"""Adversarial / regression corpus generator (numpy only).

Counterpart of stringsearch_tpu/harness/corpus.py, byte-identical to it for
every generator: the same seeds, the same draws in the same order. The
patterns are the ones that break SACAs — long runs, short periods,
near-repeats, all-equal, sparse alphabets, high-entropy bytes, multi-byte
UTF-8 — plus `enwik_like`, the compressible text the build benchmark is
defined on.
"""

from __future__ import annotations

import numpy as np


def shruggy() -> bytes:
    """UTF-8 multi-byte regression case."""
    return "¯\\_(ツ)_/¯".encode("utf-8")


def regression_corpus() -> dict[str, bytes]:
    """Small adversarial inputs replayed by the unit tests."""
    rng = np.random.default_rng(0xD1F5)
    c: dict[str, bytes] = {}
    c["empty"] = b""
    c["one"] = b"\x00"
    c["two-eq"] = b"aa"
    c["shruggy"] = shruggy()
    c["all-zero-64"] = bytes(64)
    c["all-ff-257"] = b"\xff" * 257
    c["run-then-step"] = b"a" * 100 + b"b" + b"a" * 100
    c["period2"] = b"ab" * 300
    c["period3"] = b"abc" * 200
    c["near-repeat"] = (b"abcabcabd" * 64)[:500]
    c["fibonacci"] = _fibonacci_string(13)
    c["descending"] = bytes(range(255, -1, -1))
    c["ascending"] = bytes(range(256))
    c["sparse-alpha"] = bytes(rng.integers(0, 2, 800, dtype=np.uint8))
    c["quad-alpha"] = bytes(rng.integers(0, 4, 1200, dtype=np.uint8))
    c["random-17"] = bytes(rng.integers(0, 256, 17, dtype=np.uint8))
    c["random-4k"] = bytes(rng.integers(0, 256, 4096, dtype=np.uint8))
    c["zeros-with-noise"] = _zeros_with_noise(rng, 1000, 10)
    c["blocky"] = b"".join(bytes([b]) * 37
                           for b in rng.integers(0, 256, 30, dtype=np.uint8))
    c["high-then-low"] = b"\xfe\xff" * 200 + b"\x00\x01" * 200
    return c


def _fibonacci_string(k: int) -> bytes:
    a, b = b"a", b"ab"
    for _ in range(k):
        a, b = b, b + a
    return b


def _zeros_with_noise(rng, n: int, flips: int) -> bytes:
    arr = np.zeros(n, dtype=np.uint8)
    idx = rng.integers(0, n, flips)
    arr[idx] = rng.integers(1, 256, flips, dtype=np.uint8)
    return bytes(arr)


def enwik_like(n: int, seed: int = 7) -> bytes:
    """English-ish Wikipedia-markup text with enwik8/9's statistics.

    A ~600-token Zipf-distributed vocabulary of function words,
    deterministic pseudo-words, numbers and wiki markup, assembled fully
    vectorized (one gather per chunk of tokens). Deterministic for a given
    (n, seed).
    """
    rng = np.random.default_rng(seed)
    common = [
        b"the", b"of", b"and", b"in", b"to", b"a", b"is", b"was", b"for",
        b"as", b"by", b"with", b"on", b"that", b"from", b"at", b"an",
        b"wikipedia", b"article", b"category", b"http", b"reference",
        b"[[", b"]]", b"{{", b"}}", b"==", b"link", b"page", b"&quot;",
        b"&amp;", b"<ref>", b"</ref>", b"<text", b"</text>", b"|", b"=",
    ]
    # deterministic pseudo-words: consonant-vowel syllables, 1-4 syllables
    cons = b"bcdfghjklmnprstvwz"
    vow = b"aeiou"
    words = list(common)
    wr = np.random.default_rng(0xE111)  # fixed: vocabulary independent of seed
    while len(words) < 600:
        k = int(wr.integers(1, 5))
        w = bytearray()
        for _ in range(k):
            w.append(cons[int(wr.integers(0, len(cons)))])
            w.append(vow[int(wr.integers(0, len(vow)))])
            if wr.random() < 0.3:
                w.append(cons[int(wr.integers(0, len(cons)))])
        words.append(bytes(w))
    ranks = np.arange(1, len(words) + 1, dtype=np.float64)
    p = 1.0 / ranks
    p /= p.sum()
    seps = [b"\n", b". ", b", ", b" "]
    sep_p = np.array([0.02, 0.03, 0.03, 0.92])
    # vocabulary blob: words, then the 10000 number strings, then the
    # separators; token streams index into it
    entries = words + [str(v).encode() for v in range(10000)] + seps
    blob = np.frombuffer(b"".join(entries), dtype=np.uint8)
    lens = np.array([len(e) for e in entries], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    nw = len(words)
    out_parts: list[np.ndarray] = []
    have = 0
    chunk = max(1024, n // 5)  # tokens per vectorized draw (~6 B/token)
    # inverse-CDF sampling: what Generator.choice(p=...) computes, on the
    # same RNG stream
    wcdf = np.cumsum(p)
    wcdf /= wcdf[-1]
    scdf = np.cumsum(sep_p)
    scdf /= scdf[-1]
    while have < n:
        widx = wcdf.searchsorted(rng.random(chunk), side="right")
        sidx = scdf.searchsorted(rng.random(chunk), side="right")
        numbers = rng.random(chunk) < 0.03
        numvals = rng.integers(0, 10000, size=chunk)
        toks = np.empty(2 * chunk, dtype=np.int64)
        toks[0::2] = np.where(numbers, nw + numvals, widx)
        toks[1::2] = nw + 10000 + sidx
        tl = lens[toks]
        starts = np.concatenate([[0], np.cumsum(tl)[:-1]])
        total = int(starts[-1] + tl[-1])
        # byte j of token i reads blob[j - starts[i] + offs[toks[i]]]:
        # expand via boundary-scatter + cumsum
        delta = offs[toks] - starts
        d = np.ones(total, dtype=np.int64)
        d[0] += delta[0]
        d[starts[1:]] += np.diff(delta)
        out_parts.append(blob[np.cumsum(d) - 1])
        have += total
    return np.concatenate(out_parts)[:n].tobytes()


def random_bytes(n: int, alphabet: int = 256, seed: int = 1) -> bytes:
    rng = np.random.default_rng(seed)
    return bytes(rng.integers(0, alphabet, n, dtype=np.uint8))
