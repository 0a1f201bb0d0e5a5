"""Enwik-class text made on the device from the seed.

A frozen copy of `stringsearch_torch/harness/corpus.py:enwik_like`'s
statistics, in torch: the same ~600-token vocabulary of function words,
deterministic pseudo-words, numbers and wiki markup (built from the same
fixed host RNG, so it does not depend on the seed), the same Zipf draw of
words, the same separators and number share, and the same assembly (one
gather through a boundary scatter and a cumulative sum). The draws come
from a `torch.Generator` on the text's device in a few large calls, so
2^28 bytes take a fraction of a second where the host copy took 13.8 s.
The bytes differ from `enwik_like`'s (another RNG), the statistics do not.

The text is drawn in pieces of at most `PIECE_PAIRS` (token, separator)
pairs, so making 10^9 bytes holds a few GiB on the device at a time.
"""

from __future__ import annotations

import numpy as np
import torch

_COMMON = [
    b"the", b"of", b"and", b"in", b"to", b"a", b"is", b"was", b"for",
    b"as", b"by", b"with", b"on", b"that", b"from", b"at", b"an",
    b"wikipedia", b"article", b"category", b"http", b"reference",
    b"[[", b"]]", b"{{", b"}}", b"==", b"link", b"page", b"&quot;",
    b"&amp;", b"<ref>", b"</ref>", b"<text", b"</text>", b"|", b"=",
]
_SEPS = [b"\n", b". ", b", ", b" "]
_SEP_P = [0.02, 0.03, 0.03, 0.92]
_NUMBER_SHARE = 0.03
_NUMBERS = 10000
PIECE_PAIRS = 1 << 25


def vocabulary() -> list[bytes]:
    """The 600 words: the common ones, then consonant-vowel pseudo-words
    of 1-4 syllables from a fixed RNG (enwik_like's own)."""
    cons = b"bcdfghjklmnprstvwz"
    vow = b"aeiou"
    words = list(_COMMON)
    wr = np.random.default_rng(0xE111)
    while len(words) < 600:
        k = int(wr.integers(1, 5))
        w = bytearray()
        for _ in range(k):
            w.append(cons[int(wr.integers(0, len(cons)))])
            w.append(vow[int(wr.integers(0, len(vow)))])
            if wr.random() < 0.3:
                w.append(cons[int(wr.integers(0, len(cons)))])
        words.append(bytes(w))
    return words


class Enwik:
    """The vocabulary's tables on one device; `draw` makes text."""

    def __init__(self, device):
        words = vocabulary()
        entries = words + [str(v).encode() for v in range(_NUMBERS)] + _SEPS
        lens = np.array([len(e) for e in entries], dtype=np.int64)
        p = 1.0 / np.arange(1, len(words) + 1, dtype=np.float64)
        p /= p.sum()
        sep_p = np.array(_SEP_P)
        # expected bytes of one (token, separator) pair, to size a draw
        word_len = float(p @ lens[:len(words)])
        number_len = float(lens[len(words):len(words) + _NUMBERS].mean())
        self.pair_bytes = ((1 - _NUMBER_SHARE) * word_len
                           + _NUMBER_SHARE * number_len
                           + float(sep_p @ lens[-len(_SEPS):]))
        self.nw = len(words)
        self.device = torch.device(device)
        dev = self.device
        self.blob = torch.tensor(np.frombuffer(b"".join(entries), np.uint8),
                                 device=dev)
        self.lens = torch.tensor(lens, device=dev)
        self.offs = torch.tensor(np.concatenate([[0], np.cumsum(lens)[:-1]]),
                                 device=dev)
        wcdf = np.cumsum(p)
        scdf = np.cumsum(sep_p)
        self.wcdf = torch.tensor(wcdf / wcdf[-1], device=dev)
        self.scdf = torch.tensor(scdf / scdf[-1], device=dev)

    def _chunk(self, pairs: int, gen: torch.Generator) -> torch.Tensor:
        dev = self.device
        f64 = torch.float64
        widx = torch.searchsorted(
            self.wcdf, torch.rand(pairs, generator=gen, device=dev, dtype=f64),
            right=True)
        sidx = torch.searchsorted(
            self.scdf, torch.rand(pairs, generator=gen, device=dev, dtype=f64),
            right=True)
        numbers = torch.rand(pairs, generator=gen, device=dev,
                             dtype=f64) < _NUMBER_SHARE
        numvals = torch.randint(0, _NUMBERS, (pairs,), generator=gen,
                                device=dev)
        toks = torch.empty(2 * pairs, dtype=torch.int64, device=dev)
        toks[0::2] = torch.where(numbers, self.nw + numvals, widx)
        toks[1::2] = self.nw + _NUMBERS + sidx
        del widx, sidx, numbers, numvals
        tl = self.lens[toks]
        ends = torch.cumsum(tl, 0)
        starts = ends - tl
        total = int(ends[-1])
        # byte j of token i reads blob[j - starts[i] + offs[toks[i]]]:
        # expand by a boundary scatter and a cumulative sum
        delta = self.offs[toks] - starts
        d = torch.ones(total, dtype=torch.int64, device=dev)
        d[0] += delta[0]
        d[starts[1:]] += torch.diff(delta)
        del delta, toks, tl, ends
        return self.blob[torch.cumsum(d, 0) - 1]

    def draw(self, n: int, gen: torch.Generator) -> torch.Tensor:
        """`n` bytes (uint8 on the device) from `gen`'s stream."""
        parts, have = [], 0
        while have < n:
            pairs = min(PIECE_PAIRS, max(
                1024, int((n - have) / self.pair_bytes * 1.02) + 1024))
            part = self._chunk(pairs, gen)
            parts.append(part)
            have += part.numel()
        text = parts[0] if len(parts) == 1 else torch.cat(parts)
        return text[:n].clone()


def generator(seed: int, device) -> torch.Generator:
    """The run's torch generator: any whole number seeds it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def make(config: dict, seed: int, device) -> torch.Tensor:
    """The configuration's `text_bytes` of text."""
    n = int(config["text_bytes"])
    return Enwik(device).draw(n, generator(seed, device))
