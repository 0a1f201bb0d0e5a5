#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's main path once at the benchmark's size and fails
(non-zero exit, no result line) on any failed check, or when no GPU is
present. Phases, each printed with its result and time:

  0. versions, the card's name and power limit;
  1. build the bitonic kernel library from the sources in the checkout;
  2. the kernel against its plain PyTorch version at the main path's
     shapes (keys exact, payloads as multisets per tied block), timed with
     CUDA events;
  3. `build_suffix_array(enwik_like(2^28), device="cuda")`, then the
     device verify and the host oracle's sufcheck; the kernel's launch
     count over the build must be > 0;
  4. the SA byte-exact against the C++ oracle on enwik-like 2^24 text, the
     regression corpus and adversarial inputs that reach compaction;
  5. 256 LCS, 256 exact and 16 single-byte queries on the 2^28 index,
     every answer checked against the oracle, p50 batch times.

The kernel report (JSON) and the card's name and power limit come on the
lines before the last; the last line is `{"ok": true, "device": {...}}`.
The run is pinned to one card, the first one CUDA would use.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
INT32_MAX = 2**31 - 1
LOG2N = 28  # the benchmark's text size, bench.py:55


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def canonical(keys, payloads):
    """Payloads sorted inside each tied key block: the order-free form of
    an unstable sort's output."""
    import torch
    from stringsearch_torch.ops.bitonic import plain_sort

    n = keys[0].shape[0]
    new = torch.zeros(n, dtype=torch.bool, device=keys[0].device)
    new[0] = True
    for k in keys:
        new[1:] |= k[1:] != k[:-1]
    block = (torch.cumsum(new, 0) - 1).to(torch.int32)
    return [plain_sort((block, p), 2)[1] for p in payloads]


def phase2_kernel_vs_plain() -> list[dict]:
    import torch
    from stringsearch_torch.ops import bitonic

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    n24 = 1 << 24

    def rand(n, lo, hi):
        return torch.randint(lo, hi, (n,), dtype=torch.int32, device="cuda",
                             generator=gen)

    def pick(n, values):
        v = torch.tensor(values, dtype=torch.int32, device="cuda")
        return v[rand(n, 0, len(values))]

    iota = torch.arange(n24 + 12345, dtype=torch.int32, device="cuda")
    cases = [
        # initial sort: 3 packed-byte keys + position (doubling.py l.192)
        ("initial C=4 keys=3", 3,
         [rand(n24, -2**31, INT32_MAX), rand(n24, -64, 64), rand(n24, 0, 4),
          iota[:n24]]),
        # fan-4 round: 4 rank keys + position (doubling.py l.237)
        ("round C=5 keys=4", 4,
         [rand(n24, 0, 1 << 20), rand(n24, -8, 1 << 20), rand(n24, -8, 64),
          rand(n24, -8, 8), iota[:n24]]),
        # inverse permutation: (sa, rank) by sa (doubling.py l.112)
        ("invert C=2 keys=1", 1,
         [torch.randperm(n24, device="cuda", generator=gen).to(torch.int32),
          rand(n24, 0, n24)]),
        # non-power-of-two n with INT32_MAX in every key plane
        ("int32max C=5 keys=4", 4,
         [pick(n24 + 12345, [0, 1, 2, INT32_MAX]) for _ in range(4)]
         + [iota]),
    ]
    results = []
    for name, nk, ops in cases:
        got = bitonic.bitonic_sort(ops, nk)
        want = bitonic.plain_sort(ops, nk)
        torch.cuda.synchronize()
        err = 0
        for g, w in zip(got[:nk], want[:nk]):
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
        for g, w in zip(canonical(want[:nk], got[nk:]),
                        canonical(want[:nk], want[nk:])):
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
        del got, want
        ms = cuda_ms(lambda: bitonic.bitonic_sort(ops, nk), 3)
        plain_ms = cuda_ms(lambda: bitonic.plain_sort(ops, nk), 3)
        n = ops[0].shape[0]
        say(f"phase 2: {name} n={n}: max_abs_err={err} (tolerance 0), "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(err == 0, f"kernel disagrees with the plain sort on {name}")
        results.append({"shape": name, "n": n, "max_abs_err": err,
                        "ms": round(ms, 4), "plain_ms": round(plain_ms, 4)})
        del ops
    return results


def phase3_build():
    import torch
    import stringsearch_torch as st
    from stringsearch_torch import oracle
    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_torch.ops import bitonic

    n = 1 << LOG2N
    t0 = time.perf_counter()
    text_np = np.frombuffer(enwik_like(n), dtype=np.uint8)
    say(f"phase 3: enwik_like(2^{LOG2N}) generated in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    text = torch.from_numpy(text_np.copy()).to("cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bitonic.launches = 0
    t0 = time.perf_counter()
    sa = st.build_suffix_array(text, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = bitonic.launches
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 3: build n={n}: {build_s:.4f} s, {n / build_s:.1f} B/s, "
        f"peak CUDA memory {peak} B ({peak / 2**30:.2f} GiB), "
        f"bitonic launches {launches}")
    check(launches > 0, "the build launched no bitonic kernel")
    check(sa.sa.device.type == "cuda" and sa.sa.dtype == torch.int32,
          "SA is not an int32 CUDA tensor")

    t0 = time.perf_counter()
    sa2 = st.build_suffix_array(text, device="cuda")
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    check(torch.equal(sa.sa, sa2.sa), "two builds disagree")
    del sa2
    say(f"phase 3: second build {rebuild_s:.4f} s, {n / rebuild_s:.1f} B/s")

    t0 = time.perf_counter()
    sa.verify()
    torch.cuda.synchronize()
    say(f"phase 3: device verify passed in {time.perf_counter() - t0:.4f} s")
    t0 = time.perf_counter()
    sa_host = sa.sa.cpu().numpy()
    rc = oracle.sufcheck(text_np, sa_host)
    say(f"phase 3: oracle.sufcheck rc={rc} in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    check(rc == 0, f"oracle.sufcheck rejected the SA (rc={rc})")
    return sa, text_np, sa_host, {"n": n, "build_s": build_s,
                                  "rebuild_s": rebuild_s, "peak_bytes": peak,
                                  "launches": launches}


def phase4_exact() -> None:
    import stringsearch_torch as st
    from stringsearch_torch import oracle
    from stringsearch_torch.harness.corpus import enwik_like, regression_corpus

    rng = np.random.default_rng(4)
    ff = rng.integers(0, 256, 1 << 20, dtype=np.uint8)
    ff[5000:5300] = 0xFF
    cases = {"enwik_like(2^24)": enwik_like(1 << 24),
             "ab*2^19": b"ab" * (1 << 19),
             "random 2^20 + 300x0xFF": ff.tobytes()}
    cases.update({f"corpus:{k}": v for k, v in regression_corpus().items()})
    for name, data in cases.items():
        t0 = time.perf_counter()
        got = st.build_suffix_array(data, device="cuda").sa.cpu().numpy()
        dt = time.perf_counter() - t0
        same = np.array_equal(got, oracle.build(data))
        if len(data) > 1 << 16:
            say(f"phase 4: {name} n={len(data)}: build {dt:.4f} s, "
                f"equal to oracle: {same}")
        check(same, f"SA differs from the oracle on {name}")
    say(f"phase 4: all {len(cases)} inputs byte-exact against oracle.build")


def _p50(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase5_queries(sa, text_np, sa_host) -> dict:
    from stringsearch_torch import oracle
    from stringsearch_torch.core.search import sa_search_batch, sa_simplesearch

    rng = np.random.default_rng(5)
    n = len(text_np)

    def needles(count):
        out = []
        for i in range(count):
            m = int(rng.integers(4, 64))
            if i % 2 == 0:
                s = int(rng.integers(0, n - m))
                out.append(text_np[s : s + m].tobytes())
            else:
                out.append(rng.integers(0, 256, m, dtype=np.uint8).tobytes())
        return out

    lcs_needles = needles(256)
    res = sa.longest_substring_match_batch(lcs_needles)
    for nd, r in zip(lcs_needles, res):
        check(r.as_bytes() == nd[: r.len], "LCS bytes differ from the needle")
        check(r.len == 0 or oracle.search(text_np, nd[: r.len], sa_host)[0] > 0,
              "LCS prefix does not occur")
        check(r.len == len(nd)
              or oracle.search(text_np, nd[: r.len + 1], sa_host)[0] == 0,
              "LCS is not the longest")
    lcs_p50 = _p50(lambda: sa.longest_substring_match_batch(lcs_needles), 7)
    say(f"phase 5: 256 LCS answers checked against the oracle; p50 batch "
        f"{lcs_p50 * 1e3:.3f} ms (mean match length "
        f"{np.mean([r.len for r in res]):.2f})")

    exact = needles(256)
    got = sa_search_batch(sa, exact)
    for nd, g in zip(exact, got):
        check(g == oracle.search(text_np, nd, sa_host),
              f"sa_search differs from the oracle on {nd!r}")
    search_p50 = _p50(lambda: sa_search_batch(sa, exact), 7)
    say(f"phase 5: 256 exact searches equal to oracle.search; p50 batch "
        f"{search_p50 * 1e3:.3f} ms ({sum(g[0] > 0 for g in got)} found)")

    for c in rng.choice(256, 16, replace=False).tolist():
        check(sa_simplesearch(sa, c) == oracle.simplesearch(text_np, c, sa_host),
              f"simplesearch differs from the oracle on byte {c}")
    say("phase 5: 16 simplesearch chars equal to oracle.simplesearch")
    return {"lcs_p50_s": lcs_p50, "search_p50_s": search_p50}


def main() -> int:
    # One card: the first that CUDA would use, and the only one torch sees.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = visible.split(",")[0] if visible else "0"
    os.environ["CUDA_VISIBLE_DEVICES"] = card
    import torch

    say(f"phase 0: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is False; this smoke test "
            "needs an NVIDIA GPU")
        return 2
    card = card_line(card)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say(f"phase 0: card {card}; torch sees {count} x {kind}")
    if count != 1:
        say(f"FAIL: pinned to one card, torch sees {count}")
        return 2
    torch.cuda.set_device(0)

    sys.path.insert(0, REPO)
    from stringsearch_torch.ops import bitonic

    try:
        t0 = time.perf_counter()
        bitonic.load_library()
        say(f"phase 1: built and loaded the bitonic kernel in "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        shapes = phase2_kernel_vs_plain()
        say(f"phase 2: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        sa, text_np, sa_host, build = phase3_build()
        say(f"phase 3: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        phase4_exact()
        say(f"phase 4: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        queries = phase5_queries(sa, text_np, sa_host)
        say(f"phase 5: passed in {time.perf_counter() - t0:.2f} s")
    except SmokeFailure as e:
        say(f"FAIL: {e}")
        return 1

    headline = next(s for s in shapes if s["shape"].startswith("round"))
    say(json.dumps({"kernels": [{
        "name": "bitonic_sort",
        "route": "cuda",
        "source": "stringsearch_torch/ops/csrc/bitonic.cu",
        "replaces": "stringsearch_tpu/ops/bitonic.py:240",
        "also_replaces": "stringsearch_tpu/ops/bitonic.py:263",
        "launches": build["launches"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": headline["ms"],
        "plain_ms": headline["plain_ms"],
        "timed_shape": f"{headline['shape']} n={headline['n']}",
        "shapes": shapes,
        "build": build,
        "queries": queries,
    }]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
