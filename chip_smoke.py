#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's main path once at the benchmark's size and fails
(non-zero exit, no result line) on any failed check, or when no GPU is
present. Phases, each printed with its result and time:

  0. versions, the card's name and power limit;
  1. build the three kernel libraries from the sources in the checkout:
     the radix sort behind `device_sort`, the bitonic sort and the
     radix-partition kernels (one nvcc per source, all started together);
  2. both sort kernels against the plain sort at 2^24 and 2^24 + 12345,
     tolerance 0: the radix sort, which is stable, element for element on
     every plane (heavy ties under a random payload and INT32_MIN/MAX keys
     among the cases), and against its own plain version
     `plain_radix_sort`; the bitonic sort on its keys, its payloads as
     multisets per tied block. Then the radix sort, the bitonic sort and
     the chained `torch.sort` timed with CUDA events at the main path's
     three shapes at 2^28, beside the sort's two bandwidth bounds;
  3. `build_suffix_array(enwik_like(2^28), device="cuda")`, then the
     device verify and the host oracle's sufcheck; over the build the
     radix sort's launch count must be > 0 and the bitonic sort's 0;
  4. the SA byte-exact against the C++ oracle on enwik-like 2^24 text, the
     regression corpus and adversarial inputs that reach compaction;
  5. 256 LCS, 256 exact and 16 single-byte queries on the 2^28 index,
     every answer checked against the oracle, p50 batch times;
  6. the four radix kernels against their plain versions at n = 2^28,
     tolerance 0 (histograms at tile 8192 and shifts 24 and 0; grouping at
     tiles 1024 and 2048 on random, two-bin and one-bin keys and at tile
     8192 on random keys, the destinations also against the kernel's steps
     in plain PyTorch, `plain_dest_steps`, on the first 2^24 keys; the
     flush at granules 128, 1024 and 4096 to random and sequential rows),
     timed with CUDA events; then the radix-partition probe
     `microbench.radix_probe(28)`, whose JSON comes on a line of its own,
     with every radix kernel's launch count over it > 0, and the radix
     sort's too (the probe's baseline sort; the bitonic sort's must be 0);
  7. the BWT at full width: on phase 3's text and SA `bwt(text, sa=...)`
     against the numpy formulation, `bwt(text)` (which builds the SA
     itself) the same, `unbwt` back to the text (compared on the device),
     timed with CUDA events; at 2^24 and on the regression corpus
     byte-exact against the oracle's BWT and inverse, both ways;
  8. the partitioned index at full width: `PartitionedSuffixArray(text, 4)`
     builds all four partitions in the sorts of ONE build; every
     partition equal to the flat build of its chunk; phase 5's LCS needles
     against the full index's answers; 64 exact searches, one a frequent
     byte, against the full index's occurrences that cross no boundary,
     with peak memory; P = 3 on 2^24 + 5 bytes and P = 7 on 5 bytes against
     the host loop over the oracle;
  9. the CLI in process on enwik-like 2^24 bytes: `run --verify`, `bench`
     and `crosscheck` of the doubling, dc3 and bstar engines, `queries`,
     and `crosscheck --trace` of the three engines on the GPU and on the
     CPU, whose trace files must be byte-identical;
 10. the fuzzer on the card: 40 iterations of the three engines over the
     engines, partitioned and transforms targets, 10 with `--idx64`, and
     every file of tests/corpus/; then the inverse BWT's walk probe,
     `microbench.walk_probe(24)`;
 11. the dc3 and bstar engines at full width on phase 3's text: each build
     verified on the device and equal, element for element, to phase 3's
     oracle-checked SA, with its wall, radix sort launches and peak memory;
 12. the sorts of more than six planes: `build_sa` at its default depth 24
     (seven planes) at 2^28 equal to phase 3's depth-12 SA, and with
     chunks (P = 3 on 2^24 + 5 bytes) equal to depth 12's;
     `build_ints_with_isa` at depths 4 and 6 and `build_with_isa(idx=int64)`
     on 2^24 bytes equal to the verified int32 byte build; `wide_sort`
     (`device_sort` past six int32 planes) against the plain sort at 7, 10
     and 35 planes and with int64 keys, tolerance 0, with ceil(key planes /
     5) launches, and the 7- and 10-plane sorts timed at 2^26 and 2^28
     beside the chained `torch.sort` and the bytes bound; bstar on 2^20
     bytes of `(b"a" * 200 + b"b") * 3`, which runs its 35-plane extension
     stage, equal to the oracle's SA;
 13. the exact global suffix array over four shards of the one card:
     `build_global(text, make_mesh(devices=[cuda] * 4))` on phase 3's text,
     its SA equal to phase 3's element for element, its sharded `verify()`
     passing and rejecting the state with one rank corrupted, with the
     radix sort's launches, the plain sort's calls (none), host syncs,
     peak memory, rounds, the bytes the collectives moved against the comm
     model, and the wall of two warm builds; phase 5's LCS needles in both
     text modes equal to the flat index's answers, `sa_search_batch` and
     `sa_simplesearch` equal to the oracle's; at 2^20 on eight shards
     (`b"ab" * 2^19`, all-equal bytes, enwik-like text) each equal to
     `oracle.build`, with compaction and the merge-split fallback entered;
     `scaling.measure(2^24)` at 1, 2, 4, 8 shards of the card in both
     modes; `cli crosscheck --engines doubling,global` on 2^24 bytes, and
     `--trace` of the global engine on 64 KiB on the GPU and the CPU,
     byte-identical; `fuzz --targets global`, also with `--idx64`.
Phases 9, 12 and 13 print the seconds of each command or step.
Phases 7 to 10 each zero the sort kernels' launch counts first and need
the radix sort's > 0 and the bitonic sort's 0 afterwards; phases 11 to 13
need the same of every build and sort they time.

Every kernel's entry in the report carries `bound_ms`, the least time the
card could take: the bytes the function must move (each input read once,
each output written once) over 3.35 TB/s, or its operations over the rate
below if that were more; and `library_ms`, the time of one PyTorch call
that computes the same function, where there is one.

The kernel report (JSON) and the card's name and power limit come on the
lines before the last; the last line is `{"ok": true, "device": {...}}`.
The run is pinned to one card, the first one CUDA would use.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
INT32_MAX = 2**31 - 1
INT32_MIN = -2**31
LOG2N = 28  # the benchmark's text size, bench.py:55
# Published peaks of one H100 SXM: device memory, and 32-bit operations
# outside the tensor cores (67 TFLOP/s of float32 counts a multiply-add as
# two; an integer operation is one).
BYTES_PER_S = 3.35e12
OPS_PER_S = 33.5e12
# the main path's sorts: (name, planes, keys), doubling.py
SORT_SHAPES = (("invert", 2, 1), ("initial", 4, 3), ("round", 5, 4))
# the engines phases 9 to 11 drive
ENGINES = "doubling,dc3,bstar"


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


def bound(nbytes: float, ops: float) -> dict:
    """`bound_ms` and `bound_by` of a function that must move `nbytes` and
    do `ops` 32-bit operations."""
    by_bytes = nbytes / BYTES_PER_S * 1e3
    by_ops = ops / OPS_PER_S * 1e3
    return {"bound_ms": round(max(by_bytes, by_ops), 4),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def sort_bounds(n: int, c: int, nk: int) -> dict:
    """A sort of c int32 planes by nk keys: every plane read and written
    once, and n log2 n comparisons of nk words."""
    return bound(8 * c * n, nk * n * math.log2(max(n, 2)))


def radix_design_ms(n: int, c: int, nk: int) -> float:
    """What the radix design's own traffic costs at the card's memory rate:
    4 nk passes, each reading the key plane for its histogram, then reading
    and writing all c planes. More bytes than the function needs, so not a
    bound of the function: printed beside `bound_ms`, reported nowhere."""
    return round(4 * nk * (2 * c + 1) * 4 * n / BYTES_PER_S * 1e3, 4)


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


def _exact_err(got, want) -> int:
    """Largest absolute difference over planes compared element for
    element."""
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def phase2_sorts_vs_plain() -> dict:
    """Both sort kernels against the plain sort at 2^24, then timed with the
    chained `torch.sort` at the main path's shapes at 2^28. Returns one
    report per kernel: {"radix_sort": {...}, "bitonic_sort": {...}}."""
    import torch
    from stringsearch_torch.ops import bitonic, radix_sort

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    n24 = 1 << 24
    ragged = n24 + 12345

    def rand(n, lo, hi):
        return torch.randint(lo, hi, (n,), dtype=torch.int32, device="cuda",
                             generator=gen)

    def pick(n, values):
        v = torch.tensor(values, dtype=torch.int32, device="cuda")
        return v[rand(n, 0, len(values))]

    iota = torch.arange(ragged, dtype=torch.int32, device="cuda")
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
         [pick(ragged, [0, 1, 2, INT32_MAX]) for _ in range(4)] + [iota]),
        # stability: four distinct keys under random payloads
        ("ties C=3 keys=1", 1,
         [pick(ragged, [5, -3, 1 << 30, -(1 << 30)]),
          rand(ragged, -2**31, INT32_MAX), rand(ragged, 0, 16)]),
        # both ends of the int32 range in every key plane
        ("extremes C=4 keys=2", 2,
         [pick(ragged, [INT32_MIN, INT32_MIN + 1, -1, 0, INT32_MAX - 1,
                        INT32_MAX]) for _ in range(2)]
         + [rand(ragged, -2**31, INT32_MAX), iota]),
    ]
    reports = {"radix_sort": {"shapes": []}, "bitonic_sort": {"shapes": []}}
    for name, nk, ops in cases:
        n = ops[0].shape[0]
        want = bitonic.plain_sort(ops, nk)
        got = radix_sort.radix_sort(ops, nk)
        torch.cuda.synchronize()
        radix_err = _exact_err(got, want)
        got = bitonic.bitonic_sort(ops, nk)
        torch.cuda.synchronize()
        bitonic_err = _exact_err(got[:nk], want[:nk])
        if len(ops) > nk:
            bitonic_err = max(bitonic_err, _exact_err(
                canonical(want[:nk], got[nk:]),
                canonical(want[:nk], want[nk:])))
        del got, want
        radix_ms = cuda_ms(lambda: radix_sort.radix_sort(ops, nk), 3)
        bitonic_ms = cuda_ms(lambda: bitonic.bitonic_sort(ops, nk), 3)
        plain_ms = cuda_ms(lambda: bitonic.plain_sort(ops, nk), 3)
        say(f"phase 2: {name} n={n}: max_abs_err radix {radix_err}, bitonic "
            f"{bitonic_err} (tolerance 0); radix {radix_ms:.3f} ms, bitonic "
            f"{bitonic_ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(radix_err == 0, f"the radix sort disagrees with the plain sort "
                              f"on {name}")
        check(bitonic_err == 0, f"the bitonic sort disagrees with the plain "
                                f"sort on {name}")
        for kernel, err, ms in (("radix_sort", radix_err, radix_ms),
                                ("bitonic_sort", bitonic_err, bitonic_ms)):
            reports[kernel]["shapes"].append({
                "shape": name, "n": n, "max_abs_err": err,
                "ms": round(ms, 4), "plain_ms": round(plain_ms, 4)})
        del ops

    # the radix kernel against its own plain version, pass for pass
    ops = [rand(n24, -2**31, INT32_MAX), rand(n24, -8, 8), iota[:n24]]
    got = radix_sort.radix_sort(ops, 2)
    want = radix_sort.plain_radix_sort(ops, 2)
    err = _exact_err(got, want)
    del got, want
    own_ms = cuda_ms(lambda: radix_sort.plain_radix_sort(ops, 2), 1)
    say(f"phase 2: radix_sort against plain_radix_sort C=3 keys=2 n={n24}: "
        f"max_abs_err={err} (tolerance 0), plain_radix_sort {own_ms:.3f} ms")
    check(err == 0, "the radix sort disagrees with plain_radix_sort")
    reports["radix_sort"]["plain_radix_sort"] = {
        "shape": f"C=3 keys=2 n={n24}", "max_abs_err": err,
        "ms": round(own_ms, 4)}
    del ops, iota
    torch.cuda.empty_cache()

    # the main path's shapes at its size: full-range random keys and
    # position planes
    n = 1 << LOG2N
    for name, c, nk in SORT_SHAPES:
        ops = [rand(n, -2**31, INT32_MAX) for _ in range(nk)]
        ops += [torch.arange(n, dtype=torch.int32, device="cuda")
                for _ in range(c - nk)]
        want = bitonic.plain_sort(ops, nk)
        got = radix_sort.radix_sort(ops, nk)
        torch.cuda.synchronize()
        radix_err = _exact_err(got, want)
        got = bitonic.bitonic_sort(ops, nk)
        torch.cuda.synchronize()
        bitonic_err = _exact_err(got[:nk], want[:nk])
        del got, want
        radix_ms = cuda_ms(lambda: radix_sort.radix_sort(ops, nk), 2)
        bitonic_ms = cuda_ms(lambda: bitonic.bitonic_sort(ops, nk), 1)
        library_ms = cuda_ms(lambda: bitonic.plain_sort(ops, nk), 2)
        bounds = sort_bounds(n, c, nk)
        say(f"phase 2: {name} C={c} keys={nk} n=2^{LOG2N}: max_abs_err radix "
            f"{radix_err}, bitonic keys {bitonic_err} (tolerance 0); radix "
            f"{radix_ms:.3f} ms, bitonic {bitonic_ms:.3f} ms, chained "
            f"torch.sort {library_ms:.3f} ms; bound {bounds['bound_ms']} ms "
            f"(every plane once); the radix design's own bytes take "
            f"{radix_design_ms(n, c, nk)} ms")
        check(radix_err == 0, f"the radix sort disagrees with the plain sort "
                              f"at 2^{LOG2N}, {name}")
        check(bitonic_err == 0, f"the bitonic sort's keys disagree with the "
                                f"plain sort at 2^{LOG2N}, {name}")
        for kernel, err, ms in (("radix_sort", radix_err, radix_ms),
                                ("bitonic_sort", bitonic_err, bitonic_ms)):
            # the chained torch.sort is the library call and, as
            # `plain_sort`, the plain version device_sort takes on the CPU
            reports[kernel]["shapes"].append({
                "shape": f"{name} C={c} keys={nk}", "n": n,
                "max_abs_err": err, "ms": round(ms, 4),
                "plain_ms": round(library_ms, 4),
                "library_ms": round(library_ms, 4), **bounds})
        del ops
        torch.cuda.empty_cache()
    return reports


def phase3_build():
    import torch
    import stringsearch_torch as st
    from stringsearch_torch import oracle
    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_torch.ops import bitonic, radix_sort

    n = 1 << LOG2N
    t0 = time.perf_counter()
    text_np = np.frombuffer(enwik_like(n), dtype=np.uint8)
    say(f"phase 3: enwik_like(2^{LOG2N}) generated in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    text = torch.from_numpy(text_np.copy()).to("cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    radix_sort.launches = 0
    bitonic.launches = 0
    t0 = time.perf_counter()
    sa = st.build_suffix_array(text, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = radix_sort.launches
    bitonic_launches = bitonic.launches
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 3: build n={n}: {build_s:.4f} s, {n / build_s:.1f} B/s, "
        f"peak CUDA memory {peak} B ({peak / 2**30:.2f} GiB), "
        f"radix sort launches {launches}, bitonic launches "
        f"{bitonic_launches}")
    check(launches > 0, "the build launched no radix sort")
    check(bitonic_launches == 0, "the build launched the bitonic kernel")
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
                                  "launches": launches,
                                  "bitonic_launches": bitonic_launches}


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
    return ({"lcs_p50_s": lcs_p50, "search_p50_s": search_p50},
            lcs_needles, [r.len for r in res])


def phase1_build_kernels() -> None:
    """Build and load the three kernel libraries, one nvcc each, side by
    side."""
    from concurrent.futures import ThreadPoolExecutor
    from stringsearch_torch.ops import bitonic, radix, radix_sort

    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    libraries = (("the radix sort", radix_sort), ("the bitonic sort", bitonic),
                 ("the radix-partition kernels", radix))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        times = [pool.submit(timed, module.load_library)
                 for _, module in libraries]
        for (what, _), t in zip(libraries, times):
            say(f"phase 1: built and loaded {what} in {t.result():.2f} s")
    say(f"phase 1: three libraries built side by side in "
        f"{time.perf_counter() - t0:.2f} s")


def max_abs_err(got, want) -> int:
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"shape or type differs: {tuple(got.shape)} {got.dtype} against "
          f"{tuple(want.shape)} {want.dtype}")
    if got.equal(want):
        return 0
    import torch

    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def phase6_radix() -> tuple[dict, int]:
    """The radix kernels against their plain versions at n = 2^28, then the
    radix-partition probe. Returns one report per radix kernel and the
    radix sort's launches in the probe."""
    import torch
    from stringsearch_torch.harness import microbench
    from stringsearch_torch.ops import bitonic, radix, radix_sort

    n = 1 << LOG2N
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    keys = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                         device="cuda", generator=gen)
    pay = torch.arange(n, dtype=torch.int32, device="cuda")
    low24 = keys & 0x00FFFFFF
    # top byte (the bin at shift 24) from {3, 250}, or 7 everywhere
    two_tops = torch.tensor([3 << 24, (250 << 24) - 2**32], dtype=torch.int32,
                            device="cuda")
    key_sets = {
        "random": keys,
        "two bins": low24 | two_tops[torch.randint(
            0, 2, (n,), device="cuda", generator=gen)],
        "one bin": low24 | (7 << 24),
    }
    del low24
    report = {k: {"shapes": []} for k in ("hist", "dest", "place", "flush")}

    def record(kernel, shape, err, fn, plain_fn, bounds, library_fn=None):
        ms = cuda_ms(fn, 5)
        plain_ms = cuda_ms(plain_fn, 3)
        library_ms = (None if library_fn is None
                      else round(cuda_ms(library_fn, 3), 4))
        say(f"phase 6: {kernel} {shape}: max_abs_err={err} (tolerance 0), "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library call "
            f"{library_ms} ms, bound {bounds['bound_ms']} ms")
        check(err == 0, f"radix {kernel} kernel disagrees with its plain "
                        f"version on {shape}")
        report[kernel]["shapes"].append({
            "shape": shape, "max_abs_err": err, "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 4), "library_ms": library_ms,
            **bounds})

    for shift in (24, 0):
        got = radix.kernel_histograms(keys, 8192, shift)
        want = radix.plain_histograms(keys, 8192, shift)
        check(bool((got.sum(1) == 8192).all()),
              f"a histogram row does not sum to the tile (shift {shift})")
        # the one library call: a bincount of tile * 256 + bin
        cells = radix._block_bins(keys, 8192, shift)
        record("hist", f"n=2^{LOG2N} tile=8192 shift={shift}",
               max_abs_err(got, want),
               lambda s=shift: radix.kernel_histograms(keys, 8192, s),
               lambda s=shift: radix.plain_histograms(keys, 8192, s),
               bound(4 * n + 4 * 256 * (n // 8192), n),
               lambda c=cells: torch.bincount(c, minlength=n // 8192 * 256))
        del cells

    n24 = 1 << 24  # what `plain_dest_steps` is run on: whole tiles
    for name, k in key_sets.items():
        # 8192: a tile of eight warps, joined by the scan across warps
        for tile in (1024, 2048) + ((8192,) if name == "random" else ()):
            shape = f"n=2^{LOG2N} tile={tile} shift=24 {name} keys"
            dest, lb = radix.kernel_dest(k, tile, 24)
            gk, gp = radix.kernel_place(k, pay, dest, tile)
            wdest, wlb = radix.plain_dest(k, tile, 24)
            wk, wp = radix.plain_place(k, pay, wdest, tile)
            dest_err = max(max_abs_err(dest, wdest), max_abs_err(lb, wlb))
            place_err = max(max_abs_err(gk, wk), max_abs_err(gp, wp))
            del gk, gp, wlb, wk, wp
            sdest, slb = radix.plain_dest_steps(
                k[:n24], tile, 24, radix.dest_warps_per_tile(tile))
            steps_err = max(max_abs_err(dest[:n24], sdest),
                            max_abs_err(lb[:n24 // tile], slb))
            say(f"phase 6: dest {shape}: max_abs_err={steps_err} against "
                f"plain_dest_steps on the first 2^24 keys (tolerance 0)")
            check(steps_err == 0, f"radix dest kernel disagrees with "
                                  f"plain_dest_steps on {shape}")
            del dest, lb, sdest, slb
            # no single PyTorch call computes either function
            record("dest", shape, dest_err,
                   lambda k=k, t=tile: radix.kernel_dest(k, t, 24),
                   lambda k=k, t=tile: radix.plain_dest(k, t, 24),
                   bound(8 * n + 4 * 256 * (n // tile), n))
            record("place", shape, place_err,
                   lambda k=k, d=wdest, t=tile:
                   radix.kernel_place(k, pay, d, t),
                   lambda k=k, d=wdest, t=tile:
                   radix.plain_place(k, pay, d, t),
                   bound(20 * n, n))
            del wdest
    del key_sets

    for granule in (128, 1024, 4096):
        rows = n // granule
        src = keys.view(rows, granule)
        for order in ("random", "sequential"):
            desc = (torch.randperm(rows, device="cuda", generator=gen)
                    if order == "random"
                    else torch.arange(rows, device="cuda")).to(torch.int32)
            err = max_abs_err(radix.kernel_granule_flush(desc, src, rows),
                              radix.plain_granule_flush(desc, src, rows))
            # the one library call: index_copy_ of the rows
            desc64 = desc.to(torch.int64)
            out = torch.empty_like(src)
            record("flush", f"n=2^{LOG2N} granule={granule} {order} rows",
                   err,
                   lambda d=desc: radix.kernel_granule_flush(d, src, rows),
                   lambda d=desc: radix.plain_granule_flush(d, src, rows),
                   bound(8 * n + 4 * rows, n),
                   lambda d=desc64, o=out: o.index_copy_(0, d, src))
            del desc, desc64, out
    del keys, pay, src
    torch.cuda.empty_cache()

    # the radix mode of the microbench, the path that runs these kernels and,
    # for its baseline sort, the radix sort
    for k in radix.launches:
        radix.launches[k] = 0
    radix_sort.launches = 0
    bitonic.launches = 0
    t0 = time.perf_counter()
    probe = microbench.radix_probe(LOG2N)
    torch.cuda.synchronize()
    launches = dict(radix.launches)
    sort_launches = radix_sort.launches
    say(f"phase 6: radix_probe(2^{LOG2N}) in "
        f"{time.perf_counter() - t0:.2f} s, radix launches {launches}, "
        f"radix sort launches {sort_launches}, bitonic launches "
        f"{bitonic.launches}; its result:")
    say(json.dumps(probe))
    check(probe["checks"] == {"hist": True, "group": True, "flush": True},
          f"radix_probe checks failed: {probe['checks']}")
    times = [probe["t_sort_1key_2op"], probe["t_hist"],
             *probe["t_group"].values()]
    times += [f[k] for f in probe["t_flush"].values()
              for k in ("rand_s", "seq_s")]
    times += [e["t_pass_est"] for e in probe["pass8_est"].values()]
    check(len(probe["pass8_est"]) == 6
          and all(math.isfinite(t) and t > 0 for t in times),
          "radix_probe times are not all finite and positive")
    for k, count in launches.items():
        check(count > 0, f"radix_probe launched no radix {k} kernel")
        report[k]["launches"] = count
    check(sort_launches > 0, "radix_probe's baseline sort launched no "
                             "radix sort")
    check(bitonic.launches == 0, "radix_probe launched the bitonic kernel")
    return report, sort_launches


class SortLaunches:
    """Zeroes both sort kernels' launch counts on entry; on exit requires
    the radix sort's > 0 and the bitonic sort's 0, keeps the former in
    `radix` and, given `counts`, in `counts[what]` with a line saying so."""

    def __init__(self, what: str, counts: dict | None = None):
        self.what, self.counts = what, counts

    def __enter__(self):
        from stringsearch_torch.ops import bitonic, radix_sort

        radix_sort.launches = 0
        bitonic.launches = 0
        return self

    def __exit__(self, exc_type, exc, tb):
        from stringsearch_torch.ops import bitonic, radix_sort

        self.radix = radix_sort.launches
        if exc_type is None:
            if self.counts is not None:
                self.counts[self.what] = radix_sort.launches
                say(f"{self.what}: radix sort launches {radix_sort.launches}, "
                    f"bitonic launches {bitonic.launches}")
            check(radix_sort.launches > 0,
                  f"{self.what} launched no radix sort")
            check(bitonic.launches == 0,
                  f"{self.what} launched the bitonic kernel")


def phase7_bwt(text_np, sa_host, card: str) -> dict:
    import torch
    from stringsearch_torch import oracle
    from stringsearch_torch.harness.corpus import enwik_like, regression_corpus
    from stringsearch_torch.ops.bitonic import device_sort
    from stringsearch_torch.transforms.bwt import (
        _jump, _lf_state, _unbwt_kernel, bwt, bwt_from_sa, divbwt, unbwt)

    n = len(text_np)
    text = torch.from_numpy(text_np.copy()).to("cuda")
    sa = torch.from_numpy(sa_host).to("cuda")

    # the numpy formulation: T[SA - 1] with row pidx skipped, U[0] = T[n-1]
    want_pidx = int(np.flatnonzero(sa_host == 0)[0])
    prev = text_np[sa_host - 1]  # row pidx wraps to T[n-1]: skipped
    want_u = np.concatenate([text_np[-1:], prev[:want_pidx],
                             prev[want_pidx + 1:]])
    del prev
    u, pidx = bwt(text, sa=sa)
    check(pidx == want_pidx, f"bwt pidx {pidx}, numpy {want_pidx}")
    check(np.array_equal(u.cpu().numpy(), want_u),
          "bwt(text, sa) differs from the numpy formulation")
    del want_u
    from_sa_ms = cuda_ms(lambda: bwt_from_sa(text, sa), 3)
    del sa
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u2, pidx2 = bwt(text)  # the `_divbwt_fused` branch: builds the SA
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    check(pidx2 == pidx and torch.equal(u2, u),
          "bwt(text) differs from bwt(text, sa)")
    del u2
    say(f"phase 7: n=2^{LOG2N}: bwt equal to the numpy formulation, pidx "
        f"{pidx}; bwt_from_sa {from_sa_ms:.3f} ms; bwt(text) with its build "
        f"{fused_s:.4f} s [{card}]")

    rounds = n.bit_length()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    back = _unbwt_kernel(u, pidx, rounds)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(torch.equal(back, text), "unbwt(bwt(text)) is not the text")
    del back
    unbwt_ms = cuda_ms(lambda: _unbwt_kernel(u, pidx, rounds), 1)
    # its parts: the LF sort, and a round on the real LF state
    r = torch.arange(n + 1, dtype=torch.int32, device="cuda")
    col = torch.cat([u.to(torch.int32), r.new_zeros((1,))])
    sort_ms = cuda_ms(lambda: device_sort((col, r), 1), 2)
    del col, r
    state, chars = _lf_state(u, pidx)
    del chars
    round_ms = cuda_ms(lambda: _jump(state), 5)
    del state
    say(f"phase 7: n=2^{LOG2N}: unbwt back to the text (compared on the "
        f"device); _unbwt_kernel {unbwt_ms:.3f} ms in {rounds} rounds, one "
        f"round {round_ms:.3f} ms, the LF sort {sort_ms:.3f} ms, peak CUDA "
        f"memory {peak} B of which {held} B held before [{card}]")
    del u, text
    torch.cuda.empty_cache()

    cases = {"enwik_like(2^24)": enwik_like(1 << 24), "n=0": b"", "n=1": b"q"}
    cases.update({f"corpus:{k}": v for k, v in regression_corpus().items()})
    for name, data in cases.items():
        got_u, got_p = divbwt(data, device="cuda")
        want = oracle.bwt(data)
        check((got_u, got_p) == want, f"bwt differs from oracle.bwt on {name}")
        check(unbwt(got_u, got_p, device="cuda") == data,
              f"unbwt(bwt(x)) != x on {name}")
        check(oracle.unbwt(got_u, got_p) == data,
              f"oracle.unbwt(bwt(x)) != x on {name}")
    say(f"phase 7: all {len(cases)} inputs byte-exact against oracle.bwt and "
        f"oracle.unbwt, both ways")
    return {"n": n, "bwt_from_sa_ms": from_sa_ms, "bwt_with_build_s": fused_s,
            "unbwt_ms": unbwt_ms, "rounds": rounds, "round_ms": round_ms,
            "lf_sort_ms": sort_ms, "peak_bytes": peak, "held_bytes": held}


def phase8_partitioned(text_np, sa_host, lcs_needles, full_lens,
                       card: str) -> dict:
    import torch
    import stringsearch_torch as st
    from stringsearch_torch.core.search import sa_search_batch, sa_simplesearch
    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_torch.ops import radix_sort

    n = len(text_np)
    parts = 4
    text = torch.from_numpy(text_np.copy()).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    radix_sort.launches = 0
    t0 = time.perf_counter()
    index = st.PartitionedSuffixArray(text, parts)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = radix_sort.launches
    build_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    again = st.PartitionedSuffixArray(text, parts)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    check(torch.equal(index.sas, again.sas), "two partitioned builds disagree")
    del again
    say(f"phase 8: PartitionedSuffixArray(2^{LOG2N}, {parts}): build "
        f"{build_s:.4f} s, second build {rebuild_s:.4f} s "
        f"({n / rebuild_s:.1f} B/s), radix sort launches {launches}, peak "
        f"CUDA memory {build_peak} B [{card}]")
    # the sorts of one build: the initial sort, an invert and a round
    check(launches == 3, f"the partitioned build launched {launches} radix "
                         f"sorts, a flat build 3")
    psize = index.partition_size
    for p in range(parts):
        flat = st.build_suffix_array(index.chunks[p]).sa
        check(torch.equal(index.sas[p], flat),
              f"partition {p} differs from the flat build of its chunk")
        del flat
    say("phase 8: every partition equal to the flat build of its chunk")

    # LCS: fuzz._check_partitioned's three invariants against phase 5
    res = index.longest_substring_match_batch(lcs_needles)
    lcs_p50 = _p50(lambda: index.longest_substring_match_batch(lcs_needles), 5)
    full = st.SuffixArray(text, torch.from_numpy(sa_host).to("cuda"))
    shorter = 0
    for nd, r, want_len in zip(lcs_needles, res, full_lens):
        check(r.as_bytes() == nd[: r.len], "partitioned match bytes wrong")
        check(r.len <= want_len, "partitioned match longer than the full "
                                 "index's")
        if r.len < want_len:
            # allowed only if every optimal occurrence crosses a boundary
            shorter += 1
            count, lo = sa_search_batch(full, [nd[:want_len]])[0]
            occ = full.sa[lo : lo + count]
            inside = (occ // psize) == ((occ + (want_len - 1)) // psize)
            check(not bool(inside.any()),
                  "partitioned match shorter though an optimal occurrence "
                  "lies inside one partition")
    say(f"phase 8: {len(res)} partitioned LCS answers obey the three "
        f"invariants against the full index ({shorter} shorter, every "
        f"optimal occurrence of theirs across a boundary); p50 batch "
        f"{lcs_p50 * 1e3:.3f} ms [{card}]")

    rng = np.random.default_rng(8)
    exact = [b"e"]
    while len(exact) < 64:
        m = int(rng.integers(2, 24))
        s0 = int(rng.integers(0, n - m))
        exact.append(text_np[s0 : s0 + m].tobytes() if len(exact) % 4
                     else rng.integers(0, 256, m, dtype=np.uint8).tobytes())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = index.sa_search_batch(exact)
    search_peak = torch.cuda.max_memory_allocated()
    search_p50 = _p50(lambda: index.sa_search_batch(exact), 5)
    for nd, (count, first), (fcount, lo) in zip(
            exact, got, sa_search_batch(full, exact)):
        occ = full.sa[lo : lo + fcount]
        occ = occ[(occ // psize) == ((occ + (len(nd) - 1)) // psize)]
        want = (int(occ.numel()),
                int(occ.min()) if occ.numel() else -1)
        check((count, first) == want,
              f"partitioned sa_search {(count, first)} against the full "
              f"index's in-partition occurrences {want} on {nd!r}")
    c = int(exact[0][0])
    check(index.sa_simplesearch(c)[0] == sa_simplesearch(full, c)[0],
          "partitioned sa_simplesearch count differs from the full index's")
    say(f"phase 8: 64 partitioned exact searches equal to the full index's "
        f"in-partition occurrences and least position ({got[0][0]} of "
        f"{exact[0]!r}, {sum(g[0] > 0 for g in got)} found), p50 batch "
        f"{search_p50 * 1e3:.3f} ms; peak CUDA memory {search_peak} B of which "
        f"{held} B held before; sa_simplesearch equal [{card}]")

    # 256 needles, never B * P * L elements: under the build's own peak
    many = lcs_needles[:255] + [b"e"]
    torch.cuda.reset_peak_memory_stats()
    index.sa_search_batch(many)
    many_peak = torch.cuda.max_memory_allocated()
    say(f"phase 8: 256 exact searches: peak CUDA memory {many_peak} B, the "
        f"build's {build_peak} B")
    check(many_peak < build_peak, "a partitioned search took more memory "
                                  "than the build")
    del index, full, text
    torch.cuda.empty_cache()

    for name, data, p in (("enwik_like(2^24 + 5)", enwik_like((1 << 24) + 5), 3),
                          ("5 bytes", b"abcab", 7)):
        batched = st.PartitionedSuffixArray(data, p)
        looped = st.PartitionedSuffixArray(data, p, engine="oracle")
        check(torch.equal(batched.sas, looped.sas),
              f"P={p} on {name}: the batched build differs from the host "
              f"loop over the oracle")
        say(f"phase 8: P={p} on {name} (partitions of "
            f"{batched.partition_size}): equal to the host loop over the "
            f"oracle")
    return {"n": n, "partitions": parts, "build_s": build_s,
            "rebuild_s": rebuild_s, "launches": launches,
            "peak_bytes": build_peak, "lcs_p50_s": lcs_p50,
            "search_p50_s": search_p50, "search_peak_bytes": search_peak,
            "search_256_peak_bytes": many_peak}


def phase9_cli() -> dict:
    import tempfile
    from stringsearch_torch.harness.cli import main as cli
    from stringsearch_torch.harness.corpus import enwik_like

    home = os.getcwd()
    steps = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "enwik24.bin")
        with open(path, "wb") as f:
            f.write(enwik_like(1 << 24))
        try:
            for argv in (["run", path, "--verify"],
                         ["bench", path, "--engines",
                          "doubling,dc3,bstar,oracle"],
                         ["queries", path, "--batch", "64,256", "--reps", "5"],
                         ["crosscheck", path, "--engines", ENGINES]):
                os.chdir(tmp)
                line = " ".join(argv[:1] + argv[2:])
                say(f"phase 9: $ cli {line}")
                t0 = time.perf_counter()
                rc = cli(argv)
                steps[line] = round(time.perf_counter() - t0, 4)
                check(rc == 0, f"cli {argv[0]} returned {rc}")
            traces = {}
            for where, device in (("gpu", []), ("cpu", ["--device", "cpu"])):
                work = os.path.join(tmp, where)
                os.mkdir(work)
                os.chdir(work)
                argv = ["crosscheck", path, "64k", "--trace", "--engines",
                        ENGINES, *device]
                line = " ".join(argv[:1] + argv[2:])
                say(f"phase 9: $ cli {line}")
                t0 = time.perf_counter()
                rc = cli(argv)
                steps[line] = round(time.perf_counter() - t0, 4)
                check(rc == 0, f"cli crosscheck --trace returned {rc}")
                with open("crosscheck/oracle", "rb") as f:
                    tail = f.read().split(b":: SA final")[-1]
                for engine in ENGINES.split(","):
                    with open(f"crosscheck/{engine}", "rb") as f:
                        traces[where, engine] = f.read()
                    check(traces[where, engine].split(b":: SA final")[-1]
                          == tail, f"the {where} {engine} trace does not end "
                                   f"in the oracle's SA")
            for engine in ENGINES.split(","):
                gpu = traces["gpu", engine]
                check(gpu == traces["cpu", engine],
                      f"the GPU {engine} trace differs from the CPU trace")
                say(f"phase 9: the GPU and CPU {engine} traces are "
                    f"byte-identical ({len(gpu)} B, {gpu.count(b':: ')} "
                    f"labels) and end in the oracle's SA")
        finally:
            os.chdir(home)
    say(f"phase 9: seconds by command: {json.dumps(steps)}")
    return steps


def phase10_fuzz(card: str) -> dict:
    from stringsearch_torch.harness import fuzz, microbench

    iters, iters64 = 40, 10
    t0 = time.perf_counter()
    rc = fuzz.main(["--iters", str(iters), "--max-len", "2048", "--seed", "1",
                    "--targets", "engines,partitioned,transforms",
                    "--engines", ENGINES])
    fuzz_s = time.perf_counter() - t0
    check(rc == 0, f"the fuzzer returned {rc}")
    say(f"phase 10: {iters} fuzz iterations of {ENGINES} clean in "
        f"{fuzz_s:.2f} s, {iters / fuzz_s:.2f} iterations/s [{card}]")
    t0 = time.perf_counter()
    rc = fuzz.main(["--iters", str(iters64), "--max-len", "2048", "--seed",
                    "2", "--idx64"])
    idx64_s = time.perf_counter() - t0
    check(rc == 0, f"the fuzzer with --idx64 returned {rc}")
    say(f"phase 10: {iters64} fuzz iterations with --idx64 clean in "
        f"{idx64_s:.2f} s")
    corpus = os.path.join(REPO, "tests", "corpus")
    names = sorted(os.listdir(corpus))
    for name in names:
        with open(os.path.join(corpus, name), "rb") as f:
            err = fuzz._check(f.read(), ENGINES.split(","),
                              set(fuzz.TARGETS), "cuda")
        check(err is None, f"tests/corpus/{name}: {err}")
    say(f"phase 10: all {len(names)} files of tests/corpus/ clean")
    walk = microbench.walk_probe(24)
    say(f"phase 10: walk_probe(24) [{card}]:")
    say(json.dumps(walk))
    check(all(math.isfinite(v) and v > 0 for row in walk["walkers"].values()
              for v in row.values()) and walk["t_pointer_jumping"] > 0,
          "walk_probe times are not all finite and positive")
    return {"iters": iters, "fuzz_s": fuzz_s, "idx64_iters": iters64,
            "idx64_s": idx64_s}


def phase11_engines(text_np, sa_host, card: str) -> dict:
    """dc3 and bstar on phase 3's text, each held against phase 3's SA."""
    import torch
    import stringsearch_torch as st

    n = len(text_np)
    text = torch.from_numpy(text_np.copy()).to("cuda")
    want = torch.from_numpy(sa_host).to("cuda")
    report = {}
    for name in ("dc3", "bstar"):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with SortLaunches(f"the {name} build") as count:
            t0 = time.perf_counter()
            sa = st.get_engine(name)(text)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(sa.sa.device.type == "cuda" and sa.sa.dtype == torch.int32,
              f"the {name} SA is not an int32 CUDA tensor")
        sa.verify()
        check(torch.equal(sa.sa, want),
              f"the {name} SA differs from phase 3's oracle-checked SA")
        del sa
        say(f"phase 11: {name} build n=2^{LOG2N}: {wall:.4f} s "
            f"({n / wall:.1f} B/s), radix sort launches {count.radix}, "
            f"bitonic launches 0, peak CUDA memory {peak} B of which {held} "
            f"B held before; verified and equal to phase 3's SA [{card}]")
        report[name] = {"n": n, "wall_s": wall, "launches": count.radix,
                        "peak_bytes": peak, "held_bytes": held}
    del text, want
    torch.cuda.empty_cache()
    return report


def _wide_cases(n: int, gen) -> list:
    """(name, planes, num_keys): the widths of the engines' wide sorts,
    with heavy ties, both ends of the int32 range and int64 keys."""
    import torch

    def rand(lo, hi, dtype=torch.int32):
        return torch.randint(lo, hi, (n,), dtype=dtype, device="cuda",
                             generator=gen)

    def pick(values, dtype=torch.int32):
        v = torch.tensor(values, dtype=dtype, device="cuda")
        return v[rand(0, len(values), torch.int64)]

    ends = [INT32_MIN, INT32_MIN + 1, -1, 0, 1, INT32_MAX - 1, INT32_MAX]
    iota = torch.arange(n, dtype=torch.int32, device="cuda")
    perm = torch.randperm(n, device="cuda", generator=gen).to(torch.int32)
    return [
        # the depth-24 initial sort: six packed keys and the position
        ("7 planes keys=6", [pick(ends) for _ in range(3)]
         + [rand(-3, 3) for _ in range(3)] + [iota], 6),
        # bstar's hop sort: eight hop words, the jump and the position
        ("10 planes keys=8", [pick(ends), rand(-2, 2)] + [
            rand(-2**31, INT32_MAX) if i % 3 else pick(ends)
            for i in range(6)] + [perm, iota], 8),
        # bstar's last extension stage
        ("35 planes keys=34", [pick(ends) if i % 2 else rand(-1, 1)
                               for i in range(34)] + [iota], 34),
        ("int64 keys 4 planes keys=3",
         [pick([-2**63, -2**32, -1, 0, 2**31, 2**32 - 1, 2**63 - 1],
               torch.int64), pick(ends),
          rand(-2**40, 2**40, torch.int64), iota.to(torch.int64)], 3),
    ]


def _key_planes(planes, num_keys) -> int:
    import torch

    return sum(2 if p.dtype == torch.int64 else 1 for p in planes[:num_keys])


def phase12_wide(text_np, sa_host, card: str) -> dict:
    """Every sort past six int32 planes: the depth-24 fault repaired at
    2^28 and with chunks, the integer build, int64 indexes, `wide_sort`
    against the plain sort and timed, bstar's extension stages. Each step's
    wall goes into `report["step_s"]`."""
    import torch
    import stringsearch_torch as st
    from stringsearch_torch import oracle
    from stringsearch_torch.engines import bstar, doubling
    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_torch.ops import bitonic

    report = {}
    steps = {}
    t_step = time.perf_counter()

    def step(name):
        nonlocal t_step
        now = time.perf_counter()
        steps[name] = round(now - t_step, 4)
        t_step = now

    text = torch.from_numpy(text_np.copy()).to("cuda")
    with SortLaunches("build_sa at depth 24") as count:
        t0 = time.perf_counter()
        sa24 = doubling.build_sa(text)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(torch.equal(sa24, torch.from_numpy(sa_host).to("cuda")),
          "build_sa at depth 24 differs from phase 3's depth-12 SA")
    del sa24, text
    say(f"phase 12: build_sa(depth=24) n=2^{LOG2N} (a seven-plane initial "
        f"sort): {wall:.4f} s, radix sort launches {count.radix}; equal to "
        f"phase 3's depth-12 SA [{card}]")
    report["depth24"] = {"n": 1 << LOG2N, "wall_s": wall,
                         "launches": count.radix}
    step("depth 24 at 2^28")

    data = enwik_like((1 << 24) + 5)
    chunk = len(data) // 3
    t = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy()).to(
        "cuda")
    with SortLaunches("the chunked build at depth 24") as count:
        deep = doubling.build_sa(t, chunk=chunk)
    check(torch.equal(deep, doubling.build_sa(t, depth=12, chunk=chunk)),
          "the chunked build at depth 24 differs from depth 12's")
    del deep, t
    say(f"phase 12: build_sa(depth=24, chunk) P=3 on 2^24 + 5 bytes: equal "
        f"to depth 12's, radix sort launches {count.radix}")
    report["depth24_chunk_launches"] = count.radix
    step("depth 24 with chunks at 2^24")

    # the reference: the main path's int32 build of the same bytes, checked
    # on the device (phase 4 holds the same build against the oracle on
    # enwik_like(2^24))
    t24 = torch.from_numpy(text_np[: 1 << 24].copy()).to("cuda")
    sa32, isa32 = doubling.build_with_isa(t24)
    st.SuffixArray(t24, sa32).verify()
    for depth in (4, 6):
        with SortLaunches(f"build_ints_with_isa(depth={depth})") as count:
            sa, isa = doubling.build_ints_with_isa(t24.to(torch.int32),
                                                   depth=depth)
        check(torch.equal(sa, sa32) and torch.equal(isa, isa32),
              f"build_ints_with_isa(depth={depth}) differs from the byte "
              f"build")
        say(f"phase 12: build_ints_with_isa(depth={depth}) on the 2^24 first "
            f"bytes as integers: SA and ISA equal to the verified byte "
            f"build's, radix sort launches {count.radix}")
        report[f"ints_depth{depth}_launches"] = count.radix
    with SortLaunches("build_with_isa(idx=int64)") as count:
        sa64, isa64 = doubling.build_with_isa(t24, idx=torch.int64)
    check(sa64.dtype == isa64.dtype == torch.int64
          and torch.equal(sa64, sa32.long()) and torch.equal(isa64,
                                                             isa32.long()),
          "build_with_isa(idx=int64) differs from the int32 build")
    say(f"phase 12: build_with_isa(idx=int64) on 2^24 bytes: int64 SA and "
        f"ISA equal to the verified int32 build's, radix sort launches "
        f"{count.radix}")
    report["int64_launches"] = count.radix
    del t24, sa, isa, sa64, isa64, sa32, isa32
    torch.cuda.empty_cache()
    step("integer and int64 builds at 2^24")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    shapes = []
    for name, planes, nk in _wide_cases(1 << 24, gen):
        with SortLaunches(f"wide_sort {name}") as count:
            got = bitonic.device_sort(planes, nk)
        want = bitonic.plain_sort(planes, nk)
        err = _exact_err(got, want)
        expect = math.ceil(_key_planes(planes, nk) / 5)
        say(f"phase 12: wide_sort {name} n=2^24: max_abs_err={err} "
            f"(tolerance 0), radix sort launches {count.radix} (want "
            f"{expect})")
        check(err == 0, f"wide_sort disagrees with the plain sort on {name}")
        check(count.radix == expect, f"wide_sort {name} launched "
                                     f"{count.radix} sorts, not {expect}")
        shapes.append({"shape": name, "n": 1 << 24, "max_abs_err": err,
                       "launches": count.radix})
        del got, want, planes
    torch.cuda.empty_cache()
    step("wide_sort against plain_sort at 2^24")
    for log2n in (26, 28):
        n = 1 << log2n
        for c, nk in ((7, 6), (10, 8)):
            planes = [torch.randint(-2**31, 2**31, (n,), dtype=torch.int32,
                                    device="cuda", generator=gen)
                      for _ in range(nk)]
            planes += [torch.arange(n, dtype=torch.int32, device="cuda")
                       for _ in range(c - nk)]
            with SortLaunches(f"wide_sort C={c} n=2^{log2n}") as count:
                got = bitonic.device_sort(planes, nk)
            want = bitonic.plain_sort(planes, nk)
            err = _exact_err(got, want)
            del got, want
            ms = cuda_ms(lambda: bitonic.device_sort(planes, nk), 2)
            library_ms = cuda_ms(lambda: bitonic.plain_sort(planes, nk), 1)
            bounds = sort_bounds(n, c, nk)
            say(f"phase 12: wide_sort C={c} keys={nk} n=2^{log2n}: "
                f"max_abs_err={err} (tolerance 0), {count.radix} launches, "
                f"{ms:.3f} ms; chained torch.sort {library_ms:.3f} ms; bound "
                f"{bounds['bound_ms']} ms (every plane once) [{card}]")
            check(err == 0, f"wide_sort disagrees with the plain sort at "
                            f"C={c} n=2^{log2n}")
            shapes.append({"shape": f"wide C={c} keys={nk}", "n": n,
                           "max_abs_err": err, "launches": count.radix,
                           "ms": round(ms, 4),
                           "plain_ms": round(library_ms, 4),
                           "library_ms": round(library_ms, 4), **bounds})
            del planes
            torch.cuda.empty_cache()
    report["wide_sort"] = shapes
    step("wide_sort timed at 2^26 and 2^28")

    # every B* window of the repeats is 203 bytes long: past the 16 + 16 +
    # 32 + 64 bytes of the bounded stages at any size
    log2r = 20
    unit = b"a" * 200 + b"b"
    data = (unit * 3 * ((1 << log2r) // len(unit) + 1))[: 1 << log2r]
    seen = []

    def logged(operands, num_keys=1):
        operands = tuple(operands)
        seen.append(len(operands))
        return bitonic.device_sort(operands, num_keys)

    bstar.device_sort = logged
    try:
        with SortLaunches("bstar on the repeats") as count:
            t0 = time.perf_counter()
            sa = bstar.sort(data, device="cuda").sa
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        bstar.device_sort = bitonic.device_sort
    same = np.array_equal(sa.cpu().numpy(), oracle.build(data))
    stages = [c for c in seen if c in (7, 11, 19, 35)]
    say(f"phase 12: bstar on 2^{log2r} bytes of (a*200 + b)*3: {wall:.4f} s, "
        f"radix sort launches {count.radix}, extension sorts of {stages} "
        f"planes; equal to oracle.build: {same}")
    check(same, "bstar differs from the oracle on the repeats")
    check(35 in stages, "bstar's unbounded extension stage did not run")
    report["bstar_repeats"] = {"n": 1 << log2r, "wall_s": wall,
                               "launches": count.radix,
                               "extension_planes": stages}
    step("bstar on the repeats")
    say(f"phase 12: seconds by step: {json.dumps(steps)}")
    report["step_s"] = steps
    return report


class PlainSortCalls:
    """Counts the calls of `plain_sort` (the CPU route of `device_sort`)
    while it is entered."""

    def __enter__(self):
        from stringsearch_torch.ops import bitonic

        self.calls = 0
        self._plain = bitonic.plain_sort

        def counted(operands, num_keys=1):
            self.calls += 1
            return self._plain(operands, num_keys)

        bitonic.plain_sort = counted
        return self

    def __exit__(self, *exc):
        from stringsearch_torch.ops import bitonic

        bitonic.plain_sort = self._plain


def _expected_traffic(g) -> int:
    """The bytes a shard sends in g's build by the comm model, for the
    rounds that ran (full-width and compacted)."""
    from stringsearch_torch.parallel.comm_model import (
        compact_round_bytes_per_device, global_build_comm)

    full = global_build_comm(g.n, g.num_shards, depth=g.depth, fan=g.fan,
                             rounds=g.rounds_executed).total_bytes
    return full + g.compact_rounds_executed * compact_round_bytes_per_device(
        g.num_shards, g.chunk_len, g.fan)


def phase13_global(text_np, sa_host, lcs_needles, full_lens,
                   card: str) -> dict:
    """The exact global SA on four shards of the one card, and the rest of
    the multi-device layer's surface."""
    import tempfile
    import torch
    from stringsearch_torch import NotSorted, oracle
    from stringsearch_torch.harness import fuzz, scaling
    from stringsearch_torch.harness.cli import main as cli
    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_torch.harness.profile_build import _syncs
    from stringsearch_torch.parallel import collectives, distsort, global_sa
    from stringsearch_torch.parallel.comm_model import global_build_comm
    from stringsearch_torch.parallel.global_sa import build_global
    from stringsearch_torch.parallel.mesh import make_mesh

    steps = {}
    t_step = [time.perf_counter()]

    def step(what):
        now = time.perf_counter()
        steps[what] = round(now - t_step[0], 4)
        t_step[0] = now

    n = len(text_np)
    shards = 4
    cuda = torch.device("cuda", 0)
    mesh = make_mesh(devices=[cuda] * shards)
    text = torch.from_numpy(text_np.copy()).to(cuda)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    collectives.reset_traffic()
    distsort.fallbacks.clear()
    global_sa.compact_fallbacks = 0
    built = []
    with SortLaunches("the global build") as count, PlainSortCalls() as plain:
        t0 = time.perf_counter()
        syncs = _syncs(lambda: built.append(build_global(text, mesh)))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    g = built.pop()
    peak = torch.cuda.max_memory_allocated()
    launches = count.radix
    moved = collectives.bulk_bytes_per_shard(shards)
    fell_back = dict(distsort.fallbacks)
    compact_fell_back = global_sa.compact_fallbacks
    check(plain.calls == 0, f"the global build called the plain sort "
                            f"{plain.calls} times")
    check(all(s.device == cuda for s in g._sa_sharded + g.rank),
          "a shard of the global build left the card")
    step("the first build")
    check(np.array_equal(g.suffix_array(), sa_host),
          "the global SA differs from phase 3's oracle-checked SA")
    step("SA fetched and compared with phase 3's")
    t0 = time.perf_counter()
    g.verify()
    verify_s = time.perf_counter() - t0
    good = g.rank[1]
    g.rank[1] = good.clone()
    g.rank[1][5] = g.rank[1][6]
    try:
        g.verify()
        caught = False
    except NotSorted as e:
        caught = "permutation" in str(e)
    g.rank[1] = good
    check(caught, "the sharded verify accepted a corrupted rank")
    step("verify, and its catch of a corrupted rank")

    report = g.comm_report()
    model = global_build_comm(n, shards, depth=g.depth, fan=g.fan,
                              rounds=g.rounds_run)
    check(report == model, "comm_report() differs from global_build_comm")
    expected = _expected_traffic(g)
    say(f"phase 13: global build n=2^{LOG2N} on {shards} shards of one card: "
        f"{first_s:.4f} s, radix sort launches {launches}, plain sort "
        f"calls {plain.calls}, host syncs {syncs}, peak CUDA memory {peak} B "
        f"of which {held} B held before, rounds_run {g.rounds_run} "
        f"(ran {g.rounds_executed}), compact_rounds_run "
        f"{g.compact_rounds_run} (ran {g.compact_rounds_executed}), "
        f"fallbacks {fell_back} / compacted {compact_fell_back}; SA equal to "
        f"phase 3's, sharded verify {verify_s:.4f} s [{card}]")
    say(f"phase 13: bytes each shard sent (ppermute + all_to_all): {moved}; "
        f"comm model for the rounds that ran {expected}; comm_report() "
        f"{report.total_bytes} for rounds_run {report.rounds} (initial "
        f"{report.initial_bytes}, per round {report.per_round_bytes})")
    if not fell_back and not compact_fell_back:
        check(max(moved) == expected,
              "the collectives moved other bytes than the comm model counts")

    walls = []
    for _ in range(2):
        del g
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = build_global(text, mesh)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    say(f"phase 13: two warm global builds {walls[0]:.4f}, {walls[1]:.4f} s "
        f"({n / min(walls):.1f} B/s at the faster) [{card}]")
    step("two warm builds")

    queries = {}
    for mode in ("replicated", "sharded"):
        t0 = time.perf_counter()
        res = g.longest_substring_match_batch(lcs_needles, text_mode=mode)
        queries[f"lcs_{mode}_s"] = time.perf_counter() - t0
        for nd, r, want in zip(lcs_needles, res, full_lens):
            check(r.len == want and r.as_bytes() == nd[:r.len],
                  f"global LCS ({mode}) differs from the flat index")
    rng = np.random.default_rng(13)
    exact = []
    for i in range(64):
        m = int(rng.integers(1, 40))
        s = int(rng.integers(0, n - m))
        exact.append(text_np[s:s + m].tobytes() if i % 4 else
                     rng.integers(0, 256, m, dtype=np.uint8).tobytes())
    exact.append(b"e")
    want = [oracle.search(text_np, nd, sa_host) for nd in exact]
    for mode in ("replicated", "sharded"):
        t0 = time.perf_counter()
        got = g.sa_search_batch(exact, text_mode=mode)
        queries[f"search_{mode}_s"] = time.perf_counter() - t0
        check(got == want, f"global sa_search ({mode}) differs from the "
                           f"oracle")
        for c in (0, 32, 101, 255):
            check(g.sa_simplesearch(c, mode)
                  == oracle.simplesearch(text_np, c, sa_host),
                  f"global simplesearch ({mode}) differs on byte {c}")
    say(f"phase 13: {len(lcs_needles)} LCS answers equal to the flat "
        f"index's and {len(exact)} exact searches and 4 simplesearch bytes "
        f"equal to the oracle's, both text modes; seconds "
        f"{json.dumps({k: round(v, 4) for k, v in queries.items()})}")
    del g, text
    torch.cuda.empty_cache()
    step("queries in both text modes")

    small = {}
    distsort.fallbacks.clear()
    global_sa.compact_fallbacks = 0
    mesh8 = make_mesh(devices=[cuda] * 8)
    compacted = 0
    for name, data in (("ab*2^19", b"ab" * (1 << 19)),
                       ("all-equal 2^20", bytes([7]) * (1 << 20)),
                       ("enwik_like(2^20)", enwik_like(1 << 20))):
        with SortLaunches(f"phase 13: {name} on 8 shards") as count:
            t0 = time.perf_counter()
            g8 = build_global(data, mesh8)
            wall = time.perf_counter() - t0
        check(np.array_equal(g8.suffix_array(), oracle.build(data)),
              f"the 8-shard global SA of {name} differs from the oracle")
        g8.verify()
        compacted += g8.compact_rounds_run
        small[name] = {"wall_s": wall, "launches": count.radix,
                       "rounds_run": g8.rounds_run,
                       "compact_rounds_run": g8.compact_rounds_run}
        say(f"phase 13: {name} on 8 shards: {wall:.4f} s, radix sort "
            f"launches {count.radix}, rounds_run {g8.rounds_run}, "
            f"compact_rounds_run {g8.compact_rounds_run}; equal to "
            f"oracle.build, verified")
        del g8
    say(f"phase 13: merge-split fallbacks {dict(distsort.fallbacks)}, "
        f"compacted-round fallbacks {global_sa.compact_fallbacks}")
    check(compacted > 0, "no 2^20 input entered the compacted rounds")
    check(sum(distsort.fallbacks.values()) > 0,
          "no 2^20 input entered the merge-split fallback")
    small["fallbacks"] = dict(distsort.fallbacks)
    small["compact_fallbacks"] = global_sa.compact_fallbacks
    step("2^20 on eight shards")

    scale = {}
    for mode in ("global", "partitioned"):
        rows = scaling.measure(1 << 24, reps=2, devices=[cuda] * 8,
                               mode=mode)
        scale[mode] = [{"shards": k, "s": dt, "bytes_per_s": bps,
                        "devices": ndev} for k, dt, bps, _rep, ndev in rows]
        say(f"phase 13: scaling.measure(2^24, {mode}), k shards sharing one "
            f"card (not a scaling result): " + ", ".join(
                f"k={k} {dt:.4f} s" for k, dt, *_rest in rows))
    step("scaling.measure at 2^24")

    home = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "enwik24.bin")
        with open(path, "wb") as f:
            f.write(enwik_like(1 << 24))
        try:
            os.chdir(tmp)
            rc = cli(["crosscheck", path, "--engines", "doubling,global"])
            check(rc == 0, f"cli crosscheck --engines doubling,global "
                           f"returned {rc}")
            step("cli crosscheck --engines doubling,global at 2^24")
            traces = {}
            for where, device in (("gpu", []), ("cpu", ["--device", "cpu"])):
                work = os.path.join(tmp, where)
                os.mkdir(work)
                os.chdir(work)
                rc = cli(["crosscheck", path, "64k", "--trace", "--engines",
                          "global", *device])
                check(rc == 0, f"cli crosscheck --trace global ({where}) "
                               f"returned {rc}")
                with open("crosscheck/global", "rb") as f:
                    traces[where] = f.read()
            check(traces["gpu"] == traces["cpu"],
                  "the GPU global trace differs from the CPU trace")
            say(f"phase 13: the GPU and CPU global traces are byte-identical "
                f"({len(traces['gpu'])} B, "
                f"{traces['gpu'].count(b':: ')} labels)")
            step("crosscheck --trace global on 64k, GPU and CPU")
        finally:
            os.chdir(home)

    for extra in ([], ["--idx64"]):
        t0 = time.perf_counter()
        rc = fuzz.main(["--iters", "6", "--max-len", "2048", "--seed", "7",
                        "--targets", "global", *extra])
        check(rc == 0, f"fuzz --targets global {' '.join(extra)} "
                       f"returned {rc}")
        say(f"phase 13: 6 fuzz iterations of the global target"
            f"{''.join(' ' + e for e in extra)} clean in "
            f"{time.perf_counter() - t0:.2f} s")
    step("fuzz --targets global")
    say(f"phase 13: seconds by step: {json.dumps(steps)}")
    return {"n": n, "shards": shards, "first_s": first_s,
            "warm_walls_s": walls, "launches": launches,
            "plain_sort_calls": plain.calls, "host_syncs": syncs,
            "peak_bytes": peak, "held_bytes": held,
            "rounds_run": report.rounds, "comm_bytes": report.total_bytes,
            "bytes_moved": moved, "fallbacks": fell_back,
            "compact_fallbacks": compact_fell_back, "queries": queries,
            "eight_shards_2_20": small, "scaling_2_24": scale,
            "step_s": steps}


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

    try:
        phase1_build_kernels()
        t0 = time.perf_counter()
        sorts = phase2_sorts_vs_plain()
        say(f"phase 2: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        sa, text_np, sa_host, build = phase3_build()
        say(f"phase 3: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        phase4_exact()
        say(f"phase 4: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        queries, lcs_needles, lcs_lens = phase5_queries(sa, text_np, sa_host)
        say(f"phase 5: passed in {time.perf_counter() - t0:.2f} s")
        del sa
        t0 = time.perf_counter()
        radix_report, probe_sort_launches = phase6_radix()
        say(f"phase 6: passed in {time.perf_counter() - t0:.2f} s")
        phase_launches = {}
        t0 = time.perf_counter()
        with SortLaunches("phase 7", phase_launches):
            bwt_report = phase7_bwt(text_np, sa_host, card)
        say(f"phase 7: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        with SortLaunches("phase 8", phase_launches):
            partitioned_report = phase8_partitioned(
                text_np, sa_host, lcs_needles, lcs_lens, card)
        say(f"phase 8: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        with SortLaunches("phase 9", phase_launches):
            cli_steps = phase9_cli()
        say(f"phase 9: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        with SortLaunches("phase 10", phase_launches):
            fuzz_report = phase10_fuzz(card)
        say(f"phase 10: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        engines_report = phase11_engines(text_np, sa_host, card)
        say(f"phase 11: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        wide_report = phase12_wide(text_np, sa_host, card)
        say(f"phase 12: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        global_report = phase13_global(text_np, sa_host, lcs_needles,
                                       lcs_lens, card)
        say(f"phase 13: passed in {time.perf_counter() - t0:.2f} s")
        del text_np, sa_host
    except SmokeFailure as e:
        say(f"FAIL: {e}")
        return 1

    # each radix-partition kernel's headline: the first shape it was timed
    # at, the one radix_probe times (random keys, tile 8192 / 1024, granule
    # 128)
    radix_kernels = []
    for name, line in (("hist", 92), ("dest", 145), ("place", 191),
                       ("flush", 291)):
        rep = radix_report[name]
        head = rep["shapes"][0]
        radix_kernels.append({
            "name": f"radix_{name}",
            "route": "cuda",
            "source": "stringsearch_torch/ops/csrc/radix.cu",
            "replaces": f"stringsearch_tpu/ops/radix.py:{line}",
            "launches": rep["launches"],
            "max_abs_err": max(s["max_abs_err"] for s in rep["shapes"]),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "timed_shape": head["shape"],
            "shapes": rep["shapes"],
        })

    def sort_entry(name, source, launches, **more):
        # headline: the round sort, the main path's largest, at its size
        shapes = sorts[name]["shapes"]
        head = next(s for s in shapes if s["shape"].startswith("round")
                    and s["n"] == 1 << LOG2N)
        errs = [s["max_abs_err"] for s in shapes]
        if "fault_repair" in more:
            errs += [s["max_abs_err"]
                     for s in more["fault_repair"]["wide_sort"]]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": "stringsearch_tpu/ops/bitonic.py:240",
            "also_replaces": "stringsearch_tpu/ops/bitonic.py:263",
            "launches": launches,
            "max_abs_err": max(errs),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "timed_shape": f"{head['shape']} n={head['n']}",
            "shapes": shapes,
            **more,
        }

    say(json.dumps({"kernels": [
        sort_entry("radix_sort", "stringsearch_torch/ops/csrc/radix_sort.cu",
                   build["launches"], probe_launches=probe_sort_launches,
                   plain_radix_sort=sorts["radix_sort"]["plain_radix_sort"],
                   build=build, queries=queries,
                   phase_launches=phase_launches, cli_step_s=cli_steps,
                   bwt=bwt_report,
                   partitioned=partitioned_report, fuzz=fuzz_report,
                   engines=engines_report, fault_repair=wide_report,
                   global_build=global_report),
        sort_entry("bitonic_sort", "stringsearch_torch/ops/csrc/bitonic.cu",
                   build["bitonic_launches"]),
        *radix_kernels]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
