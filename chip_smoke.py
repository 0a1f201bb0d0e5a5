#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's main path once at the benchmark's size and fails
(non-zero exit, no result line) on any failed check, or when no GPU is
present. Phases, each printed with its result and time:

  0. versions, the card's name and power limit;
  1. build the six kernel libraries from the sources in the checkout:
     the radix sort behind `device_sort`, the bitonic sort, the
     radix-partition kernels, the steps between the sorts, the global
     build's merge-split and its routing kernels (one nvcc per source, all
     started together);
  2. both sort kernels against the plain sort at 2^24 and 2^24 + 12345,
     tolerance 0: the radix sort, which is stable, element for element on
     every plane (heavy ties under a random payload, INT32_MIN/MAX keys,
     a constant key plane, a two-bit plane, ranks below 2^24 and all
     planes constant among the cases), and against its own plain version
     `plain_radix_sort`; the bitonic sort on its keys, its payloads as
     multisets per tied block, and on every plane against its own plain
     version `plain_bitonic_sort` (the same network in torch ops), also
     at n = 2, 3, a tile less one, a tile, a tile and one, 100,003 and
     2^18 at the three shapes. Then the radix sort, the bitonic sort and
     the chained `torch.sort` timed with CUDA events at the main path's
     three shapes at 2^28 on full-range random keys (the round shape's
     bitonic output against `plain_bitonic_sort` on every plane), and the
     radix sort and the chained `torch.sort` on ranks below 2^28 with the
     position as payload, beside the sort's bound and the radix design's
     own bytes; the bitonic sort's passes at 2^24 and 2^28 (its library's
     schedule equal to `ops/bitonic.py:schedule`, at most 39 at 2^28);
     the three sorts at 2^12, 2^16, 2^20 and 2^24 beside the bound, the
     first key plane half dense ties;
  3. `build_suffix_array(enwik_like(2^28), device="cuda")`, then the
     device verify and the host oracle's sufcheck; over the build the
     radix sort's launch count must be > 0 and the bitonic sort's 0, and
     each of the four step kernels' of the flat build (`ops/steps.py`:
     `pack_keys`, `shift_planes`, `head_ranks`, `invert_ranks`) > 0;
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
     passing and rejecting the state with one rank corrupted; over the
     first build the merge-split kernel's launches (`ops/merge.py`), the
     sharded head ranking's (`ops/steps.py:shard_head_ranks`) and those of
     the four routing and placement kernels (`ops/route.py`:
     `route_partition`, `place_received`; `ops/steps.py`:
     `shard_pack_keys`, `shard_shift_planes`) must be > 0, and the radix
     sort's are printed beside the counts of the routes before them; with
     the plain sort's calls (none), host syncs,
     peak memory, rounds, the bytes the collectives moved against the comm
     model, and the wall of two warm builds; phase 5's LCS needles in both
     text modes equal to the flat index's answers, `sa_search_batch` and
     `sa_simplesearch` equal to the oracle's; at 2^20 on eight shards
     (`b"ab" * 2^19`, all-equal bytes, enwik-like text) each equal to
     `oracle.build`, with compaction and the merge-split fallback entered;
     `build_global(fan=8)` and `fan=9` on four shards at 2^24 (a round's
     route of nine and ten operands, past one launch's eight), each equal
     to the flat SA; builds on 512 shards of the card: at 2^24 (L = 2^15,
     where the pairs' capacity holds) equal to the flat SA with no
     redistribute fallback, and at 2^20 (L = 2048, where both routes
     overflow and fall back, as in the JAX package) equal to
     `oracle.build`; `scaling.measure(2^24)` at 1, 2, 4, 8 shards of the card in both
     modes; `cli crosscheck --engines doubling,global` on 2^24 bytes, and
     `--trace` of the global engine on 64 KiB on the GPU and the CPU,
     byte-identical; `fuzz --targets global`, also with `--idx64`;
 14. the global build across two processes: `multihost.run_selftest(
     nproc=2, devs_per_proc=2, device="cuda", backend="gloo")` on phase 3's
     text, each process holding two of the four shards on the one card
     (gloo, staged through the host: NCCL refuses two ranks on one card,
     so the NCCL route is not run, and a line says so). Phase 3's SA goes
     to a temporary `.npy`; each process holds its SA shards against the
     matching slice of it element for element, runs the sharded `verify()`
     (and its catch of a corrupted rank), times a cold and a warm build
     with its radix sort, merge-split, sharded head-ranks and routing and
     placement launches > 0 (the radix sort's printed beside the routes
     before) and its plain sort calls 0, and
     prints its wall, the bytes that crossed processes, the transport's
     seconds, the bytes per shard against the comm model and its peak
     memory. The processes' exact searches and single-byte counts must
     equal the oracle's, and every answer must agree across them;
 15. the four step kernels against their plain versions, tolerance 0:
     `pack_keys` on phase 3's text (depth 12, flat and in four chunks),
     `head_ranks` on its own sort of those operands, `invert_ranks` on
     that sort's order (also beside the C=2 radix sort it replaced),
     `shift_planes` of a fan-4 round at h = 12 on the text-order ranks of
     that sort, and
     `head_ranks` on the round's sort and on one group over all 2^28
     slots (the longest look-back); each timed with CUDA events beside
     its plain version and its bytes bound, `head_ranks` also beside
     `torch.cummax` of `where(flag, j, -1)` (the scan alone); then the edge
     cases of tests/test_torch_steps.py: n from 1 to 2^20 + 12345 around
     each kernel's tile, chunks 4 and near 1000, depths 4, 12 and 24,
     fans 2 to 4 with h at and past the chunk, all-equal keys over 2^24
     slots, all-distinct keys, groups that start only at tile starts,
     random and striped permutations to 2^24 + 12345 (both designs of
     `invert_ranks`, into a new plane and an [n + 1] buffer), int32 and
     int64;
 16. the global build's two kernels against their plain versions,
     tolerance 0: `merge_split` on the first merge of phase 13's initial
     sort (L = 2^26 a shard, four packed key words and the position, both
     halves), timed beside its plain version (the chained stable
     `torch.sort` of the concatenation), the route it replaced (the
     `device_sort` of the concatenation) and its bytes bound; then at
     L = 2^24 on all-equal keys, one run wholly below the other,
     interleaved runs and a tie group straddling the split, in int32,
     int64 and mixed planes, every half and order, and at small L around
     its tile and at every width a caller of `sharded_sort` passes;
     `shard_head_ranks` on shards 0 and 1 of that sort's output (the
     previous shard's last key tuple as slot 0's predecessor), timed
     beside its plain chain, `torch.cummax` of the scan and its bound,
     and on a shard wholly inside one group (the longest look-back), then
     its edge cases: n around its tile, with and without a predecessor,
     int32 and int64;
 17. the global build's four routing and placement kernels against their
     plain versions, tolerance 0, on the operands of phase 13's build
     (shard 1 of four, L = 2^26, and the last shard where its edge
     differs): `shard_pack_keys` of the initial operands, with and without
     the next shard's bytes; `route_partition` of the initial
     redistribute (gidx and head-slot ranks, by window of the receiver's
     slots) and of the first round's `rank_interval_sort` (four int32,
     four int64 and nine int32 planes); `place_received` of what the
     redistribute delivered; `shard_shift_planes` of the first round; each
     timed beside its plain version, the chain it replaced (the routing
     sort, rank and scatters) and its bytes bound; the permutation
     route and placement at 64, 128, 256 and 512 windows a destination
     (512: two ranges of library calls); then the edge cases of
     tests/test_torch_route.py and tests/test_torch_route_caps.py: n
     around each tile, P from 1 to 1100, buckets past one call's, 9 and 17
     operands, destinations at and past cap, clamped and out-of-range
     sources, int32 and int64, windows, placement by window, h at and
     past L and n_pad.
Phases 9, 12 and 13 print the seconds of each command or step.
Phases 7 to 10 each zero the sort kernels' launch counts first and need
the radix sort's > 0 and the bitonic sort's 0 afterwards; phases 11 to 14
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
from collections import Counter

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
# the step kernels of the flat build (phase 3)
FLAT_STEPS = ("pack_keys", "shift_planes", "head_ranks", "invert_ranks")
# radix sort launches of the global build at 2^28 on four shards, and of
# one process of two, before merge_split took the merges (PERF.md §6),
# and before the routing kernels took the routing sorts
EARLIER_GLOBAL_RADIX = 32
EARLIER_PROCESS_RADIX = 16
UNROUTED_GLOBAL_RADIX = 20
UNROUTED_PROCESS_RADIX = 10
# the global build's routing and placement kernels: (name, module)
ROUTE_KERNELS = (("route_partition", "route"), ("place_received", "route"),
                 ("shard_pack_keys", "steps"),
                 ("shard_shift_planes", "steps"))


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


def radix_design_ms(n: int, c: int, nk: int, live) -> float:
    """What the radix design's own traffic costs at the card's memory rate
    (`radix_sort.design_bytes`: one read of the key planes for every
    histogram, then all c planes read and written by each live pass, and
    the look-back words). More bytes than the function needs, so not a
    bound of the function: printed beside `bound_ms`, reported nowhere."""
    from stringsearch_torch.ops import radix_sort

    return round(radix_sort.design_bytes(n, c, nk, live) / BYTES_PER_S * 1e3,
                 4)


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


def timed_once(fn) -> tuple:
    """(device ms, result) of one run of fn(), with CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def _bitonic_planes(n: int, c: int, nk: int, gen) -> list:
    """nk full-range random key planes, the first half of the first one
    dense ties, then position planes."""
    import torch

    ops = [torch.randint(-2**31, INT32_MAX, (n,), dtype=torch.int32,
                         device="cuda", generator=gen) for _ in range(nk)]
    if n > 4:
        ops[0][: n // 2] = torch.randint(-2, 2, (n // 2,), dtype=torch.int32,
                                         device="cuda", generator=gen)
    return ops + [torch.arange(n, dtype=torch.int32, device="cuda")
                  for _ in range(c - nk)]


def _bitonic_edge_cases(gen) -> list:
    """The bitonic sort at the edges of its tile and schedule, at the main
    path's shapes: n of 2, 3, a tile less one, a tile, a tile and one,
    100,003 and 2^18, every plane against plain_bitonic_sort and the keys
    against the plain sort, tolerance 0."""
    from stringsearch_torch.ops import bitonic

    out = []
    for name, c, nk in SORT_SHAPES:
        tile = 1 << bitonic.tile_log(c)
        for n in (2, 3, tile - 1, tile, tile + 1, 100_003, 1 << 18):
            ops = _bitonic_planes(n, c, nk, gen)
            got = bitonic.bitonic_sort(ops, nk)
            err = max(_exact_err(got, bitonic.plain_bitonic_sort(ops, nk)),
                      _exact_err(got[:nk], bitonic.plain_sort(ops, nk)[:nk]))
            check(err == 0, f"the bitonic sort disagrees with its plain "
                            f"versions at {name} n={n}")
            out.append({"shape": f"{name} C={c} keys={nk}", "n": n,
                        "max_abs_err": err})
    say(f"phase 2: bitonic sort at n = 2, 3, tile - 1, tile, tile + 1, "
        f"100003, 2^18 on the three shapes: max_abs_err "
        f"{max(e['max_abs_err'] for e in out)} on every plane (tolerance 0)")
    return out


def _bitonic_passes() -> dict:
    """Passes of one bitonic sort by shape at 2^24 and 2^28, the kernel's
    own schedule held against `schedule`'s, and at most 39 at 2^28."""
    from stringsearch_torch.ops import bitonic

    out = {}
    for name, c, nk in SORT_SHAPES:
        for log2n in (24, LOG2N):
            n = 1 << log2n
            listed = bitonic.schedule(n, c)
            check(bitonic.kernel_schedule(n, c) == listed,
                  f"the kernel's schedule differs from schedule({n}, {c})")
            out[f"{name} C={c} 2^{log2n}"] = len(listed)
    say(f"phase 2: bitonic passes over the planes (the kernel's schedule "
        f"equal to ops/bitonic.py:schedule): {out}")
    check(all(v <= 39 for k, v in out.items() if k.endswith(f"2^{LOG2N}")),
          "a bitonic sort at 2^28 makes more than 39 passes")
    return out


def _bitonic_sizes(gen) -> list:
    """The bitonic sort, the radix sort and the chained `torch.sort` at
    2^12, 2^16, 2^20 and 2^24 at the three shapes on `_bitonic_planes`
    (full-range random keys, half of the first plane dense ties), beside
    the bound (2^28 is timed with the main loop above)."""
    from stringsearch_torch.ops import bitonic, radix_sort

    out = []
    for log2n in (12, 16, 20, 24):
        n = 1 << log2n
        reps = 20 if log2n <= 16 else 5
        for name, c, nk in SORT_SHAPES:
            ops = _bitonic_planes(n, c, nk, gen)
            row = {"shape": f"{name} C={c} keys={nk}", "n": n,
                   "passes": len(bitonic.schedule(n, c)),
                   "bitonic_ms": cuda_ms(
                       lambda: bitonic.bitonic_sort(ops, nk), reps),
                   "radix_ms": cuda_ms(
                       lambda: radix_sort.radix_sort(ops, nk), reps),
                   "library_ms": cuda_ms(
                       lambda: bitonic.plain_sort(ops, nk), reps),
                   **sort_bounds(n, c, nk)}
            say(f"phase 2: 2^{log2n} {row['shape']}: bitonic "
                f"{row['bitonic_ms']:.4f} ms in {row['passes']} passes, "
                f"radix {row['radix_ms']:.4f} ms, chained torch.sort "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']} ms")
            out.append({k: round(v, 4) if isinstance(v, float) else v
                        for k, v in row.items()})
            del ops
    return out


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
        # the skipped passes: a constant key plane between two live ones
        ("constant plane C=4 keys=3", 3,
         [rand(ragged, -4, 4), torch.full_like(iota, -77),
          rand(ragged, -2**31, INT32_MAX), iota]),
        # a partition index (two live bits) leading the keys
        ("two-bit plane C=5 keys=4", 4,
         [rand(ragged, 0, 4), rand(ragged, 0, 1 << 20),
          rand(ragged, -8, 1 << 20), rand(ragged, -8, 8), iota]),
        # ranks below 2^24: the top digit of every key plane constant
        ("ranks below 2^24 C=5 keys=4", 4,
         [rand(n24, 0, n24) for _ in range(4)] + [iota[:n24]]),
        # every digit constant: the one pass left is a copy
        ("all planes constant C=3 keys=2", 2,
         [torch.full_like(iota, INT32_MAX), torch.full_like(iota, -1),
          iota]),
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
        # the same network in torch ops: every plane, payloads included
        network_err = _exact_err(got, bitonic.plain_bitonic_sort(ops, nk))
        del got, want
        radix_ms = cuda_ms(lambda: radix_sort.radix_sort(ops, nk), 3)
        bitonic_ms = cuda_ms(lambda: bitonic.bitonic_sort(ops, nk), 3)
        plain_ms = cuda_ms(lambda: bitonic.plain_sort(ops, nk), 3)
        say(f"phase 2: {name} n={n}: max_abs_err radix {radix_err}, bitonic "
            f"{bitonic_err}, bitonic against plain_bitonic_sort on every "
            f"plane {network_err} (tolerance 0); radix {radix_ms:.3f} ms, "
            f"bitonic {bitonic_ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(radix_err == 0, f"the radix sort disagrees with the plain sort "
                              f"on {name}")
        check(bitonic_err == 0, f"the bitonic sort disagrees with the plain "
                                f"sort on {name}")
        check(network_err == 0, f"the bitonic sort disagrees with "
                                f"plain_bitonic_sort on {name}")
        for kernel, err, ms in (("radix_sort", radix_err, radix_ms),
                                ("bitonic_sort",
                                 max(bitonic_err, network_err), bitonic_ms)):
            reports[kernel]["shapes"].append({
                "shape": name, "n": n, "max_abs_err": err,
                "ms": round(ms, 4), "plain_ms": round(plain_ms, 4)})
        del ops
    reports["bitonic_sort"]["edge_cases"] = _bitonic_edge_cases(gen)

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
        live = radix_sort.plan(ops, nk)[1]
        want = bitonic.plain_sort(ops, nk)
        got = radix_sort.radix_sort(ops, nk)
        torch.cuda.synchronize()
        radix_err = _exact_err(got, want)
        got = bitonic.bitonic_sort(ops, nk)
        torch.cuda.synchronize()
        bitonic_err = _exact_err(got[:nk], want[:nk])
        del want
        network_ms = None
        if name == "round":
            # the largest shape against its plain version on every plane,
            # timed in the one run (about 10 s of torch ops)
            network_ms, same = timed_once(
                lambda: bitonic.plain_bitonic_sort(ops, nk))
            bitonic_err = max(bitonic_err, _exact_err(got, same))
            del same
        del got
        radix_ms = cuda_ms(lambda: radix_sort.radix_sort(ops, nk), 2)
        bitonic_ms = cuda_ms(lambda: bitonic.bitonic_sort(ops, nk), 1)
        library_ms = cuda_ms(lambda: bitonic.plain_sort(ops, nk), 2)
        bounds = sort_bounds(n, c, nk)
        passes = len(bitonic.schedule(n, c))
        say(f"phase 2: {name} C={c} keys={nk} n=2^{LOG2N}: max_abs_err radix "
            f"{radix_err}, bitonic {bitonic_err} (keys; every plane against "
            f"plain_bitonic_sort on the round shape; tolerance 0); radix "
            f"{radix_ms:.3f} ms, bitonic {bitonic_ms:.3f} ms in {passes} "
            f"passes, chained torch.sort {library_ms:.3f} ms"
            + (f", plain_bitonic_sort {network_ms:.3f} ms"
               if network_ms else "")
            + f"; bound {bounds['bound_ms']} ms "
            f"(every plane once); the radix design's own bytes take "
            f"{radix_design_ms(n, c, nk, live)} ms ({sum(live)} of "
            f"{len(live)} passes live)")
        check(radix_err == 0, f"the radix sort disagrees with the plain sort "
                              f"at 2^{LOG2N}, {name}")
        check(bitonic_err == 0, f"the bitonic sort disagrees with the plain "
                                f"sorts at 2^{LOG2N}, {name}")
        for kernel, err, ms in (("radix_sort", radix_err, radix_ms),
                                ("bitonic_sort", bitonic_err, bitonic_ms)):
            # the chained torch.sort is the library call and, as
            # `plain_sort`, the plain version device_sort takes on the CPU;
            # the bitonic sort's plain version is plain_bitonic_sort
            plain_ms = library_ms
            if kernel == "bitonic_sort" and network_ms is not None:
                plain_ms = network_ms
            reports[kernel]["shapes"].append({
                "shape": f"{name} C={c} keys={nk}", "n": n,
                "max_abs_err": err, "ms": round(ms, 4),
                "plain_ms": round(plain_ms, 4),
                "library_ms": round(library_ms, 4), **bounds,
                **({"passes": passes} if kernel == "bitonic_sort" else {})})
        del ops
        torch.cuda.empty_cache()
    reports["bitonic_sort"]["passes"] = _bitonic_passes()
    reports["bitonic_sort"]["sizes"] = _bitonic_sizes(gen)

    # the same shapes on the main path's own keys: ranks below n, the
    # position as payload
    for name, c, nk in SORT_SHAPES:
        ops = [rand(n, 0, n) for _ in range(nk)]
        ops += [torch.arange(n, dtype=torch.int32, device="cuda")
                for _ in range(c - nk)]
        live = radix_sort.plan(ops, nk)[1]
        want = bitonic.plain_sort(ops, nk)
        got = radix_sort.radix_sort(ops, nk)
        torch.cuda.synchronize()
        radix_err = _exact_err(got, want)
        del got, want
        radix_ms = cuda_ms(lambda: radix_sort.radix_sort(ops, nk), 2)
        library_ms = cuda_ms(lambda: bitonic.plain_sort(ops, nk), 2)
        bounds = sort_bounds(n, c, nk)
        say(f"phase 2: {name} C={c} keys={nk} n=2^{LOG2N}, ranks below n: "
            f"max_abs_err radix {radix_err} (tolerance 0); radix "
            f"{radix_ms:.3f} ms, chained torch.sort {library_ms:.3f} ms; "
            f"bound {bounds['bound_ms']} ms (every plane once); the radix "
            f"design's own bytes take {radix_design_ms(n, c, nk, live)} ms "
            f"({sum(live)} of {len(live)} passes live)")
        check(radix_err == 0, f"the radix sort disagrees with the plain sort "
                              f"at 2^{LOG2N} on ranks, {name}")
        reports["radix_sort"]["shapes"].append({
            "shape": f"ranks {name} C={c} keys={nk}", "n": n,
            "max_abs_err": radix_err, "ms": round(radix_ms, 4),
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
    from stringsearch_torch.ops import bitonic, radix_sort, steps

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
    for k in steps.launches:
        steps.launches[k] = 0
    t0 = time.perf_counter()
    sa = st.build_suffix_array(text, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = radix_sort.launches
    bitonic_launches = bitonic.launches
    step_launches = dict(steps.launches)
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 3: build n={n}: {build_s:.4f} s, {n / build_s:.1f} B/s, "
        f"peak CUDA memory {peak} B ({peak / 2**30:.2f} GiB), "
        f"radix sort launches {launches}, bitonic launches "
        f"{bitonic_launches}, step kernel launches {step_launches}")
    check(launches > 0, "the build launched no radix sort")
    check(bitonic_launches == 0, "the build launched the bitonic kernel")
    for k in FLAT_STEPS:
        check(step_launches[k] > 0, f"the build launched no {k} kernel")
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
                                  "bitonic_launches": bitonic_launches,
                                  "step_launches": step_launches}


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
    """Build and load the kernel libraries, one nvcc each, side by
    side."""
    from concurrent.futures import ThreadPoolExecutor
    from stringsearch_torch.ops import (bitonic, merge, radix, radix_sort,
                                        route, steps)

    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    libraries = (("the radix sort", radix_sort.load_library),
                 ("the bitonic sort", bitonic.load_library),
                 ("the radix-partition kernels", radix.load_library),
                 ("the step kernels", steps.load_library),
                 ("the merge-split kernel", merge.load_library),
                 ("the routing kernels", route.load_library))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        times = [pool.submit(timed, load) for _, load in libraries]
        for (what, _), t in zip(libraries, times):
            say(f"phase 1: built and loaded {what} in {t.result():.2f} s")
    say(f"phase 1: {len(libraries)} libraries built side by side in "
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
    # the sorts of one build: the initial sort and a round (the invert
    # before the round is a scatter, `invert_ranks`)
    check(launches == 2, f"the partitioned build launched {launches} radix "
                         f"sorts, a flat build 2")
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


def route_counts(zero: bool = False) -> dict:
    """The launches of the global build's routing and placement kernels,
    by name; zeroes them first where `zero`."""
    from stringsearch_torch.ops import route, steps

    counts = {}
    for name, module in ROUTE_KERNELS:
        table = (route if module == "route" else steps).launches
        if zero:
            table[name] = 0
        counts[name] = table[name]
    return counts


def phase13_global(text_np, sa_host, lcs_needles, full_lens,
                   card: str) -> dict:
    """The exact global SA on four shards of the one card, and the rest of
    the multi-device layer's surface."""
    import tempfile
    import torch
    import stringsearch_torch as st
    from stringsearch_torch import NotSorted, oracle
    from stringsearch_torch.harness import fuzz, scaling
    from stringsearch_torch.harness.cli import main as cli
    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_torch.harness.profile_build import _syncs
    from stringsearch_torch.ops import merge, steps as step_ops
    from stringsearch_torch.parallel import collectives, distsort, global_sa
    from stringsearch_torch.ops.bitonic import PlainSortCalls
    from stringsearch_torch.parallel.comm_model import (executed_bytes,
                                                         global_build_comm)
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
    merge.launches = 0
    step_ops.launches["shard_head_ranks"] = 0
    route_counts(zero=True)
    with SortLaunches("the global build") as count, PlainSortCalls() as plain:
        t0 = time.perf_counter()
        sync_sites = _syncs(lambda: built.append(build_global(text, mesh)))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    syncs = len(sync_sites)
    merges = merge.launches
    heads = step_ops.launches["shard_head_ranks"]
    routed = route_counts()
    g = built.pop()
    peak = torch.cuda.max_memory_allocated()
    launches = count.radix
    moved = collectives.bulk_bytes_per_shard(shards)
    fell_back = dict(distsort.fallbacks)
    compact_fell_back = global_sa.compact_fallbacks
    check(plain.calls == 0, f"the global build called the plain sort "
                            f"{plain.calls} times")
    check(merges > 0, "the global build launched no merge_split")
    check(heads > 0, "the global build launched no shard_head_ranks")
    for name, launched in routed.items():
        check(launched > 0, f"the global build launched no {name}")
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
    expected = executed_bytes(g)
    say(f"phase 13: global build n=2^{LOG2N} on {shards} shards of one card: "
        f"{first_s:.4f} s, radix sort launches {launches} (the route "
        f"before merge_split: {EARLIER_GLOBAL_RADIX}; before the routing "
        f"kernels: {UNROUTED_GLOBAL_RADIX}), merge_split launches "
        f"{merges}, shard_head_ranks launches {heads}, routing and "
        f"placement launches {routed}, plain sort "
        f"calls {plain.calls}, host syncs {syncs} "
        f"{dict(sorted(Counter(sync_sites).items()))}, peak CUDA memory "
        f"{peak} B of which {held} B held before, rounds_run {g.rounds_run} "
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

    # a round routes fan + 1 operands: past one launch's eight at fan 8
    # and 9; and 512 shards, past what one library call of the routing
    # took before (256 buckets)
    caps = {}
    data24 = enwik_like(1 << 24)
    flat24 = st.build_suffix_array(data24, device="cuda").sa.cpu().numpy()
    for fan in (8, 9):
        route_counts(zero=True)
        t0 = time.perf_counter()
        g = build_global(data24, mesh, fan=fan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = route_counts()
        check(np.array_equal(g.suffix_array(), flat24),
              f"the fan-{fan} global SA of 2^24 bytes differs from the "
              f"flat SA")
        check(launched["route_partition"] > 0,
              f"the fan-{fan} build launched no route_partition")
        caps[f"fan_{fan}"] = {"wall_s": wall, "rounds_run": g.rounds_run,
                              "route_launches": launched}
        say(f"phase 13: build_global(fan={fan}) on 2^24 bytes, {shards} "
            f"shards: {wall:.4f} s (first), rounds_run {g.rounds_run}, "
            f"routing launches {launched}; SA equal to the flat SA [{card}]")
        del g
    step("fan 8 and 9 on four shards at 2^24")
    # 512 shards where the pairs' capacity holds: the routes run through
    # the kernels, none falls back
    route_counts(zero=True)
    fell = Counter(distsort.fallbacks)
    t0 = time.perf_counter()
    g = build_global(data24, make_mesh(devices=[cuda] * 512))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = route_counts()
    fell = dict(Counter(distsort.fallbacks) - fell)
    check(np.array_equal(g.suffix_array(), flat24),
          "the 512-shard global SA of 2^24 bytes differs from the flat SA")
    check(fell.get("redistribute", 0) == 0,
          f"the 512-shard build at 2^24 fell back: {fell}")
    check(launched["route_partition"] > 0 and launched["place_received"] > 0,
          f"the 512-shard build at 2^24 did not route through the kernels: "
          f"{launched}")
    caps["shards_512_2^24"] = {"wall_s": wall, "rounds_run": g.rounds_run,
                               "route_launches": launched, "fallbacks": fell}
    say(f"phase 13: build_global on 512 shards of 2^24 bytes (L = 2^15, cap "
        f"{distsort.redistribute_cap(512, 1 << 15)}): {wall:.4f} s, "
        f"rounds_run {g.rounds_run}, routing launches {launched}, fallbacks "
        f"{fell}; SA equal to the flat SA [{card}]")
    del g, data24, flat24
    step("512 shards at 2^24")
    data20 = enwik_like(1 << 20, seed=512)
    route_counts(zero=True)
    fell = Counter(distsort.fallbacks)
    t0 = time.perf_counter()
    g = build_global(data20, make_mesh(devices=[cuda] * 512))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = route_counts()
    check(np.array_equal(g.suffix_array(), oracle.build(data20)),
          "the 512-shard global SA of 2^20 bytes differs from the oracle")
    check(launched["route_partition"] > 0,
          "the 512-shard build launched no route_partition")
    fell = dict(Counter(distsort.fallbacks) - fell)
    caps["shards_512"] = {"wall_s": wall, "rounds_run": g.rounds_run,
                          "route_launches": launched, "fallbacks": fell}
    say(f"phase 13: build_global on 512 shards of 2^20 bytes (L = 2048): "
        f"{wall:.4f} s, rounds_run {g.rounds_run}, routing launches "
        f"{launched}, fallbacks {fell}; SA equal to oracle.build [{card}]")
    del g, data20
    step("512 shards at 2^20")

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
            "merge_launches": merges, "head_ranks_launches": heads,
            "route_launches": routed,
            "plain_sort_calls": plain.calls, "host_syncs": syncs,
            "peak_bytes": peak, "held_bytes": held,
            "rounds_run": report.rounds, "comm_bytes": report.total_bytes,
            "bytes_moved": moved, "fallbacks": fell_back,
            "compact_fallbacks": compact_fell_back, "queries": queries,
            "eight_shards_2_20": small, "route_caps": caps,
            "scaling_2_24": scale,
            "step_s": steps}


def phase14_multihost(text_np, sa_host, card: str) -> dict:
    """The global build across two processes, each holding two of the four
    shards of phase 3's build on the one card."""
    import torch
    from stringsearch_torch import oracle
    from stringsearch_torch.parallel import multihost

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        reports = multihost.run_selftest(
            nproc=2, devs_per_proc=2, device="cuda", backend="gloo",
            text=text_np, want=sa_host, builds=2, timeout=600.0)
    except (RuntimeError, TimeoutError) as e:
        raise SmokeFailure(f"phase 14: {e}") from e
    wall = time.perf_counter() - t0
    check([r["parts"] for r in reports] == [[0, 1], [2, 3]],
          "phase 14: the processes do not hold two shards each")
    for r in reports:
        check(r["radix_launches"] > 0 and r["plain_sort_calls"] == 0,
              f"phase 14: process {r['pid']} launched "
              f"{r['radix_launches']} radix sorts, called the plain sort "
              f"{r['plain_sort_calls']} times")
        check(r["merge_launches"] > 0 and r["head_ranks_launches"] > 0,
              f"phase 14: process {r['pid']} launched "
              f"{r['merge_launches']} merge_split and "
              f"{r['head_ranks_launches']} shard_head_ranks kernels")
        check(all(v > 0 for v in r["route_launches"].values()),
              f"phase 14: process {r['pid']} launched the routing and "
              f"placement kernels {r['route_launches']} times")
        if not r["fallbacks"] and not r["compact_fallbacks"]:
            check(max(r["bulk_bytes_per_shard"]) == r["expected_bytes"],
                  "phase 14: the collectives moved other bytes than the "
                  "comm model counts")
        say(f"phase 14: process {r['pid']}, shards {r['parts']}: build "
            f"cold {r['walls_s'][0]:.4f} s, warm {r['walls_s'][1]:.4f} s; "
            f"crossed {r['crossed']} B, transport {r['transport_s']:.4f} s; "
            f"radix sort launches {r['radix_launches']} (the route before "
            f"merge_split: {EARLIER_PROCESS_RADIX}; before the routing "
            f"kernels: {UNROUTED_PROCESS_RADIX}), merge_split launches "
            f"{r['merge_launches']}, shard_head_ranks launches "
            f"{r['head_ranks_launches']}, routing and placement launches "
            f"{r['route_launches']}, peak CUDA memory "
            f"{r['peak_bytes']} B; rounds_run {r['rounds_run']} (ran "
            f"{r['rounds_executed']}); verify {r['verify_s']:.4f} s [{card}]")
    first = reports[0]
    answers = [k for k in first if k.startswith(("lcs_", "search_",
                                                 "simple_", "sharded_lcs",
                                                 "sa_sha1"))]
    check(all(r[k] == first[k] for r in reports for k in answers),
          "phase 14: the processes' answers differ")
    needles = multihost.selftest_needles(text_np)
    want = [list(oracle.search(text_np, nd, sa_host)) for nd in needles]
    simple = [list(oracle.simplesearch(text_np, c, sa_host))
              for c in multihost.SELFTEST_BYTES]
    for mode in ("replicated", "sharded"):
        check(first[f"search_{mode}"] == want,
              f"phase 14: sa_search_batch ({mode}) differs from the oracle")
        check(first[f"simple_{mode}"] == simple,
              f"phase 14: sa_simplesearch ({mode}) differs from the oracle")
    say(f"phase 14: bytes each shard sent (ppermute + all_to_all): "
        f"{first['bulk_bytes_per_shard']}, comm model for the rounds that "
        f"ran {first['expected_bytes']}; {len(needles)} exact searches and "
        f"{len(simple)} single-byte counts equal to the oracle's in both "
        f"text modes, every answer equal across the processes; "
        f"run_selftest {wall:.2f} s")
    say("phase 14: the NCCL route was not run: one card, and NCCL refuses "
        "two ranks on one device (gloo staged through the host instead)")
    keep = ("parts", "walls_s", "crossed", "transport_s", "radix_launches",
            "merge_launches", "head_ranks_launches", "route_launches",
            "plain_sort_calls", "peak_bytes", "bulk_bytes_per_shard",
            "expected_bytes", "rounds_run", "rounds_executed",
            "compact_rounds_run", "fallbacks", "compact_fallbacks",
            "verify_s")
    return {"n": len(text_np), "processes": len(reports),
            "backend": "gloo", "nccl_run": False, "selftest_s": wall,
            "per_process": [{k: r[k] for k in keep} for r in reports]}


def _step_edge_cases(gen) -> dict:
    """The edge cases of tests/test_torch_steps.py, each kernel against its
    plain version: {kernel: (cases, max_abs_err)}."""
    import torch
    from stringsearch_torch.ops import steps

    def sizes(tile):
        return (1, 2, 3, tile - 1, tile, tile + 1, (1 << 20) + 12345)

    def chunks(n):
        out = [None] + ([4] if n % 4 == 0 and n > 4 else [])
        divisors = [d for d in range(2, min(n, 5000)) if n % d == 0]
        if divisors:
            out.append(min(divisors, key=lambda d: abs(d - 1000)))
        return out

    done = {"pack_keys": [0, 0], "shift_planes": [0, 0], "head_ranks": [0, 0],
            "invert_ranks": [0, 0]}

    def held(kernel, got, want):
        done[kernel][0] += 1
        done[kernel][1] = max(done[kernel][1], _exact_err(got, want))

    for n in sizes(steps.PACK_TILE) + (4000,):
        text = torch.randint(0, 256, (n,), generator=gen,
                             dtype=torch.uint8).to("cuda")
        for chunk in chunks(n):
            for depth in (4, 12, 24):
                for idx in (torch.int32, torch.int64):
                    held("pack_keys", steps.pack_keys(text, depth, chunk, idx),
                         steps.plain_pack_keys(text, depth, chunk, idx))
    for n in sizes(steps.SHIFT_TILE) + (4000,):
        for idx in (torch.int32, torch.int64):
            rank = torch.randint(-5, 1 << 20, (n,), generator=gen,
                                 dtype=idx).to("cuda")
            for chunk in chunks(n):
                c = chunk or n
                for fan in (2, 3, 4):
                    for h in (1, 12, c, c + 5):
                        shifts = [min(h, c // k + 1) * k
                                  for k in range(1, fan)]
                        held("shift_planes",
                             steps.shift_planes(rank, shifts, chunk),
                             steps.plain_shift_planes(rank, shifts, chunk))
            shifts = range(1, 12)  # build_ints_with_isa at depth 12
            held("shift_planes", steps.shift_planes(rank, shifts),
                 steps.plain_shift_planes(rank, shifts))
    for n in sizes(steps.SCAN_TILE) + (1 << 24,):
        for idx in (torch.int32, torch.int64):
            j = torch.arange(n, device="cuda", dtype=idx)
            sa = torch.randperm(n, generator=gen).to(idx).to("cuda")
            rand = torch.sort(torch.randint(0, max(n // 3, 1), (n,),
                                            generator=gen))[0].to("cuda")
            for keys in ([rand.to(torch.int32), j % 3],
                         [torch.zeros(n, dtype=torch.int32, device="cuda")],
                         [j], [(j // steps.SCAN_TILE).to(torch.int32)], []):
                out = keys + [sa]
                got = steps.head_ranks(out)
                want = steps.plain_head_ranks(out)
                held("head_ranks", [got[1]], [want[1]])
                done["head_ranks"][1] = max(
                    done["head_ranks"][1], abs(int(got[2]) - int(want[2])))
    # both designs: one store an element, and by windows from 2^24
    tile = steps.INVERT_TILE
    for n in (1, 2, 3, tile // 2 - 1, tile // 2 + 1, tile - 1, tile, tile + 1,
              (1 << 24) + 12345):
        for idx in (torch.int32, torch.int64):
            rank = torch.randint(0, n, (n,), generator=gen).to(idx).to("cuda")
            for sa in (torch.randperm(n, generator=gen),
                       torch.cat([torch.arange(n)[k::3] for k in range(3)])):
                sa = sa.to(idx).to("cuda")
                held("invert_ranks", [steps.invert_ranks(sa, rank)],
                     [steps.plain_invert_ranks(sa, rank)])
                buf = torch.full((n + 1,), -9, dtype=idx, device="cuda")
                steps.invert_ranks(sa, rank, buf)
                held("invert_ranks", [buf], [torch.cat(
                    [steps.plain_invert_ranks(sa, rank), buf[n:]])])
                done["invert_ranks"][1] = max(done["invert_ranks"][1],
                                              abs(int(buf[n]) + 9))
    torch.cuda.synchronize()
    return {k: tuple(v) for k, v in done.items()}


def phase15_steps(text_np, card: str) -> dict:
    """The four step kernels against their plain versions at 2^28 on phase
    3's text and on the edge cases, with times. Returns one report per
    kernel."""
    import torch
    from stringsearch_torch.engines import doubling
    from stringsearch_torch.ops import steps
    from stringsearch_torch.ops.bitonic import device_sort

    n = len(text_np)
    text = torch.from_numpy(text_np.copy()).to("cuda")
    reports = {k: {"shapes": []} for k in FLAT_STEPS}

    def held(kernel, shape, got, want, fn, plain, nbytes, library=None,
             replaced=None):
        err = _exact_err(got, want)
        ms = cuda_ms(fn, 5)
        plain_ms = cuda_ms(plain, 2)
        library_ms = round(cuda_ms(library, 3), 4) if library else None
        replaced_ms = round(cuda_ms(replaced, 3), 4) if replaced else None
        bounds = bound(nbytes, 0)
        say(f"phase 15: {kernel} {shape} n=2^{LOG2N}: max_abs_err {err} "
            f"(tolerance 0); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            + (f", library {library_ms} ms" if library else "")
            + (f", the route it replaced {replaced_ms} ms" if replaced
               else "")
            + f"; bound {bounds['bound_ms']} ms ({nbytes} B), share "
            f"{bounds['bound_ms'] / ms:.3f} [{card}]")
        check(err == 0, f"{kernel} {shape} disagrees with its plain version")
        reports[kernel]["shapes"].append({
            "shape": shape, "n": n, "max_abs_err": err, "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 4), "library_ms": library_ms,
            "replaced_ms": replaced_ms, **bounds})

    def heads(what, out):
        got = steps.head_ranks(out)
        want = steps.plain_head_ranks(out)
        check(int(got[2]) == int(want[2]),
              f"head_ranks {what}: count {int(got[2])} against "
              f"{int(want[2])}")
        # the scan alone as one PyTorch call, on the flags of this input
        flag = torch.ones(n, dtype=torch.bool, device="cuda")
        flag[1:] = False
        for ks in out[:-1]:
            flag[1:] |= ks[1:] != ks[:-1]
        j = torch.arange(n, dtype=out[-1].dtype, device="cuda")
        marked = torch.where(flag, j, -1)
        del flag, j
        keys = len(out) - 1
        held("head_ranks",
             f"{what}: {keys} key planes ({int(want[2])} tied)",
             [got[1]], [want[1]], lambda: steps.head_ranks(out),
             lambda: steps.plain_head_ranks(out),
             sum(p.element_size() for p in out[:-1]) * n
             + out[-1].element_size() * n,
             lambda: torch.cummax(marked, 0))
        del got, want, marked
        torch.cuda.empty_cache()

    planes = steps.pack_keys(text, 12)
    held("pack_keys", "depth 12", planes, steps.plain_pack_keys(text, 12),
         lambda: steps.pack_keys(text, 12),
         lambda: steps.plain_pack_keys(text, 12), 17 * n)
    parts = steps.pack_keys(text, 12, n // 4)
    held("pack_keys", "depth 12, 4 chunks", parts,
         steps.plain_pack_keys(text, 12, n // 4),
         lambda: steps.pack_keys(text, 12, n // 4),
         lambda: steps.plain_pack_keys(text, 12, n // 4), 21 * n)
    del parts
    out = device_sort(planes, 3)
    del planes
    torch.cuda.empty_cache()
    heads("initial", out)
    _, rank_s, _ = steps.head_ranks(out)
    sa_s = out[-1]
    del out
    torch.cuda.empty_cache()
    # the round's invert: the initial sort's order, against the C=2 sort
    # the engine ran before
    rank = doubling._scatter_to_text_order(sa_s, rank_s)
    held("invert_ranks", "the initial sort's order", [rank],
         [steps.plain_invert_ranks(sa_s, rank_s)],
         lambda: steps.invert_ranks(sa_s, rank_s),
         lambda: steps.plain_invert_ranks(sa_s, rank_s), 12 * n,
         replaced=lambda: device_sort((sa_s, rank_s), 1))
    del sa_s, rank_s
    torch.cuda.empty_cache()
    shifts = [12, 24, 36]
    planes = steps.shift_planes(rank, shifts)
    held("shift_planes", "fan 4, h = 12", planes,
         steps.plain_shift_planes(rank, shifts),
         lambda: steps.shift_planes(rank, shifts),
         lambda: steps.plain_shift_planes(rank, shifts), 20 * n)
    out = device_sort((rank, *planes), 4)
    del rank, planes
    torch.cuda.empty_cache()
    heads("round", out)
    del out, text
    torch.cuda.empty_cache()
    # the longest look-back: one group over every slot
    heads("all equal", [torch.zeros(n, dtype=torch.int32, device="cuda"),
                        torch.arange(n, dtype=torch.int32, device="cuda")])
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    edges = _step_edge_cases(torch.Generator().manual_seed(15))
    for kernel, (cases, err) in edges.items():
        say(f"phase 15: {kernel} on {cases} edge cases: max_abs_err {err} "
            f"(tolerance 0)")
        check(err == 0, f"{kernel} disagrees with its plain version on an "
                        f"edge case")
        reports[kernel]["edge_cases"] = cases
        reports[kernel]["edge_max_abs_err"] = err
    say(f"phase 15: edge cases in {time.perf_counter() - t0:.2f} s")
    return reports


def _spread(k, dtype):
    """Small nonnegative keys onto distinct values of `dtype`, negatives and
    an int64's high word included, order kept."""
    import torch

    if dtype == torch.int64:
        return k.to(torch.int64) * ((1 << 33) + 7) - (1 << 45)
    return (k.to(torch.int64) * 3 - (1 << 20)).to(torch.int32)


def _merge_edge_cases(gen) -> tuple:
    """`merge_split` against its plain version on the edge cases of
    tests/test_torch_merge.py: (cases, max_abs_err)."""
    import torch
    from stringsearch_torch.ops import merge
    from stringsearch_torch.ops.bitonic import plain_sort

    i32, i64 = torch.int32, torch.int64
    kinds = {"int32": (i32, i32, i32), "int64": (i64, i64, i64),
             "mixed": (i32, i64, i32)}
    done = [0, 0]

    def held(a, b, num_keys):
        for mine_first in (True, False):
            for keep_low in (True, False):
                got = merge.merge_split(a, b, mine_first, keep_low, num_keys)
                want = merge.plain_merge_split(a, b, mine_first, keep_low,
                                               num_keys)
                done[0] += 1
                done[1] = max(done[1], _exact_err(got, want))

    def randint(hi, n):
        return torch.randint(0, hi, (n,), generator=gen).to("cuda")

    length = 1 << 24
    half = length // 2
    j = torch.arange(length, device="cuda")
    for case in ("all equal", "one run below", "interleaved", "straddling"):
        if case == "all equal":
            ka = kb = torch.full((length,), 5, device="cuda")
        elif case == "one run below":
            ka = torch.full((length,), 1, device="cuda")
            kb = torch.full((length,), 9, device="cuda")
        elif case == "interleaved":
            ka = torch.sort(randint(4, length))[0]
            kb = torch.sort(randint(4, length))[0]
        else:
            ka = torch.where(j < half, 0, 5)
            kb = torch.where(j < half, 5, 9)
        for dtypes in kinds.values():
            a = (_spread(ka, dtypes[0]), _spread(ka // 2, dtypes[1]),
                 j.to(dtypes[2]))
            b = (_spread(kb, dtypes[0]), _spread(kb // 2, dtypes[1]),
                 (length + j).to(dtypes[2]))
            for num_keys in (1, 2):
                held(a, b, num_keys)
        del ka, kb
    del j
    torch.cuda.empty_cache()

    def runs(n, dtypes, num_keys):
        planes = [_spread(randint(3, 2 * n), dt) if q < num_keys
                  else randint(1 << 30, 2 * n).to(dt)
                  for q, dt in enumerate(dtypes)]
        a = plain_sort([p[:n] for p in planes], num_keys)
        b = plain_sort([p[n:] for p in planes], num_keys)
        return a, b

    for n in (1, 2, 3, 2047, 2048, 2049, 4097):
        for dtypes in kinds.values():
            dtypes = dtypes + dtypes[:2]
            for num_keys in (1, 3, 5):
                held(*runs(n, dtypes, num_keys), num_keys)
    # every width a caller of sharded_sort passes
    for idx in (i32, i64):
        widths = [([i32] * (d // 4) + [idx], d // 4) for d in (4, 8, 16, 64)]
        widths += [([idx] * 4, 1), ([idx] * 2, 1)]
        widths += [([idx] * (fan + 1), fan + 1) for fan in (2, 3, 4, 7)]
        for dtypes, num_keys in widths:
            held(*runs(5000, dtypes, num_keys), num_keys)
    torch.cuda.synchronize()
    return tuple(done)


def _head_edge_cases(gen) -> tuple:
    """`shard_head_ranks` against its plain version on the edge cases of
    tests/test_torch_merge.py: (cases, max_abs_err)."""
    import torch
    from stringsearch_torch.ops import steps

    done = [0, 0]
    for n in (1, 2, 3, steps.SCAN_TILE - 1, steps.SCAN_TILE,
              steps.SCAN_TILE + 1, 8 * steps.SCAN_TILE + 5,
              (1 << 20) + 12345):
        for idx in (torch.int32, torch.int64):
            j = torch.arange(n, device="cuda")
            rand = torch.sort(torch.randint(0, max(n // 3, 1), (n,),
                                            generator=gen))[0].to("cuda")
            for keys in ([rand.to(idx), (j % 2).to(torch.int32)],
                         [torch.full((n,), 7, dtype=idx, device="cuda")],
                         [j.to(idx)],
                         [(j // steps.SCAN_TILE).to(torch.int32)]):
                first = torch.stack([k[0].to(torch.int64) for k in keys])
                for prev in (None, first, first - 1):
                    for offset in (0, 3 * n):
                        got = steps.shard_head_ranks(keys, prev, offset, idx)
                        want = steps.plain_shard_head_ranks(keys, prev,
                                                            offset, idx)
                        done[0] += 1
                        done[1] = max(done[1], _exact_err([got[0]],
                                                          [want[0]]),
                                      abs(int(got[1]) - int(want[1])))
    torch.cuda.synchronize()
    return tuple(done)


def phase16_merge(text_np, card: str) -> dict:
    """The global build's merge-split and sharded head ranking against
    their plain versions at the shapes of phase 13's build, and on their
    edge cases, with times. Returns one report per kernel."""
    import torch
    from stringsearch_torch.ops import merge, steps
    from stringsearch_torch.ops.bitonic import device_sort, plain_sort
    from stringsearch_torch.parallel import global_sa
    from stringsearch_torch.parallel.distsort import (rank_interval_sort,
                                                      sharded_sort)

    n = len(text_np)
    shards = 4
    length = n // shards
    nk = global_sa.INITIAL_DEPTH // 4
    text = torch.from_numpy(text_np.copy()).to("cuda")
    reports = {"merge_split": {"shapes": []},
               "shard_head_ranks": {"shapes": []}}

    def held(kernel, shape, got, want, fn, plain, nbytes, library=None,
             replaced=None):
        err = _exact_err(got, want)
        ms = cuda_ms(fn, 10)
        plain_ms = cuda_ms(plain, 2)
        library_ms = round(cuda_ms(library, 3), 4) if library else None
        replaced_ms = round(cuda_ms(replaced, 3), 4) if replaced else None
        bounds = bound(nbytes, 0)
        say(f"phase 16: {kernel} {shape}: max_abs_err {err} (tolerance 0); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            + (f", the route it replaced {replaced_ms} ms" if replaced
               else "")
            + (f", library {library_ms} ms" if library else "")
            + f"; bound {bounds['bound_ms']} ms ({nbytes} B), share "
            f"{bounds['bound_ms'] / ms:.3f} [{card}]")
        check(err == 0, f"{kernel} {shape} disagrees with its plain version")
        reports[kernel]["shapes"].append({
            "shape": shape, "max_abs_err": err, "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 4), "library_ms": library_ms,
            "replaced_ms": replaced_ms, **bounds})

    # the initial sort of phase 13's build: every shard's operands, and the
    # network's first merge, shard 0 (low half) with shard 1 (high half)
    ops = global_sa._initial_operands(global_sa.INITIAL_DEPTH, torch.int32,
                                      list(text.view(shards, length)))
    mine, theirs = (device_sort(tuple(op[me] for op in ops), nk)
                    for me in (0, 1))
    nbytes = 2 * length * sum(p.element_size() for p in mine)
    for keep_low in (True, False):
        def run(keep_low=keep_low, sort=None):
            if sort is None:
                return merge.merge_split(mine, theirs, True, keep_low, nk)
            return merge.plain_merge_split(mine, theirs, True, keep_low, nk,
                                           sort=sort)

        held("merge_split", f"first merge of the initial sort, "
             f"{'low' if keep_low else 'high'} half, L=2^{LOG2N - 2}, "
             f"C={len(mine)}, {nk} keys", run(), run(sort=plain_sort),
             run, lambda: run(sort=plain_sort), nbytes,
             replaced=lambda: run(sort=device_sort))
    del mine, theirs
    torch.cuda.empty_cache()

    def held_heads(what, keys, prev, offset, idx):
        got = steps.shard_head_ranks(keys, prev, offset, idx)
        want = steps.plain_shard_head_ranks(keys, prev, offset, idx)
        check(int(got[1]) == int(want[1]),
              f"shard_head_ranks {what}: count {int(got[1])} against "
              f"{int(want[1])}")
        # the scan alone as one PyTorch call, on the flags of this input
        flag = torch.zeros(length, dtype=torch.bool, device="cuda")
        flag[0] = prev is None
        for q, k in enumerate(keys):
            flag[1:] |= k[1:] != k[:-1]
            if prev is not None:
                flag[:1] |= k[:1] != prev[q]
        gslot = offset + torch.arange(length, dtype=idx, device="cuda")
        marked = torch.where(flag, gslot, -1)
        del flag, gslot
        nbytes = length * (sum(k.element_size() for k in keys)
                           + torch.empty((), dtype=idx).element_size())
        held("shard_head_ranks", f"{what}, L=2^{LOG2N - 2}, {len(keys)} key "
             f"planes, {str(idx).split('.')[-1]} ({int(want[1])} tied)",
             [got[0]], [want[0]],
             lambda: steps.shard_head_ranks(keys, prev, offset, idx),
             lambda: steps.plain_shard_head_ranks(keys, prev, offset, idx),
             nbytes, lambda: torch.cummax(marked, 0))

    # the head ranking of that sort's output, shards 0 and 1
    out = sharded_sort(ops, nk)
    del ops
    torch.cuda.empty_cache()
    for me in (0, 1):
        held_heads(f"shard {me} of the initial sort",
                   [ks[me] for ks in out[:nk]],
                   None if me == 0 else
                   torch.stack([ks[me - 1][-1] for ks in out[:nk]]),
                   me * length, torch.int32)
    del out
    torch.cuda.empty_cache()
    # the first doubling round's (phase 13's build: fan 3, h = the initial
    # depth): its rank_interval_sort output, the -2 fill before shard 0; the
    # same ranks as int64 planes for the int64 index mode
    fan, h, i32 = 3, global_sa.INITIAL_DEPTH, torch.int32
    rank = global_sa._initial_shard_ranks(h, i32,
                                          list(text.view(shards, length)))[0]
    del text
    shifts, gidx = global_sa._shifted_ranks(
        rank, [k * h for k in range(1, fan)], i32)
    planes = rank_interval_sort((rank, *shifts, gidx), num_keys=fan + 1)[:fan]
    del rank, shifts, gidx
    torch.cuda.empty_cache()
    for idx in (i32, torch.int64):
        for me in (0, 1):
            prev = (torch.full((fan,), -2, dtype=idx, device="cuda")
                    if me == 0 else
                    torch.stack([ks[me - 1][-1] for ks in planes]).to(idx))
            held_heads(f"shard {me} of the first round",
                       [ks[me].to(idx) for ks in planes], prev, me * length,
                       idx)
            torch.cuda.empty_cache()
    del planes
    torch.cuda.empty_cache()
    # the longest look-back: a shard wholly inside its predecessor's group
    keys = [torch.zeros(length, dtype=torch.int32, device="cuda")]
    prev = torch.zeros(1, dtype=torch.int64, device="cuda")
    held("shard_head_ranks", f"a headless shard, L=2^{LOG2N - 2}",
         [steps.shard_head_ranks(keys, prev, length, torch.int32)[0]],
         [steps.plain_shard_head_ranks(keys, prev, length, torch.int32)[0]],
         lambda: steps.shard_head_ranks(keys, prev, length, torch.int32),
         lambda: steps.plain_shard_head_ranks(keys, prev, length,
                                              torch.int32), 8 * length)
    del keys
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(16)
    for kernel, (cases, err) in (("merge_split", _merge_edge_cases(gen)),
                                 ("shard_head_ranks",
                                  _head_edge_cases(gen))):
        say(f"phase 16: {kernel} on {cases} edge cases: max_abs_err {err} "
            f"(tolerance 0)")
        check(err == 0, f"{kernel} disagrees with its plain version on an "
                        f"edge case")
        reports[kernel]["edge_cases"] = cases
        reports[kernel]["edge_max_abs_err"] = err
    say(f"phase 16: edge cases in {time.perf_counter() - t0:.2f} s")
    return reports


def _route_edge_cases(gen) -> dict:
    """The edge cases of tests/test_torch_route.py, each kernel against its
    plain version: {kernel: (cases, max_abs_err)}."""
    import torch
    from stringsearch_torch.ops import route, steps
    from stringsearch_torch.parallel.distsort import redistribute_cap

    done = {name: [0, 0] for name, _ in ROUTE_KERNELS}
    i32, i64 = torch.int32, torch.int64

    def held(kernel, got, want):
        done[kernel][0] += 1
        done[kernel][1] = max(done[kernel][1], _exact_err(got, want))

    def randint(lo, hi, n, dtype):
        return torch.randint(lo, hi, (n,), generator=gen,
                             dtype=torch.int64).to(dtype).to("cuda")

    tile = route.ROUTE_TILE
    for n in (0, 1, 2, 33, tile - 1, tile, tile + 1, 8 * tile + 5,
              (1 << 20) + 12345):
        for p in (1, 2, 3, 4, 8, 32, 512, 1100):
            length = max(n, 1)
            cap = redistribute_cap(p, length)
            for dtype in (i32, i64):
                payload = (randint(-2**31, 2**31, n, i32),
                           randint(-2**62, 2**62, n, i64))
                fills = (-1, 2**31 - 1, 2**63 - 1)
                dest = randint(0, p, n, i64)
                heavy = dest.clone()
                heavy[:min(cap + 1, n)] = 0  # destination 0 past its cap
                for src, clamp in (
                        (dest * length + randint(0, length, n, i64), False),
                        (heavy * length, False),
                        (randint(-length, (p + 1) * length, n, i64), True),
                        (randint(-length, (p + 1) * length, n, i64), False)):
                    src = src.to(dtype)
                    planes = (src, *payload)
                    for windows in {1, route.receiver_windows(p, length),
                                    route.MAX_BUCKETS // p + 3}:
                        got = route.route_partition(src, length, p, planes,
                                                    fills, cap, clamp,
                                                    windows)
                        want = route.plain_route_partition(
                            src, length, p, planes, fills, cap, clamp,
                            windows)
                        held("route_partition", [*got[0], got[1]],
                             [*want[0], want[1]])
    # 9 and 17 operands, mixed widths (two and three launches a call)
    for n in (tile + 1, (1 << 20) + 12345):
        for p, windows in ((4, 1), (4, 256), (512, 1)):
            length = max(n // p, 1)
            cap = redistribute_cap(p, length)
            src = randint(-length, (p + 1) * length, n, i32)
            for count in (9, 17):
                planes = [src] + [randint(-2**31, 2**31, n,
                                          i32 if c % 2 else i64)
                                  for c in range(1, count)]
                fills = [-1] + [c for c in range(1, count)]
                for clamp in (False, True):
                    got = route.route_partition(src, length, p, planes,
                                                fills, cap, clamp, windows)
                    want = route.plain_route_partition(
                        src, length, p, planes, fills, cap, clamp, windows)
                    held("route_partition", [*got[0], got[1]],
                         [*want[0], want[1]])
    # the placement of what a permutation route by windows delivers
    for p in (2, 4, 8):
        for length in (1000, route.PLACE_TILE + 3, (1 << 20) + 7):
            cap = redistribute_cap(p, length)
            for dtype in (i32, i64):
                perm = torch.randperm(p * length, generator=gen).to(dtype)
                vals = randint(-2**62, 2**62, p * length, i64)
                for windows in sorted({1, 4, route.receiver_windows(
                        p, length, 8), 2 * route.MAX_BUCKETS // p}):
                    sends = [route.route_partition(
                        g, length, p, (g, v, v.to(i32)), (-1, 0, 0), cap,
                        False, windows)[0]
                        for g, v in zip(perm.to("cuda").view(p, length),
                                        vals.view(p, length))]
                    recv = [torch.cat([sends[s][k][p - 1]
                                       for s in range(p)]).view(p, cap)
                            for k in range(3)]
                    del sends
                    held("place_received",
                         route.place_received(recv[0], recv[1:], length,
                                              windows),
                         route.plain_place_received(recv[0], recv[1:],
                                                    length))
    for p in (2, 4, 8):
        for length in (1, 1000, route.PLACE_TILE + 3, (1 << 20) + 7):
            cap = redistribute_cap(p, length)
            for dtype in (i32, i64):
                perm = torch.randperm(p * length, generator=gen)
                mine = perm[perm // length == p - 1]
                recv_g = torch.full((p, cap), -1, dtype=torch.int64)
                for row, part in enumerate(torch.tensor_split(mine, p)):
                    recv_g[row, :part.numel()] = part
                recv_g = recv_g.to(dtype).to("cuda")
                recvs = (randint(-2**31, 2**31, p * cap, i32).view(p, cap),
                         randint(-2**62, 2**62, p * cap, i64).view(p, cap))
                held("place_received",
                     route.place_received(recv_g, recvs, length),
                     route.plain_place_received(recv_g, recvs, length))
    for length in (4, 5, 1023, 1024, 1025, 4099, (1 << 20) + 13):
        chunk = randint(0, 256, length, torch.uint8)
        for depth in (4, 12, 16, 24):
            if depth > length:
                continue
            for halo in (None, randint(0, 256, depth, torch.uint8),
                         torch.full((depth,), 255, dtype=torch.uint8,
                                    device="cuda")):
                for idx in (i32, i64):
                    held("shard_pack_keys",
                         steps.shard_pack_keys(chunk, halo, depth,
                                               3 * length, idx),
                         steps.plain_shard_pack_keys(chunk, halo, depth,
                                                     3 * length, idx))
    for p in (2, 4, 8):
        for length in (1, 5, steps.SHIFT_TILE - 1, steps.SHIFT_TILE + 1,
                       (1 << 18) + 3):
            n_pad = p * length
            hs = sorted({min(h, n_pad) for h in (
                1, length // 3, length - 1, length, length + 5, 2 * length,
                n_pad - 1, n_pad)})
            for idx in (i32, i64):
                rank = [randint(0, n_pad, length, idx) for _ in range(p)]
                for me in range(p):
                    windows = []
                    for h in hs + hs[:1] * 9:  # past one launch's planes
                        d, r = divmod(h, length)
                        windows.append((
                            h, rank[me + d] if me + d < p else None,
                            rank[me + d + 1] if r and me + d + 1 < p
                            else None))
                    held("shard_shift_planes",
                         steps.shard_shift_planes(windows, length,
                                                  me * length, n_pad, idx,
                                                  rank[me].device),
                         steps.plain_shard_shift_planes(
                             windows, length, me * length, n_pad, idx,
                             rank[me].device))
    torch.cuda.synchronize()
    return {k: tuple(v) for k, v in done.items()}


def phase17_route(text_np, card: str) -> dict:
    """The global build's four routing and placement kernels against their
    plain versions on the operands of phase 13's build (shard 1 of four,
    L = 2^26, and the last shard where its edge differs), and on their
    edge cases, with times; the permutation route and placement in a
    sweep of the windows a destination. Returns one report per kernel."""
    import torch
    from stringsearch_torch.ops import route, steps
    from stringsearch_torch.ops.bitonic import device_sort, plain_sort
    from stringsearch_torch.parallel import collectives as coll
    from stringsearch_torch.parallel import global_sa
    from stringsearch_torch.parallel.distsort import (redistribute_cap,
                                                      sharded_sort)

    n = len(text_np)
    p = 4
    length = n // p
    depth = global_sa.INITIAL_DEPTH
    nk = depth // 4
    fan = 3
    i32 = torch.int32
    cap = redistribute_cap(p, length)
    text = torch.from_numpy(text_np.copy()).to("cuda")
    chunks = list(text.view(p, length))
    reports = {name: {"shapes": []} for name, _ in ROUTE_KERNELS}
    reports["route_partition"]["window_sweep"] = []

    def held(kernel, shape, got, want, fn, plain, nbytes, replaced=None):
        """Kernel against plain, tolerance 0; times of the kernel, the
        plain version and the chain the kernel replaced (where that is not
        the plain version itself) beside the bytes bound."""
        err = _exact_err(got, want)
        del got, want
        ms = cuda_ms(fn, 10)
        plain_ms = cuda_ms(plain, 2)
        replaced_ms = round(cuda_ms(replaced, 2) if replaced else plain_ms,
                            4)
        bounds = bound(nbytes, 0)
        say(f"phase 17: {kernel} {shape}: max_abs_err {err} (tolerance 0); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, the chain it "
            f"replaced {replaced_ms} ms; bound {bounds['bound_ms']} ms "
            f"({nbytes} B), share {bounds['bound_ms'] / ms:.3f} [{card}]")
        check(err == 0, f"{kernel} {shape} disagrees with its plain version")
        reports[kernel]["shapes"].append({
            "shape": shape, "max_abs_err": err, "ms": round(ms, 4),
            "plain_ms": round(plain_ms, 4), "library_ms": None,
            "replaced_ms": replaced_ms, **bounds})

    # the initial operands of shards 1 and 3 (the last: no halo)
    for me in (1, p - 1):
        halo = chunks[me + 1][:depth] if me < p - 1 else None
        args = (chunks[me], halo, depth, me * length, i32)
        held("shard_pack_keys", f"shard {me} of 4, L=2^{LOG2N - 2}, depth "
             f"{depth}{'' if halo is not None else ', no halo'}",
             steps.shard_pack_keys(*args), steps.plain_shard_pack_keys(*args),
             lambda: steps.shard_pack_keys(*args),
             lambda: steps.plain_shard_pack_keys(*args),
             length + depth + (4 * nk + 4) * length)

    # the initial sort and head ranking of phase 13's build
    out = sharded_sort(global_sa._initial_operands(depth, i32, chunks), nk)
    gidx_s = out[-1]
    rank_s, _ = global_sa._sorted_head_ranks(list(out[:nk]), 0, i32, True)
    del out
    torch.cuda.empty_cache()

    # its redistribute: shard 1's send buffers, by window of the
    # receiver's slots; the chain replaced sorted by (dest, gidx)
    windows = route.receiver_windows(p, length)

    def redistribute(me, sort=None, num_keys=1, windows=windows):
        args = (gidx_s[me], length, p, (gidx_s[me], rank_s[me]), (-1, 0),
                cap, False, windows)
        if sort is None:
            return route.route_partition(*args)
        return route.plain_route_partition(*args, sort=sort,
                                           num_keys=num_keys)

    got, want = redistribute(1), redistribute(1, plain_sort)
    held("route_partition", f"the initial redistribute, shard 1 of 4, "
         f"L=2^{LOG2N - 2}, 2 int32 operands, cap {cap}, {windows} windows",
         [*got[0], got[1]], [*want[0], want[1]], lambda: redistribute(1),
         lambda: redistribute(1, plain_sort), length * 8 + 2 * p * cap * 4,
         replaced=lambda: redistribute(1, device_sort, 2, 1))
    del got, want

    def received(w):
        """What shard 1 receives of the redistribute by w windows."""
        sends = [redistribute(me, windows=w)[0] for me in range(p)]
        got = (coll.all_to_all([s[0] for s in sends])[1],
               coll.all_to_all([s[1] for s in sends])[1])
        del sends
        return got

    # what shard 1 receives, and its placement; by windows the rows hold
    # -1 only past their counts, so the function reads the L live entries
    # of gidx and of the operand and writes the output
    recv_g, recv = received(windows)
    held("place_received", f"the initial redistribute, shard 1 of 4, "
         f"L=2^{LOG2N - 2}, one int32 operand, [4, {cap}] received, "
         f"{windows} windows",
         route.place_received(recv_g, (recv,), length, windows),
         route.plain_place_received(recv_g, (recv,), length),
         lambda: route.place_received(recv_g, (recv,), length, windows),
         lambda: route.plain_place_received(recv_g, (recv,), length),
         length * (recv_g.element_size() + 2 * recv.element_size()))
    del recv_g, recv
    torch.cuda.empty_cache()

    # the permutation route at each number of windows a destination (512:
    # two ranges of library calls), the sum of route and placement as the
    # build pays it
    for w in (64, 128, 256, 512):
        got, want = redistribute(1, windows=w), redistribute(
            1, plain_sort, windows=w)
        err = _exact_err([*got[0], got[1]], [*want[0], want[1]])
        del got, want
        g1, v1 = received(w)
        err = max(err, _exact_err(
            route.place_received(g1, (v1,), length, w),
            route.plain_place_received(g1, (v1,), length)))
        check(err == 0, f"the route at {w} windows disagrees with the "
                        f"plain version")
        r_ms = cuda_ms(lambda: redistribute(1, windows=w), 10)
        p_ms = cuda_ms(lambda: route.place_received(g1, (v1,), length, w),
                       10)
        del g1, v1
        torch.cuda.empty_cache()
        reports["route_partition"]["window_sweep"].append({
            "windows": w, "buckets": p * w,
            "route_ms": round(r_ms, 4), "place_ms": round(p_ms, 4),
            "both_ms": round(r_ms + p_ms, 4), "max_abs_err": err})
        say(f"phase 17: the permutation route of shard 1, {w} "
            f"windows a destination ({p * w} buckets): route_partition "
            f"{r_ms:.4f} ms + place_received {p_ms:.4f} ms = "
            f"{r_ms + p_ms:.4f} ms, max_abs_err {err} [{card}]")
    sends = [redistribute(me)[0] for me in range(p)]
    recv_g = coll.all_to_all([s[0] for s in sends])
    recv = coll.all_to_all([s[1] for s in sends])
    del sends
    rank = [route.place_received(recv_g[me], (recv[me],), length,
                                 windows)[0] for me in range(p)]
    del recv_g, recv, gidx_s, rank_s
    torch.cuda.empty_cache()

    # the first round's shifted planes (h = depth, fan 3): shards 1 and 3
    hs = [k * depth for k in range(1, fan)]
    for me in (1, p - 1):
        shifts = [(h, rank[me], rank[me + 1] if me + 1 < p else None)
                  for h in hs]
        args = (shifts, length, me * length, p * length, i32,
                rank[me].device)
        held("shard_shift_planes", f"the first round, shard {me} of 4, "
             f"L=2^{LOG2N - 2}, h {hs}",
             steps.shard_shift_planes(*args),
             steps.plain_shard_shift_planes(*args),
             lambda: steps.shard_shift_planes(*args),
             lambda: steps.plain_shard_shift_planes(*args),
             (2 * len(hs) + 1) * 4 * length)
    # its rank_interval_sort route: shard 1's four operands, int32 and
    # int64, then nine (a fan-8 round's width: two launches)
    shifted = steps.shard_shift_planes(
        [(h, rank[1], rank[2]) for h in hs], length, length, p * length, i32,
        rank[1].device)
    operands = (rank[1], *shifted)
    del rank
    torch.cuda.empty_cache()
    for idx, width in ((i32, 4), (torch.int64, 4), (i32, 9)):
        ops = tuple(t.to(idx) for t in (operands * 3)[:width])
        sent = torch.iinfo(idx).max
        fills = (sent,) + (0,) * (width - 1)

        def interval(sort=None, ops=ops, fills=fills):
            args = (ops[0], length, p, ops, fills, cap, True)
            if sort is None:
                return route.route_partition(*args)
            return route.plain_route_partition(*args, sort=sort)

        got, want = interval(), interval(plain_sort)
        size = ops[0].element_size()
        held("route_partition", f"the first round's rank_interval_sort, "
             f"shard 1 of 4, L=2^{LOG2N - 2}, {width} "
             f"{str(idx).split('.')[-1]} operands, cap {cap}",
             [*got[0], got[1]], [*want[0], want[1]], interval,
             lambda: interval(plain_sort),
             length * width * size + p * cap * width * size,
             replaced=lambda: interval(device_sort))
        del got, want, ops
        torch.cuda.empty_cache()
    del operands, shifted, text, chunks
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(17)
    for kernel, (cases, err) in _route_edge_cases(gen).items():
        say(f"phase 17: {kernel} on {cases} edge cases: max_abs_err {err} "
            f"(tolerance 0)")
        check(err == 0, f"{kernel} disagrees with its plain version on an "
                        f"edge case")
        reports[kernel]["edge_cases"] = cases
        reports[kernel]["edge_max_abs_err"] = err
    say(f"phase 17: edge cases in {time.perf_counter() - t0:.2f} s")
    return reports


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
        t0 = time.perf_counter()
        multihost_report = phase14_multihost(text_np, sa_host, card)
        say(f"phase 14: passed in {time.perf_counter() - t0:.2f} s")
        del sa_host
        t0 = time.perf_counter()
        steps_report = phase15_steps(text_np, card)
        say(f"phase 15: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        merge_report = phase16_merge(text_np, card)
        say(f"phase 16: passed in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        route_report = phase17_route(text_np, card)
        say(f"phase 17: passed in {time.perf_counter() - t0:.2f} s")
        del text_np
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
        errs += [s["max_abs_err"] for s in more.get("edge_cases", [])]
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

    # the steps between the sorts: no Pallas kernel, so each entry names,
    # in prose, the JAX function whose jnp ops XLA fuses there. Headline:
    # the first shape timed (head_ranks: the second, after the round's
    # sort, the larger of the two on the main path).
    step_kernels = []
    for name, what in (
            ("pack_keys", "the jnp ops of _pack4_keys, doubling.py:83"),
            ("shift_planes", "the jnp ops of _shift_ranks, doubling.py:116"),
            ("head_ranks",
             "the jnp ops of _ranks_sorted_only, doubling.py:151"),
            ("invert_ranks",
             "the 1-key sort of _scatter_to_text_order, doubling.py:105")):
        rep = steps_report[name]
        head = rep["shapes"][1 if name == "head_ranks" else 0]
        step_kernels.append({
            "name": f"steps_{name}",
            "route": "cuda",
            "source": "stringsearch_torch/ops/csrc/steps.cu",
            "replaces": f"no pl.pallas_call: {what} in the JAX package's "
                        f"engines, which XLA fuses or sorts",
            "launches": build["step_launches"][name],
            "max_abs_err": max([s["max_abs_err"] for s in rep["shapes"]]
                               + [rep["edge_max_abs_err"]]),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "replaced_route_ms": head["replaced_ms"],
            "timed_shape": head["shape"],
            "shapes": rep["shapes"],
            "edge_cases": rep["edge_cases"],
        })

    # the global build's two kernels: launches from phase 13's first build;
    # headline, the first shape timed (the low half of the first merge;
    # shard 1, which has a predecessor)
    global_kernels = []
    for name, source, what, launches in (
            ("merge_split", "merge.cu",
             "the lax.sort of the 2L concatenation in _merge_halves, "
             "parallel/distsort.py:45 of the JAX package, which XLA sorts",
             global_report["merge_launches"]),
            ("shard_head_ranks", "steps.cu",
             "the jnp ops of the neighbour diff of _initial_shard_ranks "
             "and _doubling_step and of _headslot_ranks_from_sorted, "
             "parallel/global_sa.py:120 of the JAX package, which XLA "
             "fuses",
             global_report["head_ranks_launches"])):
        rep = merge_report[name]
        head = rep["shapes"][1 if name == "shard_head_ranks" else 0]
        global_kernels.append({
            "name": name if name == "merge_split" else f"steps_{name}",
            "route": "cuda",
            "source": f"stringsearch_torch/ops/csrc/{source}",
            "replaces": f"no pl.pallas_call: {what}",
            "launches": launches,
            "max_abs_err": max([s["max_abs_err"] for s in rep["shapes"]]
                               + [rep["edge_max_abs_err"]]),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "replaced_route_ms": head["replaced_ms"],
            "timed_shape": head["shape"],
            "shapes": rep["shapes"],
            "edge_cases": rep["edge_cases"],
        })

    # the global build's routing and placement kernels: launches from
    # phase 13's first build; headline, the first shape timed
    sources = {"route": "stringsearch_torch/ops/csrc/route.cu",
               "steps": "stringsearch_torch/ops/csrc/steps.cu"}
    replaced = {
        "route_partition":
            "the lax.sort by destination, searchsorted rank and send-buffer "
            "scatters of redistribute_permutation and rank_interval_sort, "
            "parallel/distsort.py:151-164 and 240-255 of the JAX package",
        "place_received":
            "the scatter to gidx % L of redistribute_permutation, "
            "parallel/distsort.py:167-178 of the JAX package",
        "shard_pack_keys":
            "the packing of _initial_shard_ranks, parallel/global_sa.py:"
            "166-189 of the JAX package",
        "shard_shift_planes":
            "_shifted_ranks and the round's _global_iota, parallel/"
            "global_sa.py:216 and 251 of the JAX package"}
    route_kernels = []
    for name, module in ROUTE_KERNELS:
        rep = route_report[name]
        head = rep["shapes"][0]
        route_kernels.append({
            "name": name if module == "route" else f"steps_{name}",
            "route": "cuda",
            "source": sources[module],
            "replaces": f"no pl.pallas_call: the jnp ops of "
                        f"{replaced[name]}, which XLA fuses",
            "launches": global_report["route_launches"][name],
            "max_abs_err": max([s["max_abs_err"] for s in rep["shapes"]]
                               + [rep["edge_max_abs_err"]]),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "replaced_route_ms": head["replaced_ms"],
            "timed_shape": head["shape"],
            "shapes": rep["shapes"],
            "edge_cases": rep["edge_cases"],
            **({"window_sweep": rep["window_sweep"]}
               if "window_sweep" in rep else {}),
        })

    say(json.dumps({"kernels": [
        sort_entry("radix_sort", "stringsearch_torch/ops/csrc/radix_sort.cu",
                   build["launches"], probe_launches=probe_sort_launches,
                   plain_radix_sort=sorts["radix_sort"]["plain_radix_sort"],
                   build=build, queries=queries,
                   phase_launches=phase_launches, cli_step_s=cli_steps,
                   bwt=bwt_report,
                   partitioned=partitioned_report, fuzz=fuzz_report,
                   engines=engines_report, fault_repair=wide_report,
                   global_build=global_report,
                   multihost=multihost_report),
        sort_entry("bitonic_sort", "stringsearch_torch/ops/csrc/bitonic.cu",
                   build["bitonic_launches"],
                   edge_cases=sorts["bitonic_sort"]["edge_cases"],
                   passes=sorts["bitonic_sort"]["passes"],
                   sizes=sorts["bitonic_sort"]["sizes"]),
        *radix_kernels, *step_kernels, *global_kernels, *route_kernels]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
