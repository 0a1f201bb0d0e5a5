"""Where the time of one suffix-array build goes, on one GPU.

    python -m stringsearch_torch.harness.profile_build

At n = 2^24 and 2^28 bytes of enwik-like text it builds the suffix array
with every sort on the Hopper radix sort (`device_sort`, the port as it
is), then on the Hopper bitonic kernel (`bitonic_sort`) and on the plain
chained `torch.sort` in its place, and prints for each:
  * the host wall of three builds after a warm-up one (each ends in
    `torch.cuda.synchronize()`), and the peak CUDA memory of a build;
  * the CUDA-event time of every `device_sort` call of one build, with its
    plane and key counts, and the build's device time outside the sorts;
  * from `torch.profiler` over one more build: the device time of each
    kernel, summed by name (`sort_hist_kernel`, `sort_scan_kernel` and
    `sort_scatter_kernel` are the radix sort's three steps), and the
    device's idle share, 1 - summed kernel time / median unprofiled wall.
Then, on each of the three sorts, the build walls of the small and
adversarial inputs that `chip_smoke.py` holds against the oracle, whose
cost is many small sorts. Then, at 2^28 on the radix sort, the same sort
times and kernel sums for what is built on the flat build: the partitioned
build (four partitions in one build), `bwt_from_sa` and `_unbwt_kernel`.
Last, the same for the dc3 and bstar engines' builds at 2^28, with the
radix sort's launches and the host syncs of one build. Then the exact
global build (`parallel/global_sa.py:build_global`) at 2^28 on four
shards of the one card, with the same numbers. Needs a CUDA device.

    python -m stringsearch_torch.harness.profile_build transforms
    python -m stringsearch_torch.harness.profile_build engines
    python -m stringsearch_torch.harness.profile_build global

run the last three parts alone.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
import time
import warnings
from collections import defaultdict

import numpy as np
import torch

import stringsearch_torch as st
from stringsearch_torch.engines import bstar, dc3, doubling
from stringsearch_torch.harness.corpus import enwik_like, regression_corpus
from stringsearch_torch.ops import bitonic, radix_sort

SIZES = (24, 28)


def _timed(sort, log):
    """`sort`, recording CUDA events around each call into `log`."""
    def timed_sort(operands, num_keys=1):
        operands = tuple(operands)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = sort(operands, num_keys)
        end.record()
        log.append((len(operands), num_keys, start, end))
        return out
    return timed_sort


def _one_build(text):
    sa = st.build_suffix_array(text, device="cuda")
    torch.cuda.synchronize()
    return sa


def _short(name: str) -> str:
    """A kernel's name without its namespace and argument list."""
    name = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
    return re.sub(r"\((?!\().*$", "", name).strip()[:72]


def _kernel_sums(fn) -> dict:
    """Device time of each kernel of fn(), summed by name, from
    `torch.profiler`: {name: [ms, launches]}."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            per[_short(e.name)][0] += e.time_range.elapsed_us() / 1e3
            per[_short(e.name)][1] += 1
    return per


def profile(label: str, fn, sort=bitonic.device_sort, modules=(doubling,),
            nbytes: int = 0) -> None:
    """Three walls of fn() after a warm-up and its peak memory; the
    CUDA-event time of each sort it makes; its kernels summed by name and
    the device's idle share. `sort` takes the place of `device_sort` in
    `modules` meanwhile."""
    def route(fn_sort):
        for module in modules:
            module.device_sort = fn_sort

    def run():
        fn()
        torch.cuda.synchronize()

    route(sort)
    try:
        run()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        wall = statistics.median(walls)
        rate = f", {nbytes / wall:.1f} B/s" if nbytes else ""
        print(f"{label}: wall {', '.join(f'{w:.4f}' for w in walls)} s "
              f"(median {wall:.4f} s{rate}), peak CUDA memory {peak} B",
              flush=True)

        log = []
        route(_timed(sort, log))
        launches = radix_sort.launches
        syncs = _syncs(fn)
        torch.cuda.synchronize()
        launches = radix_sort.launches - launches
        route(sort)
        by_shape = defaultdict(lambda: [0, 0.0])
        for c, nk, start, end in log:
            by_shape[(c, nk)][0] += 1
            by_shape[(c, nk)][1] += start.elapsed_time(end)
        sorts = sum(ms for _, ms in by_shape.values())
        for (c, nk), (count, ms) in sorted(by_shape.items()):
            print(f"   sort C={c} keys={nk}: {count} x, {ms:.3f} ms")
        print(f"   {len(log)} device_sort calls, {launches} radix sort "
              f"launches, {syncs} host syncs")

        per = _kernel_sums(run)
        busy = sum(ms for ms, _ in per.values())
        if not per:
            print("   profiler: no device events recorded (idle share not "
                  "measured)")
            return
        print(f"   sorts {sorts:.3f} ms; device time outside the sorts "
              f"{busy - sorts:.3f} ms")
        print(f"   profiler: summed kernel time {busy:.3f} ms of wall "
              f"{wall * 1e3:.3f} ms, idle share {1 - busy / (wall * 1e3):.4f}")
        for name, (ms, count) in sorted(per.items(), key=lambda kv: -kv[1][0]):
            if ms >= 0.01 * busy:
                print(f"   {ms:10.3f} ms x {count:3d}  {name}")
    finally:
        route(bitonic.device_sort)


def _syncs(fn) -> int:
    """fn(), and the number of times it made the host wait for the device
    (`torch.cuda.set_sync_debug_mode` warns once for each)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_engines(log2n: int = 28) -> None:
    """The dc3 and bstar builds at 2^log2n on the radix sort."""
    n = 1 << log2n
    text = torch.from_numpy(
        np.frombuffer(enwik_like(n), dtype=np.uint8).copy()).to("cuda")
    for name, module in (("dc3", dc3), ("bstar", bstar)):
        profile(f"2^{log2n} {name} build",
                lambda m=module: m.sort(text), modules=(module, doubling),
                nbytes=n)
        torch.cuda.empty_cache()


def profile_transforms(log2n: int = 28) -> None:
    """What is built on the flat build, at 2^log2n on the radix sort: the
    partitioned build (four partitions in one build) and the two BWT
    functions."""
    import importlib

    from stringsearch_torch.parallel.partitioned import build_partitioned

    # the package's attribute `bwt` is the function, not the module
    bwt = importlib.import_module("stringsearch_torch.transforms.bwt")
    n = 1 << log2n
    text = torch.from_numpy(
        np.frombuffer(enwik_like(n), dtype=np.uint8).copy()).to("cuda")
    profile(f"2^{log2n} partitioned build, 4 partitions",
            lambda: build_partitioned(text, 4), nbytes=n)
    sa = _one_build(text).sa
    profile(f"2^{log2n} bwt_from_sa", lambda: bwt.bwt_from_sa(text, sa))
    u, pidx = bwt.bwt_from_sa(text, sa)
    del sa
    rounds = n.bit_length()
    profile(f"2^{log2n} _unbwt_kernel, {rounds} rounds",
            lambda: bwt._unbwt_kernel(u, pidx, rounds), modules=(bwt,))


def profile_global(log2n: int = 28, shards: int = 4) -> None:
    """The exact global build at 2^log2n on `shards` shards of one card:
    every shard's sorts on the radix sort, one after another."""
    from stringsearch_torch.parallel import distsort, gather, global_sa
    from stringsearch_torch.parallel.mesh import make_mesh

    n = 1 << log2n
    text = torch.from_numpy(
        np.frombuffer(enwik_like(n), dtype=np.uint8).copy()).to("cuda")
    mesh = make_mesh(devices=[torch.device("cuda")] * shards)
    profile(f"2^{log2n} global build, {shards} shards of one card",
            lambda: global_sa.build_global(text, mesh),
            modules=(distsort, gather, global_sa), nbytes=n)


def compaction_walls() -> None:
    """Build walls of the inputs whose cost is many small sorts: the two
    adversarial texts one by one, then the whole set that `chip_smoke.py`
    holds against the oracle (those two, enwik-like text of 2^24 bytes and
    the regression corpus) as one sum of build walls, on each sort."""
    rng = np.random.default_rng(4)
    ff = rng.integers(0, 256, 1 << 20, dtype=np.uint8)
    ff[5000:5300] = 0xFF
    inputs = {"ab*2^19": b"ab" * (1 << 19),
              "random 2^20 + 300x0xFF": ff.tobytes()}
    single = len(inputs)
    inputs["enwik_like(2^24)"] = enwik_like(1 << 24)
    inputs.update(regression_corpus())
    texts = {name: torch.from_numpy(
        np.frombuffer(data, dtype=np.uint8).copy()).to("cuda")
        for name, data in inputs.items() if len(data) > 0}
    sorts = (("radix kernel", bitonic.device_sort),
             ("bitonic kernel", bitonic.bitonic_sort),
             ("plain", bitonic.plain_sort))
    for label, sort in sorts:
        calls, walls = {}, {}
        try:
            for name, text in texts.items():
                log = []
                doubling.device_sort = _timed(sort, log)
                _one_build(text)
                calls[name] = len(log)
                doubling.device_sort = sort
                walls[name] = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    _one_build(text)
                    walls[name].append(time.perf_counter() - t0)
        finally:
            doubling.device_sort = bitonic.device_sort
        for name in list(texts)[:single]:
            print(f"{name} {label}: {calls[name]} sorts a build, build wall "
                  f"{', '.join(f'{w:.4f}' for w in walls[name])} s "
                  f"(median {statistics.median(walls[name]):.4f} s)",
                  flush=True)
        total = sum(statistics.median(w) for w in walls.values())
        print(f"all {len(texts)} oracle-checked inputs {label}: "
              f"{sum(calls.values())} sorts, sum of median build walls "
              f"{total:.4f} s", flush=True)


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    radix_sort.load_library()
    if sys.argv[1:] == ["transforms"]:
        profile_transforms()
        return
    if sys.argv[1:] == ["engines"]:
        profile_engines()
        return
    if sys.argv[1:] == ["global"]:
        profile_global()
        return
    bitonic.load_library()
    for log2n in SIZES:
        text = torch.from_numpy(
            np.frombuffer(enwik_like(1 << log2n), dtype=np.uint8).copy()
        ).to("cuda")
        for label, sort in (("radix kernel", bitonic.device_sort),
                            ("bitonic kernel", bitonic.bitonic_sort),
                            ("plain", bitonic.plain_sort)):
            profile(f"2^{log2n} build, {label}",
                    lambda text=text: _one_build(text), sort,
                    nbytes=1 << log2n)
        del text
        torch.cuda.empty_cache()
    compaction_walls()
    profile_transforms()
    profile_engines()
    profile_global()


if __name__ == "__main__":
    main()
