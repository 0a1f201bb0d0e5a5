"""Where the time of one suffix-array build goes, on one GPU.

    python -m stringsearch_torch.harness.profile_build

At n = 2^24 and 2^28 bytes of enwik-like text it builds the suffix array
as the port does (every sort on the Hopper radix sort of `device_sort`,
the steps between the sorts on their kernels) and prints:
  * the host wall of three builds after a warm-up one (each ends in
    `torch.cuda.synchronize()`), and the peak CUDA memory of a build;
  * from `torch.profiler` over one more build, and the program's own
    spans of it (`harness/tracing.py`): the device time of every sort (the
    `ops.device_sort` spans), by plane and key count, and the build's
    device time outside the sorts; the device time of each phase of the
    doubling engine (the `doubling.*` spans: the initial sort, the full
    rounds, the inverts, the compaction stage, its extraction and shrinks,
    the host waits) and the tied count round by round; the device time
    of each kernel, summed by name (`sort_hist_kernel`, `sort_plan_kernel`
    and `sort_pass_kernel` are the radix sort's three steps: one histogram
    read and one plan a sort, one kernel a pass), and the device's idle
    share, 1 - summed kernel time / median unprofiled wall.
Then, at 2^28, the same numbers for what is built on the flat build: the
partitioned build (four partitions in one build), `bwt_from_sa` and
`_unbwt_kernel`. Then the dc3 and bstar engines' builds at 2^28, with the
radix sort's launches and the host syncs of one build. Then the exact
global build (`parallel/global_sa.py:build_global`) at 2^28 on four
shards of the one card, with the same numbers. Last, the same global
build across processes (`parallel/multihost.py:run_selftest`): two
processes of two shards each on gloo, and, where every process has a
card of its own, on nccl too, with one process a card; each process
prints its build walls, the bytes that crossed processes, the transport's
seconds and its peak memory. Needs a CUDA device.

    python -m stringsearch_torch.harness.profile_build transforms
    python -m stringsearch_torch.harness.profile_build engines
    python -m stringsearch_torch.harness.profile_build global
    python -m stringsearch_torch.harness.profile_build multihost

run one part alone. The benchmark (`python -m sabench`) times the cells;
this script times the paths that no cell drives.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from collections import Counter, defaultdict

import numpy as np
import torch

import stringsearch_torch as st
from stringsearch_torch.engines import bstar, dc3
from stringsearch_torch.harness import tracing
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.ops import merge, radix_sort, route, steps

SIZES = (24, 28)


def _one_build(text):
    sa = st.build_suffix_array(text, device="cuda")
    torch.cuda.synchronize()
    return sa


def _short(name: str) -> str:
    """A kernel's name without its namespace and argument list."""
    name = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
    return re.sub(r"\((?!\().*$", "", name).strip()[:72]


def _profiled(fn) -> tuple:
    """fn() under `torch.profiler`: the device time of each kernel, summed
    by name, {name: [ms, launches]}, and the program's spans of it on the
    profiler's clock, with their device times (`tracing.records`)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per = defaultdict(lambda: [0.0, 0])
    host, device = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if str(e.device_type).endswith("CUDA"):
            per[_short(e.name)][0] += (end - start) / 1e3
            per[_short(e.name)][1] += 1
            device.append((e.name, start, end))
        else:
            host.append((e.name, start, end))
    return per, tracing.records(host, device)


def _kernel_sums(fn) -> dict:
    """Device time of each kernel of fn(), summed by name, from
    `torch.profiler`: {name: [ms, launches]}."""
    return _profiled(fn)[0]


def print_phases(spans) -> None:
    """Print the doubling engine's phases from its spans, summed over the
    builds they hold: the device time of the builds, the initial sort, the
    full rounds less their inverts, the inverts, the compaction stage less
    its invert, and inside it the extraction and the shrinks; the host
    waits, their device time (the count's copy) and their host time; the
    tied count after the initial sort and each round of the first
    build."""
    builds = [s for s in spans if s.name == "doubling.build"]
    if not builds or any(s.device_ms is None for s in builds):
        print("   phases: no build with device times among the spans")
        return
    name = {s.index: s.name for s in spans}

    def ms(what, parent=None):
        """Device time of the spans `what` under a span `parent`, or
        anywhere."""
        return sum(s.device_ms or 0.0 for s in spans if s.name == what and (
            parent is None or name.get(s.parent) == parent))

    waits = [s for s in spans if s.name == "doubling.wait"]
    rounds = ms("doubling.round") - ms("doubling.invert", "doubling.round")
    compact = ms("doubling.compact") - ms("doubling.invert",
                                          "doubling.compact")
    print(f"   phases ({len(builds)} build(s), device ms): builds "
          f"{ms('doubling.build'):.3f}, initial "
          f"{ms('doubling.initial'):.3f}, full rounds less inverts "
          f"{rounds:.3f}, inverts {ms('doubling.invert'):.3f}, compaction "
          f"less its invert {compact:.3f} (extraction "
          f"{ms('doubling.extract'):.3f}, shrinks "
          f"{ms('doubling.shrink'):.3f}); {len(waits)} host waits, "
          f"{ms('doubling.wait'):.3f} ms device, "
          f"{sum(s.end_us - s.start_us for s in waits) / 1e3:.3f} ms host")
    first, last = builds[0].index, (builds[1].index if len(builds) > 1
                                    else float("inf"))
    tied = [s.attrs.get("tied", s.attrs.get("tied_out")) for s in spans
            if first < s.index < last and s.name in (
                "doubling.initial", "doubling.round",
                "doubling.compact_round")]
    print(f"   tied after the initial sort and each round (first build): "
          f"{tied}")


def profile(label: str, fn, nbytes: int = 0) -> None:
    """Three walls of fn() after a warm-up and its peak memory; the device
    time of each sort it makes and of the doubling engine's phases, from
    the program's spans; its kernels summed by name and the device's idle
    share."""
    def run():
        fn()
        torch.cuda.synchronize()

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

    launches = radix_sort.launches
    step_launches = dict(steps.launches)
    syncs = _syncs(fn)
    torch.cuda.synchronize()
    launches = radix_sort.launches - launches
    step_launches = {k: steps.launches[k] - step_launches[k]
                     for k in step_launches}

    per, spans = _profiled(run)
    sort_spans = [s for s in spans if s.name == "ops.device_sort"]
    by_shape = defaultdict(lambda: [0, 0.0])
    for s in sort_spans:
        shape = (len(s.attrs["itemsizes"]), s.attrs["num_keys"])
        by_shape[shape][0] += 1
        by_shape[shape][1] += s.device_ms or 0.0
    sorts = sum(ms for _, ms in by_shape.values())
    for (c, nk), (count, ms) in sorted(by_shape.items()):
        print(f"   sort C={c} keys={nk}: {count} x, {ms:.3f} ms")
    print(f"   {len(sort_spans)} device_sort calls, {launches} radix sort "
          f"launches, {len(syncs)} host syncs, step kernel launches "
          f"{step_launches}")
    print(f"   host syncs at {dict(sorted(Counter(syncs).items()))}")
    print_phases(spans)
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


def _syncs(fn) -> list:
    """fn(), and the places where it made the host wait for the device
    (`torch.cuda.set_sync_debug_mode` warns once for each): for each wait,
    the innermost frame of the package below this harness, as
    "module/file.py:line"."""
    sites = []

    def seen(message, *args, **kwargs):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()
                  if f"{os.sep}stringsearch_torch{os.sep}" in f.filename
                  and f"{os.sep}harness{os.sep}" not in f.filename]
        frame = frames[-1] if frames else traceback.extract_stack()[-3]
        path = frame.filename.split(f"stringsearch_torch{os.sep}")[-1]
        sites.append(f"{path}:{frame.lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sites


def profile_engines(log2n: int = 28) -> None:
    """The dc3 and bstar builds at 2^log2n on the radix sort."""
    n = 1 << log2n
    text = torch.from_numpy(
        np.frombuffer(enwik_like(n), dtype=np.uint8).copy()).to("cuda")
    for name, module in (("dc3", dc3), ("bstar", bstar)):
        profile(f"2^{log2n} {name} build", lambda m=module: m.sort(text),
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
            lambda: bwt._unbwt_kernel(u, pidx, rounds))


def profile_global(log2n: int = 28, shards: int = 4) -> None:
    """The exact global build at 2^log2n on `shards` shards of one card:
    every shard's sorts on the radix sort, one after another."""
    from stringsearch_torch.parallel import global_sa
    from stringsearch_torch.parallel.mesh import make_mesh

    n = 1 << log2n
    text = torch.from_numpy(
        np.frombuffer(enwik_like(n), dtype=np.uint8).copy()).to("cuda")
    mesh = make_mesh(devices=[torch.device("cuda")] * shards)
    profile(f"2^{log2n} global build, {shards} shards of one card",
            lambda: global_sa.build_global(text, mesh), nbytes=n)


def profile_multihost(log2n: int = 28, shards: int = 4) -> None:
    """The global build at 2^log2n across processes (process i on card i
    modulo the cards visible): 2 x shards/2 on gloo, which runs on one
    card; where `shards` cards are visible, 2 x shards/2 on nccl and
    shards x 1 on nccl and on gloo. Each layout runs three builds; every
    process checks its SA shards against the flat build's."""
    from stringsearch_torch.parallel import multihost

    n = 1 << log2n
    text = np.frombuffer(enwik_like(n), dtype=np.uint8)
    flat = st.build_suffix_array(text, device="cuda")
    want = flat.sa.cpu().numpy()
    del flat
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    layouts = [("gloo", 2, shards // 2)]
    if cards >= shards:
        layouts += [("nccl", 2, shards // 2), ("nccl", shards, 1),
                    ("gloo", shards, 1)]
    for backend, nproc, per in layouts:
        t0 = time.perf_counter()
        reports = multihost.run_selftest(
            nproc=nproc, devs_per_proc=per, device="cuda", backend=backend,
            text=text, want=want, builds=3, timeout=900.0)
        warm = [statistics.median(r["walls_s"][1:]) for r in reports]
        print(f"2^{log2n} global build across processes, {backend}, "
              f"{nproc} x {per} shards on {min(nproc, cards)} card(s): "
              f"warm wall {max(warm):.4f} s (median of builds 2-3, slowest "
              f"process), crossed {[r['crossed'] for r in reports]} B, "
              f"transport {[round(r['transport_s'], 4) for r in reports]} "
              f"s, radix launches "
              f"{[r['radix_launches'] for r in reports]}, merge_split "
              f"launches {[r['merge_launches'] for r in reports]}, peak "
              f"{[r['peak_bytes'] for r in reports]} B; run_selftest "
              f"{time.perf_counter() - t0:.2f} s", flush=True)


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    radix_sort.load_library()
    steps.load_library()
    merge.load_library()
    route.load_library()
    modes = {"transforms": profile_transforms, "engines": profile_engines,
             "global": profile_global, "multihost": profile_multihost}
    if len(sys.argv) == 2 and sys.argv[1] in modes:
        modes[sys.argv[1]]()
        return
    for log2n in SIZES:
        text = torch.from_numpy(
            np.frombuffer(enwik_like(1 << log2n), dtype=np.uint8).copy()
        ).to("cuda")
        profile(f"2^{log2n} build", lambda text=text: _one_build(text),
                nbytes=1 << log2n)
        del text
        torch.cuda.empty_cache()
    for mode in modes.values():
        mode()


if __name__ == "__main__":
    main()
