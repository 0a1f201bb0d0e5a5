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
    kernel, summed by name (`sort_hist_kernel`, `sort_plan_kernel` and
    `sort_pass_kernel` are the radix sort's three steps: one histogram
    read and one plan a sort, one kernel a pass), and the device's idle
    share, 1 - summed kernel time / median unprofiled wall.
Then, on each of the three sorts, the build walls of the small and
adversarial inputs that `chip_smoke.py` holds against the oracle, whose
cost is many small sorts. Then, at 2^28 on the radix sort, the same sort
times and kernel sums for what is built on the flat build: the partitioned
build (four partitions in one build), `bwt_from_sa` and `_unbwt_kernel`.
Last, the same for the dc3 and bstar engines' builds at 2^28, with the
radix sort's launches and the host syncs of one build. Then the exact
global build (`parallel/global_sa.py:build_global`) at 2^28 on four
shards of the one card, with the same numbers. Last, the same global
build across processes (`parallel/multihost.py:run_selftest`): two
processes of two shards each on gloo, and, where every process has a
card of its own, on nccl too, with one process a card; each process
prints its build walls, the bytes that crossed processes, the transport's
seconds and its peak memory. Needs a CUDA device.

The steps between the sorts run on their kernels (`ops/steps.py`), as in
the port. One more column, "radix kernel, plain steps", builds with the
plain versions of `pack_keys`, `shift_planes` and `head_ranks` (the eager
chain of PyTorch ops the kernels replaced) on the card in their place;
only this harness routes there, never the engines.

    python -m stringsearch_torch.harness.profile_build transforms
    python -m stringsearch_torch.harness.profile_build engines
    python -m stringsearch_torch.harness.profile_build global
    python -m stringsearch_torch.harness.profile_build multihost
    python -m stringsearch_torch.harness.profile_build steps
    python -m stringsearch_torch.harness.profile_build merge
    python -m stringsearch_torch.harness.profile_build route
    python -m stringsearch_torch.harness.profile_build bitonic

run one part alone; `steps` runs the flat, the partitioned
(P = 4) and the bstar build at 2^28 with the step kernels and with the
plain steps in turns (kernels, plain, plain, kernels), the same numbers
for each. `merge` runs the global build at 2^28 on four shards of one
card in turns, the route before the global build's two kernels and the
route through them (old, new, new, old): the old route merges by a
`device_sort` of each concatenation and ranks heads with the plain chain
(`plain_merge_split` and `plain_shard_head_ranks` on the card, which
only this harness does), the new one runs `merge_split` and
`shard_head_ranks`. `route` runs the same build in the same turns
against the routing and placement kernels of an earlier design
(`harness/route_variants.py`'s `earlier`, whose source the caller puts
at its EARLIER_SOURCE: at commit 4521b69 tiles of 4096, at most 256
buckets, the placement a scatter from registers, each with its own
windows a destination) in place of `route_partition` and
`place_received`; then the permutation route of one shard alone
(`route_partition` and `place_received`, their kernels by name) at each
number of windows a destination, the earlier design beside them.
`bitonic`
runs the flat build at 2^28 with every sort
on the bitonic kernel in turns with the radix sort (radix, bitonic,
bitonic, radix), the same numbers for each.
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
from stringsearch_torch.engines import bstar, dc3, doubling
from stringsearch_torch.harness.corpus import enwik_like, regression_corpus
from stringsearch_torch.ops import bitonic, merge, radix_sort, route, steps

SIZES = (24, 28)
# the steps between the sorts, as `engines/doubling.py` calls them
KERNEL_STEPS = {"pack_keys": steps.pack_keys,
                "shift_planes": steps.shift_planes,
                "head_ranks": steps.head_ranks}
PLAIN_STEPS = {"pack_keys": steps.plain_pack_keys,
               "shift_planes": steps.plain_shift_planes,
               "head_ranks": steps.plain_head_ranks}


def _route_steps(table: dict) -> None:
    for name, fn in table.items():
        setattr(doubling, name, fn)


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
            nbytes: int = 0, step_fns: dict = KERNEL_STEPS) -> None:
    """Three walls of fn() after a warm-up and its peak memory; the
    CUDA-event time of each sort it makes; its kernels summed by name and
    the device's idle share. `sort` takes the place of `device_sort` in
    `modules`, and `step_fns` that of the steps between the sorts in
    `engines/doubling.py`, meanwhile."""
    def route(fn_sort):
        for module in modules:
            module.device_sort = fn_sort

    def run():
        fn()
        torch.cuda.synchronize()

    route(sort)
    _route_steps(step_fns)
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
        step_launches = dict(steps.launches)
        syncs = _syncs(fn)
        torch.cuda.synchronize()
        launches = radix_sort.launches - launches
        step_launches = {k: steps.launches[k] - step_launches[k]
                         for k in step_launches}
        route(sort)
        by_shape = defaultdict(lambda: [0, 0.0])
        for c, nk, start, end in log:
            by_shape[(c, nk)][0] += 1
            by_shape[(c, nk)][1] += start.elapsed_time(end)
        sorts = sum(ms for _, ms in by_shape.values())
        for (c, nk), (count, ms) in sorted(by_shape.items()):
            print(f"   sort C={c} keys={nk}: {count} x, {ms:.3f} ms")
        print(f"   {len(log)} device_sort calls, {launches} radix sort "
              f"launches, {len(syncs)} host syncs, step kernel launches "
              f"{step_launches}")
        print(f"   host syncs at {dict(sorted(Counter(syncs).items()))}")

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
        _route_steps(KERNEL_STEPS)


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


def _old_merge(mine, theirs, mine_first, keep_low, num_keys):
    """The merge-split as it was before `merge_split`: a `device_sort` of
    the concatenation (looked up in `distsort` at the call, so `profile`
    times it as a sort)."""
    from stringsearch_torch.parallel import distsort

    return merge.plain_merge_split(mine, theirs, mine_first, keep_low,
                                   num_keys, sort=distsort.device_sort)


def profile_merge(log2n: int = 28, shards: int = 4) -> None:
    """The global build at 2^log2n on `shards` shards of one card, in
    turns: the old route (merges by sorting each concatenation, the plain
    head-ranking chain), the new (`merge_split`, `shard_head_ranks`), the
    new, the old. The merge and head-rank launches of each turn are
    printed with the rest."""
    from stringsearch_torch.parallel import distsort, gather, global_sa
    from stringsearch_torch.parallel.mesh import make_mesh

    n = 1 << log2n
    text = torch.from_numpy(
        np.frombuffer(enwik_like(n), dtype=np.uint8).copy()).to("cuda")
    mesh = make_mesh(devices=[torch.device("cuda")] * shards)
    routes = {"old route": (_old_merge, steps.plain_shard_head_ranks),
              "new route": (merge.merge_split, steps.shard_head_ranks)}
    for turn, label in enumerate(("old route", "new route", "new route",
                                  "old route"), 1):
        distsort.merge_split, global_sa.shard_head_ranks = routes[label]
        before = merge.launches, steps.launches["shard_head_ranks"]
        try:
            profile(f"2^{log2n} global build, {shards} shards of one card, "
                    f"{label} (turn {turn})",
                    lambda: global_sa.build_global(text, mesh),
                    modules=(distsort, gather, global_sa), nbytes=n)
        finally:
            distsort.merge_split, global_sa.shard_head_ranks = \
                routes["new route"]
        print(f"   merge_split launches {merge.launches - before[0]}, "
              f"shard_head_ranks launches "
              f"{steps.launches['shard_head_ranks'] - before[1]} over the "
              f"turn's six builds", flush=True)
        torch.cuda.empty_cache()


def profile_route(log2n: int = 28, shards: int = 4) -> None:
    """The global build at 2^log2n on `shards` shards of one card, in
    turns: the routing and placement kernels of the earlier design
    (`route_variants.EARLIER_SOURCE`, with its own windows a destination),
    the kernels as built, as built, the earlier design. The two functions' launches
    of each turn are printed with the rest."""
    from stringsearch_torch.harness import route_variants
    from stringsearch_torch.parallel import distsort, gather, global_sa
    from stringsearch_torch.parallel.mesh import make_mesh

    n = 1 << log2n
    text = torch.from_numpy(
        np.frombuffer(enwik_like(n), dtype=np.uint8).copy()).to("cuda")
    mesh = make_mesh(devices=[torch.device("cuda")] * shards)
    names = ("route_partition", "place_received", "receiver_windows")
    routes = {
        "kernels": [getattr(distsort, name) for name in names],
        "earlier kernels": [route_variants.earlier_route,
                            route_variants.earlier_place,
                            route_variants.earlier_windows]}

    def take(label):
        for name, fn in zip(names, routes[label]):
            setattr(distsort, name, fn)

    route_variants.earlier_library()
    for turn, label in enumerate(("earlier kernels", "kernels", "kernels",
                                  "earlier kernels"), 1):
        take(label)
        before = dict(route.launches)
        try:
            profile(f"2^{log2n} global build, {shards} shards of one card, "
                    f"{label} (turn {turn})",
                    lambda: global_sa.build_global(text, mesh),
                    modules=(distsort, gather, global_sa), nbytes=n)
        finally:
            take("kernels")
        launched = {name: route.launches[name] - before[name]
                    for name in before}
        print(f"   routing and placement launches over the turn's six "
              f"builds: {launched}", flush=True)
        torch.cuda.empty_cache()


def route_windows(log2n: int = 28, shards: int = 4) -> None:
    """The permutation route of one shard of the global build at 2^log2n
    on `shards` shards: `route_partition` (its kernels timed by name) and
    the receiver's `place_received` with each number of windows a
    destination, on a random permutation; the earlier design at its own
    windows beside them."""
    from stringsearch_torch.harness import route_variants
    from stringsearch_torch.parallel import collectives as coll
    from stringsearch_torch.parallel.distsort import redistribute_cap

    length, p = (1 << log2n) // shards, shards
    cap = redistribute_cap(p, length)
    gen = torch.Generator(device="cuda").manual_seed(15)
    gidx = list(torch.randperm(p * length, generator=gen, device="cuda")
                .to(torch.int32).view(p, length))
    vals = [torch.randint(0, 1 << 30, (length,), generator=gen,
                          device="cuda", dtype=torch.int32)
            for _ in range(p)]

    def ms(fn, reps=10):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    cases = [("earlier", w, route_variants.earlier_route,
              route_variants.earlier_place)
             for w in (16, route_variants.earlier_windows(p, length))]
    cases += [("as built", w, route.route_partition, route.place_received)
              for w in sorted({16, 64, 128, 256, 512,
                               route.receiver_windows(p, length)})]
    for label, w, send_fn, place_fn in cases:
        def send(me, w=w, send_fn=send_fn):
            return send_fn(gidx[me], length, p, (gidx[me], vals[me]),
                           (-1, 0), cap, False, w)
        sends = [send(me)[0] for me in range(p)]
        recv_g = coll.all_to_all([s[0] for s in sends])
        recv = coll.all_to_all([s[1] for s in sends])
        del sends
        r_ms = ms(lambda: send(1))
        p_ms = ms(lambda: place_fn(recv_g[1], (recv[1],), length, w))
        per = _kernel_sums(lambda: send(1))
        per.update(_kernel_sums(
            lambda: place_fn(recv_g[1], (recv[1],), length, w)))
        kernels = {name: round(t, 4) for name, (t, _) in per.items()
                   if name.startswith(("route_", "place_"))}
        print(f"2^{log2n} / {p} shards, the permutation route of shard 1, "
              f"{label}, {w} windows a destination: route_partition "
              f"{r_ms:.4f} ms, place_received {p_ms:.4f} ms, both "
              f"{r_ms + p_ms:.4f} ms ({kernels})", flush=True)
        del recv_g, recv


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


def profile_steps(log2n: int = 28) -> None:
    """The flat, the partitioned (P = 4) and the bstar build (which reaches
    the steps through `build_ints_with_isa`) at 2^log2n with the step
    kernels and with the plain steps, in turns: kernels, plain, plain,
    kernels."""
    from stringsearch_torch.parallel.partitioned import build_partitioned

    n = 1 << log2n
    text = torch.from_numpy(
        np.frombuffer(enwik_like(n), dtype=np.uint8).copy()).to("cuda")
    builds = (("build", lambda: _one_build(text), (doubling,)),
              ("partitioned build, 4 partitions",
               lambda: build_partitioned(text, 4), (doubling,)),
              ("bstar build", lambda: bstar.sort(text), (bstar, doubling)))
    turns = (("step kernels", KERNEL_STEPS), ("plain steps", PLAIN_STEPS),
             ("plain steps", PLAIN_STEPS), ("step kernels", KERNEL_STEPS))
    for what, fn, modules in builds:
        for turn, (label, table) in enumerate(turns, 1):
            profile(f"2^{log2n} {what}, radix kernel, {label} (turn {turn})",
                    fn, modules=modules, nbytes=n, step_fns=table)
            torch.cuda.empty_cache()


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


def profile_bitonic() -> None:
    """The flat build at 2^28 with every sort on the bitonic kernel, in
    turns with the radix sort: radix, bitonic, bitonic, radix."""
    bitonic.load_library()
    text = torch.from_numpy(np.frombuffer(
        enwik_like(1 << 28), dtype=np.uint8).copy()).to("cuda")
    for turn, (label, sort) in enumerate(
            (("radix kernel", bitonic.device_sort),
             ("bitonic kernel", bitonic.bitonic_sort),
             ("bitonic kernel", bitonic.bitonic_sort),
             ("radix kernel", bitonic.device_sort)), 1):
        profile(f"2^28 build, {label} (turn {turn})",
                lambda: _one_build(text), sort, nbytes=1 << 28)
        torch.cuda.empty_cache()


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    radix_sort.load_library()
    steps.load_library()
    merge.load_library()
    route.load_library()
    if sys.argv[1:] == ["transforms"]:
        profile_transforms()
        return
    if sys.argv[1:] == ["engines"]:
        profile_engines()
        return
    if sys.argv[1:] == ["global"]:
        profile_global()
        return
    if sys.argv[1:] == ["multihost"]:
        profile_multihost()
        return
    if sys.argv[1:] == ["merge"]:
        profile_merge()
        return
    if sys.argv[1:] == ["route"]:
        profile_route()
        route_windows()
        return
    if sys.argv[1:] == ["steps"]:
        profile_steps()
        return
    if sys.argv[1:] == ["bitonic"]:
        profile_bitonic()
        return
    bitonic.load_library()
    for log2n in SIZES:
        text = torch.from_numpy(
            np.frombuffer(enwik_like(1 << log2n), dtype=np.uint8).copy()
        ).to("cuda")
        for label, sort, table in (
                ("radix kernel", bitonic.device_sort, KERNEL_STEPS),
                ("radix kernel, plain steps", bitonic.device_sort,
                 PLAIN_STEPS),
                ("bitonic kernel", bitonic.bitonic_sort, KERNEL_STEPS),
                ("plain", bitonic.plain_sort, KERNEL_STEPS)):
            profile(f"2^{log2n} build, {label}",
                    lambda text=text: _one_build(text), sort,
                    nbytes=1 << log2n, step_fns=table)
        del text
        torch.cuda.empty_cache()
    compaction_walls()
    profile_transforms()
    profile_engines()
    profile_global()
    profile_multihost()


if __name__ == "__main__":
    main()
