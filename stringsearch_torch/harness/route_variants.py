"""What each design choice of the routing and placement kernels buys, and
the design they replaced, on one GPU.

    python -m stringsearch_torch.harness.route_variants [sweep|earlier]

`sweep` (the default): one shard's permutation route of the global build
at 2^26 elements a shard of four (gidx and one int32 operand, as the
initial redistribute sends them), on copies of `ops/csrc/route.cu` with
one choice changed (VARIANTS: the partition's tile and block, the
placement's block, cluster, share of a window and unrolling, each a text
replacement that must match its source exactly once). For each,
`route_partition` at 4, 64, 256 and 1024 buckets (1, 16, 64 and 256
windows a destination), held against the plain version first, its
kernels by name from `torch.profiler`, then the placement of what shard
1 receives at 16 to 1024 windows a destination, held against the plain
scatter. The copies are written to and built in
`stringsearch_torch/_build/variants/`.

`earlier`: the kernels against an earlier design of `csrc/route.cu` with
the same C interface as at commit 4521b69 (tiles of 4096, at most 256
buckets and 8 operands a call, placement by a scatter from registers),
whose source the caller puts at EARLIER_SOURCE, for instance with
`git show 4521b69:stringsearch_torch/ops/csrc/route.cu`. Each at its own
windows a destination (`receiver_windows`, `earlier_windows`), on random
permutations: the route of shard 1 and the placement of what it
receives, at four shards of 2^26 with gidx and the operand int32 and
int64 (where a window of int64 is wider than a cluster) and at eight
shards of 2^26 (the same), and the route of a round's `rank_interval_sort`
(four int32 or int64 operands, clamped, one window) at four shards of
2^26; each held against the plain version (tolerance 0), then timed in
turns, now, earlier, earlier, now. `earlier_library`, `earlier_route`,
`earlier_place` and `earlier_windows` run the earlier design behind the
same arguments as the port's wrappers, for `harness/profile_build.py
route` too.

Each time is the mean of CUDA events over ten calls after a warm one,
beside the function's bytes bound at 3.35 TB/s: the route reads each
operand once and writes each send buffer once; the placement by windows
reads the L live entries of gidx and of the operand and writes the
output once. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import threading

import torch

from stringsearch_torch.ops import _build, route

# where `earlier` finds the earlier design's source
EARLIER_SOURCE = os.path.join(_build.BUILD_DIR, "earlier", "route.cu")
BYTES_PER_S = 3.35e12
# the earlier design's kMaxBuckets and its window rule's fewest slots a
# window
_EARLIER_BUCKETS = 256
_EARLIER_MIN_WINDOW = 16
_P = ctypes.c_void_p
_lock = threading.Lock()
_earlier = None

_THREADS = "constexpr int kThreads = 512;"
_BLOCKS = "constexpr int kPartitionBlocks = 2;"
_ITEMS = "constexpr int kItems = 16;  // elements a thread, 32 apart"
_PLACE_THREADS = "constexpr int kPlaceThreads = 1024;"
_PLACE_BYTES = "constexpr int kPlaceBytes = 128 * 1024;"
_CLUSTER = "constexpr int kCluster = 8;"
_UNROLL = "constexpr int kPlaceUnroll = 4;"
VARIANTS = {
    "as built": (),
    # the earlier design's tile, 4096 elements on 256 threads
    "tile 4096": ((_THREADS, _THREADS.replace("512", "256")),),
    # the partition's registers unbounded by a second block an SM: 96 a
    # thread with no spills, one block of 512 threads an SM
    "partition, one block an SM": ((_BLOCKS, _BLOCKS.replace("2", "1")),),
    # 8192 elements on 256 threads, 32 a thread
    "tile 8192 on 256 threads": (
        (_THREADS, _THREADS.replace("512", "256")),
        (_ITEMS, _ITEMS.replace("16;", "32;"))),
    # 16384 elements: 32 a thread, or 16 on 1024 threads
    "tile 16384, 32 a thread": ((_ITEMS, _ITEMS.replace("16;", "32;")),),
    "tile 16384, 1024 threads": ((_THREADS, _THREADS.replace("512",
                                                             "1024")),),
    "placement on 512 threads": ((_PLACE_THREADS,
                                  _PLACE_THREADS.replace("1024", "512")),),
    "placement 64 KB a block": ((_PLACE_BYTES,
                                 _PLACE_BYTES.replace("128", "64")),),
    "placement clusters of 4": ((_CLUSTER, _CLUSTER.replace("8", "4")),),
    # half of a block's stores to another block's shared memory, where
    # clusters of 8 send seven eighths
    "placement clusters of 2": ((_CLUSTER, _CLUSTER.replace("8", "2")),),
    "placement unroll 8": ((_UNROLL, _UNROLL.replace("4", "8")),),
}


def variant_source(name: str) -> str:
    """Write the patched copy of variant `name`'s source; returns its path."""
    with open(route._SOURCE) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: {old!r} does not occur "
                               f"exactly once in {route._SOURCE}")
        src = src.replace(old, new)
    path = os.path.join(_build.BUILD_DIR, "variants",
                        "route_" + name.replace(" ", "_").replace(",", "")
                        + ".cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path


def variant_library(name: str) -> ctypes.CDLL:
    """Build (first call only) and load variant `name` of the kernels."""
    path = _build.build_library(
        "route_" + name.replace(" ", "_").replace(",", ""),
        [variant_source(name)], [_build.nvcc(), *_build.NVCC_FLAGS])
    return route._load(path)


# ---------------------------------------------------------------------------
# the earlier design, behind the wrappers' arguments
# ---------------------------------------------------------------------------


def earlier_library() -> ctypes.CDLL:
    """Build (first call only) and load the earlier design's library from
    EARLIER_SOURCE."""
    global _earlier
    with _lock:
        if _earlier is None:
            if not os.path.exists(EARLIER_SOURCE):
                raise SystemExit(f"no earlier source at {EARLIER_SOURCE}")
            path = _build.build_library(
                "route_earlier", [EARLIER_SOURCE],
                [_build.nvcc(), *_build.NVCC_FLAGS])
            lib = ctypes.CDLL(path)
            lib.ss_route_partition.argtypes = [
                _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_P),
                ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int64,
                _P, _P, _P]
            lib.ss_place_received.argtypes = [
                _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(_P), ctypes.POINTER(_P),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int, _P]
            for fn in (lib.ss_route_partition, lib.ss_place_received):
                fn.restype = ctypes.c_int
            lib.ss_route_scratch_bytes.argtypes = [ctypes.c_int64,
                                                   ctypes.c_int]
            lib.ss_route_scratch_bytes.restype = ctypes.c_int64
            lib.ss_route_error_string.argtypes = [ctypes.c_int]
            lib.ss_route_error_string.restype = ctypes.c_char_p
            _earlier = lib
        return _earlier


def earlier_windows(p: int, length: int, width: int = 4) -> int:
    """The earlier design's windows a destination: the most (a power of
    two) that keep p times them within its 256 buckets and a window at 16
    slots or more."""
    w = 1
    while (2 * w * p <= _EARLIER_BUCKETS
           and length // (2 * w) >= _EARLIER_MIN_WINDOW):
        w *= 2
    return w


def earlier_route(src, length: int, p: int, planes, fills, cap: int,
                  clamp: bool = False, windows: int = 1) -> tuple:
    """`route_partition` on the earlier design: at most 8 operands and 256
    buckets."""
    if p * windows > _EARLIER_BUCKETS or len(planes) > route.MAX_PLANES:
        raise ValueError("the earlier design takes at most 256 buckets and "
                         "8 operands")
    lib = earlier_library()
    n = src.shape[0]
    src = src.contiguous()
    planes = [t.contiguous() for t in planes]
    sends = [torch.empty((p, cap), dtype=t.dtype, device=src.device)
             for t in planes]
    over = torch.empty((), dtype=torch.int32, device=src.device)
    scratch = torch.empty(
        (lib.ss_route_scratch_bytes(n, p * windows) // 4,),
        dtype=torch.int32, device=src.device)
    ins, widths = route._arrays(planes)
    outs, _ = route._arrays(sends)
    route._call(lib, "ss_route_partition", src.device, src.data_ptr(),
                src.element_size(), n, length, p, windows, int(bool(clamp)),
                ins, outs, widths,
                (ctypes.c_int64 * len(fills))(*(int(f) for f in fills)),
                len(planes), cap, over.data_ptr(), scratch.data_ptr())
    return tuple(sends), over


def earlier_place(recv_g, recvs, length: int, windows: int = 1) -> tuple:
    """`place_received` on the earlier design (a scatter, whatever the
    windows): at most 8 operands."""
    lib = earlier_library()
    recv_g = recv_g.contiguous()
    recvs = [t.contiguous() for t in recvs]
    outs = [torch.empty((length,), dtype=t.dtype, device=recv_g.device)
            for t in recvs]
    ins, widths = route._arrays(recvs)
    dst, _ = route._arrays(outs)
    rows = recv_g.shape[0] if recv_g.dim() == 2 else 1
    route._call(lib, "ss_place_received", recv_g.device, recv_g.data_ptr(),
                recv_g.element_size(), rows, recv_g.numel() // max(rows, 1),
                length, ins, dst, widths, len(recvs))
    return tuple(outs)


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def _ms(fn, reps: int = 10) -> float:
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


def _same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _place_bytes(length: int, gidx_width: int, width: int) -> int:
    """The placement's bytes by windows: the L live entries of gidx and of
    the operand read, the output written."""
    return length * (gidx_width + 2 * width)


def sweep(log2n: int = 28, shards: int = 4) -> None:
    """The permutation route of shard 1 and the placement of what it
    receives, on every variant (see the module's docstring)."""
    from stringsearch_torch.harness.profile_build import _kernel_sums
    from stringsearch_torch.parallel import collectives as coll
    from stringsearch_torch.parallel.distsort import redistribute_cap

    p = shards
    length = (1 << log2n) // p
    cap = redistribute_cap(p, length)
    gen = torch.Generator(device="cuda").manual_seed(16)
    gidx = list(torch.randperm(p * length, generator=gen, device="cuda")
                .to(torch.int32).view(p, length))
    vals = [torch.randint(0, 1 << 30, (length,), generator=gen,
                          device="cuda", dtype=torch.int32)
            for _ in range(p)]
    route_bytes = 8 * length + 2 * p * cap * 4
    place_bytes = _place_bytes(length, 4, 4)
    libs = {}
    for name in VARIANTS:
        try:
            libs[name] = variant_library(name)
        except RuntimeError as e:
            print(f"variant {name!r} did not build: {e}", flush=True)

    def send(lib, me, w):
        return route.launch_route(lib, gidx[me], length, p,
                                  (gidx[me], vals[me]), (-1, 0), cap, False,
                                  w)[:2]

    for w in (1, 16, 64, 256):
        want = route.plain_route_partition(gidx[1], length, p,
                                           (gidx[1], vals[1]), (-1, 0), cap,
                                           False, w)
        for name, lib in libs.items():
            got = send(lib, 1, w)
            if not _same([*got[0], got[1]], [*want[0], want[1]]):
                raise RuntimeError(f"{name}: route_partition at {w} windows "
                                   f"differs from the plain version")
            ms = _ms(lambda: send(lib, 1, w))
            kernels = {k: round(t, 4) for k, (t, _) in
                       _kernel_sums(lambda: send(lib, 1, w)).items()
                       if k.startswith("route_")}
            print(f"route_partition, 2^{log2n} / {p} shards, shard 1, "
                  f"{p * w} buckets, {name}: {ms:.4f} ms, share "
                  f"{route_bytes / BYTES_PER_S * 1e3 / ms:.3f} ({kernels})",
                  flush=True)
        del want
    for w in (16, 64, 128, 256, 512, 1024):
        sends = [send(libs["as built"], me, w)[0] for me in range(p)]
        recv_g = coll.all_to_all([s[0] for s in sends])[1]
        recv = coll.all_to_all([s[1] for s in sends])[1]
        del sends
        want = route.plain_place_received(recv_g, (recv,), length)
        for name, lib in libs.items():
            def fn(lib=lib):
                return route.launch_place(lib, recv_g, (recv,), length,
                                          w)[0]
            if not _same(fn(), want):
                raise RuntimeError(f"{name}: place_received at {w} windows "
                                   f"differs from the plain version")
            ms = _ms(fn)
            print(f"place_received, 2^{log2n} / {p} shards, shard 1, {w} "
                  f"windows a destination, {name}: {ms:.4f} ms, share "
                  f"{place_bytes / BYTES_PER_S * 1e3 / ms:.3f}", flush=True)
        del recv_g, recv, want
        torch.cuda.empty_cache()


def _turns(now, earlier) -> tuple:
    """Times of `now` and `earlier` in turns: now, earlier, earlier, now."""
    a, b, c, d = _ms(now), _ms(earlier), _ms(earlier), _ms(now)
    return (a, d), (b, c)


def earlier_main(card: str) -> None:
    """The kernels against the earlier design (see the module's
    docstring)."""
    from stringsearch_torch.parallel import collectives as coll
    from stringsearch_torch.parallel.distsort import redistribute_cap

    earlier_library()
    gen = torch.Generator(device="cuda").manual_seed(15)
    for p, log2l, idx in ((4, 26, torch.int32), (4, 26, torch.int64),
                          (8, 26, torch.int32)):
        length = 1 << log2l
        cap = redistribute_cap(p, length)
        gw = torch.empty((), dtype=idx).element_size()
        gidx = list(torch.randperm(p * length, generator=gen, device="cuda")
                    .to(idx).view(p, length))
        # the rank beside gidx, of gidx's type as in an idx64 build
        vals = [torch.randint(0, 1 << 30, (length,), generator=gen,
                              device="cuda", dtype=idx)
                for _ in range(p)]
        shape = (f"{p} shards of 2^{log2l}, gidx and one operand "
                 f"{str(idx).split('.')[-1]}")
        designs = {"now": (route.route_partition, route.place_received,
                           route.receiver_windows(p, length, gw)),
                   "earlier": (earlier_route, earlier_place,
                               earlier_windows(p, length))}
        recvd, sends_fn = {}, {}
        for name, (send_fn, _place, w) in designs.items():
            def send(me, send_fn=send_fn, w=w):
                return send_fn(gidx[me], length, p, (gidx[me], vals[me]),
                               (-1, 0), cap, False, w)
            want = route.plain_route_partition(
                gidx[1], length, p, (gidx[1], vals[1]), (-1, 0), cap, False,
                w)
            got = send(1)
            if not _same([*got[0], got[1]], [*want[0], want[1]]):
                raise RuntimeError(f"{name}: route_partition on {shape} "
                                   f"differs from the plain version")
            del got, want
            sends = [send(me)[0] for me in range(p)]
            recvd[name] = (coll.all_to_all([s[0] for s in sends])[1],
                           coll.all_to_all([s[1] for s in sends])[1])
            sends_fn[name] = send
            del sends
            g1, v1 = recvd[name]
            if not _same(designs[name][1](g1, (v1,), length, w),
                         route.plain_place_received(g1, (v1,), length)):
                raise RuntimeError(f"{name}: place_received on {shape} "
                                   f"differs from the plain version")
        route_bytes = 2 * (length + p * cap) * gw
        place_bytes = _place_bytes(length, gw, gw)
        now_ms, old_ms = _turns(lambda: sends_fn["now"](1),
                                lambda: sends_fn["earlier"](1))
        print(f"route_partition, {shape}: now at "
              f"{designs['now'][2]} windows {now_ms[0]:.4f} / "
              f"{now_ms[1]:.4f} ms, earlier at {designs['earlier'][2]} "
              f"windows {old_ms[0]:.4f} / {old_ms[1]:.4f} ms; bound "
              f"{route_bytes / BYTES_PER_S * 1e3:.4f} ms [{card}]",
              flush=True)
        places = {name: (lambda name=name: designs[name][1](
            recvd[name][0], (recvd[name][1],), length, designs[name][2]))
            for name in designs}
        now_p, old_p = _turns(places["now"], places["earlier"])
        print(f"place_received, {shape}, what shard 1 receives: now "
              f"{now_p[0]:.4f} / {now_p[1]:.4f} ms, earlier {old_p[0]:.4f} "
              f"/ {old_p[1]:.4f} ms; bound "
              f"{place_bytes / BYTES_PER_S * 1e3:.4f} ms by windows; route "
              f"and placement now {statistics.mean(now_ms) + statistics.mean(now_p):.4f}"
              f", earlier {statistics.mean(old_ms) + statistics.mean(old_p):.4f} "
              f"ms [{card}]", flush=True)
        del gidx, vals, recvd, sends_fn, places, designs
        torch.cuda.empty_cache()
    # a round's rank_interval_sort route: four operands, clamped
    p, length = 4, 1 << 26
    cap = redistribute_cap(p, length)
    for idx in (torch.int32, torch.int64):
        ops = [torch.randint(0, p * length, (length,), generator=gen,
                             device="cuda", dtype=idx) for _ in range(4)]
        fills = (torch.iinfo(idx).max, 0, 0, 0)
        runs = {name: (lambda fn=fn: fn(ops[0], length, p, ops, fills, cap,
                                        True))
                for name, fn in (("now", route.route_partition),
                                 ("earlier", earlier_route))}
        want = route.plain_route_partition(ops[0], length, p, ops, fills,
                                           cap, True)
        for name, fn in runs.items():
            got = fn()
            if not _same([*got[0], got[1]], [*want[0], want[1]]):
                raise RuntimeError(f"{name}: the round's route differs from "
                                   f"the plain version")
        del got, want
        now_ms, old_ms = _turns(runs["now"], runs["earlier"])
        size = ops[0].element_size()
        print(f"route_partition, a round's rank_interval_sort, {p} shards "
              f"of 2^26, 4 {str(idx).split('.')[-1]} operands: now "
              f"{now_ms[0]:.4f} / {now_ms[1]:.4f} ms, earlier "
              f"{old_ms[0]:.4f} / {old_ms[1]:.4f} ms; bound "
              f"{(length + p * cap) * 4 * size / BYTES_PER_S * 1e3:.4f} ms "
              f"[{card}]", flush=True)
        del ops, runs
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    family = (argv or ["sweep"])[0]
    if family == "earlier":
        earlier_main(card)
    else:
        sweep()


if __name__ == "__main__":
    main(sys.argv[1:])
