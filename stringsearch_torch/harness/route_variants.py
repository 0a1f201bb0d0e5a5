"""What each design choice of the routing and placement kernels buys, on
one GPU.

    python -m stringsearch_torch.harness.route_variants

One shard's permutation route of the global build at 2^26 elements a
shard of four (gidx and one int32 operand, as the initial redistribute
sends them), on copies of `ops/csrc/route.cu` with one choice changed
(VARIANTS: the partition's tile and block, the placement's block,
cluster, share of a window and unrolling, each a text replacement that
must match its source exactly once). For each, `route_partition` at 4,
64, 256 and 1024 buckets (1, 16, 64 and 256 windows a destination), held
against the plain version first, its kernels by name from
`torch.profiler`, then the placement of what shard 1 receives at 16 to
1024 windows a destination, held against the plain scatter, and, as
built, the route and the placement together at each of those windows and
at `receiver_windows`. The copies are written to and built in
`stringsearch_torch/_build/variants/` (`Library.variant`). To time the
kernels against an earlier design of them, run the benchmark on a
`git archive` of the earlier commit beside this one.

Each time is the mean of CUDA events over ten calls after a warm one,
beside the function's bytes bound at 3.35 TB/s: the route reads each
operand once and writes each send buffer once; the placement by windows
reads the L live entries of gidx and of the operand and writes the
output once. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess

import torch

from stringsearch_torch import harness
from stringsearch_torch.harness import BYTES_PER_S
from stringsearch_torch.ops import route

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
    return harness.variant_source("route " + name, route._SOURCE,
                                  VARIANTS[name])


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
            libs[name] = route.LIBRARY.variant(variant_source(name))
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
    for w in sorted({16, 64, 128, 256, 512, 1024,
                     route.receiver_windows(p, length)}):
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
        # both sides of the route, through the program's own wrappers
        r_ms = _ms(lambda: route.route_partition(
            gidx[1], length, p, (gidx[1], vals[1]), (-1, 0), cap, False, w))
        p_ms = _ms(lambda: route.place_received(recv_g, (recv,), length, w))
        print(f"route_partition and place_received, 2^{log2n} / {p} "
              f"shards, shard 1, {w} windows a destination, as built: "
              f"{r_ms:.4f} + {p_ms:.4f} = {r_ms + p_ms:.4f} ms", flush=True)
        del recv_g, recv, want
        torch.cuda.empty_cache()


def main() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sweep()


if __name__ == "__main__":
    main()
