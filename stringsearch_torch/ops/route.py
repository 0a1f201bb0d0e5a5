"""The global build's all_to_all routing and placement, as Hopper kernels.

The exact global build moves elements between shards with one
`all_to_all` at a static per-pair capacity (`parallel/distsort.py`:
`redistribute_permutation` and `rank_interval_sort`). Each sender lays its
elements out in a [P, cap] send buffer per operand, row d bound for shard
d; each receiver of `redistribute_permutation` puts what arrived at slot
`gidx % L`. The JAX package (stringsearch_tpu/parallel/distsort.py:151-178
and :240-255) writes the send side as a `lax.sort` by destination,
`arange - searchsorted` for the rank inside a destination and one scatter
an operand, and the receive side as a scatter; XLA fuses them in its
jitted programs. None of it replaces a Pallas kernel.

  * `route_partition`: the send buffers of one shard, by a stable
    counting partition by destination (and by window of the destination's
    slots, where the receiver places) in `csrc/route.cu`, with the
    overflow flag and the fill of the empty slots;
  * `place_received`: the receive side, one window of the receiver's
    slots a thread block cluster, assembled in shared memory and written
    once.

Neither function has a limit of its own on the card. One library call
takes at most MAX_BUCKETS buckets (destinations times windows) and
MAX_PLANES operands; the wrappers make their calls as `launch_plan` says:
a range of buckets at a time and, in each, a group of operands at a time,
the range's first call running its count and scan for the later ones.

Each runs inside a span of its name (`ops.route_partition`,
`ops.place_received`; `harness/tracing.py`) whose attributes `reads` and
`writes` give (elements, bytes an element) of each plane it takes and
gives: for `route_partition` the operands (and `src` where it is not the
first) and the [p, cap] buffers, for `place_received` the received
buffers and the [length] outputs.

CPU tensors go to the plain versions, which are the chain of PyTorch ops
the distributed sort ran before (`plain_route_partition` sorts by
destination with `device_sort`, which is stable); CUDA tensors to the
kernels, which raise on a type, shape or launch error. There is no other
route and no fallback. Only the kernels' checks (`chip_smoke.py` phase
17, the `cuda` tests) put the plain versions on the card.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from stringsearch_torch.harness.tracing import planes as span_planes
from stringsearch_torch.harness.tracing import spanned
from stringsearch_torch.ops import _build

_SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "route.cu")
_I32 = torch.int32
_IDX = (torch.int32, torch.int64)
# kMaxBuckets and kMaxPlanes of csrc/route.cu: the buckets (destinations
# times windows) of one library call, and the operands of one launch
MAX_BUCKETS = 1024
MAX_PLANES = 8
# kTile and kScatterTile of csrc/route.cu: the elements a block of the
# partition takes, and the columns a block of the scatter placement takes
# (the tests' edge sizes)
ROUTE_TILE = 8192
PLACE_TILE = 1024
# kCluster * kPlaceBytes of csrc/route.cu: the shared memory of one thread
# block cluster of the window placement, which holds a window
PLACE_CLUSTER_BYTES = 8 * 128 * 1024

# Kernel launches in this process, by function.
launches = {"route_partition": 0, "place_received": 0}

_lock = threading.Lock()
_lib = None
_P = ctypes.c_void_p


def _load(path: str) -> ctypes.CDLL:
    """Load the built library at `path` and declare its C interface."""
    lib = ctypes.CDLL(path)
    lib.ss_route_partition.argtypes = [
        _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(_P), ctypes.POINTER(_P),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int64, _P, _P, _P]
    lib.ss_place_received.argtypes = [
        _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(_P), ctypes.POINTER(_P),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, _P, _P]
    for fn in (lib.ss_route_partition, lib.ss_place_received):
        fn.restype = ctypes.c_int
    lib.ss_route_scratch_bytes.argtypes = [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int]
    lib.ss_place_scratch_bytes.argtypes = [ctypes.c_int64, ctypes.c_int]
    for fn in (lib.ss_route_scratch_bytes, lib.ss_place_scratch_bytes):
        fn.restype = ctypes.c_int64
    lib.ss_route_error_string.argtypes = [ctypes.c_int]
    lib.ss_route_error_string.restype = ctypes.c_char_p
    lib.ss_place_window_slots.argtypes = [ctypes.c_int]
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library; checks that
    its limits are the ones this module splits by."""
    global _lib
    with _lock:
        if _lib is None:
            path = _build.build_library(
                "route", [_SOURCE], [_build.nvcc(), *_build.NVCC_FLAGS])
            lib = _load(path)
            got = (lib.ss_route_max_buckets(), lib.ss_route_max_planes(),
                   lib.ss_route_tile(), 4 * lib.ss_place_window_slots(4))
            want = (MAX_BUCKETS, MAX_PLANES, ROUTE_TILE,
                    PLACE_CLUSTER_BYTES)
            if got != want:
                raise RuntimeError(f"{path}: limits {got}, the wrapper "
                                   f"expects {want}")
            _lib = lib
        return _lib


def _call(lib, fn: str, device, *args) -> None:
    """Call `fn` of `lib` on the current stream of `device`. Raises if a
    launch failed."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{lib.ss_route_error_string(rc).decode()} "
                           f"(code {rc})")


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what} must lie on the CPU or a CUDA device, got "
                     f"{t.device}")


def _arrays(planes) -> tuple:
    """ctypes arrays of the planes' pointers and widths."""
    c = len(planes)
    return ((_P * c)(*(t.data_ptr() for t in planes)),
            (ctypes.c_int * c)(*(t.element_size() for t in planes)))


def seg_rank(dest_s: torch.Tensor) -> torch.Tensor:
    """Rank of each element inside its run of equal sorted destinations."""
    i = torch.arange(dest_s.shape[0], device=dest_s.device)
    return i - torch.searchsorted(dest_s, dest_s, side="left")


def launch_plan(p: int, windows: int, planes: int) -> list:
    """The library calls the wrappers make on the card: a range of at most
    MAX_BUCKETS consecutive buckets of the p * windows at a time, and in
    each range one call a group of at most MAX_PLANES operands, the first
    running the range's count and scan (`place_received`: p = windows = 1,
    the first call finding the rows' runs). Returns [(bucket0, buckets,
    [(first operand, operands), ...]), ...]; one call a pair of a range
    and a group."""
    groups = [(c, min(MAX_PLANES, planes - c))
              for c in range(0, planes, MAX_PLANES)]
    total = p * windows
    return [(b, min(MAX_BUCKETS, total - b), groups)
            for b in range(0, total, MAX_BUCKETS)]


# ---------------------------------------------------------------------------
# route_partition
# ---------------------------------------------------------------------------


def receiver_windows(p: int, length: int, width: int = 4) -> int:
    """The windows a destination of `route_partition` for a receiver that
    places into [length] slots of `width`-byte elements: the fewest (a power
    of two) whose window fits one cluster of the window placement
    (PLACE_CLUSTER_BYTES), but no more than keep p times them within
    MAX_BUCKETS, one range of library calls. Past that the window is wider
    than a cluster and the placement scatters."""
    slots = PLACE_CLUSTER_BYTES // width
    w = 1
    while -(-length // w) > slots and 2 * w * p <= MAX_BUCKETS:
        w *= 2
    return w


def _check_route(src, length: int, p: int, planes, fills, cap: int,
                 windows: int) -> tuple:
    planes, fills = tuple(planes), tuple(fills)
    if src.dtype not in _IDX or src.dim() != 1:
        raise TypeError(f"src must be a 1-D int32 or int64 tensor, got "
                        f"{src.dtype} of {src.dim()} dims")
    if not planes or len(planes) != len(fills):
        raise ValueError(f"route_partition needs operands and one fill "
                         f"each, got {len(planes)} and {len(fills)}")
    for t in planes:
        if t.dtype not in _IDX or t.dim() != 1:
            raise TypeError(f"the operands must be 1-D int32 or int64, got "
                            f"{t.dtype} of {t.dim()} dims")
        if t.shape != src.shape or t.device != src.device:
            raise ValueError("the operands must share src's length and "
                             "device")
    if length < 1 or p < 1 or cap < 1 or windows < 1:
        raise ValueError(f"length, p, cap and windows must be positive, "
                         f"got {length}, {p}, {cap}, {windows}")
    return planes, fills


def bucket_of(src, length: int, p: int, clamp: bool, windows: int):
    """Each element's bucket, dest * windows + window (int64), or -1 where
    its destination lies outside [0, p) without `clamp`."""
    dest = torch.div(src, length, rounding_mode="floor")
    if clamp:
        dest = dest.clamp(0, p - 1)
    key = dest * windows
    if windows > 1:
        sub = -(-length // windows)
        key = key + torch.div(src - dest * length, sub,
                              rounding_mode="floor").clamp(0, windows - 1)
    return torch.where((dest >= 0) & (dest < p), key, -1).to(torch.int64)


def plain_route_partition(src, length: int, p: int, planes, fills,
                          cap: int, clamp: bool = False, windows: int = 1,
                          sort=None, num_keys: int = 1) -> tuple:
    """`route_partition` as the chain of PyTorch ops the distributed sort
    ran before, on src's device: a stable `sort` of (bucket, operands...)
    by its first `num_keys` planes (`device_sort` by default), the rank
    inside each destination (`arange - searchsorted`), the overflow test
    and one scatter an operand into a buffer of fills, with a drop slot for
    what cannot be placed. `num_keys` 2 with src as the first operand
    orders each destination by src, as `redistribute_permutation` once
    did."""
    planes, fills = _check_route(src, length, p, planes, fills, cap,
                                 windows)
    if sort is None:
        from stringsearch_torch.ops.bitonic import device_sort as sort
    key = bucket_of(src, length, p, clamp, windows)
    srt = sort((key.to(_I32), *planes), num_keys)
    dest_s = torch.div(srt[0], windows, rounding_mode="floor")
    rank = seg_rank(dest_s)
    ok = (rank < cap) & (srt[0] >= 0)
    over = (~ok).any().to(_I32)
    at = torch.where(ok, dest_s.to(torch.int64) * cap + rank, p * cap)
    del dest_s, rank, ok
    sends = []
    for plane, fill in zip(srt[1:], fills):
        buf = torch.full((p * cap + 1,), fill, dtype=plane.dtype,
                         device=plane.device)
        buf[at] = plane
        sends.append(buf[:p * cap].view(p, cap))
    return tuple(sends), over


def _route_attrs(out, src, length, p, planes, *args, **kwargs) -> dict:
    inputs = tuple(planes) if planes and planes[0] is src else (
        src, *planes)
    return {"reads": span_planes(inputs), "writes": span_planes(out[0])}


@spanned("ops.route_partition", _route_attrs)
def route_partition(src, length: int, p: int, planes, fills, cap: int,
                    clamp: bool = False, windows: int = 1) -> tuple:
    """The [p, cap] all_to_all send buffers of one shard's operands.

    Element e goes to destination d = src[e] // length (floor), clamped to
    [0, p) where `clamp`. Row d of every operand's buffer holds
    destination d's elements by window w = (src[e] - d * length) //
    ceil(length / windows) (clamped to [0, windows)), and in source order
    inside one: a stable partition by (d, w). With one window it is a
    stable partition by destination, equal to a stable sort by d followed
    by the rank inside each destination, as the JAX package routes; more
    windows let the receiver's `place_received` take one window of its
    slots at a time. Slots past a row's count hold the operand's fill.
    `planes` are [n] int32 or int64 tensors on src's device (src itself
    may be one), any number of them, `fills` one value each; p and windows
    are any positive counts (the card takes them in the calls and
    launches of `launch_plan`). Returns (buffers, over): the buffers, each
    [p, cap] of its operand's dtype, and over, a 0-d int32 tensor on src's
    device, 1 where a row holds more than cap (what lies past cap is
    dropped) or, without `clamp`, an element's destination lies outside
    [0, p), else 0. Reading it is the caller's only host sync.
    """
    planes, fills = _check_route(src, length, p, planes, fills, cap,
                                 windows)
    if not _on_cuda(src, "src"):
        return plain_route_partition(src, length, p, planes, fills, cap,
                                     clamp, windows)
    sends, over, calls = launch_route(load_library(), src, length, p,
                                      planes, fills, cap, clamp, windows)
    launches["route_partition"] += calls
    return sends, over


def launch_route(lib, src, length: int, p: int, planes, fills, cap: int,
                 clamp: bool, windows: int) -> tuple:
    """`route_partition` on the card through `lib` (this module's library
    or another build of `csrc/route.cu`'s interface): the library calls of
    `launch_plan`, on one scratch. Returns (buffers, over, library
    calls)."""
    n = src.shape[0]
    if n >= 1 << 31 or p * windows >= 1 << 31:
        raise ValueError("route_partition takes n < 2^31 and fewer than "
                         "2^31 buckets on CUDA")
    src = src.contiguous()
    planes = [t.contiguous() for t in planes]
    device = src.device
    sends = [torch.empty((p, cap), dtype=t.dtype, device=device)
             for t in planes]
    over = torch.empty((), dtype=_I32, device=device)
    plan = launch_plan(p, windows, len(planes))
    # the first call zeroes the flag and the row counts in the scratch
    scratch = torch.empty(
        (lib.ss_route_scratch_bytes(n, plan[0][1], p) // 4,), dtype=_I32,
        device=device)
    calls = 0
    for bucket0, buckets, groups in plan:
        for c0, count in groups:
            ins, widths = _arrays(planes[c0:c0 + count])
            outs, _ = _arrays(sends[c0:c0 + count])
            values = (ctypes.c_int64 * count)(
                *(int(f) for f in fills[c0:c0 + count]))
            _call(lib, "ss_route_partition", device, src.data_ptr(),
                  src.element_size(), n, length, p, windows,
                  int(bool(clamp)), bucket0, buckets, int(c0 == 0), ins,
                  outs, widths, values, count, cap, over.data_ptr(),
                  scratch.data_ptr())
            calls += 1
    return tuple(sends), over, calls


# ---------------------------------------------------------------------------
# place_received
# ---------------------------------------------------------------------------


def _check_place(recv_g, recvs, length: int, windows: int) -> tuple:
    recvs = tuple(recvs)
    if recv_g.dtype not in _IDX:
        raise TypeError(f"recv_g must be int32 or int64, got {recv_g.dtype}")
    if not recvs:
        raise ValueError("place_received needs at least one operand")
    for t in recvs:
        if t.dtype not in _IDX:
            raise TypeError(f"the received operands must be int32 or int64, "
                            f"got {t.dtype}")
        if t.shape != recv_g.shape or t.device != recv_g.device:
            raise ValueError("the received operands must share recv_g's "
                             "shape and device")
    if length < 1 or windows < 1:
        raise ValueError(f"length and windows must be positive, got "
                         f"{length} and {windows}")
    return recvs


def plain_place_received(recv_g, recvs, length: int,
                         windows: int = 1) -> tuple:
    """`place_received` as the chain of PyTorch ops the redistribute ran
    before, on recv_g's device: the offsets `recv_g % length` with a drop
    slot `length` for the empty entries, and one scatter an operand into
    an [length + 1] buffer of zeros. The rows' order does not matter to
    it, so it reads nothing of `windows`."""
    recvs = _check_place(recv_g, recvs, length, windows)
    off = torch.where(recv_g >= 0, recv_g % length, length).reshape(-1)
    outs = []
    for recv in recvs:
        out = recv.new_zeros((length + 1,))
        out[off] = recv.reshape(-1)
        outs.append(out[:length])
    return tuple(outs)


@spanned("ops.place_received", lambda outs, recv_g, recvs, *a, **k: {
    "reads": span_planes((recv_g, *recvs)), "writes": span_planes(outs)})
def place_received(recv_g, recvs, length: int, windows: int = 1) -> tuple:
    """The receive side of the permutation route: out[recv_g % length] =
    recv for every entry whose recv_g is >= 0, for each received operand
    (each of recv_g's shape, int32 or int64, any number of them). Returns
    one [length] tensor an operand, zero where no entry lands. The
    entries' targets are expected to be distinct (the received share of a
    permutation). A [rows, cols] recv_g holds the all_to_all's rows, one a
    sender. With `windows` > 1 each row must be what `route_partition`
    sent with that many windows: ordered by window of recv_g % length
    (ceil(length / windows) slots each), -1 only past the row's count; the
    kernel then places one window of slots a thread block cluster, from
    the run of that window in each row. With one window the rows may be
    in any order."""
    recvs = _check_place(recv_g, recvs, length, windows)
    if not _on_cuda(recv_g, "recv_g"):
        return plain_place_received(recv_g, recvs, length, windows)
    outs, calls = launch_place(load_library(), recv_g, recvs, length,
                               windows)
    launches["place_received"] += calls
    return outs


def launch_place(lib, recv_g, recvs, length: int, windows: int) -> tuple:
    """`place_received` on the card through `lib` (this module's library
    or another build of `csrc/route.cu`'s interface): one library call a
    group of operands of `launch_plan`. Returns (outputs, library
    calls)."""
    recv_g = recv_g.contiguous()
    recvs = [t.contiguous() for t in recvs]
    device = recv_g.device
    outs = [torch.empty((length,), dtype=t.dtype, device=device)
            for t in recvs]
    # a [rows, cols] buffer: each row is one sender's
    rows = recv_g.shape[0] if recv_g.dim() == 2 else 1
    scratch = torch.empty(
        (max(lib.ss_place_scratch_bytes(rows, windows), 8) // 8,),
        dtype=torch.int64, device=device)
    (_bucket0, _buckets, groups), = launch_plan(1, 1, len(recvs))
    for c0, count in groups:
        ins, widths = _arrays(recvs[c0:c0 + count])
        dst, _ = _arrays(outs[c0:c0 + count])
        _call(lib, "ss_place_received", device, recv_g.data_ptr(),
              recv_g.element_size(), rows, recv_g.numel() // max(rows, 1),
              length, windows, int(c0 == 0), ins, dst, widths, count,
              scratch.data_ptr())
    return tuple(outs), len(groups)
