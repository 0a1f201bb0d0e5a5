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
    slots, where the receiver scatters) in `csrc/route.cu`, with the
    overflow flag and the fill of the empty slots;
  * `place_received`: the receive side's scatter in one pass.

CPU tensors go to the plain versions, which are the chain of PyTorch ops
the distributed sort ran before (`plain_route_partition` sorts by
destination with `device_sort`, which is stable); CUDA tensors to the
kernels, which raise on a type, shape or launch error. There is no other
route and no fallback. `harness/profile_build.py route` puts the plain
versions on the card, in turns with the kernels; nothing else runs them
there.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from stringsearch_torch.ops import _build

_SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "route.cu")
_I32 = torch.int32
_IDX = (torch.int32, torch.int64)
# kMaxBuckets and kMaxPlanes of csrc/route.cu: destinations times windows,
# and operands, of one call
MAX_BUCKETS = 256
MAX_PLANES = 8
# kTile and kPlaceTile of csrc/route.cu: the elements a block of each
# kernel takes (the tests' edge sizes)
ROUTE_TILE = 4096
PLACE_TILE = 1024
# the fewest slots of a receiver's output that `receiver_windows` gives a
# window
MIN_WINDOW = 16

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
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(_P), ctypes.POINTER(_P),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int64, _P, _P, _P]
    lib.ss_place_received.argtypes = [
        _P, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(_P), ctypes.POINTER(_P),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, _P]
    for fn in (lib.ss_route_partition, lib.ss_place_received):
        fn.restype = ctypes.c_int
    lib.ss_route_scratch_bytes.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.ss_route_scratch_bytes.restype = ctypes.c_int64
    lib.ss_route_error_string.argtypes = [ctypes.c_int]
    lib.ss_route_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(_build.build_library(
                "route", [_SOURCE], [_build.nvcc(), *_build.NVCC_FLAGS]))
        return _lib


def _launch(kernel: str, fn: str, device, *args) -> None:
    """Call `fn` of the library on the current stream of `device` and count
    the launch under `kernel`. Raises if the launch failed."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{lib.ss_route_error_string(rc).decode()} "
                           f"(code {rc})")
    launches[kernel] += 1


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


# ---------------------------------------------------------------------------
# route_partition
# ---------------------------------------------------------------------------


def receiver_windows(p: int, length: int) -> int:
    """The windows a destination of `route_partition` for a receiver that
    scatters into [length] slots: the largest power of two that keeps p
    times it within MAX_BUCKETS and a window at MIN_WINDOW slots or more."""
    w = 1
    while 2 * w * p <= MAX_BUCKETS and length // (2 * w) >= MIN_WINDOW:
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
    windows give a receiver that scatters to src % length runs of nearby
    slots. Slots past a row's count hold the operand's fill. `planes` are
    [n] int32 or int64 tensors on src's device (src itself may be one),
    `fills` one value each. Returns (buffers, over): the buffers, each
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
    if p * windows > MAX_BUCKETS or len(planes) > MAX_PLANES:
        raise ValueError(f"route_partition takes at most {MAX_BUCKETS} "
                         f"destinations times windows and {MAX_PLANES} "
                         f"operands on CUDA, got {p * windows} and "
                         f"{len(planes)}")
    n = src.shape[0]
    if n >= 1 << 31:
        raise ValueError("route_partition takes n < 2^31 on CUDA")
    src = src.contiguous()
    planes = [t.contiguous() for t in planes]
    device = src.device
    sends = [torch.empty((p, cap), dtype=t.dtype, device=device)
             for t in planes]
    over = torch.empty((), dtype=_I32, device=device)
    lib = load_library()
    # the launch zeroes the flag itself
    scratch = torch.empty(
        (lib.ss_route_scratch_bytes(n, p * windows) // 4,), dtype=_I32,
        device=device)
    ins, widths = _arrays(planes)
    outs, _ = _arrays(sends)
    _launch("route_partition", "ss_route_partition", device, src.data_ptr(),
            src.element_size(), n, length, p, windows, int(bool(clamp)), ins,
            outs, widths,
            (ctypes.c_int64 * len(fills))(*(int(f) for f in fills)),
            len(planes), cap, over.data_ptr(), scratch.data_ptr())
    return tuple(sends), over


# ---------------------------------------------------------------------------
# place_received
# ---------------------------------------------------------------------------


def _check_place(recv_g, recvs, length: int) -> tuple:
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
    if length < 1:
        raise ValueError(f"length must be positive, got {length}")
    return recvs


def plain_place_received(recv_g, recvs, length: int) -> tuple:
    """`place_received` as the chain of PyTorch ops the redistribute ran
    before, on recv_g's device: the offsets `recv_g % length` with a drop
    slot `length` for the empty entries, and one scatter an operand into
    an [length + 1] buffer of zeros."""
    recvs = _check_place(recv_g, recvs, length)
    off = torch.where(recv_g >= 0, recv_g % length, length).reshape(-1)
    outs = []
    for recv in recvs:
        out = recv.new_zeros((length + 1,))
        out[off] = recv.reshape(-1)
        outs.append(out[:length])
    return tuple(outs)


def place_received(recv_g, recvs, length: int) -> tuple:
    """The receive side of the permutation route: out[recv_g % length] =
    recv for every entry whose recv_g is >= 0, for each received operand
    (each of recv_g's shape, int32 or int64). Returns one [length] tensor
    an operand, zero where no entry lands. The entries' targets are
    expected to be distinct (the received share of a permutation). A
    [rows, cols] recv_g (the all_to_all's rows, one a sender) is read a
    column range of every row at a time: rows that `route_partition`
    ordered by window write nearby slots together."""
    recvs = _check_place(recv_g, recvs, length)
    if not _on_cuda(recv_g, "recv_g"):
        return plain_place_received(recv_g, recvs, length)
    if len(recvs) > MAX_PLANES:
        raise ValueError(f"place_received takes at most {MAX_PLANES} "
                         f"operands on CUDA, got {len(recvs)}")
    recv_g = recv_g.contiguous()
    recvs = [t.contiguous() for t in recvs]
    outs = [torch.empty((length,), dtype=t.dtype, device=recv_g.device)
            for t in recvs]
    ins, widths = _arrays(recvs)
    dst, _ = _arrays(outs)
    # a [rows, cols] buffer: a block takes the same columns of every row
    rows = recv_g.shape[0] if recv_g.dim() == 2 else 1
    _launch("place_received", "ss_place_received", recv_g.device,
            recv_g.data_ptr(), recv_g.element_size(), rows,
            recv_g.numel() // max(rows, 1), length, ins, dst, widths,
            len(recvs))
    return tuple(outs)
