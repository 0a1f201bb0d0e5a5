"""The sort behind `device_sort` on CUDA: a stable LSD radix sort.

`radix_sort` launches the hand-written Hopper kernels of
`csrc/radix_sort.cu`: 8-bit digits from the last key plane to the first and
from the lowest byte to the highest, each pass a per-tile histogram, a
bin-major scan and a ranked scatter. It takes the place of the Pallas
bitonic network of stringsearch_tpu/ops/bitonic.py (`_local_sort_kernel`,
`_make_cross`) behind the port's `device_sort`, computes what
`jax.lax.sort(operands, num_keys=...)` computes, and is stable, so it equals
`ops.bitonic.plain_sort` element for element on every plane.

`plain_radix_sort` is the kernel's plain PyTorch version: the same passes
with the same arithmetic, step by step, at a tile size of the caller's
choice. The CPU tests use it; nothing on the main path calls it.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from stringsearch_torch.ops import _build

_SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "radix_sort.cu")
_MAX_PLANES = 6
_BINS = 256
_I32 = torch.int32

# Number of sorts `radix_sort` has launched in this process.
launches = 0

_lock = threading.Lock()
_lib = None


def build(name: str, source: str) -> ctypes.CDLL:
    """Build the kernel library `name` from `source` and load it."""
    path = _build.build_library(
        name, [source], [_build.nvcc(), *_build.NVCC_FLAGS])
    lib = ctypes.CDLL(path)
    pointers = ctypes.POINTER(ctypes.c_void_p)
    lib.ss_radix_sort_i32.argtypes = [
        pointers, pointers, pointers, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.ss_radix_sort_i32.restype = ctypes.c_int
    lib.ss_radix_sort_scratch_ints.argtypes = [ctypes.c_int64]
    lib.ss_radix_sort_scratch_ints.restype = ctypes.c_int64
    lib.ss_radix_sort_error_string.argtypes = [ctypes.c_int]
    lib.ss_radix_sort_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = build("radix_sort", _SOURCE)
        return _lib


def launch_sort(lib: ctypes.CDLL, planes: tuple, num_keys: int) -> tuple:
    """Launch `lib`'s sort of contiguous int32 CUDA planes of one length
    n >= 2 on the current stream. The planes are only read; returns the
    sorted planes, new tensors. Raises if a launch failed."""
    c = len(planes)
    n = planes[0].shape[0]
    device = planes[0].device
    set_a = tuple(torch.empty_like(p) for p in planes)
    set_b = tuple(torch.empty_like(p) for p in planes)
    scratch = torch.empty((lib.ss_radix_sort_scratch_ints(n),), dtype=_I32,
                          device=device)

    def pointers(tensors):
        return (ctypes.c_void_p * c)(*(t.data_ptr() for t in tensors))

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ss_radix_sort_i32(pointers(planes), pointers(set_a),
                                   pointers(set_b), scratch.data_ptr(), c, n,
                                   num_keys, stream)
    if rc != 0:
        raise RuntimeError(
            f"radix sort kernel launch failed: "
            f"{lib.ss_radix_sort_error_string(rc).decode()} (code {rc})")
    return set_b


def _check_operands(operands: tuple, num_keys: int) -> None:
    c = len(operands)
    if not 1 <= c <= _MAX_PLANES:
        raise ValueError(f"the radix sort takes 1..{_MAX_PLANES} planes, "
                         f"got {c}")
    if not 1 <= num_keys <= c:
        raise ValueError(f"num_keys must be in 1..{c}, got {num_keys}")
    first = operands[0]
    for op in operands:
        if op.device != first.device:
            raise ValueError("the planes must lie on one device")
        if op.dtype != _I32:
            raise TypeError(f"the radix sort takes int32 planes, got "
                            f"{op.dtype}")
        if op.dim() != 1 or op.shape[0] != first.shape[0]:
            raise ValueError("the planes must be 1-D of one length")
    if first.shape[0] >= 1 << 31:
        raise ValueError("the radix sort takes fewer than 2^31 elements")


def radix_sort(operands, num_keys: int = 1) -> tuple:
    """Sort 1-D int32 CUDA planes by their first `num_keys`, ascending as
    signed int32 and stably, with the Hopper kernel.

    Returns new tensors; the inputs are only read (a plane that is not
    contiguous is copied first). Takes any n >= 0. Beside the c outputs the
    sort holds c planes and 256 * (ceil(n / tile) + 1) int32 of scratch
    while it runs.
    """
    global launches
    operands = tuple(operands)
    _check_operands(operands, num_keys)
    if operands[0].device.type != "cuda":
        raise ValueError("radix_sort planes must share one CUDA device")
    if operands[0].shape[0] < 2:
        return tuple(op.clone() for op in operands)
    planes = tuple(op.contiguous() for op in operands)
    out = launch_sort(load_library(), planes, num_keys)
    launches += 1
    return out


def _digits(key: torch.Tensor, shift: int) -> torch.Tensor:
    """Byte shift/8 of the keys' bits, the highest byte with bit 7 flipped:
    unsigned digit order is then signed int32 order. The mask drops the sign
    bits an arithmetic shift brings in."""
    return ((key >> shift) & 0xFF) ^ (0x80 if shift == 24 else 0)


def plain_radix_sort(operands, num_keys: int = 1, tile: int = 16384) -> tuple:
    """`radix_sort` in plain PyTorch, on the operands' device: the kernel's
    passes with the kernel's arithmetic at tile size `tile`.

    Passes run from the last key plane to the first and from the lowest
    byte to the highest, between two alternating buffer sets (the operands
    are only read). A pass takes each key's digit, counts the digits of
    every tile into a bin-major [256, tiles] table, scans the table
    exclusively in (bin, tile) order, ranks each key among the keys of its
    digit in its tile by position, and scatters every plane to
    offset[digit, tile] + rank.
    """
    operands = tuple(operands)
    _check_operands(operands, num_keys)
    if tile < 1:
        raise ValueError(f"tile={tile} must be >= 1")
    n = operands[0].shape[0]
    if n < 2:
        return tuple(op.clone() for op in operands)
    device = operands[0].device
    tiles = -(-n // tile)
    position = torch.arange(n, device=device)
    tile_of = position // tile
    src = operands
    sets = [tuple(torch.empty_like(op) for op in operands) for _ in range(2)]
    done = 0
    for kp in reversed(range(num_keys)):
        for shift in (0, 8, 16, 24):
            digit = _digits(src[kp], shift).to(torch.int64)
            # step 1: the table, bin-major
            cell = digit * tiles + tile_of
            table = torch.bincount(cell, minlength=_BINS * tiles)
            # step 2: exclusive scan in (bin, tile) order
            offset = torch.cumsum(table, 0) - table
            # step 3: rank among the keys of the same digit and tile, by
            # position: slot in the tile grouped stably by digit, less the
            # first slot of that (tile, digit) group
            group = tile_of * _BINS + digit
            order = torch.sort(group, stable=True).indices
            counts = torch.bincount(group, minlength=_BINS * tiles)
            first = torch.cumsum(counts, 0) - counts
            rank = torch.empty_like(position)
            rank[order] = position - first[group[order]]
            dest = offset[cell] + rank
            dst = sets[done % 2]
            for s, d in zip(src, dst):
                d[dest] = s
            src = dst
            done += 1
    return src
