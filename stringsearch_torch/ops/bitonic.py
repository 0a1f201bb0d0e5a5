"""`device_sort`: every sort of the doubling engine, through one kernel.

Counterpart of stringsearch_tpu/ops/bitonic.py. There, `device_sort` takes
the Pallas bitonic network (`_local_sort_kernel` + `_make_cross`) when it
is switched on and XLA's sort otherwise. Here it takes the hand-written
Hopper bitonic sort (`csrc/bitonic.cu`) for every CUDA call, at every n,
and the plain version below for tensors on the CPU. There is no other
route and no fallback: on CUDA the operands must be int32 planes.

The kernel is NOT stable (bitonic networks are not): ties in the key set
come back in arbitrary order. Every call site in the engine either carries
a unique last key or does not depend on order inside ties (see
engines/doubling.py). The plain version is the chained stable sort, equal
to `jax.lax.sort(operands, num_keys=...)` element for element.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from stringsearch_torch.ops import _build

_SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "bitonic.cu")
_MAX_PLANES = 6

# Number of kernel sorts launched by `bitonic_sort` in this process.
launches = 0

_lock = threading.Lock()
_lib = None


def build(name: str, source: str) -> ctypes.CDLL:
    """Build the kernel library `name` from `source` and load it."""
    path = _build.build_library(
        name, [source], [_build.nvcc(), *_build.NVCC_FLAGS])
    lib = ctypes.CDLL(path)
    lib.ss_bitonic_sort_i32.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.ss_bitonic_sort_i32.restype = ctypes.c_int
    lib.ss_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ss_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = build("bitonic", _SOURCE)
        return _lib


def launch_sort(lib: ctypes.CDLL, planes: tuple, num_keys: int) -> None:
    """Launch `lib`'s sort on contiguous int32 CUDA planes of one length,
    in place, on the current stream. Raises if the launch failed."""
    ptrs = (ctypes.c_void_p * len(planes))(*(p.data_ptr() for p in planes))
    device = planes[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ss_bitonic_sort_i32(ptrs, len(planes), planes[0].shape[0],
                                     num_keys, stream)
    if rc != 0:
        raise RuntimeError(
            f"bitonic kernel launch failed: "
            f"{lib.ss_cuda_error_string(rc).decode()} (code {rc})")


def plain_sort(operands, num_keys: int = 1) -> tuple:
    """Lexicographic sort by the first `num_keys` operands, stable.

    Chained stable `torch.sort` from the last key to the first, every
    plane gathered through the composed permutation once at the end.
    Equals `jax.lax.sort(operands, num_keys=num_keys)` exactly.
    """
    operands = tuple(operands)
    perm = None
    for key in reversed(operands[:num_keys]):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return tuple(op[perm] for op in operands)


def bitonic_sort(operands, num_keys: int = 1) -> tuple:
    """Sort 1-D int32 CUDA planes with the Hopper kernel. Not stable.

    Returns new tensors; the inputs are left as they are. Each output is
    one copy of its input, sorted in place by the kernel.
    """
    global launches
    operands = tuple(operands)
    c = len(operands)
    if not 1 <= c <= _MAX_PLANES:
        raise ValueError(f"bitonic_sort takes 1..{_MAX_PLANES} planes, got {c}")
    if not 1 <= num_keys <= c:
        raise ValueError(f"num_keys must be in 1..{c}, got {num_keys}")
    first = operands[0]
    n = first.shape[0]
    for op in operands:
        if op.device != first.device or op.device.type != "cuda":
            raise ValueError("bitonic_sort planes must share one CUDA device")
        if op.dtype != torch.int32:
            raise TypeError(f"bitonic_sort takes int32 planes, got {op.dtype}")
        if op.dim() != 1 or op.shape[0] != n:
            raise ValueError("bitonic_sort planes must be 1-D of one length")
    if n >= 1 << 31:
        raise ValueError("bitonic_sort takes fewer than 2^31 elements")
    outs = tuple(op.clone(memory_format=torch.contiguous_format)
                 for op in operands)
    if n < 2:
        return outs
    launch_sort(load_library(), outs, num_keys)
    launches += 1
    return outs


def device_sort(operands, num_keys: int = 1) -> tuple:
    """`lax.sort`-shaped sort of 1-D operands by their first `num_keys`.

    CPU tensors go to `plain_sort`; every other tensor to the Hopper
    kernel, which takes int32 CUDA planes only and raises on anything else.
    Not stable on CUDA: callers must not rely on the order inside ties.
    """
    operands = tuple(operands)
    if operands[0].device.type == "cpu":
        return plain_sort(operands, num_keys)
    return bitonic_sort(operands, num_keys)
