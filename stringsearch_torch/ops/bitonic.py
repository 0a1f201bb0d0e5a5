"""`device_sort`: every sort of the engines, through one function.

Counterpart of stringsearch_tpu/ops/bitonic.py. There, `device_sort` takes
the Pallas bitonic network (`_local_sort_kernel` + `_make_cross`) when it
is switched on and XLA's sort otherwise. Here it takes the hand-written
Hopper radix sort (`ops/radix_sort.py`, `csrc/radix_sort.cu`) for every
CUDA call, at every n, and the plain version below for tensors on the CPU.
There is no other route and no fallback: on CUDA the operands must be
int32 or int64 planes.

Both routes are stable and equal `jax.lax.sort(operands, num_keys=...)`
element for element: the radix sort by construction, the plain version as
a chained stable `torch.sort`.

`bitonic_sort` is the port of the bitonic network itself
(`csrc/bitonic.cu`). It is NOT stable (bitonic networks are not) and is
slower than the radix sort at every shape the engine uses (PERF.md), so
nothing routes through it; it stays as the counterpart of the two TPU
kernels, held against the plain version by its tests and `chip_smoke.py`.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from stringsearch_torch.ops import _build
from stringsearch_torch.ops.radix_sort import radix_sort

_SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "bitonic.cu")
_MAX_PLANES = 6
# keys a `wide_sort` launch takes: the sixth plane is the permutation
_GROUP = _MAX_PLANES - 1

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
    """Sort 1-D int32 CUDA planes with the Hopper bitonic kernel. Not
    stable.

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


def _key_words(key: torch.Tensor) -> tuple:
    """The int32 planes of one key, most significant first, in signed
    order: an int32 key itself; an int64 key as its high word (signed)
    and its low word XOR 0x80000000 (unsigned order as signed)."""
    if key.dtype == torch.int32:
        return (key,)
    return ((key >> 32).to(torch.int32),
            ((key & 0xFFFFFFFF) - (1 << 31)).to(torch.int32))


def wide_sort(operands, num_keys: int, narrow) -> tuple:
    """`lax.sort`-shaped stable sort of int32 and int64 planes, composed
    of `narrow` sorts of at most six int32 planes.

    A stable LSD sort over groups of keys: from the last group of up to
    five int32 key planes to the first, one `narrow` sort of (the group's
    keys gathered through the running permutation, the permutation);
    then every operand gathered once through the final permutation, in
    its own dtype. An int64 key is two int32 key planes (`_key_words`),
    an int64 payload is only gathered. So a sort of k int32 key planes
    makes ceil(k / 5) `narrow` calls. `narrow` (on CUDA `radix_sort`)
    must be stable and take (planes, num_keys).

    The running permutation is int32, and `radix_sort` refuses 2^31
    elements or more: on CUDA, int64 planes (and so `idx=torch.int64`
    builds) work for n < 2^31 only, where they change the index dtype
    and not the reach.
    """
    operands = tuple(operands)
    for op in operands:
        if op.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"wide_sort takes int32 and int64 planes, got "
                            f"{op.dtype}")
    if not 1 <= num_keys <= len(operands):
        raise ValueError(f"num_keys must be in 1..{len(operands)}, got "
                         f"{num_keys}")
    # (operand, word) of every int32 key plane, most significant first
    words = [(i, w) for i in range(num_keys)
             for w in range(2 if operands[i].dtype == torch.int64 else 1)]
    perm = None
    for end in range(len(words), 0, -_GROUP):
        group = words[max(end - _GROUP, 0):end]
        gathered = {}
        planes = []
        for i, w in group:
            if i not in gathered:
                gathered[i] = _key_words(
                    operands[i] if perm is None else operands[i][perm])
            planes.append(gathered[i][w])
        if perm is None:
            perm = torch.arange(operands[0].shape[0], dtype=torch.int32,
                                device=operands[0].device)
        perm = narrow(tuple(planes) + (perm,), len(planes))[-1]
        del gathered, planes
    return tuple(op[perm] for op in operands)


class PlainSortCalls:
    """Counts the calls of `plain_sort` (the CPU route of `device_sort`)
    while it is entered: a CUDA path that must never take it is held to
    `calls == 0`."""

    def __enter__(self):
        global plain_sort
        self.calls = 0
        self._plain = plain_sort

        def counted(operands, num_keys=1):
            self.calls += 1
            return self._plain(operands, num_keys)

        plain_sort = counted
        return self

    def __exit__(self, *exc):
        global plain_sort
        plain_sort = self._plain


def device_sort(operands, num_keys: int = 1) -> tuple:
    """`lax.sort`-shaped sort of 1-D operands by their first `num_keys`.

    CPU tensors go to `plain_sort`. On CUDA, at most six int32 planes are
    one `radix_sort` launch; more planes, or int64 planes, go to
    `wide_sort` over `radix_sort`; any other dtype raises. Stable on both.
    On CUDA n must be below 2^31 (`radix_sort`'s int32 n), int64 planes
    included.
    """
    operands = tuple(operands)
    if operands[0].device.type == "cpu":
        return plain_sort(operands, num_keys)
    if len(operands) <= _MAX_PLANES and all(
            op.dtype == torch.int32 for op in operands):
        return radix_sort(operands, num_keys)
    return wide_sort(operands, num_keys, radix_sort)
