"""The merge-split of the distributed sort, as a Hopper kernel.

A stage of `parallel/distsort.py:sharded_sort` (the bitonic network over
shards) hands each shard its partner's sorted chunk; the shard keeps the
low or the high half of the two chunks' stable merge. The JAX package's
`_merge_halves` (stringsearch_tpu/parallel/distsort.py:45) concatenates
the two [L] chunks and sorts all 2L elements with `lax.sort`; XLA has no
merge. `merge_split` merges them in one pass of `csrc/merge.cu` and writes
the kept half only. None of it replaces a Pallas kernel.

`merge_split` runs inside the span `ops.merge_split`
(`harness/tracing.py`), whose attributes `reads` and `writes` give
(elements, bytes an element) of both runs' planes and of the kept half's.

CPU tensors go to `plain_merge_split`, the concatenation and stable sort
that `_merge_halves` ran before; CUDA tensors to the kernel, which raises
on a type, shape or launch error. There is no other route and no fallback.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from stringsearch_torch.harness.tracing import planes, spanned
from stringsearch_torch.ops import _build
from stringsearch_torch.ops.bitonic import plain_sort

_SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "merge.cu")
_IDX = (torch.int32, torch.int64)
# kMaxPlanes and kMaxWords of csrc/merge.cu: planes of a launch, and 32-bit
# key words (an int64 key is two)
MAX_PLANES = 64
MAX_KEY_WORDS = 64

# Kernel launches in this process.
launches = 0

_lock = threading.Lock()
_lib = None
_P = ctypes.c_void_p


def _load(path: str) -> ctypes.CDLL:
    """Load the built library at `path` and declare its C interface."""
    lib = ctypes.CDLL(path)
    lib.ss_merge_split.argtypes = [
        ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_P),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int, _P, _P]
    lib.ss_merge_split.restype = ctypes.c_int
    lib.ss_merge_split_scratch_bytes.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.ss_merge_split_scratch_bytes.restype = ctypes.c_int64
    lib.ss_merge_error_string.argtypes = [ctypes.c_int]
    lib.ss_merge_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(_build.build_library(
                "merge", [_SOURCE], [_build.nvcc(), *_build.NVCC_FLAGS]))
        return _lib


def _check(mine, theirs, num_keys: int) -> tuple:
    mine, theirs = tuple(mine), tuple(theirs)
    if not mine or len(mine) != len(theirs):
        raise ValueError(f"merge_split needs the same planes from both runs, "
                         f"got {len(mine)} and {len(theirs)}")
    if not 1 <= num_keys <= len(mine):
        raise ValueError(f"num_keys must be in 1..{len(mine)}, got "
                         f"{num_keys}")
    first = mine[0]
    for a, b in zip(mine, theirs):
        for t in (a, b):
            if t.dtype not in _IDX or t.dim() != 1:
                raise TypeError(f"merge_split takes 1-D int32 and int64 "
                                f"planes, got {t.dtype} of {t.dim()} dims")
            if t.shape != first.shape or t.device != first.device:
                raise ValueError("merge_split planes must share one length "
                                 "and one device")
        if a.dtype != b.dtype:
            raise TypeError(f"a plane has {a.dtype} in one run and {b.dtype} "
                            f"in the other")
    return mine, theirs


def check_width(planes, num_keys: int) -> int:
    """The 32-bit key words of `planes` sorted by `num_keys` (one an int32
    key, two an int64 key); raises past what the kernel takes: MAX_PLANES
    planes and MAX_KEY_WORDS key words."""
    words = sum(2 if p.dtype == torch.int64 else 1
                for p in planes[:num_keys])
    if len(planes) > MAX_PLANES or words > MAX_KEY_WORDS:
        raise ValueError(
            f"merge_split takes at most {MAX_PLANES} planes and "
            f"{MAX_KEY_WORDS} 32-bit key words (an int64 key is two) on "
            f"CUDA, got {len(planes)} planes and {words} key words")
    return words


def plain_merge_split(mine, theirs, mine_first: bool, keep_low: bool,
                      num_keys: int, sort=plain_sort) -> tuple:
    """`merge_split` as the route it replaced: the two runs concatenated
    (the first run first), one stable `sort` of all 2L elements, and a copy
    of the kept half."""
    mine, theirs = _check(mine, theirs, num_keys)
    length = mine[0].shape[0]
    cat = tuple(torch.cat([a, b] if mine_first else [b, a])
                for a, b in zip(mine, theirs))
    merged = sort(cat, num_keys)
    del cat
    half = slice(0, length) if keep_low else slice(length, 2 * length)
    # a copy of the half, so the 2L buffer goes now
    return tuple(m[half].clone() for m in merged)


@spanned("ops.merge_split", lambda out, mine, theirs, *a, **k: {
    "reads": planes((*mine, *theirs)), "writes": planes(out)})
def merge_split(mine, theirs, mine_first: bool, keep_low: bool,
                num_keys: int) -> tuple:
    """One half of the stable merge of two sorted runs.

    `mine` and `theirs` are tuples of [L] planes (int32 or int64, a plane
    of the same dtype in both), each sorted lexicographically by its first
    `num_keys` planes, every key compared as a signed integer of its dtype.
    The run of `mine` comes first where `mine_first`, else that of
    `theirs`; where key tuples tie, the first run's elements come first.
    Returns the low L (`keep_low`) or the high L elements of the merge,
    new tensors of the planes' dtypes. It equals the same half of a stable
    sort of the concatenation, so two partners that pass the same runs in
    the same order get complementary halves of one list.
    """
    global launches
    mine, theirs = _check(mine, theirs, num_keys)
    device = mine[0].device
    if device.type == "cpu":
        return plain_merge_split(mine, theirs, mine_first, keep_low,
                                 num_keys)
    if device.type != "cuda":
        raise ValueError(f"merge_split planes must lie on the CPU or a CUDA "
                         f"device, got {device}")
    words = check_width(mine, num_keys)
    first, second = (mine, theirs) if mine_first else (theirs, mine)
    first = [p.contiguous() for p in first]
    second = [p.contiguous() for p in second]
    length = first[0].shape[0]
    outs = tuple(torch.empty_like(p) for p in first)
    if not length:
        return outs
    lib = load_library()
    c = len(first)
    scratch = torch.empty(
        (lib.ss_merge_split_scratch_bytes(length, words) // 8,),
        dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ss_merge_split(
            (_P * c)(*(p.data_ptr() for p in first)),
            (_P * c)(*(p.data_ptr() for p in second)),
            (_P * c)(*(p.data_ptr() for p in outs)),
            (ctypes.c_int * c)(*(p.element_size() for p in first)),
            c, num_keys, length, int(bool(keep_low)), scratch.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"ss_merge_split launch failed: "
                           f"{lib.ss_merge_error_string(rc).decode()} "
                           f"(code {rc})")
    launches += 1
    return outs
