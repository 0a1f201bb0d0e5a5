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
(`csrc/bitonic.cu`), the all-ascending network with every comparator past
n skipped. It runs the passes `schedule` lists: one pass sorts each tile
of 2^13 to 2^15 elements in shared memory, and every merge level past the
tile takes ceil(stages past the tile / S) group passes (S = log2(tile) -
5 stages each, the level's mirror stage in the first) and one tile pass:
38 passes at n = 2^28 with four to six planes, 34 with two or three.
`plain_bitonic_sort` runs the same passes in torch ops, block by block as
the kernel does, so the two agree element for element on every plane. On
an H100 at n = 2^28 the kernel takes 85.5, 180.2 and 223.3 ms for the main
path's 2-, 4- and 5-plane sorts, 1.4 to 2.5 times the chained
`torch.sort` and 2.9 to 7.2 times the radix sort (PERF.md). The network
is NOT stable, so nothing routes through it: `device_sort` must equal
`lax.sort` element for element. It stays as the counterpart of the two
TPU kernels.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple

import torch

from stringsearch_torch.harness.tracing import span
from stringsearch_torch.ops import _build
from stringsearch_torch.ops.radix_sort import radix_sort

_SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "bitonic.cu")
_MAX_PLANES = 6
# keys a `wide_sort` launch takes: the sixth plane is the permutation
_GROUP = _MAX_PLANES - 1
# log2 of the shortest row a group pass stages (`kRowLog`)
ROW_LOG = 5
_KINDS = ("sort", "group", "tile")

# Number of kernel sorts launched by `bitonic_sort` in this process.
launches = 0

_lock = threading.Lock()
_lib = None


def tile_log(num_planes: int) -> int:
    """log2 of the kernel's tile for `num_planes` planes: the largest power
    of two whose planes fit in shared memory (`csrc/bitonic.cu`)."""
    return 15 if num_planes == 1 else 14 if num_planes <= 3 else 13


class Pass(NamedTuple):
    """One pass over the planes. "sort": merge levels 1 .. level inside
    each tile. "group": the stages of merge level `level` on bits hi .. lo
    (all at or past the tile), its mirror stage among them when hi ==
    level - 1. "tile": the half-cleaners of bits hi .. lo = t-1 .. 0 that
    end level `level`."""
    kind: str
    level: int
    hi: int
    lo: int


def schedule(n: int, num_planes: int, tile: int | None = None,
             group_stages: int | None = None) -> list[Pass]:
    """The passes of one sort of n elements, in order, as the kernel runs
    them (`make_schedule`): tile 2^tile_log(num_planes) and group passes of
    S = log2(tile) - ROW_LOG stages unless given. Below one tile, one sort
    pass; past it, each level's stages at or past the tile in groups of at
    most S (the first group takes the remainder), then a tile pass."""
    if n < 2:
        return []
    t_max = tile_log(num_planes) if tile is None else tile.bit_length() - 1
    if tile is not None and (tile < 2 or tile & (tile - 1)):
        raise ValueError(f"tile must be a power of two >= 2, got {tile}")
    most = t_max - ROW_LOG if group_stages is None else group_stages
    if not 1 <= most <= t_max:
        raise ValueError(f"group_stages must be in 1..{t_max}, got {most}")
    log_full = (n - 1).bit_length()
    t = min(t_max, log_full)
    passes = [Pass("sort", t, t - 1, 0)]
    for level in range(t + 1, log_full + 1):
        hi = level - 1
        while hi >= t:
            width = (hi - t) % most + 1
            passes.append(Pass("group", level, hi, hi - width + 1))
            hi -= width
        passes.append(Pass("tile", level, t - 1, 0))
    return passes


def pass_stages(p: Pass) -> list[tuple[int, int]]:
    """The network's stages that pass p runs, in order, as (level, bit):
    bit level - 1 is the level's mirror stage, a lower bit a
    half-cleaner."""
    if p.kind == "sort":
        return [(level, b) for level in range(1, p.level + 1)
                for b in range(level - 1, -1, -1)]
    return [(p.level, b) for b in range(p.hi, p.lo - 1, -1)]


def _rows_below(base, lo: int, r: int, rows: int, n: int):
    """Elements below n among `rows` rows of 2^r at stride 2^lo from each
    base (`rows_below`)."""
    d = n - base
    x = d >> lo
    part = (d - (x << lo)).clamp(max=1 << r)
    count = torch.where(x >= rows, rows << r, (x << r) + part)
    return torch.where(d <= 0, 0, count)


def _frame(p: Pass, t: int, full: int, n: int, device) -> tuple:
    """Device positions of each block's elements in local order, [blocks,
    2^t] and increasing along a row, and each block's count of elements
    below n (the kernel's `Frame` and `valid`)."""
    size = 1 << t
    if p.kind != "group":
        base = torch.arange(0, full, size, device=device)
        pos = base[:, None] + torch.arange(size, device=device)
        return pos, _rows_below(base, t, t, 1, n)
    w = p.hi - p.lo + 1
    r = t - w
    low_bits = p.lo - r
    low_mask = (1 << low_bits) - 1
    block = torch.arange(full >> t, device=device)
    base = ((block >> low_bits) << (p.lo + w)) | ((block & low_mask) << r)
    starts = base[:, None] + (torch.arange(1 << w, device=device) << p.lo)
    half = 1 << (w - 1)
    if p.hi == p.level - 1:
        # the mirrored frame: the upper half's rows from the complemented
        # block-row bits, in device order
        starts[:, half:] ^= low_mask << r
        valid = _rows_below(base, p.lo, r, half, n)
        upper = _rows_below(starts[:, half], p.lo, r, half, n)
        valid = valid + torch.where(valid == size // 2, upper, 0)
    else:
        valid = _rows_below(base, p.lo, r, 1 << w, n)
    pos = starts[:, :, None] + torch.arange(1 << r, device=device)
    return pos.reshape(-1, size), valid


def _local_stages(p: Pass, t: int) -> list[tuple[int, int]]:
    """The stages of pass p on a block's local bits, as (partner mask, its
    top bit): a mirror pairs s with s ^ (2^L - 1), a half-cleaner s with
    s ^ 2^b."""
    if p.kind == "sort":
        out = []
        for level in range(1, p.level + 1):
            out.append(((1 << level) - 1, level - 1))
            out += [(1 << b, b) for b in range(level - 2, -1, -1)]
        return out
    if p.kind == "tile":
        return [(1 << b, b) for b in range(t - 1, -1, -1)]
    r = t - (p.hi - p.lo + 1)
    out = []
    top = t - 1
    if p.hi == p.level - 1:
        out.append(((1 << t) - 1, t - 1))
        top -= 1
    return out + [(1 << b, b) for b in range(top, r - 1, -1)]


def _lex_gt(x, y, num_keys: int):
    """Lexicographic x > y on the first num_keys planes of [C, ...]."""
    gt = torch.zeros_like(x[0], dtype=torch.bool)
    for q in reversed(range(num_keys)):
        gt = (x[q] > y[q]) | ((x[q] == y[q]) & gt)
    return gt


def plain_bitonic_sort(operands, num_keys: int = 1, tile: int | None = None,
                       group_stages: int | None = None) -> tuple:
    """The kernel's network in torch ops, on any device: the passes of
    `schedule(n, C, tile, group_stages)` one by one, each as the kernel
    runs it. A pass gathers every block's elements in local order (the
    mirrored frame of a group pass included), runs its stages on the
    block's local indices (the smaller element to the lower index, a
    comparator skipped when its upper index is past the block's valid
    count) and writes the elements back. Equals `bitonic_sort` element for
    element on every plane; not stable."""
    operands = tuple(operands)
    c = len(operands)
    if not 1 <= num_keys <= c:
        raise ValueError(f"num_keys must be in 1..{c}, got {num_keys}")
    n = operands[0].shape[0]
    planes = [op.clone() for op in operands]
    passes = schedule(n, c, tile, group_stages)
    if not passes:
        return tuple(planes)
    device = operands[0].device
    full = 1 << (n - 1).bit_length()
    t = passes[0].level
    local = torch.arange(1 << t, device=device)
    for p in passes:
        pos, valid = _frame(p, t, full, n, device)
        keep = local < valid[:, None]
        at = pos.clamp(max=n - 1)
        block = torch.stack([op[at] for op in planes])
        for mask, top in _local_stages(p, t):
            lower = local[(local >> top) & 1 == 0]
            upper = lower ^ mask
            x = block[:, :, lower]
            y = block[:, :, upper]
            swap = (upper < valid[:, None]) & _lex_gt(x, y, num_keys)
            block[:, :, lower] = torch.where(swap, y, x)
            block[:, :, upper] = torch.where(swap, x, y)
        for q, op in enumerate(planes):
            op[pos[keep]] = block[q][keep]
    return tuple(planes)


def build(name: str, source: str) -> ctypes.CDLL:
    """Build the kernel library `name` from `source` and load it."""
    path = _build.build_library(
        name, [source], [_build.nvcc(), *_build.NVCC_FLAGS])
    lib = ctypes.CDLL(path)
    lib.ss_bitonic_sort_i32.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.ss_bitonic_sort_i32.restype = ctypes.c_int
    lib.ss_bitonic_schedule.argtypes = [
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int]
    lib.ss_bitonic_schedule.restype = ctypes.c_int
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


def kernel_schedule(n: int, num_planes: int, lib=None) -> list[Pass]:
    """The passes the kernel library runs for one sort (its
    `ss_bitonic_schedule`), to hold against `schedule`."""
    lib = lib or load_library()
    cap = 256
    buf = (ctypes.c_int * (4 * cap))()
    count = lib.ss_bitonic_schedule(n, num_planes, buf, cap)
    if not 0 <= count <= cap:
        raise RuntimeError(f"ss_bitonic_schedule returned {count}")
    return [Pass(_KINDS[buf[4 * i]], *buf[4 * i + 1:4 * i + 4])
            for i in range(count)]


def launch_sort(lib: ctypes.CDLL, planes_in: tuple, planes_out: tuple,
                num_keys: int) -> None:
    """Launch `lib`'s sort of contiguous int32 CUDA planes of one length
    from `planes_in` into `planes_out` (which may be the same tensors), on
    the current stream. Raises if a launch failed."""
    def pointers(planes):
        return (ctypes.c_void_p * len(planes))(
            *(p.data_ptr() for p in planes))

    device = planes_out[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ss_bitonic_sort_i32(pointers(planes_in),
                                     pointers(planes_out), len(planes_out),
                                     planes_out[0].shape[0], num_keys,
                                     stream)
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
    stable; equals `plain_bitonic_sort` element for element.

    Returns new tensors; the inputs are left as they are. The kernel's
    first pass reads the inputs and writes the outputs, so no copy is made
    first. `len(schedule(n, C))` passes over the planes: at n = 2^28 on an
    H100, 85.5 / 180.2 / 223.3 ms at C = 2 / 4 / 5, slower than the chained
    `torch.sort` (33.7 / 120.6 / 164.1 ms) and than `device_sort`'s radix
    sort; the same at 2^24 (PERF.md).
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
    src = tuple(op.contiguous() for op in operands)
    outs = tuple(torch.empty_like(op) for op in src)
    if n < 2:
        for o, s in zip(outs, src):
            o.copy_(s)
        return outs
    launch_sort(load_library(), src, outs, num_keys)
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
    included. Every call runs inside the span `ops.device_sort`
    (`sort_span`).
    """
    operands = tuple(operands)
    with sort_span(operands, num_keys):
        if operands[0].device.type == "cpu":
            return plain_sort(operands, num_keys)
        if len(operands) <= _MAX_PLANES and all(
                op.dtype == torch.int32 for op in operands):
            return radix_sort(operands, num_keys)
        return wide_sort(operands, num_keys, radix_sort)


def sort_span(operands: tuple, num_keys: int):
    """The span `ops.device_sort` of a sort of `operands` by `num_keys`
    (`harness/tracing.py`), with its attributes: the length `n`,
    `num_keys`, `itemsizes`, the bytes an element of each plane, and
    `card`, the CUDA index of the planes' device (None off CUDA). A sort
    moves each plane in and out once, 2 n sum(itemsizes) bytes."""
    sp = span("ops.device_sort")
    if sp:
        device = operands[0].device
        sp.set(n=int(operands[0].shape[0]), num_keys=num_keys,
               itemsizes=tuple(op.element_size() for op in operands),
               card=device.index if device.type == "cuda" else None)
    return sp
