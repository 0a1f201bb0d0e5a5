"""The sort behind `device_sort` on CUDA: a stable LSD radix sort.

`radix_sort` launches the hand-written Hopper kernels of
`csrc/radix_sort.cu`: one kernel reads every key plane once for the
histograms of all passes, one block turns them into bin starts and marks
the passes whose digit is constant, and then one kernel a pass ranks its
tiles and finds their offsets by decoupled look-back (a dead pass returns
at once). Digits of `DIGIT_BITS` bits, from the last key plane to the first
and from the lowest digit to the highest. It takes the place of the Pallas
bitonic network of stringsearch_tpu/ops/bitonic.py (`_local_sort_kernel`,
`_make_cross`) behind the port's `device_sort`, computes what
`jax.lax.sort(operands, num_keys=...)` computes, and is stable, so it equals
`ops.bitonic.plain_sort` element for element on every plane.

`plain_radix_sort` is the kernel's plain PyTorch version: the same passes
with the same arithmetic, step by step, at a tile size and digit width of
the caller's choice. The CPU tests use it; nothing on the main path calls
it.
"""

from __future__ import annotations

import ctypes
import os

import torch

from stringsearch_torch.ops import _build

_SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "radix_sort.cu")
_MAX_PLANES = 6
_I32 = torch.int32
# kDigitBits and kTile of csrc/radix_sort.cu
DIGIT_BITS = 8
TILE = 16384

# Number of sorts `radix_sort` has launched in this process.
launches = 0

_P = ctypes.c_void_p
_PLANES = ctypes.POINTER(_P)
LIBRARY = _build.Library("radix_sort", _SOURCE, {
    "ss_radix_sort_i32": (ctypes.c_int, [
        _PLANES, _PLANES, _PLANES, _P, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, _P]),
    "ss_radix_sort_scratch_ints": (ctypes.c_int64, [ctypes.c_int64]),
}, "ss_radix_sort_error_string")


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    return LIBRARY.load()


def launch_sort(lib: _build.Library, planes: tuple, num_keys: int) -> tuple:
    """Launch `lib`'s sort of contiguous int32 CUDA planes of one length
    n >= 2 on the current stream. The planes are only read (one that does
    not start on 16 bytes is copied first, as the kernel's bulk loads need);
    returns the sorted planes, new tensors. Raises if a launch failed."""
    planes = tuple(p if p.data_ptr() % 16 == 0 else p.clone()
                   for p in planes)
    c = len(planes)
    n = planes[0].shape[0]
    device = planes[0].device
    set_a = tuple(torch.empty_like(p) for p in planes)
    set_b = tuple(torch.empty_like(p) for p in planes)
    scratch = torch.empty((lib.load().ss_radix_sort_scratch_ints(n),),
                          dtype=_I32, device=device)

    def pointers(tensors):
        return (_P * c)(*(t.data_ptr() for t in tensors))

    lib.call("ss_radix_sort_i32", device, pointers(planes), pointers(set_a),
             pointers(set_b), scratch.data_ptr(), c, n, num_keys)
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
    sort holds c planes and `ss_radix_sort_scratch_ints(n)` int32 of
    scratch while it runs: 2^DIGIT_BITS 8-byte look-back words a tile of
    TILE keys, and a histogram a pass.
    """
    global launches
    operands = tuple(operands)
    _check_operands(operands, num_keys)
    if operands[0].device.type != "cuda":
        raise ValueError("radix_sort planes must share one CUDA device")
    if operands[0].shape[0] < 2:
        return tuple(op.clone() for op in operands)
    planes = tuple(op.contiguous() for op in operands)
    out = launch_sort(LIBRARY, planes, num_keys)
    launches += 1
    return out


def _digits(key: torch.Tensor, shift: int, digit_bits: int) -> torch.Tensor:
    """Bits [shift, shift + digit_bits) of the keys' bits XOR 0x80000000:
    unsigned digit order is then signed int32 order."""
    flipped = (key.to(torch.int64) & 0xFFFFFFFF) ^ (1 << 31)
    return (flipped >> shift) & ((1 << digit_bits) - 1)


def passes_of(num_keys: int, digit_bits: int = DIGIT_BITS) -> list:
    """(key plane, shift) of every pass, in the order they run."""
    return [(kp, shift) for kp in reversed(range(num_keys))
            for shift in range(0, 32, digit_bits)]


def plan(operands, num_keys: int = 1, digit_bits: int = DIGIT_BITS):
    """The kernel's steps 1 and 2 in plain PyTorch: the histogram of every
    pass's digit, from one read of each key plane, and which passes are
    live. Returns (hist, live): hist [passes, 2^digit_bits] int64 bin
    counts, live a list of bools, False where one bin holds every key.
    When no pass is live the last one is, as a copy."""
    operands = tuple(operands)
    n = operands[0].shape[0]
    bins = 1 << digit_bits
    hist = torch.stack([
        torch.bincount(_digits(operands[kp], shift, digit_bits),
                       minlength=bins)
        for kp, shift in passes_of(num_keys, digit_bits)])
    live = (hist < n).all(dim=1).tolist()
    if not any(live):
        live[-1] = True
    return hist, live


def live_digits(spans, digit_bits: int = DIGIT_BITS) -> int:
    """The passes `plan` marks live over one int32 key plane whose values
    fill `spans`, inclusive (low, high) pairs: a pass is dead where every
    value has the same digit. The digits are those of the values' bits
    XOR 0x80000000, an order-keeping shift by 2^31 of the int32 range."""
    live = 0
    for shift in range(0, 32, digit_bits):
        ends = [((a + 2**31) >> shift, (b + 2**31) >> shift)
                for a, b in spans]
        same = all(a == b for a, b in ends) and len(
            {a % (1 << digit_bits) for a, _ in ends}) == 1
        live += not same
    return live


def design_bytes(n: int, c: int, num_keys: int, live,
                 digit_bits: int = DIGIT_BITS, tile: int = TILE) -> int:
    """Device-memory bytes the kernel moves for a sort of c planes by
    num_keys whose passes are `live` (from `plan`): the histogram kernel
    reads each key plane once, the look-back words are zeroed once, and a
    live pass reads and writes all c planes and writes each tile's
    look-back words twice and reads at least its predecessor's."""
    words = -(-n // tile) * (1 << digit_bits) * 8
    return 4 * n * num_keys + words + sum(live) * (8 * c * n + 3 * words)


def plain_radix_sort(operands, num_keys: int = 1, tile: int = TILE,
                     digit_bits: int = DIGIT_BITS) -> tuple:
    """`radix_sort` in plain PyTorch, on the operands' device: the kernel's
    passes with the kernel's arithmetic at tile size `tile` and digits of
    `digit_bits` bits.

    `plan` counts every pass's digits from the operands and drops the
    passes whose digit is constant. The live passes run from the last key
    plane to the first and from the lowest digit to the highest, between
    two alternating buffer sets chosen so that the last live pass writes
    the second (the operands are only read). A live pass puts a key at the
    first slot of its bin (the exclusive scan of the histogram), plus the
    keys of its bin in the tiles before its own (what the look-back sums),
    plus its rank among the keys of its bin in its tile, by position.
    """
    operands = tuple(operands)
    _check_operands(operands, num_keys)
    if tile < 1:
        raise ValueError(f"tile={tile} must be >= 1")
    if not 1 <= digit_bits <= 16:
        raise ValueError(f"digit_bits={digit_bits} must be in 1..16")
    n = operands[0].shape[0]
    if n < 2:
        return tuple(op.clone() for op in operands)
    device = operands[0].device
    bins = 1 << digit_bits
    tiles = -(-n // tile)
    position = torch.arange(n, device=device)
    tile_of = position // tile
    hist, live = plan(operands, num_keys, digit_bits)
    bin_start = torch.cumsum(hist, 1) - hist
    sets = [tuple(torch.empty_like(op) for op in operands) for _ in range(2)]
    remaining = sum(live)
    src = operands
    for p, (kp, shift) in enumerate(passes_of(num_keys, digit_bits)):
        if not live[p]:
            continue
        remaining -= 1
        digit = _digits(src[kp], shift, digit_bits)
        # the keys of each bin in each tile, and before each tile
        count = torch.bincount(digit * tiles + tile_of,
                               minlength=bins * tiles).view(bins, tiles)
        earlier = torch.cumsum(count, 1) - count
        # rank among the keys of the same digit and tile, by position: slot
        # in the tile grouped stably by digit, less the first slot of that
        # (tile, digit) group
        group = tile_of * bins + digit
        order = torch.sort(group, stable=True).indices
        sizes = torch.bincount(group, minlength=bins * tiles)
        first = torch.cumsum(sizes, 0) - sizes
        rank = torch.empty_like(position)
        rank[order] = position - first[group[order]]
        dest = bin_start[p][digit] + earlier[digit, tile_of] + rank
        dst = sets[1 - remaining % 2]
        for s, d in zip(src, dst):
            d[dest] = s
        src = dst
    return src
