"""Prefix-doubling SACA with tied-group compaction, in PyTorch.

Counterpart of stringsearch_tpu/engines/doubling.py; the algorithm is the
same, step for step:

  1. initial ranks from a `depth`-byte packed key (depth/4 keys of four
     raw bytes, zero-padded past the end; one multi-key sort);
  2. full-width fan rounds, sorting by (rank[i], rank[i+h], ..,
     rank[i+(fan-1)h]) while more than n/levels[0] positions stay tied;
  3. cascaded compaction: tied-group members move to capacity-n/levels[i]
     arrays and only they are re-sorted, rank/SA updates scattered back.

Every sort goes through `ops.bitonic.device_sort`: the Hopper kernel on
CUDA, the plain stable sort on the CPU.

What differs from the JAX package, and why:
  * The loops (`lax.while_loop`, `cond`, `switch`) are host loops that
    read the tied count with one `.item()` per round; `h` is a host int.
  * Group heads (the reference's `cummax`) come from a cumsum and a
    scatter (`_segment_heads`).
  * Packed keys are int32 with bit 31 flipped (`^ 0x80000000`), so signed
    order equals the reference's uint32 order.
  * `_shift_ranks` clamps its shift explicitly (`dynamic_slice` clamped it
    implicitly).
  * The compaction rounds update rank and SA in place, in [n+1] buffers
    whose last slot absorbs the pads' writes (the reference's scatter
    with mode="drop").
  * On CUDA the sort is not stable and `torch.topk` orders ties freely, so
    tied-group members may come out of `_extract` in another order than in
    the reference. Nothing downstream depends on that order: group
    membership, heads and counts are the same, and the final SA is unique.
Indexes are int32 (n < 2^31); the int64 index mode is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from stringsearch_torch.core.types import SuffixArray, as_text_tensor
from stringsearch_torch.ops.bitonic import device_sort

_I32 = torch.int32
_SENT = torch.iinfo(torch.int32).max
# XOR with INT32_MIN flips bit 31: maps uint32 order onto int32 order
_BIAS = torch.iinfo(torch.int32).min


def _check_args(idx, depth: int, fan: int) -> None:
    if idx != _I32:
        raise NotImplementedError(
            "only idx=torch.int32 is ported; the int64 index mode is a "
            "ROADMAP item")
    if depth % 4 or depth < 4:
        raise ValueError("depth must be a positive multiple of 4")
    if fan < 2:
        # fan=1 would make h_n == h so the loops never advance
        raise ValueError("fan must be >= 2")


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _pack4_keys(text: torch.Tensor, depth: int) -> tuple:
    """depth/4 int32 keys of four RAW text bytes each, zero-padded, biased.

    Key k of suffix i is bytes i+4k .. i+4k+3, big-endian, XOR 0x80000000:
    as signed int32 it orders like the reference's uint32 key.
    """
    n = text.shape[0]
    t = torch.cat([text.to(_I32), text.new_zeros((depth,), dtype=_I32)])
    keys = []
    for k in range(depth // 4):
        o = 4 * k
        keys.append(
            ((t[o : o + n] << 24)
             | (t[o + 1 : o + 1 + n] << 16)
             | (t[o + 2 : o + 2 + n] << 8)
             | t[o + 3 : o + 3 + n]) ^ _BIAS
        )
    return tuple(keys)


def _scatter_to_text_order(sa, rank_s):
    """rank[sa] = rank_s as a 1-key sort: sorting (sa, rank_s) by sa places
    rank_s[j] at text position sa[j]."""
    _, rank = device_sort((sa, rank_s), num_keys=1)
    return rank


def _shift_ranks(rank, h: int):
    """rank_h[i] = rank[i+h], or the marker -(i+1) past the end.

    The marker is negative (an ended suffix sorts before every continuing
    one) and strictly decreasing in i (two suffixes that both end within
    the window split at once, shorter first). Shifts above n are clamped
    to n, where every entry is a marker.
    """
    n = rank.shape[0]
    h_c = min(h, n)
    tail = -(torch.arange(n - h_c, n, dtype=rank.dtype, device=rank.device) + 1)
    return torch.cat([rank[h_c:], tail])


def _segment_heads(flag, j):
    """head[i] = the last slot <= i whose `flag` is set (flag[0] must be).

    The reference's `cummax(where(flag, j, -1))`. torch's CUDA cummax is a
    generic scan that took 44 ms of a 145 ms build at n = 2^24 on an H100,
    so this is a cumsum, a scatter and a gather instead: each flagged slot
    writes its index to its segment's entry, every other slot to a private
    scratch entry, so no two writes meet.
    """
    n = j.shape[0]
    seg = torch.cumsum(flag, 0, dtype=j.dtype) - 1
    buf = torch.empty((2 * n,), dtype=j.dtype, device=j.device)
    buf[torch.where(flag, seg, n + j)] = j
    return buf[seg]


def _heads_and_tied(new_flag, j):
    """head[j] = slot index of j's group head; tied[j] = group size >= 2."""
    head = _segment_heads(new_flag, j)
    nxt_head = torch.cat([head[1:], head.new_full((1,), -1)])
    tied = (head != j) | (nxt_head == head)
    return head, tied


def _ranks_sorted_only(out):
    """Head-slot ranking of a sorted (keys..., payload) tuple, in sorted
    order only. Returns (sa_s, rank_s, count) with count a 0-d tensor.

    The text-order rank is not computed here: each round inverts its
    predecessor's ranks just before it needs them, so a build that
    resolves never pays the last inverse-permutation sort.
    """
    sa_s = out[-1]
    n = sa_s.shape[0]
    j = _iota(n, sa_s.device)
    diff = torch.zeros((max(n - 1, 0),), dtype=torch.bool, device=sa_s.device)
    for ks in out[:-1]:
        diff |= ks[1:] != ks[:-1]
    new_flag = torch.cat(
        [torch.ones((min(n, 1),), dtype=torch.bool, device=sa_s.device), diff])
    rank_s, tied = _heads_and_tied(new_flag, j)
    return sa_s, rank_s, tied.sum()


def _initial_sorted(text, depth: int = 24):
    """`depth`-byte initial sort. Returns (sa_s, rank_s, count_tied)."""
    keys = _pack4_keys(text, depth)
    j = _iota(text.shape[0], text.device)
    out = device_sort(keys + (j,), num_keys=len(keys))
    del keys, j
    return _ranks_sorted_only(out)


def _full_round_sorted(rank, h: int, fan: int = 2):
    """One full-width round from TEXT-order ranks, without the trailing
    inverse permutation. Returns (sa_s, rank_s, count) in sorted order.

    The keys are (rank[i], rank[i+h], .., rank[i+(fan-1)h]), each a
    depth-h class, so one round multiplies the resolved depth by `fan`.
    """
    n = rank.shape[0]
    # k*h can overflow for huge n: cap h at n//k + 1 first, so the
    # product is <= n + k and _shift_ranks clamps the rest
    keys = (rank,) + tuple(
        _shift_ranks(rank, min(h, n // k + 1) * k) for k in range(1, fan)
    )
    out = device_sort(keys + (_iota(n, rank.device),), num_keys=fan)
    del keys
    return _ranks_sorted_only(out)


def _extract(rank_s, sa_s, m: int, method: str = "topk"):
    """Compact the members of all tied groups into capacity-m arrays.

    Returns (g [m], pos [m]): group-head ranks and text positions, sorted
    by g (groups contiguous). Pad slots carry g = INT32_MAX, pos = n.
    "topk" takes the m smallest masked keys, "sort" sorts all of them;
    both give the same groups, in any order inside a group.
    """
    n = rank_s.shape[0]
    j = _iota(n, rank_s.device)
    nxt_head = torch.cat([rank_s[1:], rank_s.new_full((1,), -1)])
    tied = (rank_s != j) | (nxt_head == rank_s)
    key = torch.where(tied, rank_s, _SENT)
    if method == "topk":
        g, idxs = torch.topk(key, m, largest=False, sorted=True)
        pos = torch.where(g == _SENT, n, sa_s[idxs])
        return g, pos
    ks, pos = device_sort((key, sa_s), num_keys=1)
    g = ks[:m]
    pos = torch.where(g == _SENT, n, pos[:m])
    return g, pos


def _compact_round(g, pos, rank, sa, h: int, fan: int = 2):
    """One compacted round over the tied groups only.

    g/pos: [m] group-head ranks + positions (pads g=INT32_MAX, pos=n).
    rank/sa: the full state as [n+1] buffers, updated IN PLACE; slot n
    takes the pads' writes and is never read. Returns
    (g', pos', rank, sa, count) with resolved entries blanked to pads.
    Keys (g, rank[pos+h], .., rank[pos+(fan-1)h]) advance the depth to
    fan*h; every rank in the full array has depth >= h.
    """
    n = rank.shape[0] - 1
    m = g.shape[0]
    dev = g.device
    j = _iota(m, dev)
    shift_keys = []
    for k in range(1, fan):
        # overflow guard as in _full_round_sorted; the past-end test is
        # written as pos >= n - s_k, and the sum pos + s_k is only used
        # where that test failed, so it stays < n
        s_k = min(h, n // k + 1) * k
        past = pos >= n - s_k
        ph = torch.where(past, 0, pos + s_k)
        # past-the-end marker -(pos+1), as in _shift_ranks
        shift_keys.append(torch.where(past, -(pos + 1), rank[ph]))
    out = device_sort((g, *shift_keys, pos), num_keys=fan + 1)
    del shift_keys
    g_s, pos_s = out[0], out[-1]
    ones = torch.ones((min(m, 1),), dtype=torch.bool, device=dev)
    group_f = torch.cat([ones, g_s[1:] != g_s[:-1]])
    kdiff = torch.zeros((max(m - 1, 0),), dtype=torch.bool, device=dev)
    for ks in out[1:-1]:
        kdiff |= ks[1:] != ks[:-1]
    run_f = group_f | torch.cat([ones, kdiff])
    ghead = _segment_heads(group_f, j)
    rhead = _segment_heads(run_f, j)
    valid = g_s != _SENT
    slot = torch.where(valid, g_s + (j - ghead), n)
    new_g = torch.where(valid, g_s + (rhead - ghead), _SENT)
    rank[torch.where(valid, pos_s, n)] = new_g
    sa[slot] = pos_s
    nxt_rhead = torch.cat([rhead[1:], rhead.new_full((1,), -1)])
    tied = valid & ((rhead != j) | (nxt_rhead == rhead))
    g_next = torch.where(tied, new_g, _SENT)
    pos_next = torch.where(tied, pos_s, n)
    return g_next, pos_next, rank, sa, tied.sum()


def _shrink(g, pos, m2: int):
    """Re-compact level arrays into capacity m2 (pads sort last).

    The caller guarantees at most m2 live (non-pad) entries."""
    g2, p2 = device_sort((g, pos), num_keys=2)
    return g2[:m2], p2[:m2]


def _next_h(h: int, n: int, fan: int) -> int:
    return min(min(h, n // fan + 1) * fan, n)


def _refine(sa_s0, rank_s0, count0, h0: int, levels, fan: int,
            extract: str = "auto", adaptive: bool = True,
            want_isa: bool = True):
    """Doubling rounds + cascaded compaction from a sorted initial state.

    Returns (sa, isa), or (sa, sa) when `want_isa` is False and the build
    resolved in the full rounds. The state between full rounds is sorted
    order only; each round inverts its predecessor's ranks first.

    `extract` = "sort" | "topk" | "auto" (top-k for capacities <= n/32).
    `adaptive` extracts straight into the deepest level whose capacity
    holds the live tied count.
    """
    n = sa_s0.shape[0]
    caps = [max(min(n, max(n // d, 64)), 1) for d in levels]
    # non-increasing capacities after the 64-floor clamps
    for i in range(1, len(caps)):
        caps[i] = min(caps[i], caps[i - 1])

    sa_s, rank_s, h, count = sa_s0, rank_s0, h0, int(count0)
    # no `h < n` guard: short suffixes may need the h == n marker round to
    # split, and that round always zeroes the count
    while count > caps[0]:
        rank = _scatter_to_text_order(sa_s, rank_s)  # predecessor's invert
        del sa_s, rank_s
        sa_s, rank_s, count_t = _full_round_sorted(rank, h, fan)
        del rank
        count = int(count_t)
        h = _next_h(h, n, fan)

    if count == 0:
        if want_isa:
            return sa_s, _scatter_to_text_order(sa_s, rank_s)
        return sa_s, sa_s

    # the compact rounds' shifted-key gathers read text-order ranks
    rank = _scatter_to_text_order(sa_s, rank_s)
    rank_buf = torch.cat([rank, rank.new_zeros((1,))])
    del rank
    sa_buf = torch.cat([sa_s, sa_s.new_zeros((1,))])
    # count <= caps[0] here, so the level index is >= 0
    level = 0
    if adaptive and len(caps) > 1:
        level = sum(count <= c for c in caps) - 1
    method = extract
    if method == "auto":
        method = "topk" if caps[level] * 32 <= n else "sort"
    g, pos = _extract(rank_s, sa_s, caps[level], method)
    del sa_s, rank_s

    def run_until(limit, g, pos, h, count):
        while count > limit:
            g, pos, _, _, count_t = _compact_round(g, pos, rank_buf, sa_buf,
                                                   h, fan)
            count = int(count_t)
            h = _next_h(h, n, fan)
        return g, pos, h, count

    for nxt in caps[level + 1:]:
        g, pos, h, count = run_until(nxt, g, pos, h, count)
        g, pos = _shrink(g, pos, nxt)
    run_until(0, g, pos, h, count)
    return sa_buf[:n], rank_buf[:n]


def _prepare(text, idx, depth: int, fan: int, device):
    _check_args(idx, depth, fan)
    return as_text_tensor(text, device)


def build_with_isa(text, idx=_I32, depth: int = 24,
                   levels: tuple = (4, 16, 64, 512), fan: int = 4,
                   extract: str = "auto", adaptive: bool = True,
                   device=None):
    """SA construction that also returns the ISA. Returns (sa, isa), int32
    tensors [n] on the text's device.

    A `depth`-byte initial sort, full rounds while more than n/levels[0]
    positions stay tied, then a cascade of compaction levels with
    capacities n/levels[i]. n must be >= 3 (`sort` handles shorter text).
    """
    text = _prepare(text, idx, depth, fan, device)
    sa_s0, rank_s0, count0 = _initial_sorted(text, depth)
    h0 = min(depth, text.shape[0])
    return _refine(sa_s0, rank_s0, count0, h0, levels, fan, extract,
                   adaptive, want_isa=True)


def build_sa(text, idx=_I32, depth: int = 24,
             levels: tuple = (4, 16, 64, 512), fan: int = 4,
             extract: str = "auto", adaptive: bool = True, device=None):
    """`build_with_isa` without the ISA: skips the final inverse-permutation
    sort when the build resolves in the full rounds. `sort()` uses this."""
    text = _prepare(text, idx, depth, fan, device)
    sa_s0, rank_s0, count0 = _initial_sorted(text, depth)
    h0 = min(depth, text.shape[0])
    sa, _ = _refine(sa_s0, rank_s0, count0, h0, levels, fan, extract,
                    adaptive, want_isa=False)
    return sa


def sort_in_place(text, sa_out: np.ndarray, device=None) -> None:
    """Fill a caller-provided host int32 buffer with the suffix array."""
    np.copyto(sa_out, sort(text, device).sa.cpu().numpy())


def _auto_depth(n: int) -> int:
    """Initial-key depth: 12 bytes at every size, as in the reference."""
    return 12


def sort(text, device=None) -> SuffixArray:
    """Build the suffix array of `text` on `device` (host input: "cuda"
    unless told otherwise; a tensor stays on its device).

    Inputs shorter than 3 bytes take host fast paths.
    """
    arr = as_text_tensor(text, device)
    n = int(arr.shape[0])
    if n >= (1 << 31):
        raise ValueError("text length must be < 2^31 for the i32 index path")
    if n < 2:
        return SuffixArray(arr, torch.zeros((n,), dtype=_I32, device=arr.device))
    if n == 2:
        a, b = arr.tolist()
        # equal first bytes: the shorter suffix (position 1) sorts first
        sa = [0, 1] if a < b else [1, 0]
        return SuffixArray(arr, torch.tensor(sa, dtype=_I32, device=arr.device))
    return SuffixArray(arr, build_sa(arr, depth=_auto_depth(n)))
