"""divsufsort-structured SACA: B*-reduction and data-parallel induction, in
PyTorch.

Counterpart of stringsearch_tpu/engines/bstar.py, phase for phase. Only
the B* suffixes (the last position of each run of type-B suffixes, about
n/3 of them) are sorted, through a reduced-string problem; the order of
every other suffix is induced from them:

  1. classify: segment ends, types and B* flags from one pass;
  2. name the B* substrings T[p_k .. p_{k+1}+2) by one multi-key sort of
     masked packed byte windows with a window-length tiebreak, and
     extension rounds for windows longer than the compared span;
  3. the reduced string's SA (`build_ints_with_isa`) orders the B*;
  4. induce every type-B suffix by one sort of hop keys and refinement
     rounds;
  5. induce every type-A suffix the same way, from the type-B order;
  6. assemble: per-character A and B counts by `searchsorted`, then one
     scatter.

What differs from the JAX package, and why:
  * The loops (`while_loop`) are host loops that read one count a round.
  * The reference compacts the B* positions into a static n//2 + 1
    capacity with pads, because jit needs static shapes; here their
    count m is known after one sync (`nonzero`), and the B* list, the
    reduced string and its solve are m long. The pads changed no real
    entry: they sorted after every real window and before every real
    reduced suffix. So the names, the sorted B* and every later step are
    the reference's; the reduced ISA is the reference's less cap - m (its
    pads took the first cap - m ranks), and only its order is used.
  * The reference's reverse `cummin` (classify) and `cummax` (group heads)
    are a cumsum, a scatter and a gather (`_segment_ends`,
    `_segment_heads`): torch's CUDA scans are generic and slow.
  * Packed window words are int32 with bit 31 flipped, so signed order is
    the reference's uint32 order. The byte mask comes from a table of the
    five masks, never from a shift by 32.
  * Where the reference sorts by a permutation to invert it (a scatter on
    the TPU), this is a scatter; its scatters with mode="drop" write the
    dropped entries to a spare slot.
"""

from __future__ import annotations

import numpy as np
import torch

from stringsearch_torch.core.types import SuffixArray, as_text_tensor
from stringsearch_torch.engines import doubling
from stringsearch_torch.engines.doubling import (
    _BIAS,
    _check_idx,
    _heads_and_tied,
    _iota,
    _segment_heads,
    _sent,
    build_ints_with_isa,
)
from stringsearch_torch.ops.bitonic import device_sort

_I32 = torch.int32

# the reference's defaults, fixed: hop-key pairs of an induce sort; the
# reduced solve's exact depth, pointer-jump levels and fan; window words
# of the first naming sort and of the extension stages' base width
_HOPS = 4
_RED_DEPTH = 6
_RED_FAN = 4
_RED_LEVELS = (4, 32, 256)
_W0_WORDS = 4
_EXT_WORDS = 4


# ---------------------------------------------------------------------------
# 1. classification
# ---------------------------------------------------------------------------


def _segment_ends(flag, j):
    """end[i] = the first slot >= i whose `flag` is set (flag[-1] must be).

    The reference's reverse cummin, as `_segment_heads` computes the
    forward cummax: the flagged slot that closes segment s writes its
    index to entry s, every other slot to a private scratch entry, and
    slot i reads the entry of the segment it lies in, the number of
    flagged slots before it.
    """
    n = j.shape[0]
    closed = torch.cumsum(flag, 0, dtype=j.dtype)
    buf = torch.empty((2 * n,), dtype=j.dtype, device=j.device)
    buf[torch.where(flag, closed - 1, n + j)] = j
    return buf[closed - flag.to(j.dtype)]


def _classify(text, idx=_I32):
    """(seg_end, type_b, bstar), [n] each:
      seg_end[i]: last index of i's maximal equal-byte segment;
      type_b[i]:  suffix(i) < suffix(i+1) (suffix n-1 is type A);
      bstar[i]:   type_b[i] and suffix(i+1) is type A.
    The type of i is decided at the first byte change at or after i.
    """
    n = text.shape[0]
    last = torch.ones((min(n, 1),), dtype=torch.bool, device=text.device)
    change = torch.cat([text[:-1] != text[1:], last])
    rises = torch.cat([text[:-1] < text[1:], ~last])
    seg_end = _segment_ends(change, _iota(n, text.device, idx))
    type_b = rises[seg_end]
    tb_next = torch.cat([type_b[1:], ~last])
    return seg_end, type_b, type_b & change & ~tb_next


# ---------------------------------------------------------------------------
# 2. B* extraction + substring naming
# ---------------------------------------------------------------------------


def _pack_all4(text):
    """word[i] = bytes i..i+3 big-endian, zero past the end, biased."""
    n = text.shape[0]
    t = torch.cat([text.to(_I32), text.new_zeros((4,), dtype=_I32)])
    return ((t[0:n] << 24) | (t[1 : n + 1] << 16) | (t[2 : n + 2] << 8)
            | t[3 : n + 3]) ^ _BIAS


def _extract_bstar(bstar, idx=_I32):
    """The B* positions, ascending (one sync: their count)."""
    return torch.nonzero(bstar).view(-1).to(idx)


# unbiased masks keeping the first 0..4 bytes of a big-endian word
_BYTE_MASKS = (0, -(1 << 24), -(1 << 16), -(1 << 8), -1)


def _window_words(p4, p, wlen, offset: int, nwords: int, n: int):
    """`nwords` masked window words for bytes [offset, offset + 4 nwords)
    of each window, and the capped remaining length, the tiebreak.

    Bytes at or past each window's end are masked to 0; 0 <= any byte, so
    masked-equal and equal capped length <=> equal within this span, and
    the shorter window sorts first.
    """
    masks = torch.tensor(_BYTE_MASKS, dtype=_I32, device=p4.device)
    words = []
    for t in range(nwords):
        off = offset + 4 * t
        w = p4[(p + off).clamp(0, n - 1)]
        mask = masks[(wlen - off).clamp(0, 4)]
        words.append(((w ^ _BIAS) & mask) ^ _BIAS)
    return words, (wlen - offset).clamp(0, 4 * nwords)


def _name_and_rank(text, p):
    """Name the B* substrings: R[k] = head-slot name of the k-th B*
    substring, equal names <=> identical windows. R is the reduced string,
    m = len(p) long, m >= 1."""
    n = text.shape[0]
    m = p.shape[0]
    p4 = _pack_all4(text)
    k = _iota(m, p.device, p.dtype)
    nxt = torch.cat([p[1:], p.new_full((1,), n)])
    wlen = torch.where(nxt < n, nxt + 2 - p, n - p)
    words, lenk = _window_words(p4, p, wlen, 0, _W0_WORDS, n)
    out = device_sort(tuple(words) + (lenk, k), num_keys=_W0_WORDS + 1)
    del words, lenk
    k_s = out[-1]
    first = torch.ones((1,), dtype=torch.bool, device=p.device)

    def heads_and_live(out, span):
        """Group heads of a sorted tuple, and the adjacent pairs equal so
        far of which either window reaches past `span` bytes."""
        eq = torch.ones((m - 1,), dtype=torch.bool, device=p.device)
        for ws in out[:-1]:
            eq &= ws[1:] == ws[:-1]
        head = _segment_heads(torch.cat([first, ~eq]), k)
        capped = wlen[out[-1]] > span
        live = int((eq & (capped[1:] | capped[:-1])).sum())
        return head, live

    offset = 4 * _W0_WORDS
    head, live = heads_and_live(out, offset)
    del out
    # extension rounds at widths 1x/2x/4x of at most one round each, then
    # 8x until resolved: few rounds on long common prefixes, a bounded
    # number of planes a sort. A group with any unresolved pair extends
    # as a whole.
    for ext_w, rounds in ((_EXT_WORDS, 1), (2 * _EXT_WORDS, 1),
                          (4 * _EXT_WORDS, 1), (8 * _EXT_WORDS, None)):
        done = 0
        while live > 0 and (rounds is None or done < rounds):
            words, lenk = _window_words(p4, p[k_s], wlen[k_s], offset, ext_w,
                                        n)
            out = device_sort((head, *words, lenk, k_s),
                              num_keys=1 + ext_w + 1)
            del words, lenk
            k_s = out[-1]
            offset += 4 * ext_w
            head, live = heads_and_live(out, offset)
            del out
            done += 1
    # names back to B* order (k_s is a permutation of 0..m-1)
    name = torch.empty_like(head)
    name[k_s] = head
    return name


# ---------------------------------------------------------------------------
# 4./5. induced phases
# ---------------------------------------------------------------------------


def _induce(elem_sel, w1, w2, nxt_arr, hops: int):
    """Order the selected suffixes by hop keys and doubling refinement.

    elem_sel: bool[n], which positions take part;
    w1/w2:    the hop word pair of each position ([n+1], slot n a
              sentinel);
    nxt_arr:  the hop target of each position ([n+1]; a fixed point at
              terminals and at slot n).

    Returns (pos_sorted, rank_pos, nsel): pos_sorted[j] = position of the
    j-th smallest selected suffix (the unselected positions after them),
    rank_pos[i] = head-slot rank of position i among the selected
    (meaningless at unselected positions), nsel = their count.

    After the hop-key sort the ranks are exact classes of the first
    `hops` hops; a round sorts the tied entries by the continuation at
    their jump target, doubling the exact depth. A target that is still
    selected continues with its current rank, a terminal (unselected, or
    the off-end slot) with its exact (w1, w2) pair; the leading w1 keeps
    the two scales apart. Jumps freeze at terminals.
    """
    n = elem_sel.shape[0]
    dtype = w1.dtype
    dev = w1.device
    j = _iota(n, dev, dtype)
    cur = torch.where(elem_sel, j, n)
    # (w1, w2, nxt) as the columns of one table: one row gather a hop
    static_tbl = torch.stack([w1, w2, nxt_arr], dim=1)  # [n+1, 3]
    keys = []
    for _ in range(hops):
        g = static_tbl.index_select(0, cur)
        keys += [g[:, 0], g[:, 1]]
        cur = g[:, 2]
    del static_tbl, g
    # unselected elements sort last
    keys[0] = torch.where(elem_sel, keys[0], _sent(dtype))
    out = device_sort((*keys, cur, j), num_keys=len(keys))
    del keys, cur
    jump_s, pos_s = out[-2], out[-1]
    nsel = int(elem_sel.sum())
    first = torch.ones((min(n, 1),), dtype=torch.bool, device=dev)

    def rank_and_count(out, nkeys):
        eq = torch.ones((max(n - 1, 0),), dtype=torch.bool, device=dev)
        for ks in out[:nkeys]:
            eq &= ks[1:] == ks[:-1]
        rank_s, tied = _heads_and_tied(torch.cat([first, ~eq]), j)
        return rank_s, int((tied & (j < nsel)).sum())

    rank_s, count = rank_and_count(out, len(out) - 2)
    del out
    # [n+1, 5]: (w1, w2, selected, rank_pos, jump_pos); slot n is not
    # selected, so its last two columns are never read
    tbl = torch.zeros((n + 1, 5), dtype=dtype, device=dev)
    tbl[:, 0] = w1
    tbl[:, 1] = w2
    tbl[:n, 2] = elem_sel.to(dtype)
    while count > 0:
        # position-indexed rank and jump (pos_s is a permutation)
        tbl[pos_s, 3] = rank_s
        tbl[pos_s, 4] = jump_s
        g = tbl.index_select(0, jump_s)
        jsel = g[:, 2] != 0
        k2 = torch.where(jsel, g[:, 3], g[:, 1])
        # the doubled jump, frozen at terminals
        jump2 = torch.where(jsel, g[:, 4], jump_s)
        out = device_sort((rank_s, g[:, 0], k2, jump2, pos_s), num_keys=3)
        del g, jsel, k2, jump2
        jump_s, pos_s = out[-2], out[-1]
        rank_s, count = rank_and_count(out, 3)
        del out
    rank_pos = torch.empty_like(rank_s)
    rank_pos[pos_s] = rank_s
    return pos_s, rank_pos, nsel


# ---------------------------------------------------------------------------
# full build
# ---------------------------------------------------------------------------


def build(text, idx=_I32, device=None):
    """B*-reduction SA construction. Returns (sa, isa) of dtype `idx`, [n]
    each, on the text's device (host input: "cuda" unless told
    otherwise)."""
    _check_idx(idx)
    text = as_text_tensor(text, device)
    n = text.shape[0]
    if n < 3:
        raise ValueError("build requires n >= 3 (host fast paths cover less)")
    dev = text.device
    big = _sent(idx)
    j = _iota(n, dev, idx)
    seg_end, type_b, bstar = _classify(text, idx)
    seg_len = seg_end - j + 1
    char = text.to(idx)

    # --- sorted B* via the reduced problem -------------------------------
    # the rank of each B* among the B* (its reduced ISA), spread to text
    # positions; -1 elsewhere
    p = _extract_bstar(bstar, idx)
    del bstar
    bsr_pos = torch.full((n,), -1, dtype=idx, device=dev)
    if p.shape[0]:
        red = _name_and_rank(text, p)
        _sa_red, isa_red = build_ints_with_isa(
            red, idx, depth=_RED_DEPTH, levels=_RED_LEVELS, fan=_RED_FAN)
        bsr_pos[p] = isa_red
        del red, _sa_red, isa_red
    del p

    def column(values, slot_n):
        return torch.cat([values, values.new_full((1,), slot_n)])

    # --- induce all type-B suffixes --------------------------------------
    # B positions: (2c+1, -seg_len); A positions (terminals): (2c, the B*
    # rank of i-1); slot n: sentinel. At equal char an A-type suffix
    # precedes every B-type one, which the parity of w1 encodes.
    bsr_prev = torch.cat([bsr_pos.new_full((1,), -1), bsr_pos[:-1]])
    del bsr_pos
    w1 = torch.where(type_b, 2 * char + 1, 2 * char)
    bpos_s, brank_pos, n_b = _induce(
        type_b, column(w1, big),
        column(torch.where(type_b, -seg_len, bsr_prev), 0),
        column(torch.where(type_b, seg_end + 1, j), n), _HOPS)
    del bsr_prev

    # --- induce all type-A suffixes --------------------------------------
    # A positions: (2c, +seg_len); B positions (terminals): (2c+1, induced
    # B rank); off-end: (-1, 0), an ended suffix first
    apos_s, _arank_pos, n_a = _induce(
        ~type_b, column(w1, -1),
        column(torch.where(type_b, brank_pos, seg_len), 0),
        column(torch.where(type_b, j, (seg_end + 1).clamp(max=n)), n),
        _HOPS)
    del w1, brank_pos, _arank_pos, seg_end, seg_len, type_b

    # --- assemble: per char the A part, then the B part ------------------
    ach = torch.where(j < n_a, char[apos_s], 256)
    bch = torch.where(j < n_b, char[bpos_s], 256)
    probes = torch.arange(257, dtype=idx, device=dev)
    astart = torch.searchsorted(ach, probes).to(idx)
    bstart = torch.searchsorted(bch, probes).to(idx)
    count_a = astart[1:] - astart[:-1]  # [256]
    count_b = bstart[1:] - bstart[:-1]
    charstart = torch.cat([count_a.new_zeros((1,)),
                           torch.cumsum(count_a + count_b, 0,
                                        dtype=idx)[:-1]])
    # char 256 marks a pad: it reads clamped entries and lands in slot n
    slot_a = torch.where(
        j < n_a, charstart[ach.clamp(max=255)] + (j - astart[ach]), n)
    slot_b = torch.where(
        j < n_b,
        charstart[bch.clamp(max=255)] + count_a[bch.clamp(max=255)]
        + (j - bstart[bch]), n)
    sa = torch.zeros((n + 1,), dtype=idx, device=dev)
    sa[slot_a] = apos_s
    sa[slot_b] = bpos_s
    sa = sa[:n]
    isa = torch.zeros((n,), dtype=idx, device=dev)
    isa[sa] = j
    return sa, isa


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def sort(text, device=None) -> SuffixArray:
    """Build the suffix array of `text` with the B*-reduction engine on
    `device` (host input: "cuda" unless told otherwise)."""
    arr = as_text_tensor(text, device)
    n = int(arr.shape[0])
    if n >= (1 << 31):
        raise ValueError("text length must be < 2^31 for the i32 index path")
    if n < 3:
        return doubling.sort(arr)
    sa, _isa = build(arr)
    return SuffixArray(arr, sa)


def sort_in_place(text, sa_out: np.ndarray, device=None) -> None:
    """Fill a caller-provided host int32 buffer with the suffix array."""
    np.copyto(sa_out, sort(text, device).sa.cpu().numpy())


def sort_traced(text, tracer, device=None) -> SuffixArray:
    """Traced build: the classification counts, the B* positions, their
    names, the sorted B* and the final SA, with the reference's labels,
    so the two packages' traces of one input are one text."""
    arr = as_text_tensor(text, device)
    n = int(arr.shape[0])
    tracer.log(f"bstar engine n={n}")
    if n < 3:
        sa = sort(arr)
        tracer.dump("SA final", sa.sa)
        tracer.flush()
        return sa
    _seg_end, type_b, bstar = _classify(arr)
    tracer.log(f"classify: B={int(type_b.sum())} B*={int(bstar.sum())} "
               f"of {n}")
    p = _extract_bstar(bstar)
    tracer.dump("B* positions", p)
    if p.shape[0]:
        red = _name_and_rank(arr, p)
        sa_red, _isa_red = build_ints_with_isa(
            red, depth=_RED_DEPTH, levels=_RED_LEVELS, fan=_RED_FAN)
        tracer.dump("B* substring names", red)
        tracer.dump("sorted B* suffixes", p[sa_red])
    else:
        tracer.dump("B* substring names", p)
        tracer.dump("sorted B* suffixes", p)
    sa, _isa = build(arr)
    tracer.dump("SA final", sa)
    tracer.flush()
    return SuffixArray(arr, sa)
