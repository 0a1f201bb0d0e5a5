"""Exact global suffix array over a sharded text — distributed doubling.

Counterpart of stringsearch_tpu/parallel/global_sa.py, the JAX package's
answer to the reference's `sacapart`, which only builds independent
per-partition SAs. Here the text lives sharded over the mesh's "parts"
axis and the build produces the exact suffix array OF THE WHOLE TEXT;
shard s ends up holding SA[s*L:(s+1)*L] of the global sorted order, and
no shard ever holds the whole text or SA during the build. The batched
queries offer two text modes: "replicated" (every shard reads a full copy
of the padded text) and "sharded" (every binary-search probe fetches its
windows with the distributed gather of parallel/gather.py, so no shard
holds more than text/P).

The algorithm is the JAX package's, step for step:

  initial ranks: `depth` raw text bytes packed into depth/4 keys per
  position (the window past a shard's end comes from ONE neighbour
  ppermute) and one global sort;

  per round (h per round; the depth multiplies by `fan`, default 3):
    1. rank_h[i] = rank[i+h] from at most two neighbour shards; past the
       end the marker -(i+1), negative and strictly decreasing, which
       repairs the raw-byte zero pad's conflation of "ended" with 0x00;
    2. a global sort by (rank, rank_h.., gidx) routed by head-slot rank
       (distsort.rank_interval_sort; merge-split on overflow);
    3. new head-slot ranks from neighbour diffs with the boundary value
       shifted in, a local running max of head slots (on CUDA one launch
       of the head-ranks scan a shard) and an all-gathered cross-shard
       carry;
    4. ranks back to text order by the permutation redistribute.

  Rounds go in blocks of ROUNDS_PER_DISPATCH; once the tied population
  fits the compacted capacity with headroom, rounds refine only the tied
  slots (`_compact_round`), falling back to a full round on any capacity
  overflow.

Zero padding to P*L keeps every shape static: pad suffixes sort strictly
before the real suffix with the same content, so they occupy the first
`pad` slots of the sorted order and are dropped from the final SA.

What differs from the JAX package, and why:
  * A sharded array is a list of per-shard tensors (`collectives.py`);
    one process drives every shard, whose device may repeat, or, on a mesh
    across processes (`parallel/multihost.py`), each process drives its
    own shards and a list holds None for the others. Every process takes
    the whole text, places only its own shards, and reads every host
    decision (the tied count, the fast-path flags, the compaction switch)
    from a reduction every process holds equally.
  * `lax.cond` becomes a host branch on a replicated value, one sync each:
    the skip of a round once the build has resolved (the tied count of
    the round before, read once a round), the fast path or fallback of
    every distributed sort and of a compacted round (which reads all its
    overflow flags at once, before it writes anything).
  * The neighbour diff and `lax.cummax` of head slots after a sort are
    one `ops/steps.py:shard_head_ranks` a shard (on CUDA the head-ranks
    kernel; on the CPU the eager chain); in a compacted round `lax.cummax`
    is `last_flagged` (a cumsum, a scatter and a gather).
  * The jitted query programs (`_jit_query`, `_jit_search`) are the query
    methods themselves: every shard's binary search is a generator of
    core/search.py, all driven in lock step (`run_in_lockstep`), so the
    sharded text mode's window fetch is one collective per probe for all
    shards at once (`_windows`); nothing is compiled or cached.
  * Packed text keys are int32 with bit 31 flipped (`^ 0x80000000`), so
    signed order is the JAX package's uint32 order.
  * `idx=torch.int64` makes positions, ranks and the SA int64; on CUDA it
    holds for n < 2^31 (the radix sort's int32 n), where it changes the
    index dtype and not the reach.
  * `rounds_run` and `compact_rounds_run` count as the JAX package counts
    them: every round of a dispatched block, also the ones skipped.
  * Where a sort's keys tie (the initial sort orders equal key windows
    in any order), intermediate positions may differ from JAX's inside a
    tie; the ranks, the final SA and every answer are the same.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stringsearch_torch.core import compare as cmp
from stringsearch_torch.core.types import BytesLike, as_text_tensor
from stringsearch_torch.ops.bitonic import device_sort
from stringsearch_torch.ops.steps import last_flagged, shard_head_ranks
from stringsearch_torch.parallel import collectives as coll
from stringsearch_torch.parallel.distsort import (
    host_flag,
    rank_interval_sort,
    redistribute_permutation,
    sharded_sort,
    shift_in_from_prev,
)
from stringsearch_torch.parallel.gather import (
    sharded_gather_capped,
    sharded_gather_windows,
)
from stringsearch_torch.parallel.multihost import gather_to_host

_I32 = torch.int32
_IDX = (torch.int32, torch.int64)
_AXIS = "parts"
# XOR with INT32_MIN flips bit 31: maps uint32 order onto int32 order
_BIAS = torch.iinfo(torch.int32).min

#: doubling rounds per block (the host reads the tied count once a
#: round, so a block only fixes what rounds_run counts)
ROUNDS_PER_DISPATCH = 4

#: default initial-key depth in text bytes (a multiple of 4; clamped down
#: for tiny chunks)
INITIAL_DEPTH = 16

#: compacted rounds that fell back to a full-width round, in this process
compact_fallbacks = 0


def _global_iota(me: int, chunk_len: int, idx, device) -> torch.Tensor:
    return me * chunk_len + torch.arange(chunk_len, dtype=idx, device=device)


def _gmin(xs) -> list:
    """Cross-shard min of a scalar, on every shard."""
    return coll.pmin(xs)


def _shift_in_from_next(x_first, fill) -> list:
    """The next shard's first value(s), with `fill` on the last shard."""
    p = len(x_first)
    nxt = coll.ppermute(list(x_first), [(i, (i - 1) % p) for i in range(p)],
                        boundary=True)
    if nxt[-1] is not None:
        nxt[-1] = torch.full_like(nxt[-1], fill)
    return nxt


def _sorted_head_ranks(keys_s, fill, idx, first_head: bool):
    """Global HEAD-SLOT rank of each sorted element, and the tied count.

    The head-slot rank is the global sorted slot of the element's tie
    group's FIRST member: order-isomorphic to a dense rank, equal to the
    final ISA once every group is a singleton, and what the rank-interval
    sort's routing needs. `keys_s` (per key, per shard [L]) is the sorted
    order's key planes: an element starts a group where its keys differ
    from its global predecessor's (the boundary value shifted in from the
    previous shard, `fill` on shard 0; the global first element always,
    where `first_head`, since the fill could collide with a real key).
    Returns (rank [per shard], count [replicated]): the number of tied
    SLOTS (a slot is tied iff it is not its own head or the next slot
    shares its head); 0 iff resolved.

    One `shard_head_ranks` a shard (on CUDA one launch of the head-ranks
    scan) gives its local heads as global slots, -1 before its first head,
    and its tied count but for its last slot. A shard whose first elements
    continue an earlier shard's group takes its carry from an all-gather
    of every shard's last local head (a headless shard contributes -1):
    the carry is below every head of the shard, so a max sets the prefix.
    The last slot is tied through the boundary when it heads its group and
    the next shard's first rank is the same.
    """
    p = len(keys_s[0])
    length = coll.first_local(keys_s[0]).shape[0]
    prev = shift_in_from_prev(coll.each(keys_s[0], lambda me: torch.stack(
        [ks[me][-1] for ks in keys_s])), fill)
    heads, counts = [None] * p, [None] * p
    for me in coll.local_parts(keys_s[0]):
        heads[me], counts[me] = shard_head_ranks(
            [ks[me] for ks in keys_s],
            None if first_head and me == 0 else prev[me], me * length, idx)
    del prev
    lasts = coll.all_gather(coll.each(heads, lambda me: heads[me][-1]))

    def ranked(me):
        mask = torch.arange(p, device=lasts[me].device) < me
        carry = torch.where(mask, lasts[me], -1).amax()
        return torch.maximum(heads[me], carry, out=heads[me])

    rank = coll.each(heads, ranked)
    del heads
    nf = _shift_in_from_next(coll.each(rank, lambda me: rank[me][:1]), -1)

    def tied_count(me):
        last = rank[me][-1]
        edge = (last == (me + 1) * length - 1) & (nf[me][0] == last)
        return (counts[me] + edge).to(_I32)

    return rank, coll.psum(coll.each(rank, tied_count))


def _initial_operands(depth: int, idx, chunks) -> tuple:
    """The initial sort's operands, shard-wise: depth/4 packed key words
    (int32, bit 31 flipped) of the first `depth` raw bytes, and the global
    position.

    The window past a shard's end is the next shard's first `depth` bytes
    (one ppermute); past the LAST shard it is zero-filled — the raw-byte
    conflation that the rounds' marker protocol repairs.
    """
    p = len(chunks)
    length = coll.first_local(chunks).shape[0]
    nxt = coll.ppermute(coll.each(chunks, lambda me: chunks[me][:depth]),
                        [(i, (i - 1) % p) for i in range(p)])
    if nxt[-1] is not None:
        nxt[-1] = torch.zeros_like(nxt[-1])
    nk = depth // 4
    keys = [[None] * p for _ in range(nk)]
    gidx = [None] * p
    for me in coll.local_parts(chunks):
        ext = torch.cat([chunks[me], nxt[me]]).to(_I32)  # [L + depth]
        for k in range(nk):
            o = 4 * k
            keys[k][me] = (((ext[o:o + length] << 24)
                            | (ext[o + 1:o + 1 + length] << 16)
                            | (ext[o + 2:o + 2 + length] << 8)
                            | ext[o + 3:o + 3 + length]) ^ _BIAS)
        gidx[me] = _global_iota(me, length, idx, chunks[me].device)
    return tuple(keys) + (gidx,)


def _initial_shard_ranks(depth: int, idx, chunks):
    """Ranks by the first `depth` raw bytes (packed keys), shard-wise: one
    global sort of `_initial_operands`. Returns (rank, sa, rank_s,
    count)."""
    nk = depth // 4
    out = sharded_sort(_initial_operands(depth, idx, chunks), num_keys=nk)
    keys_s, gidx_s = out[:nk], out[-1]
    del out
    rank_s, count = _sorted_head_ranks(keys_s, 0, idx, first_head=True)
    del keys_s
    # back to text order: gidx_s is a permutation, so one all_to_all
    (rank,) = redistribute_permutation(gidx_s, (rank_s,))
    return rank, gidx_s, rank_s, count


def _shifted_ranks(rank, h: int, idx) -> list:
    """rank_h[i] = rank[global i + h]; the marker -(i+1) past the end.

    The marker is negative (ended suffixes sort before every continuing
    one) and strictly decreasing in global i, so ties among ended suffixes
    split at once, shortest first.
    """
    p = len(rank)
    length = coll.first_local(rank).shape[0]
    d, r = divmod(h, length)

    def from_offset(delta):
        if delta >= p:
            return coll.each(rank, lambda me: torch.full_like(rank[me], -1))
        # shard i reads shard i + delta; delta 0 is this shard's own
        src = (list(rank) if delta == 0 else coll.ppermute(
            rank, [(i, i - delta) for i in range(delta, p)]))
        return coll.each(src, lambda me: src[me] if me + delta < p
                         else torch.full_like(src[me], -1))

    if r == 0:
        shifted = from_offset(d)
    else:
        a = from_offset(d)      # provides positions [r, L) of the window
        b = from_offset(d + 1)  # provides positions [0, r)
        shifted = coll.each(a, lambda me: torch.cat([a[me][r:],
                                                     b[me][:r]]))
        del a, b
    n_pad = length * p

    def shifted_or_marker(me):
        gidx = _global_iota(me, length, idx, rank[me].device)
        if h < n_pad:
            return torch.where(gidx < n_pad - h, shifted[me], -(gidx + 1))
        return -(gidx + 1)

    return coll.each(rank, shifted_or_marker)


def _doubling_step(chunk_len: int, total_shards: int, idx, h: int, rank,
                   fan: int = 2):
    """One distributed round. Returns (rank, sa, rank_s, count).

    Sort keys (rank[i], rank[i+h], .., rank[i+(fan-1)h]), each a depth-h
    class, so one round multiplies the resolved depth by `fan`.
    """
    n_pad = chunk_len * total_shards
    shifts = [_shifted_ranks(rank, min(k * h, n_pad), idx)
              for k in range(1, fan)]
    gidx = coll.each(rank, lambda me: _global_iota(me, chunk_len, idx,
                                                   rank[me].device))
    # head-slot primary key: the interval-routed sort (merge-split on
    # adversarial rank skew)
    out = rank_interval_sort((rank, *shifts, gidx), num_keys=fan + 1)
    del shifts, gidx
    keys_s, sa_s = out[:fan], out[-1]
    del out
    rank_s, count = _sorted_head_ranks(keys_s, -2, idx, first_head=False)
    del keys_s
    # ranks back to text order: sa_s is a permutation
    (rank,) = redistribute_permutation(sa_s, (rank_s,))
    return rank, sa_s, rank_s, count


def _rounds_block(chunk_len: int, total_shards: int, idx, hs: tuple,
                  fan: int, rank, sa, rank_s, tied: int):
    """ROUNDS_PER_DISPATCH guarded rounds: a round runs only while the
    tied count (a host int, read once a round) is not zero. Returns
    (rank, sa, rank_s, tied, rounds that ran)."""
    ran = 0
    for h in hs:
        if tied == 0:
            continue
        rank, sa, rank_s, count = _doubling_step(chunk_len, total_shards,
                                                 idx, h, rank, fan)
        tied = int(coll.first_local(count))
        ran += 1
    return rank, sa, rank_s, tied, ran


#: per-shard compacted capacity divisor: M = chunk // _COMPACT_DIV
_COMPACT_DIV = 4
#: enter the compacted phase when the global tied count <= n_pad / this
_COMPACT_ENTRY = 8


def _scatter_into(base: torch.Tensor, where: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """A copy of `base` [L] with vals written at `where`; index L is the
    drop slot (the JAX scatter's mode="drop")."""
    buf = torch.cat([base, base.new_zeros((1,))])
    buf[where] = vals.to(buf.dtype)
    return buf[:base.shape[0]]


def _compact_round(chunk_len: int, total_shards: int, idx, fan: int,
                   m_cap: int, h: int, rank, sa, rank_s):
    """One COMPACTED distributed round — refine only the tied slots.

    Each shard extracts the tied slots resident in its slice of the sorted
    order (at most m_cap), reunites boundary-straddling groups on their
    head's shard with one neighbour ppermute, and refines them with LOCAL
    sorts; the only full-width traffic left is the shifted-key gather and
    the text-order rank write-back, balanced all_to_alls at 2*ceil(2M/P)
    per-pair capacity. Locality invariants (no extraction overflow means
    every tied group spans at most 2 shards; after the straddle ppermute
    every working entry's group head lies in this shard's interval; slots
    of refined entries exceed the shard's range by < 2M <= L, so write-backs
    spill to the NEXT shard only) make the sorts and head arithmetic local.

    Every capacity violation (extraction > M, gather or write-back skew >
    cap) sets a replicated flag, read once before any write, and the round
    falls back to the always-correct full-width `_doubling_step`.

    Returns (rank, sa, rank_s, count).
    """
    global compact_fallbacks
    p = total_shards
    length = chunk_len
    n_pad = length * p
    big = torch.iinfo(idx).max
    perm_from_next = [(i, (i - 1) % p) for i in range(p)]
    perm_to_next = [(i, (i + 1) % p) for i in range(p)]
    mine = coll.local_parts(rank)
    devs = coll.each(rank, lambda me: rank[me].device)
    gslot = coll.each(rank, lambda me: _global_iota(me, length, idx,
                                                    devs[me]))

    # 1. tied flags in sorted order (local + one boundary ppermute)
    nf = _shift_in_from_next(coll.each(rank_s, lambda me: rank_s[me][:1]),
                             -1)
    # 2. local extraction at capacity M (sorted by group id g = rank_s)
    g0, pos0, over = [None] * p, [None] * p, [None] * p
    for me in mine:
        rank_s_next = torch.cat([rank_s[me][1:], nf[me]])
        tied = (rank_s[me] != gslot[me]) | (rank_s_next == rank_s[me])
        key_srt, pos_srt = device_sort(
            (torch.where(tied, rank_s[me], big), sa[me]), 1)
        over[me] = ((m_cap < length)
                    & (key_srt[min(m_cap, length - 1)] != big)).to(_I32)
        g0[me] = key_srt[:m_cap]
        pos0[me] = pos_srt[:m_cap]
        del key_srt, pos_srt
    over = coll.psum(over)
    over = coll.each(over, lambda me: over[me] > 0)

    # 3. straddle repair: entries whose group head lives on the PREVIOUS
    # shard (g < me*L, a prefix of the g-sorted extraction) ship there
    pre = coll.each(g0, lambda me: g0[me] < me * length)
    g_in = coll.ppermute(g0, perm_from_next)
    pos_in = coll.ppermute(pos0, perm_from_next)
    cnt_in = _shift_in_from_next(coll.each(pre, lambda me: pre[me].sum(
        dtype=_I32)), 0)
    gw, pw = [None] * p, [None] * p
    for me in mine:
        rv = torch.arange(m_cap, device=devs[me]) < cnt_in[me]
        gw[me] = torch.cat([torch.where(pre[me], big, g0[me]),
                            torch.where(rv, g_in[me], big)])
        pw[me] = torch.cat([torch.where(pre[me], n_pad, pos0[me]),
                            torch.where(rv, pos_in[me], n_pad)])
    del g0, pos0, pre, g_in, pos_in

    # 4. shifted keys: balanced capped gather on the sharded text-order
    # rank (markers for windows past the end, as everywhere)
    cap = 2 * (-(-2 * m_cap // p))
    shifts = []
    for k in range(1, fan):
        s_k = min(h, n_pad // k + 1) * k
        past = coll.each(pw, lambda me: pw[me] >= n_pad - s_k)
        req = coll.each(pw, lambda me: torch.where(
            past[me], 0, pw[me] + s_k).to(_I32))
        val, ov = sharded_gather_capped(rank, req, cap)
        shifts.append(coll.each(pw, lambda me: torch.where(
            past[me], -(pw[me] + 1), val[me].to(idx))))
        over = coll.each(over, lambda me: over[me] | ov[me])

    # 5. LOCAL refinement sort over the [2M] working set
    work, count = [None] * p, [None] * p
    for me in mine:
        out = device_sort((gw[me], *(s[me] for s in shifts), pw[me]),
                          fan + 1)
        g_s2, pos_s2 = out[0], out[-1]
        j2 = torch.arange(2 * m_cap, dtype=idx, device=devs[me])
        one = torch.ones((1,), dtype=torch.bool, device=devs[me])
        group_f = torch.cat([one, g_s2[1:] != g_s2[:-1]])
        kdiff = torch.zeros((2 * m_cap - 1,), dtype=torch.bool,
                            device=devs[me])
        for ks in out[1:-1]:
            kdiff |= ks[1:] != ks[:-1]
        run_f = group_f | torch.cat([one, kdiff])
        ghead = last_flagged(group_f, j2)
        rhead = last_flagged(run_f, j2)
        valid = g_s2 != big
        slot = torch.where(valid, g_s2 + (j2 - ghead), n_pad)
        new_g = torch.where(valid, g_s2 + (rhead - ghead), big)
        nxt_rhead = torch.cat([rhead[1:], rhead.new_full((1,), -1)])
        tied2 = valid & ((rhead != j2) | (nxt_rhead == rhead))
        count[me] = tied2.sum(dtype=_I32)
        # the text-order write-back's routing (7b), sorted by destination
        dest = torch.where(valid, torch.div(pos_s2, length,
                                            rounding_mode="floor"),
                           p).to(_I32)
        d_s, po_s, ng_s = device_sort((dest, pos_s2, new_g), 1)
        rnk = (torch.arange(2 * m_cap, device=devs[me])
               - torch.searchsorted(d_s, d_s, side="left"))
        work[me] = (slot, pos_s2, new_g, valid, d_s, po_s, ng_s, rnk)
        del out
    del gw, pw, shifts
    count = coll.psum(count)
    wb_over = coll.psum(coll.each(work, lambda me: (
        (work[me][4] < p) & (work[me][7] >= cap)).any().to(_I32)))
    if host_flag(coll.each(over, lambda me: over[me] | (wb_over[me] > 0))):
        compact_fallbacks += 1
        del work
        return _doubling_step(chunk_len, total_shards, idx, h, rank, fan)

    # 7a. SA and sorted-rank write-back by slot: a local scatter and one
    # next-neighbour ppermute for the spill (slot < (me+2)L)
    sa_new, rank_s_new, spill = [None] * p, [None] * p, [None] * p
    for me in mine:
        slot, pos_s2, new_g, valid, *_rest = work[me]
        loc = slot - me * length
        in_loc = valid & (loc >= 0) & (loc < length)
        drop_i = torch.where(in_loc, loc, length)
        sa_new[me] = _scatter_into(sa[me], drop_i, pos_s2)
        rank_s_new[me] = _scatter_into(rank_s[me], drop_i, new_g)
        spill[me] = torch.where(valid & (loc >= length), slot, n_pad)
    sp1 = coll.ppermute(spill, perm_to_next)
    sp2 = coll.ppermute(coll.each(work, lambda me: work[me][1]),
                        perm_to_next)
    sp3 = coll.ppermute(coll.each(work, lambda me: work[me][2]),
                        perm_to_next)
    if sp1[0] is not None:
        sp1[0] = torch.full_like(sp1[0], n_pad)  # shard 0 receives nothing
    for me in mine:
        loc2 = sp1[me] - me * length
        drop2 = torch.where((loc2 >= 0) & (loc2 < length), loc2, length)
        sa_new[me] = _scatter_into(sa_new[me], drop2, sp2[me])
        rank_s_new[me] = _scatter_into(rank_s_new[me], drop2, sp3[me])
    del spill, sp1, sp2, sp3

    # 7b. text-order rank write-back: balanced all_to_all scatter (row p
    # of the send buffers is the drop row)
    send_po, send_ng = [None] * p, [None] * p
    for me in mine:
        *_head, d_s, po_s, ng_s, rnk = work[me]
        use = (d_s < p) & (rnk < cap)
        row = torch.where(use, d_s, p)
        col = rnk.clamp(max=cap - 1)
        po = torch.full((p + 1, cap), n_pad, dtype=idx, device=devs[me])
        po[row, col] = po_s
        ng = torch.zeros((p + 1, cap), dtype=idx, device=devs[me])
        ng[row, col] = ng_s
        send_po[me] = po[:p]
        send_ng[me] = ng[:p]
    del work
    recv_po = coll.all_to_all(send_po)
    recv_ng = coll.all_to_all(send_ng)
    del send_po, send_ng

    def written_back(me):
        locp = recv_po[me].reshape(-1) - me * length
        inp = (locp >= 0) & (locp < length)
        return _scatter_into(rank[me], torch.where(inp, locp, length),
                             recv_ng[me].reshape(-1))

    return coll.each(rank, written_back), sa_new, rank_s_new, count


def _compact_block(chunk_len: int, total_shards: int, idx, fan: int,
                   m_cap: int, hs: tuple, rank, sa, rank_s, tied: int):
    """ROUNDS_PER_DISPATCH guarded COMPACTED rounds. Returns (rank, sa,
    rank_s, tied, rounds that ran)."""
    ran = 0
    for h in hs:
        if tied == 0:
            continue
        rank, sa, rank_s, count = _compact_round(
            chunk_len, total_shards, idx, fan, m_cap, h, rank, sa, rank_s)
        tied = int(coll.first_local(count))
        ran += 1
    return rank, sa, rank_s, tied, ran


def _verify_shard(chunk_len: int, idx, text_chunks, rank_chunks,
                  sa_chunks):
    """Distributed ISA-recurrence verify.

    With rank = the claimed ISA in text order, the SA is valid iff
      (1) rank is a permutation of [0, n_pad), and
      (2) the key (T[i], rank(i+1)) strictly increases when positions are
          ordered by rank (rank(n_pad) = -1: the empty suffix first).
    Both reduce to ONE distributed 1-key sort by rank carrying (first
    byte, next rank, position): sorted ranks must equal the global iota,
    adjacent payload keys must strictly increase (boundary via one
    ppermute), and the position payload must reproduce the stored SA
    shards. No shard ever holds a full array.

    Returns (ok, bad, kind), replicated: bad is the smallest failing
    global sorted-order slot (n_pad when ok); kind 0 = not a permutation,
    1 = SA is not rank's inverse, 2 = an adjacency violation or none.
    """
    p = len(rank_chunks)
    n_pad = chunk_len * p
    ranks = list(rank_chunks)
    gidx = coll.each(ranks, lambda me: _global_iota(me, chunk_len, idx,
                                                    ranks[me].device))
    # rank(i+1): local shift; the boundary value is the next shard's first
    # rank; the global last position gets -1
    nxt_first = _shift_in_from_next(coll.each(ranks, lambda me: ranks[me][
        :1]), -1)
    rank_next = coll.each(ranks, lambda me: torch.cat([ranks[me][1:],
                                                      nxt_first[me]]))
    first = coll.each(ranks, lambda me: text_chunks[me].to(idx))
    r_s, fb_s, rn_s, pos_s = sharded_sort(
        (ranks, first, rank_next, gidx), num_keys=1)
    prev = shift_in_from_prev(coll.each(fb_s, lambda me: torch.stack(
        [fb_s[me][-1], rn_s[me][-1]])), -1)
    bad_local, ok_local, kind_local = [None] * p, [None] * p, [None] * p
    for me in coll.local_parts(ranks):
        perm_ok = (r_s[me] == gidx[me]).all()
        sa_ok = (pos_s[me] == sa_chunks[me]).all()
        fb_p = torch.cat([prev[me][:1], fb_s[me][:-1]])
        rn_p = torch.cat([prev[me][1:2], rn_s[me][:-1]])
        adj_ok = (fb_p < fb_s[me]) | ((fb_p == fb_s[me]) & (rn_p < rn_s[me]))
        adj_ok = adj_ok | (gidx[me] == 0)  # the global first slot
        bad_local[me] = torch.where(adj_ok, n_pad, gidx[me]).amin()
        ok_local[me] = (perm_ok & sa_ok & adj_ok.all()).to(_I32)
        kind_local[me] = torch.where(perm_ok, torch.where(sa_ok, 2, 1),
                                     0).to(_I32)
    bad = _gmin(bad_local)
    ok = _gmin(ok_local)
    ok = coll.each(ok, lambda me: ok[me] == 1)
    kind = _gmin(kind_local)
    return ok, bad, kind


def _reduce_over_shards(starts, lengths, n: int):
    """The best candidate over shards: pad suffixes (start >= n) masked,
    matches clamped at the real end of text, first maximum wins. Returns
    host arrays (start [B], length [B])."""
    def masked(me):
        s = starts[me]
        ln = torch.minimum(lengths[me].to(s.dtype), n - s)
        return torch.where(s < n, ln, -1)

    all_len = coll.first_local(coll.all_gather(coll.each(
        starts, masked)))  # [P, B]
    all_start = coll.first_local(coll.all_gather(list(starts)))
    best_p = torch.argmax(all_len, dim=0)  # the first maximum
    best_len = all_len.amax(0).clamp(min=0)
    best_start = all_start.gather(0, best_p[None, :])[0]
    both = torch.stack([best_start, best_len]).cpu().numpy()  # one fetch
    return both[0], both[1]


def _replicated(xs_host: np.ndarray, shards) -> list:
    """A host array on the device of each of this process's shards (one
    copy per device)."""
    made = {}
    for me in coll.local_parts(shards):
        d = shards[me].device
        if d not in made:
            made[d] = torch.tensor(xs_host, device=d)
    return coll.each(shards, lambda me: made[shards[me].device])


def _in_lockstep(searches, probe) -> list:
    """`run_in_lockstep` over this process's shards' searches (None for the
    others); `probe` and the results are indexed by global shard."""
    from stringsearch_torch.core.search import run_in_lockstep

    mine = coll.local_parts(searches)

    def by_shard(xs):
        full = [None] * len(searches)
        for me, x in zip(mine, xs):
            full[me] = x
        return full

    def local_probe(positions):
        answers = probe(by_shard(positions))
        return [answers[me] for me in mine]

    return by_shard(run_in_lockstep([searches[me] for me in mine],
                                    local_probe))


def _windows(text_mode: str, sa, text, n_limit: int, chunk: int,
             m_width: int):
    """probe(positions per shard) -> per shard (starts, windows): the
    suffix windows at those slots of each shard's SA slice, read from the
    replicated text or through the distributed gather, PAST_TEXT_END at
    and past global position `n_limit`."""
    def probe(positions):
        starts = coll.each(positions, lambda me: sa[me][
            positions[me].clamp(0, chunk - 1)])
        if text_mode == "replicated":
            wins = coll.each(starts, lambda me: cmp.gather_window(
                text[me], starts[me], m_width))
        else:
            wins = sharded_gather_windows(text, starts, m_width)
            wins = coll.each(wins, lambda me: wins[me].to(_I32))

        def masked(me):
            st = starts[me]
            offs = torch.arange(m_width, dtype=st.dtype, device=st.device)
            inb = (st[:, None] + offs[None, :]) < n_limit
            return st, torch.where(inb, wins[me], cmp.PAST_TEXT_END)

        return coll.each(starts, masked)
    return probe


def _check_mode(text_mode: str) -> None:
    if text_mode not in ("replicated", "sharded"):
        raise ValueError(f"unknown text_mode {text_mode!r}")


class GlobalSuffixArray:
    """Exact suffix array of a mesh-sharded text (one index over shards).

    Unlike `ShardedSuffixArray` (independent per-partition SAs), this
    builds THE suffix array of the whole text; shard s holds
    SA[s*L:(s+1)*L] of the global sorted order (`_sa_sharded`), and `rank`
    the ISA of the padded text in text order, both lists of per-shard
    tensors on the devices of the mesh's "parts" axis.

    idx: index dtype for global positions and ranks, torch.int32 (the
    default, n < 2^31) or torch.int64.
    """

    def __init__(self, text: BytesLike, mesh, idx=_I32,
                 depth: int = INITIAL_DEPTH, fan: int = 3, tracer=None,
                 compaction: bool = True):
        self._tracer = tracer
        if _AXIS not in mesh.shape:
            raise ValueError(f'mesh must have a "{_AXIS}" axis')
        if idx not in _IDX:
            raise TypeError(f"idx must be torch.int32 or torch.int64, got "
                            f"{idx}")
        if depth % 4 or depth < 4:
            raise ValueError("depth must be a positive multiple of 4")
        if fan < 2:
            raise ValueError("fan must be >= 2")
        self.mesh = mesh
        mesh.bind()
        self.idx = idx
        self.fan = fan
        self.compaction = compaction
        devices = mesh.part_devices
        arr = as_text_tensor(text, devices[mesh.local_parts[0]])
        self.n = int(arr.shape[0])
        p = mesh.shape[_AXIS]
        self.num_shards = p
        # a chunk of at least 4 keeps even the smallest initial window
        # inside the immediate next shard
        chunk = max(-(-max(self.n, p) // p), 4)
        self.chunk_len = chunk
        # the initial window must not reach past the immediate neighbour
        self.depth = max(4, min(depth, chunk) // 4 * 4)
        pad = chunk * p - self.n
        self.pad = pad
        if pad:
            arr = torch.cat([arr, arr.new_zeros((pad,))])
        self.text_padded = [arr[s * chunk:(s + 1) * chunk].to(dev)
                            if mesh.is_local(s) else None
                            for s, dev in enumerate(devices)]
        del arr
        self._sa_host: Optional[np.ndarray] = None
        self._build()

    def _build(self) -> None:
        chunk, p, idx = self.chunk_len, self.num_shards, self.idx
        n_pad = chunk * p
        m_cap = max(chunk // _COMPACT_DIV, 1)

        rank, sa, rank_s, count = _initial_shard_ranks(
            self.depth, idx, self.text_padded)
        tied = int(coll.first_local(count))
        h = self.depth
        self.rounds_run = 0
        self.compact_rounds_run = 0
        # the rounds that ran (a block's rounds after the build resolved
        # are counted in rounds_run but skipped): what the collectives
        # moved is priced by these
        self.rounds_executed = 0
        self.compact_rounds_executed = 0
        if self._tracer is not None:
            self._tracer.log(
                f"global engine n={self.n} shards={p} chunk={chunk} "
                f"depth={self.depth} fan={self.fan}"
            )
            self._tracer.dump(f"rank h={self.depth}", gather_to_host(rank))
        # h saturates at n_pad, where the marker round resolves every
        # remaining tie (the raw-byte conflation makes a count-based early
        # exit unsound; the saturated round is the guaranteed finisher).
        # Once the tied population fits the compacted capacity with
        # headroom, rounds take the compacted path.
        while tied:
            hs = []
            for _ in range(ROUNDS_PER_DISPATCH):
                hs.append(h)
                h = min(self.fan * h, n_pad)
            compact = (
                self.compaction
                and p >= 2
                and tied <= n_pad // _COMPACT_ENTRY
                and tied <= p * m_cap
            )
            if compact:
                rank, sa, rank_s, tied, ran = _compact_block(
                    chunk, p, idx, self.fan, m_cap, tuple(hs), rank, sa,
                    rank_s, tied)
                self.compact_rounds_run += len(hs)
                self.compact_rounds_executed += ran
            else:
                rank, sa, rank_s, tied, ran = _rounds_block(
                    chunk, p, idx, tuple(hs), self.fan, rank, sa, rank_s,
                    tied)
                self.rounds_executed += ran
            self.rounds_run += len(hs)
            if self._tracer is not None:
                self._tracer.log(
                    f"block rounds={self.rounds_run} h->{h} "
                    f"compact={compact} tied={tied}"
                )
                self._tracer.dump(f"rank after {self.rounds_run} rounds",
                                  gather_to_host(rank))
            if self.rounds_run > 2 * n_pad.bit_length() \
                    + 2 * ROUNDS_PER_DISPATCH:
                raise AssertionError(
                    "global doubling failed to converge — bug")
        self.rank = rank  # ISA over the padded text, text order, sharded
        self._sa_sharded = sa  # sorted order, sharded
        self._sa_host = None

    def verify(self) -> None:
        """Distributed O(n/P)-per-shard verification, no full array on any
        shard: rank is a permutation, the ISA recurrence holds at every
        adjacent pair of the global sorted order, and the sharded SA is
        rank's inverse. Raises `NotSorted` like the single-device
        verifier."""
        from stringsearch_torch.core.types import NotSorted

        ok, bad, kind = _verify_shard(self.chunk_len, self.idx,
                                      self.text_padded, self.rank,
                                      self._sa_sharded)
        ok, bad, kind = torch.stack([coll.first_local(x).to(torch.int64)
                                     for x in (ok, bad, kind)]).tolist()
        if ok:
            return
        if kind == 0:
            raise NotSorted(0, 0, "global rank is not a permutation")
        if kind == 1:
            raise NotSorted(
                0, 0, "sharded SA is not the inverse of the global rank")
        # the global sorted-order slot minus the pad count: pad suffixes
        # usually fill the first `pad` slots, but a real suffix of leading
        # 0x00 bytes can interleave with them, so for NUL-bearing texts
        # the position is approximate; detection is exact either way
        i = max(bad - self.pad, 0)
        raise NotSorted(
            max(i - 1, 0), i,
            f"adjacent-order violation at padded sorted slot {bad} "
            f"(position estimate assumes pad suffixes fill the first "
            f"{self.pad} slots; approximate if the text contains NULs)",
        )

    def comm_report(self):
        """Exact per-shard communication volume of THIS build
        (parallel/comm_model.py, with the actual rounds_run)."""
        from stringsearch_torch.parallel.comm_model import report_for

        return report_for(self)

    def suffix_array(self) -> np.ndarray:
        """The exact SA of the (unpadded) text as a host array [n]."""
        if self._sa_host is None:
            # pad suffixes sort strictly first; drop them
            self._sa_host = gather_to_host(self._sa_sharded)[self.pad:]
        return self._sa_host

    def _text_for(self, text_mode: str) -> list:
        if text_mode == "replicated":
            return coll.all_gather(self.text_padded, tiled=True)
        return self.text_padded

    def longest_substring_match_batch(self, needles,
                                      text_mode: str = "replicated"):
        """Batched LCS query against the sharded global SA.

        Each shard binary-searches its contiguous slice of the global
        sorted order; the per-shard candidates reduce with an all-gather
        and a first-maximum argmax. `text_mode` "replicated" reads a full
        copy of the padded text on every shard; "sharded" fetches every
        probe's windows with the distributed gather (one collective per
        probe, no shard holds more than text/P).
        """
        from stringsearch_torch.core.search import (
            _ceil_log2,
            _needle_batch_to_windows,
            lcs_steps,
        )
        from stringsearch_torch.core.types import LongestCommonSubstring

        _check_mode(text_mode)
        if not needles:
            return []
        padded, _lens, width = _needle_batch_to_windows(needles)
        chunk = self.chunk_len
        steps = _ceil_log2(chunk + 1) + 1
        nds = _replicated(padded, self._sa_sharded)
        probe = _windows(text_mode, self._sa_sharded,
                         self._text_for(text_mode), chunk * self.num_shards,
                         chunk, width)
        found = _in_lockstep(coll.each(nds, lambda me: lcs_steps(
            chunk, nds[me], steps)), probe)
        starts = coll.each(found, lambda me: found[me][0])
        lengths = coll.each(found, lambda me: found[me][1])
        start, length = _reduce_over_shards(starts, lengths, self.n)
        host = gather_to_host(self.text_padded)[:self.n]
        return [LongestCommonSubstring(host, int(start[i]), int(length[i]))
                for i in range(len(needles))]

    def longest_substring_match(self, needle):
        return self.longest_substring_match_batch([needle])[0]

    def sa_search_batch(self, needles, text_mode: str = "replicated"):
        """Batched exact-occurrence search: [(count, left_slot)] per needle.

        Every shard runs the double binary search over ITS slice of the
        global sorted order; the slices concatenate to the full order, so
        the global bounds are sums over shards (count = psum(up - lo),
        leftmost slot = psum(lo)). Probe windows mask every byte at global
        position >= n to PAST_TEXT_END, so pad bytes neither extend a real
        match nor let a pad suffix match a nonempty needle; pad slots land
        below every needle, inside the lower bound, which is rebased by
        `pad`. Same semantics as the oracle's flat-SA search.
        """
        from stringsearch_torch.core.search import (
            _ceil_log2,
            _needle_batch_to_windows,
            needle_mask_cmp,
            sa_search_steps,
        )

        _check_mode(text_mode)
        if not needles:
            return []
        padded, lens, width = _needle_batch_to_windows(needles)
        chunk = self.chunk_len
        steps = _ceil_log2(chunk + 1) + 1
        nds = _replicated(padded, self._sa_sharded)
        lns = _replicated(lens, self._sa_sharded)
        compares = coll.each(nds, lambda me: needle_mask_cmp(nds[me],
                                                             lns[me]))
        windows = _windows(text_mode, self._sa_sharded,
                           self._text_for(text_mode), self.n, chunk, width)

        def probe(positions):
            wins = windows(positions)
            return coll.each(wins, lambda me: compares[me](wins[me][1]))

        found = _in_lockstep(coll.each(nds, lambda me: sa_search_steps(
            chunk, len(needles), steps, nds[me].device)), probe)
        count = coll.first_local(coll.psum(coll.each(
            found, lambda me: found[me][1] - found[me][0])))
        left = coll.first_local(coll.psum(coll.each(
            found, lambda me: found[me][0])))
        both = torch.stack([count, left]).cpu().numpy()  # one host fetch
        out = []
        for i, nd in enumerate(needles):
            if len(bytes(nd)) == 0:
                # empty needle: every real suffix matches the empty prefix
                out.append((self.n, 0))
            else:
                out.append((int(both[0, i]), int(both[1, i]) - self.pad))
        return out

    def sa_search(self, needle, text_mode: str = "replicated"):
        return self.sa_search_batch([needle], text_mode)[0]

    def sa_simplesearch(self, c: int, text_mode: str = "replicated"):
        """(count, left_slot) of suffixes starting with byte `c`, as a
        1-byte `sa_search`."""
        return self.sa_search(bytes([c]), text_mode)

    def to_suffix_array_index(self):
        """A single-device `SuffixArray` (on this process's first shard's
        device) for the query API; across processes every process calls
        it (the shards are gathered through the host)."""
        from stringsearch_torch.core.types import SuffixArray

        dev = coll.first_local(self.text_padded).device

        def whole(xs):
            if all(x is not None for x in xs):
                return torch.cat([x.to(dev) for x in xs])
            return torch.from_numpy(gather_to_host(xs)).to(dev)

        return SuffixArray(whole(self.text_padded)[:self.n],
                           whole(self._sa_sharded)[self.pad:])


def build_global(text: BytesLike, mesh, idx=_I32,
                 depth: int = INITIAL_DEPTH, fan: int = 3,
                 tracer=None, compaction: bool = True) -> GlobalSuffixArray:
    """Build the exact global SA of `text` sharded over `mesh`'s "parts".

    Pass a `harness.tracing.Tracer` to dump the sharded rank state per
    round block. `compaction=False` pins the full-width round path."""
    return GlobalSuffixArray(text, mesh, idx=idx, depth=depth, fan=fan,
                             tracer=tracer, compaction=compaction)
