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
       shifted in, a local running max of head slots and an all-gathered
       cross-shard carry;
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
    one process drives every shard, whose device may repeat.
  * `lax.cond` becomes a host branch on a replicated value, one sync each:
    the skip of a round once the build has resolved (the tied count of
    the round before, read once a round), the fast path or fallback of
    every distributed sort and of a compacted round (which reads all its
    overflow flags at once, before it writes anything).
  * `lax.cummax` of head slots is `_last_flagged` (a cumsum, a scatter and
    a gather, as `engines/doubling.py:_segment_heads`).
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
    nxt[-1] = torch.full_like(nxt[-1], fill)
    return nxt


def _last_flagged(flag: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """`cummax(where(flag, vals, -1))` for nondecreasing `vals`: the value
    at the last flagged slot <= i, or -1 before the first.

    A cumsum, a scatter and a gather: each flagged slot writes its value
    to its segment's entry, every other slot to a private scratch entry.
    """
    n = flag.shape[0]
    seg = torch.cumsum(flag, 0, dtype=vals.dtype) - 1
    j = torch.arange(n, dtype=vals.dtype, device=vals.device)
    buf = torch.empty((2 * n,), dtype=vals.dtype, device=vals.device)
    buf[torch.where(flag, seg, n + j)] = vals
    return torch.where(seg >= 0, buf[seg.clamp(min=0)], -1)


def _eq_prev(keys_s, fill) -> list:
    """Per shard: True where the sorted element's keys all equal its
    global predecessor's (the boundary value shifted in from the previous
    shard, `fill` on shard 0)."""
    p = len(keys_s[0])
    prev = shift_in_from_prev(
        [torch.stack([ks[me][-1] for ks in keys_s]) for me in range(p)],
        fill)
    out = []
    for me in range(p):
        eq = None
        for i, ks in enumerate(keys_s):
            k = ks[me]
            same = k == torch.cat([prev[me][i:i + 1], k[:-1]])
            eq = same if eq is None else eq & same
        out.append(eq)
    return out


def _headslot_ranks_from_sorted(eq_prev, idx):
    """Global HEAD-SLOT rank of each sorted element, and the tied count.

    The head-slot rank is the global sorted slot of the element's tie
    group's FIRST member: order-isomorphic to a dense rank, equal to the
    final ISA once every group is a singleton, and what the rank-interval
    sort's routing needs. `eq_prev` (per shard, bool [L]) is True where
    the element's key equals its global predecessor's. Returns (rank
    [per shard], count [replicated]): the number of tied SLOTS (a slot is
    tied iff it is not its own head or the next slot shares its head);
    0 iff resolved. A shard whose first elements continue an earlier
    shard's group takes its carry from an all-gather of every shard's last
    local head (a headless shard contributes -1).
    """
    p = len(eq_prev)
    length = eq_prev[0].shape[0]
    gslots, heads = [], []
    for me in range(p):
        gslot = _global_iota(me, length, idx, eq_prev[me].device)
        gslots.append(gslot)
        heads.append(_last_flagged(~eq_prev[me], gslot))
    lasts = coll.all_gather([h[-1] for h in heads])  # [P]
    rank = []
    for me in range(p):
        mask = torch.arange(p, device=lasts[me].device) < me
        carry = torch.where(mask, lasts[me], -1).amax()
        rank.append(torch.where(heads[me] >= 0, heads[me], carry))
    del heads
    nf = _shift_in_from_next([r[:1] for r in rank], -1)
    count = []
    for me in range(p):
        rank_next = torch.cat([rank[me][1:], nf[me]])
        tied = (rank[me] != gslots[me]) | (rank_next == rank[me])
        count.append(tied.sum(dtype=_I32))
    return rank, coll.psum(count)


def _initial_shard_ranks(depth: int, idx, chunks):
    """Ranks by the first `depth` raw bytes (packed keys), shard-wise.

    The window past a shard's end is the next shard's first `depth` bytes
    (one ppermute); past the LAST shard it is zero-filled — the raw-byte
    conflation that the rounds' marker protocol repairs. Returns (rank,
    sa, rank_s, count).
    """
    p = len(chunks)
    length = chunks[0].shape[0]
    nxt = coll.ppermute([c[:depth] for c in chunks],
                        [(i, (i - 1) % p) for i in range(p)])
    nxt[-1] = torch.zeros_like(nxt[-1])
    nk = depth // 4
    keys = [[] for _ in range(nk)]
    gidx = []
    for me in range(p):
        ext = torch.cat([chunks[me], nxt[me]]).to(_I32)  # [L + depth]
        for k in range(nk):
            o = 4 * k
            keys[k].append(((ext[o:o + length] << 24)
                            | (ext[o + 1:o + 1 + length] << 16)
                            | (ext[o + 2:o + 2 + length] << 8)
                            | ext[o + 3:o + 3 + length]) ^ _BIAS)
        gidx.append(_global_iota(me, length, idx, chunks[me].device))
    del nxt
    out = sharded_sort(tuple(keys) + (gidx,), num_keys=nk)
    del keys, gidx
    keys_s, gidx_s = out[:nk], out[-1]
    eq_prev = _eq_prev(keys_s, 0)
    del keys_s, out
    # the global first element is never equal to a predecessor (the fill
    # could collide with a real key)
    eq_prev[0][0] = False
    rank_s, count = _headslot_ranks_from_sorted(eq_prev, idx)
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
    length = rank[0].shape[0]
    d, r = divmod(h, length)

    def from_offset(delta):
        if delta >= p:
            return [torch.full_like(x, -1) for x in rank]
        # shard i reads shard i + delta; delta 0 is this shard's own
        src = (list(rank) if delta == 0 else coll.ppermute(
            rank, [(i, i - delta) for i in range(delta, p)]))
        return [x if me + delta < p else torch.full_like(x, -1)
                for me, x in enumerate(src)]

    if r == 0:
        shifted = from_offset(d)
    else:
        a = from_offset(d)      # provides positions [r, L) of the window
        b = from_offset(d + 1)  # provides positions [0, r)
        shifted = [torch.cat([x[r:], y[:r]]) for x, y in zip(a, b)]
        del a, b
    n_pad = length * p
    out = []
    for me in range(p):
        gidx = _global_iota(me, length, idx, rank[me].device)
        if h < n_pad:
            out.append(torch.where(gidx < n_pad - h, shifted[me],
                                   -(gidx + 1)))
        else:
            out.append(-(gidx + 1))
    return out


def _doubling_step(chunk_len: int, total_shards: int, idx, h: int, rank,
                   fan: int = 2):
    """One distributed round. Returns (rank, sa, rank_s, count).

    Sort keys (rank[i], rank[i+h], .., rank[i+(fan-1)h]), each a depth-h
    class, so one round multiplies the resolved depth by `fan`.
    """
    n_pad = chunk_len * total_shards
    shifts = [_shifted_ranks(rank, min(k * h, n_pad), idx)
              for k in range(1, fan)]
    gidx = [_global_iota(me, chunk_len, idx, r.device)
            for me, r in enumerate(rank)]
    # head-slot primary key: the interval-routed sort (merge-split on
    # adversarial rank skew)
    out = rank_interval_sort((rank, *shifts, gidx), num_keys=fan + 1)
    del shifts, gidx
    keys_s, sa_s = out[:fan], out[-1]
    eq_prev = _eq_prev(keys_s, -2)
    del keys_s, out
    rank_s, count = _headslot_ranks_from_sorted(eq_prev, idx)
    del eq_prev
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
        tied = int(count[0])
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
    devs = [r.device for r in rank]
    gslot = [_global_iota(me, length, idx, devs[me]) for me in range(p)]

    # 1. tied flags in sorted order (local + one boundary ppermute)
    nf = _shift_in_from_next([r[:1] for r in rank_s], -1)
    # 2. local extraction at capacity M (sorted by group id g = rank_s)
    g0, pos0, over = [], [], []
    for me in range(p):
        rank_s_next = torch.cat([rank_s[me][1:], nf[me]])
        tied = (rank_s[me] != gslot[me]) | (rank_s_next == rank_s[me])
        key_srt, pos_srt = device_sort(
            (torch.where(tied, rank_s[me], big), sa[me]), 1)
        over.append(((m_cap < length)
                     & (key_srt[min(m_cap, length - 1)] != big)).to(_I32))
        g0.append(key_srt[:m_cap])
        pos0.append(pos_srt[:m_cap])
        del key_srt, pos_srt
    over = [f > 0 for f in coll.psum(over)]

    # 3. straddle repair: entries whose group head lives on the PREVIOUS
    # shard (g < me*L, a prefix of the g-sorted extraction) ship there
    pre = [g0[me] < me * length for me in range(p)]
    g_in = coll.ppermute(g0, perm_from_next)
    pos_in = coll.ppermute(pos0, perm_from_next)
    cnt_in = _shift_in_from_next([x.sum(dtype=_I32) for x in pre], 0)
    gw, pw = [], []
    for me in range(p):
        rv = torch.arange(m_cap, device=devs[me]) < cnt_in[me]
        gw.append(torch.cat([torch.where(pre[me], big, g0[me]),
                             torch.where(rv, g_in[me], big)]))
        pw.append(torch.cat([torch.where(pre[me], n_pad, pos0[me]),
                             torch.where(rv, pos_in[me], n_pad)]))
    del g0, pos0, pre, g_in, pos_in

    # 4. shifted keys: balanced capped gather on the sharded text-order
    # rank (markers for windows past the end, as everywhere)
    cap = 2 * (-(-2 * m_cap // p))
    shifts = []
    for k in range(1, fan):
        s_k = min(h, n_pad // k + 1) * k
        past = [w >= n_pad - s_k for w in pw]
        req = [torch.where(pa, 0, w + s_k).to(_I32)
               for pa, w in zip(past, pw)]
        val, ov = sharded_gather_capped(rank, req, cap)
        shifts.append([torch.where(pa, -(w + 1), v.to(idx))
                       for pa, w, v in zip(past, pw, val)])
        over = [a | b for a, b in zip(over, ov)]

    # 5. LOCAL refinement sort over the [2M] working set
    work = []
    count = []
    for me in range(p):
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
        ghead = _last_flagged(group_f, j2)
        rhead = _last_flagged(run_f, j2)
        valid = g_s2 != big
        slot = torch.where(valid, g_s2 + (j2 - ghead), n_pad)
        new_g = torch.where(valid, g_s2 + (rhead - ghead), big)
        nxt_rhead = torch.cat([rhead[1:], rhead.new_full((1,), -1)])
        tied2 = valid & ((rhead != j2) | (nxt_rhead == rhead))
        count.append(tied2.sum(dtype=_I32))
        # the text-order write-back's routing (7b), sorted by destination
        dest = torch.where(valid, torch.div(pos_s2, length,
                                            rounding_mode="floor"),
                           p).to(_I32)
        d_s, po_s, ng_s = device_sort((dest, pos_s2, new_g), 1)
        rnk = (torch.arange(2 * m_cap, device=devs[me])
               - torch.searchsorted(d_s, d_s, side="left"))
        work.append((slot, pos_s2, new_g, valid, d_s, po_s, ng_s, rnk))
        del out
    del gw, pw, shifts
    count = coll.psum(count)
    wb_over = coll.psum([((w[4] < p) & (w[7] >= cap)).any().to(_I32)
                         for w in work])
    if host_flag([a | (b > 0) for a, b in zip(over, wb_over)]):
        compact_fallbacks += 1
        del work
        return _doubling_step(chunk_len, total_shards, idx, h, rank, fan)

    # 7a. SA and sorted-rank write-back by slot: a local scatter and one
    # next-neighbour ppermute for the spill (slot < (me+2)L)
    sa_new, rank_s_new, spill = [], [], []
    for me, (slot, pos_s2, new_g, valid, *_rest) in enumerate(work):
        loc = slot - me * length
        in_loc = valid & (loc >= 0) & (loc < length)
        drop_i = torch.where(in_loc, loc, length)
        sa_new.append(_scatter_into(sa[me], drop_i, pos_s2))
        rank_s_new.append(_scatter_into(rank_s[me], drop_i, new_g))
        spill.append(torch.where(valid & (loc >= length), slot, n_pad))
    sp1 = coll.ppermute(spill, perm_to_next)
    sp2 = coll.ppermute([w[1] for w in work], perm_to_next)
    sp3 = coll.ppermute([w[2] for w in work], perm_to_next)
    sp1[0] = torch.full_like(sp1[0], n_pad)  # shard 0 receives nothing
    for me in range(p):
        loc2 = sp1[me] - me * length
        drop2 = torch.where((loc2 >= 0) & (loc2 < length), loc2, length)
        sa_new[me] = _scatter_into(sa_new[me], drop2, sp2[me])
        rank_s_new[me] = _scatter_into(rank_s_new[me], drop2, sp3[me])
    del spill, sp1, sp2, sp3

    # 7b. text-order rank write-back: balanced all_to_all scatter (row p
    # of the send buffers is the drop row)
    send_po, send_ng = [], []
    for me, (*_head, d_s, po_s, ng_s, rnk) in enumerate(work):
        use = (d_s < p) & (rnk < cap)
        row = torch.where(use, d_s, p)
        col = rnk.clamp(max=cap - 1)
        po = torch.full((p + 1, cap), n_pad, dtype=idx, device=devs[me])
        po[row, col] = po_s
        ng = torch.zeros((p + 1, cap), dtype=idx, device=devs[me])
        ng[row, col] = ng_s
        send_po.append(po[:p])
        send_ng.append(ng[:p])
    del work
    recv_po = coll.all_to_all(send_po)
    recv_ng = coll.all_to_all(send_ng)
    del send_po, send_ng
    rank_new = []
    for me in range(p):
        locp = recv_po[me].reshape(-1) - me * length
        inp = (locp >= 0) & (locp < length)
        rank_new.append(_scatter_into(rank[me], torch.where(inp, locp,
                                                            length),
                                      recv_ng[me].reshape(-1)))
    return rank_new, sa_new, rank_s_new, count


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
        tied = int(count[0])
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
    devs = [r.device for r in rank_chunks]
    gidx = [_global_iota(me, chunk_len, idx, devs[me]) for me in range(p)]
    # rank(i+1): local shift; the boundary value is the next shard's first
    # rank; the global last position gets -1
    nxt_first = _shift_in_from_next([r[:1] for r in rank_chunks], -1)
    rank_next = [torch.cat([r[1:], f]) for r, f in zip(rank_chunks,
                                                       nxt_first)]
    first = [t.to(idx) for t in text_chunks]
    r_s, fb_s, rn_s, pos_s = sharded_sort(
        (list(rank_chunks), first, rank_next, gidx), num_keys=1)
    prev = shift_in_from_prev(
        [torch.stack([fb_s[me][-1], rn_s[me][-1]]) for me in range(p)], -1)
    bad_local, ok_local, kind_local = [], [], []
    for me in range(p):
        perm_ok = (r_s[me] == gidx[me]).all()
        sa_ok = (pos_s[me] == sa_chunks[me]).all()
        fb_p = torch.cat([prev[me][:1], fb_s[me][:-1]])
        rn_p = torch.cat([prev[me][1:2], rn_s[me][:-1]])
        adj_ok = (fb_p < fb_s[me]) | ((fb_p == fb_s[me]) & (rn_p < rn_s[me]))
        adj_ok = adj_ok | (gidx[me] == 0)  # the global first slot
        bad_local.append(torch.where(adj_ok, n_pad, gidx[me]).amin())
        ok_local.append((perm_ok & sa_ok & adj_ok.all()).to(_I32))
        kind_local.append(torch.where(perm_ok, torch.where(sa_ok, 2, 1),
                                      0).to(_I32))
    bad = _gmin(bad_local)
    ok = [x == 1 for x in _gmin(ok_local)]
    kind = _gmin(kind_local)
    return ok, bad, kind


def _reduce_over_shards(starts, lengths, n: int):
    """The best candidate over shards: pad suffixes (start >= n) masked,
    matches clamped at the real end of text, first maximum wins. Returns
    host arrays (start [B], length [B])."""
    lens = []
    for s, ln in zip(starts, lengths):
        ln = torch.minimum(ln.to(s.dtype), n - s)
        lens.append(torch.where(s < n, ln, -1))
    all_len = coll.all_gather(lens)[0]  # [P, B]
    all_start = coll.all_gather(list(starts))[0]
    best_p = torch.argmax(all_len, dim=0)  # the first maximum
    best_len = all_len.amax(0).clamp(min=0)
    best_start = all_start.gather(0, best_p[None, :])[0]
    both = torch.stack([best_start, best_len]).cpu().numpy()  # one fetch
    return both[0], both[1]


def _replicated(xs_host: np.ndarray, devices) -> list:
    """A host array on every shard's device (one copy per device)."""
    made = {}
    for d in devices:
        if d not in made:
            made[d] = torch.tensor(xs_host, device=d)
    return [made[d] for d in devices]


def _windows(text_mode: str, sa, text, n_limit: int, chunk: int,
             m_width: int):
    """probe(positions per shard) -> per shard (starts, windows): the
    suffix windows at those slots of each shard's SA slice, read from the
    replicated text or through the distributed gather, PAST_TEXT_END at
    and past global position `n_limit`."""
    def probe(positions):
        starts = [s[pos.clamp(0, chunk - 1)] for s, pos in zip(sa, positions)]
        if text_mode == "replicated":
            wins = [cmp.gather_window(t, st, m_width)
                    for t, st in zip(text, starts)]
        else:
            wins = [w.to(_I32) for w in sharded_gather_windows(
                text, starts, m_width)]
        out = []
        for st, win in zip(starts, wins):
            offs = torch.arange(m_width, dtype=st.dtype, device=st.device)
            inb = (st[:, None] + offs[None, :]) < n_limit
            out.append((st, torch.where(inb, win, cmp.PAST_TEXT_END)))
        return out
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
        self.idx = idx
        self.fan = fan
        self.compaction = compaction
        devices = mesh.part_devices
        arr = as_text_tensor(text, devices[0])
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
        tied = int(count[0])
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
            self._tracer.dump(f"rank h={self.depth}", _host_cat(rank))
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
                                  _host_cat(rank))
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
        ok, bad, kind = torch.stack([ok[0].to(torch.int64),
                                     bad[0].to(torch.int64),
                                     kind[0].to(torch.int64)]).tolist()
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
            self._sa_host = _host_cat(self._sa_sharded)[self.pad:]
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
            run_in_lockstep,
        )
        from stringsearch_torch.core.types import LongestCommonSubstring

        _check_mode(text_mode)
        if not needles:
            return []
        padded, _lens, width = _needle_batch_to_windows(needles)
        chunk = self.chunk_len
        steps = _ceil_log2(chunk + 1) + 1
        nds = _replicated(padded, self.mesh.part_devices)
        probe = _windows(text_mode, self._sa_sharded,
                         self._text_for(text_mode), chunk * self.num_shards,
                         chunk, width)
        found = run_in_lockstep(
            [lcs_steps(chunk, nd, steps) for nd in nds], probe)
        starts = [f[0] for f in found]
        lengths = [f[1] for f in found]
        start, length = _reduce_over_shards(starts, lengths, self.n)
        host = _host_cat(self.text_padded)[:self.n]
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
            run_in_lockstep,
            sa_search_steps,
        )

        _check_mode(text_mode)
        if not needles:
            return []
        padded, lens, width = _needle_batch_to_windows(needles)
        chunk = self.chunk_len
        steps = _ceil_log2(chunk + 1) + 1
        devices = self.mesh.part_devices
        nds = _replicated(padded, devices)
        compares = [needle_mask_cmp(nd, ln) for nd, ln in
                    zip(nds, _replicated(lens, devices))]
        windows = _windows(text_mode, self._sa_sharded,
                           self._text_for(text_mode), self.n, chunk, width)

        def probe(positions):
            return [compare(win) for compare, (_st, win) in
                    zip(compares, windows(positions))]

        found = run_in_lockstep(
            [sa_search_steps(chunk, len(needles), steps, nd.device)
             for nd in nds], probe)
        count = coll.psum([up - lo for lo, up in found])[0]
        left = coll.psum([lo for lo, _up in found])[0]
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
        """A single-device `SuffixArray` (on shard 0's device) for the
        query API."""
        from stringsearch_torch.core.types import SuffixArray

        dev = self.text_padded[0].device
        text = torch.cat([t.to(dev) for t in self.text_padded])[:self.n]
        sa = torch.cat([s.to(dev) for s in self._sa_sharded])[self.pad:]
        return SuffixArray(text, sa)


def _host_cat(xs) -> np.ndarray:
    """The concatenation of per-shard tensors as one host array."""
    return torch.cat([x.cpu() for x in xs]).numpy()


def build_global(text: BytesLike, mesh, idx=_I32,
                 depth: int = INITIAL_DEPTH, fan: int = 3,
                 tracer=None, compaction: bool = True) -> GlobalSuffixArray:
    """Build the exact global SA of `text` sharded over `mesh`'s "parts".

    Pass a `harness.tracing.Tracer` to dump the sharded rank state per
    round block. `compaction=False` pins the full-width round path."""
    return GlobalSuffixArray(text, mesh, idx=idx, depth=depth, fan=fan,
                             tracer=tracer, compaction=compaction)
