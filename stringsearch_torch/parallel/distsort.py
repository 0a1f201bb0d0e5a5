"""Distributed multi-key sort over the shards of a mesh — bitonic
merge-split, and the all_to_all routes that replace it where they can.

Counterpart of stringsearch_tpu/parallel/distsort.py, function for
function:

- `sharded_sort`: each shard sorts its [L] chunk locally; the bitonic
  network over P chunk slots then runs comparator stages, each one an
  exchange of chunks with a partner (`ppermute`), a merge of the two
  sorted chunks and a keep of the lower or upper half (on CUDA one pass of
  `ops/merge.py:merge_split`, where the JAX package sorts all 2L). P is
  a power of two, and every stage moves exactly L elements per operand per
  shard: no capacity to overflow.
- `redistribute_permutation`: routes elements to shard gidx // L, slot
  gidx % L, with one `all_to_all` at a static per-pair capacity, when gidx
  is a permutation; the merge-split sort is its fallback.
- `rank_interval_sort`: a global sort whose primary key is a head-slot
  rank, with one `all_to_all`, a local sort and one boundary `ppermute`;
  the merge-split sort is its fallback.

What differs from the JAX package, and why:
  * A sharded array is a list of per-shard tensors (`collectives.py`),
    and the functions take a tuple of such lists, one per operand, where
    the JAX functions take a tuple of local arrays inside `shard_map`.
    Across processes a list holds this process's shards (None elsewhere),
    and every shard-map loop runs over them (`coll.local_parts`).
  * `jax.axis_index` is the shard's Python index, and a branch on it is a
    host branch per shard.
  * `lax.cond` on a replicated flag is a host branch: one sync for the
    overflow flag of each fast path. `rank_interval_sort` reads, in that
    same sync, every shard's row count for each receiver (`route_partition`
    returns them with the flag), so it decides the boundary check on the
    host before the exchange, where the JAX package sorts first and counts
    the valid rows after: one host read a call, not two.
  * `rank_interval_sort`'s receivers sort only the rows that hold an
    element: each packs the valid prefix of every sender's block, by the
    counts read with the flag, where the JAX package sorts the whole
    p * cap receive buffer with its pads (rank the dtype's maximum, sorted
    last). The packed rows keep the valid rows' order and the sort is
    stable, so the sorted rows, the boundary repair and the output are
    those of the padded sort, ties included.
  * Every local sort is `ops.bitonic.device_sort`, which is stable (on
    CUDA the hand-written radix sort). `lax.sort` is not, so where the keys
    tie the buffers may be laid out differently from JAX's; what the keys
    determine (the routed contents once re-sorted, the results) is the
    same.
  * The all_to_all routes build their send buffers with
    `ops/route.py:route_partition` (on CUDA one pass of a stable counting
    partition by destination) where the JAX package sorts by destination
    and scatters, and `redistribute_permutation`'s receivers place with
    `place_received` (a window of slots at a time; neither function has
    a limit on the operands or the shards). `rank_interval_sort`'s buffers
    equal a stable sort by destination element for element;
    `redistribute_permutation`'s order each (source, destination) pair
    by window of gidx % L, and by source order inside a window, where the
    JAX package orders it by gidx. Its receivers place by gidx % L, so the
    outputs, the per-pair counts, the overflow decision and the bytes each
    shard sends are the same.
  * A merge-split stage merges the two sorted chunks (`merge_split`)
    where the JAX package sorts their concatenation again: the same half,
    element for element, on the same device.

Spans (`harness/tracing.py`, recorded only under a profiler):
`distsort.sharded_sort`, `global.redistribute` (`redistribute_permutation`)
and `distsort.rank_interval_sort` hold a call each, with the attribute
`fell_back` where a route fell back to the merge-split sort;
`distsort.recv_sort` holds `rank_interval_sort`'s local sorts of the
packed receive buffers, with the attributes `rows` (the valid rows sorted,
summed over the local shards) and `capacity` (p * cap a local shard, summed:
1 - rows / capacity is the share of pad rows left unsorted); `global.wait`
holds each host read of a replicated flag or count (`host_flag`, the
interval sort's table of counts and flags).
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

import torch

from stringsearch_torch.harness.tracing import span, wait_span
from stringsearch_torch.ops.bitonic import device_sort
from stringsearch_torch.ops.merge import merge_split
from stringsearch_torch.ops.route import (
    place_received,
    receiver_windows,
    route_partition,
)
from stringsearch_torch.parallel import collectives as coll


#: fast paths that fell back to the merge-split sort in this process, by
#: cause: "redistribute" (a pair over capacity), "rank_interval" (the
#: same) and "rank_interval_boundary" (an overhang over capacity)
fallbacks = Counter()


def _local(operands, me: int) -> tuple:
    """Shard `me`'s tensor of every operand."""
    return tuple(op[me] for op in operands)


def _by_operand(per_shard) -> tuple:
    """Per-shard tuples of operands (None for a remote shard) -> a tuple of
    per-shard lists."""
    width = len(coll.first_local(per_shard))
    return tuple([None if t is None else t[k] for t in per_shard]
                 for k in range(width))


def host_flag(flags) -> bool:
    """The host value of a replicated flag (one sync), read at a local
    shard, in the span `global.wait`."""
    with wait_span("global.wait"):
        return bool(coll.first_local(flags))


def _merge_halves(mine, theirs, mine_first: bool, keep_low: bool,
                  num_keys: int):
    """Merge one shard's sorted tuple of [L] arrays with its partner's;
    keep one half.

    Both partners MUST materialize the identical merged list, or ties that
    straddle the split point get duplicated on one side and dropped on the
    other. `mine_first` pins a canonical order — the lower-indexed shard's
    chunk first on both sides, its elements first where keys tie. On CUDA
    one pass of the merge kernel (`ops/merge.py`) in place of the JAX
    package's sort of the 2L concatenation.
    """
    return merge_split(mine, theirs, mine_first, keep_low, num_keys)


def sharded_sort(operands: Sequence, num_keys: int = 1) -> tuple:
    """Globally sort sharded arrays by their first `num_keys` operands.

    Each operand is a list of per-shard [L] tensors, the shards of a global
    [P*L] array. After the call, the concatenation of the shards is sorted
    lexicographically by the key operands; value operands are permuted
    alongside. Make keys unique (a position operand as the last key) when
    the order of equal key tuples matters. In the span
    `distsort.sharded_sort`.
    """
    with span("distsort.sharded_sort"):
        return _sharded_sort(operands, num_keys)


def _sharded_sort(operands, num_keys: int) -> tuple:
    operands = tuple(list(op) for op in operands)
    p = len(operands[0])
    operands = _by_operand(coll.each(operands[0], lambda me: device_sort(
        _local(operands, me), num_keys)))
    if p == 1:
        return operands
    if p & (p - 1):
        raise ValueError(f"sharded_sort needs a power-of-two axis, got {p}")

    k = 2
    while k <= p:
        j = k // 2
        while j >= 1:
            perm = [(i, i ^ j) for i in range(p)]
            theirs = tuple(coll.ppermute(op, perm) for op in operands)
            merged = [None] * p
            for me in coll.local_parts(operands[0]):
                partner = me ^ j
                # ascending region of the bitonic network
                ascending = (me & k) == 0
                mine_first = me < partner
                merged[me] = _merge_halves(
                    _local(operands, me), _local(theirs, me), mine_first,
                    mine_first == ascending, num_keys)
            del theirs
            operands = _by_operand(merged)
            del merged
            j //= 2
        k *= 2
    return operands


def redistribute_cap(p: int, chunk_elems: int, cap_factor: int = 2) -> int:
    """Static per-(source, dest) capacity of the all_to_all routes.

    Shared with parallel/comm_model.py, so the model's volume arithmetic
    cannot drift from the implementation."""
    return int(min(chunk_elems, cap_factor * (-(-chunk_elems // p))))


def _route(src, operands, fills, length: int, p: int, cap: int,
           clamp: bool, windows: int = 1) -> tuple:
    """Every local shard's [P, cap] send buffers of `operands` routed by
    `src` (`route_partition`), its overflow flag and its [P] row counts.
    Returns (buffers: a tuple of per-shard lists, one an operand; flags;
    counts), the last two per-shard lists."""
    sends, over, counts = [None] * p, [None] * p, [None] * p
    for me in coll.local_parts(src):
        sends[me], over[me], counts[me] = route_partition(
            src[me], length, p, _local(operands, me), fills, cap, clamp,
            windows)
    return _by_operand(sends), over, counts


def redistribute_permutation(gidx, operands, cap_factor: int = 2) -> tuple:
    """Route elements to shard `gidx // L`, slot `gidx % L` — the cheap
    replacement for `sharded_sort((gidx, *operands), num_keys=1)` when
    `gidx` is a permutation of [0, P*L).

    One `all_to_all` moves about cap_factor * L elements per operand per
    shard, where merge-split moves S(P) * L. The send buffers have the
    static capacity cap = cap_factor * ceil(L/P) per pair; if ANY pair
    overflows (already-sorted text routes each shard's elements to itself),
    the replicated flag sends every shard to the merge-split fallback.

    `gidx` is a list of per-shard tensors, `operands` a tuple of such
    lists. Returns the operands in destination order (slot gidx % L).

    Each shard's send buffers come from one `route_partition` (gidx and
    the operands, routed by gidx // L), which orders every (source,
    destination) pair by window of gidx % L (`receiver_windows`) and by
    source order inside a window; the JAX package sorts each pair by
    gidx. The receivers place every element at gidx % L
    (`place_received`, a window at a time), so the result does not depend
    on that order, and the pairs' counts, the overflow flag and the bytes
    sent are the same. In the span `global.redistribute` (`fell_back` on a
    fallback).
    """
    with span("global.redistribute") as sp:
        return _redistribute(gidx, operands, cap_factor, sp)


def _redistribute(gidx, operands, cap_factor: int, sp) -> tuple:
    gidx = list(gidx)
    operands = tuple(list(op) for op in operands)
    p = len(gidx)
    length = coll.first_local(gidx).shape[0]
    if p == 1:
        srt = device_sort((gidx[0],) + _local(operands, 0), 1)
        return tuple([x] for x in srt[1:])
    cap = redistribute_cap(p, length, cap_factor)
    # each row by window of the receiver's slots, so that a receiver
    # places a window at a time
    windows = receiver_windows(p, length, max(
        coll.first_local(op).element_size() for op in operands))
    sends, over, _ = _route(gidx, (gidx,) + operands,
                            (-1,) + (0,) * len(operands), length, p, cap,
                            False, windows)
    if host_flag(coll.psum(over)):
        del sends
        fallbacks["redistribute"] += 1
        sp.set(fell_back=True)
        return sharded_sort((gidx,) + operands, num_keys=1)[1:]

    sends = list(sends)
    recv_g = coll.all_to_all(sends.pop(0))
    outs = []
    for _ in operands:
        recv = coll.all_to_all(sends.pop(0))
        outs.append(coll.each(recv, lambda me: place_received(
            recv_g[me], (recv[me],), length, windows)[0]))
        del recv
    return tuple(outs)


def rank_interval_sort(operands, num_keys: int, cap_factor: int = 2
                       ) -> tuple:
    """Global sort whose primary key is a HEAD-SLOT RANK — one all_to_all,
    a local sort and one boundary ppermute instead of the merge-split
    network's S(P) full-chunk exchanges.

    Precondition: operand 0 holds head-slot ranks of the CURRENT global
    order — the value r of an element is the global slot of its tie
    group's first member, so its final sorted slot lies in [r, r +
    group size). Routing to shard r // L sends every element to the shard
    where its group STARTS; after a local sort, shard s's elements occupy
    the global slots [s*L + overhang_s, (s+1)*L + overhang_{s+1}), and ONE
    neighbour ppermute of the right-aligned tail repairs the boundaries.

    Fast-path capacities (static; either overflow falls back to
    `sharded_sort`): the per-pair all_to_all capacity `redistribute_cap`,
    and the same cap for the boundary shift (a tie group larger than cap
    straddling a shard boundary overflows it). Both are decided before the
    exchange, from one host read: every shard's overflow flag and its row
    count for each receiver (`route_partition`), all-gathered into one
    [P, P + 1] table. The counts give each receiver's valid rows, and so
    the head deficits and tail spills of the boundary repair.

    Each receiver keeps the valid prefix of every sender's block, in
    sender order, and sorts only those rows: about L of the p * cap it
    receives. The send buffers and the bytes sent are the JAX package's.

    Returns the operands globally sorted by the first `num_keys` (ties in
    any order unless the key tuple is unique). In the span
    `distsort.rank_interval_sort` (`fell_back` on a fallback), its local
    sorts in `distsort.recv_sort` (`rows`, `capacity`).
    """
    with span("distsort.rank_interval_sort") as sp:
        return _rank_interval_sort(operands, num_keys, cap_factor, sp)


def _rank_interval_sort(operands, num_keys: int, cap_factor: int, sp
                        ) -> tuple:
    operands = tuple(list(op) for op in operands)
    p = len(operands[0])
    length = coll.first_local(operands[0]).shape[0]
    if p == 1:
        return tuple([x] for x in device_sort(_local(operands, 0),
                                              num_keys))
    if p == 2:
        # S(2) = 1 merge-split stage moves L per operand; the interval
        # route's cap clamps to L at P=2, so its all_to_all + boundary
        # repair would move ~3L — merge-split wins below P=4
        # (parallel/comm_model.py has the same branch)
        return sharded_sort(operands, num_keys=num_keys)
    sent = torch.iinfo(coll.first_local(operands[0]).dtype).max
    cap = redistribute_cap(p, length, cap_factor)
    # routed by the head-slot rank's shard, clamped into [0, P)
    sends, over, counts = _route(operands[0], operands,
                                 (sent,) + (0,) * (len(operands) - 1), length,
                                 p, cap, True)
    # row s: shard s's count for each receiver, then its overflow flag
    table = coll.first_local(coll.all_gather(coll.each(
        counts, lambda me: torch.cat([counts[me], over[me].view(1)]))))
    with wait_span("global.wait"):
        table = table.tolist()
    if any(row[p] for row in table):
        del sends
        fallbacks["rank_interval"] += 1
        sp.set(fell_back=True)
        return sharded_sort(operands, num_keys=num_keys)
    nv = [sum(row[d] for row in table) for d in range(p)]  # valid rows
    pre = [sum(nv[:d]) for d in range(p)]
    oh = [pre[me] - me * length for me in range(p)]  # my head deficit
    spill = [pre[me] + nv[me] - (me + 1) * length  # my tail spill
             for me in range(p)]
    # shard p-1 has spill 0 by construction (prefix + valid == n)
    if any(not (0 <= x <= cap) for x in oh + spill):
        del sends
        fallbacks["rank_interval_boundary"] += 1
        sp.set(fell_back=True)
        return sharded_sort(operands, num_keys=num_keys)

    # each receiver keeps the valid prefix of every sender's block, in
    # sender order; the padded buffer goes before the next exchange
    sends = list(sends)
    packed = []
    for _ in operands:
        recv = coll.all_to_all(sends.pop(0))
        packed.append(coll.each(recv, lambda me: torch.cat(
            [recv[me][s, :table[s][me]] for s in range(p)])))
        del recv
    srt2 = [None] * p
    with span("distsort.recv_sort") as sort_sp:
        mine = coll.local_parts(packed[0])
        sort_sp.set(rows=sum(nv[me] for me in mine),
                    capacity=len(mine) * p * cap)
        for me in mine:
            srt2[me] = device_sort(_local(packed, me), max(num_keys, 1))
            for col in packed:
                col[me] = None
    del packed

    perm = [(t, (t + 1) % p) for t in range(p)]
    outs = []
    for k in range(len(operands)):
        # the right-aligned tail [nv - cap, nv) of the sorted rows,
        # zero-filled in front; receivers read its last oh slots
        tails = [None] * p
        for me in coll.local_parts(srt2):
            op2 = srt2[me][k]
            tail = op2[max(nv[me] - cap, 0):nv[me]]
            if tail.shape[0] < cap:
                tail = torch.cat([tail.new_zeros((cap - tail.shape[0],)),
                                  tail])
            tails[me] = tail
        heads = coll.ppermute(tails, perm)
        # shard 0's head is empty (oh == 0 there): the global order starts
        # on it
        outs.append(coll.each(srt2, lambda me: torch.cat(
            [heads[me][cap - oh[me]:], srt2[me][k][:length - oh[me]]])))
        del tails, heads
    return tuple(outs)


def exclusive_shard_offset(local_sum) -> list:
    """Sum of `local_sum` over all lower-indexed shards (exclusive scan).

    A one-hot all-gather of the scalar partials and a masked sum, as in the
    JAX package. `local_sum` is a list of per-shard 0-d tensors.
    """
    partials = coll.all_gather(list(local_sum))  # [P] on every shard
    return coll.each(partials, lambda me: partials[me][:me].sum(
        dtype=partials[me].dtype))


def shift_in_from_prev(x_last, fill) -> list:
    """Bring the previous shard's boundary value in (for neighbour diffs).

    x_last: each shard's last element (a 0-d or [k] tensor); returns the
    previous shard's, with `fill` on shard 0.
    """
    p = len(x_last)
    prev = coll.ppermute(list(x_last), [(i, (i + 1) % p) for i in range(p)],
                         boundary=True)
    if prev[0] is not None:
        prev[0] = torch.full_like(prev[0], fill)
    return prev
