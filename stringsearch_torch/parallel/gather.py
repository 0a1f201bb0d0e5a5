"""Distributed gather over a sharded array — all-to-all request routing.

Counterpart of stringsearch_tpu/parallel/gather.py: read
`out[i] = values[idx[i]]` where `values` is sharded over the "parts" axis
and every shard holds its own batch of global indices, with static shapes:

  1. each shard sorts its requests by owner shard, ranks each request
     inside its owner's segment and scatters the requests into a [P, cap]
     send buffer (cap = the request count m in `sharded_gather`, so no
     distribution of requests can overflow);
  2. one `all_to_all` moves the requests to their owners;
  3. owners answer with a local take;
  4. a reverse `all_to_all` returns the answers, and the requests' order
     is restored through the sort's permutation.

Used by `GlobalSuffixArray`'s text-sharded queries (the binary search
reads its text windows without a replicated text) and compacted rounds.

As in `distsort.py`, a sharded array is a list of per-shard tensors (this
process's shards across processes, None elsewhere), and the routing sort
ties on the owner: the port's stable sort may lay the
buffers out differently from JAX's, with the same answers.
"""

from __future__ import annotations

import torch

from stringsearch_torch.ops.bitonic import device_sort
from stringsearch_torch.parallel import collectives as coll
from stringsearch_torch.parallel.distsort import _seg_rank

_I32 = torch.int32


def _route(values, idx, cap: int):
    """Per shard: (owner_s, rank, src_s, send [P, cap]) for `idx`."""
    p = len(values)
    length = coll.first_local(values).shape[0]
    routed = [None] * p
    for me in coll.local_parts(values):
        i = idx[me].clamp(0, p * length - 1)
        owner = torch.div(i, length, rounding_mode="floor").to(_I32)
        off = (i % length).to(_I32)
        m = i.shape[0]
        owner_s, off_s, src_s = device_sort(
            (owner, off, torch.arange(m, dtype=_I32, device=i.device)), 1)
        rank = _seg_rank(owner_s)
        # a request past the capacity writes slot cap - 1 (the overflow
        # flag makes the caller discard the result)
        slot = rank.clamp(max=cap - 1)
        send = off_s.new_zeros((p, cap))
        send[owner_s, slot] = off_s
        routed[me] = (owner_s, rank, slot, src_s, send)
    return routed


def _answer(values, routed, dtype) -> list:
    """Route the requests to their owners, answer, route the answers back
    and put them in request order."""
    recv = coll.all_to_all(coll.each(routed, lambda me: routed[me][4]))
    # recv[s] = offsets requested BY shard s of my slice
    answers = coll.each(recv, lambda me: values[me][recv[me].reshape(
        -1).clamp(0, values[me].shape[0] - 1)].reshape(recv[me].shape))
    del recv
    back = coll.all_to_all(answers)
    out = [None] * len(routed)
    for me in coll.local_parts(routed):
        owner_s, _rank, slot, src_s, _send = routed[me]
        # request src_s[j] was answered at back[owner_s[j], slot[j]]
        got = back[me][owner_s, slot]
        res = torch.zeros((src_s.shape[0],), dtype=dtype, device=got.device)
        res[src_s] = got
        out[me] = res
    return out


def sharded_gather(values, idx) -> list:
    """out[i] = global_values[idx[i]] for sharded values, per-shard idx.

    values: per-shard [L] slices of the global [P*L] array; idx: per-shard
    [m] global indices (the same m on every shard), clamped into [0, P*L).
    Returns per-shard [m] tensors of values' dtype.
    """
    m = coll.first_local(idx).shape[0]
    return _answer(values, _route(values, idx, m),
                   coll.first_local(values).dtype)


def sharded_gather_capped(values, idx, cap: int):
    """`sharded_gather` with a BALANCED per-owner request capacity.

    [P, cap] send buffers (cap about 2*ceil(m/P) for near-uniform requests,
    the distributed compaction's regime) in place of [P, m]. Returns
    (out, overflow): when ANY shard's requests put more than `cap` on one
    owner, the replicated `overflow` flags are set and `out` is garbage —
    callers must take their fallback.
    """
    routed = _route(values, idx, cap)
    overflow = coll.psum(coll.each(
        routed, lambda me: (routed[me][1] >= cap).any().to(_I32)))
    return (_answer(values, routed, coll.first_local(values).dtype),
            coll.each(overflow, lambda me: overflow[me] > 0))


def sharded_gather_windows(values, starts, width: int) -> list:
    """Fetch [B, width] windows values[start:start+width] from a sharded
    array (windows may span shard boundaries). Out-of-range reads clamp;
    callers mask with their own length logic."""
    def window_index(me):
        s = starts[me]
        offs = torch.arange(width, dtype=s.dtype, device=s.device)
        return (s[:, None] + offs[None, :]).reshape(-1).to(_I32)

    out = sharded_gather(values, coll.each(starts, window_index))
    return coll.each(out, lambda me: out[me].reshape(starts[me].shape[0],
                                                     width))
