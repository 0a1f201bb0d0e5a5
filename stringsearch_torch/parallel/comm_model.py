"""Communication volume of the distributed global-SA build.

Counterpart of stringsearch_tpu/parallel/comm_model.py, byte counts only.
Every collective of the build moves a statically known number of bytes
(the send buffers have static capacities, `distsort.redistribute_cap` and
`global_sa._COMPACT_DIV`), so the volume each shard sends is exact
arithmetic. `parallel/collectives.py` counts the same bytes as the build
moves them (its "ppermute" and "all_to_all" kinds), and the tests hold the
two equal.

The JAX file turns bytes into seconds with a TPU link rate. No such
constant is carried over: a projection here takes the link rate as an
argument, with no default.

Communication inventory of one `GlobalSuffixArray` build (see
parallel/global_sa.py, parallel/distsort.py):

  initial:   1 sharded_sort over (depth/4 key words + gidx)   [nk+1 ops]
             + 1 all_to_all permutation redistribute           [2 ops]
             + 1 neighbour ppermute of `depth` bytes (window)
  per round: (fan-1) rank-shift fetches, <= 2 chunk ppermutes each
             + 1 rank_interval_sort over (rank, shifts, gidx)
               [fan+1 ops: one all_to_all at cap 2*ceil(L/P) per pair
                + one boundary ppermute of cap elements]
             + 1 all_to_all permutation redistribute (rank)    [2 ops]
             + O(1) scalar exchanges (head carries, tied counts), left out

One merge-split `sharded_sort` of P power-of-two shards is bitonic with
S(P) = log2(P)*(log2(P)+1)/2 comparator stages; each stage exchanges the
shard's full chunk of every operand with its partner, so a shard sends
S(P) * L * ops * width bytes per sort. `rank_interval_sort` replaces that
with about 2L elements per operand on its fast path.

The report counts the rounds that `rounds_run` counts: every round of a
dispatched block of four, also a round skipped because the build had
resolved. The compacted rounds are not part of it
(`compact_round_bytes_per_device` prices one).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from stringsearch_torch.parallel.distsort import redistribute_cap


def merge_split_stages(p: int) -> int:
    """Comparator stages of the bitonic merge-split network over p shards."""
    if p <= 1:
        return 0
    lg = int(math.log2(p))
    if 1 << lg != p:
        raise ValueError("power-of-two shard count required")
    return lg * (lg + 1) // 2


def sharded_sort_bytes_per_device(p: int, chunk_elems: int, n_ops: int,
                                  width: int = 4) -> int:
    """Bytes SENT per shard by one sharded_sort (receive volume equal)."""
    return merge_split_stages(p) * chunk_elems * n_ops * width


@dataclass
class CommReport:
    """Per-shard communication totals for one global build."""

    p: int
    chunk_elems: int
    rounds: int
    fan: int
    depth: int
    idx_width: int
    initial_bytes: int
    per_round_bytes: int
    total_bytes: int

    def projected_comm_seconds(self, link_gbytes_per_s: float) -> float:
        """Wire time if every shard's sends cross one link of the given
        rate (GB/s), one after another."""
        return self.total_bytes / (link_gbytes_per_s * 1e9)

    def projected_efficiency(self, compute_seconds_per_device: float,
                             link_gbytes_per_s: float) -> float:
        """compute / (compute + comm): the model's bound on scaling
        efficiency, with no overlap of compute and transfers assumed.

        `compute_seconds_per_device` is the measured build time of one
        chunk-sized problem on one device.
        """
        comm = self.projected_comm_seconds(link_gbytes_per_s)
        return compute_seconds_per_device / (compute_seconds_per_device
                                             + comm)


def rank_interval_sort_bytes_per_device(p: int, chunk_elems: int,
                                        n_ops: int, width: int = 4,
                                        cap_factor: int = 2) -> int:
    """Bytes sent per shard by one `rank_interval_sort` fast path: one
    all_to_all of n_ops [P, cap] buffers plus the boundary-repair
    ppermute of one cap-row per operand (cap from the implementation).
    Its fallback is a full merge-split sort."""
    cap = redistribute_cap(p, chunk_elems, cap_factor)
    return (cap * p + cap) * n_ops * width


def compact_round_bytes_per_device(p: int, chunk_elems: int,
                                   fan: int = 3, width: int = 4,
                                   compact_div: int = 4) -> int:
    """Bytes sent per shard by one COMPACTED round (global_sa.py
    `_compact_round`), whose volume is bounded by the live tied population.

    Inventory (M = L // compact_div, cap = 2*ceil(2M/P)):
      * straddle-repair ppermute: (M + 1) elements x 2 operands
      * shifted-key capped gathers: (fan-1) x 2 all_to_alls of [P, cap]
      * SA/sorted-rank spill ppermute: 3 x [2M]
      * text-order rank write-back: 2 all_to_alls of [P, cap]
    """
    m = max(chunk_elems // compact_div, 1)
    cap = 2 * (-(-2 * m // p))
    straddle = 2 * m * width
    gathers = (fan - 1) * 2 * p * cap * width
    spill = 3 * 2 * m * width
    writeback = 2 * p * cap * width
    return straddle + gathers + spill + writeback


def redistribute_bytes_per_device(p: int, chunk_elems: int,
                                  n_payloads: int = 1, width: int = 4,
                                  cap_factor: int = 2) -> int:
    """Bytes sent per shard by `redistribute_permutation`'s fast path: one
    all_to_all of (gidx + payload) buffers at the implementation's static
    per-pair capacity. Its fallback is a full merge-split sort."""
    cap = redistribute_cap(p, chunk_elems, cap_factor)
    return cap * p * (1 + n_payloads) * width


def global_build_comm(n: int, p: int, depth: int = 16, fan: int = 3,
                      rounds: int | None = None, idx_width: int = 4,
                      a2a_redistribute: bool = True,
                      interval_round_sort: bool = True) -> CommReport:
    """Exact per-shard communication volume of a GlobalSuffixArray build.

    `rounds`: the build's `rounds_run` when known; defaults to the schedule
    bound ceil(log_fan(n_pad/depth)) + 1 (the marker round).
    `a2a_redistribute` and `interval_round_sort` model the fast paths
    (the all_to_all redistribute; the rank-interval round sort) rather
    than the merge-split fallbacks.
    """
    chunk = max(-(-max(n, p) // p), 4)
    n_pad = chunk * p
    depth = max(4, min(depth, chunk) // 4 * 4)
    if rounds is None:
        rounds = 1 + max(0, math.ceil(
            math.log(max(n_pad / depth, 1), fan)))
    nk = depth // 4
    if a2a_redistribute:
        redist = redistribute_bytes_per_device(p, chunk, 1, idx_width)
    else:
        redist = sharded_sort_bytes_per_device(p, chunk, 2, idx_width)
    if interval_round_sort and p > 2:
        # the implementation's own branch: interval routing only for
        # P >= 4, where it beats S(P) merge-split stages (distsort.py)
        round_sort = rank_interval_sort_bytes_per_device(
            p, chunk, fan + 1, idx_width)
    else:
        round_sort = sharded_sort_bytes_per_device(
            p, chunk, fan + 1, idx_width)
    init = (
        sharded_sort_bytes_per_device(p, chunk, nk + 1)
        + redist
        + depth  # neighbour window ppermute
    )
    # shifted-key fetches: while k*h < L the source window spans only the
    # immediate next shard (from_offset(0) is free in the code), so a
    # shifted key costs ONE chunk ppermute; saturated tail rounds
    # (k*h >= L) pay two. Counted exactly from the h schedule.
    per_round = (
        (fan - 1) * chunk * idx_width  # typical (h < L) round
        + round_sort
        + redist
    )
    hop_extra = 0
    h = depth
    for _ in range(rounds):
        for k in range(1, fan):
            if k * h >= chunk:  # second neighbour hop needed
                hop_extra += chunk * idx_width
        h = min(h * fan, n_pad)
    total = init + rounds * per_round + hop_extra
    return CommReport(p=p, chunk_elems=chunk, rounds=rounds, fan=fan,
                      depth=depth, idx_width=idx_width, initial_bytes=init,
                      per_round_bytes=per_round, total_bytes=total)


def report_for(gsa) -> CommReport:
    """CommReport for a built GlobalSuffixArray (its actual rounds)."""
    import torch

    idx_width = torch.empty((), dtype=gsa.idx).element_size()
    return global_build_comm(
        gsa.n, gsa.num_shards, depth=gsa.depth, fan=gsa.fan,
        rounds=gsa.rounds_run, idx_width=idx_width,
    )
