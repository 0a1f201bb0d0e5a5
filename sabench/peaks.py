"""Published peaks of the card and the byte bounds of the kernels.

Frozen copies, so that a change to the program cannot move the yardstick:
the memory rate and `bound` are those of `chip_smoke.py` (`BYTES_PER_S`,
`bound`, `sort_bounds`), whose arithmetic counts each plane read once and
written once. Only the bytes bound is kept: every kernel measured here is
bound by bytes, and the int32 operation peak that `chip_smoke.py` carries
(33.5e12, assumed, with no cited source) never set one of its bounds.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s, at the full
# 700 W power limit.
BYTES_PER_S = 3.35e12


def bound_s(nbytes: float) -> float:
    """The least time the card can take to move `nbytes`."""
    return nbytes / BYTES_PER_S


def sort_bytes(planes) -> int:
    """A sort of `planes` (1-D tensors of one length): each plane read once
    and written once. `8 * C * n` for C int32 planes of n elements, as
    `chip_smoke.py:sort_bounds` counts it."""
    return 2 * sum(p.numel() * p.element_size() for p in planes)


def pack_keys_bytes(text, out) -> int:
    """`pack_keys`: the text read once, each key and position plane
    written once (17n at depth 12: 3 key planes and the position)."""
    return text.numel() * text.element_size() + sum(
        p.numel() * p.element_size() for p in out)


def shift_planes_bytes(rank, out) -> int:
    """`shift_planes`: the rank plane read once, each shifted plane and the
    position written once (20n in a fan-4 round)."""
    return rank.numel() * rank.element_size() + sum(
        p.numel() * p.element_size() for p in out)


def head_ranks_bytes(sorted_planes, rank_s) -> int:
    """`head_ranks`: the sorted key planes (all but the payload) read
    once, the ranks written once (20n after the round's C=5 sort, 16n
    after the initial C=4 sort)."""
    keys = sorted_planes[:-1]
    return sum(p.numel() * p.element_size() for p in keys) + (
        rank_s.numel() * rank_s.element_size())
