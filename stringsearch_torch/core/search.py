"""SA queries: longest-common-substring match and exact pattern search.

Counterpart of stringsearch_tpu/core/search.py. The binary searches are
batched over needles: every step gathers a fixed-width window of the text
at each lane's probe and decides all lanes with one vectorized compare, for
ceil(log2(n+1)) + 1 steps. The steps are a host loop of device ops with no
synchronisation; each batch makes one device-to-host fetch at the end.
The two binary searches are generators (`lcs_steps`, `sa_search_steps`)
that yield their probe positions, so several searches can be driven in
lock step (`run_in_lockstep`): the global index's shards share each
probe's window fetch. `lcs_loop` and `sa_search_loop` drive one.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from stringsearch_torch.core import compare as cmp
from stringsearch_torch.core.types import (
    BytesLike,
    LongestCommonSubstring,
    SuffixArray,
    host_tensor,
    host_u8,
)


def _ceil_log2(n: int) -> int:
    return max(1, int(n - 1).bit_length()) if n > 1 else 1


def _needle_batch_to_windows(needles: Sequence[BytesLike]) -> tuple[np.ndarray, np.ndarray, int]:
    """Pad a list of needles to a shared pow2 window width (min 16)."""
    arrs = [host_u8(nd) for nd in needles]
    maxm = max((len(a) for a in arrs), default=1)
    width = 16
    while width < maxm:
        width *= 2
    out = np.full((len(arrs), width), cmp.PAST_NEEDLE_END, dtype=np.int32)
    lens = np.zeros((len(arrs),), dtype=np.int32)
    for i, a in enumerate(arrs):
        out[i, : len(a)] = a.astype(np.int32)
        lens[i] = len(a)
    return out, lens, width


def run_in_lockstep(searches, probe):
    """Drive binary searches written as generators (`lcs_steps`,
    `sa_search_steps`) in lock step.

    Each generator yields the SA positions it probes and is sent back what
    `probe` answered for them; `probe` takes the list of every search's
    positions and returns the list of answers, so one call can serve all
    of them at once (the sharded text mode of parallel/global_sa.py makes
    one collective of it). Returns the list of the searches' results.
    """
    searches = list(searches)
    positions = [next(s) for s in searches]
    while True:
        answers = probe(positions)
        positions, results = [], []
        for search, answer in zip(searches, answers):
            try:
                positions.append(search.send(answer))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            if positions:
                raise RuntimeError("searches of one batch fell out of step")
            return results


def lcs_steps(n_sa: int, needles: torch.Tensor, steps: int):
    """The batched LCS binary search as a generator: it yields SA positions
    `pos` [B] and is sent (text_start [B], window [B, M] int32 with
    PAST_TEXT_END sentinels) for them (callers clamp); it returns
    (start, length)."""
    b = needles.shape[0]
    dev = needles.device
    lo = torch.zeros((b,), dtype=torch.int32, device=dev)
    hi = torch.full((b,), n_sa, dtype=torch.int32, device=dev)
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        _, suff = yield mid
        less = cmp.lex_less(suff, needles)  # suffix < needle
        active = lo < hi
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)

    # the longest common prefix is at a neighbour of the insertion point
    left, right = lo - 1, lo
    start_l, win_l = yield left
    start_r, win_r = yield right
    lcp_l = cmp.prefix_match_len(win_l, needles)
    lcp_r = cmp.prefix_match_len(win_r, needles)
    lcp_l = torch.where(left >= 0, lcp_l, -1)
    lcp_r = torch.where(right <= n_sa - 1, lcp_r, -1)
    take_left = lcp_l >= lcp_r
    start = torch.where(take_left, start_l, start_r)
    length = torch.where(take_left, lcp_l, lcp_r).clamp(min=0)
    return start, length


def lcs_loop(windows_at, n_sa: int, needles: torch.Tensor, steps: int):
    """Batched LCS binary search with a pluggable suffix-window fetch.

    windows_at(pos [B]) -> (text_start [B], window [B, M] int32 with
    PAST_TEXT_END sentinels) for SA positions `pos` (callers clamp).
    """
    return run_in_lockstep([lcs_steps(n_sa, needles, steps)],
                           lambda pos: [windows_at(pos[0])])[0]


def lcs_kernel(text, sa, needles, steps: int):
    """Batched LCS query. needles: int32 [B, M] padded with PAST_NEEDLE_END.

    Returns (start [B], length [B]) int32: position in the text of the
    longest needle-prefix match and its length. `sa` may be a sorted slice
    of a larger suffix array; bounds come from its length.
    """
    n_sa = sa.shape[0]
    m_width = needles.shape[-1]

    def windows_at(pos):
        starts = sa[pos.clamp(0, n_sa - 1)]
        return starts, cmp.gather_window(text, starts, m_width)

    return lcs_loop(windows_at, n_sa, needles, steps)


def sa_search_steps(n_sa: int, b: int, steps: int, device):
    """The batched double binary search as a generator: it yields SA
    positions `pos` [B] and is sent the int32 [B] three-way compare of the
    suffix at each against its lane's needle; it returns (lo [B], up [B]),
    the lower and upper insertion points: count = up - lo, leftmost
    occurrence slot = lo."""
    lo_l = torch.zeros((b,), dtype=torch.int32, device=device)
    hi_l = torch.full((b,), n_sa, dtype=torch.int32, device=device)
    lo_u = torch.zeros((b,), dtype=torch.int32, device=device)
    hi_u = torch.full((b,), n_sa, dtype=torch.int32, device=device)
    for _ in range(steps):
        mid_l = torch.div(lo_l + hi_l, 2, rounding_mode="floor")
        c_l = yield mid_l
        act = lo_l < hi_l
        less = c_l < 0
        lo_l = torch.where(act & less, mid_l + 1, lo_l)
        hi_l = torch.where(act & ~less, mid_l, hi_l)

        mid_u = torch.div(lo_u + hi_u, 2, rounding_mode="floor")
        c_u = yield mid_u
        act = lo_u < hi_u
        leq = c_u <= 0
        lo_u = torch.where(act & leq, mid_u + 1, lo_u)
        hi_u = torch.where(act & ~leq, mid_u, hi_u)
    return lo_l, lo_u


def sa_search_loop(cmp_at, n_sa: int, b: int, steps: int, device):
    """Batched double binary search with a pluggable probe compare.

    cmp_at(pos [B]) -> int32 [B]: three-way compare of the suffix at SA
    position `pos` against each lane's needle. Returns (lo [B], up [B]),
    the lower and upper insertion points: count = up - lo, leftmost
    occurrence slot = lo.
    """
    return run_in_lockstep([sa_search_steps(n_sa, b, steps, device)],
                           lambda pos: [cmp_at(pos[0])])[0]


def needle_mask_cmp(needles, lens):
    """Build `windows -> cmp` that compares only each lane's first
    len(needle) bytes (the rest neutralized to equal sentinels)."""
    m_width = needles.shape[-1]
    offs = torch.arange(m_width, dtype=torch.int32, device=needles.device)
    within = offs[None, :] < lens[:, None]  # [B, M]

    def compare(suff):
        suff_m = torch.where(within, suff, cmp.PAST_NEEDLE_END)
        return cmp.lex_cmp(suff_m, needles)  # -1/0/+1 vs needle prefix

    return compare


def sa_search_kernel(text, sa, needles, lens, steps: int):
    """Batched exact-occurrence search: returns (count [B], left [B]).

    `left` is the SA index of the leftmost occurrence (the lower bound).
    """
    n = text.shape[0]
    m_width = needles.shape[-1]
    compare = needle_mask_cmp(needles, lens)

    def cmp_at(pos):
        starts = sa[pos.clamp(0, n - 1)]
        return compare(cmp.gather_window(text, starts, m_width))

    lo, up = sa_search_loop(cmp_at, n, needles.shape[0], steps, needles.device)
    return up - lo, lo


def simplesearch_kernel(text, sa, chars):
    """Single-character occurrence search, batched over chars [B].

    Returns (count [B], left [B]). The SA's first-character column is
    nondecreasing, so both bounds are one searchsorted each.
    """
    first = text[sa].to(torch.int32)  # nondecreasing [n]
    c = chars.to(torch.int32)
    left = torch.searchsorted(first, c, side="left").to(torch.int32)
    right = torch.searchsorted(first, c, side="right").to(torch.int32)
    return right - left, left


def sa_simplesearch(index: SuffixArray, c: int) -> tuple[int, int]:
    """(count, leftmost SA index) of suffixes starting with byte `c`."""
    if len(index) == 0:
        return 0, 0
    chars = torch.tensor([c], dtype=torch.int32, device=index.device)
    count, left = simplesearch_kernel(index.text, index.sa, chars)
    both = torch.stack([count, left]).cpu().numpy()  # one host fetch
    return int(both[0, 0]), int(both[1, 0])


# ---------------------------------------------------------------------------
# host-facing wrappers
# ---------------------------------------------------------------------------

def longest_substring_match_batch(
    index: SuffixArray, needles: Sequence[BytesLike]
) -> list[LongestCommonSubstring]:
    if not needles:
        return []
    n = len(index)
    if n == 0:
        host = index.text_bytes()
        return [LongestCommonSubstring(host, 0, 0) for _ in needles]
    padded, _lens, _w = _needle_batch_to_windows(needles)
    steps = _ceil_log2(n + 1) + 1
    start, length = lcs_kernel(index.text, index.sa,
                               host_tensor(padded, index.device), steps)
    both = torch.stack([start, length]).cpu().numpy()  # one host fetch
    start, length = both[0], both[1]
    host = index.text_bytes()
    return [
        LongestCommonSubstring(host, int(start[i]), int(length[i]))
        for i in range(len(needles))
    ]


def longest_substring_match(index: SuffixArray, needle: BytesLike) -> LongestCommonSubstring:
    return longest_substring_match_batch(index, [needle])[0]


def sa_search_batch(
    index: SuffixArray, needles: Sequence[BytesLike]
) -> list[tuple[int, int]]:
    if not needles:
        return []
    n = len(index)
    if n == 0:
        return [(0, 0) for _ in needles]
    padded, lens, _w = _needle_batch_to_windows(needles)
    steps = _ceil_log2(n + 1) + 1
    count, left = sa_search_kernel(
        index.text, index.sa, host_tensor(padded, index.device),
        host_tensor(lens, index.device), steps,
    )
    both = torch.stack([count, left]).cpu().numpy()  # one host fetch
    count, left = both[0], both[1]
    return [(int(count[i]), int(left[i])) for i in range(len(needles))]


def sa_search(index: SuffixArray, needle: BytesLike) -> tuple[int, int]:
    return sa_search_batch(index, [needle])[0]
