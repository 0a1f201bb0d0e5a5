"""Partitioned suffix arrays: one batched build, merged queries.

Counterpart of stringsearch_tpu/parallel/partitioned.py: the text is split
into P partitions of L bytes (the last zero-padded), each gets its own
suffix array, and a query searches every partition and keeps the best
answer, each candidate repaired against the full text.

What differs from the JAX package, and why:
  * `jax.vmap(build_sa)` has no PyTorch counterpart, because the build's
    rounds are a host loop. All partitions are built in the SAME sorts
    instead (`engines/doubling.py`, `build_sa(..., chunk=L)`): one initial
    sort led by the partition index, then rounds whose ranks keep the
    partitions apart. A build makes as many sorts as a flat one, whatever
    P is.
  * The vmapped searches become P * B lanes over the flat arrays, each
    with its partition's offset and real length.
  * "First maximum wins" of `argmax` is written out: one maximum over
    len * P + (P - 1 - p), so the earliest partition wins a tie on every
    device.
  * The [B, P, L] mask behind `first` is never made: the occurrence
    ranges are expanded in blocks of bounded size (`_first_positions`).

Zero padding is order-safe: pad bytes sort lowest and ties break by
length in the same direction as true suffix order. Candidates that start
inside the padding are masked out, and the full-text repair removes any
influence of pad bytes on match lengths.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from stringsearch_torch.core import compare as cmp
from stringsearch_torch.core.search import (
    _ceil_log2,
    _needle_batch_to_windows,
    lcs_loop,
    needle_mask_cmp,
    sa_search_loop,
)
from stringsearch_torch.core.types import (
    BytesLike,
    LongestCommonSubstring,
    as_text_tensor,
    host_tensor,
)

_I32 = torch.int32
_I32_MAX = torch.iinfo(torch.int32).max


def build_partitioned(padded_text: torch.Tensor, num_partitions: int):
    """Build all partition SAs in one batched build.

    padded_text: uint8 [P*L]. Returns (chunks uint8 [P, L], sa int32
    [P, L]), each SA in its partition's own coordinates.
    """
    from stringsearch_torch.engines.doubling import _auto_depth, build_sa

    n = padded_text.shape[0]
    chunk = n // num_partitions
    # depth 12 (`sort`'s): with the partition index and the position a
    # deeper initial key would not fit the sort's six planes
    flat = build_sa(padded_text, depth=_auto_depth(n), chunk=chunk)
    sas = flat.view(num_partitions, chunk)
    offsets = torch.arange(num_partitions, dtype=_I32,
                           device=flat.device) * chunk
    return padded_text.view(num_partitions, chunk), sas - offsets[:, None]


def _lanes(chunks, sas, real_lens, b: int, m_width: int):
    """The P * B lanes of a batched search, lane p * B + k being needle k
    in partition p. Returns `windows_at(pos) -> (start, window)`: the
    partition-local text start of SA slot `pos` of each lane's partition
    (clamped), and its window, masked to the past-end sentinel at and
    beyond the partition's REAL length, so pad zeros never match."""
    p, chunk_len = chunks.shape
    base = (torch.arange(p, dtype=_I32, device=sas.device)
            * chunk_len).repeat_interleave(b)
    real = real_lens.repeat_interleave(b)[:, None]
    flat_sa = sas.reshape(-1)
    flat_text = chunks.reshape(-1)
    offs = torch.arange(m_width, dtype=_I32, device=sas.device)

    def windows_at(pos):
        starts = flat_sa[base + pos.clamp(0, chunk_len - 1)]
        win = cmp.gather_window(flat_text, base + starts, m_width)
        inb = (starts[:, None] + offs) < real
        return starts, torch.where(inb, win, cmp.PAST_TEXT_END)

    return windows_at


def partitioned_query(chunks, sas, full_text, real_lens, needles, lens,
                      steps: int):
    """Query all partitions, repair against the full text, reduce.

    chunks: uint8 [P, L]; sas: int32 [P, L]; full_text: uint8 [n];
    real_lens: int32 [P]; needles: int32 [B, M]; lens: int32 [B].
    Returns (start [B], length [B]) in global text coordinates. Among
    partitions with the same best length the earliest wins.
    """
    p, chunk_len = chunks.shape
    b, m_width = needles.shape
    windows_at = _lanes(chunks, sas, real_lens, b, m_width)
    starts, _lengths = lcs_loop(windows_at, chunk_len, needles.repeat(p, 1),
                                steps)
    starts = starts.view(p, b)
    part = torch.arange(p, dtype=_I32, device=sas.device)[:, None]
    global_starts = starts + part * chunk_len  # [P, B]
    valid = starts < real_lens[:, None]  # not a pure-padding suffix

    # boundary repair: the true match length against the full text covers
    # both pad-byte contamination and cross-partition extension
    windows = cmp.gather_window(full_text, global_starts, m_width)  # [P,B,M]
    true_len = cmp.prefix_match_len(windows, needles[None, :, :])  # [P, B]
    true_len = torch.where(valid, true_len, -1)

    # one maximum decides length and partition: the longer match wins,
    # and among equal lengths the smaller p
    best = (true_len * p + (p - 1 - part)).amax(0)  # [B]
    best_len = torch.div(best, p, rounding_mode="floor")
    best_p = (p - 1) - (best - best_len * p)
    best_start = global_starts.gather(0, best_p[None, :].to(torch.int64))[0]
    return best_start, best_len.clamp(min=0)


# `_first_positions` expands at most this many slots at a time, or n / 8 of
# them if that is more
_RANGE_BLOCK = 1 << 20


def _first_positions(sas, lo, up):
    """first[k] = the least global text position sas[p, i] + p * L over
    i in [lo[p, k], up[p, k]) and every partition p (int32 [B]; INT32_MAX
    where needle k has no slot). sas: int32 [P, L]; lo, up: int32 [P, B].

    The ranges together may hold many times n = P * L slots (a frequent
    needle in a large batch), so no [B, P, L] mask is made. The slots of
    all lanes are numbered in one sequence and expanded `block` at a time,
    block = max(2^20, n / 8); a slot takes under 80 bytes of temporaries,
    so the memory is bounded by 10 n bytes (or 80 MB) whatever B is. One
    host fetch, of the number of slots.
    """
    p, chunk_len = sas.shape
    b = lo.shape[1]
    dev = sas.device
    flat = sas.reshape(-1)
    counts = (up - lo).reshape(-1).to(torch.int64)  # lane p * B + k
    ends = torch.cumsum(counts, 0)
    slots = int(ends[-1])
    base = torch.arange(p, device=dev)[:, None] * chunk_len
    # slot number e of the sequence is SA slot first_slot[lane] + e
    first_slot = (base + lo).reshape(-1) - (ends - counts)
    out = torch.full((b,), _I32_MAX, dtype=_I32, device=dev)
    block = max(_RANGE_BLOCK, flat.shape[0] // 8)
    for begin in range(0, slots, block):
        e = torch.arange(begin, min(begin + block, slots), device=dev)
        lane = torch.searchsorted(ends, e, right=True)
        slot = first_slot[lane] + e
        start_of_part = torch.div(slot, chunk_len, rounding_mode="floor")
        pos = flat[slot] + (start_of_part * chunk_len).to(_I32)
        out.scatter_reduce_(0, lane % b, pos, "amin")
    return out


def partitioned_search(chunks, sas, real_lens, needles, lens, steps: int):
    """Batched in-partition exact-occurrence search over all partitions.

    Returns (count [B], first [B]): `count` is the number of occurrences
    lying entirely inside SOME partition (partitions are disjoint, so no
    occurrence is counted twice); `first` the smallest global text
    position among them, -1 when count is 0.

    Each partition runs the shared double binary search over its own SA
    with windows masked at the partition's REAL length, so pad bytes never
    extend a match and a suffix that runs out at the partition end cannot
    match a longer needle. The last partitions' pad slots hold DUPLICATES
    of their smallest real suffix (see the constructor); duplicates inside
    [lo, up) are subtracted from the count. Their positions cannot change
    `first`: the original is in range with the same position.
    """
    p, chunk_len = chunks.shape
    b, m_width = needles.shape
    dev = sas.device
    windows_at = _lanes(chunks, sas, real_lens, b, m_width)
    compare = needle_mask_cmp(needles.repeat(p, 1), lens.repeat(p))

    def cmp_at(pos):
        return compare(windows_at(pos)[1])

    lo, up = sa_search_loop(cmp_at, chunk_len, p * b, steps, dev)
    lo, up = lo.view(p, b), up.view(p, b)
    pad_p = (chunk_len - real_lens)[:, None]  # [P, 1]
    dup_in_range = torch.minimum((pad_p - lo).clamp(min=0), up - lo)
    total = (up - lo - dup_in_range).sum(0, dtype=_I32)  # [B]

    first = _first_positions(sas, lo, up)
    return total, torch.where(total > 0, first, -1)


class PartitionedSuffixArray:
    """P per-partition suffix arrays over one text.

    Construction sorts all partitions at once; queries search all
    partitions; a match crossing a boundary may be shorter than the
    full-text optimum (every candidate is repaired against the full text,
    which mitigates it).
    """

    def __init__(
        self,
        text: BytesLike,
        num_partitions: int,
        engine: Union[str, Callable, None] = None,
        device=None,
    ):
        if num_partitions < 1:
            raise ValueError("num_partitions must be >= 1")
        self.text = as_text_tensor(text, device)
        dev = self.text.device
        n = int(self.text.shape[0])
        self._num_partitions = num_partitions
        part = -(-max(n, num_partitions) // num_partitions)  # ceil, >= 1
        self.partition_size = part
        pad = part * num_partitions - n
        padded = (torch.cat([self.text, self.text.new_zeros((pad,))])
                  if pad else self.text)
        self.real_lens = torch.tensor(
            [max(0, min(n - i * part, part)) for i in range(num_partitions)],
            dtype=_I32, device=dev)
        if engine is None or engine == "doubling":
            self.chunks, self.sas = build_partitioned(padded, num_partitions)
        elif callable(engine):
            self.chunks, self.sas = self._build_with_callable(
                padded, num_partitions, engine)
        else:
            self.chunks, self.sas = self._build_with_callable(
                padded, num_partitions, None, engine_name=engine)
        # Pad suffixes (all-zero strings) are the smallest suffixes of a
        # padded chunk, so they take exactly the first `pad` slots of its
        # SA. A zero-leading needle's binary search would surface one of
        # them as the partition's only candidate, which the validity mask
        # then discards, losing real in-partition matches. Overwrite those
        # slots with duplicates of the smallest REAL suffix: the array
        # stays sorted, and the search only ever returns real candidates.
        if pad:
            pad_counts = part - self.real_lens  # [P]
            smallest_real = self.sas.gather(
                1, pad_counts.clamp(max=part - 1)[:, None].to(torch.int64))
            cols = torch.arange(part, dtype=_I32, device=dev)
            self.sas = torch.where(cols < pad_counts[:, None], smallest_real,
                                   self.sas)
        self._host_text: Optional[np.ndarray] = None

    @staticmethod
    def _build_with_callable(padded, num_partitions, fn, engine_name=None):
        """One build a partition, in a host loop: `fn` (or the engine of
        that name) takes the chunk, a tensor on the index's device, and
        returns a SuffixArray."""
        from stringsearch_torch.engines import get_engine

        if fn is None:
            fn = get_engine(engine_name)
        chunks = padded.view(num_partitions, -1)
        sas = torch.stack([
            torch.as_tensor(fn(chunks[i]).sa).to(padded.device, _I32)
            for i in range(num_partitions)])
        return chunks, sas

    def num_partitions(self) -> int:
        return self._num_partitions

    def text_bytes(self) -> np.ndarray:
        if self._host_text is None:
            self._host_text = self.text.cpu().numpy()
        return self._host_text

    def _steps(self) -> int:
        return _ceil_log2(self.partition_size + 1) + 1

    def longest_substring_match_batch(
        self, needles: Sequence[BytesLike]
    ) -> list[LongestCommonSubstring]:
        if not needles:
            return []
        host = self.text_bytes()
        if len(host) == 0:
            return [LongestCommonSubstring(host, 0, 0) for _ in needles]
        padded, lens, _w = _needle_batch_to_windows(needles)
        dev = self.text.device
        start, length = partitioned_query(
            self.chunks, self.sas, self.text, self.real_lens,
            host_tensor(padded, dev), host_tensor(lens, dev), self._steps())
        both = torch.stack([start, length]).cpu().numpy()  # one host fetch
        start, length = both[0], both[1]
        return [
            LongestCommonSubstring(host, int(start[i]), int(length[i]))
            for i in range(len(needles))
        ]

    def longest_substring_match(self, needle: BytesLike) -> LongestCommonSubstring:
        return self.longest_substring_match_batch([needle])[0]

    def sa_search_batch(self, needles: Sequence[BytesLike]):
        """Batched exact search: [(count, first_text_pos)] per needle.

        PARTITIONED SEMANTICS (they differ from the flat `sa_search`):
        `count` is the number of occurrences lying entirely inside a
        single partition; an occurrence crossing a partition boundary is
        NOT counted, so count <= the full-index count, with equality
        whenever no occurrence crosses a boundary. A partitioned index has
        no global SA slot, so the second element is the smallest global
        TEXT position of a counted occurrence (-1 when count is 0).
        """
        if not needles:
            return []
        n = int(self.text.shape[0])
        out_empty = [len(bytes(nd)) == 0 for nd in needles]
        if n == 0:
            return [(0, -1) for _ in needles]
        padded, lens, _w = _needle_batch_to_windows(needles)
        dev = self.text.device
        count, first = partitioned_search(
            self.chunks, self.sas, self.real_lens,
            host_tensor(padded, dev), host_tensor(lens, dev), self._steps())
        both = torch.stack([count, first]).cpu().numpy()  # one host fetch
        count, first = both[0], both[1]
        return [
            (n, 0) if out_empty[i] else (int(count[i]), int(first[i]))
            for i in range(len(needles))
        ]

    def sa_search(self, needle: BytesLike):
        return self.sa_search_batch([needle])[0]

    def sa_simplesearch(self, c: int):
        """(count, first_text_pos) for the single byte `c`. Single-byte
        occurrences never cross a boundary, so the count equals the
        full-text count."""
        return self.sa_search(bytes([c]))
