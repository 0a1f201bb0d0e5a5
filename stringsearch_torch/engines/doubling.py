"""Prefix-doubling SACA with tied-group compaction, in PyTorch.

Counterpart of stringsearch_tpu/engines/doubling.py; the algorithm is the
same, step for step:

  1. initial ranks from a `depth`-byte packed key (depth/4 keys of four
     raw bytes, zero-padded past the end; one multi-key sort);
  2. full-width fan rounds, sorting by (rank[i], rank[i+h], ..,
     rank[i+(fan-1)h]) while more than n/levels[0] positions stay tied;
  3. cascaded compaction: tied-group members move to capacity-n/levels[i]
     arrays and only they are re-sorted, rank/SA updates scattered back.

Every sort goes through `ops.bitonic.device_sort`: the Hopper radix sort
on CUDA, the plain chained sort on the CPU, both stable.

What differs from the JAX package, and why:
  * The loops (`lax.while_loop`, `cond`, `switch`) are host loops that
    read the tied count with one `.item()` per round; `h` is a host int.
  * The steps between the sorts are `ops/steps.py`: `pack_keys`,
    `shift_planes` and `head_ranks`, each one hand-written kernel on
    CUDA, where XLA fuses the reference's jnp ops.
  * A full round's keys are written in the bits their values need, so
    that the radix sort's dead-digit skip engages (`_round_keys`): where
    it saves passes, the round sorts by dense ranks, each group's index
    among the groups (`dense_ranks`), in place of head slots, and a shift
    plane whose values stay below 2^24 takes non-negative past-the-end
    markers (`shift_planes`' `lift`). Both keep the keys' order, so the
    sorted order, the head-slot ranks a round returns and its tied count
    are the reference's. The inverse
    permutation of a sorted order's ranks is `invert_ranks`, a scatter
    (a hand-written kernel on CUDA), where the reference sorts (sa, rank_s)
    by sa. Group heads (the
    reference's `cummax`) come on CUDA from `head_ranks`' scan with
    decoupled look-back; on the CPU, and in the compaction rounds and the
    bstar engine on both, from a cumsum and a scatter (`_segment_heads`).
  * Packed keys are int32 with bit 31 flipped (`^ 0x80000000`), so signed
    order equals the reference's uint32 order.
  * `_shift_ranks` clamps its shift explicitly (`dynamic_slice` clamped it
    implicitly).
  * The compaction rounds update rank and SA in place, in [n+1] buffers
    whose last slot absorbs the pads' writes (the reference's scatter
    with mode="drop").
  * On CUDA `torch.topk` orders ties freely, so tied-group members may
    come out of `_extract` in another order than in the reference. Nothing
    downstream depends on that order, nor on the sort's order inside ties:
    group membership, heads and counts are the same, and the final SA is
    unique.
  * The reference builds the partitions of a partitioned index with
    `jax.vmap(build_sa)`. Here the same functions build them all in the
    same sorts: the text is `n / chunk` chunks of `chunk` bytes, each
    sorted for itself. The initial sort is led by the chunk index, after
    which the head-slot ranks keep chunks apart by themselves (chunk p
    owns slots [p * chunk, (p + 1) * chunk)); every test for "past the
    end" is a test against the END OF THE SUFFIX'S CHUNK. The flat build
    is the case of one chunk (`chunk == n`), with the same sorts as ever.
The flat build records its phases as spans (`harness/tracing.py`, on only
under `torch.profiler`): `doubling.build`, `doubling.initial`, each
`doubling.round`, each `doubling.invert`, `doubling.compact` and inside
it `doubling.extract`, `doubling.compact_round` and `doubling.shrink`,
and `doubling.wait` around each read of a tied count.
Indexes are int32 (n < 2^31) unless `idx=torch.int64`: then positions,
ranks and the SA are int64, and the packed text keys stay int32. On CUDA
`device_sort` sorts an int64 plane as two int32 planes.
"""

from __future__ import annotations

import numpy as np
import torch

from stringsearch_torch.core.types import (
    DEFAULT_DEVICE,
    SuffixArray,
    as_text_tensor,
)
from stringsearch_torch.harness.tracing import span, wait_span
from stringsearch_torch.ops.bitonic import device_sort, sort_passes
from stringsearch_torch.ops.steps import (
    BIAS as _BIAS,
    chunk_len as _chunk_len,
    dense_ranks,
    head_ranks,
    heads_and_tied as _heads_and_tied,
    invert_ranks,
    pack_keys,
    read_counts,
    segment_heads as _segment_heads,
    shift_planes,
)

_I32 = torch.int32
_IDX = (torch.int32, torch.int64)


def _sent(dtype) -> int:
    """The pad and sentinel value of an index dtype: its largest value."""
    return torch.iinfo(dtype).max


def _check_idx(idx) -> None:
    if idx not in _IDX:
        raise TypeError(f"idx must be torch.int32 or torch.int64, got {idx}")


def _check_args(idx, depth: int, fan: int) -> None:
    _check_idx(idx)
    if depth % 4 or depth < 4:
        raise ValueError("depth must be a positive multiple of 4")
    if fan < 2:
        # fan=1 would make h_n == h so the loops never advance
        raise ValueError("fan must be >= 2")


def _iota(n: int, device, dtype=_I32) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


def _pack4_keys(text: torch.Tensor, depth: int, chunk=None) -> tuple:
    """depth/4 int32 keys of four RAW text bytes each, zero-padded, biased.

    Key k of suffix i is bytes i+4k .. i+4k+3, big-endian, XOR 0x80000000:
    as signed int32 it orders like the reference's uint32 key. The zero
    padding starts at the end of the suffix's chunk: no key reads across
    a chunk's end. The key planes of `pack_keys`.
    """
    planes = pack_keys(text, depth, chunk)
    lead = len(planes) - 1 - depth // 4
    return tuple(planes[lead:-1])


def _scatter_to_text_order(sa, rank_s, out=None):
    """rank[sa] = rank_s: sa is a permutation, so one scatter places
    rank_s[j] at text position sa[j] (`invert_ranks`; into the first n
    slots of `out` where it is given). The span `doubling.invert` holds
    the operation, whatever implements it."""
    with span("doubling.invert"):
        return invert_ranks(sa, rank_s, out)


def _read_count(count_t) -> int:
    """The tied count on the host: the round loop's one host wait, in the
    span `doubling.wait`."""
    with wait_span("doubling.wait"):
        return int(count_t)


def _read_counts(count_t) -> tuple:
    """The tied count and the group count of a `head_ranks` count on the
    host, (tied, groups), in one read (`read_counts`): the round loop's one
    host wait, in the span `doubling.wait`."""
    with wait_span("doubling.wait"):
        return read_counts(count_t)


def _shift_ranks(rank, h: int, chunk=None):
    """rank_h[i] = rank[i+h], or the marker -(i+1) past the end of i's
    chunk, i counted from the chunk's start.

    The marker is negative (an ended suffix sorts before every continuing
    one) and strictly decreasing in i (two suffixes that both end within
    the window split at once, shorter first). Shifts above the chunk
    length are clamped to it, where every entry is a marker. The first
    plane of `shift_planes`.
    """
    return shift_planes(rank, (h,), chunk)[0]


def _ranks_sorted_only(out):
    """Head-slot ranking of a sorted (keys..., payload) tuple, in sorted
    order only. Returns (sa_s, rank_s, count) with count a 0-d tensor.

    The text-order rank is not computed here: each round inverts its
    predecessor's ranks just before it needs them, so a build that
    resolves never pays the last inverse-permutation sort. `head_ranks`.
    """
    return head_ranks(out)


def _initial_sorted(text, depth: int = 24, chunk=None, idx=_I32):
    """`depth`-byte initial sort. Returns (sa_s, rank_s, count_tied),
    positions and ranks of dtype `idx`.

    With more than one chunk the chunk index leads the keys, so chunk p
    comes out in slots [p * chunk, (p + 1) * chunk) and no group of tied
    suffixes spans two chunks.
    """
    planes = pack_keys(text, depth, chunk, idx)
    out = device_sort(planes, num_keys=len(planes) - 1)
    del planes
    return _ranks_sorted_only(out)


def _initial(sort):
    """sort(), an initial sort that returns (sa_s, rank_s, count_tied)
    as `head_ranks` does, with its tied and group counts read on the host,
    in the span `doubling.initial` (attributes `tied`, `groups`). Returns
    (sa_s, rank_s, count, groups)."""
    with span("doubling.initial") as sp:
        sa_s, rank_s, count = sort()
        count, groups = _read_counts(count)
        sp.set(tied=count, groups=groups)
    return sa_s, rank_s, count, groups


def _initial_full(text, depth: int = 24):
    """`depth`-byte initial sort. Returns (rank, sa_s, rank_s, count_tied)."""
    sa_s, rank_s, count = _initial_sorted(text, depth)
    return _scatter_to_text_order(sa_s, rank_s), sa_s, rank_s, count


def _full_round(rank, h: int, fan: int = 2):
    """`_full_round_sorted` and the inverse permutation of its ranks.
    Returns (rank, sa_s, rank_s, count)."""
    sa_s, rank_s, count = _full_round_sorted(rank, h, fan)
    return _scatter_to_text_order(sa_s, rank_s), sa_s, rank_s, count


def _round_shifts(h: int, fan: int, chunk: int) -> list:
    """The shifts of a full round's fan - 1 shifted planes, k h for k = 1
    .. fan - 1, each clamped to the chunk."""
    # k*h can overflow for huge n: cap h at chunk//k + 1 first, so the
    # product is <= chunk + k, then clamp
    return [min(min(h, chunk // k + 1) * k, chunk) for k in range(1, fan)]


def _full_round_sorted(rank, h: int, fan: int = 2, chunk=None, lift=False):
    """One full-width round from TEXT-order ranks, without the trailing
    inverse permutation. Returns (sa_s, rank_s, count) in sorted order.

    The keys are (rank[i], rank[i+h], .., rank[i+(fan-1)h]), each a
    depth-h class, so one round multiplies the resolved depth by `fan`.
    Ranks of different chunks never meet, so the first key keeps the
    chunks apart. `lift` (`shift_planes`') writes the shifted planes with
    non-negative markers; any order-keeping ranks give the same result.
    """
    n = rank.shape[0]
    chunk = _chunk_len(n, chunk)
    planes = shift_planes(rank, _round_shifts(h, fan, chunk), chunk, lift)
    out = device_sort((rank, *planes), num_keys=fan)
    del planes
    return _ranks_sorted_only(out)


# A key plane whose values all lie in [0, 2^24) has a dead top radix
# digit: lifted shift planes, and dense ranks, are used only there.
_NARROW = 1 << 24


def _shift_spans(bound: int, s: int, chunk: int, lifted: bool) -> list:
    """The values of a round's shift plane s over ranks in [0, bound), as
    inclusive spans: the past-the-end markers (none for s = 0) and the
    continuing ranks (none where s clamps to the chunk)."""
    if lifted:
        spans = [(0, s - 1)] + ([(s, s + bound - 1)] if s < chunk else [])
    else:
        spans = [(-chunk, s - chunk - 1)] + (
            [(0, bound - 1)] if s < chunk else [])
    return spans[1:] if s == 0 else spans


def _round_keys(groups: int, n: int, chunk: int, shifts, wide: bool) -> tuple:
    """How a full round writes its keys: (dense, lifts, passes).

    Head slots lie in [0, n); dense ranks in [0, groups). A shift plane is
    lifted where its values, the ranks' bound plus the shift, fit under
    2^24; `passes` is the radix sort's reckoned live passes. Dense ranks
    are taken where they need fewer passes than head slots, and only
    while groups < 2^24.
    """
    def reckon(bound):
        lifts = [s + bound <= _NARROW for s in shifts]
        planes = [[(0, bound - 1)]] + [
            _shift_spans(bound, s, chunk, up) for s, up in zip(shifts, lifts)]
        return lifts, sort_passes(planes, wide)

    slot = reckon(n)
    if groups < _NARROW:
        dense = reckon(groups)
        if dense[1] < slot[1]:
            return (True, *dense)
    return (False, *slot)


def _extract(rank_s, sa_s, m: int, method: str = "topk"):
    """Compact the members of all tied groups into capacity-m arrays.

    Returns (g [m], pos [m]): group-head ranks and text positions, sorted
    by g (groups contiguous). Pad slots carry g = the dtype's largest
    value (`_sent`), pos = n.
    "topk" takes the m smallest masked keys, "sort" sorts all of them;
    both give the same groups, in any order inside a group.
    """
    n = rank_s.shape[0]
    sent = _sent(rank_s.dtype)
    j = _iota(n, rank_s.device, rank_s.dtype)
    nxt_head = torch.cat([rank_s[1:], rank_s.new_full((1,), -1)])
    tied = (rank_s != j) | (nxt_head == rank_s)
    key = torch.where(tied, rank_s, sent)
    if method == "topk":
        g, idxs = torch.topk(key, m, largest=False, sorted=True)
        pos = torch.where(g == sent, n, sa_s[idxs])
        return g, pos
    ks, pos = device_sort((key, sa_s), num_keys=1)
    g = ks[:m]
    pos = torch.where(g == sent, n, pos[:m])
    return g, pos


def _compact_round(g, pos, rank, sa, h: int, fan: int = 2, chunk=None):
    """One compacted round over the tied groups only.

    g/pos: [m] group-head ranks + positions (pads g=`_sent`, pos=n).
    rank/sa: the full state as [n+1] buffers, updated IN PLACE; slot n
    takes the pads' writes and is never read. Returns
    (g', pos', rank, sa, count) with resolved entries blanked to pads.
    Keys (g, rank[pos+h], .., rank[pos+(fan-1)h]) advance the depth to
    fan*h; every rank in the full array has depth >= h.
    """
    n = rank.shape[0] - 1
    chunk = _chunk_len(n, chunk)
    m = g.shape[0]
    dev = g.device
    sent = _sent(g.dtype)
    j = _iota(m, dev, g.dtype)
    # a pad's pos is n, which looks like the first byte of a chunk: pads
    # are past the end whatever the shift
    local = pos % chunk
    pad = g == sent
    shift_keys = []
    for k in range(1, fan):
        # overflow guard as in _full_round_sorted; the past-end test is
        # written as local >= chunk - s_k, and the sum pos + s_k is only
        # used where that test failed, so it stays inside pos's chunk
        s_k = min(h, chunk // k + 1) * k
        past = (local >= chunk - s_k) | pad
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
    valid = g_s != sent
    slot = torch.where(valid, g_s + (j - ghead), n)
    new_g = torch.where(valid, g_s + (rhead - ghead), sent)
    rank[torch.where(valid, pos_s, n)] = new_g
    sa[slot] = pos_s
    nxt_rhead = torch.cat([rhead[1:], rhead.new_full((1,), -1)])
    tied = valid & ((rhead != j) | (nxt_rhead == rhead))
    g_next = torch.where(tied, new_g, sent)
    pos_next = torch.where(tied, pos_s, n)
    return g_next, pos_next, rank, sa, tied.sum()


def _shrink(g, pos, m2: int):
    """Re-compact level arrays into capacity m2 (pads sort last).

    The caller guarantees at most m2 live (non-pad) entries."""
    g2, p2 = device_sort((g, pos), num_keys=2)
    return g2[:m2], p2[:m2]


def _next_h(h: int, chunk: int, fan: int) -> int:
    return min(min(h, chunk // fan + 1) * fan, chunk)


def _refine(sa_s0, rank_s0, count0: int, groups0: int, h0: int, levels,
            fan: int, extract: str = "auto", adaptive: bool = True,
            want_isa: bool = True, chunk=None):
    """Doubling rounds + cascaded compaction from a sorted initial state
    with `count0` positions tied in `groups0` groups (host ints).

    Returns (sa, isa), or (sa, sa) when `want_isa` is False and the build
    resolved in the full rounds. The state between full rounds is sorted
    order only; each round inverts its predecessor's ranks first.

    `extract` = "sort" | "topk" | "auto" (top-k for capacities <= n/32).
    `adaptive` extracts straight into the deepest level whose capacity
    holds the live tied count.

    Each full round writes its keys as `_round_keys` reckons from the
    group count and its shifts: dense ranks (`dense_ranks` of the
    predecessor's head slots, in their place) or head slots, and lifted
    shift planes where they fit; it returns head slots either way.

    Spans (`harness/tracing.py`): `doubling.round` a full round (the
    elements `n` its sort carries, the tied count `tied_in` going in and
    `tied_out` coming out, the group count `groups` going in, its keys
    `keys`, "dense" or "slot", and `live_passes`, the radix passes
    `_round_keys` reckons its sort to run), `doubling.compact` the
    compaction stage from
    its opening invert on, and inside it `doubling.extract`,
    `doubling.compact_round` (the capacity `m` its sort carries,
    `tied_in`, `tied_out`) and `doubling.shrink`.
    """
    n = sa_s0.shape[0]
    chunk = _chunk_len(n, chunk)
    caps = [max(min(n, max(n // d, 64)), 1) for d in levels]
    # non-increasing capacities after the 64-floor clamps
    for i in range(1, len(caps)):
        caps[i] = min(caps[i], caps[i - 1])

    sa_s, rank_s, h, count, groups = sa_s0, rank_s0, h0, count0, groups0
    wide = rank_s0.dtype == torch.int64
    # no `h < chunk` guard: short suffixes may need the h == chunk marker
    # round to split, and that round always zeroes the count
    while count > caps[0]:
        dense, lifts, passes = _round_keys(
            groups, n, chunk, _round_shifts(h, fan, chunk), wide)
        with span("doubling.round", n=n, tied_in=count, groups=groups,
                  keys="dense" if dense else "slot",
                  live_passes=passes) as sp:
            # the head slots are not read again: dense ranks replace them
            keys = dense_ranks(rank_s, out=rank_s) if dense else rank_s
            rank = _scatter_to_text_order(sa_s, keys)  # predecessor's
            del sa_s, rank_s, keys
            sa_s, rank_s, count_t = _full_round_sorted(rank, h, fan, chunk,
                                                       lifts)
            del rank
            count, groups = _read_counts(count_t)
            sp.set(tied_out=count)
        h = _next_h(h, chunk, fan)

    if count == 0:
        if want_isa:
            return sa_s, _scatter_to_text_order(sa_s, rank_s)
        return sa_s, sa_s

    # count <= caps[0] here, so the level index is >= 0
    level = 0
    if adaptive and len(caps) > 1:
        level = sum(count <= c for c in caps) - 1
    method = extract
    if method == "auto":
        method = "topk" if caps[level] * 32 <= n else "sort"
    with span("doubling.compact"):
        # the compact rounds' shifted-key gathers read text-order ranks
        rank_buf = _scatter_to_text_order(sa_s, rank_s,
                                          rank_s.new_empty((n + 1,)))
        sa_buf = torch.cat([sa_s, sa_s.new_zeros((1,))])
        with span("doubling.extract"):
            g, pos = _extract(rank_s, sa_s, caps[level], method)
        del sa_s, rank_s

        def run_until(limit, g, pos, h, count):
            while count > limit:
                with span("doubling.compact_round", m=g.shape[0],
                          tied_in=count) as sp:
                    g, pos, _, _, count_t = _compact_round(
                        g, pos, rank_buf, sa_buf, h, fan, chunk)
                    count = _read_count(count_t)
                    sp.set(tied_out=count)
                h = _next_h(h, chunk, fan)
            return g, pos, h, count

        for nxt in caps[level + 1:]:
            g, pos, h, count = run_until(nxt, g, pos, h, count)
            with span("doubling.shrink"):
                g, pos = _shrink(g, pos, nxt)
        run_until(0, g, pos, h, count)
    return sa_buf[:n], rank_buf[:n]


def _prepare(text, idx, depth: int, fan: int, device):
    _check_args(idx, depth, fan)
    return as_text_tensor(text, device)


def build_with_isa(text, idx=_I32, depth: int = 24,
                   levels: tuple = (4, 16, 64, 512), fan: int = 4,
                   extract: str = "auto", adaptive: bool = True,
                   device=None, chunk=None):
    """SA construction that also returns the ISA. Returns (sa, isa), int32
    tensors [n] on the text's device.

    A `depth`-byte initial sort, full rounds while more than n/levels[0]
    positions stay tied, then a cascade of compaction levels with
    capacities n/levels[i]. `idx` is the dtype of `sa` and `isa`,
    torch.int32 or torch.int64.

    `chunk` (a divisor of n) sorts every `chunk` bytes of the text for
    themselves, all in the same sorts: slots [p * chunk, (p + 1) * chunk)
    of `sa` hold the suffix array of chunk p as positions in the whole
    text, and `isa` is its inverse.
    """
    text = _prepare(text, idx, depth, fan, device)
    with span("doubling.build"):
        sa_s0, rank_s0, count0, groups0 = _initial(
            lambda: _initial_sorted(text, depth, chunk, idx))
        h0 = min(depth, _chunk_len(text.shape[0], chunk))
        return _refine(sa_s0, rank_s0, count0, groups0, h0, levels, fan,
                       extract, adaptive, want_isa=True, chunk=chunk)


def build_sa(text, idx=_I32, depth: int = 24,
             levels: tuple = (4, 16, 64, 512), fan: int = 4,
             extract: str = "auto", adaptive: bool = True, device=None,
             chunk=None):
    """`build_with_isa` without the ISA: skips the final inverse-permutation
    sort when the build resolves in the full rounds. `sort()` and the
    partitioned index (with `chunk`) use this."""
    text = _prepare(text, idx, depth, fan, device)
    with span("doubling.build"):
        sa_s0, rank_s0, count0, groups0 = _initial(
            lambda: _initial_sorted(text, depth, chunk, idx))
        h0 = min(depth, _chunk_len(text.shape[0], chunk))
        sa, _ = _refine(sa_s0, rank_s0, count0, groups0, h0, levels, fan,
                        extract, adaptive, want_isa=False, chunk=chunk)
    return sa


def build_ints_with_isa(seq, idx=_I32, depth: int = 4,
                        levels: tuple = (4, 32, 256), fan: int = 4,
                        device=None):
    """SA and ISA of an integer sequence, (sa, isa) of dtype `idx` [n].

    The doubling engine over an integer alphabet, the reduced-string
    solver of dc3's tail and of the bstar engine. The initial keys are
    exact: key t of element i is seq[i+t], or the past-the-end marker
    -(i+1) (`shift_planes`), so the initial ranks are exact
    depth-`depth` classes; one sort of `depth` keys and the position.
    Only the values' order matters, negative values too. A tensor stays
    on its device unless `device` is given; a host array goes to
    `device`, "cuda" unless told otherwise.
    """
    _check_idx(idx)
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if fan < 2:
        raise ValueError("fan must be >= 2")
    if not isinstance(seq, torch.Tensor):
        seq = torch.as_tensor(np.asarray(seq), device=device or DEFAULT_DEVICE)
    elif device is not None:
        seq = seq.to(device)
    n = seq.shape[0]
    seq = seq.to(idx)
    if n == 0:
        return seq, seq
    # the markers -(i+1) must sort below every real value: bias the
    # sequence to be non-negative
    seq = seq - seq.min()

    def sort():
        planes = shift_planes(seq, range(1, depth))
        out = device_sort((seq, *planes), num_keys=depth)
        del planes
        return _ranks_sorted_only(out)

    sa_s0, rank_s0, count0, groups0 = _initial(sort)
    return _refine(sa_s0, rank_s0, count0, groups0, min(depth, n), levels,
                   fan, want_isa=True)


_TRACE_DEPTH = 8  # a shallow initial sort, so traces show the rounds


def sort_traced(text, tracer, device=None) -> SuffixArray:
    """Traced build: host-stepped fan-2 rounds with a dump after each.

    Counterpart of the reference's `sort_traced`, with the same labels
    and dumps, so the two traces of one input are byte-identical: the
    ranks are head-slot ranks, and the sorted order between rounds holds
    ties in position order (every sort is stable, the position its
    payload). The fast path (`sort`) carries no tracing code.
    """
    arr = as_text_tensor(text, device)
    n = int(arr.shape[0])
    tracer.log(f"doubling engine n={n}")
    if n < 3:
        sa = sort(arr)
        tracer.dump("SA final", sa.sa)
        tracer.flush()
        return sa
    rank, sa, _rank_s, count = _initial_full(arr, depth=_TRACE_DEPTH)
    done = int(count) == 0
    tracer.dump(f"rank h={_TRACE_DEPTH} ({_TRACE_DEPTH}-byte radix)", rank)
    tracer.dump(f"SA h={_TRACE_DEPTH}", sa)
    h = _TRACE_DEPTH
    while not done and h < n:
        rank, sa, _rank_s, count = _full_round(rank, h)
        done = int(count) == 0
        h *= 2
        tracer.log(f"round -> h={h} done={done}")
        tracer.dump(f"rank h={h}", rank)
        tracer.dump(f"SA h={h}", sa)
    tracer.dump("SA final", sa)
    tracer.flush()
    return SuffixArray(arr, sa)


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
