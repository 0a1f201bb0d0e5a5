"""DC3 (difference cover mod 3) SACA, in PyTorch.

Counterpart of stringsearch_tpu/engines/dc3.py, step for step: a complete
Kärkkäinen–Sanders recursion, a second engine derived independently of
the doubling one, for crosschecks against it and the host oracle.

- the sample suffixes (positions i % 3 != 0) are sorted by their
  character triples in one 3-key `device_sort`; the triples are strided
  views of the padded text;
- names come from a neighbour diff and a cumsum, scattered into the
  reduced-string layout; when they are not all distinct the reduced string
  is solved by recursion;
- the mod-0 suffixes are sorted by (first char, rank of the next sample
  suffix), and the merge is two vectorized binary searches: every suffix
  counts the suffixes of the other kind that precede it, then two scatters
  place both kinds.

What differs from the JAX package, and why:
  * The recursion is on the host, as there, with one synced scalar a level
    (the number of names). `count_less`'s `fori_loop` is a host loop of a
    fixed number of probes with no sync, each one comparator-row gather
    (`index_select`).
  * Every size is padded to a size bucket (`_BUCKETS`) as in the reference,
    where it bounds the number of jit shapes. Here it changes no result;
    it stays because the traces print the padded sizes, and the traces of
    the two packages are one text.
  * The merge's two scatters keep, of several entries that write one slot,
    the last (`_scatter_last`), as the reference's serial scatter does; a
    CUDA scatter would leave the slot to any of them.
  * `STRINGSEARCH_TORCH_DC3_FULL` takes the place of the reference's
    `STRINGSEARCH_TPU_DC3_FULL`.

All values are int32 (dc3 has no int64 index mode, in the reference
neither); text bytes are biased by +1 so that 0 is the unique sentinel.
"""

from __future__ import annotations

import bisect
import os

import torch

from stringsearch_torch.core.types import SuffixArray, as_text_tensor
from stringsearch_torch.engines.doubling import _iota, build_ints_with_isa
from stringsearch_torch.ops.bitonic import device_sort

_I32 = torch.int32


def _lex3_less(a1, a2, a3, b1, b2, b3):
    """(a1,a2,a3) < (b1,b2,b3) lexicographically, elementwise."""
    return (a1 < b1) | ((a1 == b1) & ((a2 < b2) | ((a2 == b2) & (a3 < b3))))


def _sample_sort(tpad, n: int, n0: int, n02: int):
    """Sort the sample (mod-1 and mod-2) positions by their character
    triples.

    Returns (sorted sample positions [n02], names in the R layout [n02],
    the number of names as a 0-d tensor). R layout: slot i // 3 for
    i % 3 == 1, slot n0 + i // 3 for i % 3 == 2.
    """
    dev = tpad.device
    n2 = n02 - n0
    s12 = torch.cat([1 + 3 * _iota(n0, dev), 2 + 3 * _iota(n2, dev)])

    def tri(c):
        """tpad[s12 + c] from two strided views; the last element read is
        at most n + 2, inside tpad for every n % 3."""
        a = tpad[1 + c : 1 + c + 3 * (n0 - 1) + 1 : 3]
        if n2 == 0:
            return a.contiguous()
        return torch.cat([a, tpad[2 + c : 2 + c + 3 * (n2 - 1) + 1 : 3]])

    c0, c1, c2, pos = device_sort((tri(0), tri(1), tri(2), s12), num_keys=3)
    diff = (c0[1:] != c0[:-1]) | (c1[1:] != c1[:-1]) | (c2[1:] != c2[:-1])
    del c0, c1, c2
    # 0-based dense names in sorted order
    names_sorted = torch.cat([diff.new_zeros((1,)), diff]).cumsum(0,
                                                                  dtype=_I32)
    slot = torch.where(pos % 3 == 1, pos // 3, n0 + pos // 3)
    r = torch.zeros((n02,), dtype=_I32, device=dev)
    r[slot] = names_sorted
    return pos, r, names_sorted[-1] + 1


def _unrank_samples(sa_r, n0: int):
    """Map reduced-string SA entries back to text positions."""
    return torch.where(sa_r < n0, 1 + 3 * sa_r, 2 + 3 * (sa_r - n0))


def _finish(tpad, sa12_all, n: int, n0: int, drop_pad: bool, steps0: int,
            steps12: int, byte_alpha: bool = False):
    """Rank the samples, sort the mod-0 suffixes, merge by binary-search
    cross-ranks."""
    dev = tpad.device
    npad = tpad.shape[0]
    n12 = sa12_all.shape[0] - (1 if drop_pad else 0)
    sa12 = sa12_all[1:] if drop_pad else sa12_all  # the pad suffix sorts first
    # rank12[p] = 1-based rank of the sample suffix at text position p
    rank12 = torch.zeros((npad,), dtype=_I32, device=dev)
    rank12[sa12.clamp(0, npad - 1)] = 1 + _iota(n12, dev)

    # the comparator at position p reads T[p], T[p+1], rank12[p+1] and
    # rank12[p+2]: one row of `table`
    z = torch.zeros((2,), dtype=_I32, device=dev)
    t0c = tpad
    t1 = torch.cat([tpad[1:], z[:1]])
    r1 = torch.cat([rank12[1:], z[:1]])
    r2 = torch.cat([rank12[2:], z])
    del rank12

    if byte_alpha and npad < (1 << 23):
        # level 0 only (values are bytes + 1 <= 256): with ranks < 2^23,
        # (T - 256) << 23 | rank packs each case's decisive pair into one
        # int32 whose order is the lexicographic order
        table = torch.stack([((t0c - 256) << 23) | r1,  # mod-1: (T, r[p+1])
                             ((t1 - 256) << 23) | r2],  # mod-2: (T+1, r[p+2])
                            dim=1)

        def split(g, residue):
            return g[:, 0], g[:, 1], residue

        def less_c(a, b):
            k1a, k2a, ma = a
            k1b, k2b, mb = b
            jm = torch.where(ma == 0, mb, ma)  # the sample side's residue
            l1 = k1a < k1b
            ta, tb = k1a >> 23, k1b >> 23  # recovers T - 256
            l2 = (ta < tb) | ((ta == tb) & (k2a < k2b))
            return torch.where(jm == 1, l1, l2)
    else:
        table = torch.stack([t0c, t1, r1, r2], dim=1)  # [npad, 4]

        def split(g, residue):
            """(T[p], T[p+1], rank[p+1], rank[p+2], p % 3) of rows g."""
            return g[:, 0], g[:, 1], g[:, 2], g[:, 3], residue

        def less_c(a, b):
            """suffix a < suffix b; exactly one side is mod-0 and the
            sample's residue picks the depth of the comparison."""
            ta, t1a, r1a, r2a, ma = a
            tb, t1b, r1b, r2b, mb = b
            jm = torch.where(ma == 0, mb, ma)
            l1 = (ta < tb) | ((ta == tb) & (r1a < r1b))
            l2 = _lex3_less(ta, t1a, r2a, tb, t1b, r2b)
            return torch.where(jm == 1, l1, l2)

    # mod-0 suffixes sorted by (first char, rank of the next sample suffix)
    s0 = 3 * _iota(n0, dev)
    _c, _r, sa0 = device_sort((t0c[s0], r1[s0], s0), num_keys=2)
    del _c, _r, s0, t1, r1, r2

    def count_less(queries, arr, steps: int, query_is_mod0: bool):
        """The number of elements of the sorted suffix array `arr` below
        each query suffix, by `steps` probes of a binary search."""
        m = arr.shape[0]
        q = split(table.index_select(0, queries), queries % 3)
        lo = torch.zeros_like(queries)
        hi = torch.full_like(queries, m)
        for _ in range(steps):
            mid = (lo + hi) // 2
            at = arr[mid.clamp(0, m - 1)]
            a = split(table.index_select(0, at), at % 3)
            # suffixes are never equal: arr[mid] < q <=> not q < arr[mid]
            arr_less = ~less_c(q, a) if query_is_mod0 else less_c(a, q)
            active = lo < hi
            lo = torch.where(active & arr_less, mid + 1, lo)
            hi = torch.where(active & ~arr_less, mid, hi)
        return lo

    pos0 = _iota(n0, dev) + count_less(sa0, sa12, steps12, True)
    pos12 = _iota(n12, dev) + count_less(sa12, sa0, steps0, False)
    # the last slot is a spare, for the entries `_scatter_last` drops
    sa = torch.zeros((n0 + n12 + 1,), dtype=_I32, device=dev)
    _scatter_last(sa, pos0, sa0)
    _scatter_last(sa, pos12, sa12)
    return sa[:-1]


def _scatter_last(out, pos, values) -> None:
    """out[pos] = values, where of several entries that write one slot the
    last wins, as in a serial scatter and the reference's. `out` ends in a
    spare slot, which takes the entries that lose.

    Only suffixes inside a level's bucket padding (zeros, which the
    comparator cannot always tell apart) ever share a slot, and only in
    the padded head of the merged SA, which the level drops; but the
    traces dump it, so it must not depend on the device.
    """
    j = _iota(pos.shape[0], pos.device)
    last = torch.full_like(out, -1)
    last.scatter_reduce_(0, pos.long(), j, reduce="amax")
    out[torch.where(last[pos] == j, pos, out.shape[0] - 1)] = values


def _ceil_log2(x: int) -> int:
    return max(1, int(x - 1).bit_length()) if x > 1 else 1


def _reduced_size(v: int) -> int:
    """n02 of a level of size v: (v+2)//3 mod-0 slots + v//3 mod-2 slots."""
    return (v + 2) // 3 + v // 3


def _build_buckets(limit: int = 1 << 31) -> list[int]:
    """Size buckets spaced so that each bucket's reduced string fits in the
    previous bucket: b_{k+1} = max v with n02(v) <= b_k (ratio ~1.5), so
    the padded recursion strictly shrinks."""
    buckets = [4]
    while buckets[-1] < limit:
        b = buckets[-1]
        v = (3 * b) // 2
        while _reduced_size(v + 1) <= b:
            v += 1
        while _reduced_size(v) > b:
            v -= 1
        buckets.append(v)
    return buckets


_BUCKETS = _build_buckets()

#: levels >= 1 of at most this padded size solve their reduced string with
#: `build_ints_with_isa` in one call instead of further dc3 levels; level 0
#: never does, so every dc3 build runs its own sample, naming and merge
#: steps on the input. The reference's value.
_SOLVE_THRESHOLD = 1 << 22


def _tail_solve_enabled() -> bool:
    """The tail solve hands levels >= 1 to the doubling core, so a doubling
    fault could hide below level 0 from dc3-against-doubling checks. Set
    STRINGSEARCH_TORCH_DC3_FULL=1 to run the whole recursion."""
    return not os.environ.get("STRINGSEARCH_TORCH_DC3_FULL")


def _host_sort(t: torch.Tensor) -> torch.Tensor:
    """Suffix array of at most three values, on the host."""
    host = t.tolist()
    order = sorted(range(len(host)), key=lambda i: host[i:])
    return torch.tensor(order, dtype=_I32, device=t.device)


def _dc3(t: torch.Tensor, tracer=None, level: int = 0,
         byte_alpha: bool = False) -> torch.Tensor:
    """Suffix array of the int32 tensor `t` (values >= 1; 0 is reserved).

    Pads to the next size bucket with zeros: the pad suffixes sort first,
    and appending a character smaller than every real one keeps the order
    of the real suffixes, so the real SA is the tail.
    """
    n = int(t.shape[0])
    if n <= 3:
        return _host_sort(t)
    m = _BUCKETS[bisect.bisect_left(_BUCKETS, n)]
    if m > n:
        t = torch.cat([t, t.new_zeros((m - n,))])
    if level > 0 and m <= _SOLVE_THRESHOLD and _tail_solve_enabled():
        if tracer is not None:
            tracer.log(f"level {level}: n={n} -> int-doubling tail solve")
        sa, _isa = build_ints_with_isa(t)
        return sa[m - n :]
    return _dc3_core(t, tracer, level, byte_alpha)[m - n :]


def _dc3_core(t: torch.Tensor, tracer=None, level: int = 0,
              byte_alpha: bool = False) -> torch.Tensor:
    """Suffix array of `t`, n >= 4 (padded by `_dc3`)."""
    n = int(t.shape[0])
    n0 = (n + 2) // 3
    n1 = (n + 1) // 3
    n2 = n // 3
    n02 = n0 + n2
    drop_pad = n0 != n1  # n % 3 == 1: the samples hold the pad position n

    tpad = torch.cat([t, t.new_zeros((3,))])
    pos_sorted, r, num_names = _sample_sort(tpad, n, n0, n02)
    num_names = int(num_names)  # the level's one sync
    if tracer is not None:
        tracer.log(f"level {level}: n={n} n02={n02} names={num_names}")
        tracer.dump(f"L{level} sample order", pos_sorted)
        tracer.dump(f"L{level} names", r)

    if num_names < n02:
        # recurse on the reduced string (values + 1 keep 0 the sentinel)
        del pos_sorted
        sa12_all = _unrank_samples(_dc3(r + 1, tracer, level + 1), n0)
    else:
        sa12_all = pos_sorted
    del r
    if tracer is not None:
        tracer.dump(f"L{level} SA12", sa12_all)

    steps0 = _ceil_log2(n0 + 1) + 1
    n12 = n02 - (1 if drop_pad else 0)
    steps12 = _ceil_log2(n12 + 1) + 1
    sa = _finish(tpad, sa12_all, n, n0, drop_pad, steps0, steps12,
                 byte_alpha=byte_alpha)
    if tracer is not None:
        tracer.dump(f"L{level} SA (merged)", sa)
    return sa


def sort(text, device=None) -> SuffixArray:
    """Build the suffix array with DC3 on `device` (host input: "cuda"
    unless told otherwise; a tensor stays on its device)."""
    arr = as_text_tensor(text, device)
    if arr.shape[0] == 0:
        return SuffixArray(arr, torch.zeros((0,), dtype=_I32,
                                            device=arr.device))
    return SuffixArray(arr, _dc3(arr.to(_I32) + 1, byte_alpha=True))


def sort_traced(text, tracer, device=None) -> SuffixArray:
    """Traced DC3 build: each recursion level dumps its sample order,
    names, sample SA and merged SA, with the reference's labels, so the
    two packages' traces of one input are one text."""
    arr = as_text_tensor(text, device)
    n = int(arr.shape[0])
    tracer.log(f"dc3 engine n={n}")
    if n == 0:
        sa = torch.zeros((0,), dtype=_I32, device=arr.device)
    else:
        sa = _dc3(arr.to(_I32) + 1, tracer, 0, byte_alpha=True)
    tracer.dump("SA final", sa)
    tracer.flush()
    return SuffixArray(arr, sa)
