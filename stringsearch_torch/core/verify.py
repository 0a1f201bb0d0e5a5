"""Suffix-array verification in O(n), fully vectorized.

Counterpart of stringsearch_tpu/core/verify.py. It uses the ISA-recurrence
characterisation, three gathers and a reduction:

  SA is *the* suffix array of T  <=>
    (1) SA is a permutation of [0, n)
    (2) for all adjacent entries i:  T[SA[i]] <= T[SA[i+1]]
    (3) if T[SA[i]] == T[SA[i+1]]:  rank(SA[i]+1) < rank(SA[i+1]+1)
        where rank(p) = ISA[p] and rank(n) = -1 (the empty suffix sorts
        first).
"""

from __future__ import annotations

import torch

from stringsearch_torch.core.types import NotSorted, as_index_tensor, as_text_tensor


def verify_flags(text: torch.Tensor, sa: torch.Tensor):
    """Device-side check. Returns (perm_ok [n] bool, adj_ok [n-1] bool)."""
    n = text.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=text.device)
    clip = sa.clamp(0, n - 1)
    counts = torch.zeros((n,), dtype=torch.int32, device=text.device)
    counts.index_put_((clip,), torch.ones_like(sa), accumulate=True)
    perm_ok = (counts == 1) & ((sa >= 0) & (sa < n)).all()

    isa = torch.zeros((n,), dtype=torch.int32, device=text.device)
    isa[clip] = iota
    first = text[clip].to(torch.int32)
    nxt = sa + 1
    rank_next = torch.where(nxt < n, isa[nxt.clamp(0, n - 1)], -1)
    adj_ok = (first[:-1] < first[1:]) | (
        (first[:-1] == first[1:]) & (rank_next[:-1] < rank_next[1:])
    )
    return perm_ok, adj_ok


def is_valid(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """Scalar bool tensor: `sa` is the suffix array of `text`."""
    perm_ok, adj_ok = verify_flags(text, sa)
    return perm_ok.all() & adj_ok.all()


def _first_false(flags: torch.Tensor) -> int:
    return int(flags.to(torch.uint8).argmin())


def verify(text, sa, device=None) -> None:
    """Raise NotSorted if `sa` is not the suffix array of `text`.

    The error carries the first offending adjacent pair (i, i+1), or
    (i, i) for the first slot that breaks the permutation.
    """
    text = as_text_tensor(text, device)
    sa = as_index_tensor(sa, text.device)
    n = int(text.shape[0])
    if tuple(sa.shape) != (n,):
        raise NotSorted(0, 0, f"sa shape {tuple(sa.shape)} != text length {n}")
    if n == 0:
        return
    perm_ok, adj_ok = verify_flags(text, sa)
    if not bool(perm_ok.all()):
        bad = _first_false(perm_ok)
        raise NotSorted(bad, bad, "SA is not a permutation of [0, n)")
    if n > 1 and not bool(adj_ok.all()):
        i = _first_false(adj_ok)
        raise NotSorted(i, i + 1)
