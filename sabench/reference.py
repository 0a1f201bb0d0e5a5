"""The plain reference that decides `correct`. Plain PyTorch; it imports
nothing of the program and takes nothing the program made but the outputs
it judges.

* `check_sa` judges a suffix array: it is a permutation of the positions,
  and every adjacent pair (a, b) has (text[a], rank[a+1]) < (text[b],
  rank[b+1]) with rank the inverse of the array and rank[n] = -1. These
  two hold for the suffix array and for nothing else (Burkhardt and
  Karkkainen, "Fast lightweight suffix array construction and checking",
  CPM 2003), so a result that passes is the unique suffix array.
* `Digest` folds a suffix array into three position-weighted sums, so the
  output of every timed build can be held against the one judged in full
  without keeping a copy of each.
* `doubling_sa` builds a suffix array by plain prefix doubling on
  `torch.sort`; `short=k` returns the order k doubling rounds before it
  resolves (ties in position order), the control's broken guarantee.
"""

from __future__ import annotations

import torch

def check_sa(text: torch.Tensor, sa: torch.Tensor,
             block: int = 1 << 26) -> dict:
    """{"sa_not_perm": positions the array never lists, "sa_bad_pairs":
    adjacent pairs out of suffix order}. Both are 0 only for the suffix
    array of `text`."""
    n = text.numel()
    if tuple(sa.shape) != (n,):
        return {"sa_not_perm": n, "sa_bad_pairs": n}
    dev = text.device
    sa = sa.to(torch.int64)
    inside = (sa >= 0) & (sa < n)
    rank = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    rank[sa[inside]] = torch.arange(n, device=dev)[inside]
    not_perm = int((rank[:n] < 0).sum())
    del inside
    bad = 0
    for i0 in range(1, n, block):
        i1 = min(i0 + block, n)
        a = sa[i0 - 1:i1 - 1].clamp(0, n - 1)
        b = sa[i0:i1].clamp(0, n - 1)
        ta, tb = text[a], text[b]
        ra, rb = rank[a + 1], rank[b + 1]
        ok = (ta < tb) | ((ta == tb) & (ra < rb))
        bad += int((~ok).sum())
    return {"sa_not_perm": not_perm, "sa_bad_pairs": bad}


class Digest:
    """Three int64 sums of an int32 array of length n, each position
    weighted by fixed pseudo-random weights: by its row and by its column
    of a [n // 4096, 4096] view, and one by one in the tail. The row and
    column sums are taken in int32, exact modulo 2^32 in any order, so the
    array is read once a sum and never copied. Two arrays that differ in
    a swap or a changed entry differ in a sum but for chance."""

    COLS = 4096

    def __init__(self, n: int, device):
        gen = torch.Generator(device=device)
        gen.manual_seed(0x5AB3)
        self.rows = n // self.COLS
        self.w_row = torch.randint(1, 1 << 31, (self.rows,), generator=gen,
                                   device=device)
        self.w_col = torch.randint(1, 1 << 31, (self.COLS,), generator=gen,
                                   device=device)
        self.w_tail = torch.randint(1, 1 << 31, (n - self.rows * self.COLS,),
                                    generator=gen, device=device)

    def __call__(self, sa: torch.Tensor) -> torch.Tensor:
        body = sa[:self.rows * self.COLS].view(self.rows, self.COLS)
        tail = sa[self.rows * self.COLS:].to(torch.int64)
        rows = body.sum(1, dtype=torch.int32).to(torch.int64)
        cols = body.sum(0, dtype=torch.int32).to(torch.int64)
        return torch.stack([(rows * self.w_row).sum(),
                            (cols * self.w_col).sum(),
                            (tail * self.w_tail).sum()])


def doubling_sa(text: torch.Tensor, short: int = 0) -> torch.Tensor:
    """The suffix array of `text` (int32) by prefix doubling on
    `torch.sort`: 7 bytes packed big-endian into an int64 (zero past the
    end), then rounds keyed (rank[i], rank[i + h]) with -(i + 1) for a
    suffix that ends before i + h, until every rank is distinct. With
    `short` > 0, the order of the round `short` rounds before the last
    (the first round's where there are fewer): suffixes compared to a
    bounded depth, ties in position order."""
    n = text.numel()
    dev = text.device
    if n < 2:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    depth = 7
    padded = torch.cat([text.to(torch.int64),
                        torch.zeros(depth, dtype=torch.int64, device=dev)])
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    for k in range(depth):
        key = (key << 8) | padded[k:k + n]
    del padded
    pos = torch.arange(n, device=dev)
    h, earlier = depth, []
    while True:
        vals, order = torch.sort(key, stable=True)
        head = torch.ones(n, dtype=torch.bool, device=dev)
        head[1:] = vals[1:] != vals[:-1]
        del vals
        groups = head.cumsum(0) - 1
        if int(groups[-1]) == n - 1:
            break
        rank = torch.empty(n, dtype=torch.int64, device=dev)
        rank[order] = groups
        del groups, head
        earlier = (earlier + [order.to(torch.int32)])[-short:] if short else []
        nxt = torch.where(pos + h < n, rank[(pos + h).clamp(max=n - 1)],
                          -(pos + 1))
        key = (rank << 32) + (nxt + (1 << 31))
        del rank, nxt
        h *= 2
    return earlier[0] if earlier else order.to(torch.int32)
