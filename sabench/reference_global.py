"""`reference.Digest` of a suffix array that lies in pieces on several
devices, taken where each piece lies. Plain PyTorch; it imports nothing
of the program.

The global index gives its suffix array as one piece a shard, in sorted
order, each on its shard's card. Gathering the pieces on one card to
digest them would move the whole array inside the timed window (4 GiB at
2^30 positions). `ShardDigest` instead folds each piece on its own device
into the parts `Digest` weighs: the rows of the [n // 4096, 4096] view
that the piece holds whole, summed in int32 and weighed with `Digest`'s
row weights there; the int32 sums of its part of the rows it shares with
a neighbouring piece; the int32 sums of each column over its rows; and
its slots past the last whole row. Only the last three come to the host
(a few entries and 4096 column sums a piece), where the shared rows and
the columns get `Digest`'s int32 wrap and weights. Every sum is exact
modulo 2^32 or 2^64 in any order, so the result equals `Digest` of the
concatenation bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sabench import reference

_I32, _I64 = torch.int32, torch.int64


def wrap32(x):
    """int64 values (an array or an int) as the int32 they are modulo
    2^32, sign-extended."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def wrap64(x: int) -> int:
    """An int as the int64 it is modulo 2^64."""
    return ((x + (1 << 63)) & 0xFFFFFFFFFFFFFFFF) - (1 << 63)


class ShardDigest:
    """`reference.Digest(n, device)` of an int32 array of length n given
    as pieces, each on its own device; the result is on the host."""

    def __init__(self, n: int, device):
        d = reference.Digest(n, device)
        self.n, self.cols, self.rows = n, d.COLS, d.rows
        self.body = d.rows * d.COLS
        self.w_row, self.w_col, self.w_tail = (
            w.cpu().numpy() for w in (d.w_row, d.w_col, d.w_tail))
        self._w_rows = {d.w_row.device: d.w_row}

    def _row_weights(self, device) -> torch.Tensor:
        """The row weights on `device` (copied there once)."""
        if device not in self._w_rows:
            self._w_rows[device] = next(iter(self._w_rows.values())).to(
                device)
        return self._w_rows[device]

    def fold(self, piece: torch.Tensor, start: int) -> tuple:
        """The parts of the digest that `piece`, global slots [start,
        start + len), adds, as tensors on its device: (the weighted sum of
        the rows it holds whole, 0-d int64; [(row, int32 sum of its part)]
        for the rows it shares; the int32 sum of each column over its rows;
        its values past the last whole row)."""
        c = self.cols
        lo, hi = start, min(start + piece.numel(), self.body)
        dev = piece.device
        cols = torch.zeros(c, dtype=_I32, device=dev)
        whole = torch.zeros((), dtype=_I64, device=dev)
        shared = []
        a, b = -(-lo // c) * c, hi // c * c  # its whole rows: [a, b)
        if hi <= lo:
            pass
        elif a > b:  # inside one row
            part = piece[:hi - lo]
            shared.append((lo // c, part.sum(dtype=_I32)))
            cols[lo % c:lo % c + part.numel()] += part
        else:
            if a > lo:
                part = piece[:a - lo]
                shared.append((lo // c, part.sum(dtype=_I32)))
                cols[lo % c:] += part
            if b > a:
                block = piece[a - lo:b - lo].view(-1, c)
                whole = (block.sum(1, dtype=_I32).to(_I64)
                         * self._row_weights(dev)[a // c:b // c]).sum()
                cols += block.sum(0, dtype=_I32)
            if hi > b:
                part = piece[b - lo:hi - lo]
                shared.append((b // c, part.sum(dtype=_I32)))
                cols[:part.numel()] += part
        return whole, shared, cols, piece[max(hi, lo) - lo:]

    def __call__(self, pieces) -> torch.Tensor:
        """The digest of the concatenation of `pieces`: three int64 sums
        on the host, equal to `reference.Digest`'s."""
        folds, start = [], 0
        for piece in pieces:  # every device folds before any is read
            folds.append((start, self.fold(piece, start)))
            start += piece.numel()
        if start != self.n:
            raise ValueError(f"pieces of {start} slots, not {self.n}")
        rows, shared = 0, {}
        cols = np.zeros(self.cols, np.int64)
        tail = np.zeros(self.w_tail.shape, np.int64)
        for piece_start, (whole, parts, c, t) in folds:
            rows += whole.item()
            for r, part in parts:
                shared[r] = shared.get(r, 0) + part.item()
            cols += c.cpu().numpy()
            at = max(piece_start, self.body) - self.body
            tail[at:at + t.numel()] = t.cpu().numpy()
        rows += sum(wrap32(v) * int(self.w_row[r]) for r, v in shared.items())
        # int64 products and sums wrap modulo 2^64, as Digest's do
        return torch.tensor([wrap64(rows),
                             int(np.sum(wrap32(cols) * self.w_col)),
                             int(np.sum(tail * self.w_tail))], dtype=_I64)
