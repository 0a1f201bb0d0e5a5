"""Burrows-Wheeler transform and its inverse, on the device.

Counterpart of stringsearch_tpu/transforms/bwt.py, with the same
convention (the C++ oracle's, so outputs cross-check byte-exact): with SA
the suffix array and pidx the row where SA[pidx] == 0,
  U[0] = T[n-1];  U[1:] = T[SA[i]-1] for rows i in order, skipping row pidx.

Forward: one gather of the text through the SA and one copy that skips a
row. Inverse: the LF walk is a sequential n-step pointer chase, so it is
done data-parallel instead:
  1. the LF mapping from one stable sort of the BWT column (LF[r] is the
     stable rank of the character at row r), through `device_sort` like
     every sort of the port;
  2. the distance of every row to row 0 along the single (n+1)-cycle by
     pointer jumping, bit_length(n) rounds of one 8-byte row gather;
  3. one scatter that emits all output bytes.

What differs from the JAX package: `pidx` is fetched to the host once, as
an int, and the skipped row is then a matter of slices; the scatter that
drops a write (`mode="drop"`) writes to a spare last slot; there is no
program to fuse in PyTorch, so `_divbwt_fused` is the build followed by
`bwt_from_sa`.
"""

from __future__ import annotations

import torch

from stringsearch_torch.core.types import (
    BytesLike,
    as_index_tensor,
    as_text_tensor,
)
from stringsearch_torch.ops.bitonic import device_sort

_I32 = torch.int32


def bwt_from_sa(text: torch.Tensor, sa: torch.Tensor):
    """BWT from an existing SA. Returns (u uint8 [n], pidx int); n >= 1."""
    pidx = int((sa == 0).nonzero()[0, 0])  # the one host fetch
    prev = text[(sa - 1).clamp(min=0)]  # row pidx holds a byte to skip
    return torch.cat([text[-1:], prev[:pidx], prev[pidx + 1:]]), pidx


def _jump(state: torch.Tensor) -> torch.Tensor:
    """One pointer-jumping round over state int32 [m, 2] = (next, dist):
    next <- next[next], dist <- dist + dist[next]. Returns a new tensor.

    A row is fetched as ONE 8-byte element (the two int32 viewed as an
    int64), so a round is one random gather, not two; `index_select` takes
    the int32 column as its index where it lies, strided. The fetched
    rows already hold the new `next`; the old `dist` is added in place.
    """
    m = state.shape[0]
    rows = state.view(torch.int64).view(m)
    at_next = rows.index_select(0, state[:, 0]).view(_I32).view(m, 2)
    at_next[:, 1] += state[:, 1]
    return at_next


def _lf_state(u: torch.Tensor, pidx: int):
    """The start of the inverse: (state int32 [n+1, 2], chars uint8 [n+1]).

    `chars` is the BWT column with a row for the sentinel (row pidx+1);
    state[r] = (LF[r], 1), the row before r in text order and its
    distance, but (0, 0) at row 0, where the LF walk starts and the jumps
    end.
    """
    n = u.shape[0]
    m = n + 1
    r = torch.arange(m, dtype=_I32, device=u.device)
    # characters biased +1, the sentinel 0
    col = torch.cat([u[: pidx + 1].to(_I32) + 1, r.new_zeros((1,)),
                     u[pidx + 1:].to(_I32) + 1])
    # LF[row] = the row's place in the stable order of the column
    _, order = device_sort((col, r), num_keys=1)
    del col
    state = torch.empty((m, 2), dtype=_I32, device=u.device)
    state[:, 0][order] = r
    state[:, 1] = 1
    state[0] = 0
    chars = torch.cat([u[: pidx + 1], u.new_zeros((1,)), u[pidx + 1:]])
    return state, chars


def _unbwt_kernel(u: torch.Tensor, pidx: int, rounds: int) -> torch.Tensor:
    """Inverse BWT of u uint8 [n] (n >= 1) with primary index `pidx`, in
    `rounds` >= bit_length(n) pointer-jumping rounds. Returns uint8 [n]."""
    n = u.shape[0]
    m = n + 1  # with the sentinel row
    state, chars = _lf_state(u, pidx)
    for _ in range(rounds):
        state = _jump(state)
    # the LF walk starts at row 0 and emits T[n-1-s] at its step s; row r
    # is m - dist[r] steps in
    s = m - state[:, 1]
    s[0] = 0
    del state
    # the full-string row (s == n) emits nothing: its write goes to the
    # spare slot n
    target = torch.where((s >= 0) & (s <= n - 1), n - 1 - s, n)
    out = torch.zeros((m,), dtype=torch.uint8, device=u.device)
    out[target] = chars
    return out[:n]


def _divbwt_fused(text: torch.Tensor, depth: int):
    """SA build and BWT emission with no SA handed back: the counterpart
    of the reference's one-program `_divbwt_fused`. Two steps here."""
    from stringsearch_torch.engines.doubling import build_sa

    return bwt_from_sa(text, build_sa(text, depth=depth))


def bwt(text: BytesLike, sa=None, engine: str = "doubling",
        device=None) -> tuple[torch.Tensor, int]:
    """BWT of `text`; builds the SA with `engine` if none is given.

    Returns (u uint8 tensor [n] on the text's device, pidx int). Equals
    the oracle's `saca_bwt` byte for byte.
    """
    arr = as_text_tensor(text, device)
    n = int(arr.shape[0])
    if n == 0:
        return arr, 0
    if sa is None and engine == "doubling" and n >= 3:
        from stringsearch_torch.engines.doubling import _auto_depth

        return _divbwt_fused(arr, _auto_depth(n))
    if sa is None:
        from stringsearch_torch.engines import build_suffix_array

        sa = build_suffix_array(arr, engine=engine).sa
    return bwt_from_sa(arr, as_index_tensor(sa, arr.device))


def divbwt(text: BytesLike, engine: str = "doubling",
           device=None) -> tuple[bytes, int]:
    """Direct-BWT entry returning host bytes."""
    u, pidx = bwt(text, engine=engine, device=device)
    return u.cpu().numpy().tobytes(), pidx


def unbwt(u: BytesLike, pidx: int, device=None) -> bytes:
    """Inverse BWT, data-parallel on the device. Returns host bytes."""
    arr = as_text_tensor(u, device)
    n = int(arr.shape[0])
    if n == 0:
        return b""
    if not 0 <= pidx < n:
        raise ValueError(f"pidx={pidx} must be in [0, {n})")
    out = _unbwt_kernel(arr, int(pidx), max(1, n.bit_length()))
    return out.cpu().numpy().tobytes()
