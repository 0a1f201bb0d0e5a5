"""Vectorized byte-string comparison primitives.

Counterpart of stringsearch_tpu/core/compare.py. All compares run over
fixed-width windows gathered from the text in one gather, with sentinels
that make padding order correctly:
    PAST_TEXT_END   = -2  (a suffix that ran out of text sorts lowest)
    PAST_NEEDLE_END = -1  (an exhausted needle sorts below any real byte but
                           above an exhausted suffix)
Real bytes occupy [0, 255] in int32.
"""

from __future__ import annotations

import torch

PAST_TEXT_END = -2
PAST_NEEDLE_END = -1


def gather_window(text: torch.Tensor, starts: torch.Tensor, width: int) -> torch.Tensor:
    """`width` bytes of `text` at each start as int32, with PAST_TEXT_END
    beyond either end of the text.

    text: uint8 [n]; starts: int32 [...]; returns int32 [..., width].
    """
    n = text.shape[0]
    offs = torch.arange(width, dtype=torch.int32, device=text.device)
    pos = starts[..., None] + offs
    inb = (pos >= 0) & (pos < n)
    vals = text[pos.clamp(0, n - 1)].to(torch.int32)
    return torch.where(inb, vals, PAST_TEXT_END)


def prefix_match_len(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Length of the common prefix of two int32 byte windows [..., W].

    Only real bytes match: sentinels (< 0) never count, even when equal.
    """
    eq = (a == b) & (a >= 0) & (b >= 0)
    # cumprod of int32 promotes to int64: cast the count back
    return eq.to(torch.int32).cumprod(-1).sum(-1).to(torch.int32)


def _first_diff(a: torch.Tensor, b: torch.Tensor):
    """(any difference, a at the first difference, b there) over [..., W]."""
    neq = a != b
    idx = neq.to(torch.uint8).argmax(-1, keepdim=True)  # first True, 0 if none
    a_at = a.gather(-1, idx)[..., 0]
    b_at = b.gather(-1, idx)[..., 0]
    return neq.any(-1), a_at, b_at


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a < b over int32 windows [..., W] (sentinels included)."""
    any_diff, a_at, b_at = _first_diff(a, b)
    return any_diff & (a_at < b_at)


def lex_cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Three-way lexicographic compare over windows: -1 / 0 / +1 (int32)."""
    any_diff, a_at, b_at = _first_diff(a, b)
    sign = torch.sign(a_at - b_at).to(torch.int32)
    return torch.where(any_diff, sign, 0)


def _cpl(text, pa, pb, width):
    return prefix_match_len(gather_window(text, pa, width),
                            gather_window(text, pb, width))


def common_prefix_len(text, a, b, max_len: int = 256, device=None) -> torch.Tensor:
    """Common prefix length of text[a:] and text[b:], batched over positions.

    `a` and `b` may be scalars or arrays of positions. Windows of `max_len`
    are compared in one vector op, then extended in doubling rounds for the
    (rare) longer matches, so the result is exact regardless of `max_len`.
    """
    from stringsearch_torch.core.types import as_text_tensor

    text = as_text_tensor(text, device)
    n = int(text.shape[0])
    a = torch.as_tensor(a, dtype=torch.int32, device=text.device)
    b = torch.as_tensor(b, dtype=torch.int32, device=text.device)
    scalar = a.dim() == 0 and b.dim() == 0
    a, b = torch.broadcast_tensors(torch.atleast_1d(a), torch.atleast_1d(b))

    width = min(max(max_len, 1), max(n, 1))
    total = _cpl(text, a, b, width)
    # extend any window-saturated lanes with doubling window sizes
    while width < n:
        if not bool((total == min(width, n)).any()):
            break
        nxt = min(width * 2, n)
        total = torch.where(
            total >= width,
            width + _cpl(text, a + width, b + width, nxt - width),
            total,
        )
        # positions past the end gather sentinels, so over-extension is safe
        width = nxt
        total = torch.minimum(total, (n - torch.maximum(a, b)).clamp(min=0))
    if scalar:
        return total[0]
    return total
