"""A Fibonacci word, made on the device.

The finite Fibonacci words over a < b are S_0 = "a", S_1 = "ab" and
S_k = S_(k-1) S_(k-2); each is a prefix of the next, and S_k holds F_(k+2)
bytes (F_1 = F_2 = 1). The text is the first `text_bytes` bytes of that
sequence, which is S_k itself when `text_bytes` is a Fibonacci number. The
word does not depend on the seed: the same text for every run.

Its factor complexity is the least a text that is not periodic can have
(m + 1 distinct factors of each length m), so nearly every suffix stays
tied with another until the sort depth reaches the longest repeat, about
0.618 of the length: the worst case of prefix doubling short of a periodic
text.
"""

from __future__ import annotations

import torch


def word(n: int, device, a: int = ord("a"), b: int = ord("b")) -> torch.Tensor:
    """The first `n` bytes of the Fibonacci word (uint8 on `device`)."""
    prev = torch.tensor([a], dtype=torch.uint8, device=device)
    cur = torch.tensor([a, b], dtype=torch.uint8, device=device)
    while cur.numel() < n:
        prev, cur = cur, torch.cat([cur, prev])
    return cur[:n].clone() if n < cur.numel() else cur


def make(config: dict, seed: int, device) -> torch.Tensor:
    """The configuration's `text_bytes` of the word; `seed` changes nothing."""
    return word(int(config["text_bytes"]), device)
