"""Core types: SuffixArray, match results, StringIndex protocol.

Counterpart of stringsearch_tpu/core/types.py. The text is a uint8 tensor
and the suffix array an int32 tensor on one device, so queries and
verification run there without host round trips.

Devices: host input (bytes, numpy) goes to `device`, "cuda" unless told
otherwise; a tensor stays on its own device unless `device` is given. No
function here picks the CPU because no GPU is present.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, Union, runtime_checkable

import numpy as np
import torch

BytesLike = Union[bytes, bytearray, memoryview, np.ndarray, torch.Tensor]
DEFAULT_DEVICE = "cuda"


def as_text_tensor(data: BytesLike, device=None) -> torch.Tensor:
    """Coerce bytes / arrays / tensors into a uint8 text tensor on a device.

    Host input goes to `device` (default "cuda"); a tensor stays where it
    is unless `device` is given.
    """
    if isinstance(data, torch.Tensor):
        _check_u8(data.dtype, "text")
        return data if device is None else data.to(device)
    return host_tensor(host_u8(data, "text").reshape(-1),
                       device or DEFAULT_DEVICE)


def _check_u8(dtype, what: str) -> None:
    if dtype not in (torch.uint8, np.uint8):
        raise TypeError(f"{what} must be uint8 bytes, got {dtype}")


def host_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A copy of a host array on `device`, never an alias: a later change
    to the caller's array leaves the index as it was."""
    return torch.tensor(arr, device=device)


def as_index_tensor(data, device) -> torch.Tensor:
    """An int32 tensor on `device` from a tensor or a host array."""
    if isinstance(data, torch.Tensor):
        return data.to(device, torch.int32)
    return host_tensor(np.asarray(data, dtype=np.int32), device)


def host_u8(data: BytesLike, what: str = "needle") -> np.ndarray:
    """A host uint8 array of `data`: a view of a host buffer, a copy of a
    tensor."""
    if isinstance(data, torch.Tensor):
        _check_u8(data.dtype, what)
        return data.cpu().numpy()
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    arr = np.asarray(data)
    _check_u8(arr.dtype, what)
    return arr


@dataclasses.dataclass(frozen=True)
class LongestCommonSubstring:
    """The longest prefix of a needle found anywhere in the indexed text.

    `start`/`len` locate the match in the indexed text; `as_bytes` returns
    the matched slice.
    """

    text: np.ndarray  # host view of the indexed text (uint8)
    start: int
    len: int

    def as_bytes(self) -> bytes:
        return bytes(self.text[self.start : self.start + self.len].tobytes())

    def __repr__(self) -> str:  # pragma: no cover - debug nicety
        return (
            f"LongestCommonSubstring(start={self.start}, len={self.len}, "
            f"bytes={self.as_bytes()!r})"
        )


class NotSorted(Exception):
    """Raised when `verify` finds the SA is not a valid suffix array; keeps
    the offending adjacent-pair indices (i, j)."""

    def __init__(self, i: int, j: int, reason: str = ""):
        self.i = int(i)
        self.j = int(j)
        super().__init__(
            f"suffix array not sorted at adjacent entries ({self.i}, {self.j})"
            + (f": {reason}" if reason else "")
        )


@runtime_checkable
class StringIndex(Protocol):
    """The one abstraction every index type implements."""

    def longest_substring_match(self, needle: BytesLike) -> LongestCommonSubstring:
        ...


class SuffixArray:
    """An owning (text, sa) pair with query/verify methods.

    Both tensors live on one device; `text_bytes()` materialises a host
    copy lazily for `LongestCommonSubstring.as_bytes()`.
    """

    def __init__(self, text: BytesLike, sa, device=None):
        self.text = as_text_tensor(text, device)
        self.sa = as_index_tensor(sa, self.text.device)
        if self.sa.shape != (self.text.shape[0],):
            raise ValueError(
                f"sa shape {tuple(self.sa.shape)} does not match text length "
                f"{self.text.shape[0]}"
            )
        self._host_text: np.ndarray | None = None

    @classmethod
    def from_arrays(cls, text_np: np.ndarray, sa_np: np.ndarray,
                    device=None) -> "SuffixArray":
        """An index from host (text, sa) arrays, e.g. the JAX package's
        `SuffixArray` fetched with `np.asarray`."""
        text_np = np.ascontiguousarray(np.asarray(text_np, dtype=np.uint8))
        sa_np = np.ascontiguousarray(np.asarray(sa_np, dtype=np.int32))
        return cls(text_np, sa_np, device)

    @property
    def device(self) -> torch.device:
        return self.text.device

    def __len__(self) -> int:
        return int(self.text.shape[0])

    def into_parts(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.text, self.sa

    def text_bytes(self) -> np.ndarray:
        if self._host_text is None:
            self._host_text = self.text.cpu().numpy()
        return self._host_text

    def verify(self) -> None:
        from stringsearch_torch.core.verify import verify

        verify(self.text, self.sa)

    def longest_substring_match(self, needle: BytesLike) -> LongestCommonSubstring:
        from stringsearch_torch.core.search import longest_substring_match

        return longest_substring_match(self, needle)

    def longest_substring_match_batch(
        self, needles: Sequence[BytesLike]
    ) -> list[LongestCommonSubstring]:
        from stringsearch_torch.core.search import longest_substring_match_batch

        return longest_substring_match_batch(self, needles)

    def search(self, needle: BytesLike) -> tuple[int, int]:
        """(count, leftmost SA index) of exact occurrences of `needle`."""
        from stringsearch_torch.core.search import sa_search

        return sa_search(self, needle)
