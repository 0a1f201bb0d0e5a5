"""Diffable phase traces.

Counterpart of stringsearch_tpu/harness/tracing.py, with the same text
format: `:: label` headers and array dumps of 25 values a line, so a trace
of the port diffs cleanly against one of the JAX package or of the host
oracle. Tracing selects a separate execution path (`engines/doubling.py`,
`sort_traced`); the fast path carries no tracing code.
"""

from __future__ import annotations

import os
from typing import IO, Optional

import numpy as np
import torch

PER_LINE = 25


class Tracer:
    """Writes phase labels and array dumps to a text file."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f: Optional[IO[str]] = open(path, "w")

    def log(self, msg: str) -> None:
        assert self._f is not None
        self._f.write(f":: {msg}\n")

    def dump(self, label: str, arr) -> None:
        """Array dump, 25 values a line. `arr` is a host array or a tensor
        on any device (fetched with one copy)."""
        assert self._f is not None
        if isinstance(arr, torch.Tensor):
            arr = arr.cpu().numpy()
        a = np.asarray(arr).ravel()
        self._f.write(f":: {label} len={a.size}\n")
        for i in range(0, a.size, PER_LINE):
            row = a[i : i + PER_LINE]
            self._f.write(" ".join(str(int(v)) for v in row) + "\n")

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self) -> "Tracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
