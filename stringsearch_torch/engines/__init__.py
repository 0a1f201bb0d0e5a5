"""SACA engines (suffix-array construction algorithms).

Counterpart of stringsearch_tpu/engines. Engines here:
- "doubling": prefix-doubling SACA with tied-group compaction, every sort
  through the Hopper bitonic kernel on CUDA.
- "oracle": the trusted host C++ SA-IS engine, for differential checks.
"dc3" and "bstar" are not ported yet (ROADMAP, modules to port).
"""

from __future__ import annotations

from typing import Callable

from stringsearch_torch.core.types import BytesLike, SuffixArray

_NOT_PORTED = {
    "dc3": "engines/dc3.py is not ported yet (ROADMAP: modules to port, dc3)",
    "bstar": "engines/bstar.py is not ported yet (ROADMAP: modules to port, "
             "bstar, after build_ints_with_isa)",
}


def get_engine(name: str) -> Callable[..., SuffixArray]:
    """The engine's `sort(text, device=None) -> SuffixArray`."""
    if name == "doubling":
        from stringsearch_torch.engines.doubling import sort

        return sort
    if name == "oracle":
        from stringsearch_torch.oracle import sort

        return sort
    if name in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[name])
    raise KeyError(
        f"unknown engine {name!r} (have: doubling, dc3, bstar, oracle)")


def build_suffix_array(text: BytesLike, engine: str = "doubling",
                       device=None) -> SuffixArray:
    """Build a SuffixArray with the named engine on `device` (host input
    goes to "cuda" unless told otherwise; a tensor stays on its device)."""
    return get_engine(engine)(text, device=device)
