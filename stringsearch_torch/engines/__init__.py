"""SACA engines (suffix-array construction algorithms).

Counterpart of stringsearch_tpu/engines. Engines here, every sort through
the Hopper radix sort on CUDA:
- "doubling": prefix-doubling SACA with tied-group compaction;
- "dc3": the difference-cover mod-3 recursion;
- "bstar": B*-reduction with induced sorting, divsufsort's structure;
- "oracle": the trusted host C++ SA-IS engine, for differential checks.
"""

from __future__ import annotations

from typing import Callable

from stringsearch_torch.core.types import BytesLike, SuffixArray


def get_engine(name: str) -> Callable[..., SuffixArray]:
    """The engine's `sort(text, device=None) -> SuffixArray`."""
    if name == "doubling":
        from stringsearch_torch.engines.doubling import sort

        return sort
    if name == "dc3":
        from stringsearch_torch.engines.dc3 import sort

        return sort
    if name == "bstar":
        from stringsearch_torch.engines.bstar import sort

        return sort
    if name == "oracle":
        from stringsearch_torch.oracle import sort

        return sort
    raise KeyError(
        f"unknown engine {name!r} (have: doubling, dc3, bstar, oracle)")


def build_suffix_array(text: BytesLike, engine: str = "doubling",
                       device=None) -> SuffixArray:
    """Build a SuffixArray with the named engine on `device` (host input
    goes to "cuda" unless told otherwise; a tensor stays on its device)."""
    return get_engine(engine)(text, device=device)


# every engine name of the reference's registry, in its order
ENGINES = ("doubling", "dc3", "bstar", "oracle")
