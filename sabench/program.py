"""The system under test, as the benchmark drives it: the public entry of
stringsearch_torch, imported only when a run starts.

`Program` is what a timed unit calls. The controls (`sabench/control.py`)
and the tests put another object with the same methods in its place.
"""

from __future__ import annotations


class Program:
    """stringsearch_torch's flat doubling index."""

    def __init__(self):
        import stringsearch_torch
        from stringsearch_torch.ops import radix_sort

        self._st = stringsearch_torch
        self._radix = radix_sort

    def load_kernels(self) -> None:
        """Build (with nvcc, where the checkout has no build yet) and load
        the kernel libraries that a flat build on the card launches."""
        from stringsearch_torch.ops import steps

        self._radix.load_library()
        steps.load_library()

    def build(self, text):
        """The suffix array of a text tensor (int32, on its device)."""
        return self._st.build_suffix_array(text).sa

    def sort_launches(self) -> int:
        """The program's own count of radix sorts launched."""
        return self._radix.launches
