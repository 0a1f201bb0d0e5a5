"""The exact global index of stringsearch_torch, as the benchmark drives
it over several cards: the public entry `build_global` on
`make_mesh(devices=...)`, one shard a device, with the program's defaults
(int32 positions, `depth` 16, `fan` 3, compaction on). Imported only when
a run starts.

`GlobalProgram` is what a timed unit of `kinds/global_build.py` calls,
through the run's `program` (`Context.program`): the kind puts it in the
place of the run's default, the flat `sabench.program.Program`, and
takes any other program that builds by shard (`sharded`) as it is given,
as the global control does (`sabench/control_global.py`). `build` returns
the suffix array as the index's pieces, each on its shard's device
(`GlobalSuffixArray.sa_shards`), so that the benchmark digests each where
it lies. A program without that accessor cannot run the cell: the adapter
refuses it at set-up, before the first build.
"""

from __future__ import annotations

from sabench import spec


class GlobalProgram:
    """stringsearch_torch's global build, over the cards `use` gives."""

    sharded = True

    def __init__(self):
        from stringsearch_torch.ops import radix_sort
        from stringsearch_torch.parallel import global_sa
        from stringsearch_torch.parallel.mesh import make_mesh

        if not isinstance(getattr(global_sa.GlobalSuffixArray, "sa_shards",
                                  None), property):
            raise spec.SpecError(
                "stringsearch_torch's GlobalSuffixArray has no sa_shards: "
                "this program cannot give its suffix array by shard")
        self._build_global = global_sa.build_global
        self._make_mesh = make_mesh
        self._radix = radix_sort
        self.mesh = None

    def use(self, devices) -> None:
        """Build over `devices`, one shard a device."""
        self.mesh = self._make_mesh(devices=devices)

    def load_kernels(self) -> None:
        """Build (with nvcc, where the checkout has no build yet) and load
        the kernel libraries that the global build launches on the card:
        the radix sort, the steps, the merge-split and the routing."""
        from stringsearch_torch.ops import merge, route, steps

        for library in (self._radix, steps, merge, route):
            library.load_library()

    def build(self, text) -> tuple:
        """The suffix array of a text tensor (uint8, on the mesh's first
        device), as its shards' pieces in sorted order, each on its
        device."""
        return self._build_global(text, self.mesh).sa_shards

    def sort_launches(self) -> int:
        """The program's own count of radix sorts launched."""
        return self._radix.launches
