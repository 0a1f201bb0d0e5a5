"""Radix sorts a build launches, from the program's own counter
(`stringsearch_torch.ops.radix_sort.launches`): the rounds show here."""


def read(trace):
    if trace.kind != "build" or not trace.units:
        return None
    return trace.sort_launches / trace.units
