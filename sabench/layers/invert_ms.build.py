"""Device time of the inverts a build, in ms: the `doubling.invert` spans
(rank[sa] = rank_s, the inverse permutation of the sorted order's ranks,
whatever implements it), the device time of the operations they
launched, over the `doubling.build` spans."""

from sabench import spans


def value(trace, records):
    if trace.kind != "build" or not spans.on_device(records):
        return None
    return spans.device_ms(records, "doubling.invert") / spans.builds(
        records)


def read(trace):
    return value(trace, spans.of(trace))
