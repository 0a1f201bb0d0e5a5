"""Device time of the compaction stage a build, in ms: the
`doubling.compact` spans (extraction of the tied groups, the compacted
rounds and the shrinks: the device time of the operations they launched,
which holds none of the device's idle in their host waits), less the
`doubling.invert` spans inside them, so that this metric and
`invert_ms.build` do not overlap. A build that
resolves in its full rounds compacts nothing and adds 0 (some `enwik9`
seeds do)."""

from sabench import spans


def value(trace, records):
    if trace.kind != "build" or not spans.on_device(records):
        return None
    compacts = {s.index for s in records if s.name == "doubling.compact"}
    inverts = spans.device_ms([s for s in records if s.parent in compacts],
                              "doubling.invert")
    return (spans.device_ms(records, "doubling.compact") - inverts) / (
        spans.builds(records))


def read(trace):
    return value(trace, spans.of(trace))
