"""What the round loop's host waits cost the device a build, in ms: the
device's idle time inside the traced window (the gaps between
`trace.busy_intervals()`) in gaps that begin while the host is inside a
`doubling.wait` span (reading a tied count), over the `doubling.build`
spans: the drain before the read and the relaunch after it."""

import bisect

from sabench import spans


def value(trace, records):
    if trace.kind != "build" or not trace.device_ops or not spans.builds(
            records):
        return None
    waits = sorted((s.start_us, s.end_us) for s in records
                   if s.name == "doubling.wait")
    starts = [w[0] for w in waits]
    busy = trace.busy_intervals()
    idle = 0.0
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(starts, g0) - 1
        if i >= 0 and g0 <= waits[i][1]:
            idle += g1 - g0
    return idle * 1e-3 / spans.builds(records)


def read(trace):
    return value(trace, spans.of(trace))
