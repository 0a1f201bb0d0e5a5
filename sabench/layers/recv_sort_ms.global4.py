"""Device time of the receive-buffer sorts a global build, in ms: the
local sorts of each shard's p * cap receive buffer in
`rank_interval_sort` (the `ops.device_sort` spans inside
`distsort.recv_sort`), each sort's time read on its card and paired there
with its span in order (`cards.sorts`), over the `global.build` spans."""

from sabench import cards, spans


def value(trace, records):
    if trace.kind != "build" or not trace.device_ops or not cards.builds(
            records):
        return None
    matched = cards.sorts(trace, records)
    if matched is None:
        return None
    recv = {s.index for s in records if s.name == "distsort.recv_sort"}
    us = sum(t for s, t in matched if s.parent in recv)
    return us * 1e-3 / cards.builds(records)


def read(trace):
    return value(trace, spans.of(trace))
