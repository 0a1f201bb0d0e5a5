"""The steps' share of their roofline, in %, from the program's spans: the
bytes bound of every `ops.pack_keys`, `ops.shift_planes` and
`ops.head_ranks` span (the planes each reads and writes, once, at the
card's 3.35 TB/s) over those spans' device time. `steps_roofline`'s
definition, with no kernel name and no wrapped call."""

from sabench import peaks, spans

STEPS = ("ops.pack_keys", "ops.shift_planes", "ops.head_ranks")


def value(trace, records):
    steps = [s for s in records if s.name in STEPS]
    if not steps or not spans.on_device(records):
        return None
    nbytes = sum(spans.plane_bytes(s.attrs) for s in steps)
    ms = spans.device_ms(steps, *STEPS)
    return 100.0 * peaks.bound_s(nbytes) / (ms * 1e-3) if ms else None


def read(trace):
    return value(trace, spans.of(trace))
