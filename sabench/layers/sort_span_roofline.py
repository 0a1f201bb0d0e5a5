"""The sort's share of its roofline, in %, from the program's spans: the
bytes bound of every `ops.device_sort` span (each plane read and written
once, 2 n sum(itemsizes) bytes, at the card's 3.35 TB/s) over those spans'
device time. `sort_roofline`'s definition, with no kernel name and no
wrapped call."""

from sabench import peaks, spans

SORT = "ops.device_sort"


def value(trace, records):
    sorts = [s for s in records if s.name == SORT]
    if not sorts or not spans.on_device(records):
        return None
    nbytes = sum(spans.sort_bytes(s.attrs) for s in sorts)
    ms = spans.device_ms(sorts, SORT)
    return 100.0 * peaks.bound_s(nbytes) / (ms * 1e-3) if ms else None


def read(trace):
    return value(trace, spans.of(trace))
