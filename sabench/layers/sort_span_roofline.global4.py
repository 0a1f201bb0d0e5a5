"""The global build's radix sorts against their roofline, in %: the bytes
bound of every `ops.device_sort` span that ran on a card (each plane read
and written once, 2 n sum(itemsizes) bytes, at the card's 3.35 TB/s) over
those sorts' device time, each read on its card and paired there with
its span in order (`cards.sorts`): `sort_span_roofline`'s definition,
card by card, over the local and the receive-buffer sorts."""

from sabench import cards, peaks, spans


def value(trace, records):
    if trace.kind != "build" or not trace.device_ops or not cards.builds(
            records):
        return None
    matched = cards.sorts(trace, records)
    if not matched:
        return None
    nbytes = sum(spans.sort_bytes(s.attrs) for s, _ in matched)
    us = sum(t for _, t in matched)
    return 100.0 * peaks.bound_s(nbytes) / (us * 1e-6) if us else None


def read(trace):
    return value(trace, spans.of(trace))
