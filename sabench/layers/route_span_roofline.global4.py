"""The global build's routing and placement against their roofline, in %:
the bound bytes of every `ops.route_partition` and `ops.place_received`
span (`peaks_global`, from the spans' `reads` and `writes`) at the card's
3.35 TB/s, over the device time of `csrc/route.cu`'s kernels on every
card (only those two functions launch them)."""

from sabench import cards, spans

SPANS = ("ops.route_partition", "ops.place_received")
KERNELS = (r"\b(route_(count|scan|base|partition)"
           r"|place_(bounds|window|scatter))_kernel\b")


def value(trace, records):
    return cards.span_roofline(trace, records, SPANS, KERNELS)


def read(trace):
    return value(trace, spans.of(trace))
