"""The global build's merge-split against its roofline, in %: the bound
bytes of every `ops.merge_split` span (`peaks_global`, from the spans'
`reads` and `writes`) at the card's 3.35 TB/s, over the device time of
`csrc/merge.cu`'s kernels on every card (only `merge_split` launches
them)."""

from sabench import cards, spans

SPANS = ("ops.merge_split",)
KERNELS = r"\bmerge_(partition|tile)_kernel\b"


def value(trace, records):
    return cards.span_roofline(trace, records, SPANS, KERNELS)


def read(trace):
    return value(trace, spans.of(trace))
