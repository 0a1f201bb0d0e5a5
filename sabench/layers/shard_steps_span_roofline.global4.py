"""The global build's shard steps against their roofline, in %: the bound
bytes of every `ops.shard_pack_keys`, `ops.shard_shift_planes` and
`ops.shard_head_ranks` span (`peaks_global`, from the spans' `reads` and
`writes`) at the card's 3.35 TB/s, over the device time of the three
`csrc/steps.cu` kernels they launch on every card (`pack_keys_kernel`
with a halo, `shard_shift_planes_kernel`, `head_ranks_kernel` with a
boundary; nothing else in a global build launches them)."""

from sabench import cards, spans

SPANS = ("ops.shard_pack_keys", "ops.shard_shift_planes",
         "ops.shard_head_ranks")
KERNELS = (r"(?<![A-Za-z0-9_])(pack_keys|shard_shift_planes|head_ranks)"
           r"_kernel\b")


def value(trace, records):
    return cards.span_roofline(trace, records, SPANS, KERNELS)


def read(trace):
    return value(trace, spans.of(trace))
