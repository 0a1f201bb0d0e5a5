"""Byte bounds of the global build's kernels, from the `reads` and
`writes` attributes of the program's spans ((elements, bytes an element)
of each plane a step takes and gives).

Each counts the live elements read once and written once, as the kernel
table of PERF.md counts them, so that a share of the card's 3.35 TB/s
(`peaks.bound_s`) is comparable with that table's shares. At the table's
shapes (a shard of L = 2^26, four int32 shards) they give its bounds:
`route_partition` 24 B an element with two int32 operands (48 with four,
96 with four int64), `place_received` 12 B a slot, `merge_split` 2 x 20 B
a slot kept, `shard_pack_keys` 21 B a position, `shard_shift_planes` 20 B
a position, `shard_head_ranks` 20 B a slot after the initial sort (16 B
after a first round's three int32 key planes, 32 B int64).
"""

from __future__ import annotations


def _bytes(planes) -> int:
    return sum(n * size for n, size in planes)


def route_partition_bytes(attrs) -> int:
    """Every input plane read once and every slot of the [p, cap] send
    buffers written once, the fill of the slots past a row's count
    included (the kernel writes it): 4 + 8 B an int32 operand at the
    routes' cap = 2 L / p."""
    return _bytes(attrs["reads"]) + _bytes(attrs["writes"])


def place_received_bytes(attrs) -> int:
    """The L live entries of the received positions and of each operand
    read, and each [L] output written: 12 B a slot with one int32
    operand. The [p, cap] buffers' slots past each row's count hold no
    entry, and the placement by windows need not read them."""
    live = attrs["writes"][0][0]
    return live * sum(size for _, size in (*attrs["reads"],
                                           *attrs["writes"]))


def merge_split_bytes(attrs) -> int:
    """The kept half read from the two runs and written once: twice the
    bytes of the planes written (2 x 20 B a slot kept at five int32
    planes)."""
    return 2 * _bytes(attrs["writes"])


def shard_pack_keys_bytes(attrs) -> int:
    """The shard's text read once and each key plane and the positions
    written once: 21 B a position at depth 16. The halo, the next shard's
    first `depth` bytes, is that shard's."""
    return _bytes(attrs["reads"][:1]) + _bytes(attrs["writes"])


def shard_shift_planes_bytes(attrs) -> int:
    """The parts of each window read once (L elements a shift where the
    shifted window lies inside the text) and each shifted plane and the
    positions written once: 20 B a position at fan 3."""
    return _bytes(attrs["reads"]) + _bytes(attrs["writes"])


def shard_head_ranks_bytes(attrs) -> int:
    """The sorted key planes read once and the ranks written once. PERF.md's
    8 B a slot for a shard wholly inside one tie group is a reading of
    that case alone, which this count does not model."""
    return _bytes(attrs["reads"]) + _bytes(attrs["writes"])


BYTES = {
    "ops.route_partition": route_partition_bytes,
    "ops.place_received": place_received_bytes,
    "ops.merge_split": merge_split_bytes,
    "ops.shard_pack_keys": shard_pack_keys_bytes,
    "ops.shard_shift_planes": shard_shift_planes_bytes,
    "ops.shard_head_ranks": shard_head_ranks_bytes,
}


def span_bytes(span) -> int:
    """The bound bytes of one of the spans above."""
    return BYTES[span.name](span.attrs)
