"""The cell `enwik9-1g.global4` on the CPU: its kind through `run_workload`
on four CPU shards, the shard-wise digest against `Digest` of the
concatenation, the global build's byte bounds at the shapes of PERF.md's
kernel table, and the cell's readers on synthetic spans and traces of
several cards, each value worked out by hand; silence where there is no
global build."""

import collections
import importlib.util
import os

import pytest
import torch

from sabench import cards, peaks, peaks_global, reference
from sabench.reference_global import ShardDigest
from sabench.run import run_workload
from sabench.trace import Trace

CELL = "enwik9-1g.global4"
LAYERS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "layers")
READERS = ["exchange_ms.global4", "recv_sort_ms.global4",
           "fallbacks_per_build.global4", "route_span_roofline.global4",
           "merge_span_roofline.global4",
           "shard_steps_span_roofline.global4",
           "sort_span_roofline.global4"]
SEED = 4_210_002_002  # past 32 signed bits, as a run's seed may be

Span = collections.namedtuple(
    "Span", "name index parent attrs start_us end_us device_ms")


def layer(name):
    spec = importlib.util.spec_from_file_location(
        "global4_layer_" + name.replace(".", "_"),
        os.path.join(LAYERS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tree(*items):
    """Spans from (name, parent index, attrs), indexed in order."""
    return [Span(name, i, parent, attrs, 0.0, 0.0, None)
            for i, (name, parent, attrs) in enumerate(items)]


def trace(ops_by_card, window=(0.0, 1000.0), kind="build"):
    """A trace of len(ops_by_card) cards from each card's (name, start,
    end) operations."""
    ops, places = [], []
    for card, card_ops in enumerate(ops_by_card):
        ops += card_ops
        places += [card] * len(card_ops)
    return Trace(kind=kind, units=2, window=window, device_ops=ops,
                 host_ops=[], calls=[], syncs=[], sort_launches=0,
                 device_cards=places, cards=len(ops_by_card))


# -- the kind, end to end on four CPU shards ---------------------------------


@pytest.mark.parametrize("trace_on", [False, True])
def test_the_cell_builds_on_four_cpu_shards(trace_on):
    r = run_workload(CELL, SEED, 0.2, trace_on, device="cpu",
                     config_overrides={"text_bytes": 9001})
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["device"]["count"] == 4
    assert all(c["value"] == 0 for c in r["checks"].values())
    if trace_on:
        # no device operations on the CPU: only the program's counters
        assert set(r["metrics"]) == {"fallbacks_per_build.global4",
                                     "sort_calls_per_build.build",
                                     "syncs_per_build.build"}
    else:
        assert set(r["metrics"]) == {"build_Bps", "peak_GiB", "setup_s"}


def test_the_global_control_fails_on_four_cpu_shards():
    from sabench.control_global import GlobalControl

    r = run_workload(CELL, SEED, 0.2, False, device="cpu",
                     config_overrides={"text_bytes": 9001},
                     program=GlobalControl())
    checks = {k: c["value"] for k, c in r["checks"].items()}
    assert not r["correct"] and r["failed"] == r["attempted"] >= 1
    assert checks["sa_bad_pairs"] > 0
    assert checks["sa_not_perm"] == 0 and checks["builds_differ"] == 0


def test_the_cell_refuses_a_program_that_does_not_build_by_shard():
    from sabench.control import Control
    from sabench.spec import SpecError

    with pytest.raises(SpecError, match="does not build by shard"):
        run_workload(CELL, SEED, 0.2, False, device="cpu",
                     config_overrides={"text_bytes": 9001},
                     program=Control())


@pytest.mark.parametrize("depth", [1, 3, 16])
def test_first_bytes_order_puts_the_ties_in_position_order(depth):
    from sabench.control_global import first_bytes_order

    text = torch.tensor(list(b"abracadabra abracadabra"), dtype=torch.uint8)
    sa = reference.doubling_sa(text)
    got = first_bytes_order(text, sa, depth).tolist()
    data = bytes(text.tolist())
    want = sorted(range(len(data)), key=lambda i: (data[i:i + depth], i))
    assert sorted(got) == list(range(len(data))) and got == want


# -- the shard-wise digest ---------------------------------------------------


LAYOUTS = {
    "mid-row boundaries": (3 * 4096 + 5, [5000, 4000, 3293]),
    "row-aligned": (4 * 4096, [4096, 8192, 4096]),
    "inside one row": (4096 + 70, [10, 20, 4096 + 40]),
    "shorter than a row": (3000, [1000, 2000]),
    "four shards, a tail": (8 * 4096 + 999, [8441, 8442, 8442, 8442]),
}


def pieces_of(sa, lengths):
    return list(torch.split(sa, lengths))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_shard_digest_equals_the_digest_of_the_concatenation(name):
    n, lengths = LAYOUTS[name]
    sa = torch.randperm(n, generator=torch.Generator().manual_seed(n)).to(
        torch.int32)
    want = reference.Digest(n, "cpu")(sa)
    digest = ShardDigest(n, "cpu")
    assert torch.equal(digest(pieces_of(sa, lengths)), want)
    # one swap across a shard boundary changes it
    at = lengths[0]
    swapped = sa.clone()
    swapped[[at - 1, at]] = sa[[at, at - 1]]
    assert not torch.equal(digest(pieces_of(swapped, lengths)), want)


def test_shard_digest_wraps_as_the_digest_does():
    # sums far past 2^31 in every row and column
    n = 8 * 4096 + 17
    sa = torch.full((n,), 2**31 - 1, dtype=torch.int32)
    sa[::3] = -2**31
    assert torch.equal(ShardDigest(n, "cpu")(pieces_of(sa, [9000, n - 9000])),
                       reference.Digest(n, "cpu")(sa))


def test_shard_digest_refuses_the_wrong_length():
    with pytest.raises(ValueError):
        ShardDigest(100, "cpu")([torch.zeros(99, dtype=torch.int32)])


# -- byte bounds at PERF.md's kernel table shapes (L = 2^26, P = 4) -----------


L = 1 << 26


def bound_ms(name, reads, writes):
    span = Span(name, 0, None, {"reads": reads, "writes": writes}, 0, 0,
                None)
    return round(peaks.bound_s(peaks_global.span_bytes(span)) * 1e3, 4)


@pytest.mark.parametrize("name, reads, writes, ms", [
    # route: two, four int32 and four int64 operands into [4, L / 2]
    ("ops.route_partition", ((L, 4),) * 2, ((2 * L, 4),) * 2, 0.4808),
    ("ops.route_partition", ((L, 4),) * 4, ((2 * L, 4),) * 4, 0.9616),
    ("ops.route_partition", ((L, 8),) * 4, ((2 * L, 8),) * 4, 1.9231),
    # placement: the [4, L / 2] received gidx and operand, [L] out
    ("ops.place_received", ((2 * L, 4),) * 2, ((L, 4),), 0.2404),
    # merge-split of five int32 planes
    ("ops.merge_split", ((L, 4),) * 10, ((L, 4),) * 5, 0.8013),
    # pack at depth 16, with the next shard's 16 bytes
    ("ops.shard_pack_keys", ((L, 1), (16, 1)), ((L, 4),) * 5, 0.4207),
    # shift at fan 3, h = 16: two windows of L read, three planes written
    ("ops.shard_shift_planes", ((L - 16, 4), (16, 4), (L - 32, 4), (32, 4)),
     ((L, 4),) * 3, 0.4006),
    # head ranks after the initial sort (4 key planes), the first round's
    # 3 int32 and 3 int64 key planes
    ("ops.shard_head_ranks", ((L, 4),) * 4, ((L, 4),), 0.4006),
    ("ops.shard_head_ranks", ((L, 4),) * 3, ((L, 4),), 0.3205),
    ("ops.shard_head_ranks", ((L, 8),) * 3, ((L, 8),), 0.6410),
])
def test_byte_bounds_equal_the_kernel_table(name, reads, writes, ms):
    assert bound_ms(name, reads, writes) == ms


# -- the readers -----------------------------------------------------------


def global_builds():
    """Two builds: the first with a placement copy, two collectives'
    copies, a receive sort and a local sort on each of two cards, the
    second with one collective copy."""
    return tree(
        ("global.build", None, {"fallbacks": {"rank_interval": 2},
                                "compact_fallbacks": 1}),           # 0
        ("global.place", 0, {"copies": [(0, 1, 64)]}),               # 1
        ("ops.device_sort", 0, {"n": 8, "card": 0}),                # 2
        ("ops.device_sort", 0, {"n": 8, "card": 1}),                # 3
        ("coll.all_to_all", 0, {"copies": [(0, 1, 8), (1, 0, 8)]}),  # 4
        ("distsort.recv_sort", 0, {}),                              # 5
        ("ops.device_sort", 5, {"n": 16, "card": 0}),               # 6
        ("ops.device_sort", 5, {"n": 16, "card": 1}),               # 7
        ("coll.ppermute", 0, {"copies": [(1, 0, 4)]}),               # 8
        ("global.build", None, {"fallbacks": {},
                                "compact_fallbacks": 1}),           # 9
        ("coll.reduce", 9, {"copies": [(0, 1, 4)]}),                 # 10
        ("ops.device_sort", 9, {"n": 1, "card": 0}),                # 11
    )


def sort_ops(t0, us_each):
    """One radix sort's operations from t0: memset, hist, plan, passes."""
    names = ["Memset", "sort_hist_kernel", "sort_plan_kernel<4>",
             "sort_pass_kernel<4>", "sort_pass_kernel<4>"]
    return [(name, t0 + i * 10, t0 + i * 10 + us) for i, (name, us) in
            enumerate(zip(names, us_each))]


def two_card_trace():
    # card 0: the placement copy, its local sort, the all_to_all copy, the
    # receive sort, the reduce's copy; card 1: its local sort, its copy,
    # the receive sort, the ppermute's copy. Card 1's begin before card
    # 0's launched earlier.
    card0 = ([("Memcpy PtoP", 100, 140)] + sort_ops(200, (1, 2, 1, 3, 3))
             + [("Memcpy PtoP", 300, 302), ("fill_kernel", 310, 311)]
             + sort_ops(400, (1, 5, 1, 10, 10))
             + [("Memcpy PtoP", 900, 901)])
    card1 = (sort_ops(50, (1, 2, 1, 4, 4))
             + [("Memcpy PtoP", 120, 123)]
             + sort_ops(150, (2, 6, 1, 20, 20))
             + [("Memcpy PtoP", 260, 262)])
    return trace([card0, card1])


def test_recv_sort_ms_pairs_each_cards_sorts_with_its_spans():
    value = layer("recv_sort_ms.global4").value
    # the second sort on each card: (1 + 5 + 1 + 10 + 10) + (2 + 6 + 1 +
    # 20 + 20) us, over two builds
    assert value(two_card_trace(), global_builds()) == pytest.approx(
        76e-3 / 2)
    # a sort span without its kernels on the card: the counts differ
    extra = global_builds() + [
        Span("ops.device_sort", 12, 5, {"n": 16, "card": 1}, 0, 0, None)]
    assert value(two_card_trace(), extra) is None


def test_exchange_ms_sums_every_copy_between_cards():
    value = layer("exchange_ms.global4").value
    # card 0: placement 40, all_to_all 2, reduce 1; card 1: all_to_all 3,
    # ppermute 2: 48 us over two builds
    assert value(two_card_trace(), global_builds()) == pytest.approx(
        48e-3 / 2)
    # a copy's record missing from the trace (card 0's all_to_all copy):
    # the rest still sum
    full = two_card_trace()
    by_card = [[], []]
    for op, card in zip(full.device_ops, full.device_cards):
        if op != ("Memcpy PtoP", 300, 302):
            by_card[card].append(op)
    assert value(trace(by_card), global_builds()) == pytest.approx(
        46e-3 / 2)


def test_fallbacks_per_build():
    value = layer("fallbacks_per_build.global4").value
    # (2 + 1) + (0 + 1) over two builds; no device operations needed
    assert value(trace([[]]), global_builds()) == pytest.approx(2.0)


def test_span_rooflines():
    records = tree(
        ("global.build", None, {"fallbacks": {}, "compact_fallbacks": 0}),
        ("ops.route_partition", 0, {"reads": ((1000, 4),) * 2,
                                    "writes": ((2000, 4),) * 2}),
        ("ops.place_received", 0, {"reads": ((2000, 4),) * 2,
                                   "writes": ((1000, 4),)}),
        ("ops.merge_split", 0, {"reads": ((1000, 4),) * 4,
                                "writes": ((1000, 4),) * 2}),
        ("ops.shard_pack_keys", 0, {"reads": ((1000, 1), (16, 1)),
                                    "writes": ((1000, 4),) * 5}),
        ("ops.shard_head_ranks", 0, {"reads": ((1000, 4),) * 4,
                                     "writes": ((1000, 4),)}))
    tr = trace([[("route_count_kernel", 0, 1), ("route_partition_kernel", 1,
                                                 3),
                 ("place_window_kernel", 3, 4), ("merge_tile_kernel", 4, 6),
                 ("pack_keys_kernel", 6, 7)],
                [("merge_partition_kernel", 0, 2),
                 ("head_ranks_kernel<int>", 2, 3),
                 ("shift_planes_kernel<int>", 3, 9),
                 ("sort_pass_kernel<4>", 9, 19)]])

    def pct(nbytes, us):
        return 100.0 * nbytes / peaks.BYTES_PER_S / (us * 1e-6)

    route = layer("route_span_roofline.global4").value(tr, records)
    assert route == pytest.approx(pct(24000 + 12000, 4))
    merge = layer("merge_span_roofline.global4").value(tr, records)
    assert merge == pytest.approx(pct(16000, 4))
    # the flat shift_planes kernel is not the shard steps'
    steps = layer("shard_steps_span_roofline.global4").value(tr, records)
    assert steps == pytest.approx(pct(21000 + 20000, 2))


def test_sort_span_roofline_pairs_each_cards_sorts_with_its_spans():
    value = layer("sort_span_roofline.global4").value
    records = [s._replace(attrs={**s.attrs, "itemsizes": (4,) * 5})
               if s.name == "ops.device_sort" else s
               for s in global_builds()]
    # four sorts on two cards, of 8, 8, 16 and 16 elements of five int32
    # planes (the one of a single element launches none): 2 n 20 bytes
    # over their memsets and kernels, 10 + 12 + 27 + 49 us
    want = 100.0 * (2 * 48 * 20) / peaks.BYTES_PER_S / 98e-6
    assert value(two_card_trace(), records) == pytest.approx(want)
    extra = records + [Span("ops.device_sort", 12, 0, {
        "n": 16, "card": 0, "itemsizes": (4,)}, 0, 0, None)]
    assert value(two_card_trace(), extra) is None


def test_idle_share_reads_card_seconds_on_the_global_cell():
    # idle_share.build, PR 21's reader, over a trace of two cards
    value = layer("idle_share.build").read
    tr = trace([[("k", 0, 500)], [("k", 0, 250), ("k", 500, 750)]])
    # busy 500 and 500 of 1000 us on each card
    assert value(tr) == pytest.approx(50.0)


@pytest.mark.parametrize("name", READERS)
def test_readers_are_silent_without_a_global_build(name):
    value = layer(name).value
    flat = tree(("doubling.build", None, {}),
                ("ops.device_sort", 0, {"n": 16, "card": 0}),
                ("ops.shard_head_ranks", 0, {"reads": ((8, 4),),
                                             "writes": ((8, 4),)}))
    tr = two_card_trace()
    assert value(tr, flat) is None
    assert value(tr, []) is None
    assert value(trace([[]], kind="other"), global_builds()) is None
