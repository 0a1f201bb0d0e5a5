"""The exact global build on four CPU shards against the benchmark's plain
reference, and the spans of the global layer.

`build_global` over `make_mesh(devices=[cpu] * 4)` with its defaults (as
the benchmark's cell `enwik9-1g.global4` calls it on four cards) against
`sabench/reference.py`, which is plain PyTorch and imports neither JAX nor
the program: `doubling_sa` gives the suffix array and `check_sa` judges
the build's. Seeded enwik-class text at 2^12-2^16 B, a length that 4 does
not divide, the Fibonacci word, and a long run of one byte before random
text, which overflows `rank_interval_sort`'s and the redistribute's
routes (they fall back to the merge-split sort) and then enters the
compacted rounds, which fall back at four shards; the counters are read
back. Then the spans: a build under a CPU profiler records every span of
the global layer with its attributes, `global.build`'s fallbacks equal
the module counters, and the `coll.*` spans' bytes equal the collectives'
`sent` counters. Everything compared is an integer: tolerance none.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sabench import reference
from stringsearch_torch.harness import tracing
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.parallel import collectives as coll
from stringsearch_torch.parallel import distsort, global_sa
from stringsearch_torch.parallel.global_sa import build_global
from stringsearch_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")


def fibonacci(n: int) -> bytes:
    a, b = b"a", b"ab"
    while len(b) < n:
        a, b = b, b + a
    return b[:n]


def long_run(n: int) -> bytes:
    """A run of 1500 'x' before random lowercase text: the run's suffixes
    stay tied for rounds, one group routed to one shard."""
    rng = np.random.default_rng(22)
    return b"x" * 1500 + rng.integers(97, 123, n - 1500,
                                      dtype=np.uint8).tobytes()


TEXTS = {
    "enwik_2^12": lambda: enwik_like(1 << 12, seed=3),
    "enwik_2^14": lambda: enwik_like(1 << 14, seed=5),
    "enwik_2^16": lambda: enwik_like(1 << 16, seed=7),
    "enwik_2^14+3": lambda: enwik_like((1 << 14) + 3, seed=11),
    "fibonacci": lambda: fibonacci(10946),
    "long_run": lambda: long_run(8000),
}


def as_tensor(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())


def mesh():
    return make_mesh(devices=[CPU] * 4)


def counters() -> tuple:
    return dict(distsort.fallbacks), global_sa.compact_fallbacks


def counted_since(before) -> tuple:
    fell, compact = before
    return ({k: v - fell.get(k, 0) for k, v in distsort.fallbacks.items()
             if v > fell.get(k, 0)}, global_sa.compact_fallbacks - compact)


@pytest.mark.parametrize("name", list(TEXTS))
def test_build_equals_the_plain_reference(name):
    data = TEXTS[name]()
    text = as_tensor(data)
    before = counters()
    g = build_global(data, mesh())
    fell, compact = counted_since(before)
    sa = torch.cat(list(g.sa_shards))
    assert sa.dtype == torch.int32
    assert torch.equal(sa, reference.doubling_sa(text))
    assert reference.check_sa(text, sa) == {"sa_not_perm": 0,
                                            "sa_bad_pairs": 0}
    assert np.array_equal(sa.numpy(), g.suffix_array())
    if name == "long_run":
        # the run's group overflows one pair of the routes; its compacted
        # round falls back at four shards (the reference's own gap)
        assert fell.get("rank_interval", 0) > 0
        assert fell.get("redistribute", 0) > 0
        assert compact >= 1 and g.compact_rounds_executed >= 1


@pytest.mark.parametrize("n", [4096, (1 << 12) + 3])
def test_sa_shards_are_each_shards_slice(n):
    g = build_global(enwik_like(n, seed=13), mesh())
    pieces = g.sa_shards
    assert len(pieces) == 4
    assert [p.numel() for p in pieces] == (
        [g.chunk_len - g.pad] + [g.chunk_len] * 3)
    assert all(p.device == CPU for p in pieces)
    assert np.array_equal(torch.cat(list(pieces)).numpy(), g.suffix_array())


def traced_build(data: bytes):
    """One build under a CPU profiler: (its spans, the counters' growth,
    the collectives' `sent` counters)."""
    coll.reset_traffic()
    before = counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build_global(data, mesh())
    host = [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()]
    return (tracing.records(host, []), counted_since(before),
            {k: dict(v) for k, v in coll.sent.items() if v})


GLOBAL_SPANS = [
    "global.build", "global.place", "global.initial", "global.round",
    "global.compact_round", "global.redistribute", "global.wait",
    "distsort.rank_interval_sort", "distsort.recv_sort",
    "distsort.sharded_sort", "coll.all_to_all", "coll.ppermute",
    "coll.all_gather", "coll.reduce", "ops.route_partition",
    "ops.place_received", "ops.merge_split", "ops.shard_pack_keys",
    "ops.shard_shift_planes", "ops.shard_head_ranks", "ops.device_sort"]


@pytest.fixture(scope="module")
def traced():
    """A build of `long_run` and one of enwik-class text, each traced."""
    return {name: traced_build(TEXTS[name]())
            for name in ("long_run", "enwik_2^14")}


@pytest.mark.parametrize("name", GLOBAL_SPANS)
def test_a_traced_build_records_each_span(traced, name):
    records = traced["long_run"][0] + traced["enwik_2^14"][0]
    assert any(s.name == name for s in records)


def test_the_build_span_holds_the_tree_and_the_fallbacks(traced):
    for records, (fell, compact), _ in traced.values():
        builds = [s for s in records if s.name == "global.build"]
        assert len(builds) == 1 and builds[0].parent is None
        assert builds[0].attrs == {"fallbacks": fell,
                                   "compact_fallbacks": compact}
        top = builds[0].index
        place, initial = [s for s in records if s.parent == top][:2]
        assert (place.name, initial.name) == ("global.place",
                                              "global.initial")
        assert place.attrs.get("copies", []) == []  # one device
        assert initial.attrs["tied"] >= 0
    records, (fell, compact), _ = traced["long_run"]
    rounds = [s for s in records if s.name == "global.round"]
    crounds = [s for s in records if s.name == "global.compact_round"]
    assert rounds and crounds
    for r in rounds + crounds:
        assert set(r.attrs) == {"n" if r in rounds else "m", "tied_in",
                                "tied_out", "fell_back"}
    # each round's tied count goes in where the last came out
    chain = sorted(rounds + crounds, key=lambda s: s.index)
    assert [r.attrs["tied_in"] for r in chain[1:]] == [
        r.attrs["tied_out"] for r in chain[:-1]]
    assert chain[-1].attrs["tied_out"] == 0
    assert all(r.attrs["n"] == 8000 for r in rounds)
    assert sum(r.attrs["fell_back"] for r in crounds) == compact
    assert any(r.attrs["fell_back"] for r in rounds)
    interval = [s for s in records if s.name == "distsort.rank_interval_sort"]
    assert sum(s.attrs.get("fell_back", False) for s in interval) == (
        fell.get("rank_interval", 0) + fell.get("rank_interval_boundary", 0))


def test_collective_bytes_equal_the_sent_counters(traced):
    for records, _, sent in traced.values():
        by_kind = collections.defaultdict(collections.Counter)
        for s in records:
            if s.name.startswith("coll."):
                by_kind[s.attrs["kind"]].update(s.attrs["sent"])
                assert s.attrs["copies"] == []  # one device: no copies
        assert {k: dict(v) for k, v in by_kind.items()} == sent
        assert set(sent) >= {"ppermute", "all_to_all", "all_gather",
                             "reduce", "boundary"}


def test_step_spans_carry_their_planes(traced):
    records = traced["enwik_2^14"][0]
    length = (1 << 14) // 4
    packs = [s for s in records if s.name == "ops.shard_pack_keys"]
    assert len(packs) == 4
    # the chunk, then the next shard's 16 bytes (none past the last)
    assert [s.attrs["reads"] for s in packs] == [
        ((length, 1), (16, 1))] * 3 + [((length, 1),)]
    assert all(s.attrs["writes"] == ((length, 4),) * 5 for s in packs)
    for s in records:
        if s.name == "ops.shard_head_ranks":
            keys = len(s.attrs["reads"])
            assert s.attrs["reads"] == ((length, 4),) * keys
            assert s.attrs["writes"] == ((length, 4),)
        if s.name == "ops.merge_split":
            (n, size), *_ = s.attrs["writes"]
            assert n == length and len(s.attrs["reads"]) == 2 * len(
                s.attrs["writes"])
        if s.name == "ops.place_received":
            assert all(n == length for n, _ in s.attrs["writes"])
        if s.name == "ops.device_sort":
            assert s.attrs["card"] is None  # the CPU


def test_moved_records_a_copy_between_devices():
    x = torch.arange(6, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("t") as sp:
            y = coll.moved(x, torch.device("meta"), sp)
            coll.moved(x, CPU, sp)  # no copy on its own device
            assert sp.attrs["copies"] == [(None, None, 24)]
    assert y.device.type == "meta"
    assert coll.moved(x, CPU) is x
