"""The readers of the program's spans (`sabench/spans.py` and the layers
whose source is `program_span` or `program_counter`) on synthetic spans and
traces, each value worked out by hand; silence where there is nothing to
read."""

import collections
import importlib.util
import os
import sys

import pytest

from sabench import peaks, spans
from sabench.trace import Trace

LAYERS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "layers")
NEW = ["invert_ms.build", "compact_ms.build", "tied_share.build",
       "sort_span_roofline", "steps_span_roofline", "wait_idle_ms.build"]

Span = collections.namedtuple(
    "Span", "name index parent attrs start_us end_us device_ms")


def layer(name):
    spec = importlib.util.spec_from_file_location(
        "span_layer_" + name.replace(".", "_"),
        os.path.join(LAYERS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def trace(device_ops=(), window=(0.0, 1000.0), kind="build", host_ops=()):
    return Trace(kind=kind, units=2, window=window,
                 device_ops=list(device_ops), host_ops=list(host_ops),
                 calls=[], syncs=[], sort_launches=0)


def tree(*items, device=True):
    """Spans from (name, parent index, attrs, device ms[, start, end]),
    indexed in order; device times dropped with device=False."""
    out = []
    for i, (name, parent, attrs, ms, *host) in enumerate(items):
        start, end = host or (0.0, 0.0)
        out.append(Span(name, i, parent, attrs, start, end,
                        ms if device else None))
    return out


def builds_with_inverts(device=True):
    return tree(("doubling.build", None, {}, 100.0),
                ("doubling.round", 0, {}, None),
                ("doubling.invert", 1, {}, 10.0),
                ("ops.device_sort", 2, {}, 9.5),
                ("doubling.build", None, {}, 110.0),
                ("doubling.invert", 4, {}, 20.0),
                ("doubling.compact", 4, {}, 50.0),
                ("doubling.invert", 6, {}, 30.0),
                ("doubling.extract", 6, {}, 5.0),
                device=device)


def test_invert_ms_per_build():
    value = layer("invert_ms.build").value
    # (10 + 20 + 30) ms of inverts over two builds
    assert value(trace(), builds_with_inverts()) == pytest.approx(30.0)
    assert value(trace(), builds_with_inverts(device=False)) is None
    assert value(trace(kind="other"), builds_with_inverts()) is None
    assert value(trace(), []) is None
    # builds with no round: nothing inverted
    assert value(trace(), tree(("doubling.build", None, {}, 5.0))) == 0.0


def test_compact_ms_leaves_out_its_invert():
    value = layer("compact_ms.build").value
    # 50 ms of compaction less its 30 ms invert (the extraction stays),
    # over two builds; the inverts outside it do not count
    assert value(trace(), builds_with_inverts()) == pytest.approx(10.0)
    # builds that resolve in their full rounds compact nothing
    no_compaction = [s for s in builds_with_inverts() if s.index < 6]
    assert value(trace(), no_compaction) == 0.0
    assert value(trace(), builds_with_inverts(device=False)) is None


def test_tied_share_over_full_and_compacted_rounds():
    value = layer("tied_share.build").value
    records = tree(("doubling.build", None, {}, None),
                   ("doubling.initial", 0, {"tied": 95}, None),
                   ("doubling.round", 0, {"n": 100, "tied_in": 90}, None),
                   ("doubling.round", 0, {"n": 100, "tied_in": 40}, None),
                   ("doubling.compact", 0, {}, None),
                   ("doubling.compact_round", 4, {"m": 20, "tied_in": 10},
                    None))
    # (90 + 40 + 10) tied of (100 + 100 + 20) carried; the initial sort
    # is no round; counts, so no device is needed
    assert value(trace(), records) == pytest.approx(100.0 * 140 / 220)
    assert value(trace(), records[:2]) is None
    assert value(trace(kind="other"), records) is None


def test_sort_span_roofline():
    value = layer("sort_span_roofline").value
    records = tree(("doubling.build", None, {}, 1.0),
                   ("ops.device_sort", 0,
                    {"n": 1000, "num_keys": 1, "itemsizes": (4, 4)}, 0.01),
                   ("ops.device_sort", 0,
                    {"n": 1000, "num_keys": 4, "itemsizes": (4,) * 5}, 0.02),
                   ("ops.pack_keys", 0, {"reads": (), "writes": ()}, 5.0))
    # 2 x 1000 x 8 + 2 x 1000 x 20 = 56,000 B in 0.03 ms
    want = 100.0 * 56_000 / peaks.BYTES_PER_S / 0.03e-3
    assert value(trace(), records) == pytest.approx(want)
    assert spans.sort_bytes(records[2].attrs) == 40_000
    assert value(trace(), records[:1]) is None
    assert value(trace(), tree(("doubling.build", None, {}, None),
                               ("ops.device_sort", 0, records[1].attrs,
                                None))) is None


def test_steps_span_roofline():
    value = layer("steps_span_roofline").value
    pack = {"reads": ((1000, 1),), "writes": ((1000, 4),) * 4}
    heads = {"reads": ((1000, 4),) * 3, "writes": ((1000, 4),)}
    records = tree(("doubling.build", None, {}, 1.0),
                   ("ops.pack_keys", 0, pack, 0.004),
                   ("ops.device_sort", 0,
                    {"n": 1000, "num_keys": 3, "itemsizes": (4,) * 4}, 9.0),
                   ("ops.head_ranks", 0, heads, 0.006))
    # 17,000 + 16,000 B in 0.01 ms; the sort is not a step
    assert spans.plane_bytes(pack) == 17_000
    want = 100.0 * 33_000 / peaks.BYTES_PER_S / 0.01e-3
    assert value(trace(), records) == pytest.approx(want)
    assert value(trace(), records[:1]) is None


def test_wait_idle_counts_the_gaps_that_open_in_a_wait():
    value = layer("wait_idle_ms.build").value
    # busy 0-100 (two overlapping ops), 150-300, 320-600, 700-1000 us:
    # gaps 100-150, 300-320, 600-700
    ops = [("a", 0.0, 80.0), ("b", 50.0, 100.0), ("c", 150.0, 300.0),
           ("d", 320.0, 600.0), ("e", 700.0, 1000.0)]
    records = tree(("doubling.build", None, {}, 1.0, 0.0, 500.0),
                   ("doubling.wait", 0, {}, None, 90.0, 160.0),
                   ("doubling.wait", 0, {}, None, 301.0, 315.0),
                   ("doubling.build", None, {}, 1.0, 500.0, 1000.0),
                   ("doubling.wait", 3, {}, None, 590.0, 600.0))
    # the gaps at 100 (50 us) and 600 (100 us) open inside a wait; the
    # one at 300 opens before its wait begins: 150 us over two builds
    assert value(trace(ops), records) == pytest.approx(0.075)
    assert value(trace(ops), records[:1]) == 0.0
    assert value(trace([]), records) is None
    assert value(trace(ops, kind="other"), records) is None
    assert value(trace(ops), []) is None


def test_readers_are_silent_without_the_programs_spans(monkeypatch):
    ops = [("a", 0.0, 80.0)]
    # a trace that holds none of the program's markers: no spans of any
    # session are placed on it, whatever the recorder holds
    for name in NEW:
        assert layer(name).read(trace(ops)) is None
    monkeypatch.delitem(sys.modules, spans.RECORDER, raising=False)
    assert spans.of(trace(ops)) == []
    for name in NEW:
        assert layer(name).read(trace(ops)) is None


@pytest.mark.parametrize("cell,size", [("enwik9.build", 1 << 15),
                                       ("fib41.build", 28657)])
def test_a_traced_cpu_run_reads_the_counts_and_no_device_time(cell, size):
    from sabench.run import run_workload

    r = run_workload(cell, 2**31 + 7, 0.2, True, device="cpu",
                     config_overrides={"text_bytes": size},
                     traffic_overrides={"trace_units": 2, "warmup": 1})
    assert r["correct"]
    assert 0.0 < r["metrics"]["tied_share.build"]["value"] <= 100.0
    for name in set(NEW) - {"tied_share.build"}:
        assert name not in r["metrics"]
