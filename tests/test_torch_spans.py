"""The program's spans (`stringsearch_torch/harness/tracing.py`) on the CPU.

Nothing records without a profiler; under one, a flat build records one
`doubling.build` whose tree, round counts, tied counts and waits are the
build's own; the sort and step spans carry the bytes the benchmark's
yardstick (`sabench/peaks.py` over `sabench.trace.CallLog`) computes; a
new session drops the last one's spans; a span's device time is that of
the operations launched between its markers, and a build on the CPU has
none, also in a process that has started CUDA.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sabench import spans as bench_spans
from sabench.trace import CallLog
from stringsearch_torch.engines import doubling
from stringsearch_torch.harness import tracing
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.ops import steps


def fibonacci(n: int) -> bytes:
    a, b = b"a", b"ab"
    while len(b) < n:
        a, b = b, b + a
    return b[:n]


TEXTS = {"fibonacci": fibonacci(6765), "enwik": enwik_like(1 << 14)}


def as_tensor(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())


def events_of(prof):
    """The profiler's (host, device) events as (name, start_us, end_us)."""
    host, device = [], []
    for e in prof.events():
        on = device if str(e.device_type).endswith("CUDA") else host
        on.append((e.name, e.time_range.start, e.time_range.end))
    return host, device


def profiled(fn):
    """fn() under a CPU profiler; its spans on the profiler's clock, and
    the profiler's host events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    host, device = events_of(prof)
    return tracing.records(host, device), host


def build(text):
    return doubling.build_sa(text, depth=12)


def children(records, span):
    return [s for s in records if s.parent == span.index]


def test_off_records_nothing(monkeypatch):
    text = as_tensor(TEXTS["enwik"])
    before = tracing.records()
    assert tracing.span("x") is tracing.OFF
    assert tracing.span("x", a=1) is tracing.OFF
    assert not tracing.OFF
    with tracing.OFF as sp:
        sp.set(a=1)

    class NoClock:
        def perf_counter_ns(self):
            raise AssertionError("a clock read with no profiler active")

    monkeypatch.setattr(tracing, "time", NoClock())
    monkeypatch.setattr(tracing, "_marker", None)
    sa = build(text)
    monkeypatch.undo()
    assert tracing.records() == before
    assert np.array_equal(sa.numpy(), build(text).numpy())


def spied_counts(text):
    """The tied counts `_refine` reads, by spying on the functions that
    produce them: (initial, [full rounds], [compacted rounds])."""
    seen = {"initial": [], "round": [], "compact": []}
    initial, full, compact = (doubling._initial_sorted,
                              doubling._full_round_sorted,
                              doubling._compact_round)

    def spy(key, fn, at):
        def spied(*a, **k):
            out = fn(*a, **k)
            seen[key].append(int(out[at]))
            return out
        return spied

    mp = pytest.MonkeyPatch()
    mp.setattr(doubling, "_initial_sorted", spy("initial", initial, 2))
    mp.setattr(doubling, "_full_round_sorted", spy("round", full, 2))
    mp.setattr(doubling, "_compact_round", spy("compact", compact, 4))
    try:
        build(text)
    finally:
        mp.undo()
    return seen["initial"][0], seen["round"], seen["compact"]


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_a_profiled_build_records_its_tree(name):
    text = as_tensor(TEXTS[name])
    initial, full, compact = spied_counts(text)
    records, events = profiled(lambda: build(text))
    by_name = {}
    for s in records:
        by_name.setdefault(s.name, []).append(s)

    (b,) = by_name["doubling.build"]
    assert b.parent is None and b.attrs == {}
    top = [s.name for s in children(records, b)]
    assert top[0] == "doubling.initial"
    assert top[1:1 + len(full)] == ["doubling.round"] * len(full)
    assert top[1 + len(full):] == (["doubling.compact"] if compact else [])

    (ini,) = by_name["doubling.initial"]
    assert ini.attrs["tied"] == initial
    assert [s.name for s in children(records, ini)] == [
        "ops.pack_keys", "ops.device_sort", "ops.head_ranks",
        "doubling.wait"]

    rounds = by_name.get("doubling.round", [])
    assert [r.attrs["tied_out"] for r in rounds] == full
    assert [r.attrs["tied_in"] for r in rounds] == ([initial] + full)[:-1]
    for r in rounds:
        assert r.attrs["n"] == len(TEXTS[name])
        assert [s.name for s in children(records, r)] == [
            "doubling.invert", "ops.shift_planes", "ops.device_sort",
            "ops.head_ranks", "doubling.wait"]

    # each invert is one `invert_ranks` scatter over the n positions, with
    # no sort inside
    inverts = by_name.get("doubling.invert", [])
    assert len(inverts) == len(full) + (1 if compact else 0)
    for inv in inverts:
        (op,) = children(records, inv)
        assert op.name == "ops.invert_ranks"
        n = len(TEXTS[name])
        assert op.attrs == {"reads": ((n, 4), (n, 4)), "writes": ((n, 4),)}
    assert len(by_name.get("ops.invert_ranks", [])) == len(inverts)

    crounds = by_name.get("doubling.compact_round", [])
    assert [r.attrs["tied_out"] for r in crounds] == compact
    if compact:
        (c,) = by_name["doubling.compact"]
        kids = [s.name for s in children(records, c)]
        assert kids[:2] == ["doubling.invert", "doubling.extract"]
        assert kids.count("doubling.compact_round") == len(compact)
        assert crounds[0].attrs["tied_in"] == (full or [initial])[-1]

    # one wait a tied count read, each around the read's host event
    waits = by_name["doubling.wait"]
    reads = sorted((s, e) for n, s, e in events
                   if n == "aten::_local_scalar_dense")
    assert len(waits) == len(reads) == 1 + len(full) + len(compact)
    for w, (s, e) in zip(waits, reads):
        assert w.start_us <= s <= e <= w.end_us
    assert all(s.device_ms is None for s in records)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_span_bytes_equal_the_yardstick(name):
    """The sort and step spans' bytes equal `sabench/peaks.py`'s bytes of
    the same calls, as `sabench.trace.CallLog` logs them."""
    text = as_tensor(TEXTS[name])
    with CallLog() as log:
        records, _ = profiled(lambda: build(text))
    from_spans = []
    for s in records:
        if s.name == "ops.device_sort":
            from_spans.append(("device_sort", bench_spans.sort_bytes(s.attrs)))
        elif s.name in ("ops.pack_keys", "ops.shift_planes",
                        "ops.head_ranks"):
            from_spans.append((s.name[4:], bench_spans.plane_bytes(s.attrs)))
    order = {"device_sort": 0, "pack_keys": 1, "shift_planes": 2,
             "head_ranks": 3}
    assert sorted(from_spans, key=lambda c: order[c[0]]) == sorted(
        log.calls, key=lambda c: order[c[0]])
    assert [c for c in from_spans if c[0] == "device_sort"] == [
        c for c in log.calls if c[0] == "device_sort"]
    # depth 12: the text read, three key planes and the position written
    assert ("pack_keys", 17 * len(TEXTS[name])) in from_spans


def sorted_lengths(records):
    """The length of the text each build's initial sort sorted."""
    name = {s.index: s.name for s in records}
    return [s.attrs["n"] for s in records if s.name == "ops.device_sort"
            and name[s.parent] == "doubling.initial"]


def test_a_new_session_drops_the_last():
    short, long_ = (as_tensor(TEXTS["fibonacci"][:1000]),
                    as_tensor(TEXTS["enwik"]))
    first, _ = profiled(lambda: build(short))
    assert sorted_lengths(first) == [1000]
    # read after the first session: the next span starts a new one
    second, _ = profiled(lambda: build(long_))
    assert sorted_lengths(second) == [1 << 14]
    assert second[0].index == 0
    # back to back, with nothing between: the events of the second
    # session place its spans and no others
    with profile(activities=[ProfilerActivity.CPU]):
        build(short)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        build(long_)
    placed = tracing.records(*events_of(prof))
    assert sorted_lengths(placed) == [1 << 14]
    assert tracing.records([]) == []


def test_marks_put_spans_on_the_profiler_clock():
    """Spans and the profiler's own ranges between them: the placed times
    keep the order the host ran them in. The outermost span marks its two
    ends and a wait span its entry; no other span marks."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner", k=1) as sp:
                with torch.profiler.record_function("between"):
                    pass
                sp.set(k=2)
            with tracing.wait_span("wait"):
                with torch.profiler.record_function("waiting"):
                    pass
    events, _ = events_of(prof)
    outer, inner, wait = tracing.records(events)
    (_, s, e), = [ev for ev in events if ev[0] == "between"]
    (_, ws, we), = [ev for ev in events if ev[0] == "waiting"]
    assert (outer.name, inner.name, inner.parent) == ("outer", "inner",
                                                      outer.index)
    assert inner.attrs == {"k": 2}
    assert outer.start_us <= inner.start_us <= s <= e <= inner.end_us <= (
        wait.start_us) <= ws <= we <= wait.end_us <= outer.end_us
    assert sum(ev[0] == tracing.ANCHOR for ev in events) == 3


def launch(name="cudaLaunchKernel"):
    """A host event of the launching call's name, a millisecond clear of
    the span boundaries either side."""
    time.sleep(1e-3)
    with torch.profiler.record_function(name):
        pass
    time.sleep(1e-3)


def test_a_span_holds_the_operations_launched_inside_it():
    """Synthetic launches: the k-th launching call put the k-th device
    operation on the stream, and a span's device time sums those launched
    between its markers."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        launch()  # before any span: no span holds it
        with tracing.span("outer"):
            with tracing.span("a"):
                launch()
                launch("cudaMemsetAsync")
                launch("cudaStreamSynchronize")  # puts nothing on a stream
            with tracing.span("idle"):
                pass
            launch("cudaMemcpyAsync")
    host, _ = events_of(prof)
    device = [("k0", 0.0, 1.0), ("k1", 10.0, 13.0), ("memset", 13.0, 13.5),
              ("copy", 20.0, 24.0)]
    outer, a, idle = tracing.records(host, device)
    assert (outer.name, a.name, idle.name) == ("outer", "a", "idle")
    assert a.device_ms == pytest.approx(3.5e-3)
    assert outer.device_ms == pytest.approx(7.5e-3)
    assert idle.device_ms is None
    # the device operations listed in any order
    assert tracing.records(host, device[::-1])[1].device_ms == (
        pytest.approx(3.5e-3))
    # a trace whose operations and launches do not match one for one
    # gives no device times
    for ops in (device[:3], device + [("extra", 30.0, 31.0)], []):
        assert all(s.device_ms is None for s in tracing.records(host, ops))
    assert all(s.device_ms is None for s in tracing.records(host))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cpu_spans_carry_no_device_time_once_cuda_runs(cuda):
    """In a process that has started CUDA, a CPU build's spans carry no
    device time, and a CUDA build's carry the device time of its
    operations, within the traced device time."""
    text = as_tensor(TEXTS["fibonacci"])
    want = build(text)
    assert torch.equal(build(text.to(cuda)).cpu(), want)
    torch.cuda.synchronize()
    assert torch.cuda.is_initialized()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        build(text)
    host, device = events_of(prof)
    records = tracing.records(host, device)
    assert records and all(s.device_ms is None for s in records)
    assert bench_spans.on_device(records) is False

    before = steps.launches["invert_ranks"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        build(text.to(cuda))
        torch.cuda.synchronize()
    host, device = events_of(prof)
    records = tracing.records(host, device)
    # one `invert_ranks` launch an invert
    inverts = [s for s in records if s.name == "doubling.invert"]
    assert inverts
    assert steps.launches["invert_ranks"] - before == len(inverts)
    assert all(s.device_ms > 0.0 for s in inverts)
    (b,) = [s for s in records if s.name == "doubling.build"]
    busy = sum(e - s for _, s, e in device) / 1e3
    assert bench_spans.on_device(records)
    assert 0.0 < b.device_ms <= busy + 1e-9
    sorts = [s for s in records if s.name == "ops.device_sort"]
    assert sorts and all(s.device_ms > 0.0 for s in sorts)
