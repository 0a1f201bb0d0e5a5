"""Cells of more than one card: each cell opens its own cards, reports the
fullest card's peak beside each card's, and takes busy and idle time per
card. A four-card cell is laid out as new files and entries only and run
on the CPU four times over (a mesh may repeat a device); the per-card
arithmetic is checked on synthetic traces worked out by hand, and a
one-card trace and window read exactly as they did before."""

import hashlib
import importlib.util
import json
import os
import shutil
import types

import pytest
import torch

from sabench import phases, run, spec, trace
from sabench.trace import Trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LAYERS = os.path.join(ROOT, "sabench", "layers")
METRICS = os.path.join(ROOT, "sabench", "metrics")
CELL = "tiny-global.global4"

GENERATOR = """import torch


def make(config, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(97, 101, (config['text_bytes'],), generator=g,
                         dtype=torch.uint8, device=device)
"""

# a kind of its own: the exact global build over a mesh of the cell's cards
KIND = """import time

import torch

from sabench import reference


class Job:
    kind = 'build'

    def __init__(self, ctx):
        from stringsearch_torch.parallel.global_sa import build_global
        from stringsearch_torch.parallel.mesh import make_mesh

        self.ctx, self.out = ctx, []
        self.build = build_global
        self.mesh = make_mesh(devices=ctx.devices)

    def unit(self):
        t0 = time.perf_counter()
        g = self.build(self.ctx.text, self.mesh)
        self.out.append(torch.from_numpy(g.suffix_array().copy()))
        self.ctx.sync()
        return t0, time.perf_counter(), self.ctx.text.numel()

    def release(self):
        self.ctx.program = None

    def judge(self):
        text = self.ctx.text.cpu()
        bad = sum(sum(reference.check_sa(text, sa).values()) > 0
                  for sa in self.out)
        return len(self.out), bad, {'bad_builds': (bad, 0)}
"""


def digests(root):
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            path = os.path.join(dirpath, fn)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def four_card_root(tmp_path_factory):
    """A copy of the benchmark with a four-card cell added as new files
    and entries, and the digests of every file that was there before."""
    root = tmp_path_factory.mktemp("global4")
    shutil.copytree(os.path.join(ROOT, "sabench"), root / "sabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = digests(root / "sabench")
    base = root / "sabench"
    (base / "configs" / "tiny-global.json").write_text(json.dumps(
        {"name": "tiny-global", "generator": "tiny_global",
         "text_bytes": 4096}))
    (base / "generators" / "tiny_global.py").write_text(GENERATOR)
    (base / "traffic" / "global4.json").write_text(json.dumps(
        {"kind": "global_builds", "trace_units": 1}))
    (base / "kinds" / "global_builds.py").write_text(KIND)
    bench["configs"].append({"name": "tiny-global", "source": "a test",
                             "file": "sabench/configs/tiny-global.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "tiny-global",
                               "traffic": "global4", "chips": 4,
                               "why": "a test"})
    for group, key in (("end_to_end", "build_Bps"),
                       ("per_layer", "idle_share.build")):
        for entry in bench[group]:
            if entry["name"] == key:
                entry["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, before


def test_a_four_card_cell_is_new_files_and_entries(four_card_root,
                                                   monkeypatch):
    root, before = four_card_root
    after = digests(root / "sabench")
    assert all(after[k] == v for k, v in before.items())
    assert len(after) == len(before) + 4

    seen = []
    context = run.Context
    monkeypatch.setattr(run, "Context", lambda *args: seen.append(
        context(*args)) or seen[-1])
    r = run_workload(root, False)
    assert r["correct"] and r["checks"]["bad_builds"]["value"] == 0
    assert r["device"]["count"] == 4
    assert r["device"]["memory_peak_bytes_per_card"] == [0, 0, 0, 0]
    assert set(r["metrics"]) == {"build_Bps", "peak_GiB", "setup_s"}
    [ctx] = seen
    assert ctx.devices == [torch.device("cpu")] * 4
    assert ctx.device == ctx.devices[0] == ctx.text.device

    t = run_workload(root, True)
    assert t["correct"] and t["device"]["count"] == 4
    # no device work on the CPU: each card reads 0, and nothing is
    # reported as a share of a device that did nothing
    assert t["device"]["busy_s_per_card"] == [0.0] * 4
    assert t["device"]["busy_s"] == 0.0
    assert "idle_share.build" not in t["metrics"]


def run_workload(root, trace_on):
    return run.run_workload(CELL, 2**31 + 11, 0.2, trace_on, root=str(root),
                            device="cpu")


def test_the_fullest_card_wins_and_each_card_keeps_its_place(four_card_root,
                                                            monkeypatch):
    root, _ = four_card_root
    # set-up's peak of each card, then the window's
    readings = iter([10, 50, 20, 5, 30, 40, 60 * 2**30, 1])
    monkeypatch.setattr(run, "_peak", lambda device: next(readings))
    r = run_workload(root, False)
    assert r["device"]["memory_peak_bytes_per_card"] == [30, 50, 60 * 2**30,
                                                         5]
    assert r["device"]["memory_peak_bytes"] == 60 * 2**30
    # peak_GiB is the window's fullest card
    assert r["metrics"]["peak_GiB"]["value"] == 60.0


def test_one_card_results_carry_one_entry_each():
    r = run.run_workload("fib41.build", 2**31 + 7, 0.2, True, device="cpu",
                         config_overrides={"text_bytes": 28657},
                         traffic_overrides={"trace_units": 1, "warmup": 1})
    d = r["device"]
    assert r["correct"] and d["count"] == 1
    assert d["memory_peak_bytes_per_card"] == [d["memory_peak_bytes"]]
    assert d["busy_s_per_card"] == [d["busy_s"]]


def reader(folder, name):
    spec_ = importlib.util.spec_from_file_location(
        "cards_" + name.replace(".", "_"), os.path.join(folder, name + ".py"))
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module.read


def two_card_trace():
    # card 0 busy 0-40 and 60-100, card 1 busy 10-30 and 50-70
    ops = [("k0", 0.0, 40.0), ("k1", 10.0, 30.0), ("k0", 60.0, 100.0),
           ("k1", 50.0, 70.0)]
    return Trace(kind="build", units=1, window=(0.0, 100.0), device_ops=ops,
                 host_ops=[("aten::item", 45.0, 64.0)], calls=[], syncs=[],
                 sort_launches=0, device_cards=[0, 1, 0, 1], cards=2)


def test_busy_and_idle_are_taken_per_card():
    tr = two_card_trace()
    assert tr.busy_intervals(0) == [[0.0, 40.0], [60.0, 100.0]]
    assert tr.busy_intervals(1) == [[10.0, 30.0], [50.0, 70.0]]
    assert tr.busy_us_per_card() == [80.0, 40.0]
    assert tr.busy_us() == 60.0
    # 80 idle card-us of 200
    assert reader(LAYERS, "idle_share.build")(tr) == pytest.approx(40.0)
    # card 0's gap 40-60 (middle 50, inside aten::item) and card 1's
    # 0-10, 30-50 and 70-100 (middles 5, 40, 85: outside it), summed
    assert tr.breakdown()["idle_gaps"] == [
        ["host Python between traced ops", pytest.approx(60e-6)],
        ["aten::item", pytest.approx(20e-6)]]
    assert sorted(phases.gaps(tr)) == [(30.0, 50.0), (40.0, 60.0)]


def event(name, start, end, device_type, index=-1):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=device_type, device_index=index)


class FakeProfile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_read_profile_keeps_each_op_on_its_card():
    prof = FakeProfile([
        event(trace.WINDOW, 0.0, 100.0, "DeviceType.CPU"),
        event("void k<int>(int)", 0.0, 40.0, "DeviceType.CUDA", 1),
        event("void k<int>(int)", 0.0, 60.0, "DeviceType.CUDA", 0),
        event("aten::item", 45.0, 64.0, "DeviceType.CPU")])
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    tr = trace.read_profile(prof, cards, kind="build", units=1, calls=[],
                            syncs=[], sort_launches=0)
    assert tr.cards == 2 and tr.device_cards == [1, 0]
    assert tr.busy_us_per_card() == [60.0, 40.0]
    # work on a card outside the cell is refused, not dropped
    with pytest.raises(RuntimeError, match="card 1"):
        trace.read_profile(prof, cards[:1], kind="build", units=1, calls=[],
                           syncs=[], sort_launches=0)


def parent_busy(ops, window):
    """The busy time of one card as the harness read it before it took
    cards apart: the union of every op's interval, clipped."""
    w0, w1 = window
    spans = sorted((max(s, w0), min(e, w1)) for _, s, e in ops
                   if e > w0 and s < w1)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return sum(e - s for s, e in out)


@pytest.mark.parametrize("ops", [
    [("a", 0.0, 60.0), ("b", 10.0, 70.0), ("c", 80.0, 90.0)],
    [("a", -50.0, 150.0)],
    [("a", 5.0, 95.0), ("b", 90.0, 120.0), ("c", -10.0, 8.0)],
    [("k1", 0.0, 30.0), ("k2", 70.0, 100.0)],
])
def test_a_one_card_trace_reads_as_before(ops):
    fields = dict(kind="build", units=2, window=(0.0, 100.0),
                  device_ops=ops, calls=[], syncs=[2], sort_launches=6,
                  host_ops=[("aten::item", 25.0, 75.0),
                            ("cudaStreamSynchronize", 31.0, 69.0)])
    tr = Trace(**fields)
    busy = parent_busy(ops, (0.0, 100.0))
    assert tr.busy_us() == busy and tr.busy_us_per_card() == [busy]
    assert reader(LAYERS, "idle_share.build")(tr) == 100.0 * (
        1.0 - busy / 100.0)
    # the same trace read from a profile of one card
    prof = FakeProfile([event(trace.WINDOW, 0.0, 100.0, "DeviceType.CPU")]
                       + [event(n, s, e, "DeviceType.CUDA", 0)
                          for n, s, e in ops]
                       + [event(*h, "DeviceType.CPU")
                          for h in fields["host_ops"]])
    placed = trace.read_profile(prof, [torch.device("cuda", 0)],
                                **{k: fields[k] for k in (
                                    "kind", "units", "calls", "syncs",
                                    "sort_launches")})
    assert placed.device_cards == [0] * len(ops) and placed.cards == 1
    assert placed.busy_intervals(0) == tr.busy_intervals()
    assert placed.busy_us() == tr.busy_us()
    assert placed.breakdown() == tr.breakdown()
    assert phases.gaps(placed) == phases.gaps(tr)


def test_a_one_card_window_reads_as_before():
    window = run.Window("build", [(0.0, 1.0, 1000), (1.0, 2.5, 1000)], 0.0,
                        2.5, 3 * 2**29, 9.5)
    assert reader(METRICS, "peak_GiB")(window) == 1.5
    assert reader(METRICS, "build_Bps")(window) == 800.0
    assert reader(METRICS, "setup_s")(window) == 9.5


@pytest.fixture
def synced(monkeypatch):
    """torch.cuda.synchronize, recording each card it waits for and
    whether a profiler was running then."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(
        (d, torch.autograd._profiler_enabled())))
    return calls


def test_context_sync_waits_for_every_card(synced):
    cards = [torch.device("cuda", i) for i in range(4)]
    ctx = run.Context(None, {}, {}, 0, None, cards[0], cards)
    ctx.sync()
    assert [d for d, _ in synced] == cards
    # a mesh that repeats a card waits for it once; the CPU not at all
    run.Context(None, {}, {}, 0, None, cards[0], cards[:1] * 3).sync()
    cpu = torch.device("cpu")
    run.Context(None, {}, {}, 0, None, cpu, [cpu] * 4).sync()
    assert [d for d, _ in synced] == cards + cards[:1]


def test_profiled_waits_for_every_card_before_it_closes(synced):
    cards = [torch.device("cuda", i) for i in range(4)]
    out, prof = trace.profiled(lambda: 7, cards)
    assert out == 7
    assert synced == [(d, True) for d in cards]
    assert any(e.name == trace.WINDOW for e in prof.events())


def test_open_devices(monkeypatch):
    assert run.open_devices("cpu", 4) == [torch.device("cpu")] * 4
    names = ["NVIDIA H100 80GB HBM3"] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d: names[d.index])
    assert run.open_devices("cuda", 4) == [torch.device("cuda", i)
                                           for i in range(4)]
    assert run.open_devices("cuda", 1) == [torch.device("cuda", 0)]
    names[3] = "NVIDIA A100-SXM4-80GB"
    with pytest.raises(spec.SpecError, match="more than one kind"):
        run.open_devices("cuda", 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(spec.SpecError, match="4 CUDA card"):
        run.open_devices("cuda", 4)


def test_chips_default_to_one(tmp_path):
    shutil.copytree(os.path.join(ROOT, "sabench"), tmp_path / "sabench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    del bench["workloads"][0]["chips"]
    bench["workloads"][1]["chips"] = 0
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert spec.load_cell(str(tmp_path), "enwik9.build").chips == 1
    with pytest.raises(spec.SpecError, match="bad chips"):
        spec.load_cell(str(tmp_path), "fib41.build")
