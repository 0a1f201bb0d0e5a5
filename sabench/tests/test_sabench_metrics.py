import importlib.util
import os

import pytest
import torch

from sabench import peaks
from sabench.trace import Trace, short_name

LAYERS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "layers")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "layer_" + name.replace(".", "_"), os.path.join(LAYERS, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def trace(device_ops, window=(0.0, 100.0), kind="build", **kw):
    fields = dict(kind=kind, units=2, window=window, device_ops=device_ops,
                  host_ops=[], calls=[], syncs=[2], sort_launches=6)
    fields.update(kw)
    return Trace(**fields)


def test_idle_share_is_the_union_of_overlapping_intervals():
    # two streams overlap: summed time 120 us over a 100 us window
    ops = [("a", 0.0, 60.0), ("b", 10.0, 70.0), ("c", 80.0, 90.0)]
    tr = trace(ops)
    assert tr.busy_us() == pytest.approx(80.0)
    assert reader("idle_share.build")(tr) == pytest.approx(20.0)
    assert reader("idle_share.build")(trace(ops, kind="other")) is None


@pytest.mark.parametrize("ops", [
    [("a", -50.0, 150.0)],
    [("a", 0.0, 100.0), ("b", 0.0, 100.0), ("c", 20.0, 40.0)],
    [("a", 5.0, 95.0), ("b", 90.0, 120.0), ("c", -10.0, 8.0)],
])
def test_idle_share_never_reads_below_zero(ops):
    share = reader("idle_share.build")(trace(ops))
    assert 0.0 <= share <= 100.0


def test_breakdown_names_the_gaps_by_host_op():
    ops = [("k1", 0.0, 30.0), ("k2", 70.0, 100.0)]
    host = [("aten::item", 25.0, 75.0), ("cudaStreamSynchronize", 31.0, 69.0)]
    b = trace(ops, host_ops=host).breakdown()
    assert b["idle_gaps"] == [["aten::item > cudaStreamSynchronize",
                               pytest.approx(40e-6)]]
    assert [k for k, _ in b["device_ops"]] == ["k1", "k2"]


def test_roofline_bytes():
    n = 1 << 12
    i32 = torch.zeros(n, dtype=torch.int32)
    # a sort of C int32 planes: each read and written once, 8 C n
    for c in (2, 4, 5):
        assert peaks.sort_bytes([i32] * c) == 8 * c * n
    # the doubling engine's steps, on their plain versions
    from stringsearch_torch.ops import steps

    text = torch.randint(0, 256, (n,), dtype=torch.uint8)
    out = steps.pack_keys(text, 12)
    assert peaks.pack_keys_bytes(text, out) == 17 * n
    rank = torch.randint(0, n, (n,), dtype=torch.int32)
    shifted = steps.shift_planes(rank, [12, 24, 36])
    assert peaks.shift_planes_bytes(rank, shifted) == 20 * n
    for keys, per in ((4, 20), (3, 16)):
        planes = tuple(torch.sort(torch.randint(0, 9, (n,), dtype=torch.int32)
                                  ).values for _ in range(keys)) + (rank,)
        _, rank_s, _ = steps.head_ranks(planes)
        assert peaks.head_ranks_bytes(planes, rank_s) == per * n


def test_roofline_share_and_its_silence():
    calls = [("device_sort", 8 * 5 * (1 << 28)), ("pack_keys", 17 << 28)]
    ops = [("sort_pass_kernel<5>", 0.0, 64104.0),
           ("pack_keys_kernel<int>", 64104.0, 64104.0 + 1362.2),
           ("shard_pack_keys_kernel", 0.0, 1e6)]
    tr = trace(ops, window=(0.0, 2e6), calls=calls)
    # 10.74 GB at 3.35 TB/s is 3.2052 ms: 5% of 64.104 ms
    assert reader("sort_roofline")(tr) == pytest.approx(5.0, rel=1e-3)
    assert reader("steps_roofline")(tr) == pytest.approx(
        100 * (17 << 28) / 3.35e12 / 1362.2e-6, rel=1e-6)
    assert reader("sort_roofline")(trace([], calls=calls)) is None
    assert reader("steps_roofline")(trace(ops, calls=[])) is None


def test_counts_per_unit():
    tr = trace([("k", 0.0, 1.0)], kind="other", units=2)
    assert reader("sort_calls_per_build.build")(tr) is None
    assert reader("syncs_per_build.build")(tr) is None
    tb = trace([("k", 0.0, 1.0)], units=2)
    assert reader("sort_calls_per_build.build")(tb) == 3
    assert reader("syncs_per_build.build")(tb) == 2


def test_short_name():
    assert short_name("void sort_pass_kernel<5>(Planes, Planes, long)") == \
        "sort_pass_kernel<5>"
    assert short_name("void (anonymous namespace)::head_ranks_kernel<int>"
                      "(KeyPlanes, int)") == "head_ranks_kernel<int>"
