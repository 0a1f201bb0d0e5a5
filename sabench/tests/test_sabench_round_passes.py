"""`layers/round_passes_per_build.build.py` on synthetic spans, each value
worked out by hand, silent where the rounds carry no reckoning, and on a
traced run of each one-card cell on the CPU at a few KiB."""

import pytest

from sabench.tests.test_sabench_span_layers import layer, trace, tree

NAME = "round_passes_per_build.build"


def rounds(*passes):
    """Two builds: the first with a round of each of `passes`, the second
    with none."""
    items = [("doubling.build", None, {}, None),
             ("doubling.initial", 0, {"tied": 90, "groups": 12}, None)]
    items += [("doubling.round", 0,
               {"n": 100, "tied_in": 90, "groups": 12, "keys": "dense",
                "live_passes": p}, None) for p in passes]
    items += [("doubling.build", None, {}, None)]
    return tree(*items)


@pytest.mark.parametrize("passes,want", [((4, 4, 8), 8.0), ((16,), 8.0),
                                         ((), 0.0)])
def test_round_passes_per_build(passes, want):
    # the rounds' live passes over the two builds
    assert layer(NAME).value(trace(), rounds(*passes)) == pytest.approx(want)


def test_round_passes_are_silent_without_a_reckoning():
    value = layer(NAME).value
    unreckoned = tree(("doubling.build", None, {}, None),
                      ("doubling.round", 0, {"n": 100, "tied_in": 90},
                       None))
    assert value(trace(), unreckoned) is None
    assert value(trace(kind="other"), rounds(4)) is None
    assert value(trace(), []) is None
    assert layer(NAME).read(trace([("a", 0.0, 80.0)])) is None


@pytest.mark.parametrize("cell,size", [("enwik9.build", 1 << 15),
                                       ("fib41.build", 28657)])
def test_a_traced_cpu_run_reads_the_round_passes(cell, size):
    from sabench.run import run_workload

    r = run_workload(cell, 2**31 + 7, 0.2, True, device="cpu",
                     config_overrides={"text_bytes": size},
                     traffic_overrides={"trace_units": 2, "warmup": 1})
    assert r["correct"]
    got = r["metrics"][NAME]["value"]
    # the Fibonacci word runs full rounds, each at least one pass; the
    # enwik-class text at this size resolves without one
    assert got > 0 if cell == "fib41.build" else got >= 0
