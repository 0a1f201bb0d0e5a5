"""The judgment on the CPU at small sizes: sound runs come out correct,
and the control and each fault that a cell can have come out not correct.

The faults break the timed path underneath the harness (the program's own
functions), and the rest of the run is the benchmark's: set-up, window,
judgment. A fault of the exchange between chips cannot occur: every cell
runs on one card.
"""

import pytest
import torch

from sabench.control import Control
from sabench.program import Program
from sabench.run import run_workload

SMALL = {"enwik9.build": {"text_bytes": 1 << 15},
         "fib41.build": {"text_bytes": 28657}}
MIX = {"trace_units": 2, "warmup": 1}
BUILDS = ["enwik9.build", "fib41.build"]


@pytest.fixture
def run():
    def one(cell, seed=2**31 + 5, program=None, trace=False, seconds=0.2):
        return run_workload(cell, seed, seconds, trace, device="cpu",
                            program=program, config_overrides=SMALL[cell],
                            traffic_overrides=MIX)
    return one


def checks(result):
    return {k: c["value"] for k, c in result["checks"].items()}


@pytest.mark.parametrize("cell", BUILDS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_runs_are_correct(cell, trace, run):
    r = run(cell, trace=trace)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(v == 0 for v in checks(r).values())
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", BUILDS)
def test_control_fails_builds(cell, run):
    r = run(cell, program=Control(Program()))
    assert not r["correct"] and checks(r)["sa_bad_pairs"] > 0


@pytest.mark.parametrize("cell", BUILDS)
def test_state_left_unchanged_fails(cell, monkeypatch, run):
    from stringsearch_torch.engines import doubling

    # the doubling rounds hand back the initial sort's order unchanged
    monkeypatch.setattr(doubling, "_refine",
                        lambda sa_s0, *a, **k: (sa_s0, sa_s0))
    r = run(cell)
    assert not r["correct"] and checks(r)["sa_bad_pairs"] > 0


def _patch_build(monkeypatch, alter):
    from stringsearch_torch.engines import doubling

    build_sa = doubling.build_sa

    def broken(text, *a, **k):
        return alter(text, build_sa(text, *a, **k), build_sa)

    monkeypatch.setattr(doubling, "build_sa", broken)


@pytest.mark.parametrize("cell", BUILDS)
def test_half_the_text_left_out_fails(cell, monkeypatch, run):
    def half(text, sa, build_sa):
        h = text.numel() // 2
        rest = torch.arange(h, text.numel(), dtype=sa.dtype)
        return torch.cat([build_sa(text[:h]), rest])

    _patch_build(monkeypatch, half)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", BUILDS)
def test_answer_altered_fails(cell, monkeypatch, run):
    def swap(text, sa, build_sa):
        sa = sa.clone()
        sa[10], sa[11] = sa[11].item(), sa[10].item()
        return sa

    _patch_build(monkeypatch, swap)
    r = run(cell)
    assert not r["correct"] and checks(r)["sa_bad_pairs"] > 0


@pytest.mark.parametrize("cell", BUILDS)
def test_one_wrong_build_in_the_window_fails(cell, monkeypatch, run):
    calls = []

    def first_wrong(text, sa, build_sa):
        calls.append(1)
        if len(calls) == 2:  # the first build of the window
            sa = sa.clone()
            sa[3], sa[4] = sa[4].item(), sa[3].item()
        return sa

    _patch_build(monkeypatch, first_wrong)
    r = run(cell, seconds=5.0)  # more builds than one, on a loaded host too
    assert not r["correct"] and checks(r)["builds_differ"] == 1
    assert checks(r)["sa_bad_pairs"] == 0 and r["failed"] == 1


@pytest.mark.parametrize("cell,kind,check", [
    ("enwik9.build", "swap", "sa_bad_pairs"),
    ("fib41.build", "entry", "sa_not_perm"),
    ("enwik9.build", "alternate", "builds_differ"),
])
def test_planted_faults_fail_their_number(cell, kind, check, run):
    from sabench.control import Fault

    r = run(cell, program=Fault(kind, Program()), seconds=5.0)
    assert not r["correct"] and checks(r)[check] > 0
