"""BENCHMARK.json against the rules of the benchmark contract, and every file
it names."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(bench):
    assert set(bench) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(line(w) for w in bench["command"])
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
    metric_names = [e["name"] for e in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["why"]) and line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metrics_and_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def reported(bench, cell):
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    layer = {m["name"] for m in bench["per_layer"]
             if cell in m.get("workloads", [cell] if m["moves"] in e2e
                              else [])}
    return e2e, layer


def test_every_cell_reports_what_it_must(bench):
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    assert configs == {w["config"] for w in bench["workloads"]}
    for cell in cells:
        e2e, layer = reported(bench, cell)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells
    # a layer metric's `moves` is reported in each cell that reads it
    for m in bench["per_layer"]:
        for cell in m.get("workloads", []):
            assert m["moves"] in reported(bench, cell)[0], (m["name"], cell)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_named_file_exists(bench):
    base = os.path.join(ROOT, "sabench")
    for c in bench["configs"]:
        assert c["file"].startswith("sabench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg) and set(c["reduced"]) <= set(
            cfg.get("reduced", {}))
        assert os.path.isfile(os.path.join(base, "generators",
                                           cfg["generator"] + ".py"))
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for w in bench["workloads"]:
        with open(os.path.join(base, "traffic", w["traffic"] + ".json")) as f:
            mix = json.load(f)
        assert os.path.isfile(os.path.join(base, "kinds", mix["kind"] + ".py"))
    for m in bench["end_to_end"]:
        assert os.path.isfile(os.path.join(base, "metrics", m["name"] + ".py"))
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(base, "layers", m["name"] + ".py"))


def test_files_under_paths_are_named_from_name_characters(bench):
    for p in bench["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in filenames:
                if fn.endswith(".pyc"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), ROOT)
                assert PATH.match(rel), rel
