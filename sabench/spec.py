"""Find the pieces of a cell by name: `BENCHMARK.json` and the files under
`sabench/` that it names.

Everything is looked up under a root directory (the checkout), so a test
can lay out a cell of its own in a temporary directory and run it with
the same code.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from types import ModuleType

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class SpecError(Exception):
    """`BENCHMARK.json` or a file it names is missing or malformed."""


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise SpecError(f"bad {what} name {name!r}")
    return name


def load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise SpecError(f"cannot read {path}: {e}") from e


def load_module(path: str) -> ModuleType:
    """Import the Python file at `path` under a name of its own."""
    if not os.path.isfile(path):
        raise SpecError(f"no file {path}")
    name = "sabench_piece_" + re.sub(r"\W", "_", os.path.relpath(path))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType


@dataclasses.dataclass
class Cell:
    """One workload of `BENCHMARK.json` with every piece it names."""

    name: str
    config: dict
    traffic: dict
    generator: ModuleType
    kind: ModuleType
    end_to_end: list
    per_layer: list


def _cell_metrics(entries: list, cell: str, e2e_of_cell=None) -> list:
    """The metric entries that `cell` reports: those that list it, or,
    without a `workloads` key, every cell (per-layer: every cell that
    reports the end-to-end metric it moves)."""
    out = []
    for entry in entries:
        if "workloads" in entry:
            if cell in entry["workloads"]:
                out.append(entry)
        elif e2e_of_cell is None or entry.get("moves") in e2e_of_cell:
            out.append(entry)
    return out


def load_cell(root: str, workload: str) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench.get("workloads", [])}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(have: {', '.join(cells)})")
    w = cells[workload]
    base = os.path.join(root, "sabench")
    config = load_json(os.path.join(
        base, "configs", check_name(w["config"], "config") + ".json"))
    traffic = load_json(os.path.join(
        base, "traffic", check_name(w["traffic"], "traffic") + ".json"))
    generator = load_module(os.path.join(
        base, "generators",
        check_name(config["generator"], "generator") + ".py"))
    kind = load_module(os.path.join(
        base, "kinds", check_name(traffic["kind"], "kind") + ".py"))

    def metrics(entries, folder):
        return [Metric(e["name"], e["unit"], load_module(os.path.join(
            base, folder, check_name(e["name"], "metric") + ".py")))
            for e in entries]

    e2e = _cell_metrics(bench.get("end_to_end", []), workload)
    layers = _cell_metrics(bench.get("per_layer", []), workload,
                           {e["name"] for e in e2e})
    return Cell(workload, config, traffic, generator, kind,
                metrics(e2e, "metrics"), metrics(layers, "layers"))
