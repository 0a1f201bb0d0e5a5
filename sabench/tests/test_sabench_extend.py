"""A later change adds a cell, a configuration, a mix and metrics as new
files and new entries: this lays a throwaway cell out in a copy of the
benchmark and runs it, with no file that was there edited."""

import hashlib
import json
import os
import shutil

from sabench.run import run_workload

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


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


def test_a_throwaway_cell_is_new_files_and_entries(tmp_path):
    shutil.copytree(os.path.join(ROOT, "sabench"), tmp_path / "sabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = digests(tmp_path / "sabench")
    base = tmp_path / "sabench"
    (base / "configs" / "tiny-text.json").write_text(json.dumps(
        {"name": "tiny-text", "generator": "tiny", "text_bytes": 4096,
         "reduced": {}}))
    (base / "generators" / "tiny.py").write_text(
        "import torch\n\n\n"
        "def make(config, seed, device):\n"
        "    g = torch.Generator(device=device).manual_seed(seed)\n"
        "    n = config['text_bytes']\n"
        "    return torch.randint(97, 100, (n,), generator=g,\n"
        "                         dtype=torch.uint8, device=device)\n")
    (base / "traffic" / "halves.json").write_text(json.dumps(
        {"kind": "half_builds", "trace_units": 2}))
    # a kind of its own: builds of the text's first half, each judged
    (base / "kinds" / "half_builds.py").write_text(
        "import time\n\n"
        "from sabench import reference\n\n\n"
        "class Job:\n"
        "    kind = 'half_builds'\n\n"
        "    def __init__(self, ctx):\n"
        "        self.ctx, self.half, self.out = ctx, ctx.text.numel() // 2, []\n\n"
        "    def unit(self):\n"
        "        t0 = time.perf_counter()\n"
        "        self.out.append(self.ctx.program.build(\n"
        "            self.ctx.text[:self.half]))\n"
        "        return t0, time.perf_counter(), self.half\n\n"
        "    def release(self):\n"
        "        self.ctx.program = None\n\n"
        "    def judge(self):\n"
        "        bad = sum(sum(reference.check_sa(\n"
        "            self.ctx.text[:self.half], sa).values()) > 0\n"
        "            for sa in self.out)\n"
        "        return len(self.out), bad, {'bad_builds': (bad, 0)}\n")
    (base / "metrics" / "build_p50_ms.py").write_text(
        "import numpy as np\n\n\n"
        "def read(window):\n"
        "    return float(np.median([b - a for a, b, _ in window.units]))"
        " * 1e3\n")
    (base / "layers" / "host_ops_per_build.py").write_text(
        "def read(trace):\n"
        "    return len(trace.host_ops) / trace.units\n")
    bench["configs"].append({"name": "tiny-text", "source": "a test",
                             "file": "sabench/configs/tiny-text.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-text.halves",
                               "config": "tiny-text", "traffic": "halves",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "build_p50_ms", "unit": "ms",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny-text.halves"]})
    bench["per_layer"].append({"name": "host_ops_per_build", "unit": "ops",
                               "better": "lower", "source": "device_trace",
                               "layer": "host", "moves": "build_p50_ms",
                               "workloads": ["tiny-text.halves"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    after = digests(tmp_path / "sabench")
    assert all(after[k] == v for k, v in before.items())
    assert len(after) == len(before) + 6

    r = run_workload("tiny-text.halves", 3, 0.2, False, root=str(tmp_path),
                     device="cpu")
    assert r["correct"] and r["checks"]["bad_builds"]["value"] == 0
    assert set(r["metrics"]) == {"build_p50_ms", "peak_GiB", "setup_s"}
    t = run_workload("tiny-text.halves", 3, 0.2, True, root=str(tmp_path),
                     device="cpu")
    assert t["correct"] and t["metrics"]["host_ops_per_build"]["value"] > 0
