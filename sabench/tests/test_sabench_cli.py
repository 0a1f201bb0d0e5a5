"""`python -m sabench` on a machine without a card: no result, exit code
not 0."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARGS = ["--workload", "enwik9.build", "--seed", "4294967311",
        "--seconds", "1", "--trace", "0"]


def run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "sabench", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_no_card_no_result():
    out = run(ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "sabench"), tmp_path / "sabench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_without_the_program_no_result(tmp_path, monkeypatch):
    """With the card check passed, a checkout without stringsearch_torch
    exits 2 and prints nothing."""
    from sabench import run as sabench_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setitem(sys.modules, "stringsearch_torch", None)
    assert sabench_run.main(ARGS) == 2


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "sabench", *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
