"""Port of harness/cli.py against the JAX package's CLI.

Counterparts of tests/test_cli.py with `--device cpu`, the trace files of
`crosscheck --trace` byte for byte against the JAX CLI's on the same input
files (the global engine's too), and the refusal of a run without
`--device` on a machine with no GPU.
"""

import os

import numpy as np
import pytest
import torch

from stringsearch_torch.harness.cli import _traced_engine, main
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.utils.sizes import (
    format_size,
    format_throughput,
    parse_size,
)


@pytest.fixture()
def sample_file(tmp_path):
    rng = np.random.default_rng(4)
    p = tmp_path / "input.bin"
    p.write_bytes(bytes(rng.integers(0, 64, 3000, dtype=np.uint8)))
    return str(p)


def test_sizes_match_jax():
    from stringsearch_tpu.utils import sizes as jsizes

    for s in ("4096", "4k", "2m", "1g", "1.5k", " 7K "):
        assert parse_size(s) == jsizes.parse_size(s)
    assert parse_size("1.5k") == 1536
    with pytest.raises(ValueError):
        parse_size("")
    for n in (0, 512, 2048, 3 * 1024 * 1024, 5 * 1024**3, 7 * 1024**4,
              9 * 1024**5):
        assert format_size(n) == jsizes.format_size(n)
        assert format_throughput(n) == jsizes.format_throughput(n)
    assert format_size(512) == "512 B"


def test_cli_run(sample_file, capsys):
    assert main(["run", sample_file, "--verify", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Done in" in out and "verify: OK" in out


def test_cli_run_with_cap(sample_file, capsys):
    assert main(["run", sample_file, "1k", "--device", "cpu"]) == 0
    assert main(["run", sample_file, "--engine", "oracle", "--device",
                 "cpu"]) == 0


def test_cli_crosscheck_ok(sample_file, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(["crosscheck", sample_file, "--trace", "--device",
                 "cpu"]) == 0
    out = capsys.readouterr().out
    assert "crosscheck on" in out and "oracle: built + sufcheck OK" in out
    assert "doubling: verify OK, byte-exact match vs oracle" in out
    assert os.path.exists("crosscheck/doubling")
    assert os.path.exists("crosscheck/oracle")
    # both traces end with identical final-SA dumps
    tail_a = open("crosscheck/doubling").read().split(":: SA final")[-1]
    tail_b = open("crosscheck/oracle").read().split(":: SA final")[-1]
    assert tail_a == tail_b


def _input_files(tmp_path) -> dict:
    rng = np.random.default_rng(9)
    inputs = {
        "enwik": enwik_like(5000),
        "alpha2": bytes(rng.integers(0, 2, 3000, dtype=np.uint8)),
        "periodic": b"abcab" * 400,  # several rounds
    }
    paths = {}
    for name, data in inputs.items():
        path = tmp_path / f"{name}.bin"
        path.write_bytes(data)
        paths[name] = str(path)
    return paths


@pytest.mark.parametrize("name", ["enwik", "alpha2", "periodic"])
def test_crosscheck_trace_files_equal_the_jax_cli(name, tmp_path, capsys,
                                                  monkeypatch):
    """Every round's ranks and sorted order, not only the final SA: the
    two CLIs write byte-identical trace files and the same lines."""
    from stringsearch_tpu.harness.cli import main as jmain

    path = _input_files(tmp_path)[name]
    outs = {}
    for who, entry in (("torch", main), ("jax", jmain)):
        work = tmp_path / who
        work.mkdir()
        monkeypatch.chdir(work)
        assert entry(["crosscheck", path, "--trace", "--device", "cpu"]) == 0
        outs[who] = capsys.readouterr().out
    assert outs["torch"] == outs["jax"]
    for trace in ("oracle", "doubling"):
        got = (tmp_path / "torch" / "crosscheck" / trace).read_bytes()
        want = (tmp_path / "jax" / "crosscheck" / trace).read_bytes()
        assert got == want, trace
    assert got.count(b":: round -> h=") >= (2 if name == "periodic" else 0)


def test_cli_crosscheck_trace_all_engines(sample_file, capsys, tmp_path,
                                          monkeypatch):
    """`--trace` with the oracle beside the doubling engine: an engine with
    no traced build path runs untraced, with a warning. dc3 and bstar have
    one, as in the reference."""
    monkeypatch.chdir(tmp_path)
    assert main(["crosscheck", sample_file, "1k", "--trace", "--device",
                 "cpu", "--engines", "doubling,oracle"]) == 0
    captured = capsys.readouterr()
    assert "oracle: verify OK, byte-exact match vs oracle" in captured.out
    assert "'oracle' has no traced build path" in captured.err
    assert sorted(os.listdir("crosscheck")) == ["doubling", "oracle"]
    assert all(_traced_engine(e) is not None
               for e in ("doubling", "dc3", "bstar"))
    assert _traced_engine("oracle") is None
    assert main(["crosscheck", sample_file, "1k", "--device", "cpu",
                 "--engines", "dc3,bstar"]) == 0
    out = capsys.readouterr().out
    assert "dc3: verify OK, byte-exact match vs oracle" in out
    assert "bstar: verify OK, byte-exact match vs oracle" in out


def test_cli_bench_table(sample_file, capsys):
    assert main(["bench", sample_file, "2k", "--engines", "doubling,oracle",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Algorithm" in out and "Average speed" in out
    assert "doubling" in out and "oracle" in out


def test_cli_bench_skips_what_is_not_ported(sample_file, capsys):
    """Every engine of the registry is ported and benched; an unknown name
    is skipped."""
    assert main(["bench", sample_file, "2k", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert "skipping" not in captured.err
    rows = [line.split()[0] for line in captured.out.splitlines()[2:]]
    assert rows == ["doubling", "dc3", "bstar", "oracle"]
    assert main(["bench", sample_file, "2k", "--device", "cpu", "--engines",
                 "nope"]) == 0
    assert "skipping nope" in capsys.readouterr().err


def test_cli_queries(sample_file, capsys):
    assert main(["queries", sample_file, "--batch", "16,32", "--reps", "3",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("queries: batch=") == 2
    assert "p50=" in out and "p95=" in out and "needles/s" in out
    assert main(["queries", sample_file, "--batch", "x", "--device",
                 "cpu"]) == 2
    assert main(["queries", sample_file, "--batch", "0", "--device",
                 "cpu"]) == 2


def test_cli_refuses_global(sample_file, capsys, tmp_path, monkeypatch):
    """`crosscheck --engines global` was refused while the multi-device
    layer was not ported; it now builds the exact global SA (over the one
    CPU device under `--device cpu`), verifies it and matches the oracle,
    untraced and traced."""
    monkeypatch.chdir(tmp_path)
    assert main(["crosscheck", sample_file, "--device", "cpu", "--engines",
                 "doubling,global"]) == 0
    captured = capsys.readouterr()
    assert "global: verify OK, byte-exact match vs oracle" in captured.out
    assert "doubling: verify OK, byte-exact match vs oracle" in captured.out
    assert captured.err == "" and not os.path.exists("crosscheck")
    assert main(["crosscheck", sample_file, "--device", "cpu", "--engines",
                 "global", "--trace"]) == 0
    assert sorted(os.listdir("crosscheck")) == ["global", "oracle"]
    trace = open("crosscheck/global").read()
    assert trace.startswith(":: global engine n=3000 shards=1 ")
    assert trace.split(":: SA final")[-1] == \
        open("crosscheck/oracle").read().split(":: SA final")[-1]


@pytest.mark.parametrize("name", ["enwik", "alpha2", "periodic"])
def test_crosscheck_global_trace_equals_the_jax_cli(name, tmp_path, capsys,
                                                    monkeypatch):
    """The global engine's trace (every block's ranks) is byte-identical
    to the JAX CLI's on the same file, both over one device: the port's
    CLI under `--device cpu` builds on the one CPU device; the JAX CLI on
    every CPU device it sees, here held to the first."""
    import jax

    from stringsearch_tpu.harness.cli import main as jmain

    devices = jax.devices
    monkeypatch.setattr(jax, "devices",
                        lambda *a, **k: devices(*a, **k)[:1])
    path = _input_files(tmp_path)[name]
    outs = {}
    for who, entry in (("torch", main), ("jax", jmain)):
        work = tmp_path / who
        work.mkdir()
        monkeypatch.chdir(work)
        assert entry(["crosscheck", path, "--trace", "--device", "cpu",
                      "--engines", "doubling,global"]) == 0
        outs[who] = capsys.readouterr().out
    assert outs["torch"] == outs["jax"]
    for trace in ("oracle", "doubling", "global"):
        got = (tmp_path / "torch" / "crosscheck" / trace).read_bytes()
        want = (tmp_path / "jax" / "crosscheck" / trace).read_bytes()
        assert got == want, trace
    assert b":: block rounds=" in got or name == "enwik"


@pytest.mark.parametrize("argv", [["crosscheck"], ["run", "--verify"],
                                  ["bench"], ["queries"],
                                  ["run", "--device", "cuda"]])
def test_cli_without_a_card_returns_2(argv, sample_file, capsys, monkeypatch):
    """No `--device` means the GPU; with none present the CLI says so and
    returns 2. It never carries on on the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([argv[0], sample_file, *argv[1:]]) == 2
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and captured.out == ""
