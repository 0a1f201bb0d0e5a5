"""Port of harness/fuzz.py against the JAX package's fuzzer.

The input generators are byte-identical for the same seed, so a seed or a
crash file found with one package replays on the other; the port's checks
run clean on the CPU and on every file of tests/corpus/; a planted failure
is reported, shrunk and replayed; what is not ported is refused.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from stringsearch_torch.harness import fuzz

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "corpus")
CASES = sorted(os.listdir(CORPUS_DIR))
ALL_TARGETS = "engines,partitioned,transforms"


@pytest.mark.parametrize("seed", range(10))
def test_generators_are_byte_identical_to_jax(seed):
    from stringsearch_tpu.harness import fuzz as jfuzz

    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    lens = fuzz._length_pool(rng, 2048)
    assert lens == jfuzz._length_pool(jrng, 2048)
    assert fuzz._FIXED_LENS == jfuzz._FIXED_LENS
    for _ in range(40):
        n = int(rng.choice(lens))
        assert n == int(jrng.choice(lens))
        data = fuzz._mutate(rng, n)
        assert data == jfuzz._mutate(jrng, n)
        assert len(data) == n
    a, b = fuzz._input_rng(data), jfuzz._input_rng(data)
    assert a.integers(0, 1 << 62) == b.integers(0, 1 << 62)


def test_fuzz_runner_clean(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc = fuzz.main(["--iters", "15", "--max-len", "300", "--seed", "42",
                    "--device", "cpu", "--targets", ALL_TARGETS])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "0 failures" in out
    assert ("targets=['engines', 'partitioned', 'transforms'] "
            "engines=['doubling'] seed=42 iters=15") in out
    assert not os.path.exists("fuzz-crashes")


def test_fuzz_default_target_is_engines(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert fuzz.main(["--iters", "25", "--max-len", "64", "--seed", "3",
                      "--device", "cpu", "--engines", "doubling,oracle"]) == 0
    out = capsys.readouterr().out
    assert "targets=['engines'] engines=['doubling', 'oracle']" in out
    assert "[25/25] ok so far, 0 failures" in out


def test_mutation_strategies_cover_patterns():
    rng = np.random.default_rng(1)
    seen = set()
    for _ in range(60):
        data = fuzz._mutate(rng, 256)
        assert 1 <= len(data) <= 256
        seen.add(len(set(data)) <= 4)  # low-alphabet strategies appear
    assert True in seen and False in seen


@pytest.mark.parametrize("name", CASES)
def test_corpus_replays_clean(name):
    with open(os.path.join(CORPUS_DIR, name), "rb") as f:
        data = f.read()
    assert fuzz._check(data, ["doubling"], set(fuzz.TARGETS), "cpu") is None


@pytest.fixture
def broken_engine(monkeypatch):
    """An engine that swaps two SA entries whenever the text holds the
    bytes "XY": the planted fault."""
    from stringsearch_torch import engines
    from stringsearch_torch.engines import doubling

    def sort(text, device=None):
        sa = doubling.sort(text, device)
        if b"XY" in bytes(text) and len(sa) >= 2:
            sa.sa[[0, 1]] = sa.sa[[1, 0]]
        return sa

    real = engines.get_engine
    monkeypatch.setattr(
        engines, "get_engine",
        lambda name: sort if name == "broken" else real(name))


def test_planted_failure_is_found_shrunk_and_replayed(
        broken_engine, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    data = bytes(range(97, 123)) * 3 + b"XY" + bytes(range(65, 88)) * 2
    err = fuzz._check(data, ["broken"], {"engines"}, "cpu")
    assert err is not None and err.startswith("broken:")
    assert fuzz._check(data, ["doubling"], {"engines"}, "cpu") is None
    shrunk = fuzz._shrink(data, ["broken"], {"engines"}, "cpu")
    assert b"XY" in shrunk and len(shrunk) <= 4
    assert fuzz._check(shrunk, ["broken"], {"engines"}, "cpu") is not None

    (tmp_path / "planted").write_bytes(data)
    argv = ["--replay", "planted", "--device", "cpu", "--engines"]
    assert fuzz.main(argv + ["broken"]) == 1
    assert "replay planted (126B): broken:" in capsys.readouterr().out
    assert fuzz.main(argv + ["doubling"]) == 0
    assert "no failure" in capsys.readouterr().out

    # a campaign writes the shrunken input under its sha1 and returns 1
    monkeypatch.setattr(fuzz, "_mutate", lambda rng, n: data)
    assert fuzz.main(["--iters", "2", "--seed", "0", "--device", "cpu",
                      "--engines", "broken", "--out", "found"]) == 1
    out = capsys.readouterr().out
    assert "FAILURE: broken:" in out and "done: 2 iterations, 2 failures" in out
    (crash,) = os.listdir("found")
    body = (tmp_path / "found" / crash).read_bytes()
    assert crash == "crash-" + hashlib.sha1(body).hexdigest()
    assert body == shrunk


@pytest.mark.parametrize("argv,word", [
    (["--idx64"], "idx=int64"),
    (["--targets", "engines,global"], "multi-device layer"),
    (["--targets", "engines,nothing"], "unknown targets"),
])
def test_fuzz_refuses_what_is_not_ported(argv, word, capsys):
    """`global` and unknown targets are refused; `--idx64`, refused until
    the int64 index mode was ported, now runs it."""
    if argv == ["--idx64"]:
        assert fuzz.main(["--iters", "3", "--seed", "4", "--device", "cpu",
                          *argv]) == 0
        captured = capsys.readouterr()
        assert "done: 3 iterations, 0 failures" in captured.out
        assert captured.err == ""
        return
    assert fuzz.main(["--iters", "1", "--device", "cpu", *argv]) == 2
    captured = capsys.readouterr()
    assert word in captured.err and captured.out == ""
    if word != "unknown targets":
        assert "ROADMAP.md" in captured.err


def test_fuzz_without_a_card_returns_2(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fuzz.main(["--iters", "1"]) == 2
    captured = capsys.readouterr()
    assert "no CUDA device" in captured.err and captured.out == ""
