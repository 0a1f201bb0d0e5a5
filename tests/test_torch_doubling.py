"""Port of engines/doubling.py against the JAX engine and the C++ oracle.

Same numpy inputs through both packages; the port runs on the CPU, the JAX
engine as its own tests run it (CPU, `lax.sort`). All outputs are integers
and compared exactly (tolerance 0). Intermediate sorted states are compared
per tied group as sets: the order inside a group is one `torch.topk` may
change on CUDA, and nothing downstream depends on it.
To keep JAX compiles few, the generated cases share one length.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stringsearch_tpu as jst
import stringsearch_torch as tst
from stringsearch_torch import oracle
from stringsearch_torch.engines import doubling
from stringsearch_torch.harness.corpus import regression_corpus
from stringsearch_tpu.engines import doubling as jdoubling

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "corpus")
N_SHARED = 700  # one length for the generated cases: one JAX compile each


def _u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


def _ff_run_text() -> bytes:
    rng = np.random.default_rng(300)
    arr = rng.integers(0, 256, N_SHARED, dtype=np.uint8)
    arr[200:500] = 0xFF  # 300 bytes: initial keys of all-ones words
    return arr.tobytes()


def _shared_cases() -> dict:
    rng = np.random.default_rng(2024)
    cases = {f"alpha{a}": rng.integers(0, a, N_SHARED, dtype=np.uint8).tobytes()
             for a in (1, 2, 4, 16, 256)}
    cases["period2"] = b"ab" * (N_SHARED // 2)
    cases["ff-run-300"] = _ff_run_text()
    cases["ff-tail"] = b"ab" * 200 + b"\xff" * (N_SHARED - 400)
    return cases


def _corpus_cases() -> dict:
    cases = {f"reg:{k}": v for k, v in regression_corpus().items()}
    for name in sorted(os.listdir(CORPUS_DIR)):
        with open(os.path.join(CORPUS_DIR, name), "rb") as f:
            cases[f"file:{name}"] = f.read()
    return cases


CORPUS = _corpus_cases()
SHARED = _shared_cases()


def _biased_to_u32(key: torch.Tensor) -> np.ndarray:
    return (key.numpy() ^ np.int32(np.iinfo(np.int32).min)).view(np.uint32)


@pytest.mark.parametrize("depth", [4, 12])
def test_pack4_keys_match_jax(depth):
    text = _u8(SHARED["ff-run-300"])
    got = doubling._pack4_keys(torch.from_numpy(text.copy()), depth)
    want = jdoubling._pack4_keys(jnp.asarray(text), depth)
    assert len(got) == len(want) == depth // 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_biased_to_u32(g), np.asarray(w))
    # bias preserves order: signed order of the port == uint32 order
    k0 = got[0].numpy()
    np.testing.assert_array_equal(np.argsort(k0, kind="stable"),
                                  np.argsort(np.asarray(want[0]), kind="stable"))


@pytest.mark.parametrize("h", [0, 1, 5, 699, 700, 707, 2100])
def test_shift_ranks_match_jax(h):
    rank = np.random.default_rng(h).integers(-50, 50, N_SHARED, dtype=np.int32)
    got = doubling._shift_ranks(torch.from_numpy(rank), h)
    want = jdoubling._shift_ranks(jnp.asarray(rank), jnp.int32(h))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("density", [0.0, 0.1, 0.9, 1.0])
def test_segment_heads_equal_cummax(density):
    """The port's cumsum+scatter heads equal the reference's cummax."""
    import jax

    rng = np.random.default_rng(int(density * 10))
    flag = rng.random(N_SHARED) < density
    flag[0] = True
    j = np.arange(N_SHARED, dtype=np.int32)
    got = doubling._segment_heads(torch.from_numpy(flag), torch.from_numpy(j))
    want = jax.lax.cummax(jnp.where(jnp.asarray(flag), jnp.asarray(j), -1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ranks_sorted_only_match_jax():
    rng = np.random.default_rng(9)
    keys = [np.sort(rng.integers(0, 6, N_SHARED, dtype=np.int32)),
            rng.integers(-3, 3, N_SHARED, dtype=np.int32)]
    order = np.lexsort((keys[1], keys[0]))
    out = [k[order] for k in keys] + [order.astype(np.int32)]
    sa_s, rank_s, count = doubling._ranks_sorted_only(
        [torch.from_numpy(a) for a in out])
    jsa, jrank, jcount = jdoubling._ranks_sorted_only(
        tuple(jnp.asarray(a) for a in out), jnp.int32)
    np.testing.assert_array_equal(sa_s.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(rank_s.numpy(), np.asarray(jrank))
    assert int(count) == int(jcount)


def test_initial_full_and_full_round_match_jax():
    """The text-order variants the microbench's tiedcurve/extract modes
    drive: rank, sa_s, rank_s and count equal (the CPU sort is stable)."""
    text = _u8(SHARED["alpha4"])
    got = doubling._initial_full(torch.from_numpy(text.copy()), 4)
    want = jdoubling._initial_full(jnp.asarray(text), jnp.int32, 4)
    for step in range(2):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        got = doubling._full_round(got[0], 4 << step, fan=2)
        want = jdoubling._full_round(want[0], jnp.int32(4 << step),
                                     jnp.int32, 2)


def _groups(rank_s: np.ndarray, sa_s: np.ndarray) -> dict:
    """Tied group head -> set of members (the order-free view)."""
    groups: dict = {}
    for r, p in zip(rank_s.tolist(), sa_s.tolist()):
        groups.setdefault(r, set()).add(p)
    return groups


@pytest.mark.parametrize("method", ["topk", "sort"])
def test_initial_sort_and_extract_match_jax(method):
    """Intermediate state after a 4-byte initial sort, and the extraction
    into a compaction level: same ranks and counts, same group members."""
    text = _u8(SHARED["alpha4"])
    sa_s, rank_s, count = doubling._initial_sorted(
        torch.from_numpy(text.copy()), 4)
    jsa, jrank, jcount = jdoubling._initial_sorted(jnp.asarray(text),
                                                   jnp.int32, 4)
    assert int(count) == int(jcount) > 0
    np.testing.assert_array_equal(rank_s.numpy(), np.asarray(jrank))
    assert _groups(rank_s.numpy(), sa_s.numpy()) == _groups(
        np.asarray(jrank), np.asarray(jsa))
    m = int(count) + 16
    g, pos = doubling._extract(rank_s, sa_s, m, method=method)
    jg, jpos = jdoubling._extract(jrank, jsa, m, jnp.int32, method)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert _groups(g.numpy(), pos.numpy()) == _groups(np.asarray(jg),
                                                      np.asarray(jpos))


def _check_build(data: bytes):
    """Port build_sa and build_with_isa vs JAX build_with_isa and oracle."""
    text = _u8(data)
    want_sa = oracle.build(text)
    got_sa = doubling.build_sa(text, depth=12, device="cpu")
    got_sa2, got_isa = doubling.build_with_isa(text, depth=12, device="cpu")
    jsa, jisa = jdoubling.build_with_isa(jnp.asarray(text), depth=12)
    np.testing.assert_array_equal(np.asarray(jsa), want_sa)
    np.testing.assert_array_equal(got_sa.numpy(), want_sa)
    np.testing.assert_array_equal(got_sa2.numpy(), want_sa)
    np.testing.assert_array_equal(got_isa.numpy(), np.asarray(jisa))


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_build_matches_jax_and_oracle_corpus(name):
    data = CORPUS[name]
    if len(data) < 3:  # below the engine's host fast paths
        got = tst.build_suffix_array(data, device="cpu")
        want = jst.build_suffix_array(data)
        np.testing.assert_array_equal(got.sa.numpy(), np.asarray(want.sa))
        return
    _check_build(data)


@pytest.mark.parametrize("name", sorted(SHARED))
def test_build_matches_jax_and_oracle_generated(name):
    _check_build(SHARED[name])


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("extract", ["sort", "topk"])
def test_compaction_forced_matches_jax(extract, adaptive):
    """Shallow depth + tight levels force the compaction machinery on."""
    kw = dict(depth=4, levels=(2, 8, 64), fan=2, extract=extract,
              adaptive=adaptive)
    for name, data in SHARED.items():
        text = _u8(data)
        sa, isa = doubling.build_with_isa(text, device="cpu", **kw)
        jsa, jisa = jdoubling.build_with_isa(jnp.asarray(text), **kw)
        np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa), name)
        np.testing.assert_array_equal(isa.numpy(), np.asarray(jisa), name)
        np.testing.assert_array_equal(sa.numpy(), oracle.build(text), name)


def test_compaction_regression_corpus_vs_oracle():
    for name, data in CORPUS.items():
        if len(data) < 3:
            continue
        text = _u8(data)
        sa, isa = doubling.build_with_isa(text, depth=4, levels=(2, 8, 64),
                                          fan=2, device="cpu")
        np.testing.assert_array_equal(sa.numpy(), oracle.build(text), name)
        np.testing.assert_array_equal(isa.numpy()[sa.numpy()],
                                      np.arange(len(text)), name)


def test_build_sa_equals_build_with_isa_on_both_exits():
    for data in (SHARED["alpha256"], SHARED["alpha2"], SHARED["period2"]):
        text = _u8(data)
        sa_only = doubling.build_sa(text, depth=4, fan=2, levels=(2, 16),
                                    device="cpu")
        sa, isa = doubling.build_with_isa(text, depth=4, fan=2,
                                          levels=(2, 16), device="cpu")
        assert torch.equal(sa_only, sa)
        np.testing.assert_array_equal(isa.numpy()[sa.numpy()],
                                      np.arange(len(text)))


def test_short_inputs_and_sort_in_place():
    for data, want in [(b"", []), (b"x", [0]), (b"ab", [0, 1]),
                       (b"ba", [1, 0]), (b"aa", [1, 0])]:
        sa = tst.build_suffix_array(data, device="cpu")
        assert sa.sa.tolist() == want and sa.sa.dtype == torch.int32
        sa.verify()
    out = np.zeros(6, dtype=np.int32)
    doubling.sort_in_place(b"banana", out, device="cpu")
    assert out.tolist() == [5, 3, 1, 0, 4, 2]


def test_length_guard(monkeypatch):
    class FakeText:
        shape = (1 << 31,)

    monkeypatch.setattr(doubling, "as_text_tensor", lambda t, d=None: FakeText())
    with pytest.raises(ValueError, match="2\\^31"):
        doubling.sort(b"irrelevant")


def test_rejects_unported_modes_and_bad_args():
    """int64 indexes and the dc3 engine, refused until they were ported,
    now build; what no engine takes still raises."""
    text = _u8(b"banana split")
    sa64 = doubling.build_sa(text, idx=torch.int64, device="cpu")
    assert sa64.dtype == torch.int64
    assert torch.equal(sa64, doubling.build_sa(text, device="cpu").long())
    with pytest.raises(TypeError):
        doubling.build_sa(text, idx=torch.int16, device="cpu")
    with pytest.raises(ValueError):
        doubling.build_sa(text, depth=6, device="cpu")
    with pytest.raises(ValueError):
        doubling.build_with_isa(text, fan=1, device="cpu")
    with pytest.raises(TypeError):
        tst.build_suffix_array(np.zeros(4, dtype=np.int16), device="cpu")
    for name in ("dc3", "bstar"):
        sa = tst.get_engine(name)(b"banana split", device="cpu")
        np.testing.assert_array_equal(sa.sa.numpy(), oracle.build(text))
    with pytest.raises(KeyError):
        tst.get_engine("nope")


def test_oracle_engine_and_device_placement():
    data = SHARED["alpha16"]
    sa = tst.build_suffix_array(data, engine="oracle", device="cpu")
    assert sa.sa.device.type == "cpu" and sa.text.dtype == torch.uint8
    np.testing.assert_array_equal(
        sa.sa.numpy(), tst.build_suffix_array(data, device="cpu").sa.numpy())
    # a tensor stays on its own device when none is given
    t = torch.from_numpy(_u8(data).copy())
    assert tst.build_suffix_array(t).sa.device == t.device


def _trace_inputs() -> dict:
    rng = np.random.default_rng(55)
    return {
        "n0": b"", "n2": b"ba", "n3": b"aab",
        "n1000": rng.integers(0, 4, 1000, dtype=np.uint8).tobytes(),
        "periodic": b"abcab" * 200,  # needs several rounds
    }


@pytest.mark.parametrize("name", sorted(_trace_inputs()))
def test_sort_traced_trace_equals_jax(name, tmp_path):
    """Every round's head-slot ranks and sorted order (ties in position
    order), label for label: the two packages' traces are one text."""
    from stringsearch_torch.harness.tracing import PER_LINE, Tracer
    from stringsearch_tpu.harness import tracing as jtracing

    data = _trace_inputs()[name]
    with Tracer(str(tmp_path / "torch" / "doubling")) as tr:
        sa = doubling.sort_traced(data, tr, device="cpu")
    with jtracing.Tracer(str(tmp_path / "jax" / "doubling")) as jtr:
        jsa = jdoubling.sort_traced(data, jtr)
    got = (tmp_path / "torch" / "doubling").read_text()
    assert got == (tmp_path / "jax" / "doubling").read_text()
    np.testing.assert_array_equal(sa.sa.numpy(), np.asarray(jsa.sa))
    np.testing.assert_array_equal(sa.sa.numpy(), oracle.build(data))
    assert PER_LINE == jtracing.PER_LINE == 25
    assert got.startswith(f":: doubling engine n={len(data)}\n")
    if name == "periodic":
        assert got.count(":: round -> h=") >= 3
        assert "done=True" in got and "done=False" in got
    if len(data) >= 3:
        assert ":: rank h=8 (8-byte radix) len=" in got
        lines = got.split(":: SA final")[-1].splitlines()[1:]
        assert all(len(line.split()) == 25 for line in lines[:-1])


def test_tracer_dumps_tensors_and_arrays_alike(tmp_path):
    from stringsearch_torch.harness.tracing import Tracer

    values = np.arange(-3, 60, dtype=np.int32)
    with Tracer(str(tmp_path / "a")) as tr:
        tr.log("x")
        tr.dump("v", values)
    with Tracer(str(tmp_path / "b")) as tr:
        tr.log("x")
        tr.dump("v", torch.from_numpy(values))
    text = (tmp_path / "a").read_text()
    assert text == (tmp_path / "b").read_text()
    assert text.splitlines()[:2] == [":: x", ":: v len=63"]
    assert len(text.splitlines()) == 2 + 3
