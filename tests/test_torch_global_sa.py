"""Port of parallel/global_sa.py (the build and its verify) against JAX.

The exact global suffix array on P = 2, 4 and 8 shards of `[cpu] * P`.
Against the JAX package on its 8-device CPU mesh (tests/conftest.py), at a
few shared (text, P) shapes built once per module (each shard_map program
compiles once per shape and P): the SA, the ISA (`rank`), `rounds_run`,
`compact_rounds_run` and the traced `rank h=...` dumps byte for byte, and
the port's sharded verify on the JAX-built state. Every other case, the
counterparts of the build and verify cases of tests/test_global_sa.py at
each P, is held against the C++ oracle or the naive suffix array, which
compile nothing. Everything compared is an integer: tolerance none.
The query cases are in tests/test_torch_global_queries.py.
"""

import jax
import numpy as np
import pytest
import torch

import stringsearch_torch as st
from stringsearch_torch import oracle
from stringsearch_torch.harness.corpus import enwik_like, regression_corpus
from stringsearch_torch.harness.tracing import Tracer
from stringsearch_torch.parallel import collectives as coll
from stringsearch_torch.parallel import comm_model, distsort, global_sa
from stringsearch_torch.parallel.global_sa import (
    ROUNDS_PER_DISPATCH,
    GlobalSuffixArray,
    build_global,
)
from stringsearch_torch.parallel.mesh import make_mesh

from tests.conftest import naive_suffix_array

CPU = torch.device("cpu")
SHARDS = [2, 4, 8]


def _mesh(p):
    return make_mesh(devices=[CPU] * p)


def _shards(x: np.ndarray, p: int) -> list:
    return [torch.from_numpy(c.copy()) for c in np.split(np.asarray(x), p)]


def _cat(xs) -> np.ndarray:
    return torch.cat(list(xs)).numpy()


def port_state_from_jax(jg) -> GlobalSuffixArray:
    """The JAX GlobalSuffixArray's sharded state (text_padded, rank,
    _sa_sharded, fetched as numpy) as a port GlobalSuffixArray over
    `[cpu] * P`, without a build."""
    p = jg.num_shards
    g = object.__new__(GlobalSuffixArray)
    rank = np.asarray(jg.rank)
    g.mesh = _mesh(p)
    g.idx = torch.int64 if rank.dtype == np.int64 else torch.int32
    g.fan, g.compaction, g._tracer = jg.fan, jg.compaction, None
    g.n, g.num_shards, g.chunk_len = jg.n, p, jg.chunk_len
    g.depth, g.pad = jg.depth, jg.pad
    g.rounds_run, g.compact_rounds_run = jg.rounds_run, jg.compact_rounds_run
    g.text_padded = _shards(np.asarray(jg.text_padded), p)
    g.rank = _shards(rank, p)
    g._sa_sharded = _shards(np.asarray(jg._sa_sharded), p)
    g._sa_host = None
    return g


def _jax_build(text, p, **kw):
    from stringsearch_tpu.parallel.global_sa import build_global as jbuild
    from stringsearch_tpu.parallel.mesh import make_mesh as jmesh

    return jbuild(text, jmesh(p, 1, jax.devices("cpu")), **kw)


# (text, build options) of the JAX comparisons: text-like input, and a
# four-letter alphabet at depth 8 that reaches the compacted rounds at
# every P
JAX_CASES = {
    "enwik-4000": (enwik_like(4000, seed=2), {}),
    "alpha4-1000": (bytes(np.random.default_rng(3).integers(
        0, 4, 1000, dtype=np.uint8)), {"depth": 8, "fan": 3}),
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{(case, p): (JAX index, its trace text)}, each built once."""
    from stringsearch_tpu.harness.tracing import Tracer as JTracer

    out = {}
    work = tmp_path_factory.mktemp("jax-traces")
    for name, (text, kw) in JAX_CASES.items():
        for p in SHARDS:
            path = work / f"{name}-{p}"
            with JTracer(str(path)) as tr:
                jg = _jax_build(text, p, tracer=tr, **kw)
            out[name, p] = (jg, path.read_text())
    return out


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_build_equals_jax(case, p, jax_runs, tmp_path):
    """SA, ISA, round counts and every traced rank dump, byte for byte."""
    text, kw = JAX_CASES[case]
    jg, jtrace = jax_runs[case, p]
    with Tracer(str(tmp_path / "trace")) as tr:
        g = build_global(text, _mesh(p), tracer=tr, **kw)
    np.testing.assert_array_equal(g.suffix_array(), jg.suffix_array())
    np.testing.assert_array_equal(g.suffix_array(), oracle.build(text))
    np.testing.assert_array_equal(_cat(g.rank), np.asarray(jg.rank))
    assert (g.rounds_run, g.compact_rounds_run) == \
        (jg.rounds_run, jg.compact_rounds_run)
    assert (tmp_path / "trace").read_text() == jtrace
    assert jtrace.count(":: rank") >= 2


@pytest.mark.parametrize("p", SHARDS)
def test_jax_compaction_cases_compact_in_both(p, jax_runs):
    """The four-letter alphabet reaches the compacted rounds in JAX and in
    the port, at the same count."""
    jg, _ = jax_runs["alpha4-1000", p]
    text, kw = JAX_CASES["alpha4-1000"]
    g = build_global(text, _mesh(p), **kw)
    assert g.compact_rounds_run == jg.compact_rounds_run > 0


@pytest.mark.parametrize("p", SHARDS)
def test_verify_on_jax_built_state(p, jax_runs):
    """The port's sharded verify accepts the JAX-built state and rejects it
    with one rank corrupted, or two SA entries swapped."""
    g = port_state_from_jax(jax_runs["enwik-4000", p][0])
    g.verify()
    np.testing.assert_array_equal(g.suffix_array(),
                                  jax_runs["enwik-4000", p][0].suffix_array())
    good = g.rank[1]
    g.rank[1] = good.clone()
    g.rank[1][5] = g.rank[1][6]
    with pytest.raises(st.NotSorted, match="permutation"):
        g.verify()
    g.rank[1] = good
    sa = _cat(g._sa_sharded)
    sa[100], sa[200] = sa[200], sa[100]
    g._sa_sharded = _shards(sa, p)
    with pytest.raises(st.NotSorted, match="inverse"):
        g.verify()


def test_i64_equals_jax():
    """idx=int64: int64 state equal to the JAX package's x64 build."""
    import jax.numpy as jnp

    text = bytes(np.random.default_rng(42).integers(0, 16, 777,
                                                    dtype=np.uint8))
    with jax.enable_x64():
        jg = _jax_build(text, 8, idx=jnp.int64)
        jrank = np.asarray(jg.rank)
        jsa = jg.suffix_array()
    g = build_global(text, _mesh(8), idx=torch.int64)
    assert g.rank[0].dtype == torch.int64
    assert g.suffix_array().dtype == np.int64
    assert jrank.dtype == np.int64
    np.testing.assert_array_equal(_cat(g.rank), jrank)
    np.testing.assert_array_equal(g.suffix_array(), jsa)


@pytest.mark.parametrize("p", SHARDS)
def test_global_exact_small(p):
    text = b"banana band bandana ban bananas in pajamas"
    g = build_global(text, _mesh(p))
    np.testing.assert_array_equal(g.suffix_array(), naive_suffix_array(text))


@pytest.mark.parametrize("p", SHARDS)
def test_global_exact_vs_engine(p):
    text = enwik_like(3000, seed=3)
    g = build_global(text, _mesh(p))
    want = st.build_suffix_array(text, device="cpu").sa.numpy()
    np.testing.assert_array_equal(g.suffix_array(), want)
    np.testing.assert_array_equal(g.suffix_array(), oracle.build(text))


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("name", ["period2", "fibonacci", "sparse-alpha",
                                  "all-zero-64", "random-4k", "shruggy"])
def test_global_regression_corpus(p, name):
    text = regression_corpus()[name]
    g = build_global(text, _mesh(p))
    np.testing.assert_array_equal(g.suffix_array(), naive_suffix_array(text))


@pytest.mark.parametrize("p", SHARDS)
def test_global_sharded_verify_ok(p):
    for text in (enwik_like(5000, seed=9), b"banana" * 100,
                 regression_corpus()["fibonacci"]):
        build_global(text, _mesh(p)).verify()


@pytest.mark.parametrize("p", SHARDS)
def test_global_sharded_verify_catches_corruption(p):
    text = enwik_like(4000, seed=11)
    g = build_global(text, _mesh(p))
    g.verify()

    # swap two SA entries: the inverse check must trip
    good_sa = g._sa_sharded
    sa = _cat(good_sa)
    sa[100], sa[200] = sa[200], sa[100]
    g._sa_sharded = _shards(sa, p)
    with pytest.raises(st.NotSorted):
        g.verify()
    g._sa_sharded = good_sa

    # rank into a non-permutation
    rank = _cat(g.rank)
    rank[5] = rank[6]
    g.rank = _shards(rank, p)
    with pytest.raises(st.NotSorted, match="permutation"):
        g.verify()

    # a consistent swap of BOTH rank and sa (still a permutation and a
    # consistent inverse, but not suffix order): adjacency must trip
    g2 = build_global(text, _mesh(p))
    rank = _cat(g2.rank)
    sa = _cat(g2._sa_sharded)
    a, b = int(sa[300]), int(sa[301])
    rank[a], rank[b] = rank[b], rank[a]
    sa[300], sa[301] = sa[301], sa[300]
    g2.rank = _shards(rank, p)
    g2._sa_sharded = _shards(sa, p)
    with pytest.raises(st.NotSorted, match="adjacent-order"):
        g2.verify()


@pytest.mark.parametrize("p", SHARDS)
def test_global_non_divisible_lengths(p):
    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 5, 17, 101, 1003):
        text = bytes(rng.integers(0, 8, n, dtype=np.uint8))
        g = build_global(text, _mesh(p))
        np.testing.assert_array_equal(
            g.suffix_array(), naive_suffix_array(text), err_msg=f"n={n}")


@pytest.mark.parametrize("p", SHARDS)
def test_global_i64_index_mode(p):
    """idx=torch.int64: int64 output equal to the int32 build."""
    text = bytes(np.random.default_rng(42).integers(0, 16, 777,
                                                    dtype=np.uint8))
    want = build_global(text, _mesh(p)).suffix_array()
    g64 = build_global(text, _mesh(p), idx=torch.int64)
    got = g64.suffix_array()
    assert got.dtype == np.int64
    assert all(r.dtype == torch.int64 for r in g64.rank + g64._sa_sharded)
    np.testing.assert_array_equal(got, want.astype(np.int64))
    g64.verify()


@pytest.mark.parametrize("p", SHARDS)
def test_global_rounds_are_batched(p):
    """Deep initial keys and blocked rounds: text-like input resolves in at
    most one block of rounds."""
    g = build_global(enwik_like(4096), _mesh(p))
    assert g.rounds_run <= ROUNDS_PER_DISPATCH, g.rounds_run


@pytest.mark.parametrize("p", SHARDS)
def test_global_distributed_compaction(p):
    """Adversarial inputs go through the compacted rounds and still give
    THE suffix array; compaction=False pins the full-width path. The three
    inputs of the JAX test compact only at P = 8; the four-letter alphabet
    compacts at every P, in JAX as here."""
    rng = np.random.default_rng(11)
    cases = [
        bytes(rng.integers(0, 2, 700, dtype=np.uint8)),
        (b"xyxz" * 200)[:777],
        bytes(rng.integers(0, 256, 900, dtype=np.uint8)),
        JAX_CASES["alpha4-1000"][0],
    ]
    compacted_somewhere = False
    for text in cases:
        g = build_global(text, _mesh(p), depth=8, fan=3)
        want = naive_suffix_array(text)
        np.testing.assert_array_equal(g.suffix_array(), want)
        g.verify()
        g2 = build_global(text, _mesh(p), depth=8, fan=3, compaction=False)
        np.testing.assert_array_equal(g2.suffix_array(), want)
        assert g2.compact_rounds_run == 0
        compacted_somewhere |= g.compact_rounds_run > 0
    assert compacted_somewhere, "no case exercised the compacted rounds"


@pytest.mark.parametrize("p", SHARDS)
def test_global_compaction_giant_group_falls_back(p):
    """A single giant tie group (all-equal text) overflows every fast
    path's capacity: the rounds take the merge-split fallback, and the SA
    is still exact."""
    text = bytes([9]) * 513
    distsort.fallbacks.clear()
    g = build_global(text, _mesh(p), depth=4, fan=2)
    np.testing.assert_array_equal(g.suffix_array(), naive_suffix_array(text))
    g.verify()
    if p > 2:
        assert distsort.fallbacks["rank_interval"] > 0


@pytest.mark.parametrize("p", SHARDS)
def test_comm_report_equals_the_bytes_moved(p):
    """comm_report() equals global_build_comm and, on a text whose every
    dispatched round runs (a 700-byte repeat: tied until depth 432, the
    fourth round's), the bytes each shard's collectives moved."""
    rng = np.random.default_rng(1)
    text = bytearray(rng.integers(0, 256, 4000, dtype=np.uint8))
    text[2000:2700] = text[200:900]
    coll.reset_traffic()
    distsort.fallbacks.clear()
    g = build_global(bytes(text), _mesh(p))
    assert not distsort.fallbacks
    assert g.rounds_run == g.rounds_executed == 4
    rep = g.comm_report()
    assert rep == comm_model.global_build_comm(g.n, p, depth=g.depth,
                                               fan=g.fan, rounds=g.rounds_run)
    assert max(coll.bulk_bytes_per_shard(p)) == rep.total_bytes


@pytest.mark.parametrize("p", SHARDS)
def test_bytes_moved_follow_the_rounds_that_ran(p):
    """Where the build resolves before its block ends, or compacts, what
    the collectives moved is the model's count for the rounds that ran."""
    for text in (enwik_like(4000, seed=2), b"ab" * 100 + enwik_like(3000)):
        coll.reset_traffic()
        distsort.fallbacks.clear()
        global_sa.compact_fallbacks = 0
        g = build_global(text, _mesh(p))
        if distsort.fallbacks or global_sa.compact_fallbacks:
            continue
        want = comm_model.global_build_comm(
            g.n, p, depth=g.depth, fan=g.fan,
            rounds=g.rounds_executed).total_bytes
        want += g.compact_rounds_executed * \
            comm_model.compact_round_bytes_per_device(p, g.chunk_len, g.fan)
        assert max(coll.bulk_bytes_per_shard(p)) == want


def test_build_rejects_bad_arguments():
    mesh = _mesh(2)
    with pytest.raises(ValueError, match="multiple of 4"):
        build_global(b"abc", mesh, depth=6)
    with pytest.raises(ValueError, match="fan"):
        build_global(b"abc", mesh, fan=1)
    with pytest.raises(TypeError, match="idx"):
        build_global(b"abc", mesh, idx=torch.int16)

    class NoParts:
        shape = {"batch": 1}

    with pytest.raises(ValueError, match="parts"):
        build_global(b"abc", NoParts())
