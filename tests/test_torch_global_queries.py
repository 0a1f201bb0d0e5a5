"""Port of parallel/global_sa.py's queries against JAX and the oracle.

LCS, exact search and single-byte search on the exact global suffix array
at P = 2, 4 and 8 shards of `[cpu] * P`, in both text modes ("replicated":
a full copy of the padded text on every shard; "sharded": every probe's
windows through the distributed gather), with idx int32 and int64. The
counterparts of the query cases of tests/test_global_sa.py at each P are
held against the flat index and the C++ oracle; at P = 8 the answers are
also held against the JAX package's, on the port's own state and on the
JAX-built state carried over (tests/test_torch_global_sa.py,
`port_state_from_jax`). Starts, lengths, counts and slots are integers:
tolerance none.
"""

import numpy as np
import pytest
import torch

import stringsearch_torch as st
from stringsearch_torch import oracle
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.parallel import distsort, global_sa
from stringsearch_torch.parallel.global_sa import build_global
from stringsearch_torch.parallel.mesh import make_mesh

from tests.test_torch_global_sa import _jax_build, port_state_from_jax

CPU = torch.device("cpu")
SHARDS = [2, 4, 8]
MODES = ["replicated", "sharded"]
IDX = {"int32": torch.int32, "int64": torch.int64}


def _mesh(p):
    return make_mesh(devices=[CPU] * p)


def _oracle_search(text: bytes, needle: bytes):
    return oracle.search(text, needle, oracle.build(text))


@pytest.mark.parametrize("p", SHARDS)
def test_global_query_api(p):
    text = b"the quick brown fox jumps over the lazy dog; the fox again"
    g = build_global(text, _mesh(p))
    idx = g.to_suffix_array_index()
    idx.verify()
    m = idx.longest_substring_match(b"the fox jumps")
    assert text[m.start : m.start + m.len] == b"the fox jumps"[: m.len]
    assert m.len == len(b"the fox ")  # diverges at "again" in the text


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("idx", sorted(IDX))
def test_global_distributed_query(p, mode, idx):
    text = b"it is time, gentlemen; time to go home, time to sleep, time flies"
    g = build_global(text, _mesh(p), idx=IDX[idx])
    full = st.build_suffix_array(text, device="cpu")
    needles = [b"time to", b"gentle", b"sleep, time flies away", b"zzz",
               b"t", b"\x00weird", text[-7:] + b"overrun"]
    got = g.longest_substring_match_batch(needles, text_mode=mode)
    want = full.longest_substring_match_batch(needles)
    for nd, a, b in zip(needles, got, want):
        assert a.len == b.len, nd
        assert text[a.start : a.start + a.len] == nd[: a.len]
    single = g.longest_substring_match(b"time fl")
    assert single.as_bytes() == b"time fl"


@pytest.mark.parametrize("p", SHARDS)
def test_global_queries_build_nothing(p, monkeypatch):
    """Counterpart of the JAX test that the query executable is compiled
    once: here there is nothing to compile, and a query batch runs none of
    the build's sorts and leaves the built state as it was; repeated
    batches give the same answers."""
    text = b"caching the query path means tracing it exactly once" * 2
    g = build_global(text, _mesh(p))
    state = [t.clone() for t in g.rank + g._sa_sharded]
    calls = []
    for module in (global_sa, distsort):
        monkeypatch.setattr(module, "device_sort",
                            lambda *a, **k: calls.append(a))
    first = g.longest_substring_match_batch([b"query", b"trace"])
    again = g.longest_substring_match_batch([b"query", b"trace"])
    g.sa_search_batch([b"once!", b"again"], text_mode="sharded")
    assert calls == []
    assert [(m.start, m.len) for m in first] == \
        [(m.start, m.len) for m in again]
    for before, after in zip(state, g.rank + g._sa_sharded):
        assert torch.equal(before, after)


@pytest.mark.parametrize("p", SHARDS)
def test_global_query_sharded_text_mode(p):
    """The sharded text mode agrees with the replicated one exactly."""
    text = (b"the time traveller (for so it will be convenient to speak "
            b"of him) was expounding a recondite matter to us; time, time")
    g = build_global(text, _mesh(p))
    needles = [b"time tr", b"recondite matters", b"zzz-not-here", b"t",
               text[-9:] + b"\x00tail", b"e"]
    rep = g.longest_substring_match_batch(needles)
    shd = g.longest_substring_match_batch(needles, text_mode="sharded")
    for nd, a, b in zip(needles, rep, shd):
        assert (a.start, a.len) == (b.start, b.len), nd
        assert text[b.start : b.start + b.len] == nd[: b.len]


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_global_sa_search_matches_oracle(p, mode):
    """Distributed sa_search is slot-exact against the oracle's flat
    search: counts AND left slots agree."""
    text = enwik_like(3000, seed=21)
    g = build_global(text, _mesh(p))
    rng = np.random.default_rng(5)
    needles = [bytes(text[s : s + int(rng.integers(1, 24))])
               for s in rng.integers(0, len(text) - 24, 12)]
    needles += [b"zzzzzz-not-present", b"\x00", b"a", text[:1], b""]
    got = g.sa_search_batch(needles, text_mode=mode)
    for nd, (count, left) in zip(needles, got):
        if not nd:
            assert (count, left) == (len(text), 0)
            continue
        wc, wl = _oracle_search(text, nd)
        assert count == wc, (nd, count, wc)
        if count:
            assert left == wl, (nd, left, wl)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_global_sa_search_pad_and_nul_edges(p, mode):
    """Needles that could falsely extend into the zero pad, and NUL
    needles that must match real NULs but never pad bytes."""
    text = b"ab\x00\x00ab" * 9 + b"ab"  # length 56: pads at P = 8
    g = build_global(text, _mesh(p))
    for nd in (b"ab", b"ab\x00", b"\x00", b"\x00\x00", b"\x00\x00a", b"b"):
        wc, wl = _oracle_search(text, nd)
        got = g.sa_search(nd, text_mode=mode)
        assert got[0] == wc, (nd, got, (wc, wl))
        if got[0]:
            assert got[1] == wl, (nd, got, (wc, wl))


@pytest.mark.parametrize("p", SHARDS)
def test_global_sa_search_sharded_text_mode(p):
    text = enwik_like(2000, seed=31)
    g = build_global(text, _mesh(p))
    needles = [text[100:110], b"missing!", text[40:41]]
    rep = g.sa_search_batch(needles, text_mode="replicated")
    sh = g.sa_search_batch(needles, text_mode="sharded")
    assert rep == sh
    for nd, got in zip(needles, rep):
        assert got[0] == _oracle_search(text, nd)[0]


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_global_simplesearch(p, mode):
    text = enwik_like(1500, seed=41)
    g = build_global(text, _mesh(p))
    osa = oracle.build(text)
    for c in (ord("a"), ord(" "), 0, 255):
        count, left = g.sa_simplesearch(c, mode)
        wc, wl = oracle.simplesearch(text, c, osa)
        assert count == wc, (c, count, wc)
        if count:
            assert left == wl


def test_unknown_text_mode_is_refused():
    g = build_global(b"abcabc", _mesh(2))
    with pytest.raises(ValueError, match="text_mode"):
        g.longest_substring_match_batch([b"a"], text_mode="mirrored")
    with pytest.raises(ValueError, match="text_mode"):
        g.sa_search_batch([b"a"], text_mode="mirrored")
    assert g.longest_substring_match_batch([]) == []
    assert g.sa_search_batch([]) == []


QUERY_TEXT = enwik_like(2500, seed=51)
LCS_NEEDLES = [QUERY_TEXT[400:430], QUERY_TEXT[1200:1207] + b"\xff\xfe",
               b"zzzq", b"the ", QUERY_TEXT[-5:] + b"more", b"\x00x"]
SEARCH_NEEDLES = [QUERY_TEXT[100:104], QUERY_TEXT[900:912], b"e", b"qqqq",
                  b"\x00"]


@pytest.fixture(scope="module")
def jax_answers():
    """The JAX index at P = 8 and its answers in both text modes."""
    jg = _jax_build(QUERY_TEXT, 8)
    out = {"index": jg}
    for mode in MODES:
        out["lcs", mode] = [
            (m.start, m.len) for m in
            jg.longest_substring_match_batch(LCS_NEEDLES, text_mode=mode)]
        out["search", mode] = jg.sa_search_batch(SEARCH_NEEDLES,
                                                 text_mode=mode)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("state", ["port-built", "jax-built"])
def test_queries_equal_jax(mode, state, jax_answers):
    """LCS starts and lengths, search counts and slots equal the JAX
    package's, on the port's own build and on the JAX-built state."""
    g = (build_global(QUERY_TEXT, _mesh(8)) if state == "port-built"
         else port_state_from_jax(jax_answers["index"]))
    lcs = [(m.start, m.len) for m in
           g.longest_substring_match_batch(LCS_NEEDLES, text_mode=mode)]
    assert lcs == jax_answers["lcs", mode]
    assert g.sa_search_batch(SEARCH_NEEDLES, text_mode=mode) == \
        jax_answers["search", mode]


def test_int64_queries_equal_jax(jax_answers):
    """idx=int64 answers equal the JAX package's int32 ones (the SA is the
    same; only the index dtype changes)."""
    g = build_global(QUERY_TEXT, _mesh(8), idx=torch.int64)
    for mode in MODES:
        lcs = [(m.start, m.len) for m in
               g.longest_substring_match_batch(LCS_NEEDLES, text_mode=mode)]
        assert lcs == jax_answers["lcs", mode]
        assert g.sa_search_batch(SEARCH_NEEDLES, text_mode=mode) == \
            jax_answers["search", mode]
