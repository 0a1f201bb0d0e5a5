"""Port of core/search.py and core/compare.py against the JAX package and
the C++ oracle.

The JAX engine builds one SA; `SuffixArray.from_arrays` carries it into
the port, so both packages answer the same queries over the same index.
Answers are integers and compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stringsearch_tpu as jst
from stringsearch_torch import oracle
from stringsearch_torch.core import compare as tcmp
from stringsearch_torch.core import search as tsearch
from stringsearch_torch.core.types import SuffixArray
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_tpu.core import compare as jcmp
from stringsearch_tpu.core import search as jsearch

N = 1 << 13


@pytest.fixture(scope="module")
def indexes():
    text = np.frombuffer(enwik_like(N, seed=3), dtype=np.uint8)
    jsa = jst.build_suffix_array(text)
    sa_np = np.asarray(jsa.sa)
    port = SuffixArray.from_arrays(text, sa_np, device="cpu")
    return text, sa_np, jsa, port


def _needles(text: np.ndarray, count: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        m = int(rng.integers(1, 40))
        if i % 2 == 0:  # cut from the text, sometimes with a mutated tail
            s = int(rng.integers(0, len(text) - m))
            nd = bytearray(text[s : s + m].tobytes())
            if i % 4 == 0:
                nd[-1] = int(rng.integers(0, 256))
        else:
            nd = bytearray(rng.integers(97, 123, m, dtype=np.uint8).tobytes())
        out.append(bytes(nd))
    out[0] = b""
    out[1] = text[-5:].tobytes() + b"zz"  # runs off the end of the text
    return out


def test_from_arrays_carries_the_index(indexes):
    text, sa_np, _, port = indexes
    assert port.sa.dtype == torch.int32 and port.text.dtype == torch.uint8
    np.testing.assert_array_equal(port.sa.numpy(), sa_np)
    np.testing.assert_array_equal(sa_np, oracle.build(text))
    port.verify()


def test_from_arrays_copies_host_arrays():
    text = np.frombuffer(b"banana", dtype=np.uint8).copy()
    sa = oracle.build(text)
    port = SuffixArray.from_arrays(text, sa, device="cpu")
    text[:] = 0
    sa[:] = 0
    assert bytes(port.text.numpy()) == b"banana"
    assert port.sa.tolist() == [5, 3, 1, 0, 4, 2]


def test_lcs_matches_jax_and_oracle(indexes):
    text, sa_np, jsa, port = indexes
    needles = _needles(text, 64, 1)
    got = port.longest_substring_match_batch(needles)
    want = jsearch.longest_substring_match_batch(jsa, needles)
    assert [(g.start, g.len) for g in got] == [(w.start, w.len) for w in want]
    for nd, g in zip(needles, got):
        assert g.as_bytes() == nd[: g.len]
        if g.len:
            assert oracle.search(text, nd[: g.len], sa_np)[0] > 0
        if g.len < len(nd):
            assert oracle.search(text, nd[: g.len + 1], sa_np)[0] == 0


def test_sa_search_matches_jax_and_oracle(indexes):
    text, sa_np, jsa, port = indexes
    needles = _needles(text, 64, 2)
    got = tsearch.sa_search_batch(port, needles)
    want = jsearch.sa_search_batch(jsa, needles)
    assert got == want
    for nd, g in zip(needles[1:], got[1:]):
        assert g == oracle.search(text, nd, sa_np)
    assert port.search(b"the") == jsa.search(b"the")


def test_simplesearch_matches_jax_and_oracle(indexes):
    text, sa_np, jsa, port = indexes
    chars = np.arange(256, dtype=np.int32)
    count, left = tsearch.simplesearch_kernel(port.text, port.sa,
                                              torch.from_numpy(chars))
    jcount, jleft = jsearch.simplesearch_kernel(jsa.text, jsa.sa,
                                                jnp.asarray(chars))
    np.testing.assert_array_equal(count.numpy(), np.asarray(jcount))
    np.testing.assert_array_equal(left.numpy(), np.asarray(jleft))
    for c in (0, ord(" "), ord("e"), ord("["), 255):
        assert tsearch.sa_simplesearch(port, c) == oracle.simplesearch(
            text, c, sa_np)


def test_compare_primitives_match_jax(indexes):
    text = indexes[0]
    rng = np.random.default_rng(4)
    starts = rng.integers(-3, N + 3, 64).astype(np.int32)
    win = tcmp.gather_window(torch.from_numpy(text.copy()),
                             torch.from_numpy(starts), 16)
    jwin = jcmp.gather_window(jnp.asarray(text), jnp.asarray(starts), 16)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    other = np.roll(win.numpy(), 1, axis=0)
    for fn, jfn in [(tcmp.prefix_match_len, jcmp.prefix_match_len),
                    (tcmp.lex_less, jcmp.lex_less),
                    (tcmp.lex_cmp, jcmp.lex_cmp)]:
        got = fn(win, torch.from_numpy(other))
        want = jfn(jnp.asarray(np.asarray(jwin)), jnp.asarray(other))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype in (torch.int32, torch.bool)
    a = rng.integers(0, N, 32).astype(np.int32)
    b = rng.integers(0, N, 32).astype(np.int32)
    a[0], b[0] = 10, 10  # whole-suffix match: exercises the extension loop
    got = tcmp.common_prefix_len(text, a, b, max_len=8, device="cpu")
    want = jcmp.common_prefix_len(text, a, b, max_len=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tcmp.common_prefix_len(text, 3, 3, device="cpu")) == N - 3
