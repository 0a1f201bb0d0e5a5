"""Port of core/verify.py against the JAX verifier.

The same (text, SA) pairs, valid and corrupted, through both packages:
`verify_flags` must agree flag for flag, and `verify` must raise NotSorted
with the same (i, j). All cases share one length (one JAX compile).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stringsearch_tpu as jst
from stringsearch_torch import oracle
from stringsearch_torch.core import verify as tverify
from stringsearch_torch.core.types import NotSorted
from stringsearch_tpu.core import verify as jverify

N = 512


def _text() -> np.ndarray:
    rng = np.random.default_rng(17)
    return rng.integers(0, 3, N, dtype=np.uint8)


def _corruptions():
    """name -> corrupted copy of the true SA."""
    sa = oracle.build(_text())
    out = {"valid": sa.copy()}
    s = sa.copy(); s[100], s[101] = s[101], s[100]
    out["adjacent-swap"] = s
    s = sa.copy(); s[7], s[400] = s[400], s[7]
    out["far-swap"] = s
    s = sa.copy(); s[50] = s[51]
    out["duplicate"] = s
    s = sa.copy(); s[3] = N
    out["out-of-range"] = s
    s = sa.copy(); s[0] = -1
    out["negative"] = s
    out["reversed"] = sa[::-1].copy()
    return out


CASES = _corruptions()


@pytest.mark.parametrize("name", sorted(CASES))
def test_verify_flags_match_jax(name):
    text, sa = _text(), CASES[name]
    perm_ok, adj_ok = tverify.verify_flags(torch.from_numpy(text),
                                           torch.from_numpy(sa))
    jperm, jadj = jverify.verify_flags(jnp.asarray(text), jnp.asarray(sa))
    np.testing.assert_array_equal(perm_ok.numpy(), np.asarray(jperm))
    if np.asarray(jperm).all():  # adj flags are defined for permutations
        np.testing.assert_array_equal(adj_ok.numpy(), np.asarray(jadj))
    assert bool(tverify.is_valid(torch.from_numpy(text),
                                 torch.from_numpy(sa))) == bool(
        jverify.is_valid(jnp.asarray(text), jnp.asarray(sa)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_verify_raises_same_pair_as_jax(name):
    text, sa = _text(), CASES[name]
    try:
        jst.verify(text, sa)
        want = None
    except jst.NotSorted as e:
        want = (e.i, e.j)
    try:
        tverify.verify(text, sa, device="cpu")
        got = None
    except NotSorted as e:
        got = (e.i, e.j)
    assert got == want
    assert (want is None) == (name == "valid")


def test_verify_shape_and_empty():
    with pytest.raises(NotSorted):
        tverify.verify(b"abc", np.array([0, 1], dtype=np.int32), device="cpu")
    tverify.verify(b"", np.zeros(0, dtype=np.int32), device="cpu")
