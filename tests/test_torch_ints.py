"""`engines/doubling.py:build_ints_with_isa` against the JAX function.

The SA and ISA of an integer sequence (dc3's tail solve, bstar's reduced
string): the same numpy sequences through both packages, the port on the
CPU, compared exactly (tolerance 0), with the initial sorted state beside
them. The generated sequences share one length, so the JAX side compiles
once per depth. The `cuda` test runs the kernel route and skips without a
card: `python -m pytest --noconftest -m cuda tests/test_torch_ints.py`
(this file imports jax only inside the tests that compare with it).
"""

import numpy as np
import pytest
import torch

from stringsearch_torch.engines import doubling
from stringsearch_torch.ops import radix_sort

N = 300


def _sequences() -> dict:
    rng = np.random.default_rng(31)
    return {
        "negative": rng.integers(-40, 40, N).astype(np.int32),
        "two values": rng.integers(-1, 1, N).astype(np.int32),
        "constant": np.full(N, -7, dtype=np.int32),
        "periodic": np.tile(np.array([3, -2, 3, 5], np.int32), N // 4),
        "wide range": rng.integers(-(1 << 30), 1 << 30, N).astype(np.int32),
    }


def _jax_build(seq, **kw):
    import jax.numpy as jnp

    from stringsearch_tpu.engines import doubling as jdoubling

    sa, isa = jdoubling.build_ints_with_isa(jnp.asarray(seq), **kw)
    return np.asarray(sa), np.asarray(isa)


def _naive_sa(seq: np.ndarray) -> np.ndarray:
    values = seq.tolist()
    return np.asarray(sorted(range(len(values)), key=lambda i: values[i:]),
                      dtype=np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6])
def test_build_ints_with_isa_matches_jax(depth):
    for name, seq in _sequences().items():
        sa, isa = doubling.build_ints_with_isa(seq, depth=depth,
                                               device="cpu")
        jsa, jisa = _jax_build(seq, depth=depth)
        assert sa.dtype == isa.dtype == torch.int32
        np.testing.assert_array_equal(sa.numpy(), jsa, name)
        np.testing.assert_array_equal(isa.numpy(), jisa, name)
        np.testing.assert_array_equal(sa.numpy(), _naive_sa(seq), name)


@pytest.mark.parametrize("n", [0, 1, 2])
def test_short_sequences_match_jax(n):
    seq = np.array([5, -3][:n], dtype=np.int32)
    sa, isa = doubling.build_ints_with_isa(seq, device="cpu")
    jsa, jisa = _jax_build(seq)
    assert sa.shape == isa.shape == (n,)
    np.testing.assert_array_equal(sa.numpy(), jsa)
    np.testing.assert_array_equal(isa.numpy(), jisa)


def test_initial_sorted_state_matches_jax():
    """The one sort of depth + 1 planes and its head-slot ranks."""
    import jax.numpy as jnp

    from stringsearch_tpu.engines import doubling as jdoubling

    seq = _sequences()["two values"]
    depth = 3
    t = torch.from_numpy(seq - seq.min())
    keys = (t,) + tuple(doubling._shift_ranks(t, h) for h in range(1, depth))
    out = doubling.device_sort(keys + (doubling._iota(N, "cpu"),), depth)
    got = doubling._ranks_sorted_only(out)
    js = jnp.asarray(seq) - jnp.min(jnp.asarray(seq))
    jkeys = (js,) + tuple(jdoubling._shift_ranks(js, jnp.int32(h))
                          for h in range(1, depth))
    jout = jdoubling.device_sort(jkeys + (jnp.arange(N, dtype=jnp.int32),),
                                 num_keys=depth)
    want = jdoubling._ranks_sorted_only(jout, jnp.int32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert int(got[2]) > 0


def test_tensor_input_stays_on_its_device_and_bad_args_raise():
    seq = torch.tensor([4, 1, 4, 1, 0], dtype=torch.int32)
    sa, isa = doubling.build_ints_with_isa(seq)
    assert sa.device == seq.device and sa.tolist() == [4, 3, 1, 2, 0]
    sa64, isa64 = doubling.build_ints_with_isa(seq, idx=torch.int64)
    assert sa64.dtype == isa64.dtype == torch.int64
    assert sa64.tolist() == sa.tolist() and isa64.tolist() == isa.tolist()
    with pytest.raises(ValueError):
        doubling.build_ints_with_isa(seq, depth=0)
    with pytest.raises(ValueError):
        doubling.build_ints_with_isa(seq, fan=1)
    with pytest.raises(TypeError):
        doubling.build_ints_with_isa(seq, idx=torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [4, 6])
def test_build_ints_with_isa_on_the_card(cuda, depth):
    """Depth 6 sorts seven planes: two launches of the kernel."""
    for name, seq in _sequences().items():
        want = doubling.build_ints_with_isa(seq, depth=depth, device="cpu")
        before = radix_sort.launches
        got = doubling.build_ints_with_isa(seq, depth=depth, device=cuda)
        assert radix_sort.launches > before
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and torch.equal(g.cpu(), w), name
