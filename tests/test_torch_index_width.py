"""The int64 index mode of the doubling engine, against the JAX package.

The reference's tests/test_index_width.py, through both packages: with
`idx=int64` the SA and ISA are int64 and equal, value for value, the JAX
engine's under `jax.enable_x64()` and the int32 build's. Texts past 2^31
cannot be built here, so these pin the semantics. The `cuda` tests run the
kernel route, where an int64 plane is two int32 planes, and skip without a
card: `python -m pytest --noconftest -m cuda tests/test_torch_index_width.py`
(this file imports jax only inside the tests that compare with it).
"""

import numpy as np
import pytest
import torch

from stringsearch_torch.engines import bstar, doubling
from stringsearch_torch.harness.corpus import enwik_like, regression_corpus


def _naive_sa(data: bytes) -> np.ndarray:
    return np.asarray(sorted(range(len(data)), key=lambda i: data[i:]))


def _texts() -> dict:
    return {"enwik_like(2000, seed=11)": enwik_like(2000, seed=11),
            "period2": regression_corpus()["period2"]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(_texts()))
def test_i64_matches_i32(name):
    import jax
    import jax.numpy as jnp

    from stringsearch_tpu.engines.doubling import build_with_isa

    data = _texts()[name]
    text = np.frombuffer(data, dtype=np.uint8)
    sa64, isa64 = doubling.build_with_isa(text, idx=torch.int64,
                                          device="cpu")
    assert sa64.dtype == isa64.dtype == torch.int64
    with jax.enable_x64():
        jsa, jisa = build_with_isa(jnp.asarray(text), idx=jnp.int64)
        assert jsa.dtype == jnp.int64
        np.testing.assert_array_equal(sa64.numpy(), np.asarray(jsa))
        np.testing.assert_array_equal(isa64.numpy(), np.asarray(jisa))
    np.testing.assert_array_equal(sa64.numpy(), _naive_sa(data))
    sa32, isa32 = doubling.build_with_isa(text, device="cpu")
    assert torch.equal(sa64, sa32.to(torch.int64))
    assert torch.equal(isa64, isa32.to(torch.int64))


def test_i32_default_dtype():
    text = np.frombuffer(b"mississippi", dtype=np.uint8)
    sa, isa = doubling.build_with_isa(text, device="cpu")
    assert sa.dtype == isa.dtype == torch.int32
    np.testing.assert_array_equal(sa.numpy(), _naive_sa(b"mississippi"))


@pytest.mark.parametrize("kw", [
    dict(depth=4, levels=(2, 8, 64), fan=2, extract="sort"),
    dict(depth=4, levels=(2, 8, 64), fan=2, extract="topk"),
    dict(depth=8, chunk=500),
])
def test_i64_compaction_and_chunks_equal_i32(kw):
    """The compaction rounds (sentinel pads of the int64 range) and the
    chunked build take int64 as they take int32."""
    text = np.frombuffer(regression_corpus()["period3"] * 5, dtype=np.uint8)
    sa64, isa64 = doubling.build_with_isa(text, idx=torch.int64,
                                          device="cpu", **kw)
    sa32, isa32 = doubling.build_with_isa(text, device="cpu", **kw)
    assert sa64.dtype == torch.int64
    assert torch.equal(sa64, sa32.to(torch.int64))
    assert torch.equal(isa64, isa32.to(torch.int64))
    only = doubling.build_sa(text, idx=torch.int64, device="cpu", **kw)
    assert torch.equal(only, sa64)


def test_bstar_takes_int64():
    data = enwik_like(3000, seed=2)
    sa64, isa64 = bstar.build(data, idx=torch.int64, device="cpu")
    sa32, isa32 = bstar.build(data, device="cpu")
    assert sa64.dtype == isa64.dtype == torch.int64
    assert torch.equal(sa64, sa32.to(torch.int64))
    assert torch.equal(isa64, isa32.to(torch.int64))
    with pytest.raises(TypeError):
        bstar.build(data, idx=torch.int16, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [12, 24])
def test_i64_on_the_card(cuda, depth):
    data = enwik_like(1 << 16, seed=5)
    text = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
    sa64, isa64 = doubling.build_with_isa(text, idx=torch.int64, depth=depth,
                                          device=cuda)
    sa32, isa32 = doubling.build_with_isa(text, depth=depth, device=cuda)
    assert sa64.dtype == torch.int64 and sa64.device.type == "cuda"
    assert torch.equal(sa64, sa32.to(torch.int64))
    assert torch.equal(isa64, isa32.to(torch.int64))
    b64, _ = bstar.build(text, idx=torch.int64, device=cuda)
    assert torch.equal(b64, sa64)
