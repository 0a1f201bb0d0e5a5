"""Port of transforms/bwt.py against the JAX package and both oracles.

The same bytes go through `stringsearch_torch.transforms.bwt` on the CPU
and `stringsearch_tpu.transforms.bwt`; every value is a byte or an index
and compared exactly (tolerance 0). Counterparts of the six tests of
tests/test_bwt.py are among them. The `cuda`-marked twins run the same
cases on the card, with every sort through the hand-written radix sort; run
them with `python -m pytest --noconftest -m cuda tests/test_torch_bwt.py`
(this file imports jax only inside the tests that compare with it).
"""

import importlib

import numpy as np
import pytest
import torch

from stringsearch_torch import oracle
from stringsearch_torch.harness.corpus import regression_corpus
from stringsearch_torch.ops import bitonic, radix_sort
from stringsearch_torch.transforms import bwt, bwt_from_sa, divbwt, unbwt
from stringsearch_torch.transforms.bwt import _divbwt_fused, _unbwt_kernel

N_SHARED = 600  # one length for the generated cases: one JAX compile each


def _cases() -> dict:
    rng = np.random.default_rng(31)
    cases = dict(regression_corpus())
    cases.update({
        "empty": b"", "one": b"z", "two": b"ab", "two-equal": b"aa",
        "banana": b"banana",
        "random": rng.integers(0, 256, N_SHARED, dtype=np.uint8).tobytes(),
        "alpha2": rng.integers(0, 2, N_SHARED, dtype=np.uint8).tobytes(),
        "periodic": b"abc" * (N_SHARED // 3),
        "zeros": bytes(N_SHARED),
    })
    return cases


CASES = _cases()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _jax_bwt():
    # the package's attribute `bwt` is the function, not the module
    return importlib.import_module("stringsearch_tpu.transforms.bwt")


def _check_against_oracle(data: bytes, device) -> None:
    u, pidx = divbwt(data, device=device)
    assert (u, pidx) == oracle.bwt(data)
    assert unbwt(u, pidx, device=device) == data
    assert oracle.unbwt(u, pidx) == data


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwt_matches_jax_and_oracles(name):
    """bwt and unbwt of the port, the JAX package, the port's oracle and
    the JAX package's oracle agree, both ways."""
    from stringsearch_tpu import oracle as joracle

    data = CASES[name]
    _check_against_oracle(data, "cpu")
    u, pidx = divbwt(data, device="cpu")
    assert (u, pidx) == _jax_bwt().divbwt(data)
    assert (u, pidx) == joracle.bwt(data)
    assert unbwt(u, pidx, device="cpu") == _jax_bwt().unbwt(u, pidx)


def test_bwt_matches_oracle():
    for name, data in regression_corpus().items():
        if not data:
            continue
        assert divbwt(data, device="cpu") == oracle.bwt(data), name


def test_roundtrip_both_ways():
    for name, data in regression_corpus().items():
        u, pidx = divbwt(data, device="cpu")
        assert unbwt(u, pidx, device="cpu") == data, name


def test_cross_roundtrip():
    """The port forward and the oracle inverse, and the other way round:
    the conventions agree."""
    rng = np.random.default_rng(2)
    data = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    u_t, pidx_t = divbwt(data, device="cpu")
    assert oracle.unbwt(u_t, pidx_t) == data
    u_c, pidx_c = oracle.bwt(data)
    assert unbwt(u_c, pidx_c, device="cpu") == data


def test_banana():
    assert divbwt(b"banana", device="cpu") == (b"annbaa", 3)


def test_empty_and_single():
    assert divbwt(b"", device="cpu") == (b"", 0)
    assert unbwt(b"", 0, device="cpu") == b""
    u, pidx = divbwt(b"z", device="cpu")
    assert unbwt(u, pidx, device="cpu") == b"z"
    with pytest.raises(ValueError):
        unbwt(b"abc", 3, device="cpu")


def test_divbwt_fused_matches_two_step():
    """`_divbwt_fused` equals SA-then-`bwt_from_sa`, the JAX package's
    fused program and the host oracle."""
    import jax.numpy as jnp

    from stringsearch_torch.engines.doubling import sort as dsort

    data = (b"the quick brown fox " * 40) + bytes(range(256))
    arr = np.frombuffer(data, dtype=np.uint8)
    u_f, pidx_f = _divbwt_fused(torch.from_numpy(arr.copy()), 12)
    sa = dsort(data, device="cpu")
    u_2, pidx_2 = bwt_from_sa(sa.text, sa.sa)
    assert pidx_f == pidx_2 and torch.equal(u_f, u_2)
    u_j, pidx_j = _jax_bwt()._divbwt_fused(jnp.asarray(arr), 12)
    assert pidx_f == int(pidx_j)
    np.testing.assert_array_equal(u_f.numpy(), np.asarray(u_j))
    assert (u_f.numpy().tobytes(), pidx_f) == oracle.bwt(data)


@pytest.mark.parametrize("name", ["random", "alpha2", "periodic", "banana"])
def test_bwt_from_sa_and_unbwt_kernel_match_jax(name):
    """The two device functions on the same arrays as the JAX functions."""
    import jax.numpy as jnp

    data = CASES[name]
    text = np.frombuffer(data, dtype=np.uint8)
    sa = oracle.build(data)
    u, pidx = bwt_from_sa(torch.from_numpy(text.copy()), torch.from_numpy(sa))
    ju, jpidx = _jax_bwt().bwt_from_sa(jnp.asarray(text), jnp.asarray(sa))
    assert pidx == int(jpidx)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    rounds = len(data).bit_length()
    back = _unbwt_kernel(u, pidx, rounds)
    jback = _jax_bwt()._unbwt_kernel(ju, jnp.int32(pidx), rounds)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
    assert back.numpy().tobytes() == data


def test_bwt_three_branches():
    """`bwt` with an SA given, with the default engine (the fused branch)
    and with another engine gives one answer; a tensor keeps its device."""
    data = CASES["random"]
    want = oracle.bwt(data)
    text = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
    for u, pidx in (bwt(text, sa=oracle.build(data)), bwt(text),
                    bwt(data, engine="oracle", device="cpu")):
        assert u.device.type == "cpu" and u.dtype == torch.uint8
        assert (u.numpy().tobytes(), pidx) == want
    u, pidx = bwt(b"", device="cpu")
    assert u.shape == (0,) and pidx == 0
    assert divbwt(b"ba", device="cpu") == oracle.bwt(b"ba")  # n < 3


def test_unbwt_sorts_through_device_sort(monkeypatch):
    """The LF mapping's sort is `device_sort` of (column, row), one key:
    on the card that is the hand-written radix sort."""
    module = importlib.import_module("stringsearch_torch.transforms.bwt")
    calls = []

    def recorded(operands, num_keys=1):
        calls.append((len(operands), num_keys,
                      {op.dtype for op in operands}))
        return bitonic.plain_sort(operands, num_keys)

    monkeypatch.setattr(module, "device_sort", recorded)
    u, pidx = oracle.bwt(CASES["random"])
    assert unbwt(u, pidx, device="cpu") == CASES["random"]
    assert calls == [(2, 1, {torch.int32})]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_bwt_on_the_card(cuda, name):
    data = CASES[name]
    radix_sort.launches = 0
    bitonic.launches = 0
    _check_against_oracle(data, cuda)
    if len(data) >= 3:
        assert radix_sort.launches > 0
    assert bitonic.launches == 0


@pytest.mark.cuda
def test_bwt_on_the_card_at_2_to_20(cuda):
    from stringsearch_torch.harness.corpus import enwik_like

    data = enwik_like(1 << 20)
    u, pidx = bwt(data, device=cuda)
    assert u.device.type == "cuda"
    assert (u.cpu().numpy().tobytes(), pidx) == oracle.bwt(data)
    back = _unbwt_kernel(u, pidx, (1 << 20).bit_length())
    assert back.cpu().numpy().tobytes() == data
