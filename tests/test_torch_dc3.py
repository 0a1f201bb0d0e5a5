"""Port of engines/dc3.py against the JAX engine and the C++ oracle.

The inputs of the reference's tests/test_dc3.py go through both packages,
the port on the CPU: every recursion level's sample order, names, sample
SA and merged SA are compared through `sort_traced`, whose trace text must
be byte-identical to the JAX one, and the SA against the naive suffix
order (tolerance 0 throughout). Both with the tail solve and with the full
recursion (`STRINGSEARCH_TORCH_DC3_FULL`, `STRINGSEARCH_TPU_DC3_FULL` on
the JAX side). `_sample_sort` and `_finish` are also compared alone, on
both comparator paths. The `cuda` tests run the kernel route and skip
without a card: `python -m pytest --noconftest -m cuda tests/test_torch_dc3.py`
(this file imports jax only inside the tests that compare with it).
"""

import bisect

import numpy as np
import pytest
import torch

import stringsearch_torch as st
from stringsearch_torch import oracle
from stringsearch_torch.engines import dc3
from stringsearch_torch.harness.corpus import regression_corpus
from stringsearch_torch.harness.tracing import Tracer

SMALL = {k: v for k, v in regression_corpus().items() if len(v) <= 1024}
MODES = {"tail": {}, "full": {"STRINGSEARCH_TORCH_DC3_FULL": "1",
                              "STRINGSEARCH_TPU_DC3_FULL": "1"}}


def _naive_sa(data: bytes) -> np.ndarray:
    return np.asarray(sorted(range(len(data)), key=lambda i: data[i:]),
                      dtype=np.int32)


def _fibonacci_800() -> bytes:
    a, b = b"a", b"ab"
    for _ in range(12):
        a, b = b, b + a
    return b[:800]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _traces_equal(data: bytes, tmp_path, device="cpu") -> str:
    """Trace `data` with both packages; assert one text, the SA equal to
    the naive one. Returns the trace."""
    from stringsearch_tpu.engines import dc3 as jdc3
    from stringsearch_tpu.harness import tracing as jtracing

    with Tracer(str(tmp_path / "torch")) as tr:
        sa = dc3.sort_traced(data, tr, device=device)
    with jtracing.Tracer(str(tmp_path / "jax")) as jtr:
        jdc3.sort_traced(data, jtr)
    got = (tmp_path / "torch").read_text()
    assert got == (tmp_path / "jax").read_text()
    np.testing.assert_array_equal(sa.sa.cpu().numpy(), _naive_sa(data))
    return got


@pytest.mark.parametrize("name", sorted(SMALL))
def test_dc3_matches_jax_on_the_corpus(name, tmp_path):
    got = _traces_equal(SMALL[name], tmp_path)
    if len(SMALL[name]) > 3:
        assert ":: L0 SA (merged)" in got


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", [99, 100, 101, 102, 103])
def test_dc3_mod3_boundaries(n, mode, tmp_path, monkeypatch):
    """All three n % 3 residues around a recursion-heavy input."""
    for var, value in MODES[mode].items():
        monkeypatch.setenv(var, value)
    rng = np.random.default_rng(8 + n)
    data = bytes(rng.integers(0, 3, n, dtype=np.uint8))
    got = _traces_equal(data, tmp_path)
    assert ("tail solve" in got) == (mode == "tail")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dc3_deep_recursion(mode, tmp_path, monkeypatch):
    """A Fibonacci string forces deep recursion (few distinct names)."""
    for var, value in MODES[mode].items():
        monkeypatch.setenv(var, value)
    got = _traces_equal(_fibonacci_800(), tmp_path)
    levels = got.count("n02=")
    assert levels >= (4 if mode == "full" else 1)


def test_three_way_crosscheck():
    """doubling against dc3 against the C++ oracle, and the JAX dc3."""
    from stringsearch_tpu.engines import dc3 as jdc3

    rng = np.random.default_rng(55)
    for n, alpha in [(500, 2), (1000, 256), (2000, 4)]:
        data = bytes(rng.integers(0, alpha, n, dtype=np.uint8))
        a = st.build_suffix_array(data, engine="doubling", device="cpu").sa
        b = dc3.sort(data, device="cpu").sa
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(b.numpy(), oracle.build(data))
        np.testing.assert_array_equal(b.numpy(),
                                      np.asarray(jdc3.sort(data).sa))


def test_dc3_engine_registry():
    sa = st.build_suffix_array(b"banana", engine="dc3", device="cpu")
    assert sa.sa.tolist() == [5, 3, 1, 0, 4, 2]
    assert sa.sa.dtype == torch.int32
    sa.verify()
    assert dc3.sort(b"", device="cpu").sa.shape == (0,)
    # every bucket's reduced string fits in the bucket below it; 2^28
    # bytes pad to 354,836,039
    b = dc3._BUCKETS
    assert all(dc3._reduced_size(v) <= u for u, v in zip(b, b[1:]))
    assert b[bisect.bisect_left(b, 1 << 28)] == 354_836_039


def _level_input(n: int, alpha: int, seed: int) -> np.ndarray:
    """A level's values: >= 1, 0 the sentinel."""
    return np.random.default_rng(seed).integers(1, alpha + 1, n).astype(
        np.int32)


@pytest.mark.parametrize("n", [28, 41, 62])
def test_sample_sort_matches_jax(n):
    import jax.numpy as jnp

    from stringsearch_tpu.engines import dc3 as jdc3

    t = _level_input(n, 3, n)
    tpad = np.concatenate([t, np.zeros(3, np.int32)])
    n0, n2 = (n + 2) // 3, n // 3
    got = dc3._sample_sort(torch.from_numpy(tpad), n, n0, n0 + n2)
    want = jdc3._sample_sort(jnp.asarray(tpad), n, n0, n0 + n2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("byte_alpha", [True, False])
@pytest.mark.parametrize("n", [28, 41, 62])
def test_finish_matches_jax(n, byte_alpha):
    """The merge on both comparator paths (the packed one takes bytes + 1
    only), fed the sample SA sorted on the host."""
    import jax.numpy as jnp

    from stringsearch_tpu.engines import dc3 as jdc3

    t = _level_input(n, 256 if byte_alpha else 5, 7 * n)
    tpad = np.concatenate([t, np.zeros(3, np.int32)])
    n0, n1, n2 = (n + 2) // 3, (n + 1) // 3, n // 3
    drop_pad = n0 != n1
    # the sample positions of the padded text by their suffixes: where
    # n % 3 == 1 the pad position n is one of them, and sorts first
    values = tpad.tolist()
    sa12 = np.asarray(sorted([1 + 3 * k for k in range(n0)]
                             + [2 + 3 * k for k in range(n2)],
                             key=lambda i: values[i:]), dtype=np.int32)
    steps0 = dc3._ceil_log2(n0 + 1) + 1
    steps12 = dc3._ceil_log2(n0 + n2 - drop_pad + 1) + 1
    got = dc3._finish(torch.from_numpy(tpad), torch.from_numpy(sa12), n, n0,
                      drop_pad, steps0, steps12, byte_alpha)
    want = jdc3._finish(jnp.asarray(tpad), jnp.asarray(sa12), n, n0,
                        drop_pad, steps0, steps12, byte_alpha)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  _naive_sa(bytes((t - 1).astype(np.uint8))))


def test_scatter_last_keeps_the_last_writer():
    """The merge of a padded level writes some slots twice (pad suffixes
    the comparator cannot tell apart); the last writer wins, as in the
    reference's serial scatter, on every device."""
    out = torch.zeros(7, dtype=torch.int32)  # the last slot is the spare
    pos = torch.tensor([4, 1, 4, 0, 1, 4], dtype=torch.int32)
    dc3._scatter_last(out, pos, torch.arange(10, 16, dtype=torch.int32))
    assert out.tolist()[:6] == [13, 14, 0, 0, 15, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
def test_dc3_on_the_card(cuda, mode, monkeypatch):
    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_torch.ops import radix_sort

    for var, value in MODES[mode].items():
        monkeypatch.setenv(var, value)
    cases = dict(SMALL)
    cases["fibonacci-800"] = _fibonacci_800()
    cases["enwik_like(2^17)"] = enwik_like(1 << 17)
    for name, data in cases.items():
        before = radix_sort.launches
        sa = dc3.sort(data, device=cuda).sa
        assert sa.device.type == "cuda"
        np.testing.assert_array_equal(sa.cpu().numpy(), oracle.build(data),
                                      name)
        assert len(data) < 4 or radix_sort.launches > before


@pytest.mark.cuda
def test_dc3_trace_on_the_card_equals_the_cpu_trace(cuda, tmp_path):
    from stringsearch_torch.harness.corpus import enwik_like

    for i, data in enumerate((_fibonacci_800(), enwik_like(1 << 16))):
        with Tracer(str(tmp_path / f"gpu{i}")) as tr:
            dc3.sort_traced(data, tr, device=cuda)
        with Tracer(str(tmp_path / f"cpu{i}")) as tr:
            dc3.sort_traced(data, tr, device="cpu")
        assert (tmp_path / f"gpu{i}").read_bytes() == \
            (tmp_path / f"cpu{i}").read_bytes()
