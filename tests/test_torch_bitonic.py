"""Port of ops/bitonic.py: `device_sort`, its plain version and the
bitonic kernel.

The plain version is held against `jax.lax.sort` exactly (both are stable).
The Hopper bitonic kernel (`bitonic_sort`, which `device_sort` no longer
routes through: the radix sort of tests/test_torch_radix_sort.py took its
place) is unstable, so against the plain sort its keys must match exactly
and each payload plane as a multiset inside every tied key block; against
its own plain version `plain_bitonic_sort` (the same network, pass for
pass) every plane must match exactly. tests/test_torch_bitonic_schedule.py
holds the schedule and `plain_bitonic_sort` on the CPU.
Tests that launch a kernel are marked `cuda` and skip without a card; on a
machine with one, run them with
`python -m pytest --noconftest -m cuda tests/test_torch_bitonic.py`
(this file imports jax only inside the tests that compare with it).
"""

import numpy as np
import pytest
import torch

from stringsearch_torch.ops import bitonic, radix_sort

INT32_MAX = np.iinfo(np.int32).max


def _planes(rng, n, c, num_keys, lo=-8, hi=8):
    """num_keys mixed-sign key planes with many ties + distinct payloads."""
    keys = [rng.integers(lo, hi, n, dtype=np.int32) for _ in range(num_keys)]
    pays = [rng.permutation(n).astype(np.int32) for _ in range(c - num_keys)]
    return keys + pays


def _assert_sorted_like(got, want, num_keys):
    """Keys equal; each payload plane equal as a multiset per tied block."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(w) for w in want]
    for g, w in zip(got[:num_keys], want[:num_keys]):
        np.testing.assert_array_equal(g, w)
    n = want[0].shape[0]
    if n == 0:
        return
    keys = np.stack(want[:num_keys])
    new = np.ones(n, dtype=bool)
    new[1:] = (keys[:, 1:] != keys[:, :-1]).any(axis=0)
    block = np.cumsum(new)
    for g, w in zip(got[num_keys:], want[num_keys:]):
        np.testing.assert_array_equal(g[np.lexsort((g, block))],
                                      w[np.lexsort((w, block))])


def _lax_sort(arrays, num_keys):
    import jax

    out = jax.lax.sort(tuple(arrays), num_keys=num_keys)
    return [np.asarray(o) for o in out]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1024, 1100])
@pytest.mark.parametrize("c,num_keys", [(2, 1), (4, 3), (5, 4), (5, 5), (6, 6)])
def test_plain_sort_equals_lax_sort(c, num_keys, n):
    rng = np.random.default_rng(1000 * c + num_keys + n)
    arrays = _planes(rng, n, c, num_keys)
    got = bitonic.plain_sort([torch.from_numpy(a) for a in arrays], num_keys)
    want = _lax_sort(arrays, num_keys)
    for g, w in zip(got, want):  # both stable: payloads match exactly
        np.testing.assert_array_equal(g.numpy(), w)


def test_plain_sort_full_int32_range():
    rng = np.random.default_rng(3)
    n = 777
    k = rng.integers(np.iinfo(np.int32).min, INT32_MAX, n, dtype=np.int32,
                     endpoint=True)
    k[:5] = [INT32_MAX, np.iinfo(np.int32).min, 0, -1, INT32_MAX]
    j = np.arange(n, dtype=np.int32)
    got = bitonic.plain_sort([torch.from_numpy(k), torch.from_numpy(j)], 1)
    for g, w in zip(got, _lax_sort([k, j], 1)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_reference_pallas_network_agrees(monkeypatch):
    """The port's sort against the reference's Pallas network itself, run
    in interpret mode with 256-element tiles (power-of-two n, where the
    reference pads nothing)."""
    monkeypatch.setenv("STRINGSEARCH_TPU_PALLAS_TILE", "256")
    from stringsearch_tpu.ops.bitonic import pallas_sort

    rng = np.random.default_rng(11)
    arrays = _planes(rng, 1024, 2, 1, lo=-(1 << 30), hi=1 << 30)
    import jax.numpy as jnp

    want = pallas_sort(tuple(jnp.asarray(a) for a in arrays), 1, interpret=True)
    got = bitonic.device_sort([torch.from_numpy(a) for a in arrays], 1)
    _assert_sorted_like([g.numpy() for g in got], want, 1)


def test_device_sort_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    ops = [torch.from_numpy(a) for a in _planes(rng, 300, 4, 3)]
    before = bitonic.launches, radix_sort.launches
    got = bitonic.device_sort(ops, num_keys=3)
    want = bitonic.plain_sort(ops, num_keys=3)
    assert (bitonic.launches, radix_sort.launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version in its place."""
    ops = (torch.zeros(8, dtype=torch.int32), torch.arange(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        bitonic.bitonic_sort(ops, 1)


def _int32_max_case(n, seed):
    """Keys from {0, 1, 2, INT32_MAX}: the values that make the reference's
    all-ones padding lose payloads at non-power-of-two n."""
    rng = np.random.default_rng(seed)
    k = rng.choice(np.array([0, 1, 2, INT32_MAX], dtype=np.int32), n)
    return k, np.arange(n, dtype=np.int32)


@pytest.mark.parametrize("n", [1100, 1030])
def test_int32_max_keys_lose_nothing_plain(n):
    k, j = _int32_max_case(n, n)
    got = bitonic.device_sort([torch.from_numpy(k), torch.from_numpy(j)], 1)
    np.testing.assert_array_equal(np.sort(got[1].numpy()), j)
    np.testing.assert_array_equal(got[0].numpy(), np.sort(k))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1100, 1030, (1 << 16) + 12345])
@pytest.mark.parametrize("kernel", ["bitonic", "radix"])
def test_int32_max_keys_lose_nothing_kernel(cuda, kernel, n):
    k, j = _int32_max_case(n, n)
    ops = [torch.from_numpy(k).to(cuda), torch.from_numpy(j).to(cuda)]
    module = bitonic if kernel == "bitonic" else radix_sort
    sort = bitonic.bitonic_sort if kernel == "bitonic" else bitonic.device_sort
    before = module.launches
    got = sort(ops, 1)
    torch.cuda.synchronize()
    assert module.launches == before + 1
    np.testing.assert_array_equal(np.sort(got[1].cpu().numpy()), j)
    want = bitonic.plain_sort([torch.from_numpy(k), torch.from_numpy(j)], 1)
    _assert_sorted_like([g.cpu() for g in got], want, 1)
    if kernel == "radix":  # stable: the payload order matches too
        assert torch.equal(got[1].cpu(), want[1])


def _edge_n(n, c):
    """n of the edge cases: a number, or "T-1", "T", "T+1" around the
    kernel's tile for c planes."""
    if isinstance(n, int):
        return n
    return (1 << bitonic.tile_log(c)) + {"T-1": -1, "T": 0, "T+1": 1}[n]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3, "T-1", "T", "T+1", 100_003, 1 << 18])
@pytest.mark.parametrize("c,num_keys", [(1, 1), (2, 1), (2, 2), (4, 3),
                                        (5, 4), (5, 5), (6, 6)])
def test_kernel_matches_plain(cuda, c, num_keys, n):
    """Keys equal the plain sort's, payloads per tied block; every plane
    equals `plain_bitonic_sort`'s element for element (the same network)."""
    n = _edge_n(n, c)
    rng = np.random.default_rng(n + 7 * c + num_keys)
    arrays = _planes(rng, n, c, num_keys, lo=-(1 << 31), hi=(1 << 31) - 1)
    if n > 4:  # dense ties as well as extremes
        arrays[0][: n // 2] = rng.integers(-2, 2, n // 2, dtype=np.int32)
    ops = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = bitonic.launches
    got = bitonic.bitonic_sort(ops, num_keys)
    torch.cuda.synchronize()
    assert bitonic.launches == before + 1
    want = bitonic.plain_sort([torch.from_numpy(a) for a in arrays], num_keys)
    _assert_sorted_like([g.cpu() for g in got], want, num_keys)
    same = bitonic.plain_bitonic_sort(ops, num_keys)
    for g, w in zip(got, same):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("c", range(1, 7))
def test_kernel_runs_the_schedule(cuda, c):
    """The library's own pass list equals `schedule`'s, from one element
    to 2^31."""
    for n in [0, 1, 2, 3, 255, 256, 257, 4095, 8193, 100_003, 1 << 20,
              (1 << 24) + 12345, 1 << 28, 1 << 31]:
        assert bitonic.kernel_schedule(n, c) == bitonic.schedule(n, c)


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [bitonic.bitonic_sort, bitonic.device_sort])
def test_kernel_leaves_inputs_and_rejects_other_dtypes(cuda, sort):
    """`device_sort` takes int64 planes (as pairs of int32 planes);
    `bitonic_sort` takes int32 only; neither takes bytes."""
    k = torch.tensor([3, 1, 2], dtype=torch.int32, device=cuda)
    v = torch.arange(3, dtype=torch.int32, device=cuda)
    sort((k, v), 1)
    assert k.tolist() == [3, 1, 2] and v.tolist() == [0, 1, 2]
    k64 = k.to(torch.int64) - (1 << 40)
    if sort is bitonic.device_sort:
        got = sort((k64, v), 1)
        assert got[0].tolist() == sorted(k64.tolist())
        assert got[1].tolist() == [1, 2, 0]
    else:
        with pytest.raises(TypeError):
            sort((k64, v), 1)
    with pytest.raises(TypeError):
        sort((k.to(torch.uint8), v), 1)


@pytest.mark.parametrize("name", ["tile 4096", "group stages S-1",
                                  "no mirror fusion", "no swizzle",
                                  "two stages a round", "four stages a round",
                                  "key count at run time"])
def test_sort_variants_each_change_the_source_once(name):
    """The design sweep patches the kernel's source by text; each patch
    must still find its one place in it."""
    from stringsearch_torch.harness import sort_variants

    with open(bitonic._SOURCE) as f:
        built = f.read()
    with open(sort_variants.variant_source(name)) as f:
        variant = f.read()
    assert variant != built
    assert len(variant.splitlines()) == len(built.splitlines())
