"""The radix sort behind `device_sort`: its plain version and the kernel.

`plain_radix_sort` repeats the kernel's arithmetic pass by pass (digits of
the bits XOR 0x80000000 at each digit width, the histogram of every pass
from one read of the keys, the skip of a constant digit, bin starts plus
the keys of the bin in earlier tiles plus in-tile ranks, a scatter between
two buffer sets chosen so that the last live pass writes the second) and is
held here against `jax.lax.sort` on the CPU, exactly, on every plane: both
are stable, so payload order is compared too. Tests that launch the kernel
are marked `cuda` and skip without a card; on a machine with one, run them
with `python -m pytest --noconftest -m cuda tests/test_torch_radix_sort.py`
(this file imports jax only inside the tests that compare with it).
"""

import os

import numpy as np
import pytest
import torch

from stringsearch_torch.ops import bitonic, radix_sort

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INT32_MIN = np.iinfo(np.int32).min
INT32_MAX = np.iinfo(np.int32).max

SIZES = [0, 1, 2, 255, 256, 257, 1100, 4096 + 17, (1 << 16) + 12345]
KERNEL_TILE = radix_sort.TILE
SHAPES = [(c, nk) for c in range(1, 7) for nk in range(1, c + 1)]
# some divide some of the sizes, some divide none
TILES = [64, 100, 256, KERNEL_TILE]


def _lax_sort(arrays, num_keys):
    import jax

    out = jax.lax.sort(tuple(arrays), num_keys=num_keys)
    return [np.asarray(o) for o in out]


def _mixed_planes(rng, n, c, num_keys):
    """Key planes of both signs over the whole int32 range, with the two
    extremes planted and enough ties in every plane that the next one
    decides; payload planes random, with repeats."""
    planes = []
    for q in range(c):
        p = rng.integers(INT32_MIN, INT32_MAX, n, dtype=np.int32,
                         endpoint=True)
        if q < num_keys:
            few = rng.choice(np.array([INT32_MIN, -70000, -1, 0, 5, 1 << 24,
                                       INT32_MAX], dtype=np.int32), n)
            p = np.where(rng.random(n) < 0.7, few, p).astype(np.int32)
        planes.append(p)
    return planes


def _kind_planes(kind, rng, n, c, num_keys):
    def keys(make):
        return [make().astype(np.int32) for _ in range(num_keys)]

    if kind == "all equal":
        k = keys(lambda: np.full(n, -7))
    elif kind == "four values":
        k = keys(lambda: rng.choice(np.array([3, -2, 1 << 20, -(1 << 29)]), n))
    elif kind == "extremes":
        k = keys(lambda: rng.choice(
            np.array([INT32_MIN, INT32_MIN + 1, -1, 0, INT32_MAX - 1,
                      INT32_MAX]), n))
    elif kind == "negative":
        k = keys(lambda: rng.integers(INT32_MIN, 0, n))
    elif kind == "one byte differs":
        # keys that differ in one byte only, a different one per plane
        k = [(rng.integers(0, 256, n) << (8 * (q % 4))).astype(np.int32)
             for q in range(num_keys)]
    else:
        raise AssertionError(kind)
    pays = [rng.integers(-50, 50, n, dtype=np.int32)
            for _ in range(c - num_keys)]
    return k + pays


KINDS = ["all equal", "four values", "extremes", "negative",
         "one byte differs"]


def _assert_planes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))


def _tensors(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the plain version against jax.lax.sort, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("c,num_keys", SHAPES)
def test_plain_radix_sort_equals_lax_sort(c, num_keys, n):
    rng = np.random.default_rng(100 * c + 10 * num_keys + n)
    arrays = _mixed_planes(rng, n, c, num_keys)
    tile = TILES[(c + num_keys + n) % len(TILES)]
    got = radix_sort.plain_radix_sort(_tensors(arrays), num_keys, tile=tile)
    _assert_planes_equal(got, _lax_sort(arrays, num_keys))


@pytest.mark.parametrize("n,tile", [(1100, 256), (4096 + 17, 1000)])
@pytest.mark.parametrize("c,num_keys", [(2, 1), (5, 4), (6, 6)])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_radix_sort_key_kinds(kind, c, num_keys, n, tile):
    rng = np.random.default_rng(n + c)
    arrays = _kind_planes(kind, rng, n, c, num_keys)
    got = radix_sort.plain_radix_sort(_tensors(arrays), num_keys, tile=tile)
    _assert_planes_equal(got, _lax_sort(arrays, num_keys))


@pytest.mark.parametrize("tile", [1, 7, 256, 1100, 4096, 50000])
def test_plain_radix_sort_is_the_same_at_every_tile(tile):
    rng = np.random.default_rng(9)
    arrays = _kind_planes("four values", rng, 1100, 3, 2)
    got = radix_sort.plain_radix_sort(_tensors(arrays), 2, tile=tile)
    _assert_planes_equal(got, _lax_sort(arrays, 2))


def test_plain_radix_sort_leaves_its_operands():
    rng = np.random.default_rng(4)
    arrays = _mixed_planes(rng, 700, 3, 2)
    ops = _tensors([a.copy() for a in arrays])
    radix_sort.plain_radix_sort(ops, 2, tile=128)
    _assert_planes_equal(ops, arrays)


# the digit widths the kernel can be built with (kDigitBits; the sweep's
# variants take 10 and 11)
DIGIT_WIDTHS = [8, 10, 11]
# inputs that reach the new arithmetic: a skipped pass, all passes skipped
# but one copy, a plane of two live bits, ranks whose top digit is
# constant, both ends of the range and negative keys in every key plane
SKIP_KINDS = ["constant key plane", "all planes constant", "two live bits",
              "ranks below 2^k", "extremes and negatives"]
SMALL_TILE = 64
# 2, a tile, a tile and one, and a size no tile divides
SKIP_SIZES = [2, SMALL_TILE, SMALL_TILE + 1, 3 * SMALL_TILE + 37]


def _skip_planes(kind, rng, n, c=4, num_keys=3):
    """c planes of one length, the first num_keys keys of `kind`, the rest
    positions and random payloads."""
    def keys():
        if kind == "constant key plane":
            # the middle key plane constant, the others with heavy ties
            return [rng.integers(-3, 3, n), np.full(n, -123456),
                    rng.integers(INT32_MIN, INT32_MAX, n, endpoint=True)]
        if kind == "all planes constant":
            return [np.full(n, v) for v in (7, INT32_MIN, -1)]
        if kind == "two live bits":
            # a partition index, 0..3, leading the keys
            return [rng.integers(0, 4, n), rng.integers(0, 1 << 12, n),
                    rng.integers(INT32_MIN, INT32_MAX, n, endpoint=True)]
        if kind == "ranks below 2^k":
            return [rng.integers(0, 1 << 20, n), rng.integers(0, 1 << 9, n),
                    rng.integers(0, 1 << 22, n)]
        if kind == "extremes and negatives":
            ends = np.array([INT32_MIN, INT32_MIN + 1, -1 << 20, -1, 0,
                             INT32_MAX - 1, INT32_MAX])
            return [rng.choice(ends, n), rng.integers(INT32_MIN, 0, n),
                    rng.choice(ends, n)]
        raise AssertionError(kind)

    planes = [k.astype(np.int32) for k in keys()][:num_keys]
    planes.append(np.arange(n, dtype=np.int32))
    while len(planes) < c:
        planes.append(rng.integers(-50, 50, n).astype(np.int32))
    return planes


@pytest.mark.parametrize("digit_bits", DIGIT_WIDTHS)
@pytest.mark.parametrize("n", SKIP_SIZES)
@pytest.mark.parametrize("kind", SKIP_KINDS)
def test_plain_radix_sort_skips_and_digit_widths(kind, n, digit_bits):
    rng = np.random.default_rng(7 * n + digit_bits)
    arrays = _skip_planes(kind, rng, n)
    got = radix_sort.plain_radix_sort(_tensors(arrays), 3, tile=SMALL_TILE,
                                      digit_bits=digit_bits)
    _assert_planes_equal(got, _lax_sort(arrays, 3))


@pytest.mark.parametrize("digit_bits,live", [
    (8, [True, False, False, False]),
    (10, [True, False, False, False]),
    (11, [True, False, False]),
])
def test_plan_skips_the_constant_digits_of_a_partition_index(digit_bits,
                                                             live):
    """A partition index 0..3 has two live bits: one pass of its digits
    runs, the others are constant."""
    part = torch.arange(1000, dtype=torch.int32) % 4
    assert radix_sort.plan([part], 1, digit_bits)[1] == live


@pytest.mark.parametrize("digit_bits,live", [
    (8, [True, True, True, False]),
    (10, [True, True, True, False]),
    (11, [True, True, True]),
])
def test_plan_skips_the_top_digit_of_small_ranks(digit_bits, live):
    """Ranks below 2^24 (the positions of a 16 MiB text) leave the top
    8-bit digit constant, those below 2^30 the top 10-bit one (two bits);
    11-bit digits split 32 bits in three live passes."""
    ranks = torch.tensor([0, 5, (1 << 24) - 1, 1 << 21, 77], dtype=torch.int32)
    assert radix_sort.plan([ranks], 1, digit_bits)[1] == live


def test_plan_keeps_one_pass_when_every_digit_is_constant():
    planes = [torch.full((9,), -5, dtype=torch.int32),
              torch.full((9,), 3, dtype=torch.int32)]
    hist, live = radix_sort.plan(planes, 2)
    assert live == [False] * 7 + [True]
    assert hist.shape == (8, 256) and bool((hist.sum(1) == 9).all())


def test_plain_radix_sort_refuses_bad_digit_widths():
    for bits in (0, 17):
        with pytest.raises(ValueError, match="digit_bits"):
            radix_sort.plain_radix_sort(_ok_planes(), 1, digit_bits=bits)


def test_design_bytes_count_the_live_passes():
    n, c, nk = 1 << 20, 5, 4
    words = (n // radix_sort.TILE) * 256 * 8
    assert radix_sort.design_bytes(n, c, nk, [True] * 16) == (
        4 * n * nk + words + 16 * (8 * c * n + 3 * words))
    assert radix_sort.design_bytes(n, c, nk, [False] * 16) == 4 * n * nk + words


def test_the_plain_version_takes_the_kernels_constants():
    """DIGIT_BITS and TILE are the kernel's kDigitBits and kTile."""
    with open(radix_sort._SOURCE) as f:
        src = f.read()
    assert f"constexpr int kDigitBits = {radix_sort.DIGIT_BITS};" in src
    assert f"constexpr int kTile = {radix_sort.TILE};" in src


def _engine_initial(text_bytes):
    """The operands of the engine's initial sort: three packed keys and the
    position."""
    from stringsearch_torch.engines import doubling

    text = torch.from_numpy(np.frombuffer(text_bytes, dtype=np.uint8).copy())
    keys = doubling._pack4_keys(text, 12)
    return [k.numpy() for k in keys] + [np.arange(len(text_bytes),
                                                  dtype=np.int32)]


def test_plain_radix_sort_on_the_engines_initial_keys():
    from stringsearch_torch.harness.corpus import enwik_like

    arrays = _engine_initial(enwik_like(5000) + b"\xff" * 40 + b"\x00" * 40)
    assert min(a.min() for a in arrays[:3]) < 0 < max(
        a.max() for a in arrays[:3])
    got = radix_sort.plain_radix_sort(_tensors(arrays), 3, tile=512)
    _assert_planes_equal(got, _lax_sort(arrays, 3))


def test_plain_radix_sort_on_a_shift_ranks_round():
    """A fan-4 round's operands: ranks and their shifts by h, 2h and 3h with
    the negative past-the-end markers, and the position."""
    from stringsearch_torch.engines import doubling

    text = torch.from_numpy(np.frombuffer(b"abracadabra" * 150,
                                          dtype=np.uint8).copy())
    rank, _, _, count = doubling._initial_full(text, 4)
    assert int(count) > 0
    n = rank.shape[0]
    arrays = [rank.numpy()] + [doubling._shift_ranks(rank, 4 * k).numpy()
                               for k in (1, 2, 3)]
    arrays.append(np.arange(n, dtype=np.int32))
    assert arrays[3].min() < 0
    got = radix_sort.plain_radix_sort(_tensors(arrays), 4, tile=300)
    _assert_planes_equal(got, _lax_sort(arrays, 4))


@pytest.mark.parametrize("c,num_keys,n", [(2, 1, 1100), (4, 3, 4113),
                                          (5, 4, 257), (6, 5, 64)])
def test_device_sort_on_cpu_equals_lax_sort(c, num_keys, n):
    rng = np.random.default_rng(c * n)
    arrays = _mixed_planes(rng, n, c, num_keys)
    before = radix_sort.launches, bitonic.launches
    got = bitonic.device_sort(_tensors(arrays), num_keys)
    assert (radix_sort.launches, bitonic.launches) == before
    _assert_planes_equal(got, _lax_sort(arrays, num_keys))


# ---------------------------------------------------------------------------
# what the wrappers refuse
# ---------------------------------------------------------------------------


def _ok_planes(c=2, n=8, dtype=torch.int32):
    return [torch.arange(n, dtype=dtype) for _ in range(c)]


def test_radix_sort_refuses_cpu_tensors():
    """The kernel wrapper never runs a plain version in its place."""
    before = radix_sort.launches
    with pytest.raises(ValueError, match="CUDA"):
        radix_sort.radix_sort(_ok_planes(), 1)
    assert radix_sort.launches == before


@pytest.mark.parametrize("sort", [radix_sort.radix_sort,
                                  radix_sort.plain_radix_sort])
@pytest.mark.parametrize("planes,num_keys,error", [
    (_ok_planes(dtype=torch.int64), 1, TypeError),
    ([torch.arange(8, dtype=torch.int32), torch.arange(8.0)], 1, TypeError),
    (_ok_planes(c=7), 1, ValueError),
    ([], 1, ValueError),
    ([torch.arange(8, dtype=torch.int32),
      torch.arange(9, dtype=torch.int32)], 1, ValueError),
    ([torch.zeros((4, 2), dtype=torch.int32)], 1, ValueError),
    (_ok_planes(), 0, ValueError),
    (_ok_planes(), 3, ValueError),
])
def test_sorts_refuse_what_the_kernel_does_not_take(sort, planes, num_keys,
                                                    error):
    with pytest.raises(error):
        sort(planes, num_keys)


def test_plain_radix_sort_refuses_tile_zero():
    with pytest.raises(ValueError, match="tile"):
        radix_sort.plain_radix_sort(_ok_planes(), 1, tile=0)


def test_the_two_oracle_sources_are_byte_identical():
    """Both packages are judged by one oracle: the port's own copy of the
    C++ source equals the JAX package's, and is the file the port builds."""
    from stringsearch_torch import oracle

    ours = os.path.join(REPO, "stringsearch_torch", "oracle", "csrc",
                        "saca.cpp")
    theirs = os.path.join(REPO, "stringsearch_tpu", "oracle", "csrc",
                          "saca.cpp")
    assert os.path.samefile(oracle.SOURCE, ours)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


RADIX_VARIANTS = ["radix digits 10", "radix digits 11 tile 8192",
                  "radix cp.async loads", "radix register loads",
                  "radix look-back window 1", "radix look-back window 4",
                  "radix match_any", "radix tile 16384 threads 1024",
                  "radix tile 16384 threads 1024 cp.async loads",
                  "radix tile 8192 threads 256",
                  "radix tile 8192 threads 256 digits 11"]


@pytest.mark.parametrize("name", RADIX_VARIANTS)
def test_sort_variants_each_change_the_radix_source_once(name):
    """The design sweep patches the kernel's source by text; each patch
    must still find its one place in it."""
    from stringsearch_torch.harness import sort_variants

    assert set(RADIX_VARIANTS) | {"radix as built"} == set(
        sort_variants.RADIX_VARIANTS)
    with open(radix_sort._SOURCE) as f:
        built = f.read()
    with open(sort_variants.variant_source(name)) as f:
        variant = f.read()
    assert variant != built
    assert len(variant.splitlines()) == len(built.splitlines())


# ---------------------------------------------------------------------------
# the kernel against the plain sort, on the card
# ---------------------------------------------------------------------------


def _kernel_equals_plain(arrays, num_keys, device):
    before = radix_sort.launches, bitonic.launches
    got = bitonic.device_sort(_tensors(arrays, device), num_keys)
    torch.cuda.synchronize()
    launched = 1 if len(arrays[0]) >= 2 else 0
    assert radix_sort.launches == before[0] + launched
    assert bitonic.launches == before[1]
    assert all(g.device.type == "cuda" for g in got)
    _assert_planes_equal(got, bitonic.plain_sort(_tensors(arrays), num_keys))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES + [KERNEL_TILE, 2 * KERNEL_TILE,
                               (1 << 20) + 4099])
@pytest.mark.parametrize("c,num_keys", SHAPES)
def test_kernel_equals_plain_sort(cuda, c, num_keys, n):
    rng = np.random.default_rng(100 * c + 10 * num_keys + n)
    _kernel_equals_plain(_mixed_planes(rng, n, c, num_keys), num_keys, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1100, 4096 + 17, (1 << 18) + 5])
@pytest.mark.parametrize("c,num_keys", [(2, 1), (5, 4), (6, 6)])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_key_kinds(cuda, kind, c, num_keys, n):
    rng = np.random.default_rng(n + c)
    _kernel_equals_plain(_kind_planes(kind, rng, n, c, num_keys), num_keys,
                         cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, KERNEL_TILE, KERNEL_TILE + 1,
                               3 * KERNEL_TILE + 37, (1 << 20) + 7])
@pytest.mark.parametrize("kind", SKIP_KINDS)
def test_kernel_skips_constant_digits(cuda, kind, n):
    rng = np.random.default_rng(n + len(kind))
    arrays = _skip_planes(kind, rng, n, c=5, num_keys=3)
    _kernel_equals_plain(arrays, 3, cuda)
    ops = _tensors(arrays, cuda)
    got = radix_sort.radix_sort(ops, 3)
    want = radix_sort.plain_radix_sort(ops, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernel_takes_planes_off_16_bytes(cuda):
    """A plane that starts 4 bytes into its storage (the bulk loads need
    16) is copied and sorted."""
    base = torch.arange(70001, 0, -1, dtype=torch.int32, device=cuda)
    k, v = base[1:], torch.arange(70000, dtype=torch.int32, device=cuda)
    assert k.data_ptr() % 16 != 0
    got = radix_sort.radix_sort((k, v), 1)
    want = bitonic.plain_sort((k, v), 1)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_kernel_on_the_engines_shapes(cuda):
    from stringsearch_torch.harness.corpus import enwik_like

    arrays = _engine_initial(enwik_like(1 << 17) + b"\xff" * 40)
    _kernel_equals_plain(arrays, 3, cuda)


@pytest.mark.cuda
def test_kernel_equals_its_plain_version(cuda):
    rng = np.random.default_rng(12)
    ops = _tensors(_mixed_planes(rng, 3 * KERNEL_TILE + 5, 4, 3), cuda)
    got = radix_sort.radix_sort(ops, 3)
    want = radix_sort.plain_radix_sort(ops, 3, tile=KERNEL_TILE)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_kernel_leaves_inputs_and_takes_strided_planes(cuda):
    k = torch.tensor([3, -1, 2, -1, 3, 0], dtype=torch.int32, device=cuda)
    v = torch.arange(12, dtype=torch.int32, device=cuda)[::2]
    assert not v.is_contiguous()
    got = radix_sort.radix_sort((k, v), 1)
    assert k.tolist() == [3, -1, 2, -1, 3, 0]
    assert v.tolist() == [0, 2, 4, 6, 8, 10]
    assert got[0].tolist() == [-1, -1, 0, 2, 3, 3]
    assert got[1].tolist() == [2, 6, 10, 4, 0, 8]
    with pytest.raises(TypeError):
        radix_sort.radix_sort((k.to(torch.int64), v), 1)
