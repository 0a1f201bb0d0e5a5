"""The doubling engine's steps between the sorts (`ops/steps.py`).

`pack_keys`, `shift_planes` and `head_ranks` against the JAX package's
`_pack4_keys`, `_shift_ranks` and `_ranks_sorted_only`
(stringsearch_tpu/engines/doubling.py:83, :116, :151), on the same numpy
inputs: random bytes, a two-letter alphabet, `b"ab" * k` and all-zero
text, n from 1 to 4999. On the CPU each function takes its plain version.
Every value is an integer: tolerance 0. A routing guard counts the three
functions' calls in the builds that reach them.

Tests marked `cuda` hold each kernel against its plain version on the card
and skip without one; run them with
`python -m pytest --noconftest -m cuda tests/test_torch_steps.py` (this file
imports jax only inside the tests that compare with it).
"""

import numpy as np
import pytest
import torch

from stringsearch_torch.engines import doubling
from stringsearch_torch.ops import steps
from stringsearch_torch.ops.bitonic import plain_sort

INT32_MIN = np.iinfo(np.int32).min
KINDS = ("random", "alpha2", "ab", "zeros")
SIZES = (1, 2, 3, 5, 100, 1031, 4999)


def _text(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + n)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "alpha2":
        return rng.choice(np.array([97, 98], dtype=np.uint8), n)
    if kind == "ab":
        return np.frombuffer((b"ab" * (n // 2 + 1))[:n], dtype=np.uint8).copy()
    if kind == "zeros":
        return np.zeros(n, dtype=np.uint8)
    raise AssertionError(kind)


def _jax_keys(text: np.ndarray, depth: int) -> list:
    """The reference's uint32 keys, as the port's biased int32 bits."""
    import jax.numpy as jnp

    from stringsearch_tpu.engines import doubling as jdoubling

    keys = jdoubling._pack4_keys(jnp.asarray(text), depth)
    return [(np.asarray(k).view(np.int32) ^ np.int32(INT32_MIN))
            for k in keys]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# pack_keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_pack_keys_match_jax(kind, n):
    text = _text(kind, n)
    planes = steps.pack_keys(torch.from_numpy(text.copy()), 12)
    assert len(planes) == 4
    for got, want in zip(planes[:-1], _jax_keys(text, 12)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(planes[-1]), np.arange(n))
    assert planes[-1].dtype == torch.int32


@pytest.mark.parametrize("depth", [4, 8, 24, 26])
def test_pack_keys_depths_match_jax(depth):
    text = _text("random", 777)
    planes = steps.pack_keys(torch.from_numpy(text.copy()), depth)
    want = _jax_keys(text, depth)
    assert len(planes) == len(want) + 1 == depth // 4 + 1
    for got, w in zip(planes, want):
        np.testing.assert_array_equal(_np(got), w)


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("chunk", [1, 4, 250, 997])
@pytest.mark.parametrize("kind", ["random", "ab"])
def test_pack_keys_chunked_match_jax_chunk_by_chunk(kind, chunk, idx):
    n = 997 * 4 if chunk == 997 else 1000
    text = _text(kind, n)
    planes = steps.pack_keys(torch.from_numpy(text.copy()), 12, chunk, idx)
    assert len(planes) == 5
    lead, keys, pos = planes[0], planes[1:-1], planes[-1]
    assert lead.dtype == pos.dtype == idx
    np.testing.assert_array_equal(_np(lead), np.arange(n) // chunk)
    np.testing.assert_array_equal(_np(pos), np.arange(n))
    for p in range(n // chunk):
        part = slice(p * chunk, (p + 1) * chunk)
        for got, want in zip(keys, _jax_keys(text[part], 12)):
            np.testing.assert_array_equal(_np(got)[part], want)


def test_pack_keys_one_chunk_is_the_flat_build():
    text = torch.from_numpy(_text("alpha2", 640))
    flat = steps.pack_keys(text, 12)
    whole = steps.pack_keys(text, 12, chunk=640, idx=torch.int32)
    assert len(flat) == len(whole) == 4
    for a, b in zip(flat, whole):
        assert torch.equal(a, b)


def test_pack4_keys_is_the_key_planes_of_pack_keys():
    text = torch.from_numpy(_text("random", 400))
    for chunk in (None, 100):
        planes = steps.pack_keys(text, 16, chunk)
        keys = doubling._pack4_keys(text, 16, chunk)
        assert len(keys) == 4
        for a, b in zip(keys, planes[-5:-1]):
            assert torch.equal(a, b)


def test_pack_keys_refuses_bad_input():
    text = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(TypeError):
        steps.pack_keys(text.to(torch.int16), 12)
    with pytest.raises(TypeError):
        steps.pack_keys(text, 12, idx=torch.float32)
    with pytest.raises(ValueError):
        steps.pack_keys(text, 0)
    with pytest.raises(ValueError):
        steps.pack_keys(text, 12, chunk=3)


# ---------------------------------------------------------------------------
# shift_planes
# ---------------------------------------------------------------------------


def _jax_shift(rank: np.ndarray, h: int) -> np.ndarray:
    import jax.numpy as jnp

    from stringsearch_tpu.engines import doubling as jdoubling

    return np.asarray(jdoubling._shift_ranks(jnp.asarray(rank),
                                             jnp.asarray(h, rank.dtype)))


@pytest.mark.parametrize("n", [1, 2, 3, 700, 4999])
def test_shift_planes_match_jax(n):
    rank = np.random.default_rng(n).integers(-50, 50, n, dtype=np.int32)
    shifts = [0, 1, 2, 5, n - 1, n, n + 1, 3 * n + 7]
    planes = steps.shift_planes(torch.from_numpy(rank), shifts)
    assert len(planes) == len(shifts) + 1
    for h, got in zip(shifts, planes):
        np.testing.assert_array_equal(_np(got), _jax_shift(rank, h))
    np.testing.assert_array_equal(_np(planes[-1]), np.arange(n))


def test_shift_planes_int64_match_jax():
    import jax

    n = 1500
    rank = np.random.default_rng(5).integers(-(1 << 40), 1 << 40, n)
    shifts = [1, 12, 24, 1499, 1500, 4000]
    planes = steps.shift_planes(torch.from_numpy(rank), shifts)
    with jax.enable_x64():
        for h, got in zip(shifts, planes):
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(_np(got), _jax_shift(rank, h))
    assert planes[-1].dtype == torch.int64


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("chunk", [1, 4, 125, 1000])
def test_shift_planes_chunked_match_jax_chunk_by_chunk(chunk, idx):
    import jax

    n = 1000
    rank = np.random.default_rng(chunk).integers(0, 90, n).astype(
        np.int32 if idx == torch.int32 else np.int64)
    # a fan-4 round at h = 12 and at h >= chunk, with the round's overflow
    # guard, and the shifts of build_ints_with_isa
    shifts = sorted({min(h, chunk // k + 1) * k for h in (12, chunk, chunk + 5)
                     for k in (1, 2, 3)} | {1, 2, 3})
    planes = steps.shift_planes(torch.from_numpy(rank), shifts, chunk)
    with jax.enable_x64():
        for h, got in zip(shifts, planes):
            assert got.dtype == idx
            for p in range(n // chunk):
                part = slice(p * chunk, (p + 1) * chunk)
                np.testing.assert_array_equal(
                    _np(got)[part], _jax_shift(rank[part], min(h, chunk)))
    np.testing.assert_array_equal(_np(planes[-1]), np.arange(n))


def test_shift_ranks_is_the_first_plane_of_shift_planes():
    rank = torch.from_numpy(
        np.random.default_rng(1).integers(0, 9, 600, dtype=np.int32))
    for h, chunk in ((5, None), (5, 100), (100, 100), (700, None)):
        want = steps.shift_planes(rank, [h], chunk)[0]
        assert torch.equal(doubling._shift_ranks(rank, h, chunk), want)


def test_shift_planes_refuses_bad_input():
    rank = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        steps.shift_planes(rank, [-1])
    with pytest.raises(TypeError):
        steps.shift_planes(rank.to(torch.float32), [1])
    with pytest.raises(ValueError):
        steps.shift_planes(rank, [1], chunk=3)


# ---------------------------------------------------------------------------
# head_ranks
# ---------------------------------------------------------------------------


def _sorted_tuple(keys: list, idx) -> list:
    """(keys..., positions) sorted by the keys, stably, as numpy arrays."""
    n = len(keys[0])
    planes = [torch.from_numpy(k) for k in keys]
    planes.append(torch.arange(n, dtype=idx))
    return [_np(p) for p in plain_sort(planes, len(keys))]


def _jax_heads(out: list, idx):
    import jax
    import jax.numpy as jnp

    from stringsearch_tpu.engines import doubling as jdoubling

    jidx = jnp.int64 if idx == torch.int64 else jnp.int32
    with jax.enable_x64():
        sa, rank, count = jdoubling._ranks_sorted_only(
            tuple(jnp.asarray(a) for a in out), jidx)
        return np.asarray(sa), np.asarray(rank), int(count)


def _check_heads(out: list, idx) -> int:
    sa_s, rank_s, count = steps.head_ranks([torch.from_numpy(a) for a in out])
    want_sa, want_rank, want_count = _jax_heads(out, idx)
    assert rank_s.dtype == sa_s.dtype == idx
    assert count.dim() == 0 and count.dtype == torch.int64
    np.testing.assert_array_equal(_np(sa_s), want_sa)
    np.testing.assert_array_equal(_np(rank_s), want_rank)
    assert int(count) == want_count
    return want_count


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_head_ranks_of_the_initial_sort_match_jax(kind, n, idx):
    text = torch.from_numpy(_text(kind, n))
    keys = [_np(k) for k in steps.pack_keys(text, 12)[:-1]]
    _check_heads(_sorted_tuple(keys, idx), idx)


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", KINDS)
def test_head_ranks_of_a_round_sort_match_jax(kind, idx):
    """A fan-4 round's sort: the text-order rank and three shifts."""
    n = 3001
    rank = np.random.default_rng(3).integers(0, 4, n)
    if kind == "ab":
        rank = np.arange(n) % 2
    elif kind == "zeros":
        rank = np.zeros(n, dtype=np.int64)
    rank = torch.from_numpy(rank).to(idx)
    planes = steps.shift_planes(rank, [4, 8, 12])
    keys = [_np(rank)] + [_np(p) for p in planes[:-1]]
    _check_heads(_sorted_tuple(keys, idx), idx)


def test_head_ranks_of_mixed_planes_match_jax():
    """The chunked initial sort: an int64 chunk plane before int32 keys."""
    n = 1200
    text = torch.from_numpy(_text("alpha2", n))
    planes = steps.pack_keys(text, 8, chunk=100, idx=torch.int64)
    keys = [_np(p) for p in planes[:-1]]
    assert keys[0].dtype == np.int64 and keys[1].dtype == np.int32
    assert _check_heads(_sorted_tuple(keys, torch.int64), torch.int64) > 0


@pytest.mark.parametrize("case", ["all equal", "all distinct",
                                  "no key planes", "heads every 7"])
def test_head_ranks_edge_groups_match_jax(case):
    n = 2500
    if case == "all equal":
        keys = [np.full(n, 3, dtype=np.int32)]
    elif case == "all distinct":
        keys = [np.arange(n, dtype=np.int32)]
    elif case == "no key planes":
        keys = []
    else:
        keys = [(np.arange(n) // 7).astype(np.int32),
                np.zeros(n, dtype=np.int32)]
    planes = [torch.from_numpy(k) for k in keys]
    out = [_np(p) for p in plain_sort(
        planes + [torch.arange(n, dtype=torch.int32)], max(len(keys), 1))]
    count = _check_heads(out, torch.int32)
    assert count == {"all equal": n, "all distinct": 0, "no key planes": n,
                     "heads every 7": n - n % 7 + (n % 7 > 1) * (n % 7)}[case]


def test_head_ranks_empty():
    sa_s, rank_s, count = steps.head_ranks(
        [torch.zeros(0, dtype=torch.int32)] * 2)
    assert rank_s.shape == (0,) and int(count) == 0


def test_ranks_sorted_only_is_head_ranks():
    out = [torch.tensor([1, 1, 2, 5, 5, 5], dtype=torch.int32),
           torch.tensor([3, 0, 1, 2, 4, 5], dtype=torch.int32)]
    got = doubling._ranks_sorted_only(out)
    want = steps.head_ranks(out)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].tolist() == [0, 0, 2, 3, 3, 3] and int(got[2]) == 5


def test_head_ranks_refuses_bad_input():
    good = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        steps.head_ranks([good.to(torch.float32), good])
    with pytest.raises(ValueError):
        steps.head_ranks([torch.zeros(5, dtype=torch.int32), good])
    with pytest.raises(ValueError):
        steps.head_ranks([])


# ---------------------------------------------------------------------------
# routing: the builds call the three steps where their path needs them
# ---------------------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Counts the calls of the three steps made through the engine."""
    calls = {"pack_keys": 0, "shift_planes": 0, "head_ranks": 0}
    for name in calls:
        fn = getattr(doubling, name)

        def wrapper(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(doubling, name, wrapper)
    return calls


@pytest.mark.parametrize("chunk", [None, 250])
def test_build_sa_goes_through_the_three_steps(counted, chunk):
    from stringsearch_torch import oracle

    # periodic text: the initial sort leaves most suffixes tied, so full
    # rounds run before the compaction levels take over
    data = (b"abcab" * 200)
    text = np.frombuffer(data, dtype=np.uint8)
    sa = doubling.build_sa(text, depth=12, device="cpu", chunk=chunk)
    assert counted["pack_keys"] == 1
    assert counted["shift_planes"] >= 1
    # one head_ranks after the initial sort and after every full round
    assert counted["head_ranks"] == counted["shift_planes"] + 1
    if chunk is None:
        np.testing.assert_array_equal(_np(sa), oracle.build(data))
    else:
        for p in range(len(data) // chunk):
            part = data[p * chunk:(p + 1) * chunk]
            np.testing.assert_array_equal(
                _np(sa)[p * chunk:(p + 1) * chunk] - p * chunk,
                oracle.build(part))


def test_build_ints_with_isa_goes_through_the_steps(counted):
    from stringsearch_torch import oracle

    seq = np.random.default_rng(8).integers(0, 3, 3000)
    sa, _ = doubling.build_ints_with_isa(seq, device="cpu")
    assert counted["pack_keys"] == 0
    assert counted["shift_planes"] >= 1
    # the initial sort and every full round: one of each
    assert counted["head_ranks"] == counted["shift_planes"]
    want = oracle.build(seq.astype(np.uint8).tobytes())
    np.testing.assert_array_equal(_np(sa), want)


# ---------------------------------------------------------------------------
# the kernels on the card, against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    steps.load_library()
    return torch.device("cuda")


def _edge_sizes(tile: int) -> list:
    return [1, 2, 3, tile - 1, tile, tile + 1, (1 << 20) + 12345]


def _chunks(n: int) -> list:
    """None, 4 and the divisor of n nearest 1000, where they divide n and
    are below it."""
    out = [None]
    if n % 4 == 0 and n > 4:
        out.append(4)
    divisors = [d for d in range(1, min(n, 5000)) if n % d == 0]
    if divisors:
        near = min(divisors, key=lambda d: abs(d - 1000))
        if near not in out:
            out.append(near)
    return out


def _equal_planes(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("depth", [4, 12, 24])
@pytest.mark.parametrize("n", _edge_sizes(steps.PACK_TILE) + [4096, 4000])
def test_pack_keys_kernel_equals_plain(cuda, n, depth, idx):
    for kind in ("random", "zeros"):
        text = torch.from_numpy(_text(kind, n)).to(cuda)
        for chunk in _chunks(n):
            before = steps.launches["pack_keys"]
            got = steps.pack_keys(text, depth, chunk, idx)
            torch.cuda.synchronize()
            assert steps.launches["pack_keys"] == before + 1
            _equal_planes(got, steps.plain_pack_keys(text, depth, chunk, idx))


@pytest.mark.cuda
def test_pack_keys_kernel_on_an_unaligned_text(cuda):
    base = torch.from_numpy(_text("random", 5001)).to(cuda)
    for off in (1, 2, 3):
        text = base[off:off + 4000]
        _equal_planes(steps.pack_keys(text, 12, 1000),
                      steps.plain_pack_keys(text, 12, 1000))


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("fan", [2, 3, 4])
@pytest.mark.parametrize("n", _edge_sizes(steps.SHIFT_TILE) + [4000])
def test_shift_planes_kernel_equals_plain(cuda, n, fan, idx):
    rank = torch.randint(-5, 1 << 20, (n,), dtype=idx,
                         generator=torch.Generator().manual_seed(n)).to(cuda)
    for chunk in _chunks(n):
        c = steps.chunk_len(n, chunk)
        for h in (1, 12, c, c + 5, 3 * c):
            shifts = [min(h, c // k + 1) * k for k in range(1, fan)]
            before = steps.launches["shift_planes"]
            got = steps.shift_planes(rank, shifts, chunk)
            torch.cuda.synchronize()
            assert steps.launches["shift_planes"] == before + 1
            _equal_planes(got, steps.plain_shift_planes(rank, shifts, chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 6, 9, 20])
def test_shift_planes_kernel_many_shifts(cuda, depth):
    """build_ints_with_isa's shifts 1..depth-1, past one launch's eight."""
    rank = torch.arange(3000, dtype=torch.int32, device=cuda) % 17
    shifts = range(1, depth)
    before = steps.launches["shift_planes"]
    got = steps.shift_planes(rank, shifts)
    assert steps.launches["shift_planes"] == before + max(
        1, -(-(depth - 1) // 8))
    _equal_planes(got, steps.plain_shift_planes(rank, shifts))


def _head_cases(n: int, idx, cuda) -> dict:
    g = torch.Generator().manual_seed(n)
    j = torch.arange(n, dtype=idx)
    rand = torch.sort(torch.randint(0, max(n // 3, 1), (n,), generator=g))[0]
    cases = {
        "random": [rand.to(torch.int32), torch.randint(0, 3, (n,),
                                                       generator=g)
                   .to(idx)],
        "all equal": [torch.full((n,), 7, dtype=torch.int32)] * 3,
        "all distinct": [j.clone()],
        "tile starts": [(j // steps.SCAN_TILE).to(torch.int32)],
        "no key planes": [],
    }
    return {name: [p.to(cuda) for p in keys] + [
        torch.randperm(n, generator=g).to(idx).to(cuda)]
        for name, keys in cases.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", _edge_sizes(steps.SCAN_TILE) + [
    8 * steps.SCAN_TILE + 5])
def test_head_ranks_kernel_equals_plain(cuda, n, idx):
    for name, out in _head_cases(n, idx, cuda).items():
        before = steps.launches["head_ranks"]
        sa_s, rank_s, count = steps.head_ranks(out)
        torch.cuda.synchronize()
        assert steps.launches["head_ranks"] == before + 1, name
        want = steps.plain_head_ranks(out)
        assert sa_s is out[-1]
        _equal_planes([rank_s], [want[1]])
        assert count.device.type == "cuda" and count.dtype == torch.int64
        assert int(count) == int(want[2]), name


@pytest.mark.cuda
def test_head_ranks_kernel_on_long_tied_runs(cuda):
    """All-equal keys over 2^24 slots (the longest look-back), and runs
    that end only at every 64th tile."""
    n = 1 << 24
    for keys in ([torch.zeros(n, dtype=torch.int32, device=cuda)],
                 [torch.arange(n, device=cuda) // (64 * steps.SCAN_TILE)]):
        out = keys + [torch.arange(n, dtype=torch.int32, device=cuda)]
        sa_s, rank_s, count = steps.head_ranks(out)
        want = steps.plain_head_ranks(out)
        assert torch.equal(rank_s, want[1]) and int(count) == int(want[2])


@pytest.mark.cuda
def test_steps_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        steps.pack_keys(torch.zeros(8, dtype=torch.int32, device=cuda), 12)
    with pytest.raises(TypeError):
        steps.shift_planes(torch.zeros(8, device=cuda), [1])
    with pytest.raises(TypeError):
        steps.head_ranks([torch.zeros(8, device=cuda),
                          torch.zeros(8, dtype=torch.int32, device=cuda)])
    with pytest.raises(ValueError):
        steps.head_ranks([torch.zeros(8, dtype=torch.int32, device=cuda)]
                         * 66)
    with pytest.raises(ValueError):
        steps.pack_keys(torch.zeros(8, dtype=torch.uint8, device=cuda),
                        4 * 4097)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 1000])
def test_builds_on_the_card_launch_the_three_kernels(cuda, chunk):
    text = _text("random", 4000)
    # a run over most of the text: more than n/4 suffixes stay tied after
    # the initial sort, so the build runs a full round
    text[500:3500] = 0x61
    before = dict(steps.launches)
    sa = doubling.build_sa(text, depth=12, device=cuda, chunk=chunk)
    got = {k: steps.launches[k] - before[k] for k in before}
    assert got["pack_keys"] == 1
    assert got["shift_planes"] >= 1
    assert got["head_ranks"] == got["shift_planes"] + 1
    want = doubling.build_sa(text, depth=12, device="cpu", chunk=chunk)
    assert torch.equal(sa.cpu(), want)
    before = steps.launches["head_ranks"]
    seq = np.random.default_rng(8).integers(0, 3, 3000)
    sa, isa = doubling.build_ints_with_isa(seq, device=cuda)
    assert steps.launches["head_ranks"] > before
    want = doubling.build_ints_with_isa(seq, device="cpu")
    assert torch.equal(sa.cpu(), want[0]) and torch.equal(isa.cpu(), want[1])
