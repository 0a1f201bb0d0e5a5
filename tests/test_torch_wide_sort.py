"""`wide_sort`: `device_sort` over any number of int32 and int64 planes.

One launch of the radix sort takes at most six int32 planes. `wide_sort`
composes such sorts (a stable LSD over groups of five key planes, the
permutation the sixth) and is held here against `plain_sort`, the chained
`torch.sort`, element for element on every plane (tolerance 0), with a
`narrow` sort that is `plain_sort` limited to what one launch takes. The
guard at the end runs every engine with `device_sort`'s CPU route sent
through that limit, so a sort wider than the kernel takes shows up here
and not first on the card. Tests that launch the kernel are marked `cuda`
and skip without a card; on a machine with one, run them with
`python -m pytest --noconftest -m cuda tests/test_torch_wide_sort.py`.
"""

import math

import numpy as np
import pytest
import torch

import stringsearch_torch as st
from stringsearch_torch.engines import bstar, doubling
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.ops import bitonic, radix_sort
from stringsearch_torch.transforms.bwt import bwt, unbwt

I64 = np.iinfo(np.int64)
_PLAIN = bitonic.plain_sort


class SixPlanes:
    """`plain_sort` limited to what one radix sort launch takes: at most
    six int32 planes. Keeps the plane count of every call."""

    def __init__(self):
        self.calls = []

    def __call__(self, operands, num_keys):
        operands = tuple(operands)
        self.calls.append(len(operands))
        if len(operands) > 6:
            raise ValueError(f"{len(operands)} planes in one sort")
        if any(op.dtype != torch.int32 for op in operands):
            raise TypeError("a launch takes int32 planes only")
        return _PLAIN(operands, num_keys)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _planes(rng, n, dtypes, num_keys):
    """Key planes of heavy ties and both ends of their range, payloads
    that are permutations."""
    out = []
    for i, dt in enumerate(dtypes):
        info = np.iinfo(dt)
        if i < num_keys:
            ends = np.array([info.min, info.min + 1, -1, 0, 1, 1 << 31,
                             (1 << 31) - 1, info.max - 1, info.max],
                            dtype=np.int64)
            ends = ends[(ends >= info.min) & (ends <= info.max)].astype(dt)
            a = rng.integers(-2, 3, n).astype(dt)
            pick = rng.random(n) < 0.3
            a[pick] = rng.choice(ends, int(pick.sum()))
        else:
            a = rng.permutation(n).astype(dt)
        out.append(torch.from_numpy(a))
    return out


def _key_planes(dtypes, num_keys) -> int:
    """int32 key planes of a sort: an int64 key counts twice."""
    return sum(2 if dt == np.int64 else 1 for dt in dtypes[:num_keys])


# (dtypes, num_keys): bstar's widths (7, 11, 19, 35 planes), the hop sort
# (10), depth 24 (7), and int64 keys and payloads
SHAPES = [
    ([np.int32] * 7, 6), ([np.int32] * 7, 7), ([np.int32] * 10, 8),
    ([np.int32] * 11, 10), ([np.int32] * 19, 18), ([np.int32] * 35, 34),
    ([np.int32] * 35, 1), ([np.int64, np.int64], 1),
    ([np.int64, np.int32, np.int64], 2), ([np.int32] * 3 + [np.int64], 3),
    ([np.int64] * 5, 4), ([np.int32, np.int64] * 3, 6),
]


@pytest.mark.parametrize("n", [0, 1, 2, 1000])
@pytest.mark.parametrize("dtypes,num_keys", SHAPES)
def test_wide_sort_equals_plain_sort(dtypes, num_keys, n):
    rng = np.random.default_rng(len(dtypes) * 100 + num_keys + n)
    ops = _planes(rng, n, dtypes, num_keys)
    narrow = SixPlanes()
    got = bitonic.wide_sort(ops, num_keys, narrow)
    want = _PLAIN(ops, num_keys)
    assert len(got) == len(ops)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    assert len(narrow.calls) == math.ceil(_key_planes(dtypes, num_keys) / 5)
    assert max(narrow.calls) <= 6


def test_int64_key_words_keep_the_order():
    """High word signed, low word XOR 0x80000000: the pair of int32 words
    orders like the int64 key."""
    keys = torch.tensor([I64.min, -(1 << 32), -(1 << 31) - 1, -1, 0, 1,
                         (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
                         I64.max], dtype=torch.int64)
    hi, lo = bitonic._key_words(keys.flip(0))
    order = np.lexsort((lo.numpy(), hi.numpy()))
    assert keys.flip(0)[torch.from_numpy(order)].tolist() == keys.tolist()


def test_wide_sort_rejects_other_dtypes_and_bad_key_counts():
    k = torch.tensor([3, 1, 2], dtype=torch.int32)
    for bad in (torch.uint8, torch.int16, torch.float32):
        with pytest.raises(TypeError):
            bitonic.wide_sort((k, k.to(bad)), 1, SixPlanes())
    for num_keys in (0, 3):
        with pytest.raises(ValueError):
            bitonic.wide_sort((k, k), num_keys, SixPlanes())


def test_device_sort_routes_by_planes_and_dtype(monkeypatch):
    """Off the CPU: at most six int32 planes are one radix sort of those
    planes; more planes, or int64 planes, go through `wide_sort` in
    ceil(key planes / 5) radix sorts; never through `torch.sort`. Shown on
    tensors of the `meta` device, which carry shapes and no data."""
    calls = []

    def fake_radix_sort(ops, num_keys):
        calls.append((len(ops), num_keys))
        return tuple(torch.empty_like(op) for op in ops)

    def no_torch_sort(*a, **k):
        raise AssertionError("torch.sort on the device route")

    monkeypatch.setattr(bitonic, "radix_sort", fake_radix_sort)
    monkeypatch.setattr(torch, "sort", no_torch_sort)

    def planes(*dtypes):
        return [torch.empty((50,), dtype=dt, device="meta") for dt in dtypes]

    for dtypes, num_keys, want in [
            ((torch.int32,) * 6, 5, [(6, 5)]),
            ((torch.int32,) * 2, 1, [(2, 1)]),
            ((torch.int32,) * 7, 6, [(6, 5), (2, 1)]),
            ((torch.int32,) * 10, 8, [(6, 5), (4, 3)]),
            ((torch.int64, torch.int32), 1, [(3, 2)]),
            ((torch.int32, torch.int64), 1, [(2, 1)])]:
        calls.clear()
        out = bitonic.device_sort(planes(*dtypes), num_keys)
        assert calls == want, dtypes
        assert [o.dtype for o in out] == list(dtypes)
    with pytest.raises(TypeError):
        bitonic.device_sort(planes(torch.int32, torch.uint8), 1)
    with pytest.raises(TypeError):
        bitonic.device_sort(planes(*(torch.float32,) * 7), 1)


def test_device_sort_on_the_cpu_is_plain_sort():
    rng = np.random.default_rng(5)
    ops = _planes(rng, 500, [np.int32] * 12 + [np.int64], 11)
    for g, w in zip(bitonic.device_sort(ops, 11), _PLAIN(ops, 11)):
        assert torch.equal(g, w)


# --- the guard: every engine under six-plane sorts ------------------------


class SixPlaneRoute:
    """`device_sort`'s CPU route as its CUDA route, with the kernel's
    launch limit: at most six int32 planes go to one narrow sort, the rest
    through `wide_sort`. `wide` counts the sorts that took that way."""

    def __init__(self):
        self.narrow = SixPlanes()
        self.wide = 0

    def __call__(self, operands, num_keys=1):
        operands = tuple(operands)
        if len(operands) <= 6 and all(op.dtype == torch.int32
                                      for op in operands):
            return self.narrow(operands, num_keys)
        self.wide += 1
        return bitonic.wide_sort(operands, num_keys, self.narrow)


def _guard_cases() -> dict:
    """name -> a build returning a tuple of tensors."""
    text = np.frombuffer(enwik_like(2048, seed=3), dtype=np.uint8)
    ext = (b"a" * 200 + b"b") * 3  # reaches bstar's unbounded stage
    seq = np.random.default_rng(6).integers(-4, 4, 700).astype(np.int32)
    i64 = torch.int64

    def engine(name, data):
        return lambda: (st.get_engine(name)(data, device="cpu").sa,)

    def bwt_both_ways():
        u, pidx = bwt(text, device="cpu")
        back = np.frombuffer(unbwt(u, pidx, device="cpu"), dtype=np.uint8)
        return u, torch.tensor([pidx]), torch.from_numpy(back.copy())

    return {
        "build_sa depth 24": lambda: (doubling.build_sa(text, device="cpu"),),
        "build_sa depth 24 chunk 512": lambda: (doubling.build_sa(
            text, device="cpu", chunk=512),),
        "build_with_isa depth 24": lambda: doubling.build_with_isa(
            text, device="cpu"),
        "build_with_isa depth 24 chunk 256": lambda: doubling.build_with_isa(
            text, device="cpu", chunk=256),
        "build_ints_with_isa depth 6": lambda: doubling.build_ints_with_isa(
            seq, depth=6, device="cpu"),
        "build_with_isa int64": lambda: doubling.build_with_isa(
            text, idx=i64, depth=12, device="cpu"),
        "build_sa int64 depth 24 chunk 1024": lambda: (doubling.build_sa(
            text, idx=i64, device="cpu", chunk=1024),),
        "dc3": engine("dc3", text),
        "bstar": engine("bstar", text),
        "bstar extension stages": engine("bstar", ext),
        "bstar int64": lambda: bstar.build(text, idx=i64, device="cpu"),
        "bwt and unbwt": bwt_both_ways,
        "partitioned": lambda: (st.PartitionedSuffixArray(
            text, 4, device="cpu").sas,),
    }


# the builds with a sort wider than one launch: over six planes, or int64
WIDE = {"build_sa depth 24", "build_sa depth 24 chunk 512",
        "build_with_isa depth 24", "build_with_isa depth 24 chunk 256",
        "build_ints_with_isa depth 6", "build_with_isa int64",
        "build_sa int64 depth 24 chunk 1024", "bstar",
        "bstar extension stages", "bstar int64"}


@pytest.mark.parametrize("name", sorted(_guard_cases()))
def test_every_build_runs_on_six_plane_sorts(name, monkeypatch):
    """The engines with every sort through `wide_sort` over at most six
    int32 planes, as on the card: each result equals its plain result,
    and no narrow sort saw more than six planes."""
    fn = _guard_cases()[name]
    want = fn()
    route = SixPlaneRoute()
    monkeypatch.setattr(bitonic, "plain_sort", route)
    got = fn()
    monkeypatch.undo()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert route.narrow.calls and max(route.narrow.calls) <= 6
    assert (route.wide > 0) == (name in WIDE)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4097, 1 << 18])
@pytest.mark.parametrize("dtypes,num_keys", SHAPES)
def test_wide_sort_kernel_matches_plain(cuda, dtypes, num_keys, n):
    rng = np.random.default_rng(len(dtypes) * 10 + num_keys + n)
    ops = _planes(rng, n, dtypes, num_keys)
    before = radix_sort.launches
    got = bitonic.device_sort([op.to(cuda) for op in ops], num_keys)
    launched = radix_sort.launches - before
    for g, w in zip(got, _PLAIN(ops, num_keys)):
        assert g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)
    if len(dtypes) <= 6 and all(dt == np.int32 for dt in dtypes):
        assert launched == 1
    else:
        assert launched == math.ceil(_key_planes(dtypes, num_keys) / 5)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 1 << 14])
def test_depth_24_builds_on_the_card(cuda, chunk):
    """The default depth sorts seven planes first: it equals depth 12's SA
    and the oracle's, flat and with chunks."""
    from stringsearch_torch import oracle

    data = enwik_like(1 << 16)
    text = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())
    deep = doubling.build_sa(text, device=cuda, chunk=chunk)
    assert torch.equal(deep, doubling.build_sa(text, depth=12, device=cuda,
                                               chunk=chunk))
    if chunk is None:
        np.testing.assert_array_equal(deep.cpu().numpy(), oracle.build(data))
        sa, isa = doubling.build_with_isa(text, device=cuda)
        assert torch.equal(sa, deep)
