"""The global build's merge-split and head ranking (`ops/merge.py`,
`ops/steps.py:shard_head_ranks`).

`plain_merge_split` against the JAX package's `_merge_halves`
(stringsearch_tpu/parallel/distsort.py:45), called eagerly with concrete
bools, on the same numpy runs: C = 1..6 planes of int32, int64 or both,
every `keep_low` x `mine_first`, L = 1, 2, 3, 1000, 4097, on unique key
tuples (where `lax.sort`'s instability cannot show). On tied keys it is
held element for element against a stable sort of the concatenation
(numpy's `lexsort`), which is what the port ran before, and against the
JAX output as a multiset of each half. Every width a caller of
`sharded_sort` passes goes through it too. `_sorted_head_ranks` (the
global build's head ranking, one `shard_head_ranks` a shard) is held
against the JAX `_headslot_ranks_from_sorted` inside `shard_map` on the
8-device CPU mesh, at P = 2, 4 and 8, both fills, int32 and int64.
Everything compared is an integer: tolerance 0.

Tests marked `cuda` hold the kernels against their plain versions on the
card and skip without one; run them with
`python -m pytest --noconftest -m cuda tests/test_torch_merge.py` (this file
imports jax only inside the tests that compare with it).
"""

import numpy as np
import pytest
import torch

from stringsearch_torch.ops import merge, steps
from stringsearch_torch.parallel import distsort, global_sa
from stringsearch_torch.parallel.distsort import sharded_sort

SIZES = (1, 2, 3, 1000, 4097)
BOOLS = [(mine_first, keep_low) for mine_first in (True, False)
         for keep_low in (True, False)]
I32, I64 = np.int32, np.int64


def _dtypes(c: int, kind: str) -> list:
    if kind == "mixed":
        return [I64 if i % 2 else I32 for i in range(c)]
    return [I64 if kind == "int64" else I32] * c


def _spread(rng, values: np.ndarray, dtype) -> np.ndarray:
    """Distinct `values` (0..m) onto the dtype's range, signs and the high
    word of an int64 included, order kept."""
    if dtype == I64:
        return (values.astype(np.int64) * ((1 << 33) + 7) - (1 << 45))
    return (values.astype(np.int64) * 3 - (1 << 20)).astype(np.int32)


def _rows(rng, n: int, dtypes: list, num_keys: int, unique: bool) -> list:
    """n rows of planes: keys before plane `num_keys - 1` from a small range,
    that one distinct per row where `unique`, the rest random."""
    planes = []
    for i, dt in enumerate(dtypes):
        if i < num_keys - 1 or (i == num_keys - 1 and not unique):
            v = _spread(rng, rng.integers(0, 3, n), dt)
        elif i == num_keys - 1:
            v = _spread(rng, rng.permutation(n), dt)
        else:
            info = np.iinfo(dt)
            v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        planes.append(np.asarray(v, dtype=dt))
    return planes


def _sorted(planes: list, num_keys: int) -> list:
    order = np.lexsort(tuple(reversed(planes[:num_keys])), axis=0)
    return [p[order] for p in planes]


def _runs(rng, length: int, dtypes: list, num_keys: int,
          unique: bool = True) -> tuple:
    """Two sorted runs of `length` rows, cut from one set of 2L rows."""
    rows = _rows(rng, 2 * length, dtypes, num_keys, unique)
    pick = rng.permutation(2 * length)
    a = _sorted([p[pick[:length]] for p in rows], num_keys)
    b = _sorted([p[pick[length:]] for p in rows], num_keys)
    return a, b


def _stable_half(a, b, mine_first, keep_low, num_keys) -> list:
    """The kept half of a stable sort of the concatenation (the first run
    first): the port's route before the merge kernel."""
    cat = [np.concatenate([x, y] if mine_first else [y, x])
           for x, y in zip(a, b)]
    merged = _sorted(cat, num_keys)
    length = a[0].shape[0]
    return [m[:length] if keep_low else m[length:] for m in merged]


def _port(a, b, mine_first, keep_low, num_keys, fn=None) -> list:
    fn = fn or merge.plain_merge_split
    out = fn(tuple(torch.from_numpy(x.copy()) for x in a),
             tuple(torch.from_numpy(x.copy()) for x in b),
             mine_first, keep_low, num_keys)
    return [o.numpy() for o in out]


def _jax(a, b, mine_first, keep_low, num_keys) -> list:
    import jax
    import jax.numpy as jnp

    from stringsearch_tpu.parallel.distsort import _merge_halves

    with jax.enable_x64(any(x.dtype == I64 for x in a)):
        out = _merge_halves(tuple(map(jnp.asarray, a)),
                            tuple(map(jnp.asarray, b)),
                            jnp.asarray(mine_first), jnp.asarray(keep_low),
                            num_keys)
        return [np.asarray(o) for o in out]


def _rows_sorted(planes: list) -> np.ndarray:
    """The rows of `planes` as a sorted list of tuples (a multiset)."""
    return sorted(zip(*(p.tolist() for p in planes)))


def _assert_planes_equal(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# plain_merge_split against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("length", SIZES)
@pytest.mark.parametrize("kind", ["int32", "int64", "mixed"])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 6])
def test_plain_merge_split_equals_jax_on_unique_keys(c, kind, length):
    rng = np.random.default_rng(100 * c + length)
    dtypes = _dtypes(c, kind)
    for num_keys in sorted({1, c}):
        a, b = _runs(rng, length, dtypes, num_keys)
        for mine_first, keep_low in BOOLS:
            got = _port(a, b, mine_first, keep_low, num_keys)
            _assert_planes_equal(got, _jax(a, b, mine_first, keep_low,
                                           num_keys))
            _assert_planes_equal(got, _stable_half(a, b, mine_first,
                                                   keep_low, num_keys))


def _tie_case(name: str, length: int, dtypes: list, rng) -> tuple:
    """Two sorted runs of tied keys (two key planes): every key equal, one
    run wholly below the other, interleaved runs, and one tie group that
    straddles the split. The value plane numbers the rows."""
    half = length // 2
    if name == "all equal":
        ka = kb = np.full(length, 5)
    elif name == "one run below":
        ka, kb = np.full(length, 1), np.full(length, 9)
    elif name == "interleaved":
        ka = np.sort(rng.integers(0, 4, length))
        kb = np.sort(rng.integers(0, 4, length))
    elif name == "straddling":
        ka = np.r_[np.zeros(half, int), np.full(length - half, 5)]
        kb = np.r_[np.full(half, 5), np.full(length - half, 9)]
    else:
        raise AssertionError(name)
    runs = []
    for k, base in ((ka, 0), (kb, length)):
        planes = [_spread(rng, k, dtypes[0]),
                  _spread(rng, k // 2, dtypes[1]),
                  (base + np.arange(length)).astype(dtypes[2])]
        runs.append(planes)
    return runs[0], runs[1]


TIES = ("all equal", "one run below", "interleaved", "straddling")


@pytest.mark.parametrize("length", SIZES)
@pytest.mark.parametrize("kind", ["int32", "int64", "mixed"])
@pytest.mark.parametrize("case", TIES)
def test_plain_merge_split_on_tied_keys(case, kind, length):
    """Element for element against the stable sort of the concatenation;
    against JAX as a multiset of each half; the two partners' halves make
    the whole merge."""
    rng = np.random.default_rng(length)
    a, b = _tie_case(case, length, _dtypes(3, kind), rng)
    for num_keys in (1, 2):
        for mine_first, keep_low in BOOLS:
            got = _port(a, b, mine_first, keep_low, num_keys)
            _assert_planes_equal(got, _stable_half(a, b, mine_first,
                                                   keep_low, num_keys))
            assert _rows_sorted(got) == _rows_sorted(
                _jax(a, b, mine_first, keep_low, num_keys))
        # shard a keeps the low half, its partner b the high half, each
        # passing its own run first
        low = _port(a, b, True, True, num_keys)
        high = _port(b, a, False, False, num_keys)
        _assert_planes_equal(
            [np.concatenate([x, y]) for x, y in zip(low, high)],
            _sorted([np.concatenate([x, y]) for x, y in zip(a, b)],
                    num_keys))


def _caller_widths() -> dict:
    """(dtypes, num_keys) of every `sharded_sort` in the package, by
    caller, for int32 and int64 indexes."""
    out = {}
    for name, idx in (("int32", I32), ("int64", I64)):
        for depth in (4, 8, 16, 64):  # `_initial_shard_ranks`
            out[f"initial depth {depth}, {name}"] = (
                [I32] * (depth // 4) + [idx], depth // 4)
        # `_verify_shard`: (rank, first byte, next rank, position) by rank
        out[f"verify, {name}"] = ([idx] * 4, 1)
        # `redistribute_permutation`'s fallback: (gidx, rank_s) by gidx
        out[f"redistribute fallback, {name}"] = ([idx] * 2, 1)
        for fan in (2, 3, 4, 7):  # `rank_interval_sort`'s fallback
            out[f"round fallback fan {fan}, {name}"] = (
                [idx] * (fan + 1), fan + 1)
    return out


CALLER_WIDTHS = _caller_widths()


@pytest.mark.parametrize("width", sorted(CALLER_WIDTHS))
def test_every_caller_width(width):
    dtypes, num_keys = CALLER_WIDTHS[width]
    rng = np.random.default_rng(len(dtypes) * 10 + num_keys)
    a, b = _runs(rng, 777, dtypes, num_keys, unique=False)
    for mine_first, keep_low in BOOLS:
        _assert_planes_equal(
            _port(a, b, mine_first, keep_low, num_keys),
            _stable_half(a, b, mine_first, keep_low, num_keys))
    planes = [torch.from_numpy(x) for x in a]
    assert merge.check_width(planes, num_keys) <= merge.MAX_KEY_WORDS


def test_check_width_refuses_past_the_kernel():
    one = torch.zeros(4, dtype=torch.int64)
    assert merge.check_width([one] * 32, 32) == 64
    with pytest.raises(ValueError, match="key words"):
        merge.check_width([one] * 33, 33)
    with pytest.raises(ValueError, match="planes"):
        merge.check_width([one] * (merge.MAX_PLANES + 1), 1)


@pytest.mark.parametrize("mine,theirs,num_keys,error", [
    ([torch.zeros(4)], [torch.zeros(4)], 1, TypeError),
    ([torch.zeros(4, dtype=torch.int32)], [torch.zeros(4, dtype=torch.int64)],
     1, TypeError),
    ([torch.zeros(4, dtype=torch.int32)], [torch.zeros(5, dtype=torch.int32)],
     1, ValueError),
    ([torch.zeros(4, dtype=torch.int32)] * 2,
     [torch.zeros(4, dtype=torch.int32)], 1, ValueError),
    ([torch.zeros(4, dtype=torch.int32)], [torch.zeros(4, dtype=torch.int32)],
     2, ValueError),
    ([torch.zeros(4, dtype=torch.int32)], [torch.zeros(4, dtype=torch.int32)],
     0, ValueError),
    ([torch.zeros((2, 2), dtype=torch.int32)],
     [torch.zeros((2, 2), dtype=torch.int32)], 1, TypeError),
])
@pytest.mark.parametrize("fn", [merge.merge_split, merge.plain_merge_split])
def test_merge_split_refuses_what_it_does_not_take(fn, mine, theirs, num_keys,
                                                    error):
    with pytest.raises(error):
        fn(mine, theirs, True, True, num_keys)


def test_merge_split_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(5)
    a, b = _runs(rng, 300, [I32, I64, I32], 2, unique=False)
    before = merge.launches
    for mine_first, keep_low in BOOLS:
        _assert_planes_equal(
            _port(a, b, mine_first, keep_low, 2, merge.merge_split),
            _port(a, b, mine_first, keep_low, 2))
    assert merge.launches == before


# ---------------------------------------------------------------------------
# routing: every merge of sharded_sort goes through merge_split
# ---------------------------------------------------------------------------


@pytest.fixture
def merges(monkeypatch):
    """Counts the calls of `merge_split` made through `distsort`."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[0][0].shape[0])
        return merge.merge_split(*args, **kwargs)

    monkeypatch.setattr(distsort, "merge_split", counted)
    return calls


@pytest.mark.parametrize("p", [2, 4, 8])
def test_sharded_sort_merges_through_merge_split(merges, p):
    rng = np.random.default_rng(p)
    length = 40
    keys = rng.integers(0, 5, p * length).astype(np.int32)
    vals = np.arange(p * length, dtype=np.int32)
    out = sharded_sort(tuple([torch.from_numpy(c.copy())
                              for c in np.split(x, p)] for x in (keys, vals)),
                       2)
    got = [torch.cat(o).numpy() for o in out]
    order = np.lexsort((vals, keys))
    np.testing.assert_array_equal(got[0], keys[order])
    np.testing.assert_array_equal(got[1], vals[order])
    log = p.bit_length() - 1
    # every shard merges once a stage, S(P) = log (log + 1) / 2 stages
    assert merges == [length] * (p * log * (log + 1) // 2)


def test_plain_version_is_reached_only_from_the_cpu(monkeypatch):
    """`merge_split` and `shard_head_ranks` take their plain versions only
    for CPU tensors; any other device goes to the kernel's branch (here a
    device that is neither, which `ops/_build.py:on_cuda` refuses)."""
    def refused(*args, **kwargs):
        raise AssertionError("the plain version was called")

    monkeypatch.setattr(merge, "plain_merge_split", refused)
    monkeypatch.setattr(steps, "plain_shard_head_ranks", refused)
    for device in ("meta", "cpu"):
        planes = [torch.zeros(8, dtype=torch.int32, device=device)]
        for call in (lambda: merge.merge_split(planes, planes, True, True, 1),
                     lambda: steps.shard_head_ranks(planes, None, 0,
                                                    torch.int32)):
            if device == "meta":
                with pytest.raises(ValueError, match="must lie on the CPU "
                                   "or a CUDA device, got meta"):
                    call()
            else:
                with pytest.raises(AssertionError, match="plain version"):
                    call()


def test_global_build_goes_through_both_new_steps(merges, monkeypatch):
    from stringsearch_torch import oracle
    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_torch.parallel.mesh import make_mesh

    heads = []

    def counted(*args, **kwargs):
        heads.append(args[2])
        return steps.shard_head_ranks(*args, **kwargs)

    monkeypatch.setattr(global_sa, "shard_head_ranks", counted)
    text = enwik_like(4000, seed=2)
    g = global_sa.build_global(text, make_mesh(
        devices=[torch.device("cpu")] * 4))
    np.testing.assert_array_equal(g.suffix_array(), oracle.build(text))
    # the initial sort's three stages of four merges, at least
    assert len(merges) >= 12 and merges[:12] == [1000] * 12
    # one a shard after every full-width sort, at its first global slot
    assert heads and len(heads) % 4 == 0
    assert heads[:4] == [0, 1000, 2000, 3000]


# ---------------------------------------------------------------------------
# the sharded head ranking against the JAX package
# ---------------------------------------------------------------------------


def _sorted_keys(rng, n: int, planes: int, dtype, first_zero: bool) -> list:
    """`planes` key planes of n rows in sorted order, with long and short
    tie groups; the first row all zeros where `first_zero` (the fill 0
    collides with it)."""
    keys = [rng.integers(0, 3, n) for _ in range(planes - 1)]
    keys.append(np.repeat(rng.integers(0, 50, n // 7 + 1), 7)[:n])
    keys = _sorted([k.astype(dtype) for k in keys], planes)
    if first_zero:
        for k in keys:
            k[:3] = 0
        keys = _sorted(keys, planes)
    return keys


def _jax_head_ranks(keys: list, p: int, fill: int, first_head: bool, idx):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from stringsearch_tpu.parallel.distsort import shift_in_from_prev
    from stringsearch_tpu.parallel.global_sa import (
        _headslot_ranks_from_sorted)

    length = keys[0].shape[0] // p

    def body(*ks):
        me = jax.lax.axis_index("parts")
        prev = shift_in_from_prev(jnp.stack([k[-1] for k in ks]), "parts",
                                  fill)
        eq = jnp.ones((length,), bool)
        for i, k in enumerate(ks):
            eq = eq & (k == jnp.concatenate([prev[i:i + 1], k[:-1]]))
        if first_head:
            eq = eq & ~((me == 0) & (jnp.arange(length) == 0))
        rank, count = _headslot_ranks_from_sorted(
            eq, jnp.int64 if idx == I64 else jnp.int32)
        return rank, count[None]

    mesh = Mesh(np.array(jax.devices("cpu")[:p]), ("parts",))
    with jax.enable_x64(idx == I64):
        f = jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=tuple(P("parts") for _ in keys),
            out_specs=(P("parts"), P("parts")), check_vma=False))
        rank, count = f(*map(jnp.asarray, keys))
        return np.asarray(rank), np.asarray(count)


@pytest.mark.parametrize("idx", [I32, I64])
@pytest.mark.parametrize("fill,first_head", [(0, True), (-2, False)])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_sorted_head_ranks_equal_jax(p, fill, first_head, idx):
    """The initial sort's call (fill 0, the global first element a head)
    and a round's (fill -2): every shard's rank_s and the replicated count,
    bit for bit."""
    rng = np.random.default_rng(p * 7 + fill)
    n = p * 96
    planes = 4 if first_head else 3
    keys = _sorted_keys(rng, n, planes, I32 if first_head else idx,
                        first_zero=first_head)
    if not first_head:
        keys[0] = np.abs(keys[0])  # a round's first key is a rank, >= 0
        keys = _sorted(keys, planes)
    dtype = torch.int64 if idx == I64 else torch.int32
    rank, count = global_sa._sorted_head_ranks(
        [[torch.from_numpy(c.copy()) for c in np.split(k, p)] for k in keys],
        fill, dtype, first_head)
    jrank, jcount = _jax_head_ranks(keys, p, fill, first_head, idx)
    got = torch.cat(rank).numpy()
    assert got.dtype == jrank.dtype
    np.testing.assert_array_equal(got, jrank)
    assert all(c.dtype == torch.int32 for c in count)
    assert [int(c) for c in count] == [int(jcount[0])] * p
    assert int(jcount[0]) > 0


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_shard_head_ranks_on_a_headless_shard(idx):
    """A shard wholly inside one group: every head -1, every slot tied."""
    keys = [torch.full((50,), 3, dtype=torch.int32)]
    heads, count = steps.shard_head_ranks(
        keys, torch.tensor([3], dtype=torch.int32), 100, idx)
    assert heads.dtype == idx and bool((heads == -1).all())
    assert int(count) == 50
    heads, count = steps.shard_head_ranks(keys, None, 100, idx)
    assert bool((heads == 100).all()) and int(count) == 50


def test_shard_head_ranks_refuses_bad_input():
    good = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        steps.shard_head_ranks([], None, 0, torch.int32)
    with pytest.raises(ValueError):
        steps.shard_head_ranks([good], torch.zeros(2, dtype=torch.int64), 0,
                               torch.int32)
    with pytest.raises(TypeError):
        steps.shard_head_ranks([good], None, 0, torch.float32)
    with pytest.raises(ValueError):
        steps.shard_head_ranks([good], None, -1, torch.int32)


# ---------------------------------------------------------------------------
# the kernels on the card, against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    merge.load_library()
    steps.load_library()
    return torch.device("cuda")


def _on(planes, device) -> tuple:
    return tuple(torch.from_numpy(x.copy()).to(device) for x in planes)


def _kernel_equals_plain(a, b, num_keys, cuda) -> None:
    ca, cb = _on(a, cuda), _on(b, cuda)
    for mine_first, keep_low in BOOLS:
        before = merge.launches
        got = merge.merge_split(ca, cb, mine_first, keep_low, num_keys)
        torch.cuda.synchronize()
        assert merge.launches == before + 1
        want = merge.plain_merge_split(ca, cb, mine_first, keep_low,
                                       num_keys)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g, w)


# around the tile of 8 outputs a thread (2048), and past a few tiles
CUDA_SIZES = (1, 2, 3, 2047, 2048, 2049, (1 << 20) + 12345)


@pytest.mark.cuda
@pytest.mark.parametrize("length", CUDA_SIZES)
@pytest.mark.parametrize("kind", ["int32", "int64", "mixed"])
@pytest.mark.parametrize("c", [1, 3, 5, 6])
def test_merge_split_kernel_equals_plain(cuda, c, kind, length):
    rng = np.random.default_rng(c * length)
    dtypes = _dtypes(c, kind)
    for num_keys in sorted({1, max(c - 1, 1), c}):
        for unique in (True, False):
            a, b = _runs(rng, length, dtypes, num_keys, unique)
            _kernel_equals_plain(a, b, num_keys, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("length", [1, 2, 3, 2049, 1 << 20])
@pytest.mark.parametrize("case", TIES)
def test_merge_split_kernel_on_tied_keys(cuda, case, length):
    rng = np.random.default_rng(length)
    for kind in ("int32", "int64", "mixed"):
        a, b = _tie_case(case, length, _dtypes(3, kind), rng)
        for num_keys in (1, 2, 3):
            _kernel_equals_plain(a, b, num_keys, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("width", sorted(CALLER_WIDTHS))
def test_merge_split_kernel_every_caller_width(cuda, width):
    dtypes, num_keys = CALLER_WIDTHS[width]
    rng = np.random.default_rng(len(dtypes))
    for length in (5000, 3 * 2048 + 7):
        a, b = _runs(rng, length, dtypes, num_keys, unique=False)
        _kernel_equals_plain(a, b, num_keys, cuda)


@pytest.mark.cuda
def test_merge_split_kernel_at_its_limits(cuda):
    rng = np.random.default_rng(64)
    a, b = _runs(rng, 3000, [I64] * 32 + [I32] * 32, 32, unique=False)
    _kernel_equals_plain(a, b, 32, cuda)
    with pytest.raises(ValueError, match="key words"):
        x = tuple(torch.zeros(8, dtype=torch.int64, device=cuda)
                  for _ in range(33))
        merge.merge_split(x, x, True, True, 33)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4, 8])
def test_sharded_sort_on_the_card_never_takes_the_plain_version(
        cuda, monkeypatch, p):
    def refused(*args, **kwargs):
        raise AssertionError("the plain version was called on the card")

    monkeypatch.setattr(merge, "plain_merge_split", refused)
    rng = np.random.default_rng(p)
    n = p * 5000
    keys = rng.integers(0, 50, n).astype(np.int32)
    vals = np.arange(n, dtype=np.int64)
    before = merge.launches
    out = sharded_sort(tuple([torch.from_numpy(c.copy()).to(cuda)
                              for c in np.split(x, p)] for x in (keys, vals)),
                       1)
    log = p.bit_length() - 1
    assert merge.launches - before == p * log * (log + 1) // 2
    got = [torch.cat(o).cpu().numpy() for o in out]
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got[0], keys[order])
    np.testing.assert_array_equal(np.sort(got[1]), vals)
    np.testing.assert_array_equal(keys[got[1]], got[0])


def _shard_cases(n: int, idx, cuda) -> dict:
    g = torch.Generator().manual_seed(n)
    rand = torch.sort(torch.randint(0, max(n // 3, 1), (n,), generator=g))[0]
    j = torch.arange(n)
    cases = {
        "random": [rand.to(idx), (torch.randint(0, 2, (n,), generator=g)
                                  .to(torch.int32))],
        "all equal": [torch.full((n,), 7, dtype=idx)] * 2,
        "all distinct": [j.to(idx)],
        "tile starts": [(j // steps.SCAN_TILE).to(torch.int32)],
    }
    return {name: [k.to(cuda) for k in keys] for name, keys in cases.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("n", [1, 2, 3, steps.SCAN_TILE - 1, steps.SCAN_TILE,
                               steps.SCAN_TILE + 1, 8 * steps.SCAN_TILE + 5,
                               (1 << 20) + 12345])
def test_shard_head_ranks_kernel_equals_plain(cuda, n, idx):
    for name, keys in _shard_cases(n, idx, cuda).items():
        first = torch.stack([k[0].to(torch.int64) for k in keys])
        for prev in (None, first, first - 1, first + 1):
            for offset in (0, 3 * n):
                before = steps.launches["shard_head_ranks"]
                got = steps.shard_head_ranks(keys, prev, offset, idx)
                torch.cuda.synchronize()
                assert steps.launches["shard_head_ranks"] == before + 1
                want = steps.plain_shard_head_ranks(keys, prev, offset, idx)
                assert got[0].dtype == idx and torch.equal(got[0], want[0]), \
                    name
                assert got[1].dtype == torch.int64
                assert int(got[1]) == int(want[1]), name


@pytest.mark.cuda
def test_shard_head_ranks_kernel_on_a_long_headless_prefix(cuda):
    """2^24 slots that all continue the previous shard's group: the
    look-back from tile 0 on finds no head."""
    n = 1 << 24
    keys = [torch.zeros(n, dtype=torch.int32, device=cuda)]
    prev = torch.zeros(1, dtype=torch.int64, device=cuda)
    for tail in (None, n - 5):
        if tail is not None:
            keys[0][tail:] = 1
        got = steps.shard_head_ranks(keys, prev, 7 * n, torch.int32)
        want = steps.plain_shard_head_ranks(keys, prev, 7 * n, torch.int32)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_global_build_on_the_card_launches_both_kernels(cuda, p, idx):
    from stringsearch_torch import oracle
    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_torch.parallel.mesh import make_mesh

    text = enwik_like(1 << 16, seed=p)
    before = merge.launches, steps.launches["shard_head_ranks"]
    g = global_sa.build_global(text, make_mesh(devices=[cuda] * p), idx=idx)
    assert merge.launches > before[0]
    assert steps.launches["shard_head_ranks"] > before[1]
    np.testing.assert_array_equal(g.suffix_array(), oracle.build(text))
    want = global_sa.build_global(
        text, make_mesh(devices=[torch.device("cpu")] * p), idx=idx)
    for a, b in zip(g.rank, want.rank):
        assert torch.equal(a.cpu(), b)
