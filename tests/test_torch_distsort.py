"""Port of parallel/distsort.py and parallel/comm_model.py against JAX.

Counterparts of every case of tests/test_distsort.py, at P = 2, 4 and 8
shards on `[cpu] * P`, with the JAX functions run inside `shard_map` on
the 8-device CPU mesh for the same numpy inputs. Outputs are integers,
compared exactly (tolerance 0). Where the keys tie, JAX's sort and the
port's may order the payloads differently inside a tie: there the sorted
keys are compared exactly and the payloads as multisets per key, as the
JAX tests do. The comm model's byte counts are held equal to the JAX
model's and to the bytes the port's collectives moved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.parallel import collectives as coll
from stringsearch_torch.parallel import comm_model, distsort
from stringsearch_torch.parallel.distsort import (
    exclusive_shard_offset,
    rank_interval_sort,
    redistribute_cap,
    redistribute_permutation,
    sharded_sort,
    shift_in_from_prev,
)
from stringsearch_torch.parallel.global_sa import build_global
from stringsearch_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
SHARDS = [2, 4, 8]


def _jmesh(p):
    return Mesh(np.array(jax.devices("cpu")[:p]), ("parts",))


def _shards(x: np.ndarray, p: int) -> list:
    return [torch.from_numpy(c.copy()) for c in np.split(np.asarray(x), p)]


def _cat(xs) -> np.ndarray:
    return torch.cat(list(xs)).numpy()


def _jax_sort(p, arrays, num_keys):
    from stringsearch_tpu.parallel.distsort import sharded_sort as jsort

    f = jax.jit(jax.shard_map(
        lambda *ops: jsort(ops, "parts", num_keys=num_keys),
        mesh=_jmesh(p), in_specs=tuple(P("parts") for _ in arrays),
        out_specs=tuple(P("parts") for _ in arrays), check_vma=False))
    return [np.asarray(x) for x in f(*map(jnp.asarray, arrays))]


def _port_sort(p, arrays, num_keys):
    out = sharded_sort(tuple(_shards(a, p) for a in arrays), num_keys)
    return [_cat(o) for o in out]


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("hi", [2, 7, 50, 1 << 20])
def test_sharded_sort_duplicate_keys(p, hi):
    """With duplicate keys, both partners of a comparator must build the
    same merged list: the value multiset is exact."""
    rng = np.random.default_rng(hi)
    n = p * 32
    keys = rng.integers(0, hi, n).astype(np.int32)
    vals = np.arange(n, dtype=np.int32)
    ks, vs = _port_sort(p, (keys, vals), 1)
    assert np.all(np.diff(ks) >= 0)
    np.testing.assert_array_equal(ks, np.sort(keys))
    np.testing.assert_array_equal(np.sort(vs), vals)
    np.testing.assert_array_equal(keys[vs], ks)
    if p == 8:
        jks, jvs = _jax_sort(p, (keys, vals), 1)
        np.testing.assert_array_equal(ks, jks)
        for k in np.unique(ks):
            np.testing.assert_array_equal(np.sort(vs[ks == k]),
                                          np.sort(jvs[jks == k]))


@pytest.mark.parametrize("p", SHARDS)
def test_sharded_sort_two_keys_exact(p):
    rng = np.random.default_rng(3)
    n = p * 16
    k1 = rng.integers(0, 6, n).astype(np.int32)
    k2 = rng.integers(0, 6, n).astype(np.int32)
    idx = np.arange(n, dtype=np.int32)
    got = _port_sort(p, (k1, k2, idx), 3)  # idx as a key: unique tuples
    order = np.lexsort((idx, k2, k1))
    for g, a in zip(got, (k1, k2, idx)):
        np.testing.assert_array_equal(g, a[order])
    for g, w in zip(got, _jax_sort(p, (k1, k2, idx), 3)):
        np.testing.assert_array_equal(g, w)


def test_sharded_sort_needs_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        sharded_sort(([torch.zeros(4, dtype=torch.int32)] * 3,), 1)


@pytest.mark.parametrize("p", SHARDS)
def test_exclusive_offset_and_shift(p):
    from stringsearch_tpu.parallel.distsort import (
        exclusive_shard_offset as joff,
        shift_in_from_prev as jshift,
    )

    x = np.arange(p * 4, dtype=np.int32)

    def body(a):
        off = joff(jnp.sum(a), "parts")
        prev = jshift(a[-1:], "parts", -7)
        return jnp.full_like(a, off), jnp.broadcast_to(prev, a.shape)

    f = jax.jit(jax.shard_map(body, mesh=_jmesh(p), in_specs=P("parts"),
                              out_specs=(P("parts"), P("parts")),
                              check_vma=False))
    j_offs, j_prevs = map(np.asarray, f(jnp.asarray(x)))
    sh = _shards(x, p)
    offs = exclusive_shard_offset([s.sum(dtype=torch.int32) for s in sh])
    prevs = shift_in_from_prev([s[-1:] for s in sh], -7)
    np.testing.assert_array_equal([int(o) for o in offs],
                                  j_offs.reshape(p, 4)[:, 0])
    np.testing.assert_array_equal([int(v[0]) for v in prevs],
                                  j_prevs.reshape(p, 4)[:, 0])
    chunks = x.reshape(p, 4)
    np.testing.assert_array_equal(
        [int(o) for o in offs],
        np.concatenate([[0], np.cumsum(chunks.sum(1))[:-1]]))


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("skewed", [False, True])
def test_redistribute_permutation_matches_sort(p, skewed):
    """The all_to_all route equals the merge-split sort on the fast path
    (a uniform permutation) and on the fallback (an identity-like
    permutation overflows a pair's capacity), and equals JAX's."""
    from stringsearch_tpu.parallel.distsort import (
        redistribute_permutation as jredist,
    )

    length = 64
    n = p * length
    rng = np.random.default_rng(3 if skewed else 4)
    if skewed:
        perm = np.arange(n)
        perm[:length] = np.roll(perm[:length], 7)
    else:
        perm = rng.permutation(n)
    gidx = perm.astype(np.int32)
    vals = rng.integers(0, 1 << 30, n).astype(np.int32)
    distsort.fallbacks.clear()
    (got,) = redistribute_permutation(_shards(gidx, p), (_shards(vals, p),))
    assert distsort.fallbacks["redistribute"] == (1 if skewed else 0)
    want = np.empty_like(vals)
    want[gidx] = vals
    np.testing.assert_array_equal(_cat(got), want)
    np.testing.assert_array_equal(
        _cat(got), _port_sort(p, (gidx, vals), 1)[1])
    f = jax.jit(jax.shard_map(
        lambda g, v: jredist(g, (v,), "parts"), mesh=_jmesh(p),
        in_specs=(P("parts"), P("parts")), out_specs=(P("parts"),),
        check_vma=False))
    np.testing.assert_array_equal(
        _cat(got), np.asarray(f(jnp.asarray(gidx), jnp.asarray(vals))[0]))


def _head_slot_ranks(key: np.ndarray) -> np.ndarray:
    """The head-slot rank of each element: the sorted slot of the first
    element with its key."""
    srt = np.sort(key)
    return np.searchsorted(srt, key, side="left").astype(np.int32)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("case", ["spread", "giant-group", "straddle"])
def test_rank_interval_sort(p, case):
    """The interval route equals a lexsort: on the fast path (spread
    ranks), on the routing overflow (one giant tie group) and on the
    boundary fallback (a group larger than cap straddling a boundary)."""
    length = 256
    n = p * length
    rng = np.random.default_rng(p)
    key = np.arange(n)
    if case == "giant-group":
        key[:] = 0
    elif case == "straddle":
        # a tie group of 2 cap starting half a cap before the boundary of
        # shards 0 and 1: every pair fits, shard 0's spill does not
        cap = redistribute_cap(p, length)
        key[length - cap // 2:length + 3 * cap // 2] = length - cap // 2
    key = rng.permutation(key)
    rank = _head_slot_ranks(key)
    second = rng.integers(0, 5, n).astype(np.int32)
    gidx = rng.permutation(n).astype(np.int32)
    distsort.fallbacks.clear()
    out = rank_interval_sort(
        (_shards(rank, p), _shards(second, p), _shards(gidx, p)), 3)
    order = np.lexsort((gidx, second, rank))
    for o, a in zip(out, (rank, second, gidx)):
        np.testing.assert_array_equal(_cat(o), a[order])
    want = {"spread": {}, "giant-group": {"rank_interval": 1},
            "straddle": {"rank_interval_boundary": 1}}[case]
    # merge-split is the route at P = 2
    assert dict(distsort.fallbacks) == ({} if p == 2 else want)


def test_comm_model_functions_equal_jax():
    """Every byte count of the port's model equals the JAX model's."""
    from stringsearch_tpu.parallel import comm_model as jcm
    from stringsearch_tpu.parallel.distsort import redistribute_cap as jcap

    for p in (1, 2, 4, 8, 16):
        assert comm_model.merge_split_stages(p) == jcm.merge_split_stages(p)
        for chunk in (4, 100, 1000, 1 << 20):
            assert redistribute_cap(p, chunk) == jcap(p, chunk)
            for fn in ("sharded_sort_bytes_per_device",
                       "rank_interval_sort_bytes_per_device"):
                assert getattr(comm_model, fn)(p, chunk, 5, 4) \
                    == getattr(jcm, fn)(p, chunk, 5, 4)
            assert comm_model.compact_round_bytes_per_device(p, chunk, 3) \
                == jcm.compact_round_bytes_per_device(p, chunk, 3)
            assert comm_model.redistribute_bytes_per_device(p, chunk, 1, 8) \
                == jcm.redistribute_bytes_per_device(p, chunk, 1, 8)
        for n in (1, 100, 4000, 1 << 24):
            for rounds in (None, 0, 4, 8):
                assert comm_model.global_build_comm(
                    n, p, 16, 3, rounds).__dict__ == jcm.global_build_comm(
                    n, p, 16, 3, rounds).__dict__
    with pytest.raises(ValueError, match="power-of-two"):
        comm_model.merge_split_stages(6)


def test_comm_model_has_no_default_link_rate():
    """A projection takes the link rate from the caller: no rate of any
    device is built in."""
    import inspect

    rep = comm_model.global_build_comm(4000, 4)
    for name in ("projected_comm_seconds", "projected_efficiency"):
        params = inspect.signature(getattr(rep, name)).parameters
        assert all(p.default is inspect.Parameter.empty
                   for p in params.values()), name
    assert rep.projected_comm_seconds(2.0) == rep.total_bytes / 2e9
    assert 0 < rep.projected_efficiency(0.1, 45.0) < 1


@pytest.mark.parametrize("p", SHARDS)
def test_comm_model_matches_build(p):
    """The report's rounds equal the build's; the per-round arithmetic is
    the interval sort (P > 2) or merge-split (P = 2), the redistribute and
    one chunk hop per shift; the default schedule bound does not
    underestimate."""
    g = build_global(enwik_like(4000, seed=2), make_mesh(devices=[CPU] * p))
    rep = g.comm_report()
    assert rep.rounds == g.rounds_run
    assert rep.p == p and rep.chunk_elems == g.chunk_len
    round_sort = (
        comm_model.rank_interval_sort_bytes_per_device(p, g.chunk_len,
                                                       g.fan + 1)
        if p > 2 else
        comm_model.sharded_sort_bytes_per_device(p, g.chunk_len, g.fan + 1))
    per_round = ((g.fan - 1) * g.chunk_len * 4 + round_sort
                 + comm_model.redistribute_bytes_per_device(p, g.chunk_len))
    assert rep.per_round_bytes == per_round
    assert rep.total_bytes >= rep.initial_bytes + rep.rounds * per_round
    bound = comm_model.global_build_comm(g.n, p, depth=g.depth, fan=g.fan)
    assert bound.rounds >= rep.rounds


@pytest.mark.parametrize("p", SHARDS)
def test_sorts_move_the_bytes_the_model_counts(p):
    """Each shard's bulk bytes (ppermute + all_to_all) of one call equal
    the model's count: merge-split, the redistribute fast path, the
    interval sort's fast path."""
    length = 64
    n = p * length
    rng = np.random.default_rng(p)
    a = _shards(rng.permutation(n).astype(np.int32), p)
    b = _shards(rng.integers(0, 9, n).astype(np.int32), p)
    coll.reset_traffic()
    sharded_sort((a, b), 1)
    assert max(coll.bulk_bytes_per_shard(p)) == \
        comm_model.sharded_sort_bytes_per_device(p, length, 2)
    coll.reset_traffic()
    distsort.fallbacks.clear()
    redistribute_permutation(a, (b,))
    assert not distsort.fallbacks
    assert coll.bulk_bytes_per_shard(p) == \
        [comm_model.redistribute_bytes_per_device(p, length, 1)] * p
    coll.reset_traffic()
    rank_interval_sort((a, b), 2)
    want = (comm_model.rank_interval_sort_bytes_per_device(p, length, 2)
            if p > 2 else
            comm_model.sharded_sort_bytes_per_device(p, length, 2))
    assert not distsort.fallbacks
    assert coll.bulk_bytes_per_shard(p) == [want] * p
