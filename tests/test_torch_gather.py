"""Port of parallel/gather.py against JAX.

Counterparts of every case of tests/test_gather.py at P = 2, 4 and 8
shards on `[cpu] * P`, the JAX gathers run inside `shard_map` on the
8-device CPU mesh for the same numpy inputs; plus the capped gather, which
the compacted rounds use, on both sides of its capacity. Outputs are
integers, compared exactly (tolerance 0), and the bytes the gathers moved
are held to their static buffer sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from stringsearch_torch.parallel import collectives as coll
from stringsearch_torch.parallel.gather import (
    sharded_gather,
    sharded_gather_capped,
    sharded_gather_windows,
)

SHARDS = [2, 4, 8]


def _jrun(p, fn, *arrays, out_specs=P("parts")):
    mesh = Mesh(np.array(jax.devices("cpu")[:p]), ("parts",))
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=tuple(P("parts") for _ in arrays),
        out_specs=out_specs, check_vma=False))(*map(jnp.asarray, arrays))


def _shards(x: np.ndarray, p: int) -> list:
    return [torch.from_numpy(c.copy()) for c in np.split(np.asarray(x), p)]


def _cat(xs) -> np.ndarray:
    return torch.cat(list(xs)).numpy()


@pytest.mark.parametrize("p", SHARDS)
def test_gather_random(p):
    from stringsearch_tpu.parallel.gather import sharded_gather as jgather

    rng = np.random.default_rng(3)
    n, m = p * 40, p * 16
    values = rng.integers(0, 1 << 30, n).astype(np.int32)
    idx = rng.integers(0, n, m).astype(np.int32)
    coll.reset_traffic()
    got = _cat(sharded_gather(_shards(values, p), _shards(idx, p)))
    np.testing.assert_array_equal(got, values[idx])
    # two all_to_alls of [P, m/P] int32 per shard
    assert coll.bulk_bytes_per_shard(p) == [2 * p * (m // p) * 4] * p
    want = _jrun(p, lambda v, i: jgather(v, i, "parts"), values, idx)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("p", SHARDS)
def test_gather_skewed_all_one_owner(p):
    """Worst case: every request targets one shard — capacity must hold."""
    n, m = p * 32, p * 8
    values = np.arange(n, dtype=np.int32) * 7
    idx = np.full((m,), 5, np.int32)  # all hit shard 0
    got = _cat(sharded_gather(_shards(values, p), _shards(idx, p)))
    np.testing.assert_array_equal(got, np.full((m,), 35))


@pytest.mark.parametrize("p", SHARDS)
def test_gather_windows_cross_boundary(p):
    from stringsearch_tpu.parallel.gather import (
        sharded_gather_windows as jwindows,
    )

    rng = np.random.default_rng(4)
    n = p * 64
    values = rng.integers(0, 256, n).astype(np.int32)
    starts = np.tile(np.asarray([0, 62, 63, 64, 200 % n, n - 3], np.int32),
                     p)
    w = 5
    got = torch.cat(sharded_gather_windows(
        _shards(values, p), _shards(starts, p), w)).numpy()
    for b, s in enumerate(starts):
        want = values[np.minimum(np.arange(s, s + w), n - 1)]
        np.testing.assert_array_equal(got[b], want, err_msg=f"start={s}")
    jwant = _jrun(p, lambda v, s: jwindows(v, s, w, "parts"), values, starts)
    np.testing.assert_array_equal(got, np.asarray(jwant))


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("skewed", [False, True])
def test_gather_capped(p, skewed):
    """Balanced requests fit the capacity and are answered exactly;
    requests concentrated on one owner raise the replicated overflow flag,
    as in JAX. The buffers are [P, cap] whatever the requests."""
    from stringsearch_tpu.parallel.gather import (
        sharded_gather_capped as jcapped,
    )

    rng = np.random.default_rng(p)
    n, m = p * 64, p * 32
    cap = (m // p) // p  # exactly what balanced requests need
    values = rng.integers(-1000, 1000, n).astype(np.int32)
    if skewed:
        idx = rng.integers(0, 64, m).astype(np.int32)  # all owned by shard 0
    else:
        # each shard asks every owner for the same number of values
        idx = ((np.arange(m) % p) * 64 + rng.integers(0, 64, m)).astype(
            np.int32)
    coll.reset_traffic()
    out, over = sharded_gather_capped(_shards(values, p), _shards(idx, p),
                                      cap)
    assert len({bool(f) for f in over}) == 1  # replicated
    assert bool(over[0]) == skewed
    assert coll.bulk_bytes_per_shard(p) == [2 * p * cap * 4] * p
    jout, jover = _jrun(p, lambda v, i: jcapped(v, i, "parts", cap), values,
                        idx, out_specs=(P("parts"), P()))
    assert bool(jover) == skewed
    if not skewed:
        np.testing.assert_array_equal(_cat(out), values[idx])
        np.testing.assert_array_equal(_cat(out), np.asarray(jout))
