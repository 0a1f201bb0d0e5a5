"""Port of shard_map's collectives (parallel/collectives.py) against JAX.

Each collective of the port takes the list of per-shard tensors; the same
numpy inputs go through the JAX collective inside `shard_map` on the
8-device CPU mesh (tests/conftest.py) and through the port on
`[cpu] * P`. The outputs are integers and compared exactly (tolerance 0).
The byte counts the port keeps per shard and kind are checked too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from stringsearch_torch.parallel import collectives as coll

CPU = torch.device("cpu")
SHARDS = [2, 4, 8]


def _jmesh(p):
    return Mesh(np.array(jax.devices("cpu")[:p]), ("parts",))


def _jrun(p, body, x, out_spec=P("parts")):
    return np.asarray(jax.jit(jax.shard_map(
        body, mesh=_jmesh(p), in_specs=P("parts"), out_specs=out_spec,
        check_vma=False))(jnp.asarray(x)))


def _shards(x: np.ndarray, p: int) -> list:
    return [torch.from_numpy(c.copy()) for c in np.split(x, p)]


def _cat(xs) -> np.ndarray:
    return torch.cat(list(xs)).numpy()


def _data(p: int, per: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-1000, 1000, p * per).astype(np.int32)


@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("kind", ["cycle", "from_next", "partial", "xor"])
def test_ppermute_equals_jax(p, kind):
    """Every permutation shape the layer uses; shards that receive nothing
    get zeros, as in JAX."""
    perm = {"cycle": [(i, (i + 1) % p) for i in range(p)],
            "from_next": [(i, (i - 1) % p) for i in range(p)],
            "partial": [(i, i - 1) for i in range(1, p)],
            "xor": [(i, i ^ 1) for i in range(p)]}[kind]
    x = _data(p, 6, p)
    want = _jrun(p, lambda a: jax.lax.ppermute(a, "parts", perm), x)
    got = coll.ppermute(_shards(x, p), perm)
    np.testing.assert_array_equal(_cat(got), want)


@pytest.mark.parametrize("p", SHARDS)
def test_all_to_all_equals_jax(p):
    x = _data(p, 3 * p, 10 + p)

    def body(a):
        return jax.lax.all_to_all(a.reshape(p, 3), "parts", split_axis=0,
                                  concat_axis=0, tiled=True).reshape(-1)

    want = _jrun(p, body, x)
    got = coll.all_to_all([s.reshape(p, 3) for s in _shards(x, p)])
    np.testing.assert_array_equal(_cat(g.reshape(-1) for g in got), want)


@pytest.mark.parametrize("p", SHARDS)
def test_reductions_and_all_gather_equal_jax(p):
    """psum, the all-gather (stacked and tiled) and the min over shards,
    replicated on every shard."""
    x = _data(p, 5, 20 + p)
    sh = _shards(x, p)
    want_sum = _jrun(p, lambda a: jax.lax.psum(a, "parts"), x, P())
    want_stack = _jrun(p, lambda a: jax.lax.all_gather(a, "parts"), x, P())
    want_tiled = _jrun(p, lambda a: jax.lax.all_gather(a, "parts",
                                                        tiled=True), x, P())
    want_min = _jrun(p, lambda a: jnp.min(jax.lax.all_gather(a, "parts"),
                                          axis=0), x, P())
    for got, want in ((coll.psum(sh), want_sum),
                      (coll.all_gather(sh), want_stack),
                      (coll.all_gather(sh, tiled=True), want_tiled),
                      (coll.pmin(sh), want_min)):
        assert len(got) == p
        for g in got:
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), want)


def test_collectives_count_what_each_shard_sends():
    """Bytes per shard and kind: a self-send counts, a shard that sends
    nothing adds nothing, boundary exchanges go to their own kind."""
    p = 4
    sh = _shards(np.arange(p * 8, dtype=np.int32), p)
    coll.reset_traffic()
    coll.ppermute(sh, [(i, i - 1) for i in range(1, p)])
    coll.ppermute([s[:1] for s in sh], [(i, (i + 1) % p) for i in range(p)],
                  boundary=True)
    coll.all_to_all([s.reshape(p, 2) for s in sh])
    coll.psum([s.sum() for s in sh])
    coll.all_gather([s[:2] for s in sh])
    assert [coll.sent["ppermute"][s] for s in range(p)] == [0, 32, 32, 32]
    assert [coll.sent["boundary"][s] for s in range(p)] == [4] * p
    assert [coll.sent["all_to_all"][s] for s in range(p)] == [32] * p
    assert [coll.sent["reduce"][s] for s in range(p)] == [8] * p
    assert [coll.sent["all_gather"][s] for s in range(p)] == [8] * p
    assert coll.bulk_bytes_per_shard(p) == [32, 64, 64, 64]
    coll.reset_traffic()
    assert coll.bulk_bytes_per_shard(p) == [0] * p


def test_receivers_never_share_a_buffer_they_write():
    """all_to_all builds a new buffer for every receiver, also on one
    device; ppermute hands the sender's tensor over (the layer only reads
    what it receives); a reduction's result is shared per device."""
    p = 4
    sh = _shards(np.arange(p * 8, dtype=np.int32), p)
    recv = coll.all_to_all([s.reshape(p, 2) for s in sh])
    ptrs = {r.data_ptr() for r in recv} | {s.data_ptr() for s in sh}
    assert len(ptrs) == 2 * p
    moved = coll.ppermute(sh, [(i, (i + 1) % p) for i in range(p)])
    assert moved[1] is sh[0]
    sums = coll.psum([s.sum() for s in sh])
    assert all(s is sums[0] for s in sums)
    assert int(sums[0]) == int(np.arange(p * 8).sum())


def test_all_to_all_rejects_ragged_shards():
    with pytest.raises(ValueError, match="equal shapes"):
        coll.all_to_all([torch.zeros(4, dtype=torch.int32),
                         torch.zeros(6, dtype=torch.int32)])
    with pytest.raises(ValueError, match="divisible"):
        coll.all_to_all([torch.zeros(3, dtype=torch.int32)] * 2)
