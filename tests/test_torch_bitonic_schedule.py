"""The bitonic kernel's schedule and its plain version, on the CPU.

`ops/bitonic.py:schedule` lists the passes the kernel (`csrc/bitonic.cu`)
runs, and `plain_bitonic_sort` runs them in torch ops, block by block in
the kernel's frames. Here, at small tiles and group widths so that every
kind of pass runs below n = 2^13:
  * the schedule covers each stage of the network once, in order;
  * `plain_bitonic_sort` under any (tile, group width) equals the network
    run stage by stage on every plane;
  * its keys equal the stable plain sort's and the JAX package's Pallas
    network's (interpret mode), its payloads as multisets per tied block.
The kernel itself is held against `plain_bitonic_sort` on every plane with
tolerance 0 by the `cuda` tests of tests/test_torch_bitonic.py and by
`chip_smoke.py` phase 2.
"""

import numpy as np
import pytest
import torch

from stringsearch_torch.ops import bitonic

INT32_MAX = np.iinfo(np.int32).max
# (tile, stages a group pass takes): small enough that group passes with
# and without the mirror, and tile passes, all run at n of a few thousand
GROUPINGS = [(64, 2), (64, 3), (256, 3), (256, 2), (16, 1), (None, None)]
SHAPES = [(2, 1), (4, 3), (5, 4)]


def _network(operands, num_keys):
    """The all-ascending bitonic network, one stage after another over the
    whole array, comparators past n skipped."""
    ops = [op.clone() for op in operands]
    n = ops[0].shape[0]
    if n < 2:
        return ops
    log_full = (n - 1).bit_length()
    index = torch.arange(1 << log_full)
    for level in range(1, log_full + 1):
        for b in range(level - 1, -1, -1):
            mask = (1 << level) - 1 if b == level - 1 else 1 << b
            lower = index[(index >> b) & 1 == 0]
            upper = lower ^ mask
            live = upper < n
            lower, upper = lower[live], upper[live]
            x = torch.stack([op[lower] for op in ops])
            y = torch.stack([op[upper] for op in ops])
            swap = bitonic._lex_gt(x, y, num_keys)
            for q, op in enumerate(ops):
                op[lower] = torch.where(swap, y[q], x[q])
                op[upper] = torch.where(swap, x[q], y[q])
    return ops


def _planes(rng, n, c, num_keys, values=None):
    """num_keys key planes with many ties (or drawn from `values`), then
    distinct payloads."""
    if values is None:
        keys = [rng.integers(-3, 3, n, dtype=np.int32)
                for _ in range(num_keys)]
    else:
        keys = [rng.choice(np.asarray(values, dtype=np.int32), n)
                for _ in range(num_keys)]
    pays = [rng.permutation(n).astype(np.int32) for _ in range(c - num_keys)]
    return [torch.from_numpy(a) for a in keys + pays]


def _canonical(keys, payload):
    """The payload sorted inside each tied key block."""
    keys = np.stack([np.asarray(k) for k in keys])
    new = np.ones(keys.shape[1], dtype=bool)
    new[1:] = (keys[:, 1:] != keys[:, :-1]).any(axis=0)
    block = np.cumsum(new)
    payload = np.asarray(payload)
    return payload[np.lexsort((payload, block))]


@pytest.mark.parametrize("tile,group_stages", GROUPINGS)
@pytest.mark.parametrize("c", [1, 2, 4, 6])
def test_schedule_covers_every_stage_once_in_order(c, tile, group_stages):
    for n in [2, 3, 17, 64, 65, 100, 1030, 1100, 4097, 1 << 13, 1 << 20,
              (1 << 24) + 12345, 1 << 28]:
        passes = bitonic.schedule(n, c, tile, group_stages)
        log_full = (n - 1).bit_length()
        network = [(level, b) for level in range(1, log_full + 1)
                   for b in range(level - 1, -1, -1)]
        ran = [s for p in passes for s in bitonic.pass_stages(p)]
        assert ran == network, (n, c)
        t = passes[0].level
        most = group_stages or bitonic.tile_log(c) - bitonic.ROW_LOG
        for p in passes[1:]:
            if p.kind == "group":  # past the tile, at most S stages
                assert p.lo >= t and p.hi - p.lo + 1 <= most
            else:
                assert (p.kind, p.hi, p.lo) == ("tile", t - 1, 0)


def test_schedule_pass_counts():
    """At 2^28: 38 passes for C = 4..6 and 34 for C = 2, 3 (the earlier
    design made 78); at 2^24: 26 and 22."""
    for c, at28, at24 in [(1, 30, 19), (2, 34, 22), (3, 34, 22), (4, 38, 26),
                          (5, 38, 26), (6, 38, 26)]:
        assert len(bitonic.schedule(1 << 28, c)) == at28
        assert len(bitonic.schedule(1 << 24, c)) == at24
    assert bitonic.schedule(1, 5) == [] and bitonic.schedule(0, 5) == []
    assert bitonic.schedule(1000, 5) == [bitonic.Pass("sort", 10, 9, 0)]


def test_schedule_rejects_bad_groupings():
    with pytest.raises(ValueError):
        bitonic.schedule(1000, 2, tile=48)
    with pytest.raises(ValueError):
        bitonic.schedule(1000, 2, tile=64, group_stages=7)
    with pytest.raises(ValueError):
        bitonic.schedule(1000, 2, tile=64, group_stages=0)


@pytest.mark.parametrize("tile,group_stages", GROUPINGS[:4])
def test_frames_cover_each_element_once(tile, group_stages):
    """Every pass's blocks hold each position below 2^k once, in
    increasing order within a block, and a block's valid count is its
    number of positions below n (the kernel's `rows_below` arithmetic)."""
    for n in [1100, 4097, 3000]:
        full = 1 << (n - 1).bit_length()
        passes = bitonic.schedule(n, 4, tile, group_stages)
        t = passes[0].level
        for p in passes:
            pos, valid = bitonic._frame(p, t, full, n, "cpu")
            assert torch.equal(pos.flatten().sort().values,
                               torch.arange(full))
            assert bool((pos[:, 1:] > pos[:, :-1]).all())
            assert torch.equal(valid, (pos < n).sum(1))


@pytest.mark.parametrize("n", [1024, 1100, 1030, 4097, 50])
@pytest.mark.parametrize("tile,group_stages", GROUPINGS)
@pytest.mark.parametrize("c,num_keys", SHAPES)
def test_grouping_does_not_change_the_result(c, num_keys, tile,
                                              group_stages, n):
    rng = np.random.default_rng(1000 * c + n)
    ops = _planes(rng, n, c, num_keys)
    got = bitonic.plain_bitonic_sort(ops, num_keys, tile, group_stages)
    want = _network(ops, num_keys)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(torch.equal(a, b) for a, b in zip(
        ops, _planes(np.random.default_rng(1000 * c + n), n, c, num_keys)))


@pytest.mark.parametrize("n", [1100, 1030, 4097])
@pytest.mark.parametrize("tile,group_stages", [(64, 2), (256, 3)])
def test_int32_max_keys_lose_nothing(tile, group_stages, n):
    """Keys from {0, 1, 2, INT32_MAX} and all INT32_MAX: no payload is
    lost or duplicated, and every plane equals the network's."""
    rng = np.random.default_rng(n)
    for values in ([0, 1, 2, INT32_MAX], [INT32_MAX]):
        ops = _planes(rng, n, 5, 4, values)
        got = bitonic.plain_bitonic_sort(ops, 4, tile, group_stages)
        for g, w in zip(got, _network(ops, 4)):
            assert torch.equal(g, w)
        want = bitonic.plain_sort(ops, 4)
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g, w)
        assert torch.equal(got[4].sort().values,
                           torch.arange(n, dtype=torch.int32))


@pytest.mark.parametrize("n", [777, 4096])
@pytest.mark.parametrize("c,num_keys", SHAPES)
def test_keys_and_payloads_against_the_plain_sort(c, num_keys, n):
    rng = np.random.default_rng(7 * n + c)
    ops = _planes(rng, n, c, num_keys)
    got = bitonic.plain_bitonic_sort(ops, num_keys, 64, 2)
    want = bitonic.plain_sort(ops, num_keys)
    for g, w in zip(got[:num_keys], want[:num_keys]):
        assert torch.equal(g, w)
    for g, w in zip(got[num_keys:], want[num_keys:]):
        np.testing.assert_array_equal(_canonical(want[:num_keys], g),
                                      _canonical(want[:num_keys], w))


def test_keys_and_payloads_against_the_pallas_network(monkeypatch):
    """Against the reference's Pallas network itself, in interpret mode
    with 256-element tiles, at a power of two (where it pads nothing):
    keys equal, payloads per tied block (the reference's network alternates
    directions, so its order inside ties may differ)."""
    monkeypatch.setenv("STRINGSEARCH_TPU_PALLAS_TILE", "256")
    import jax.numpy as jnp
    from stringsearch_tpu.ops.bitonic import pallas_sort

    rng = np.random.default_rng(12)
    ops = _planes(rng, 1024, 4, 3)
    want = pallas_sort(tuple(jnp.asarray(op.numpy()) for op in ops), 3,
                       interpret=True)
    want = [np.asarray(w) for w in want]
    for tile, group_stages in [(64, 2), (None, None)]:
        got = bitonic.plain_bitonic_sort(ops, 3, tile, group_stages)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(_canonical(want[:3], got[3]),
                                      _canonical(want[:3], want[3]))


def test_plain_bitonic_sort_takes_any_num_keys_and_short_inputs():
    for n in [0, 1, 2]:
        ops = [torch.arange(n, dtype=torch.int32).flip(0)] * 2
        got = bitonic.plain_bitonic_sort(ops, 1)
        assert got[0].tolist() == sorted(ops[0].tolist())
    with pytest.raises(ValueError):
        bitonic.plain_bitonic_sort([torch.zeros(4, dtype=torch.int32)], 2)
