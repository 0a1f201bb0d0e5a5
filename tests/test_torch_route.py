"""The global build's routing and placement steps (`ops/route.py`,
`ops/steps.py:shard_pack_keys`, `shard_shift_planes`).

`plain_route_partition` against a numpy model of the JAX package's
arithmetic (stringsearch_tpu/parallel/distsort.py:151-164 and :240-255: a
stable sort by destination, the `searchsorted` rank, a scatter into a
buffer of fills that drops what lies past cap) and against those jnp ops
themselves: P = 2, 4, 8, int32 and int64 operands, one window and four a
destination, uniform, skewed and empty destinations, a destination at
exactly cap and at cap + 1 (the overflow flag), clamped and out-of-range
sources, n not a multiple of any tile; each row ordered by window, and
the windows `receiver_windows` picks. `plain_place_received` against the
numpy scatter. The slice
against the JAX package, run inside `shard_map` on the 8-device CPU mesh
as tests/test_torch_distsort.py runs it, at P = 2, 4, 8:
`redistribute_permutation`, `rank_interval_sort`, `_initial_shard_ranks`,
`_doubling_step` and `build_global` (int32 and int64), with the bytes
each shard sent and the fallbacks equal to those of the route before
these kernels (a sort by (dest, gidx)). The shard variants of
`pack_keys` and `shift_planes` against the JAX packing and
`_shifted_ranks`, with h below L, equal to L, a multiple of L and at or
past n_pad. Everything compared is an integer: tolerance 0.

Tests marked `cuda` hold the kernels against their plain versions on the
card and skip without one; run them with
`python -m pytest --noconftest -m cuda tests/test_torch_route.py` (this
file imports jax only inside the tests that compare with it).
"""

import numpy as np
import pytest
import torch

from stringsearch_torch.ops import route, steps
from stringsearch_torch.parallel import collectives as coll
from stringsearch_torch.parallel import distsort, global_sa
from stringsearch_torch.parallel.distsort import redistribute_cap
from stringsearch_torch.parallel.mesh import make_mesh

CPU = torch.device("cpu")
SHARDS = [2, 4, 8]
I32, I64 = np.int32, np.int64
CASES = ("uniform", "skewed", "empty", "at cap", "past cap", "clamped",
         "out of range")
# n not a multiple of the route tile, of the place tile or of a warp row
N = 3 * route.ROUTE_TILE + 7


def _shards(x: np.ndarray, p: int) -> list:
    return [torch.from_numpy(c.copy()) for c in np.split(np.asarray(x), p)]


def _cat(xs) -> np.ndarray:
    return torch.cat([x.cpu() for x in xs]).numpy()


def _jmesh(p):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices("cpu")[:p]), ("parts",))


def _shard_map(p, fn, n_in, out_specs):
    import jax
    from jax.sharding import PartitionSpec as P

    return jax.jit(jax.shard_map(
        fn, mesh=_jmesh(p), in_specs=tuple(P("parts") for _ in range(n_in)),
        out_specs=out_specs, check_vma=False))


# ---------------------------------------------------------------------------
# route_partition and place_received: plain versions against the model
# ---------------------------------------------------------------------------


def _route_case(case: str, p: int, dtype, n: int = N, seed: int = 0):
    """(src, length, cap, clamp) of one routing case of n elements, or
    None where the case cannot be built."""
    rng = np.random.default_rng([seed, p, n, CASES.index(case)])
    length = n
    cap = redistribute_cap(p, length)
    clamp = case == "clamped"
    dest = rng.integers(0, p, n)
    if case == "skewed":
        # destination 0 takes as many as fit, the rest spread
        heavy = min(cap, n)
        dest = np.concatenate([np.zeros(heavy, int),
                               rng.integers(1, p, n - heavy)
                               if p > 1 else np.zeros(n - heavy, int)])
        dest = rng.permutation(dest)
    elif case == "empty":
        # destination 0 gets nothing, the others share within cap
        dest = rng.integers(min(1, p - 1), p, n)
    elif case in ("at cap", "past cap"):
        first = cap + (case == "past cap")
        if first > n:
            return None  # at P = 2 the cap is the whole shard
        dest = np.concatenate([np.zeros(first, int),
                               rng.integers(1, p, n - first)])
        dest = rng.permutation(dest)
    src = dest * length + rng.integers(0, length, n)
    if case == "clamped":
        # a tenth of a shard below 0 and past the last: clamped, in cap
        src = rng.integers(-(length // 10), (p * 10 + 1) * length // 10, n)
    elif case == "out of range":
        src[rng.integers(0, n, 5)] = p * length + 1
        src[rng.integers(0, n, 5)] = -7
    return src.astype(dtype), length, cap, clamp


def _planes(rng, src: np.ndarray) -> tuple:
    """(planes, fills): src itself, an int32 and an int64 payload."""
    n = src.shape[0]
    planes = (src, rng.integers(-2**31, 2**31, n).astype(I32),
              rng.integers(-2**62, 2**62, n).astype(I64))
    fills = (-1, np.iinfo(I32).max, np.iinfo(I64).max)
    return planes, fills


def np_route(src, length, p, planes, fills, cap, clamp, windows=1):
    """The JAX package's routing arithmetic in numpy: a stable sort by
    destination (by destination and window with more than one window), the
    rank inside the destination, a scatter that drops what cannot be
    placed."""
    n = src.shape[0]
    v = src.astype(np.int64)
    dest = np.floor_divide(v, length)
    if clamp:
        dest = np.clip(dest, 0, p - 1)
    sub = -(-length // windows)
    win = np.clip(np.floor_divide(v - dest * length, sub), 0, windows - 1)
    key = np.where((dest >= 0) & (dest < p), dest * windows + win, -1)
    order = np.argsort(key, kind="stable")
    dest_s = np.floor_divide(key[order], windows)
    rank = np.arange(n) - np.searchsorted(dest_s, dest_s, side="left")
    ok = (rank < cap) & (dest_s >= 0)
    sends = []
    for plane, fill in zip(planes, fills):
        buf = np.full((p, cap), fill, dtype=plane.dtype)
        buf[dest_s[ok], rank[ok]] = plane[order][ok]
        sends.append(buf)
    return sends, int(not ok.all())


def np_route_counts(src, length, p, clamp):
    """Each destination's elements, cap or not, as the routing arithmetic
    assigns them (what lies outside [0, p) without `clamp` counts
    nowhere)."""
    dest = np.floor_divide(src.astype(np.int64), length)
    if clamp:
        dest = np.clip(dest, 0, p - 1)
    return np.bincount(dest[(dest >= 0) & (dest < p)], minlength=p)


def _route_torch(fn, src, length, p, planes, fills, cap, clamp, device=CPU,
                 windows=1):
    """The buffers and flag of `fn`, its row counts held to the model."""
    sends, over, counts = fn(torch.from_numpy(src).to(device), length, p,
                             [torch.from_numpy(x).to(device) for x in planes],
                             fills, cap, clamp, windows)
    assert over.dim() == 0 and over.dtype == torch.int32
    assert counts.shape == (p,) and counts.dtype == torch.int32
    assert counts.device == over.device
    np.testing.assert_array_equal(counts.cpu().numpy(),
                                  np_route_counts(src, length, p, clamp))
    return [s.cpu().numpy() for s in sends], int(over)


@pytest.mark.parametrize("windows", [1, 4])
@pytest.mark.parametrize("dtype", [I32, I64])
@pytest.mark.parametrize("case,p", [
    (case, p) for case in CASES for p in SHARDS
    if _route_case(case, p, I32) is not None])
def test_plain_route_partition_equals_the_model(case, p, dtype, windows):
    src, length, cap, clamp = _route_case(case, p, dtype)
    planes, fills = _planes(np.random.default_rng(p), src)
    want, want_over = np_route(src, length, p, planes, fills, cap, clamp,
                               windows)
    got, over = _route_torch(route.route_partition, src, length, p, planes,
                             fills, cap, clamp, windows=windows)
    assert over == want_over == (case in ("past cap", "out of range"))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (p, cap)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [0, 1, 2, 31, 33, route.ROUTE_TILE - 1,
                               route.ROUTE_TILE + 1])
def test_plain_route_partition_small(n):
    rng = np.random.default_rng(n)
    p, length = 4, max(n, 1)
    src = rng.integers(0, p * length, n).astype(I32)
    planes, fills = _planes(rng, src)
    cap = redistribute_cap(p, length)
    want, want_over = np_route(src, length, p, planes, fills, cap, False)
    got, over = _route_torch(route.plain_route_partition, src, length, p,
                             planes, fills, cap, False)
    assert over == want_over
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("windows", [1, 4])
@pytest.mark.parametrize("case,p", [
    (case, p) for case in CASES for p in SHARDS
    if _route_case(case, p, I32) is not None])
def test_route_counts_equal_the_plain_counts(case, p, windows):
    """The row counts `route_partition` returns beside its buffers equal
    `plain_route_partition`'s and the model's, cap or not; the buffers and
    the flag are what they were without counts (the model's); and row d
    holds min(counts[d], cap) elements."""
    src, length, cap, clamp = _route_case(case, p, I64)
    ids = np.arange(src.size, dtype=I32)
    args = (torch.from_numpy(src), length, p,
            (torch.from_numpy(src), torch.from_numpy(ids)), (-1, -1), cap,
            clamp, windows)
    sends, over, counts = route.route_partition(*args)
    plain = route.plain_route_partition(*args)
    np.testing.assert_array_equal(counts.numpy(), plain[2].numpy())
    np.testing.assert_array_equal(counts.numpy(),
                                  np_route_counts(src, length, p, clamp))
    want, want_over = np_route(src, length, p, (src, ids), (-1, -1), cap,
                               clamp, windows)
    assert int(over) == int(plain[1]) == want_over
    for got, other, w in zip(sends, plain[0], want):
        np.testing.assert_array_equal(got.numpy(), w)
        np.testing.assert_array_equal(other.numpy(), w)
    held = (sends[1].numpy() >= 0).sum(axis=1)
    np.testing.assert_array_equal(held, np.minimum(counts.numpy(), cap))
    assert (counts.numpy() > cap).any() == (case == "past cap")


def test_the_model_is_the_jax_arithmetic():
    """The numpy model equals the JAX package's ops (distsort.py:240-255)
    run eagerly with a stable sort, on a clamped route with overflow."""
    import jax
    import jax.numpy as jnp

    p = 4
    src, length, cap, _ = _route_case("clamped", p, I32)
    src = src.copy()
    src[:cap + 3] = 5  # destination 0 past its cap
    op = np.random.default_rng(1).integers(0, 99, N).astype(I32)
    dest = jnp.clip(jnp.asarray(src) // length, 0, p - 1).astype(jnp.int32)
    dest_s, op_s = jax.lax.sort((dest, jnp.asarray(op)), num_keys=1,
                                is_stable=True)
    seg_rank = (jnp.arange(N, dtype=jnp.int32)
                - jnp.searchsorted(dest_s, dest_s, side="left"))
    send = jnp.full((p, cap), 2**31 - 1, jnp.int32)
    send = send.at[dest_s, seg_rank].set(op_s, mode="drop")
    over = bool(jnp.any(seg_rank >= cap))
    (want,), want_over = np_route(src, length, p, (op,), (2**31 - 1,), cap,
                                  True)
    np.testing.assert_array_equal(np.asarray(send), want)
    assert over and want_over


def test_receiver_windows():
    """The fewest windows (a power of two) whose window fits one cluster of
    the window placement, with p times them within MAX_BUCKETS: 256 a
    destination at phase 13's four shards of 2^26, one on short shards
    and past MAX_BUCKETS / 2 shards."""
    assert route.receiver_windows(4, 1 << 26) == 256
    assert route.receiver_windows(4, 1 << 26, 8) == 256
    assert route.receiver_windows(8, 1 << 26) == 128
    assert route.receiver_windows(32, 1 << 26) == 32
    assert route.receiver_windows(4, 1 << 24, 8) == 128
    assert route.receiver_windows(4, 1000) == 1
    assert route.receiver_windows(512, 1 << 26) == 2
    assert route.receiver_windows(1024, 1 << 26) == 1
    for p in (1, 2, 3, 5, 8, 300, 600):
        for length in (1, 15, 64, 1000, 1 << 20, 1 << 26):
            for width in (4, 8):
                slots = route.PLACE_CLUSTER_BYTES // width
                w = route.receiver_windows(p, length, width)
                assert w & (w - 1) == 0
                assert w == 1 or p * w <= route.MAX_BUCKETS
                # it fits, or doubling would leave one library call
                assert -(-length // w) <= slots or \
                    2 * w * p > route.MAX_BUCKETS
                # the fewest that fit
                assert w == 1 or -(-length // (w // 2)) > slots


def test_windows_order_each_row_by_window():
    """With windows, row d holds its elements by window of src % L, each
    window in source order: the receiver's targets rise window by
    window."""
    p, length, windows = 4, 1000, 8
    rng = np.random.default_rng(5)
    src = rng.permutation(p * length)[:length].astype(I32)  # one shard's
    cap = redistribute_cap(p, length)
    (got,), over = _route_torch(route.route_partition, src, length, p,
                                (src,), (-1,), cap, False, windows=windows)
    assert over == 0
    sub = -(-length // windows)
    for d in range(p):
        row = got[d][got[d] >= 0]
        assert sorted(row // length) == [d] * row.size
        win = (row % length) // sub
        assert (np.diff(win) >= 0).all()
        for w in range(windows):  # source order inside a window
            mine = src[(src // length == d) & ((src % length) // sub == w)]
            np.testing.assert_array_equal(row[win == w], mine)


@pytest.mark.parametrize("dtype", [I32, I64])
@pytest.mark.parametrize("p", SHARDS)
def test_plain_place_received_equals_the_scatter(p, dtype):
    rng = np.random.default_rng(p)
    length = 1000 + p
    cap = redistribute_cap(p, length)
    # shard 1's share of a permutation, as the all_to_all delivers it: row
    # s holds what shard s sent, -1 past its count
    gidx = rng.permutation(p * length)
    mine = gidx[(gidx // length) == 1]
    recv_g = np.full((p, cap), -1, dtype=dtype)
    recv = np.zeros((p, cap), dtype=dtype)
    for s, part in enumerate(np.array_split(mine, p)):
        recv_g[s, :part.size] = part
        recv[s, :part.size] = rng.integers(-5, 10**9, part.size)
    got = route.place_received(torch.from_numpy(recv_g),
                               (torch.from_numpy(recv),), length)
    assert len(got) == 1 and got[0].dtype == torch.from_numpy(recv).dtype
    want = np.zeros(length, dtype=dtype)
    keep = recv_g >= 0
    want[recv_g[keep] % length] = recv[keep]
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(
        route.plain_place_received(torch.from_numpy(recv_g),
                                   (torch.from_numpy(recv),), length)[0],
        want)


def test_route_rejects_bad_arguments():
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        route.route_partition(x.to(torch.int16), 4, 2, (x,), (0,), 4)
    with pytest.raises(ValueError, match="one fill"):
        route.route_partition(x, 4, 2, (x,), (), 4)
    with pytest.raises(ValueError, match="length"):
        route.route_partition(x, 4, 2, (x[:4],), (0,), 4)
    with pytest.raises(ValueError, match="positive"):
        route.route_partition(x, 4, 2, (x,), (0,), 0)
    with pytest.raises(ValueError, match="positive"):
        route.route_partition(x, 4, 2, (x,), (0,), 4, windows=0)
    with pytest.raises(ValueError, match="shape"):
        route.place_received(x, (x[:4],), 4)


def test_plain_versions_are_reached_only_from_the_cpu(monkeypatch):
    """Each wrapper that picks between its kernel and its plain version
    (`ops/_build.py:on_cuda`) takes the plain version only for CPU
    tensors; any other device goes to the kernel's branch (here a device
    that is neither, which it refuses with on_cuda's ValueError)."""
    from stringsearch_torch.ops import radix

    def refused(*args, **kwargs):
        raise AssertionError("the plain version was called")

    def i32(device, n=8):
        return torch.zeros(n, dtype=torch.int32, device=device)

    def text(device):
        return torch.zeros(8, dtype=torch.uint8, device=device)

    calls = {
        (route, "plain_route_partition"):
            lambda d: route.route_partition(i32(d), 4, 2, (i32(d),), (0,),
                                            4),
        (route, "plain_place_received"):
            lambda d: route.place_received(i32(d), (i32(d),), 4),
        (steps, "plain_shard_pack_keys"):
            lambda d: steps.shard_pack_keys(text(d), None, 4, 0),
        (steps, "plain_shard_shift_planes"):
            lambda d: steps.shard_shift_planes(
                [(1, i32(d), i32(d))], 8, 0, 16, torch.int32,
                torch.device(d)),
        (steps, "plain_pack_keys"): lambda d: steps.pack_keys(text(d), 4),
        (steps, "plain_shift_planes"):
            lambda d: steps.shift_planes(i32(d), [1]),
        (steps, "plain_head_ranks"):
            lambda d: steps.head_ranks((i32(d), i32(d))),
        (steps, "plain_invert_ranks"):
            lambda d: steps.invert_ranks(i32(d), i32(d)),
        (radix, "plain_histograms"):
            lambda d: radix.block_histograms(i32(d, 1024), 1024, 1024),
        (radix, "plain_dest"):
            lambda d: radix.local_group(i32(d, 1024), i32(d, 1024), 1024,
                                        chunk=1024),
        (radix, "plain_granule_flush"):
            lambda d: radix.granule_flush(i32(d), i32(d, 32), 4, 8, 8),
    }
    for module, name in calls:
        monkeypatch.setattr(module, name, refused)
    for call in calls.values():
        with pytest.raises(ValueError, match="must lie on the CPU or a CUDA "
                                             "device, got meta"):
            call("meta")
        with pytest.raises(AssertionError, match="plain version"):
            call("cpu")


# ---------------------------------------------------------------------------
# shard_pack_keys and shard_shift_planes against the JAX arithmetic
# ---------------------------------------------------------------------------


def np_shard_pack(chunk: np.ndarray, halo, depth: int, offset: int, dtype):
    """The packing of the JAX `_initial_shard_ranks` (global_sa.py:176-187)
    in numpy, as the port's biased int32 bits, and the global positions."""
    length = chunk.shape[0]
    nxt = np.zeros(depth, np.uint8) if halo is None else halo
    ext = np.concatenate([chunk, nxt]).astype(np.uint32)
    keys = []
    for k in range(depth // 4):
        o = 4 * k
        u = ((ext[o:o + length] << 24) | (ext[o + 1:o + 1 + length] << 16)
             | (ext[o + 2:o + 2 + length] << 8) | ext[o + 3:o + 3 + length])
        keys.append((u ^ np.uint32(1 << 31)).view(np.int32))
    return keys + [offset + np.arange(length, dtype=dtype)]


PACK_SIZES = (4, 5, 1023, 1024, 1025, 4099)


@pytest.mark.parametrize("dtype", [I32, I64])
@pytest.mark.parametrize("length,depth", [
    (length, depth) for length in PACK_SIZES for depth in (4, 12, 16)
    if depth <= length])  # the global build caps depth at the chunk length
def test_shard_pack_keys_equals_the_jax_packing(length, depth, dtype):
    rng = np.random.default_rng(length + depth)
    chunk = rng.integers(0, 256, length, dtype=np.uint8)
    for halo in (None, rng.integers(0, 256, depth, dtype=np.uint8),
                 np.full(depth, 255, np.uint8)):
        offset = 3 * length
        got = steps.shard_pack_keys(
            torch.from_numpy(chunk),
            None if halo is None else torch.from_numpy(halo), depth, offset,
            torch.from_numpy(np.zeros(0, dtype)).dtype)
        want = np_shard_pack(chunk, halo, depth, offset, dtype)
        assert len(got) == len(want) == depth // 4 + 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def _np_shifted(rank: np.ndarray, h: int) -> np.ndarray:
    n_pad = rank.shape[0]
    g = np.arange(n_pad)
    out = -(g + 1)
    ok = g + h < n_pad
    out[ok] = rank[(g + h)[ok]]
    return out.astype(rank.dtype)


def _hs(length: int, p: int) -> list:
    """Shifts below L, equal to L, a multiple of L, past a multiple, and
    at or past n_pad (the build clamps to n_pad)."""
    n_pad = length * p
    return sorted({min(h, n_pad) for h in (
        1, length // 3, length - 1, length, length + 5, 2 * length,
        n_pad - 1, n_pad)})


@pytest.mark.parametrize("dtype", [I32, I64])
@pytest.mark.parametrize("p", SHARDS)
def test_shifted_ranks_equal_the_model(p, dtype):
    """One `shard_shift_planes` a shard, as `_shifted_ranks` drives it,
    against the global shift; the positions against the global iota."""
    length = 37
    rng = np.random.default_rng(p)
    rank = rng.permutation(p * length).astype(dtype)
    hs = _hs(length, p)
    planes, gidx = global_sa._shifted_ranks(
        _shards(rank, p), hs, torch.from_numpy(rank[:0]).dtype)
    assert len(planes) == len(hs)
    for h, plane in zip(hs, planes):
        np.testing.assert_array_equal(_cat(plane), _np_shifted(rank, h))
    np.testing.assert_array_equal(_cat(gidx), np.arange(p * length))


@pytest.mark.parametrize("p", SHARDS)
def test_shifted_ranks_equal_jax(p):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stringsearch_tpu.parallel import global_sa as jg

    length = 24
    rank = np.random.default_rng(p).permutation(p * length).astype(I32)
    hs = _hs(length, p)
    planes, _ = global_sa._shifted_ranks(_shards(rank, p), hs, torch.int32)
    for h, plane in zip(hs, planes):
        f = _shard_map(p, lambda r, h=h: jg._shifted_ranks(
            r, h, p, jnp.int32), 1, P("parts"))
        np.testing.assert_array_equal(_cat(plane),
                                      np.asarray(f(jnp.asarray(rank))))


@pytest.mark.parametrize("p", SHARDS)
def test_initial_operands_equal_the_jax_packing(p):
    from stringsearch_torch.harness.corpus import enwik_like

    length = 40
    text = np.frombuffer(enwik_like(p * length, seed=p), np.uint8)
    ops = global_sa._initial_operands(16, torch.int32, _shards(text, p))
    chunks = np.split(text, p)
    for me in range(p):
        halo = chunks[me + 1][:16] if me < p - 1 else None
        want = np_shard_pack(chunks[me], halo, 16, me * length, I32)
        for col, w in zip(ops, want):
            np.testing.assert_array_equal(col[me].numpy(), w)


# ---------------------------------------------------------------------------
# the slice against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", SHARDS)
def test_redistribute_permutation_equals_jax(p):
    """Output equal to JAX's; the bytes each shard sent equal to the comm
    model's; the same from the route before, which ordered each pair by
    gidx."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stringsearch_tpu.parallel.distsort import (
        redistribute_permutation as jredist,
    )
    from stringsearch_torch.parallel import comm_model

    length = 96
    rng = np.random.default_rng(p)
    gidx = rng.permutation(p * length).astype(I32)
    vals = rng.integers(0, 1 << 30, p * length).astype(I32)
    coll.reset_traffic()
    distsort.fallbacks.clear()
    (got,) = distsort.redistribute_permutation(_shards(gidx, p),
                                               (_shards(vals, p),))
    assert not distsort.fallbacks
    assert coll.bulk_bytes_per_shard(p) == \
        [comm_model.redistribute_bytes_per_device(p, length, 1)] * p
    f = _shard_map(p, lambda g, v: jredist(g, (v,), "parts"), 2,
                   (P("parts"),))
    np.testing.assert_array_equal(
        _cat(got), np.asarray(f(jnp.asarray(gidx), jnp.asarray(vals))[0]))


def _routed_before(monkeypatch):
    """Route as before these kernels: `redistribute_permutation` sorted each
    shard by (dest, gidx), `rank_interval_sort` by dest; the plain
    scatter on the receive side."""
    def before(src, length, p, planes, fills, cap, clamp=False, windows=1):
        return route.plain_route_partition(src, length, p, planes, fills,
                                           cap, clamp,
                                           num_keys=1 if clamp else 2)

    monkeypatch.setattr(distsort, "route_partition", before)
    monkeypatch.setattr(distsort, "place_received",
                        route.plain_place_received)


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("case", ["spread", "giant-group"])
def test_rank_interval_sort_sends_and_output(p, case, monkeypatch):
    """The send buffers equal the JAX arithmetic element for element; the
    output equals JAX's `rank_interval_sort` (unique key tuples), and the
    route before gives the same output, fallbacks and bytes."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stringsearch_tpu.parallel.distsort import (
        rank_interval_sort as jris,
    )

    length = 64
    n = p * length
    rng = np.random.default_rng(p)
    key = np.zeros(n, int) if case == "giant-group" else np.arange(n)
    key = rng.permutation(key)
    rank = np.searchsorted(np.sort(key), key, side="left").astype(I32)
    second = rng.integers(0, 5, n).astype(I32)
    gidx = rng.permutation(n).astype(I32)
    arrays = (rank, second, gidx)
    cap = redistribute_cap(p, length)
    sent = []

    def captured(src, length_, p_, planes, fills, cap_, clamp=False,
                 windows=1):
        out = route.route_partition(src, length_, p_, planes, fills, cap_,
                                    clamp, windows)
        sent.append((src, planes, fills, clamp, windows, out))
        return out

    runs = {}
    for label in ("new", "before"):
        if label == "before":
            _routed_before(monkeypatch)
        else:
            monkeypatch.setattr(distsort, "route_partition", captured)
        coll.reset_traffic()
        distsort.fallbacks.clear()
        out = distsort.rank_interval_sort(
            tuple(_shards(a, p) for a in arrays), 3)
        runs[label] = ([_cat(o) for o in out], dict(distsort.fallbacks),
                       coll.bulk_bytes_per_shard(p))
    assert runs["new"][1:] == runs["before"][1:]
    for a, b in zip(runs["new"][0], runs["before"][0]):
        np.testing.assert_array_equal(a, b)
    assert runs["new"][1] == ({} if case == "spread"
                              else {"rank_interval": 1})
    # every shard's buffers against the JAX arithmetic
    assert len(sent) == p
    for src, planes, fills, clamp, windows, (sends, over, counts) in sent:
        want, want_over = np_route(src.numpy(), length, p,
                                   [x.numpy() for x in planes], fills, cap,
                                   clamp)
        assert clamp and windows == 1
        assert fills == (np.iinfo(I32).max, 0, 0)
        assert int(over) == want_over
        np.testing.assert_array_equal(
            counts.numpy(), np_route_counts(src.numpy(), length, p, clamp))
        for g, w in zip(sends, want):
            np.testing.assert_array_equal(g.numpy(), w)
    f = _shard_map(p, lambda *ops: jris(ops, "parts", num_keys=3), 3,
                   tuple(P("parts") for _ in arrays))
    for g, w in zip(runs["new"][0], f(*map(jnp.asarray, arrays))):
        np.testing.assert_array_equal(g, np.asarray(w))


def _jax_initial(p, depth, text, jidx):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stringsearch_tpu.parallel import global_sa as jg

    f = _shard_map(p, lambda c: jg._initial_shard_ranks(depth, jidx, c), 1,
                   (P("parts"), P("parts"), P("parts"), P()))
    return [np.asarray(x) for x in f(jnp.asarray(text))]


@pytest.mark.parametrize("p", SHARDS)
def test_initial_shard_ranks_and_doubling_step_equal_jax(p):
    """`_initial_shard_ranks` and one `_doubling_step` (fan 3) against the
    JAX functions: ranks, head-slot ranks and tied counts exactly, the
    sorted positions exactly after the round (unique keys) and as sets
    inside each tie group before it (the initial keys tie)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_tpu.parallel import global_sa as jg

    length, depth, fan = 64, 8, 3
    text = np.frombuffer(enwik_like(p * length, seed=p + 1), np.uint8)
    rank, sa, rank_s, count = global_sa._initial_shard_ranks(
        depth, torch.int32, _shards(text, p))
    jrank, jsa, jrank_s, jcount = _jax_initial(p, depth, text, jnp.int32)
    np.testing.assert_array_equal(_cat(rank), jrank)
    np.testing.assert_array_equal(_cat(rank_s), jrank_s)
    assert int(coll.first_local(count)) == int(jcount)
    # each tie group's positions as a set: sorted by (rank_s, sa)
    np.testing.assert_array_equal(
        _cat(sa)[np.lexsort((_cat(sa), _cat(rank_s)))],
        jsa[np.lexsort((jsa, jrank_s))])

    step = global_sa._doubling_step(length, p, torch.int32, depth, rank, fan)
    f = _shard_map(p, lambda r: jg._doubling_step(length, p, jnp.int32,
                                                  depth, r, fan), 1,
                   (P("parts"), P("parts"), P("parts"), P()))
    want = [np.asarray(x) for x in f(jnp.asarray(jrank))]
    for got, w in zip(step[:3], want[:3]):
        np.testing.assert_array_equal(_cat(got), w)
    assert int(coll.first_local(step[3])) == int(want[3])


@pytest.mark.parametrize("idx", ["int32", "int64"])
@pytest.mark.parametrize("p", SHARDS)
def test_build_global_equals_jax_and_the_route_before(p, idx, monkeypatch):
    """SA, rank, rounds against the JAX package; the fallbacks and the
    bytes each shard sent against the route before these kernels."""
    import jax
    import jax.numpy as jnp

    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_tpu.parallel.global_sa import build_global as jbuild
    from stringsearch_tpu.parallel.mesh import make_mesh as jmesh

    text = enwik_like(4000, seed=2)
    with jax.enable_x64(idx == "int64"):
        jgsa = jbuild(text, jmesh(p, 1, jax.devices("cpu")),
                      idx=getattr(jnp, idx))
        jrank, jsa = np.asarray(jgsa.rank), jgsa.suffix_array()
    runs = {}
    for label in ("new", "before"):
        if label == "before":
            _routed_before(monkeypatch)
        coll.reset_traffic()
        distsort.fallbacks.clear()
        global_sa.compact_fallbacks = 0
        g = global_sa.build_global(text, make_mesh(devices=[CPU] * p),
                                   idx=getattr(torch, idx))
        runs[label] = (dict(distsort.fallbacks), global_sa.compact_fallbacks,
                       coll.bulk_bytes_per_shard(p))
        np.testing.assert_array_equal(_cat(g.rank), jrank)
        np.testing.assert_array_equal(g.suffix_array(), jsa)
        assert (g.rounds_run, g.compact_rounds_run) == \
            (jgsa.rounds_run, jgsa.compact_rounds_run)
        assert g.rank[0].dtype == getattr(torch, idx)
    assert runs["new"] == runs["before"]


def test_global_build_goes_through_the_four_steps(monkeypatch):
    """On the CPU the global build reaches every wrapper (each then takes
    its plain version): one route_partition a shard a route, one
    place_received a shard a redistribute, one shard_pack_keys a shard,
    one shard_shift_planes a shard a round."""
    from stringsearch_torch.harness.corpus import enwik_like

    calls = {"route_partition": 0, "place_received": 0,
             "shard_pack_keys": 0, "shard_shift_planes": 0}

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapper)

    for module, name in ((distsort, "route_partition"),
                         (distsort, "place_received"),
                         (global_sa, "shard_pack_keys"),
                         (global_sa, "shard_shift_planes")):
        counted(module, name)
    p = 4
    distsort.fallbacks.clear()
    g = global_sa.build_global(enwik_like(4000, seed=3),
                               make_mesh(devices=[CPU] * p),
                               compaction=False)
    ran = g.rounds_executed
    assert ran >= 1 and not distsort.fallbacks
    assert calls == {"route_partition": p * (1 + 2 * ran),
                     "place_received": p * (1 + ran),
                     "shard_pack_keys": p, "shard_shift_planes": p * ran}


# ---------------------------------------------------------------------------
# the kernels on the card, against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    route.load_library()
    steps.load_library()
    return torch.device("cuda")


def _kernel_route_equals_plain(src, length, p, planes, fills, cap, clamp,
                               cuda, windows=1):
    before = route.launches["route_partition"]
    got = _route_torch(route.route_partition, src, length, p, planes, fills,
                       cap, clamp, cuda, windows)
    torch.cuda.synchronize()
    assert route.launches["route_partition"] == before + 1
    want = _route_torch(route.plain_route_partition, src, length, p, planes,
                        fills, cap, clamp, cuda, windows)
    assert got[1] == want[1]
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    return got[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [I32, I64])
@pytest.mark.parametrize("p", SHARDS + [3, 32])
@pytest.mark.parametrize("case", CASES)
def test_route_partition_kernel_equals_plain(cuda, case, p, dtype):
    for n in (N, (1 << 20) + 12345):
        built = _route_case(case, p, dtype, n)
        if built is None:
            continue
        src, length, cap, clamp = built
        planes, fills = _planes(np.random.default_rng(n), src)
        for windows in {1, 4, route.receiver_windows(p, length)}:
            over = _kernel_route_equals_plain(src, length, p, planes, fills,
                                              cap, clamp, cuda, windows)
            assert over == (case in ("past cap", "out of range"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 2, 31, 32, 33, route.ROUTE_TILE - 1,
                               route.ROUTE_TILE, route.ROUTE_TILE + 1,
                               8 * route.ROUTE_TILE + 5])
def test_route_partition_kernel_at_tile_edges(cuda, n):
    rng = np.random.default_rng(n)
    for p in (1, 2, 5, 8):
        length = max(n // p, 1)
        src = rng.integers(0, p * length, n).astype(I64)
        planes, fills = _planes(rng, src)
        for cap in (1, redistribute_cap(p, length), max(n, 1)):
            for windows in (1, route.MAX_BUCKETS // 8):
                _kernel_route_equals_plain(src, length, p, planes, fills,
                                           cap, False, cuda, windows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [I32, I64])
@pytest.mark.parametrize("p", SHARDS)
def test_place_received_kernel_equals_plain(cuda, p, dtype):
    rng = np.random.default_rng(p)
    for length in (1, 1000, route.PLACE_TILE + 3, (1 << 20) + 7):
        cap = redistribute_cap(p, length)
        gidx = rng.permutation(p * length)
        mine = gidx[(gidx // length) == p - 1]
        recv_g = np.full((p, cap), -1, dtype=dtype)
        for s, part in enumerate(np.array_split(mine, p)):
            recv_g[s, :part.size] = part
        recvs = (torch.from_numpy(rng.integers(-2**31, 2**31, (p, cap))
                                  .astype(I32)).to(cuda),
                 torch.from_numpy(rng.integers(-2**62, 2**62, (p, cap))
                                  .astype(I64)).to(cuda))
        g = torch.from_numpy(recv_g).to(cuda)
        before = route.launches["place_received"]
        got = route.place_received(g, recvs, length)
        torch.cuda.synchronize()
        assert route.launches["place_received"] == before + 1
        want = route.plain_place_received(g, recvs, length)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("length,depth", [
    (length, depth) for length in PACK_SIZES + ((1 << 20) + 13,)
    for depth in (4, 12, 16, 24) if depth <= length])
def test_shard_pack_keys_kernel_equals_plain(cuda, length, depth, idx):
    g = torch.Generator().manual_seed(length)
    chunk = torch.randint(0, 256, (length,), dtype=torch.uint8,
                          generator=g).to(cuda)
    for halo in (None, torch.randint(0, 256, (depth,), dtype=torch.uint8,
                                     generator=g).to(cuda),
                 torch.full((depth,), 255, dtype=torch.uint8, device=cuda)):
        for part in (chunk, chunk[1:] if length > depth else chunk):
            before = steps.launches["shard_pack_keys"]
            got = steps.shard_pack_keys(part, halo, depth, 5 * length, idx)
            torch.cuda.synchronize()
            assert steps.launches["shard_pack_keys"] == before + 1
            want = steps.plain_shard_pack_keys(part, halo, depth, 5 * length,
                                               idx)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("p", SHARDS)
def test_shard_shift_planes_kernel_equals_plain(cuda, p, idx):
    for length in (1, 5, steps.SHIFT_TILE - 1, steps.SHIFT_TILE + 1,
                   (1 << 18) + 3):
        rank = [torch.randperm(p * length)[:length].to(idx).to(cuda)
                for _ in range(p)]
        hs = [h for h in _hs(length, p) if h >= 0]
        windows_of = []
        for me in range(p):
            windows = []
            for h in hs + hs[:1] * 9:  # past one launch's eight planes
                d, r = divmod(h, length)
                head = rank[me + d] if me + d < p else None
                tail = rank[me + d + 1] if r and me + d + 1 < p else None
                windows.append((h, head, tail))
            windows_of.append(windows)
        for me, windows in enumerate(windows_of):
            got = steps.shard_shift_planes(windows, length, me * length,
                                           p * length, idx, cuda)
            want = steps.plain_shard_shift_planes(windows, length,
                                                  me * length, p * length,
                                                  idx, cuda)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("p", SHARDS)
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_global_build_on_the_card_never_takes_the_plain_chains(
        cuda, monkeypatch, p, idx):
    from stringsearch_torch import oracle
    from stringsearch_torch.harness.corpus import enwik_like

    def refused(*args, **kwargs):
        raise AssertionError("a plain version was called on the card")

    for module, name in ((route, "plain_route_partition"),
                         (route, "plain_place_received"),
                         (steps, "plain_shard_pack_keys"),
                         (steps, "plain_shard_shift_planes")):
        monkeypatch.setattr(module, name, refused)
    text = enwik_like(1 << 16, seed=p)
    before = dict(route.launches), dict(steps.launches)
    g = global_sa.build_global(text, make_mesh(devices=[cuda] * p), idx=idx)
    np.testing.assert_array_equal(g.suffix_array(), oracle.build(text))
    for name in route.launches:
        assert route.launches[name] > before[0][name], name
    assert steps.launches["shard_pack_keys"] > before[1]["shard_pack_keys"]
    if g.rounds_executed:
        assert steps.launches["shard_shift_planes"] \
            > before[1]["shard_shift_planes"]
