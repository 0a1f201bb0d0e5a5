"""The routing kernels' limits: any operand count and any shard count.

On the card one library call of `route_partition` takes at most
`route.MAX_BUCKETS` buckets (destinations times windows) and
`route.MAX_PLANES` operands, and one call of `place_received` at most
`route.MAX_PLANES` operands; the wrappers make their calls as
`route.launch_plan` says (a bucket range at a time, a group of operands
at a time in each, the range's first call running its count and scan),
so neither function has a limit of its own. A round of the global build
routes fan + 1 operands, `(rank, *shifts, gidx)`, and the JAX package
takes any fan >= 2 and any shard count.

On the CPU the plain versions run, which have no limit either. So the
guard here records every `route_partition` and `place_received` call of
`build_global` and hands each to the CUDA wrapper's own code
(`route.launch_route`, `route.launch_place`) on a stand-in for the
kernel library, which refuses a call past the C entry points' limits and
records the rest: every call within one call's buckets and operands, the
calls of a route covering its buckets and operands once each, the count
and scan once a range, while the SA at fan 2, 3, 8 and 9 on four shards
equals `oracle.build` and at fan 8 the JAX package's SA, rank and
rounds. `plain_route_partition` is held against the numpy model of
tests/test_torch_route.py with 9 to 17 operands, mixed int32 and int64,
and with more buckets than one call takes. Everything compared is an
integer: tolerance 0.

Tests marked `cuda` hold the kernels against their plain versions on the
card (9 to 17 operands, bucket counts past one call's, 512 destinations,
128, 256 and 512 windows a destination, n around the tiles) and build at
fan 8 and 9 and on 512 shards of the card against the oracle; they skip
without one. Run them with
`python -m pytest --noconftest -m cuda tests/test_torch_route_caps.py`.
"""

import numpy as np
import pytest
import torch

from stringsearch_torch.ops import route
from stringsearch_torch.parallel import distsort, global_sa
from stringsearch_torch.parallel.distsort import redistribute_cap
from stringsearch_torch.parallel.mesh import make_mesh
from test_torch_route import _route_torch, np_route

CPU = torch.device("cpu")
I32, I64 = np.int32, np.int64
# the text of test_torch_route.py's build against the JAX package
TEXT_LEN, TEXT_SEED = 4000, 2


def _wide_planes(rng, src, count):
    """src, then count - 1 payloads alternating int32 and int64, with
    fills at each type's edge."""
    n = src.shape[0]
    planes, fills = [src], [-1]
    for c in range(1, count):
        if c % 2:
            planes.append(rng.integers(-2**31, 2**31, n).astype(I32))
            fills.append(np.iinfo(I32).min + c)
        else:
            planes.append(rng.integers(-2**62, 2**62, n).astype(I64))
            fills.append(np.iinfo(I64).max - c)
    return planes, fills


# ---------------------------------------------------------------------------
# the split, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,windows,planes", [
    (1, 1, 1), (4, 1, 9), (4, 256, 17), (4, 512, 2), (8, 128, 8),
    (512, 1, 4), (1100, 1, 3), (1, 3000, 1), (3, 700, 16)])
def test_launch_plan_covers_every_bucket_and_operand(p, windows, planes):
    """Consecutive bucket ranges of at most MAX_BUCKETS from 0 to p *
    windows, each with the same operand groups of at most MAX_PLANES
    covering the operands in order."""
    plan = route.launch_plan(p, windows, planes)
    assert plan[0][0] == 0
    at = 0
    for bucket0, buckets, groups in plan:
        assert bucket0 == at and 1 <= buckets <= route.MAX_BUCKETS
        at += buckets
        c = 0
        for first, count in groups:
            assert first == c and 1 <= count <= route.MAX_PLANES
            c += count
        assert c == planes
    assert at == p * windows
    assert len(plan) == -(-p * windows // route.MAX_BUCKETS)
    assert len(plan[0][2]) == -(-planes // route.MAX_PLANES)


def test_receiver_windows_at_the_bucket_cap():
    """At four shards of 2^26 the window fits one cluster and the four
    destinations fill one call; past MAX_BUCKETS / 2 shards one window;
    the windows never make a second call."""
    slots = route.PLACE_CLUSTER_BYTES // 4
    w = route.receiver_windows(4, 1 << 26)
    assert 4 * w == route.MAX_BUCKETS and (1 << 26) // w == slots
    for p in (2, 3, 4, 8, 100, route.MAX_BUCKETS // 2, route.MAX_BUCKETS,
              route.MAX_BUCKETS + 1, 4096):
        for length in (64, 1 << 18, (1 << 20) + 3, 1 << 26, 1 << 30):
            w = route.receiver_windows(p, length)
            assert len(route.launch_plan(p, w, 2)) == \
                -(-p // route.MAX_BUCKETS)
            if p > route.MAX_BUCKETS // 2:
                assert w == 1


@pytest.mark.parametrize("count", [9, 12, 17])
@pytest.mark.parametrize("p,windows", [(4, 1), (4, 300), (1100, 1)])
def test_plain_route_takes_any_width_and_bucket_count(count, p, windows):
    """9 to 17 operands, mixed int32 and int64, and more buckets than one
    call takes, against the numpy model: clamped sources with one
    destination past its cap."""
    n = 3 * route.ROUTE_TILE + 7
    rng = np.random.default_rng([count, p, windows])
    length = max(n // p, 1)
    cap = redistribute_cap(p, length)
    src = rng.integers(-length // 10, p * length + length // 10, n)
    src[:cap + 1] = length // 3  # destination 0 past its cap
    src = rng.permutation(src).astype(I64)
    planes, fills = _wide_planes(rng, src, count)
    want, want_over = np_route(src, length, p, planes, fills, cap, True,
                               windows)
    got, over = _route_torch(route.route_partition, src, length, p, planes,
                             fills, cap, True, windows=windows)
    assert over == want_over == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


class StandInLibrary:
    """The kernel library (`route.LIBRARY`, a `_build.Library`) on the CPU,
    for the wrappers' `launch_route` and `launch_place`: each call is held
    to the argument checks of `ss_route_partition` and `ss_place_received`
    in csrc/route.cu and recorded; nothing is computed."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def ss_route_scratch_bytes(n, buckets, dests):
        return 8

    @staticmethod
    def ss_place_scratch_bytes(rows, windows):
        return 8

    def load(self):
        return self

    def call(self, fn, _device, *args):
        if fn == "ss_route_partition":
            (_src, _sb, _n, _length, dests, windows, _clamp, bucket0,
             buckets, count, ins, _outs, widths, _fills, planes, _cap,
             _over, _scratch) = args
            assert 1 <= buckets <= route.MAX_BUCKETS
            assert 0 <= bucket0 and bucket0 + buckets <= dests * windows
        else:
            assert fn == "ss_place_received"
            (_g, _gb, _rows, _cols, _length, _windows, count, ins, _outs,
             widths, planes, _scratch) = args
            bucket0 = buckets = None
        assert 1 <= planes <= route.MAX_PLANES
        assert all(w in (4, 8) for w in widths[:planes])
        self.calls.append((fn, bucket0, buckets, bool(count),
                           tuple(ins[:planes])))
        return 0


class Recorded:
    """The distributed sort's `route_partition` and `place_received`: each
    call recorded as (function, p, windows, operands) and replayed through
    the CUDA wrapper's code on a `StandInLibrary`, whose calls are checked
    here against the call they came from."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.library_calls = 0
        monkeypatch.setattr(distsort, "route_partition", self.route)
        monkeypatch.setattr(distsort, "place_received", self.place)

    def route(self, src, length, p, planes, fills, cap, clamp=False,
              windows=1):
        self.calls.append(("route_partition", p, windows, len(planes)))
        lib = StandInLibrary()
        _sends, _over, _counts, calls = route.launch_route(
            lib, src, length, p, planes, fills, cap, clamp, windows)
        assert calls == len(lib.calls)
        # consecutive bucket ranges from 0 to p * windows; in each, every
        # operand once and in order, the first call running the count
        ptrs = tuple(t.data_ptr() for t in planes)
        starts = [bucket0 for _fn, bucket0, *_ in lib.calls]
        assert starts == sorted(starts)
        ranges = {}
        for _fn, bucket0, buckets, count, ins in lib.calls:
            ranges.setdefault((bucket0, buckets), []).append((count, ins))
        at = 0
        for (bucket0, buckets), group in ranges.items():
            assert bucket0 == at
            at += buckets
            assert [c for c, _ in group] == [True] + [False] * (
                len(group) - 1)
            assert sum((ins for _, ins in group), ()) == ptrs
        assert at == p * windows
        self.library_calls += calls
        return route.route_partition(src, length, p, planes, fills, cap,
                                     clamp, windows)

    def place(self, recv_g, recvs, length, windows=1):
        self.calls.append(("place_received", 1, 1, len(recvs)))
        lib = StandInLibrary()
        _outs, calls = route.launch_place(lib, recv_g, recvs, length,
                                          windows)
        assert calls == len(lib.calls)
        assert [c for *_, c, _ins in lib.calls] == [True] + [False] * (
            calls - 1)
        assert sum((ins for *_, ins in lib.calls), ()) == tuple(
            t.data_ptr() for t in recvs)
        self.library_calls += calls
        return route.place_received(recv_g, recvs, length, windows)


@pytest.mark.parametrize("fan", [2, 3, 8, 9])
def test_every_global_build_routes_within_the_launch_limits(fan,
                                                            monkeypatch):
    """`build_global` at fan 2, 3, 8 and 9 on four shards: the SA equals
    `oracle.build`, a round's route carries fan + 1 operands, and the CUDA
    wrapper's calls for every route and placement of the build stay
    within one call's buckets and operands and cover each route once;
    past MAX_PLANES operands a route takes more calls than ranges."""
    from stringsearch_torch import oracle
    from stringsearch_torch.harness.corpus import enwik_like

    text = enwik_like(TEXT_LEN, seed=TEXT_SEED)
    rec = Recorded(monkeypatch)
    distsort.fallbacks.clear()
    g = global_sa.build_global(text, make_mesh(devices=[CPU] * 4), fan=fan,
                               compaction=False)
    np.testing.assert_array_equal(g.suffix_array(), oracle.build(text))
    assert g.rounds_executed >= 1
    widths = {planes for fn, _p, _w, planes in rec.calls
              if fn == "route_partition"}
    assert fan + 1 in widths
    ranges = sum(len(route.launch_plan(p, w, 1)) for fn, p, w, _ in rec.calls
                 if fn == "route_partition")
    routed = sum(1 for fn, *_ in rec.calls if fn == "route_partition")
    placed = len(rec.calls) - routed
    assert routed and placed
    assert (fan + 1 > route.MAX_PLANES) == (
        rec.library_calls > ranges + placed)


def test_fan_8_build_equals_jax(monkeypatch):
    """SA, rank and rounds of the fan-8 build on four shards against the
    JAX package's, with every route recorded as above."""
    import jax

    from stringsearch_torch.harness.corpus import enwik_like
    from stringsearch_tpu.parallel.global_sa import build_global as jbuild
    from stringsearch_tpu.parallel.mesh import make_mesh as jmesh

    text = enwik_like(TEXT_LEN, seed=TEXT_SEED)
    jgsa = jbuild(text, jmesh(4, 1, jax.devices("cpu")), fan=8)
    rec = Recorded(monkeypatch)
    g = global_sa.build_global(text, make_mesh(devices=[CPU] * 4), fan=8)
    np.testing.assert_array_equal(
        torch.cat([r.cpu() for r in g.rank]).numpy(), np.asarray(jgsa.rank))
    np.testing.assert_array_equal(g.suffix_array(), jgsa.suffix_array())
    assert (g.rounds_run, g.compact_rounds_run) == \
        (jgsa.rounds_run, jgsa.compact_rounds_run)
    assert any(planes == 9 for fn, _p, _w, planes in rec.calls
               if fn == "route_partition")


# ---------------------------------------------------------------------------
# the kernels on the card, against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    route.load_library()
    return torch.device("cuda")


def _kernel_equals_plain(src, length, p, planes, fills, cap, clamp, cuda,
                         windows):
    before = route.launches["route_partition"]
    got = _route_torch(route.route_partition, src, length, p, planes, fills,
                       cap, clamp, cuda, windows)
    torch.cuda.synchronize()
    assert route.launches["route_partition"] == before + sum(
        len(groups) for *_, groups in route.launch_plan(p, windows,
                                                         len(planes)))
    want = _route_torch(route.plain_route_partition, src, length, p, planes,
                        fills, cap, clamp, cuda, windows)
    assert got[1] == want[1]
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    return got[1]


@pytest.mark.cuda
@pytest.mark.parametrize("count", [9, 13, 17])
@pytest.mark.parametrize("p,windows", [(4, 1), (4, 256), (4, 512), (512, 1),
                                       (1100, 1), (1, 2000), (3, 700)])
def test_route_kernel_any_width_and_bucket_count(cuda, count, p, windows):
    for n in (route.ROUTE_TILE - 1, 5 * route.ROUTE_TILE + 3,
              (1 << 20) + 12345):
        rng = np.random.default_rng([count, p, windows, n])
        length = max(n // p, 1)
        cap = redistribute_cap(p, length)
        for clamp in (False, True):
            src = rng.integers(0, p * length, n)
            if clamp:
                src = rng.integers(-length, (p + 1) * length, n)
            else:
                src[rng.integers(0, n, 3)] = p * length + 5  # unroutable
            planes, fills = _wide_planes(rng, src.astype(I32), count)
            over = _kernel_equals_plain(planes[0], length, p, planes, fills,
                                        cap, clamp, cuda, windows)
            assert clamp or over == 1


@pytest.mark.cuda
@pytest.mark.parametrize("windows", [4, 128, 256, 512])
@pytest.mark.parametrize("dtype", [I32, I64])
def test_windowed_route_and_placement_equal_plain(cuda, windows, dtype):
    """The permutation route of each shard of four with 4, 128, 256 and
    512 windows a destination (512: two bucket ranges; 4 at 2^22 slots: a
    window wider than a cluster, placed by the scatter), then the
    placement of what shard 1 receives, with two operands, against the
    plain versions."""
    p = 4
    for length in ((1 << 20) + 7, 1 << 22):
        gen = torch.Generator().manual_seed(length + windows)
        gidx = torch.randperm(p * length, generator=gen).to(
            torch.from_numpy(np.zeros(0, dtype)).dtype)
        vals = torch.randint(-2**31, 2**31, (p * length,), generator=gen,
                             dtype=torch.int64)
        cap = redistribute_cap(p, length)
        shards = [t.to(cuda) for t in gidx.view(p, length)]
        payload = [t.to(cuda) for t in vals.view(p, length)]
        sends = []
        for me in range(p):
            planes = (shards[me], payload[me], payload[me].to(torch.int32))
            args = (shards[me], length, p, planes, (-1, 0, 0), cap, False,
                    windows)
            got = route.route_partition(*args)
            want = route.plain_route_partition(*args)
            assert int(got[1]) == int(want[1]) == 0
            for a, b in zip(got[0], want[0]):
                assert torch.equal(a, b)
            sends.append(got[0])
        recv = [torch.cat([sends[s][k][1] for s in range(p)]).view(p, cap)
                for k in range(3)]
        before = route.launches["place_received"]
        got = route.place_received(recv[0], recv[1:], length, windows)
        torch.cuda.synchronize()
        assert route.launches["place_received"] == before + 1
        want = route.plain_place_received(recv[0], recv[1:], length)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("count", [1, 9, 17])
def test_placement_any_width(cuda, count):
    """9 and 17 operands (two and three library calls), rows in no window
    order and by window, against the plain scatter."""
    p, length = 4, (1 << 19) + 5
    cap = redistribute_cap(p, length)
    gen = torch.Generator().manual_seed(count)
    perm = torch.randperm(p * length, generator=gen)
    mine = perm[perm // length == 2]
    for windows in (1, 64):
        recv_g = torch.full((p, cap), -1, dtype=torch.int64)
        parts = torch.tensor_split(mine, p)
        for s, part in enumerate(parts):
            if windows > 1:
                sub = -(-length // windows)
                part = part[torch.sort((part % length) // sub,
                                       stable=True).indices]
            recv_g[s, :part.numel()] = part
        recv_g = recv_g.to(cuda)
        recvs = [torch.randint(-2**31, 2**31, (p, cap), generator=gen,
                               dtype=torch.int64)
                 .to(torch.int32 if c % 2 else torch.int64).to(cuda)
                 for c in range(count)]
        before = route.launches["place_received"]
        got = route.place_received(recv_g, recvs, length, windows)
        assert route.launches["place_received"] == \
            before - (-count // route.MAX_PLANES)
        want = route.plain_place_received(recv_g, recvs, length)
        assert len(got) == count
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("fan", [8, 9])
def test_global_build_at_fan_8_and_9_on_the_card(cuda, fan):
    from stringsearch_torch import oracle
    from stringsearch_torch.harness.corpus import enwik_like

    text = enwik_like(1 << 16, seed=fan)
    g = global_sa.build_global(text, make_mesh(devices=[cuda] * 4), fan=fan)
    np.testing.assert_array_equal(g.suffix_array(), oracle.build(text))
    g.verify()


@pytest.mark.cuda
def test_global_build_on_512_shards_of_the_card(cuda):
    from stringsearch_torch import oracle
    from stringsearch_torch.harness.corpus import enwik_like

    text = enwik_like(512 * 4096, seed=512)
    g = global_sa.build_global(text, make_mesh(devices=[cuda] * 512))
    np.testing.assert_array_equal(g.suffix_array(), oracle.build(text))
