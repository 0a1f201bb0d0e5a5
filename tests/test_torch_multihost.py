"""Port of parallel/multihost.py: the global build across processes.

Counterpart of tests/test_multihost.py, whose JAX run is slow-marked.
Every case here spawns local processes through `run_selftest`: each joins
a gloo process group over a file rendezvous in the test's `tmp_path`,
holds only its own shards on the CPU, builds, verifies and queries the
exact global suffix array, and writes its report there. Each spawn runs
under a wall limit (`WALL`), and a failed child makes `run_selftest`
raise. The two-process build is held against the single-controller port
build on `[cpu] * P`, against the JAX package's `build_global` on four
devices of the 8-device CPU mesh (tests/conftest.py; one XLA compile, in
the test process) and against `oracle.build`. Everything compared is an
integer: tolerance none. The JAX package is imported inside the one case
that needs it, so that the `cuda` case runs where jax is not installed:
`python -m pytest --noconftest -m cuda tests/test_torch_multihost.py`.
"""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from stringsearch_torch import oracle
from stringsearch_torch.harness.corpus import enwik_like
from stringsearch_torch.parallel import collectives as coll
from stringsearch_torch.parallel import distsort, global_sa, multihost
from stringsearch_torch.parallel.global_sa import build_global
from stringsearch_torch.parallel.mesh import (
    Mesh,
    ShardedSuffixArray,
    make_mesh,
)

CPU = torch.device("cpu")
#: wall limit of one spawn, seconds (a CPU run takes a few)
WALL = 240.0
MODES = ("replicated", "sharded")


def _spawn(tmp_path, **kw) -> list:
    return multihost.run_selftest(device="cpu", timeout=WALL,
                                  workdir=str(tmp_path), **kw)


def _single(text: bytes, p: int, **kw):
    """The single-controller build on [cpu] * p, with its traffic and
    fallbacks."""
    coll.reset_traffic()
    distsort.fallbacks.clear()
    global_sa.compact_fallbacks = 0
    g = build_global(text, make_mesh(devices=[CPU] * p), **kw)
    sent = {kind: {str(s): coll.sent[kind][s] for s in range(p)}
            for kind in coll.KINDS}
    return g, sent, dict(distsort.fallbacks), global_sa.compact_fallbacks


def _merged_sent(reports) -> dict:
    """Every process's per-shard byte counts, by kind."""
    out = {kind: {} for kind in coll.KINDS}
    for r in reports:
        for kind, counts in r["sent"].items():
            out[kind].update(counts)
    return out


@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    """The JAX self-test's case: 2 processes x 2 shards on its text."""
    return _spawn(tmp_path_factory.mktemp("two-by-two"), nproc=2,
                  devs_per_proc=2, arrays=True)


def test_two_processes_equal_single_controller_jax_and_oracle(two_by_two):
    """(a) SA, rank, round counts and the bytes each shard sent."""
    from tests.test_torch_global_sa import _jax_build

    text = multihost.selftest_text()
    g, sent, fell, compact_fell = _single(text, 4)
    jg = _jax_build(text, 4)
    want = oracle.build(text)
    assert [r["parts"] for r in two_by_two] == [[0, 1], [2, 3]]
    for r in two_by_two:
        np.testing.assert_array_equal(r["sa"], want)
        np.testing.assert_array_equal(r["sa"], g.suffix_array())
        np.testing.assert_array_equal(r["sa"], jg.suffix_array())
        np.testing.assert_array_equal(r["rank"], torch.cat(g.rank).numpy())
        np.testing.assert_array_equal(r["rank"], np.asarray(jg.rank))
        assert (r["rounds_run"], r["compact_rounds_run"]) == \
            (g.rounds_run, g.compact_rounds_run) == \
            (jg.rounds_run, jg.compact_rounds_run)
        assert r["bulk_bytes_per_shard"] == [
            sent["ppermute"][str(s)] + sent["all_to_all"][str(s)]
            for s in range(4)]
        assert (r["fallbacks"], r["compact_fallbacks"]) == (fell,
                                                            compact_fell)
        assert max(r["bulk_bytes_per_shard"]) == r["expected_bytes"]
        assert r["crossed"] > 0
    assert _merged_sent(two_by_two) == sent


def test_two_processes_verify_and_query_like_single_controller(two_by_two):
    """(d) verify passed, and raised on a corrupted rank, in every process
    (each child checks both, or fails); the LCS batch in both text modes,
    `sa_search_batch`, `sa_simplesearch` and the mesh-sharded partitioned
    index answer as the single controller; `gather_to_host` gives every
    process the same array."""
    text = multihost.selftest_text()
    g, *_ = _single(text, 4)
    needles = multihost.selftest_needles(np.frombuffer(text, np.uint8))
    for mode in MODES:
        lcs = [[m.start, m.len]
               for m in g.longest_substring_match_batch(needles, mode)]
        search = [list(x) for x in g.sa_search_batch(needles, mode)]
        simple = [list(g.sa_simplesearch(c, mode))
                  for c in multihost.SELFTEST_BYTES]
        for r in two_by_two:
            assert r[f"lcs_{mode}"] == lcs
            assert r[f"search_{mode}"] == search
            assert r[f"simple_{mode}"] == simple
    sharded = [[m.start, m.len] for m in ShardedSuffixArray(
        text, make_mesh(devices=[CPU] * 4)).longest_substring_match_batch(
            needles)]
    for r in two_by_two:
        assert r["verify_s"] >= 0
        assert r["sharded_lcs"] == sharded
    assert len({r["sa_sha1"] for r in two_by_two}) == 1


EIGHT_SHARD_TEXTS = {
    "ab*2048": b"ab" * 2048,
    "equal-4096": bytes([7]) * 4096,
    # a tie group straddling a shard boundary past the interval sort's
    # capacity: the "rank_interval_boundary" fallback
    "near-repeat-4096": (b"abcabcabd" * 512)[:4096],
}


@pytest.mark.parametrize("name", sorted(EIGHT_SHARD_TEXTS))
def test_eight_shards_fall_back_as_the_single_controller(name, tmp_path):
    """(b) 2 x 4 shards: equal to the oracle, and the merge-split
    fallbacks (which cross processes here) as the single controller's."""
    text = EIGHT_SHARD_TEXTS[name]
    _g, sent, fell, compact_fell = _single(text, 8)
    assert sum(fell.values()) > 0
    reports = _spawn(tmp_path, nproc=2, devs_per_proc=4, text=text,
                     want=oracle.build(text))
    for r in reports:
        assert (r["fallbacks"], r["compact_fallbacks"]) == (fell,
                                                            compact_fell)
    assert _merged_sent(reports) == sent


def test_compacted_rounds_write_back_across_processes(tmp_path):
    """(b) 2 x 1 shards on a text whose compacted rounds succeed (at P = 2
    the capped gather cannot overflow): the straddle, the spill and the
    text-order write-back cross processes; equal to the oracle, with the
    single controller's round counts and traffic."""
    rng = np.random.default_rng(1)
    text = bytearray(rng.integers(0, 256, 4096, dtype=np.uint8))
    for at in (1000, 2500, 3500):
        text[at:at + 100] = text[100:200]
    text = bytes(text)
    g, sent, fell, compact_fell = _single(text, 2)
    assert g.compact_rounds_executed > 0 and compact_fell == 0
    reports = _spawn(tmp_path, nproc=2, devs_per_proc=1, text=text,
                     arrays=True)
    for r in reports:
        np.testing.assert_array_equal(r["sa"], oracle.build(text))
        assert (r["compact_rounds_executed"], r["compact_fallbacks"]) == \
            (g.compact_rounds_executed, 0)
    assert _merged_sent(reports) == sent


def test_four_processes_int64(tmp_path):
    """(c) 4 processes x 1 shard, idx=int64, equal to the oracle."""
    text = enwik_like(1 << 14, seed=7)
    g, sent, *_ = _single(text, 4, idx=torch.int64)
    reports = _spawn(tmp_path, nproc=4, devs_per_proc=1, text=text,
                     idx=torch.int64, arrays=True)
    assert [r["parts"] for r in reports] == [[0], [1], [2], [3]]
    for r in reports:
        assert r["sa"].dtype == np.int64 and r["rank"].dtype == np.int64
        np.testing.assert_array_equal(r["sa"], oracle.build(text))
        np.testing.assert_array_equal(r["rank"], torch.cat(g.rank).numpy())
    assert _merged_sent(reports) == sent


def test_a_child_that_fails_early_makes_run_selftest_raise(tmp_path):
    """(e) An expected SA that is wrong in the second process's shards only:
    that process fails its check and exits while the first waits in the
    next collective; run_selftest kills it and raises, long before the
    process group's timeout."""
    text = multihost.selftest_text()
    want = oracle.build(text)
    want[3000], want[3001] = want[3001], want[3000]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited"):
        _spawn(tmp_path, nproc=2, devs_per_proc=2, want=want)
    assert time.monotonic() - t0 < multihost.TIMEOUT_S / 2


def test_wait_all_kills_the_rest():
    """(e) The monitor: a child that exits non-zero, or the deadline,
    kills every other child and raises."""
    def spawn(code):
        return subprocess.Popen([sys.executable, "-c", code])

    procs = [spawn("import sys; sys.exit(3)"),
             spawn("import time; time.sleep(600)")]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited"):
        multihost._wait_all(procs, timeout=WALL)
    assert time.monotonic() - t0 < 60
    assert all(p.poll() is not None for p in procs)
    procs = [spawn("import time; time.sleep(600)") for _ in range(2)]
    with pytest.raises(TimeoutError):
        multihost._wait_all(procs, timeout=1.0)
    assert all(p.poll() is not None for p in procs)


def test_one_process_group_and_no_switch_of_backend(tmp_path):
    """A group of one process: `initialize` is idempotent, its mesh owns
    every shard (so every collective runs the single-controller body) and
    builds the single controller's SA; `shutdown` leaves no transport. A
    backend that cannot run here (NCCL on the CPU) raises: nothing falls
    back to gloo."""
    init = f"file://{tmp_path}/rendezvous"
    assert multihost.initialize(init, 1, 0, device="cpu")
    try:
        assert coll.transport().backend == "gloo"
        assert multihost.initialize() is True
        mesh = multihost.device_mesh(devices=[CPU] * 2)
        assert mesh.owners == (0, 0) and mesh.local_parts == [0, 1]
        text = enwik_like(2000, seed=3)
        np.testing.assert_array_equal(build_global(text, mesh).suffix_array(),
                                      oracle.build(text))
    finally:
        multihost.shutdown()
    assert coll.transport() is None
    with pytest.raises((RuntimeError, ValueError)):
        multihost.initialize(f"file://{tmp_path}/nccl", 1, 0,
                             backend="nccl", device="cpu")
    assert coll.transport() is None


def test_staging_follows_the_backend():
    """(f) gloo stages every transfer through the host; nccl hands over
    tensors on the process's own device. `meta` stands in for the card."""
    x = torch.arange(6, dtype=torch.int32)
    gloo = coll.Transport("gloo", 0, 2, "meta")
    nccl = coll.Transport("nccl", 0, 2, "meta")
    assert gloo.staged and not nccl.staged
    assert gloo.wire_device == CPU
    assert nccl.wire_device == torch.device("meta")
    assert gloo.buffer(x.to("meta")).device == CPU
    assert nccl.buffer(x).device == torch.device("meta")
    assert gloo.outbound(x) is x
    assert nccl.outbound(x).device == torch.device("meta")
    with pytest.raises(ValueError, match="backend"):
        coll.Transport("mpi", 0, 2, "cpu")


def test_mesh_owners_and_single_process_entry(monkeypatch):
    """A mesh names each row's owner; with no transport this process is
    rank 0, `initialize` has nothing to join, `device_mesh` is a single
    controller's mesh trimmed to a power of two, and a list with remote
    shards is refused."""
    mesh = Mesh([[CPU]] * 4, owners=[0, 0, 1, 1])
    assert mesh.local_parts == [0, 1]
    assert mesh.is_local(1) and not mesh.is_local(2)
    assert make_mesh(devices=[CPU] * 4).local_parts == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="owners"):
        Mesh([[CPU]] * 4, owners=[0, 1])
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert coll.transport() is None
    m6 = multihost.device_mesh(devices=[CPU] * 6)
    assert m6.shape == {"parts": 4, "batch": 1} and m6.owners is None
    with pytest.raises(RuntimeError, match="transport"):
        mesh.bind()
    with pytest.raises(RuntimeError, match="transport"):
        coll.psum([torch.tensor(1), None])


def test_ppermute_holds_jax_shape_rule():
    """Every shard's operand has one shape and dtype: a receiver sizes its
    buffer by its own tensor across processes, so the single controller
    refuses a pair that breaks the rule."""
    xs = [torch.zeros(2, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)]
    with pytest.raises(AssertionError, match="ppermute 0->1"):
        coll.ppermute(xs, [(0, 1)])
    ys = [torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int64)]
    with pytest.raises(AssertionError, match="ppermute 1->0"):
        coll.ppermute(ys, [(1, 0)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_two_processes_on_the_card(cuda, tmp_path):
    """(g) 2 processes x 2 shards of one card at 2^20, gloo staging
    through the host (NCCL refuses two ranks on one card): the radix sort
    runs in both processes, the plain sort in neither (each child checks),
    and the SA equals the oracle's."""
    text = enwik_like(1 << 20, seed=7)
    reports = multihost.run_selftest(nproc=2, devs_per_proc=2,
                                     device="cuda", backend="gloo",
                                     text=text, timeout=WALL,
                                     workdir=str(tmp_path))
    for r in reports:
        assert r["backend"] == "gloo" and r["device"].startswith("cuda")
        assert r["radix_launches"] > 0 and r["plain_sort_calls"] == 0
        assert r["merge_launches"] > 0 and r["head_ranks_launches"] > 0
        assert r["peak_bytes"] > 0
