"""Multi-process entry of the exact global index: a mesh across processes.

Counterpart of stringsearch_tpu/parallel/multihost.py. The JAX package
scales past one host by running the same `shard_map` programs over a mesh
whose devices span processes, once `jax.distributed.initialize` has run
in every process. Here `initialize` starts a `torch.distributed` process
group and activates a transport under the collectives of
`parallel/collectives.py`; `device_mesh` builds a "parts" mesh over every
process's devices, each row owned by the process that contributed it.
The global layer (`global_sa`, `distsort`, `gather`, `mesh`) then runs
unchanged in behaviour, each process holding only its own shards.

Usage (one command per process; every process passes the whole text):

    MASTER_ADDR=host0 MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 python build.py

    # build.py
    from stringsearch_torch.parallel import multihost
    from stringsearch_torch.parallel.global_sa import build_global
    multihost.initialize()             # torch's standard variables
    mesh = multihost.device_mesh()     # ("parts",) over every process's cards
    g = build_global(text, mesh)       # exact global SA across processes
    g.verify(); sa = g.suffix_array()  # collectives: every process calls
    multihost.shutdown()

Simulated multi-process run on one machine (two local processes, each
with two shards, collectives over a file rendezvous):

    python -m stringsearch_torch.parallel.multihost --selftest [--device cpu]

This is also exercised by tests/test_torch_multihost.py and by phase 14 of
chip_smoke.py.

What differs from the JAX package, and why:
  * The defaults of `initialize` come from torch's variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as `torchrun` sets them)
    in place of JAX_*; with neither an address nor a world size there is
    nothing to join, and it returns False (a single controller), as JAX's
    no-argument form does off a pod. A failed `init_process_group` raises.
  * `backend` is nccl for a CUDA device and gloo for the CPU unless the
    caller names one; nothing switches from one to the other. NCCL refuses
    two ranks on one card, so processes that share a card use gloo, which
    stages every transfer through the host.
  * `device_mesh` takes each process's devices (every visible CUDA device
    by default; a list may repeat a device, as `[cuda] * 2` on one card)
    and needs every process to keep at least one shard after the trim to
    a power of two: each process contributes to every reduction.
  * The self-test checks more than the JAX one (verify and its catch of a
    corrupted rank, the three query kinds in both text modes, traffic and
    launch counts) and reports to its caller through files.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from stringsearch_torch.parallel import collectives as coll

#: the process group's timeout: a collective that one process skips fails
#: after this long instead of hanging (torch's default is 30 minutes)
TIMEOUT_S = 300.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Idempotent: join the process group and activate the transport.

    `coordinator_address` is "host:port" (a TCP rendezvous) or an
    init-method URL such as "file:///path". The arguments default to
    MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK. `device` is the device
    this process works on: a CUDA device without an index is card
    LOCAL_RANK (modulo the cards visible), or the current card where
    LOCAL_RANK is not set. `backend` defaults to nccl for a CUDA device
    and gloo otherwise. Returns True if distributed mode is active after
    the call.
    """
    import torch.distributed as dist

    if coll.transport() is not None:
        return True
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs the coordinator address, the "
                         "number of processes and this process's id")
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "host")
    if device.type == "cuda" and device.index is None:
        local = env.get("LOCAL_RANK")
        device = torch.device("cuda", (
            int(local) % torch.cuda.device_count() if local
            else torch.cuda.current_device()))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    transport = coll.Transport(backend, process_id, num_processes, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        # the group's first collective, every rank in it (NCCL's batched
        # point-to-point calls need one before them)
        ones = torch.ones(1, dtype=torch.int32,
                          device=transport.wire_device)
        dist.all_reduce(ones)
        if int(ones.item()) != num_processes:
            raise RuntimeError(f"{int(ones.item())} of {num_processes} "
                               f"processes answered")
    except BaseException:
        dist.destroy_process_group()
        raise
    coll.activate(transport)
    return True


def shutdown() -> None:
    """Leave the process group; the collectives go back to a single
    controller."""
    import torch.distributed as dist

    if coll.transport() is None:
        return
    coll.deactivate()
    dist.destroy_process_group()


def device_mesh(batch_axis: int = 1, devices=None):
    """A ("parts", "batch") mesh over every process's devices.

    Each process contributes `devices` (default every visible CUDA
    device); the lists are gathered in rank order and the "parts" axis
    trimmed to the largest power of two, so the merge-split distributed
    sort (parallel/distsort.py) can run on it. A row belongs to the process
    that contributed its devices.
    """
    from stringsearch_torch.parallel.mesh import Mesh, _visible_cuda_devices

    local = ([torch.device(d) for d in devices] if devices is not None
             else _visible_cuda_devices())
    t = coll.transport()
    if t is None:
        everyone = [[str(d) for d in local]]
    else:
        import torch.distributed as dist

        everyone = [None] * t.world
        dist.all_gather_object(everyone, [str(d) for d in local])
    names = [d for devs in everyone for d in devs]
    owners = [r for r, devs in enumerate(everyone) for _ in devs]
    n = len(names)
    while n & (n - 1):
        n -= 1
    if n == 0 or n % batch_axis:
        raise ValueError(f"{n} devices not divisible by batch_axis="
                         f"{batch_axis}")
    rows = [names[i:i + batch_axis] for i in range(0, n, batch_axis)]
    row_owners = [owners[i] for i in range(0, n, batch_axis)]
    if any(owners[i] != owners[i - i % batch_axis] for i in range(n)):
        raise ValueError(f"a row of batch_axis={batch_axis} devices spans "
                         f"two processes")
    if t is None:
        return Mesh(rows)
    idle = sorted(set(range(t.world)) - set(row_owners))
    if idle:
        raise ValueError(f"processes {idle} hold no shard of the "
                         f"{len(rows)}-part mesh")
    return Mesh(rows, row_owners)


def gather_to_host(sharded) -> np.ndarray:
    """The concatenation of a sharded array's shards as a host array, in
    every process (a collective when the shards span processes)."""
    return coll.gather_to_host(list(sharded))


# ---------------------------------------------------------------------------
# simulated multi-process self-test (a file rendezvous, local processes)
# ---------------------------------------------------------------------------

_IDX = {"int32": torch.int32, "int64": torch.int64}


def selftest_text() -> bytes:
    """The JAX self-test's text: 4096 bytes over an alphabet of 8."""
    rng = np.random.default_rng(7)
    return rng.integers(0, 8, 4096).astype(np.uint8).tobytes()


def selftest_needles(text: np.ndarray) -> list:
    """The needles every self-test process queries: substrings of the text
    and random bytes."""
    rng = np.random.default_rng(11)
    n = len(text)
    out = []
    for i in range(16):
        m = int(rng.integers(1, 24))
        s = int(rng.integers(0, max(n - m, 1)))
        out.append(text[s:s + m].tobytes() if i % 4 else
                   rng.integers(0, 256, m, dtype=np.uint8).tobytes())
    return out


#: the bytes of the self-test's single-byte searches
SELFTEST_BYTES = (0, 1, 7, 97, 255)
# the global build's routing and placement kernels (`ops/route.py`,
# `ops/steps.py`), whose launches a self-test build counts
ROUTE_STEPS = ("route_partition", "place_received", "shard_pack_keys",
               "shard_shift_planes")


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"multihost selftest: {what}")


def _selftest_run(pid: int, devs_per_proc: int, work: str, idx,
                  builds: int, arrays: bool) -> dict:
    """One process's part of the self-test; returns its report."""
    import torch.distributed as dist

    from stringsearch_torch import NotSorted
    from stringsearch_torch.ops import merge, radix_sort, route, steps
    from stringsearch_torch.ops.bitonic import PlainSortCalls
    from stringsearch_torch.parallel import distsort, global_sa
    from stringsearch_torch.parallel.comm_model import executed_bytes
    from stringsearch_torch.parallel.global_sa import build_global
    from stringsearch_torch.parallel.mesh import ShardedSuffixArray

    dev = coll.transport().device
    cuda = dev.type == "cuda"
    mesh = device_mesh(devices=[dev] * devs_per_proc)
    p = mesh.shape["parts"]
    text = np.load(os.path.join(work, "text.npy"))
    want = np.load(os.path.join(work, "want.npy"), mmap_mode="r")
    n = len(text)

    walls, g = [], None
    for _ in range(builds):
        g = None
        coll.reset_traffic()
        distsort.fallbacks.clear()
        global_sa.compact_fallbacks = 0
        radix_sort.launches = 0
        merge.launches = 0
        for name in ROUTE_STEPS:
            (route if name in route.launches else steps).launches[name] = 0
        steps.launches["shard_head_ranks"] = 0
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        with PlainSortCalls() as plain:
            t0 = time.perf_counter()
            g = build_global(text, mesh, idx=idx)
            if cuda:
                torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    report = {
        "pid": pid, "parts": mesh.local_parts, "owners": list(mesh.owners),
        "device": str(dev), "backend": coll.transport().backend, "n": n,
        "shards": p, "chunk_len": g.chunk_len, "walls_s": walls,
        "rounds_run": g.rounds_run, "rounds_executed": g.rounds_executed,
        "compact_rounds_run": g.compact_rounds_run,
        "compact_rounds_executed": g.compact_rounds_executed,
        "sent": {kind: {str(s): coll.sent[kind][s] for s in mesh.local_parts}
                 for kind in coll.KINDS},
        "crossed": coll.crossed, "transport_s": coll.transport_s,
        "fallbacks": dict(distsort.fallbacks),
        "compact_fallbacks": global_sa.compact_fallbacks,
        "radix_launches": radix_sort.launches,
        "merge_launches": merge.launches,
        "head_ranks_launches": steps.launches["shard_head_ranks"],
        "route_launches": {
            name: (route if name in route.launches else steps).launches[name]
            for name in ROUTE_STEPS},
        "plain_sort_calls": plain.calls,
        "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None,
    }
    report["bulk_bytes_per_shard"] = coll.bulk_bytes_per_shard(p)
    report["expected_bytes"] = executed_bytes(g)
    if cuda:
        _check(report["radix_launches"] > 0, "no radix sort launched")
        # one shard in all has no partner to merge with
        _check(report["merge_launches"] > 0 or p == 1,
               "no merge_split launched")
        _check(report["head_ranks_launches"] > 0,
               "no shard_head_ranks launched")
        # one shard routes nothing; a build that resolves at once runs no
        # round to shift
        needed = {"route_partition": p > 1, "place_received": p > 1,
                  "shard_pack_keys": True,
                  "shard_shift_planes": g.rounds_executed > 0}
        for name, launched in report["route_launches"].items():
            _check(launched > 0 or not needed[name], f"no {name} launched")
        _check(plain.calls == 0, f"the plain sort ran {plain.calls} times")

    # this process's shards against the expected SA, slot for slot: slots
    # below `pad` hold the pad suffixes (positions >= n)
    chunk = g.chunk_len
    for s in mesh.local_parts:
        got = g._sa_sharded[s].cpu().numpy()
        slots = np.arange(s * chunk, (s + 1) * chunk)
        real = slots >= g.pad
        _check(np.array_equal(got[real], want[slots[real] - g.pad])
               and bool((got[~real] >= n).all()),
               f"shard {s} differs from the expected SA")
    sa = g.suffix_array()
    _check(np.array_equal(sa, want), "suffix_array() differs")
    whole = g.to_suffix_array_index()
    _check(np.array_equal(whole.sa.cpu().numpy(), want),
           "to_suffix_array_index() differs")
    del whole
    report["sa_sha1"] = _sha1(sa)

    t0 = time.perf_counter()
    g.verify()
    report["verify_s"] = time.perf_counter() - t0
    bad = 1 if p > 1 else 0
    good = g.rank[bad]
    if mesh.is_local(bad):
        g.rank[bad] = good.clone()
        g.rank[bad][0] = g.rank[bad][1]
    try:
        g.verify()
        caught = False
    except NotSorted as e:
        caught = "permutation" in str(e)
    g.rank[bad] = good
    _check(caught, "verify accepted a corrupted rank")

    needles = selftest_needles(text)
    for mode in ("replicated", "sharded"):
        report[f"lcs_{mode}"] = [
            [m.start, m.len]
            for m in g.longest_substring_match_batch(needles, mode)]
        report[f"search_{mode}"] = [list(r) for r in
                                    g.sa_search_batch(needles, mode)]
        report[f"simple_{mode}"] = [list(g.sa_simplesearch(c, mode))
                                    for c in SELFTEST_BYTES]
    report["sharded_lcs"] = [
        [m.start, m.len] for m in ShardedSuffixArray(
            text, mesh).longest_substring_match_batch(needles)]
    if arrays:
        np.savez(os.path.join(work, f"arrays{pid}.npz"), sa=sa,
                 rank=gather_to_host(g.rank))
    return report


def _sha1(a: np.ndarray) -> str:
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def _selftest_child(init: str, nproc: int, pid: int, devs_per_proc: int,
                    device: str, backend: Optional[str], work: str,
                    idx: str, builds: int, arrays: bool) -> None:
    torch.set_num_threads(1)
    initialize(init, nproc, pid, backend=backend, device=device)
    try:
        report = _selftest_run(pid, devs_per_proc, work, _IDX[idx], builds,
                               arrays)
    finally:
        shutdown()
    with open(os.path.join(work, f"report{pid}.json"), "w") as f:
        json.dump(report, f)
    print(f"multihost selftest OK: process {pid} of {nproc}, shards "
          f"{report['parts']} of {report['shards']} on {report['device']} "
          f"({report['backend']}), n={report['n']}: build walls "
          f"{report['walls_s']} s, crossed {report['crossed']} B in "
          f"{report['transport_s']:.4f} s of transport, bytes per shard "
          f"{report['bulk_bytes_per_shard']} (comm model "
          f"{report['expected_bytes']}), radix sort launches "
          f"{report['radix_launches']}, merge_split launches "
          f"{report['merge_launches']}, shard_head_ranks launches "
          f"{report['head_ranks_launches']}, routing and placement "
          f"launches {report['route_launches']}, plain sort calls "
          f"{report['plain_sort_calls']}, peak memory "
          f"{report['peak_bytes']} B", flush=True)


def _wait_all(procs, timeout: float) -> None:
    """Wait for every child. The first that fails, or the deadline, kills
    the others and raises; no child outlives the call."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            rcs = [proc.poll() for proc in procs]
            if any(rc not in (None, 0) for rc in rcs):
                raise RuntimeError(f"selftest children exited {rcs}")
            if all(rc == 0 for rc in rcs):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"selftest children still running after "
                                   f"{timeout} s (exit codes {rcs})")
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for proc in procs:
            proc.wait()


def run_selftest(nproc: int = 2, devs_per_proc: int = 2,
                 timeout: float = 600.0, device: str = "cuda", text=None,
                 backend: Optional[str] = None, idx=torch.int32,
                 builds: int = 1, want=None, arrays: bool = False,
                 workdir: Optional[str] = None) -> list:
    """Spawn `nproc` local processes and build a global SA across them.

    Each process holds `devs_per_proc` shards on `device` (on a machine
    with several cards, process i takes card i modulo their number) and
    checks its build against `want` (the oracle's SA of `text` when not given);
    `text` defaults to the JAX self-test's. The rendezvous file, the
    inputs and the reports go to `workdir` (a temporary directory by
    default). Returns each process's report (with its gathered `sa` and
    `rank` when `arrays`). Raises within `timeout` if a process fails or
    hangs, after killing the others.
    """
    import subprocess
    import tempfile

    from stringsearch_torch.core.types import host_u8

    text = host_u8(selftest_text() if text is None else text, "text")
    if idx not in _IDX.values():
        raise TypeError(f"idx must be torch.int32 or torch.int64, got {idx}")
    if want is None:
        from stringsearch_torch import oracle

        want = oracle.build(text)
    idx_name = {v: k for k, v in _IDX.items()}[idx]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory(prefix="multihost-",
                                     dir=workdir) as work:
        np.save(os.path.join(work, "text.npy"), text)
        np.save(os.path.join(work, "want.npy"), np.asarray(want))
        init = "file://" + os.path.join(work, "rendezvous")
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "stringsearch_torch.parallel.multihost",
                 "--child", init, str(nproc), str(pid), str(devs_per_proc),
                 "--device", device, "--work", work, "--idx", idx_name,
                 "--builds", str(builds)]
                + (["--backend", backend] if backend else [])
                + (["--arrays"] if arrays else []),
                env={**env, "LOCAL_RANK": str(pid)})
            for pid in range(nproc)
        ]
        _wait_all(procs, timeout)
        reports = []
        for pid in range(nproc):
            with open(os.path.join(work, f"report{pid}.json")) as f:
                reports.append(json.load(f))
            if arrays:
                with np.load(os.path.join(work, f"arrays{pid}.npz")) as z:
                    reports[-1].update(sa=z["sa"], rank=z["rank"])
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m stringsearch_torch.parallel.multihost",
        description="the multi-process global build's self-test")
    ap.add_argument("--selftest", action="store_true",
                    help="spawn the processes and check their build")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--backend", choices=coll.BACKENDS, default=None)
    ap.add_argument("--child", nargs=4,
                    metavar=("INIT", "NPROC", "PID", "DEVS_PER_PROC"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    ap.add_argument("--idx", choices=sorted(_IDX), default="int32",
                    help=argparse.SUPPRESS)
    ap.add_argument("--builds", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--arrays", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        init, nproc, pid, devs = args.child
        _selftest_child(init, int(nproc), int(pid), int(devs), args.device,
                        args.backend, args.work, args.idx, args.builds,
                        args.arrays)
        return 0
    if not args.selftest:
        ap.error("nothing to do: pass --selftest")
    run_selftest(nproc=args.nproc, device=args.device, backend=args.backend)
    print("selftest passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
