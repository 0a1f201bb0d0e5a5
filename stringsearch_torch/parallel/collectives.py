"""The collectives of the multi-device layer, over lists of per-shard tensors.

The stand-in for `shard_map`'s collectives in stringsearch_tpu/parallel/
(`jax.lax.ppermute`, `all_to_all`, `psum`, `all_gather`, and the min the
JAX package builds from an all-gather). A sharded array is a Python list
with one tensor per "parts" index, each on its shard's device, and a
shard-map body is a loop over the shard indices. A collective takes the
list of every shard's tensor and returns the list of what each shard
receives. Every collective call of the layer is in this module.

Single controller. With no transport active, one process drives every
shard (whose device may repeat), and every entry of a list is filled.

Several processes. Between `multihost.initialize` and `multihost.shutdown`
a `Transport` on `torch.distributed` is active, and a build binds its
mesh's owners (`bind_owners`: the process rank that holds each shard).
A process then fills only the entries of its own shards; the others are
None, and a list is still indexed by the global shard number. A list
with a None entry is sharded across processes: each collective reads the
local entries, moves what crosses a process over the transport, and
returns a list with the local entries filled. A list with every entry
filled runs the single-controller body, transport or not. Every process
calls every collective, in the same order: the layer takes each host
branch on a value that every process holds equally (a reduction's or an
all-gather's result), so no process skips a collective another calls.

JAX's rule holds: every shard's operand of a collective has one shape
and dtype (a receiver sizes its buffer by its own tensor). The single
controller's `ppermute` asserts it, so a call site that breaks it shows
on the CPU.

Backends. gloo moves host tensors, so it stages every tensor through the
host (`.cpu()` before sending, `.to(device)` after receiving); nccl moves
device tensors, on the process's own device. The backend is the caller's
choice; nothing switches from one to the other.

Copies. A tensor bound for another device moves with
`tensor.to(device, non_blocking=True)`. On the same device `ppermute`
hands the receiver the sender's own tensor, without a copy; `all_to_all`
always builds new buffers (one concatenation per receiver); `psum`,
`pmin` and `all_gather` build one result per distinct device of the
process, shared by its shards there. No caller in the layer writes in
place into what a collective returned, so the shared buffers are safe: the
call sites that rely on it are every `ppermute` in `distsort.py`
(merge-split partners, boundary values), `global_sa.py` (the initial
window, the shifted ranks, the compaction's straddle and spill) and every
reduction's result. The send buffers that `all_to_all` reads are built
fresh by each caller.

Traffic. `sent[kind][shard]` counts the bytes each local shard has sent,
by kind: "ppermute" and "all_to_all" are the bulk transfers that
`parallel/comm_model.py` counts; "boundary" (ppermutes of O(1) boundary
values), "all_gather" and "reduce" (psum, pmin) are what it leaves out.
A self-send counts, as the comm model counts it. Across processes,
`crossed` counts the bytes that left this process and `transport_s` the
host seconds spent moving them (staging copies and `torch.distributed`
calls, waits included). On nccl a call returns once its transfers are
queued on the device's stream, so there `transport_s` is the host's
enqueue time, not the transfers'. `reset_traffic()` zeroes all three.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

KINDS = ("ppermute", "all_to_all", "boundary", "all_gather", "reduce")
BACKENDS = ("gloo", "nccl")

#: bytes sent by each shard, by kind (see the module docstring)
sent = {kind: Counter() for kind in KINDS}
#: bytes this process sent to other processes
crossed = 0
#: host seconds spent in cross-process transfers
transport_s = 0.0


def reset_traffic() -> None:
    global crossed, transport_s
    for counts in sent.values():
        counts.clear()
    crossed = 0
    transport_s = 0.0


class Transport:
    """A `torch.distributed` process group under the collectives: this
    process's rank, the world size, the backend and the device this
    process works on; `owners` is bound by a build (`bind_owners`)."""

    def __init__(self, backend: str, rank: int, world: int, device):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        self.backend, self.rank, self.world = backend, rank, world
        self.device = torch.device(device)
        self.owners: Optional[tuple] = None

    @property
    def staged(self) -> bool:
        """True where tensors pass through the host (gloo)."""
        return self.backend == "gloo"

    @property
    def wire_device(self) -> torch.device:
        """Where the tensors handed to torch.distributed live."""
        return torch.device("cpu") if self.staged else self.device

    def outbound(self, x: torch.Tensor) -> torch.Tensor:
        """`x` as torch.distributed takes it: on the wire device, dense;
        `x` itself when it already is."""
        return x.to(self.wire_device).contiguous()

    def buffer(self, like: torch.Tensor) -> torch.Tensor:
        """A receive buffer of `like`'s shape and dtype on the wire
        device."""
        return torch.empty(like.shape, dtype=like.dtype,
                           device=self.wire_device)


_transport: Optional[Transport] = None


def activate(transport: Transport) -> None:
    global _transport
    _transport = transport


def deactivate() -> None:
    global _transport
    _transport = None


def transport() -> Optional[Transport]:
    """The active transport, None for a single controller."""
    return _transport


def process_rank() -> int:
    return 0 if _transport is None else _transport.rank


def bind_owners(owners: Sequence[int]) -> None:
    """Record the process rank that holds each shard, for the collectives
    to route by. Needs an active transport, and every process holding at
    least one shard (each contributes to every reduction)."""
    if _transport is None:
        raise RuntimeError("a mesh with owners needs an active transport "
                           "(multihost.initialize)")
    owners = tuple(int(o) for o in owners)
    if sorted(set(owners)) != list(range(_transport.world)):
        raise ValueError(f"owners {owners} must name every rank of the "
                         f"{_transport.world} processes")
    _transport.owners = owners


def _t() -> Transport:
    if _transport is None or _transport.owners is None:
        raise RuntimeError("a list with remote shards (None entries) needs "
                           "an active transport with bound owners")
    return _transport


def local_parts(xs: Sequence) -> list:
    """The indices of the shards this process holds: the entries of `xs`
    that are not None."""
    return [i for i, x in enumerate(xs) if x is not None]


def first_local(xs: Sequence):
    """The entry of this process's first shard: where a replicated value
    is read."""
    return next(x for x in xs if x is not None)


def each(xs: Sequence, fn) -> list:
    """`fn(i)` for each local shard i of `xs`, None for the others."""
    return [None if x is None else fn(i) for i, x in enumerate(xs)]


def _spread(xs: Sequence) -> bool:
    """True when `xs` is sharded across processes."""
    return any(x is None for x in xs)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _timed(fn):
    global transport_s
    t0 = time.perf_counter()
    try:
        return fn()
    finally:
        transport_s += time.perf_counter() - t0


def _p2p(sends, recvs) -> dict:
    """Post `sends` [(peer, tag, tensor)] and `recvs` [(peer, tag, like)]
    in one `batch_isend_irecv`; returns {tag: what arrived}, each on its
    `like`'s device. Both sides post a pair's messages in tag order, as
    NCCL (which ignores tags) matches them in order."""
    import torch.distributed as dist

    global crossed
    t = _t()
    sends = sorted(sends, key=lambda m: m[1])
    recvs = sorted(recvs, key=lambda m: m[1])

    def go():
        ops, bufs = [], []
        for peer, tag, x in sends:
            ops.append(dist.P2POp(dist.isend, t.outbound(x), peer, tag=tag))
        for peer, tag, like in recvs:
            bufs.append(t.buffer(like))
            ops.append(dist.P2POp(dist.irecv, bufs[-1], peer, tag=tag))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return {tag: b.to(like.device, non_blocking=True)
                for b, (_peer, tag, like) in zip(bufs, recvs)}

    crossed += sum(_nbytes(x) for _peer, _tag, x in sends)
    return _timed(go)


def ppermute(xs: Sequence[torch.Tensor], perm, boundary: bool = False
             ) -> list:
    """`jax.lax.ppermute`: shard dst receives shard src's tensor for each
    (src, dst) in `perm`; a shard that receives nothing gets zeros of its
    own tensor's shape and dtype. `boundary` files the bytes under
    "boundary" (O(1) values the comm model leaves out)."""
    kind = "boundary" if boundary else "ppermute"
    p = len(xs)
    out = [None] * p
    if not _spread(xs):
        for src, dst in perm:
            assert (xs[src].shape == xs[dst].shape
                    and xs[src].dtype == xs[dst].dtype), (
                f"ppermute {src}->{dst}: {tuple(xs[src].shape)} "
                f"{xs[src].dtype} into {tuple(xs[dst].shape)} "
                f"{xs[dst].dtype}")
            out[dst] = xs[src].to(xs[dst].device, non_blocking=True)
            sent[kind][src] += _nbytes(xs[src])
        return [torch.zeros_like(x) if o is None else o
                for x, o in zip(xs, out)]
    owners = _t().owners
    sends, recvs = [], []
    for src, dst in perm:
        tag = src * p + dst
        if xs[src] is not None:
            sent[kind][src] += _nbytes(xs[src])
            if xs[dst] is not None:
                out[dst] = xs[src].to(xs[dst].device, non_blocking=True)
            else:
                sends.append((owners[dst], tag, xs[src]))
        elif xs[dst] is not None:
            recvs.append((owners[src], tag, xs[dst]))
    for tag, got in _p2p(sends, recvs).items():
        out[tag % p] = got
    return [None if x is None else torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]


def all_to_all(xs: Sequence[torch.Tensor]) -> list:
    """`jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`:
    every shard splits its tensor into len(xs) equal blocks along axis 0;
    shard d receives block d of every shard, concatenated in shard order."""
    p = len(xs)
    mine = local_parts(xs)
    shape = xs[mine[0]].shape
    rows = shape[0]
    if rows % p or any(xs[s].shape != shape for s in mine):
        raise ValueError(f"all_to_all needs equal shapes with axis 0 "
                         f"divisible by {p}")
    blk = rows // p
    for s in mine:
        sent["all_to_all"][s] += _nbytes(xs[s])
    if len(mine) == p:
        return [torch.cat([x[d * blk:(d + 1) * blk].to(xs[d].device,
                                                        non_blocking=True)
                           for x in xs]) for d in range(p)]
    owners = _t().owners
    sends = [(owners[d], s * p + d, xs[s][d * blk:(d + 1) * blk])
             for s in mine for d in range(p) if xs[d] is None]
    recvs = [(owners[s], s * p + d, xs[d][s * blk:(s + 1) * blk])
             for d in mine for s in range(p) if xs[s] is None]
    got = _p2p(sends, recvs)
    return each(xs, lambda d: torch.cat([
        xs[s][d * blk:(d + 1) * blk].to(xs[d].device, non_blocking=True)
        if xs[s] is not None else got[s * p + d] for s in range(p)]))


def _per_device(devices, make):
    """One `make(device)` per distinct device, in shard order (None for a
    remote shard)."""
    made = {}
    for d in devices:
        if d is not None and d not in made:
            made[d] = make(d)
    return [None if d is None else made[d] for d in devices]


def _gather_remote(xs: Sequence[torch.Tensor]) -> list:
    """Every shard's tensor, in shard order, from a list sharded across
    processes: one `all_gather` of each process's local stack (padded to
    the most shards a process holds). The tensors arrive on the wire
    device."""
    import torch.distributed as dist

    global crossed
    t = _t()
    mine = local_parts(xs)
    held = Counter(t.owners)
    most = max(held.values())
    stack = torch.stack([t.outbound(xs[s]) for s in mine])
    if len(mine) < most:
        stack = torch.cat([stack, stack.new_zeros(
            (most - len(mine),) + tuple(stack.shape[1:]))])

    def go():
        bufs = [torch.empty_like(stack) for _ in range(t.world)]
        dist.all_gather(bufs, stack)
        return bufs

    crossed += _nbytes(stack) * (t.world - 1)
    bufs = _timed(go)
    slot = Counter()
    out = []
    for o in t.owners:
        out.append(bufs[o][slot[o]])
        slot[o] += 1
    return out


def _gathered(xs, kind: str, combine) -> list:
    for s in local_parts(xs):
        sent[kind][s] += _nbytes(xs[s])
    devices = [None if x is None else x.device for x in xs]
    if not _spread(xs):
        return _per_device(devices, lambda dev: combine(
            [x.to(dev, non_blocking=True) for x in xs]))
    everyone = _gather_remote(xs)
    return _per_device(devices, lambda dev: combine(
        [x.to(dev, non_blocking=True) for x in everyone]))


def all_gather(xs: Sequence[torch.Tensor], tiled: bool = False) -> list:
    """`jax.lax.all_gather`: every shard gets every shard's tensor, stacked
    on a new axis 0 (concatenated along axis 0 when `tiled`)."""
    return _gathered(xs, "all_gather", torch.cat if tiled else torch.stack)


def _reduced(xs, local_op, op_name: str) -> list:
    """A reduction: the single-controller body, or a local reduction over
    this process's shards and an `all_reduce` across processes (bool
    carried as int32: NCCL and gloo treat bool differently)."""
    for s in local_parts(xs):
        sent["reduce"][s] += _nbytes(xs[s])
    devices = [None if x is None else x.device for x in xs]
    if not _spread(xs):
        return _per_device(devices, lambda dev: local_op(
            [x.to(dev, non_blocking=True) for x in xs]))
    import torch.distributed as dist

    global crossed
    t = _t()
    mine = [xs[s] for s in local_parts(xs)]
    dtype = mine[0].dtype
    part = local_op([x.to(mine[0].device) for x in mine])
    wire = t.outbound(part.to(torch.int32) if dtype == torch.bool else part)
    crossed += _nbytes(wire) * (t.world - 1)
    _timed(lambda: dist.all_reduce(wire, getattr(dist.ReduceOp, op_name)))
    total = wire.to(dtype)
    return _per_device(devices, lambda dev: total.to(dev, non_blocking=True))


def psum(xs: Sequence[torch.Tensor]) -> list:
    """`jax.lax.psum`: the sum over shards, on every shard."""
    return _reduced(xs, lambda v: torch.stack(v).sum(0, dtype=v[0].dtype),
                    "SUM")


def pmin(xs: Sequence[torch.Tensor]) -> list:
    """The minimum over shards, on every shard."""
    return _reduced(xs, lambda v: torch.stack(v).amin(0), "MIN")


def gather_to_host(xs: Sequence[torch.Tensor]) -> np.ndarray:
    """The concatenation of every shard's tensor as one host array, in
    every process (a collective when `xs` is sharded across processes).
    Not counted in `sent`: it is a host fetch, not a shard's transfer."""
    if not _spread(xs):
        return torch.cat([x.cpu() for x in xs]).numpy()
    return torch.cat([x.cpu() for x in _gather_remote(xs)]).numpy()


def bulk_bytes_per_shard(p: int) -> list:
    """The bytes each of p shards has sent in the transfers that the comm
    model counts ("ppermute" and "all_to_all"); summed over the processes
    (a collective) while a transport with bound owners is active."""
    counts = [sent["ppermute"][s] + sent["all_to_all"][s] for s in range(p)]
    t = _transport
    if t is None or t.owners is None:
        return counts
    import torch.distributed as dist

    mine = torch.tensor([c if t.owners[s] == t.rank else 0
                         for s, c in enumerate(counts)], dtype=torch.int64)
    wire = mine.to(t.wire_device)
    dist.all_reduce(wire)
    return wire.cpu().tolist()
