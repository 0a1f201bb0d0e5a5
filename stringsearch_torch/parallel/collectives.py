"""The collectives of the multi-device layer, over lists of per-shard tensors.

The stand-in for `shard_map`'s collectives in stringsearch_tpu/parallel/
(`jax.lax.ppermute`, `all_to_all`, `psum`, `all_gather`, and the min the
JAX package builds from an all-gather). The layer is a single controller,
as the JAX package is: one process drives every shard. A sharded array is
a Python list with one tensor per "parts" index, each on its shard's
device, and a shard-map body is a loop over the shard indices. A
collective takes the list of every shard's tensor and returns the list of
what each shard receives. Every collective call of the layer is in this
module, so a multi-process transport can take the place of these bodies.

Copies. A tensor bound for another device moves with
`tensor.to(device, non_blocking=True)`. On the same device `ppermute`
hands the receiver the sender's own tensor, without a copy; `all_to_all`
always builds new buffers (one concatenation per receiver); `psum`,
`pmin` and `all_gather` build one result per distinct device, shared by
the shards on it. No caller in the layer writes in place into what a
collective returned, so the shared buffers are safe: the call sites that
rely on it are every `ppermute` in `distsort.py` (merge-split partners,
boundary values), `global_sa.py` (the initial window, the shifted ranks,
the compaction's straddle and spill) and every reduction's result. The
send buffers that `all_to_all` reads are built fresh by each caller.

Traffic. `sent[kind][shard]` counts the bytes each shard has sent, by
kind: "ppermute" and "all_to_all" are the bulk transfers that
`parallel/comm_model.py` counts; "boundary" (ppermutes of O(1) boundary
values), "all_gather" and "reduce" (psum, pmin) are what it leaves out.
A self-send counts, as the comm model counts it. `reset_traffic()` zeroes
the counts.
"""

from __future__ import annotations

from collections import Counter
from typing import Sequence

import torch

KINDS = ("ppermute", "all_to_all", "boundary", "all_gather", "reduce")

#: bytes sent by each shard, by kind (see the module docstring)
sent = {kind: Counter() for kind in KINDS}


def reset_traffic() -> None:
    for counts in sent.values():
        counts.clear()


def bulk_bytes_per_shard(p: int) -> list:
    """The bytes each of p shards has sent in the transfers that the comm
    model counts ("ppermute" and "all_to_all")."""
    return [sent["ppermute"][s] + sent["all_to_all"][s] for s in range(p)]


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _per_device(devices, make):
    """One `make(device)` per distinct device, in shard order."""
    made = {}
    for d in devices:
        if d not in made:
            made[d] = make(d)
    return [made[d] for d in devices]


def ppermute(xs: Sequence[torch.Tensor], perm, boundary: bool = False
             ) -> list:
    """`jax.lax.ppermute`: shard dst receives shard src's tensor for each
    (src, dst) in `perm`; a shard that receives nothing gets zeros of its
    own tensor's shape and dtype. `boundary` files the bytes under
    "boundary" (O(1) values the comm model leaves out)."""
    kind = "boundary" if boundary else "ppermute"
    out = [None] * len(xs)
    for src, dst in perm:
        out[dst] = xs[src].to(xs[dst].device, non_blocking=True)
        sent[kind][src] += _nbytes(xs[src])
    return [torch.zeros_like(x) if o is None else o for x, o in zip(xs, out)]


def all_to_all(xs: Sequence[torch.Tensor]) -> list:
    """`jax.lax.all_to_all(x, split_axis=0, concat_axis=0, tiled=True)`:
    every shard splits its tensor into len(xs) equal blocks along axis 0;
    shard d receives block d of every shard, concatenated in shard order."""
    p = len(xs)
    rows = xs[0].shape[0]
    if rows % p or any(x.shape != xs[0].shape for x in xs):
        raise ValueError(f"all_to_all needs equal shapes with axis 0 "
                         f"divisible by {p}")
    blk = rows // p
    for s, x in enumerate(xs):
        sent["all_to_all"][s] += _nbytes(x)
    return [torch.cat([x[d * blk:(d + 1) * blk].to(xs[d].device,
                                                    non_blocking=True)
                       for x in xs]) for d in range(p)]


def _gathered(xs, kind: str, combine) -> list:
    for s, x in enumerate(xs):
        sent[kind][s] += _nbytes(x)
    return _per_device([x.device for x in xs], lambda dev: combine(
        [x.to(dev, non_blocking=True) for x in xs]))


def all_gather(xs: Sequence[torch.Tensor], tiled: bool = False) -> list:
    """`jax.lax.all_gather`: every shard gets every shard's tensor, stacked
    on a new axis 0 (concatenated along axis 0 when `tiled`)."""
    return _gathered(xs, "all_gather", torch.cat if tiled else torch.stack)


def psum(xs: Sequence[torch.Tensor]) -> list:
    """`jax.lax.psum`: the sum over shards, on every shard."""
    return _gathered(xs, "reduce",
                     lambda v: torch.stack(v).sum(0, dtype=v[0].dtype))


def pmin(xs: Sequence[torch.Tensor]) -> list:
    """The minimum over shards, on every shard."""
    return _gathered(xs, "reduce", lambda v: torch.stack(v).amin(0))
