"""Device meshes and the mesh-sharded partitioned suffix array.

Counterpart of stringsearch_tpu/parallel/mesh.py. There, `shard_map`
over a `jax.sharding.Mesh` puts one text partition on each device of the
"parts" axis and splits a needle batch over the "batch" axis; the best
match over partitions is an all-gather of per-partition candidates and an
argmax (the earliest partition wins a tie). Here the mesh is a grid of
`torch.device`s, and one process drives every shard (`collectives.py`).

What differs from the JAX package, and why:
  * A mesh may repeat a device: `make_mesh(devices=[cuda] * 4)` runs four
    shards on one card, as the JAX tests run eight shards on eight virtual
    CPU devices. Such a mesh measures correctness and launch counts, not
    scaling. `devices` defaults to every visible CUDA device; the CPU is
    used only when the caller passes CPU devices, and there is no switch
    to it when no GPU is present.
  * `jax.vmap(build_sa)` over a device's partitions becomes one build of
    all the partitions on that device (`build_sa(..., chunk=L)`, as
    `parallel/partitioned.py` does).
  * A partition's arrays live on the first device of its "parts" row; a
    needle block answered on another device of the row reads them there
    (a copy between devices, none on one device).
  * A mesh may span processes (`parallel/multihost.py:device_mesh`):
    `owners` names the process that holds each "parts" row, and a process
    builds and queries only its own rows (`collectives.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from stringsearch_torch.core import compare as cmp
from stringsearch_torch.core.search import (
    _ceil_log2,
    _needle_batch_to_windows,
    lcs_kernel,
)
from stringsearch_torch.core.types import (
    BytesLike,
    LongestCommonSubstring,
    as_text_tensor,
    host_tensor,
)
from stringsearch_torch.parallel import collectives as coll


class Mesh:
    """Devices on a ("parts", "batch") grid: `devices[part][batch]`.

    `shape` maps each axis name to its size, as a JAX mesh's does. A
    device may appear more than once. `owners` names the process rank that
    holds each "parts" row; None means this process holds every row (a
    single controller). A remote row's devices are its owner's, as the
    owner named them.
    """

    axis_names = ("parts", "batch")

    def __init__(self, devices: Sequence[Sequence],
                 owners: Optional[Sequence[int]] = None):
        rows = [[torch.device(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh needs a non-empty rectangular grid of "
                             "devices")
        if owners is not None and len(owners) != len(rows):
            raise ValueError(f"{len(owners)} owners for {len(rows)} "
                             f"\"parts\" rows")
        self.devices = rows
        self.shape = {"parts": len(rows), "batch": len(rows[0])}
        self.owners = None if owners is None else tuple(int(o)
                                                        for o in owners)

    @property
    def part_devices(self) -> list:
        """The device of each "parts" index: the first of its row."""
        return [row[0] for row in self.devices]

    def is_local(self, s: int) -> bool:
        """True when this process holds "parts" index s."""
        return self.owners is None or self.owners[s] == coll.process_rank()

    @property
    def local_parts(self) -> list:
        """The "parts" indices this process holds."""
        return [s for s in range(self.shape["parts"]) if self.is_local(s)]

    def bind(self) -> None:
        """Hand the owners to the collectives (a mesh across processes)."""
        if self.owners is not None:
            coll.bind_owners(self.owners)


def _visible_cuda_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass devices=[torch.device('cpu')] * k to "
            "build a mesh on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: Optional[int] = None,
    batch_axis: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A ("parts", "batch") mesh over the given devices, or over every
    visible CUDA device. A list may repeat a device."""
    devs = (list(devices) if devices is not None
            else _visible_cuda_devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0 or n % batch_axis != 0:
        raise ValueError(f"{n} devices not divisible by batch_axis="
                         f"{batch_axis}")
    return Mesh([devs[i:i + batch_axis] for i in range(0, n, batch_axis)])


def _pad_to_partitions(text: torch.Tensor, num_parts: int):
    """Zero-pad `text` to num_parts equal partitions. Returns (padded text,
    partition length, real length of each partition as a host array)."""
    n = int(text.shape[0])
    part = -(-max(n, num_parts) // num_parts)
    padded_len = part * num_parts
    if padded_len > n:
        text = torch.cat([text, text.new_zeros((padded_len - n,))])
    real_lens = np.minimum(np.maximum(n - np.arange(num_parts) * part, 0),
                           part)
    return text, part, np.asarray(real_lens, np.int32)


def build_sharded(text: BytesLike, mesh: Mesh):
    """Build one suffix array per partition, one partition per "parts"
    index of the mesh, each on its device.

    Returns (chunks, sas, real_lens): lists of the per-partition uint8 text
    [L] and int32 SA [L] (in the partition's own coordinates), and the
    host array of real lengths [P].
    """
    from stringsearch_torch.engines.doubling import _auto_depth, build_sa

    devices = mesh.part_devices
    local = mesh.local_parts
    text = as_text_tensor(text, devices[local[0]])
    num_parts = mesh.shape["parts"]
    padded, part, real_lens = _pad_to_partitions(text, num_parts)
    chunks = [padded[s * part:(s + 1) * part].to(dev)
              if mesh.is_local(s) else None for s, dev in enumerate(devices)]
    sas = [None] * num_parts
    # the partitions that share a device are built in one build
    for dev in dict.fromkeys(devices[s] for s in local):
        mine = [s for s in local if devices[s] == dev]
        flat = build_sa(torch.cat([chunks[s] for s in mine]),
                        depth=_auto_depth(part * len(mine)), chunk=part)
        for k, s in enumerate(mine):
            sas[s] = flat[k * part:(k + 1) * part] - k * part
    return chunks, sas, real_lens


def _sharded_query(chunks, sas, full_text, real_lens, needles, steps: int,
                   mesh: Mesh):
    """Sharded LCS query. `needles` [B, M] (B a multiple of the batch axis)
    is split over "batch"; for each needle block, every partition answers
    on its device of that column, and the candidates reduce over "parts"
    with an all-gather and a first-maximum argmax. Returns host arrays
    (start [B], length [B])."""
    num_parts, batch = mesh.shape["parts"], mesh.shape["batch"]
    chunk_len = coll.first_local(chunks).shape[0]
    blk = needles.shape[0] // batch
    starts, lens = [], []
    for b in range(batch):
        tlens, gstarts = [None] * num_parts, [None] * num_parts
        for s in coll.local_parts(chunks):
            dev = mesh.devices[s][b]
            nds = host_tensor(needles[b * blk:(b + 1) * blk], dev)
            start, _ = lcs_kernel(chunks[s].to(dev), sas[s].to(dev), nds,
                                  steps)
            # global coordinates and the repair against the full text
            gstart = start + s * chunk_len
            windows = cmp.gather_window(full_text.to(dev), gstart,
                                        nds.shape[-1])
            tlen = cmp.prefix_match_len(windows, nds)
            tlens[s] = torch.where(start < int(real_lens[s]), tlen, -1)
            gstarts[s] = gstart
        all_len = coll.first_local(coll.all_gather(tlens))  # [P, b_loc]
        all_start = coll.first_local(coll.all_gather(gstarts))
        best_p = torch.argmax(all_len, dim=0)  # the first maximum
        lens.append(all_len.amax(0).clamp(min=0).cpu().numpy())
        starts.append(all_start.gather(0, best_p[None, :])[0].cpu().numpy())
    return np.concatenate(starts), np.concatenate(lens)


class ShardedSuffixArray:
    """Mesh-sharded partitioned suffix array (one partition per "parts"
    index)."""

    def __init__(self, text: BytesLike, mesh: Mesh):
        self.mesh = mesh
        mesh.bind()
        self.text = as_text_tensor(text,
                                   mesh.part_devices[mesh.local_parts[0]])
        self.chunks, self.sas, self.real_lens = build_sharded(self.text,
                                                              mesh)
        self.partition_size = int(coll.first_local(self.chunks).shape[0])
        self._host_text: Optional[np.ndarray] = None

    def num_partitions(self) -> int:
        return len(self.chunks)

    def text_bytes(self) -> np.ndarray:
        if self._host_text is None:
            self._host_text = self.text.cpu().numpy()
        return self._host_text

    def longest_substring_match_batch(
        self, needles: Sequence[BytesLike]
    ) -> list[LongestCommonSubstring]:
        if not needles:
            return []
        batch_n = self.mesh.shape["batch"]
        padded, _lens, width = _needle_batch_to_windows(needles)
        # pad the batch to a multiple of the batch axis
        b = padded.shape[0]
        b_pad = -(-b // batch_n) * batch_n
        if b_pad > b:
            padded = np.concatenate(
                [padded, np.full((b_pad - b, width), cmp.PAST_NEEDLE_END,
                                 np.int32)])
        steps = _ceil_log2(self.partition_size + 1) + 1
        start, length = _sharded_query(self.chunks, self.sas, self.text,
                                       self.real_lens, padded, steps,
                                       self.mesh)
        host = self.text_bytes()
        return [LongestCommonSubstring(host, int(start[i]), int(length[i]))
                for i in range(b)]

    def longest_substring_match(self, needle: BytesLike
                                ) -> LongestCommonSubstring:
        return self.longest_substring_match_batch([needle])[0]
