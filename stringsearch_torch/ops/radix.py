"""Radix-partition probes: per-tile histograms, stable in-tile grouping and
the granule flush, the stages of one 8-bit MSD partition pass.

Counterpart of stringsearch_tpu/ops/radix.py, with the same public names:
`block_histograms`, `local_group`, `granule_flush` and the `check_*`
functions. CPU tensors go to the plain PyTorch versions below; CUDA tensors
to the hand-written Hopper kernels of `csrc/radix.cu`, which take int32
tensors only and raise on anything else. There is no other route and no
fallback. `python -m stringsearch_torch.harness.microbench radix` composes
the stages into the cost of one pass and sets it beside the port's sort.

Keys are uint32 in the reference. torch has no uint32 shifts on the CPU,
so keys here are int32 tensors holding the same 32 bits (numpy
`keys.view(np.int32)`, or a `torch.uint32` tensor viewed as int32); a bin is
`(key >> shift) & 0xFF` of the unsigned bits, and `local_group` returns the
grouped keys as int32 bits too. No order bias is applied: the bits are the
bin.

One plain version stands beside each TPU kernel, so that each kernel can be
held against its own: `plain_histograms` (`_hist_kernel`), `plain_dest`
(`_dest_kernel`), `plain_place` (`_place_kernel`) and `plain_granule_flush`
(`_flush_kernel`). The `kernel_*` functions launch the kernels directly.
`plain_dest_steps` repeats the steps of the destination kernel (warp runs,
32-key segments, counters per warp, the scans over warps and bins) and is
held against `plain_dest`; nothing on a card calls it.

Not carried over from the reference, because they are Mosaic alignment
rules and not semantics: n a multiple of 8 tiles (`block_histograms`),
tile a multiple of 1024 (`local_group`), per_block a multiple of 1024 and
granule 128 or a multiple of 1024 (`granule_flush`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from stringsearch_torch.ops import _build

_SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "radix.cu")
_I32 = torch.int32
_BINS = 256
# ss_radix_dest (csrc/radix.cu): the keys a lane holds, one of each 32-key
# segment of its warp's run (kDestPerLane), and the most warps a tile takes.
_DEST_PER_LANE = 32
_DEST_MAX_WARPS = 32

# Kernel launches in this process, by kernel.
launches = {"hist": 0, "dest": 0, "place": 0, "flush": 0}

_P = ctypes.c_void_p
_INT = (ctypes.c_int, [])


def _check_lanes(lib: ctypes.CDLL) -> None:
    if lib.ss_radix_dest_per_lane() != _DEST_PER_LANE:
        raise RuntimeError("csrc/radix.cu and ops/radix.py disagree on the "
                           "keys a lane of ss_radix_dest holds")


LIBRARY = _build.Library("radix", _SOURCE, {
    "ss_radix_hist": (ctypes.c_int, [_P, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, _P, _P]),
    "ss_radix_dest": (ctypes.c_int, [_P, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, _P, _P, _P]),
    "ss_radix_place": (ctypes.c_int, [_P, _P, _P, ctypes.c_int64,
                                      ctypes.c_int, _P, _P, _P]),
    "ss_radix_flush": (ctypes.c_int, [_P, _P, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, _P, _P]),
    "ss_radix_max_dest_tile": _INT,
    "ss_radix_max_place_tile": _INT,
    "ss_radix_dest_per_lane": _INT,
}, "ss_radix_error_string", _check_lanes)


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the radix kernel library."""
    return LIBRARY.load()


def max_tiles() -> dict:
    """The largest tiles the kernels take, as csrc/radix.cu derives them:
    {"dest": ..., "place": ...}. `kernel_dest` gives a tile at most 32 warps
    whose lanes hold at most 32 keys each in registers (its shared memory,
    256 counters a warp, does not bound the tile); `kernel_place` stages the
    tile's keys and payloads in shared memory. Builds the library on first
    use."""
    lib = load_library()
    return {"dest": lib.ss_radix_max_dest_tile(),
            "place": lib.ss_radix_max_place_tile()}


def _launch(kernel: str, fn: str, device, *args) -> None:
    """Call `fn` of the library on `device`'s current stream; counts the
    launch under `kernel`."""
    LIBRARY.call(fn, device, *args)
    launches[kernel] += 1


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def _check_int32(name: str, t: torch.Tensor, dim: int = 1) -> None:
    if t.dtype != _I32:
        raise TypeError(f"{name} must be int32 (uint32 keys as their int32 "
                        f"bits), got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")


def _check_tiling(n: int, tile: int, shift: int, chunk: int = 1) -> None:
    if tile < 1 or chunk < 1:
        raise ValueError(f"tile={tile} and chunk={chunk} must be >= 1")
    if n % tile:
        raise ValueError(f"n={n} must be a multiple of tile={tile}")
    if tile % chunk:
        raise ValueError(f"tile={tile} must be a multiple of chunk={chunk}")
    if not 0 <= shift < 32:
        raise ValueError(f"shift={shift} must be in 0..31")
    if n >= 1 << 31:
        raise ValueError("the radix kernels take fewer than 2^31 keys")


def _check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the radix kernels take tensors on one CUDA device")


# ---------------------------------------------------------------------------
# plain versions, one per TPU kernel
# ---------------------------------------------------------------------------


def _bins(keys: torch.Tensor, shift: int) -> torch.Tensor:
    """(key >> shift) & 0xFF of the unsigned bits of int32 keys: the mask
    drops the sign bits an arithmetic shift brings in above bit 31-shift."""
    return (keys >> shift) & (0xFF >> max(shift - 24, 0))


def _block_bins(keys: torch.Tensor, tile: int, shift: int) -> torch.Tensor:
    """block * 256 + bin of every key, int32 while that fits."""
    n = keys.shape[0]
    dtype = _I32 if (n // tile) * _BINS < 1 << 31 else torch.int64
    block = torch.arange(n, dtype=dtype, device=keys.device) // tile
    return block * _BINS + _bins(keys, shift).to(dtype)


def plain_histograms(keys: torch.Tensor, tile: int,
                     shift: int) -> torch.Tensor:
    """[n / tile, 256] int32 bin counts per tile: a bincount of
    block * 256 + bin."""
    b = keys.shape[0] // tile
    counts = torch.bincount(_block_bins(keys, tile, shift),
                            minlength=b * _BINS)
    return counts.to(_I32).reshape(b, _BINS)


def plain_dest(keys: torch.Tensor, tile: int, shift: int) -> tuple:
    """(dest [n], local_base [n / tile, 256]), int32.

    dest[t] is key t's slot inside its tile once the tile is grouped by bin,
    stably: the inverse of a stable sort of block * 256 + bin. local_base is
    the exclusive cumsum of each tile's histogram."""
    n = keys.shape[0]
    order = torch.sort(_block_bins(keys, tile, shift), stable=True).indices
    dest = torch.empty((n,), dtype=_I32, device=keys.device)
    dest[order] = torch.arange(n, dtype=_I32, device=keys.device) % tile
    hist = plain_histograms(keys, tile, shift)
    local_base = torch.cumsum(hist, 1, dtype=_I32) - hist
    return dest, local_base


def dest_warps_per_tile(tile: int) -> int:
    """The warps `kernel_dest` gives one tile: the fewest of 1, 2, 4, ... 32
    whose lanes hold at most 32 keys each, one of every 32-key segment of
    the warp's run. 1 up to tile 1024, 2 up to 2048, 8 up to 8192."""
    segments = -(-tile // 32)
    warps = 1
    while warps < _DEST_MAX_WARPS and -(-segments // warps) > _DEST_PER_LANE:
        warps *= 2
    return warps


def _check_dest_warps(tile: int, warps: int) -> int:
    """Segments a warp ranks when `warps` warps share a tile; raises unless
    `warps` is a power of two up to 32 that leaves a lane at most 32 keys."""
    if warps < 1 or warps > _DEST_MAX_WARPS or warps & (warps - 1):
        raise ValueError(f"warps_per_tile={warps} must be a power of two in "
                         f"1..{_DEST_MAX_WARPS}")
    per_lane = -(-(-(-tile // 32)) // warps)
    if per_lane > _DEST_PER_LANE:
        raise ValueError(f"tile={tile} on {warps} warps gives a lane "
                         f"{per_lane} keys; it holds {_DEST_PER_LANE}")
    return per_lane


def plain_dest_steps(keys: torch.Tensor, tile: int, shift: int,
                     warps_per_tile: int) -> tuple:
    """`plain_dest` by the steps of the kernel `ss_radix_dest`.

    A tile is cut into `warps_per_tile` contiguous runs, one warp each, of
    `per_lane` 32-key segments (the last run, and its last segment, may be
    short). A warp takes its segments in order and carries 256 counters: a
    key's rank in the run is its bin's count before the segment plus the
    lower lanes of the segment with its bin. The counters are then summed
    exclusively over the warps in order and the tile's totals scanned
    exclusively over the bins (local_base); dest is the sum of the three.
    """
    n = keys.shape[0]
    per_lane = _check_dest_warps(tile, warps_per_tile)
    tiles = n // tile
    device = keys.device
    run = per_lane * 32
    padded = warps_per_tile * run
    # [tiles, warps, segments, lanes]; slots past the tile's end are dead
    slot = torch.arange(padded, device=device)
    live = (slot < tile).reshape(1, warps_per_tile, per_lane, 32)
    bins = torch.zeros((tiles, padded), dtype=torch.int64, device=device)
    bins[:, :tile] = _bins(keys, shift).reshape(tiles, tile).to(torch.int64)
    bins = bins.reshape(tiles, warps_per_tile, per_lane, 32)
    lower = torch.tril(torch.ones((32, 32), dtype=torch.bool, device=device),
                       -1)
    count = torch.zeros((tiles, warps_per_tile, _BINS), dtype=torch.int64,
                        device=device)
    rank = torch.zeros_like(bins)
    for j in range(per_lane):
        b, alive = bins[:, :, j], live[:, :, j]
        # peers[..., i, k]: lane k is live and holds lane i's bin
        peers = (b.unsqueeze(-1) == b.unsqueeze(-2)) & alive.unsqueeze(-2)
        before = torch.gather(count, 2, b)
        rank[:, :, j] = before + (peers & lower).sum(-1)
        count.scatter_add_(2, b, alive.expand_as(b).to(torch.int64))
    earlier = torch.cumsum(count, 1) - count      # over the warps, in order
    total = count.sum(1)
    local_base = torch.cumsum(total, 1) - total   # over the bins
    first = earlier + local_base.unsqueeze(1)     # [tiles, warps, 256]
    dest = rank + torch.gather(first, 2, bins.reshape(
        tiles, warps_per_tile, run)).reshape(bins.shape)
    dest = dest.reshape(tiles, padded)[:, :tile].reshape(n)
    return dest.to(_I32), local_base.to(_I32)


def plain_place(keys: torch.Tensor, payload: torch.Tensor,
                dest: torch.Tensor, tile: int) -> tuple:
    """(gk, gp): keys and payloads scattered to tile_base + dest."""
    n = keys.shape[0]
    tile_base = torch.arange(n, dtype=_I32, device=keys.device) // tile * tile
    slot = tile_base + dest
    gk = torch.empty_like(keys)
    gp = torch.empty_like(payload)
    gk[slot] = keys
    gp[slot] = payload
    return gk, gp


def plain_granule_flush(desc: torch.Tensor, src: torch.Tensor,
                        out_rows: int) -> torch.Tensor:
    """out[desc] = src into a new [out_rows, granule] tensor."""
    out = torch.empty((out_rows, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    out[desc] = src
    return out


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


def kernel_histograms(keys: torch.Tensor, tile: int,
                      shift: int) -> torch.Tensor:
    """`plain_histograms` on the Hopper kernel `ss_radix_hist`."""
    _check_int32("keys", keys)
    _check_cuda(keys)
    n = keys.shape[0]
    _check_tiling(n, tile, shift)
    keys = keys.contiguous()
    out = torch.empty((n // tile, _BINS), dtype=_I32, device=keys.device)
    if n:
        _launch("hist", "ss_radix_hist", keys.device, keys.data_ptr(), n,
                tile, shift, out.data_ptr())
    return out


def kernel_dest(keys: torch.Tensor, tile: int, shift: int) -> tuple:
    """`plain_dest` on the Hopper kernel `ss_radix_dest`, a tile on
    `dest_warps_per_tile(tile)` warps; tile at most `max_tiles()["dest"]`."""
    _check_int32("keys", keys)
    _check_cuda(keys)
    n = keys.shape[0]
    _check_tiling(n, tile, shift)
    limit = max_tiles()["dest"]
    if tile > limit:
        raise ValueError(f"tile={tile}: the grouping kernel's warps hold "
                         f"tiles of at most {limit} keys")
    keys = keys.contiguous()
    dest = torch.empty((n,), dtype=_I32, device=keys.device)
    local_base = torch.empty((n // tile, _BINS), dtype=_I32,
                             device=keys.device)
    if n:
        _launch("dest", "ss_radix_dest", keys.device, keys.data_ptr(), n,
                tile, shift, dest_warps_per_tile(tile), dest.data_ptr(),
                local_base.data_ptr())
    return dest, local_base


def kernel_place(keys: torch.Tensor, payload: torch.Tensor,
                 dest: torch.Tensor, tile: int) -> tuple:
    """`plain_place` on the Hopper kernel `ss_radix_place`. dest must hold a
    permutation of 0..tile-1 in every tile; tile at most
    `max_tiles()["place"]`."""
    for name, t in (("keys", keys), ("payload", payload), ("dest", dest)):
        _check_int32(name, t)
    _check_cuda(keys, payload, dest)
    n = keys.shape[0]
    if payload.shape[0] != n or dest.shape[0] != n:
        raise ValueError("keys, payload and dest must have one length")
    _check_tiling(n, tile, 0)
    limit = max_tiles()["place"]
    if tile > limit:
        raise ValueError(f"tile={tile}: the placement kernel's shared memory "
                         f"holds tiles of at most {limit} keys")
    keys, payload, dest = (t.contiguous() for t in (keys, payload, dest))
    gk = torch.empty_like(keys)
    gp = torch.empty_like(payload)
    if n:
        _launch("place", "ss_radix_place", keys.device, keys.data_ptr(),
                payload.data_ptr(), dest.data_ptr(), n, tile, gk.data_ptr(),
                gp.data_ptr())
    return gk, gp


def kernel_granule_flush(desc: torch.Tensor, src: torch.Tensor,
                         out_rows: int) -> torch.Tensor:
    """`plain_granule_flush` on the Hopper kernel `ss_radix_flush`. Rows whose
    descriptor lies outside [0, out_rows) are skipped."""
    _check_int32("desc", desc)
    _check_int32("src", src, dim=2)
    _check_cuda(desc, src)
    total, granule = src.shape
    if desc.shape[0] != total:
        raise ValueError("desc must have one entry per row of src")
    desc, src = desc.contiguous(), src.contiguous()
    out = torch.empty((out_rows, granule), dtype=_I32, device=src.device)
    if total and granule:
        _launch("flush", "ss_radix_flush", src.device, desc.data_ptr(),
                src.data_ptr(), total, granule, out_rows, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# public functions (same names and arguments as the reference)
# ---------------------------------------------------------------------------


def block_histograms(keys: torch.Tensor, tile: int = 8192, chunk: int = 1024,
                     shift: int = 24) -> torch.Tensor:
    """[n / tile, 256] int32 histograms of ((keys >> shift) & 0xFF) per tile.

    `chunk` is the reference's MXU slab width: it changes nothing here and
    is validated as there. Raises ValueError unless tile divides n and chunk
    divides tile. The reference checks neither of the two: with tile=8192
    and chunk=3000 its kernel counts only the first 6000 keys of every tile
    and drops the rest without a word.
    """
    _check_int32("keys", keys)
    _check_tiling(keys.shape[0], tile, shift, chunk)
    if not _build.on_cuda(keys.device, "keys"):
        return plain_histograms(keys, tile, shift)
    return kernel_histograms(keys, tile, shift)


def local_group(keys: torch.Tensor, payload: torch.Tensor, tile: int = 1024,
                shift: int = 24, chunk: int = 128) -> tuple:
    """Group every tile's (key, payload) pairs by bin, stably.

    Returns (gk, gp, local_base): keys and payloads with each tile
    bin-contiguous, order inside a bin as in the tile, and the tile-local
    bin starts [n / tile, 256] int32. Two kernels on CUDA, destinations
    (`kernel_dest`, tile up to `max_tiles()["dest"]`) and placement
    (`kernel_place`), as the reference's two pallas_calls. `chunk` (the
    reference's cumsum slab) changes nothing here and is validated as there.
    """
    _check_int32("keys", keys)
    _check_int32("payload", payload)
    if payload.shape != keys.shape:
        raise ValueError("keys and payload must have one shape")
    _check_tiling(keys.shape[0], tile, shift, chunk)
    if not _build.on_cuda(keys.device, "keys"):
        dest, local_base = plain_dest(keys, tile, shift)
        gk, gp = plain_place(keys, payload, dest, tile)
    else:
        dest, local_base = kernel_dest(keys, tile, shift)
        gk, gp = kernel_place(keys, payload, dest, tile)
    return gk, gp, local_base


def granule_flush(desc: torch.Tensor, src: torch.Tensor, granule: int,
                  per_block: int, out_rows: int) -> torch.Tensor:
    """Scatter granule rows of `src` (int32, total * granule values) to rows
    `desc` (int32 [total]) of a new [out_rows, granule] output.

    `per_block` (descriptors per grid step in the reference) must divide the
    descriptor count; the kernel's launch does not depend on it. Rows that
    no descriptor names are left unspecified (the reference's interpret mode
    gives INT32_MIN there, its TPU run uninitialised memory), and so is
    which row wins where `desc` repeats an entry.
    """
    _check_int32("desc", desc)
    total = desc.shape[0]
    if granule < 1 or per_block < 1 or out_rows < 0:
        raise ValueError("granule and per_block must be >= 1, out_rows >= 0")
    if total % per_block:
        raise ValueError("per_block must divide the descriptor count")
    if src.numel() != total * granule:
        raise ValueError(f"src holds {src.numel()} values, not "
                         f"{total} x {granule}")
    src = src.reshape(total, granule)
    _check_int32("src", src, dim=2)
    if not _build.on_cuda(desc.device, "desc"):
        return plain_granule_flush(desc, src, out_rows)
    return kernel_granule_flush(desc, src, out_rows)


# ---------------------------------------------------------------------------
# reference checks: the functions above against numpy on the host
# ---------------------------------------------------------------------------


def _host_bins(keys: torch.Tensor, shift: int) -> np.ndarray:
    return (keys.cpu().numpy().view(np.uint32) >> np.uint32(shift)) & 0xFF


def check_histogram(keys: torch.Tensor, tile: int = 8192,
                    shift: int = 24) -> bool:
    """`block_histograms` of int32 keys, on their device, against numpy."""
    got = block_histograms(keys, tile=tile, shift=shift).cpu().numpy()
    b = _host_bins(keys, shift).astype(np.int64)
    blocks = len(b) // tile
    want = np.bincount(np.arange(len(b)) // tile * 256 + b,
                       minlength=blocks * 256).reshape(blocks, 256)
    return bool(np.array_equal(got, want))


def check_local_group(keys: torch.Tensor, payload: torch.Tensor,
                      tile: int = 1024, shift: int = 24) -> bool:
    """`local_group` on the tensors' device against a stable numpy argsort
    of the bins inside every tile (any tile: `chunk` changes nothing here)."""
    gk, gp, lb = (x.cpu().numpy() for x in local_group(
        keys, payload, tile=tile, shift=shift, chunk=tile))
    k = keys.cpu().numpy()
    p = payload.cpu().numpy()
    ball = _host_bins(keys, shift)
    for i in range(len(k) // tile):
        sl = slice(i * tile, (i + 1) * tile)
        order = np.argsort(ball[sl], kind="stable")
        if not np.array_equal(gk[sl], k[sl][order]):
            return False
        if not np.array_equal(gp[sl], p[sl][order]):
            return False
        hist = np.bincount(ball[sl], minlength=256)
        base = np.concatenate([[0], np.cumsum(hist)[:-1]])
        if not np.array_equal(lb[i], base):
            return False
    return True


def check_granule_flush(total: int = 2048, granule: int = 128,
                        per_block: int = 1024, device="cuda") -> bool:
    """`granule_flush` of random rows to a random permutation of rows, on
    `device`, against numpy."""
    rng = np.random.default_rng(0)
    desc = rng.permutation(total).astype(np.int32)
    src = rng.integers(0, 1 << 30, (total, granule), dtype=np.int32)
    out = granule_flush(torch.from_numpy(desc).to(device),
                        torch.from_numpy(src).to(device), granule, per_block,
                        total).cpu().numpy()
    want = np.zeros_like(src)
    want[desc] = src
    return bool(np.array_equal(out, want))
