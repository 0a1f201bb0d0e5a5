"""The doubling engine's steps between the sorts, as three Hopper kernels.

Every engine reaches these steps through `engines/doubling.py`: the flat
and the partitioned build, and `build_ints_with_isa` under dc3 and bstar.

  * `pack_keys`: the initial sort's operands from the text (the reference's
    `_pack4_keys`, stringsearch_tpu/engines/doubling.py:83, and its
    position `arange`);
  * `shift_planes`: a round's shifted rank planes and positions (its
    `_shift_ranks`, l.116, once a shift);
  * `head_ranks`: head-slot ranks and the tied count of a sorted tuple (its
    `_ranks_sorted_only`, l.151, with `_heads_and_tied`'s `cummax`);
  * `shard_head_ranks`: the same kernel on one shard of the global build's
    sorted order, slot 0 compared with the previous shard's last key
    tuple and the heads as global slots (the neighbour diff of
    stringsearch_tpu/parallel/global_sa.py's `_initial_shard_ranks` and
    `_doubling_step`, and `_headslot_ranks_from_sorted`, l.120, but for
    the cross-shard carry and the last slot's boundary term, which
    `parallel/global_sa.py` adds).

None of them replaces a Pallas kernel: the JAX package writes these steps
as jnp ops inside one jitted build, which XLA fuses into a few passes. The
port ran them one PyTorch op, and one pass over device memory, at a time;
the kernels of `csrc/steps.cu` do each in one pass (its header says what
bounds them and how). CPU tensors go to the plain versions below, which
are that op-by-op chain; CUDA tensors to the kernels, which raise on a
type, shape or launch error. There is no other route and no fallback.
`harness/profile_build.py steps` puts the plain versions on the card, in
turns with the kernels, to measure what the kernels save; nothing else
runs them there.

`segment_heads`, `heads_and_tied` and `last_flagged` (the
cumsum-and-scatter form of the reference's `cummax`) stay plain: the
plain versions use them, and so do the compaction rounds (flat and
global) and the bstar engine.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from stringsearch_torch.ops import _build

_SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "steps.cu")
_I32 = torch.int32
_IDX = (torch.int32, torch.int64)
# XOR with INT32_MIN flips bit 31: maps uint32 order onto int32 order
BIAS = torch.iinfo(torch.int32).min
# kMaxShifts, kMaxPackKeys and kMaxKeys of csrc/steps.cu: output planes of
# one `shift_planes` launch, key planes of one `pack_keys` launch, key
# planes `head_ranks` takes
_MAX_SHIFTS = 8
_MAX_PACK_KEYS = 4096
_MAX_KEYS = 64
# kPackTile, kShiftTile and kScanTile of csrc/steps.cu: the elements a
# block of each kernel takes (the tests' edge sizes)
PACK_TILE = 1024
SHIFT_TILE = 1024
SCAN_TILE = 2048

# Kernel launches in this process, by function (`shard_head_ranks` is
# `head_ranks`' kernel on one shard of the global build).
launches = {"pack_keys": 0, "shift_planes": 0, "head_ranks": 0,
            "shard_head_ranks": 0}

_lock = threading.Lock()
_lib = None
_P = ctypes.c_void_p


def _load(path: str) -> ctypes.CDLL:
    """Load the built library at `path` and declare its C interface."""
    lib = ctypes.CDLL(path)
    lib.ss_pack_keys.argtypes = [
        _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        _P, _P, _P, ctypes.c_int, _P]
    lib.ss_shift_planes.argtypes = [
        _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int64), _P, _P]
    lib.ss_head_ranks.argtypes = [
        ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int64, _P, ctypes.c_int64, _P, ctypes.c_int, _P, _P, _P]
    for fn in (lib.ss_pack_keys, lib.ss_shift_planes, lib.ss_head_ranks):
        fn.restype = ctypes.c_int
    lib.ss_head_ranks_scratch_bytes.argtypes = [ctypes.c_int64]
    lib.ss_head_ranks_scratch_bytes.restype = ctypes.c_int64
    lib.ss_steps_error_string.argtypes = [ctypes.c_int]
    lib.ss_steps_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Build (first call only) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(_build.build_library(
                "steps", [_SOURCE], [_build.nvcc(), *_build.NVCC_FLAGS]))
        return _lib


def _launch(kernel: str, fn: str, device, *args) -> None:
    """Call `fn` of the library on the current stream of `device` and count
    the launch under `kernel`. Raises if the launch failed."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{lib.ss_steps_error_string(rc).decode()} "
                           f"(code {rc})")
    launches[kernel] += 1


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what} must lie on the CPU or a CUDA device, got "
                     f"{t.device}")


def chunk_len(n: int, chunk) -> int:
    """The chunk length of a build over n elements: `chunk`, or n itself
    (at least 1) for the flat build."""
    if chunk is None:
        return max(n, 1)
    if chunk < 1 or n % chunk:
        raise ValueError(f"chunk={chunk} must be positive and divide n={n}")
    return chunk


# ---------------------------------------------------------------------------
# pack_keys
# ---------------------------------------------------------------------------


def _check_pack(text, depth: int, idx) -> None:
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError(f"text must be a 1-D uint8 tensor, got "
                        f"{text.dtype} of {text.dim()} dims")
    if depth < 4:
        raise ValueError(f"depth must be >= 4, got {depth}")
    if idx not in _IDX:
        raise TypeError(f"idx must be torch.int32 or torch.int64, got {idx}")


def plain_pack_keys(text, depth: int, chunk=None, idx=_I32) -> tuple:
    """`pack_keys` as a chain of PyTorch ops, on the text's device."""
    _check_pack(text, depth, idx)
    n = text.shape[0]
    c = chunk_len(n, chunk)
    rows = text.to(_I32).view(n // c, c)
    t = torch.cat([rows, rows.new_zeros((rows.shape[0], depth))], 1)
    keys = []
    for k in range(depth // 4):
        o = 4 * k
        keys.append(
            (((t[:, o : o + c] << 24)
              | (t[:, o + 1 : o + 1 + c] << 16)
              | (t[:, o + 2 : o + 2 + c] << 8)
              | t[:, o + 3 : o + 3 + c]) ^ BIAS).view(n)
        )
    j = torch.arange(n, dtype=idx, device=text.device)
    lead = [torch.div(j, c, rounding_mode="floor")] if c < n else []
    return (*lead, *keys, j)


def pack_keys(text, depth: int, chunk=None, idx=_I32) -> tuple:
    """The operands of the initial `depth`-byte sort of a uint8 text.

    Returns (chunk index, key_0, .., key_{depth/4 - 1}, position), the chunk
    index only with more than one chunk (`chunk` < n). Key k of suffix i is
    bytes i+4k .. i+4k+3, big-endian, zero past the end of the suffix's
    chunk, XOR 0x80000000, as int32: signed order is the reference's uint32
    order. The chunk index and the position have dtype `idx`.
    """
    _check_pack(text, depth, idx)
    if not _on_cuda(text, "text"):
        return plain_pack_keys(text, depth, chunk, idx)
    n = text.shape[0]
    c = chunk_len(n, chunk)
    nk = depth // 4
    if nk > _MAX_PACK_KEYS:
        raise ValueError(f"pack_keys takes depth <= {4 * _MAX_PACK_KEYS} on "
                         f"CUDA, got {depth}")
    if idx == _I32 and n >= 1 << 31:
        raise ValueError("int32 positions need n < 2^31")
    text = text.contiguous()
    # one buffer, every key plane starting on 16 bytes
    stride = -(-n // 4) * 4
    block = torch.empty((nk, stride), dtype=_I32, device=text.device)
    lead = [torch.empty(n, dtype=idx, device=text.device)] if c < n else []
    pos = torch.empty(n, dtype=idx, device=text.device)
    if n:
        _launch("pack_keys", "ss_pack_keys", text.device, text.data_ptr(), n,
                c, nk, stride, block.data_ptr(),
                lead[0].data_ptr() if lead else None, pos.data_ptr(),
                pos.element_size())
    return (*lead, *(block[k, :n] for k in range(nk)), pos)


# ---------------------------------------------------------------------------
# shift_planes
# ---------------------------------------------------------------------------


def _check_shift(rank, shifts) -> list:
    if rank.dtype not in _IDX or rank.dim() != 1:
        raise TypeError(f"rank must be a 1-D int32 or int64 tensor, got "
                        f"{rank.dtype} of {rank.dim()} dims")
    shifts = [int(s) for s in shifts]
    if any(s < 0 for s in shifts):
        raise ValueError(f"shifts must be >= 0, got {shifts}")
    return shifts


def plain_shift_planes(rank, shifts, chunk=None) -> list:
    """`shift_planes` as a chain of PyTorch ops, on rank's device."""
    shifts = _check_shift(rank, shifts)
    n = rank.shape[0]
    c = chunk_len(n, chunk)
    rows = rank.view(n // c, c)
    out = []
    for h in shifts:
        h_c = min(h, c)
        tail = -(torch.arange(c - h_c, c, dtype=rank.dtype,
                              device=rank.device) + 1)
        out.append(torch.cat([rows[:, h_c:], tail.expand(rows.shape[0], h_c)],
                             1).view(n))
    out.append(torch.arange(n, dtype=rank.dtype, device=rank.device))
    return out


def shift_planes(rank, shifts, chunk=None) -> list:
    """[rank shifted by s for each s in `shifts`] + [the position plane].

    Entry i of the plane of shift s is rank[i + s], or the marker
    -(local i + 1) where i + s lies past the end of i's chunk (local i
    counted from the chunk's start). The marker is negative (an ended
    suffix sorts before every continuing one) and strictly decreasing in i
    (two suffixes that both end within the window split at once, shorter
    first). A shift of `chunk` or more is clamped to `chunk`, where every
    entry is a marker. All planes have rank's dtype; `rank` itself is not
    copied.
    """
    shifts = _check_shift(rank, shifts)
    if not _on_cuda(rank, "rank"):
        return plain_shift_planes(rank, shifts, chunk)
    n = rank.shape[0]
    c = chunk_len(n, chunk)
    rank = rank.contiguous()
    out = [torch.empty_like(rank) for _ in shifts]
    pos = torch.empty_like(rank)
    # one launch a group of at most _MAX_SHIFTS planes; the first also
    # writes the positions
    for g in range(0, max(len(shifts), 1) if n else 0, _MAX_SHIFTS):
        group = shifts[g:g + _MAX_SHIFTS]
        planes = (_P * _MAX_SHIFTS)(*(t.data_ptr()
                                      for t in out[g:g + _MAX_SHIFTS]))
        clamped = (ctypes.c_int64 * _MAX_SHIFTS)(*(min(h, c) for h in group))
        _launch("shift_planes", "ss_shift_planes", rank.device,
                rank.data_ptr(), n, c, rank.element_size(), len(group),
                planes, clamped, pos.data_ptr() if g == 0 else None)
    return out + [pos]


# ---------------------------------------------------------------------------
# head_ranks
# ---------------------------------------------------------------------------


def segment_heads(flag, j):
    """head[i] = the last slot <= i whose `flag` is set (flag[0] must be).

    The reference's `cummax(where(flag, j, -1))`. torch's CUDA cummax is a
    generic scan that took 44 ms of a 145 ms build at n = 2^24 on an H100,
    so this is a cumsum, a scatter and a gather instead: each flagged slot
    writes its index to its segment's entry, every other slot to a private
    scratch entry, so no two writes meet.
    """
    n = j.shape[0]
    seg = torch.cumsum(flag, 0, dtype=j.dtype) - 1
    buf = torch.empty((2 * n,), dtype=j.dtype, device=j.device)
    buf[torch.where(flag, seg, n + j)] = j
    return buf[seg]


def heads_and_tied(new_flag, j):
    """head[j] = slot index of j's group head; tied[j] = group size >= 2."""
    head = segment_heads(new_flag, j)
    nxt_head = torch.cat([head[1:], head.new_full((1,), -1)])
    tied = (head != j) | (nxt_head == head)
    return head, tied


def _check_heads(out) -> tuple:
    out = tuple(out)
    if not out:
        raise ValueError("head_ranks needs the sorted tuple's planes")
    sa_s = out[-1]
    for p in out:
        if p.dtype not in _IDX or p.dim() != 1:
            raise TypeError(f"the sorted planes must be 1-D int32 or int64, "
                            f"got {p.dtype} of {p.dim()} dims")
        if p.shape != sa_s.shape or p.device != sa_s.device:
            raise ValueError("the sorted planes must share one length and "
                             "one device")
    return out


def plain_head_ranks(out):
    """`head_ranks` as a chain of PyTorch ops, on the planes' device."""
    out = _check_heads(out)
    sa_s = out[-1]
    n = sa_s.shape[0]
    j = torch.arange(n, dtype=sa_s.dtype, device=sa_s.device)
    diff = torch.zeros((max(n - 1, 0),), dtype=torch.bool, device=sa_s.device)
    for ks in out[:-1]:
        diff |= ks[1:] != ks[:-1]
    new_flag = torch.cat(
        [torch.ones((min(n, 1),), dtype=torch.bool, device=sa_s.device), diff])
    rank_s, tied = heads_and_tied(new_flag, j)
    return sa_s, rank_s, tied.sum()


def _launch_heads(kernel: str, keys, n: int, prev, offset: int, idx,
                  device):
    """One launch of the head-ranks scan over `keys` ([n] planes on the
    CUDA `device`); returns (rank_s of dtype idx, count)."""
    keys = [p.contiguous() for p in keys]
    if len(keys) > _MAX_KEYS:
        raise ValueError(f"head_ranks takes at most {_MAX_KEYS} key planes "
                         f"on CUDA, got {len(keys)}")
    rank_s = torch.empty((n,), dtype=idx, device=device)
    if not n:
        return rank_s, torch.zeros((), dtype=torch.int64, device=device)
    # the launch zeroes the count and the scratch itself
    count = torch.empty((), dtype=torch.int64, device=device)
    words = load_library().ss_head_ranks_scratch_bytes(n) // 8
    scratch = torch.empty((words,), dtype=torch.int64, device=device)
    planes = (_P * max(len(keys), 1))(*(k.data_ptr() for k in keys))
    widths = (ctypes.c_int * max(len(keys), 1))(
        *(k.element_size() for k in keys))
    _launch(kernel, "ss_head_ranks", device, planes, widths,
            len(keys), n, None if prev is None else prev.data_ptr(), offset,
            rank_s.data_ptr(), rank_s.element_size(), count.data_ptr(),
            scratch.data_ptr())
    return rank_s, count


def head_ranks(out):
    """Head-slot ranking of a sorted (keys..., payload) tuple, in sorted
    order. Returns (sa_s, rank_s, count): sa_s is out[-1] as it is;
    rank_s[j], of sa_s's dtype, is the last slot <= j whose keys differ
    from the slot before's (slot 0 counts), that is the slot of j's group
    head; count, a 0-d int64 tensor on the planes' device, is the number of
    slots whose group holds two or more. Reading it is the caller's only
    host sync.
    """
    out = _check_heads(out)
    sa_s = out[-1]
    if not _on_cuda(sa_s, "the sorted planes"):
        return plain_head_ranks(out)
    rank_s, count = _launch_heads("head_ranks", out[:-1], sa_s.shape[0],
                                  None, 0, sa_s.dtype, sa_s.device)
    return sa_s, rank_s, count


# ---------------------------------------------------------------------------
# shard_head_ranks: head_ranks on one shard of a sorted global order
# ---------------------------------------------------------------------------


def last_flagged(flag: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """`cummax(where(flag, vals, -1))` for nondecreasing `vals`: the value
    at the last flagged slot <= i, or -1 before the first.

    A cumsum, a scatter and a gather: each flagged slot writes its value
    to its segment's entry, every other slot to a private scratch entry.
    """
    n = flag.shape[0]
    seg = torch.cumsum(flag, 0, dtype=vals.dtype) - 1
    j = torch.arange(n, dtype=vals.dtype, device=vals.device)
    buf = torch.empty((2 * n,), dtype=vals.dtype, device=vals.device)
    buf[torch.where(flag, seg, n + j)] = vals
    return torch.where(seg >= 0, buf[seg.clamp(min=0)], -1)


def _check_shard(keys, prev, offset: int, idx) -> tuple:
    keys = tuple(keys)
    if not keys:
        raise ValueError("shard_head_ranks needs the key planes")
    _check_heads(keys)
    if idx not in _IDX:
        raise TypeError(f"idx must be torch.int32 or torch.int64, got {idx}")
    if prev is not None and (prev.dim() != 1 or prev.shape[0] != len(keys)
                             or prev.device != keys[0].device):
        raise ValueError("prev must hold one value a key plane, on the "
                         "planes' device")
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")
    return keys


def plain_shard_head_ranks(keys, prev, offset: int, idx) -> tuple:
    """`shard_head_ranks` as the chain of PyTorch ops the global build ran
    before, on the planes' device."""
    keys = _check_shard(keys, prev, offset, idx)
    n = keys[0].shape[0]
    device = keys[0].device
    eq = None
    for i, k in enumerate(keys):
        before = k[:1] if prev is None else prev[i:i + 1].to(k.dtype)
        same = k == torch.cat([before, k[:-1]])
        eq = same if eq is None else eq & same
    if prev is None and n:
        eq[0] = False
    gslots = offset + torch.arange(n, dtype=idx, device=device)
    heads = last_flagged(~eq, gslots)
    # tied, as far as the shard shows: not its own head, or the next slot
    # in the shard shares its head
    same_next = torch.cat([heads[1:] == heads[:-1],
                           torch.zeros((min(n, 1),), dtype=torch.bool,
                                       device=device)])
    count = ((heads != gslots) | same_next).sum()
    return heads, count


def shard_head_ranks(keys, prev, offset: int, idx) -> tuple:
    """Head-slot ranking of one shard of a sorted global order: what
    `head_ranks` computes for a whole order, with the shard's boundary.

    `keys` are the shard's [L] key planes, in sorted order. Slot j > 0
    starts a group where some key plane differs from slot j - 1; slot 0
    where its keys differ from `prev`, a [k] tensor holding the previous
    shard's last key tuple (read as int64), or always where `prev` is None
    (the global first slot). Returns (heads, count): heads[j], of dtype
    `idx`, is offset + the last slot <= j that starts a group (the global
    slot of j's group head, with offset = the shard's first global slot),
    or -1 where no slot of the shard up to j starts one; count, a 0-d
    int64 tensor on the planes' device, counts the slots that do not start
    a group, and those that do where slot j + 1 of the shard does not. The
    caller adds the carry of a headless prefix and the term of the shard's
    last slot, which both need the neighbouring shards.
    """
    keys = _check_shard(keys, prev, offset, idx)
    if not _on_cuda(keys[0], "the key planes"):
        return plain_shard_head_ranks(keys, prev, offset, idx)
    if prev is not None:
        prev = prev.to(torch.int64).contiguous()
    return _launch_heads("shard_head_ranks", keys, keys[0].shape[0], prev,
                         offset, idx, keys[0].device)
