"""The doubling engine's steps between the sorts, as Hopper kernels.

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
    `parallel/global_sa.py` adds);
  * `shard_pack_keys`: `pack_keys`' kernel on one shard of the global
    build, the bytes past the shard from the next shard's first `depth`
    (the packing of `_initial_shard_ranks`, l.166-189, with no
    concatenation) and global positions;
  * `shard_shift_planes`: the shifted rank planes of one shard of a global
    round from the shards the round's ppermutes delivered, with the end
    marker past the padded text and the global positions (its
    `_shifted_ranks`, l.216, once a shift, and the round's `arange`).
  * `invert_ranks`: the text-order ranks of a sorted order, rank[sa_s[j]]
    = rank_s[j] (its `_scatter_to_text_order`, l.105, which sorts (sa_s,
    rank_s) by sa_s: sa_s is a permutation, so one scatter gives the same
    ranks).

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

`pack_keys`, `shift_planes`, `head_ranks` and `invert_ranks`, and the
global build's `shard_pack_keys`, `shard_shift_planes` and
`shard_head_ranks`, each run inside a span of their name (`ops.pack_keys`,
...; `harness/tracing.py`) whose attributes `reads` and `writes` give
(elements, bytes an element) of each plane the step reads and writes: the
bytes its kernel must move (of a shard shift's windows, the parts it
reads; of `shard_pack_keys`, the chunk, then the halo where there is
one).

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

from stringsearch_torch.harness.tracing import planes, spanned
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
# kInvertThreads times the int32 items a thread of csrc/steps.cu: the
# elements a block of `invert_ranks` takes (int64: half)
INVERT_TILE = 8192

# Kernel launches in this process, by function (`shard_head_ranks` and
# `shard_pack_keys` are the kernels of `head_ranks` and `pack_keys` on one
# shard of the global build).
launches = {"pack_keys": 0, "shift_planes": 0, "head_ranks": 0,
            "shard_head_ranks": 0, "shard_pack_keys": 0,
            "shard_shift_planes": 0, "invert_ranks": 0}

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
    lib.ss_shard_pack_keys.argtypes = [
        _P, ctypes.c_int64, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        _P, _P, ctypes.c_int64, ctypes.c_int, _P]
    lib.ss_shard_shift_planes.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_P), ctypes.POINTER(_P), ctypes.POINTER(_P),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64), _P,
        _P]
    lib.ss_invert_ranks.argtypes = [
        _P, _P, ctypes.c_int64, ctypes.c_int, _P, _P, _P]
    for fn in (lib.ss_pack_keys, lib.ss_shift_planes, lib.ss_head_ranks,
               lib.ss_shard_pack_keys, lib.ss_shard_shift_planes,
               lib.ss_invert_ranks):
        fn.restype = ctypes.c_int
    lib.ss_head_ranks_scratch_bytes.argtypes = [ctypes.c_int64]
    lib.ss_head_ranks_scratch_bytes.restype = ctypes.c_int64
    lib.ss_invert_ranks_scratch_bytes.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.ss_invert_ranks_scratch_bytes.restype = ctypes.c_int64
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


@spanned("ops.pack_keys", lambda out, text, *a, **k: {
    "reads": planes((text,)), "writes": planes(out)})
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


@spanned("ops.shift_planes", lambda out, rank, *a, **k: {
    "reads": planes((rank,)), "writes": planes(out)})
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


@spanned("ops.head_ranks", lambda res, out: {
    "reads": planes(tuple(out)[:-1]), "writes": planes(res[1:2])})
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
# invert_ranks
# ---------------------------------------------------------------------------


def _check_invert(sa_s, rank_s, out) -> None:
    for name, t in (("sa_s", sa_s), ("rank_s", rank_s)):
        if t.dtype not in _IDX or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 or int64 tensor, "
                            f"got {t.dtype} of {t.dim()} dims")
    if (sa_s.dtype != rank_s.dtype or sa_s.shape != rank_s.shape
            or sa_s.device != rank_s.device):
        raise ValueError("sa_s and rank_s must share one dtype, one length "
                         "and one device")
    if out is not None and (out.dtype != rank_s.dtype or out.dim() != 1
                            or out.shape[0] < rank_s.shape[0]
                            or out.device != rank_s.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous 1-D {rank_s.dtype} "
                         f"tensor of at least {rank_s.shape[0]} slots on "
                         f"{rank_s.device}")


def plain_invert_ranks(sa_s, rank_s, out=None):
    """`invert_ranks` as one PyTorch scatter, on the planes' device."""
    _check_invert(sa_s, rank_s, out)
    rank = torch.empty_like(rank_s) if out is None else out
    rank[sa_s] = rank_s
    return rank


@spanned("ops.invert_ranks", lambda res, sa_s, rank_s, *a, **k: {
    "reads": planes((sa_s, rank_s)), "writes": planes((rank_s,))})
def invert_ranks(sa_s, rank_s, out=None):
    """The text-order ranks of a sorted order: rank[sa_s[j]] = rank_s[j].

    `sa_s`, a permutation of [0, n), and `rank_s` are [n] int32 or int64
    planes of one dtype. Returns a new [n] plane of their dtype, or `out`
    (a contiguous plane of that dtype with n slots or more) with its
    first n slots written and the rest left as they were.
    """
    _check_invert(sa_s, rank_s, out)
    if not _on_cuda(sa_s, "sa_s"):
        return plain_invert_ranks(sa_s, rank_s, out)
    n = sa_s.shape[0]
    rank = torch.empty_like(rank_s) if out is None else out
    if not n:
        return rank
    sa_s, rank_s = sa_s.contiguous(), rank_s.contiguous()
    width = rank_s.element_size()
    nbytes = load_library().ss_invert_ranks_scratch_bytes(n, width)
    scratch = (torch.empty((nbytes,), dtype=torch.uint8, device=sa_s.device)
               if nbytes else None)
    _launch("invert_ranks", "ss_invert_ranks", sa_s.device, sa_s.data_ptr(),
            rank_s.data_ptr(), n, width, rank.data_ptr(),
            None if scratch is None else scratch.data_ptr())
    return rank


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


@spanned("ops.shard_head_ranks", lambda res, keys, *a, **k: {
    "reads": planes(keys), "writes": planes(res[:1])})
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


# ---------------------------------------------------------------------------
# shard_pack_keys: pack_keys on one shard of the global build
# ---------------------------------------------------------------------------


def _check_shard_pack(chunk, halo, depth: int, offset: int, idx) -> None:
    _check_pack(chunk, depth, idx)
    if halo is not None and (halo.dtype != torch.uint8
                             or halo.shape != (depth,)
                             or halo.device != chunk.device):
        raise ValueError(f"halo must be None or {depth} uint8 bytes on the "
                         f"chunk's device")
    if offset < 0:
        raise ValueError(f"offset must be >= 0, got {offset}")


def plain_shard_pack_keys(chunk, halo, depth: int, offset: int,
                          idx=_I32) -> tuple:
    """`shard_pack_keys` as the chain of PyTorch ops the global build ran
    before, on the chunk's device."""
    _check_shard_pack(chunk, halo, depth, offset, idx)
    length = chunk.shape[0]
    nxt = chunk.new_zeros((depth,)) if halo is None else halo
    ext = torch.cat([chunk, nxt]).to(_I32)  # [L + depth]
    keys = []
    for k in range(depth // 4):
        o = 4 * k
        keys.append(((ext[o:o + length] << 24)
                     | (ext[o + 1:o + 1 + length] << 16)
                     | (ext[o + 2:o + 2 + length] << 8)
                     | ext[o + 3:o + 3 + length]) ^ BIAS)
    pos = offset + torch.arange(length, dtype=idx, device=chunk.device)
    return (*keys, pos)


@spanned("ops.shard_pack_keys", lambda out, chunk, halo, *a, **k: {
    "reads": planes((chunk,) if halo is None else (chunk, halo)),
    "writes": planes(out)})
def shard_pack_keys(chunk, halo, depth: int, offset: int, idx=_I32) -> tuple:
    """The operands of the global build's initial sort on one shard.

    `chunk` is the shard's [L] uint8 text, `halo` the next shard's first
    `depth` bytes (None past the last shard: zeros). Returns (key_0, ..,
    key_{depth/4 - 1}, position): key k of position i is bytes i+4k ..
    i+4k+3 of the chunk followed by the halo, big-endian, XOR 0x80000000,
    as int32 (as `pack_keys` packs them); the position is offset + i, of
    dtype `idx`.
    """
    _check_shard_pack(chunk, halo, depth, offset, idx)
    if not _on_cuda(chunk, "chunk"):
        return plain_shard_pack_keys(chunk, halo, depth, offset, idx)
    n = chunk.shape[0]
    nk = depth // 4
    if nk > _MAX_PACK_KEYS:
        raise ValueError(f"shard_pack_keys takes depth <= "
                         f"{4 * _MAX_PACK_KEYS} on CUDA, got {depth}")
    if idx == _I32 and offset + n >= 1 << 31:
        raise ValueError("int32 positions need offset + L < 2^31")
    chunk = chunk.contiguous()
    if halo is not None:
        halo = halo.contiguous()
    stride = -(-n // 4) * 4
    block = torch.empty((nk, stride), dtype=_I32, device=chunk.device)
    pos = torch.empty(n, dtype=idx, device=chunk.device)
    if n:
        _launch("shard_pack_keys", "ss_shard_pack_keys", chunk.device,
                chunk.data_ptr(), n, None if halo is None else halo.data_ptr(),
                0 if halo is None else depth, nk, stride, block.data_ptr(),
                pos.data_ptr(), offset, pos.element_size())
    return (*(block[k, :n] for k in range(nk)), pos)


# ---------------------------------------------------------------------------
# shard_shift_planes: the shifted ranks of one shard of a global round
# ---------------------------------------------------------------------------


def _device_of(device) -> torch.device:
    """`device` as a torch.device, a CUDA device with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_shard_shift(windows, length: int, offset: int, n_pad: int, idx,
                       device) -> list:
    windows = [(int(h), head, tail) for h, head, tail in windows]
    if idx not in _IDX:
        raise TypeError(f"idx must be torch.int32 or torch.int64, got {idx}")
    if length < 1 or offset < 0 or n_pad < offset + length:
        raise ValueError(f"need length >= 1 and 0 <= offset <= n_pad - "
                         f"length, got {length}, {offset}, {n_pad}")
    for h, head, tail in windows:
        if not 0 <= h <= n_pad:
            raise ValueError(f"a shift must lie in [0, n_pad], got {h}")
        for t in (head, tail):
            if t is not None and (t.dtype != idx or t.shape != (length,)
                                  or t.device != device):
                raise TypeError(f"a window's shards must be [{length}] "
                                f"{idx} on {device}, got "
                                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return windows


def plain_shard_shift_planes(windows, length: int, offset: int, n_pad: int,
                             idx, device) -> list:
    """`shard_shift_planes` as the chain of PyTorch ops the global build
    ran before, on `device`."""
    device = _device_of(device)
    windows = _check_shard_shift(windows, length, offset, n_pad, idx,
                                 device)
    gidx = offset + torch.arange(length, dtype=idx, device=device)
    out = []
    for h, head, tail in windows:
        r = h % length
        a = torch.full_like(gidx, -1) if head is None else head
        if r:
            b = torch.full_like(gidx, -1) if tail is None else tail
            a = torch.cat([a[r:], b[:r]])
        if h < n_pad:
            out.append(torch.where(gidx < n_pad - h, a, -(gidx + 1)))
        else:
            out.append(-(gidx + 1))
    return out + [gidx]


def _window_reads(windows, length: int) -> tuple:
    """(elements, bytes an element) of each part of the windows a shard
    shift reads: [h % length, length) of each head and [0, h % length) of
    each tail it is given."""
    out = []
    for h, head, tail in windows:
        r = int(h) % length
        for t, n in ((head, length - r), (tail, r)):
            if t is not None and n:
                out.append((n, t.element_size()))
    return tuple(out)


@spanned("ops.shard_shift_planes", lambda out, windows, length, *a, **k: {
    "reads": _window_reads(windows, length), "writes": planes(out)})
def shard_shift_planes(windows, length: int, offset: int, n_pad: int, idx,
                       device) -> list:
    """[rank shifted by h for each window] + [the global positions], on
    one shard of a global round.

    The shard holds the global positions offset .. offset + length - 1 of
    a padded text of n_pad. Each window is (h, head, tail), 0 <= h <=
    n_pad: `head` is the [length] rank shard that holds global position
    offset + (h // length) * length, `tail` the shard after it (None where
    a shard lies past the last one, or where h % length is 0 and no tail
    is read). Entry i of the plane of shift h is rank[offset + i + h], read
    from the two shards, or the marker -(offset + i + 1) where offset + i
    + h >= n_pad. The shards lie on `device`; all planes have dtype `idx`,
    on `device`.
    """
    device = _device_of(device)
    windows = _check_shard_shift(windows, length, offset, n_pad, idx,
                                 device)
    if device.type == "cpu":
        return plain_shard_shift_planes(windows, length, offset, n_pad, idx,
                                        device)
    if device.type != "cuda":
        raise ValueError(f"the windows must lie on the CPU or a CUDA device, "
                         f"got {device}")
    if idx == _I32 and n_pad >= 1 << 31:
        raise ValueError("int32 positions need n_pad < 2^31")
    windows = [(h, *(None if t is None else t.contiguous()
                     for t in (head, tail))) for h, head, tail in windows]
    out = [torch.empty(length, dtype=idx, device=device) for _ in windows]
    pos = torch.empty(length, dtype=idx, device=device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # one launch a group of at most _MAX_SHIFTS planes; the first also
    # writes the positions
    for g in range(0, max(len(windows), 1), _MAX_SHIFTS):
        group = windows[g:g + _MAX_SHIFTS]
        k = max(len(group), 1)
        _launch("shard_shift_planes", "ss_shard_shift_planes", device,
                length, offset, pos.element_size(), len(group),
                (_P * k)(*(t.data_ptr() for t in out[g:g + _MAX_SHIFTS])),
                (_P * k)(*(ptr(head) for _h, head, _t in group)),
                (_P * k)(*(ptr(tail) for _h, _hd, tail in group)),
                (ctypes.c_int64 * k)(*(h % length for h, *_ in group)),
                (ctypes.c_int64 * k)(*(min(max(n_pad - h - offset, 0),
                                           length) for h, *_ in group)),
                pos.data_ptr() if g == 0 else None)
    return out + [pos]
