// The doubling engine's steps between the sorts, on Hopper (sm_90a).
//
// Three kernels, each the fusion of a chain of PyTorch ops that
// `engines/doubling.py` ran one op, and one pass over device memory, at a
// time. None replaces a Pallas kernel: the JAX package writes these steps
// as jnp ops inside its one jitted build (stringsearch_tpu/engines/
// doubling.py:9-10, `build_sa` l.370), and XLA fuses them there.
//
//   pack_keys_kernel  replaces `_pack4_keys` (stringsearch_tpu/engines/
//       doubling.py:83) and the position `arange` of `_initial_sorted`
//       (l.182): it writes the initial sort's operands, the chunk index
//       (with chunks), depth/4 int32 keys of four raw bytes each,
//       big-endian, zero past the end of the suffix's chunk, XOR
//       0x80000000, and the position.
//   shift_planes_kernel  replaces `_shift_ranks` (l.116), once for every
//       shift of a round, and the round's position `arange`: out_s[i] =
//       rank[i + s], or the marker -(local i + 1) past the end of i's chunk.
//   head_ranks_kernel  replaces the neighbour diff, `lax.cummax` and tied
//       count of `_ranks_sorted_only` / `_heads_and_tied` (l.143-172):
//       rank_s[j] = the last slot <= j where some key plane differs from
//       the slot before (slot 0 always counts), and the number of slots
//       whose group holds two or more. On one shard of the global build
//       (stringsearch_tpu/parallel/global_sa.py:120,
//       `_headslot_ranks_from_sorted`, and the neighbour diff before it)
//       slot 0 is compared with the previous shard's last key tuple, a
//       slot before the shard's first group start gets -1, and the heads
//       are offset to global slots.
//
// Bound: device-memory bytes, for all three. Each reads its inputs and
// writes its outputs once and does a few integer operations an element:
//   pack_keys     n text bytes in, (4 * depth/4 + 4 or 8 [+ 4 or 8]) n out;
//   shift_planes  one rank plane in (its shifts meet in L2), one plane out
//                 a shift, and the positions;
//   head_ranks    every key plane in, one rank plane out.
// What the design does about it:
//   * One pass each, in place of one op a pass (the eager chain makes a
//     temporary plane for every shift, OR, compare, cat and cumsum).
//   * No per-thread copy of the launch's arguments: shift_planes reads its
//     table of output planes with constant indices (a loop over them that
//     was not unrolled put the table on every thread's stack, and ran at
//     0.30 of the bound at 2^28, slower than the eager chain).
//   * Neighbouring threads on neighbouring addresses. pack_keys gives a
//     thread four consecutive positions: it reads two words of a tile of
//     text staged in shared memory (with a halo of depth bytes) and builds
//     its four keys with `__byte_perm`, then stores them as one 16-byte
//     write. head_ranks gives a thread kScanItems consecutive slots, read
//     and written 16 bytes at a time. shift_planes reads and writes one
//     element a thread an instruction, 128 bytes a warp.
//   * The running max of head_ranks crosses tiles by decoupled look-back
//     (Merrill and Garland, 2016), as `sort_pass_kernel` in radix_sort.cu
//     does: a tile is claimed from an atomic counter, so every predecessor
//     is resident. For a max, a tile that holds a flag knows its inclusive
//     value (its own last flag) before any look-back and publishes it at
//     once; a tile with no flag publishes "none here" and, once its
//     look-back ends, its inclusive value. A look-back skips "none here"
//     words 32 at a time (one a lane) and stops at the first inclusive
//     one, so long tied runs (periodic text, all-equal keys) walk back only
//     over tiles still in flight. Only a tile whose first slot carries no
//     flag looks back at all.
//   * The tied count is local (a slot and its successor's flag): a block
//     reduction and one 64-bit atomic add a tile into a 0-d device tensor,
//     which the host reads only when the engine asks (no added sync).
//
// Interface: plain C, loaded with ctypes. Each function launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// the first nonzero CUDA error of its launches, or 0.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr unsigned kFull = 0xffffffffu;

constexpr int kPackThreads = 256;
constexpr int kPackItems = 4;  // consecutive positions a thread
constexpr int kPackTile = kPackThreads * kPackItems;
// A pack tile stages kPackTile + 4 * keys + 4 bytes of text.
constexpr int kMaxPackKeys = 4096;

constexpr int kShiftThreads = 256;
constexpr int kShiftItems = 4;  // elements a thread, kShiftThreads apart
constexpr int kShiftTile = kShiftThreads * kShiftItems;
constexpr int kMaxShifts = 8;  // output planes a launch

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;  // consecutive slots a thread
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kMaxKeys = 64;

// Look-back words: status << 62 | value. kNone: the tile holds no flag and
// does not know its inclusive value yet; kInclusive: value is the last
// flag at or before the tile's last slot.
constexpr uint64_t kNone = 1ull << 62;
constexpr uint64_t kInclusive = 2ull << 62;
constexpr uint64_t kValueMask = (1ull << 62) - 1;

__device__ __forceinline__ void store_word(uint64_t* at, uint64_t w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(at), "l"(w)
               : "memory");
}

__device__ __forceinline__ uint64_t load_word(const uint64_t* at) {
  uint64_t w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(w)
               : "l"(at)
               : "memory");
  return w;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// v[0..N) to p[0..N) as 16-byte stores; p must be 16-byte aligned.
template <typename T, int N>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[N]) {
  static_assert(N * sizeof(T) % 16 == 0, "whole 16-byte stores");
#pragma unroll
  for (int c = 0; c < N * static_cast<int>(sizeof(T)) / 16; ++c) {
    int4 x;
    memcpy(&x, reinterpret_cast<const char*>(v) + 16 * c, 16);
    reinterpret_cast<int4*>(p)[c] = x;
  }
}

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[N]) {
  static_assert(N * sizeof(T) % 16 == 0, "whole 16-byte loads");
#pragma unroll
  for (int c = 0; c < N * static_cast<int>(sizeof(T)) / 16; ++c) {
    const int4 x = reinterpret_cast<const int4*>(p)[c];
    memcpy(reinterpret_cast<char*>(v) + 16 * c, &x, 16);
  }
}

// v[0..N) to p[0..min(N, left)): one vector store when all N fit and p is
// aligned, else element by element.
template <typename T, int N>
__device__ __forceinline__ void store_run(T* p, const T (&v)[N],
                                          int64_t left) {
  if (left >= N && aligned16(p)) {
    store_vec(p, v);
  } else {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      if (m < left) p[m] = v[m];
    }
  }
}

// i modulo chunk; 32-bit arithmetic when both are below 2^32 (`small`).
__device__ __forceinline__ int64_t local_of(int64_t i, int64_t chunk,
                                            bool small) {
  if (small) {
    return static_cast<uint32_t>(i) % static_cast<uint32_t>(chunk);
  }
  return i % chunk;
}

// ---------------------------------------------------------------------------
// pack_keys
// ---------------------------------------------------------------------------

// One tile of kPackTile positions a block. Output planes: `keys` int32
// planes at key_out + k * stride (stride a multiple of 4, so every plane
// starts on 16 bytes), the chunk index at chunk_out (none when null) and
// the position at pos_out, both of type Idx.
template <typename Idx>
__global__ void __launch_bounds__(kPackThreads)
    pack_keys_kernel(const uint8_t* __restrict__ text, int64_t n,
                     int64_t chunk, int keys, int64_t stride,
                     int* __restrict__ key_out, Idx* __restrict__ chunk_out,
                     Idx* __restrict__ pos_out) {
  extern __shared__ uint32_t line[];  // text [t0, t0 + 4 * words), 0 past n
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kPackTile;
  const int words = kPackThreads + keys + 1;
  const bool text_aligned = (reinterpret_cast<uintptr_t>(text) & 3) == 0;
  for (int w = threadIdx.x; w < words; w += kPackThreads) {
    const int64_t g = t0 + 4 * w;
    uint32_t v = 0;
    if (text_aligned && g + 4 <= n) {
      v = __ldg(reinterpret_cast<const uint32_t*>(text + g));
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (g + b < n) v |= static_cast<uint32_t>(text[g + b]) << (8 * b);
      }
    }
    line[w] = v;
  }
  __syncthreads();

  const int64_t i0 = t0 + kPackItems * threadIdx.x;
  if (i0 >= n) return;
  const int64_t left = n - i0;
  // each position's chunk and the end of that chunk
  int64_t c = chunk >= n ? 0 : i0 / chunk;
  int64_t end = (c + 1) * chunk;
  int64_t ends[kPackItems];
  Idx cidx[kPackItems], pos[kPackItems];
#pragma unroll
  for (int m = 0; m < kPackItems; ++m) {
    while (i0 + m >= end) {
      end += chunk;
      ++c;
    }
    ends[m] = end;
    cidx[m] = static_cast<Idx>(c);
    pos[m] = static_cast<Idx>(i0 + m);
  }
  for (int k = 0; k < keys; ++k) {
    // bytes i0 + 4k .. i0 + 4k + 7; byte b of the pair is (b < 4 ? w0 : w1)
    // bits 8 * (b % 4)
    const uint32_t w0 = line[threadIdx.x + k];
    const uint32_t w1 = line[threadIdx.x + k + 1];
    int v[kPackItems];
#pragma unroll
    for (int m = 0; m < kPackItems; ++m) {
      // bytes m .. m + 3 of the pair, the first in the top bits
      const unsigned sel = (m + 3) | (m + 2) << 4 | (m + 1) << 8 | m << 12;
      uint32_t key = __byte_perm(w0, w1, sel);
      const int64_t inside = ends[m] - (i0 + m + 4 * k);
      if (inside < 4) {
        key = inside <= 0 ? 0u : key & (kFull << (8 * (4 - inside)));
      }
      v[m] = static_cast<int>(key ^ 0x80000000u);
    }
    store_run(key_out + k * stride + i0, v, left);
  }
  if (chunk_out != nullptr) store_run(chunk_out + i0, cidx, left);
  store_run(pos_out + i0, pos, left);
}

// ---------------------------------------------------------------------------
// shift_planes
// ---------------------------------------------------------------------------

template <typename T>
struct ShiftOut {
  T* plane[kMaxShifts];
  int64_t shift[kMaxShifts];  // each in [0, chunk]
};

// out.plane[s][i] = rank[i + shift] where the local position l of i in its
// chunk has l + shift < chunk, else -(l + 1); pos[i] = i unless pos is null.
template <typename T>
__global__ void __launch_bounds__(kShiftThreads)
    shift_planes_kernel(const T* __restrict__ rank, int64_t n, int64_t chunk,
                        int count, ShiftOut<T> out, T* __restrict__ pos) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kShiftTile;
  const bool flat = chunk >= n;
  const bool small = n < (int64_t(1) << 32);
  int64_t local[kShiftItems];
#pragma unroll
  for (int m = 0; m < kShiftItems; ++m) {
    const int64_t i = t0 + threadIdx.x + m * kShiftThreads;
    local[m] = flat ? i : local_of(i, chunk, small);
  }
  // unrolled, so that `out` is read with constant indices: indexed at run
  // time it is copied to every thread's stack (local memory), which cost
  // as much traffic as the planes themselves
#pragma unroll
  for (int s = 0; s < kMaxShifts; ++s) {
    if (s >= count) break;
    const int64_t h = out.shift[s];
    T* __restrict__ dst = out.plane[s];
#pragma unroll
    for (int m = 0; m < kShiftItems; ++m) {
      const int64_t i = t0 + threadIdx.x + m * kShiftThreads;
      if (i < n) {
        dst[i] = local[m] + h < chunk ? rank[i + h]
                                      : static_cast<T>(-(local[m] + 1));
      }
    }
  }
  if (pos != nullptr) {
#pragma unroll
    for (int m = 0; m < kShiftItems; ++m) {
      const int64_t i = t0 + threadIdx.x + m * kShiftThreads;
      if (i < n) pos[i] = static_cast<T>(i);
    }
  }
}

// ---------------------------------------------------------------------------
// head_ranks
// ---------------------------------------------------------------------------

struct KeyPlanes {
  const void* plane[kMaxKeys];
  uint64_t wide;  // bit q set: plane q is int64, else int32
};

// diff[m] |= p[j0 + m] != p[j0 + m - 1] for m in [0, kScanItems], where
// both slots lie in [0, n); slot 0's predecessor is `prev` where it is not
// null.
template <typename T>
__device__ __forceinline__ void add_diffs(const T* __restrict__ p, int64_t j0,
                                          int64_t n, const int64_t* prev,
                                          bool (&diff)[kScanItems + 1]) {
  if (j0 >= n) return;
  T v[kScanItems];
  if (j0 + kScanItems <= n && aligned16(p + j0)) {
    load_vec(p + j0, v);
  } else {
#pragma unroll
    for (int m = 0; m < kScanItems; ++m) v[m] = j0 + m < n ? p[j0 + m] : T(0);
  }
  if (j0 > 0) {
    diff[0] |= v[0] != p[j0 - 1];
  } else if (prev != nullptr) {
    diff[0] |= static_cast<int64_t>(v[0]) != *prev;
  }
#pragma unroll
  for (int m = 1; m < kScanItems; ++m) diff[m] |= v[m] != v[m - 1];
  if (j0 + kScanItems < n) diff[kScanItems] |= p[j0 + kScanItems] !=
                                              v[kScanItems - 1];
}

// A headless slot: none of the slots up to it starts a group (only where
// slot 0 is compared with `prev`). As a look-back value, all value bits.
__device__ __forceinline__ uint64_t encode_head(int64_t v) {
  return v < 0 ? kValueMask : static_cast<uint64_t>(v);
}

__device__ __forceinline__ int64_t decode_head(uint64_t w) {
  return (w & kValueMask) == kValueMask ? -1
                                        : static_cast<int64_t>(w & kValueMask);
}

// prev: null, or one int64 a key plane, slot 0's predecessor (null: slot
// 0 starts a group). rank_out[j] = offset + the last group start <= j, or
// -1 where there is none.
template <typename Idx>
__global__ void __launch_bounds__(kScanThreads)
    head_ranks_kernel(KeyPlanes planes, int keys, int64_t n,
                      const int64_t* __restrict__ prev, int64_t offset,
                      Idx* __restrict__ rank_out,
                      unsigned long long* __restrict__ count,
                      uint64_t* __restrict__ words,
                      unsigned* __restrict__ tile_counter) {
  __shared__ int64_t warp_last[kScanWarps];
  __shared__ unsigned warp_tied[kScanWarps];
  __shared__ int64_t prefix;
  __shared__ int tile_slot;
  __shared__ bool first_flag;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) tile_slot = static_cast<int>(atomicAdd(tile_counter, 1u));
  __syncthreads();
  const int64_t tile = tile_slot;
  const int64_t j0 = tile * kScanTile + static_cast<int64_t>(tid) * kScanItems;

  // flag[m]: slot j0 + m starts a group (m = kScanItems is the next
  // thread's first slot, for the tied test of this thread's last)
  bool flag[kScanItems + 1] = {};
  for (int q = 0; q < keys; ++q) {
    if (planes.wide >> q & 1) {
      add_diffs(static_cast<const int64_t*>(planes.plane[q]), j0, n,
                prev == nullptr ? nullptr : prev + q, flag);
    } else {
      add_diffs(static_cast<const int*>(planes.plane[q]), j0, n,
                prev == nullptr ? nullptr : prev + q, flag);
    }
  }
  if (j0 == 0 && prev == nullptr) flag[0] = true;
  int64_t last = -1;  // this thread's last flagged slot
  unsigned tied = 0;
#pragma unroll
  for (int m = 0; m < kScanItems; ++m) {
    if (j0 + m < n) {
      if (flag[m]) last = j0 + m;
      tied += !flag[m] || (j0 + m + 1 < n && !flag[m + 1]);
    }
  }
  if (tid == 0) first_flag = flag[0];

  // the running max over the block: warps, then the warps before
  int64_t incl = last;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = o > incl ? o : incl;
  }
  int64_t excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = -1;
  tied = __reduce_add_sync(kFull, tied);
  if (lane == 31) warp_last[warp] = incl;
  if (lane == 0) warp_tied[warp] = tied;
  __syncthreads();
  int64_t tile_last = -1;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) {
    const int64_t x = warp_last[w];
    if (w < warp && x > excl) excl = x;
    if (x > tile_last) tile_last = x;
  }
  if (tid == 0) {
    // a tile with a flag knows its inclusive value now
    store_word(words + tile, tile_last >= 0
                                 ? kInclusive | static_cast<uint64_t>(tile_last)
                                 : kNone);
    unsigned total = 0;
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) total += warp_tied[w];
    if (total) atomicAdd(count, static_cast<unsigned long long>(total));
  }

  // the look-back: only a tile whose first slot is not flagged needs the
  // last flag before it (before tile 0 there is none)
  const bool need = !first_flag;
  if (need) {
    if (warp == 0) {
      int64_t at = tile - 1;  // the nearest predecessor not yet passed
      uint64_t found;
      for (;;) {
        const int64_t t = at - lane;
        const uint64_t w =
            t >= 0 ? load_word(words + t) : kInclusive | encode_head(-1);
        const unsigned open = __ballot_sync(kFull, (w & ~kValueMask) != kNone);
        if (open == 0) {
          at -= 32;
          continue;
        }
        const int first = __ffs(open) - 1;
        const uint64_t fw = __shfl_sync(kFull, w, first);
        if ((fw & ~kValueMask) == kInclusive) {
          found = fw;
          break;
        }
        at -= first;  // wait on the nearest word not yet published
      }
      if (lane == 0) prefix = decode_head(found);
    }
    __syncthreads();
    if (tid == 0 && tile_last < 0) {
      store_word(words + tile, kInclusive | encode_head(prefix));
    }
    if (prefix > excl) excl = prefix;
  }

  Idx r[kScanItems];
  int64_t run = excl;
#pragma unroll
  for (int m = 0; m < kScanItems; ++m) {
    if (flag[m]) run = j0 + m;
    r[m] = static_cast<Idx>(run < 0 ? run : run + offset);
  }
  if (j0 < n) store_run(rank_out + j0, r, n - j0);
}

inline int blocks_of(int64_t n, int tile) {
  return static_cast<int>((n + tile - 1) / tile);
}

}  // namespace

extern "C" {

// The operands of the initial sort of n text bytes, in one launch. keys:
// int32 planes at key_out + k * stride (stride >= n, a multiple of 4,
// key_out 16-byte aligned); chunk_out (null for none) and pos_out of
// idx_bytes (4 or 8) each, 16-byte aligned. chunk divides n.
int ss_pack_keys(const void* text, int64_t n, int64_t chunk, int keys,
                 int64_t stride, void* key_out, void* chunk_out,
                 void* pos_out, int idx_bytes, void* stream) {
  if (n < 1 || chunk < 1 || n % chunk != 0 || keys < 1 ||
      keys > kMaxPackKeys || stride < n || stride % 4 != 0 ||
      (idx_bytes != 4 && idx_bytes != 8) ||
      (reinterpret_cast<uintptr_t>(key_out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = 4 * (kPackThreads + keys + 1);
  const int blocks = blocks_of(n, kPackTile);
  const auto* t = static_cast<const uint8_t*>(text);
  auto* k = static_cast<int*>(key_out);
  if (idx_bytes == 4) {
    pack_keys_kernel<int><<<blocks, kPackThreads, smem, s>>>(
        t, n, chunk, keys, stride, k, static_cast<int*>(chunk_out),
        static_cast<int*>(pos_out));
  } else {
    pack_keys_kernel<int64_t><<<blocks, kPackThreads, smem, s>>>(
        t, n, chunk, keys, stride, k, static_cast<int64_t*>(chunk_out),
        static_cast<int64_t*>(pos_out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Shifted copies of a rank plane of n elements of elem_bytes (4 or 8):
// outs[s][i] = rank[i + shifts[s]] inside i's chunk, else -(local i + 1);
// shifts[s] in [0, chunk]; 1 <= count <= kMaxShifts output planes, and the
// position at pos_out unless it is null. outs and shifts are host arrays.
int ss_shift_planes(const void* rank, int64_t n, int64_t chunk,
                    int elem_bytes, int count, void** outs,
                    const int64_t* shifts, void* pos_out, void* stream) {
  if (n < 1 || chunk < 1 || n % chunk != 0 || count < 0 ||
      count > kMaxShifts || (elem_bytes != 4 && elem_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_of(n, kShiftTile);
  if (elem_bytes == 4) {
    ShiftOut<int> out{};
    for (int q = 0; q < count; ++q) {
      if (shifts[q] < 0 || shifts[q] > chunk) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      out.plane[q] = static_cast<int*>(outs[q]);
      out.shift[q] = shifts[q];
    }
    shift_planes_kernel<int><<<blocks, kShiftThreads, 0, s>>>(
        static_cast<const int*>(rank), n, chunk, count, out,
        static_cast<int*>(pos_out));
  } else {
    ShiftOut<int64_t> out{};
    for (int q = 0; q < count; ++q) {
      if (shifts[q] < 0 || shifts[q] > chunk) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      out.plane[q] = static_cast<int64_t*>(outs[q]);
      out.shift[q] = shifts[q];
    }
    shift_planes_kernel<int64_t><<<blocks, kShiftThreads, 0, s>>>(
        static_cast<const int64_t*>(rank), n, chunk, count, out,
        static_cast<int64_t*>(pos_out));
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch `ss_head_ranks` needs for n slots: a look-back word a
// tile and the tile counter.
int64_t ss_head_ranks_scratch_bytes(int64_t n) {
  return (static_cast<int64_t>(blocks_of(n, kScanTile)) + 1) * 8;
}

// Head-slot ranks of n sorted slots: rank_out[j] (idx_bytes, 4 or 8) =
// offset + the last slot <= j where one of the `keys` planes (planes: host
// array of device pointers, plane_bytes: 4 or 8 each) differs from the
// slot before, or -1 where there is none; slot 0's predecessor is the key
// tuple at prev (a device array of one int64 a plane), or, where prev is
// null, slot 0 always counts. *count (a device int64) = the slots j that
// do not count, or whose slot j + 1 < n does not: the slots whose group
// holds two or more, where the group goes no further than slot n - 1.
// scratch: ss_head_ranks_scratch_bytes(n), 8-byte aligned.
int ss_head_ranks(const void* const* planes, const int* plane_bytes, int keys,
                  int64_t n, const void* prev, int64_t offset, void* rank_out,
                  int idx_bytes, void* count, void* scratch, void* stream) {
  if (n < 1 || keys < 0 || keys > kMaxKeys ||
      (idx_bytes != 4 && idx_bytes != 8) ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  KeyPlanes kp{};
  for (int q = 0; q < keys; ++q) {
    if (plane_bytes[q] != 4 && plane_bytes[q] != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    kp.plane[q] = planes[q];
    if (plane_bytes[q] == 8) kp.wide |= 1ull << q;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = blocks_of(n, kScanTile);
  auto* words = static_cast<uint64_t*>(scratch);
  auto* counter = reinterpret_cast<unsigned*>(words + tiles);
  cudaError_t err = cudaMemsetAsync(scratch, 0, ss_head_ranks_scratch_bytes(n),
                                    s);
  if (err == cudaSuccess) err = cudaMemsetAsync(count, 0, 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* c = static_cast<unsigned long long*>(count);
  if (idx_bytes == 4) {
    head_ranks_kernel<int><<<tiles, kScanThreads, 0, s>>>(
        kp, keys, n, static_cast<const int64_t*>(prev), offset,
        static_cast<int*>(rank_out), c, words, counter);
  } else {
    head_ranks_kernel<int64_t><<<tiles, kScanThreads, 0, s>>>(
        kp, keys, n, static_cast<const int64_t*>(prev), offset,
        static_cast<int64_t*>(rank_out), c, words, counter);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ss_steps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
