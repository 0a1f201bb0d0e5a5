// The doubling engine's steps between the sorts, on Hopper (sm_90a).
//
// Four kernels, each the fusion of a chain of PyTorch ops that
// `engines/doubling.py` ran one op, and one pass over device memory, at a
// time, the invert, which it ran as a sort, and dense_ranks, which narrows
// a round's sort keys. None replaces a Pallas
// kernel: the JAX package writes these steps as jnp ops inside its one
// jitted build (stringsearch_tpu/engines/doubling.py:9-10, `build_sa`
// l.370), and XLA fuses them there.
//
//   pack_keys_kernel  replaces `_pack4_keys` (stringsearch_tpu/engines/
//       doubling.py:83) and the position `arange` of `_initial_sorted`
//       (l.182): it writes the initial sort's operands, the chunk index
//       (with chunks), depth/4 int32 keys of four raw bytes each,
//       big-endian, zero past the end of the suffix's chunk, XOR
//       0x80000000, and the position.
//   shift_planes_kernel  replaces `_shift_ranks` (l.116), once for every
//       shift of a round, and the round's position `arange`: out_s[i] =
//       rank[i + s], or the marker -(local i + 1) past the end of i's chunk;
//       on a lifted plane rank[i + s] + s, or chunk - 1 - local i, the same
//       order in non-negative values, so that a round's keys take no more
//       radix digits than their values need.
//   head_ranks_kernel  replaces the neighbour diff, `lax.cummax` and tied
//       count of `_ranks_sorted_only` / `_heads_and_tied` (l.143-172):
//       rank_s[j] = the last slot <= j where some key plane differs from
//       the slot before (slot 0 always counts), and the number of slots
//       whose group holds two or more, and on request that count plus
//       the number of groups times 2^32. On one shard of the global build
//       (stringsearch_tpu/parallel/global_sa.py:120,
//       `_headslot_ranks_from_sorted`, and the neighbour diff before it)
//       slot 0 is compared with the previous shard's last key tuple, a
//       slot before the shard's first group start gets -1, and the heads
//       are offset to global slots.
//   On one shard of the global build, two of them again:
//   pack_keys_kernel with a halo (`ss_shard_pack_keys`) replaces the
//       packing of `_initial_shard_ranks` (stringsearch_tpu/parallel/
//       global_sa.py:166-189): the bytes past the shard come from the next
//       shard's first `depth` (zero past the last shard), with no
//       concatenation into an extended chunk, and the positions are global.
//   shard_shift_planes_kernel replaces `_shifted_ranks` (l.216), once for
//       every shift of a round, and the round's global position `arange`:
//       plane s at i is the window [r, r + L) of the two shards that the
//       round's ppermutes delivered, or the marker -(global i + 1) where
//       i + h lies past the padded text.
//   dense_ranks_kernel has no counterpart in the JAX package: the dense
//       rank of a sorted slot, dense[j] = (heads at or before j) - 1, where
//       slot j is a head when rank_s[j] == j. A full round sorts by these
//       in place of head slots when its keys then take fewer radix passes
//       (engines/doubling.py); the two orders are the same.
//   invert_ranks_kernel, or invert_partition_kernel twice and
//       invert_place_kernel, replace the 1-key sort of (sa_s, rank_s) in
//       `_scatter_to_text_order` (stringsearch_tpu/engines/doubling.py:
//       105): out[sa_s[j]] = rank_s[j]. sa_s is a permutation, so one
//       scatter gives what the sort gave.
//
// Bound: device-memory bytes, for all of them. Each reads its inputs and
// writes its outputs once and does a few integer operations an element:
//   pack_keys     n text bytes in, (4 * depth/4 + 4 or 8 [+ 4 or 8]) n out;
//   shift_planes  one rank plane in (its shifts meet in L2), one plane out
//                 a shift, and the positions;
//   shard_shift_planes  one window of L elements in a shift (but for the
//                 markers), one plane out a shift, and the positions;
//   head_ranks    every key plane in, one rank plane out;
//   dense_ranks   the rank plane in, one dense plane out: 8 n bytes in
//                 int32;
//   invert_ranks  sa_s and rank_s in, one rank plane out: 12 n bytes in
//                 int32.
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
//     which the host reads only when the engine asks (no added sync). The
//     group count, where asked for, is the flags' count, added at bit 32
//     of a second word beside the tied count, so that one read of one
//     scalar gives both (n < 2^32).
//   * dense_ranks is a sum across tiles, so every tile looks back (as
//     sort_pass_kernel does): it publishes its count of heads at once,
//     then its inclusive count once its warp 0 has summed its
//     predecessors' counts back to the nearest inclusive one, 32 a step.
//     A tile of 4096 slots, 16 a thread: 1.21 ms at 2^28 on an H100
//     against 0.64 ms of bytes, where 2048 took 1.31 ms; a look-back of
//     64 to 256 words a step, 8192 slots and a back-off in the wait were
//     no faster. What holds it back is the look-back in every tile, as in
//     head_ranks over a single group (1.44 ms for the same bytes).
//   * The invert's stores land at random slots. One store an element
//     straight from registers costs a 32-byte sector a 4-byte element,
//     assembled in L2 from stores of many blocks: where the output fits
//     L2 (kDirectBytes) that is the fastest, but past it every store
//     fetches and writes back a sector of device memory, 20.3 ms at 2^28
//     against the 0.96 ms of its bytes (a random permutation, H100).
//     Held in L2, partial stores still go at about 45 G a second (a
//     scatter inside 8 MB windows: 6.0 ms at 2^28). So a larger output
//     is written in three coalesced passes of 44 n bytes, 4.35 ms at
//     2^28: a partition of the pairs by window of the output (8 MB; one
//     cursor a window and an atomic add a tile, no counting pass, since a
//     permutation fills each window exactly), a partition of each
//     window's pairs by place (64 KB of output), and a block a place that
//     stores its ranks into shared memory and writes the place out in
//     order, each sector once. Reads leave L2 first (ld.global.cs).
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

constexpr int kDenseThreads = 256;
constexpr int kDenseItems = 16;  // consecutive slots a thread
constexpr int kDenseTile = kDenseThreads * kDenseItems;
constexpr int kDenseWarps = kDenseThreads / 32;
// dense_ranks takes head_ranks' scratch: no more tiles than it
static_assert(kDenseTile >= kScanTile, "a look-back word a tile");

constexpr int kInvertThreads = 512;
constexpr int kInvertWarps = kInvertThreads / 32;
constexpr int kInvertTileBytes = 64 * 1024;  // a partition tile's pairs
// buckets of one partition: the scan over them takes two a thread
constexpr int kMaxBuckets = 2 * kInvertThreads;
// output bytes of a window, the first partition's bucket, and of a place,
// the second's, which a block of the last step holds in shared memory
constexpr int64_t kWindowBytes = int64_t(8) << 20;
constexpr int kPlaceBytes = 64 * 1024;
// the largest output invert_ranks writes one store an element: L2 holds
// it, so its sectors are assembled there; a larger one is partitioned
constexpr int64_t kDirectBytes = int64_t(32) << 20;

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
// On one shard of the global build (`shard_pack_keys`) the bytes past n
// are the halo's (halo_len bytes, the next shard's first; none past them,
// nor where halo is null), no chunk ends before n + halo_len, and the
// positions count from pos_offset.
template <typename Idx>
__global__ void __launch_bounds__(kPackThreads)
    pack_keys_kernel(const uint8_t* __restrict__ text, int64_t n,
                     int64_t chunk, int keys, int64_t stride,
                     int* __restrict__ key_out, Idx* __restrict__ chunk_out,
                     Idx* __restrict__ pos_out,
                     const uint8_t* __restrict__ halo, int64_t halo_len,
                     int64_t pos_offset) {
  // text [t0, t0 + 4 * words), then the halo, then 0
  extern __shared__ uint32_t line[];
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
        const int64_t at = g + b;
        const uint32_t byte = at < n                ? text[at]
                              : at - n < halo_len ? halo[at - n]
                                                  : 0u;
        v |= byte << (8 * b);
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
    pos[m] = static_cast<Idx>(pos_offset + i0 + m);
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
  unsigned lift;              // bit s set: plane s is lifted
};

// out.plane[s][i] = rank[i + shift] where the local position l of i in its
// chunk has l + shift < chunk, else -(l + 1); on a lifted plane rank[i +
// shift] + shift, else chunk - 1 - l. pos[i] = i unless pos is null.
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
    const bool lift = out.lift >> s & 1;
    T* __restrict__ dst = out.plane[s];
#pragma unroll
    for (int m = 0; m < kShiftItems; ++m) {
      const int64_t i = t0 + threadIdx.x + m * kShiftThreads;
      if (i < n) {
        if (local[m] + h < chunk) {
          dst[i] = lift ? static_cast<T>(rank[i + h] + h) : rank[i + h];
        } else {
          dst[i] = static_cast<T>(lift ? chunk - 1 - local[m]
                                       : -(local[m] + 1));
        }
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
// shard_shift_planes
// ---------------------------------------------------------------------------

// The shifted planes of one shard of the global build. Shift s reads the
// window [r, r + n) of two consecutive shards: head holds its positions
// [r, n), tail its positions [n, n + r) (either null where it lies past
// the last shard, read as -1).
template <typename T>
struct ShardShiftOut {
  T* plane[kMaxShifts];
  const T* head[kMaxShifts];
  const T* tail[kMaxShifts];
  int64_t r[kMaxShifts];      // in [0, n)
  int64_t limit[kMaxShifts];  // local positions below it take the window
};

// out.plane[s][i] = window s at i for i < limit[s], else the marker
// -(offset + i + 1); pos[i] = offset + i unless pos is null.
template <typename T>
__global__ void __launch_bounds__(kShiftThreads)
    shard_shift_planes_kernel(int64_t n, int64_t offset, int count,
                              ShardShiftOut<T> out, T* __restrict__ pos) {
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kShiftTile;
  // unrolled, so that `out` is read with constant indices (see
  // shift_planes_kernel)
#pragma unroll
  for (int s = 0; s < kMaxShifts; ++s) {
    if (s >= count) break;
    const T* __restrict__ head = out.head[s];
    const T* __restrict__ tail = out.tail[s];
    const int64_t r = out.r[s];
    const int64_t limit = out.limit[s];
    T* __restrict__ dst = out.plane[s];
#pragma unroll
    for (int m = 0; m < kShiftItems; ++m) {
      const int64_t i = t0 + threadIdx.x + m * kShiftThreads;
      if (i < n) {
        T v = static_cast<T>(-(offset + i + 1));
        if (i < limit) {
          const int64_t j = i + r;
          const T* from = j < n ? head : tail;
          v = from == nullptr ? T(-1) : from[j < n ? j : j - n];
        }
        dst[i] = v;
      }
    }
  }
  if (pos != nullptr) {
#pragma unroll
    for (int m = 0; m < kShiftItems; ++m) {
      const int64_t i = t0 + threadIdx.x + m * kShiftThreads;
      if (i < n) pos[i] = static_cast<T>(offset + i);
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
// -1 where there is none. packed: null, or the tied count plus the count
// of group starts times 2^32.
template <typename Idx>
__global__ void __launch_bounds__(kScanThreads)
    head_ranks_kernel(KeyPlanes planes, int keys, int64_t n,
                      const int64_t* __restrict__ prev, int64_t offset,
                      Idx* __restrict__ rank_out,
                      unsigned long long* __restrict__ count,
                      unsigned long long* __restrict__ packed,
                      uint64_t* __restrict__ words,
                      unsigned* __restrict__ tile_counter) {
  __shared__ int64_t warp_last[kScanWarps];
  __shared__ unsigned warp_tied[kScanWarps];
  __shared__ unsigned warp_heads[kScanWarps];
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
  unsigned tied = 0, heads = 0;
#pragma unroll
  for (int m = 0; m < kScanItems; ++m) {
    if (j0 + m < n) {
      if (flag[m]) last = j0 + m;
      heads += flag[m];
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
  if (packed != nullptr) heads = __reduce_add_sync(kFull, heads);
  if (lane == 31) warp_last[warp] = incl;
  if (lane == 0) warp_tied[warp] = tied;
  if (lane == 0) warp_heads[warp] = heads;
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
    unsigned total = 0, starts = 0;
#pragma unroll
    for (int w = 0; w < kScanWarps; ++w) {
      total += warp_tied[w];
      starts += warp_heads[w];
    }
    if (total) atomicAdd(count, static_cast<unsigned long long>(total));
    if (packed != nullptr && (total || starts)) {
      atomicAdd(packed, static_cast<unsigned long long>(total) +
                            (static_cast<unsigned long long>(starts) << 32));
    }
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

// ---------------------------------------------------------------------------
// dense_ranks
// ---------------------------------------------------------------------------

// Look-back words of dense_ranks: status << 62 | a count of heads. 0: not
// published; kAggregate: the tile's own count; kInclusive (as above): the
// count up to and including the tile.
constexpr uint64_t kAggregate = 1ull << 62;

// dense[j] = (slots j' <= j with rank_s[j'] == j') - 1, one tile of
// kDenseTile slots a block, claimed in order from tile_counter. dense may
// be rank_s: a thread reads its slots before the block's first barrier
// and writes the same slots after its last (so neither is __restrict__).
template <typename Idx>
__global__ void __launch_bounds__(kDenseThreads)
    dense_ranks_kernel(const Idx* rank_s, int64_t n, Idx* dense,
                       uint64_t* __restrict__ words,
                       unsigned* __restrict__ tile_counter) {
  __shared__ unsigned warp_sum[kDenseWarps];
  __shared__ uint64_t prefix;
  __shared__ int tile_slot;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) tile_slot = static_cast<int>(atomicAdd(tile_counter, 1u));
  __syncthreads();
  const int64_t tile = tile_slot;
  const int64_t j0 =
      tile * kDenseTile + static_cast<int64_t>(tid) * kDenseItems;

  bool head[kDenseItems];
  unsigned mine = 0;
  if (j0 < n) {
    Idx r[kDenseItems];
    if (j0 + kDenseItems <= n && aligned16(rank_s + j0)) {
      load_vec(rank_s + j0, r);
    } else {
#pragma unroll
      for (int m = 0; m < kDenseItems; ++m) {
        r[m] = j0 + m < n ? rank_s[j0 + m] : Idx(-1);
      }
    }
#pragma unroll
    for (int m = 0; m < kDenseItems; ++m) {
      head[m] = static_cast<int64_t>(r[m]) == j0 + m;
      mine += head[m];
    }
  } else {
#pragma unroll
    for (int m = 0; m < kDenseItems; ++m) head[m] = false;
  }

  // the block's exclusive sum: warps, then the warps before
  unsigned incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  uint64_t excl = incl - mine;
  uint64_t tile_total = 0;
#pragma unroll
  for (int w = 0; w < kDenseWarps; ++w) {
    if (w < warp) excl += warp_sum[w];
    tile_total += warp_sum[w];
  }
  if (tid == 0) {
    store_word(words + tile, (tile == 0 ? kInclusive : kAggregate) |
                                 tile_total);
  }

  if (tile > 0) {
    if (warp == 0) {
      // the predecessors' counts, nearest first, back to the first
      // inclusive one (before tile 0: an inclusive 0)
      uint64_t sum = 0;
      for (int64_t at = tile - 1;; at -= 32) {
        const int64_t t = at - lane;
        uint64_t w = t >= 0 ? load_word(words + t) : kInclusive;
        while (__any_sync(kFull, (w & ~kValueMask) == 0)) {
          if ((w & ~kValueMask) == 0) w = load_word(words + t);
        }
        const unsigned done =
            __ballot_sync(kFull, (w & ~kValueMask) == kInclusive);
        const int first = done ? __ffs(done) - 1 : 31;
        uint64_t part = lane <= first ? w & kValueMask : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
          part += __shfl_xor_sync(kFull, part, d);
        }
        sum += part;
        if (done) break;
      }
      if (lane == 0) {
        prefix = sum;
        store_word(words + tile, kInclusive | (sum + tile_total));
      }
    }
    __syncthreads();
    excl += prefix;
  }

  if (j0 < n) {
    Idx d[kDenseItems];
    int64_t run = static_cast<int64_t>(excl) - 1;
#pragma unroll
    for (int m = 0; m < kDenseItems; ++m) {
      run += head[m];
      d[m] = static_cast<Idx>(run);
    }
    store_run(dense + j0, d, n - j0);
  }
}

inline int blocks_of(int64_t n, int tile) {
  return static_cast<int>((n + tile - 1) / tile);
}

template <typename T>
int launch_shard_shift(int64_t n, int64_t offset, int count, void** outs,
                       const void* const* heads, const void* const* tails,
                       const int64_t* rs, const int64_t* limits,
                       void* pos_out, cudaStream_t s) {
  ShardShiftOut<T> out{};
  for (int q = 0; q < count; ++q) {
    if (rs[q] < 0 || rs[q] >= n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    out.plane[q] = static_cast<T*>(outs[q]);
    out.head[q] = static_cast<const T*>(heads[q]);
    out.tail[q] = static_cast<const T*>(tails[q]);
    out.r[q] = rs[q];
    out.limit[q] = limits[q];
  }
  shard_shift_planes_kernel<T><<<blocks_of(n, kShiftTile), kShiftThreads, 0,
                                 s>>>(n, offset, count, out,
                                      static_cast<T*>(pos_out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// invert_ranks
// ---------------------------------------------------------------------------

template <typename Idx>
struct alignas(2 * sizeof(Idx)) Pair {
  Idx slot;
  Idx rank;
};

// Pairs a thread of a partition, kInvertThreads apart: a tile's pairs fill
// kInvertTileBytes of shared memory (16 a thread for int32, 8 for int64).
template <typename Idx>
__host__ __device__ constexpr int invert_items() {
  return kInvertTileBytes / kInvertThreads /
         static_cast<int>(sizeof(Pair<Idx>));
}

// Loads that leave L2 first (ld.global.cs): each input is read once.
__device__ __forceinline__ int load_first(const int* p) { return __ldcs(p); }

__device__ __forceinline__ int64_t load_first(const int64_t* p) {
  return static_cast<int64_t>(__ldcs(reinterpret_cast<const long long*>(p)));
}

__device__ __forceinline__ Pair<int> load_first(const Pair<int>* p) {
  const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
  return Pair<int>{v.x, v.y};
}

__device__ __forceinline__ Pair<int64_t> load_first(const Pair<int64_t>* p) {
  const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(p));
  return Pair<int64_t>{static_cast<int64_t>(v.x), static_cast<int64_t>(v.y)};
}

template <typename Idx>
__device__ __forceinline__ bool inside(Idx slot, int64_t n) {
  return static_cast<uint64_t>(slot) < static_cast<uint64_t>(n);
}

// A tile's pairs in registers, all loads issued before any use: from the
// planes (sa[j], rank_s[j]), or from `pairs` where it is not null; slot -1
// past n.
template <typename Idx, int kItems>
__device__ __forceinline__ void load_tile(const Idx* __restrict__ sa,
                                          const Idx* __restrict__ rank_s,
                                          const Pair<Idx>* __restrict__ pairs,
                                          int64_t n, Pair<Idx> (&p)[kItems]) {
  const int64_t j0 =
      static_cast<int64_t>(blockIdx.x) * kInvertThreads * kItems + threadIdx.x;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int64_t j = j0 + static_cast<int64_t>(m) * kInvertThreads;
    if (j >= n) {
      p[m] = Pair<Idx>{Idx(-1), Idx(0)};
    } else if (pairs != nullptr) {
      p[m] = load_first(pairs + j);
    } else {
      p[m] = Pair<Idx>{load_first(sa + j), load_first(rank_s + j)};
    }
  }
}

// One store an element: out[sa[j]] = rank_s[j] straight from registers.
template <typename Idx>
__global__ void __launch_bounds__(kInvertThreads)
    invert_ranks_kernel(const Idx* __restrict__ sa,
                        const Idx* __restrict__ rank_s, int64_t n,
                        Idx* __restrict__ out) {
  constexpr int kItems = invert_items<Idx>();
  Pair<Idx> p[kItems];
  load_tile(sa, rank_s, static_cast<const Pair<Idx>*>(nullptr), n, p);
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    if (inside(p[m].slot, n)) out[p[m].slot] = p[m].rank;
  }
}

// A partition of a tile's pairs by bucket: bucket g holds the slots [g <<
// shift, (g + 1) << shift), and a tile takes the `buckets` buckets from
// g0 = (its first index >> group_shift) << (group_shift - shift) on (g0 =
// 0 where group_shift < 0). A permutation puts exactly a bucket's size of
// pairs in each, so bucket g's pairs go to staged[g << shift, ...) with no
// counting pass: the tile counts its pairs a bucket in shared memory,
// claims a run of each bucket's places with one atomic add to the
// bucket's cursor, stages its pairs by bucket in shared memory and writes
// each run out in order. Neighbouring runs of one bucket are claimed by
// tiles in flight together, so their sectors meet in L2. A pair outside
// the tile's buckets, or past a bucket's size (sa no permutation), is
// dropped.
template <typename Idx>
__global__ void __launch_bounds__(kInvertThreads, 2)
    invert_partition_kernel(const Idx* __restrict__ sa,
                            const Idx* __restrict__ rank_s,
                            const Pair<Idx>* __restrict__ pairs, int64_t n,
                            int shift, int group_shift, int buckets,
                            unsigned* __restrict__ cursor,
                            Pair<Idx>* __restrict__ staged) {
  constexpr int kItems = invert_items<Idx>();
  extern __shared__ __align__(16) unsigned char smem[];
  Pair<Idx>* tile = reinterpret_cast<Pair<Idx>*>(smem);
  __shared__ unsigned count[kMaxBuckets];  // pairs a bucket, then a cursor
  __shared__ unsigned start[kMaxBuckets];  // a bucket's first place in tile
  __shared__ unsigned base[kMaxBuckets];   // its run's first in the bucket
  __shared__ unsigned warp_sum[kInvertWarps];
  __shared__ unsigned filled;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t g0 =
      group_shift < 0
          ? 0
          : (static_cast<int64_t>(blockIdx.x) * kInvertThreads * kItems >>
             group_shift) << (group_shift - shift);
  Pair<Idx> p[kItems];
  load_tile(sa, rank_s, pairs, n, p);
  unsigned b[kItems];  // the local bucket, or buckets where dropped
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const uint64_t g = static_cast<uint64_t>((p[m].slot >> shift) - g0);
    b[m] = inside(p[m].slot, n) && g < static_cast<uint64_t>(buckets)
               ? static_cast<unsigned>(g)
               : static_cast<unsigned>(buckets);
  }
  for (int g = tid; g < buckets; g += kInvertThreads) count[g] = 0;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    if (b[m] < static_cast<unsigned>(buckets)) atomicAdd(&count[b[m]], 1u);
  }
  __syncthreads();

  // buckets 2 tid and 2 tid + 1: their first places in the tile (a scan),
  // and their runs' places in the buckets (an atomic add each)
  const int w0 = 2 * tid;
  const unsigned c0 = w0 < buckets ? count[w0] : 0u;
  const unsigned c1 = w0 + 1 < buckets ? count[w0 + 1] : 0u;
  unsigned incl = c0 + c1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  unsigned excl = incl - c0 - c1;
#pragma unroll
  for (int w = 0; w < kInvertWarps; ++w) {
    if (w < warp) excl += warp_sum[w];
  }
  if (c0) {
    start[w0] = count[w0] = excl;
    base[w0] = atomicAdd(cursor + g0 + w0, c0);
  }
  if (c1) {
    start[w0 + 1] = count[w0 + 1] = excl + c0;
    base[w0 + 1] = atomicAdd(cursor + g0 + w0 + 1, c1);
  }
  if (tid == kInvertThreads - 1) filled = excl + c0 + c1;
  __syncthreads();

#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    if (b[m] < static_cast<unsigned>(buckets)) {
      tile[atomicAdd(&count[b[m]], 1u)] = p[m];
    }
  }
  __syncthreads();
  // consecutive threads on consecutive places of one bucket's run
  const unsigned total = filled;
  for (unsigned i = tid; i < total; i += kInvertThreads) {
    const Pair<Idx> q = tile[i];
    const int g = static_cast<int>((q.slot >> shift) - g0);
    const int64_t first = (g0 + g) << shift;
    const int64_t size =
        n - first < (int64_t(1) << shift) ? n - first : int64_t(1) << shift;
    const int64_t at = static_cast<int64_t>(base[g]) + (i - start[g]);
    if (at < size) staged[first + at] = q;
  }
}

// The last step: block g owns the slots [g << shift, (g + 1) << shift),
// whose pairs lie in the same places of `staged`. It stores each rank
// into shared memory at its slot, then writes the slots out in order, so
// every sector of the output is written once, whole.
template <typename Idx>
__global__ void __launch_bounds__(kInvertThreads)
    invert_place_kernel(const Pair<Idx>* __restrict__ staged, int64_t n,
                        int shift, Idx* __restrict__ out) {
  constexpr int kItems = invert_items<Idx>();
  extern __shared__ __align__(16) unsigned char smem[];
  Idx* slots = reinterpret_cast<Idx*>(smem);
  const int64_t lo = static_cast<int64_t>(blockIdx.x) << shift;
  const int size = static_cast<int>(
      n - lo < (int64_t(1) << shift) ? n - lo : int64_t(1) << shift);
  for (int i0 = 0; i0 < size; i0 += kInvertThreads * kItems) {
    Pair<Idx> p[kItems];
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int i = i0 + m * kInvertThreads + threadIdx.x;
      p[m] = i < size ? load_first(staged + lo + i)
                      : Pair<Idx>{Idx(-1), Idx(0)};
    }
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const uint64_t at = static_cast<uint64_t>(p[m].slot - lo);
      if (at < static_cast<uint64_t>(size)) slots[at] = p[m].rank;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < size; i += kInvertThreads) {
    out[lo + i] = slots[i];
  }
}

bool partitioned(int64_t n, int idx_bytes) {
  return n * idx_bytes > kDirectBytes;
}

// log2 of the slots of a window (the first partition's bucket):
// kWindowBytes of output of idx_bytes a slot, or more where kMaxBuckets
// windows would not cover n.
int window_shift(int64_t n, int idx_bytes) {
  int shift = 0;
  while ((int64_t(idx_bytes) << shift) < kWindowBytes) ++shift;
  while (((n - 1) >> shift) + 1 > kMaxBuckets) ++shift;
  return shift;
}

// log2 of the slots of a block of the last step: kPlaceBytes of output.
int place_shift(int idx_bytes) {
  int shift = 0;
  while ((int64_t(idx_bytes) << shift) < kPlaceBytes) ++shift;
  return shift;
}

// Dynamic shared memory past 48 KB needs the kernel's attribute first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename Idx>
int launch_invert(const void* sa_v, const void* rank_v, int64_t n,
                  void* out_v, void* scratch, cudaStream_t s) {
  const auto* sa = static_cast<const Idx*>(sa_v);
  const auto* rank_s = static_cast<const Idx*>(rank_v);
  auto* out = static_cast<Idx*>(out_v);
  const int blocks = blocks_of(n, kInvertThreads * invert_items<Idx>());
  if (!partitioned(n, sizeof(Idx))) {
    invert_ranks_kernel<Idx><<<blocks, kInvertThreads, 0, s>>>(sa, rank_s, n,
                                                               out);
    return static_cast<int>(cudaGetLastError());
  }
  const int wshift = window_shift(n, sizeof(Idx));
  const int pshift = place_shift(sizeof(Idx));
  const int windows = static_cast<int>(((n - 1) >> wshift) + 1);
  const int64_t places = ((n - 1) >> pshift) + 1;
  if (wshift - pshift > 10 || places > (int64_t(1) << 31) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* staged = static_cast<Pair<Idx>*>(scratch);
  auto* cursor = reinterpret_cast<unsigned*>(staged + 2 * n);
  cudaError_t err = cudaMemsetAsync(
      cursor, 0, sizeof(unsigned) * (windows + places), s);
  if (err == cudaSuccess) {
    err = allow_smem(invert_partition_kernel<Idx>, kInvertTileBytes);
  }
  if (err == cudaSuccess) {
    err = allow_smem(invert_place_kernel<Idx>, kPlaceBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // by window, then by place inside each window (a tile lies in one
  // window), then each place's slots in shared memory
  invert_partition_kernel<Idx><<<blocks, kInvertThreads, kInvertTileBytes,
                                 s>>>(sa, rank_s, nullptr, n, wshift, -1,
                                      windows, cursor, staged);
  invert_partition_kernel<Idx><<<blocks, kInvertThreads, kInvertTileBytes,
                                 s>>>(nullptr, nullptr, staged, n, pshift,
                                      wshift, 1 << (wshift - pshift),
                                      cursor + windows, staged + n);
  invert_place_kernel<Idx><<<static_cast<int>(places), kInvertThreads,
                             kPlaceBytes, s>>>(staged + n, n, pshift, out);
  return static_cast<int>(cudaGetLastError());
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
        static_cast<int*>(pos_out), nullptr, 0, 0);
  } else {
    pack_keys_kernel<int64_t><<<blocks, kPackThreads, smem, s>>>(
        t, n, chunk, keys, stride, k, static_cast<int64_t*>(chunk_out),
        static_cast<int64_t*>(pos_out), nullptr, 0, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Shifted copies of a rank plane of n elements of elem_bytes (4 or 8):
// outs[s][i] = rank[i + shifts[s]] inside i's chunk, else -(local i + 1);
// where bit s of lift is set, rank[i + shifts[s]] + shifts[s], else chunk
// - 1 - local i (the caller keeps those sums inside the type); shifts[s]
// in [0, chunk]; 1 <= count <= kMaxShifts output planes, and the position
// at pos_out unless it is null. outs and shifts are host arrays.
int ss_shift_planes(const void* rank, int64_t n, int64_t chunk,
                    int elem_bytes, int count, void** outs,
                    const int64_t* shifts, unsigned lift, void* pos_out,
                    void* stream) {
  if (n < 1 || chunk < 1 || n % chunk != 0 || count < 0 ||
      count > kMaxShifts || (elem_bytes != 4 && elem_bytes != 8) ||
      (lift >> count) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_of(n, kShiftTile);
  if (elem_bytes == 4) {
    ShiftOut<int> out{};
    out.lift = lift;
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
    out.lift = lift;
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

// The operands of the initial sort of one shard of the global build: as
// ss_pack_keys without chunks, the bytes past the shard's n from the halo
// (halo_len bytes, the next shard's first; zero past them, or where halo
// is null) and the positions from pos_offset.
int ss_shard_pack_keys(const void* text, int64_t n, const void* halo,
                       int64_t halo_len, int keys, int64_t stride,
                       void* key_out, void* pos_out, int64_t pos_offset,
                       int idx_bytes, void* stream) {
  if (n < 1 || halo_len < 0 || (halo == nullptr && halo_len != 0) ||
      keys < 1 || keys > kMaxPackKeys || stride < n || stride % 4 != 0 ||
      (idx_bytes != 4 && idx_bytes != 8) ||
      (reinterpret_cast<uintptr_t>(key_out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = 4 * (kPackThreads + keys + 1);
  const int blocks = blocks_of(n, kPackTile);
  const auto* t = static_cast<const uint8_t*>(text);
  const auto* h = static_cast<const uint8_t*>(halo);
  auto* k = static_cast<int*>(key_out);
  // one chunk, which ends past the halo: no key is cut before it
  const int64_t chunk = n + halo_len;
  if (idx_bytes == 4) {
    pack_keys_kernel<int><<<blocks, kPackThreads, smem, s>>>(
        t, n, chunk, keys, stride, k, nullptr, static_cast<int*>(pos_out), h,
        halo_len, pos_offset);
  } else {
    pack_keys_kernel<int64_t><<<blocks, kPackThreads, smem, s>>>(
        t, n, chunk, keys, stride, k, nullptr,
        static_cast<int64_t*>(pos_out), h, halo_len, pos_offset);
  }
  return static_cast<int>(cudaGetLastError());
}

// The shifted rank planes of one shard of n elements of elem_bytes (4 or
// 8), 0 <= count <= kMaxShifts: outs[s][i] = the window of shift s at i
// where i < limits[s] (heads[s][i + rs[s]] below n, else tails[s][i +
// rs[s] - n]; a null source reads -1), else -(offset + i + 1); the global
// position offset + i at pos_out unless it is null. outs, heads, tails,
// rs and limits are host arrays.
int ss_shard_shift_planes(int64_t n, int64_t offset, int elem_bytes,
                          int count, void** outs, const void* const* heads,
                          const void* const* tails, const int64_t* rs,
                          const int64_t* limits, void* pos_out,
                          void* stream) {
  if (n < 1 || offset < 0 || count < 0 || count > kMaxShifts ||
      (elem_bytes != 4 && elem_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    return launch_shard_shift<int>(n, offset, count, outs, heads, tails, rs,
                                   limits, pos_out, s);
  }
  return launch_shard_shift<int64_t>(n, offset, count, outs, heads, tails,
                                     rs, limits, pos_out, s);
}

// Bytes of scratch `ss_head_ranks` and `ss_dense_ranks` need for n slots:
// a look-back word a tile and the tile counter.
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
// Where packed is 1, count is two device int64 and count[1] = count[0] +
// 2^32 times the slots that count; that needs n < 2^32. scratch:
// ss_head_ranks_scratch_bytes(n), 8-byte aligned.
int ss_head_ranks(const void* const* planes, const int* plane_bytes, int keys,
                  int64_t n, const void* prev, int64_t offset, void* rank_out,
                  int idx_bytes, void* count, int packed, void* scratch,
                  void* stream) {
  if (n < 1 || keys < 0 || keys > kMaxKeys || packed < 0 || packed > 1 ||
      (packed && n >= (int64_t(1) << 32)) ||
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
  if (err == cudaSuccess) err = cudaMemsetAsync(count, 0, 8 + 8 * packed, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* c = static_cast<unsigned long long*>(count);
  auto* g = packed ? c + 1 : nullptr;
  if (idx_bytes == 4) {
    head_ranks_kernel<int><<<tiles, kScanThreads, 0, s>>>(
        kp, keys, n, static_cast<const int64_t*>(prev), offset,
        static_cast<int*>(rank_out), c, g, words, counter);
  } else {
    head_ranks_kernel<int64_t><<<tiles, kScanThreads, 0, s>>>(
        kp, keys, n, static_cast<const int64_t*>(prev), offset,
        static_cast<int64_t*>(rank_out), c, g, words, counter);
  }
  return static_cast<int>(cudaGetLastError());
}

// Dense ranks of n sorted slots of idx_bytes (4 or 8): dense[j] = (the
// slots j' <= j with rank_s[j'] == j') - 1; dense may be rank_s. scratch:
// ss_head_ranks_scratch_bytes(n), 8-byte aligned.
int ss_dense_ranks(const void* rank_s, int64_t n, int idx_bytes, void* dense,
                   void* scratch, void* stream) {
  if (n < 1 || (idx_bytes != 4 && idx_bytes != 8) ||
      (reinterpret_cast<uintptr_t>(scratch) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = blocks_of(n, kDenseTile);
  auto* words = static_cast<uint64_t*>(scratch);
  auto* counter = reinterpret_cast<unsigned*>(words + tiles);
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, (static_cast<int64_t>(tiles) + 1) * 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (idx_bytes == 4) {
    dense_ranks_kernel<int><<<tiles, kDenseThreads, 0, s>>>(
        static_cast<const int*>(rank_s), n, static_cast<int*>(dense), words,
        counter);
  } else {
    dense_ranks_kernel<int64_t><<<tiles, kDenseThreads, 0, s>>>(
        static_cast<const int64_t*>(rank_s), n, static_cast<int64_t*>(dense),
        words, counter);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch `ss_invert_ranks` needs for n slots of idx_bytes: none
// for one store an element; partitioned, two pairs a slot (the two
// partitions' outputs) and a cursor a window and a place.
int64_t ss_invert_ranks_scratch_bytes(int64_t n, int idx_bytes) {
  if (n < 1 || !partitioned(n, idx_bytes)) return 0;
  const int64_t windows = ((n - 1) >> window_shift(n, idx_bytes)) + 1;
  const int64_t places = ((n - 1) >> place_shift(idx_bytes)) + 1;
  return n * 4 * idx_bytes + (windows + places) * 4;
}

// The inverse permutation's ranks: out[sa[j]] = rank_s[j] for j < n, where
// sa (a permutation of [0, n)), rank_s and out hold idx_bytes (4 or 8) a
// slot; slots of out from n on are not written. scratch:
// ss_invert_ranks_scratch_bytes(n, idx_bytes), 16-byte aligned (null
// where that is 0).
int ss_invert_ranks(const void* sa, const void* rank_s, int64_t n,
                    int idx_bytes, void* out, void* scratch, void* stream) {
  if (n < 1 || (idx_bytes != 4 && idx_bytes != 8) ||
      (partitioned(n, idx_bytes) &&
       (scratch == nullptr ||
        (reinterpret_cast<uintptr_t>(scratch) & 15) != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4) {
    return launch_invert<int>(sa, rank_s, n, out, scratch, s);
  }
  return launch_invert<int64_t>(sa, rank_s, n, out, scratch, s);
}

const char* ss_steps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
