// Stable LSD radix sort of C int32 operand planes on Hopper (sm_90a).
//
// Replaces, behind `device_sort`, the Pallas TPU bitonic network of
// stringsearch_tpu/ops/bitonic.py: `_local_sort_kernel` (l.240) and the
// `_make_cross` kernel (l.263). It computes what that network computes, an
// ascending lexicographic sort of C = 1..6 int32 planes by the first
// `num_keys` of them, compared as signed int32, the other planes moved with
// their keys; and it is stable, which the network is not, so the result
// equals `jax.lax.sort(operands, num_keys=...)` element for element.
//
// Not carried over block by block. The TPU kernel is a compare-exchange
// network because Mosaic has no scatter, no atomics and no cheap prefix
// sum. Hopper has all three, so the same function is a least-significant-
// digit radix sort: 8-bit digits, from the last key plane to the first and
// from the lowest byte of a plane to the highest, 4 * num_keys passes where
// the network needs 78 passes over the planes at n = 2^28 (csrc/bitonic.cu).
// The digit of the highest byte is XORed with 0x80, which turns unsigned
// digit order into signed int32 order.
//
// One pass is three kernels over tiles of kTile keys:
//   1. `sort_hist_kernel`: one block per tile counts the tile's 256 digits
//      with shared-memory atomics and writes its column of a bin-major
//      [256, tiles] table;
//   2. `sort_scan_kernel`: one block per bin turns its row of the table into
//      exclusive offsets over the tiles and writes the bin's total. The 256
//      totals are scanned by every scatter block for itself (1 KB from L2),
//      which saves a launch per pass;
//   3. `sort_scatter_kernel`: one block per tile ranks its keys, stages the
//      tile in shared memory in bin order, one plane at a time, and writes
//      each bin's run to offset[bin][tile] + rank, neighbouring threads on
//      neighbouring addresses.
// The first pass reads the caller's planes, which are never written; the
// passes then alternate between two scratch sets, and the last pass (their
// number is even) writes set B.
//
// Stability. Atomics would give arbitrary ranks, so every rank comes from
// position. The scan runs bin-major, tiles in order. Inside a tile, warp w
// takes the keys [w * kWarpKeys, (w + 1) * kWarpKeys) as consecutive 32-key
// segments, in order. In a segment the lanes of one digit find each other
// (eight ballots, one per digit bit, cost the same for any digit
// distribution; `__match_any_sync` slows down with the number of distinct
// values) and a key's rank among them is the count of lower lanes. A
// [kWarps, 256] count table in shared memory carries each digit's count from
// segment to segment inside the warp, and is then scanned over the warps and
// over the bins. So shared memory holds 256 counters per warp, not per
// segment, and the tile is not bounded by them.
//
// Bound. No arithmetic to speak of: the sort is bound by device-memory
// bytes. The function must read and write every plane once (8 * C * n
// bytes); this design moves 4 * num_keys * (2 * C + 1) planes (a pass reads
// the key plane for its histogram, then reads and writes all C planes).
// What it does about it: every load and every store of a plane is coalesced
// (the loads by segment, the stores by bin run out of the staged tile); the
// tile is large, 16384 keys, so that a bin's run is 256 bytes even on
// uniformly random digits and the table is 0.4% of a pass; the stage holds
// one plane and a byte of digit per element, 80 KB whatever C is; and a
// thread keeps its 32 keys and their ranks in registers without spilling
// (one block of 512 threads on an SM, up to 128 registers a thread), which
// measured faster than more resident blocks of fewer registers. Decoupled
// look-back in place of kernels 1-2, wider digits, TMA loads and skipping a
// pass whose digit is constant are later work. Measured times, also of the
// tiles, blocks and register caps that lost, are in PERF.md.
//
// Interface: plain C, loaded with ctypes. `ss_radix_sort_i32` launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// the first nonzero cudaGetLastError() after a launch, or 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPlanes = 6;
constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;
// Tile and block of the histogram and scatter kernels. What other choices
// cost on an H100 is measured by
// `python -m stringsearch_torch.harness.sort_variants` (PERF.md).
constexpr int kTile = 16384;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = kTile / kThreads;  // keys a thread ranks and moves
constexpr int kWarpKeys = kPerThread * 32;    // consecutive keys of one warp
// Resident blocks the scatter kernel is compiled for: 512 threads per SM,
// so at most 128 registers a thread. A thread holds kPerThread keys and
// their ranks in registers and has kPerThread loads of a plane in flight;
// capped at fewer registers the compiler spills and the kernel slows down
// by more than the extra resident blocks give back (PERF.md).
constexpr int kScatterBlocks = 512 / kThreads;
constexpr int kStageBytes = kTile * 5;  // a staged plane and its digits
// the scatter kernel's static shared memory: warp_count, delta, warp_sum
constexpr int kScatterStaticBytes = (kWarps * kBins + kBins + kWarps) * 4;
constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;  // consecutive table entries per thread
static_assert(kThreads % 32 == 0 && kThreads >= kBins && kThreads <= 1024,
              "one thread per bin, whole warps");
static_assert(kTile % kThreads == 0, "every thread ranks kPerThread keys");

struct Planes {
  int* p[kMaxPlanes];
};

// The pass's digit of a key: byte `shift / 8` of its bits, XOR `flip`
// (0x80 for the highest byte, else 0).
__device__ __forceinline__ int digit_of(int key, int shift, int flip) {
  return static_cast<int>((static_cast<uint32_t>(key) >> shift) & 0xFFu) ^
         flip;
}

// Exclusive prefix sum of v over the T threads of the block, in thread
// order; `total` receives the block's sum. `warp_sum` is T / 32 ints of
// shared memory, free again on return.
template <int T>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sum,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;  // inclusive scan inside the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) {
    const int s = warp_sum[w];
    if (w < warp) before += s;
    total += s;
  }
  __syncthreads();
  return before + x - v;
}

// The lanes of the warp that are `live` and hold digit b. Every lane of the
// warp calls it.
__device__ __forceinline__ unsigned lanes_of_digit(int b, bool live) {
  unsigned peers = __ballot_sync(kFull, live);
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const bool set = (b >> bit) & 1;
    const unsigned vote = __ballot_sync(kFull, set);
    peers &= set ? vote : ~vote;
  }
  return peers;
}

// Step 1. table[bin * tiles + tile] = keys of the tile with that digit. A
// warp whose 32 keys share one digit (the high bytes of small ranks) adds
// them with one atomic instead of 32 that collide.
__global__ void __launch_bounds__(kThreads)
    sort_hist_kernel(const int* __restrict__ key, int64_t n, int shift,
                     int flip, int tiles, int* __restrict__ table) {
  __shared__ int count[kBins];
  if (threadIdx.x < kBins) count[threadIdx.x] = 0;
  __syncthreads();
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int valid = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
  const int lane = threadIdx.x & 31;
  // t - lane is the same for the 32 lanes, so a warp leaves the loop whole
  for (int t = threadIdx.x; t - lane < valid; t += kThreads) {
    const bool live = t < valid;
    const int b = live ? digit_of(key[t0 + t], shift, flip) : 0;
    const int b0 = __shfl_sync(kFull, b, 0);
    if (__all_sync(kFull, live && b == b0)) {
      if (lane == 0) atomicAdd(&count[b0], 32);
    } else if (live) {
      atomicAdd(&count[b], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x < kBins) {
    table[static_cast<int64_t>(threadIdx.x) * tiles + blockIdx.x] =
        count[threadIdx.x];
  }
}

// Step 2. Block b: row b of the table (the bin's count in every tile)
// becomes its exclusive prefix sum over the tiles, in place, and totals[b]
// the bin's count in the whole array. A thread scans kScanItems consecutive
// entries, the block scans the threads' sums, and a running carry joins the
// chunks of the row.
__global__ void __launch_bounds__(kScanThreads)
    sort_scan_kernel(int* table, int* __restrict__ totals, int tiles) {
  __shared__ int warp_sum[kScanThreads / 32];
  int* row = table + static_cast<int64_t>(blockIdx.x) * tiles;
  int carry = 0;
  for (int base = 0; base < tiles; base += kScanThreads * kScanItems) {
    const int first = base + threadIdx.x * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      v[i] = first + i < tiles ? row[first + i] : 0;
      sum += v[i];
    }
    int chunk_total;
    int run = carry + block_exclusive_scan<kScanThreads>(sum, warp_sum,
                                                         chunk_total);
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      if (first + i < tiles) row[first + i] = run;
      run += v[i];
    }
    carry += chunk_total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// The part of plane `src` that this thread moves: its key of every segment
// of its warp. `src` points at the tile; keys past `valid` read as 0.
__device__ __forceinline__ void load_part(const int* __restrict__ src,
                                          int first, int valid,
                                          int (&v)[kPerThread]) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int t = first + j * 32;
    v[j] = t < valid ? src[t] : 0;
  }
}

// Step 3. One block per tile. `table` holds step 2's offsets, `totals` the
// bin totals. Plane 0 of `in` and `out` is the pass's key plane, the others
// follow in any order (the same in both).
template <int C>
__global__ void __launch_bounds__(kThreads, kScatterBlocks)
    sort_scatter_kernel(Planes in, Planes out, int64_t n, int shift, int flip,
                        int tiles, const int* __restrict__ table,
                        const int* __restrict__ totals) {
  // [kTile] ints, one plane of the tile, then [kTile] bytes of digits
  extern __shared__ int stage[];
  unsigned char* staged_digit =
      reinterpret_cast<unsigned char*>(stage + kTile);
  // first each warp's count of a digit so far, then the tile-local slot of
  // the warp's first key of that digit
  __shared__ int warp_count[kWarps][kBins];
  // global slot of a staged element at i of digit b: delta[b] + i
  __shared__ int delta[kBins];
  __shared__ int warp_sum[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int valid = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
  const int first = warp * kWarpKeys + lane;  // this thread's key of segment 0

  for (int i = tid; i < kWarps * kBins; i += kThreads) {
    (&warp_count[0][0])[i] = 0;
  }
  int key[kPerThread];
  load_part(in.p[0] + t0, first, valid, key);
  __syncthreads();

  // rank[j]: keys of the same digit before key j in this warp's part of
  // the tile. Segments in order; a segment wholly past the tile's end is
  // skipped by the whole warp.
  int rank[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    rank[j] = 0;
    if (first - lane + j * 32 < valid) {
      const bool live = first + j * 32 < valid;
      const int b = digit_of(key[j], shift, flip);
      const unsigned peers = lanes_of_digit(b, live);
      const int before = live ? warp_count[warp][b] : 0;
      __syncwarp();
      if (live && (peers & lower) == 0) {
        warp_count[warp][b] = before + __popc(peers);
      }
      __syncwarp();
      rank[j] = before + __popc(peers & lower);
    }
  }
  __syncthreads();

  // thread b: the digit's count over the warps, then over the bins
  int in_tile = 0;
  if (tid < kBins) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w][tid];
      warp_count[w][tid] = in_tile;
      in_tile += c;
    }
  }
  int unused;
  const int start =
      block_exclusive_scan<kThreads>(in_tile, warp_sum, unused);
  const int bin_base = block_exclusive_scan<kThreads>(
      tid < kBins ? totals[tid] : 0, warp_sum, unused);
  if (tid < kBins) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_count[w][tid] += start;
    delta[tid] = bin_base +
                 table[static_cast<int64_t>(tid) * tiles + blockIdx.x] - start;
  }
  __syncthreads();

  // rank[j] becomes key j's slot in the staged tile; the key plane goes
  // through the stage first
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (first + j * 32 < valid) {
      rank[j] += warp_count[warp][digit_of(key[j], shift, flip)];
      stage[rank[j]] = key[j];
    }
  }
  __syncthreads();
  // The staged element at i goes to global slot delta[its digit] + i. The
  // digit is kept, a byte per element, for the planes that follow:
  // kPerThread slots in registers instead made the compiler spill. Element
  // i is written out by the same thread in every plane.
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    if (i < valid) {
      const int v = stage[i];
      const int b = digit_of(v, shift, flip);
      staged_digit[i] = static_cast<unsigned char>(b);
      out.p[0][delta[b] + i] = v;
    }
  }
  // Loading plane q + 1 into registers while plane q is written out was
  // tried and lost 7-10%: the registers it takes are worth more (PERF.md).
#pragma unroll
  for (int q = 1; q < C; ++q) {
    int val[kPerThread];
    load_part(in.p[q] + t0, first, valid, val);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (first + j * 32 < valid) stage[rank[j]] = val[j];
    }
    __syncthreads();
    int* __restrict__ dst = out.p[q];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = tid + k * kThreads;
      if (i < valid) dst[delta[staged_digit[i]] + i] = stage[i];
    }
  }
}

// `planes` with plane kp moved to the front: the scatter kernel's order.
Planes key_first(const Planes& planes, int c, int kp) {
  Planes out{};
  out.p[0] = planes.p[kp];
  for (int q = 0, at = 1; q < c; ++q) {
    if (q != kp) out.p[at++] = planes.p[q];
  }
  return out;
}

inline int tiles_of(int64_t n) {
  return static_cast<int>((n + kTile - 1) / kTile);
}

template <int C>
int sort_planes(const Planes& in, const Planes& a, const Planes& b,
                int* scratch, int64_t n, int nk, cudaStream_t stream) {
  const int tiles = tiles_of(n);
  int* table = scratch;
  int* totals = scratch + static_cast<int64_t>(kBins) * tiles;
  cudaError_t err;
  if (kStageBytes + kScatterStaticBytes > 48 * 1024) {
    // The attribute belongs to the kernel on a device, not to a launch: it
    // is set again only when the current device is another than last time.
    static int stage_allowed_on = -1;
    int device;
    err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device != stage_allowed_on) {
      err = cudaFuncSetAttribute(sort_scatter_kernel<C>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kStageBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      stage_allowed_on = device;
    }
  }
  int pass = 0;
  for (int kp = nk - 1; kp >= 0; --kp) {
    for (int shift = 0; shift < 32; shift += 8, ++pass) {
      const Planes& from = pass == 0 ? in : (pass & 1 ? a : b);
      const Planes& to = pass & 1 ? b : a;
      const int flip = shift == 24 ? 0x80 : 0;
      sort_hist_kernel<<<tiles, kThreads, 0, stream>>>(from.p[kp], n, shift,
                                                       flip, tiles, table);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      sort_scan_kernel<<<kBins, kScanThreads, 0, stream>>>(table, totals,
                                                           tiles);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      sort_scatter_kernel<C><<<tiles, kThreads, kStageBytes, stream>>>(
          key_first(from, C, kp), key_first(to, C, kp), n, shift, flip, tiles,
          table, totals);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// int32 entries of scratch a sort of n elements needs: the [256, tiles]
// table and the 256 bin totals.
int64_t ss_radix_sort_scratch_ints(int64_t n) {
  return static_cast<int64_t>(kBins) * (tiles_of(n) + 1);
}

// Sorts c int32 planes of length n by their first num_keys, stably. Each of
// planes_in, planes_a, planes_b is c device pointers: the input (read only)
// and two scratch sets, none overlapping another. The result is in set b.
// scratch: ss_radix_sort_scratch_ints(n) ints. stream: a cudaStream_t
// (0 = legacy default). 2 <= n < 2^31.
int ss_radix_sort_i32(void** planes_in, void** planes_a, void** planes_b,
                      void* scratch, int c, int64_t n, int num_keys,
                      void* stream) {
  if (c < 1 || c > kMaxPlanes || num_keys < 1 || num_keys > c || n < 2 ||
      n >= (int64_t(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes in{}, a{}, b{};
  for (int q = 0; q < c; ++q) {
    in.p[q] = static_cast<int*>(planes_in[q]);
    a.p[q] = static_cast<int*>(planes_a[q]);
    b.p[q] = static_cast<int*>(planes_b[q]);
  }
  int* sc = static_cast<int*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return sort_planes<1>(in, a, b, sc, n, num_keys, s);
    case 2: return sort_planes<2>(in, a, b, sc, n, num_keys, s);
    case 3: return sort_planes<3>(in, a, b, sc, n, num_keys, s);
    case 4: return sort_planes<4>(in, a, b, sc, n, num_keys, s);
    case 5: return sort_planes<5>(in, a, b, sc, n, num_keys, s);
    default: return sort_planes<6>(in, a, b, sc, n, num_keys, s);
  }
}

const char* ss_radix_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
