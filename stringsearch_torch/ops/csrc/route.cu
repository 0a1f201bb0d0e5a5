// The global build's all_to_all routing and placement, on Hopper (sm_90a).
//
// The exact global build (`parallel/global_sa.py`) moves elements between
// shards with one all_to_all at a static per-pair capacity `cap`: a sender
// lays its elements out in a [P, cap] buffer per operand, row d bound for
// shard d, and a receiver puts what arrived in place. The JAX package
// (stringsearch_tpu/parallel/distsort.py:151-178, `redistribute_
// permutation`, and :240-255, `rank_interval_sort`) writes the send side
// as a `lax.sort` by destination, `arange - searchsorted` for the rank
// inside a destination and one scatter per operand, and the receive side
// as a scatter to `gidx % L`; XLA fuses them inside one jitted program.
// None of it is a Pallas kernel.
//
// route_partition: a stable counting partition by bucket. An element's
// bucket is (dest, window): dest = src / L (clamped to [0, P), or flagged
// where it falls outside), window = (src - dest L) / ceil(L / W) for W
// windows a destination (W = 1: the bucket is the destination). Row d of
// the send buffers holds destination d's elements by window, and in
// source order inside one. One call of `ss_route_partition` takes a range
// of at most kMaxBuckets consecutive buckets and a group of at most
// kMaxPlanes operands; the caller (ops/route.py:launch_plan) covers the P W
// buckets with consecutive ranges (one for P W <= kMaxBuckets) and each
// range's operands with groups, so no destination count and no operand
// count is a limit of the function. The first group's call of a range
// runs the count, scan and base; each call runs one partition, on one
// stream:
//   route_count_kernel  one block a tile of kTile elements: the tile's
//       count of each bucket of the range (a shared-memory add an
//       element), into a [tiles, buckets] table.
//   route_scan_kernel  one block a group of 8 buckets: the exclusive
//       prefix of each bucket's counts over the tiles, in place, its 128
//       warps' quarters a range of tiles each, and its total.
//   route_base_kernel  one block: each bucket's first slot in its row (the
//       row's elements in earlier ranges and earlier windows), each row's
//       count so far, and the overflow flag where a finished row holds
//       more than cap.
//   route_partition_kernel  each call, against its range's scan: one
//       block a tile; each element's rank
//       among the tile's earlier elements of its bucket (ballots on the
//       bucket's bits inside a warp, a 16-bit running count a warp and
//       bucket in shared memory, a scan over the warps), plus its bucket's
//       first slot and the counts of the earlier tiles, is its slot. Each
//       operand's values are copied to shared memory in tile order
//       (cp.async; the first while the tile is ranked) and written a run
//       a bucket. An element at or past cap is dropped (the flag is set).
//       In the last range's launches, blocks past the last tile write the
//       fill into the slots past each row's count.
//
// place_received: out[g % L] = recv[i] where g = recv_g[i] >= 0, zero
// elsewhere; a call takes a group of at most kMaxPlanes operands, and the
// caller makes one call a group. The rows of recv_g are what
// `route_partition` sent with W windows: each ordered by window of g % L,
// -1 past its count. By window, on clusters:
//   place_bounds_kernel  (the first call on a recv_g) a warp each row and
//       window: the row's first column of that window or a later one (a
//       32-way search; -1 sorts last), into a [rows, W + 1] table.
//   place_window_kernel  where a window fits the shared memory of a
//       thread block cluster (kCluster x kPlaceBytes): a cluster of
//       kCluster blocks owns as many whole windows of the output as fit.
//       Its blocks read the runs of its windows in every row together,
//       each element's value stored into the shared memory of the block
//       that owns its slot (distributed shared memory, `map_shared_rank`),
//       then each block writes its slots out once, in order, zero where
//       nothing landed.
//   place_scatter_kernel  where a window is wider than a cluster (rows in
//       no window order, W = 1, longer than a cluster; or too few windows
//       for L): the output zeroed, then one store an element at g % L, a
//       block taking the same columns of every row.
//
// Bound: device-memory bytes, for both functions. route_partition reads
// the destination source and every operand once and writes every slot of
// every send buffer once; its design reads the source twice (the count)
// and moves a count a tile and bucket. place_received with W > 1 reads the
// live entries of the received gidx and operands once (those before each
// row's fill: L of them, the receiver's share of a permutation) and
// writes each output once; with W = 1 a row may hold -1 anywhere, so it
// reads every entry. What the design does about it:
//   * One read of every input, in place of a sort's passes over all
//     planes, a `searchsorted`, an `arange` and one scatter an operand.
//   * Bucket arithmetic in 32 bits by multiply and shift (a divisor's
//     magic number, set on the host) for sources below 2^31: with a
//     division an element for the destination and another for the
//     window, the count read its source at 0.75-1.2 TB/s.
//   * Loads of 128 bytes a warp, issued ahead of their use: the first
//     operand's values while each bucket's place is set and the tile is
//     ranked (a draft that loaded each operand to
//     registers after the ranking and staged it by bucket took 4-14% more
//     time); the partition's stores go out of shared memory by bucket,
//     consecutive threads on consecutive slots of one bucket's run.
//   * A shared-memory add an element in the count: one a distinct bucket
//     of a warp's (by __match_any_sync) took longer on 4 to 1,024
//     buckets.
//   * No look-back: the counts of the earlier tiles come from a scan of
//     the count table.
//   * The windows serve the receiver. Rows in source order land their
//     elements at random places of the receiver's [L] output, one 32-byte
//     sector a 4-byte element; stored one at a time from registers, even
//     ordered by window, each sector was assembled in L2 from eight
//     stores made by different blocks. The window placement assembles a
//     cluster's slots in shared memory and writes each sector once, and
//     zeroes no output beforehand.
//   * The launch parameters are read with constant indices (unrolled
//     loops over the operands), so they stay in the parameter space.
//
// Interface: plain C, loaded with ctypes. Each function launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// the first nonzero CUDA error of its calls, or 0.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // elements a thread, 32 apart
constexpr int kTile = kThreads * kItems;
constexpr int kMaxBuckets = 1024;  // buckets of one call
constexpr int kMaxPlanes = 8;      // operands of one partition launch
// buckets a thread takes in the partition's steps over the buckets
constexpr int kPer = (kMaxBuckets + kThreads - 1) / kThreads;
// blocks an SM the partition's registers leave room for (two: 64
// registers a thread, with spills)
constexpr int kPartitionBlocks = 2;
constexpr int kFillTile = 8192;    // send-buffer slots a fill block
constexpr int kScanThreads = 1024;
constexpr int kScanWidth = 8;  // buckets a scan block
constexpr int kScanGroups = kScanThreads / kScanWidth;
constexpr int kScanBatch = 8;  // tiles a thread loads at once

constexpr int kPlaceThreads = 1024;
constexpr int kCluster = 8;
constexpr int kPlaceBytes = 128 * 1024;  // a block's slots of a window
constexpr int kPlaceUnroll = 4;
constexpr int kScatterThreads = 256;
constexpr int kScatterItems = 4;
constexpr int kScatterTile = kScatterThreads * kScatterItems;

static_assert(kTile <= 32768, "tile positions and counts in 16 bits");
static_assert(kMaxBuckets <= kScanThreads, "a thread a bucket (base)");
static_assert(kMaxBuckets + 2 < 65536, "bucket ids in 16 bits");

// floor(v / d) by a multiply and a shift where 0 <= v < 2^31 and
// 1 < d < 2^31 (m = ceil(2^(31 + l) / d), l = ceil(log2 d): exact there),
// by a 64-bit division elsewhere.
struct FastDiv {
  int64_t d;
  uint32_t m;  // 0: no multiplier (d = 1 or d >= 2^31)
  int s;
};

FastDiv make_div(int64_t d) {
  FastDiv f{d, 0u, 0};
  if (d > 1 && d < (int64_t(1) << 31)) {
    int l = 0;
    while ((int64_t(1) << l) < d) ++l;
    f.m = static_cast<uint32_t>(((uint64_t(1) << (31 + l)) + d - 1) / d);
    f.s = l - 1;
  }
  return f;
}

__device__ __forceinline__ int64_t div_floor(int64_t v, const FastDiv& f) {
  if (f.d == 1) return v;
  if (f.m != 0 && v >= 0 && v < (int64_t(1) << 31)) {
    return __umulhi(static_cast<uint32_t>(v), f.m) >> f.s;
  }
  const int64_t q = v / f.d;
  return q * f.d > v ? q - 1 : q;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

struct RouteArgs {
  const void* src;
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  int64_t fill[kMaxPlanes];
  uint32_t wide;  // bit c set: operand c is int64, else int32
  int src_wide;
  int planes;
  int dests;
  int windows;
  int clamp;
  int buckets;      // this call's: [bucket0, bucket0 + buckets)
  int64_t bucket0;
  int64_t n;
  int64_t cap;
  int64_t tiles;
  FastDiv len;  // length
  FastDiv sub;  // ceil(length / windows): the elements of a window
  FastDiv win;  // windows
  // sources in [0, narrow) take 32-bit arithmetic: both divisors have a
  // multiplier (or are 1), and narrow <= min(dests * length, 2^31)
  int64_t narrow;
};

__device__ __forceinline__ uint32_t div32(uint32_t v, const FastDiv& f) {
  return f.d == 1 ? v : __umulhi(v, f.m) >> f.s;
}

// The call's bucket of source value v (dest * windows + window, less
// bucket0): dest = v / length, clamped to [0, dests) where `clamp`; -2
// where dest falls outside [0, dests) without `clamp` (an element that
// cannot be routed); -1 where the bucket lies outside the call's range.
__device__ __forceinline__ int bucket_of(int64_t v, const RouteArgs& a) {
  if (v >= 0 && v < a.narrow) {
    // dest < dests and window < windows without a clamp
    const uint32_t x = static_cast<uint32_t>(v);
    const uint32_t d = div32(x, a.len);
    int b = static_cast<int>(d) * a.windows - static_cast<int>(a.bucket0);
    if (a.windows > 1) {
      b += static_cast<int>(div32(x - d * static_cast<uint32_t>(a.len.d),
                                  a.sub));
    }
    return static_cast<unsigned>(b) < static_cast<unsigned>(a.buckets) ? b
                                                                        : -1;
  }
  int64_t d = div_floor(v, a.len);
  if (a.clamp) {
    d = d < 0 ? 0 : d >= a.dests ? a.dests - 1 : d;
  } else if (d < 0 || d >= a.dests) {
    return -2;
  }
  int64_t b = d * a.windows - a.bucket0;
  if (a.windows > 1) {
    const int64_t w = div_floor(v - d * a.len.d, a.sub);
    b += w < 0 ? 0 : w >= a.windows ? a.windows - 1 : w;
  }
  return b >= 0 && b < a.buckets ? static_cast<int>(b) : -1;
}

// v[m] = src[base + stride m] (0 past n), every load issued before any
// use.
template <typename T, int N>
__device__ __forceinline__ void load_values(const void* src, int64_t n,
                                            int64_t base, int64_t stride,
                                            int64_t (&v)[N]) {
  const T* __restrict__ p = static_cast<const T*>(src);
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const int64_t e = base + stride * m;
    v[m] = e < n ? static_cast<int64_t>(p[e]) : 0;
  }
}

// The buckets of a thread's elements base + 32 m: -1 past n or outside
// the call's range, -2 where the element cannot be routed.
__device__ __forceinline__ void load_buckets(const RouteArgs& a,
                                             int64_t base,
                                             int (&key)[kItems]) {
  int64_t v[kItems];
  if (a.src_wide) {
    load_values<int64_t>(a.src, a.n, base, 32, v);
  } else {
    load_values<int>(a.src, a.n, base, 32, v);
  }
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    key[m] = base + 32 * m < a.n ? bucket_of(v[m], a) : -1;
  }
}

// The lanes of this warp whose key equals this lane's: ballots on the
// bits of key + 2, `bits` of them.
__device__ __forceinline__ unsigned same_key(int key, int bits) {
  const unsigned k = static_cast<unsigned>(key + 2);
  unsigned same = kFull;
  for (int b = 0; b < bits; ++b) {
    const unsigned bit = __ballot_sync(kFull, k >> b & 1);
    same &= (k >> b & 1) ? bit : ~bit;
  }
  return same;
}

__device__ __forceinline__ int key_bits(const RouteArgs& a) {
  return 32 - __clz(a.buckets + 1);
}

// counts[tile * buckets + b] = the tile's elements of bucket b; *over = 1
// where an element cannot be routed.
__global__ void __launch_bounds__(kThreads)
    route_count_kernel(RouteArgs a, int* __restrict__ counts,
                       int* __restrict__ over) {
  extern __shared__ int hist[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile = blockIdx.x;
  for (int b = tid; b < a.buckets; b += kThreads) hist[b] = 0;
  int key[kItems];
  load_buckets(a, tile * kTile + warp * (32 * kItems) + lane, key);
  __syncthreads();
  bool bad = false;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    bad |= key[m] == -2;
    if (key[m] >= 0) atomicAdd(&hist[key[m]], 1);
  }
  if (__syncthreads_or(bad) && tid == 0) atomicExch(over, 1);
  for (int b = tid; b < a.buckets; b += kThreads) {
    counts[tile * a.buckets + b] = hist[b];
  }
}

// counts[t * buckets + b] becomes the sum over the tiles before t, and
// totals[b] the sum over all: block x takes buckets [8 x, 8 x + 8), each
// of its kScanGroups groups of 8 threads a range of tiles.
__global__ void __launch_bounds__(kScanThreads)
    route_scan_kernel(int64_t tiles, int buckets, int* __restrict__ counts,
                      int* __restrict__ totals) {
  __shared__ int part[kScanGroups][kScanWidth + 1];
  const int lane = threadIdx.x % kScanWidth;
  const int g = threadIdx.x / kScanWidth;
  const int b = blockIdx.x * kScanWidth + lane;
  const int64_t per = (tiles + kScanGroups - 1) / kScanGroups;
  const int64_t t0 = g * per;
  const int64_t t1 = min64(t0 + per, tiles);
  int sum = 0;
  if (b < buckets) {
    for (int64_t t = t0; t < t1; t += kScanBatch) {
      int x[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        x[u] = t + u < t1 ? counts[(t + u) * buckets + b] : 0;
      }
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) sum += x[u];
    }
  }
  part[g][lane] = sum;
  __syncthreads();
  if (g == 0) {
    int run = 0;
    for (int k = 0; k < kScanGroups; ++k) {
      const int x = part[k][lane];
      part[k][lane] = run;
      run += x;
    }
    if (b < buckets) totals[b] = run;
  }
  __syncthreads();
  if (b < buckets) {
    int run = part[g][lane];
    // a batch of loads before its stores: in place, each load would
    // otherwise wait for the store before it
    for (int64_t t = t0; t < t1; t += kScanBatch) {
      int x[kScanBatch];
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        x[u] = t + u < t1 ? counts[(t + u) * buckets + b] : 0;
      }
#pragma unroll
      for (int u = 0; u < kScanBatch; ++u) {
        if (t + u < t1) counts[(t + u) * buckets + b] = run;
        run += x[u];
      }
    }
  }
}

// first[b] = the slot of bucket b's first element in its row; rows[d] =
// row d's elements so far (zeroed before the first call); *over = 1 where
// a row that ends in this call exceeds cap.
__global__ void __launch_bounds__(kScanThreads)
    route_base_kernel(RouteArgs a, const int* __restrict__ totals,
                      int* __restrict__ first, int* __restrict__ rows,
                      int* __restrict__ over) {
  __shared__ int ex[kMaxBuckets];
  __shared__ int warp_sum[kScanThreads / 32];
  const int b = threadIdx.x;
  const int lane = b & 31;
  const int warp = b >> 5;
  const bool live = b < a.buckets;
  const int x = live ? totals[b] : 0;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = incl - x;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  if (live) ex[b] = before;
  __syncthreads();
  const int64_t gb = a.bucket0 + b;
  const int64_t row = div_floor(gb, a.win);
  const int row0 = static_cast<int>(max64(row * a.windows - a.bucket0, 0));
  int count = 0;
  if (live) {
    count = rows[row] + before - ex[row0];
    first[b] = count;
    count += x;
  }
  __syncthreads();
  const bool ends = gb + 1 == (row + 1) * a.windows;
  if (live && (ends || b == a.buckets - 1)) {
    rows[row] = count;
    if (ends && count > a.cap) atomicExch(over, 1);
  }
}

// Fill block f: the slots [f, f + 1) * kFillTile of the [dests * cap]
// buffers that lie past their row's count get the operand's fill.
__device__ __forceinline__ void fill_rest(const RouteArgs& a, int64_t f,
                                          const int* __restrict__ rows) {
  const int64_t s0 = f * kFillTile;
  const int64_t s1 = min64(s0 + kFillTile, a.dests * a.cap);
  for (int64_t d = s0 / a.cap; d * a.cap < s1; ++d) {
    const int64_t lo = max64(s0, d * a.cap + min64(rows[d], a.cap));
    const int64_t hi = min64(s1, (d + 1) * a.cap);
    for (int64_t s = lo + threadIdx.x; s < hi; s += kThreads) {
#pragma unroll
      for (int c = 0; c < kMaxPlanes; ++c) {
        if (c >= a.planes) break;
        if (a.wide >> c & 1) {
          static_cast<int64_t*>(a.out[c])[s] = a.fill[c];
        } else {
          static_cast<int*>(a.out[c])[s] = static_cast<int>(a.fill[c]);
        }
      }
    }
  }
}

// The partition kernel's dynamic shared memory for `buckets` buckets:
// int64 start[buckets] (the send-buffer offset of the tile's first
// element, a bucket), int room[buckets] (the slots left in its row from
// there), int local[buckets] (the tile's elements before, a bucket),
// int warp_sum[kWarps], uint16 seen[kWarps][buckets] (a warp's elements of
// a bucket so far, then the tile's elements of it before the warp's),
// uint16 bucket[kTile] (of the tile's k-th element by bucket), uint16
// order[kTile] (its position in the tile), then the values of one operand
// in tile order, 16-byte aligned.
__host__ __device__ constexpr int64_t staging_offset(int buckets) {
  return (int64_t(buckets) * (8 + 4 + 4 + 2 * kWarps) + 4 * kWarps +
          4 * kTile + 15) / 16 * 16;
}

// Start copying operand c of the tile to shared memory in tile order.
template <typename T>
__device__ __forceinline__ void fetch_plane(const RouteArgs& a, int c,
                                            void* staging, int64_t tile) {
  const T* src = static_cast<const T*>(a.in[c]);
  T* value = static_cast<T*>(staging);
  const int64_t e0 = tile * kTile;
  const int count = static_cast<int>(min64(kTile, a.n - e0));
  for (int i = threadIdx.x; i < count; i += kThreads) {
    __pipeline_memcpy_async(value + i, src + e0 + i, sizeof(T));
  }
  __pipeline_commit();
}

// Write operand c of the tile, copied in tile order, a run a bucket.
template <typename T>
__device__ __forceinline__ void write_plane(
    const RouteArgs& a, int c, const int64_t* start, const int* room,
    const int* local, const uint16_t* bucket, const uint16_t* order,
    const void* staging, int staged) {
  T* __restrict__ dst = static_cast<T*>(a.out[c]);
  const T* value = static_cast<const T*>(staging);
  for (int j = threadIdx.x; j < staged; j += kThreads) {
    const int b = bucket[j];
    const int k = j - local[b];
    // past cap the row overflows: the flag is set
    if (k < room[b]) dst[start[b] + k] = value[order[j]];
  }
}

__global__ void __launch_bounds__(kThreads, kPartitionBlocks)
    route_partition_kernel(RouteArgs a, const int* __restrict__ prefix,
                           const int* __restrict__ first,
                           const int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nb = a.buckets;
  int64_t* start = reinterpret_cast<int64_t*>(smem);
  int* room = reinterpret_cast<int*>(start + nb);
  int* local = room + nb;
  int* warp_sum = local + nb;
  uint16_t* seen = reinterpret_cast<uint16_t*>(warp_sum + kWarps);
  uint16_t* bucket = seen + kWarps * nb;
  uint16_t* order = bucket + kTile;
  void* staging = smem + staging_offset(nb);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile = blockIdx.x;
  if (tile >= a.tiles) {
    fill_rest(a, tile - a.tiles, rows);
    return;
  }
  // the first operand's values are on their way while the tile is ranked
  if (a.wide & 1) {
    fetch_plane<int64_t>(a, 0, staging, tile);
  } else {
    fetch_plane<int>(a, 0, staging, tile);
  }
  // each thread a run of buckets: the place of each in the send buffers
  // for this tile, set while the operand's values arrive
  const int per = (nb + kThreads - 1) / kThreads;
  const int b0 = tid * per;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = b0 + j;
    if (j >= per || b >= nb) break;
    const int64_t slot =
        static_cast<int64_t>(first[b]) + prefix[tile * nb + b];
    room[b] = static_cast<int>(max64(min64(a.cap - slot, kTile), 0));
    start[b] = div_floor(a.bucket0 + b, a.win) * a.cap + slot;
  }
  for (int i = tid; i < kWarps * nb; i += kThreads) seen[i] = 0;
  const int64_t base = tile * kTile + warp * (32 * kItems) + lane;
  int key[kItems];
  load_buckets(a, base, key);
  __syncthreads();

  // each element's rank among its warp's earlier elements of its bucket
  const int bits = key_bits(a);
  uint16_t* mine = seen + warp * nb;
  int pos[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const unsigned same = same_key(key[m], bits);
    const int leader = __ffs(same) - 1;
    int before = 0;
    if (key[m] >= 0 && lane == leader) {
      before = mine[key[m]];
      mine[key[m]] = static_cast<uint16_t>(before + __popc(same));
    }
    pos[m] = __shfl_sync(kFull, before, leader) +
             __popc(same & ((1u << lane) - 1));
    __syncwarp();
  }
  __syncthreads();
  // each thread's buckets: the warps before each; then the tile's
  // elements of the buckets before each (a scan over the threads)
  int total = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = b0 + j;
    if (j >= per || b >= nb) break;
    int count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = seen[w * nb + b];
      seen[w * nb + b] = static_cast<uint16_t>(count);
      count += x;
    }
    local[b] = count;
    total += count;
  }
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = incl - total;
  for (int w = 0; w < warp; ++w) before += warp_sum[w];
  int staged = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) staged += warp_sum[w];
  for (int j = 0; j < per; ++j) {
    const int b = b0 + j;
    if (b >= nb) break;
    const int count = local[b];
    local[b] = before;
    before += count;
  }
  __syncthreads();

  // each element's position in the tile by bucket: its bucket and its
  // place in the tile there
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int b = key[m];
    if (b >= 0) {
      const int at = pos[m] + local[b] + seen[warp * nb + b];
      bucket[at] = static_cast<uint16_t>(b);
      order[at] = static_cast<uint16_t>(warp * (32 * kItems) + 32 * m + lane);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxPlanes; ++c) {
    if (c >= a.planes) break;
    const bool wide = a.wide >> c & 1;
    if (c > 0) {
      __syncthreads();  // the last operand's values are written
      if (wide) {
        fetch_plane<int64_t>(a, c, staging, tile);
      } else {
        fetch_plane<int>(a, c, staging, tile);
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    if (wide) {
      write_plane<int64_t>(a, c, start, room, local, bucket, order, staging,
                           staged);
    } else {
      write_plane<int>(a, c, start, room, local, bucket, order, staging,
                       staged);
    }
  }
}

struct PlaceArgs {
  const void* gidx;
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  uint32_t wide;  // bit c set: operand c is int64, else int32
  int gidx_wide;
  int planes;
  int windows;
  int64_t rows;
  int64_t cols;
  FastDiv len;   // length
  FastDiv sub;   // ceil(length / windows)
  int64_t span;  // a cluster's slots: a multiple of a window's
  FastDiv per;   // a block's slots: ceil(span / kCluster)
};

__device__ __forceinline__ int64_t load_index(const PlaceArgs& a,
                                              int64_t i) {
  return a.gidx_wide ? static_cast<const int64_t*>(a.gidx)[i]
                     : static_cast<const int*>(a.gidx)[i];
}

// g % length for g >= 0.
__device__ __forceinline__ int64_t slot_of(int64_t g, const PlaceArgs& a) {
  return g - div_floor(g, a.len) * a.len.d;
}

// bounds[r * (windows + 1) + w] = the first column of row r whose window
// is w or more, a -1 entry's window being `windows`: a 32-way search by one
// warp each (row, w).
__global__ void __launch_bounds__(256)
    place_bounds_kernel(PlaceArgs a, int64_t* __restrict__ bounds) {
  const int64_t id =
      (static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t per_row = a.windows + 1;
  if (id >= a.rows * per_row) return;  // the whole warp
  const int64_t r = id / per_row;
  const int w = static_cast<int>(id - r * per_row);
  const int64_t row = r * a.cols;
  auto at_or_past = [&](int64_t i) {
    const int64_t g = load_index(a, row + i);
    if (g < 0) return true;
    return div_floor(slot_of(g, a), a.sub) >= w;
  };
  int64_t lo = 0;
  int64_t hi = a.cols;
  // the answer lies in [lo, hi]; hi means every column before it is below
  while (lo < hi) {
    const int64_t span = hi - lo;
    if (span <= 32) {
      const unsigned m =
          __ballot_sync(kFull, lane < span && at_or_past(lo + lane));
      lo = m ? lo + __ffs(m) - 1 : hi;
      break;
    }
    const int64_t step = span / 32;
    const unsigned m =
        __ballot_sync(kFull, at_or_past(lo + (lane + 1) * step - 1));
    if (m == 0) {
      lo += 32 * step;
    } else {
      const int j = __ffs(m) - 1;
      hi = lo + (j + 1) * step - 1;
      lo += j * step;
    }
  }
  if (lane == 0) bounds[id] = lo;
}

// One operand of a cluster's slots [lo, hi): zero this block's slots,
// store every element of the cluster's runs into the shared memory of the
// block that owns its slot, write this block's slots out.
template <typename T>
__device__ __forceinline__ void place_plane(
    const PlaceArgs& a, int c, T* slots, cg::cluster_group& cluster,
    int64_t lo, int64_t hi, int64_t my_lo, int64_t my_hi,
    const int64_t* __restrict__ bounds, int w0, int w1) {
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t mine = my_hi - my_lo;
  for (int64_t j = tid; j < mine; j += kPlaceThreads) slots[j] = T(0);
  cluster.sync();
  const T* __restrict__ in = static_cast<const T*>(a.in[c]);
  constexpr int64_t kStride = int64_t(kCluster) * kPlaceThreads;
  for (int64_t r = 0; r < a.rows; ++r) {
    const int64_t row = r * a.cols;
    int64_t i0 = 0;
    int64_t i1 = a.cols;
    if (a.windows > 1) {
      i0 = bounds[r * (a.windows + 1) + w0];
      i1 = bounds[r * (a.windows + 1) + w1];
    }
    for (int64_t i = i0 + rank * kPlaceThreads + tid; i < i1;
         i += kPlaceUnroll * kStride) {
      int64_t s[kPlaceUnroll];
      T v[kPlaceUnroll];
#pragma unroll
      for (int u = 0; u < kPlaceUnroll; ++u) {
        const bool live = i + u * kStride < i1;
        s[u] = live ? load_index(a, row + i + u * kStride) : -1;
        // every entry of the runs is the cluster's, so its value loads
        // beside its index
        v[u] = live ? in[row + i + u * kStride] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kPlaceUnroll; ++u) {
        if (s[u] >= 0) {
          s[u] = slot_of(s[u], a);
          if (s[u] < lo || s[u] >= hi) s[u] = -1;
        }
      }
#pragma unroll
      for (int u = 0; u < kPlaceUnroll; ++u) {
        if (s[u] >= 0) {
          const int64_t off = s[u] - lo;
          const int owner = static_cast<int>(div_floor(off, a.per));
          T* dst = cluster.map_shared_rank(slots, owner);
          dst[off - owner * a.per.d] = v[u];
        }
      }
    }
  }
  cluster.sync();
  T* __restrict__ out = static_cast<T*>(a.out[c]);
  for (int64_t j = tid; j < mine; j += kPlaceThreads) {
    out[my_lo + j] = slots[j];
  }
  __syncthreads();
}

// Cluster x owns the output slots [x, x + 1) * span, a block of it `per`
// of them in its shared memory.
__global__ void __launch_bounds__(kPlaceThreads)
    place_window_kernel(PlaceArgs a, const int64_t* __restrict__ bounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int64_t x = blockIdx.x / kCluster;
  const int64_t lo = x * a.span;
  const int64_t hi = min64(lo + a.span, a.len.d);
  const int64_t my_lo =
      min64(lo + static_cast<int64_t>(cluster.block_rank()) * a.per.d, hi);
  const int64_t my_hi = min64(my_lo + a.per.d, hi);
  const int w0 = static_cast<int>(div_floor(lo, a.sub));
  const int w1 = static_cast<int>(
      min64(div_floor(hi - 1, a.sub) + 1, a.windows));
#pragma unroll
  for (int c = 0; c < kMaxPlanes; ++c) {
    if (c >= a.planes) break;
    if (a.wide >> c & 1) {
      place_plane(a, c, reinterpret_cast<int64_t*>(smem), cluster, lo, hi,
                  my_lo, my_hi, bounds, w0, w1);
    } else {
      place_plane(a, c, reinterpret_cast<int*>(smem), cluster, lo, hi,
                  my_lo, my_hi, bounds, w0, w1);
    }
  }
}

// out[to[m]] = in[from[m]] for each m whose to[m] >= 0: every load first,
// then every store.
template <typename T, int N>
__device__ __forceinline__ void move(const void* in, void* out,
                                     const int64_t (&from)[N],
                                     const int64_t (&to)[N]) {
  const T* __restrict__ src = static_cast<const T*>(in);
  T* __restrict__ dst = static_cast<T*>(out);
  T v[N];
#pragma unroll
  for (int m = 0; m < N; ++m) v[m] = to[m] >= 0 ? src[from[m]] : T(0);
#pragma unroll
  for (int m = 0; m < N; ++m) {
    if (to[m] >= 0) dst[to[m]] = v[m];
  }
}

// Block b takes columns [b, b + 1) * kScatterTile of every row: rows in no
// window order, one store an element.
__global__ void __launch_bounds__(kScatterThreads)
    place_scatter_kernel(PlaceArgs a) {
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kScatterTile;
  for (int64_t r = 0; r < a.rows; ++r) {
    const int64_t row = r * a.cols;
    const int64_t k = k0 + threadIdx.x;
    int64_t from[kScatterItems], to[kScatterItems];
    if (a.gidx_wide) {
      load_values<int64_t>(a.gidx, row + a.cols, row + k, kScatterThreads,
                           to);
    } else {
      load_values<int>(a.gidx, row + a.cols, row + k, kScatterThreads, to);
    }
#pragma unroll
    for (int j = 0; j < kScatterItems; ++j) {
      from[j] = row + k + j * kScatterThreads;
      const int64_t g = k + j * kScatterThreads < a.cols ? to[j] : -1;
      to[j] = g < 0 ? -1 : slot_of(g, a);
    }
#pragma unroll
    for (int c = 0; c < kMaxPlanes; ++c) {
      if (c >= a.planes) break;
      if (a.wide >> c & 1) {
        move<int64_t>(a.in[c], a.out[c], from, to);
      } else {
        move<int>(a.in[c], a.out[c], from, to);
      }
    }
  }
}

inline int64_t blocks_of(int64_t n, int64_t tile) {
  return (n + tile - 1) / tile;
}

// Dynamic shared memory past 48 KB needs the kernel's attribute first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int64_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// The limits of one call and one launch, for the wrappers.
int ss_route_max_buckets() { return kMaxBuckets; }
int ss_route_max_planes() { return kMaxPlanes; }
int ss_route_tile() { return kTile; }
int ss_place_window_slots(int width) {
  return kCluster * (kPlaceBytes / width);
}

// Bytes of scratch `ss_route_partition` needs for n elements, calls of at
// most `buckets` buckets and `dests` destinations: a row count a
// destination, a total and a first slot a bucket, a count a tile and
// bucket.
int64_t ss_route_scratch_bytes(int64_t n, int buckets, int dests) {
  return (blocks_of(n, kTile) * buckets + 2 * kMaxBuckets + dests) * 4;
}

// Buckets [bucket0, bucket0 + buckets) of the [dests, cap] send buffers of
// `planes` operands, at most kMaxPlanes (in: host array of device pointers
// to n elements each, widths 4 or 8; out: dests * cap elements each; fills:
// host array of one value each). Element e of destination d = src[e] / length (src_bytes 4
// or 8; clamped to [0, dests) where `clamp`) and window w = (src[e] - d *
// length) / ceil(length / windows) (clamped to [0, windows)) has bucket
// d * windows + w and goes to row d, after the row's elements of the
// earlier windows and the earlier elements of its window. The caller
// covers [0, dests * windows) with consecutive ranges on one stream, the
// first at bucket0 = 0, and each range's operands with one call a group of
// them, the first with `count` set (it runs the range's count, scan and
// base, which the range's later groups partition against), all sharing
// `scratch` (ss_route_scratch_bytes(n, the calls' most buckets, dests),
// 4-byte aligned); the last range's calls write the fill into the slots
// past each row's count. *over (a device int32, zeroed by the first call) = 1 where a row
// holds more than cap (what lies past cap is dropped), or, without
// `clamp`, an element's destination lies outside [0, dests).
int ss_route_partition(const void* src, int src_bytes, int64_t n,
                       int64_t length, int dests, int windows, int clamp,
                       int64_t bucket0, int buckets, int count,
                       const void* const* in,
                       void* const* out, const int* widths,
                       const int64_t* fills, int planes, int64_t cap,
                       void* over, void* scratch, void* stream) {
  const int64_t all = static_cast<int64_t>(dests) * windows;
  if (n < 0 || n >= (int64_t(1) << 31) || length < 1 || dests < 1 ||
      windows < 1 || all >= (int64_t(1) << 31) || bucket0 < 0 ||
      buckets < 1 || buckets > kMaxBuckets || bucket0 + buckets > all ||
      cap < 1 || planes < 1 || planes > kMaxPlanes ||
      (src_bytes != 4 && src_bytes != 8) ||
      (reinterpret_cast<uintptr_t>(scratch) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int c = 0; c < planes; ++c) {
    if (widths[c] != 4 && widths[c] != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  RouteArgs a{};
  a.src = src;
  a.src_wide = src_bytes == 8;
  a.dests = dests;
  a.windows = windows;
  a.clamp = clamp != 0;
  a.buckets = buckets;
  a.bucket0 = bucket0;
  a.n = n;
  a.cap = cap;
  a.tiles = blocks_of(n, kTile);
  a.len = make_div(length);
  a.sub = make_div((length + windows - 1) / windows);
  a.win = make_div(windows);
  const bool fast = (a.len.m != 0 || length == 1) &&
                    (a.sub.m != 0 || a.sub.d == 1);
  const int64_t reach = static_cast<int64_t>(dests) * length;
  a.narrow = !fast ? 0
             : reach < (int64_t(1) << 31) ? reach : int64_t(1) << 31;
  const bool last = bucket0 + buckets == all;
  const int64_t fill_blocks = last ? blocks_of(dests * cap, kFillTile) : 0;
  if (a.tiles + fill_blocks >= (int64_t(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the row counts first: they carry over from one call to the next,
  // whose count table may be of another width
  int* rows = static_cast<int*>(scratch);
  int* totals = rows + dests;
  int* first = totals + kMaxBuckets;
  int* counts = first + kMaxBuckets;
  auto* flag = static_cast<int*>(over);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (count && bucket0 == 0) {
    err = cudaMemsetAsync(over, 0, 4, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(rows, 0, dests * 4, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (count) {
    if (a.tiles > 0) {
      const int64_t hist = int64_t(buckets) * 4;
      err = allow_smem(route_count_kernel, hist);
      if (err != cudaSuccess) return static_cast<int>(err);
      route_count_kernel<<<static_cast<int>(a.tiles), kThreads, hist, s>>>(
          a, counts, flag);
    }
    route_scan_kernel<<<(buckets + kScanWidth - 1) / kScanWidth,
                        kScanThreads, 0, s>>>(a.tiles, buckets, counts,
                                              totals);
    route_base_kernel<<<1, kScanThreads, 0, s>>>(a, totals, first, rows,
                                                 flag);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the partition of this group of operands, against the range's scan
  a.planes = planes;
  int width = 4;
  for (int c = 0; c < planes; ++c) {
    a.in[c] = in[c];
    a.out[c] = out[c];
    a.fill[c] = fills[c];
    if (widths[c] == 8) {
      a.wide |= 1u << c;
      width = 8;
    }
  }
  const int64_t blocks = a.tiles + fill_blocks;
  if (blocks > 0) {
    const int64_t smem = staging_offset(buckets) + int64_t(kTile) * width;
    err = allow_smem(route_partition_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    route_partition_kernel<<<static_cast<int>(blocks), kThreads, smem, s>>>(
        a, counts, first, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of scratch `ss_place_received` needs: a column a row and window
// bound.
int64_t ss_place_scratch_bytes(int64_t rows, int windows) {
  return rows * (static_cast<int64_t>(windows) + 1) * 8;
}

// out[c][g % length] = in[c][i] for every i < rows * cols with g =
// gidx[i] >= 0 (gidx_bytes 4 or 8), zero at every other slot of each
// output (length elements); in, out: host arrays of device pointers,
// widths 4 or 8, at most kMaxPlanes of them. With windows > 1 each row of
// gidx is ordered by window w = (g % length) / ceil(length / windows) and
// holds -1 only past its count (what `ss_route_partition` sends), and
// scratch holds ss_place_scratch_bytes(rows, windows), 8-byte aligned,
// which the call with `bounds` set fills with the rows' runs for the
// later calls on the same gidx. With windows = 1 the rows may be in any
// order.
int ss_place_received(const void* gidx, int gidx_bytes, int64_t rows,
                      int64_t cols, int64_t length, int windows,
                      int bounds_first, const void* const* in,
                      void* const* out,
                      const int* widths, int planes, void* scratch,
                      void* stream) {
  if (rows < 0 || cols < 0 || length < 1 || windows < 1 || planes < 1 ||
      planes > kMaxPlanes || (gidx_bytes != 4 && gidx_bytes != 8) ||
      (windows > 1 && (reinterpret_cast<uintptr_t>(scratch) & 7) != 0) ||
      blocks_of(cols, kScatterTile) >= (int64_t(1) << 31) ||
      blocks_of(rows * (int64_t(windows) + 1) * 32, 256) >=
          (int64_t(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int c = 0; c < planes; ++c) {
    if (widths[c] != 4 && widths[c] != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PlaceArgs a{};
  a.gidx = gidx;
  a.gidx_wide = gidx_bytes == 8;
  a.windows = windows;
  a.rows = rows;
  a.cols = cols;
  a.len = make_div(length);
  const int64_t sub = (length + windows - 1) / windows;
  a.sub = make_div(sub);
  auto* bounds = static_cast<int64_t*>(scratch);
  cudaError_t err = cudaSuccess;
  if (bounds_first && windows > 1 && rows > 0) {
    const int64_t warps = rows * (int64_t(windows) + 1);
    place_bounds_kernel<<<static_cast<int>(blocks_of(warps * 32, 256)), 256,
                          0, s>>>(a, bounds);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  a.planes = planes;
  int width = 4;
  for (int c = 0; c < planes; ++c) {
    a.in[c] = in[c];
    a.out[c] = out[c];
    if (widths[c] == 8) {
      a.wide |= 1u << c;
      width = 8;
    }
  }
  const int64_t cluster_slots = int64_t(kCluster) * (kPlaceBytes / width);
  if (sub > cluster_slots) {
    // a window wider than a cluster: the scatter
    for (int c = 0; c < planes; ++c) {
      err = cudaMemsetAsync(a.out[c], 0, length * widths[c], s);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (rows > 0 && cols > 0) {
      place_scatter_kernel<<<static_cast<int>(blocks_of(cols,
                                                        kScatterTile)),
                             kScatterThreads, 0, s>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  // as many whole windows a cluster as fit
  a.span = sub * (cluster_slots / sub);
  a.per = make_div((a.span + kCluster - 1) / kCluster);
  const int64_t blocks = blocks_of(length, a.span) * kCluster;
  if (blocks >= (int64_t(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = a.per.d * width;
  err = allow_smem(place_window_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config{};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(kPlaceThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, place_window_kernel, a,
                           static_cast<const int64_t*>(bounds));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* ss_route_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
