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
// None of it is a Pallas kernel. With P destinations (4 to 8) the send
// side is a stable counting partition, not a sort.
//
// route_partition: a stable counting partition by bucket, in four
// launches on one stream. An element's bucket is (dest, window): dest =
// src / L (clamped to [0, P), or flagged where it falls outside), window
// = (src - dest L) / ceil(L / W) for W windows a destination (W = 1: the
// bucket is the destination). Row d of the send buffers holds
// destination d's elements by window, and in source order inside one.
//   route_count_kernel  one block a tile of kTile elements: the tile's
//       count of every bucket (a shared-memory add an element), into a
//       [buckets, tiles] table.
//   route_scan_kernel  one block a bucket: the exclusive prefix of its
//       counts over the tiles, in place, and its total.
//   route_base_kernel  one block: each bucket's first slot in its row
//       (the totals of the row's earlier windows), each row's count, and
//       the overflow flag where a row holds more than cap.
//   route_partition_kernel  one block a tile: each element's rank among
//       the tile's earlier elements of its bucket (ballots on the bucket's
//       bits inside a warp, a running count a warp and bucket in shared
//       memory, a scan over the warps), plus its bucket's first slot and
//       the counts of the earlier tiles, is its slot. The tile is staged
//       in shared memory by bucket, one operand at a time, and written a
//       run a bucket. An element at or past cap is dropped (the flag is
//       set). Blocks past the last tile write the fill into the slots
//       past each row's count.
// place_received_kernel  out[g % L] = recv[i] where g = recv_g[i] >= 0,
//       for every operand, after the output is zeroed. A block takes the
//       same columns of every received row.
//
// Bound: device-memory bytes, for both functions. route_partition reads
// the destination source and every operand once and writes every slot of
// every send buffer once; its design reads the source twice and moves a
// count a tile and bucket (4 B for 4096 elements a bucket). place_received
// reads the received gidx and operands once and writes each output once
// (and zeroes it before). What the design does about it:
//   * One read of every input, in place of a sort's passes over all
//     planes, a `searchsorted`, an `arange` and one scatter an operand.
//   * Loads of 128 bytes a warp (a warp's 32 lanes on 32 consecutive
//     elements), every load of a thread issued before its stores (the
//     pointers are restrict-qualified: with unknown aliasing each load
//     waited behind the store before it, and a draft ran at 0.27 of the
//     bound on an H100). The stores go out of shared memory, where the
//     tile is laid out by bucket: consecutive threads write consecutive
//     slots of one bucket's run. Written straight from registers, a
//     warp's 32 elements went to as many buckets' sectors, and a route of
//     2^26 elements into 4 x 64 buckets took 3.33 ms in place of 1.96.
//   * No look-back: the counts of the earlier tiles come from a scan of
//     the count table (a first draft walked back over every tile still in
//     flight, one word at a time, and ran at 0.3-0.4 of the bound).
//   * The windows serve the receiver. A row in source order lands its
//     elements at random places in the receiver's [L] output, one 32-byte
//     sector a 4-byte element: the first draft of place_received ran at
//     0.079 of its bound (2^26 elements). Ordered by window, each row's next elements
//     land in a window of ceil(L / W) elements, and a block takes the
//     same columns of every row, so the P rows of one window are written
//     while their sectors stay in L2.
//   * The launch parameters are read with constant indices (unrolled
//     loops over the operands), so they stay in the parameter space.
//
// Interface: plain C, loaded with ctypes. Each function launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// the first nonzero CUDA error of its calls, or 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;  // elements a thread, 32 apart
constexpr int kTile = kThreads * kItems;
constexpr int kMaxBuckets = 256;  // destinations times windows
constexpr int kMaxPlanes = 8;
constexpr int kFillTile = 4096;  // send-buffer slots a fill block
constexpr int kScanThreads = 1024;

constexpr int kPlaceThreads = 256;
constexpr int kPlaceItems = 4;
constexpr int kPlaceTile = kPlaceThreads * kPlaceItems;

static_assert(kMaxBuckets == kThreads, "a thread a bucket");

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
  int buckets;  // dests * windows
  int clamp;
  int64_t n;
  int64_t length;
  int64_t sub;  // ceil(length / windows): the elements of a window
  int64_t cap;
  int64_t tiles;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// floor(v / d) for d >= 1: a 32-bit unsigned division where both fit.
__device__ __forceinline__ int64_t floor_div(int64_t v, int64_t d) {
  if (v >= 0 && v < (int64_t(1) << 32) && d < (int64_t(1) << 32)) {
    return static_cast<uint32_t>(v) / static_cast<uint32_t>(d);
  }
  const int64_t q = v / d;
  return q * d > v ? q - 1 : q;
}

// The bucket of source value v: dest * windows + window, with dest = v /
// length clamped to [0, dests) where `clamp`; -2 where dest falls outside
// [0, dests) without `clamp` (an element that cannot be routed).
__device__ __forceinline__ int bucket_of(int64_t v, const RouteArgs& a) {
  int64_t d = floor_div(v, a.length);
  if (a.clamp) {
    d = d < 0 ? 0 : d >= a.dests ? a.dests - 1 : d;
  } else if (d < 0 || d >= a.dests) {
    return -2;
  }
  if (a.windows == 1) return static_cast<int>(d);
  const int64_t w = floor_div(v - d * a.length, a.sub);
  return static_cast<int>(d) * a.windows +
         static_cast<int>(w < 0 ? 0 : w >= a.windows ? a.windows - 1 : w);
}

// v[m] = src[base + stride m] (0 past n), every load issued before any
// use (with the type test and the bucket arithmetic inside the loop of
// loads, the loads went out fewer at a time and the count kernel was
// slower).
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

// The buckets of a thread's elements base + 32 m: -1 past n, -2 where the
// element cannot be routed.
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

// counts[b * tiles + tile] = the tile's elements of bucket b; *over = 1
// where an element cannot be routed. A count needs no order: one
// shared-memory add an element (grouping a warp's equal buckets by
// ballots first was slower, on four buckets and on 256).
__global__ void __launch_bounds__(kThreads)
    route_count_kernel(RouteArgs a, int* __restrict__ counts,
                       int* __restrict__ over) {
  __shared__ int hist[kMaxBuckets];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile = blockIdx.x;
  hist[tid] = 0;
  int key[kItems];
  load_buckets(a, tile * kTile + warp * (32 * kItems) + lane, key);
  __syncthreads();
  bool bad = false;
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    if (key[m] >= 0) atomicAdd(&hist[key[m]], 1);
    bad |= key[m] == -2;
  }
  if (bad) atomicExch(over, 1);
  __syncthreads();
  if (tid < a.buckets) counts[tid * a.tiles + tile] = hist[tid];
}

// counts[b * tiles + t] becomes the sum over the tiles before t (bucket b
// = blockIdx.x), and totals[b] the sum over all.
__global__ void __launch_bounds__(kScanThreads)
    route_scan_kernel(int64_t tiles, int* __restrict__ counts,
                      int* __restrict__ totals) {
  __shared__ int warp_sum[kScanThreads / 32];
  __shared__ int carry;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* row = counts + static_cast<int64_t>(blockIdx.x) * tiles;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int64_t t0 = 0; t0 < tiles; t0 += kScanThreads) {
    const int64_t t = t0 + tid;
    const int x = t < tiles ? row[t] : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    if (t < tiles) row[t] = before + incl - x;
    __syncthreads();
    if (tid == kScanThreads - 1) carry = before + incl;
    __syncthreads();
  }
  if (tid == 0) totals[blockIdx.x] = carry;
}

// first[b] = the slot of bucket b's first element in its row; rows[d] =
// row d's elements; *over = 1 where one exceeds cap.
__global__ void __launch_bounds__(kThreads)
    route_base_kernel(int buckets, int windows, int64_t cap,
                      const int* __restrict__ totals, int* __restrict__ first,
                      int* __restrict__ rows, int* __restrict__ over) {
  const int b = threadIdx.x;
  if (b >= buckets) return;
  const int row0 = b - b % windows;
  int before = 0;
  for (int j = row0; j < b; ++j) before += totals[j];
  first[b] = before;
  if (b == row0 + windows - 1) {
    const int count = before + totals[b];
    rows[b / windows] = count;
    if (count > cap) atomicExch(over, 1);
  }
}

// out[to[m]] = in[from[m]] for each m whose to[m] >= 0: every load first,
// then every store. The pointers are restrict-qualified, so the loads are
// issued together (with `in` and `out` of unknown aliasing the compiler
// keeps each load behind the store before it, a memory latency an
// element).
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

// `move` for every operand of a launch.
template <typename Args, int N>
__device__ __forceinline__ void move_planes(const Args& a,
                                            const int64_t (&from)[N],
                                            const int64_t (&to)[N]) {
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

// The partition kernel's dynamic shared memory: the tile's elements by
// bucket (their bucket and, one operand at a time, their value), and a
// few words a bucket.
struct Staging {
  // seen[w][b]: warp w's elements of bucket b so far, then the tile's
  // elements of b before warp w's
  int seen[kWarps][kMaxBuckets];
  int64_t start[kMaxBuckets];     // the slot of the tile's first, a bucket
  int local[kMaxBuckets];         // the tile's elements before, a bucket
  int warp_sum[kWarps];
  uint16_t bucket[kTile];         // of the tile's k-th element by bucket
  uint64_t value[kTile];          // its value of one operand
};

// Operand c of the tile's elements (at their tile position `pos`, -1 for
// none) through shared memory: loaded together, staged by bucket, then
// written a run a bucket, consecutive threads on consecutive slots.
template <typename T>
__device__ __forceinline__ void stage_plane(const RouteArgs& a, int c,
                                            Staging& st, int64_t base,
                                            const int (&pos)[kItems],
                                            int staged) {
  const T* __restrict__ src = static_cast<const T*>(a.in[c]);
  T* __restrict__ dst = static_cast<T*>(a.out[c]);
  T* value = reinterpret_cast<T*>(st.value);
  T v[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    v[m] = pos[m] >= 0 ? src[base + 32 * m] : T(0);
  }
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    if (pos[m] >= 0) value[pos[m]] = v[m];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < staged; j += kThreads) {
    const int b = st.bucket[j];
    const int64_t slot = st.start[b] + (j - st.local[b]);
    // past cap the row overflows: the flag is set
    if (slot < a.cap) dst[(b / a.windows) * a.cap + slot] = value[j];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    route_partition_kernel(RouteArgs a, const int* __restrict__ prefix,
                           const int* __restrict__ first,
                           const int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  Staging& st = *reinterpret_cast<Staging*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile = blockIdx.x;
  if (tile >= a.tiles) {
    fill_rest(a, tile - a.tiles, rows);
    return;
  }
#pragma unroll
  for (int w = 0; w < kWarps; ++w) st.seen[w][tid] = 0;
  const int64_t base = tile * kTile + warp * (32 * kItems) + lane;
  int key[kItems];
  load_buckets(a, base, key);
  __syncthreads();

  // each element's rank among its warp's earlier elements of its bucket
  const int bits = key_bits(a);
  int pos[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const unsigned same = same_key(key[m], bits);
    const int leader = __ffs(same) - 1;
    int before = 0;
    if (key[m] >= 0 && lane == leader) {
      before = st.seen[warp][key[m]];
      st.seen[warp][key[m]] = before + __popc(same);
    }
    pos[m] = __shfl_sync(kFull, before, leader) +
             __popc(same & ((1u << lane) - 1));
    __syncwarp();
  }
  __syncthreads();
  // a thread a bucket: the warps before each, the bucket's first slot for
  // this tile, and the tile's elements of the buckets before it
  int count = 0;
  if (tid < a.buckets) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = st.seen[w][tid];
      st.seen[w][tid] = count;
      count += x;
    }
    st.start[tid] = static_cast<int64_t>(first[tid]) +
                    prefix[static_cast<int64_t>(tid) * a.tiles + tile];
  }
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) st.warp_sum[warp] = incl;
  __syncthreads();
  int before = incl - count;
  for (int w = 0; w < warp; ++w) before += st.warp_sum[w];
  st.local[tid] = before;
  int staged = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) staged += st.warp_sum[w];
  __syncthreads();

  // each element's position in the tile by bucket; -1 for none
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int b = key[m];
    if (b >= 0) {
      pos[m] += st.local[b] + st.seen[warp][b];
      st.bucket[pos[m]] = static_cast<uint16_t>(b);
    } else {
      pos[m] = -1;
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxPlanes; ++c) {
    if (c >= a.planes) break;
    if (a.wide >> c & 1) {
      stage_plane<int64_t>(a, c, st, base, pos, staged);
    } else {
      stage_plane<int>(a, c, st, base, pos, staged);
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
  int64_t rows;
  int64_t cols;
  int64_t length;
};

// Block b takes columns [b, b + 1) * kPlaceTile of every row.
__global__ void __launch_bounds__(kPlaceThreads)
    place_received_kernel(PlaceArgs a) {
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kPlaceTile;
  for (int64_t s = 0; s < a.rows; ++s) {
    // this row's columns k0 + threadIdx.x + j kPlaceThreads
    const int64_t row = s * a.cols;
    const int64_t k = k0 + threadIdx.x;
    int64_t from[kPlaceItems], to[kPlaceItems];
    if (a.gidx_wide) {
      load_values<int64_t>(a.gidx, row + a.cols, row + k, kPlaceThreads, to);
    } else {
      load_values<int>(a.gidx, row + a.cols, row + k, kPlaceThreads, to);
    }
#pragma unroll
    for (int j = 0; j < kPlaceItems; ++j) {
      from[j] = row + k + j * kPlaceThreads;
      const int64_t g = k + j * kPlaceThreads < a.cols ? to[j] : -1;
      to[j] = g < 0 ? -1 : g - floor_div(g, a.length) * a.length;
    }
    move_planes(a, from, to);
  }
}

inline int64_t blocks_of(int64_t n, int64_t tile) {
  return (n + tile - 1) / tile;
}

}  // namespace

extern "C" {

// Bytes of scratch `ss_route_partition` needs: a count a tile and bucket,
// and a total, a first slot and a row count a bucket.
int64_t ss_route_scratch_bytes(int64_t n, int buckets) {
  return (blocks_of(n, kTile) * buckets + 3 * kMaxBuckets) * 4;
}

// The [dests, cap] send buffers of `planes` operands (in: host array of
// device pointers to n elements each, widths 4 or 8; out: dests * cap
// elements each; fills: host array of one value each). Element e of
// destination d = src[e] / length (src_bytes 4 or 8; clamped to [0,
// dests) where `clamp`) and window w = (src[e] - d * length) /
// ceil(length / windows) (clamped to [0, windows)) goes to row d, after
// the row's elements of the earlier windows and the earlier elements of
// its window; slots past a row's count take the fill. *over (a device
// int32) = 1 where a row holds more than cap (what lies past cap is
// dropped), or, without `clamp`, an element's destination lies outside
// [0, dests); else 0. scratch: ss_route_scratch_bytes(n, dests *
// windows), 4-byte aligned.
int ss_route_partition(const void* src, int src_bytes, int64_t n,
                       int64_t length, int dests, int windows, int clamp,
                       const void* const* in, void* const* out,
                       const int* widths, const int64_t* fills, int planes,
                       int64_t cap, void* over, void* scratch,
                       void* stream) {
  if (n < 0 || n >= (int64_t(1) << 31) || length < 1 || dests < 1 ||
      windows < 1 || dests > kMaxBuckets / windows ||
      cap < 1 || planes < 1 || planes > kMaxPlanes ||
      (src_bytes != 4 && src_bytes != 8) ||
      (reinterpret_cast<uintptr_t>(scratch) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RouteArgs a{};
  for (int c = 0; c < planes; ++c) {
    if (widths[c] != 4 && widths[c] != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.in[c] = in[c];
    a.out[c] = out[c];
    a.fill[c] = fills[c];
    if (widths[c] == 8) a.wide |= 1u << c;
  }
  a.src = src;
  a.src_wide = src_bytes == 8;
  a.planes = planes;
  a.dests = dests;
  a.windows = windows;
  a.buckets = dests * windows;
  a.clamp = clamp != 0;
  a.n = n;
  a.length = length;
  a.sub = (length + windows - 1) / windows;
  a.cap = cap;
  a.tiles = blocks_of(n, kTile);
  const int64_t blocks = a.tiles + blocks_of(dests * cap, kFillTile);
  if (blocks >= (int64_t(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* counts = static_cast<int*>(scratch);
  int* totals = counts + a.tiles * a.buckets;
  int* first = totals + kMaxBuckets;
  int* rows = first + kMaxBuckets;
  auto* flag = static_cast<int*>(over);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(over, 0, 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.tiles > 0) {
    route_count_kernel<<<static_cast<int>(a.tiles), kThreads, 0, s>>>(
        a, counts, flag);
  }
  route_scan_kernel<<<a.buckets, kScanThreads, 0, s>>>(a.tiles, counts,
                                                        totals);
  route_base_kernel<<<1, kThreads, 0, s>>>(a.buckets, windows, cap, totals,
                                           first, rows, flag);
  const int smem = static_cast<int>(sizeof(Staging));
  err = cudaFuncSetAttribute(route_partition_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  route_partition_kernel<<<static_cast<int>(blocks), kThreads, smem, s>>>(
      a, counts, first, rows);
  return static_cast<int>(cudaGetLastError());
}

// out[c][g % length] = in[c][i] for every i < rows * cols with g =
// gidx[i] >= 0 (gidx_bytes 4 or 8), each output (length elements) zeroed
// first; in, out: host arrays of device pointers, widths 4 or 8.
int ss_place_received(const void* gidx, int gidx_bytes, int64_t rows,
                      int64_t cols, int64_t length, const void* const* in,
                      void* const* out, const int* widths, int planes,
                      void* stream) {
  if (rows < 0 || cols < 0 || length < 1 || planes < 1 ||
      planes > kMaxPlanes || (gidx_bytes != 4 && gidx_bytes != 8) ||
      blocks_of(cols, kPlaceTile) >= (int64_t(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PlaceArgs a{};
  for (int c = 0; c < planes; ++c) {
    if (widths[c] != 4 && widths[c] != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.in[c] = in[c];
    a.out[c] = out[c];
    if (widths[c] == 8) a.wide |= 1u << c;
    const cudaError_t err = cudaMemsetAsync(out[c], 0, length * widths[c], s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  a.gidx = gidx;
  a.gidx_wide = gidx_bytes == 8;
  a.planes = planes;
  a.rows = rows;
  a.cols = cols;
  a.length = length;
  if (rows > 0 && cols > 0) {
    place_received_kernel<<<static_cast<int>(blocks_of(cols, kPlaceTile)),
                            kPlaceThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ss_route_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
