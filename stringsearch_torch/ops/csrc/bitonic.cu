// Bitonic sort of C int32 operand planes on Hopper (sm_90a).
//
// Replaces the Pallas TPU bitonic network of stringsearch_tpu/ops/bitonic.py:
// `_local_sort_kernel` (l.240, every stage group inside a VMEM tile) and the
// `_make_cross` kernel (l.263, one cross-tile stage plus the group's local
// tail). It computes what `pallas_sort` computes: an ascending, unstable sort
// of C = 1..6 int32 planes, compared lexicographically as signed int32 on the
// first `num_keys` planes; the other planes move with their keys.
//
// Network. The all-ascending form of the bitonic network: merge level k
// (k = 2, 4, .., N with N = next power of two >= n) first compares i with its
// mirror i ^ (k - 1) inside each block of k, then runs half-cleaners i ^ j
// for j = k/4 .. 1. Every comparator puts the smaller element at the lower
// index. Positions n .. N-1 stand for +infinity: a comparator whose upper
// index is >= n is skipped, which is exactly what the padded network would
// do with keys greater than every real key. No pad memory exists, and a real
// element whose keys are all INT32_MAX can never be swapped out of range
// (the reference pads with all-ones keys and can lose such an element).
//
// Bound. Each pass over the planes reads and writes up to 2 * C * 4 * n
// bytes with almost no arithmetic, so the sort is bound by device-memory
// bandwidth, and its cost is the number of passes. Two things cut that
// number:
//   * `tile_kernel` keeps a tile of kTile elements of every plane in shared
//     memory (C * 4 * kTile bytes, at most 96 KB) and runs all stages with
//     distance < kTile there: the whole sort of each tile in one pass, and
//     the tail j = kTile/2 .. 1 of every later merge level in one pass;
//   * stages of distance >= kTile run in device memory, and consecutive
//     half-cleaners are fused: `group_kernel` gives each thread the 2^S
//     elements (S <= 3) that S consecutive half-cleaner stages exchange
//     among, runs those stages in registers and writes back only the
//     elements that moved (payload planes are read only for those). The
//     mirror stage that opens a merge level pairs other elements, so it
//     runs alone (`mirror_kernel`).
// Neighbouring threads touch neighbouring addresses in every pass, so
// loads and stores coalesce. For n = 2^28 a sort is 78 passes over the
// planes instead of the network's 406 stages. Shared-memory stages are
// grouped the same way, two at a time (half the barriers and round trips).
// What each of these choices buys on an H100 is measured by
// `python -m stringsearch_torch.harness.sort_variants` (PERF.md).
// Register-resident tiles with warp shuffles, wide loads, TMA and wider
// fusion are later work.
//
// Interface: plain C, loaded with ctypes. Every kernel launches on the
// caller's stream; the function returns the first nonzero cudaGetLastError()
// after a launch, or 0. Nothing is allocated and nothing synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPlanes = 6;
constexpr int kTile = 4096;        // elements of each plane per tile
constexpr int kTileThreads = 512;  // two blocks per SM: at most 64 registers
constexpr int kGlobalThreads = 256;
// Half-cleaner stages fused per pass (a thread holds 2^S elements). Three in
// device memory; two in shared memory, where a thread must stay within the
// 64 registers that two resident blocks of kTileThreads leave it.
constexpr int kGlobalGroupStages = 3;
constexpr int kTileGroupStages = 2;

struct Planes {
  int* p[kMaxPlanes];
};

// The t-th run of 2^width consecutive-bit patterns: t with `width` zero
// bits inserted at bit position lo.
template <typename I>
__device__ __forceinline__ I spread(I t, int lo, int width) {
  const I low = t & ((I(1) << lo) - 1);
  return ((t >> lo) << (lo + width)) | low;
}

// Lexicographic x > y on the first nk of C signed planes.
template <int C>
__device__ __forceinline__ bool lex_gt(const int (&x)[C], const int (&y)[C],
                                       int nk) {
  bool gt = false;
#pragma unroll
  for (int q = C - 1; q >= 0; --q) {
    if (q < nk) gt = (x[q] > y[q]) || (x[q] == y[q] && gt);
  }
  return gt;
}

template <int C>
__device__ __forceinline__ void swap_rows(int (&x)[C], int (&y)[C]) {
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int t = x[q];
    x[q] = y[q];
    y[q] = t;
  }
}

// Runs the S half-cleaner stages of distances stride * 2^(S-1) .. stride on
// the 2^S elements base + x * stride (x < 2^S) of `at`, in registers, and
// stores back only the elements that moved. Keys are loaded up front; a
// payload plane is read only for an element that moved. Elements at index
// >= limit stand for +infinity and are neither read nor compared.
// `at(q, i)` returns a reference to element i of plane q.
template <int C, int S, typename I, typename At>
__device__ __forceinline__ void exchange_group(At at, I base, I stride,
                                               I limit, int nk) {
  constexpr int E = 1 << S;
  int v[E][C];
  int src[E];  // which input element now sits at x
#pragma unroll
  for (int x = 0; x < E; ++x) {
    src[x] = x;
    if (base + x * stride < limit) {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (q < nk) v[x][q] = at(q, base + x * stride);
      }
    }
  }
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
#pragma unroll
    for (int x = 0; x < E; ++x) {
      if (x & (1 << s)) continue;
      const int y = x | (1 << s);
      if (base + y * stride < limit && lex_gt<C>(v[x], v[y], nk)) {
        swap_rows<C>(v[x], v[y]);
        const int t = src[x];
        src[x] = src[y];
        src[y] = t;
      }
    }
  }
  // every read of the group precedes every write
#pragma unroll
  for (int x = 0; x < E; ++x) {
    if (src[x] != x) {
#pragma unroll
      for (int q = 0; q < C; ++q) {
        if (q >= nk) v[x][q] = at(q, base + src[x] * stride);
      }
    }
  }
#pragma unroll
  for (int x = 0; x < E; ++x) {
    if (src[x] != x) {
#pragma unroll
      for (int q = 0; q < C; ++q) at(q, base + x * stride) = v[x][q];
    }
  }
}

// Compare-exchange of a < b (one comparator); payloads move only on a swap.
template <int C, typename I, typename At>
__device__ __forceinline__ void exchange_pair(At at, I a, I b, int nk) {
  int x[C], y[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    if (q < nk) {
      x[q] = at(q, a);
      y[q] = at(q, b);
    }
  }
  if (!lex_gt<C>(x, y, nk)) return;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    if (q >= nk) {
      x[q] = at(q, a);
      y[q] = at(q, b);
    }
    at(q, a) = y[q];
    at(q, b) = x[q];
  }
}

// Element i of plane q of a shared tile. Unswizzled: an XOR swizzle of the
// low bits removes the bank conflicts of the small-stride stages but costs
// more index arithmetic than it saves, measured over the main path's plane
// counts on an H100 (PERF.md).
struct SharedAt {
  int* s;
  int tile;
  __device__ int& operator()(int q, int i) const { return s[q * tile + i]; }
};

struct GlobalAt {
  Planes d;
  __device__ int& operator()(int q, int64_t i) const { return d.p[q][i]; }
};

// Stages per group when half-cleaners 2^hi .. 2^lo are fused at most
// `most` at a time: the first group takes the remainder, so the others end
// on bit lo + most * m.
__device__ __host__ inline int group_width(int hi, int lo, int most) {
  return (hi - lo) % most + 1;
}

// Half-cleaner stages of distances 2^hi .. 2^lo inside a shared tile, in
// groups of up to kTileGroupStages, with a barrier after each group.
template <int C>
__device__ void tile_half_cleaners(SharedAt at, int valid, int nk, int hi,
                                   int lo) {
  while (hi >= lo) {
    const int width = group_width(hi, lo, kTileGroupStages);
    const int low = hi - width + 1;
    const int groups = at.tile >> width;
    for (int t = threadIdx.x; t < groups; t += blockDim.x) {
      const int base = spread<int>(t, low, width);
      const int stride = 1 << low;
      if (width == 2) {
        exchange_group<C, 2, int>(at, base, stride, valid, nk);
      } else {
        exchange_group<C, 1, int>(at, base, stride, valid, nk);
      }
    }
    __syncthreads();
    hi = low - 1;
  }
}

// One tile of `tile` elements per block. sort_all: merge levels k = 2..tile
// (the full sort of the tile). Otherwise: the half-cleaners j = tile/2..1
// that end a merge level k > tile, whose larger distances ran in device
// memory.
template <int C>
__global__ void __launch_bounds__(kTileThreads, 2)
    tile_kernel(Planes d, int64_t n, int nk, int tile, int sort_all) {
  extern __shared__ int s[];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tile;
  const int valid = static_cast<int>(n - base < tile ? n - base : tile);
  const SharedAt at{s, tile};
#pragma unroll
  for (int q = 0; q < C; ++q) {
    for (int i = threadIdx.x; i < valid; i += blockDim.x) {
      at(q, i) = d.p[q][base + i];
    }
  }
  __syncthreads();
  int log_tile = 0;
  while ((1 << log_tile) < tile) ++log_tile;
  if (sort_all) {
    for (int logk = 1; logk <= log_tile; ++logk) {
      const int k = 1 << logk;
      // mirror stage: i with i ^ (k - 1), i in the lower half of its block
      for (int t = threadIdx.x; t < (tile >> 1); t += blockDim.x) {
        const int a = spread<int>(t, logk - 1, 1);
        const int b = a ^ (k - 1);
        if (b < valid) exchange_pair<C, int>(at, a, b, nk);
      }
      __syncthreads();
      tile_half_cleaners<C>(at, valid, nk, logk - 2, 0);
    }
  } else {
    tile_half_cleaners<C>(at, valid, nk, log_tile - 1, 0);
  }
#pragma unroll
  for (int q = 0; q < C; ++q) {
    for (int i = threadIdx.x; i < valid; i += blockDim.x) {
      d.p[q][base + i] = at(q, i);
    }
  }
}

// The mirror stage of merge level 2^logk >= 2 * tile, over the whole array:
// one comparator per thread, `pairs` = N/2 comparators.
template <int C>
__global__ void mirror_kernel(Planes d, int64_t n, int nk, int logk,
                              int64_t pairs) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const int64_t a = spread<int64_t>(t, logk - 1, 1);
  const int64_t b = a ^ ((int64_t(1) << logk) - 1);
  if (b >= n) return;
  exchange_pair<C, int64_t>(GlobalAt{d}, a, b, nk);
}

// S fused half-cleaner stages of distances 2^(lo+S-1) .. 2^lo over the whole
// array: one group of 2^S elements per thread, `groups` = N / 2^S.
template <int C, int S>
__global__ void group_kernel(Planes d, int64_t n, int nk, int lo,
                             int64_t groups) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= groups) return;
  const int64_t stride = int64_t(1) << lo;
  const int64_t base = spread<int64_t>(t, lo, S);
  if (base + stride >= n) return;  // every comparator of the group is skipped
  exchange_group<C, S, int64_t>(GlobalAt{d}, base, stride, n, nk);
}

inline unsigned blocks_for(int64_t threads, int per_block) {
  return static_cast<unsigned>((threads + per_block - 1) / per_block);
}

template <int C>
int sort_planes(const Planes& d, int64_t n, int nk, cudaStream_t stream) {
  int64_t full = 1;
  int log_full = 0;
  while (full < n) {
    full <<= 1;
    ++log_full;
  }
  const int tile = static_cast<int>(full < kTile ? full : kTile);
  int log_tile = 0;
  while ((1 << log_tile) < tile) ++log_tile;
  const size_t smem = sizeof(int) * C * static_cast<size_t>(tile);
  const int tile_threads = tile / 2 < kTileThreads
                               ? (tile / 2 < 32 ? 32 : tile / 2)
                               : kTileThreads;
  const unsigned tiles = static_cast<unsigned>((n + tile - 1) / tile);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);

  tile_kernel<C><<<tiles, tile_threads, smem, stream>>>(d, n, nk, tile, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  for (int logk = log_tile + 1; logk <= log_full; ++logk) {
    mirror_kernel<C><<<blocks_for(full / 2, kGlobalThreads), kGlobalThreads,
                       0, stream>>>(d, n, nk, logk, full / 2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // half-cleaners 2^(logk-2) .. tile, up to kGlobalGroupStages per pass
    for (int hi = logk - 2; hi >= log_tile;) {
      const int width = group_width(hi, log_tile, kGlobalGroupStages);
      const int lo = hi - width + 1;
      const int64_t groups = full >> width;
      const unsigned blocks = blocks_for(groups, kGlobalThreads);
      if (width == 3) {
        group_kernel<C, 3><<<blocks, kGlobalThreads, 0, stream>>>(
            d, n, nk, lo, groups);
      } else if (width == 2) {
        group_kernel<C, 2><<<blocks, kGlobalThreads, 0, stream>>>(
            d, n, nk, lo, groups);
      } else {
        group_kernel<C, 1><<<blocks, kGlobalThreads, 0, stream>>>(
            d, n, nk, lo, groups);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      hi = lo - 1;
    }
    tile_kernel<C><<<tiles, tile_threads, smem, stream>>>(d, n, nk, tile, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Sorts `c` int32 planes of length n in place, by their first num_keys.
// planes: c device pointers; stream: a cudaStream_t (0 = legacy default).
int ss_bitonic_sort_i32(void** planes, int c, int64_t n, int num_keys,
                        void* stream) {
  if (c < 1 || c > kMaxPlanes || num_keys < 1 || num_keys > c || n < 0 ||
      n > (int64_t(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n < 2) return 0;
  Planes d{};
  for (int q = 0; q < c; ++q) d.p[q] = static_cast<int*>(planes[q]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return sort_planes<1>(d, n, num_keys, s);
    case 2: return sort_planes<2>(d, n, num_keys, s);
    case 3: return sort_planes<3>(d, n, num_keys, s);
    case 4: return sort_planes<4>(d, n, num_keys, s);
    case 5: return sort_planes<5>(d, n, num_keys, s);
    default: return sort_planes<6>(d, n, num_keys, s);
  }
}

const char* ss_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
