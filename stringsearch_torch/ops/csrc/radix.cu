// Radix-partition kernels on Hopper (sm_90a): per-tile histograms, stable
// in-tile grouping (destinations, then placement) and the granule flush.
//
// Replaces the four Pallas TPU kernels of stringsearch_tpu/ops/radix.py:
//   ss_radix_hist  <- `_hist_kernel`  (l.92):  [B, 256] bin counts per tile;
//   ss_radix_dest  <- `_dest_kernel`  (l.145): stable tile-local destination
//                     local_base[bin] + rank-in-bin, and local_base;
//   ss_radix_place <- `_place_kernel` (l.191): (key, payload) moved to those
//                     destinations, so each tile comes out bin-contiguous;
//   ss_radix_flush <- `_flush_kernel` (l.291): granule row src[i] copied to
//                     row desc[i] of the output.
// A key's bin is (key >> shift) & 0xFF of its 32 bits, unsigned.
//
// None is carried over block by block. The TPU kernels are MXU formulations
// (one-hot matmuls for the histogram, triangular matmuls for the cumsum, a
// bf16 permutation matmul over 8-bit planes for the placement) that exist
// because Mosaic has no scatter, gather or cumsum; here shared-memory
// atomics, warp votes and shared-memory scatters do those jobs directly.
//
// Bound. Every kernel moves a few bytes per key and does little arithmetic,
// so each is bound by device-memory bandwidth at best; the histogram and the
// placement pay shared-memory traffic on top (atomics, a scatter into a
// staged tile), the grouping's destinations pay warp votes. Scalar 4-byte
// loads and stores everywhere. What each costs on an H100 is in PERF.md.
//
// ss_radix_dest, the design. The function reads a key once and writes its
// destination once (8 bytes a key, and 1 KB of bin starts a tile); ranking
// must not cost more than that traffic takes. A key's rank inside its bin
// must follow its position in the tile (`check_local_group` holds the
// grouping to a stable argsort of the bins), so atomics, which give an
// arbitrary rank, are out. What the kernel does:
//   - A tile is cut into `warps` contiguous runs, one warp each, in tile
//     order; a warp takes its run as consecutive 32-key segments, whole
//     ones and, where the tile ends inside a segment, a shorter tail. A
//     lane starts the loads of all its keys (one of every segment, at most
//     kDestPerLane) before the first vote, so a warp has its whole run in
//     flight, and no key is read twice.
//   - In a segment the lanes of one bin find each other with eight ballots,
//     one per bit of the bin, which cost the same for any distribution of
//     the keys (`__match_any_sync` serialises over the distinct values). A
//     key's rank in its run is its bin's count so far plus the lower lanes
//     of its bin; the lowest lane of each bin adds the segment's count.
//     The counts are 256 ints of shared memory a warp, whatever the tile.
//     The votes, not the memory, set the kernel's pace, so the loop around
//     them is kept short: five operations a bit (`lanes_of_bin`), no
//     test of liveness in a whole segment, one test to leave the loop.
//   - A key's bin (8 bits) and its rank in the run (below the tile) stay
//     packed in one register until the bin starts are known. For one-warp
//     tiles the kernel is compiled for kDestResident threads an SM, 80
//     registers a thread: with more registers fewer warps hide each other's
//     loads and votes, with fewer the held keys spill (a few words at 64,
//     which tiles of several warps accept for the warps they gain).
//   - Every warp of a tile then reads the count rows of the tile's warps,
//     8 bins a lane: the sum over the earlier warps (exclusive, in warp
//     order, which keeps the ranks in tile order) and over all of them,
//     whose exclusive scan over the bins (lane-local, then five shuffles)
//     is local_base. The sum of the two goes back into the warp's own row,
//     each lane adds its keys' entries to the ranks it holds and stores the
//     destinations by segment, coalesced. Warp 0 of the tile writes its row
//     out as the tile's local_base, coalesced too.
//   - A tile of up to 1024 keys is one warp's: several tiles a block and no
//     __syncthreads at all. A larger tile takes 2, 4, ... 32 warps, the
//     fewest whose lanes hold at most kDestPerLane keys (the caller picks;
//     ops/radix.py:dest_warps_per_tile), joined by two __syncthreads.
// Nothing is staged, so TMA and cp.async have no work here, and there is no
// matrix product for the tensor cores: a key goes from device memory to a
// register once.
//
// Interface: plain C, loaded with ctypes. Each ss_radix_<kernel> function
// launches on the caller's stream and returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for arguments it does not take), 0 on
// success. Nothing is allocated and nothing synchronises. The tile limits
// below are exported (ss_radix_max_*_tile), so the Python side reads them
// from here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;  // block of the hist, place and flush kernels
constexpr unsigned kFull = 0xffffffffu;
// Shared memory one block can use on Hopper (227 KB).
constexpr int kSmemMax = 232448;
// ss_radix_dest: keys a lane holds in registers (one of each 32-key segment
// of its warp's run), the warps of a block whose tiles take no more than
// that many, and the most warps one tile can take (a whole block). What
// other choices cost is measured by
// `python -m stringsearch_torch.harness.sort_variants` (PERF.md).
constexpr int kDestPerLane = 32;
constexpr int kDestBlockWarps = 8;
constexpr int kDestMaxWarps = 32;
// Threads an SM holds when it is full of blocks of one-warp tiles: the
// compiler keeps a thread's registers under 65536 / kDestResident (80 for
// 768). Tiles of several warps take the build for 1024 threads (64).
constexpr int kDestResident = 768;
constexpr int kMaxDestTile = kDestMaxWarps * 32 * kDestPerLane;
static_assert(kMaxDestTile <= (1 << 23), "a rank packs beside 8 bits of bin");
// ss_radix_place: the tile's keys and payloads staged in shared memory.
constexpr int kMaxPlaceTile = kSmemMax / 8;

__device__ __forceinline__ int bin_of(uint32_t key, int shift) {
  return static_cast<int>((key >> shift) & 0xFFu);
}

// One block per tile: 256 shared counters, one atomic per key, then the
// row of counts. Integer atomics are exact.
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const uint32_t* keys, int tile, int shift, int* out) {
  __shared__ int count[kBins];
  count[threadIdx.x] = 0;
  __syncthreads();
  const uint32_t* k = keys + static_cast<int64_t>(blockIdx.x) * tile;
  for (int t = threadIdx.x; t < tile; t += kThreads) {
    atomicAdd(&count[bin_of(k[t], shift)], 1);
  }
  __syncthreads();
  out[static_cast<int64_t>(blockIdx.x) * kBins + threadIdx.x] =
      count[threadIdx.x];
}

// The lanes of `live_lanes` that hold bin b. Every lane of the warp calls
// it. One ballot per bit of the bin, from bit 7 down: the bit is moved to
// the sign, where a compare gives the vote's predicate and an arithmetic
// shift the mask that turns the vote into "the lanes whose bit is mine".
// Five machine operations a bit; `set ? vote : ~vote` compiled to seven.
__device__ __forceinline__ unsigned lanes_of_bin(int b, unsigned live_lanes) {
  unsigned peers = live_lanes;
  int x = b << 24;
#pragma unroll
  for (int bit = 7; bit >= 0; --bit) {
    const unsigned vote = __ballot_sync(kFull, x < 0);
    peers &= ~(vote ^ static_cast<unsigned>(x >> 31));
    x += x;
  }
  return peers;
}

// One 32-key segment of a warp's run: returns bin | rank << 8 of this lane's
// `key`, the rank counting the keys of the bin before it in the run, and
// adds the segment to the warp's 256 counters `count`. Every lane of the
// warp calls it; kWhole says that all 32 lanes hold a key, else those of
// `live_lanes` (a prefix of the warp) do.
template <bool kWhole>
__device__ __forceinline__ int ranked(uint32_t key, int shift, int* count,
                                      unsigned live_lanes) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1;
  const bool live = kWhole || ((live_lanes >> lane) & 1) != 0;
  const int bin = bin_of(key, shift);
  const unsigned peers = lanes_of_bin(bin, kWhole ? kFull : live_lanes);
  const int before = live ? count[bin] : 0;
  __syncwarp();
  // the lowest lane of each bin takes the count on
  if (live && (peers & lower) == 0) count[bin] = before + __popc(peers);
  __syncwarp();
  return bin | (before + __popc(peers & lower)) << 8;
}

// All threads that work on one tile meet: the warp alone, or the block.
__device__ __forceinline__ void tile_sync(int warps) {
  if (warps == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// blockDim.x / 32 / warps tiles per block, `warps` consecutive warps each;
// warp p of a tile ranks the keys [p * per_lane * 32, (p + 1) * per_lane *
// 32) of it, cut at the tile's end (see the header). `warps` divides the
// block's warps and per_lane <= kDestPerLane. Dynamic shared memory: 256
// ints for every warp of the block.
template <int kMaxThreads>
__global__ void __launch_bounds__(
    kMaxThreads, (kDestResident + kMaxThreads - 1) / kMaxThreads)
    dest_kernel(const uint32_t* __restrict__ keys, int64_t tiles, int tile,
                int shift, int warps, int per_lane, int* __restrict__ dest,
                int* __restrict__ local_base) {
  // [warps of the block][kBins]
  extern __shared__ __align__(16) int warp_count[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = warp % warps;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32 / warps) +
      warp / warps;
  // The run is `whole` segments of 32 keys and, where the tile ends inside
  // a segment, `tail` keys more. The last block may own fewer tiles: a warp
  // without one, like a warp past the tile's end, has an empty run, but
  // meets the block at every __syncthreads.
  const int run_start = part * per_lane * 32;
  const int run_keys =
      b < tiles ? max(min(per_lane * 32, tile - run_start), 0) : 0;
  const int whole = run_keys / 32;
  const int tail = run_keys % 32;
  const int64_t first = b * tile + run_start + lane;  // this lane's first key
  int* count = warp_count + warp * kBins;

  // every load of the run before the first vote
  int held[kDestPerLane];
#pragma unroll
  for (int j = 0; j < kDestPerLane; ++j) {
    held[j] = j < whole ? static_cast<int>(keys[first + j * 32]) : 0;
  }
  int held_tail = lane < tail ? static_cast<int>(keys[first + whole * 32]) : 0;
#pragma unroll
  for (int i = 0; i < kBins / 32; ++i) count[i * 32 + lane] = 0;
  __syncwarp();

  // keys become bin | rank << 8, segment by segment in order; the warp
  // leaves the unrolled loop whole after its last segment
#pragma unroll
  for (int j = 0; j < kDestPerLane; ++j) {
    if (j >= whole) break;
    held[j] = ranked<true>(held[j], shift, count, kFull);
  }
  if (tail != 0) {
    held_tail = ranked<false>(held_tail, shift, count, (1u << tail) - 1);
  }
  tile_sync(warps);

  // Lane l, bins 8 l .. 8 l + 7 (two 16-byte words of a row): their counts
  // in the tile's earlier warps and in all of its warps, then the scan of
  // the latter over the bins.
  constexpr int kMine = kBins / 32;
  static_assert(kMine == 8, "a lane reads its bins as two int4");
  int earlier[kMine], total[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) earlier[i] = total[i] = 0;
  const int4* rows = reinterpret_cast<const int4*>(
      warp_count + (warp - part) * kBins + lane * kMine);
  for (int w = 0; w < warps; ++w) {
    const int4 lo = rows[w * (kBins / 4)];
    const int4 hi = rows[w * (kBins / 4) + 1];
    const int c[kMine] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      if (w < part) earlier[i] += c[i];
      total[i] += c[i];
    }
  }
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kMine; ++i) mine += total[i];
  int upto = mine;  // inclusive scan over the lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, upto, d);
    if (lane >= d) upto += y;
  }
  int start = upto - mine;
  // earlier[i] becomes the tile-local slot of this warp's first key of the
  // bin, and goes into the warp's own row once every warp of the tile has
  // read it
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    earlier[i] += start;
    start += total[i];
  }
  tile_sync(warps);
  int4* own = reinterpret_cast<int4*>(count + lane * kMine);
  own[0] = make_int4(earlier[0], earlier[1], earlier[2], earlier[3]);
  own[1] = make_int4(earlier[4], earlier[5], earlier[6], earlier[7]);
  __syncwarp();

  if (b < tiles && part == 0) {  // no earlier warp: the row is local_base
#pragma unroll
    for (int i = 0; i < kBins / 32; ++i) {
      local_base[b * kBins + i * 32 + lane] = count[i * 32 + lane];
    }
  }
#pragma unroll
  for (int j = 0; j < kDestPerLane; ++j) {
    if (j >= whole) break;
    dest[first + j * 32] = (held[j] >> 8) + count[held[j] & 0xFF];
  }
  if (lane < tail) {
    dest[first + whole * 32] = (held_tail >> 8) + count[held_tail & 0xFF];
  }
}

// One block per tile: keys and payloads scattered into a shared-memory copy
// of the tile by their destinations, then written out in order, so the
// stores to device memory coalesce. A destination outside the tile is
// dropped (dest must be a permutation of 0..tile-1 for a defined result).
__global__ void __launch_bounds__(kThreads)
    place_kernel(const int* keys, const int* payload, const int* dest,
                 int tile, int* gk, int* gp) {
  extern __shared__ int staged[];  // [2][tile]: keys, then payloads
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  for (int t = threadIdx.x; t < tile; t += kThreads) {
    const int d = dest[t0 + t];
    if (static_cast<unsigned>(d) < static_cast<unsigned>(tile)) {
      staged[d] = keys[t0 + t];
      staged[tile + d] = payload[t0 + t];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < tile; t += kThreads) {
    gk[t0 + t] = staged[t];
    gp[t0 + t] = staged[tile + t];
  }
}

// Ints of a flushed row each thread copies per step, loads before stores.
constexpr int kFlushPerThread = 4;

// blockDim.y rows per block, blockDim.x threads per row: row i of `src`
// (`granule` ints) goes to row desc[i] of `out`. Neighbouring threads copy
// neighbouring ints of one row, so reads and writes coalesce. A thread
// issues kFlushPerThread loads, blockDim.x apart, before it stores them:
// with one load in flight per thread the copy fell well short of the
// device-memory bandwidth (PERF.md §6). Rows whose descriptor lies outside
// [0, out_rows) are skipped. `src` and `out` do not overlap.
__global__ void flush_kernel(const int* __restrict__ desc,
                             const int* __restrict__ src, int64_t total,
                             int64_t granule, int64_t out_rows,
                             int* __restrict__ out) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (row >= total) return;
  const int64_t d = desc[row];
  if (d < 0 || d >= out_rows) return;
  const int* from = src + row * granule;
  int* to = out + d * granule;
  const int64_t step = blockDim.x;
  for (int64_t u0 = threadIdx.x; u0 < granule; u0 += step * kFlushPerThread) {
    int v[kFlushPerThread];
#pragma unroll
    for (int i = 0; i < kFlushPerThread; ++i) {
      const int64_t u = u0 + i * step;
      if (u < granule) v[i] = from[u];
    }
#pragma unroll
    for (int i = 0; i < kFlushPerThread; ++i) {
      const int64_t u = u0 + i * step;
      if (u < granule) to[u] = v[i];
    }
  }
}

bool tiling_ok(int64_t n, int tile, int shift) {
  return n >= 0 && tile >= 1 && n % tile == 0 && n / tile <= INT32_MAX &&
         shift >= 0 && shift < 32;
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// out[b, r] = number of keys t of tile b with (keys[t] >> shift) & 0xFF == r.
// keys: [n] 32-bit keys; out: [n / tile, 256] int32.
int ss_radix_hist(const void* keys, int64_t n, int tile, int shift,
                  void* out, void* stream) {
  if (!tiling_ok(n, tile, shift)) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  hist_kernel<<<static_cast<unsigned>(n / tile), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), tile, shift, static_cast<int*>(out));
  return launched();
}

// dest[t]: tile-local slot of key t in its tile grouped stably by bin;
// local_base[b, r]: the first slot of bin r in tile b. `warps` warps rank a
// tile: a power of two, at most kDestMaxWarps, with at most kDestPerLane
// 32-key segments each. tile <= kMaxDestTile.
int ss_radix_dest(const void* keys, int64_t n, int tile, int shift, int warps,
                  void* dest, void* local_base, void* stream) {
  if (!tiling_ok(n, tile, shift) || tile > kMaxDestTile || warps < 1 ||
      warps > kDestMaxWarps || (warps & (warps - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const int segments = (tile + 31) / 32;
  const int per_lane = (segments + warps - 1) / warps;
  if (per_lane > kDestPerLane) return cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int block_warps = warps > kDestBlockWarps ? warps : kDestBlockWarps;
  const int64_t tiles = n / tile;
  const int per_block = block_warps / warps;
  const unsigned blocks =
      static_cast<unsigned>((tiles + per_block - 1) / per_block);
  const int smem = block_warps * kBins * 4;  // at most 32 KB
  // A tile of several warps waits at two barriers, where more resident warps
  // are worth more than registers: it takes the build for blocks of up to
  // 1024 threads (64 registers a thread) at any block size.
  auto* kernel = warps > 1 ? dest_kernel<kDestMaxWarps * 32>
                           : dest_kernel<kDestBlockWarps * 32>;
  kernel<<<blocks, block_warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), tiles, tile, shift, warps, per_lane,
      static_cast<int*>(dest), static_cast<int*>(local_base));
  return launched();
}

// gk[b * tile + dest[t]] = keys[t], gp likewise for the payload, t in tile b.
// tile <= kMaxPlaceTile.
int ss_radix_place(const void* keys, const void* payload, const void* dest,
                   int64_t n, int tile, void* gk, void* gp, void* stream) {
  if (!tiling_ok(n, tile, 0) || tile > kMaxPlaceTile) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const int smem = 8 * tile;
  cudaError_t err = cudaFuncSetAttribute(
      place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  place_kernel<<<static_cast<unsigned>(n / tile), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const int*>(payload),
      static_cast<const int*>(dest), tile, static_cast<int*>(gk),
      static_cast<int*>(gp));
  return launched();
}

// out[desc[i], :] = src[i, :] for i < total; rows of `granule` int32 values.
int ss_radix_flush(const void* desc, const void* src, int64_t total,
                   int64_t granule, int64_t out_rows, void* out,
                   void* stream) {
  if (total < 0 || granule < 1 || out_rows < 0) return cudaErrorInvalidValue;
  if (total == 0) return 0;
  const int64_t per_row = (granule + kFlushPerThread - 1) / kFlushPerThread;
  const int64_t rounded = (per_row + 31) / 32 * 32;
  const int tx = static_cast<int>(rounded < kThreads ? rounded : kThreads);
  const int ty = kThreads / tx;
  const int64_t blocks = (total + ty - 1) / ty;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  flush_kernel<<<static_cast<unsigned>(blocks), dim3(tx, ty), 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(desc), static_cast<const int*>(src), total,
      granule, out_rows, static_cast<int*>(out));
  return launched();
}

// The largest tiles ss_radix_dest and ss_radix_place take, and the keys a
// lane of ss_radix_dest holds.
int ss_radix_max_dest_tile() { return kMaxDestTile; }
int ss_radix_dest_per_lane() { return kDestPerLane; }
int ss_radix_max_place_tile() { return kMaxPlaceTile; }

const char* ss_radix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
