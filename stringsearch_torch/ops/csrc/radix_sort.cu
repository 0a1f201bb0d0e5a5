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
// digit radix sort over kDigitBits-bit digits, from the last key plane to
// the first and from the lowest digit of a plane to the highest. A key is
// taken as its bits XOR 0x80000000, which turns unsigned digit order into
// signed int32 order.
//
// Bound: device-memory bytes. There is no arithmetic to speak of; the
// function must read and write every plane once (8 * C * n bytes), and each
// pass of an LSD sort reads and writes all C planes again. So the design
// is about moving as few bytes as it can, and moving them at the card's
// rate:
//   1. One read of the keys for every histogram (Onesweep: Adinets and
//      Merrill, 2022). `sort_hist_kernel` reads each key plane once and
//      counts the digit of every pass of that plane; `sort_plan_kernel`, one
//      block, turns each pass's histogram into the first slot of every bin.
//      No pass reads its key plane for a histogram of its own.
//   2. No pass over a constant digit. A digit whose histogram has one bin
//      holding all n keys leaves a stable sort as it is, so the plan marks
//      that pass dead and its kernel returns at once. The host launches
//      every pass and never waits on the device: which set of buffers each
//      live pass reads and writes is worked out by the plan kernel, so that
//      the last live pass writes set B (if every digit is constant, the last
//      pass runs anyway, as a copy).
//   3. One kernel a pass, with decoupled look-back (Merrill and Garland,
//      2016), in place of a histogram and a scan kernel a pass.
//      `sort_pass_kernel` runs one block an SM, and a block claims tile
//      after tile from an atomic counter, a tile only when it is about to
//      load it, so a tile waits only on tiles that are being worked on
//      (claiming two ahead made whole convoys wait). A tile ranks its
//      keys, publishes its count of every bin (flag "aggregate"), sums its
//      predecessors' counts back to the first inclusive prefix, reading
//      kWindow predecessors at a time (one at a time lost at every shape),
//      and publishes its own inclusive prefix. A word holds the pass's
//      tag, the flag and a 32-bit count, so neither the count (< 2^31) nor
//      the flag is cut, and the words need zeroing once a sort, not once a
//      pass.
//   4. Asynchronous tile loads. Each plane of a tile comes into shared
//      memory as one bulk copy (TMA, `cp.async.bulk` with an mbarrier) and
//      holds no register: the load of plane 1 overlaps the ranking and the
//      look-back, the load of plane q + 1 the write-out of plane q, and the
//      next tile's key plane is claimed and loaded as soon as the buffer is
//      free. The plane lands linearly, each thread moves its elements to
//      their ranked slots in the stage, and the stage is written out in bin
//      order, a bin's run on neighbouring addresses. The last plane of a
//      tile stays in the stage and is written out while the next tile's
//      keys are ranked, so those stores overlap the ranking.
//   5. Measured choices (`python -m stringsearch_torch.harness.sort_variants`,
//      PERF.md): 8-bit digits (10 and 11 bits save passes but shorten a
//      bin's run in a tile to 16 or 8 keys, and lost at every shape); a
//      tile of 16384 keys on 512 threads; TMA before `cp.async` and
//      register loads; ballots before `__match_any_sync`; the plane
//      pointers in shared memory from six planes on, where they would
//      otherwise spill.
//
// What bounds it now: not the bytes alone. At 2^28 a pass spends about as
// long on the work of a tile that moves no bytes (ranking, scans, the
// look-back, waiting for the tile's key plane) as on its bytes, and one
// block an SM cannot overlap the two; PERF.md has the numbers.
//
// Stability. Every rank comes from position. Inside a tile, warp w takes
// the keys [w * kWarpKeys, (w + 1) * kWarpKeys) as consecutive 32-key
// segments, in order. In a segment the lanes of one digit find each other
// (one ballot a digit bit, which costs the same for any digit distribution)
// and a key's rank among them is the count of lower lanes. A [kWarps,
// kBins] 16-bit count table carries each digit's count from segment to
// segment in the warp, and is then scanned over the warps and the bins.
// Tiles are ordered by their ids, and the look-back sums the tiles before,
// so equal keys keep their order across tiles too.
//
// Interface: plain C, loaded with ctypes. `ss_radix_sort_i32` launches on
// the caller's stream, allocates nothing, does not synchronise, and returns
// the first nonzero CUDA error of its launches, or 0.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kMaxPlanes = 6;
// What other choices cost on an H100 is measured by
// `python -m stringsearch_torch.harness.sort_variants` (PERF.md).
constexpr int kDigitBits = 8;
constexpr int kTile = 16384;
constexpr int kThreads = 512;
// How a plane of a tile reaches shared memory: 0 one TMA bulk copy, 1
// `cp.async` of 16 bytes a thread, 2 loads through registers.
constexpr int kLoad = 0;
// Predecessors' look-back words a thread reads at once.
constexpr int kWindow = 16;
// Plane count from which the pass kernel keeps its plane pointers in
// shared memory.
constexpr int kPlaneTable = 6;

constexpr int kBins = 1 << kDigitBits;
constexpr int kPlanePasses = (32 + kDigitBits - 1) / kDigitBits;
constexpr int kMaxPasses = kMaxPlanes * kPlanePasses;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = kTile / kThreads;  // keys a thread ranks and moves
constexpr int kWarpKeys = kPerThread * 32;    // consecutive keys of one warp
constexpr int kBinsPerThread = (kBins + kThreads - 1) / kThreads;
// Resident blocks the pass kernel is compiled for: 512 threads per SM, so
// at most 128 registers a thread, which hold kPerThread keys and ranks.
constexpr int kPassBlocks = 512 / kThreads;
// The pass kernel's shared memory: the loaded plane, the stage, the digit
// of every staged element, the 16-bit warp counts, the bin deltas, the
// scan's warp sums, the tile id and the mbarrier.
using Digit = std::conditional_t<(kBins <= 256), uint8_t, uint16_t>;
constexpr int kPassSmem = kTile * 4 * 2 + kTile * sizeof(Digit) +
                          kWarps * kBins * 2 + kBins * 4 + kWarps * 4 +
                          8 + 8;
constexpr int kHistThreads = 512;
// Copies of the histogram kernel's counters, as many as 48 KB hold, at
// most one a warp: fewer lanes collide on one counter.
constexpr int kHistCopies = std::max(
    1, std::min(kHistThreads / 32, 49152 / (kPlanePasses * kBins * 4)));
constexpr int kHistSmem = kHistCopies * kPlanePasses * kBins * 4;
constexpr int kPlanThreads = 1024;
// Look-back words: pass tag << 34 | flag << 32 | count.
constexpr uint64_t kAggregate = 1ull << 32;
constexpr uint64_t kInclusive = 2ull << 32;
constexpr int kTagShift = 34;

static_assert(kDigitBits >= 4 && kDigitBits <= 11, "16-bit digits, bins");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kTile % kThreads == 0, "every thread ranks kPerThread keys");
static_assert(kTile <= 32768, "16-bit warp counts and slots");
static_assert(kPassSmem <= 232448, "shared memory of one block");

struct Planes {
  int* p[kMaxPlanes];
};

// The pass's digit of a key: bits [shift, shift + kDigitBits) of its bits
// XOR 0x80000000.
__device__ __forceinline__ int digit_of(int key, int shift) {
  return static_cast<int>(
      ((static_cast<uint32_t>(key) ^ 0x80000000u) >> shift) & (kBins - 1));
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
  for (int bit = 0; bit < kDigitBits; ++bit) {
    const bool set = (b >> bit) & 1;
    const unsigned vote = __ballot_sync(kFull, set);
    peers &= set ? vote : ~vote;
  }
  return peers;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Step 1. hist[p][b] += keys of digit b in pass p, for every pass of every
// key plane, reading each key plane once. Pass p sorts by key plane
// nk - 1 - p / kPlanePasses at digit p % kPlanePasses. `hist` must be zero.
// A warp whose 32 keys share a digit (the high digits of small ranks, a
// constant plane) adds them with one atomic instead of 32 that collide.
__device__ __forceinline__ void count_key(unsigned* count, int key, bool live,
                                          int lane) {
#pragma unroll
  for (int s = 0; s < kPlanePasses; ++s) {
    const int b = live ? digit_of(key, s * kDigitBits) : 0;
    const int b0 = __shfl_sync(kFull, b, 0);
    if (__all_sync(kFull, live && b == b0)) {
      if (lane == 0) atomicAdd(&count[s * kBins + b0], 32u);
    } else if (live) {
      atomicAdd(&count[s * kBins + b], 1u);
    }
  }
}

__global__ void __launch_bounds__(kHistThreads)
    sort_hist_kernel(Planes keys, int nk, int64_t n,
                     unsigned* __restrict__ hist) {
  // [kHistCopies][kPlanePasses][kBins]: warp w counts into copy
  // w % kHistCopies, so fewer lanes collide on one counter
  extern __shared__ unsigned count[];
  const int lane = threadIdx.x & 31;
  unsigned* mine =
      count + ((threadIdx.x >> 5) % kHistCopies) * kPlanePasses * kBins;
  const int64_t quads = n / 4;
  for (int kp = 0; kp < nk; ++kp) {
    for (int i = threadIdx.x; i < kHistCopies * kPlanePasses * kBins;
         i += kHistThreads) {
      count[i] = 0;
    }
    __syncthreads();
    const int4* __restrict__ key4 = reinterpret_cast<const int4*>(keys.p[kp]);
    // `base` is the same for the whole block, so every warp runs the loop
    // whole and the votes see 32 lanes
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * kHistThreads;
         base < quads; base += static_cast<int64_t>(gridDim.x) * kHistThreads) {
      const int64_t q = base + threadIdx.x;
      const bool live = q < quads;
      const int4 v = live ? key4[q] : make_int4(0, 0, 0, 0);
      count_key(mine, v.x, live, lane);
      count_key(mine, v.y, live, lane);
      count_key(mine, v.z, live, lane);
      count_key(mine, v.w, live, lane);
    }
    if (blockIdx.x == 0 && threadIdx.x < n - quads * 4) {
      const int key = keys.p[kp][quads * 4 + threadIdx.x];
#pragma unroll
      for (int s = 0; s < kPlanePasses; ++s) {
        atomicAdd(&mine[s * kBins + digit_of(key, s * kDigitBits)], 1u);
      }
    }
    __syncthreads();
    unsigned* row = hist + (nk - 1 - kp) * kPlanePasses * kBins;
    for (int i = threadIdx.x; i < kPlanePasses * kBins; i += kHistThreads) {
      unsigned c = 0;
#pragma unroll
      for (int k = 0; k < kHistCopies; ++k) {
        c += count[k * kPlanePasses * kBins + i];
      }
      if (c) atomicAdd(&row[i], c);
    }
    __syncthreads();
  }
}

// Step 2, one block. Each pass's histogram becomes, in place, the first
// slot of every bin; plan[p] = {live, set read, set written}, sets 0 (the
// input), 1 (A), 2 (B). A pass is dead when one bin holds all n keys.
__global__ void __launch_bounds__(kPlanThreads)
    sort_plan_kernel(unsigned* hist, int passes, int64_t n,
                     int4* __restrict__ plan) {
  constexpr int kPer = (kBins + kPlanThreads - 1) / kPlanThreads;
  __shared__ int warp_sum[kPlanThreads / 32];
  __shared__ int live[kMaxPasses];
  for (int p = 0; p < passes; ++p) {
    unsigned* row = hist + p * kBins;
    int v[kPer];
    int sum = 0;
    bool whole = false;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int b = threadIdx.x * kPer + k;
      v[k] = b < kBins ? static_cast<int>(row[b]) : 0;
      sum += v[k];
      whole |= v[k] == n;
    }
    int total;
    int run = block_exclusive_scan<kPlanThreads>(sum, warp_sum, total);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int b = threadIdx.x * kPer + k;
      if (b < kBins) row[b] = static_cast<unsigned>(run);
      run += v[k];
    }
    const int constant = __syncthreads_or(whole);
    if (threadIdx.x == 0) live[p] = !constant;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int p = 0; p < passes; ++p) m += live[p];
    if (m == 0) {
      live[passes - 1] = 1;
      m = 1;
    }
    // live pass k of m reads what live pass k - 1 wrote (the input first)
    // and writes set B when m - 1 - k is even, so the last one writes B
    int from = 0;
    for (int p = 0, k = 0; p < passes; ++p) {
      if (live[p]) {
        const int to = ((m - 1 - k) & 1) ? 1 : 2;
        plan[p] = make_int4(1, from, to, 0);
        from = to;
        ++k;
      } else {
        plan[p] = make_int4(0, 0, 0, 0);
      }
    }
  }
}

// Brings `valid` ints of `src` (16-byte aligned) into `line`, by the
// route kLoad names, the first valid & ~3 of them as 16-byte units and the
// last valid & 3 by threads 0..2. Every thread calls it; `await_plane`
// and a __syncthreads() make the plane visible to all.
__device__ __forceinline__ void issue_plane(const int* __restrict__ src,
                                            int* line, int valid,
                                            uint64_t* bar) {
  const int whole = valid & ~3;
  if (threadIdx.x < (valid & 3)) {
    line[whole + threadIdx.x] = src[whole + threadIdx.x];
  }
  if constexpr (kLoad == 0) {
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(whole) * 4;
      // the block's earlier reads of `line` (ordered by a __syncthreads())
      // come before the copy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
              smem_addr(bar)),
          "r"(bytes)
          : "memory");
      if (bytes) {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];" ::"r"(smem_addr(line)),
            "l"(src), "r"(bytes), "r"(smem_addr(bar))
            : "memory");
      }
    }
  } else if constexpr (kLoad == 1) {
    for (int c = threadIdx.x * 4; c < whole; c += kThreads * 4) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_addr(line + c)),
                   "l"(src + c)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else {
    for (int c = threadIdx.x * 4; c < whole; c += kThreads * 4) {
      *reinterpret_cast<int4*>(line + c) =
          *reinterpret_cast<const int4*>(src + c);
    }
  }
}

// Waits for the block's load number `k` (from 0).
__device__ __forceinline__ void await_plane(uint64_t* bar, int k) {
  if constexpr (kLoad == 0) {
    const uint32_t addr = smem_addr(bar);
    const uint32_t parity = k & 1;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
          "%2; selp.u32 %0, 1, 0, p; }"
          : "=r"(done)
          : "r"(addr), "r"(parity)
          : "memory");
    }
  } else if constexpr (kLoad == 1) {
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
}

// Step 3, one kernel a pass. Sets are {input, A, B}, each with the pass's
// key plane first and the other planes after it in one order. `starts` is
// the pass's row of step 2: the first slot of every bin. `lookback` holds
// [tiles][kBins] words, `tile_counter` one counter a pass, both zeroed
// once a sort.
template <int C>
__global__ void __launch_bounds__(kThreads, kPassBlocks)
    sort_pass_kernel(Planes in, Planes a, Planes b, int64_t n, int pass,
                     int shift, const int4* __restrict__ plan,
                     const unsigned* __restrict__ starts,
                     uint64_t* lookback, unsigned* tile_counter) {
  const int4 step = plan[pass];
  if (!step.x) return;  // a constant digit: nothing moves
  extern __shared__ __align__(16) unsigned char smem[];
  int* line = reinterpret_cast<int*>(smem);  // [kTile] a plane as loaded
  int* stage = line + kTile;                 // [kTile] a plane in bin order
  Digit* staged_digit = reinterpret_cast<Digit*>(stage + kTile);
  // [kWarps][kBins]: first each warp's count of a digit so far, then the
  // tile slot of its first key of it
  uint16_t* warp_count = reinterpret_cast<uint16_t*>(staged_digit + kTile);
  // global slot of a staged element at i of digit d: delta[d] + i
  int* delta = reinterpret_cast<int*>(warp_count + kWarps * kBins);
  int* warp_sum = delta + kBins;
  int* tile_slot = warp_sum + kWarps;
  uint64_t* bar = reinterpret_cast<uint64_t*>(tile_slot + 2);

  // The planes this pass reads and writes. From kPlaneTable planes on
  // they are read from shared memory where they are used, so that they
  // hold no registers (fewer planes fit in registers without spilling).
  __shared__ const int* from[kMaxPlanes];
  __shared__ int* to[kMaxPlanes];
  if (C >= kPlaneTable && threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      from[q] = step.y == 0 ? in.p[q] : (step.y == 1 ? a.p[q] : b.p[q]);
      to[q] = step.z == 1 ? a.p[q] : b.p[q];
    }
  }
  auto src = [&](int q) -> const int* {
    if (C >= kPlaneTable) return from[q];
    return step.y == 0 ? in.p[q] : (step.y == 1 ? a.p[q] : b.p[q]);
  };
  auto dst = [&](int q) -> int* {
    if (C >= kPlaneTable) return to[q];
    return step.z == 1 ? a.p[q] : b.p[q];
  };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1;
  const int tiles = static_cast<int>((n + kTile - 1) / kTile);
  const int first = warp * kWarpKeys + lane;  // this thread's key of segment 0
  auto valid_of = [&](int t) {
    const int64_t left = n - static_cast<int64_t>(t) * kTile;
    return static_cast<int>(left < kTile ? left : kTile);
  };
  if (tid == 0) {
    *tile_slot = static_cast<int>(atomicAdd(tile_counter + pass, 1u));
    if constexpr (kLoad == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  int tile = *tile_slot;
  // loads the block has issued, which numbers the mbarrier's phases
  int loads = 0;
  if (tile < tiles) {
    issue_plane(src(0) + static_cast<int64_t>(tile) * kTile, line,
                valid_of(tile), bar);
  }
  // The last plane of the tile before, still in the stage: it is written
  // out while this tile's keys are ranked, with the delta and digits of
  // its own tile, which stay until then.
  int* held = nullptr;
  int held_valid = 0;
  auto write_out = [&](int* __restrict__ out, int k, int upto) {
    const int i = tid + k * kThreads;
    if (i < upto) {
      const int d = C == 1 ? digit_of(stage[i], shift) : staged_digit[i];
      out[delta[d] + i] = stage[i];
    }
  };
  // A tile is claimed when `line` is free for its key plane, which then
  // loads while the tile before it is written out. It is claimed no
  // earlier, so that the tiles before it are being worked on and the
  // look-back waits on no block that has not reached them.
  while (tile < tiles) {
    const int64_t t0 = static_cast<int64_t>(tile) * kTile;
    const int valid = valid_of(tile);
    for (int i = tid; i < kWarps * kBins / 2; i += kThreads) {
      reinterpret_cast<unsigned*>(warp_count)[i] = 0;
    }
    await_plane(bar, loads++);
    __syncthreads();
    int key[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int t = first + j * 32;
      key[j] = t < valid ? line[t] : 0;
    }
    if (C == 1 && tid == 0) {
      *tile_slot = static_cast<int>(atomicAdd(tile_counter + pass, 1u));
    }
    __syncthreads();
    int next = tiles;
    if (C == 1) {
      next = *tile_slot;
      if (next < tiles) {
        issue_plane(src(0) + static_cast<int64_t>(next) * kTile, line,
                    valid_of(next), bar);
      }
    } else {
      issue_plane(src(1) + t0, line, valid, bar);
    }

    // rank[j]: keys of the same digit before key j in this warp's part of
    // the tile. Segments in order; a segment wholly past the tile's end is
    // skipped by the whole warp.
    int rank[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      rank[j] = 0;
      if (first - lane + j * 32 < valid) {
        const bool live = first + j * 32 < valid;
        const int d = digit_of(key[j], shift);
        const unsigned peers = lanes_of_digit(d, live);
        const int before = live ? warp_count[warp * kBins + d] : 0;
        __syncwarp();
        if (live && (peers & lower) == 0) {
          warp_count[warp * kBins + d] =
              static_cast<uint16_t>(before + __popc(peers));
        }
        __syncwarp();
        rank[j] = before + __popc(peers & lower);
      }
      if (held) write_out(held, j, held_valid);
    }
    __syncthreads();  // the held plane is written out; the stage is free

    // Thread t owns the bins t * kBinsPerThread + k: their counts over the
    // warps, then their first slots in the tile.
    int in_tile[kBinsPerThread];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kBinsPerThread; ++k) {
      const int d = tid * kBinsPerThread + k;
      int c = 0;
      if (d < kBins) {
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const int x = warp_count[w * kBins + d];
          warp_count[w * kBins + d] = static_cast<uint16_t>(c);
          c += x;
        }
      }
      in_tile[k] = c;
      sum += c;
    }
    int unused;
    const int start = block_exclusive_scan<kThreads>(sum, warp_sum, unused);

    // Publish the tile's count of each bin: its inclusive prefix if it is
    // the first tile, else an aggregate. Then the warp counts become the
    // tile slots of each warp's first key of a digit.
    const uint64_t tag = static_cast<uint64_t>(pass + 1);
    uint64_t* row = lookback + static_cast<int64_t>(tile) * kBins;
    int local_start[kBinsPerThread];
    int run = start;
#pragma unroll
    for (int k = 0; k < kBinsPerThread; ++k) {
      const int d = tid * kBinsPerThread + k;
      local_start[k] = run;
      if (d < kBins) {
        store_word(row + d, tag << kTagShift |
                                (tile == 0 ? kInclusive : kAggregate) |
                                static_cast<unsigned>(in_tile[k]));
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          warp_count[w * kBins + d] =
              static_cast<uint16_t>(warp_count[w * kBins + d] + run);
        }
      }
      run += in_tile[k];
    }
    __syncthreads();
    // rank[j] becomes key j's slot in the staged tile
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (first + j * 32 < valid) {
        rank[j] += warp_count[warp * kBins + digit_of(key[j], shift)];
      }
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (first + j * 32 < valid) stage[rank[j]] = key[j];
    }

    // The look-back: the keys of each bin in the tiles before this one.
    // kWindow predecessors are read at once, nearest first; their counts
    // are summed up to the first inclusive prefix, or up to the first word
    // not yet published, from which the next read starts.
#pragma unroll
    for (int k = 0; k < kBinsPerThread; ++k) {
      const int d = tid * kBinsPerThread + k;
      unsigned before = 0;
      if (d < kBins && tile > 0) {
        int at = tile - 1;  // the nearest predecessor not yet summed
        for (;;) {
          uint64_t w[kWindow];
#pragma unroll
          for (int i = 0; i < kWindow; ++i) {
            w[i] = at - i >= 0
                       ? load_word(lookback +
                                   static_cast<int64_t>(at - i) * kBins + d)
                       : 0;
          }
          int used = 0;
          bool done = false;
#pragma unroll
          for (int i = 0; i < kWindow; ++i) {
            if (!done && used == i && (w[i] >> kTagShift) == tag) {
              before += static_cast<unsigned>(w[i]);
              used = i + 1;
              done = (w[i] & kInclusive) != 0;
            }
          }
          if (done) break;
          at -= used;
        }
        store_word(row + d, tag << kTagShift | kInclusive |
                                (before + static_cast<unsigned>(in_tile[k])));
      }
      if (d < kBins) {
        delta[d] = static_cast<int>(starts[d] + before) - local_start[k];
      }
    }
    __syncthreads();
    // The staged element at i goes to global slot delta[its digit] + i;
    // the digit is kept for the planes that follow, whose element i the
    // same thread writes out.
    held = dst(C - 1);
    held_valid = valid;
    if (C > 1) {
      int* __restrict__ out = dst(0);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int i = tid + k * kThreads;
        if (i < valid) {
          const int v = stage[i];
          const int d = digit_of(v, shift);
          staged_digit[i] = static_cast<Digit>(d);
          out[delta[d] + i] = v;
        }
      }
    }
#pragma unroll
    for (int q = 1; q < C; ++q) {
      await_plane(bar, loads++);
      __syncthreads();  // plane q is in `line`; the stage is written out
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (first + j * 32 < valid) stage[rank[j]] = line[first + j * 32];
      }
      if (q + 1 == C && tid == 0) {
        *tile_slot = static_cast<int>(atomicAdd(tile_counter + pass, 1u));
      }
      __syncthreads();
      if (q + 1 < C) {
        issue_plane(src(q + 1) + t0, line, valid, bar);
        int* __restrict__ out = dst(q);
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int i = tid + k * kThreads;
          if (i < valid) out[delta[staged_digit[i]] + i] = stage[i];
        }
      } else {
        next = *tile_slot;
        if (next < tiles) {
          issue_plane(src(0) + static_cast<int64_t>(next) * kTile, line,
                      valid_of(next), bar);
        }
      }
    }
    tile = next;
  }
  if (held) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) write_out(held, k, held_valid);
  }
}

// `planes` with plane kp moved to the front: the pass kernel's order.
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

// Byte offsets in the scratch: the look-back words, the histograms, the
// tile counters (these three zeroed once a sort), then the plan.
struct Layout {
  int64_t hist, counters, plan, total;
};

inline Layout layout_of(int64_t n) {
  Layout l{};
  l.hist = static_cast<int64_t>(tiles_of(n)) * kBins * 8;
  l.counters = l.hist + static_cast<int64_t>(kMaxPasses) * kBins * 4;
  l.plan = l.counters + ((kMaxPasses * 4 + 15) / 16) * 16;
  l.total = l.plan + kMaxPasses * 16;
  return l;
}

// The dynamic shared memory attribute belongs to a kernel on a device, not
// to a launch: it is set again only when the device is another than last
// time.
template <int C>
cudaError_t allow_pass_smem() {
  static int allowed_on = -1;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == allowed_on) return err;
  err = cudaFuncSetAttribute(sort_pass_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kPassSmem);
  if (err == cudaSuccess) allowed_on = device;
  return err;
}

template <int C>
int sort_planes(const Planes& in, const Planes& a, const Planes& b,
                unsigned char* scratch, int64_t n, int nk,
                cudaStream_t stream) {
  const int tiles = tiles_of(n);
  const int passes = nk * kPlanePasses;
  const Layout l = layout_of(n);
  auto* lookback = reinterpret_cast<uint64_t*>(scratch);
  auto* hist = reinterpret_cast<unsigned*>(scratch + l.hist);
  auto* counters = reinterpret_cast<unsigned*>(scratch + l.counters);
  auto* plan = reinterpret_cast<int4*>(scratch + l.plan);
  cudaError_t err = allow_pass_smem<C>();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(scratch, 0, l.plan, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device, sms;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t quad_blocks = (n / 4 + kHistThreads - 1) / kHistThreads;
  const int hist_blocks = static_cast<int>(
      quad_blocks < 4 * sms ? (quad_blocks > 0 ? quad_blocks : 1) : 4 * sms);
  sort_hist_kernel<<<hist_blocks, kHistThreads, kHistSmem, stream>>>(
      in, nk, n, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_plan_kernel<<<1, kPlanThreads, 0, stream>>>(hist, passes, n, plan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // one resident block an SM, each taking tile after tile: a dead pass
  // costs one wave of blocks that return
  const int pass_blocks = tiles < sms * kPassBlocks ? tiles : sms * kPassBlocks;
  int pass = 0;
  for (int kp = nk - 1; kp >= 0; --kp) {
    const Planes kin = key_first(in, C, kp);
    const Planes ka = key_first(a, C, kp);
    const Planes kb = key_first(b, C, kp);
    for (int s = 0; s < kPlanePasses; ++s, ++pass) {
      sort_pass_kernel<C><<<pass_blocks, kThreads, kPassSmem, stream>>>(
          kin, ka, kb, n, pass, s * kDigitBits, plan,
          hist + static_cast<int64_t>(pass) * kBins, lookback, counters);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// int32 entries of scratch a sort of n elements needs: kBins look-back
// words (two ints each) a tile, a histogram and a tile counter a pass, and
// the plan, for up to kMaxPasses passes.
int64_t ss_radix_sort_scratch_ints(int64_t n) {
  return layout_of(n).total / 4;
}

// Sorts c int32 planes of length n by their first num_keys, stably. Each of
// planes_in, planes_a, planes_b is c device pointers, 16-byte aligned: the
// input (read only) and two scratch sets, none overlapping another. The
// result is in set b. scratch: ss_radix_sort_scratch_ints(n) ints, 16-byte
// aligned. stream: a cudaStream_t (0 = legacy default). 2 <= n < 2^31.
int ss_radix_sort_i32(void** planes_in, void** planes_a, void** planes_b,
                      void* scratch, int c, int64_t n, int num_keys,
                      void* stream) {
  if (c < 1 || c > kMaxPlanes || num_keys < 1 || num_keys > c || n < 2 ||
      n >= (int64_t(1) << 31) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes in{}, a{}, b{};
  for (int q = 0; q < c; ++q) {
    in.p[q] = static_cast<int*>(planes_in[q]);
    a.p[q] = static_cast<int*>(planes_a[q]);
    b.p[q] = static_cast<int*>(planes_b[q]);
    for (const void* p : {planes_in[q], planes_a[q], planes_b[q]}) {
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
        return static_cast<int>(cudaErrorMisalignedAddress);
      }
    }
  }
  auto* sc = static_cast<unsigned char*>(scratch);
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
