// Bitonic sort of C int32 operand planes on Hopper (sm_90a).
//
// Replaces the Pallas TPU bitonic network of stringsearch_tpu/ops/bitonic.py:
// `_local_sort_kernel` (l.240, every stage group inside a VMEM tile) and the
// `_make_cross` kernel (l.263, one cross-tile stage plus the group's local
// tail). It computes what `pallas_sort` computes: an ascending, unstable sort
// of C = 1..6 int32 planes, compared lexicographically as signed int32 on the
// first `num_keys` planes; the other planes move with their keys.
//
// Network. The all-ascending form of the bitonic network: merge level L
// (block K = 2^L, L = 1 .. log2 N with N the next power of two >= n) first
// compares i with its mirror i ^ (K - 1) inside each block of K, then runs
// half-cleaners i ^ 2^b for b = L-2 .. 0. Every comparator puts the smaller
// element at the lower index. Positions n .. N-1 stand for +infinity: a
// comparator whose upper index is >= n is skipped. No pad memory exists, and
// a real element whose keys are all INT32_MAX is never swapped out of range.
//
// Bound. A pass reads and writes every plane once with little arithmetic,
// so the sort is bound by device-memory bytes times the number of passes
// (log-squared stages over the passes that hold them), and then by the
// instructions of its compare-exchanges. The design cuts the passes and
// keeps each one coalesced. What each choice buys, at n = 2^28 and C = 5
// planes (4 keys) on an H100 (`sort_variants bitonic`, PERF.md §6):
//   * Tiles sized to the card: T = 2^t elements of every plane per block in
//     shared memory, C * 4 * T <= 192 KB (t = 15 for C = 1, 14 for C = 2..3,
//     13 for C = 4..6), one block an SM. A sort pass sorts each tile; a tile
//     pass ends a merge level with its half-cleaners of distance < T.
//     (Tiles of 4096 for C = 4..6: 268 ms against 223.)
//   * Stages of distance >= T run S = t - 5 at a time in one group pass: a
//     block stages 2^w (w <= S) rows of 2^(t-w) >= 32 contiguous elements
//     whose starts differ in the group's bits, so those stages run inside
//     the block and every row is read and written whole. (S - 1: 228 ms.)
//   * The mirror stage that opens a level joins the level's first group.
//     The block takes its upper half's rows from the mirrored rows (the
//     block-row bits complemented), in device order. Then the mirror of the
//     level is the mirror over the block's own T elements, and the level's
//     half-cleaners keep their partners; device order stays increasing in
//     the block's local order, so "smaller to the lower local index" and
//     "skip if the upper local index is past the valid count" hold in every
//     frame. So a level past the tile costs ceil((L - t) / S) group passes
//     and one tile pass: at n = 2^28, 38 passes for C = 4..6 and 34 for
//     C = 2..3, and at 2^24, 26 and 22 (the earlier design: 78 and 51).
//     (The mirror in a pass of its own: 274 ms.)
//   * Inside a block, stages run in registers, three at a time: a thread
//     takes the 2^3 elements that three consecutive stages exchange among,
//     runs those stages and writes the elements back to shared memory
//     before one barrier. A level's rounds run from its top bit, so the
//     first round, which reads device memory, keeps eight loads a thread
//     in flight; a tile's last round is the one on bits 2..0, whose eight
//     elements are consecutive words, read and written as 16-byte vectors,
//     and the sort pass's first round runs levels 1..3 on them. With the
//     words swizzled (bits 6-7 into bits 3-4) no round has a bank conflict
//     but those on bits 2..0, 3 and 4..3 (two-way). (Two stages a round:
//     240 ms; four, on 256 threads: 251 ms; no swizzle: 227 ms. Warp
//     shuffles for the distances below 256 cost about three register
//     stages each.)
//   * The key count is a constant of each kernel (one build for every C and
//     num_keys), so a comparison tests the key planes only. (Read at run
//     time: 265 ms.)
//   * A pass's first round reads device memory straight into registers and
//     its last writes them back: lanes on consecutive addresses of one row,
//     every element once. The sort pass reads the caller's planes and writes
//     the outputs, so no copy of the input is made.
// A pass then runs at 0.52 (tile passes) to 0.86 (narrow groups) of its
// bytes' time, the sort pass (91 stages) at 0.09; the sort at 2^28 takes
// 85.5 / 180.2 / 223.3 ms at C = 2 / 4 / 5, 1.4-2.5 times the chained
// `torch.sort`. The schedule (`make_schedule`) is the one
// `ops/bitonic.py:schedule` lists, and `ss_bitonic_schedule` hands it out
// for the two to be compared.
//
// Interface: plain C, loaded with ctypes. Every kernel launches on the
// caller's stream; the function returns the first nonzero cudaGetLastError()
// after a launch, or 0. Nothing is allocated and nothing synchronises.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxPlanes = 6;
// log2 of the tile, the largest power of two whose planes fit in shared
// memory: C = 1; C = 2, 3; C = 4 .. 6
constexpr int kTileLogOne = 15;
constexpr int kTileLogNarrow = 14;
constexpr int kTileLogWide = 13;
// log2 of the shortest row a group pass stages: 32 elements, 128 bytes
constexpr int kRowLog = 5;
// the mirror stage that opens a level runs in the level's first group pass;
// false: in a pass of its own
constexpr bool kFuseMirror = true;
// stages a thread runs in registers between two shared-memory round trips
constexpr int kChunkStages = 3;
// the shared-memory words of a tile swizzled (`swizzle`); false: in order
constexpr bool kSwizzle = true;
// the key count a constant of each kernel, one build for every (C,
// num_keys), so that a comparison tests only the key planes; false: read
// at run time by one build for each C
constexpr bool kKeysCompiled = true;
constexpr int kThreads = 512;
// log2 of the least tile a block holds: 32 threads of eight elements
constexpr int kLeastTileLog = 8;
constexpr int kMaxPasses = 128;

enum PassKind { kSortPass = 0, kGroupPass = 1, kTilePass = 2 };

struct Planes {
  int* p[kMaxPlanes];
};

// One pass over the planes. kSortPass: merge levels 1 .. level inside each
// tile. kGroupPass: the stages of level `level` on bits hi .. lo (>= t),
// with its mirror stage when hi == level - 1. kTilePass: the half-cleaners
// of bits hi .. lo = t-1 .. 0 that end level `level`.
struct Pass {
  int kind, level, hi, lo;
};

constexpr int tile_log(int c) {
  return c == 1 ? kTileLogOne : c <= 3 ? kTileLogNarrow : kTileLogWide;
}

int log2_ceil(int64_t n) {
  int k = 0;
  while ((int64_t(1) << k) < n) ++k;
  return k;
}

// The passes of one sort of n elements of c planes, in order. Writes at
// most `cap` of them to `out` and returns their number.
int make_schedule(int64_t n, int c, Pass* out, int cap) {
  if (n < 2) return 0;
  const int log_full = log2_ceil(n);
  const int t = tile_log(c) < log_full ? tile_log(c) : log_full;
  const int most = tile_log(c) - kRowLog;  // S: stages of a group pass
  int count = 0;
  auto emit = [&](int kind, int level, int hi, int lo) {
    if (count < cap) out[count] = Pass{kind, level, hi, lo};
    ++count;
  };
  emit(kSortPass, t, t - 1, 0);
  for (int level = t + 1; level <= log_full; ++level) {
    int hi = level - 1;
    if (!kFuseMirror) {
      emit(kGroupPass, level, hi, hi);
      --hi;
    }
    while (hi >= t) {
      const int width = (hi - t) % most + 1;  // the first group the remainder
      emit(kGroupPass, level, hi, hi - width + 1);
      hi -= width;
    }
    emit(kTilePass, level, t - 1, 0);
  }
  return count;
}

// t with `width` zero bits inserted at bit position lo.
__device__ __forceinline__ int spread(int t, int lo, int width) {
  return ((t >> lo) << (lo + width)) | (t & ((1 << lo) - 1));
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

// One comparator: the smaller of x, y to x (the lower index), if live.
template <int C>
__device__ __forceinline__ void order(int (&x)[C], int (&y)[C], bool live,
                                      int nk) {
  const bool swap = live && lex_gt<C>(x, y, nk);
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const int a = x[q];
    const int b = y[q];
    x[q] = swap ? b : a;
    y[q] = swap ? a : b;
  }
}

// Where a block's elements lie. The block holds T = 2^t elements in local
// order s: rows of 2^r contiguous elements, row x at base + x * 2^lo, the
// rows of the upper half (s >= half) at base_up instead. The device index
// increases with s, so the elements below n are those with s < valid.
struct Frame {
  int64_t base;
  int64_t base_up;
  int lo;
  int r;
  int half;
  __device__ __forceinline__ int64_t at(int s) const {
    const int64_t b = s >= half ? base_up : base;
    return b + (static_cast<int64_t>(s >> r) << lo) + (s & ((1 << r) - 1));
  }
};

// Elements below n among `rows` rows of 2^r at stride 2^lo from base.
__device__ int rows_below(int64_t base, int lo, int r, int rows, int64_t n) {
  if (n <= base) return 0;
  const int64_t d = n - base;
  const int64_t x = d >> lo;
  if (x >= rows) return rows << r;
  const int64_t part = d - (x << lo);
  return static_cast<int>((x << r) + (part < (1 << r) ? part : (1 << r)));
}

// Shared-memory word of local element s: bits 6-7 XORed into bits 3-4, so
// that a round whose lanes step over bits 6-7 (the one on bits 5..3) still
// touches 32 banks.
__device__ __forceinline__ int swizzle(int s) {
  return kSwizzle ? s ^ (((s >> 6) & 3) << 3) : s;
}

// Everything a round of stages needs to read and write its elements.
struct Tile {
  int* sm;       // C planes of T elements, plane q at sm + q * T
  int T;
  Frame f;
  Planes src;    // device planes the pass reads (its first round)
  Planes dst;    // device planes the pass writes (its last round)
  int valid;
  int nk;
};

// The E elements idx[x] of a thread into v, from device memory or shared
// memory. contiguous: idx[x] = idx[0] + x with idx[0] a multiple of 8 (the
// round on bits 2..0), read from shared memory as 16-byte vectors.
template <int C, int E>
__device__ __forceinline__ void load(const Tile& b, bool from_device,
                                     bool contiguous, const int (&idx)[E],
                                     int (&v)[E][C]) {
  if (from_device) {
#pragma unroll
    for (int x = 0; x < E; ++x) {
      const bool live = idx[x] < b.valid;
      const int64_t i = live ? b.f.at(idx[x]) : 0;
#pragma unroll
      for (int q = 0; q < C; ++q) v[x][q] = live ? b.src.p[q][i] : 0;
    }
  } else if (contiguous) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
#pragma unroll
      for (int x = 0; x < E; x += 4) {
        const int4 w = *reinterpret_cast<const int4*>(
            b.sm + q * b.T + swizzle(idx[0]) + x);
        v[x][q] = w.x;
        v[x + 1][q] = w.y;
        v[x + 2][q] = w.z;
        v[x + 3][q] = w.w;
      }
    }
  } else {
#pragma unroll
    for (int x = 0; x < E; ++x) {
#pragma unroll
      for (int q = 0; q < C; ++q) v[x][q] = b.sm[q * b.T + swizzle(idx[x])];
    }
  }
}

template <int C, int E>
__device__ __forceinline__ void store(const Tile& b, bool to_device,
                                      bool contiguous, const int (&idx)[E],
                                      const int (&v)[E][C]) {
  if (to_device && contiguous && idx[E - 1] < b.valid) {
    // eight consecutive elements of one row: 16-byte stores
    const int64_t i = b.f.at(idx[0]);
#pragma unroll
    for (int q = 0; q < C; ++q) {
#pragma unroll
      for (int x = 0; x < E; x += 4) {
        *reinterpret_cast<int4*>(b.dst.p[q] + i + x) =
            make_int4(v[x][q], v[x + 1][q], v[x + 2][q], v[x + 3][q]);
      }
    }
  } else if (to_device) {
#pragma unroll
    for (int x = 0; x < E; ++x) {
      if (idx[x] < b.valid) {
        const int64_t i = b.f.at(idx[x]);
#pragma unroll
        for (int q = 0; q < C; ++q) b.dst.p[q][i] = v[x][q];
      }
    }
  } else if (contiguous) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
#pragma unroll
      for (int x = 0; x < E; x += 4) {
        *reinterpret_cast<int4*>(b.sm + q * b.T + swizzle(idx[0]) + x) =
            make_int4(v[x][q], v[x + 1][q], v[x + 2][q], v[x + 3][q]);
      }
    }
  } else {
#pragma unroll
    for (int x = 0; x < E; ++x) {
#pragma unroll
      for (int q = 0; q < C; ++q) b.sm[q * b.T + swizzle(idx[x])] = v[x][q];
    }
  }
}

// One stage on eight consecutive elements s0 + x held in v[x]: partner
// x ^ MASK, the smaller to the lower index.
template <int C, int MASK>
__device__ __forceinline__ void stage8(int (&v)[8][C], int s0, int valid,
                                       int nk) {
  constexpr int kTop = MASK >= 4 ? 2 : MASK >= 2 ? 1 : 0;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    if (x & (1 << kTop)) continue;
    const int y = x ^ MASK;
    order<C>(v[x], v[y], s0 + y < valid, nk);
  }
}

// M consecutive stages on local bits top .. top-M+1, a thread holding the
// 2^M elements they exchange among. mirror != 0: the first stage is the
// mirror of level log2(mirror + 1) (top is that level's top bit): the upper
// half of a thread's elements are the mirror images of the lower half, and
// below the first stage their comparators point the other way. levels > 0
// (M = 3, top = 2): merge levels 1 .. levels of each eight elements.
template <int C, int M>
__device__ __forceinline__ void shared_round(const Tile& b, bool from_device, bool to_device,
                             int top, int mirror, int levels) {
  constexpr int E = 1 << M;
  const int low = top - M + 1;
  const bool contiguous = M == 3 && low == 0 && !mirror;
  const int groups = b.T >> M;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int s0 = spread(g, low, M);
    int idx[E];
#pragma unroll
    for (int x = 0; x < E; ++x) {
      const int s = s0 | ((x & (E / 2 - 1)) << low);
      idx[x] = x < E / 2 ? s : (mirror ? s ^ mirror : s | (1 << top));
    }
    int v[E][C];
    load<C, E>(b, from_device, contiguous, idx, v);
    if constexpr (M == 3) {
      if (levels > 0) {
        stage8<C, 1>(v, s0, b.valid, b.nk);
        if (levels > 1) {
          stage8<C, 3>(v, s0, b.valid, b.nk);
          stage8<C, 1>(v, s0, b.valid, b.nk);
        }
        if (levels > 2) {
          stage8<C, 7>(v, s0, b.valid, b.nk);
          stage8<C, 2>(v, s0, b.valid, b.nk);
          stage8<C, 1>(v, s0, b.valid, b.nk);
        }
        store<C, E>(b, to_device, contiguous, idx, v);
        continue;
      }
    }
#pragma unroll
    for (int j = M - 1; j >= 0; --j) {
#pragma unroll
      for (int x = 0; x < E; ++x) {
        if (x & (1 << j)) continue;
        const int y = x | (1 << j);
        if (mirror && j < M - 1 && (x & (E / 2))) {
          order<C>(v[y], v[x], idx[x] < b.valid, b.nk);
        } else {
          order<C>(v[x], v[y], idx[y] < b.valid, b.nk);
        }
      }
    }
    store<C, E>(b, to_device, contiguous, idx, v);
  }
}

// Calls visit(top, m, mirror, levels) for each round of pass p, in order:
// m stages from bit top down, the first the mirror `mirror` when nonzero;
// levels > 0: the sort pass's first round, levels 1 .. levels on each
// eight elements.
template <typename Visit>
__device__ __forceinline__ void rounds(const Pass& p, int t, int r, bool mirrored,
                       Visit&& visit) {
  // a level's stages on bits hi .. lo, the first a mirror if mirror != 0,
  // in rounds of kChunkStages from the top (the first round, which reads
  // device memory, keeps 2^3 loads a thread in flight); down to bit 0, the
  // last round is the one on bits 2..0, whose elements are consecutive
  auto segment = [&](int mirror, int hi, int lo) {
    const int bottom = lo == 0 ? 3 : lo;
    int top = hi;
    for (; top >= bottom; mirror = 0) {
      const int m = top - bottom + 1 < kChunkStages ? top - bottom + 1
                                                    : kChunkStages;
      visit(top, m, mirror, 0);
      top -= m;
    }
    if (lo == 0) visit(2, 3, mirror, 0);
  };
  if (p.kind == kSortPass) {
    const int first = p.level < 3 ? p.level : 3;
    visit(2, 3, 0, first);
    for (int level = first + 1; level <= p.level; ++level) {
      segment((1 << level) - 1, level - 1, 0);
    }
  } else if (p.kind == kTilePass) {
    segment(0, t - 1, 0);
  } else {
    segment(mirrored ? (1 << t) - 1 : 0, t - 1, r);
  }
}

// One pass of the schedule over a tile of 2^t elements a block, on C
// planes of which the first NK are keys (nk when not kKeysCompiled).
template <int C, int NK>
__global__ void __launch_bounds__(kThreads, 1)
    pass_kernel(Planes src, Planes dst, int64_t n, int nk, int t, Pass p) {
  extern __shared__ int4 sm_words[];  // 16-byte aligned
  int* sm = reinterpret_cast<int*>(sm_words);
  const int T = 1 << t;
  Tile b{sm, T, Frame{}, src, dst, 0, kKeysCompiled ? NK : nk};
  bool mirrored = false;
  int r = t;
  if (p.kind == kGroupPass) {
    // 2^w rows of 2^r at stride 2^lo; the block's number gives the bits
    // between the row and the group (low) and above the group (high)
    const int w = p.hi - p.lo + 1;
    r = t - w;
    const int low_bits = p.lo - r;
    const int64_t block = blockIdx.x;
    const int64_t low_mask = (int64_t(1) << low_bits) - 1;
    const int64_t base = ((block >> low_bits) << (p.lo + w)) |
                         ((block & low_mask) << r);
    mirrored = p.hi == p.level - 1;
    b.f = Frame{base, mirrored ? base ^ (low_mask << r) : base, p.lo, r,
                mirrored ? T / 2 : T};
    const int rows = 1 << w;
    if (mirrored) {
      b.valid = rows_below(base, p.lo, r, rows / 2, n);
      if (b.valid == T / 2) {
        b.valid += rows_below(b.f.base_up + (int64_t(rows / 2) << p.lo),
                              p.lo, r, rows / 2, n);
      }
    } else {
      b.valid = rows_below(base, p.lo, r, rows, n);
    }
  } else {
    const int64_t base = static_cast<int64_t>(blockIdx.x) << t;
    b.f = Frame{base, base, t, t, T};
    b.valid = rows_below(base, t, t, 1, n);
  }
  if (b.valid == 0) return;  // every element past n: nothing to compare

  int total = 0;
  rounds(p, t, r, mirrored, [&](int, int, int, int) { ++total; });
  int i = 0;
  rounds(p, t, r, mirrored, [&](int top, int m, int mirror, int levels) {
    const bool first = i == 0;
    const bool last = i == total - 1;
    if (m == 3) {
      shared_round<C, 3>(b, first, last, top, mirror, levels);
    } else if (m == 2) {
      shared_round<C, 2>(b, first, last, top, mirror, 0);
    } else if (m == 1) {
      shared_round<C, 1>(b, first, last, top, mirror, 0);
    } else if constexpr (kChunkStages >= 4) {
      shared_round<C, 4>(b, first, last, top, mirror, 0);
    }
    if (!last) __syncthreads();
    ++i;
  });
}

template <int C, int NK>
int sort_planes(const Planes& src, const Planes& dst, int64_t n, int nk,
                cudaStream_t stream) {
  Pass passes[kMaxPasses];
  const int count = make_schedule(n, C, passes, kMaxPasses);
  if (count > kMaxPasses) return static_cast<int>(cudaErrorInvalidValue);
  // the sort pass's levels are the tile's; a block holds at least 256
  const int t = passes[0].level > kLeastTileLog ? passes[0].level
                                                : kLeastTileLog;
  const int64_t tile = int64_t(1) << t;
  const int64_t full = int64_t(1) << log2_ceil(n);
  const size_t smem = sizeof(int) * C * static_cast<size_t>(tile);
  const int threads = static_cast<int>(tile / 8 < kThreads ? tile / 8
                                                           : kThreads);
  cudaError_t err = cudaFuncSetAttribute(
      pass_kernel<C, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < count; ++i) {
    const Pass& p = passes[i];
    const int64_t blocks =
        p.kind == kGroupPass ? full >> t : (n + tile - 1) >> t;
    pass_kernel<C, NK>
        <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
            i == 0 ? src : dst, dst, n, nk, t, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// sort_planes<C, nk>, or <C, 1> reading nk at run time.
template <int C, int NK = 1>
int sort_keys(const Planes& src, const Planes& dst, int64_t n, int nk,
              cudaStream_t stream) {
  if constexpr (kKeysCompiled && NK < C) {
    if (nk > NK) return sort_keys<C, NK + 1>(src, dst, n, nk, stream);
  }
  return sort_planes<C, NK>(src, dst, n, nk, stream);
}

}  // namespace

extern "C" {

// Sorts `c` int32 planes of length n by their first num_keys: reads
// planes_in, writes planes_out (which may be the same planes; each output
// 16-byte aligned). Both are c device pointers; stream is a cudaStream_t
// (0 = legacy default).
int ss_bitonic_sort_i32(void** planes_in, void** planes_out, int c, int64_t n,
                        int num_keys, void* stream) {
  if (c < 1 || c > kMaxPlanes || num_keys < 1 || num_keys > c || n < 0 ||
      n > (int64_t(1) << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n < 2) return 0;
  Planes src{}, dst{};
  for (int q = 0; q < c; ++q) {
    src.p[q] = static_cast<int*>(planes_in[q]);
    dst.p[q] = static_cast<int*>(planes_out[q]);
    // the last round of a tile writes eight elements as two 16-byte stores
    if (reinterpret_cast<uintptr_t>(dst.p[q]) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return sort_keys<1>(src, dst, n, num_keys, s);
    case 2: return sort_keys<2>(src, dst, n, num_keys, s);
    case 3: return sort_keys<3>(src, dst, n, num_keys, s);
    case 4: return sort_keys<4>(src, dst, n, num_keys, s);
    case 5: return sort_keys<5>(src, dst, n, num_keys, s);
    default: return sort_keys<6>(src, dst, n, num_keys, s);
  }
}

// The passes of one sort of n elements of c planes: writes (kind, level,
// hi, lo) of at most `cap` of them to out (kind 0 sort, 1 group, 2 tile)
// and returns their number.
int ss_bitonic_schedule(int64_t n, int c, int* out, int cap) {
  if (c < 1 || c > kMaxPlanes) return -1;
  Pass passes[kMaxPasses];
  const int count = make_schedule(n, c, passes, kMaxPasses);
  for (int i = 0; i < count && i < cap && i < kMaxPasses; ++i) {
    out[4 * i] = passes[i].kind;
    out[4 * i + 1] = passes[i].level;
    out[4 * i + 2] = passes[i].hi;
    out[4 * i + 3] = passes[i].lo;
  }
  return count;
}

const char* ss_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
