// The merge-split of the distributed sort, on Hopper (sm_90a).
//
// A stage of `parallel/distsort.py:sharded_sort` hands a shard its
// partner's sorted chunk; the shard keeps the low or the high half of the
// two chunks' stable merge. The reference (stringsearch_tpu/parallel/
// distsort.py:45, `_merge_halves`) and the port before this kernel
// concatenated the two [L] chunks and sorted all 2L elements again. This
// file merges them in one pass and writes only the kept half.
//
//   merge_partition_kernel  one thread a tile boundary: the merge-path
//       split of the output diagonal where each tile starts (a binary
//       search on the two runs, comparing key tuples word by word).
//   merge_tile_kernel  one block a tile of `tile` outputs of the kept
//       half: it stages the tile's key words from both runs in shared
//       memory, each thread finds its own split inside the tile and merges
//       `items` outputs into a table of sources, then the block writes
//       every plane once, 128 bytes a warp a store.
//
// Order: the first `keys` planes lexicographically, each as a signed
// integer of its own dtype (the order `device_sort` gives). An int32 key
// is one 32-bit word; an int64 key is two, its high word signed and its
// low word XOR 0x80000000 (unsigned order as signed), as
// `ops/bitonic.py:_key_words` splits it. Ties go to the first run: the
// stable merge of two sorted runs is the stable sort of their
// concatenation, so the kept half equals that sort's half element for
// element.
//
// Bound: device-memory bytes. The kept half takes exactly L elements from
// the two runs: every plane of those is read once and written once (the
// int32 and int64 key planes are written from the staged words, not read
// again). The searches read log2 L key tuples a tile boundary.
// No tensor cores: a merge does a few integer operations a byte.
//
// Interface: plain C, loaded with ctypes. The launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns the first
// nonzero CUDA error, or 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxItems = 8;  // outputs a thread, at most
constexpr int kMaxPlanes = 64;
constexpr int kMaxWords = 64;  // 32-bit key words (an int64 key is two)
// shared memory a block takes at most: the tile's key words and sources
constexpr int kSmemBudget = 96 * 1024;

struct MergeArgs {
  const void* first[kMaxPlanes];   // the run whose elements win ties
  const void* second[kMaxPlanes];
  void* out[kMaxPlanes];
  uint64_t wide;  // bit p set: plane p is int64, else int32
  int planes;
  int words;
  // key word w is word word_part[w] of plane word_plane[w]: 0 an int32
  // key, 1 the high word of an int64 key, 2 its low word
  int8_t word_plane[kMaxWords];
  int8_t word_part[kMaxWords];
  // the first key word of plane p, or -1 for a plane that is no key
  int8_t plane_word[kMaxPlanes];
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ int word_at(const void* plane, int part,
                                       int64_t i) {
  if (part == 0) return static_cast<const int*>(plane)[i];
  const int64_t v = static_cast<const int64_t*>(plane)[i];
  return part == 1 ? static_cast<int>(v >> 32)
                   : static_cast<int>(static_cast<uint32_t>(v) ^ 0x80000000u);
}

// True where element x of run `xs` has a smaller key tuple than element y
// of run `ys`.
__device__ __forceinline__ bool less_global(const MergeArgs& args,
                                            const void* const* xs, int64_t x,
                                            const void* const* ys,
                                            int64_t y) {
  for (int w = 0; w < args.words; ++w) {
    const int plane = args.word_plane[w];
    const int part = args.word_part[w];
    const int a = word_at(xs[plane], part, x);
    const int b = word_at(ys[plane], part, y);
    if (a != b) return a < b;
  }
  return false;
}

// The same on the staged words: word w of staged element x at
// keys[w * tile + x].
__device__ __forceinline__ bool less_staged(const int* keys, int words,
                                            int tile, int x, int y) {
  for (int w = 0; w < words; ++w) {
    const int a = keys[w * tile + x];
    const int b = keys[w * tile + y];
    if (a != b) return a < b;
  }
  return false;
}

// splits[t] = how many elements of the first run the first d outputs of
// the merge take, d = min(d_begin + t * tile, d_end), for t in [0, tiles].
// An element of the first run goes before one of the second unless the
// second's key is smaller: the largest such count is the split.
__global__ void __launch_bounds__(kThreads)
    merge_partition_kernel(const __grid_constant__ MergeArgs args,
                           int64_t len_first, int64_t len_second,
                           int64_t d_begin, int64_t d_end, int tile,
                           int64_t tiles, int64_t* __restrict__ splits) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t > tiles) return;
  const int64_t d = min64(d_begin + t * tile, d_end);
  int64_t lo = max64(0, d - len_second);
  int64_t hi = min64(d, len_first);
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (!less_global(args, args.second, d - 1 - mid, args.first, mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  splits[t] = lo;
}

// Plane p of the tile's outputs [0, count): output x takes staged element
// src[x], which is first-run element i0 + s for s < na, else second-run
// element j0 + s - na.
template <typename T>
__device__ __forceinline__ void write_plane(const T* __restrict__ first,
                                            const T* __restrict__ second,
                                            T* __restrict__ out,
                                            const int* src, int count, int na,
                                            int64_t i0, int64_t j0) {
  for (int x = threadIdx.x; x < count; x += kThreads) {
    const int s = src[x];
    out[x] = s < na ? first[i0 + s] : second[j0 + s - na];
  }
}

__global__ void __launch_bounds__(kThreads)
    merge_tile_kernel(const __grid_constant__ MergeArgs args,
                      int64_t d_begin, int64_t d_end, int tile, int items,
                      const int64_t* __restrict__ splits) {
  extern __shared__ int smem[];
  int* keys = smem;                      // [words][tile]
  int* src = smem + args.words * tile;   // [tile]
  const int tid = threadIdx.x;
  const int64_t d0 = d_begin + static_cast<int64_t>(blockIdx.x) * tile;
  const int count = static_cast<int>(min64(tile, d_end - d0));
  const int64_t i0 = splits[blockIdx.x];
  const int64_t j0 = d0 - i0;
  const int na = static_cast<int>(splits[blockIdx.x + 1] - i0);
  const int nb = count - na;

  // staged element x: first-run element i0 + x for x < na, else second-run
  // element j0 + x - na; both ranges are read in order
  for (int w = 0; w < args.words; ++w) {
    const int plane = args.word_plane[w];
    const int part = args.word_part[w];
    const void* a = args.first[plane];
    const void* b = args.second[plane];
    for (int x = tid; x < count; x += kThreads) {
      keys[w * tile + x] = x < na ? word_at(a, part, i0 + x)
                                  : word_at(b, part, j0 + x - na);
    }
  }
  __syncthreads();

  // this thread's outputs [d, d + items) of the tile: its split inside the
  // tile, then a serial merge with the same tie rule
  const int d = tid * items;
  if (d < count) {
    int lo = max(0, d - nb);
    int hi = min(d, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!less_staged(keys, args.words, tile, na + d - 1 - mid, mid)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int ia = lo;
    int ib = d - lo;
    const int end = min(d + items, count);
    for (int x = d; x < end; ++x) {
      const bool take_first =
          ib >= nb ||
          (ia < na && !less_staged(keys, args.words, tile, na + ib, ia));
      src[x] = take_first ? ia++ : na + ib++;
    }
  }
  __syncthreads();

  const int64_t o0 = d0 - d_begin;
  for (int p = 0; p < args.planes; ++p) {
    const int w = args.plane_word[p];
    const bool wide = args.wide >> p & 1;
    if (w >= 0) {
      // a key plane: its words are staged
      for (int x = tid; x < count; x += kThreads) {
        const int s = src[x];
        if (wide) {
          const uint32_t high = static_cast<uint32_t>(keys[w * tile + s]);
          const uint32_t low =
              static_cast<uint32_t>(keys[(w + 1) * tile + s]) ^ 0x80000000u;
          static_cast<int64_t*>(args.out[p])[o0 + x] =
              static_cast<int64_t>(static_cast<uint64_t>(high) << 32 | low);
        } else {
          static_cast<int*>(args.out[p])[o0 + x] = keys[w * tile + s];
        }
      }
    } else if (wide) {
      write_plane(static_cast<const int64_t*>(args.first[p]),
                  static_cast<const int64_t*>(args.second[p]),
                  static_cast<int64_t*>(args.out[p]) + o0, src, count, na, i0,
                  j0);
    } else {
      write_plane(static_cast<const int*>(args.first[p]),
                  static_cast<const int*>(args.second[p]),
                  static_cast<int*>(args.out[p]) + o0, src, count, na, i0,
                  j0);
    }
  }
}

// Outputs a thread: as many as the shared-memory budget allows, at most
// kMaxItems.
int items_for(int words) {
  const int per_item = (words + 1) * 4 * kThreads;
  const int items = kSmemBudget / per_item;
  return items < 1 ? 1 : (items > kMaxItems ? kMaxItems : items);
}

int64_t tiles_of(int64_t length, int tile) {
  return (length + tile - 1) / tile;
}

}  // namespace

extern "C" {

// Bytes of scratch `ss_merge_split` needs: a split a tile boundary.
int64_t ss_merge_split_scratch_bytes(int64_t length, int words) {
  return (tiles_of(length, kThreads * items_for(words)) + 1) * 8;
}

// The low (keep_low) or high half of the stable merge of two sorted runs
// of `length` elements each, on their first `keys` planes; ties go to the
// run `first`. first, second and out: host arrays of `planes` device
// pointers, plane p of plane_bytes[p] (4 or 8) bytes an element in all
// three; out holds `length` elements a plane. scratch:
// ss_merge_split_scratch_bytes(length, key words), 8-byte aligned.
int ss_merge_split(const void* const* first, const void* const* second,
                   void* const* out, const int* plane_bytes, int planes,
                   int keys, int64_t length, int keep_low, void* scratch,
                   void* stream) {
  if (length < 1 || planes < 1 || planes > kMaxPlanes || keys < 1 ||
      keys > planes || (reinterpret_cast<uintptr_t>(scratch) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MergeArgs args{};
  args.planes = planes;
  for (int p = 0; p < planes; ++p) {
    if (plane_bytes[p] != 4 && plane_bytes[p] != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    args.first[p] = first[p];
    args.second[p] = second[p];
    args.out[p] = out[p];
    args.plane_word[p] = -1;
    if (plane_bytes[p] == 8) args.wide |= 1ull << p;
  }
  for (int p = 0; p < keys; ++p) {
    const int parts = plane_bytes[p] == 8 ? 2 : 1;
    if (args.words + parts > kMaxWords) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    args.plane_word[p] = static_cast<int8_t>(args.words);
    for (int q = 0; q < parts; ++q) {
      args.word_plane[args.words] = static_cast<int8_t>(p);
      args.word_part[args.words] =
          static_cast<int8_t>(parts == 1 ? 0 : 1 + q);
      ++args.words;
    }
  }
  const int items = items_for(args.words);
  const int tile = kThreads * items;
  const int64_t tiles = tiles_of(length, tile);
  const int smem = (args.words + 1) * tile * 4;
  cudaError_t err = cudaFuncSetAttribute(
      merge_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* splits = static_cast<int64_t*>(scratch);
  const int64_t d_begin = keep_low ? 0 : length;
  const int64_t d_end = d_begin + length;
  merge_partition_kernel<<<static_cast<int>((tiles + kThreads) / kThreads),
                           kThreads, 0, s>>>(args, length, length, d_begin,
                                             d_end, tile, tiles, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_tile_kernel<<<static_cast<int>(tiles), kThreads, smem, s>>>(
      args, d_begin, d_end, tile, items, splits);
  return static_cast<int>(cudaGetLastError());
}

int ss_merge_max_planes() { return kMaxPlanes; }

int ss_merge_max_words() { return kMaxWords; }

const char* ss_merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
