// The binning engine shared by K1 (georegrid_bin.cu) and K2/K3
// (regrid_bin.cu): per-cell integer sums of samples with precomputed grid
// indices, as shared-memory tile histograms.
//
// The samples form an (n_rows, w) plane with int32 grid rows iy and columns
// ix (invalid: outside [0, n_lat) x [0, n_lon)). A block of kThreads
// threads takes a kTileRows x kTileCols tile of the plane at a time
// (persistent blocks loop over the tiles). Each thread handles kGroup
// neighbouring samples of one row in each of kPasses passes: its indices
// (and, where the row allows, its data) come in as 16-byte vector loads, and
// the ragged edge as scalars.
//
// A block reduction gives the tile's cell box: the min and max of its valid
// rows and columns. When the box fits the block's shared memory (the fast
// path) the block zeroes it, adds every sample into it with shared-memory
// atomics, and flushes each non-zero word with one global atomic: about one
// global atomic per (tile, cell, word) instead of one per (sample, word).
// When it does not fit (near the horizon, on random indices, or where a
// tile spans two frames of a burst) the block takes the fallback path:
// global atomics, aggregated across the lanes of a warp that share a cell
// (__match_any_sync groups the lanes, one lane sums its group's terms
// through a small shared-memory scratch and issues the atomic).
//
// Inside a thread, neighbouring samples of one row usually share a cell, so
// each word is first summed over runs of equal cells (run_sums), and only
// the run's first sample (its head) adds. Every sum is an integer, so the
// result does not depend on the order of the atomics.
//
// Shared-memory words are 32-bit: Hopper has no 64-bit shared-memory add
// (nvcc emits a compare-and-swap loop, ATOMS.CAST.SPIN.64). A 64-bit term
// in [0, 2^38) (a fixed-point elevation, a 'full' channel) adds as two
// 32-bit words, its low kSplit bits and the rest, which cannot wrap over
// the kTileRows * kTileCols samples of a tile; a term outside that range
// (negative, or huge: only out-of-contract data) adds straight to device
// memory (add_shared_split).

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bin_tile {

constexpr int kThreads = 256;
// Blocks a SM that the tile kernels' register budget must allow
// (__launch_bounds__): 3 caps them at 85 registers a thread (uncapped,
// ptxas gives them 107-128 and only 2 blocks share a SM), so that more
// tiles are in flight while each block waits on its loads.
constexpr int kMinBlocks = 3;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;                   // samples of one row a thread takes
constexpr int kTileCols = 32 * kGroup;      // one warp spans a tile row
constexpr int kPasses = 4;
constexpr int kTileRows = kWarps * kPasses;  // 32
constexpr int kSmemBytes = 48 * 1024;       // the box's shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSplit = 19;  // a split word: low 19 bits, and the rest
constexpr unsigned long long kSmallTerm = 1ull << 38;  // splits exactly

typedef unsigned long long u64;

// One thread's samples in one pass: kGroup neighbouring columns of one row.
struct Group {
  int y[kGroup], x[kGroup];
  bool valid[kGroup];
  bool head[kGroup];  // the first valid sample of a run of equal cells
  bool any;           // any valid sample
  int64_t idx0;       // flat index of the first sample, r * w + c0
};

// Load the indices of the samples (r, c0 .. c0 + kGroup - 1); kVec: one
// int4 each for iy and ix (w % kGroup == 0 and 16-byte aligned bases).
template <bool kVec>
__device__ __forceinline__ void load_group(const int32_t* __restrict__ iy,
                                           const int32_t* __restrict__ ix,
                                           int64_t n_rows, int w, int64_t r,
                                           int c0, int n_lat, int n_lon,
                                           Group& g) {
  g.idx0 = r * w + c0;
  const bool row_in = r < n_rows && c0 < w;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) g.y[k] = g.x[k] = -1;
  if (row_in) {
    if (kVec) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(iy + g.idx0));
      const int4 b = __ldg(reinterpret_cast<const int4*>(ix + g.idx0));
      g.y[0] = a.x; g.y[1] = a.y; g.y[2] = a.z; g.y[3] = a.w;
      g.x[0] = b.x; g.x[1] = b.y; g.x[2] = b.z; g.x[3] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (c0 + k < w) {
          g.y[k] = __ldg(iy + g.idx0 + k);
          g.x[k] = __ldg(ix + g.idx0 + k);
        }
      }
    }
  }
  int py = -1, px = -1;
  bool have = false;
  g.any = false;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    g.valid[k] = g.y[k] >= 0 && g.y[k] < n_lat && g.x[k] >= 0 &&
                 g.x[k] < n_lon;
    g.head[k] = g.valid[k] && (!have || g.y[k] != py || g.x[k] != px);
    if (g.valid[k]) {
      py = g.y[k];
      px = g.x[k];
      have = true;
    }
    g.any |= g.valid[k];
  }
}

// q[k] -> at each run head, the sum of q over its run (valid samples only)
template <class T>
__device__ __forceinline__ void run_sums(const Group& g, T (&q)[kGroup]) {
  T acc = 0;
#pragma unroll
  for (int k = kGroup - 1; k >= 0; --k) {
    if (g.valid[k]) acc += q[k];
    if (g.head[k]) {
      q[k] = acc;
      acc = 0;
    }
  }
}

// The tile's cell box, reduced over the block (every thread gets it).
struct Box {
  int ymin, xmin, bh, bw;
  long long cells;  // bh * bw; 0 when the tile has no valid sample
};

__device__ __forceinline__ Box block_box(const Group (&g)[kPasses],
                                         int (*s_box)[4]) {
  int ymin = INT_MAX, xmin = INT_MAX, ymax = INT_MIN, xmax = INT_MIN;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (g[p].valid[k]) {
        ymin = min(ymin, g[p].y[k]);
        ymax = max(ymax, g[p].y[k]);
        xmin = min(xmin, g[p].x[k]);
        xmax = max(xmax, g[p].x[k]);
      }
    }
  }
  ymin = __reduce_min_sync(kFull, ymin);
  xmin = __reduce_min_sync(kFull, xmin);
  ymax = __reduce_max_sync(kFull, ymax);
  xmax = __reduce_max_sync(kFull, xmax);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_box[warp][0] = ymin;
    s_box[warp][1] = xmin;
    s_box[warp][2] = ymax;
    s_box[warp][3] = xmax;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    ymin = min(ymin, s_box[i][0]);
    xmin = min(xmin, s_box[i][1]);
    ymax = max(ymax, s_box[i][2]);
    xmax = max(xmax, s_box[i][3]);
  }
  Box b;
  b.ymin = ymin;
  b.xmin = xmin;
  b.bh = ymax - ymin + 1;
  b.bw = xmax - xmin + 1;
  b.cells = ymin > ymax ? 0 : (long long)b.bh * b.bw;
  return b;
}

// Fast path: add each run into the box's shared-memory word s_word.
template <class T>
__device__ __forceinline__ void add_shared(const Group& g, const Box& b,
                                           const T (&q)[kGroup], T* s_word) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (g.head[k] && q[k] != 0) {
      atomicAdd(s_word + (g.y[k] - b.ymin) * b.bw + (g.x[k] - b.xmin), q[k]);
    }
  }
}

// Fast path for 64-bit terms: each run sum adds into a split pair of 32-bit
// shared words (s_lo: its low kSplit bits, s_hi: the rest), or, when the
// group holds a term outside [0, kSmallTerm) (`big`), straight into word
// `word` of its cell in `acc` (stride words a cell).
__device__ __forceinline__ void add_shared_split(const Group& g, const Box& b,
                                                 const u64 (&q)[kGroup],
                                                 bool big, unsigned* s_lo,
                                                 unsigned* s_hi, u64* acc,
                                                 int64_t stride, int word,
                                                 int n_lon) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (!g.head[k] || q[k] == 0) continue;
    if (big) {
      atomicAdd(acc + ((int64_t)g.y[k] * n_lon + g.x[k]) * stride + word,
                q[k]);
    } else {
      const int i = (g.y[k] - b.ymin) * b.bw + (g.x[k] - b.xmin);
      const unsigned lo = (unsigned)(q[k] & ((1u << kSplit) - 1));
      const unsigned hi = (unsigned)(q[k] >> kSplit);
      if (lo) atomicAdd(s_lo + i, lo);
      if (hi) atomicAdd(s_hi + i, hi);
    }
  }
}

// whether a group's terms (before run_sums) need add_shared_split's `big`
__device__ __forceinline__ bool any_big(const Group& g,
                                        const u64 (&q)[kGroup]) {
  bool big = false;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) big |= g.valid[k] && q[k] >= kSmallTerm;
  return big;
}

// the 64-bit sum of a split pair of shared words
__device__ __forceinline__ u64 split_sum(unsigned lo, unsigned hi) {
  return ((u64)hi << kSplit) + lo;
}

// Fallback path: the lanes' run heads with equal cells (grp[k], from
// match_groups) are summed by the group's first lane, which adds the sum to
// word `word` of its cell in `acc` (stride words a cell). Every lane of the
// warp must call this (it synchronises the warp). With kCheck, the word is
// the cell's count and any cell whose count passes `limit` raises *status
// to its count (atomicMax).
template <bool kCheck>
__device__ __forceinline__ void add_global(const Group& g,
                                           const unsigned (&grp)[kGroup],
                                           const u64 (&q)[kGroup], u64* acc,
                                           int64_t stride, int word, int n_lon,
                                           u64* scratch, u64 limit = 0,
                                           u64* status = nullptr) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    scratch[lane] = q[k];
    __syncwarp();
    if (g.head[k] && lane == __ffs(grp[k]) - 1) {
      u64 s = 0;
      for (unsigned m = grp[k]; m; m &= m - 1) s += scratch[__ffs(m) - 1];
      if (s != 0) {
        u64* a = acc + ((int64_t)g.y[k] * n_lon + g.x[k]) * stride + word;
        if (kCheck) {
          const u64 now = atomicAdd(a, s) + s;
          if (now > limit) atomicMax(status, now);
        } else {
          atomicAdd(a, s);
        }
      }
    }
    __syncwarp();
  }
}

// The lanes of the warp whose run heads at slot k share a cell (lanes
// without a head at k group together and add nothing).
__device__ __forceinline__ void match_groups(const Group& g, int n_lon,
                                             unsigned (&grp)[kGroup]) {
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    const long long key = g.head[k] ? (long long)g.y[k] * n_lon + g.x[k] : -1;
    grp[k] = __match_any_sync(kFull, key);
  }
}

// Global index of box cell i.
__device__ __forceinline__ int64_t box_cell(const Box& b, long long i,
                                            int n_lon) {
  return (int64_t)(b.ymin + i / b.bw) * n_lon + b.xmin + i % b.bw;
}

// Persistent grid for `n_tiles` tiles of `kernel` with `smem` bytes of
// dynamic shared memory: as many blocks as fit on the card at once, at most
// one a tile, into *blocks. Sets the kernel's dynamic shared-memory limit.
template <class K>
inline cudaError_t persistent_blocks(K kernel, int smem, long long n_tiles,
                                     long long* blocks) {
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  const long long most = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  *blocks = n_tiles < most ? n_tiles : most;
  return err;
}

__host__ __device__ inline long long n_tiles(long long n_rows, int w) {
  return ((n_rows + kTileRows - 1) / kTileRows) *
         (((long long)w + kTileCols - 1) / kTileCols);
}

}  // namespace bin_tile
