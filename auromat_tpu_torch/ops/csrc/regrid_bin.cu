// K2 (and K3): per-cell (count, n_ch channel sums) binning of samples with
// precomputed bin indices into a fixed plate-carree grid, its input checks
// and its fused float32 epilogue.
//
// Replaces auromat_tpu/ops/regrid_pallas.py::_kernel_cw (K2, driven by
// bin_partial_pallas_cw) and ::_kernel (K3, driven by bin_partial_pallas).
// Those Pallas kernels build bf16 one-hot matrices and contract them on the
// TPU's matrix unit, windowed over grid rows and 128-wide column blocks
// (K3: the whole grid width), because the TPU serializes scatter-adds; to
// keep the bf16 products exact they split channels into limbs (elevation
// into integer + two fraction limbs, 'full' channels into base-256
// digits). Both compute one contract, so both land on this one kernel, a
// shared-memory tile histogram (bin_tile.cuh) over the (h, w) sample plane.
// Invalid samples (iy < 0 or outside the grid) are skipped, NaN data at a
// valid coordinate adds 0, and the limb splits become integer arithmetic:
//   mode 0 ('uint8'): channels 0..n_ch-2 hold integers 0..255 and add as
//       they are; the last channel (elevation) adds round((x + 90) * 2^30)
//       in double, rounded to nearest even (K1's fixed point);
//   mode 1 ('full', values in [0, 65536)) and mode 2 ('raw', bf16-exact
//       values): every channel adds round(x * 2^shift) as a signed integer.
// acc is (n_cells, 1 + n_ch) int64: [count, channel sums]; in shared memory
// the count is a uint32 word and each channel a split pair of uint32 words
// (bin_tile.cuh). Integer sums do not depend on the order of the atomics,
// so the result is bit-reproducible and equal to the plain PyTorch version
// (ops/regrid_pallas.py::bin_partial_cw_plain).
//
// The checks of the plain version's _check_inputs run here, on the samples
// the kernel adds, into a status buffer of three int64 words that the
// wrapper reads once: [0] 1 if any value breaks the mode's range (mode 0: a
// leading channel not an integer in 0..255; mode 1: outside [0, 65536);
// mode 2: not bf16-exact), [1] the bits of the largest magnitude as a
// float32 (mode 0: |fl32(last + 90)|, else |x|; atomicMax on the bits of a
// non-negative float), [2] the number of valid samples. One atomic per warp
// for each.
//
// The same call then runs the epilogue: one thread per int64 word writes the
// float32 count (n_cells,) and sums (n_cells, n_ch) that the wrapper
// returns, with the plain version's roundings (__dmul_rn/__dsub_rn: no FMA
// contraction).
//
// What bounds it on an H100: the bytes, 4 * (2 + n_ch) read per sample
// (482 MB for the 12 MP frame's taint stack, n_ch = 8: 0.144 ms at
// 3.35 TB/s). The one-sample-per-thread version it replaces issued up to
// 1 + n_ch 64-bit global atomics per valid sample; the tile histogram
// issues about that many per (tile, cell). Channels come in as float4 (or
// float2) loads where n_ch allows.

#include <cmath>

#include "bin_tile.cuh"

namespace {

using bin_tile::Box;
using bin_tile::Group;
using bin_tile::kGroup;
using bin_tile::kPasses;
using bin_tile::kThreads;
using bin_tile::kWarps;
using bin_tile::u64;

template <int VW>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = __ldg(p); }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* v) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
};

template <int VW, bool kVecIdx>
__global__ void __launch_bounds__(kThreads, bin_tile::kMinBlocks)
    k2_bin_kernel(const int32_t* __restrict__ iy,
                  const int32_t* __restrict__ ix,
                  const float* __restrict__ data, int64_t n_rows, int w,
                  int n_ch, int n_lat, int n_lon, int mode, int shift,
                  u64* __restrict__ acc, u64* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem[];
  // word j of box cell i at j * cap + i: the count (j = 0), then channel
  // c's split pair (j = 1 + 2c: low bits, 2 + 2c: the rest)
  unsigned* s_w = reinterpret_cast<unsigned*>(smem);
  __shared__ int s_box[kWarps][4];
  __shared__ u64 s_scratch[kWarps][32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int words = 1 + n_ch, s_words = 1 + 2 * n_ch;
  const long long cap = bin_tile::kSmemBytes / (4 * s_words);
  const double scale = ldexp(1.0, shift);
  const int tiles_x = (w + bin_tile::kTileCols - 1) / bin_tile::kTileCols;
  const long long n_tiles = bin_tile::n_tiles(n_rows, w);
  unsigned viol = 0, most = 0;
  u64 n_valid = 0;

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r0 = (t / tiles_x) * bin_tile::kTileRows + warp;
    const int c0 = (int)(t % tiles_x) * bin_tile::kTileCols + lane * kGroup;
    Group g[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
      bin_tile::load_group<kVecIdx>(iy, ix, n_rows, w, r0 + p * kWarps, c0,
                                    n_lat, n_lon, g[p]);
    const Box b = bin_tile::block_box(g, s_box);
    const bool fast = b.cells <= cap;
    if (b.cells > 0 && fast) {
      for (int j = 0; j < s_words; ++j)
        for (int i = threadIdx.x; i < b.cells; i += kThreads)
          s_w[j * cap + i] = 0;
      __syncthreads();
    }
    if (b.cells > 0) {
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const Group& gp = g[p];
        unsigned grp[kGroup];
        if (!fast) bin_tile::match_groups(gp, n_lon, grp);
        unsigned qc[kGroup];
        u64 q[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          qc[k] = 1;
          n_valid += gp.valid[k];
        }
        bin_tile::run_sums(gp, qc);
        if (fast) {
          if (gp.any) bin_tile::add_shared(gp, b, qc, s_w);
        } else {
#pragma unroll
          for (int k = 0; k < kGroup; ++k) q[k] = qc[k];
          bin_tile::add_global<false>(gp, grp, q, acc, words, 0, n_lon,
                                      s_scratch[warp]);
        }
        for (int cb = 0; cb < n_ch; cb += VW) {
          float v[kGroup][VW];
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            if (gp.valid[k]) {
              Vec<VW>::load(data + (gp.idx0 + k) * n_ch + cb, v[k]);
            } else {
#pragma unroll
              for (int j = 0; j < VW; ++j) v[k][j] = 0.0f;
            }
          }
#pragma unroll
          for (int j = 0; j < VW; ++j) {
            const int c = cb + j;
#pragma unroll
            for (int k = 0; k < kGroup; ++k) {
              float x = v[k][j];
              x = (x == x) ? x : 0.0f;  // NaN data at a valid coordinate adds 0
              long long qk;
              float mag = 0.0f;
              bool bad;
              if (mode == 0 && c < n_ch - 1) {
                bad = !(x >= 0.0f && x <= 255.0f && x == floorf(x));
                qk = (long long)x;
              } else if (mode == 0) {
                bad = false;
                mag = fabsf(__fadd_rn(x, 90.0f));
                qk = __double2ll_rn(
                    __dmul_rn(__dadd_rn((double)x, 90.0), scale));
              } else {
                bad = mode == 1 ? !(x >= 0.0f && x < 65536.0f)
                                : (__float_as_uint(x) & 0xFFFFu) != 0;
                mag = fabsf(x);
                qk = __double2ll_rn(__dmul_rn((double)x, scale));
              }
              if (gp.valid[k]) {
                viol |= bad;
                most = max(most, __float_as_uint(mag));
              }
              q[k] = gp.valid[k] ? (u64)qk : 0;
            }
            const bool big = bin_tile::any_big(gp, q);
            bin_tile::run_sums(gp, q);
            if (fast) {
              if (gp.any)
                bin_tile::add_shared_split(
                    gp, b, q, big, s_w + (1 + 2 * c) * cap,
                    s_w + (2 + 2 * c) * cap, acc, words, 1 + c, n_lon);
            } else {
              bin_tile::add_global<false>(gp, grp, q, acc, words, 1 + c, n_lon,
                                          s_scratch[warp]);
            }
          }
        }
      }
    }
    if (b.cells > 0 && fast) {
      __syncthreads();
      for (int i = threadIdx.x; i < b.cells; i += kThreads) {
        if (s_w[i] == 0) continue;
        u64* a = acc + bin_tile::box_cell(b, i, n_lon) * words;
        atomicAdd(a, (u64)s_w[i]);
        for (int c = 0; c < n_ch; ++c) {
          const u64 s = bin_tile::split_sum(s_w[(1 + 2 * c) * cap + i],
                                            s_w[(2 + 2 * c) * cap + i]);
          if (s) atomicAdd(a + 1 + c, s);
        }
      }
    }
    __syncthreads();  // the box and s_box are reused by the next tile
  }

  viol = __reduce_or_sync(bin_tile::kFull, viol);
  most = __reduce_max_sync(bin_tile::kFull, most);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    n_valid += __shfl_down_sync(bin_tile::kFull, n_valid, off);
  if (lane == 0) {
    if (viol) atomicOr(status, 1ull);
    if (most) atomicMax(status + 1, (u64)most);
    if (n_valid) atomicAdd(status + 2, n_valid);
  }
}

// The float32 epilogue, as ops/regrid_pallas.py::_finish computes it: one
// thread per int64 word of acc.
__global__ void k2_finish_kernel(const long long* __restrict__ acc,
                                 int64_t n_cells, int n_ch, int mode,
                                 double inv_scale, float* __restrict__ count,
                                 float* __restrict__ sums) {
  const int words = 1 + n_ch;
  const int64_t n = n_cells * words;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t cell = i / words;
    const int j = (int)(i - cell * words);
    const long long a = acc[i];
    if (j == 0) {
      count[cell] = __ll2float_rn(a);
      continue;
    }
    const int c = j - 1;
    float out;
    if (mode == 0 && c < n_ch - 1) {
      out = __ll2float_rn(a);
    } else if (mode == 0) {
      out = __double2float_rn(
          __dsub_rn(__dmul_rn(__ll2double_rn(a), inv_scale),
                    __dmul_rn(90.0, __ll2double_rn(acc[cell * words]))));
    } else {
      out = __double2float_rn(__dmul_rn(__ll2double_rn(a), inv_scale));
    }
    sums[cell * n_ch + c] = out;
  }
}

bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <int VW, bool kVecIdx>
int launch_bin(const void* iy, const void* ix, const void* data,
               long long n_rows, int w, int n_ch, int n_lat, int n_lon,
               int mode, int shift, void* acc, void* status,
               cudaStream_t s) {
  auto kernel = &k2_bin_kernel<VW, kVecIdx>;
  long long blocks = 0;
  cudaError_t err = bin_tile::persistent_blocks(
      kernel, bin_tile::kSmemBytes, bin_tile::n_tiles(n_rows, w), &blocks);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, bin_tile::kSmemBytes, s>>>(
      (const int32_t*)iy, (const int32_t*)ix, (const float*)data,
      (int64_t)n_rows, w, n_ch, n_lat, n_lon, mode, shift, (u64*)acc,
      (u64*)status);
  return (int)cudaGetLastError();
}

template <int VW>
int launch_bin_vw(bool vec_idx, const void* iy, const void* ix,
                  const void* data, long long n_rows, int w, int n_ch,
                  int n_lat, int n_lon, int mode, int shift, void* acc,
                  void* status, cudaStream_t s) {
  return vec_idx ? launch_bin<VW, true>(iy, ix, data, n_rows, w, n_ch, n_lat,
                                        n_lon, mode, shift, acc, status, s)
                 : launch_bin<VW, false>(iy, ix, data, n_rows, w, n_ch, n_lat,
                                         n_lon, mode, shift, acc, status, s);
}

}  // namespace

// Plain C entry point for ctypes. Adds the samples of the (n_rows, w) plane
// (data: (n_rows, w, n_ch) float32) into `acc` ((n_lat * n_lon, 1 + n_ch)
// int64, zeroed by the caller), writes the checks into `status` (three
// int64, zeroed by the caller) and the float32 `count` (n_cells,) and `sums`
// (n_cells, n_ch). Launches on `stream` and returns the cudaGetLastError()
// code (0 = launched).
extern "C" int regrid_bin_launch(const void* iy, const void* ix,
                                 const void* data, long long n_rows, int w,
                                 int n_ch, int n_lat, int n_lon, int mode,
                                 int shift, void* acc, void* status,
                                 void* count, void* sums, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rows > 0 && w > 0 && n_ch > 0) {
    const bool vec_idx = w % kGroup == 0 && aligned(iy, 16) && aligned(ix, 16);
    int rc;
    if (n_ch % 4 == 0 && aligned(data, 16))
      rc = launch_bin_vw<4>(vec_idx, iy, ix, data, n_rows, w, n_ch, n_lat,
                            n_lon, mode, shift, acc, status, s);
    else if (n_ch % 2 == 0 && aligned(data, 8))
      rc = launch_bin_vw<2>(vec_idx, iy, ix, data, n_rows, w, n_ch, n_lat,
                            n_lon, mode, shift, acc, status, s);
    else
      rc = launch_bin_vw<1>(vec_idx, iy, ix, data, n_rows, w, n_ch, n_lat,
                            n_lon, mode, shift, acc, status, s);
    if (rc != 0) return rc;
  }
  const int64_t n_cells = (int64_t)n_lat * n_lon;
  const long long n = n_cells * (1 + n_ch);
  if (n > 0) {
    const long long blocks = (n + 255) / 256 < 8192 ? (n + 255) / 256 : 8192;
    k2_finish_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        (const long long*)acc, n_cells, n_ch, mode, ldexp(1.0, -shift),
        (float*)count, (float*)sums);
  }
  return (int)cudaGetLastError();
}
