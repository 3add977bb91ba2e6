// K1: per-cell (count, sum R, sum G, sum B, sum elevation) binning of a
// frame's samples (or a burst of frames stacked along the rows) into a fixed
// plate-carree grid, and its fused float32 epilogue.
//
// Replaces auromat_tpu/ops/georegrid.py::_kernel (the Pallas TPU kernel
// driven by bin_rgbelev_from_indices). That kernel builds bf16 one-hot
// matrices and contracts them on the TPU's matrix unit, windowed over grid
// rows and 128-wide column blocks, because the TPU serializes scatter-adds.
// This kernel computes the same contract as shared-memory tile histograms
// (bin_tile.cuh): invalid samples (iy < 0 or outside the grid) are skipped,
// NaN data at a valid coordinate adds 0, and every sum is an integer:
//   count, R, G, B  uint32 words in shared memory (a tile holds 4096
//                   samples of at most 255), int64 in device memory
//   elevation       sum of (elev + 90) in fixed point at scale 2^30, each
//                   sample rounded to nearest even in double; a sample is
//                   < 180 * 2^30 < 2^38, so it adds as a split pair of
//                   uint32 words in shared memory
// Integer sums do not depend on the order of the atomics, so the result is
// bit-reproducible and equal to the plain PyTorch version
// (ops/georegrid.py::bin_rgbelev_plain), which uses the same arithmetic.
// The accumulators are the int64 sums of bin_rgbelev_int (the mosaic adds
// them across bursts and ranks); the count word's atomics return the old
// value, and any cell whose count passes MAX_CELL_COUNT (ops/georegrid.py)
// raises the status word to its count, which the wrapper reads once.
//
// With output pointers, the same call runs the epilogue: one thread per cell
// reads the integer sums once and writes the float32 count and (R, G, B,
// elevation) sums that bin_rgbelev_from_indices returns, with the plain
// version's roundings: count and R/G/B int64 -> float32, elevation as
// fl32(fl64(fl64(e) * 2^-s) - fl64(90 * count)) with __dmul_rn/__dsub_rn, so
// that no FMA contraction moves a bit.
//
// K1-i8 (georegrid_bin_i8_launch) replaces the JAX package's compute='i8'
// variant, ops/georegrid.py::_kernel_i8, which runs the same binning
// through the TPU's int8 matrix path and carries elevation as
// floor-quantized base-256 limbs. It is this kernel with one change, a
// template mode: the elevation term is floor(fl32(e + 90) * 2^16), the add
// done in float32 and the product floored, exactly as _kernel_i8 quantizes.
//
// What bounds it on an H100: the bytes, 24 read per sample (289 MB for the
// 12 MP frame, 0.086 ms at 3.35 TB/s). The one-sample-per-thread version it
// replaces issued five global atomics per valid sample, which serialised at
// L2 where neighbouring pixels share a cell (~56 samples a cell, ~7 pixels
// across, on the 539x524 grid); the tile histogram issues about five per
// (tile, cell).

#include "bin_tile.cuh"

namespace {

using bin_tile::Box;
using bin_tile::Group;
using bin_tile::kGroup;
using bin_tile::kPasses;
using bin_tile::kThreads;
using bin_tile::kWarps;
using bin_tile::u64;

constexpr int kBoxCap = bin_tile::kSmemBytes / 24;  // 6 uint32 words a cell
constexpr u64 kMaxCellCount = 0xFFFFFFFFull / 255;  // MAX_CELL_COUNT

// the four data values of a group, NaN -> 0
template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ p,
                                      const Group& g, float (&v)[kGroup]) {
  if (kVec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + g.idx0));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      v[k] = g.valid[k] ? __ldg(p + g.idx0 + k) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k) v[k] = (v[k] == v[k]) ? v[k] : 0.0f;
}

template <bool kI8>
__device__ __forceinline__ u64 elev_term(float e) {
  if (kI8)  // float32 add, exact product by 2^16, floor (the _kernel_i8 limbs)
    return (u64)(long long)floorf(__fmul_rn(__fadd_rn(e, 90.0f), 65536.0f));
  // (e + 90) rounded once in double, times 2^30 exactly, to nearest even
  return (u64)__double2ll_rn(
      __dmul_rn(__dadd_rn((double)e, 90.0), 1073741824.0));
}

template <bool kI8, bool kVec>
__global__ void __launch_bounds__(kThreads, bin_tile::kMinBlocks)
    k1_bin_kernel(const int32_t* __restrict__ iy,
                  const int32_t* __restrict__ ix,
                  const float* __restrict__ img,
                  const float* __restrict__ elev, int64_t n_rows, int w,
                  int n_lat, int n_lon, u64* __restrict__ acc,
                  u64* __restrict__ elev_acc, u64* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* s_c = reinterpret_cast<unsigned*>(smem);
  unsigned* s_rgb[3] = {s_c + kBoxCap, s_c + 2 * kBoxCap, s_c + 3 * kBoxCap};
  unsigned* s_elo = s_c + 4 * kBoxCap;  // the elevation's split pair
  unsigned* s_ehi = s_c + 5 * kBoxCap;
  __shared__ int s_box[kWarps][4];
  __shared__ u64 s_scratch[kWarps][32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = n_rows * w;
  const int tiles_x = (w + bin_tile::kTileCols - 1) / bin_tile::kTileCols;
  const long long n_tiles = bin_tile::n_tiles(n_rows, w);
  const float* plane[3] = {img, img + n, img + 2 * n};

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r0 = (t / tiles_x) * bin_tile::kTileRows + warp;
    const int c0 = (int)(t % tiles_x) * bin_tile::kTileCols + lane * kGroup;
    Group g[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
      bin_tile::load_group<kVec>(iy, ix, n_rows, w, r0 + p * kWarps, c0,
                                 n_lat, n_lon, g[p]);
    const Box b = bin_tile::block_box(g, s_box);
    const bool fast = b.cells <= kBoxCap;
    if (b.cells > 0 && fast) {
      for (int i = threadIdx.x; i < b.cells; i += kThreads)
        s_c[i] = s_rgb[0][i] = s_rgb[1][i] = s_rgb[2][i] = s_elo[i] =
            s_ehi[i] = 0;
      __syncthreads();
    }
    if (b.cells > 0) {
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const Group& gp = g[p];
        float v[3][kGroup], e[kGroup];
        if (gp.any) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            load4<kVec>(plane[ch], gp, v[ch]);
          load4<kVec>(elev, gp, e);
        }
        u64 qe[kGroup];
        unsigned qc[kGroup], qrgb[3][kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          qc[k] = 1u;
          qe[k] = gp.valid[k] ? elev_term<kI8>(e[k]) : 0;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            qrgb[ch][k] = gp.valid[k] ? (unsigned)v[ch][k] : 0u;
        }
        const bool big = bin_tile::any_big(gp, qe);
        bin_tile::run_sums(gp, qc);
        bin_tile::run_sums(gp, qe);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) bin_tile::run_sums(gp, qrgb[ch]);
        if (fast) {
          if (gp.any) {
            bin_tile::add_shared(gp, b, qc, s_c);
#pragma unroll
            for (int ch = 0; ch < 3; ++ch)
              bin_tile::add_shared(gp, b, qrgb[ch], s_rgb[ch]);
            bin_tile::add_shared_split(gp, b, qe, big, s_elo, s_ehi,
                                       elev_acc, 1, 0, n_lon);
          }
        } else {  // every lane of the warp takes part
          unsigned grp[kGroup];
          bin_tile::match_groups(gp, n_lon, grp);
          u64 q[kGroup];
#pragma unroll
          for (int k = 0; k < kGroup; ++k) q[k] = qc[k];
          bin_tile::add_global<true>(gp, grp, q, acc, 4, 0, n_lon,
                                     s_scratch[warp], kMaxCellCount, status);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
            for (int k = 0; k < kGroup; ++k) q[k] = qrgb[ch][k];
            bin_tile::add_global<false>(gp, grp, q, acc, 4, 1 + ch, n_lon,
                                        s_scratch[warp]);
          }
          bin_tile::add_global<false>(gp, grp, qe, elev_acc, 1, 0, n_lon,
                                      s_scratch[warp]);
        }
      }
    }
    if (b.cells > 0 && fast) {
      __syncthreads();
      for (int i = threadIdx.x; i < b.cells; i += kThreads) {
        const unsigned c = s_c[i];
        if (c == 0) continue;
        const int64_t cell = bin_tile::box_cell(b, i, n_lon);
        u64* a = acc + cell * 4;
        const u64 now = atomicAdd(a, (u64)c) + c;
        if (now > kMaxCellCount) atomicMax(status, now);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          if (s_rgb[ch][i]) atomicAdd(a + 1 + ch, (u64)s_rgb[ch][i]);
        const u64 e = bin_tile::split_sum(s_elo[i], s_ehi[i]);
        if (e) atomicAdd(elev_acc + cell, e);
      }
    }
    __syncthreads();  // the box and s_box are reused by the next tile
  }
}

// The float32 epilogue: count (n_cells,) and sums (n_cells, 4) from the
// int64 sums, as ops/georegrid.py::finish_int_sums computes them.
__global__ void k1_finish_kernel(const long long* __restrict__ acc,
                                 const long long* __restrict__ elev_acc,
                                 int64_t n_cells, double inv_scale,
                                 float* __restrict__ count,
                                 float* __restrict__ sums) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_cells; i += stride) {
    const longlong2 cr = reinterpret_cast<const longlong2*>(acc)[2 * i];
    const longlong2 gb = reinterpret_cast<const longlong2*>(acc)[2 * i + 1];
    const double el =
        __dsub_rn(__dmul_rn(__ll2double_rn(elev_acc[i]), inv_scale),
                  __dmul_rn(90.0, __ll2double_rn(cr.x)));
    count[i] = __ll2float_rn(cr.x);
    reinterpret_cast<float4*>(sums)[i] =
        make_float4(__ll2float_rn(cr.y), __ll2float_rn(gb.x),
                    __ll2float_rn(gb.y), __double2float_rn(el));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kI8>
int launch(const void* iy, const void* ix, const void* img, const void* elev,
           long long n_rows, int w, int n_lat, int n_lon, void* acc,
           void* elev_acc, void* status, void* count, void* sums,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_tiles = bin_tile::n_tiles(n_rows, w);
  if (n_rows > 0 && w > 0) {
    const bool vec = w % kGroup == 0 && aligned16(iy) && aligned16(ix) &&
                     aligned16(img) && aligned16(elev);
    auto kernel = vec ? &k1_bin_kernel<kI8, true> : &k1_bin_kernel<kI8, false>;
    long long blocks = 0;
    cudaError_t err = bin_tile::persistent_blocks(kernel, bin_tile::kSmemBytes,
                                                  n_tiles, &blocks);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)blocks, kThreads, bin_tile::kSmemBytes, s>>>(
        (const int32_t*)iy, (const int32_t*)ix, (const float*)img,
        (const float*)elev, (int64_t)n_rows, w, n_lat, n_lon, (u64*)acc,
        (u64*)elev_acc, (u64*)status);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t n_cells = (int64_t)n_lat * n_lon;
  if (count != nullptr && n_cells > 0) {
    const long long blocks = (n_cells + 255) / 256 < 4096
                                 ? (n_cells + 255) / 256 : 4096;
    k1_finish_kernel<<<(unsigned)blocks, 256, 0, s>>>(
        (const long long*)acc, (const long long*)elev_acc, n_cells,
        kI8 ? 1.0 / 65536.0 : 1.0 / 1073741824.0, (float*)count,
        (float*)sums);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes (K1 and K1-i8). Each adds the samples of
// the (n_rows, w) plane into `acc` ((n_lat * n_lon, 4) int64 [count, R, G,
// B]) and `elev_acc` ((n_lat * n_lon,) int64), raises `status` (one int64,
// zeroed by the caller) to the count of any cell past MAX_CELL_COUNT, and,
// when `count` is not null, writes the float32 `count` (n_cells,) and `sums`
// (n_cells, 4). Launches on `stream` and returns the cudaGetLastError() code
// (0 = launched).
extern "C" int georegrid_bin_launch(const void* iy, const void* ix,
                                    const void* img, const void* elev,
                                    long long n_rows, int w, int n_lat,
                                    int n_lon, void* acc, void* elev_acc,
                                    void* status, void* count, void* sums,
                                    void* stream) {
  return launch<false>(iy, ix, img, elev, n_rows, w, n_lat, n_lon, acc,
                       elev_acc, status, count, sums, stream);
}

extern "C" int georegrid_bin_i8_launch(const void* iy, const void* ix,
                                       const void* img, const void* elev,
                                       long long n_rows, int w, int n_lat,
                                       int n_lon, void* acc, void* elev_acc,
                                       void* status, void* count, void* sums,
                                       void* stream) {
  return launch<true>(iy, ix, img, elev, n_rows, w, n_lat, n_lon, acc,
                      elev_acc, status, count, sums, stream);
}
