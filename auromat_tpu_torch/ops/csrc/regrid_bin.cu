// K2 (and K3): per-cell (count, n_ch channel sums) binning of samples with
// precomputed bin indices into a fixed plate-carree grid.
//
// Replaces auromat_tpu/ops/regrid_pallas.py::_kernel_cw (K2, driven by
// bin_partial_pallas_cw) and ::_kernel (K3, driven by bin_partial_pallas).
// Those Pallas kernels build bf16 one-hot matrices and contract them on the
// TPU's matrix unit, windowed over grid rows and 128-wide column blocks
// (K3: the whole grid width), because the TPU serializes scatter-adds; to
// keep the bf16 products exact they split channels into limbs (elevation
// into integer + two fraction limbs, 'full' channels into base-256
// digits). Both compute one contract, so both land on this one kernel: one
// thread per sample in a grid-stride loop, skipping invalid samples (iy < 0
// or outside the grid), zeroing NaN data, and adding into the grid with
// 64-bit INTEGER atomics. The limb splits become integer arithmetic:
//   mode 0 ('uint8'): channels 0..n_ch-2 hold integers 0..255 and add as
//       they are; the last channel (elevation) adds round((x + 90) * 2^30)
//       in double, rounded to nearest even (K1's fixed point);
//   mode 1 ('full', values in [0, 65536)) and mode 2 ('raw', bf16-exact
//       values): every channel adds round(x * 2^shift) as a signed integer.
// acc is (n_cells, 1 + n_ch) uint64 holding two's-complement int64 sums:
// [count, channel sums]. The wrapper bounds the inputs so that no cell sum
// can overflow int64. Integer atomics make the sums independent of the
// order the threads run in, so the result is bit-reproducible and equal to
// the plain PyTorch version (ops/regrid_pallas.py::bin_partial_cw_plain),
// which uses the same arithmetic. The wrapper turns the sums into floats.
//
// What bounds it on an H100: the atomics, 1 + n_ch per valid sample (a zero
// term is skipped, which drops most of the taint channels of
// bin_mean_pallas_taint), contended where neighbouring pixels share a cell
// (a 12 MP frame puts ~56 samples into each cell of a ~100 arcsec grid).
// The 4 * (2 + n_ch) bytes read per sample come second. Later work:
// warp-aggregated atomics and shared-memory tile histograms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void regrid_bin_kernel(const int32_t* __restrict__ iy,
                                  const int32_t* __restrict__ ix,
                                  const float* __restrict__ data,
                                  int64_t n, int32_t n_ch, int32_t n_lat,
                                  int32_t n_lon, int32_t mode, int32_t shift,
                                  unsigned long long* __restrict__ acc) {
  const double scale = ldexp(1.0, shift);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t y = iy[i];
    const int32_t x = ix[i];
    if (y < 0 || y >= n_lat || x < 0 || x >= n_lon) continue;
    unsigned long long* a = acc + ((int64_t)y * n_lon + x) * (1 + n_ch);
    atomicAdd(a, 1ull);
    const float* d = data + i * n_ch;
    for (int32_t c = 0; c < n_ch; ++c) {
      float v = d[c];
      v = (v == v) ? v : 0.0f;  // NaN data at a valid coordinate adds 0
      long long q;
      if (mode == 0) {
        q = (c < n_ch - 1)
                ? (long long)v
                : __double2ll_rn(__dmul_rn(__dadd_rn((double)v, 90.0),
                                           1073741824.0));
      } else {
        q = __double2ll_rn(__dmul_rn((double)v, scale));
      }
      if (q != 0) atomicAdd(a + 1 + c, (unsigned long long)q);
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns the
// cudaGetLastError() code of the launch (0 = launched).
extern "C" int regrid_bin_launch(const void* iy, const void* ix,
                                 const void* data, long long n, int n_ch,
                                 int n_lat, int n_lon, int mode, int shift,
                                 void* acc, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = (long long)(n_sm > 0 ? n_sm : 1) * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  regrid_bin_kernel<<<(unsigned int)blocks, threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)iy, (const int32_t*)ix, (const float*)data, (int64_t)n,
      (int32_t)n_ch, (int32_t)n_lat, (int32_t)n_lon, (int32_t)mode,
      (int32_t)shift, (unsigned long long*)acc);
  return (int)cudaGetLastError();
}
