// K1: per-cell (count, sum R, sum G, sum B, sum elevation) binning of one
// frame's samples into a fixed plate-carree grid.
//
// Replaces auromat_tpu/ops/georegrid.py::_kernel (the Pallas TPU kernel
// driven by bin_rgbelev_from_indices). That kernel builds bf16 one-hot
// matrices and contracts them on the TPU's matrix unit, windowed over grid
// rows and 128-wide column blocks, because the TPU serializes scatter-adds.
// This kernel computes the same contract the direct way: one thread per
// pixel in a grid-stride loop, skipping invalid samples (iy < 0 or outside
// the grid), zeroing NaN data, and adding into the grid with global
// INTEGER atomics:
//   acc[cell * 4 + 0..3]  uint32  count, R, G, B (integral 0..255 data;
//                                  the wrapper bounds h*w*255 < 2^32)
//   elev_acc[cell]        uint64  sum of (elev + 90) in fixed point at
//                                  scale 2^30, each sample rounded to
//                                  nearest even in double; a sample is
//                                  < 180 * 2^30 < 2^38, so 2^24 samples
//                                  cannot overflow
// Integer atomics make the sums independent of the order the threads run
// in, so the result is bit-reproducible and equal to the plain PyTorch
// version (ops/georegrid.py::bin_rgbelev_plain), which uses the same
// arithmetic. The wrapper turns the integer sums into the f32 outputs.
//
// K1-i8 (georegrid_bin_i8_launch) replaces the JAX package's
// compute='i8' variant, ops/georegrid.py::_kernel_i8, which runs the same
// binning through the TPU's int8 matrix path and carries elevation as
// floor-quantized base-256 limbs. It is this kernel with one change, a
// template mode: the elevation term is floor(fl32(e + 90) * 2^16), the add
// done in float32 and the product floored, not rounded, exactly as
// _kernel_i8 quantizes (a double add, or a rounding, would move samples by
// one 2^-16 quantum). Each term is < 180 * 2^16 < 2^24.
//
// What bounds it on an H100: the atomics, five per valid sample, where
// neighbouring pixels share a cell. The 12 MP ISS frame puts 7.03 M
// samples into 126,585 cells of the 539x524 grid (~56 a cell, ~7 pixels
// across), so the 32 lanes of a warp land on only four or five cells.
// The 24 bytes read per pixel (289 MB a frame, ~0.09 ms at 3.35 TB/s)
// come second. Later work: warp-aggregated atomics (reduce lanes with
// equal cells before one atomic) and shared-memory tile histograms
// flushed once per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kI8>
__global__ void georegrid_bin_kernel(const int32_t* __restrict__ iy,
                                     const int32_t* __restrict__ ix,
                                     const float* __restrict__ img,
                                     const float* __restrict__ elev,
                                     int64_t n, int32_t n_lat, int32_t n_lon,
                                     unsigned int* __restrict__ acc,
                                     unsigned long long* __restrict__ elev_acc) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t y = iy[i];
    const int32_t x = ix[i];
    if (y < 0 || y >= n_lat || x < 0 || x >= n_lon) continue;
    const int64_t cell = (int64_t)y * n_lon + x;
    float r = img[i], g = img[n + i], b = img[2 * n + i], e = elev[i];
    // NaN data at a valid coordinate contributes 0 (the K1 contract)
    r = (r == r) ? r : 0.0f;
    g = (g == g) ? g : 0.0f;
    b = (b == b) ? b : 0.0f;
    e = (e == e) ? e : 0.0f;
    unsigned int* a = acc + cell * 4;
    atomicAdd(a + 0, 1u);
    atomicAdd(a + 1, (unsigned int)r);
    atomicAdd(a + 2, (unsigned int)g);
    atomicAdd(a + 3, (unsigned int)b);
    long long q;
    if (kI8) {
      // float32 add, exact product by 2^16, floor (the _kernel_i8 limbs)
      q = (long long)floorf(__fmul_rn(__fadd_rn(e, 90.0f), 65536.0f));
    } else {
      // (e + 90) * 2^30 is exact in double; __double2ll_rn rounds to
      // nearest even like torch.round
      q = __double2ll_rn(((double)e + 90.0) * 1073741824.0);
    }
    atomicAdd(elev_acc + cell, (unsigned long long)q);
  }
}

template <bool kI8>
int launch(const void* iy, const void* ix, const void* img, const void* elev,
           long long n, int n_lat, int n_lon, void* acc, void* elev_acc,
           void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = (long long)(n_sm > 0 ? n_sm : 1) * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  georegrid_bin_kernel<kI8><<<(unsigned int)blocks, threads, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)iy, (const int32_t*)ix, (const float*)img,
      (const float*)elev, (int64_t)n, (int32_t)n_lat, (int32_t)n_lon,
      (unsigned int*)acc, (unsigned long long*)elev_acc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes (K1 and K1-i8). Each launches on `stream`
// and returns the cudaGetLastError() code of the launch (0 = launched).
extern "C" int georegrid_bin_launch(const void* iy, const void* ix,
                                    const void* img, const void* elev,
                                    long long n, int n_lat, int n_lon,
                                    void* acc, void* elev_acc, void* stream) {
  return launch<false>(iy, ix, img, elev, n, n_lat, n_lon, acc, elev_acc,
                       stream);
}

extern "C" int georegrid_bin_i8_launch(const void* iy, const void* ix,
                                       const void* img, const void* elev,
                                       long long n, int n_lat, int n_lon,
                                       void* acc, void* elev_acc,
                                       void* stream) {
  return launch<true>(iy, ix, img, elev, n, n_lat, n_lon, acc, elev_acc,
                      stream);
}
