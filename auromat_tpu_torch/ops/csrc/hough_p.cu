// OpenCV's probabilistic Hough transform (cv2.HoughLinesP) for sm_90a.
//
// Replaces no TPU kernel: the JAX package calls cv2.HoughLinesP on the
// host (auromat_tpu/solving/masking.py::mask_starfield). Plain version:
// auromat_tpu_torch/solving/masking.py::_hough_p_plain, in the same
// arithmetic, so the two give the same lines in the same order.
//
// The algorithm is sequential: each set pixel, in a fixed pseudo-random
// order, votes into the accumulator, and a vote that reaches the threshold
// walks the line, clears its pixels from the mask and (for a line long
// enough to keep) takes their votes back, which changes what every later
// pixel sees. So one block walks the whole order:
//   - the order (OpenCV's RNG; it depends on the count of set pixels only)
//     comes from the host as (x, y) pairs, read CHUNK at a time into
//     shared memory;
//   - thread n votes angle n: acc[n][rint(x c_n + y s_n) + (numrho-1)/2]
//     with __fmul_rn/__fadd_rn (no contraction into an fma: OpenCV rounds
//     the product and the sum), so the votes are OpenCV's;
//   - the first maximum over the angles: a warp-shuffle max of
//     (votes << 8 | 255 - n), so a tie keeps the smallest n, then the six
//     warps' results through shared memory (double-buffered: one
//     __syncthreads a vote);
//   - warp 0 walks: lanes 0 and 1 the two directions of the gap-limited
//     walk in parallel, then the whole warp the clearing walk, pixel by
//     pixel, each lane taking back the votes of every 32nd angle.
// What bounds it: latency. One dependent step a candidate pixel (a mask
// read, one L2 read-modify-write a thread, a block reduction), and the
// accumulator (numangle x numrho int32, 10.2 MB at 4256x2832) and the mask
// (12 MB) stay in the 50 MB L2. The bytes it must move (the order, the
// mask, the lines) take ~0.01 ms at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 192;  // >= numangle (180 at theta = pi/180)
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 2048;
constexpr int SHIFT = 16;

__device__ __forceinline__ int vote_bin(int x, int y, float c, float s) {
  return __float2int_rn(__fadd_rn(__fmul_rn((float)x, c), __fmul_rn((float)y, s)));
}

__global__ void __launch_bounds__(THREADS, 1)
hough_p_kernel(const int* __restrict__ pts, int count, unsigned char* mask,
               int width, int height, int* acc, int numangle, int numrho,
               const float* __restrict__ trig, int threshold, int line_length,
               int line_gap, int* lines, int* n_lines) {
  __shared__ float s_cos[THREADS], s_sin[THREADS];
  __shared__ int s_x[CHUNK], s_y[CHUNK];
  __shared__ int s_key[2][WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = (numrho - 1) / 2;
  if (tid < numangle) {
    s_cos[tid] = trig[tid];
    s_sin[tid] = trig[numangle + tid];
  }
  int* row = acc + (size_t)min(tid, numangle - 1) * numrho + half;
  int nl = 0, parity = 0;

  for (int base = 0; base < count; base += CHUNK) {
    const int m = min(CHUNK, count - base);
    __syncthreads();  // the previous chunk is read by everyone
    for (int i = tid; i < m; i += THREADS) {
      s_x[i] = pts[2 * (base + i)];
      s_y[i] = pts[2 * (base + i) + 1];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const int x = s_x[j], y = s_y[j];
      if (!mask[(size_t)y * width + x]) continue;  // taken by a line

      int key = -1;
      if (tid < numangle) {
        const int val = ++row[vote_bin(x, y, s_cos[tid], s_sin[tid])];
        key = (val << 8) | (255 - tid);
      }
      for (int o = 16; o; o >>= 1) key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
      if (lane == 0) s_key[parity][warp] = key;
      __syncthreads();
      int best = s_key[parity][0];
      for (int w = 1; w < WARPS; ++w) best = max(best, s_key[parity][w]);
      parity ^= 1;
      if ((best >> 8) < threshold) continue;  // uniform over the block
      if (warp == 0) {
        const int n = 255 - (best & 255);
        const float a = -s_sin[n], b = s_cos[n];
        const float one = (float)(1 << SHIFT);
        int x0 = x, y0 = y, dx0, dy0;
        const bool xflag = fabsf(a) > fabsf(b);
        if (xflag) {
          dx0 = a > 0 ? 1 : -1;
          dy0 = __float2int_rn(__fdiv_rn(__fmul_rn(b, one), fabsf(a)));
          y0 = (y0 << SHIFT) + (1 << (SHIFT - 1));
        } else {
          dy0 = b > 0 ? 1 : -1;
          dx0 = __float2int_rn(__fdiv_rn(__fmul_rn(a, one), fabsf(b)));
          x0 = (x0 << SHIFT) + (1 << (SHIFT - 1));
        }
        // the gap-limited walks: lane k walks direction k
        int ex = -1, ey = -1;
        if (lane < 2) {
          int px = x0, py = y0, gap = 0;
          const int ddx = lane ? -dx0 : dx0, ddy = lane ? -dy0 : dy0;
          for (;; px += ddx, py += ddy) {
            const int j1 = xflag ? px : px >> SHIFT;
            const int i1 = xflag ? py >> SHIFT : py;
            if (j1 < 0 || j1 >= width || i1 < 0 || i1 >= height) break;
            if (mask[(size_t)i1 * width + j1]) {
              gap = 0;
              ex = j1;
              ey = i1;
            } else if (++gap > line_gap) {
              break;
            }
          }
        }
        const int ex0 = __shfl_sync(0xffffffffu, ex, 0), ey0 = __shfl_sync(0xffffffffu, ey, 0);
        const int ex1 = __shfl_sync(0xffffffffu, ex, 1), ey1 = __shfl_sync(0xffffffffu, ey, 1);
        const bool good = abs(ex1 - ex0) >= line_length || abs(ey1 - ey0) >= line_length;
        // the clearing walks, one after the other, the warp in step
        for (int k = 0; k < 2; ++k) {
          const int ddx = k ? -dx0 : dx0, ddy = k ? -dy0 : dy0;
          const int endx = k ? ex1 : ex0, endy = k ? ey1 : ey0;
          for (int px = x0, py = y0;; px += ddx, py += ddy) {
            const int j1 = xflag ? px : px >> SHIFT;
            const int i1 = xflag ? py >> SHIFT : py;
            unsigned char* p = mask + (size_t)i1 * width + j1;
            const bool set = *p != 0;
            __syncwarp();
            if (set) {
              if (good) {
                for (int a2 = lane; a2 < numangle; a2 += 32)
                  acc[(size_t)a2 * numrho + half + vote_bin(j1, i1, s_cos[a2], s_sin[a2])]--;
              }
              if (lane == 0) *p = 0;
            }
            __syncwarp();
            if (i1 == endy && j1 == endx) break;
          }
        }
        if (good) {
          if (lane == 0) reinterpret_cast<int4*>(lines)[nl] = make_int4(ex0, ey0, ex1, ey1);
          ++nl;  // every lane of warp 0 counts alike; thread 0 stores it
        }
      }
      __syncthreads();  // the walks' mask and votes are seen by all
    }
  }
  if (tid == 0) *n_lines = nl;
}

}  // namespace

extern "C" int hough_p_launch(const int* pts, int count, unsigned char* mask,
                              int width, int height, int* acc, int numangle,
                              int numrho, const float* trig, int threshold,
                              int line_length, int line_gap, int* lines,
                              int* n_lines, void* stream) {
  if (numangle < 1 || numangle > THREADS) return (int)cudaErrorInvalidValue;
  hough_p_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      pts, count, mask, width, height, acc, numangle, numrho, trig, threshold,
      line_length, line_gap, lines, n_lines);
  return (int)cudaGetLastError();
}
