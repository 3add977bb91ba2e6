// The visit order of OpenCV's probabilistic Hough transform
// (cv2.HoughLinesP), drawn on the card for sm_90a.
//
// Replaces no TPU kernel: the JAX package calls cv2.HoughLinesP on the
// host (auromat_tpu/solving/masking.py::mask_starfield), and the order
// was a host loop. Plain versions: auromat_tpu_torch/solving/masking.py
// ::_hough_order (one draw at a time) and ::_hough_order_chains of
// ::_hough_draws (this kernel's two steps in numpy).
//
// OpenCV visits the `count` set pixels in the order of its RNG: a
// multiply-with-carry state s (2^64-1 at the start), one step
// s -> (s & 0xffffffff) c + (s >> 32) with c = 4164903690, draws
// idx_k = (s_(k+1) & 0xffffffff) % (count - k), outputs slot idx_k of a
// permutation and moves the last slot (count-1-k) into it. Both parts are
// sequential on the host; here they are parallel and exact:
//   - draws: a step multiplies s by 2^-32 modulo m = c 2^32 - 1, and
//     every state after s_1 lies below m, so s_n = (2^-32)^(n-1) s_1
//     mod m. Each thread jumps to the start of its SEG draws with one
//     modular power (Montgomery products, R = 2^96: a 64x64 -> 128-bit
//     product through __umul64hi, reduced by three MWC steps, each a
//     division by 2^32 modulo m) and then runs the plain recurrence;
//   - the permutation: output k is the value in slot idx_k at step k,
//     which is the slot's own index unless an earlier step j wrote it
//     (idx_j == idx_k != count-1-j); then it is what slot count-1-j held
//     at step j, for the last such j, and so on back in time (at 910,556
//     pixels: at most 18 hops, 1.0 on average). The writes are grouped by
//     slot with a counting sort (a histogram of the draws, an exclusive
//     scan, a scatter), and one thread an output follows its chain,
//     taking at each hop the latest write before its time from its slot's
//     bucket (a linear pass: a bucket holds ln(count/slot) writes on
//     average; the order inside a bucket does not matter).
// What bounds it: latency of a few dependent passes (six launches, each
// over the count); the output's bytes (8 a pixel) take ~2 us at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr u64 COEFF = 4164903690ull;
constexpr u64 MOD = COEFF * (1ull << 32) - 1;       // m
constexpr u64 S1 = (COEFF + 1) * 0xffffffffull;     // after one step, >= m
constexpr u64 M32 = 0xffffffffull;
constexpr int SEG = 32;         // draws a thread
constexpr int SCAN_THREADS = 1024;
constexpr int PER = 8;          // scan elements a thread
constexpr int TILE = SCAN_THREADS * PER;

__device__ __forceinline__ u64 mwc_step(u64 s) { return (s & M32) * COEFF + (s >> 32); }

// a b 2^-96 modulo m, below 2^64 (not always below m), for a, b < 2^64
__device__ __forceinline__ u64 mont(u64 a, u64 b) {
  u64 lo = a * b, hi = __umul64hi(a, b);
  for (int r = 0; r < 3; ++r) {  // x -> (x & M32) c + (x >> 32) = x 2^-32 mod m
    const u64 t = (lo & M32) * COEFF;
    const u64 nlo = (hi << 32) | (lo >> 32);
    hi >>= 32;
    lo = nlo + t;
    hi += lo < t;
  }
  return lo;  // hi is 0: the three steps bring any 128-bit x below 2^64
}

// s_n, the state after n >= 2 steps: (2^-32)^(n-1) s_1 mod m
__device__ u64 mwc_state(u64 n) {
  u64 x = S1, t = 0ull - MOD;  // t = 2^64 mod m = 2^-32 R mod m
  for (u64 e = n - 1; e; e >>= 1) {
    if (e & 1) x = mont(x, t);  // x 2^(-32 2^i)
    t = mont(t, t);             // 2^(-32 2^(i+1)) R
  }
  return x >= MOD ? x - MOD : x;
}

__global__ void draws_kernel(int count, int* __restrict__ draws, int* __restrict__ hist) {
  const long long k0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * SEG;
  if (k0 >= count) return;
  u64 s = k0 == 0 ? S1 : mwc_state((u64)k0 + 1);  // s_(k0+1)
  const int kend = (int)min(k0 + SEG, (long long)count);
  for (int k = (int)k0; k < kend; ++k) {
    const unsigned c = (unsigned)(count - k);
    const int d = (int)((unsigned)(s & M32) % c);
    draws[k] = d;
    if ((unsigned)d != c - 1) atomicAdd(hist + d, 1);  // a write into slot d
    s = mwc_step(s);
  }
}

// exclusive scan of v over the block; *total gets the block's sum
__device__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  const int out = (warp ? s_warp[warp - 1] : 0) + x - v;
  *total = s_warp[31];
  __syncthreads();  // s_warp is reused
  return out;
}

__global__ void __launch_bounds__(SCAN_THREADS)
tile_sums_kernel(const int* __restrict__ in, int n, int* __restrict__ sums) {
  __shared__ int s_warp[32];
  const long long base = (long long)blockIdx.x * TILE + threadIdx.x * PER;
  int v = 0;
  for (int i = 0; i < PER; ++i)
    if (base + i < n) v += in[base + i];
  int total;
  block_scan(v, s_warp, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_sums_kernel(int* sums, int n) {  // one block, in place, exclusive
  __shared__ int s_warp[32];
  int carry = 0;
  for (int base = 0; base < n; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < n ? sums[i] : 0;
    int total;
    const int ex = block_scan(v, s_warp, &total);
    if (i < n) sums[i] = carry + ex;
    carry += total;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_apply_kernel(const int* __restrict__ in, int n, const int* __restrict__ offs,
                  int* __restrict__ out) {
  __shared__ int s_warp[32];
  const long long base = (long long)blockIdx.x * TILE + threadIdx.x * PER;
  int v[PER], sum = 0;
  for (int i = 0; i < PER; ++i) {
    v[i] = base + i < n ? in[base + i] : 0;
    sum += v[i];
  }
  int total;
  int run = offs[blockIdx.x] + block_scan(sum, s_warp, &total);
  for (int i = 0; i < PER; ++i) {
    if (base + i < n) out[base + i] = run;
    run += v[i];
  }
}

// bucket[start[d] .. start[d+1]) gets the steps that wrote slot d, in no
// order; hist counts down to 0 as the bucket fills
__global__ void scatter_kernel(int count, const int* __restrict__ draws, int* hist,
                               const int* __restrict__ start, int* __restrict__ bucket) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  const int d = draws[k];
  if (d != count - 1 - k) bucket[start[d] + atomicSub(hist + d, 1) - 1] = k;
}

__global__ void chains_kernel(int count, const int* __restrict__ draws,
                              const int* __restrict__ start, const int* __restrict__ bucket,
                              long long* __restrict__ order) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  int slot = draws[k], t = k;
  for (;;) {  // the value in `slot` before step t
    int last = -1;
    for (int q = start[slot], e = start[slot + 1]; q < e; ++q) {
      const int j = bucket[q];
      if (j < t && j > last) last = j;
    }
    if (last < 0) break;  // never written before t: the slot's own index
    slot = count - 1 - last;
    t = last;
  }
  order[k] = slot;
}

// ints of workspace hough_order_launch needs for `count` pixels
long long work_ints_needed(int count) {
  const long long n = (long long)count + 1;
  return 4ll * count + 2 + (n + TILE - 1) / TILE;
}

}  // namespace

// order[k] (int64): the raster index of the k-th pixel HoughLinesP visits;
// work: at least 4 count + 3 + (count + 1) / 1024 ints of scratch
extern "C" int hough_order_launch(int count, long long* order, int* work,
                                  long long work_ints, void* stream) {
  if (count < 0 || work_ints < work_ints_needed(count)) return (int)cudaErrorInvalidValue;
  if (count == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int n = count + 1;  // hist[count] stays 0: start[count] is the total
  const int n_tiles = (n + TILE - 1) / TILE;
  int* draws = work;
  int* hist = draws + count;
  int* start = hist + n;
  int* bucket = start + n;
  int* sums = bucket + count;
  cudaError_t err = cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)n, st);
  if (err != cudaSuccess) return (int)err;
  const int n_seg = (count + SEG - 1) / SEG;
  draws_kernel<<<(n_seg + 255) / 256, 256, 0, st>>>(count, draws, hist);
  tile_sums_kernel<<<n_tiles, SCAN_THREADS, 0, st>>>(hist, n, sums);
  scan_sums_kernel<<<1, SCAN_THREADS, 0, st>>>(sums, n_tiles);
  scan_apply_kernel<<<n_tiles, SCAN_THREADS, 0, st>>>(hist, n, sums, start);
  const int blocks = (count + 255) / 256;
  scatter_kernel<<<blocks, 256, 0, st>>>(count, draws, hist, start, bucket);
  chains_kernel<<<blocks, 256, 0, st>>>(count, draws, start, bucket, order);
  return (int)cudaGetLastError();
}
