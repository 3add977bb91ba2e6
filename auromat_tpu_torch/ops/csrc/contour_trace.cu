// Outer-border following (CONTOUR_TRACE), for sm_90a: the external
// contours that cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)
// returns, measured as cv2.contourArea and cv2.boundingRect measure them.
//
// Replaces no TPU kernel: the JAX package calls those three on the host
// (auromat_tpu/solving/masking.py:70, :75, :96). Plain version:
// auromat_tpu_torch/solving/masking.py::_contour_trace_plain (over
// utils.trace_outer_borders, contour_approx_simple, _contour_area and
// bounding_rect).
//
// One thread a root: the flat index of a component's first pixel in raster
// order (the 8-connected roots of the hole-filled image, from CCL8). The
// thread follows utils._follow_outer_border's walk (Suzuki & Abe's outer
// border, in OpenCV's neighbour order) on the binary image, read-only:
// the walk tests only whether a pixel is set, and the marks the host
// follower leaves are non-zero, so they never change it; threads share
// nothing. Out-of-image pixels count as unset (findContours' zero frame).
// Per root it writes
//   - area2: |sum x_k y_(k+1) - x_(k+1) y_k| over the whole chain, int64:
//     twice the shoelace area of the CHAIN_APPROX_SIMPLE contour (that
//     drops only points whose incoming and outgoing steps are equal, which
//     changes no area), so comparisons with an integer are exact;
//   - box: x, y, w, h of the chain (its extremes are simple points);
//   - length: the chain's points (CHAIN_APPROX_NONE), -1 if the walk did
//     not start on a set pixel or ran past 8 steps a pixel;
//   - count: the CHAIN_APPROX_SIMPLE points: the points whose outgoing step
//     differs from the incoming one, the start compared with the closing
//     step (the opposite of the first step found clockwise).
// With `pts`, the same walk writes the simple points (x, y) at `offsets`
// (an exclusive prefix sum of the counts). With `cycles`, each thread
// writes the clock64() cycles of its walk.
// What bounds it: latency. The time is the longest border's walk (117,038
// steps on ISS029's fudge-40 binary), one step after another. A first pass
// packs the image into 8x8-pixel tiles of one 64-bit word each (12 MB ->
// 1.5 MB, which stays in L2); a walking thread keeps a 16x16-pixel window
// of 2x2 words in registers and reloads it (four independent loads, one
// round trip) only when the 3x3 neighbourhood leaves it, about once in ten
// steps on a real border. A step is then a chain of dependent integer
// operations (the neighbourhood's bits, the next direction, the position).
// Reading the eight neighbour bytes each step took one L2 round trip a
// step whenever the walk moved to a new row. The bytes (the image once,
// 36 bytes a root out) take ~4 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// OpenCV's chain code: direction s -> (dx, dy), counterclockwise from east,
// y down: (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1),
// (1, 1), kept as 2-bit fields of dx + 1 and dy + 1
constexpr unsigned DXB = 2u | 2u << 2 | 1u << 4 | 0u << 6 | 0u << 8 | 0u << 10 | 1u << 12 | 2u << 14;
constexpr unsigned DYB = 1u | 0u << 2 | 0u << 4 | 0u << 6 | 1u << 8 | 2u << 10 | 2u << 12 | 2u << 14;

__device__ __forceinline__ int step_x(int s) { return (int)(DXB >> (2 * s) & 3u) - 1; }
__device__ __forceinline__ int step_y(int s) { return (int)(DYB >> (2 * s) & 3u) - 1; }

// the image as 8x8-pixel tiles, one 64-bit word each (bit r*8 + c is
// pixel (8 ty + r, 8 tx + c)); one thread a word
__global__ void pack_kernel(const uint8_t* __restrict__ img, int w, int h, int tw,
                            unsigned long long* __restrict__ bits) {
  const int tx = blockIdx.x * blockDim.x + threadIdx.x, ty = blockIdx.y;
  if (tx >= tw) return;
  unsigned long long v = 0;
  for (int r = 0; r < 8; ++r) {
    const int y = ty * 8 + r;
    if (y >= h) break;
    for (int c = 0; c < 8; ++c) {
      const int x = tx * 8 + c;
      if (x < w && img[(size_t)y * w + x] != 0) v |= 1ull << (r * 8 + c);
    }
  }
  bits[(size_t)ty * tw + tx] = v;
}

// a 16x16-pixel window of 2x2 tile words, kept in registers while the
// walk's 3x3 neighbourhood stays inside it
struct Window {
  const unsigned long long* __restrict__ bits;
  int tw, th, bx, by;
  unsigned long long w00, w01, w10, w11;

  __device__ unsigned long long word(int ty, int tx) const {
    return (unsigned)tx < (unsigned)tw && (unsigned)ty < (unsigned)th
               ? __ldg(bits + (size_t)ty * tw + tx)
               : 0ull;
  }
  // bit s set where the neighbour of (x, y) in direction s is set
  __device__ unsigned neighbours(int x, int y) {
    if (x - 1 < 8 * bx || x + 1 >= 8 * bx + 16 || y - 1 < 8 * by || y + 1 >= 8 * by + 16) {
      bx = (x - 1) >> 3;
      by = (y - 1) >> 3;
      w00 = word(by, bx);
      w01 = word(by, bx + 1);
      w10 = word(by + 1, bx);
      w11 = word(by + 1, bx + 1);
    }
    const int lx = x - 8 * bx, ly = y - 8 * by;
    unsigned trip[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {  // rows y-1, y, y+1: columns x-1, x, x+1
      const int ry = ly - 1 + k, r = 8 * (ry & 7);
      const unsigned long long lo = ry >> 3 ? w10 : w00, hi = ry >> 3 ? w11 : w01;
      const unsigned row = (unsigned)(lo >> r & 0xffu) | (unsigned)(hi >> r & 0xffu) << 8;
      trip[k] = row >> (lx - 1) & 7u;
    }
    return (trip[1] >> 2 & 1u) | (trip[0] >> 2 & 1u) << 1 | (trip[0] >> 1 & 1u) << 2 |
           (trip[0] & 1u) << 3 | (trip[1] & 1u) << 4 | (trip[2] & 1u) << 5 |
           (trip[2] >> 1 & 1u) << 6 | (trip[2] >> 2 & 1u) << 7;
  }
};

template <bool POINTS>
__global__ void trace_kernel(const uint8_t* __restrict__ img, int w, int h,
                             const int* __restrict__ roots, int n, long long* __restrict__ area2,
                             int* __restrict__ box, long long* __restrict__ length,
                             long long* __restrict__ count, const long long* __restrict__ offsets,
                             int* __restrict__ pts, long long* __restrict__ cycles,
                             const unsigned long long* __restrict__ bits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long long t0 = clock64();
  const int i0 = roots[r];
  const int x0 = i0 % w, y0 = i0 / w;
  int2* out = POINTS ? reinterpret_cast<int2*>(pts) + offsets[r] : nullptr;
  long long steps = 1, simple = 1, twice = 0;
  int minx = x0, maxx = x0, miny = y0, maxy = y0;
  Window win{bits, (w + 7) / 8, (h + 7) / 8, -8, -8, 0, 0, 0, 0};  // first call loads
  unsigned m = win.neighbours(x0, y0);
  // the first set neighbour clockwise from the west: 3, 2, 1, 0, 7, 6, 5
  int s1 = -1;
  for (int k = 0; k < 7 && s1 < 0; ++k)
    if (m >> ((3 - k) & 7) & 1) s1 = (3 - k) & 7;
  if (i0 < 0 || i0 >= w * h || __ldg(img + i0) == 0) {  // no border starts here
    steps = -1;
  } else if (s1 < 0) {  // a single pixel
    if (POINTS) out[0] = make_int2(x0, y0);
  } else {
    const int x1 = x0 + step_x(s1), y1 = y0 + step_y(s1);
    const long long limit = 8ll * w * h;
    int x = x0, y = y0, s = s1;
    int prev = (s1 + 4) & 7;  // the closing step, from (x1, y1) back to the start
    steps = simple = 0;
    for (;;) {
      // the next set neighbour counterclockwise after s
      const int s0 = (s + 1) & 7;
      const unsigned rot = ((m >> s0) | (m << (8 - s0))) & 0xffu;
      const int d = (s0 + __ffs(rot) - 1) & 7;
      const int xn = x + step_x(d), yn = y + step_y(d);
      if (d != prev) {
        if (POINTS) out[simple] = make_int2(x, y);
        ++simple;
      }
      ++steps;
      twice += (long long)x * yn - (long long)xn * y;
      minx = min(minx, x);
      maxx = max(maxx, x);
      miny = min(miny, y);
      maxy = max(maxy, y);
      if (xn == x0 && yn == y0 && x == x1 && y == y1) break;
      if (steps > limit) {
        steps = -1;
        break;
      }
      prev = d;
      x = xn;
      y = yn;
      s = (d + 4) & 7;
      m = win.neighbours(x, y);
    }
  }
  area2[r] = twice < 0 ? -twice : twice;
  box[4 * r] = minx;
  box[4 * r + 1] = miny;
  box[4 * r + 2] = maxx - minx + 1;
  box[4 * r + 3] = maxy - miny + 1;
  length[r] = steps;
  count[r] = simple;
  if (cycles) cycles[r] = clock64() - t0;
}

}  // namespace

// roots: int32 (n); area2, length, count: int64 (n); box: int32 (n, 4);
// offsets (int64 (n)) and pts (int32 (sum of counts, 2)) both null or both
// given; cycles: null or int64 (n); bits: scratch of ceil(h/8) ceil(w/8)
// 64-bit words
extern "C" int contour_trace_launch(const uint8_t* img, int w, int h, const int* roots, int n,
                                    long long* area2, int* box, long long* length,
                                    long long* count, const long long* offsets, int* pts,
                                    long long* cycles, unsigned long long* bits,
                                    void* stream) {
  if (w <= 0 || h <= 0 || n < 0 || (long long)w * h >= (1ll << 31) || (h + 7) / 8 > 65535 ||
      bits == nullptr || (offsets == nullptr) != (pts == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int tw = (w + 7) / 8, th = (h + 7) / 8;
  pack_kernel<<<dim3((tw + 127) / 128, th), 128, 0, st>>>(img, w, h, tw, bits);
  const int threads = 128, blocks = (n + threads - 1) / threads;
  if (pts)
    trace_kernel<true><<<blocks, threads, 0, st>>>(img, w, h, roots, n, area2, box, length,
                                                   count, offsets, pts, cycles, bits);
  else
    trace_kernel<false><<<blocks, threads, 0, st>>>(img, w, h, roots, n, area2, box, length,
                                                    count, offsets, pts, cycles, bits);
  return (int)cudaGetLastError();
}
