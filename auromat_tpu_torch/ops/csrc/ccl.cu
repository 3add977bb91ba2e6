// Connected-component labelling of a binary image (CCL8 and CCL4), for
// sm_90a.
//
// Replaces no TPU kernel: the JAX package finds the star-field mask's
// contours with cv2.findContours on the host
// (auromat_tpu/solving/masking.py:70), whose components and holes the
// port labels here (solving/masking.py::external_contours). Plain
// version: auromat_tpu_torch/solving/masking.py::_ccl_plain
// (scipy.ndimage.label, each label mapped to its first pixel).
//
// Contract: labels[y*w + x] = the flat index of the first pixel in raster
// order of the 8- or 4-connected component of (x, y) among the pixels
// whose (img != 0) equals `fg`; -1 at every other pixel.
//
// Design: union-find on the labels themselves (Playne & Hawick, IEEE TPDS
// 2018, block-based). A link always points from a larger index to a
// smaller one (atomicMin), so a tree's root is its smallest index, which
// is the component's first pixel in raster order: no reduction after the
// unions.
//   1. tile: a 32x32 tile a block, one thread a pixel, a union-find in
//      shared memory over the tile's own neighbours (W and N; for
//      8-connectivity N alone where it is set, else NE and W or NW), with
//      path halving; each pixel then writes its tile root as a global
//      index (raster order inside a tile is raster order in the image);
//   2. seams: each pixel on a tile's left, top or right edge merges with
//      its earlier neighbours in other tiles, in global memory;
//   3. flatten: each pixel follows its chain to the root and writes it.
// What bounds it: the bytes are few (the image read once, 12 MB at
// 4256x2832; the labels written twice and read once, ~48 MB each way: a
// few hundredths of a millisecond at 3.35 TB/s). The time goes to latency:
// in a tile that is all set, the merges meet at one root and follow its
// chains through shared memory. One merge a pixel where the pixel above is
// set and path halving keep those chains short; the seams' global merges
// and the flattening's chains follow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;

// the root of x in the tile's shared labels, with path halving: each node
// passed is linked to its grandparent (an ancestor stays one: trees only
// join). The accesses are volatile: other threads relink the chain while
// it is followed. Only for the tile pass, whose results go to global
// memory: where the labels are also the output (the flattening), a late
// halving write could overwrite a pixel's final root
__device__ __forceinline__ int find_halving(volatile int* s, int x) {
  int p = s[x];
  while (p != x) {
    const int g = s[p];
    s[x] = g;
    x = g;
    p = s[x];
  }
  return x;
}

// the root of x in global memory: the first index on its chain that is its
// own parent
__device__ __forceinline__ int find_global(const volatile int* L, int x) {
  int p = L[x];
  while (p != x) {
    x = p;
    p = L[x];
  }
  return x;
}

// join the trees of a and b: the larger root is linked under the smaller;
// where another thread moved that root first, go on from its new parent
__device__ void merge_shared(int* s, int a, int b) {
  for (;;) {
    a = find_halving(s, a);
    b = find_halving(s, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(s + b, a);
    if (old == b) return;
    b = old;
  }
}

__device__ void merge_global(int* L, int a, int b) {
  for (;;) {
    a = find_global(L, a);
    b = find_global(L, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(L + b, a);
    if (old == b) return;
    b = old;
  }
}

template <int CONN>
__global__ void __launch_bounds__(TILE * TILE)
tile_kernel(const uint8_t* __restrict__ img, int w, int h, int fg, int* __restrict__ labels) {
  __shared__ int s[TILE * TILE];
  const int lx = threadIdx.x, ly = threadIdx.y, t = ly * TILE + lx;
  const int x = blockIdx.x * TILE + lx, y = blockIdx.y * TILE + ly;
  const bool in = x < w && y < h;
  const bool on = in && ((img[(size_t)y * w + x] != 0) == (fg != 0));
  s[t] = on ? t : -1;
  __syncthreads();
  // s[j] >= 0 exactly where pixel j is on (the merges write indices only).
  // 8-connected, a pixel merges with N alone where N is on (N joins NW and
  // NE, and W joins N, by their own merges), else with NE and with W or,
  // where W is off, NW: the same components, one or two merges a pixel
  const bool n_on = ly > 0 && s[t - TILE] >= 0;
  if (on && CONN == 8) {
    if (n_on) {
      merge_shared(s, t, t - TILE);
    } else {
      if (ly > 0 && lx < TILE - 1 && s[t - TILE + 1] >= 0) merge_shared(s, t, t - TILE + 1);
      if (lx > 0 && s[t - 1] >= 0)
        merge_shared(s, t, t - 1);
      else if (lx > 0 && ly > 0 && s[t - TILE - 1] >= 0)
        merge_shared(s, t, t - TILE - 1);
    }
  } else if (on) {
    if (lx > 0 && s[t - 1] >= 0) merge_shared(s, t, t - 1);
    if (n_on) merge_shared(s, t, t - TILE);
  }
  __syncthreads();
  if (!in) return;
  int out = -1;
  if (on) {
    const int r = find_halving(s, t);
    out = (blockIdx.y * TILE + r / TILE) * w + blockIdx.x * TILE + r % TILE;
  }
  labels[(size_t)y * w + x] = out;
}

// the earlier neighbours of a tile's edge pixels that lie in other tiles
template <int CONN>
__global__ void seam_kernel(int w, int h, int* labels) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const int lx = x % TILE, ly = y % TILE;
  if (lx != 0 && ly != 0 && lx != TILE - 1) return;
  const int i = y * w + x;
  const volatile int* L = labels;  // >= 0 exactly where a pixel is on
  if (L[i] < 0) return;
  if (lx == 0 && x > 0 && L[i - 1] >= 0) merge_global(labels, i, i - 1);
  if (ly == 0 && y > 0 && L[i - w] >= 0) merge_global(labels, i, i - w);
  if (CONN == 8 && y > 0) {
    if ((lx == 0 || ly == 0) && x > 0 && L[i - w - 1] >= 0) merge_global(labels, i, i - w - 1);
    if ((lx == TILE - 1 || ly == 0) && x + 1 < w && L[i - w + 1] >= 0)
      merge_global(labels, i, i - w + 1);
  }
}

__global__ void flatten_kernel(long long n, int* labels) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = labels[i];
  if (p < 0 || p == i) return;
  labels[i] = find_global(labels, p);
}

template <int CONN>
int ccl_launch(const uint8_t* img, int w, int h, int fg, int* labels, void* stream) {
  if (w <= 0 || h <= 0 || h > 65535 || (long long)w * h >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 tiles((w + TILE - 1) / TILE, (h + TILE - 1) / TILE);
  tile_kernel<CONN><<<tiles, dim3(TILE, TILE), 0, st>>>(img, w, h, fg, labels);
  seam_kernel<CONN><<<dim3((w + 255) / 256, h), 256, 0, st>>>(w, h, labels);
  const long long n = (long long)w * h;
  flatten_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(n, labels);
  return (int)cudaGetLastError();
}

}  // namespace

// labels: int32 (h, w); fg: 1 labels the non-zero pixels, 0 the zero ones
extern "C" int ccl8_launch(const uint8_t* img, int w, int h, int fg, int* labels,
                           void* stream) {
  return ccl_launch<8>(img, w, h, fg, labels, stream);
}

extern "C" int ccl4_launch(const uint8_t* img, int w, int h, int fg, int* labels,
                           void* stream) {
  return ccl_launch<4>(img, w, h, fg, labels, stream);
}
