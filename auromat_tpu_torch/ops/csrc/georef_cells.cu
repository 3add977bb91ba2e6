// GEOREF_CELLS: the float32 georeference chain of the fused path and its
// cells in one pass: pixel -> CD matrix -> trig-free TAN unprojection ->
// rotmat -> ray/inflated-ellipsoid intersection -> J2000->GEO -> Bowring
// lat/lon -> elevation -> the cell (iy, ix) K1 bins the pixel into.
//
// It replaces no Pallas kernel: the JAX package leaves this chain to XLA,
// which fuses it on the TPU. Eager PyTorch ran it as ~150 full-frame
// elementwise launches (ops/georef.py::georef_latlon_dyn, then the float64
// ops/regrid.py::bin_indices and ops/georegrid.py::split_bin_indices), each
// reading and writing 48 or 96 MB planes. That eager chain stays as this
// kernel's plain twin: the CPU route runs it, and the gpu tests hold the
// kernel to it on the card.
//
// Bit-equal to the eager chain on the card. Every float32 operation of the
// eager chain is one rounded operation here, in its order (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: no FMA contraction), with the
// same CUDA math functions ATen calls (rsqrtf, atanf, atan2f, acosf).
// Python floats are float32 operands rounded on the host, as torch rounds
// them (ops/georegrid.py::_CHAIN_CONSTS). Torch's reverse division by a
// Python float, ``c / t``, is ``reciprocal(t) * c``: 1/t rounded, then the
// product. The per-frame 0-d ops (a, b, 1/a, 1/b, the scaled origin, its
// squared norm, inside) are recomputed by every thread in the same float32
// roundings, so nothing is read back to the host. The cell arithmetic is
// float64 as in bin_indices; ATen on CUDA divides a tensor by a Python float
// as a product with the reciprocal rounded on the host, so the kernel takes
// 1/lat_step and 1/lon_step from the host and multiplies (__dmul_rn).
//
// What bounds it on an H100. It reads nothing per pixel but a mask byte
// where a mask is given, and writes iy, ix (int32) and the elevation
// (float32): 12 B a pixel, 144.6 MB for the 12 MP frame, 0.043 ms at 3.35
// TB/s (lat/lon add 8 B a pixel where a caller asks for them). The
// instructions bound it first: about 100 float32 operations, four correctly
// rounded square roots, five divides, rsqrt, atan, atan2, acos and a few
// float64 operations a pixel. Its SASS (sm_90a) holds 2,416 instructions
// for PIX = 4 pixels, 604 a pixel; at 4 warp-instructions a clock on each
// of 132 SMs at 1,980 MHz the 12 MP frame takes at least 0.218 ms (less:
// the divides' and roots' slow paths are in the count and rarely run). It
// runs in 0.250 ms on an H100 80GB HBM3 at 700 W, against 6.9 ms for the
// eager chain.
//
// Design: one thread computes PIX consecutive pixels of a row entirely in
// registers (74 registers, no spill) and stores each output as one 16-byte
// vector where the group is whole and aligned (scalar stores at a ragged
// row end or off alignment). Nothing but the outputs touches device
// memory; the calibration's few floats are read through the read-only
// cache, the same words by every thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PIX = 4;  // consecutive pixels of a row a thread
constexpr int THREADS = 256;

struct Calib {  // device pointers to the DynGeorefParams fields (float32)
  const float* cd;          // (2, 2)
  const float* px_ref;      // ()
  const float* py_ref;      // ()
  const float* rotmat;      // (3, 3)
  const float* camera_pos;  // (3,)
  const float* altitude;    // ()
  const float* geo;         // (3, 3) J2000 -> GEO
};

struct Consts {  // the eager chain's Python floats, rounded to float32
  float u2;   // (180/pi)^2, _pixel_dirs
  float u;    // 180/pi, _pixel_dirs
  float a;    // WGS84_A
  float b;    // WGS84_B
  float d;    // (a^2 - b^2) / b, _bowring
  float e2a;  // e2 * a, _bowring
  float r2d;  // rad2deg's factor
};

struct Cells {  // ops/regrid.py::bin_indices of GridSpec, on the host
  int n_lat, n_lon;
  double lat_hi_edge, inv_lat_step, lon_lo_edge, inv_lon_step;
};

struct Frame {  // the per-frame scalars of the eager chain's 0-d ops
  float cd00, cd01, cd10, cd11, px1, py1;
  float r[9], g[9];
  float ox, oy, oz, inv_a, inv_b, osx, osy, osz, c_q;
  bool inside;
};

__device__ __forceinline__ float add3(float p, float q, float r) {
  return __fadd_rn(__fadd_rn(p, q), r);  // (p + q) + r, as torch adds
}

__device__ __forceinline__ float dot3(const float* m, float x, float y,
                                      float z) {
  return add3(__fmul_rn(m[0], x), __fmul_rn(m[1], y), __fmul_rn(m[2], z));
}

__device__ __forceinline__ Frame load_frame(const Calib& c, const Consts& k) {
  Frame f;
  f.cd00 = __ldg(c.cd);
  f.cd01 = __ldg(c.cd + 1);
  f.cd10 = __ldg(c.cd + 2);
  f.cd11 = __ldg(c.cd + 3);
  f.px1 = __fsub_rn(__ldg(c.px_ref), 1.0f);  // p.px_ref - 1.0
  f.py1 = __fsub_rn(__ldg(c.py_ref), 1.0f);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    f.r[i] = __ldg(c.rotmat + i);
    f.g[i] = __ldg(c.geo + i);
  }
  const float alt = __ldg(c.altitude);
  const float a = __fadd_rn(alt, k.a);  // WGS84_A + p.altitude
  const float b = __fadd_rn(alt, k.b);
  f.ox = __ldg(c.camera_pos);
  f.oy = __ldg(c.camera_pos + 1);
  f.oz = __ldg(c.camera_pos + 2);
  const float qa = __fdiv_rn(f.ox, a), qb = __fdiv_rn(f.oy, a);
  const float qc = __fdiv_rn(f.oz, b);
  // (ox / a) ** 2 + (oy / a) ** 2 + (oz / b) ** 2 < 1.0
  f.inside = add3(__fmul_rn(qa, qa), __fmul_rn(qb, qb), __fmul_rn(qc, qc)) <
             1.0f;
  f.inv_a = __fdiv_rn(1.0f, a);  // 1.0 / a: reciprocal(a) * 1.0
  f.inv_b = __fdiv_rn(1.0f, b);
  f.osx = __fmul_rn(-f.ox, f.inv_a);
  f.osy = __fmul_rn(-f.oy, f.inv_a);
  f.osz = __fmul_rn(-f.oz, f.inv_b);
  f.c_q = add3(__fmul_rn(f.osx, f.osx), __fmul_rn(f.osy, f.osy),
               __fmul_rn(f.osz, f.osz));
  return f;
}

struct Pixel {
  float lat, lon, elev;
  int iy, ix;
};

// ops/georef.py: _pixel_dirs, _intersect, _latlon_from_j2000 (_rot,
// _bowring, rad2deg), _elevation_deg; then bin_indices + split_bin_indices
__device__ __forceinline__ Pixel chain(const Frame& f, const Consts& k,
                                       const Cells& cells, float px,
                                       float py, bool masked) {
  const float dx = __fsub_rn(px, f.px1);
  const float dy = __fsub_rn(py, f.py1);
  const float x = __fadd_rn(__fmul_rn(f.cd00, dx), __fmul_rn(f.cd01, dy));
  const float y = __fadd_rn(__fmul_rn(f.cd10, dx), __fmul_rn(f.cd11, dy));
  const float inv =
      rsqrtf(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), k.u2));
  const float l = __fmul_rn(-y, inv);
  const float m = __fmul_rn(x, inv);
  const float n = __fmul_rn(inv, k.u);
  const float vx = dot3(f.r, l, m, n);
  const float vy = dot3(f.r + 3, l, m, n);
  const float vz = dot3(f.r + 6, l, m, n);

  // scaled-space quadratic; a camera inside takes the far root
  const float dsx = __fmul_rn(vx, f.inv_a);
  const float dsy = __fmul_rn(vy, f.inv_a);
  const float dsz = __fmul_rn(vz, f.inv_b);
  const float b_q = add3(__fmul_rn(dsx, f.osx), __fmul_rn(dsy, f.osy),
                         __fmul_rn(dsz, f.osz));
  const float a_q = add3(__fmul_rn(dsx, dsx), __fmul_rn(dsy, dsy),
                         __fmul_rn(dsz, dsz));
  const float root = __fsqrt_rn(__fadd_rn(
      __fsub_rn(__fmul_rn(b_q, b_q), __fmul_rn(f.c_q, a_q)), a_q));
  float d = f.inside ? __fadd_rn(b_q, root) : __fsub_rn(b_q, root);
  d = d < 0.0f ? __int_as_float(0x7fc00000) : d;  // behind the camera: NaN
  d = __fdiv_rn(d, a_q);
  const float jx = __fadd_rn(f.ox, __fmul_rn(d, vx));
  const float jy = __fadd_rn(f.oy, __fmul_rn(d, vy));
  const float jz = __fadd_rn(f.oz, __fmul_rn(d, vz));

  // J2000 -> GEO, Bowring
  const float gx = dot3(f.g, jx, jy, jz);
  const float gy = dot3(f.g + 3, jx, jy, jz);
  const float gz = dot3(f.g + 6, jx, jy, jz);
  const float p2 = __fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy));
  const float p = __fsqrt_rn(p2);
  const float r = __fsqrt_rn(__fadd_rn(p2, __fmul_rn(gz, gz)));
  // b * z * (1.0 + d / r) / (a * p), d / r being reciprocal(r) * d
  const float tu = __fdiv_rn(
      __fmul_rn(__fmul_rn(gz, k.b),
                __fadd_rn(__fmul_rn(__fdiv_rn(1.0f, r), k.d), 1.0f)),
      __fmul_rn(p, k.a));
  const float tu2 = __fmul_rn(tu, tu);
  const float cu = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(tu2, 1.0f)));
  const float cu3 = __fmul_rn(__fmul_rn(cu, cu), cu);
  const float su3 = __fmul_rn(__fmul_rn(cu3, tu2), tu);
  const float lat = atanf(__fdiv_rn(__fadd_rn(gz, __fmul_rn(su3, k.d)),
                                    __fsub_rn(p, __fmul_rn(cu3, k.e2a))));
  const float lon = atan2f(gy, gx);

  // 90 - rad2deg(arccos(clip(-(v . j) / |j|, -1, 1)))
  const float ilen = __fsqrt_rn(add3(__fmul_rn(jx, jx), __fmul_rn(jy, jy),
                                     __fmul_rn(jz, jz)));
  float dot = __fdiv_rn(-add3(__fmul_rn(vx, jx), __fmul_rn(vy, jy),
                              __fmul_rn(vz, jz)),
                        ilen);
  dot = dot != dot ? dot : fminf(fmaxf(dot, -1.0f), 1.0f);  // NaN stays

  Pixel o;
  o.lat = __fmul_rn(lat, k.r2d);
  o.lon = __fmul_rn(lon, k.r2d);
  o.elev = __fsub_rn(90.0f, __fmul_rn(acosf(dot), k.r2d));

  // the cell in float64; the far edge is inclusive; NaN and +-inf fail
  const double fy = __dmul_rn(__dsub_rn(cells.lat_hi_edge, (double)o.lat),
                              cells.inv_lat_step);
  const double fx = __dmul_rn(__dsub_rn((double)o.lon, cells.lon_lo_edge),
                              cells.inv_lon_step);
  double cy = floor(fy), cx = floor(fx);
  if (fy == (double)cells.n_lat) cy = cells.n_lat - 1.0;
  if (fx == (double)cells.n_lon) cx = cells.n_lon - 1.0;
  const bool valid = !masked && cy >= 0.0 && cy < (double)cells.n_lat &&
                     cx >= 0.0 && cx < (double)cells.n_lon;
  o.iy = valid ? (int)cy : -1;
  o.ix = valid ? (int)cx : -1;
  return o;
}

__global__ void __launch_bounds__(THREADS)
    georef_cells_kernel(Calib calib, Consts k, Cells cells,
                        const unsigned char* __restrict__ mask, int h, int w,
                        int row0, int* __restrict__ iy, int* __restrict__ ix,
                        float* __restrict__ elev, float* __restrict__ lat,
                        float* __restrict__ lon) {
  const long long groups = (w + PIX - 1) / PIX;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= groups * h) return;
  const int r = (int)(t / groups);
  const int c0 = (int)(t - (long long)r * groups) * PIX;
  const long long idx0 = (long long)r * w + c0;
  const Frame f = load_frame(calib, k);
  const float py = (float)(row0 + r);

  Pixel o[PIX];
#pragma unroll
  for (int j = 0; j < PIX; ++j) {
    const bool in = c0 + j < w;
    const bool masked = in && mask != nullptr && mask[idx0 + j] != 0;
    o[j] = chain(f, k, cells, (float)(c0 + j), py, masked);
  }

  uintptr_t addr = (uintptr_t)(iy + idx0) | (uintptr_t)(ix + idx0) |
                   (uintptr_t)(elev + idx0);
  if (lat != nullptr) addr |= (uintptr_t)(lat + idx0) | (uintptr_t)(lon + idx0);
  if (c0 + PIX <= w && (addr & 15) == 0) {
    *reinterpret_cast<int4*>(iy + idx0) =
        make_int4(o[0].iy, o[1].iy, o[2].iy, o[3].iy);
    *reinterpret_cast<int4*>(ix + idx0) =
        make_int4(o[0].ix, o[1].ix, o[2].ix, o[3].ix);
    *reinterpret_cast<float4*>(elev + idx0) =
        make_float4(o[0].elev, o[1].elev, o[2].elev, o[3].elev);
    if (lat != nullptr) {
      *reinterpret_cast<float4*>(lat + idx0) =
          make_float4(o[0].lat, o[1].lat, o[2].lat, o[3].lat);
      *reinterpret_cast<float4*>(lon + idx0) =
          make_float4(o[0].lon, o[1].lon, o[2].lon, o[3].lon);
    }
  } else {
#pragma unroll
    for (int j = 0; j < PIX; ++j) {
      if (c0 + j >= w) break;
      iy[idx0 + j] = o[j].iy;
      ix[idx0 + j] = o[j].ix;
      elev[idx0 + j] = o[j].elev;
      if (lat != nullptr) {
        lat[idx0 + j] = o[j].lat;
        lon[idx0 + j] = o[j].lon;
      }
    }
  }
}

}  // namespace

// Launch on ``stream``: rows row0 .. row0 + h - 1 of a w-wide frame into the
// (h, w) planes iy, ix, elev and, unless lat is null, lat and lon. mask (or
// null) is (h, w) bytes, nonzero = exclude (iy = ix = -1). Returns
// cudaGetLastError() of the launch.
extern "C" int georef_cells_launch(
    const void* cd, const void* px_ref, const void* py_ref,
    const void* rotmat, const void* camera_pos, const void* altitude,
    const void* geo, const void* mask, int h, int w, int row0, int n_lat,
    int n_lon, double lat_hi_edge, double inv_lat_step, double lon_lo_edge,
    double inv_lon_step, float u2, float u, float a, float b, float d,
    float e2a, float r2d, void* iy, void* ix, void* elev, void* lat,
    void* lon, void* stream) {
  const long long total = (long long)h * ((w + PIX - 1) / PIX);
  if (total == 0) return 0;
  const Calib calib{(const float*)cd,         (const float*)px_ref,
                    (const float*)py_ref,     (const float*)rotmat,
                    (const float*)camera_pos, (const float*)altitude,
                    (const float*)geo};
  const Consts k{u2, u, a, b, d, e2a, r2d};
  const Cells cells{n_lat, n_lon, lat_hi_edge, inv_lat_step, lon_lo_edge,
                    inv_lon_step};
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  georef_cells_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      calib, k, cells, (const unsigned char*)mask, h, w, row0, (int*)iy,
      (int*)ix, (float*)elev, (float*)lat, (float*)lon);
  return (int)cudaGetLastError();
}
