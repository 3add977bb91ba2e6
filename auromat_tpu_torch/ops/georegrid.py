"""Fused georeference + regrid: the single-frame production path.

Counterpart of ``auromat_tpu.ops.georegrid``. One call runs the full
pipeline forward (pixel grid -> TAN unproject -> ray/ellipsoid
intersection -> GEO rotation -> Bowring lat/lon + elevation -> fixed-grid
bin indices -> mean binning) for one frame:

- the georeference chain and the bin indices are GEOREF_CELLS, a CUDA
  kernel written by hand (``csrc/georef_cells.cu``, :func:`georef_cells`),
  which keeps every intermediate in registers and writes K1's cells and
  the elevation; its plain twin, on CPU tensors, is the eager chain
  (:func:`georegrid_inputs_plain`: :mod:`auromat_tpu_torch.ops.georef` and
  :func:`auromat_tpu_torch.ops.regrid.bin_indices`), to which the kernel is
  bit-equal on the card;
- the binning is K1, a CUDA kernel written by hand
  (``csrc/georegrid_bin.cu``: shared-memory tile histograms on the engine of
  ``csrc/bin_tile.cuh``, with a fused float32 epilogue), with its plain
  PyTorch version (:func:`bin_rgbelev_plain`) beside it in this module.
  ``compute='i8'`` selects K1-i8, the same kernel with the elevation
  quantization of the JAX package's int8 variant.

The whole (count, 4 sums) accumulator of a grid lives in device memory at
once (40 bytes of int64 sums a cell: ~1 GB even for the 0.05 deg global
grid), so the TPU package's VMEM workarounds — lat slabs, tile bounds,
tile shapes — have no counterpart here.

K1 takes any (n, w) block of samples: one frame (h, w) or a burst of
frames stacked along the rows (B*h, w), as the mosaic step
(:mod:`auromat_tpu_torch.parallel.sharding`) passes it. A call refuses
2^32 samples or more, and any cell that ends up holding more than
:data:`MAX_CELL_COUNT` samples (the JAX package's uint32 bound): the
plain version checks the counts after binning, the kernel raises a status
word that the wrapper reads once (one small copy, one host sync a call).
:func:`bin_rgbelev_int` and :func:`bin_rgbelev_plain_int` return the
integer sums themselves, for callers that add them across calls;
:func:`mean_int_sums` (K1_MEAN, in the same source) finishes such sums on
the card in one pass: the float32 count, the means and the largest count.

Reference: auromat/mapping/astrometry.py:49-212 + auromat/resample.py:
328-351 (the lazy-property pyramid + histogram2d rebin, fused).
"""

import math

import numpy as np
import torch

from auromat_tpu_torch.constants import WGS84_A, WGS84_B
from auromat_tpu_torch.ops._kernels import (GEOREF_CELLS, GEOREGRID_BIN,
                                            GEOREGRID_BIN_I8, K1_MEAN)
from auromat_tpu_torch.ops.georef import DynGeorefParams, georef_latlon_dyn
from auromat_tpu_torch.ops.regrid import GridSpec, bin_indices, finalize_mean
from auromat_tpu_torch.profiling import span

ELEV_OFFSET = 90.0  # elevation + 90 >= 0: the fixed-point sums are unsigned
ELEV_SCALE = 2.0 ** 30  # fixed-point scale of the elevation sums
ELEV_SCALE_I8 = 2.0 ** 16  # K1-i8: elevation floor-quantized to 2^-16
_KERNELS = {"bf16": GEOREGRID_BIN, "i8": GEOREGRID_BIN_I8}
# the most samples a cell may hold: 255 * count still fits a uint32 word
MAX_CELL_COUNT = (2 ** 32 - 1) // 255  # 16,843,009

_U = 180.0 / math.pi  # ops/georef.py::_pixel_dirs; also rad2deg's factor
_A2_B2 = WGS84_A * WGS84_A - WGS84_B * WGS84_B  # ops/georef.py::_bowring
# the eager chain's Python floats as torch rounds them, each a float32
# operand of a float32 tensor op: u * u and u (_pixel_dirs), WGS84_A and
# WGS84_B (_intersect, _bowring), _bowring's d and e2 * a, rad2deg's factor
_CHAIN_CONSTS = tuple(float(np.float32(v)) for v in (
    _U * _U, _U, WGS84_A, WGS84_B, _A2_B2 / WGS84_B,
    _A2_B2 / (WGS84_A * WGS84_A) * WGS84_A, _U))
# the calibration GEOREF_CELLS reads, with the shape of one frame's field
_CELLS_DYN = {"cd": (2, 2), "px_ref": (), "py_ref": (), "rotmat": (3, 3),
              "camera_pos": (3,), "altitude": (),
              "mat_j2000_to_geo": (3, 3)}


def _check_inputs(grid, iy, ix, img_chw, elev):
    h, w = iy.shape
    want = {"iy": (iy, torch.int32, (h, w)), "ix": (ix, torch.int32, (h, w)),
            "img_chw": (img_chw, torch.float32, (3, h, w)),
            "elev": (elev, torch.float32, (h, w))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != iy.device:
            raise ValueError(f"{name} is on {t.device}, iy on {iy.device}")
    if h * w >= 2 ** 32:
        raise ValueError(f"{h}x{w} samples could overflow the uint32 counts")
    if grid.n_lat * grid.n_lon >= 2 ** 31:
        raise ValueError("grid too large for int32 cell indices")


def refuse_cell_count(most):
    """Raise if the fullest cell, ``most`` samples, holds more than
    :data:`MAX_CELL_COUNT` (a uint32 R/G/B sum could wrap)."""
    if most > MAX_CELL_COUNT:
        raise ValueError(f"a cell holds {most} samples: its uint32 R/G/B "
                         f"sums could overflow (at most {MAX_CELL_COUNT})")


def _check_cell_counts(count):
    """The plain version's refusal: one reduction and one host sync."""
    refuse_cell_count(int(count.max().item()) if count.numel() else 0)


def _check_compute(compute):
    if compute not in _KERNELS:
        raise ValueError(f"unknown compute mode {compute!r}")


def finish_int_sums(grid, cnt_rgb, elev_fixed, compute):
    """Integer sums -> f32 (count (n_lat, n_lon), sums (n_lat, n_lon, 4)).

    :param cnt_rgb: (n_cells, 4) int64 [count, R, G, B]
    :param elev_fixed: (n_cells,) int64 sum of the fixed-point elevations
        (+ 90 deg) at the scale of ``compute``
    """
    count = cnt_rgb[:, 0]
    scale = ELEV_SCALE_I8 if compute == "i8" else ELEV_SCALE
    el = elev_fixed.double() * (1.0 / scale) - ELEV_OFFSET * count.double()
    sums = torch.cat([cnt_rgb[:, 1:].float(), el.float()[:, None]], dim=1)
    return (count.float().reshape(grid.n_lat, grid.n_lon),
            sums.reshape(grid.n_lat, grid.n_lon, 4))


def mean_int_sums(grid, cnt_rgb, elev_fixed):
    """K1_MEAN: :func:`finish_int_sums` (K1's scale) and
    :func:`~auromat_tpu_torch.ops.regrid.finalize_mean` of CUDA tensors in
    one launch on the current stream, bit-equal to that pair, which is its
    plain twin on any device.

    :param cnt_rgb: (n_cells, 4) int64 [count, R, G, B], contiguous and
        16-byte aligned
    :param elev_fixed: (n_cells,) int64 sum of the fixed-point elevations
        (+ 90 deg) at :data:`ELEV_SCALE`
    :returns: count (n_lat, n_lon) and means (n_lat, n_lon, 4) [R, G, B,
        elevation], float32, NaN where the count is 0; and the largest
        count, a (1,) int64 tensor on the device for the caller to read
    """
    n_cells, dev = grid.n_lat * grid.n_lon, cnt_rgb.device
    if dev.type != "cuda":
        raise ValueError(f"K1_MEAN runs on cuda, not {dev}; its plain twin "
                         "is finish_int_sums + finalize_mean")
    for name, t, shape in (("cnt_rgb", cnt_rgb, (n_cells, 4)),
                           ("elev_fixed", elev_fixed, (n_cells,))):
        if t.dtype != torch.int64 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want int64 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if cnt_rgb.data_ptr() % 16:
        raise ValueError("cnt_rgb must be 16-byte aligned for K1_MEAN")
    count = torch.empty(n_cells, dtype=torch.float32, device=dev)
    means = torch.empty(n_cells, 4, dtype=torch.float32, device=dev)
    most = torch.zeros(1, dtype=torch.int64, device=dev)
    K1_MEAN(cnt_rgb, elev_fixed, n_cells, 1.0 / ELEV_SCALE, count, means,
            most)
    return (count.reshape(grid.n_lat, grid.n_lon),
            means.reshape(grid.n_lat, grid.n_lon, 4), most)


def bin_rgbelev_plain(grid: GridSpec, iy, ix, img_chw, elev,
                      compute="bf16"):
    """Plain PyTorch version of K1 and K1-i8 with the kernels' arithmetic
    contract: count and R/G/B as exact integer sums, elevation as a
    fixed-point integer sum (``index_add_`` of int64): round((e + 90) *
    2^30) in double for K1, floor(fl32(e + 90) * 2^16) for K1-i8. Bit-equal
    to the kernel on all five outputs, and it refuses what the kernel
    refuses. Arguments and result as :func:`bin_rgbelev_from_indices`.
    """
    return finish_int_sums(grid, *bin_rgbelev_plain_int(
        grid, iy, ix, img_chw, elev, compute), compute)


def bin_rgbelev_plain_int(grid: GridSpec, iy, ix, img_chw, elev,
                          compute="bf16"):
    """The integer sums of :func:`bin_rgbelev_plain` on any device, as
    :func:`bin_rgbelev_int` returns them."""
    _check_compute(compute)
    _check_inputs(grid, iy, ix, img_chw, elev)
    n_cells = grid.n_lat * grid.n_lon
    valid = ((iy >= 0) & (iy < grid.n_lat) & (ix >= 0) & (ix < grid.n_lon))
    cell = (iy.long() * grid.n_lon + ix.long())[valid]
    img = img_chw[:, valid]
    img = torch.where(img == img, img, 0.0)
    e = elev[valid]
    e = torch.where(e == e, e, 0.0)
    vals = torch.cat([torch.ones_like(cell)[None], img.long()], dim=0).T
    cnt_rgb = torch.zeros(n_cells, 4, dtype=torch.int64, device=iy.device)
    cnt_rgb.index_add_(0, cell, vals)
    _check_cell_counts(cnt_rgb[:, 0])
    if compute == "i8":  # the add in float32, then an exact scale and floor
        q = torch.floor((e + ELEV_OFFSET) * ELEV_SCALE_I8).long()
    else:
        q = torch.round((e.double() + ELEV_OFFSET) * ELEV_SCALE).long()
    elev_fixed = torch.zeros(n_cells, dtype=torch.int64, device=iy.device)
    elev_fixed.index_add_(0, cell, q)
    return cnt_rgb, elev_fixed


def launch_k1(grid, iy, ix, img_chw, elev, acc, elev_acc, status,
              count=None, sums=None, compute="bf16"):
    """Launch K1 (or K1-i8) on the current stream, adding into ``acc``
    ((n_cells, 4) int64 [count, R, G, B]) and ``elev_acc`` ((n_cells,)
    int64 fixed-point elevation), and raising ``status`` ((1,) int64) to
    the count of any cell past :data:`MAX_CELL_COUNT`; with ``count``
    ((n_cells,) float32) and ``sums`` ((n_cells, 4) float32) the same call
    runs the float32 epilogue. Shapes and dtypes are validated by the
    caller (:func:`_check_inputs`)."""
    n, w = iy.shape
    _KERNELS[compute](iy, ix, img_chw, elev, n, w, grid.n_lat, grid.n_lon,
                      acc, elev_acc, status, count, sums)


def _bin_rgbelev_cuda(grid, iy, ix, img_chw, elev, compute, finish):
    """K1 on the card: the float32 (count, sums) with ``finish``, else the
    int64 sums of :func:`bin_rgbelev_int`."""
    n_cells, dev = grid.n_lat * grid.n_lon, iy.device
    # one zero-fill for the sums and the status word
    zeros = torch.zeros(5 * n_cells + 1, dtype=torch.int64, device=dev)
    acc = zeros[:4 * n_cells].view(n_cells, 4)
    elev_acc, status = zeros[4 * n_cells:-1], zeros[-1:]
    count = sums = None
    if finish:
        count = torch.empty(n_cells, dtype=torch.float32, device=dev)
        sums = torch.empty(n_cells, 4, dtype=torch.float32, device=dev)
    launch_k1(grid, iy, ix, img_chw, elev, acc, elev_acc, status, count,
              sums, compute)
    with span("k1.wait"):
        most = int(status.item())
    refuse_cell_count(most)
    if finish:
        return (count.reshape(grid.n_lat, grid.n_lon),
                sums.reshape(grid.n_lat, grid.n_lon, 4))
    return acc, elev_acc


def bin_rgbelev_int(grid: GridSpec, iy, ix, img_chw, elev, compute="bf16"):
    """K1's integer sums, before the float32 epilogue.

    CUDA tensors go to the K1 kernel; CPU tensors to its plain version,
    :func:`bin_rgbelev_plain_int`. Any other device raises. Arguments as
    :func:`bin_rgbelev_from_indices`.

    :returns: cnt_rgb (n_cells, 4) int64 [count, R, G, B] and elev_fixed
        (n_cells,) int64, the sum of the fixed-point elevations (+ 90 deg)
        at the scale of ``compute``; both exact, so sums of several calls
        equal one call over all their samples
    """
    return _bin_rgbelev(grid, iy, ix, img_chw, elev, compute, finish=False)


def _bin_rgbelev(grid, iy, ix, img_chw, elev, compute, finish):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_compute(compute)
    if iy.device.type == "cuda":
        _check_inputs(grid, iy, ix, img_chw, elev)
        return _bin_rgbelev_cuda(grid, iy, ix, img_chw, elev, compute, finish)
    if iy.device.type == "cpu":
        sums = bin_rgbelev_plain_int(grid, iy, ix, img_chw, elev, compute)
        return finish_int_sums(grid, *sums, compute) if finish else sums
    raise ValueError(f"K1 runs on cuda (kernel) or cpu (plain); got {iy.device}")


def bin_rgbelev_from_indices(grid: GridSpec, iy, ix, img_chw, elev,
                             compute="bf16"):
    """Bin (count, R, G, B, elevation) from precomputed bin indices (K1).

    CUDA tensors go to the K1 kernel; CPU tensors to its plain version,
    :func:`bin_rgbelev_plain`. Any other device raises.

    :param iy, ix: (n, w) int32 grid row/col per sample (one frame, or a
        burst of frames stacked along the rows); -1 = invalid (samples
        outside the grid contribute nothing either). Fewer than 2^32
        samples, and at most :data:`MAX_CELL_COUNT` in any one cell.
    :param img_chw: (3, n, w) float32, integer-valued 0..255 ('uint8'
        contract)
    :param elev: (n, w) float32 elevation in degrees; NaN (at valid coords)
        contributes 0
    :param compute: 'bf16' (K1; the JAX package's name for its default
        mode) or 'i8' (K1-i8: the elevation of each sample floor-quantized
        to 2^-16 after a float32 add, as the JAX int8 variant does)
    :returns: count (n_lat, n_lon), sums (n_lat, n_lon, 4) [R, G, B, elev],
        float32. Count and R/G/B are exact; each elevation sum is within
        2^-31 ('bf16') or below 2^-16 ('i8') per sample of the exact sum,
        then rounded once to float32.
    """
    return _bin_rgbelev(grid, iy, ix, img_chw, elev, compute, finish=True)


def split_bin_indices(grid, flat, valid):
    """(flat, valid) from bin_indices -> (iy, ix) int32 with the kernel's
    -1 = invalid-sample sentinel (the bin_rgbelev_from_indices contract —
    change it HERE, not at the call sites)."""
    iy = torch.where(valid, flat // grid.n_lon, -1).to(torch.int32)
    ix = torch.where(valid, flat % grid.n_lon, -1).to(torch.int32)
    return iy, ix


def bin_mean_rgbelev(grid: GridSpec, lats, lons, data):
    """Mean-bin (R, G, B, elevation) samples with K1.

    NaN coordinates are invalid samples; NaN DATA at a valid coordinate
    contributes 0 rather than tainting the bin.

    :param lats, lons: (h, w) sample coordinates, degrees
    :param data: (h, w, 4) — integer-valued 0..255 RGB + elevation (deg)
    :returns: (count (n_lat, n_lon), means (n_lat, n_lon, 4))
    """
    with span("georegrid"):
        flat, valid = bin_indices(grid, lats, lons)
        iy, ix = split_bin_indices(grid, flat, valid)
        data = data.to(torch.float32)
        img_chw = data[..., :3].permute(2, 0, 1).contiguous()
        count, sums = bin_rgbelev_from_indices(grid, iy, ix, img_chw,
                                               data[..., 3].contiguous())
        return count, finalize_mean(count, sums)


def georegrid_inputs(grid: GridSpec, dyn: DynGeorefParams, h, w, mask=None,
                     row0=0):
    """The georeference half of :func:`georegrid_partial`: per-pixel
    (iy, ix) bin indices and the georef outputs (lat, lon, elevation) of
    ``h`` rows of a ``w``-wide frame, starting at row ``row0`` (a row block
    of a frame; 0 and the frame's height for the whole frame), in float32
    on ``dyn``'s device.

    On CUDA one launch of GEOREF_CELLS (:func:`georef_cells`) writes all
    five planes; elsewhere the eager chain, :func:`georegrid_inputs_plain`,
    computes them.

    :param mask: optional (h, w) bool, True = exclude pixel
    """
    dev = dyn.cd.device
    if dev.type != "cuda":
        # the eager chain's own planes, without the copy into fresh ones
        # that georef_cells makes on these devices
        return georegrid_inputs_plain(grid, dyn, h, w, mask, row0)
    iy, ix, elev = cell_planes(h, w, dev)
    lat, lon = (torch.empty((h, w), dtype=torch.float32, device=dev)
                for _ in range(2))
    georef_cells(grid, dyn, iy, ix, elev, mask, row0, lat, lon)
    return iy, ix, {"lat": lat, "lon": lon, "elevation": elev}


def georegrid_inputs_plain(grid: GridSpec, dyn: DynGeorefParams, h, w,
                           mask=None, row0=0):
    """:func:`georegrid_inputs` as eager tensor code on any device: the
    pixel grid, :func:`georef_latlon_dyn`, the float64 :func:`bin_indices`
    and :func:`split_bin_indices`. GEOREF_CELLS's plain twin."""
    dev = dyn.cd.device
    f32 = torch.float32
    # one span over the chain and its cells, as over GEOREF_CELLS
    with span("georegrid.georef", stream=dev):
        px = torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w)
        py = torch.arange(row0, row0 + h, dtype=f32,
                          device=dev)[:, None].expand(h, w)
        out = georef_latlon_dyn(dyn, px, py, dtype=f32, with_elevation=True)
        flat, valid = bin_indices(grid, out["lat"], out["lon"])
        if mask is not None:
            valid &= ~mask
        iy, ix = split_bin_indices(grid, flat, valid)
    return iy, ix, out


def cell_planes(h, w, device):
    """Empty (iy, ix, elevation) planes, (h, w) int32, int32 and float32,
    for :func:`georef_cells` to fill."""
    return (torch.empty((h, w), dtype=torch.int32, device=device),
            torch.empty((h, w), dtype=torch.int32, device=device),
            torch.empty((h, w), dtype=torch.float32, device=device))


def georef_cells(grid: GridSpec, dyn: DynGeorefParams, iy, ix, elev,
                 mask=None, row0=0, lat=None, lon=None):
    """Georeference rows ``row0 .. row0 + h - 1`` of a frame into the
    caller's (h, w) planes: K1's cells ``iy``/``ix`` (int32, -1 = invalid,
    the :func:`split_bin_indices` sentinel), the elevation ``elev``
    (float32) and, where given, ``lat``/``lon`` (float32 degrees). The
    planes may be row blocks of larger buffers (a burst's), as long as
    each is contiguous.

    A float32 calibration on CUDA launches GEOREF_CELLS once
    (``csrc/georef_cells.cu``), bit-equal to the eager chain on the card;
    any other dtype on CUDA raises. On other devices the eager chain
    (:func:`georegrid_inputs_plain`) computes the planes and they are
    copied in.

    :param mask: optional (h, w) bool, True = exclude pixel
    """
    h, w = iy.shape
    dev = dyn.cd.device
    if (lat is None) != (lon is None):
        raise ValueError("lat and lon are written together")
    for name, t, dtype in (("iy", iy, torch.int32), ("ix", ix, torch.int32),
                           ("elev", elev, torch.float32),
                           ("lat", lat, torch.float32),
                           ("lon", lon, torch.float32)):
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != (h, w) or t.device != dev:
            raise ValueError(f"{name}: want {dtype} {(h, w)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type != "cuda":
        fiy, fix, out = georegrid_inputs_plain(grid, dyn, h, w, mask, row0)
        for t, v in ((iy, fiy), (ix, fix), (elev, out["elevation"]),
                     (lat, out["lat"]), (lon, out["lon"])):
            if t is not None:
                t.copy_(v)
        return
    for name, shape in _CELLS_DYN.items():
        t = getattr(dyn, name)
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"dyn.{name}: GEOREF_CELLS takes one frame's "
                             f"float32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if grid.n_lat * grid.n_lon >= 2 ** 31:
        raise ValueError("grid too large for int32 cell indices")
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != (h, w) or \
                mask.device != dev:
            raise ValueError(f"mask: want bool {(h, w)} on {dev}, got "
                             f"{mask.dtype} {tuple(mask.shape)} on "
                             f"{mask.device}")
        mask = mask.contiguous()
    if h * w == 0:  # nothing to launch
        return
    with span("georegrid.georef", stream=dev):
        _launch_georef_cells(grid, dyn, iy, ix, elev, mask, row0, lat, lon)


def _launch_georef_cells(grid, dyn, iy, ix, elev, mask, row0, lat, lon):
    """One GEOREF_CELLS launch on the current stream; the arguments are
    validated by :func:`georef_cells`."""
    fields = [getattr(dyn, name).contiguous() for name in _CELLS_DYN]
    h, w = iy.shape
    # bin_indices' edges; ATen divides a CUDA tensor by a Python float as
    # a product with the reciprocal, rounded in float64 on the host
    lat_hi_edge = grid.lat0 + grid.lat_step / 2
    lon_lo_edge = grid.lon0 - grid.lon_step / 2
    GEOREF_CELLS(*fields, mask, h, w, row0, grid.n_lat, grid.n_lon,
                 lat_hi_edge, 1.0 / grid.lat_step, lon_lo_edge,
                 1.0 / grid.lon_step, *_CHAIN_CONSTS, iy, ix, elev, lat, lon)


def georegrid_partial(grid: GridSpec, dyn: DynGeorefParams, img_chw,
                      mask=None):
    """Fused georef + mean-regrid partial: (count, sums) for one frame.

    :param grid: fixed plate-carree target grid
    :param dyn: per-frame calibration (DynGeorefParams, float32, on the
        compute device)
    :param img_chw: (3, h, w) image on the same device, channels first,
        integer-valued 0..255
    :param mask: optional (h, w) bool, True = exclude pixel
    :returns: count (n_lat, n_lon) and sums (n_lat, n_lon, 4) over
        channels (R, G, B, elevation)
    """
    with span("georegrid"):
        return _georegrid_sums(grid, dyn, img_chw, mask)


def _georegrid_sums(grid, dyn, img_chw, mask):
    _, h, w = img_chw.shape
    iy, ix, elev = cell_planes(h, w, dyn.cd.device)
    georef_cells(grid, dyn, iy, ix, elev, mask)
    return bin_rgbelev_from_indices(grid, iy, ix,
                                    img_chw.to(torch.float32).contiguous(),
                                    elev)


def georegrid_mean(grid: GridSpec, dyn: DynGeorefParams, img_chw, mask=None):
    """Fused georef + mean regrid: (count, means); NaN where empty."""
    with span("georegrid"):
        count, sums = _georegrid_sums(grid, dyn, img_chw, mask)
        return count, finalize_mean(count, sums)
