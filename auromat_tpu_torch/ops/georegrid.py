"""Fused georeference + regrid: the single-frame production path.

Counterpart of ``auromat_tpu.ops.georegrid``. One call runs the full
pipeline forward (pixel grid -> TAN unproject -> ray/ellipsoid
intersection -> GEO rotation -> Bowring lat/lon + elevation -> fixed-grid
bin indices -> mean binning) for one frame:

- the georeference chain (:mod:`auromat_tpu_torch.ops.georef`) and the bin
  indices (:func:`auromat_tpu_torch.ops.regrid.bin_indices`) are plain
  elementwise tensor code;
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
integer sums themselves, for callers that add them across calls.

Reference: auromat/mapping/astrometry.py:49-212 + auromat/resample.py:
328-351 (the lazy-property pyramid + histogram2d rebin, fused).
"""

import ctypes

import torch

from auromat_tpu_torch.ops._kernels import GEOREGRID_BIN, GEOREGRID_BIN_I8
from auromat_tpu_torch.ops.georef import DynGeorefParams, georef_latlon_dyn
from auromat_tpu_torch.ops.regrid import GridSpec, bin_indices, finalize_mean
from auromat_tpu_torch.profiling import span

ELEV_OFFSET = 90.0  # elevation + 90 >= 0: the fixed-point sums are unsigned
ELEV_SCALE = 2.0 ** 30  # fixed-point scale of the elevation sums
ELEV_SCALE_I8 = 2.0 ** 16  # K1-i8: elevation floor-quantized to 2^-16
_KERNELS = {"bf16": GEOREGRID_BIN, "i8": GEOREGRID_BIN_I8}
# the most samples a cell may hold: 255 * count still fits a uint32 word
MAX_CELL_COUNT = (2 ** 32 - 1) // 255  # 16,843,009


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
    for name, t in (("iy", iy), ("ix", ix), ("img_chw", img_chw),
                    ("elev", elev)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the K1 kernel")
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    n, w = iy.shape
    with torch.cuda.device(iy.device):  # the launcher reads the current device
        _KERNELS[compute](
            ptr(iy), ptr(ix), ptr(img_chw), ptr(elev), n, w, grid.n_lat,
            grid.n_lon, ptr(acc), ptr(elev_acc), ptr(status), ptr(count),
            ptr(sums), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))


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
        with span("georegrid.bin_indices", stream=lats.device):
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

    :param mask: optional (h, w) bool, True = exclude pixel
    """
    dev = dyn.cd.device
    f32 = torch.float32
    with span("georegrid.georef", stream=dev):
        px = torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w)
        py = torch.arange(row0, row0 + h, dtype=f32,
                          device=dev)[:, None].expand(h, w)
        out = georef_latlon_dyn(dyn, px, py, dtype=f32, with_elevation=True)
    with span("georegrid.bin_indices", stream=dev):
        flat, valid = bin_indices(grid, out["lat"], out["lon"])
        if mask is not None:
            valid &= ~mask
        iy, ix = split_bin_indices(grid, flat, valid)
    return iy, ix, out


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
    iy, ix, out = georegrid_inputs(grid, dyn, h, w, mask)
    return bin_rgbelev_from_indices(grid, iy, ix,
                                    img_chw.to(torch.float32).contiguous(),
                                    out["elevation"].contiguous())


def georegrid_mean(grid: GridSpec, dyn: DynGeorefParams, img_chw, mask=None):
    """Fused georef + mean regrid: (count, means); NaN where empty."""
    with span("georegrid"):
        count, sums = _georegrid_sums(grid, dyn, img_chw, mask)
        return count, finalize_mean(count, sums)
