"""Fused per-pixel georeferencing: camera -> sky -> Earth in plain torch.

Counterpart of ``auromat_tpu.ops.georef``: the per-pixel chain of the fused
georegrid path (:func:`georef_latlon_dyn`) and the full-frame corner +
centre georeference behind ``create_mapping`` (:func:`georeference`):

    pixel grid -> CD matmul -> TAN unproject -> celestial rotation (J2000 dirs)
    -> ray/ellipsoid intersection at emission altitude -> GEO rotation ->
    Bowring geodetic -> lat/lon/elevation

Per-frame scalars (WCS solution, camera position, frame matrices) are
host-computed float64 (:class:`GeorefParams`) and travel to the device as
a :class:`DynGeorefParams` of 0-d/small tensors in the working dtype. The
per-pixel chain is elementwise tensor code in the dtype and on the device
of its inputs; the operation order follows the JAX package so the two
round alike (XLA-CPU contracts a*b+c into fma where eager torch rounds
after each op, so the f32 chains agree to a tolerance, not bitwise).

Frame-convention note (parity-relevant): like the reference, the ellipsoid is
treated as axis-aligned in the GCRS/J2000 frame, and ICRS directions are used
as GCRS (auromat/mapping/astrometry.py:245-269).
"""

import math
from dataclasses import dataclass
from datetime import datetime
from typing import NamedTuple

import numpy as np
import torch

from auromat_tpu_torch.constants import WGS84_A, WGS84_B
from auromat_tpu_torch.coordinates.frames import FrameMatrices
from auromat_tpu_torch.coordinates.wcs import (TanWcs, ZenithalWcs,
                                               pix2world_dirs)


@dataclass(frozen=True)
class GeorefParams:
    """Static (hashable) per-frame scalar calibration for the georef chain.

    Arrays are stored as nested tuples of Python floats; use :meth:`from_wcs`
    to build from a parsed WCS header + camera state.
    """

    width: int
    height: int
    cd: tuple  # 2x2
    px_ref: float
    py_ref: float
    rotmat: tuple  # 3x3 native->celestial (ICRS~GCRS)
    camera_pos: tuple  # (3,) GCRS km
    altitude: float  # emission altitude km
    mat_j2000_to_geo: tuple  # 3x3
    mat_j2000_to_sm: tuple  # 3x3

    @staticmethod
    def from_wcs(wcs: TanWcs, camera_pos, photo_time: datetime, altitude=110.0,
                 frame_matrices: FrameMatrices = None):
        fm = frame_matrices or FrameMatrices(photo_time)
        t = lambda a: tuple(tuple(float(v) for v in row)
                            for row in np.asarray(a, dtype=np.float64))
        return GeorefParams(
            width=int(wcs.width),
            height=int(wcs.height),
            cd=t(wcs.cd),
            px_ref=float(wcs.px_ref),
            py_ref=float(wcs.py_ref),
            rotmat=t(wcs.rotmat),
            camera_pos=tuple(float(v) for v in np.asarray(camera_pos)),
            altitude=float(altitude),
            mat_j2000_to_geo=t(fm.j2000_to_geo),
            mat_j2000_to_sm=t(fm.j2000_to_sm),
        )


class DynGeorefParams(NamedTuple):
    """Per-frame calibration as tensors on the compute device.

    Same fields as :class:`GeorefParams` minus the static image shape.
    """

    cd: torch.Tensor  # (2, 2)
    px_ref: torch.Tensor  # ()
    py_ref: torch.Tensor  # ()
    rotmat: torch.Tensor  # (3, 3)
    camera_pos: torch.Tensor  # (3,)
    altitude: torch.Tensor  # ()
    mat_j2000_to_geo: torch.Tensor  # (3, 3)
    mat_j2000_to_sm: torch.Tensor  # (3, 3)

    @staticmethod
    def from_static(p: GeorefParams, device, dtype=torch.float64):
        """``p`` as tensors on ``device`` (required: 'cpu' or a CUDA
        device; CUDA raises without a card)."""
        return dyn_params_from_numpy(
            {f: np.asarray(getattr(p, f), dtype=np.float64)
             for f in DynGeorefParams._fields}, compute_device(device), dtype)

    def to(self, device, dtype):
        return DynGeorefParams(*(v.to(device=device, dtype=dtype)
                                 for v in self))

    @staticmethod
    def stack(params_list, dtype=torch.float32, *, device):
        """Stack per-frame calibration (a list of :class:`GeorefParams`)
        along a new leading frame axis: numpy stacking on the host, then
        ONE transfer of all fields to ``device`` (required, as for
        :meth:`from_static`)."""
        fields = [np.stack([np.asarray(getattr(p, f), dtype=np.float64)
                            for p in params_list])
                  for f in DynGeorefParams._fields]
        n = len(params_list)
        flat = torch.from_numpy(np.concatenate(
            [a.reshape(n, -1) for a in fields], axis=1)).to(
                device=compute_device(device), dtype=dtype)
        cols = np.cumsum([0] + [a[0].size for a in fields])
        return DynGeorefParams(*(
            flat[:, c0:c1].reshape(a.shape)
            for a, c0, c1 in zip(fields, cols[:-1], cols[1:])))

    def frame(self, i):
        """Frame ``i`` of a stacked :class:`DynGeorefParams` (views)."""
        return DynGeorefParams(*(v[i] for v in self))


def dyn_params_from_numpy(fields, device, dtype):
    """A :class:`DynGeorefParams` from a dict of numpy arrays keyed by field.

    Carries calibration across from the JAX package: pass
    ``{f: np.asarray(getattr(jax_dyn, f)) for f in DynGeorefParams._fields}``
    so both packages compute on identical values.
    """
    return DynGeorefParams(**{
        f: torch.as_tensor(np.array(fields[f]), dtype=dtype, device=device)
        for f in DynGeorefParams._fields})


def _pixel_dirs(p, px, py):
    """TAN unprojection to unit J2000 direction components (fused).

    Trig-free: with u = (180/pi)/R the native-spherical direction is
        (cos t cos phi, cos t sin phi, sin t)
      = (-y, x, u) / sqrt(x^2 + y^2 + u^2)
    since cos(arctan2(x,-y)) = -y/R, sin = x/R, and sin(arctan u') with
    u' = u/R collapses against R.
    """
    cd = p.cd
    dx = px - (p.px_ref - 1.0)
    dy = py - (p.py_ref - 1.0)
    x = cd[0][0] * dx + cd[0][1] * dy
    y = cd[1][0] * dx + cd[1][1] * dy
    u = 180.0 / math.pi
    inv = torch.rsqrt(x * x + y * y + u * u)
    l_ = -y * inv
    m_ = x * inv
    n_ = u * inv
    rm = p.rotmat
    vx = rm[0][0] * l_ + rm[0][1] * m_ + rm[0][2] * n_
    vy = rm[1][0] * l_ + rm[1][1] * m_ + rm[1][2] * n_
    vz = rm[2][0] * l_ + rm[2][1] * m_ + rm[2][2] * n_
    return vx, vy, vz


def georef_dirs_dyn(p: DynGeorefParams, px, py):
    """Pixel coords -> J2000 unit directions (vx, vy, vz) with per-frame
    params ``p``, on the device and in the dtype of ``p``, ``px`` and
    ``py``."""
    return _pixel_dirs(p, px, py)


def _intersect(p, vx, vy, vz, dtype):
    """Directed ray/inflated-ellipsoid intersection (origin = camera).

    Rays that miss (or hit behind the camera) give NaN coordinates.
    """
    a = WGS84_A + p.altitude
    b = WGS84_B + p.altitude
    ox, oy, oz = p.camera_pos[0], p.camera_pos[1], p.camera_pos[2]
    # a camera inside the inflated ellipsoid takes the far root
    inside = (ox / a) ** 2 + (oy / a) ** 2 + (oz / b) ** 2 < 1.0
    # scaled-space quadratic (the reference's formulation,
    # intersection.py:58-104)
    inv_a, inv_b = 1.0 / a, 1.0 / b
    dsx, dsy, dsz = vx * inv_a, vy * inv_a, vz * inv_b
    osx = (-ox * inv_a).to(dtype)
    osy = (-oy * inv_a).to(dtype)
    osz = (-oz * inv_b).to(dtype)
    b_q = dsx * osx + dsy * osy + dsz * osz
    a_q = dsx * dsx + dsy * dsy + dsz * dsz
    c_q = osx * osx + osy * osy + osz * osz
    root = torch.sqrt(b_q * b_q - c_q * a_q + a_q)
    d = torch.where(inside, b_q + root, b_q - root)
    d = torch.where(d < 0, torch.nan, d) / a_q
    return ox + d * vx, oy + d * vy, oz + d * vz


def _bowring(x, y, z, a=WGS84_A, b=WGS84_B):
    e2 = (a * a - b * b) / (a * a)
    d = (a * a - b * b) / b
    p2 = x * x + y * y
    p = torch.sqrt(p2)
    r = torch.sqrt(p2 + z * z)
    tu = b * z * (1.0 + d / r) / (a * p)
    tu2 = tu * tu
    cu = 1.0 / torch.sqrt(1.0 + tu2)
    cu3 = cu * cu * cu
    su3 = cu3 * tu2 * tu
    lat = torch.atan((z + d * su3) / (p - e2 * a * cu3))
    lon = torch.atan2(y, x)
    return lat, lon


def _rot(m, x, y, z):
    return (
        m[0][0] * x + m[0][1] * y + m[0][2] * z,
        m[1][0] * x + m[1][1] * y + m[1][2] * z,
        m[2][0] * x + m[2][1] * y + m[2][2] * z,
    )


def _latlon_from_j2000(p, ix, iy, iz):
    gx, gy, gz = _rot(p.mat_j2000_to_geo, ix, iy, iz)
    lat, lon = _bowring(gx, gy, gz)
    return torch.rad2deg(lat), torch.rad2deg(lon)


def _elevation_deg(vx, vy, vz, ix, iy, iz):
    """90 deg minus angle(-ray, unit(intersection)).

    Reference: auromat/mapping/astrometry.py:200-212 — the ray direction
    is used as-is.
    """
    ilen = torch.sqrt(ix * ix + iy * iy + iz * iz)
    dot = -(vx * ix + vy * iy + vz * iz) / ilen
    alpha = torch.arccos(torch.clip(dot, -1.0, 1.0))
    return 90.0 - torch.rad2deg(alpha)


def georef_latlon_dyn(p: DynGeorefParams, px, py, dtype=torch.float32,
                      with_elevation=False, with_mlatmlt=False):
    """Georeference pixel coords (0-based pixel centres) with per-frame params.

    ``p``, ``px`` and ``py`` share one device and the dtype ``dtype``.

    :returns: dict with lat, lon (+ elevation, mlat, mlt when requested),
        degrees (MLT in hours), NaN where the ray misses the inflated
        ellipsoid
    """
    vx, vy, vz = _pixel_dirs(p, px, py)
    ix, iy, iz = _intersect(p, vx, vy, vz, dtype)
    lat, lon = _latlon_from_j2000(p, ix, iy, iz)
    out = {"lat": lat, "lon": lon}
    if with_elevation:
        out["elevation"] = _elevation_deg(vx, vy, vz, ix, iy, iz)
    if with_mlatmlt:
        out["mlat"], out["mlt"] = _mlatmlt_from_j2000(p, ix, iy, iz)
    return out


def compute_device(device):
    """``device`` as a torch.device; raises if it is CUDA and torch finds no
    CUDA device (nothing in the port falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but torch finds "
                           "no CUDA device")
    return device


def _compute_dtype(dtype):
    """The JAX package's ``"df64"`` (its double-float emulation of float64 on
    TPUs) is native float64 here."""
    if isinstance(dtype, str):
        if dtype != "df64":
            raise ValueError(f"unknown dtype {dtype!r}")
        return torch.float64
    return dtype


def _grid(width, height, corner, dtype, device):
    off = -0.5 if corner else 0.0
    extra = 1 if corner else 0
    xs = torch.arange(off, off + width + extra, dtype=dtype, device=device)
    ys = torch.arange(off, off + height + extra, dtype=dtype, device=device)
    return torch.meshgrid(xs, ys, indexing="xy")


def _mlatmlt_from_j2000(p, ix, iy, iz):
    sx, sy, sz = _rot(p.mat_j2000_to_sm, ix, iy, iz)
    mlat = torch.rad2deg(torch.atan2(sz, torch.sqrt(sx * sx + sy * sy)))
    mlt = torch.rad2deg(torch.atan2(sy, sx)) * (24.0 / 360.0) + 12.0
    return mlat, mlt


def georeference(params: GeorefParams, fast_center=False, with_mlatmlt=True,
                 dtype=torch.float64, device="cuda"):
    """Fully georeference one frame on ``device`` (the card by default;
    pass ``device="cpu"`` for the CPU).

    :param fast_center: compute pixel-centre values as the mean of the 4
        surrounding corner values instead of a second full evaluation
        (reference astrometry.py:154-160); centres are then NaN wherever
        any corner is NaN, which pre-satisfies the mask invariants
    :param dtype: torch dtype of the per-pixel chain; ``"df64"`` is float64
    :returns: dict of tensors on ``device``: lats, lons (h+1, w+1);
        lats_center, lons_center, elevation (h, w); and mlat, mlt,
        mlat_center, mlt_center if requested. NaN where rays miss the
        inflated ellipsoid.
    """
    dtype = _compute_dtype(dtype)
    p = DynGeorefParams.from_static(params, compute_device(device), dtype)
    return _georeference_body(p, params.width, params.height, fast_center,
                              with_mlatmlt, dtype)


def _generic_dirs_fn(wcs, dtype):
    def dirs(px, py):
        return tuple(v.to(dtype) for v in pix2world_dirs(wcs, px, py, origin=0))
    return dirs


def georeference_generic(wcs, params: GeorefParams, fast_center=False,
                         with_mlatmlt=True, dtype=torch.float64, device="cuda"):
    """:func:`georeference` for ANY supported FITS projection.

    Pixel directions come from the generic plane->native->celestial
    chain of the :mod:`auromat_tpu_torch.coordinates.wcs` family classes
    (``pix2world_dirs``) instead of the fused trig-free TAN
    unprojection; the downstream chain — ray/ellipsoid intersection,
    Bowring, elevation, MLat/MLT — is shared. This is the reference's
    astropy-fallback georeferencing role (reference wcs.py:18-64 via
    astrometry.py:49-64) for non-TAN headers; off-map pixels (e.g.
    outside the SIN disc) produce NaN directions and flow into the NaN
    masks naturally.

    The chain is eager: each elementwise step is one full-frame
    operation on ``device``, so an iterative inverse (PCO's bisection)
    is several hundred of them. Header constants are Python floats
    (``pix2world_dirs``), so a float32 call is float32 end to end.
    """
    dtype = _compute_dtype(dtype)
    p = DynGeorefParams.from_static(params, compute_device(device), dtype)
    return _georeference_body(p, params.width, params.height, fast_center,
                              with_mlatmlt, dtype,
                              dirs_fn=_generic_dirs_fn(wcs, dtype))


def georeference_dyn(p: DynGeorefParams, width, height, fast_center=False,
                     with_mlatmlt=True, dtype=torch.float32):
    """:func:`georeference` of one frame from its calibration as tensors
    (e.g. one :meth:`DynGeorefParams.frame` of a stacked burst), on the
    device and in the dtype of ``p``; same outputs."""
    return _georeference_body(p, width, height, fast_center, with_mlatmlt,
                              dtype)


def _georeference_body(p, width, height, fast_center, with_mlatmlt, dtype,
                       dirs_fn=None):
    dirs = dirs_fn or (lambda gx, gy: _pixel_dirs(p, gx, gy))
    dev = p.cd.device
    px, py = _grid(width, height, True, dtype, dev)
    vx, vy, vz = dirs(px, py)
    ix, iy, iz = _intersect(p, vx, vy, vz, dtype)
    lats, lons = _latlon_from_j2000(p, ix, iy, iz)
    out = {"lats": lats, "lons": lons}

    if fast_center:
        mean4 = lambda a: (a[:-1, :-1] + a[:-1, 1:] + a[1:, 1:] + a[1:, :-1]) * 0.25
        cvx, cvy, cvz = mean4(vx), mean4(vy), mean4(vz)
        cix, ciy, ciz = mean4(ix), mean4(iy), mean4(iz)
    else:
        cpx, cpy = _grid(width, height, False, dtype, dev)
        cvx, cvy, cvz = dirs(cpx, cpy)
        cix, ciy, ciz = _intersect(p, cvx, cvy, cvz, dtype)

    out["lats_center"], out["lons_center"] = _latlon_from_j2000(p, cix, ciy, ciz)
    out["elevation"] = _elevation_deg(cvx, cvy, cvz, cix, ciy, ciz)
    if with_mlatmlt:
        out["mlat"], out["mlt"] = _mlatmlt_from_j2000(p, ix, iy, iz)
        out["mlat_center"], out["mlt_center"] = _mlatmlt_from_j2000(
            p, cix, ciy, ciz)
    return out


def _points(px, py, dtype, device):
    t = lambda a: torch.as_tensor(
        a if torch.is_tensor(a) else np.asarray(a)).to(device=device,
                                                       dtype=dtype)
    return t(px), t(py)


def georeference_points(params: GeorefParams, px, py, dtype=torch.float64,
                        device="cuda"):
    """Georeference arbitrary pixel coordinates (0-based pixel centres;
    the chain of :func:`georeference` on an explicit point set).

    :returns: (lat, lon) degree tensors on ``device``
    """
    dtype = _compute_dtype(dtype)
    device = compute_device(device)
    p = DynGeorefParams.from_static(params, device, dtype)
    px, py = _points(px, py, dtype, device)
    out = georef_latlon_dyn(p, px, py, dtype)
    return out["lat"], out["lon"]


def _points_chain(params, px, py, dtype, device, dirs_fn, with_elevation,
                  with_mlatmlt):
    p = DynGeorefParams.from_static(params, device, dtype)
    px, py = _points(px, py, dtype, device)
    vx, vy, vz = dirs_fn(px, py) if dirs_fn else _pixel_dirs(p, px, py)
    ix, iy, iz = _intersect(p, vx, vy, vz, dtype)
    out = dict(zip(("lat", "lon"), _latlon_from_j2000(p, ix, iy, iz)))
    if with_elevation:
        out["elevation"] = _elevation_deg(vx, vy, vz, ix, iy, iz)
    if with_mlatmlt:
        out["mlat"], out["mlt"] = _mlatmlt_from_j2000(p, ix, iy, iz)
    return out


def georeference_points_generic(wcs, params: GeorefParams, px, py,
                                dtype=torch.float64, with_elevation=False,
                                device="cuda"):
    """:func:`georeference_points` for ANY supported FITS projection.

    Directions come from the generic plane->native->celestial chain
    (:func:`auromat_tpu_torch.coordinates.wcs.pix2world_dirs`, the
    reference's astropy-fallback role — reference wcs.py:18-64) instead
    of the fused TAN unprojection; intersection and Bowring are shared.

    :returns: (lat, lon[, elevation]) degree tensors on ``device``
    """
    dtype = _compute_dtype(dtype)
    out = _points_chain(params, px, py, dtype, compute_device(device),
                        _generic_dirs_fn(wcs, dtype), with_elevation, False)
    if with_elevation:
        return out["lat"], out["lon"], out["elevation"]
    return out["lat"], out["lon"]


def georeference_points_df64_full(params: GeorefParams, px, py,
                                  with_elevation=True, with_mlatmlt=True,
                                  projection="TAN", wcs=None, device="cuda"):
    """Full-precision chain over every exported per-pixel variable (lat,
    lon, elevation, mlat, mlt) as a dict of host float64 arrays, NaN where
    the ray misses.

    The JAX package computes this in (hi, lo) float32 pairs because its
    device has no float64; here it is the native float64 chain on
    ``device``, and it takes every projection family: ``projection``
    names a radial zenithal law (TAN fused; SIN/ZEA/ARC/STG from the
    calibration), ``wcs`` any object :func:`make_wcs` builds (it then
    decides the projection). The variable set is selectable as in the JAX
    package (``with_elevation``, ``with_mlatmlt``).
    """
    dirs_fn = None
    if wcs is not None and not isinstance(wcs, TanWcs):
        dirs_fn = _generic_dirs_fn(wcs, torch.float64)
    elif wcs is None and projection != "TAN":
        dirs_fn = _generic_dirs_fn(
            ZenithalWcs.from_calibration(projection, params.cd, params.rotmat,
                                         params.px_ref, params.py_ref),
            torch.float64)
    out = _points_chain(params, px, py, torch.float64,
                        compute_device(device), dirs_fn, with_elevation,
                        with_mlatmlt)
    return {k: v.cpu().numpy() for k, v in out.items()}


def georeference_points_df64(params: GeorefParams, px, py, device="cuda"):
    """Full-precision (lat_deg, lon_deg) host float64 arrays of a TAN
    calibration: native float64 on ``device`` (see
    :func:`georeference_points_df64_full`)."""
    out = georeference_points_df64_full(params, px, py, with_elevation=False,
                                        with_mlatmlt=False, device=device)
    return out["lat"], out["lon"]
