"""Resample mappings onto regular plate-carree grids (the 'mean' method).

Counterpart of ``auromat_tpu.resample``: pole rotation and discontinuity
shifting on the host, the mean binning on ``device``. The binning routes
as the JAX package routes on a TPU (resample.py:157-178), with a CUDA
device in the TPU's place:

- uint8 RGB with elevation -> K1 (``'pallas_rgbelev'``,
  :func:`auromat_tpu_torch.ops.georegrid.bin_mean_rgbelev`);
- any other uint8 image -> K2 (``'pallas_taint'``,
  :func:`auromat_tpu_torch.ops.regrid_pallas.bin_mean_pallas_taint`);
- anything else, and every image on the CPU -> ``'sorted'``, the float64
  scatter of :func:`auromat_tpu_torch.ops.regrid.bin_mean`.

An explicit ``'pallas_*'`` method on the CPU runs the kernel's plain
version. The K1/K2 routes divide means in float32, so a uint8 mean that
sits on a .5 boundary may round one step away from the float64 route.

Not ported: the interpolation methods ('nearest', 'linear', 'cubic' and
their device forms; ROADMAP queue 1 item 9), ``mosaic``,
``resample_mlat_mlt`` and ``ResampleProvider``; nor the JAX package's TPU
workarounds here (``host_f64_device``, ``_initialized_backend_is_tpu``):
host math is numpy or CPU torch in float64 directly.
"""

import numpy as np
import torch

from auromat_tpu_torch.coordinates import geodesic
from auromat_tpu_torch.coordinates.geodesic import Location
from auromat_tpu_torch.coordinates.transform import rotate_pole
from auromat_tpu_torch.mapping.mapping import (BoundingBox, Mapping,
                                               MappingCollection)
from auromat_tpu_torch.ops.georef import compute_device
from auromat_tpu_torch.ops.regrid import bin_mean, fixed_grid
from auromat_tpu_torch.utils import wrap_lon_180 as _wrap_lon_np


def plate_carree_resolution(bounding_box: BoundingBox, arcsec_per_px):
    """(lat_px_per_deg, lon_px_per_deg) approximating a spherical resolution
    at the bbox centre. Reference: auromat/resample.py:36-61."""
    deg_per_px = arcsec_per_px / 3600.0
    lat_px_per_deg = 1.0 / deg_per_px
    lat_middle = (bounding_box.latNorth + bounding_box.latSouth) / 2
    middle_left = Location(lat_middle, bounding_box.lonWest)
    middle_right = Location(lat_middle, bounding_box.lonEast)
    lon_middle_distance = geodesic.angular_distance(middle_left, middle_right)
    px = lon_middle_distance / deg_per_px
    lon_east = bounding_box.lonEast
    if bounding_box.lonWest > lon_east:
        lons = lon_east + 360 - bounding_box.lonWest
    else:
        lons = lon_east - bounding_box.lonWest
    lon_ppd = px / lons
    if not lon_ppd > 0:
        # pole-containing boxes span -180..180: the two mid-edge points
        # coincide and the measured lon width degenerates to zero. The pole
        # path resamples in a rotated frame anyway, where the original lon
        # resolution has no special meaning.
        lon_ppd = lat_px_per_deg
    return lat_px_per_deg, lon_ppd


def resample(mapping_or_collection, px_per_deg=25, arcsec_per_px=None,
             contains_pole=None, method="mean", bin_method="auto",
             device="cuda"):
    """Resample image+elevation onto a regular lat/lon grid.

    With 'mean' binning, high target resolutions produce empty cells at low
    elevations — mask by elevation first (reference resample.py:79-84).

    :param px_per_deg: scalar or (lat, lon) pixels per degree
    :param arcsec_per_px: spherical resolution (overrides px_per_deg)
    :param method: 'mean'; the interpolation methods are not ported yet
    :param bin_method: 'auto' (see the module docstring), 'pallas_rgbelev'
        (K1), 'pallas_taint' (K2) or any ``ops.regrid._BIN_METHODS`` name
    :param device: where the binning runs (the card by default; pass
        ``device="cpu"`` for the CPU); the result is a host Mapping
    :rtype: Mapping or MappingCollection
    """
    if isinstance(mapping_or_collection, MappingCollection):
        return MappingCollection(
            [resample(m, px_per_deg, arcsec_per_px, contains_pole, method,
                      bin_method, device)
             for m in mapping_or_collection.mappings],
            mapping_or_collection.identifier,
            mayOverlap=mapping_or_collection.mayOverlap,
        )
    mapping = mapping_or_collection
    if not isinstance(mapping, Mapping):
        raise ValueError(f"not a mapping or collection: {type(mapping)}")
    if method != "mean":
        raise NotImplementedError(
            f"resample method {method!r} is not ported yet (ROADMAP queue 1 "
            "item 9, interpolation); only 'mean' is")
    device = compute_device(device)

    if contains_pole is None:
        contains_pole = mapping.containsPole
    if arcsec_per_px:
        px_per_deg = plate_carree_resolution(mapping.boundingBox, arcsec_per_px)
    else:
        try:
            _, _ = px_per_deg
        except TypeError:
            px_per_deg = (px_per_deg, px_per_deg)

    img = mapping.img
    img_dtype = img.dtype
    if bin_method == "auto":
        n_ch = img.shape[2] if img.ndim == 3 else 1
        on_gpu = device.type == "cuda"
        if on_gpu and img_dtype == np.uint8 and n_ch == 3 and \
                mapping.elevation is not None:
            # K1; its NaN-data-adds-0 contract equals taint semantics here:
            # mask invariants put NaN data only at NaN coordinates
            bin_method = "pallas_rgbelev"
        elif on_gpu and img_dtype == np.uint8:
            bin_method = "pallas_taint"
        else:
            bin_method = "sorted"
    img3 = img if img.ndim == 3 else img[:, :, None]
    parts = [np.asarray(img3.astype(np.float64).filled(np.nan))]
    has_elevation = mapping.elevation is not None
    if has_elevation:  # CDF/netCDF files without zenith_angle have none
        parts.append(np.asarray(mapping.elevation.filled(np.nan))[:, :, None])
    merged = np.concatenate(parts, axis=-1)
    lats, lons, lats_c, lons_c, data = _resample(
        np.asarray(mapping.latsCenter.filled(np.nan)),
        np.asarray(mapping.lonsCenter.filled(np.nan)),
        mapping.altitude, merged, lambda: mapping.outline.copy(),
        mapping.boundingBox, px_per_deg, mapping.containsDiscontinuity,
        contains_pole, bin_method, device,
    )
    img_r = data[..., :-1] if has_elevation else data
    elevation_r = data[..., -1] if has_elevation else None
    if np.issubdtype(img_dtype, np.integer):
        img_r = _finalize_int_image(img_r, img_dtype)
    if img3.shape[2] == 1:
        img_r = img_r[..., 0]
    return mapping.createResampled(lats, lons, lats_c, lons_c, elevation_r, img_r)


def _rotate_pole_deg(la_deg, lo_deg, angle, altitude):
    """Degrees-in/degrees-out rotate-pole about the x-axis at the emission
    altitude: the one wrapper behind every pole rotation and unrotation
    here. Host float64 (CPU torch); NaN coordinates pass through as NaN."""
    la2, lo2 = rotate_pole(
        torch.from_numpy(np.deg2rad(np.asarray(la_deg, dtype=np.float64))),
        torch.from_numpy(np.deg2rad(np.asarray(lo_deg, dtype=np.float64))),
        altitude, angle_deg=angle, axis=(1, 0, 0))
    return np.rad2deg(la2.numpy()), np.rad2deg(lo2.numpy())


def _finalize_int_image(img_r, img_dtype):
    """Float resampled image -> the source integer dtype.

    Clamps to the integer range (a cast would wrap) and turns NaN (masked)
    cells into 0; the mask is re-derived from coordinates, so the fill
    value is irrelevant."""
    with np.errstate(invalid="ignore"):
        img_r = np.round(img_r)
        info = np.iinfo(img_dtype)
        img_r = np.clip(img_r, info.min, info.max)
    return np.where(np.isnan(img_r), 0, img_r).astype(img_dtype)


def grid_mapping(grid, img_r, elev_r, altitude, photo_time, identifier,
                 shift=False):
    """Assemble a :class:`Mapping` from a plate-carree
    :class:`~auromat_tpu_torch.ops.regrid.GridSpec` and finalized per-cell
    channels (camera_pos is NaN: a grid product has no single camera).
    ``shift=True`` unwraps +180-deg-shifted longitudes (the
    discontinuity-handling convention of :func:`resample`)."""
    lat_grid, lon_grid = grid.corner_grids()
    lat_grid_c, lon_grid_c = grid.center_grids()
    if shift:
        lon_grid = _wrap_lon_np(lon_grid + 180.0)
        lon_grid_c = _wrap_lon_np(lon_grid_c + 180.0)
    return Mapping(
        lat_grid, lon_grid, lat_grid_c, lon_grid_c, elev_r, altitude, img_r,
        np.full(3, np.nan), photo_time, identifier,
    )


def _bin_mean_on(device, grid, lats_center, lons_center, data, bin_method):
    """Mean-bin host arrays on ``device``; host float64 means back."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    lats, lons, data = to(lats_center), to(lons_center), to(data)
    if bin_method == "pallas_rgbelev":
        from auromat_tpu_torch.ops.georegrid import bin_mean_rgbelev

        _, data_r = bin_mean_rgbelev(grid, lats, lons, data)
    elif bin_method == "pallas_taint":
        from auromat_tpu_torch.ops.regrid_pallas import bin_mean_pallas_taint

        _, data_r = bin_mean_pallas_taint(grid, lats, lons, data)
    else:
        _, data_r = bin_mean(grid, lats, lons, data, method=bin_method)
    return data_r.to(device="cpu", dtype=torch.float64).numpy()


def _resample(lats_center, lons_center, altitude, data, outline_fn, bbox,
              px_per_deg, contains_discontinuity, contains_pole,
              bin_method, device):
    lat_min, lat_max = bbox.latSouth, bbox.latNorth
    lon_min, lon_max = bbox.lonWest, bbox.lonEast

    if contains_pole:
        outline = outline_fn()
        outline[:, 0], outline[:, 1] = _rotate_pole_deg(
            outline[:, 0], outline[:, 1], 90.0, altitude)
        lat_min, lat_max = outline[:, 0].min(), outline[:, 0].max()
        lon_min, lon_max = outline[:, 1].min(), outline[:, 1].max()
        la, lo = _rotate_pole_deg(lats_center.ravel(), lons_center.ravel(),
                                  90.0, altitude)
        lats_center = la.reshape(lats_center.shape)
        lons_center = lo.reshape(lons_center.shape)
    elif contains_discontinuity:
        outline = outline_fn()
        outline[:, 1] = _wrap_lon_np(outline[:, 1] + 180.0)
        lon_min, lon_max = outline[:, 1].min(), outline[:, 1].max()
        lons_center = _wrap_lon_np(lons_center + 180.0)

    grid = fixed_grid(px_per_deg, lat_min, lat_max, lon_min, lon_max)
    lat_grid, lon_grid = grid.corner_grids()
    lat_grid_c, lon_grid_c = grid.center_grids()
    data_r = _bin_mean_on(device, grid, lats_center, lons_center, data,
                          bin_method)

    if contains_pole:
        def unrotate(la, lo):
            la2, lo2 = _rotate_pole_deg(la.ravel(), lo.ravel(), -90.0,
                                        altitude)
            return la2.reshape(la.shape), lo2.reshape(lo.shape)

        lat_grid, lon_grid = unrotate(lat_grid, lon_grid)
        lat_grid_c, lon_grid_c = unrotate(lat_grid_c, lon_grid_c)
    elif contains_discontinuity:
        lon_grid = _wrap_lon_np(lon_grid + 180.0)
        lon_grid_c = _wrap_lon_np(lon_grid_c + 180.0)

    return lat_grid, lon_grid, lat_grid_c, lon_grid_c, data_r
