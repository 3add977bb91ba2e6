"""Plate-carree regridding: the fixed global grid and its bin indices.

Counterpart of ``auromat_tpu.ops.regrid``: the host-side grid definition
(:class:`GridSpec`, :func:`fixed_grid`), the per-sample bin index
(:func:`bin_indices`), the final divide (:func:`finalize_mean`), and the
float64 mean binning with the reference's NaN-taint semantics
(:func:`bin_mean`, :func:`bin_partial`). The kernels that bin are K1
(:mod:`auromat_tpu_torch.ops.georegrid`) and K2/K3
(:mod:`auromat_tpu_torch.ops.regrid_pallas`).

Grid alignment: all resamplings share one global grid per resolution
(reference resample.py:281-299 ``fixedGrid``) so mosaics line up cell-exact.
"""

from dataclasses import dataclass

import numpy as np
import torch


def round_up(x, m):
    """Smallest multiple of m >= x (tile/window padding helper)."""
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class GridSpec:
    """A fixed plate-carree grid (host-side).

    Latitudes DEcrease along rows (north at row 0), longitudes increase along
    columns — the reference's output orientation (resample.py:228-237).
    ``lat0``/``lon0`` are the *centre* coordinates of the first (north-west)
    cell; ``lat_step`` is positive.
    """

    n_lat: int
    n_lon: int
    lat0: float
    lon0: float
    lat_step: float
    lon_step: float

    @property
    def lat_centers(self):
        return self.lat0 - np.arange(self.n_lat) * self.lat_step

    @property
    def lon_centers(self):
        return self.lon0 + np.arange(self.n_lon) * self.lon_step

    @property
    def lat_corners(self):
        return self.lat0 + self.lat_step / 2 - np.arange(self.n_lat + 1) * self.lat_step

    @property
    def lon_corners(self):
        return self.lon0 - self.lon_step / 2 + np.arange(self.n_lon + 1) * self.lon_step

    def corner_grids(self):
        """(lats, lons) 2D corner arrays of shape (n_lat+1, n_lon+1)."""
        return np.meshgrid(self.lon_corners, self.lat_corners)[::-1]

    def center_grids(self):
        return np.meshgrid(self.lon_centers, self.lat_centers)[::-1]


def fixed_grid(px_per_deg, lat_min, lat_max, lon_min, lon_max):
    """Align a bounding box to the global fixed grid; return a GridSpec.

    Semantics follow the reference exactly (auromat/resample.py:281-299 plus
    the first/last trimming at resample.py:229-237): the returned grid's
    *centre* rows/columns are the global grid lines strictly inside the
    aligned box (first and last alignment line dropped).

    :param px_per_deg: (lat_px_per_deg, lon_px_per_deg) or a scalar
    :param lon_min, lon_max: must NOT contain the discontinuity
    """
    try:
        lat_ppd, lon_ppd = px_per_deg
    except TypeError:
        lat_ppd = lon_ppd = float(px_per_deg)
    assert lat_ppd > 0 and lon_ppd > 0

    n_lat_all = int(round(lat_ppd * 180 + 1))
    n_lon_all = int(round(lon_ppd * 360 + 1))
    lat_all = np.linspace(-90, 90, n_lat_all)
    lon_all = np.linspace(-180, 180, n_lon_all)
    lat_lo = lat_all[np.argmax(lat_all > lat_min) - 1]
    lat_hi = lat_all[np.argmax(lat_all >= lat_max)]
    lon_lo = lon_all[np.argmax(lon_all > lon_min) - 1]
    lon_hi = lon_all[np.argmax(lon_all >= lon_max)]
    n_lat = int(round(lat_ppd * (lat_hi - lat_lo) + 1))
    n_lon = int(round(lon_ppd * (lon_hi - lon_lo) + 1))
    assert n_lat > 2 and n_lon > 2, (n_lat, n_lon)

    # canonical global steps (identical for every bbox at this resolution,
    # unlike the reference's per-bbox linspace retstep which carries float
    # jitter in the last ulps, resample.py:229-230)
    lat_step = 180.0 / (n_lat_all - 1)
    lon_step = 360.0 / (n_lon_all - 1)
    # drop the outermost centre lines (reference resample.py:232-237)
    return GridSpec(
        n_lat=n_lat - 2,
        n_lon=n_lon - 2,
        lat0=lat_hi - lat_step,
        lon0=lon_lo + lon_step,
        lat_step=lat_step,
        lon_step=lon_step,
    )


def bin_indices(grid: GridSpec, lats, lons):
    """Flat bin index per sample; out-of-range/NaN -> n_bins (dump slot).

    Bin edges are centre +- step/2, matching the reference's histogram2d
    ranges (resample.py:330-338). Following numpy histogram semantics the
    right-most edge is inclusive.

    The cell arithmetic runs in float64 with true division whatever the
    dtype of ``lats``/``lons``: that is what the JAX package computes
    (``fixed_grid``'s float64 edges promote its f32 coordinates under x64),
    and it is the only form that puts every f32 sample in the same cell.
    Validity is decided on the float values, so a NaN, inf or out-of-range
    coordinate is never cast to int32.

    :returns: (flat int32, valid bool), both shaped like ``lats``
    """
    lat_hi_edge = grid.lat0 + grid.lat_step / 2
    lon_lo_edge = grid.lon0 - grid.lon_step / 2
    fy = (lat_hi_edge - lats.double()) / grid.lat_step
    fx = (lons.double() - lon_lo_edge) / grid.lon_step
    iy = torch.floor(fy)
    ix = torch.floor(fx)
    # inclusive right-most edge: clamp samples exactly on the far edge
    iy = torch.where(fy == grid.n_lat, grid.n_lat - 1.0, iy)
    ix = torch.where(fx == grid.n_lon, grid.n_lon - 1.0, ix)
    # NaN fails every comparison; +-inf fails the range test
    valid = (iy >= 0) & (iy < grid.n_lat) & (ix >= 0) & (ix < grid.n_lon)
    flat = torch.where(valid, iy * grid.n_lon + ix, grid.n_lat * grid.n_lon)
    return flat.to(torch.int32), valid


def finalize_mean(count, sums):
    """Divide reduced partial sums by counts; NaN where empty."""
    c = count[..., None]
    return torch.where(c > 0, sums / c, torch.nan)


def _bin_sum_index_add(flat_idx, data, n_bins):
    """(n_bins, 1 + C) float64 [count, channel sums]: one ``index_add_``,
    with the invalid samples (``flat_idx == n_bins``) in a dropped slot."""
    vals = torch.cat([torch.ones_like(data[:, :1]), data], dim=1)
    acc = torch.zeros(n_bins + 1, vals.shape[1], dtype=torch.float64,
                      device=data.device)
    acc.index_add_(0, flat_idx.long(), vals)
    return acc[:-1]


# The JAX package's binning methods (segment sums, a scatter, and three
# sort + compensated-prefix-sum variants) exist because a TPU serializes
# scatter-adds. A GPU adds in place, so every method name is the same plain
# float64 index_add_; the names stay so that callers' code runs unchanged.
_BIN_METHODS = {name: _bin_sum_index_add for name in (
    "segment", "scatter", "sorted", "sorted_gather", "sorted_packed")}


def _flat_samples(grid, lats, lons, data):
    n_ch = data.shape[-1]
    flat_idx, valid = bin_indices(grid, lats.reshape(-1), lons.reshape(-1))
    flat_data = data.reshape(-1, n_ch).to(torch.float64)
    # zero out data of invalid samples so the dropped slot stays finite
    return flat_idx, torch.where(valid[:, None], flat_data, 0.0)


def bin_mean(grid: GridSpec, lats, lons, data, method="sorted"):
    """Mean-bin multi-channel samples onto the grid (float64 sums).

    :param lats, lons: sample coordinates (any shape), NaN = masked
    :param data: (..., C) channel values per sample. NaN data at VALID
        coordinates taints its bin's mean in that channel only (numpy
        bincount/histogram2d semantics, which the reference relies on: it
        bins img+elevation filled with NaN). NaNs are zeroed and binned
        alongside per-channel taint indicator channels.
    :param method: any name of ``_BIN_METHODS``
    :returns: (count (n_lat, n_lon), means (n_lat, n_lon, C)), in the
        promotion of ``data``'s dtype and float32; means are NaN where
        count == 0
    """
    fn = _BIN_METHODS[method]
    n_ch = data.shape[-1]
    out_dtype = torch.promote_types(data.dtype, torch.float32)
    flat_idx, flat_data = _flat_samples(grid, lats, lons, data)
    taint = torch.isnan(flat_data)
    flat_data = torch.cat([torch.where(taint, 0.0, flat_data),
                           taint.to(torch.float64)], dim=1)
    acc = fn(flat_idx, flat_data, grid.n_lat * grid.n_lon)
    count = acc[:, 0].reshape(grid.n_lat, grid.n_lon)
    sums = acc[:, 1:1 + n_ch].reshape(grid.n_lat, grid.n_lon, n_ch)
    taints = acc[:, 1 + n_ch:].reshape(grid.n_lat, grid.n_lon, n_ch)
    means = torch.where(taints > 0, torch.nan, finalize_mean(count, sums))
    return count.to(out_dtype), means.to(out_dtype)


def bin_partial(grid: GridSpec, lats, lons, data, method="segment"):
    """Per-shard partial accumulation: (count, sums) without the divide.

    NaN data at valid coordinates is treated as 0 here (partial sums must
    stay finite for a cross-shard reduction); use :func:`bin_mean` for the
    reference's NaN-taint semantics.

    ``method='pallas'`` goes to the K2 binning kernel
    (:func:`auromat_tpu_torch.ops.regrid_pallas.bin_partial_pallas2`,
    (h, w) inputs, 'uint8' channel contract). Any other method name sums
    in float64 and returns the promotion of ``data``'s dtype and float32.
    """
    if method == "pallas":
        from auromat_tpu_torch.ops.regrid_pallas import bin_partial_pallas2

        return bin_partial_pallas2(grid, lats, lons, data, "uint8")
    fn = _BIN_METHODS[method]
    n_ch = data.shape[-1]
    out_dtype = torch.promote_types(data.dtype, torch.float32)
    flat_idx, flat_data = _flat_samples(grid, lats, lons, data)
    flat_data = torch.where(torch.isnan(flat_data), 0.0, flat_data)
    acc = fn(flat_idx, flat_data, grid.n_lat * grid.n_lon)
    count = acc[:, 0].reshape(grid.n_lat, grid.n_lon)
    sums = acc[:, 1:].reshape(grid.n_lat, grid.n_lon, n_ch)
    return count.to(out_dtype), sums.to(out_dtype)
