"""Plate-carree grids, cell indices and mean binning in plain PyTorch.

``fixed_grid`` is the original auromat's global grid alignment
(resample.py ``fixedGrid`` and the first/last line trimming), written from
its definition; ``cells`` puts a sample in the cell whose edges (centre
+- half a step) hold it, the right-most edge inclusive, as numpy's
histogram does, in float64.
"""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Grid:
    n_lat: int
    n_lon: int
    lat0: float  # centre of the north-west cell
    lon0: float
    lat_step: float
    lon_step: float

    @property
    def n_cells(self):
        return self.n_lat * self.n_lon

    def corners(self):
        """(lat, lon) corner lattices, (n_lat + 1, n_lon + 1), float64."""
        lat = self.lat0 + self.lat_step / 2 - np.arange(self.n_lat + 1) * self.lat_step
        lon = self.lon0 - self.lon_step / 2 + np.arange(self.n_lon + 1) * self.lon_step
        return np.meshgrid(lon, lat)[::-1]

    def centres(self):
        lat = self.lat0 - np.arange(self.n_lat) * self.lat_step
        lon = self.lon0 + np.arange(self.n_lon) * self.lon_step
        return np.meshgrid(lon, lat)[::-1]


def _align(ppd, span, lo, hi):
    n_all = int(round(ppd * span + 1))
    lines = np.linspace(-span / 2, span / 2, n_all)
    return (lines[np.argmax(lines > lo) - 1], lines[np.argmax(lines >= hi)],
            span / (n_all - 1))


def fixed_grid(px_per_deg, lat_min, lat_max, lon_min, lon_max):
    """The global grid's cells inside the box, the outermost lines dropped."""
    lat_ppd, lon_ppd = (px_per_deg if np.ndim(px_per_deg)
                        else (px_per_deg, px_per_deg))
    lat_lo, lat_hi, lat_step = _align(float(lat_ppd), 180.0, lat_min, lat_max)
    lon_lo, lon_hi, lon_step = _align(float(lon_ppd), 360.0, lon_min, lon_max)
    n_lat = int(round(lat_ppd * (lat_hi - lat_lo) + 1))
    n_lon = int(round(lon_ppd * (lon_hi - lon_lo) + 1))
    return Grid(n_lat - 2, n_lon - 2, lat_hi - lat_step, lon_lo + lon_step,
                lat_step, lon_step)


def cells(grid, lat, lon):
    """Flat cell index (int64) of each sample, -1 outside the grid or NaN."""
    fy = (grid.lat0 + grid.lat_step / 2 - lat.double()) / grid.lat_step
    fx = (lon.double() - (grid.lon0 - grid.lon_step / 2)) / grid.lon_step
    iy = torch.where(fy == grid.n_lat, grid.n_lat - 1.0, torch.floor(fy))
    ix = torch.where(fx == grid.n_lon, grid.n_lon - 1.0, torch.floor(fx))
    ok = (iy >= 0) & (iy < grid.n_lat) & (ix >= 0) & (ix < grid.n_lon)
    return torch.where(ok, iy * grid.n_lon + ix, -1.0).long()


def add_samples(count, sums, flat, values):
    """Add samples into ``count`` (n_cells,) and ``sums`` (n_cells, C), both
    float64: ``flat`` (n,) cell indices (-1 = none), ``values`` (n, C)."""
    keep = flat >= 0
    f = flat[keep]
    count += torch.bincount(f, minlength=count.numel()).double()
    v = values[keep].double()
    for ch in range(sums.shape[1]):
        sums[:, ch] += torch.bincount(f, weights=v[:, ch], minlength=count.numel())
