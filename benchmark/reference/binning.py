"""The mean grids of georeferenced frames, by the definitions: every pixel
centre's cell from the float64 chain, then count, R, G, B and elevation
summed per cell."""

import torch

from benchmark.reference.georef import georef, pixel_rows
from benchmark.reference.grid import add_samples, cells

BLOCK_ROWS = 256  # rows georeferenced at once: ~0.5 GB of float64 temporaries


def frame_samples(cal, altitude, grid, device, dtype=torch.float64):
    """(cell, elevation) of every pixel of a frame, row-major (h * w,):
    cell -1 where the ray misses or falls outside ``grid``."""
    flats, elevs = [], []
    for r0 in range(0, cal.height, BLOCK_ROWS):
        rows = min(BLOCK_ROWS, cal.height - r0)
        px, py = pixel_rows(cal, r0, rows, device, dtype)
        lat, lon, elev = georef(cal, altitude, px, py, dtype)
        flats.append(cells(grid, lat, lon).reshape(-1))
        elevs.append(elev.double().reshape(-1))
    return torch.cat(flats), torch.cat(elevs)


def mean_sums(grid, samples, images):
    """float64 count (n_cells,) and sums (n_cells, 4: R, G, B, elevation)
    of frames with ``samples`` from :func:`frame_samples` and ``images``
    (h, w, 3), one a frame."""
    count = torch.zeros(grid.n_cells, dtype=torch.float64, device=images[0].device)
    sums = torch.zeros(grid.n_cells, 4, dtype=torch.float64, device=count.device)
    for (flat, elev), img in zip(samples, images):
        values = torch.cat([img.reshape(-1, 3).double(), elev[:, None]], dim=1)
        add_samples(count, sums, flat, values)
    return count, sums


def as_program_output(grid, count, sums, n_lat_out=None):
    """(count, means) float32 shaped as the program returns them, ``n_lat_out``
    rows (a band padded past the grid's rows), means NaN where empty: the
    control stands in the program's place with these."""
    n_lat_out = n_lat_out or grid.n_lat
    c = torch.zeros(n_lat_out * grid.n_lon, dtype=torch.float32, device=count.device)
    m = torch.full((n_lat_out * grid.n_lon, 4), torch.nan, dtype=torch.float32,
                   device=count.device)
    c[:grid.n_cells] = count.float()
    ok = count > 0
    m[:grid.n_cells][ok] = (sums[ok] / count[ok, None]).float()
    return c.reshape(n_lat_out, grid.n_lon), m.reshape(n_lat_out, grid.n_lon, 4)
