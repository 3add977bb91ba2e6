"""The fused single-frame path: one request is the port's main entry,
``ops/georegrid.py::georegrid_mean`` (what ``entry.entry("cuda")`` returns),
on the next frame of a ring of seeded images, onto the configuration's
fixed grid. The check holds every sampled answer against the float64
reference: the per-pixel georeference through its cells, K1's counts and
sums, and the mean grid."""

import torch

from benchmark import inputs
from benchmark.reference import binning, compare, grid as rgrid
from benchmark.roofline import k1_bytes


class State:
    frames_per_request = 1

    def __init__(self, config, traffic, device, seed, shrink, spans):
        from auromat_tpu_torch.coordinates.wcs import TanWcs
        from auromat_tpu_torch.io import fits
        from auromat_tpu_torch.ops.georef import DynGeorefParams, GeorefParams
        from auromat_tpu_torch.ops.georegrid import georegrid_mean
        from auromat_tpu_torch.ops.regrid import fixed_grid

        self.config, self.device = config, device
        (path, cards), = inputs.frames(config, shrink)
        self.cal = inputs.calibrations(config, shrink)[0]
        header = inputs.program_header(path, cards)
        params = GeorefParams.from_wcs(
            TanWcs(header), fits.get_shifted_spacecraft_position(header)[:3],
            fits.get_shifted_photo_time(header), altitude=config["altitude_km"])
        dyn = DynGeorefParams.from_static(params, device=device, dtype=torch.float32)
        g = config["grid"]
        grid = fixed_grid(tuple(g["px_per_deg"]), *g["lat"], *g["lon"])
        self.fn = lambda img: georegrid_mean(grid, dyn, img)
        self.ring = traffic["ring"]
        self.images = inputs.seeded_images(seed, self.ring, self.cal.height,
                                           self.cal.width, device)
        self.chw = [im.permute(2, 0, 1).float().contiguous() for im in self.images]
        self.request = lambda i: self.fn(self.chw[i % self.ring])

    def release(self):
        del self.fn, self.chw
        self.request = None

    def _grid(self):
        g = self.config["grid"]
        return rgrid.fixed_grid(tuple(g["px_per_deg"]), *g["lat"], *g["lon"])

    def use_control(self):
        """The reference in the program's place, one precision below the
        configuration's float32 chain."""
        grid = self._grid()
        samples = binning.frame_samples(self.cal, self.config["altitude_km"], grid,
                                        self.device, torch.bfloat16)

        def control(i):
            c, s = binning.mean_sums(grid, [samples], [self.images[i % self.ring]])
            return binning.as_program_output(grid, c, s)

        self.request = control

    def check(self, kept):
        grid = self._grid()
        samples = binning.frame_samples(self.cal, self.config["altitude_km"], grid,
                                        self.device)
        worst = {}
        for i, (count, means) in kept:
            c, s = binning.mean_sums(grid, [samples], [self.images[i % self.ring]])
            got = compare.grid_numbers(count, means, c, s, grid.n_lat, grid.n_lon)
            worst = {k: max(v, worst.get(k, v)) for k, v in got.items()}
        n_valid = int((samples[0] >= 0).sum())
        n = self.cal.height * self.cal.width
        return worst, {"k1_bytes": k1_bytes(n, n_valid, grid.n_cells, int_sums=False)}


def setup(config, traffic, device, seed, shrink, spans):
    return State(config, traffic, device, seed, shrink, spans)
