"""The sequence-mosaic path: one request is
``parallel/mosaic.py::mosaic_sequence`` over the configuration's frames on
``make_mesh()`` (a world of one), in steps of ``batch`` frames (a last
step short of ``batch`` padded with null frames), onto the configuration's grid, the images the
next set of a ring of seeded sets. The check holds every sampled mosaic
against the float64 reference of all its frames."""

import torch

from benchmark import inputs
from benchmark.reference import binning, compare, grid as rgrid
from benchmark.roofline import k1_bytes


def _band_rows(n_lat):
    return (n_lat + 7) // 8 * 8  # one rank's band: the grid's rows to a multiple of 8


class State:
    def __init__(self, config, traffic, device, seed, shrink, spans):
        from auromat_tpu_torch.coordinates.wcs import TanWcs
        from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position
        from auromat_tpu_torch.ops.georef import GeorefParams
        from auromat_tpu_torch.ops.regrid import fixed_grid
        from auromat_tpu_torch.parallel import make_mesh, mosaic_sequence

        self.config, self.device = config, device
        self.cals = inputs.calibrations(config, shrink)
        params = []
        for path, cards in inputs.frames(config, shrink):
            header = inputs.program_header(path, cards)
            pos, t, _ = resolve_camera_position(header)
            params.append(GeorefParams.from_wcs(TanWcs(header), pos, t,
                                                config["altitude_km"]))
        g = config["grid"]
        grid = fixed_grid(g["px_per_deg"], *g["lat"], *g["lon"])
        mesh = make_mesh(device=device)
        batch = config["batch"]
        self.frames_per_request = len(params)
        self.ring = traffic["ring"]
        h, w = self.cals[0].height, self.cals[0].width
        self.images = [inputs.seeded_images(seed + k, len(params), h, w, device)
                       for k in range(self.ring)]
        self.request = lambda i: mosaic_sequence(
            mesh, grid, [(params, self.images[i % self.ring])], batch=batch)

    def release(self):
        self.request = None

    def _grid(self):
        g = self.config["grid"]
        return rgrid.fixed_grid(g["px_per_deg"], *g["lat"], *g["lon"])

    def _samples(self, grid, dtype=torch.float64):
        """Each frame's samples, worked out once a calibration (a sequence
        may hold a frame's calibration more than once)."""
        done = {}
        for rel, c in zip(self.config["frames"], self.cals):
            if rel not in done:
                done[rel] = binning.frame_samples(c, self.config["altitude_km"], grid,
                                                  self.device, dtype)
        return [done[rel] for rel in self.config["frames"]]

    def use_control(self):
        """The reference in the program's place, one precision below the
        configuration's float32 chain."""
        grid = self._grid()
        samples = self._samples(grid, torch.bfloat16)

        def control(i):
            c, s = binning.mean_sums(grid, samples, self.images[i % self.ring])
            return binning.as_program_output(grid, c, s, _band_rows(grid.n_lat))

        self.request = control

    def check(self, kept):
        grid = self._grid()
        samples = self._samples(grid)
        worst = {}
        for i, (count, means) in kept:
            c, s = binning.mean_sums(grid, samples, self.images[i % self.ring])
            got = compare.grid_numbers(count, means, c, s, grid.n_lat, grid.n_lon)
            worst = {k: max(v, worst.get(k, v)) for k, v in got.items()}
        # K1's work a request: one launch a step of ``batch`` frame slots
        # (null frames pad the last), each adding into the cells it touches
        batch, n = self.config["batch"], self.cals[0].height * self.cals[0].width
        work = 0
        for s in range(0, len(samples), batch):
            flat = torch.cat([f for f, _ in samples[s:s + batch]])
            flat = flat[flat >= 0]
            work += k1_bytes(batch * n, flat.numel(), int(torch.unique(flat).numel()),
                             int_sums=True)
        return worst, {"k1_bytes": work}


def setup(config, traffic, device, seed, shrink, spans):
    return State(config, traffic, device, seed, shrink, spans)
