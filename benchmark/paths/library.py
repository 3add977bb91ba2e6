"""The public library slice: one request is
``mapping/astrometry.py::create_mapping`` of the frame's header and the next
seeded image of a ring (host uint8, as a decoded JPEG arrives; centres
georeferenced in full, as ``get_mapping`` asks), then
``resample.py::resample`` at the configuration's arcseconds per pixel, both
on the card. The check holds each sampled Mapping (coordinates, elevation,
masks) and its resampled grid against the float64 reference."""

import torch

from benchmark import inputs
from benchmark.reference import compare, library


def _mapping_arrays(m):
    return {"lats": m.lats.data, "lons": m.lons.data, "lats_center": m.latsCenter.data,
            "lons_center": m.lonsCenter.data, "elevation": m.elevation.data,
            "corner_mask": m.corner_mask, "center_mask": m.center_mask}


def _resampled_arrays(r):
    return {"lats": r.lats.data, "lons": r.lons.data, "img": r.img.data,
            "elevation": r.elevation.data, "center_mask": r.center_mask}


class State:
    frames_per_request = 1

    def __init__(self, config, traffic, device, seed, shrink, spans):
        from auromat_tpu_torch.mapping.astrometry import create_mapping
        from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position
        from auromat_tpu_torch.resample import resample

        self.config, self.device = config, device
        (path, cards), = inputs.frames(config, shrink)
        self.cal = inputs.calibrations(config, shrink)[0]
        header = inputs.program_header(path, cards)
        pos, t, _ = resolve_camera_position(header)
        self.ring = traffic["ring"]
        self.images = inputs.seeded_images(seed, self.ring, self.cal.height,
                                           self.cal.width, device)
        host = [im.cpu().numpy() for im in self.images]
        alt, arcsec = config["altitude_km"], config["arcsec_per_px"]

        def request(i, dtype=torch.float64):
            with spans("create_mapping"):
                m = create_mapping(header, host[i % self.ring], pos, t, altitude=alt,
                                   fast_center=False, dtype=dtype, device=device)
            with spans("resample"):
                r = resample(m, arcsec_per_px=arcsec, device=device)
            return _mapping_arrays(m), _resampled_arrays(r)

        self._request = request
        self.request = request

    def release(self):
        self.request = self._request = None

    def use_control(self):
        """The program's own float32 path (``dtype=float32``) in its place,
        one precision below the configuration's float64."""
        prog = self._request
        self.request = lambda i: prog(i, torch.float32)

    def check(self, kept):
        ref = library.mapping(self.cal, self.config["altitude_km"], self.device)
        grid = library.resample_grid(ref, self.config["arcsec_per_px"])
        worst = {}
        for i, (m, r) in kept:
            got = compare.mapping_numbers(m, ref)
            got |= compare.resampled_numbers(
                r, library.resample_mean(ref, self.images[i % self.ring], grid, self.device))
            worst = {k: max(v, worst.get(k, v)) for k, v in got.items()}
        return worst, {}


def setup(config, traffic, device, seed, shrink, spans):
    return State(config, traffic, device, seed, shrink, spans)
