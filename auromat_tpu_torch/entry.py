"""Entry point of the port's main path: the fused georeference + regrid
forward of one real 12 MP ISS DSLR frame onto the fixed global
plate-carree grid (counterpart of ``__graft_entry__.entry`` of the JAX
package).

    fn, (img,) = entry()          # on the GPU
    count, means = fn(img)        # (539, 524) and (539, 524, 4)
"""

import os

import torch

from auromat_tpu_torch.coordinates.wcs import TanWcs
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.ops.georef import (DynGeorefParams, GeorefParams,
                                          compute_device)
from auromat_tpu_torch.ops.georegrid import georegrid_mean
from auromat_tpu_torch.ops.regrid import fixed_grid

FRAME_WCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "tests", "resources", "ISS030-E-102170_dc.wcs")


def frame_setup(device="cuda"):
    """The main path's frame and grid: (grid, dyn, params).

    The calibration is the astrometry.net solution of ISS030-E-102170
    (4256x2832, 12.05 MPix); the grid covers the frame at ~100 arcsec per
    cell (36 x 25 cells per degree, 539 x 524 cells).
    """
    device = compute_device(device)
    header = fits.read_header(FRAME_WCS)
    params = GeorefParams.from_wcs(
        TanWcs(header),
        fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_shifted_photo_time(header),
        altitude=110.0,
    )
    dyn = DynGeorefParams.from_static(params, device=device, dtype=torch.float32)
    grid = fixed_grid((36, 25), 47.0, 62.0, -112.0, -91.0)
    return grid, dyn, params


def entry(device="cuda"):
    """(fn, example_args): ``fn(img_chw, mask=None) -> (count, means)``
    georeferences and mean-regrids one (3, h, w) frame on ``device``."""
    grid, dyn, params = frame_setup(device)

    def forward(img_chw, mask=None):
        return georegrid_mean(grid, dyn, img_chw, mask)

    example_img = torch.zeros((3, params.height, params.width),
                              dtype=torch.float32, device=dyn.cd.device)
    return forward, (example_img,)
