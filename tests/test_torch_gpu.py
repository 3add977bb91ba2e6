"""The port's CUDA kernels on the card (marked ``gpu``; each test skips
without a CUDA device).

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: ``tests/conftest.py`` configures jax.)

* K1 against its plain version on the same CUDA tensors: bit-equal on all
  five outputs, since both sum in integers (order-independent atomics).
* The main path on the card against the same path on the CPU. The f32
  georeference chain rounds differently on the two devices (their
  transcendental functions differ in the last ulps), so a pixel on a cell
  edge may move to the neighbouring cell; the bounds are those of the CPU
  comparison with the JAX package (tests/test_torch_georegrid.py).
* The wrapper refuses what the kernel does not take.
"""

import os

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from auromat_tpu_torch.coordinates.wcs import TanWcs
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.ops import _kernels
from auromat_tpu_torch.ops.georef import DynGeorefParams, GeorefParams
from auromat_tpu_torch.ops.georegrid import (bin_rgbelev_from_indices,
                                             bin_rgbelev_plain,
                                             georegrid_inputs, georegrid_mean)
from auromat_tpu_torch.ops.regrid import fixed_grid

RES = os.path.join(os.path.dirname(__file__), "resources")
GRID = fixed_grid((36, 25), 47.0, 62.0, -112.0, -91.0)


def small_dyn(device, w=128, h=96):
    """The real ISS030-E-102170 calibration scaled down to (h, w) pixels,
    as float32 on ``device`` (the port's twin of
    tests/test_georegrid.py::small_params)."""
    header = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    base = GeorefParams.from_wcs(
        TanWcs(header), fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_photo_time(header), altitude=110.0)
    scale = base.width / w
    p = GeorefParams(
        width=w, height=h,
        cd=tuple(tuple(v * scale for v in row) for row in base.cd),
        px_ref=base.px_ref / scale, py_ref=base.py_ref / scale,
        rotmat=base.rotmat, camera_pos=base.camera_pos,
        altitude=base.altitude, mat_j2000_to_geo=base.mat_j2000_to_geo,
        mat_j2000_to_sm=base.mat_j2000_to_sm)
    return DynGeorefParams.from_static(p, device, torch.float32), h, w


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def frame():
    return np.random.default_rng(3).integers(0, 256, (3, 96, 128)
                                             ).astype(np.float32)


@pytest.mark.gpu
def test_k1_kernel_matches_plain(cuda, frame):
    dyn, h, w = small_dyn(cuda)
    iy, ix, out = georegrid_inputs(GRID, dyn, h, w)
    img = torch.from_numpy(frame).to(cuda)
    elev = out["elevation"].clone()
    elev[5, :40] = torch.nan  # NaN data at valid coordinates adds 0
    img[1, 50, :] = torch.nan
    before = _kernels.GEOREGRID_BIN.launches
    kc, ks = bin_rgbelev_from_indices(GRID, iy, ix, img, elev)
    pc, ps = bin_rgbelev_plain(GRID, iy, ix, img, elev)
    torch.cuda.synchronize()
    assert _kernels.GEOREGRID_BIN.launches == before + 1
    assert torch.equal(kc, pc) and torch.equal(ks, ps)
    assert kc.sum().item() == (iy >= 0).sum().item() > 1000


@pytest.mark.gpu
def test_k1_kernel_full_grid_random(cuda):
    """Every cell of a small grid hit, elevations over their whole range."""
    rng = np.random.default_rng(2)
    g = fixed_grid((2.0, 1.0), 0.05, 19.95, 0.5, 129.5)
    shape = (64, 256)
    iy = torch.from_numpy(rng.integers(-1, g.n_lat, shape).astype(np.int32))
    ix = torch.from_numpy(rng.integers(0, g.n_lon, shape).astype(np.int32))
    img = torch.from_numpy(rng.integers(0, 256, (3,) + shape).astype(np.float32))
    elev = torch.from_numpy(rng.uniform(-90, 90, shape).astype(np.float32))
    args = [t.to(cuda) for t in (iy, ix, img, elev)]
    kc, ks = bin_rgbelev_from_indices(g, *args)
    pc, ps = bin_rgbelev_plain(g, *args)
    cc, cs = bin_rgbelev_plain(g, iy, ix, img, elev)  # the CPU's plain
    assert torch.equal(kc, pc) and torch.equal(ks, ps)
    assert torch.equal(kc.cpu(), cc) and torch.equal(ks.cpu(), cs)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_georegrid_mean_gpu_matches_cpu(cuda, frame, masked):
    dyn_c, h, w = small_dyn("cpu")
    dyn_g, _, _ = small_dyn(cuda)
    mask = torch.zeros((h, w), dtype=torch.bool)
    mask[: h // 2] = True
    m = mask if masked else None
    c, mean = georegrid_mean(GRID, dyn_c, torch.from_numpy(frame), m)
    before = _kernels.GEOREGRID_BIN.launches
    gc, gmean = georegrid_mean(GRID, dyn_g, torch.from_numpy(frame).to(cuda),
                               None if m is None else m.to(cuda))
    assert _kernels.GEOREGRID_BIN.launches == before + 1
    gc, gmean = gc.cpu().numpy(), gmean.cpu().numpy()
    c, mean = c.numpy(), mean.numpy()
    assert gc.shape == (GRID.n_lat, GRID.n_lon)
    assert c.sum() > 1000 and gc.sum() == c.sum()
    d = gc - c
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-2
    same = (d == 0) & (c > 0)
    ok = same[..., None] & ~np.isnan(mean)
    assert_allclose(gmean[ok], mean[ok], rtol=1e-3, atol=0.05)
    assert np.all(np.isnan(gmean[gc == 0]))


@pytest.mark.gpu
def test_k1_wrapper_refuses_bad_input(cuda, frame):
    dyn, h, w = small_dyn(cuda)
    iy, ix, out = georegrid_inputs(GRID, dyn, h, w)
    img = torch.from_numpy(frame).to(cuda)
    elev = out["elevation"]
    with pytest.raises(ValueError, match="contiguous"):
        bin_rgbelev_from_indices(GRID, iy.t().contiguous().t(), ix, img, elev)
    with pytest.raises(ValueError):  # mixed devices
        bin_rgbelev_from_indices(GRID, iy, ix, img.cpu(), elev)
    with pytest.raises(ValueError):
        bin_rgbelev_from_indices(GRID, iy, ix, img.half(), elev)
