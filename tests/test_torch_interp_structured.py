"""The port's structured interpolators (``interp_linear_structured``,
``interp_cubic_structured``: jump-flood seeding + Newton inversion of the
bilinear patch map) and their resample routes, against the JAX package on
the CPU.

* On golden_resample_methods.npz's input mesh (140x140 pixel centres,
  float64) onto the mapping's 8 px/deg grid: NaN masks equal to JAX's,
  values and source positions within 1e-9. The grid is the one
  ``resample(px_per_deg=8)`` makes, so JAX compiles each interpolator
  once for both tests.
* ``resample`` with 'linear_device' and 'cubic_device' on the CPU: JAX's
  device routes' masks, uint8 within one step; on a locally affine field
  both interpolators reproduce the field; the 4x4-stencil rule of cubic
  and the NaN source band.
"""

import dataclasses
import os
from datetime import datetime

import numpy as np
import pytest
import torch

from auromat_tpu.mapping.mapping import Mapping as JMapping
from auromat_tpu.ops import regrid as jr
from auromat_tpu.resample import resample as jresample
from auromat_tpu_torch.mapping.mapping import Mapping
from auromat_tpu_torch.ops import regrid as tr
from auromat_tpu_torch.resample import resample

RES = os.path.join(os.path.dirname(__file__), "resources")
PPD = 8
FNS = {"linear": (tr.interp_linear_structured, jr.interp_linear_structured),
       "cubic": (tr.interp_cubic_structured, jr.interp_cubic_structured)}


@pytest.fixture(scope="module")
def golden():
    g = np.load(os.path.join(RES, "golden_resample_methods.npz"))
    args = (g["in_lats"], g["in_lons"], g["in_lats_center"],
            g["in_lons_center"], g["in_elevation"], 110.0, g["in_img"],
            [0.0, 0.0, 6871.0], datetime(2012, 1, 25, 9, 27, 57),
            "synthetic_methods")
    m, jm = Mapping(*args), JMapping(*args)
    bb = m.boundingBox
    grid = tr.fixed_grid((PPD, PPD), bb.latSouth, bb.latNorth, bb.lonWest,
                         bb.lonEast)
    # resample's payload: the image as float64, then elevation
    data = np.concatenate([g["in_img"].astype(np.float64),
                           g["in_elevation"][..., None]], axis=-1)
    return g, m, jm, grid, data


def jgrid(grid):
    return jr.GridSpec(**dataclasses.asdict(grid))


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_interp_structured_matches_jax(golden, kind):
    g, _, _, grid, data = golden
    lat, lon = g["in_lats_center"], g["in_lons_center"]
    fn, jfn = FNS[kind]
    td, tp = fn(grid, *(torch.from_numpy(a) for a in (lat, lon, data)))
    jd, jp = (np.asarray(a) for a in jfn(jgrid(grid), lat, lon, data))
    assert td.dtype == torch.float64 and td.shape == jd.shape
    for ours, theirs in ((td.numpy(), jd), (tp.numpy(), jp)):
        assert np.array_equal(np.isnan(ours), np.isnan(theirs))
        ok = ~np.isnan(theirs)
        assert ok.mean() > 0.5
        assert np.abs(ours[ok] - theirs[ok]).max() < 1e-9


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_resample_device_route_matches_jax(golden, kind):
    _, m, jm, _, _ = golden
    method = f"{kind}_device"
    r = resample(m, px_per_deg=PPD, contains_pole=False, method=method,
                 device="cpu")
    jr_ = jresample(jm, px_per_deg=PPD, contains_pole=False, method=method)
    mask = np.ma.getmaskarray(r.img)
    assert np.array_equal(mask, np.ma.getmaskarray(jr_.img))
    assert (~mask).sum() > 1000
    d = np.abs(r.img.filled(0).astype(int) - jr_.img.filled(0).astype(int))
    assert d.max() <= 1
    e = np.abs(r.elevation.filled(np.nan) - jr_.elevation.filled(np.nan))
    assert np.nanmax(e) < 1e-6


def affine_mesh(h=24, w=30, nan_rows=0):
    """A smooth, slightly rotated pixel mesh and a field affine in lat/lon."""
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    lat = 60.0 - 0.1 * yy + 0.01 * xx
    lon = 10.0 + 0.12 * xx + 0.02 * yy
    lat[:nan_rows] = np.nan
    lon[:nan_rows] = np.nan
    field = np.stack([3.0 * lat - 2.0 * lon + 1.0, lon], axis=-1)
    grid = tr.fixed_grid(20, 57.8, 59.7, 10.5, 13.2)
    return grid, lat, lon, field


@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_interp_structured_reproduces_affine_fields(kind):
    grid, lat, lon, field = affine_mesh()
    out, pos = FNS[kind][0](grid, *(torch.from_numpy(a)
                                    for a in (lat, lon, field)))
    out = out.numpy()
    tgt_lat = grid.lat_centers[:, None]
    tgt_lon = grid.lon_centers[None, :]
    ok = ~np.isnan(out[..., 0])
    assert ok.mean() > 0.5
    want = 3.0 * tgt_lat - 2.0 * tgt_lon + 1.0
    assert np.abs(out[..., 0] - want)[ok].max() < 1e-9
    assert np.abs(out[..., 1] - np.broadcast_to(tgt_lon, ok.shape))[ok].max() \
        < 1e-9
    assert np.array_equal(np.isnan(pos.numpy()[..., 0]), ~ok)


def test_cubic_needs_the_full_stencil_and_nan_sources_taint():
    grid, lat, lon, field = affine_mesh(nan_rows=4)
    t = [torch.from_numpy(a) for a in (lat, lon, field)]
    lin, lpos = tr.interp_linear_structured(grid, *t)
    cub, cpos = tr.interp_cubic_structured(grid, *t)
    lin_ok = ~torch.isnan(lin[..., 0])
    cub_ok = ~torch.isnan(cub[..., 0])
    assert (cub_ok & ~lin_ok).sum() == 0  # cubic solves a subset of linear
    assert (lin_ok & ~cub_ok).sum() > 0
    y0 = torch.floor(cpos[..., 0][cub_ok])
    x0 = torch.floor(cpos[..., 1][cub_ok])
    h, w = lat.shape
    assert ((y0 >= 1) & (y0 <= h - 3) & (x0 >= 1) & (x0 <= w - 3)).all()
    # no solved cell reads a NaN source row (rows 0..3, so y >= 4)
    assert (lpos[..., 0][lin_ok] >= 4).all() and (y0 >= 4).all()
