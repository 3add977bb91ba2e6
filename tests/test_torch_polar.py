"""The pole and antimeridian branches of the interpolation routes and of
``mosaic``, port (``device="cpu"``) against the JAX package.

The input mappings of golden_resample_{polar,discont,polar_masked}.npz (a
cap over the north pole, a cap across the 180-degree meridian, the polar
cap with a masked disc) go through ``resample`` in all six interpolation
routes; two-member mosaics are built from the polar and the antimeridian
input (second member shifted 40 and 3 degrees in longitude, elevation one
degree lower). The grids are coarser than the goldens' 25 px/deg: the JAX
device routes take minutes on the CPU there. Tolerances: grids 1e-9 deg,
masks equal, uint8 equal for take-best and 'nearest' (up to 0.1% of cells
one step off for 'nearest_device', whose float32 distances can tie) and
within one step for the mesh interpolators.

This file holds the checks, the host routes and the mosaics. Each device
route compiles in JAX for most of a minute per grid shape, so the three of
them have a file each (tests/test_torch_polar_{nearest,linear,cubic}_device.py)
and can run side by side; the polar and the masked polar input share a
shape, hence a compile.
"""

import os
from datetime import datetime

import numpy as np
import pytest

from auromat_tpu.mapping.mapping import Mapping as JMapping
from auromat_tpu.mapping.mapping import MappingCollection as JCollection
from auromat_tpu.resample import mosaic as jmosaic
from auromat_tpu.resample import resample as jresample
from auromat_tpu_torch.mapping.mapping import Mapping, MappingCollection
from auromat_tpu_torch.mapping.mapping import check_guarantees
from auromat_tpu_torch.resample import mosaic, resample

RES = os.path.join(os.path.dirname(__file__), "resources")
PPD = 5  # the goldens are at 25
T0 = datetime(2012, 1, 25, 9, 27, 57)
HOST_ROUTES = ["nearest", "linear", "cubic"]
INPUTS = ["polar", "discont", "polar_masked"]


def _args(name, dlon=0.0, delev=0.0):
    g = np.load(os.path.join(RES, f"golden_resample_{name}.npz"))
    wrap = lambda lon: (lon + dlon + 180.0) % 360.0 - 180.0
    return (g["in_lats"], wrap(g["in_lons"]), g["in_lats_center"],
            wrap(g["in_lons_center"]), g["in_elevation"] + delev, 110.0,
            g["in_img"], [0.0, 0.0, 6871.0], T0,
            f"synthetic_{name}_{dlon:g}"), bool(g["contains_pole"])


_cache = {}


def _pair(name):
    """(port mapping, JAX mapping, contains_pole) of one golden's input."""
    if name not in _cache:
        args, pole = _args(name)
        _cache[name] = Mapping(*args), JMapping(*args), pole
    return _cache[name]


def _same_grids(r, jr_):
    for name in ("lats", "lons", "latsCenter", "lonsCenter"):
        a = np.asarray(getattr(r, name).filled(np.nan))
        b = np.asarray(getattr(jr_, name).filled(np.nan))
        assert a.shape == b.shape
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        d = np.abs(a - b)
        if name.startswith("lon"):
            d = np.minimum(d, 360.0 - d)
        assert np.nanmax(d) < 1e-9, (name, np.nanmax(d))


def check_branch(name):
    m, jm, pole = _pair(name)
    assert m.containsPole == jm.containsPole == pole == name.startswith("polar")
    assert m.containsDiscontinuity and jm.containsDiscontinuity
    check_guarantees(m)


def check_route(name, method):
    m, jm, pole = _pair(name)
    r = resample(m, px_per_deg=PPD, contains_pole=pole, method=method,
                 device="cpu")
    jr_ = jresample(jm, px_per_deg=PPD, contains_pole=pole, method=method)
    _same_grids(r, jr_)
    mask = np.ma.getmaskarray(r.img)
    assert np.array_equal(mask, np.ma.getmaskarray(jr_.img))
    assert (~mask).sum() > 500
    d = np.abs(r.img.filled(0).astype(int) - jr_.img.filled(0).astype(int))
    if method == "nearest":
        assert d.max() == 0
    elif method == "nearest_device":
        # a float32 distance tie may pick another sample in a few cells
        # (tests/test_torch_interp.py)
        assert (d > 1).sum() == 0 and (d != 0).mean() < 1e-3
    else:
        assert d.max() <= 1
    e = np.abs(r.elevation.filled(np.nan) - jr_.elevation.filled(np.nan))
    assert np.array_equal(np.isnan(r.elevation.filled(np.nan)),
                          np.isnan(jr_.elevation.filled(np.nan)))
    assert np.nanmax(e) < 1e-4
    check_guarantees(r)


def check_mosaic(name, dlon):
    """Take-best over the pole / across the antimeridian: the shifted
    member loses every cell the first member covers (elevation -1)."""
    a0, _ = _args(name)
    a1, _ = _args(name, dlon=dlon, delev=-1.0)
    col = MappingCollection([Mapping(*a0), Mapping(*a1)], identifier="pair")
    jcol = JCollection([JMapping(*a0), JMapping(*a1)], identifier="pair")
    r = mosaic(col, px_per_deg=PPD, device="cpu")
    jr_ = jmosaic(jcol, px_per_deg=PPD)
    _same_grids(r, jr_)
    mask = np.ma.getmaskarray(r.img)
    assert np.array_equal(mask, np.ma.getmaskarray(jr_.img))
    assert (~mask).sum() > 500
    assert np.array_equal(r.img.filled(0), jr_.img.filled(0))
    assert np.array_equal(r.elevation.filled(np.nan),
                          jr_.elevation.filled(np.nan), equal_nan=True)


@pytest.mark.parametrize("name", INPUTS)
def test_inputs_take_the_branch_they_are_named_for(name):
    check_branch(name)


@pytest.mark.parametrize("method", HOST_ROUTES)
@pytest.mark.parametrize("name", INPUTS)
def test_host_interpolation_route_matches_jax(name, method):
    check_route(name, method)


@pytest.mark.parametrize("name,dlon", [("polar", 40.0), ("discont", 3.0)])
def test_two_member_mosaic_matches_jax(name, dlon):
    check_mosaic(name, dlon)
