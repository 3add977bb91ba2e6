"""The port's host-side inputs (auromat_tpu_torch) against the JAX package:
FITS header, WCS header parse, frame matrices, georef calibration and the
fixed grid must carry identical values, and the port must not import jax."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from auromat_tpu.coordinates import frames as jframes
from auromat_tpu.coordinates import wcs as jwcs
from auromat_tpu.io import fits as jfits
from auromat_tpu.ops import georef as jgeoref
from auromat_tpu.ops import regrid as jregrid
from auromat_tpu_torch.coordinates import frames as tframes
from auromat_tpu_torch.coordinates import wcs as twcs
from auromat_tpu_torch.io import fits as tfits
from auromat_tpu_torch.ops import georef as tgeoref
from auromat_tpu_torch.ops import regrid as tregrid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "tests", "resources")
FRAMES = ["ISS030-E-102170_dc", "ISS029-E-8492"]


def headers(name):
    path = os.path.join(RES, f"{name}.wcs")
    return jfits.read_header(path), tfits.read_header(path)


@pytest.mark.parametrize("name", FRAMES)
def test_read_header_and_times(name):
    jh, th = headers(name)
    assert dict(th) == dict(jh)
    assert th.comments == jh.comments
    assert th.history == jh.history and th.comment_cards == jh.comment_cards
    for fn in ("get_photo_time", "get_spacecraft_position",
               "get_shifted_spacecraft_position", "get_shifted_photo_time"):
        assert getattr(tfits, fn)(th) == getattr(jfits, fn)(jh), fn
    assert tfits.get_shifted_photo_time(th) is not None


def test_parse_card_grammar():
    cards = ["KEY     = 'it''s a / test' / comment",
             "FLAG    =                    T",
             "NUM     =              1.5D+02 / exp",
             "HISTORY some history",
             "BARE    no value indicator",
             " " * 80]
    for c in cards:
        assert tfits.parse_card(c.ljust(80)) == jfits.parse_card(c.ljust(80))


@pytest.mark.parametrize("name", FRAMES)
def test_tan_wcs_fields(name):
    jh, th = headers(name)
    jw, tw = jwcs.TanWcs(jh), twcs.TanWcs(th)
    for f in ("projection", "ra_ref", "dec_ref", "px_ref", "py_ref",
              "lonpole", "width", "height"):
        assert getattr(tw, f) == getattr(jw, f), f
    assert np.array_equal(tw.cd, jw.cd)
    assert np.array_equal(tw.rotmat, jw.rotmat)


def test_tan_wcs_refuses_other_projections():
    _, th = headers(FRAMES[0])
    sin = dict(th, CTYPE1="RA---SIN", CTYPE2="DEC--SIN")
    with pytest.raises(ValueError):
        twcs.TanWcs(sin)
    assert twcs.ZenithalWcs(sin).projection == "SIN"


@pytest.mark.parametrize("cards", [
    {"CTYPE1": "RA---CAR", "CTYPE2": "DEC--CAR"},
    {"CTYPE1": "GLON-MER", "CTYPE2": "GLAT-MER", "CRVAL2": -20.0,
     "PC1_2": 0.1, "CDELT1": 0.02, "CDELT2": 0.03},
    {"CTYPE1": "RA---CEA", "CTYPE2": "DEC--CEA", "CROTA2": 12.0,
     "LONPOLE": 90.0, "CRVAL2": 0.0, "LATPOLE": -30.0},
])
def test_celestial_header_helpers(cards):
    """The non-zenithal header helpers set the same fields as the JAX
    package's cylindrical family, which is built from them."""
    header = {"CRVAL1": 150.0, "CRVAL2": 35.0, "CRPIX1": 100.5,
              "CRPIX2": 80.5, "IMAGEW": 200, "IMAGEH": 160,
              "CD1_1": -0.01, "CD2_2": 0.01}
    header.update(cards)
    if "CDELT1" in cards or "CROTA2" in cards:
        del header["CD1_1"], header["CD2_2"]
    jw = jwcs.CylindricalWcs(header)
    tw = type("Cyl", (), {"SUPPORTED": jwcs.CylindricalWcs.SUPPORTED})()
    twcs._parse_celestial_header(tw, header, "cylindrical")
    twcs._finish_native_pole(tw, header, 0.0)
    for f in ("projection", "ra_ref", "dec_ref", "px_ref", "py_ref",
              "width", "height", "lonpole", "latpole"):
        assert getattr(tw, f) == getattr(jw, f), f
    assert np.array_equal(tw.cd, jw.cd)
    assert np.array_equal(tw.rotmat, jw.rotmat)


@pytest.mark.parametrize("name", FRAMES)
def test_frame_matrices_and_georef_params(name):
    jh, th = headers(name)
    jt, tt = jfits.get_shifted_photo_time(jh), tfits.get_shifted_photo_time(th)
    jfm, tfm = jframes.FrameMatrices(jt), tframes.FrameMatrices(tt)
    assert tfm.et == jfm.et
    for f in ("j2000_to_geo", "j2000_to_sm", "geo_to_sm", "geo_to_j2000",
              "sm_to_geo"):
        assert np.array_equal(getattr(tfm, f), getattr(jfm, f)), f
    pos = lambda m, h: (m.get_shifted_spacecraft_position(h) or
                        m.get_spacecraft_position(h))[:3]
    jp = jgeoref.GeorefParams.from_wcs(jwcs.TanWcs(jh), pos(jfits, jh), jt)
    tp = tgeoref.GeorefParams.from_wcs(twcs.TanWcs(th), pos(tfits, th), tt)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


@pytest.mark.parametrize("args", [
    ((36, 25), 47.0, 62.0, -112.0, -91.0),
    (25, -89.0, 89.0, -179.0, 179.0),
    ((2.0, 1.0), 0.05, 19.95, 0.5, 129.5),
    (20, 10.3, 12.7, 5.1, 9.9),
])
def test_fixed_grid(args):
    jg, tg = jregrid.fixed_grid(*args), tregrid.fixed_grid(*args)
    assert dataclasses.astuple(tg) == dataclasses.astuple(jg)
    assert np.array_equal(tg.lat_corners, jg.lat_corners)
    assert np.array_equal(tg.lon_corners, jg.lon_corners)
    assert tregrid.round_up(tg.n_lon, 128) == jregrid.round_up(jg.n_lon, 128)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import auromat_tpu_torch, auromat_tpu_torch.entry\n"
            "import auromat_tpu_torch.ops.georegrid, auromat_tpu_torch.timeutil\n"
            "import auromat_tpu_torch.coordinates.igrf\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'auromat_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
