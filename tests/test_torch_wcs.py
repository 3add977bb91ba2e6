"""The port's FITS projections against the JAX package's, family by family.

The same header dict and the same seeded numpy pixel set go through
``auromat_tpu.coordinates.wcs`` (CPU, float64) and
``auromat_tpu_torch.coordinates.wcs`` (CPU tensors). Tolerances: unit
vectors 1e-12, angles 1e-9 deg, pixels 1e-6, NaN masks equal. The iterative
inverses (ZPN/AIR Newton, MOL Newton, PCO bisection) may differ in the last
bits because XLA-CPU contracts a*b+c where eager torch rounds twice; the
tolerances leave room for that.
"""

import numpy as np
import pytest
import torch

from auromat_tpu.coordinates import wcs as jw
from auromat_tpu_torch.coordinates import wcs as tw

#: one case per code of _WCS_FAMILIES, with the PV values tests/test_wcs.py
#: uses for that family
CASES = [
    ("TAN", {}), ("SIN", {}), ("ZEA", {}), ("ARC", {}), ("STG", {}),
    ("AZP", {"PV2_1": 2.0, "PV2_2": 30.0}),
    ("SZP", {"PV2_1": 2.0, "PV2_2": 30.0, "PV2_3": 60.0}),
    ("ZPN", {"PV2_1": 1.0, "PV2_3": 0.1}),
    ("AIR", {"PV2_1": 45.0}),
    ("CAR", {}), ("CEA", {"PV2_1": 0.8}), ("MER", {}),
    ("CYP", {"PV2_1": 1.0, "PV2_2": 0.7}),
    ("COP", {"PV2_1": 45.0, "PV2_2": 15.0}),
    ("COE", {"PV2_1": 45.0, "PV2_2": 15.0}),
    ("COD", {"PV2_1": 45.0, "PV2_2": 15.0}),
    ("COO", {"PV2_1": 45.0, "PV2_2": 15.0}),
    ("SFL", {}), ("PAR", {}), ("MOL", {}), ("AIT", {}),
    ("BON", {"PV2_1": 45.0}), ("PCO", {}),
    ("TSC", {}), ("QSC", {}), ("HPX", {}), ("XPH", {}),
]
IDS = [c for c, _ in CASES]


def _header(code, scale=0.01, **pv):
    h = {
        "CTYPE1": f"RA---{code}", "CTYPE2": f"DEC--{code}",
        "CRVAL1": 30.0, "CRVAL2": 45.0,
        "CRPIX1": 100.5, "CRPIX2": 80.25,
        "CD1_1": scale * 0.9, "CD1_2": scale * 0.3,
        "CD2_1": -scale * 0.2, "CD2_2": scale * 1.1,
        "IMAGEW": 200, "IMAGEH": 160,
    }
    h.update(pv)
    return h


def _pixels(seed=0, n=400):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-40.0, 240.0, n)
    py = rng.uniform(-40.0, 200.0, n)
    # the reference pixel itself (the guarded divisors of the centre) and
    # a NaN (must stay NaN through every branch)
    px[0], py[0] = 99.5, 79.25
    px[1] = np.nan
    return px, py


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_family_table_is_the_jax_one():
    assert sorted(tw._WCS_FAMILIES) == sorted(jw._WCS_FAMILIES) == sorted(IDS)
    for code in IDS:
        assert (tw._WCS_FAMILIES[code].__name__
                == jw._WCS_FAMILIES[code].__name__)


@pytest.mark.parametrize("scale", [0.01, 1.7], ids=["narrow", "allsky"])
@pytest.mark.parametrize("code,pv", CASES, ids=IDS)
def test_pix2world_matches_jax(code, pv, scale):
    """pix2world_dirs within 1e-12, pix2world within 1e-9 deg, NaN masks
    equal; at 1.7 deg/px the pixel set runs off every map."""
    h = _header(code, scale, **pv)
    wj, wt = jw.make_wcs(h), tw.make_wcs(h)
    assert type(wt).__name__ == type(wj).__name__
    px, py = _pixels()
    dj = [np.asarray(v) for v in jw.pix2world_dirs(wj, px, py)]
    dt = [v.numpy() for v in tw.pix2world_dirs(wt, _t(px), _t(py))]
    for a, b in zip(dj, dt):
        assert b.dtype == np.float64
        assert np.array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    assert np.isnan(dt[0][1])
    if scale > 1 and code not in ("TAN", "STG", "MER", "CAR", "COO", "ZPN",
                                  "AIR", "CYP", "COP", "PCO"):
        # (those ten map every point of this set, or wrap)
        assert np.isnan(dt[0]).sum() > 1, "the all-sky set must leave the map"
    ra_j, dec_j = (np.asarray(v) for v in jw.pix2world(wj, px, py))
    ra_t, dec_t = (v.numpy() for v in tw.pix2world(wt, _t(px), _t(py)))
    assert np.array_equal(np.isnan(ra_j), np.isnan(ra_t))
    assert np.array_equal(np.isnan(dec_j), np.isnan(dec_t))
    dra = (ra_t - ra_j + 180.0) % 360.0 - 180.0
    ok = ~np.isnan(ra_j)
    assert np.abs(dra[ok]).max() < 1e-9
    assert np.abs((dec_t - dec_j)[ok]).max() < 1e-9
    c = tw.pix2world_cartesian(wt, _t(px), _t(py)).numpy()
    assert c.shape == px.shape + (3,)
    np.testing.assert_array_equal(c[..., 2], dt[2])


@pytest.mark.parametrize("code,pv", CASES, ids=IDS)
def test_world2pix_matches_jax(code, pv):
    """world2pix of a seeded whole-sky set (unprojectable directions
    included): pixels within 1e-6 where finite, NaN masks equal."""
    h = _header(code, 0.05, **pv)
    wj, wt = jw.make_wcs(h), tw.make_wcs(h)
    rng = np.random.default_rng(1)
    ra = rng.uniform(0.0, 360.0, 300)
    dec = np.rad2deg(np.arcsin(rng.uniform(-1.0, 1.0, 300)))
    ra[0], dec[0] = 30.0, 45.0  # the reference point itself
    xj, yj = (np.asarray(v) for v in jw.world2pix(wj, ra, dec))
    xt, yt = (v.numpy() for v in tw.world2pix(wt, _t(ra), _t(dec)))
    assert np.array_equal(np.isnan(xj), np.isnan(xt))
    assert np.array_equal(np.isnan(yj), np.isnan(yt))
    ok = np.isfinite(xj) & np.isfinite(yj)
    assert ok.sum() > 50
    scale = np.maximum(1.0, np.abs(xj[ok]))
    assert (np.abs(xt[ok] - xj[ok]) / scale).max() < 1e-6
    scale = np.maximum(1.0, np.abs(yj[ok]))
    assert (np.abs(yt[ok] - yj[ok]) / scale).max() < 1e-6


def test_world2pix_takes_tensors_only():
    """Like pix2world, the world -> pixel functions follow their tensor
    inputs' device and dtype; an array is refused, not computed on the
    CPU behind the caller's back."""
    ra, dec = np.array([30.0]), np.array([45.0])
    with pytest.raises(TypeError):
        tw.world2pix(tw.make_wcs(_header("ZEA")), ra, dec)
    with pytest.raises(TypeError):
        tw.tan_world2pix(tw.TanWcs(_header("TAN")), ra, dec)
    with pytest.raises(TypeError):
        tw.pix2world(tw.make_wcs(_header("ZEA")), ra, dec)


@pytest.mark.parametrize("code,pv", CASES, ids=IDS)
def test_roundtrip_on_map(code, pv):
    """world2pix(pix2world(p)) == p within 1e-6 px on on-map points (the
    frame at 0.01 deg/px lies on every map)."""
    wt = tw.make_wcs(_header(code, 0.01, **pv))
    rng = np.random.default_rng(2)
    px = _t(rng.uniform(0.0, 200.0, 300))
    py = _t(rng.uniform(0.0, 160.0, 300))
    ra, dec = tw.pix2world(wt, px, py)
    assert not torch.isnan(ra).any()
    bx, by = tw.world2pix(wt, ra, dec)
    assert (bx - px).abs().max() < 1e-6
    assert (by - py).abs().max() < 1e-6


@pytest.mark.parametrize("code,pv", CASES, ids=IDS)
def test_float32_stays_float32(code, pv):
    """No header constant promotes a float32 call; the float32 result is
    the float64 one within float32 rounding of the chain."""
    wt = tw.make_wcs(_header(code, 0.01, **pv))
    rng = np.random.default_rng(3)
    px = rng.uniform(0.0, 200.0, 64)
    py = rng.uniform(0.0, 160.0, 64)
    d32 = tw.pix2world_dirs(wt, _t(px, torch.float32), _t(py, torch.float32))
    d64 = tw.pix2world_dirs(wt, _t(px), _t(py))
    for a, b in zip(d32, d64):
        assert a.dtype == torch.float32
        assert (a.double() - b).abs().max() < 1e-3
    ra, dec = tw.pix2world(wt, _t(px, torch.float32), _t(py, torch.float32))
    assert ra.dtype == dec.dtype == torch.float32
    bx, by = tw.world2pix(wt, ra, dec)
    assert bx.dtype == by.dtype == torch.float32


def test_tan_functions_match_jax():
    h = _header("TAN")
    wj, wt = jw.TanWcs(h), tw.TanWcs(h)
    px, py = _pixels(4)
    px[1] = 3.0
    cj = np.asarray(jw.tan_pix2world_cartesian(wj, px, py))
    ct = tw.tan_pix2world_cartesian(wt, _t(px), _t(py)).numpy()
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-14)
    ra_j, dec_j = (np.asarray(v) for v in jw.tan_pix2world(wj, px, py))
    ra_t, dec_t = (v.numpy() for v in tw.tan_pix2world(wt, _t(px), _t(py)))
    np.testing.assert_allclose(ra_t, ra_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(dec_t, dec_j, rtol=0, atol=1e-10)
    # far hemisphere masked alike
    ra = np.array([30.0, 210.0, 31.0, 120.0])
    dec = np.array([45.0, -45.0, 44.0, -10.0])
    xj, yj = (np.asarray(v) for v in jw.tan_world2pix(wj, ra, dec))
    xt, yt = (v.numpy() for v in tw.tan_world2pix(wt, _t(ra), _t(dec)))
    assert np.array_equal(np.isnan(xj), np.isnan(xt)) and np.isnan(xt[1])
    np.testing.assert_allclose(xt[~np.isnan(xt)], xj[~np.isnan(xj)],
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(yt[~np.isnan(yt)], yj[~np.isnan(yj)],
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("corner", [True, False])
def test_pixel_grid_and_directions_match_jax(corner):
    h = _header("TAN")
    h["IMAGEW"], h["IMAGEH"] = 12, 9
    gj = jw.pixel_grid(12, 9, 2, 3, corner=corner)
    gt = tw.pixel_grid(12, 9, 2, 3, corner=corner, device="cpu")
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    dj = np.asarray(jw.pixel_directions(jw.TanWcs(h), corner=corner))
    dt = tw.pixel_directions(tw.TanWcs(h), corner=corner, device="cpu")
    assert dt.shape == dj.shape
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=1e-14)
    h.pop("IMAGEW")
    with pytest.raises(ValueError, match="IMAGEW"):
        tw.pixel_directions(tw.TanWcs(h), device="cpu")


@pytest.mark.parametrize("header,exc", [
    (_header("CSC"), NotImplementedError),
    (_header("BON"), ValueError),
    (_header("HPX", PV2_1=0.0), ValueError),
    (_header("HPX", PV2_1=-2.0), ValueError),
    (_header("COP"), ValueError),
    (_header("AZP", PV2_2=95.0), ValueError),
    (_header("ZPN", PV2_1=-1.0), ValueError),
    (_header("CYP", PV2_2=-1.0), ValueError),
    (_header("CEA", PV2_1=1.5), ValueError),
    (_header("XYZ"), NotImplementedError),
], ids=["CSC", "BON-noPV", "HPX-H0", "HPX-Hneg", "COP-noPV", "AZP-gamma",
        "ZPN-decreasing", "CYP-lambda", "CEA-lambda", "unknown"])
def test_make_wcs_raises_as_jax(header, exc):
    with pytest.raises(exc) as ej:
        jw.make_wcs(header)
    with pytest.raises(exc) as et:
        tw.make_wcs(header)
    assert type(ej.value) is type(et.value)
    if header["CTYPE1"].endswith("CSC"):
        assert "TSC/QSC" in str(et.value)


def test_invert_monotone_radial_seed_matches_numpy_interp():
    """The searchsorted + lerp seed is numpy's ``interp`` on increasing
    samples, clamped at both ends."""
    rng = np.random.default_rng(5)
    xp = np.cumsum(rng.uniform(0.1, 1.0, 256))
    fp = rng.normal(size=256)
    x = np.concatenate([rng.uniform(xp[0] - 1, xp[-1] + 1, 500), xp[:5],
                        [xp[0], xp[-1]]])
    got = tw._interp(_t(x), _t(xp), _t(fp)).numpy()
    np.testing.assert_allclose(got, np.interp(x, xp, fp), rtol=0, atol=1e-13)
    assert torch.isnan(tw._interp(_t([np.nan]), _t(xp), _t(fp))).all()
