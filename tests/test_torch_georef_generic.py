"""The port's generic-projection georeference and its full-precision point
functions (``auromat_tpu_torch.ops.georef``) against the JAX package.

One header dict and the same numpy pixel arrays go to both packages; the
port runs with ``device="cpu"``. Tolerances:

* float64 against JAX float64: 1e-9 deg (lat, lon, MLat), 1e-9 (elevation,
  MLT hours), NaN masks equal;
* float32 generic chain against the port's own float64: the JAX package's
  limit of tests/test_georef.py::test_generic_projection_f32_floor
  (max < 1e-2 deg, median latitude error < 1e-4 deg, masks equal);
* the full-precision point functions against the executed-reference
  goldens (golden_georef_*.npz) and against JAX's double-float chain:
  1e-6 deg, masks equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auromat_tpu.coordinates.wcs import TanWcs as JTanWcs
from auromat_tpu.coordinates.wcs import make_wcs as jmake_wcs
from auromat_tpu.mapping.astrometry import create_mapping as jcreate_mapping
from auromat_tpu.ops import georef as jg
from auromat_tpu_torch.coordinates.wcs import TanWcs, make_wcs
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.mapping.astrometry import create_mapping
from auromat_tpu_torch.mapping.mapping import check_guarantees
from auromat_tpu_torch.ops import georef as tg

RES = os.path.join(os.path.dirname(__file__), "resources")
FULL = "ISS030-E-102170_dc"
FRAMES = [FULL, "ISS029-E-8492"]
W, H = 128, 96


def header_as(code, w=W, h=H, **pv):
    """The real frame's header scaled to (h, w) pixels with its CTYPE
    swapped to ``code``; LONPOLE/LATPOLE dropped so that the family's own
    default applies (the theta0 = 0 families refuse LONPOLE=180 here)."""
    hd = dict(fits.read_header(os.path.join(RES, f"{FULL}.wcs")))
    scale = hd["IMAGEW"] / w
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        hd[k] = hd[k] * scale
    hd["CRPIX1"] /= scale
    hd["CRPIX2"] /= scale
    hd["IMAGEW"], hd["IMAGEH"] = w, h
    if code != "TAN":
        hd = {k: v for k, v in hd.items()
              if k.upper() not in ("LONPOLE", "LATPOLE")}
    hd["CTYPE1"], hd["CTYPE2"] = f"RA---{code}", f"DEC--{code}"
    hd.update(pv)
    return hd


def camera(hd):
    return (np.array(fits.get_shifted_spacecraft_position(hd)[:3]),
            fits.get_shifted_photo_time(hd))


def both_params(hd):
    """(JAX params, port params, JAX wcs, port wcs) of one header dict."""
    pos, t = camera(hd)
    jw, tw = jmake_wcs(hd), make_wcs(hd)
    return (jg.GeorefParams.from_wcs(jw, pos, t, 110.0),
            tg.GeorefParams.from_wcs(tw, pos, t, 110.0), jw, tw)


def close(got, want, tol=1e-9, lon=False):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert ok.any()
    d = np.abs(got[ok] - want[ok])
    if lon:
        d = np.minimum(d, 360.0 - d)
    assert d.max() < tol, d.max()


CODES = [("ZEA", {}), ("HPX", {}), ("QSC", {}),
         ("AZP", {"PV2_1": 0.0, "PV2_2": 0.0})]


@pytest.mark.parametrize("fast_center", [True, False])
@pytest.mark.parametrize("code,pv", CODES, ids=[c for c, _ in CODES])
def test_georeference_generic_matches_jax(code, pv, fast_center):
    jp, tp, jw, tw = both_params(header_as(code, **pv))
    want = jg.georeference_generic(jw, jp, fast_center, True, jnp.float64)
    got = tg.georeference_generic(tw, tp, fast_center, True, torch.float64,
                                  "cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float64
        close(got[k], want[k], lon=k.startswith("lon"))
    assert 0.2 < np.isnan(got["lats"].numpy()).mean() < 0.8
    df = tg.georeference_generic(tw, tp, fast_center, True, "df64", "cpu")
    assert all(np.array_equal(df[k].numpy(), got[k].numpy(), equal_nan=True)
               for k in got)


def test_azp_mu0_is_the_fused_tan_chain():
    """AZP with mu = 0 IS the gnomonic projection: the generic chain must
    agree with the fused TAN path to float64 roundoff (the non-circular
    gate of tests/test_georef.py::test_azp_mu0_matches_tan_cropped)."""
    _, tp, _, tw = both_params(header_as("AZP", PV2_1=0.0, PV2_2=0.0))
    pos, t = camera(header_as("TAN"))
    pt = tg.GeorefParams.from_wcs(TanWcs(header_as("TAN")), pos, t, 110.0)
    a = tg.georeference_generic(tw, tp, False, True, torch.float64, "cpu")
    b = tg.georeference(pt, False, True, torch.float64, "cpu")
    for k in b:
        close(a[k], b[k].numpy(), lon=k.startswith("lon"))


def _grid_points(step=1):
    return np.meshgrid(np.arange(0, W, step, dtype=np.float64),
                       np.arange(0, H, step, dtype=np.float64))


@pytest.mark.parametrize("code", ["ZEA", "HPX", "QSC", "PCO", "MOL"])
def test_georeference_points_generic_matches_jax(code):
    jp, tp, jw, tw = both_params(header_as(code))
    px, py = _grid_points()
    px[0, 0] = np.nan
    want = jg.georeference_points_generic(jw, jp, px, py, jnp.float64, True)
    got = tg.georeference_points_generic(tw, tp, px, py, torch.float64, True,
                                         device="cpu")
    assert len(got) == 3
    close(got[0], want[0])
    close(got[1], want[1], lon=True)
    close(got[2], want[2])
    assert len(tg.georeference_points_generic(tw, tp, px, py,
                                              device="cpu")) == 2


def test_georeference_points_matches_jax():
    hd = header_as("TAN")
    pos, t = camera(hd)
    jp = jg.GeorefParams.from_wcs(JTanWcs(hd), pos, t, 110.0)
    tp = tg.GeorefParams.from_wcs(TanWcs(hd), pos, t, 110.0)
    px, py = _grid_points()
    want = jg.georeference_points(jp, px, py, jnp.float64)
    got = tg.georeference_points(tp, px, py, device="cpu")
    close(got[0], want[0])
    close(got[1], want[1], lon=True)
    got = tg.georeference_points(tp, torch.from_numpy(px),
                                 torch.from_numpy(py), torch.float32, "cpu")
    assert got[0].dtype == torch.float32


@pytest.mark.parametrize("code", ["ZEA", "HPX", "QSC"])
def test_generic_float32_chain_within_the_documented_floor(code):
    """Full frame at every 16th pixel, float32 against the port's own
    float64: identical masks, max < 1e-2 deg, median latitude < 1e-4 deg."""
    hd = header_as(code, w=4256, h=2832)
    pos, t = camera(hd)
    tw = make_wcs(hd)
    p = tg.GeorefParams.from_wcs(tw, pos, t, 110.0)
    px, py = np.meshgrid(np.arange(0, 4256, 16, dtype=np.float64),
                         np.arange(0, 2832, 16, dtype=np.float64))
    la64, lo64 = (a.numpy() for a in tg.georeference_points_generic(
        tw, p, px, py, torch.float64, device="cpu"))
    la32, lo32 = tg.georeference_points_generic(
        tw, p, px.astype(np.float32), py.astype(np.float32), torch.float32,
        device="cpu")
    assert la32.dtype == lo32.dtype == torch.float32
    la32, lo32 = la32.double().numpy(), lo32.double().numpy()
    assert np.array_equal(np.isnan(la64), np.isnan(la32))
    both = ~np.isnan(la64)
    assert both.sum() > 10_000
    dla = np.abs(la32[both] - la64[both])
    dlo = np.abs(lo32[both] - lo64[both])
    dlo = np.minimum(dlo, 360.0 - dlo)
    assert max(dla.max(), dlo.max()) < 1e-2
    assert np.median(dla) < 1e-4


@pytest.mark.parametrize("name", FRAMES)
def test_df64_points_match_the_goldens(name):
    golden = np.load(os.path.join(RES, f"golden_georef_{name}.npz"))
    header = fits.read_header(os.path.join(RES, f"{name}.wcs"))
    shifted = fits.get_shifted_spacecraft_position(header)
    pos = shifted[:3] if shifted else fits.get_spacecraft_position(header)
    params = tg.GeorefParams.from_wcs(TanWcs(header), pos,
                                      fits.get_photo_time(header),
                                      altitude=float(golden["altitude"]))
    px, py = np.meshgrid(golden["xs"] - 0.5, golden["ys"] - 0.5)
    lat, lon = tg.georeference_points_df64(params, px, py, device="cpu")
    full = tg.georeference_points_df64_full(params, px, py, device="cpu")
    assert sorted(full) == ["elevation", "lat", "lon", "mlat", "mlt"]
    for la, lo in ((lat, lon), (full["lat"], full["lon"])):
        assert isinstance(la, np.ndarray) and la.dtype == np.float64
        assert np.array_equal(np.isnan(la), np.isnan(golden["lat"]))
        assert np.array_equal(np.isnan(lo), np.isnan(golden["lon"]))
        m = ~np.isnan(golden["lat"])
        assert m.sum() > 100 and (~m).sum() > 0
        assert np.abs(la[m] - golden["lat"][m]).max() < 1e-6
        assert np.abs(lo[m] - golden["lon"][m]).max() < 1e-6
    m = ~np.isnan(golden["mlat"])
    assert np.array_equal(np.isnan(full["mlat"]), ~m)
    assert np.abs(full["mlat"][m] - golden["mlat"][m]).max() < 1e-6
    dm = np.abs(full["mlt"][m] - golden["mlt"][m])
    assert np.minimum(dm, 24.0 - dm).max() < 1e-6
    assert np.array_equal(np.isnan(full["elevation"]), ~m)
    # the variable set is selectable
    part = tg.georeference_points_df64_full(params, px, py,
                                            with_elevation=False,
                                            with_mlatmlt=False, device="cpu")
    assert sorted(part) == ["lat", "lon"]


def test_df64_full_on_a_zea_header_matches_the_jax_double_float_chain():
    jp, tp, jw, tw = both_params(header_as("ZEA"))
    px, py = _grid_points()
    want = jg.georeference_points_df64_full(
        jp, px.astype(np.float32), py.astype(np.float32), projection="ZEA")
    got = tg.georeference_points_df64_full(tp, px, py, projection="ZEA",
                                           device="cpu")
    by_wcs = tg.georeference_points_df64_full(tp, px, py, wcs=tw,
                                              device="cpu")
    assert sorted(got) == sorted(want)
    # on the CPU the JAX chain marks a miss with NaN in "lat" only (its
    # other variables come back 0 there, MLT 12): the latitude's NaNs are
    # the miss mask for every variable
    miss = np.isnan(want["lat"])
    assert 0.2 < miss.mean() < 0.8
    for k in want:
        assert np.array_equal(got[k], by_wcs[k], equal_nan=True)
        assert np.array_equal(np.isnan(got[k]), miss)
        close(got[k], np.where(miss, np.nan, want[k]), tol=1e-6,
              lon=(k == "lon"))


def test_df64_full_takes_the_families_the_double_float_chain_refuses():
    """HPX through ``wcs=``: equal to the float64 generic point chain; a
    projection name that needs constants is refused without its object."""
    _, tp, _, tw = both_params(header_as("HPX"))
    px, py = _grid_points(4)
    got = tg.georeference_points_df64_full(tp, px, py, wcs=tw, device="cpu")
    la, lo, el = tg.georeference_points_generic(tw, tp, px, py, torch.float64,
                                                True, device="cpu")
    assert np.array_equal(got["lat"], la.numpy(), equal_nan=True)
    assert np.array_equal(got["elevation"], el.numpy(), equal_nan=True)
    with pytest.raises(ValueError, match="wcs="):
        tg.georeference_points_df64_full(tp, px, py, projection="HPX",
                                         device="cpu")


@pytest.mark.parametrize("fast_center", [True, False])
def test_create_mapping_on_a_zea_header_matches_jax(fast_center):
    hd = header_as("ZEA")
    hd.pop("IMAGEW"), hd.pop("IMAGEH")  # filled in from the image
    pos, t = camera(hd)
    img = np.random.default_rng(3).integers(0, 256, (H, W, 3), dtype=np.uint8)
    jm = jcreate_mapping(hd, img, pos, t, identifier="zea",
                         fast_center=fast_center)
    m = create_mapping(hd, img, pos, t, identifier="zea",
                       fast_center=fast_center, device="cpu")
    assert np.array_equal(m.corner_mask, jm.corner_mask)
    assert np.array_equal(m.center_mask, jm.center_mask)
    assert 0.2 < m.center_mask.mean() < 0.8
    for name in ("lats", "lons", "latsCenter", "lonsCenter", "elevation"):
        close(getattr(m, name).filled(np.nan), getattr(jm, name).filled(np.nan),
              lon=name.startswith("lon"))
    for name in ("mLatMlt", "mLatMltCenter"):
        for a, b in zip(getattr(m, name), getattr(jm, name)):
            close(a.filled(np.nan), b.filled(np.nan))
    check_guarantees(m)
    m.checkGuarantees()
    jm.checkGuarantees()
    assert m.wcs_header is hd
    # "df64" is float64 for every family (the JAX package refuses HPX)
    md = create_mapping(header_as("HPX"), img, pos, t, dtype="df64",
                        device="cpu")
    check_guarantees(md)
    assert md.center_mask.mean() < 1.0


def test_create_mapping_refuses_a_non_equatorial_header():
    hd = header_as("ZEA")
    hd["CTYPE1"], hd["CTYPE2"] = "GLON-ZEA", "GLAT-ZEA"
    pos, t = camera(header_as("ZEA"))
    img = np.zeros((H, W, 3), np.uint8)
    with pytest.raises(ValueError, match="equatorial"):
        jcreate_mapping(hd, img, pos, t)
    with pytest.raises(ValueError, match="equatorial"):
        create_mapping(hd, img, pos, t, device="cpu")
    with pytest.raises(NotImplementedError, match="CSC"):
        create_mapping(header_as("CSC"), img, pos, t, device="cpu")
