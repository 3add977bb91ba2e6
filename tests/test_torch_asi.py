"""The port's all-sky-imager path against the JAX package and the goldens,
on the CPU: geometry (``coordinates.intersection``,
``transform.geodetic_to_ecef_zero``, ``utils.points_inside_polygon``), the
THEMIS and MIRACLE providers, ``mosaic`` and the convert CLI on THEMIS and
MIRACLE folders.

* intersection: within 1e-9 of JAX on rays that hit, miss, start inside
  and point away; the same NaN positions (a miss, a hit behind the origin).
* ``points_inside_polygon`` (numpy) array-equal to matplotlib's
  ``Path.contains_points`` on the ISS030 and MIRACLE outlines and on random
  polygons, with random points, the vertices and the edge midpoints.
* THEMIS: ``reproject``/``reproject_batch`` within 1e-9 deg of
  golden_themis_reproject.npz with identical NaN masks, batched == serial;
  on synthetic L1/L2 CDFs (two stations, the JAX tests' generator)
  ``ThemisMappingProvider.get``/``getSequence``/``getById`` give JAX's
  coordinates within 1e-9 deg and its uint16 images and masks exactly, and
  ``mosaic`` gives JAX's uint16 mosaic exactly.
* MIRACLE: ``get_calibration_data`` equal to JAX's on cal.txt;
  ``fisheye_az_el``, ``az_el_to_geo_directions`` and the full chain against
  golden_miracle_fisheye.npz at tests/test_providers.py's tolerances;
  ``get_mapping`` (the real SOD frame) and its array helper against JAX.
* ``convert --platform cpu`` on THEMIS and MIRACLE folders, with and
  without ``--grid geo``: the JAX CLI's file names, and its variables
  within the tolerances tests/test_torch_cli.py applies to spacecraft
  folders.
* The port's ASI modules import neither jax, nor the JAX package, nor
  matplotlib.
"""

import datetime as dt
import os
import shutil
import subprocess
import sys

import matplotlib.path
import numpy as np
import pytest
import torch

from auromat_tpu import resample as jresample
from auromat_tpu.cli import convert as jconvert
from auromat_tpu.constants import WGS84_A, WGS84_B
from auromat_tpu.coordinates import intersection as jint
from auromat_tpu.coordinates import transform as jtransform
from auromat_tpu.mapping import miracle as jmiracle
from auromat_tpu.mapping import themis as jthemis
from auromat_tpu.mapping.cdf import read_mapping as jread_cdf
from auromat_tpu.mapping.netcdf import read_mapping as jread_nc
from auromat_tpu_torch import resample as tresample
from auromat_tpu_torch import utils as tutils
from auromat_tpu_torch.cli import convert
from auromat_tpu_torch.coordinates import intersection as tint
from auromat_tpu_torch.coordinates import transform as ttransform
from auromat_tpu_torch.mapping import miracle, themis
from auromat_tpu_torch.mapping.mapping import MappingCollection
from test_providers import synth_themis_cdfs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "tests", "resources")
SOD = "SOD120304_171900_557_1000.jpg"
SOD_DATE = dt.datetime(2012, 3, 4, 17, 19)
CPU = ["--platform", "cpu"]


def t64(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def assert_close_nan(a, b, tol=1e-9):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    if ok.any():
        assert np.abs(a[ok] - b[ok]).max() < tol


# -- geometry -----------------------------------------------------------------

def ray_cases():
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(400, 3))
    outside = np.array([7000.0, 1000.0, 500.0])
    inside = np.array([1000.0, -2000.0, 3000.0])
    return dirs, outside, inside


@pytest.mark.parametrize("directed", [True, False])
def test_ellipsoid_line_intersection_matches_jax(directed):
    dirs, outside, inside = ray_cases()
    a, b = WGS84_A + 110.0, WGS84_B + 110.0
    for origin in (outside, inside):
        ours = tint.ellipsoid_line_intersection(a, b, t64(origin), t64(dirs),
                                                directed).numpy()
        theirs = np.asarray(jint.ellipsoid_line_intersection(
            a, b, origin, dirs, directed))
        assert_close_nan(ours, theirs, 1e-6)  # km: 1e-9 relative
        hits = tint.ellipsoid_line_intersects(a, b, t64(origin), t64(dirs),
                                              directed).numpy()
        assert np.array_equal(hits, np.asarray(jint.ellipsoid_line_intersects(
            a, b, origin, dirs, directed)))
    miss = tint.ellipsoid_line_intersection(a, b, t64(outside), t64(dirs))
    assert torch.isnan(miss).any() and (~torch.isnan(miss)).any()
    behind = tint.ellipsoid_line_intersection(a, b, t64(outside),
                                              t64(outside)[None], directed)
    assert bool(torch.isnan(behind).all()) == directed


@pytest.mark.parametrize("directed", [True, False])
def test_sphere_line_intersection_matches_jax(directed):
    dirs, outside, inside = ray_cases()
    dirs = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    for origin in (outside, inside):
        ours = tint.sphere_line_intersection(6500.0, t64(origin), t64(dirs),
                                             directed).numpy()
        assert_close_nan(ours, np.asarray(jint.sphere_line_intersection(
            6500.0, origin, dirs, directed)), 1e-6)


def test_batched_origins_broadcast():
    """An (S, 1, 1, 3) origin serves (S, h, w, 3) rays, as reproject_batch
    uses it; each station equals its own call."""
    rng = np.random.default_rng(1)
    origins = rng.normal(size=(3, 3)) * 3000
    dirs = rng.normal(size=(3, 4, 5, 3))
    a, b = WGS84_A + 90.0, WGS84_B + 90.0
    batched = tint.ellipsoid_line_intersection(
        a, b, t64(origins)[:, None, None], t64(dirs)).numpy()
    for s in range(3):
        one = tint.ellipsoid_line_intersection(a, b, t64(origins[s]),
                                               t64(dirs[s])).numpy()
        assert np.array_equal(batched[s], one, equal_nan=True)


def test_geodetic_to_ecef_zero_matches_jax():
    rng = np.random.default_rng(2)
    lat, lon = rng.uniform(-1.5, 1.5, 100), rng.uniform(-3.1, 3.1, 100)
    ours = ttransform.geodetic_to_ecef_zero(t64(lat), t64(lon))
    theirs = jtransform.geodetic_to_ecef_zero(lat, lon)
    for o, t in zip(ours, theirs):
        assert np.abs(o.numpy() - np.asarray(t)).max() < 1e-9
    h0 = ttransform.geodetic_to_ecef(t64(lat), t64(lon), 0.0)
    for o, t in zip(ours, h0):
        assert np.abs(o.numpy() - t.numpy()).max() < 1e-9


def small_iss_mapping():
    """The real ISS030-E-102170 calibration scaled to 128x96 pixels."""
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from test_torch_devices import small_header
    from auromat_tpu_torch.io import fits

    header = small_header()
    pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
    img = np.zeros((96, 128, 3), np.uint8)
    return create_mapping(header, img, pos, fits.get_shifted_photo_time(header),
                          device="cpu")


@pytest.fixture(scope="module")
def sod_mapping():
    return miracle.get_mapping(os.path.join(RES, SOD), altitude=110,
                               device="cpu")


def polygon_points(poly, rng, n=3000):
    lo, hi = poly.min(axis=0) - 0.5, poly.max(axis=0) + 0.5
    mids = (poly + np.roll(poly, 1, axis=0)) / 2
    return np.concatenate([rng.uniform(lo, hi, (n, 2)), poly, mids,
                           [[np.nan, 0.0], [0.0, np.inf]]])


@pytest.mark.parametrize("which", ["iss030", "miracle", "random"])
def test_points_inside_polygon_matches_matplotlib(which, sod_mapping):
    rng = np.random.default_rng(3)
    if which == "random":
        polys = [rng.integers(0, 12, (rng.integers(3, 30), 2)).astype(float)
                 for _ in range(50)]
    else:
        m = small_iss_mapping() if which == "iss030" else sod_mapping
        polys = [m.outline]
    for poly in polys:
        pts = polygon_points(poly, rng)
        if which != "random":  # the corner grid resample tests
            grid = tresample.fixed_grid(10, poly[:, 0].min(),
                                        poly[:, 0].max(), poly[:, 1].min(),
                                        poly[:, 1].max())
            lats, lons = grid.corner_grids()
            pts = np.concatenate([pts, np.stack([lats.ravel(), lons.ravel()],
                                                axis=-1)])
        ours = tutils.points_inside_polygon(pts, poly)
        theirs = matplotlib.path.Path(poly).contains_points(pts)
        assert np.array_equal(ours, theirs)
        assert 0 < ours.sum() < len(pts) or which == "random"
    assert not tutils.points_inside_polygon([[0.5, 0.5]], [[0, 0], [1, 1]])


def test_small_host_helpers():
    from auromat_tpu import utils as jutils

    a = np.array([1.0, 2.5, 4.0, 9.0])
    for v in (-1.0, 1.0, 1.7, 1.75, 3.3, 8.9, 20.0):
        assert tutils.find_nearest(a, v) == jutils.find_nearest(a, v)
    poly = np.random.default_rng(4).normal(size=(9, 2))
    assert tutils.polygon_area(poly) == jutils.polygon_area(poly)
    assert tutils.polygon_centroid(poly) == jutils.polygon_centroid(poly)


# -- THEMIS -------------------------------------------------------------------

def test_reproject_matches_the_reference_golden():
    g = np.load(os.path.join(RES, "golden_themis_reproject.npz"))
    ll = (float(g["lat_asi"]), float(g["lon_asi"]))
    for h_new in (90, 150):
        la, lo = themis.reproject(ll, g["lats_ref"], g["lons_ref"],
                                  float(g["height_ref"]), float(h_new),
                                  device="cpu")
        ref_la, ref_lo = g[f"lats_{h_new}"], g[f"lons_{h_new}"]
        assert np.array_equal(np.isnan(la), np.isnan(ref_la))
        m = ~np.isnan(ref_la)
        assert m.sum() > 500
        assert np.abs(la[m] - ref_la[m]).max() < 1e-9
        assert np.abs(lo[m] - ref_lo[m]).max() < 1e-9
        # one station through the batch == the serial call
        lab, lob = themis.reproject_batch(
            np.array([ll]), g["lats_ref"][None], g["lons_ref"][None],
            float(g["height_ref"]), float(h_new), device="cpu")
        assert np.array_equal(lab[0], la, equal_nan=True)
        assert np.array_equal(lob[0], lo, equal_nan=True)


@pytest.fixture
def themis_dir(tmp_path):
    date, _ = synth_themis_cdfs(str(tmp_path), station="gill")
    synth_themis_cdfs(str(tmp_path), station="atha")
    return str(tmp_path), date


def test_reproject_batch_equals_serial_and_jax(themis_dir):
    d, _ = themis_dir
    cals = [themis.get_l2_data(d, st) for st in ("gill", "atha")]
    lat_lon = np.array([c[0] for c in cals])
    lats_ref = np.stack([c[3][0] for c in cals])
    lons_ref = np.stack([c[4][0] for c in cals])
    h_ref = np.array([c[5][0] for c in cals])
    lab, lob = themis.reproject_batch(lat_lon, lats_ref, lons_ref, h_ref,
                                      100.0, device="cpu")
    jla, jlo = jthemis.reproject_batch(lat_lon, lats_ref, lons_ref, h_ref,
                                       100.0)
    assert_close_nan(lab, jla)
    assert_close_nan(lob, jlo)
    for i, c in enumerate(cals):
        la, lo = themis.reproject(c[0], c[3][0], c[4][0], c[5][0], 100.0,
                                  device="cpu")
        assert np.array_equal(lab[i], la, equal_nan=True)
        assert np.array_equal(lob[i], lo, equal_nan=True)


def assert_same_mappings(ours, theirs):
    assert [m.identifier for m in ours] == [m.identifier for m in theirs]
    for m, jm in zip(ours, theirs):
        assert type(m).__name__ == type(jm).__name__
        for name in ("lats", "lons", "latsCenter", "lonsCenter",
                     "elevation"):
            assert_close_nan(getattr(m, name).filled(np.nan),
                             getattr(jm, name).filled(np.nan))
        assert np.array_equal(m.center_mask, jm.center_mask)
        assert np.array_equal(m.corner_mask, jm.corner_mask)
        assert m.img.dtype == jm.img.dtype == np.uint16
        assert np.array_equal(m.img.filled(0), jm.img.filled(0))
        assert np.array_equal(m.rgb.filled(0), jm.rgb.filled(0))
        assert m.photoTime == jm.photoTime and m.altitude == jm.altitude
        assert np.abs(m.cameraPosGCRS - jm.cameraPosGCRS).max() < 1e-6


@pytest.mark.parametrize("altitude", [110, 100])
def test_themis_provider_and_mosaic_match_jax(themis_dir, altitude):
    d, date = themis_dir
    kw = dict(altitude=altitude, offline=True, stations=["gill", "atha"])
    prov = themis.ThemisMappingProvider(d, d, device="cpu", **kw)
    jprov = jthemis.ThemisMappingProvider(d, d, **kw)
    coll, jcoll = prov.get(date), jprov.get(date)
    assert coll.identifier == jcoll.identifier and coll.mayOverlap
    assert_same_mappings(coll.mappings, jcoll.mappings)
    assert_same_mappings([prov.getById("atha.2012.02.04.07.56.26")],
                         [jprov.getById("atha.2012.02.04.07.56.26")])
    assert prov.contains(date) and not prov.contains(
        date + dt.timedelta(seconds=30))

    mo = tresample.mosaic(coll, device="cpu")
    jmo = jresample.mosaic(jcoll)
    assert mo.identifier == jmo.identifier == f"{coll.identifier}.mosaic"
    assert mo.img.dtype == np.uint16
    assert np.array_equal(np.ma.getmaskarray(mo.img),
                          np.ma.getmaskarray(jmo.img))
    assert np.array_equal(mo.img.filled(0), jmo.img.filled(0))
    assert (~mo.center_mask).sum() > 500
    assert np.array_equal(mo.elevation.filled(np.nan),
                          jmo.elevation.filled(np.nan), equal_nan=True)
    assert np.array_equal(mo.lats.filled(np.nan), jmo.lats.filled(np.nan),
                          equal_nan=True)
    for ppd in (10, (12, 20)):
        a = tresample.mosaic(coll, px_per_deg=ppd, device="cpu")
        b = jresample.mosaic(jcoll, px_per_deg=ppd)
        assert np.array_equal(a.img.filled(0), b.img.filled(0))


def test_themis_sequence_matches_jax(themis_dir):
    d, date = themis_dir
    kw = dict(altitude=100, offline=True, stations=["gill", "atha"])
    t0, t1 = date - dt.timedelta(seconds=5), date + dt.timedelta(seconds=30)
    seq = list(themis.ThemisMappingProvider(d, d, device="cpu", **kw)
               .getSequence(t0, t1))
    jseq = list(jthemis.ThemisMappingProvider(d, d, **kw).getSequence(t0, t1))
    assert len(seq) == len(jseq) == 3
    for c, jc in zip(seq, jseq):
        assert c.identifier == jc.identifier
        assert_same_mappings(c.mappings, jc.mappings)
    with pytest.raises(ValueError, match="explicit"):
        next(themis.ThemisMappingProvider(d, d, device="cpu", **kw)
             .getSequence())


def test_themis_mixed_grid_shapes_batch_by_shape(tmp_path, monkeypatch):
    date, _ = synth_themis_cdfs(str(tmp_path), station="gill", size=32)
    synth_themis_cdfs(str(tmp_path), station="atha", size=16)
    synth_themis_cdfs(str(tmp_path), station="fsim", size=32)
    calls = []
    real = themis.reproject_batch
    monkeypatch.setattr(themis, "reproject_batch", lambda *a, **k: (
        calls.append(a[1].shape), real(*a, **k))[1])
    coll = themis.get_mappings(date, str(tmp_path), str(tmp_path),
                               altitude=100, offline=True,
                               stations=["gill", "atha", "fsim"],
                               device="cpu")
    assert sorted(calls) == [(1, 17, 17), (2, 33, 33)]
    jcoll = jthemis.get_mappings(date, str(tmp_path), str(tmp_path),
                                 altitude=100, offline=True,
                                 stations=["gill", "atha", "fsim"])
    assert_same_mappings(coll.mappings, jcoll.mappings)


def test_themis_cache_helpers(tmp_path):
    date = dt.datetime(2012, 2, 4, 7)
    path404 = os.path.join(str(tmp_path),
                           themis.l1_filename("gill", date) + ".404")
    from auromat_tpu_torch.util.osutil import touch

    touch(path404)
    assert themis.has_l1_data(str(tmp_path), "gill", date) == "404"
    assert not themis.download_l1_data(str(tmp_path), "gill", date)
    old = dt.datetime.now() - dt.timedelta(days=31)
    os.utime(path404, (old.timestamp(), old.timestamp()))
    assert themis.has_l1_data(str(tmp_path), "gill", date) is False
    assert not os.path.exists(path404)
    assert themis.l1_times(str(tmp_path), "gill", date) == []
    prov = themis.ThemisMappingProvider(str(tmp_path), str(tmp_path),
                                        offline=True, stations=["gill"],
                                        device="cpu")
    with pytest.raises(RuntimeError, match="offline"):
        prov.download(date, date)
    with pytest.raises(ValueError, match="No THEMIS"):
        prov.get(date)
    img = np.arange(6.0).reshape(2, 3)
    masked = themis.mask_by_l2(np.array([[1, 0, 0], [0, 0, 1]]), img)
    assert np.isnan(masked[0, 0]) and np.isnan(masked[1, 2])
    assert np.array_equal(themis.bytscl(np.array([0.0, 5.0, 50.0]), max_=10),
                          jthemis.bytscl(np.array([0.0, 5.0, 50.0]), max_=10))


def test_mosaic_refusals(themis_dir):
    d, date = themis_dir
    coll = themis.ThemisMappingProvider(d, d, offline=True,
                                        stations=["gill", "atha"],
                                        device="cpu").get(date)
    with pytest.raises(ValueError, match="empty"):
        tresample.mosaic([], device="cpu")
    m0 = coll.mappings[0]
    moved = type(m0)(m0.lats.filled(np.nan), m0.lons.filled(np.nan),
                     m0.latsCenter.filled(np.nan),
                     m0.lonsCenter.filled(np.nan),
                     m0.elevation.filled(np.nan), 120.0, m0.img_unmasked,
                     m0.cameraPosGCRS, m0.photoTime, "x")
    with pytest.raises(ValueError, match="altitudes"):
        tresample.mosaic([m0, moved], device="cpu")


def test_min_lon_interval_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(30):
        c = rng.uniform(-180, 180)
        lons = tresample._wrap_lon_np(c + rng.uniform(-40, 40, 20))
        lons[rng.random(20) < 0.1] = np.nan
        assert tresample._min_lon_interval_deg(lons) == \
            jresample._min_lon_interval_deg(lons)


def test_resample_provider_wraps_every_getter(themis_dir):
    d, date = themis_dir
    prov = themis.ThemisMappingProvider(d, d, offline=True,
                                        stations=["gill", "atha"],
                                        device="cpu")
    wrapped = tresample.ResampleProvider(prov, px_per_deg=10, device="cpu")
    coll = wrapped.get(date)
    assert isinstance(coll, MappingCollection) and len(coll) == 2
    assert all(m.isPlateCarree for m in coll.mappings)
    seq = list(wrapped.getSequence(date - dt.timedelta(seconds=1),
                                   date + dt.timedelta(seconds=1)))
    assert len(seq) == 1 and seq[0].mappings[0].isPlateCarree
    assert not prov.get(date).mappings[0].isPlateCarree  # a copy was wrapped


# -- MIRACLE ------------------------------------------------------------------

def test_miracle_calibration_matches_jax():
    path = os.path.join(RES, "cal.txt")
    for date in (SOD_DATE, dt.datetime(2012, 1, 1)):
        assert miracle.get_calibration_data(path, "SOD", date)[:9] == \
            jmiracle.get_calibration_data(path, "SOD", date)[:9]
    bb = miracle.get_calibration_data(path, "SOD", SOD_DATE).boundingBoxSimple
    assert (bb.latSouth, bb.lonWest, bb.latNorth, bb.lonEast) == (
        64.12, 10.09, 70.72, 42.69)
    for station, date in (("SOD", dt.datetime(2005, 1, 1)),
                          ("XXX", dt.datetime(2012, 1, 1))):
        with pytest.raises(ValueError):
            miracle.get_calibration_data(path, station, date)


def test_miracle_fisheye_matches_the_reference_golden():
    g = np.load(os.path.join(RES, "golden_miracle_fisheye.npz"))
    cal = miracle.CalibrationData(
        station="SOD", validFrom=None, validTo=None,
        lat=float(g["lat_asi"]), lon=float(g["lon_asi"]),
        xc=float(g["xc"]), yc=float(g["yc"]), k=float(g["k"]),
        rotation=float(g["rotation"]), boundingBoxSimple=None)
    size = int(g["size"])
    for corner, az_key, el_key in ((False, "az_center", "el_center"),
                                   (True, "az_corner", "el_corner")):
        az, el = miracle.fisheye_az_el(cal, size, corner=corner)
        daz = np.abs((az - g[az_key] + 180.0) % 360.0 - 180.0)
        assert daz.max() < 1e-9
        assert np.abs(el - g[el_key]).max() < 1e-9
    dirs = miracle.az_el_to_geo_directions(cal, g["az_center"],
                                           g["el_center"])
    assert np.abs(dirs - g["dirs"]).max() < 1e-12
    # the full chain: the port's device intersection in float64
    alt = float(g["altitude"])
    la, lo = miracle._grid_latlon(cal, size, alt,
                                  ttransform.station_ecef(cal.lat, cal.lon),
                                  False, torch.device("cpu"))
    above = g["el_center"] >= 1.0
    assert above.sum() > 500
    assert np.abs(la[above] - g["lats"][above]).max() < 1e-9
    dlo = np.abs((lo[above] - g["lons"][above] + 180.0) % 360.0 - 180.0)
    assert dlo.max() < 1e-9


@pytest.mark.parametrize("simple", [False, True])
def test_miracle_get_mapping_matches_jax(sod_mapping, simple):
    path = os.path.join(RES, SOD)
    m = (sod_mapping if not simple else
         miracle.get_mapping(path, simple=True, device="cpu"))
    jm = jmiracle.get_mapping(path, altitude=110, simple=simple)
    assert m.identifier == jm.identifier == "SOD.2012.03.04.17.19.00"
    assert isinstance(m, miracle.MIRACLEMapping)
    for name in ("lats", "lons", "latsCenter", "lonsCenter", "elevation"):
        assert_close_nan(getattr(m, name).filled(np.nan),
                         getattr(jm, name).filled(np.nan))
    assert np.array_equal(m.center_mask, jm.center_mask)
    assert np.array_equal(m.img.filled(0), jm.img.filled(0))
    assert m.img.shape == (512, 512, 3)
    if simple:
        m.checkPlateCarree()
    # the array helper is the whole of get_mapping after reading the file
    from auromat_tpu_torch.io.image import load_image

    cal = miracle.get_calibration_data(os.path.join(RES, "cal.txt"), "SOD",
                                       SOD_DATE)
    a = miracle.create_mapping(load_image(path), cal, SOD_DATE, 110, simple,
                               device="cpu")
    assert np.array_equal(a.lats.filled(np.nan), m.lats.filled(np.nan),
                          equal_nan=True)
    assert np.array_equal(a.img.filled(0), m.img.filled(0))


def test_miracle_provider(sod_mapping):
    prov = miracle.MIRACLEMappingProvider(RES, altitude=110, device="cpu")
    assert len(prov) == 1 and prov.range[0] == SOD_DATE
    date = SOD_DATE + dt.timedelta(seconds=2)
    assert prov.contains(date)
    assert not prov.contains(date + dt.timedelta(seconds=30))
    coll = prov.get(date)
    assert coll.identifier == "MIRACLE.2012.03.04.17.19.02" and len(coll) == 1
    assert np.array_equal(coll.mappings[0].lats.filled(np.nan),
                          sod_mapping.lats.filled(np.nan), equal_nan=True)
    assert prov.getById("SOD.2012.03.04.17.19.00").altitude == 110
    with pytest.raises(ValueError):
        prov.getById("SOD.2012.03.04.17.19.01")
    assert len(list(prov.getSequence())) == 1
    assert list(prov.getSequence(date)) == []


def test_miracle_mosaic_on_rgb(sod_mapping):
    mo = tresample.mosaic(MappingCollection([sod_mapping], "one"),
                          device="cpu")
    r = tresample.resample(sod_mapping, method="nearest_device",
                           device="cpu")
    assert mo.img.dtype == np.uint8 and mo.img.shape[-1] == 3
    assert (~mo.center_mask).sum() > 10000
    assert r.img.shape == mo.img.shape


# -- convert ------------------------------------------------------------------

def read(path):
    return (jread_cdf if path.endswith(".cdf") else jread_nc)(path)


def assert_files_agree(port_dir, jax_dir):
    names = sorted(os.listdir(jax_dir))
    assert names and sorted(os.listdir(port_dir)) == names
    for name in names:
        m, jm = read(os.path.join(port_dir, name)), read(
            os.path.join(jax_dir, name))
        for attr in ("lats", "lons", "latsCenter", "lonsCenter"):
            a, b = getattr(m, attr).data, getattr(jm, attr).data
            assert a.shape == b.shape
            assert_close_nan(a, b)
        assert np.array_equal(m.center_mask, jm.center_mask)
        assert np.array_equal(m.img.filled(0), jm.img.filled(0))
        ok = ~m.center_mask
        assert ok.sum() > 100
        assert np.abs(m.elevation.data - jm.elevation.data)[ok].max() < 1e-6
        assert m.photoTime == jm.photoTime and m.altitude == jm.altitude
        for ours, theirs in ((m.mLatMlt, jm.mLatMlt),
                             (m.mLatMltCenter, jm.mLatMltCenter)):
            for a, b in zip(ours, theirs):
                ok = ~np.isnan(a.data) & ~np.isnan(b.data)
                assert ok.sum() > 100
                assert np.abs(a.data[ok] - b.data[ok]).max() < 1e-9


@pytest.fixture(scope="module")
def asi_folders(tmp_path_factory):
    base = tmp_path_factory.mktemp("asi")
    th = base / "themis"
    th.mkdir()
    date, _ = synth_themis_cdfs(str(th), station="gill")
    synth_themis_cdfs(str(th), station="atha")
    mi = base / "miracle"
    mi.mkdir()
    shutil.copy(os.path.join(RES, SOD), mi / SOD)
    shutil.copy(os.path.join(RES, "cal.txt"), mi / "cal.txt")
    return str(th), str(mi), date


@pytest.mark.parametrize("source", ["themis", "miracle"])
@pytest.mark.parametrize("grid", [[], ["--grid", "geo", "--arcsecperpx",
                                       "300"]], ids=["none", "geo"])
def test_convert_asi_folders_match_jax_cli(asi_folders, tmp_path, source,
                                           grid):
    th, mi, date = asi_folders
    folder = th if source == "themis" else mi
    extra = list(grid)
    if source == "themis":
        extra += ["--start", (date - dt.timedelta(seconds=4)).isoformat(),
                  "--end", (date + dt.timedelta(seconds=4)).isoformat()]
    fmt = ["--format", "netcdf" if grid else "cdf"]
    assert jconvert.main([folder, *extra, *fmt,
                          "--out", str(tmp_path / "jax")]) == 0
    assert convert.main(CPU + [folder, *extra, *fmt,
                               "--out", str(tmp_path / "port")]) == 0
    assert_files_agree(str(tmp_path / "port"), str(tmp_path / "jax"))
    n = len(os.listdir(tmp_path / "port"))
    assert n == (6 if source == "themis" else 1)


def test_asi_modules_import_no_jax_nor_matplotlib():
    res = subprocess.run([sys.executable, "-c", (
        "import sys\n"
        "import auromat_tpu_torch.resample, auromat_tpu_torch.mapping.themis\n"
        "import auromat_tpu_torch.mapping.miracle, auromat_tpu_torch.cli.convert\n"
        "import auromat_tpu_torch.coordinates.intersection\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'auromat_tpu', 'matplotlib')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
