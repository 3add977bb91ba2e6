"""The port's magnetic-grid path (``resample_mlat_mlt``) and the rest of its
Mapping surface, on the CPU, against the executed-reference goldens and the
JAX package.

* Full frame (ISS030-E-102170, 4256x2832, float64; built once per module):
  ``resample_mlat_mlt`` against golden_resample_mlatmlt_*.npz with the gates
  of tests/test_resample_parity.py::test_mlatmlt_parity (longitudes 1e-9
  deg, the binning gate, elevation 1e-4, the reference's unit-radius
  latitude reproduced within 1e-9 deg, the corrected latitudes by the MLat
  round trip within 1e-6 deg) and against the JAX package's
  ``resample_mlat_mlt`` on the same arrays (grids 1e-9 deg, masks equal,
  uint8 equal); the Mapping properties against golden_mapprops_*.npz as
  ::test_mapping_properties_parity (centroid and footpoint 1e-9 deg, pixel
  scales 1e-9 relative, both centre masks bit-exact).
* Small frame (the real calibration scaled to 128x96): each stage of the
  magnetic path against JAX on identical arrays (1e-9 deg, masks equal),
  both binning routes, ``maskedByPolygon`` over the pole and across the
  antimeridian, ``BoundingBox.center``/``size``, ``inflated_earth_intersection``
  (1e-9 km), ``MaskByElevationProvider`` over the spacecraft provider.

Every mapping built here passes ``check_guarantees``.
"""

import os
from datetime import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auromat_tpu.io import fits as jfits
from auromat_tpu.mapping import mapping as jmapping
from auromat_tpu.resample import resample as jresample
from auromat_tpu.resample import resample_mlat_mlt as jresample_mlat_mlt
from auromat_tpu_torch.coordinates.transform import (apply_rotation_vecs,
                                                     ecef_to_geodetic,
                                                     spherical_to_cartesian)
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.mapping.astrometry import create_mapping
from auromat_tpu_torch.mapping.mapping import (BoundingBox, Mapping,
                                               MaskByElevationProvider,
                                               check_guarantees,
                                               convert_mapping_to_sm,
                                               convert_sm_mapping_to_geo,
                                               inflated_earth_intersection)
from auromat_tpu_torch.mapping.spacecraft import (SpacecraftMappingProvider,
                                                  get_mapping)
from auromat_tpu_torch.resample import resample, resample_mlat_mlt
from test_resample_parity import _gate_binning

RES = os.path.join(os.path.dirname(__file__), "resources")
FULL = "ISS030-E-102170_dc"
W, H = 128, 96


def as_jax_mapping(m):
    """The JAX package's Mapping on the port mapping's own arrays (data,
    masks, image, precomputed MLat/MLT), so that a stage is compared on
    identical inputs."""
    jm = jmapping.Mapping(
        m.lats.data, m.lons.data, m.latsCenter.data, m.lonsCenter.data,
        None if m.elevation is None else m.elevation.data, m.altitude,
        m.img_unmasked, m.cameraPosGCRS, m.photoTime, m.identifier,
        metadata=m.metadata, sanitized=True, mlat_mlt=m._mlatmlt,
        mlat_mlt_center=m._mlatmlt_center)
    jm._corner_mask_arr = m.corner_mask.copy()
    jm._center_mask_arr = m.center_mask.copy()
    return jm


def same_mapping(m, jm, tol=1e-9, elev_tol=1e-9):
    """Grids within ``tol`` deg under equal masks, uint8 image equal,
    elevation within ``elev_tol`` deg."""
    assert np.array_equal(m.corner_mask, jm.corner_mask)
    assert np.array_equal(m.center_mask, jm.center_mask)
    assert 0 < (~m.center_mask).sum()
    for name in ("lats", "lons", "latsCenter", "lonsCenter"):
        a = getattr(m, name).filled(np.nan)
        b = np.asarray(getattr(jm, name).filled(np.nan))
        assert a.shape == b.shape
        d = np.abs(a - b)
        if name.startswith("lon"):
            d = np.minimum(d, 360.0 - d)
        assert np.nanmax(d) < tol, (name, np.nanmax(d))
    assert np.array_equal(m.img.filled(0), jm.img.filled(0))
    e = np.abs(m.elevation.filled(np.nan) - jm.elevation.filled(np.nan))
    assert np.nanmax(e) < elev_tol


# -- the full frame -----------------------------------------------------------

@pytest.fixture(scope="module")
def full():
    golden = np.load(os.path.join(RES, f"golden_resample_mlatmlt_{FULL}.npz"))
    m = get_mapping(os.path.join(RES, f"{FULL}.jpg"),
                    os.path.join(RES, f"{FULL}.wcs"),
                    altitude=float(golden["altitude"]), device="cpu")
    ppd = float(golden["px_per_deg"])
    r = resample_mlat_mlt(m, px_per_deg=ppd, contains_pole=False,
                          device="cpu")
    sm_r = resample(convert_mapping_to_sm(m), px_per_deg=ppd,
                    contains_pole=False, device="cpu")
    return golden, m, r, sm_r


def test_mlatmlt_binning_and_elevation_meet_the_golden(full):
    golden, _, r, _ = full
    assert np.asarray(r.lats).shape == golden["lats"].shape
    _gate_binning(r, golden)
    elev = np.asarray(r.elevation.filled(np.nan))
    both = ~np.isnan(elev) & ~np.isnan(golden["elevation"])
    assert both.sum() > 10_000
    assert np.abs(elev[both] - golden["elevation"][both]).max() < 1e-4
    check_guarantees(r)


def test_mlatmlt_longitudes_meet_the_golden(full):
    golden, _, r, _ = full
    lons = np.asarray(r.lons.filled(np.nan))
    both = ~np.isnan(lons) & ~np.isnan(golden["lons"])
    assert both.sum() > 10_000
    assert np.abs(lons[both] - golden["lons"][both]).max() < 1e-9


def test_unit_radius_latitude_of_the_reference_is_reproduced(full):
    """The golden's latitudes are Bowring on the UNIT-radius SM direction
    (the reference's smToLatLon); the port keeps the ray at the mapping
    altitude, and reproduces the golden from its own regular SM grid."""
    golden, _, r, sm_r = full
    x, y, z = spherical_to_cartesian(
        None, torch.from_numpy(np.deg2rad(sm_r.lats.data)),
        torch.from_numpy(np.deg2rad(sm_r.lons.data)))
    g = apply_rotation_vecs(sm_r.frame_matrices.sm_to_geo,
                            torch.stack([x, y, z], dim=-1))
    unit_lat, _ = ecef_to_geodetic(g[..., 0], g[..., 1], g[..., 2])
    unit_lat = np.rad2deg(unit_lat.numpy())
    both = ~np.isnan(r.lons.filled(np.nan)) & ~np.isnan(golden["lons"])
    assert np.abs(unit_lat[both] - golden["lats"][both]).max() < 1e-9
    # and the kept divergence is a large one on this frame
    assert np.abs(r.lats.filled(np.nan)[both] - golden["lats"][both]).max() > 10


def test_corrected_latitudes_round_trip_to_the_regular_mlat_grid(full):
    golden, _, r, sm_r = full
    mlat = np.asarray(r.mLatMlt[0].filled(np.nan))
    both = ~np.isnan(mlat) & ~np.isnan(golden["lons"])
    assert both.sum() > 10_000
    assert np.abs(mlat[both] - np.asarray(sm_r.lats.data)[both]).max() < 1e-6
    sm_r.checkPlateCarree()


def test_resample_mlat_mlt_matches_jax_on_the_full_frame(full):
    golden, m, r, _ = full
    jr_ = jresample_mlat_mlt(as_jax_mapping(m),
                             px_per_deg=float(golden["px_per_deg"]),
                             contains_pole=False)
    same_mapping(r, jr_)
    jr_.checkGuarantees()


PROPERTY_GATES = ["centroid", "footpoint", "scales", "outline", "elev15",
                  "polygon"]


@pytest.mark.parametrize("gate", PROPERTY_GATES)
def test_mapping_properties_meet_the_golden(full, gate):
    _, m, _, _ = full
    golden = np.load(os.path.join(RES, f"golden_mapprops_{FULL}.npz"))
    assert float(golden["altitude"]) == m.altitude
    if gate == "centroid":
        c = m.centroid
        assert abs(c.lat - golden["centroid"][0]) < 1e-9
        assert abs(c.lon - golden["centroid"][1]) < 1e-9
        assert m.properties.centroid == c
    elif gate == "footpoint":
        f = m.cameraFootpoint
        assert abs(f.lat - golden["camera_footpoint"][0]) < 1e-9
        assert abs(f.lon - golden["camera_footpoint"][1]) < 1e-9
        p = m.properties
        assert p.cameraFootpoint == f and p.identifier == FULL
        assert p.altitude == m.altitude and p.photoTime == m.photoTime
    elif gate == "scales":
        s = m.arcSecPerPx
        scales = np.array([[p.mean, p.median, p.min, p.max]
                           for p in (s.width, s.height, s.diagonal)])
        assert np.abs(scales / golden["arcsec_per_px"] - 1).max() < 1e-9
    elif gate == "outline":  # the same point multiset
        ro, go = np.asarray(m.outline), golden["outline"]
        assert ro.shape == go.shape
        assert np.abs(ro[np.lexsort(ro.T)] - go[np.lexsort(go.T)]).max() < 1e-9
    elif gate == "elev15":
        me = m.maskedByElevation(15)
        assert np.array_equal(np.ma.getmaskarray(me.img)[..., 0],
                              golden["elev15_center_mask"])
        check_guarantees(me)
    else:
        mp = m.maskedByPolygon(golden["mask_polygon"])
        assert np.array_equal(np.ma.getmaskarray(mp.img)[..., 0],
                              golden["poly_center_mask"])
        check_guarantees(mp)


# -- the small frame, stage by stage against JAX ------------------------------

def small_header():
    hd = dict(fits.read_header(os.path.join(RES, f"{FULL}.wcs")))
    scale = hd["IMAGEW"] / W
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        hd[k] = hd[k] * scale
    hd["CRPIX1"] /= scale
    hd["CRPIX2"] /= scale
    hd["IMAGEW"], hd["IMAGEH"] = W, H
    return hd


@pytest.fixture(scope="module")
def small():
    hd = small_header()
    pos = np.array(fits.get_shifted_spacecraft_position(hd)[:3])
    img = np.random.default_rng(11).integers(0, 256, (H, W, 3), dtype=np.uint8)
    m = create_mapping(hd, img, pos, fits.get_shifted_photo_time(hd),
                       identifier="small", device="cpu")
    check_guarantees(m)
    return m


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "elev10"])
def test_convert_mapping_to_sm_matches_jax(small, masked):
    m = small.maskedByElevation(10) if masked else small
    assert m._mlatmlt is not None and m._mlatmlt_center is not None
    sm = convert_mapping_to_sm(m)
    jsm = jmapping.convert_mapping_to_sm(as_jax_mapping(m))
    same_mapping(sm, jsm, tol=1e-12)
    assert np.array_equal(sm.center_mask, m.center_mask)
    # the coordinates are the magnetic ones: lon = (MLT - 12) * 15
    mlat, mlt = m.mLatMltCenter
    ok = ~m.center_mask
    assert np.array_equal(sm.latsCenter.data[ok], mlat.data[ok])
    d = np.abs(sm.lonsCenter.data[ok] - (mlt.data[ok] - 12.0) * 15.0)
    assert np.minimum(d, 360.0 - d).max() < 1e-9
    check_guarantees(sm)


@pytest.mark.parametrize("bin_method", ["sorted", "pallas_taint",
                                        "pallas_rgbelev"])
def test_sm_resample_and_back_match_jax(small, bin_method):
    """The SM mapping through both binning routes' plain versions, and the
    conversion of the regular grid back to geodetic coordinates."""
    sm = convert_mapping_to_sm(small)
    sm_r = resample(sm, px_per_deg=4, contains_pole=False,
                    bin_method=bin_method, device="cpu")
    jsm_r = jresample(as_jax_mapping(sm), px_per_deg=4, contains_pole=False,
                      bin_method="sorted")
    # the kernels' routes sum the elevation in float32
    elev_tol = 1e-9 if bin_method == "sorted" else 1e-4
    same_mapping(sm_r, jsm_r, elev_tol=elev_tol)
    sm_r.checkPlateCarree()
    back = convert_sm_mapping_to_geo(sm_r, device="cpu")
    jback = jmapping.convert_sm_mapping_to_geo(as_jax_mapping(sm_r))
    same_mapping(back, jback)
    # the source masks are carried over, not derived from NaNs
    assert np.array_equal(back.corner_mask, sm_r.corner_mask)
    assert back.corner_mask.any() and not np.isnan(back.lats.data).any()
    check_guarantees(back)


@pytest.mark.parametrize("min_elevation", [None, 10])
def test_resample_mlat_mlt_matches_jax(small, min_elevation):
    m = small if min_elevation is None else small.maskedByElevation(10)
    r = resample_mlat_mlt(m, px_per_deg=4, contains_pole=False, device="cpu")
    jr_ = jresample_mlat_mlt(as_jax_mapping(m), px_per_deg=4,
                             contains_pole=False)
    same_mapping(r, jr_)
    check_guarantees(r)
    # automatic pole detection takes the same branch
    r2 = resample_mlat_mlt(m, px_per_deg=4, device="cpu")
    same_mapping(r2, jr_)


def test_resample_mlat_mlt_by_arcsec(small):
    r = resample_mlat_mlt(small, arcsec_per_px=900, method="mean",
                          device="cpu")
    jr_ = jresample_mlat_mlt(as_jax_mapping(small), arcsec_per_px=900,
                             method="mean")
    same_mapping(r, jr_)


def _cap(name):
    g = np.load(os.path.join(RES, f"golden_resample_{name}.npz"))
    return (g["in_lats"], g["in_lons"], g["in_lats_center"],
            g["in_lons_center"], g["in_elevation"], 110.0, g["in_img"],
            [0.0, 0.0, 6871.0], datetime(2012, 1, 25, 9, 27, 57), name)


POLYGONS = {
    # a quadrilateral around the pole, inside the polar cap
    "polar": [(86.0, 0.0), (86.0, 90.0), (86.0, 180.0), (86.0, -90.0)],
    # across the antimeridian
    "discont": [(55.0, 175.0), (55.0, -175.0), (65.0, -172.0), (64.0, 172.0)],
}


@pytest.mark.parametrize("name", ["polar", "discont"])
def test_masked_by_polygon_over_pole_and_antimeridian(name):
    args = _cap(name)
    m, jm = Mapping(*args), jmapping.Mapping(*args)
    poly = np.array(POLYGONS[name])
    mp, jmp = m.maskedByPolygon(poly), jm.maskedByPolygon(poly)
    assert np.array_equal(mp.center_mask, jmp.center_mask)
    assert np.array_equal(mp.corner_mask, jmp.corner_mask)
    kept = (~mp.center_mask).sum()
    assert 0 < kept < (~m.center_mask).sum()
    check_guarantees(mp)
    with pytest.raises(ValueError, match="mask all"):
        m.maskedByPolygon(np.array([(-60.0, 10.0), (-60.0, 11.0),
                                    (-59.0, 10.5)]))


BOXES = [(48.0, -110.0, 61.0, -92.0), (10.0, 170.0, 30.0, -160.0),
         (70.0, -180.0, 90.0, 180.0), (-90.0, -180.0, -65.0, 180.0),
         (-5.0, 20.0, 40.0, 25.0)]


@pytest.mark.parametrize("box", BOXES)
def test_bounding_box_center_and_size_match_jax(box):
    b, jb = BoundingBox(*box), jmapping.BoundingBox(*box)
    assert abs(b.center.lat - jb.center.lat) < 1e-9
    d = abs(b.center.lon - jb.center.lon)
    assert min(d, 360.0 - d) < 1e-9
    assert np.allclose(b.size, jb.size, rtol=1e-12, atol=0)
    assert b.size.width > 0 and b.size.height > 0


@pytest.mark.parametrize("earth_model", ["wgs84", "sphere"])
def test_inflated_earth_intersection_matches_jax(earth_model):
    rng = np.random.default_rng(2)
    pos = np.array([3000.0, -4000.0, 4500.0])
    d = -pos / np.linalg.norm(pos) + rng.normal(0, 1.0, (500, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = inflated_earth_intersection(d, pos, 110, earth_model, device="cpu")
    want = np.asarray(jmapping.inflated_earth_intersection(
        jnp.asarray(d), jnp.asarray(pos), 110, earth_model))
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert np.array_equal(np.isnan(got), np.isnan(want))
    hit = ~np.isnan(want)
    assert 0.1 < hit.mean() < 0.9
    assert np.abs(got[hit] - want[hit]).max() < 1e-9 * 6500
    with pytest.raises(ValueError, match="earth model"):
        inflated_earth_intersection(d, pos, 110, "flat", device="cpu")


def test_rgb_views(small):
    assert small.rgb_unmasked is small.img_unmasked
    assert np.array_equal(np.ma.getmaskarray(small.rgb)[..., 0],
                          small.center_mask)
    gray = Mapping(small.lats, small.lons, small.latsCenter, small.lonsCenter,
                   small.elevation, 110.0,
                   small.img_unmasked[..., 0].astype(np.uint16) * 257,
                   small.cameraPosGCRS, small.photoTime, "gray")
    jgray = as_jax_mapping(gray)
    assert gray.rgb_unmasked.shape == (H, W, 3)
    assert np.array_equal(gray.rgb_unmasked, jgray.rgb_unmasked)
    assert np.array_equal(gray.rgb.filled(0), jgray.rgb.filled(0))
    assert np.array_equal(gray.rgb_unmasked[..., 0], small.img_unmasked[..., 0])


@pytest.fixture(scope="module")
def small_folder(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("magnetic") / "small"
    d.mkdir()
    hd = jfits.read_header(os.path.join(RES, f"{FULL}.wcs"))
    hd.update(small_header())
    jfits.write_header(hd, str(d / "small.wcs"))
    img = np.random.default_rng(5).integers(0, 256, (H, W, 3), np.uint8)
    Image.fromarray(img).save(d / "small.png")
    return str(d)


@pytest.mark.parametrize("how", ["get", "getById", "getSequence",
                                 "getSequenceBatched"])
def test_mask_by_elevation_provider(small_folder, how):
    base = SpacecraftMappingProvider(small_folder, fast_center=True,
                                     device="cpu")
    prov = MaskByElevationProvider(base, 10)
    (plain,) = base.getSequence()
    if how == "get":
        m = prov.get(plain.photoTime)
    elif how == "getById":
        m = prov.getById("small")
    elif how == "getSequence":
        (m,) = prov.getSequence()
    else:
        (m,) = prov.getSequenceBatched(batch=4)
    assert m.center_mask.sum() > plain.center_mask.sum()
    assert (m.elevation.compressed() >= 10).all()
    assert m._mlatmlt is not None
    check_guarantees(m)
    # the wrapped provider itself is untouched
    (again,) = base.getSequence()
    assert np.array_equal(again.center_mask, plain.center_mask)
