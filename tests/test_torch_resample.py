"""The port's public georeference -> resample('mean') slice against the JAX
package and the executed-reference goldens:

1. ``utils.outline`` (a numpy border follower) array-equal to the JAX
   package's OpenCV version — start point and orientation included — on
   both resource frames' corner masks and on concave, border-touching and
   two-component synthetic masks;
2. ``georeference`` and ``create_mapping`` (float64, both ``fast_center``
   values, with MLat/MLT) against JAX on the 128x96 scaled real frame:
   within 1e-9 deg, masks equal;
3. ``resample`` of that mapping against JAX ``resample`` with the
   'sorted', 'pallas_taint' and 'pallas_rgbelev' binnings (JAX's Pallas
   kernels in interpret mode): grids within 1e-9, masks equal, uint8 within
   the ``_gate_binning`` class of tests/test_resample_parity.py;
4. the synthetic pole / discontinuity goldens with the gates of
   ``TestSyntheticPaths``;
5. one full-size run, ``get_mapping`` + ``resample`` of ISS030-E-102170
   (4256x2832 -> 336x495 at 25 px/deg, float64) against
   golden_resample_ISS030-E-102170_dc.npz with the gates of
   ``test_grid_alignment``, ``test_image_binning`` and
   ``test_elevation_binning``, and its polygons (``draw_helpers``) against
   golden_polygons_ISS030-E-102170_dc.npz.

The binning routes on the card are tested in tests/test_torch_gpu.py.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from datetime import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auromat_tpu.ops.georegrid as jgeoregrid
import auromat_tpu.ops.regrid_pallas as jregrid_pallas
from auromat_tpu import utils as jutils
from auromat_tpu.io import fits as jfits
from auromat_tpu.mapping.astrometry import create_mapping as jcreate_mapping
from auromat_tpu.mapping.mapping import Mapping as JMapping
from auromat_tpu.ops.georef import georeference as jgeoreference
from auromat_tpu.resample import resample as jresample
from auromat_tpu_torch import utils as tutils
from auromat_tpu_torch.io import fits as tfits
from auromat_tpu_torch.mapping.astrometry import create_mapping
from auromat_tpu_torch.mapping.mapping import Mapping
from auromat_tpu_torch.mapping.spacecraft import get_mapping
from auromat_tpu_torch.ops.georef import GeorefParams, georeference
from auromat_tpu_torch.resample import resample
from test_georegrid import small_params
from test_resample_parity import _gate_binning, _gate_grids

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "tests", "resources")
FULL = "ISS030-E-102170_dc"


@pytest.fixture(scope="module")
def full_pair():
    """The port's full-size CPU run of the slice, and its golden."""
    golden = np.load(os.path.join(RES, f"golden_resample_{FULL}.npz"))
    m = get_mapping(os.path.join(RES, f"{FULL}.jpg"),
                    os.path.join(RES, f"{FULL}.wcs"),
                    altitude=float(golden["altitude"]), device="cpu")
    return golden, m, resample(m, px_per_deg=float(golden["px_per_deg"]),
                               device="cpu")


# -- 1. outline ---------------------------------------------------------------

def synthetic_mask(kind):
    yy, xx = np.mgrid[:40, :56]
    if kind == "concave":  # a C shape
        m = (np.hypot(yy - 20, xx - 28) < 17) & ~((abs(yy - 20) < 5) & (xx > 26))
    elif kind == "border":  # touches every image edge
        m = (yy + xx > 10) & (xx - yy < 40)
        m[:, -1] = True
    elif kind == "two_components":  # the larger one wins
        m = (np.hypot(yy - 10, xx - 10) < 7) | (np.hypot(yy - 28, xx - 40) < 10)
    else:  # equal areas: the tie goes to the component OpenCV lists first
        m = np.zeros((40, 56), bool)
        m[3:10, 4:12] = m[20:27, 30:38] = True
    return m


@pytest.mark.parametrize("kind", ["concave", "border", "two_components",
                                  "tie"])
def test_outline_equals_opencv_synthetic(kind):
    m = synthetic_mask(kind)
    got, want = tutils.outline(m), jutils.outline(m)
    assert got.dtype == np.int32 and len(got) > 20
    assert np.array_equal(got, want)


def test_outline_equals_opencv_random_masks():
    """Random blobs, speckle and holes: every shape class the border
    follower's start and hole tests can meet."""
    from scipy import ndimage

    rng = np.random.default_rng(0)
    for i in range(200):
        h, w = rng.integers(2, 40, 2)
        m = rng.random((h, w)) < rng.random()
        if i % 2:
            m = ndimage.binary_dilation(m & (rng.random((h, w)) < 0.1),
                                        iterations=int(rng.integers(1, 4)))
        if not m.any():
            continue
        assert np.array_equal(tutils.outline(m), jutils.outline(m)), i


def test_outline_equals_opencv_full_frames(full_pair):
    _, m, _ = full_pair
    got = tutils.outline(~m.corner_mask)
    assert np.array_equal(got, jutils.outline(~m.corner_mask))
    assert len(got) > 10000
    # the other resource frame, georeferenced by the port
    from auromat_tpu_torch.coordinates.wcs import TanWcs
    from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position

    h = tfits.read_header(os.path.join(RES, "ISS029-E-8492.wcs"))
    pos, t, _ = resolve_camera_position(h)
    p = GeorefParams.from_wcs(TanWcs(h), pos, t)
    lats = georeference(p, fast_center=True, with_mlatmlt=False,
                        device="cpu")["lats"].numpy()
    defined = ~np.isnan(lats)
    assert defined.any() and not defined.all()
    assert np.array_equal(tutils.outline(defined), jutils.outline(defined))


def test_outline_refuses_empty_image():
    with pytest.raises(ValueError):
        tutils.outline(np.zeros((5, 5), bool))


# -- 2. georeference / create_mapping on the scaled frame --------------------

def scaled_headers(w=128, h=96):
    """ISS030-E-102170's header scaled to (h, w) pixels, as the JAX and the
    port's header objects (the calibration of test_georegrid.small_params)."""
    out = []
    for fits in (jfits, tfits):
        hd = fits.read_header(os.path.join(RES, f"{FULL}.wcs"))
        scale = hd["IMAGEW"] / w
        for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
            hd[k] = hd[k] * scale
        hd["CRPIX1"] = hd["CRPIX1"] / scale
        hd["CRPIX2"] = hd["CRPIX2"] / scale
        hd["IMAGEW"], hd["IMAGEH"] = w, h
        out.append(hd)
    return out


def box(bb):
    return bb.latSouth, bb.lonWest, bb.latNorth, bb.lonEast


def assert_close_masked(a, b, tol=1e-9):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    assert ok.any()
    assert np.abs(a[ok] - b[ok]).max() <= tol


@pytest.mark.parametrize("fast_center", [False, True])
def test_georeference_matches_jax(fast_center):
    jp, _ = small_params()
    tp = GeorefParams(**dataclasses.asdict(jp))
    want = jgeoreference(jp, fast_center, True, jnp.float64)
    got = georeference(tp, fast_center, True, torch.float64, "cpu")
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float64
        assert_close_masked(got[k].numpy(), want[k])
    df = georeference(tp, fast_center, True, "df64", "cpu")
    assert all(np.array_equal(df[k].numpy(), got[k].numpy(), equal_nan=True)
               for k in got)


@pytest.fixture(scope="module")
def small_mappings():
    jh, th = scaled_headers()
    pos = np.array(tfits.get_shifted_spacecraft_position(th)[:3])
    t = tfits.get_shifted_photo_time(th)
    img = np.random.default_rng(3).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    out = {}
    for fc in (False, True):
        out[fc] = (jcreate_mapping(jh, img, pos, t, identifier="small",
                                   fast_center=fc),
                   create_mapping(th, img, pos, t, identifier="small",
                                  fast_center=fc, device="cpu"))
    return out


@pytest.mark.parametrize("fast_center", [False, True])
def test_create_mapping_matches_jax(small_mappings, fast_center):
    jm, m = small_mappings[fast_center]
    assert np.array_equal(m.corner_mask, jm.corner_mask)
    assert np.array_equal(m.center_mask, jm.center_mask)
    assert 0.3 < m.center_mask.mean() < 0.7
    for name in ("lats", "lons", "latsCenter", "lonsCenter", "elevation"):
        assert_close_masked(getattr(m, name).filled(np.nan),
                            getattr(jm, name).filled(np.nan))
    for name in ("mLatMlt", "mLatMltCenter"):
        for a, b in zip(getattr(m, name), getattr(jm, name)):
            assert_close_masked(a.filled(np.nan), b.filled(np.nan))
    assert np.array_equal(np.ma.getmaskarray(m.img), np.ma.getmaskarray(jm.img))
    assert_close_masked(m.outline, jm.outline)
    assert np.allclose(box(m.boundingBox), box(jm.boundingBox), rtol=0,
                       atol=1e-9)
    assert not m.containsPole and not m.containsDiscontinuity


# -- 3. resample of the scaled mapping ---------------------------------------

@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX package's resample reaches its Pallas kernels without
    ``interpret``; on the CPU they run as its own tests run them."""
    monkeypatch.setattr(jregrid_pallas, "bin_mean_pallas_taint", functools.partial(
        jregrid_pallas.bin_mean_pallas_taint, interpret=True))
    monkeypatch.setattr(jgeoregrid, "bin_mean_rgbelev", functools.partial(
        jgeoregrid.bin_mean_rgbelev, interpret=True))


@pytest.mark.parametrize("bin_method", ["sorted", "pallas_taint",
                                        "pallas_rgbelev"])
def test_resample_matches_jax(small_mappings, jax_pallas_interpret, bin_method):
    jm, m = small_mappings[False]
    want = jresample(jm, px_per_deg=3, bin_method=bin_method)
    got = resample(m, px_per_deg=3, bin_method=bin_method, device="cpu")
    assert isinstance(got, Mapping)
    for name in ("lats", "lons", "latsCenter", "lonsCenter"):
        assert_close_masked(getattr(got, name).data, getattr(want, name).data)
    mask = np.ma.getmaskarray(got.img)
    assert np.array_equal(mask, np.ma.getmaskarray(want.img))
    assert 0.2 < mask.mean() < 0.8
    ok = ~mask
    diff = np.abs(got.img.data.astype(int) - want.img.data.astype(int))[ok]
    assert (diff > 1).sum() == 0 and (diff == 1).mean() < 1e-3
    # the two mappings' elevations agree to ~1e-12 deg; the K1/K2 routes
    # sum and divide in float32
    tol = 1e-9 if bin_method == "sorted" else 1e-4
    assert_close_masked(got.elevation.filled(np.nan),
                        want.elevation.filled(np.nan), tol)


def test_resample_collection_and_refusals(small_mappings):
    from auromat_tpu_torch.mapping.mapping import MappingCollection

    _, m = small_mappings[True]
    col = resample(MappingCollection([m, m], "pair"), px_per_deg=3,
                   device="cpu")
    one = resample(m, px_per_deg=3, device="cpu")
    assert len(col) == 2 and col.identifier == "pair"
    assert np.array_equal(col.mappings[1].img, one.img)
    with pytest.raises(NotImplementedError, match="spline"):
        resample(m, method="spline", device="cpu")
    # the interpolation methods (tests/test_torch_interp.py) share the grid
    near = resample(m, px_per_deg=3, method="nearest", device="cpu")
    assert np.array_equal(near.lats.data, one.lats.data)
    with pytest.raises(KeyError):
        resample(m, bin_method="pallas", device="cpu")
    with pytest.raises(ValueError):
        resample(m.img, device="cpu")


@pytest.mark.parametrize("shift", [False, True])
def test_grid_mapping_matches_jax(shift):
    from auromat_tpu.ops.regrid import fixed_grid as jfixed_grid
    from auromat_tpu.resample import grid_mapping as jgrid_mapping
    from auromat_tpu_torch.ops.regrid import fixed_grid
    from auromat_tpu_torch.resample import grid_mapping

    args = (4, 55.0, 60.0, -20.0, -10.0)
    g, jg = fixed_grid(*args), jfixed_grid(*args)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (g.n_lat, g.n_lon, 3), dtype=np.uint8)
    elev = rng.uniform(0, 90, (g.n_lat, g.n_lon))
    elev[2, 3] = np.nan
    t = datetime(2012, 1, 25, 9, 27, 57)
    m = grid_mapping(g, img, elev, 110.0, t, "grid", shift=shift)
    jm = jgrid_mapping(jg, img, elev, 110.0, t, "grid", shift=shift)
    for name in ("lats", "lons", "latsCenter", "lonsCenter", "elevation"):
        assert np.array_equal(getattr(m, name).filled(np.nan),
                              getattr(jm, name).filled(np.nan), equal_nan=True)
    assert np.array_equal(np.ma.getmaskarray(m.img), np.ma.getmaskarray(jm.img))
    assert np.isnan(m.cameraPosGCRS).all()


# -- 4. synthetic pole / discontinuity goldens -------------------------------

@pytest.mark.parametrize("name", ["polar", "discont", "polar_masked"])
def test_synthetic_paths_match_golden(name):
    golden = np.load(os.path.join(RES, f"golden_resample_{name}.npz"))
    m = Mapping(golden["in_lats"], golden["in_lons"],
                golden["in_lats_center"], golden["in_lons_center"],
                golden["in_elevation"], 110.0, golden["in_img"],
                [0.0, 0.0, 6871.0], datetime(2012, 1, 25, 9, 27, 57),
                f"synthetic_{name}")
    jm = JMapping(golden["in_lats"], golden["in_lons"],
                  golden["in_lats_center"], golden["in_lons_center"],
                  golden["in_elevation"], 110.0, golden["in_img"],
                  [0.0, 0.0, 6871.0], datetime(2012, 1, 25, 9, 27, 57),
                  f"synthetic_{name}")
    assert np.array_equal(m.outline, jm.outline)
    assert box(m.boundingBox) == box(jm.boundingBox)
    r = resample(m, px_per_deg=float(golden["px_per_deg"]),
                 contains_pole=bool(golden["contains_pole"]), device="cpu")
    _gate_grids(r, golden, tol=1e-8)
    _gate_binning(r, golden)
    elev = np.asarray(r.elevation.filled(np.nan))
    both = ~np.isnan(elev) & ~np.isnan(golden["elevation"])
    assert both.any()
    assert np.abs(elev[both] - golden["elevation"][both]).max() < 1e-4


# -- 5. the full-size frame against the executed-reference golden ------------

def test_full_frame_grid_alignment(full_pair):
    golden, _, r = full_pair
    lats = np.asarray(r.lats.filled(np.nan))
    assert lats.shape == golden["lats"].shape == (337, 496)
    for ours, ref in [(lats, golden["lats"]),
                      (np.asarray(r.lons.filled(np.nan)), golden["lons"]),
                      (np.asarray(r.latsCenter.filled(np.nan)),
                       golden["lats_center"]),
                      (np.asarray(r.lonsCenter.filled(np.nan)),
                       golden["lons_center"])]:
        both = ~np.isnan(ours) & ~np.isnan(ref)
        assert both.any()
        assert np.abs(ours[both] - ref[both]).max() < 1e-9


def test_full_frame_image_binning(full_pair):
    golden, _, r = full_pair
    assert r.img.dtype == golden["img"].dtype == np.uint8
    _gate_binning(r, golden)


def test_full_frame_elevation_binning(full_pair):
    golden, _, r = full_pair
    elev = np.asarray(r.elevation.filled(np.nan))
    ref = golden["elevation"]
    assert abs(int(np.isnan(elev).sum()) - int(np.isnan(ref).sum())) <= 4
    both = ~np.isnan(elev) & ~np.isnan(ref)
    assert both.any()
    assert np.abs(elev[both] - ref[both]).max() < 1e-4


def test_full_frame_polygons_match_golden(full_pair):
    """The drawing layer's quad decomposition of the full-size composite
    against the executed reference (golden_polygons_*.npz, the gate of
    tests/test_resample_parity.py::test_polygon_decomposition_parity): the
    same quads in the same order, vertices within 1e-9 deg, colours
    exact."""
    from auromat_tpu_torch.draw_helpers import (
        polygons_from_mapping_or_collection)

    _, _, r = full_pair
    golden = np.load(os.path.join(RES, f"golden_polygons_{FULL}.npz"))
    assert float(golden["altitude"]) == 110.0 and golden["px_per_deg"] == 25
    verts, colors = polygons_from_mapping_or_collection(r)
    ref_verts = golden["verts"][:, :, ::-1]  # (lat,lon) -> (lon,lat)
    assert verts.shape == ref_verts.shape
    assert np.abs(verts - ref_verts).max() < 1e-9
    assert np.abs(colors[:, :3]
                  - golden["colors"].astype(np.float64) / 255.0).max() == 0.0


# -- devices and imports -----------------------------------------------------

def test_cuda_request_without_cuda_raises(small_mappings, monkeypatch):
    _, m = small_mappings[True]
    _, th = scaled_headers()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resample(m, px_per_deg=3, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        create_mapping(th, m.img_unmasked, m.cameraPosGCRS, m.photoTime,
                       device="cuda")


def test_slice_never_imports_jax():
    code = ("import sys\n"
            "import auromat_tpu_torch.resample, auromat_tpu_torch.mapping.spacecraft\n"
            "import auromat_tpu_torch.ops.regrid_pallas, auromat_tpu_torch.utils\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'auromat_tpu', 'cv2'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
