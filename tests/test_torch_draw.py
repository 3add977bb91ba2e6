"""The port's drawing layer (``auromat_tpu_torch.{draw,draw_helpers,debug,
coastlines}``, ``geodesic.course``/``destination``/``line``,
``ops.georef.georef_dirs_dyn``) against the JAX package on the CPU.

The fixtures are tests/test_draw.py's: ``get_mapping`` of
ISS030-E-102170_dc (``fast_center=True``) masked at 10 deg of elevation,
and its ``resample(arcsec_per_px=300)``, built once per module in each
package (the port's on ``device="cpu"``).

* Every ``draw_*`` case of tests/test_draw.py, one parametrised test
  (``test_figure_matches_jax``): the same call in both packages, then the
  artists walked side by side: collection paths, offsets and sizes, line
  data, image arrays, patch geometry and axis limits within 1e-9
  (absolute or relative, whichever is larger); face and edge colours,
  tick labels, axis labels, titles, texts and legends equal; and the
  rendered figures (``draw_helpers.figure_image``) differing in at most
  0.1% of their pixels.
* The KML overlay, on the plate-carree resampled mapping (no resampling)
  and on the 12 MP mapping (``resample('mean')`` at 100 arcsec on the
  CPU): the KML text equal to JAX's and the PNG's RGBA array equal; the
  numeric helpers of the device-reaching figures (``_kml_overlay``,
  ``_horizon_grid``, ``_ra_dec_grid``, ``_constellation_segments``)
  equal to the numbers JAX's functions feed into matplotlib.
* ``draw_helpers`` on its own, ``coastlines`` (arrays equal, the port's
  resources byte-equal to the JAX package's), ``geodesic.course``,
  ``destination`` and ``line`` (1e-9 deg, 1e-6 m, the antipodal
  ValueError), ``georef_dirs_dyn`` (1e-12), and ``debug``.

The port's polygons against golden_polygons_ISS030-E-102170_dc.npz are
gated in tests/test_torch_resample.py (its full-size fixture is the
golden's configuration).
"""

import datetime
import filecmp
import os
import shutil
from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg", force=True)

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import auromat_tpu.coastlines as jcoastlines  # noqa: E402
import auromat_tpu.coordinates.geodesic as jgeodesic  # noqa: E402
import auromat_tpu.coordinates.wcs as jwcs  # noqa: E402
import auromat_tpu.debug as jdebug  # noqa: E402
import auromat_tpu.draw as jdraw  # noqa: E402
import auromat_tpu.draw_helpers as jhelpers  # noqa: E402
import auromat_tpu.io.fits as jfits  # noqa: E402
import auromat_tpu.mapping.mapping as jmm  # noqa: E402
from auromat_tpu.mapping.spacecraft import get_mapping as jget_mapping  # noqa: E402
from auromat_tpu.ops import georef as jgeoref  # noqa: E402
from auromat_tpu.resample import resample as jresample  # noqa: E402
import auromat_tpu_torch.coastlines as tcoastlines  # noqa: E402
import auromat_tpu_torch.coordinates.geodesic as tgeodesic  # noqa: E402
import auromat_tpu_torch.coordinates.wcs as twcs  # noqa: E402
import auromat_tpu_torch.debug as tdebug  # noqa: E402
import auromat_tpu_torch.draw as tdraw  # noqa: E402
import auromat_tpu_torch.draw_helpers as thelpers  # noqa: E402
import auromat_tpu_torch.io.fits as tfits  # noqa: E402
import auromat_tpu_torch.mapping.mapping as tmm  # noqa: E402
from auromat_tpu_torch.mapping.spacecraft import get_mapping  # noqa: E402
from auromat_tpu_torch.ops import georef as tgeoref  # noqa: E402
from auromat_tpu_torch.resample import resample  # noqa: E402

RES = os.path.join(os.path.dirname(__file__), "resources")
IMG = os.path.join(RES, "ISS030-E-102170_dc.jpg")
WCS = os.path.join(RES, "ISS030-E-102170_dc.wcs")
TOL = 1e-9


# -- the two packages side by side --------------------------------------------

@pytest.fixture(scope="module")
def sides():
    """(jax, port) namespaces: each package's modules and its mapping and
    resampled mapping; ``dev`` is the port's ``device`` keyword."""
    jm = jget_mapping(IMG, WCS, fast_center=True).maskedByElevation(10)
    tm = get_mapping(IMG, WCS, fast_center=True,
                     device="cpu").maskedByElevation(10)
    return (
        SimpleNamespace(draw=jdraw, helpers=jhelpers, fits=jfits, mm=jmm,
                        geodesic=jgeodesic, wcs=jwcs, mapping=jm,
                        resampled=jresample(jm, arcsec_per_px=300,
                                            method="mean"), dev={}),
        SimpleNamespace(draw=tdraw, helpers=thelpers, fits=tfits, mm=tmm,
                        geodesic=tgeodesic, wcs=twcs, mapping=tm,
                        resampled=resample(tm, arcsec_per_px=300,
                                           method="mean", device="cpu"),
                        dev={"device": "cpu"}, jax_mapping=jm),
    )


def close(got, want, what):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert np.array_equal(np.isnan(got), np.isnan(want)), f"{what}: NaNs"
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok])
    assert (err <= TOL * np.maximum(1.0, np.abs(want[ok]))).all(), \
        f"{what}: max |d| {err.max()}"


def equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    nan = got.dtype.kind == "f" and want.dtype.kind == "f"
    assert np.array_equal(got, want, equal_nan=nan), what


def texts(objs):
    return [t.get_text() for t in objs]


def assert_artists_match(got, want, what):
    """One artist against its JAX twin, by kind."""
    assert type(got) is type(want), what
    if isinstance(got, matplotlib.collections.Collection):
        gp, wp = got.get_paths(), want.get_paths()
        assert len(gp) == len(wp), f"{what}: {len(gp)} != {len(wp)} paths"
        if gp:
            close(np.concatenate([p.vertices for p in gp]),
                  np.concatenate([p.vertices for p in wp]), f"{what} paths")
            assert [None if p.codes is None else p.codes.tolist()
                    for p in gp] == [None if p.codes is None
                                     else p.codes.tolist() for p in wp], \
                f"{what} path codes"
        close(got.get_offsets(), want.get_offsets(), f"{what} offsets")
        if hasattr(got, "get_sizes"):  # not on LineCollections
            close(got.get_sizes(), want.get_sizes(), f"{what} sizes")
        equal(got.get_facecolor(), want.get_facecolor(), f"{what} faces")
        equal(got.get_edgecolor(), want.get_edgecolor(), f"{what} edges")
        assert got.get_gid() == want.get_gid(), what
    elif isinstance(got, matplotlib.lines.Line2D):
        close(got.get_xydata(), want.get_xydata(), f"{what} data")
        assert got.get_color() == want.get_color(), what
        assert got.get_linewidth() == want.get_linewidth(), what
        assert got.get_marker() == want.get_marker(), what
    elif isinstance(got, matplotlib.image.AxesImage):
        g, w = got.get_array(), want.get_array()
        equal(np.ma.getmaskarray(g), np.ma.getmaskarray(w), f"{what} mask")
        close(np.ma.filled(g.astype(np.float64), np.nan),
              np.ma.filled(w.astype(np.float64), np.nan), f"{what} array")
        close(got.get_extent(), want.get_extent(), f"{what} extent")
    elif isinstance(got, matplotlib.patches.Patch):
        close(got.get_path().vertices, want.get_path().vertices,
              f"{what} path")
        close(got.get_patch_transform().get_matrix(),
              want.get_patch_transform().get_matrix(), f"{what} transform")
        equal(got.get_facecolor(), want.get_facecolor(), f"{what} face")
        equal(got.get_edgecolor(), want.get_edgecolor(), f"{what} edge")
        assert got.get_zorder() == want.get_zorder(), what
    elif isinstance(got, matplotlib.text.Text):
        assert got.get_text() == want.get_text(), what
        close(got.get_position(), want.get_position(), f"{what} position")
        assert got.get_color() == want.get_color(), what


def assert_figures_match(got, want):
    """A port figure against its JAX twin (see the module docstring)."""
    img_g, img_w = thelpers.figure_image(got), jhelpers.figure_image(want)
    assert img_g.shape == img_w.shape
    frac = float((img_g != img_w).any(axis=-1).mean())
    assert frac <= 1e-3, f"{frac:.2e} of the pixels differ"
    assert texts(got.texts) == texts(want.texts)
    assert len(got.axes) == len(want.axes)
    for i, (a, b) in enumerate(zip(got.axes, want.axes)):
        close(a.get_xlim(), b.get_xlim(), f"axes {i} xlim")
        close(a.get_ylim(), b.get_ylim(), f"axes {i} ylim")
        for get in ("get_xticklabels", "get_yticklabels"):
            assert texts(getattr(a, get)()) == texts(getattr(b, get)()), get
        close(a.get_xticks(), b.get_xticks(), f"axes {i} xticks")
        close(a.get_yticks(), b.get_yticks(), f"axes {i} yticks")
        assert (a.get_xlabel(), a.get_ylabel(), a.get_title()) == \
            (b.get_xlabel(), b.get_ylabel(), b.get_title())
        equal(a.get_facecolor(), b.get_facecolor(), f"axes {i} face")
        la, lb = a.get_legend(), b.get_legend()
        assert (la is None) == (lb is None)
        if la is not None:
            assert texts(la.get_texts()) == texts(lb.get_texts())
        ca, cb = a.get_children(), b.get_children()
        assert [type(c).__name__ for c in ca] == \
            [type(c).__name__ for c in cb], f"axes {i} children"
        for j, (x, y) in enumerate(zip(ca, cb)):
            assert_artists_match(x, y, f"axes {i} child {j} "
                                       f"({type(x).__name__})")


def figures(result):
    """The figures of a draw_* result: a Figure, (fig, ax) or a dict."""
    if isinstance(result, dict):
        return [result[k] for k in sorted(result)]
    if isinstance(result, tuple):
        return [result[0]]
    return [result]


# -- the cases of tests/test_draw.py ------------------------------------------

def _wide_box(s):
    bb = s.resampled.boundingBox
    return s.mm.BoundingBox(latSouth=bb.latSouth - 10, lonWest=bb.lonWest - 10,
                            latNorth=bb.latNorth + 10,
                            lonEast=bb.lonEast + 10)


def _fake_props(s, n=5):
    t0 = datetime.datetime(2012, 1, 25, 9, 27, 0)
    props = []
    for i in range(n):
        lat, lon = 50.0 + 0.5 * i, -100.0 + 0.8 * i
        bb = s.mm.BoundingBox(latSouth=lat - 2, lonWest=lon - 3,
                              latNorth=lat + 2, lonEast=lon + 3)
        props.append(s.mm.MappingProperties(
            altitude=110.0, cameraPosGCRS=np.zeros(3), boundingBox=bb,
            photoTime=t0 + datetime.timedelta(seconds=6 * i),
            centroid=s.geodesic.Location(lat, lon),
            cameraFootpoint=s.geodesic.Location(lat - 3.0, lon - 1.0),
            identifier=f"f{i}"))
    return props


def _sent(co, items):
    for m in items:
        co.send(m)
    co.close()


def _keogram(s, mlatmlt=False):
    out = {}
    _sent(s.draw.draw_scanlines_co(out, mlatmlt=mlatmlt), [s.resampled] * 5)
    assert len(out["times"]) == 5
    return out["figure"]


def _azimuth(s):
    out = {}
    _sent(s.draw.draw_azimuth_plots_co(out), _fake_props(s, 6))
    assert set(out) == {"az_centroid", "az_centroid_from_cam",
                        "latlon_centroid", "latlon_centroid_from_az",
                        "latlon_cam_foot"}
    return out


def _grid_twin(s):
    """For the port, a port Mapping holding the JAX mapping's grids: the
    packages' 12 MP grids differ by up to ~4.4e-10 deg, and contour
    crossings of nearly flat lat/lon cells magnify that to ~6e-7 px, so the
    contour figure is held at 1e-9 on identical grids (the grids themselves
    are held in ``test_mapping_grids_match_jax``)."""
    if s.draw is jdraw:
        return s.mapping
    j = s.jax_mapping
    return tmm.Mapping(*(getattr(j, k).filled(np.nan) for k in (
        "lats", "lons", "latsCenter", "lonsCenter", "elevation")),
        j.altitude, j.img.data, j.cameraPosGCRS, j.photoTime, j.identifier)


def _small(s, n=8):
    """The central n x n cells of the resampled mapping, as a mapping."""
    r = s.resampled
    h, w = r.img.shape[:2]
    y, x = (h - n) // 2, (w - n) // 2
    c, k = np.s_[y:y + n + 1, x:x + n + 1], np.s_[y:y + n, x:x + n]
    lats, lons, lats_c, lons_c, elev = (getattr(r, a).filled(np.nan) for a in (
        "lats", "lons", "latsCenter", "lonsCenter", "elevation"))
    return s.mm.Mapping(lats[c], lons[c], lats_c[k], lons_c[k], elev[k],
                        r.altitude, r.img.data[k], r.cameraPosGCRS,
                        r.photoTime, r.identifier)


def _scanlines_map(s, mlatmlt):
    """Two sends of a small resampled mapping (SM-converted for
    ``mlatmlt``) with props moved along a track, as tests/test_draw.py does
    with four sends of the whole one (the strip polygons' bounding boxes
    take time quadratic in their perimeter, in both packages)."""
    m = _small(s)
    m = s.mm.convert_mapping_to_sm(m) if mlatmlt else m
    base, c = m.properties, m.properties.centroid
    sends = [{"props": base._replace(
        photoTime=base.photoTime + datetime.timedelta(seconds=6 * i),
        centroid=type(c)(c.lat + 0.3 * i, c.lon + 0.5 * i),
        cameraFootpoint=type(c)(c.lat - 3 + 0.3 * i, c.lon - 1 + 0.5 * i)),
        "mapping": m} for i in range(2)]
    out = {}
    _sent(s.draw.draw_scanlines_map_co(out, mlatmlt=mlatmlt), sends)
    assert len(out["times"]) == 2
    return out["figure"]


def _synthetic_constellation(s):
    """tests/test_draw.py's case: one "constellation" around the frame's
    pointing centre (its RA/Dec from the JAX package, the same input for
    both)."""
    wcs = s.wcs.TanWcs(s.fits.read_header(WCS))
    ra0, dec0 = (float(np.asarray(v)) for v in jwcs.tan_pix2world(
        jwcs.TanWcs(jfits.read_header(WCS)), np.array(2128.0),
        np.array(1416.0)))
    data = {"Test": [((ra0 - 2, dec0 - 2), (ra0 + 2, dec0 + 2)),
                     ((ra0 + 2, dec0 + 2), (ra0 + 2, dec0 - 2))]}
    return s.draw.draw_constellations(wcs, data, **s.dev)


def _corr_seq(s, tmp):
    rng = np.random.default_rng(2)
    paths = []
    for i in range(4):
        fx, fy = rng.uniform(0, 4000, 12), rng.uniform(0, 2800, 12)
        p = str(tmp / f"{i}.corr")
        s.fits.write_bintable(p, {"field_x": fx, "field_y": fy,
                                  "index_x": fx + rng.normal(0, 0.5, 12),
                                  "index_y": fy + rng.normal(0, 0.5, 12)})
        paths.append(p)
    return s.draw.draw_corr_seq_plot(paths)


def _rotation_wrap(s):
    def header(angle_deg, scale=0.01):
        a = np.deg2rad(angle_deg)
        h = s.fits.FitsHeader()
        h["CD1_1"], h["CD2_1"] = scale * np.cos(a), scale * np.sin(a)
        h["CD1_2"], h["CD2_2"] = -scale * np.sin(a), scale * np.cos(a)
        h["DATE-OBS"] = "2012-01-25T09:27:00"
        return h

    fig, ax = s.draw.draw_astrometry_rotation_angles(
        [header(178.0), header(179.5), header(-179.0)], x=[0, 1, 2])
    ys = ax.lines[0].get_ydata()
    assert np.max(ys) - np.min(ys) < 10
    return fig


def _headers(s):
    return [s.fits.read_header(WCS)] * 4


SEQ_X = [datetime.datetime(2012, 1, 25) + datetime.timedelta(seconds=6 * i)
         for i in range(4)]


def _set_colors(s):
    fig = s.draw.draw_plot(s.resampled)
    s.draw.set_colors(fig, bgcolor="black")
    s.draw.set_colors((fig, fig.axes[0]), bgcolor="white", transparent=True)
    return fig


def _dated(s):
    fig = s.draw.draw_plot(s.resampled)
    s.draw.draw_date((fig, fig.axes[0]), s.resampled, color="black")
    return fig


def _catalog_stars(s):
    header = s.fits.read_header(WCS)
    x, y = s.fits.get_catalog_stars(header, **s.dev)
    return s.draw.draw_reference_stars(
        np.zeros((int(header["IMAGEH"]) // 8, int(header["IMAGEW"]) // 8)),
        [(x / 8, y / 8)])


def _lsmask_axes(s):
    fig, ax = plt.subplots()
    s.draw._draw_lsmask(ax, 60.0, -100.0, min_cos=0.05)
    return fig


def _rng_image_stars():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (100, 150), dtype=np.uint8)
    return img, [(rng.uniform(0, 150, 20), rng.uniform(0, 100, 20)),
                 (rng.uniform(0, 150, 10), rng.uniform(0, 100, 10))]


def _corr():
    rng = np.random.default_rng(1)
    fx, fy = rng.uniform(1, 150, 15), rng.uniform(1, 100, 15)
    return fx, fy, fx + rng.normal(0, 1, 15), fy + rng.normal(0, 1, 15)


def _heat_points():
    rng = np.random.default_rng(2)
    lats, lons = rng.uniform(50, 60, 5000), rng.uniform(-110, -90, 5000)
    lats[::7] = np.nan
    return lats, lons


CASES = {
    "draw_plot": lambda s, tmp: s.draw.draw_plot(s.resampled),
    "draw_stereographic": lambda s, tmp: s.draw.draw_stereographic(
        s.resampled),
    "draw_stereographic bounding_box": lambda s, tmp:
        s.draw.draw_stereographic(s.resampled, bounding_box=_wide_box(s)),
    "draw_stereographic collection": lambda s, tmp:
        s.draw.draw_stereographic(s.mm.MappingCollection(
            [s.resampled], "t", mayOverlap=True), bounding_box=_wide_box(s)),
    "draw_stereographic coastlines=None": lambda s, tmp:
        s.draw.draw_stereographic(s.resampled, coastlines=None),
    "draw_stereographic cities": lambda s, tmp: s.draw.draw_stereographic(
        s.resampled, cities=True),
    "draw_stereographic lsmask": lambda s, tmp: s.draw.draw_stereographic(
        s.resampled, lsmask=True),
    "_draw_lsmask": lambda s, tmp: _lsmask_axes(s),
    "draw_stereographic_mlat_mlt": lambda s, tmp:
        s.draw.draw_stereographic_mlat_mlt(s.resampled),
    "draw_mlat_mlt_polar": lambda s, tmp: s.draw.draw_mlat_mlt_polar(
        s.resampled),
    "draw_parallels_meridians": lambda s, tmp:
        s.draw.draw_parallels_meridians(_grid_twin(s)),
    "draw_horizon": lambda s, tmp: s.draw.draw_horizon(s.mapping, **s.dev),
    "draw_ra_dec": lambda s, tmp: s.draw.draw_ra_dec(s.mapping, **s.dev),
    "draw_astrometry_pixel_scales": lambda s, tmp:
        s.draw.draw_astrometry_pixel_scales(s.mapping),
    "draw_histogram": lambda s, tmp: s.draw.draw_histogram(
        np.exp(-((np.arange(256) - 40) / 30.0) ** 2), vlines=[(40, "red")],
        xlabel="Intensity"),
    "draw_scanlines_co": lambda s, tmp: _keogram(s),
    "draw_scanlines_co mlatmlt": lambda s, tmp: _keogram(s, mlatmlt=True),
    "draw_reference_stars": lambda s, tmp: s.draw.draw_reference_stars(
        *_rng_image_stars()),
    "draw_reference_stars catalog": lambda s, tmp: _catalog_stars(s),
    "draw_indx_plot": lambda s, tmp: s.draw.draw_indx_plot(
        np.zeros((100, 120)),
        np.array([[10.0, 10.0], [100.0, 20.0], [90.0, 80.0], [20.0, 70.0]])),
    "draw_corr_plot": lambda s, tmp: s.draw.draw_corr_plot(_corr()),
    "draw_constellations": lambda s, tmp: _synthetic_constellation(s),
    "draw_constellations bundled": lambda s, tmp: s.draw.draw_constellations(
        s.mapping, **s.dev),
    "draw_constellations color dict": lambda s, tmp:
        s.draw.draw_constellations(
            s.mapping, color=s.draw.get_fixed_constellation_colors(),
            **s.dev),
    "draw_constellations color cycle": lambda s, tmp:
        s.draw.draw_constellations(s.mapping, color=["red", "lime"],
                                   image=np.zeros((354, 532)), **s.dev),
    "draw_heatmap": lambda s, tmp: s.draw.draw_heatmap(*_heat_points(),
                                                       bins=30),
    "draw_array_heatmap": lambda s, tmp: s.draw.draw_array_heatmap(
        s.resampled.elevation, cb_label="Elevation", xlabel="x"),
    "draw_distortion_displacement": lambda s, tmp:
        s.draw.draw_distortion_displacement((200, 300), "ptlens",
                                            (0.05, -0.02, 0.01)),
    "draw_line_plot": lambda s, tmp: s.draw.draw_line_plot(
        [datetime.datetime(2012, 1, 25, 9, 27)
         + datetime.timedelta(seconds=6 * i) for i in range(10)],
        np.arange(10.0), "Time", "v"),
    "draw_corr_seq_plot": _corr_seq,
    "draw_astrometry_rotation_angles": lambda s, tmp:
        s.draw.draw_astrometry_rotation_angles(_headers(s), SEQ_X),
    "draw_astrometry_rotation_angles wrap": lambda s, tmp: _rotation_wrap(s),
    "draw_cd11_cd21": lambda s, tmp: s.draw.draw_cd11_cd21(_headers(s)),
    "draw_ra_dec_seq": lambda s, tmp: s.draw.draw_ra_dec_seq(_headers(s)),
    "draw_right_ascension": lambda s, tmp: s.draw.draw_right_ascension(
        _headers(s), SEQ_X),
    "draw_declination": lambda s, tmp: s.draw.draw_declination(_headers(s),
                                                               SEQ_X),
    "draw_camera_footpoints": lambda s, tmp: s.draw.draw_camera_footpoints(
        _fake_props(s)),
    "draw_date": lambda s, tmp: _dated(s),
    "set_colors": lambda s, tmp: _set_colors(s),
    **{f"draw_lens_distortion_derivative {model}": (
        lambda s, tmp, model=model, terms=terms:
        s.draw.draw_lens_distortion_derivative(model, terms,
                                               crop_factor=1.5))
       for model, terms in [("ptlens", (0.01, -0.03, 0.0)),
                            ("poly3", (-0.02,)), ("poly5", (-0.02, 0.004))]},
    "draw_azimuth_plots_co": lambda s, tmp: _azimuth(s),
    "draw_scanlines_map_co": lambda s, tmp: _scanlines_map(s, False),
    "draw_scanlines_map_co mlatmlt": lambda s, tmp: _scanlines_map(s, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_figure_matches_jax(sides, case, tmp_path):
    jside, tside = sides
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = figures(CASES[case](jside, tmp_path / "jax"))
    got = figures(CASES[case](tside, tmp_path / "port"))
    try:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_figures_match(g, w)
    finally:
        plt.close("all")


def test_mapping_grids_match_jax(sides):
    jside, tside = sides
    for which in ("mapping", "resampled"):
        for key in ("lats", "lons", "latsCenter", "lonsCenter", "elevation"):
            a, b = (getattr(getattr(s, which), key).filled(np.nan)
                    for s in (tside, jside))
            equal(np.isnan(a), np.isnan(b), f"{which}.{key} mask")
            assert np.nanmax(np.abs(a - b)) < 1e-9, f"{which}.{key}"


def test_draw_heatmaps_match_jax(sides, tmp_path):
    """The written heatmap PNGs: the same names, <= 0.1% of pixels apart."""
    from PIL import Image

    jside, tside = sides
    written = [s.draw.draw_heatmaps(s.resampled,
                                    path_prefix=str(tmp_path / f"{n}_"))
               for n, s in (("jax", jside), ("port", tside))]
    assert [os.path.basename(p)[4:] for p in written[0]] == \
        [os.path.basename(p)[5:] for p in written[1]]
    assert len(written[1]) == 3
    for j, t in zip(*written):
        a, b = (np.asarray(Image.open(p).convert("RGB")) for p in (j, t))
        assert a.shape == b.shape and (a != b).any(axis=-1).mean() <= 1e-3


# -- the KML overlay and the numbers of the device-reaching figures -----------

@pytest.mark.parametrize("which", ["resampled", "mapping"])
def test_kml_matches_jax(sides, tmp_path, which):
    """On the plate-carree resampled mapping nothing is resampled; on the
    12 MP mapping ``resample('mean')`` runs at 100 arcsec (the port's on the
    CPU, its K1 route's plain twin)."""
    from PIL import Image

    jside, tside = sides
    jk, jp = jdraw.draw_kml_image(str(tmp_path / "j.kml"),
                                  getattr(jside, which))
    tk, tp = tdraw.draw_kml_image(str(tmp_path / "t.kml"),
                                  getattr(tside, which), device="cpu")
    assert (tk, tp) == (str(tmp_path / "t.kml"), str(tmp_path / "t.png"))
    assert open(tk).read() == open(jk).read().replace("j.png", "t.png")
    got, want = (np.asarray(Image.open(p)) for p in (tp, jp))
    assert got.shape[-1] == 4 and np.array_equal(got, want)
    rgba, kml = tdraw._kml_overlay(str(tmp_path / "j.kml"),
                                   getattr(tside, which), device="cpu")
    assert kml == open(jk).read() and np.array_equal(rgba, want)
    if which == "mapping":
        assert rgba.shape[:2] != tside.mapping.img.shape[:2]


def test_horizon_grid_matches_jax(sides):
    jside, tside = sides
    m = jside.mapping
    h, w = m.img.shape[:2]
    params = jgeoref.GeorefParams.from_wcs(
        jdraw._wcs_from_mapping(m, w, h), m.cameraPosGCRS, m.photoTime,
        altitude=0.0)
    stride = max(1, w // 512)
    jpx, jpy = np.meshgrid(np.arange(0, w, stride, dtype=float),
                           np.arange(0, h, stride, dtype=float))
    lat, _ = jgeoref.georeference_points(params, jpx, jpy)
    px, py, hit = tdraw._horizon_grid(tside.mapping, device="cpu")
    assert hit.dtype == bool and 0 < hit.mean() < 1
    equal(px, jpx, "px")
    equal(py, jpy, "py")
    equal(hit, np.isfinite(np.asarray(lat)), "hit")


def test_ra_dec_grid_matches_jax(sides):
    jside, tside = sides
    wcs = jdraw._wcs_from_mapping(jside.mapping, 0, 0)
    px, py = np.meshgrid(np.arange(0, wcs.width, 64, dtype=float),
                         np.arange(0, wcs.height, 64, dtype=float))
    jra, jdec = jwcs.tan_pix2world(wcs, px, py)
    ra, dec = tdraw._ra_dec_grid(tside.mapping, device="cpu")
    assert ra.dtype == np.float64 and ra.shape == px.shape
    close(ra, jra, "ra")
    close(dec, jdec, "dec")


def test_constellation_segments_match_jax(sides):
    """Every end point JAX projects one by one, projected in one call."""
    from auromat_tpu_torch.coordinates.constellations import figure_segments

    jside, tside = sides
    data = figure_segments()
    jw = jdraw._wcs_from_mapping(jside.mapping, 0, 0)
    got = tdraw._constellation_segments(
        tdraw._wcs_from_mapping(tside.mapping, 0, 0), data, device="cpu")
    assert list(got) == list(data)
    n_in = 0
    for name, segments in data.items():
        want = [[float(np.asarray(v)) for v in (
            *jwcs.tan_world2pix(jw, ra1, dec1),
            *jwcs.tan_world2pix(jw, ra2, dec2))]
            for (ra1, dec1), (ra2, dec2) in segments]
        close(got[name], np.reshape(want, (-1, 4)), name)
        n_in += int(((got[name][:, 0] >= 0) & (got[name][:, 0] <= 4256)).sum())
    assert n_in > 0
    assert tdraw._constellation_segments(tdraw._wcs_from_mapping(
        tside.mapping, 0, 0), {}, device="cpu") == {}


def test_fixed_constellation_colors_match_jax():
    assert tdraw.get_fixed_constellation_colors() == \
        jdraw.get_fixed_constellation_colors()
    assert tdraw.get_fixed_constellation_colors(["a", "b"]) == \
        jdraw.get_fixed_constellation_colors(["a", "b"])


def test_wcs_from_mapping_refuses_a_mapping_without_header(sides):
    _, tside = sides
    plain = tside.resampled
    assert getattr(plain, "wcs_header", None) is None
    for fn in (lambda: tdraw.draw_horizon(plain, device="cpu"),
               lambda: tdraw.draw_ra_dec(plain, device="cpu"),
               lambda: tdraw.draw_constellations(plain, device="cpu")):
        with pytest.raises(ValueError, match="no WCS header"):
            fn()


def test_stereographic_project_matches_jax(sides):
    rng = np.random.default_rng(4)
    lats, lons = rng.uniform(-89, 89, 500), rng.uniform(-180, 180, 500)
    lats[0], lons[0] = -60.0, 80.0  # the antipode of the centre
    for a, b in zip(tdraw.stereographic_project(lats, lons, 60.0, -100.0),
                    jdraw.stereographic_project(lats, lons, 60.0, -100.0)):
        equal(a, b, "stereographic_project")


# -- draw_helpers ---------------------------------------------------------------

@pytest.mark.parametrize("mlatmlt", [False, True])
def test_polygons_match_jax(sides, mlatmlt):
    jside, tside = sides
    got = thelpers.polygons_from_mapping_or_collection(tside.resampled,
                                                       mlatmlt=mlatmlt)
    want = jhelpers.polygons_from_mapping_or_collection(jside.resampled,
                                                        mlatmlt=mlatmlt)
    close(got[0], want[0], "verts")
    equal(got[1], want[1], "colors")
    verts, colors, elev = thelpers.create_polygons_and_colors(
        tside.resampled.lats, tside.resampled.lons, tside.resampled.rgb,
        tside.resampled.elevation)
    jverts, jcolors, jelev = jhelpers.create_polygons_and_colors(
        jside.resampled.lats, jside.resampled.lons, jside.resampled.rgb,
        jside.resampled.elevation)
    close(verts, jverts, "verts")
    equal(colors, jcolors, "colors")
    close(elev, jelev, "elevation")
    assert colors.max() <= 1.0 and not np.isnan(verts).any()


def test_collection_overlap_sort_matches_jax(sides):
    """mayOverlap collections sort by elevation (two members, the second
    shifted), and refuse a member without elevation."""
    jside, tside = sides
    colls = []
    for s in (jside, tside):
        r = s.resampled
        other = s.mm.Mapping(r.lats.data + 0.05, r.lons.data,
                             r.latsCenter.data + 0.05, r.lonsCenter.data,
                             r.elevation.data[::-1].copy(), r.altitude,
                             r.img.data, r.cameraPosGCRS, r.photoTime,
                             "other")
        colls.append(s.mm.MappingCollection([r, other], "c", mayOverlap=True))
    got = thelpers.polygons_from_mapping_or_collection(colls[1])
    want = jhelpers.polygons_from_mapping_or_collection(colls[0])
    close(got[0], want[0], "verts")
    equal(got[1], want[1], "colors")
    r = tside.resampled
    bare = tmm.Mapping(r.lats.data, r.lons.data, r.latsCenter.data,
                       r.lonsCenter.data, None, r.altitude, r.img.data,
                       r.cameraPosGCRS, r.photoTime, "bare")
    with pytest.raises(ValueError, match="need elevation"):
        thelpers.polygons_from_mapping_or_collection(
            tmm.MappingCollection([r, bare], "c", mayOverlap=True))


def test_small_helpers_match_jax():
    for v in (13.5, 0.25, 16.995, -0.5, 23.999, 48.25):
        assert thelpers.mlt_formatter(v) == jhelpers.mlt_formatter(v)
    verts = np.random.default_rng(5).random((7, 4, 2))
    equal(thelpers.overlap_polygons(verts, 0.12),
          jhelpers.overlap_polygons(verts, 0.12), "overlap_polygons")
    pts = np.array([[5, 5], [5, 6], [5, 7], [1, 1], [1, 2], [1, 3]])
    for p in (pts, pts[:2], pts[:3]):
        equal(thelpers.ensure_continuous_path(p),
              jhelpers.ensure_continuous_path(p), "ensure_continuous_path")


@pytest.mark.parametrize("source", ["array", "path", "gray"])
def test_load_fig_image_matches_jax(tmp_path, source):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (60, 90, 3), dtype=np.uint8)
    if source == "path":
        from PIL import Image

        Image.fromarray(img).save(tmp_path / "i.png")
        img = str(tmp_path / "i.png")
    elif source == "gray":
        img = img[..., 0]
    try:
        (tf, ta), (jf, ja) = (h.load_fig_image(img, dpi=40)
                              for h in (thelpers, jhelpers))
        close(ta.get_xlim(), ja.get_xlim(), "xlim")
        close(ta.get_ylim(), ja.get_ylim(), "ylim")
        equal(thelpers.figure_image(tf), jhelpers.figure_image(jf), "image")
    finally:
        plt.close("all")


def test_save_fig_writes_and_closes(sides, tmp_path):
    _, tside = sides
    fig = tdraw.draw_plot(tside.resampled)
    out = thelpers.save_fig(str(tmp_path / "p.png"), fig, width_px=400)
    assert out == str(tmp_path / "p.png") and os.path.getsize(out) > 5000
    assert not plt.fignum_exists(fig.number)


# -- coastlines ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["coastlines_coarse.npz", "cities_ne50m.npz",
                                  "constellations.npz"])
def test_resources_byte_equal(name):
    ours = os.path.join(os.path.dirname(tdraw.__file__), "resources", name)
    theirs = os.path.join(os.path.dirname(jdraw.__file__), "resources", name)
    assert filecmp.cmp(ours, theirs, shallow=False)


def test_coastlines_match_jax():
    equal(tcoastlines.coastline_latlon(), jcoastlines.coastline_latlon(),
          "coastline")
    rings, jrings = tcoastlines.land_rings(), jcoastlines.land_rings()
    assert len(rings) == len(jrings) >= 20
    for a, b in zip(rings, jrings):
        equal(a, b, "ring")
    for a, b in zip(tcoastlines.city_points(), jcoastlines.city_points()):
        equal(a, b, "cities")
    lats, lons, _ = tcoastlines.city_points()
    equal(tcoastlines.near_hemisphere(lats, lons, 60.0, -100.0),
          jcoastlines.near_hemisphere(lats, lons, 60.0, -100.0), "near")


# -- geodesic courses, destinations and lines; georef_dirs_dyn -------------------

def test_geodesic_course_destination_line_match_jax():
    rng = np.random.default_rng(7)
    a = (rng.uniform(-80, 80, 200), rng.uniform(-180, 180, 200))
    b = (rng.uniform(-80, 80, 200), rng.uniform(-180, 180, 200))
    a[0][0], a[1][0], b[0][0], b[1][0] = 0.0, 0.0, 0.5, 179.7  # near-antipode
    close(tgeodesic.course(a, b), jgeodesic.course(a, b), "course")
    assert isinstance(tgeodesic.course((50, -100), (51, -99)), float)
    assert abs(tgeodesic.course((50, -100), (51, -99))
               - jgeodesic.course((50, -100), (51, -99))) <= 1e-9
    azi, dist = rng.uniform(-180, 180, 200), rng.uniform(0, 5e6, 200)
    for got, want in zip(tgeodesic.destination(a, azi, dist),
                         jgeodesic.destination(a, azi, dist)):
        close(got, want, "destination")
    got = tgeodesic.destination((50.0, -100.0), 30.0, 250e3)
    want = jgeodesic.destination((50.0, -100.0), 30.0, 250e3)
    assert isinstance(got, tgeodesic.Location)
    assert max(abs(g - w) for g, w in zip(got, want)) <= 1e-9
    for p, q, res in (((50.0, -100.0), (52.0, -96.0), 1000),
                      ((50.0, -100.0), (50.001, -100.0), 1000),
                      ((10.0, 20.0), (-30.0, 150.0), 50e3)):
        got, want = tgeodesic.line(p, q, res), jgeodesic.line(p, q, res)
        close(got, want, "line")
        assert abs(tgeodesic.distance(got[0], got[-1])
                   - jgeodesic.distance(want[0], want[-1])) <= 1e-6


@pytest.mark.parametrize("pkg", [tgeodesic, jgeodesic])
def test_geodesic_line_refuses_an_unsolved_pair(pkg, monkeypatch):
    """A pair the inverse leaves unsolved (NaN, a degenerate antipodal
    pair) raises; no real pair tried reaches it, so the inverse is
    replaced by one returning NaN."""
    real = pkg._inverse
    monkeypatch.setattr(pkg, "_inverse", lambda *a: (
        np.float64(np.nan),) + tuple(real(*a)[1:]))
    with pytest.raises(ValueError, match="antipodal"):
        pkg.line((0.0, 0.0), (0.0, 180.0))


def test_georef_dirs_dyn_matches_jax():
    header = tfits.read_header(WCS)
    pos = np.array(tfits.get_shifted_spacecraft_position(header)[:3])
    t = tfits.get_shifted_photo_time(header)
    jp = jgeoref.GeorefParams.from_wcs(jwcs.TanWcs(jfits.read_header(WCS)),
                                       pos, t)
    jd = jgeoref.DynGeorefParams.from_static(jp)
    tp = tgeoref.DynGeorefParams.from_static(
        tgeoref.GeorefParams.from_wcs(twcs.TanWcs(header), pos, t), "cpu")
    rng = np.random.default_rng(8)
    px, py = rng.uniform(0, 4256, 1000), rng.uniform(0, 2832, 1000)
    got = tgeoref.georef_dirs_dyn(tp, torch.from_numpy(px),
                                  torch.from_numpy(py))
    want = jgeoref.georef_dirs_dyn(jd, px, py)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-12


# -- debug ----------------------------------------------------------------------

def test_debug_checks_match_jax(sides, tmp_path, monkeypatch):
    """check_horizon and check_graticule write their PNGs, within 0.1% of
    the pixels of JAX's. ``get_mapping`` (held against JAX elsewhere) is
    replaced in each package by one that checks its arguments and returns
    the module's mapping of the same frame."""
    from PIL import Image

    import auromat_tpu.mapping.spacecraft as jspacecraft
    import auromat_tpu_torch.mapping.spacecraft as tspacecraft

    calls = []
    for mod, side, dev in ((jspacecraft, sides[0], {}),
                           (tspacecraft, sides[1], {"device": "cpu"})):
        def fake(image_path, wcs_path, altitude, fast_center, _m=side.mapping,
                 _dev=dev, **kw):
            assert (image_path, wcs_path, altitude, fast_center, kw) == \
                (IMG, WCS, 110.0, True, _dev)
            calls.append(image_path)
            return _m

        monkeypatch.setattr(mod, "get_mapping", fake)
    for name in ("check_horizon", "check_graticule"):
        j = getattr(jdebug, name)(IMG, WCS, out_path=str(tmp_path / "j.png"))
        t = getattr(tdebug, name)(IMG, WCS, out_path=str(tmp_path / "t.png"),
                                  device="cpu")
        assert t == str(tmp_path / "t.png") and os.path.getsize(t) > 10000
        a, b = (np.asarray(Image.open(p).convert("RGB")) for p in (j, t))
        assert a.shape == b.shape and (a != b).any(axis=-1).mean() <= 1e-3
    assert len(calls) == 4


def test_debug_batch_mask_matches_jax(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    shutil.copy(IMG, src / "frame.jpg")
    (src / "notes.txt").write_text("skipped")
    got = tdebug.batch_mask(str(src), str(tmp_path / "t"), device="cpu")
    want = jdebug.batch_mask(str(src), str(tmp_path / "j"))
    assert set(got) == set(want) == {"frame.jpg"}
    assert got["frame.jpg"][1] == want["frame.jpg"][1]
    assert filecmp.cmp(got["frame.jpg"][0], want["frame.jpg"][0],
                       shallow=False)
