"""The port's public entry points compute on the card unless asked not to.

Each one, called without ``device`` where torch finds no CUDA device,
raises (``ops.georef.compute_device``); nothing falls back to the CPU.
``DynGeorefParams.from_static`` and ``.stack`` take ``device`` as a
required argument. ``torch.cuda.is_available`` is patched to False so that
the tests mean the same on a machine with a card.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from auromat_tpu_torch.cli import convert
from auromat_tpu_torch.coordinates.wcs import (TanWcs, make_wcs,
                                               pixel_directions, pixel_grid)
from auromat_tpu_torch.entry import entry, frame_setup
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.mapping.astrometry import create_mapping
from auromat_tpu_torch.mapping.spacecraft import (SpacecraftMappingProvider,
                                                  get_mapping,
                                                  get_mapping_batch)
from auromat_tpu_torch.mapping.mapping import (convert_sm_mapping_to_geo,
                                               inflated_earth_intersection)
from auromat_tpu_torch.ops.georef import (DynGeorefParams, GeorefParams,
                                          georeference, georeference_generic,
                                          georeference_points,
                                          georeference_points_df64,
                                          georeference_points_df64_full,
                                          georeference_points_generic)
from auromat_tpu_torch.mapping import miracle, themis
from auromat_tpu_torch.mapping.iss import ISSMappingProvider
from auromat_tpu_torch.util.lensdistortion import (
    correct_lens_distortion, correct_lens_distortion_exif)
from auromat_tpu_torch.parallel import global_mesh, initialize, make_mesh
from auromat_tpu_torch.solving import eol, masking, solving
from auromat_tpu_torch.solving.spacecraft import (intersects_earth,
                                                  is_consistent)
from auromat_tpu_torch.util.histogram import histogram2d, histogramdd
from auromat_tpu_torch.resample import mosaic, resample, resample_mlat_mlt
from auromat_tpu_torch import debug, draw

RES = os.path.join(os.path.dirname(__file__), "resources")
WCS = os.path.join(RES, "ISS030-E-102170_dc.wcs")
SOD = os.path.join(RES, "SOD120304_171900_557_1000.jpg")
RESAMPLE_METHODS = ("nearest", "nearest_host", "nearest_device", "linear",
                    "linear_device", "cubic", "cubic_device")


def small_header(w=128, h=96):
    """The real frame's calibration scaled to (h, w) pixels."""
    header = fits.read_header(WCS)
    scale = header["IMAGEW"] / w
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        header[k] = header[k] * scale
    header["CRPIX1"] /= scale
    header["CRPIX2"] /= scale
    header["IMAGEW"], header["IMAGEH"] = w, h
    return header


@pytest.fixture(scope="module")
def small():
    """(header, image, camera position, photo time, params, CPU mapping)."""
    header = small_header()
    pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
    t = fits.get_shifted_photo_time(header)
    img = np.random.default_rng(0).integers(0, 256, (96, 128, 3), np.uint8)
    params = GeorefParams.from_wcs(TanWcs(header), pos, t)
    m = create_mapping(header, img, pos, t, identifier="small", device="cpu")
    return SimpleNamespace(header=header, img=img, pos=pos, t=t,
                           params=params, mapping=m)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _mosaic_args(tmp):
    return convert.build_parser().parse_args(
        [str(tmp), "--mosaic", "1", "--out", str(tmp)])


def _zea(header):
    """``header`` as a ZEA solution (its TAN constants reinterpreted)."""
    header = dict(header, CTYPE1="RA---ZEA", CTYPE2="DEC--ZEA")
    header.pop("LONPOLE", None), header.pop("LATPOLE", None)
    return header


def _mag_args(tmp):
    return convert.build_parser().parse_args(
        [str(tmp), "--grid", "mag", "--out", str(tmp)])


def _geo_args(tmp):
    return convert.build_parser().parse_args(
        [str(tmp), "--grid", "geo", "--out", str(tmp)])


class _Bursts:
    iterParamBursts = None  # --mosaic's capability probe


ENTRY_POINTS = {
    "resample": lambda s, tmp: resample(s.mapping, px_per_deg=3),
    "create_mapping": lambda s, tmp: create_mapping(s.header, s.img, s.pos,
                                                    s.t),
    "get_mapping": lambda s, tmp: get_mapping(str(tmp / "x.png"), WCS),
    "SpacecraftMappingProvider": lambda s, tmp: SpacecraftMappingProvider(
        str(tmp)),
    "get_mapping_batch": lambda s, tmp: get_mapping_batch(
        [(str(tmp / "x.png"), WCS)]),
    "georeference": lambda s, tmp: georeference(s.params),
    "make_mesh": lambda s, tmp: make_mesh(),
    "global_mesh": lambda s, tmp: global_mesh(),
    "initialize": lambda s, tmp: initialize(),
    "entry": lambda s, tmp: entry(),
    "frame_setup": lambda s, tmp: frame_setup(),
    "convert.make_provider": lambda s, tmp: convert.make_provider(
        "spacecraft", str(tmp), 110.0),
    "convert.convert_mapping": lambda s, tmp: convert.convert_mapping(
        s.mapping, _geo_args(tmp), str(tmp)),
    "convert.convert_mosaic": lambda s, tmp: convert.convert_mosaic(
        _Bursts(), _mosaic_args(tmp), str(tmp)),
    "convert.platform_device": lambda s, tmp: convert.platform_device(
        _geo_args(tmp).platform),
    "mosaic": lambda s, tmp: mosaic([s.mapping]),
    "ThemisMappingProvider": lambda s, tmp: themis.ThemisMappingProvider(
        str(tmp), str(tmp), offline=True),
    "themis.get_mappings": lambda s, tmp: themis.get_mappings(
        s.t, str(tmp), str(tmp), offline=True),
    "themis.mapping_single_asi": lambda s, tmp: themis.mapping_single_asi(
        "gill", s.t, str(tmp), str(tmp), offline=True),
    "themis.reproject_batch": lambda s, tmp: themis.reproject_batch(
        np.zeros((1, 2)), np.zeros((1, 3, 3)), np.zeros((1, 3, 3)), 110.0,
        100.0),
    "themis.reproject": lambda s, tmp: themis.reproject(
        (0.0, 0.0), np.zeros((3, 3)), np.zeros((3, 3)), 110.0, 100.0),
    "MIRACLEMappingProvider": lambda s, tmp: miracle.MIRACLEMappingProvider(
        RES),
    "miracle.get_mapping": lambda s, tmp: miracle.get_mapping(SOD),
    "miracle.create_mapping": lambda s, tmp: miracle.create_mapping(
        np.zeros((64, 64, 3), np.uint8), miracle.get_calibration_data(
            os.path.join(RES, "cal.txt"), "SOD", s.t.replace(year=2012)),
        s.t.replace(year=2012)),
    "convert.make_provider themis": lambda s, tmp: convert.make_provider(
        "themis", str(tmp), 110.0),
    "convert.make_provider miracle": lambda s, tmp: convert.make_provider(
        "miracle", RES, 110.0),
    "convert.main miracle": lambda s, tmp: convert.main(
        [RES, "--out", str(tmp)]),
    "convert.main themis": lambda s, tmp: convert.main(
        [str(tmp), "--grid", "geo", "--out", str(tmp)]),
    "resample_mlat_mlt": lambda s, tmp: resample_mlat_mlt(
        s.mapping, px_per_deg=3, contains_pole=False),
    "convert_sm_mapping_to_geo": lambda s, tmp: convert_sm_mapping_to_geo(
        s.mapping),
    "convert.convert_mapping mag": lambda s, tmp: convert.convert_mapping(
        s.mapping, _mag_args(tmp), str(tmp)),
    "inflated_earth_intersection": lambda s, tmp: inflated_earth_intersection(
        np.array([[0.0, 0.0, -1.0]]), s.pos),
    "create_mapping ZEA": lambda s, tmp: create_mapping(
        _zea(s.header), s.img, s.pos, s.t),
    "georeference_generic": lambda s, tmp: georeference_generic(
        make_wcs(_zea(s.header)), s.params),
    "georeference_points": lambda s, tmp: georeference_points(
        s.params, [1.0], [2.0]),
    "georeference_points_generic": lambda s, tmp: georeference_points_generic(
        make_wcs(_zea(s.header)), s.params, [1.0], [2.0]),
    "georeference_points_df64": lambda s, tmp: georeference_points_df64(
        s.params, [1.0], [2.0]),
    "georeference_points_df64_full": lambda s, tmp:
        georeference_points_df64_full(s.params, [1.0], [2.0],
                                      projection="ZEA"),
    "pixel_grid": lambda s, tmp: pixel_grid(4, 3),
    "ISSMappingProvider": lambda s, tmp: ISSMappingProvider(str(tmp)),
    "convert.make_provider iss": lambda s, tmp: convert.make_provider(
        "iss", str(tmp), 110.0),
    "correct_lens_distortion": lambda s, tmp: correct_lens_distortion(
        s.img, "poly3", (-0.019,)),
    "correct_lens_distortion_exif": lambda s, tmp:
        correct_lens_distortion_exif(s.img, {
            "Model": "NIKON D3S", "LensModel": "24.0 mm f/1.4",
            "FocalLength": 24.0}),
    "pixel_directions": lambda s, tmp: pixel_directions(TanWcs(s.header)),
    "intersects_earth": lambda s, tmp: intersects_earth(s.header),
    "mask_starfield": lambda s, tmp: masking.mask_starfield(s.img),
    "debug.batch_mask": lambda s, tmp: debug.batch_mask(RES, str(tmp / "o")),
    "solve_image": lambda s, tmp: solving.solve_image(
        os.path.join(RES, "ISS030-E-102170_dc.jpg"), str(tmp / "x.wcs"),
        solve_field="sh"),
    "is_consistent": lambda s, tmp: is_consistent(s.header),
    "histogram2d": lambda s, tmp: histogram2d([0.5], [0.5], 2,
                                              weights=[None]),
    "histogramdd": lambda s, tmp: histogramdd(np.zeros((1, 2)), 2,
                                              weights=[None]),
    "eol.correct_lens_distortion": lambda s, tmp: eol.correct_lens_distortion(
        RES, str(tmp / "out")),
    "fits.get_catalog_stars": lambda s, tmp: fits.get_catalog_stars(
        s.header),
    # the device is resolved before the star list is read
    "fits.recompute_xyls_pixel_positions": lambda s, tmp:
        fits.recompute_xyls_pixel_positions(str(tmp / "stars.xyls"), WCS,
                                            WCS),
    "draw.draw_kml_image": lambda s, tmp: draw.draw_kml_image(
        str(tmp / "o.kml"), s.mapping),
    "draw.draw_horizon": lambda s, tmp: draw.draw_horizon(s.mapping),
    "draw.draw_ra_dec": lambda s, tmp: draw.draw_ra_dec(s.mapping),
    "draw.draw_constellations": lambda s, tmp: draw.draw_constellations(
        TanWcs(s.header)),
    "debug.check_horizon": lambda s, tmp: debug.check_horizon(
        str(tmp / "x.png"), WCS, out_path=str(tmp / "h.png")),
    "debug.check_graticule": lambda s, tmp: debug.check_graticule(
        str(tmp / "x.png"), WCS, out_path=str(tmp / "g.png")),
    **{f"resample method={m}": (lambda s, tmp, m=m: resample(
        s.mapping, px_per_deg=3, method=m)) for m in RESAMPLE_METHODS},
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_device_raises_without_a_card(small, no_card,
                                                           tmp_path, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name](small, tmp_path)
    assert not list(tmp_path.iterdir())  # nothing written


def test_dyn_params_need_a_device(small, no_card):
    with pytest.raises(TypeError):
        DynGeorefParams.from_static(small.params)
    with pytest.raises(TypeError):
        DynGeorefParams.stack([small.params])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynGeorefParams.from_static(small.params, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DynGeorefParams.stack([small.params], device="cuda")
    d = DynGeorefParams.stack([small.params] * 2, device="cpu")
    assert d.cd.device.type == "cpu" and tuple(d.cd.shape) == (2, 2, 2)


def test_platform_choices():
    parser = convert.build_parser()
    assert parser.parse_args(["f"]).platform == "cuda"
    assert parser.parse_args(["f", "--platform", "cpu"]).platform == "cpu"
    with pytest.raises(SystemExit):  # no value picks the CPU unasked
        parser.parse_args(["f", "--platform", "default"])
    assert convert.platform_device("cpu") == torch.device("cpu")
