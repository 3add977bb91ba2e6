"""The port's ESA ISS archive provider (auromat_tpu_torch.mapping.iss)
against the JAX package's on the CPU, with the offline cache of
tests/test_iss_provider.py (the checked-in 4256x2832 frame ISS030-E-102170
and its .wcs, no network).

* ``range``, ``contains``, ``get``/``getById``/``getSequence``, identifier
  and merged metadata with ``fastCenterCalculation=True``: corner and
  centre lat/lon within 1e-9 deg, masks and images equal.
* The route a RAW frame takes once decoded, ``_postprocess_common`` (180
  degree flip, the archive's poly3 model (-0.019) corrected on the device,
  crop to a multiple of 16) and ``_array_mapping``, with the JPEG's decoded
  array given to both providers: the corrected images within one step on
  at most 1e-3 of the values (at this size XLA's CPU loop rounds the
  squared radius once, the port twice; tests/test_torch_lensdistortion.py),
  and ``_array_mapping`` of one corrected array equal to the JAX
  package's (grids 1e-9 deg, masks and images equal).
* The refusals: offline without api.json or metadata.json, a frame missing
  offline, a date out of range, and the RAW route's white-balance guard
  and its 16-bps no-cache rule with a stub in place of rawpy (no RAW
  decoder here).
* ``download`` through ``file://`` URIs laid out in tmp_path
  (``baseUrl=tmp_path.as_uri() + "/"``; urllib opens them with no
  network), the same files as the JAX provider's download.
"""

import datetime
import gzip
import importlib.machinery
import json
import os
import shutil
import sys
import types

import numpy as np
import pytest

from auromat_tpu.io.image import load_image
from auromat_tpu.mapping.iss import ISSMappingProvider as JISS
from auromat_tpu_torch.mapping import iss
from auromat_tpu_torch.mapping.iss import ISSMappingProvider

RES = os.path.join(os.path.dirname(__file__), "resources")
KEY = "ISS030-E-102170"
DATE = datetime.datetime(2012, 1, 25, 9, 27, 8, 60000)
DIST = {"model": "poly3", "params": [-0.019]}


def api_json(**extra):
    api = {
        "id": 77,
        "date_start": "2012-01-25T09:27:08.060000",
        "date_end": "2012-01-25T09:27:08.060000",
        "image_extension": ".jpg",
        "metadata_uri": "unused",
        "images": {KEY: {"date": "2012-01-25T09:27:08.060000",
                         "image_uri": "unused", "wcs_uri": "unused"}},
    }
    api.update(extra)
    return api


META = {"sequence_metadata": {"Project": "THOR"},
        "image_metadata": {KEY: {"exposure": 1.0}}}


def make_cache(folder, frame=True, **extra):
    os.makedirs(folder, exist_ok=True)
    if frame:
        shutil.copy(os.path.join(RES, "ISS030-E-102170_dc.jpg"),
                    os.path.join(folder, f"{KEY}.jpg"))
        shutil.copy(os.path.join(RES, "ISS030-E-102170_dc.wcs"),
                    os.path.join(folder, f"{KEY}.wcs"))
    with open(os.path.join(folder, "api.json"), "w") as f:
        json.dump(api_json(**extra), f)
    with open(os.path.join(folder, "metadata.json"), "w") as f:
        json.dump(META, f)
    return str(folder)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return make_cache(tmp_path_factory.mktemp("iss") / "cache",
                      distortion_correction=DIST, raw_is_upside_down=True)


@pytest.fixture(scope="module")
def providers(cache):
    return (ISSMappingProvider(cache, offline=True, fastCenterCalculation=True,
                               device="cpu"),
            JISS(cache, offline=True, fastCenterCalculation=True))


@pytest.fixture(scope="module")
def jax_mapping(providers):
    return providers[1].getById(KEY)


def assert_mappings_equal(m, jm, tol=1e-9):
    assert m.identifier == jm.identifier
    assert m.photoTime == jm.photoTime and m.altitude == jm.altitude
    np.testing.assert_array_equal(m.cameraPosGCRS, jm.cameraPosGCRS)
    assert np.array_equal(m.corner_mask, jm.corner_mask)
    assert np.array_equal(m.center_mask, jm.center_mask)
    for name in ("lats", "lons", "latsCenter", "lonsCenter", "elevation"):
        a = getattr(m, name).filled(np.nan)
        b = getattr(jm, name).filled(np.nan)
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        ok = ~np.isnan(a)
        assert ok.mean() > 0.3 and np.abs(a[ok] - b[ok]).max() < tol, name
    assert np.array_equal(m.img.filled(0), jm.img.filled(0))
    assert m.img.dtype == jm.img.dtype


def test_provider_matches_jax(providers, jax_mapping):
    prov, jprov = providers
    assert prov.range == jprov.range == (DATE, DATE)
    for dt in (0, 2, 4, -4):
        d = DATE + datetime.timedelta(seconds=dt)
        assert prov.contains(d) == jprov.contains(d) == (abs(dt) <= 3)
    m = prov.get(DATE + datetime.timedelta(seconds=2))
    assert_mappings_equal(m, jax_mapping)
    assert m.metadata == jax_mapping.metadata == {"Project": "THOR",
                                                  "exposure": 1.0}
    (s,) = prov.getSequence()
    assert s.identifier == KEY and np.array_equal(s.lats.data, m.lats.data,
                                                   equal_nan=True)
    assert prov.download() == jprov.download() == [KEY]
    assert 47 < m.boundingBox.latSouth < 49


def test_postprocess_and_array_route_match_jax(providers, jax_mapping):
    prov, jprov = providers
    decoded = load_image(os.path.join(RES, "ISS030-E-102170_dc.jpg"))
    ours = prov._postprocess_common(decoded)
    theirs = jprov._postprocess_common(decoded)
    assert ours.shape == theirs.shape == decoded.shape
    assert ours.dtype == np.uint8
    d = np.abs(ours.astype(int) - theirs.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    # the flip came before the correction: the corrected image is not the
    # unflipped one
    assert not np.array_equal(ours, prov._postprocess_common(decoded[::-1, ::-1]))
    m = prov._array_mapping(KEY, theirs)
    jm = jprov._array_mapping(KEY, theirs)
    assert_mappings_equal(m, jm)
    # the same frame's grids as the JPEG route, another image
    assert np.array_equal(jm.lats.data, jax_mapping.lats.data, equal_nan=True)
    assert not np.array_equal(m.img.filled(0), jax_mapping.img.filled(0))


def test_offline_refusals(tmp_path):
    with pytest.raises(RuntimeError, match="api.json"):
        ISSMappingProvider(str(tmp_path / "empty"), offline=True, device="cpu")
    d = make_cache(tmp_path / "nometa", frame=False)
    os.remove(os.path.join(d, "metadata.json"))
    with pytest.raises(RuntimeError, match="metadata.json"):
        ISSMappingProvider(d, offline=True, device="cpu")
    with pytest.raises(ValueError, match="id_"):
        ISSMappingProvider(str(tmp_path / "noid"), device="cpu")
    prov = ISSMappingProvider(make_cache(tmp_path / "noframe", frame=False),
                              offline=True, device="cpu")
    with pytest.raises(RuntimeError, match="not cached"):
        prov.getById(KEY)
    with pytest.raises(ValueError, match="no image within"):
        prov.get(DATE + datetime.timedelta(hours=2))
    assert not prov.contains(DATE + datetime.timedelta(hours=2))


def test_the_card_by_default(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ISSMappingProvider(make_cache(tmp_path / "c", frame=False),
                           offline=True)


class StubRaw:
    """What ``rawpy.imread`` returns, with a decoded frame in place of the
    demosaic."""

    def __init__(self, color_desc, rgb):
        self.color_desc, self.num_colors = color_desc, 3
        self.rgb, self.calls = rgb, []

    def postprocess(self, **kw):
        self.calls.append(kw)
        return self.rgb


@pytest.fixture
def stub_rawpy(monkeypatch):
    """A ``rawpy`` module whose imread returns the raw object the test
    sets; records bad-pixel repairs."""
    state = {"raw": None, "repaired": []}
    mod = types.ModuleType("rawpy")
    mod.__spec__ = importlib.machinery.ModuleSpec("rawpy", None)
    mod.imread = lambda path: state["raw"]
    enhance = types.ModuleType("rawpy.enhance")
    enhance.repair_bad_pixels = lambda raw, bad: state["repaired"].append(bad)
    mod.enhance = enhance
    monkeypatch.setitem(sys.modules, "rawpy", mod)
    monkeypatch.setitem(sys.modules, "rawpy.enhance", enhance)
    assert iss.has_rawpy()
    return state


def raw_cache(folder):
    d = make_cache(folder, frame=False, raw_extension=".NEF",
                   raw_white_balance=[2.0, 1.0, 1.5, 1.0],
                   raw_bad_pixels_uri="unused", raw_is_upside_down=True,
                   distortion_correction=DIST)
    with open(os.path.join(d, "api.json")) as f:
        api = json.load(f)
    api["images"][KEY]["raw_uri"] = "unused"
    with open(os.path.join(d, "api.json"), "w") as f:
        json.dump(api, f)
    open(os.path.join(d, f"{KEY}.NEF"), "wb").close()
    shutil.copy(os.path.join(RES, "ISS030-E-102170_dc.wcs"),
                os.path.join(d, f"{KEY}.wcs"))
    with gzip.open(os.path.join(d, "bad_pixels.gz"), "wt") as f:
        f.write("10 20\n30 40\n")
    return d


def test_raw_route_with_a_stub_decoder(tmp_path, stub_rawpy):
    d = raw_cache(tmp_path / "raw")
    rgb16 = np.random.default_rng(1).integers(0, 65536, (70, 90, 3),
                                              dtype=np.uint16)
    # a user white balance on a non-RGBG sensor is refused
    prov = ISSMappingProvider(d, offline=True, raw_white_balance=(1, 1, 1),
                              device="cpu")
    assert prov.useRaw and prov.badPixels.shape == (2, 2)
    prov._download_files(KEY)
    stub_rawpy["raw"] = StubRaw(b"RGBX", rgb16)
    with pytest.raises(NotImplementedError, match="white balance"):
        prov._processed_image(KEY)
    # RGBG: the 3-tuple maps onto the pattern; 16 bps is never cached
    stub_rawpy["raw"] = raw = StubRaw(b"RGBG", rgb16)
    prov = ISSMappingProvider(d, offline=True, raw_white_balance=(3, 1, 2),
                              noRawPostprocessCaching=False, device="cpu")
    prov._download_files(KEY)
    out = prov._processed_image(KEY)
    assert raw.calls[0]["user_wb"] == [3, 1, 2, 1]
    assert raw.calls[0]["output_bps"] == 16 and raw.calls[0]["user_flip"] is False
    assert isinstance(out, np.ndarray) and out.dtype == np.uint16
    assert out.shape == (64, 80, 3) and KEY not in prov.processedImagePaths
    assert np.array_equal(out, prov._postprocess_common(rgb16))
    assert len(stub_rawpy["repaired"]) == 2  # one repair a decode
    # 8 bps with caching on: a tiff in the cache folder, then reused
    stub_rawpy["raw"] = raw = StubRaw(b"RGBG", (rgb16 >> 8).astype(np.uint8))
    prov = ISSMappingProvider(d, offline=True, raw_bps=8,
                              noRawPostprocessCaching=False, device="cpu")
    prov._download_files(KEY)
    path = prov._processed_image(KEY)
    assert raw.calls[0]["user_wb"] == [2.0, 1.0, 1.5, 1.0]
    assert path == os.path.join(d, f"{KEY}.tiff") and os.path.exists(path)
    assert prov._processed_image(KEY) == path and len(raw.calls) == 1
    prov.removePostProcessedImages()
    assert not os.path.exists(path) and prov.processedImagePaths == {}


def test_download_through_file_uris(tmp_path):
    server = tmp_path / "server"
    server.mkdir()
    url = lambda name: (server / name).as_uri()
    shutil.copy(os.path.join(RES, "ISS030-E-102170_dc.jpg"), server / "f.jpg")
    shutil.copy(os.path.join(RES, "ISS030-E-102170_dc.wcs"), server / "f.wcs")
    (server / "meta.json").write_text(json.dumps(META))
    api = api_json(metadata_uri=url("meta.json"))
    api["images"][KEY].update(image_uri=url("f.jpg"), wcs_uri=url("f.wcs"))
    (server / "77").write_text(json.dumps(api))
    base = server.as_uri() + "/"
    prov = ISSMappingProvider(str(tmp_path / "ours"), id_=77, useRaw=False,
                              baseUrl=base, device="cpu")
    jprov = JISS(str(tmp_path / "theirs"), id_=77, useRaw=False, baseUrl=base)
    assert prov.download() == jprov.download() == [KEY]
    listing = sorted(os.listdir(tmp_path / "ours"))
    assert listing == sorted(os.listdir(tmp_path / "theirs")) == [
        f"{KEY}.jpg", f"{KEY}.wcs", "api.json", "metadata.json"]
    for name in listing:
        with open(tmp_path / "ours" / name, "rb") as a, \
                open(tmp_path / "theirs" / name, "rb") as b:
            assert a.read() == b.read()
    assert prov.metadata == META
    # resume-safe: a second provider on the cache needs no server
    shutil.rmtree(server)
    again = ISSMappingProvider(str(tmp_path / "ours"), device="cpu")
    assert again.download() == [KEY] and again.range == (DATE, DATE)
