"""The port's product read-back (auromat_tpu_torch.mapping.cdf and
.netcdf) against the JAX package's on the CPU.

* ``read_mapping`` on CDF, NETCDF4 and NETCDF3 files of one frame (the
  ISS030-E-102170 calibration scaled to 512x384, a seeded uint8 image),
  unresampled (2-D coordinates) and resampled onto a plate-carree grid
  (1-D coordinates), written by the port's exporters and by the JAX
  package's: every array, mask, dtype, metadata entry, the altitude,
  camera position, photo time and the MLat/MLT caches equal to the JAX
  package's ``read_mapping`` of the same file; the caches are the same
  masked-array type ``Mapping.mLatMlt`` returns.
* ``CDFMappingProvider``/``NetCDFMappingProvider``: ``range``,
  ``contains``, ``get``, ``getById``, ``getSequence`` (date filters
  included) and their refusals, as the JAX package's.
* ``resample`` of a read-back mapping equals ``resample`` of the original:
  grids and masks equal, uint8 image identical, elevation within 1e-5 deg
  (the file holds the zenith angle in float32).
"""

import datetime as dt
import os
import shutil

import numpy as np
import numpy.ma as ma
import pytest

from auromat_tpu.export import cdf as jexport_cdf
from auromat_tpu.export import netcdf as jexport_nc
from auromat_tpu.io import fits as jfits
from auromat_tpu.mapping import cdf as jcdf
from auromat_tpu.mapping import netcdf as jnc
from auromat_tpu.mapping.astrometry import create_mapping as jcreate
from auromat_tpu_torch.export import cdf as export_cdf
from auromat_tpu_torch.export import netcdf as export_nc
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.mapping import cdf, netcdf
from auromat_tpu_torch.mapping.astrometry import create_mapping
from auromat_tpu_torch.resample import resample

RES = os.path.join(os.path.dirname(__file__), "resources")
FORMATS = ["cdf", "NETCDF4", "NETCDF3"]


def small_header():
    hd = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    scale = hd["IMAGEW"] / 512
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        hd[k] = hd[k] * scale
    hd["CRPIX1"], hd["CRPIX2"] = hd["CRPIX1"] / scale, hd["CRPIX2"] / scale
    hd["IMAGEW"], hd["IMAGEH"] = 512, 384
    return hd


@pytest.fixture(scope="module")
def mappings():
    """(port mapping, JAX mapping) of the small frame, unresampled and
    resampled."""
    hd = small_header()
    pos = np.array(fits.get_shifted_spacecraft_position(hd)[:3])
    t = fits.get_shifted_photo_time(hd)
    img = np.random.default_rng(11).integers(0, 256, (384, 512, 3), np.uint8)
    meta = {"Project": "THOR", "exposure": 1.5}
    m = create_mapping(hd, img, pos, t, identifier="small", metadata=meta,
                       device="cpu")
    jm = jcreate(jfits.FitsHeader(hd), img, pos, t, identifier="small",
                 metadata=meta)
    r = resample(m, arcsec_per_px=900, device="cpu")
    from auromat_tpu.resample import resample as jresample

    jr = jresample(jm, arcsec_per_px=900)
    return {"frame": (m, jm), "grid": (r, jr)}


def write(package, fmt, path, mapping):
    if fmt == "cdf":
        (export_cdf if package == "port" else jexport_cdf).write(path, mapping)
    else:
        (export_nc if package == "port" else jexport_nc).write(
            path, mapping, format=fmt)


def readers(fmt):
    return (cdf.read_mapping, jcdf.read_mapping) if fmt == "cdf" else \
        (netcdf.read_mapping, jnc.read_mapping)


@pytest.fixture(scope="module")
def files(mappings, tmp_path_factory):
    d = tmp_path_factory.mktemp("products")
    out = {}
    for kind, pair in mappings.items():
        for package, mapping in zip(("port", "jax"), pair):
            for fmt in FORMATS:
                ext = ".cdf" if fmt == "cdf" else ".nc"
                path = str(d / f"{kind}_{package}_{fmt}{ext}")
                write(package, fmt, path, mapping)
                out[kind, package, fmt] = path
    return out


def assert_same_mapping(m, jm):
    assert type(m).__name__ == type(jm).__name__ == "Mapping"
    assert m.identifier == jm.identifier and m.photoTime == jm.photoTime
    assert m.altitude == jm.altitude and m.metadata == jm.metadata
    assert np.array_equal(m.cameraPosGCRS, jm.cameraPosGCRS)
    assert np.array_equal(m.corner_mask, jm.corner_mask)
    assert np.array_equal(m.center_mask, jm.center_mask)
    for name in ("lats", "lons", "latsCenter", "lonsCenter", "elevation",
                 "img"):
        a, b = getattr(m, name), getattr(jm, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(np.ma.getmaskarray(a), np.ma.getmaskarray(b))
        assert np.array_equal(a.data, b.data, equal_nan=True), name
    for ours, theirs in ((m._mlatmlt, jm._mlatmlt),
                         (m._mlatmlt_center, jm._mlatmlt_center)):
        assert (ours is None) == (theirs is None)
        for a, b in zip(ours or (), theirs or ()):
            assert isinstance(a, ma.MaskedArray) and a.dtype == np.float64
            assert np.array_equal(a.mask, b.mask)
            assert np.array_equal(a.data, b.data, equal_nan=True)


@pytest.mark.parametrize("kind", ["frame", "grid"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_read_mapping_matches_jax(files, mappings, kind, fmt, writer):
    path = files[kind, writer, fmt]
    read, jread = readers(fmt)
    m, jm = read(path), jread(path)
    assert_same_mapping(m, jm)
    original = mappings[kind][0]
    assert m.img.dtype == np.uint8
    assert np.array_equal(m.img.filled(0), original.img.filled(0))
    assert m.metadata["Project"] == "THOR"
    assert m._mlatmlt_center is not None
    assert type(m.mLatMltCenter[0]) is type(original.mLatMltCenter[0])
    if kind == "frame" and fmt == "cdf":
        assert m._mlatmlt is not None  # corner MLat/MLT from *_bounds
    assert read(path, identifier="x").identifier == "x"


@pytest.mark.parametrize("fmt", FORMATS)
def test_providers_match_jax(files, mappings, fmt, tmp_path):
    ext = ".cdf" if fmt == "cdf" else ".nc"
    shutil.copy(files["frame", "port", fmt], tmp_path / f"b{ext}")
    shutil.copy(files["grid", "jax", fmt], tmp_path / f"a{ext}")
    (tmp_path / "ignored.txt").write_text("")
    cls, jcls = ((cdf.CDFMappingProvider, jcdf.CDFMappingProvider)
                 if fmt == "cdf" else
                 (netcdf.NetCDFMappingProvider, jnc.NetCDFMappingProvider))
    prov, jprov = cls(str(tmp_path)), jcls(str(tmp_path))
    t = mappings["frame"][0].photoTime
    assert prov.range == jprov.range
    assert abs((prov.range[0] - t).total_seconds()) < 1e-3
    for s in (0, 2, 5):
        d = t + dt.timedelta(seconds=s)
        assert prov.contains(d) == jprov.contains(d) == (s <= 3)
    assert_same_mapping(prov.get(t), jprov.get(t))
    assert prov.get(t).identifier in ("a", "b")
    assert_same_mapping(prov.getById("b"), jprov.getById("b"))
    seq, jseq = list(prov.getSequence()), list(jprov.getSequence())
    assert [m.identifier for m in seq] == [m.identifier for m in jseq]
    assert len(seq) == 2
    late = t + dt.timedelta(seconds=1)
    assert list(prov.getSequence(dateBegin=late)) == []
    assert len(list(prov.getSequence(dateEnd=late))) == 2
    with pytest.raises(ValueError, match="maxTimeOffset"):
        prov.get(t + dt.timedelta(hours=1))
    with pytest.raises(ValueError, match="no mapping with identifier"):
        prov.getById("nope")
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no .* files found"):
        cls(str(tmp_path / "empty")).range


@pytest.mark.parametrize("fmt", FORMATS)
def test_resample_of_read_back_equals_original(files, mappings, fmt):
    m = mappings["frame"][0]
    back = readers(fmt)[0](files["frame", "port", fmt])
    r = resample(m, arcsec_per_px=900, device="cpu")
    rb = resample(back, arcsec_per_px=900, device="cpu")
    for name in ("lats", "lons", "latsCenter", "lonsCenter"):
        assert np.array_equal(getattr(r, name).data, getattr(rb, name).data,
                              equal_nan=True)
    assert np.array_equal(r.center_mask, rb.center_mask)
    assert (~r.center_mask).sum() > 300
    assert np.array_equal(r.img.filled(0), rb.img.filled(0))
    ok = ~r.center_mask
    assert np.abs(r.elevation.data - rb.elevation.data)[ok].max() < 1e-5


def test_cdf_without_bounds_is_refused(mappings, tmp_path):
    path = str(tmp_path / "nob.cdf")
    export_cdf.write(path, mappings["frame"][0], includeBounds=False)
    with pytest.raises(ValueError, match="corner bounds"):
        cdf.read_mapping(path)
