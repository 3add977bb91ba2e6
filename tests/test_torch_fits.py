"""The port's FITS writer, checksums, BINTABLE helpers and catalog stars
(``auromat_tpu_torch.io.fits``) against the JAX package on the CPU.

* Headers, cards and files the two packages write are compared as bytes:
  the real ISS030-E-102170 header as read, after every setter, after
  ``set_checksums``, and single cards of each value type (and the same
  refusals).
* The FITS checksum convention: ``_encode_checksum`` over chosen sums
  equal to JAX's, ``set_checksums`` + ``verify_checksum`` with and without
  data, a flipped byte detected.
* BINTABLE, .xyls, .match and .corr files written by one package and read
  by the other (and the same bytes from both writers).
* The CD-matrix and centre helpers equal to JAX's.
* ``recompute_xyls_pixel_positions`` and ``get_catalog_stars('bright')``
  (float64 on CPU tensors) within 1e-9 px of JAX's, same stars in the same
  order; the 'tycho2' route's VizieR parsing with ``urlopen`` replaced.
"""

import io
import os
from datetime import datetime

import numpy as np
import pytest

from auromat_tpu.io import fits as jfits
from auromat_tpu_torch.io import fits

RES = os.path.join(os.path.dirname(__file__), "resources")
WCS = os.path.join(RES, "ISS030-E-102170_dc.wcs")


def both_headers():
    return fits.read_header(WCS), jfits.read_header(WCS)


def test_real_header_bytes_equal(tmp_path):
    ours, theirs = both_headers()
    assert fits.header_bytes(ours) == jfits.header_bytes(theirs)
    assert len(fits.header_bytes(ours)) % fits.BLOCK == 0
    fits.write_header(ours, tmp_path / "a.wcs")
    jfits.write_header(theirs, tmp_path / "b.wcs")
    assert (tmp_path / "a.wcs").read_bytes() == (tmp_path / "b.wcs").read_bytes()
    # and the file reads back to the same cards
    back = fits.read_header(tmp_path / "a.wcs")
    assert dict(back) == dict(ours) and back.history == ours.history


def _set_all(mod, h):
    t = datetime(2012, 1, 25, 9, 27, 8, 60000)
    mod.set_spacecraft_position(h, (-2153.123456789, 4032.5, 4991.000001), t)
    mod.set_shifted_spacecraft_position(h, (1.0, 2.5, -3.25), -13.0)
    mod.set_norad_id(h, 25544)
    mod.set_cd_matrix(h, 0.0123456789, 37.5)
    mod.set_center_radec(h, 271.25, -12.5)
    return h


def test_setters_and_checksums_bytes_equal():
    ours, theirs = both_headers()
    ours = fits.FitsHeader({k: v for k, v in ours.items()
                            if not k.startswith(("POS", "NORADID"))})
    theirs = jfits.FitsHeader(dict(ours))
    _set_all(fits, ours), _set_all(jfits, theirs)
    assert fits.header_bytes(ours) == jfits.header_bytes(theirs)
    assert ours.history == theirs.history == [
        "POS* & DATE-OBS added by auromat_tpu",
        "POS*SHIF & DATESHIF added by auromat_tpu",
        "NORADID added by auromat_tpu"]
    data = bytes(range(256)) * 7
    fits.set_checksums(ours, data), jfits.set_checksums(theirs, data)
    blob = fits.header_bytes(ours)
    assert blob == jfits.header_bytes(theirs)
    assert fits.verify_checksum(blob, data)
    assert not fits.verify_checksum(blob, data[:-1] + b"\x01")


@pytest.mark.parametrize("key,value,comment", [
    ("FLAG", True, None), ("FLAG", False, "a logical"),
    ("N", 0, None), ("N", -123456789012, "an int"),
    ("X", 1.5, None), ("X", -0.0, None), ("X", 1e-300, "tiny"),
    ("X", 123456789.123456789, None), ("X", 2.0 ** 70, None),
    ("S", "", None), ("S", "O'Brien", "quoted"), ("S", "RA---TAN", None),
    ("LONGCMT", 1, "c" * 100), ("HISTORY", "solved by solve-field", None),
    ("COMMENT", None, None), ("END", None, None),
])
def test_format_card_equal(key, value, comment):
    card = fits.format_card(key, value, comment)
    assert card == jfits.format_card(key, value, comment)
    assert len(card) == fits.CARD


@pytest.mark.parametrize("value,error", [
    (float("nan"), ValueError), (float("inf"), ValueError),
    ("x" * 80, ValueError), ([1], TypeError)])
def test_format_card_refusals_match(value, error):
    for mod in (fits, jfits):
        with pytest.raises(error):
            mod.format_card("KEY", value)


@pytest.mark.parametrize("total", [0, 1, 0xFFFFFFFF, 0x12345678, 0xDEADBEEF,
                                   0x3A3A3A3A, 0x5B5B5B5B, 0x7F7F7F7F])
def test_encode_checksum_equal(total):
    s = fits._encode_checksum(total)
    assert s == jfits._encode_checksum(total) and len(s) == 16
    assert all(c.isalnum() for c in s)


def test_checksum_helpers_equal():
    data = np.random.default_rng(0).integers(0, 256, 1001, np.uint8).tobytes()
    assert fits.compute_datasum(data) == jfits.compute_datasum(data)
    assert fits._ones_complement_sum32(data) == \
        jfits._ones_complement_sum32(data)
    for v in (0, 2 ** 32, 2 ** 40 + 5, 2 ** 64 - 1):
        assert fits._fold32(v) == jfits._fold32(v) < 2 ** 32
    h = fits.set_checksums(fits.FitsHeader({"A": 1}))
    assert fits.verify_checksum(fits.header_bytes(h))
    assert h["DATASUM"] == "0"


def _columns(n=37):
    rng = np.random.default_rng(1)
    return {"X": rng.random(n) * 4000, "Y": rng.random(n).astype(np.float32),
            "I2": rng.integers(-999, 999, n).astype(np.int16),
            "I4": rng.integers(-2 ** 30, 2 ** 30, n).astype(np.int32),
            "I8": rng.integers(-2 ** 60, 2 ** 60, n),
            "FLAG": rng.random(n) > 0.5}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_bintable_round_trip_across_packages(tmp_path, writer):
    cols = _columns()
    prim = {"OBJECT": "stars", "NSTARS": 37}
    a, b = tmp_path / "a.fits", tmp_path / "b.fits"
    fits.write_bintable(a, cols, primary_header=prim)
    jfits.write_bintable(b, cols, primary_header=prim)
    assert a.read_bytes() == b.read_bytes()
    path = a if writer == "port" else b
    for reader in (fits, jfits):
        table = reader.read_bintable(path)
        assert list(table) == list(cols)
        for k, v in cols.items():
            assert table[k].dtype.kind == v.dtype.kind
            assert np.array_equal(table[k], v), k
    assert fits.read_header(a)["OBJECT"] == "stars"


def test_xyls_and_corr_round_trip(tmp_path):
    rng = np.random.default_rng(2)
    x, y, flux = rng.random(50) * 4256, rng.random(50) * 2832, rng.random(50)
    fits.write_xyls(tmp_path / "a.xyls", x, y, flux)
    jfits.write_xyls(tmp_path / "b.xyls", x, y, flux)
    assert (tmp_path / "a.xyls").read_bytes() == \
        (tmp_path / "b.xyls").read_bytes()
    for sort in (False, True):
        ours = fits.read_xy(tmp_path / "b.xyls", sort=sort)
        theirs = jfits.read_xy(tmp_path / "a.xyls", sort=sort)
        for o, t in zip(ours, theirs):
            assert np.array_equal(o, t)
    assert np.allclose(ours[0], x[np.argsort(flux)[::-1]], atol=1e-9)
    corr = {"field_x": x, "field_y": y, "index_x": x + 0.5, "index_y": y - 1}
    fits.write_bintable(tmp_path / "c.corr", corr)
    for o, t in zip(fits.read_corr(tmp_path / "c.corr"),
                    jfits.read_corr(tmp_path / "c.corr")):
        assert np.array_equal(o, t)


def _write_match(path, quadpix, dimquads):
    """A .match file as astrometry.net writes it: one row with a repeated
    QUADPIX column (8D), which ``write_bintable`` (1-D columns) cannot."""
    dtype = np.dtype([("DIMQUADS", ">i2"), ("QUADPIX", ">f8", (8,))])
    row = np.zeros(1, dtype)
    row["DIMQUADS"], row["QUADPIX"][0] = dimquads, quadpix
    cards = [fits.format_card(k, v) for k, v in (
        ("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
        ("NAXIS1", dtype.itemsize), ("NAXIS2", 1), ("PCOUNT", 0),
        ("GCOUNT", 1), ("TFIELDS", 2), ("TTYPE1", "DIMQUADS"),
        ("TFORM1", "I"), ("TTYPE2", "QUADPIX"), ("TFORM2", "8D"))]
    ext = "".join(cards + [fits.format_card("END", None)]).encode()
    ext += b" " * ((-len(ext)) % fits.BLOCK)
    data = row.tobytes()
    data += b"\0" * ((-len(data)) % fits.BLOCK)
    with open(path, "wb") as f:
        f.write(fits.header_bytes(fits.FitsHeader({"EXTEND": True}))
                + ext + data)


def test_read_quad_match_equal(tmp_path):
    quad = np.arange(8, dtype=np.float64) * 10.5
    _write_match(tmp_path / "q.match", quad, 3)
    ours = fits.read_quad_match(tmp_path / "q.match")
    assert np.array_equal(ours, jfits.read_quad_match(tmp_path / "q.match"))
    assert np.array_equal(ours, quad.reshape(4, 2)[:3])


def test_cd_and_centre_helpers_equal():
    ours, theirs = both_headers()
    for name in ("get_cd_matrix", "get_pixel_scale_deg", "get_center_radec",
                 "get_rotation_angle", "get_radius"):
        assert getattr(fits, name)(ours) == getattr(jfits, name)(theirs), name
    assert fits.get_radius(ours, 0.25) == jfits.get_radius(theirs, 0.25)
    assert fits.cd11_cd21(0.01, 123.0) == jfits.cd11_cd21(0.01, 123.0)
    fits.set_cd_matrix(ours, 0.02, -45.0)
    jfits.set_cd_matrix(theirs, 0.02, -45.0)
    fits.set_center_radec(ours, 10.0, 20.0)
    jfits.set_center_radec(theirs, 10.0, 20.0)
    assert dict(ours) == dict(theirs)
    assert fits.get_rotation_angle(ours) == pytest.approx(-45.0)
    for mod in (fits, jfits):
        with pytest.raises(AssertionError):
            mod.set_center_radec(ours, 361.0, 0.0)


def _moved(header):
    h = header.copy()
    h["CRVAL1"] += 0.05
    h["CRVAL2"] -= 0.03
    h["CD1_2"] *= 1.001
    return h


def test_recompute_xyls_pixel_positions(tmp_path):
    rng = np.random.default_rng(3)
    x, y = rng.random(40) * 4256, rng.random(40) * 2832
    fits.write_xyls(tmp_path / "s.xyls", x, y)
    ours, theirs = both_headers()
    for new in (WCS, _moved(ours)):
        nx, ny = fits.recompute_xyls_pixel_positions(tmp_path / "s.xyls", WCS,
                                                     new, device="cpu")
        jnew = new if isinstance(new, str) else _moved(theirs)
        jx, jy = jfits.recompute_xyls_pixel_positions(tmp_path / "s.xyls",
                                                      WCS, jnew)
        assert nx.dtype == np.float64 and nx.shape == (40,)
        np.testing.assert_allclose(nx, jx, rtol=0, atol=1e-9)
        np.testing.assert_allclose(ny, jy, rtol=0, atol=1e-9)
    same = fits.recompute_xyls_pixel_positions(tmp_path / "s.xyls", WCS, WCS,
                                               device="cpu")
    np.testing.assert_allclose(same[0], x, atol=1e-6)


@pytest.mark.parametrize("limit,ret_vmag", [(500, False), (5, True),
                                            (0, False)])
def test_catalog_stars_bright_equal(limit, ret_vmag):
    ours, theirs = both_headers()
    got = fits.get_catalog_stars(ours, limit=limit, ret_vmag=ret_vmag,
                                 device="cpu")
    want = jfits.get_catalog_stars(theirs, limit=limit, ret_vmag=ret_vmag)
    assert len(got) == len(want) == (3 if ret_vmag else 2)
    assert len(got[0]) == len(want[0]) > 0
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
    if ret_vmag:
        assert np.isnan(got[2]).all() and np.isnan(want[2]).all()


VIZIER_TSV = b"""#
# VizieR Astronomical Server
#Column\tRAJ2000
RA(ICRS)\tDE(ICRS)\tVTmag
deg\tdeg\tmag
----------\t----------\t------
250.000000\t+40.000000\t3.5
251.000000\t+41.000000\t
bad\trow\there
252.500000\t+39.500000\t5.25
"""


def test_tycho2_route_parses_vizier_tsv(monkeypatch):
    """The VizieR answer parsed alike by both packages (``urlopen``
    replaced: no test touches the network), then projected."""
    import urllib.request

    urls = []

    def fake_urlopen(url, timeout=None):
        urls.append(url)
        return io.BytesIO(VIZIER_TSV)

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    ours = fits._query_vizier_tycho2(250.0, 40.0, 2.0, 10, max_vmag=6)
    theirs = jfits._query_vizier_tycho2(250.0, 40.0, 2.0, 10, max_vmag=6)
    assert urls[0] == urls[1] and "VTmag=%3C6" in urls[0]
    for o, t in zip(ours, theirs):
        assert np.array_equal(o, t, equal_nan=True)
    assert len(ours[0]) == 3 and np.isnan(ours[2][1])
    h, jh = both_headers()
    ra, dec = fits.get_center_radec(h)
    monkeypatch.setattr(fits, "_query_vizier_tycho2",
                        lambda *a, **k: (np.array([ra]), np.array([dec]),
                                         np.array([4.0])))
    x, y, v = fits.get_catalog_stars(h, catalog="tycho2", ret_vmag=True,
                                     device="cpu")
    assert len(x) == 1 and v[0] == 4.0
    assert abs(x[0] - (h["CRPIX1"] - 1)) < 1e-6
    with pytest.raises(ValueError, match="unknown catalog"):
        fits.get_catalog_stars(h, catalog="nope", device="cpu")
