"""The port's TLE camera positions (auromat_tpu_torch.coordinates.ephem, the
TLE branch of ``mapping.spacecraft.resolve_camera_position``) and its
Space-Track client's pure functions, against the JAX package on the CPU.

* The Spacetrack Report #3 goldens (TEME positions at 0 and 360 min).
* Port vs JAX ``SGP4``, ``teme_to_gcrs_matrix`` and
  ``EphemerisCalculator``: equal within 1e-9 km (the same float64 host
  code).
* The ISS TLE fitted to the ISS030-E-102170 header's two positions
  (tests/test_ephem.py::iss_tle_from_header) kept below as constants, and
  the helper still producing them.
* The TLE branch: the ISS030 header without its POS* cards plus that TLE,
  through ``resolve_camera_position``, ``create_mapping`` (the header's
  calibration scaled to 512x384) and ``get_mapping`` on the CPU: position
  within 1e-9 km of the JAX calculator's and within 15 km of the header's,
  lat/lon within 1e-9 deg of the JAX package's mapping from that position.
* Space-Track's coverage and checksum filters as in tests/test_spacetrack.py.
"""

import math
import os
import warnings
from datetime import datetime, timedelta

import numpy as np
import pytest

from auromat_tpu.coordinates import ephem as jeph
from auromat_tpu.io import fits as jfits
from auromat_tpu.mapping.astrometry import create_mapping as jcreate
from auromat_tpu_torch.coordinates import ephem
from auromat_tpu_torch.coordinates.spacetrack import Spacetrack
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.mapping import spacecraft as sc
from auromat_tpu_torch.mapping.astrometry import create_mapping
from tests.test_ephem import (TEST_L1, TEST_L2, iss_tle_from_header,
                              make_tle)

RES = os.path.join(os.path.dirname(__file__), "resources")
WCS = os.path.join(RES, "ISS030-E-102170_dc.wcs")

# tests/test_ephem.py::iss_tle_from_header, fitted to the header's state
ISS_L1 = "1 25544U 98067A   12025.39384329  .00000000  00000-0  00000-0 0    04"
ISS_L2 = "2 25544  51.6283 123.3888 0093999 252.4012 171.2148 15.81821010    06"
DATE_OBS = datetime(2012, 1, 25, 9, 27, 8, 60000)


def test_fitted_iss_tle_constants():
    tle, t0, _ = iss_tle_from_header()
    assert (tle.line1, tle.line2) == (ISS_L1, ISS_L2) and t0 == DATE_OBS
    assert ephem.tle_checksum_ok(ISS_L1) and ephem.tle_checksum_ok(ISS_L2)


def test_tle_parsing_matches_jax(tmp_path):
    l1, l2 = make_tle(datetime(2012, 1, 25, 12), 51.6, 280.0, 0.0016,
                      291.7, 134.6, 15.59)
    p = tmp_path / "tle.txt"
    p.write_text(f"ISS (ZARYA)\n{l1}\n{l2}\n{TEST_L1}\n{TEST_L2}\n")
    ours, theirs = ephem.parse_tle_file(str(p)), jeph.parse_tle_file(str(p))
    assert len(ours) == len(theirs) == 2 and ours[0].name == "ISS (ZARYA)"
    for a, b in zip(ours, theirs):
        assert vars(a) == vars(b)
    assert ephem.TLE(TEST_L1, TEST_L2).bstar == pytest.approx(0.66816e-4,
                                                             abs=1e-12)
    for line in (l1, l2, l1[:-1] + str((int(l1[-1]) + 1) % 10),
                 l1[:-1] + "X", ""):
        assert ephem.tle_checksum_ok(line) == jeph.tle_checksum_ok(line)


def test_sgp4_spacetrack_report_3_golden_and_jax():
    prop = ephem.SGP4(ephem.TLE(TEST_L1, TEST_L2))
    jprop = jeph.SGP4(jeph.TLE(TEST_L1, TEST_L2))
    r0, _ = prop(0.0)
    np.testing.assert_allclose(
        r0, [2328.97048951, -5995.22076416, 1719.97067261], atol=0.05)
    r360, _ = prop(360.0)
    np.testing.assert_allclose(
        r360, [2456.10705566, -6071.93853760, 1222.89727783], atol=0.5)
    for t in np.linspace(-720.0, 1440.0, 13):
        (r, v), (jr, jv) = prop(float(t)), jprop(float(t))
        assert np.abs(r - jr).max() < 1e-9 and np.abs(v - jv).max() < 1e-12


@pytest.mark.parametrize("date", [datetime(2000, 1, 1, 12), DATE_OBS,
                                  datetime(2020, 6, 1),
                                  datetime(2004, 4, 6, 7, 51, 28)])
def test_teme_to_gcrs_matches_jax(date):
    m = ephem.teme_to_gcrs_matrix(date)
    np.testing.assert_allclose(m, jeph.teme_to_gcrs_matrix(date), rtol=0,
                               atol=1e-15)
    np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-12)
    assert ephem.julian_date(date) == jeph.julian_date(date)


def test_ephemeris_calculator_matches_jax():
    tle, jtle = ephem.TLE(ISS_L1, ISS_L2), jeph.TLE(ISS_L1, ISS_L2)
    calc, jcalc = ephem.EphemerisCalculator([tle]), \
        jeph.EphemerisCalculator([jtle])
    for dt in (-600, -13, 0, 60, 3600):
        t = DATE_OBS + timedelta(seconds=dt)
        assert np.abs(calc(t) - jcalc(t)).max() < 1e-9
    assert calc.getPosition(DATE_OBS) is not None
    assert calc.contains(tle.epoch) and not calc.contains(
        DATE_OBS + timedelta(days=400))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        calc(DATE_OBS + timedelta(days=3))
    assert any("TLE epoch" in str(x.message) for x in w)
    with pytest.raises(ValueError, match="no TLEs"):
        ephem.EphemerisCalculator([tle], norad_id=1)


@pytest.fixture(scope="module")
def tle_case(tmp_path_factory):
    """The header without POS* cards (scaled to 512x384), a TLE file, and
    the JAX calculator's position at DATE-OBS."""
    d = tmp_path_factory.mktemp("tle")
    (d / "iss.tle").write_text(f"ISS (ZARYA)\n{ISS_L1}\n{ISS_L2}\n")
    full = fits.read_header(WCS)
    header = fits.FitsHeader({k: v for k, v in full.items()
                              if not k.startswith("POS")})
    scale = header["IMAGEW"] / 512
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        header[k] = header[k] * scale
    header["CRPIX1"], header["CRPIX2"] = (header["CRPIX1"] / scale,
                                          header["CRPIX2"] / scale)
    header["IMAGEW"], header["IMAGEH"] = 512, 384
    jpos = jeph.EphemerisCalculator(str(d / "iss.tle"))(DATE_OBS)
    header_pos = np.array(fits.get_spacecraft_position(full))
    return header, str(d / "iss.tle"), jpos, header_pos, d


def test_resolve_camera_position_tle_branch(tle_case):
    header, tle_path, jpos, header_pos, _ = tle_case
    pos, t, shift = sc.resolve_camera_position(header, tle_path)
    assert t == DATE_OBS and shift == 0.0
    assert np.abs(pos - jpos).max() < 1e-9
    assert np.linalg.norm(pos - header_pos) < 15.0
    with pytest.raises(ValueError, match="no spacecraft position"):
        sc.resolve_camera_position(header)
    # the header's own cards still win over a TLE
    full = fits.read_header(WCS)
    _, t_shift, shift = sc.resolve_camera_position(full, tle_path)
    assert shift == -13.0 and t_shift == DATE_OBS - timedelta(seconds=13)


def test_create_and_get_mapping_from_a_tle(tle_case):
    header, tle_path, jpos, _, d = tle_case
    from PIL import Image

    img = np.random.default_rng(3).integers(0, 256, (384, 512, 3), np.uint8)
    pos, t, _ = sc.resolve_camera_position(header, tle_path)
    m = create_mapping(header, img, pos, t, fast_center=True, device="cpu")
    jm = jcreate(jfits.FitsHeader(header), img, jpos, t, fast_center=True)
    Image.fromarray(img).save(d / "frame.png")
    jfits.write_header(jfits.FitsHeader(header), str(d / "frame.wcs"))
    g = sc.get_mapping(str(d / "frame.png"), str(d / "frame.wcs"),
                       fast_center=True, tle_path=tle_path, device="cpu")
    for ours in (m, g):
        for name in ("lats", "lons", "latsCenter", "lonsCenter"):
            a = getattr(ours, name).filled(np.nan)
            b = getattr(jm, name).filled(np.nan)
            assert np.array_equal(np.isnan(a), np.isnan(b))
            ok = ~np.isnan(a)
            assert ok.mean() > 0.3 and np.abs(a[ok] - b[ok]).max() < 1e-9
        assert np.array_equal(ours.img.filled(0), jm.img.filled(0))
    # a mapping from the header's own position lies within a few km
    hpos = np.array(fits.get_spacecraft_position(fits.read_header(WCS)))
    mh = create_mapping(header, img, hpos, t, fast_center=True, device="cpu")
    ok = ~m.center_mask & ~mh.center_mask & (m.elevation.filled(0) > 10)
    dlat = np.abs(m.latsCenter.data - mh.latsCenter.data)[ok]
    assert ok.sum() > 1000 and dlat.max() < 0.5


def _write_archive(path, epochs):
    lines = []
    for e in epochs:
        lines += list(make_tle(e, 51.6, 100.0, 0.0005, 90.0, 0.0, 15.5))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("case", ["contiguous", "gapped", "unsorted",
                                  "future_end"])
def test_spacetrack_coverage(tmp_path, case):
    st = Spacetrack("user", "pw", str(tmp_path))
    path = tmp_path / "25544.tle"
    day = lambda d0, n, step=1.0: [d0 + timedelta(days=i * step)
                                   for i in range(n)]
    now = datetime.now()
    epochs, start, end, covers = {
        "contiguous": (day(datetime(2012, 1, 1), 15, 2), datetime(2012, 1, 2),
                       datetime(2012, 1, 25), True),
        "gapped": (day(datetime(2012, 5, 1), 5) + day(datetime(2012, 8, 1), 5),
                   datetime(2012, 6, 10), datetime(2012, 6, 20), False),
        "unsorted": (day(datetime(2012, 3, 1), 10)
                     + day(datetime(2012, 2, 25), 5),
                     datetime(2012, 2, 26), datetime(2012, 3, 8), True),
        "future_end": (day(now - timedelta(days=5), 11, 0.5),
                       now - timedelta(days=4), now + timedelta(days=2), True),
    }[case]
    _write_archive(path, epochs)
    assert st._covers(str(path), start, end) is covers
    assert st.tle_path(25544) == str(path)
    assert st._covers(str(tmp_path / "none.tle"), start, end) is False


def test_spacetrack_checksum_filter():
    e = datetime(2012, 1, 1)
    l1a, l2a = make_tle(e, 51.6, 100.0, 0.0005, 90.0, 0.0, 15.5)
    l1b, l2b = make_tle(e + timedelta(days=1), 51.6, 100.0, 0.0005, 90.0,
                        0.0, 15.5)
    flip = lambda line: line[:-1] + ("0" if line[-1] != "0" else "1")
    f = Spacetrack._checksum_filter
    assert f([l1a, flip(l2a), l1b, l2b]) == [l1b, l2b]
    assert f(["ISS (ZARYA)", l1a, l2a]) == ["ISS (ZARYA)", l1a, l2a]
    assert f(["ISS (ZARYA)", flip(l1a), l2a]) == []
    assert f([l2a, l1b, l2b]) == [l1b, l2b]  # orphan line 2 dropped
    assert math.isfinite(ephem.TLE(l1b, l2b).no)
