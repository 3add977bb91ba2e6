"""The port's solving path (``auromat_tpu_torch.solving``) against the JAX
package on the CPU.

* ``masking.mask_starfield`` on the two checked-in ISS frames (once per
  module): the block mask bit-identical to golden_masking_*.npz (the
  executed reference) and to the JAX package, sigma within 1e-2 of the
  golden and equal to JAX's; from a path (``io.image`` decodes) and from
  the PIL array alike. ``mask_starfield_rect`` on an array needs no cv2. A small
  synthetic frame for the channel options and the helpers.
* ``noise.estimate_noise_level`` equal to JAX's.
* ``solving.build_solve_command`` and ``estimate_arcsec_range`` equal.
* ``run_with_timeout`` kills the whole process group at a 2 s timeout
  (tests/test_solving.py's case) and closes its pipes.
* ``solve_image`` with a stand-in ``solve-field`` (a POSIX ``sh`` script,
  as tests/test_solving.py): the ``.wcs`` bytes equal JAX's; per-image
  masked PNGs under a shared ``work_dir``; its own temp dir removed; an
  unsolvable frame and a timeout give None; ``solve_images``' thread pool.
* ``spacecraft.solve_sequence`` on three EXIF-stamped frames with the ISS
  TLE fitted to the ISS030-E-102170 header: header bytes equal JAX's
  (NORAD id, POS*, DATE-OBS, IMAGEW/IMAGEH); a second call runs the solver
  0 times (resume); ``solve`` likewise.
* ``intersects_earth``/``is_consistent`` on the CPU: the JAX package's
  booleans on the real headers and on the ISS030 header turned to
  all-Earth (nadir) and all-sky (zenith); the 32x32 latitudes within
  1e-9 deg where both are finite, NaN where JAX's are.
"""

import os
import sys
import tempfile
import time
from datetime import datetime, timedelta

import numpy as np
import pytest

from auromat_tpu.io import fits as jfits
from auromat_tpu.solving import masking as jmasking
from auromat_tpu.solving import noise as jnoise
from auromat_tpu.solving import solving as jsolving
from auromat_tpu.solving import spacecraft as jspacecraft
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.io.image import load_image
from auromat_tpu_torch.solving import masking, noise, solving, spacecraft
from torch_solving_stand_ins import (fake_solve_field, live_group_members,
                                     pointed, solver_calls, unstamped)

RES = os.path.join(os.path.dirname(__file__), "resources")
FRAMES = ("ISS030-E-102170_dc", "ISS029-E-8492")
WCS = os.path.join(RES, "ISS030-E-102170_dc.wcs")
# tests/test_ephem.py::iss_tle_from_header (tests/test_torch_ephem.py)
ISS_TLE = ("1 25544U 98067A   12025.39384329  .00000000  00000-0  00000-0 0"
           "    04\n2 25544  51.6283 123.3888 0093999 252.4012 171.2148 "
           "15.81821010    06\n")
DATE_OBS = datetime(2012, 1, 25, 9, 27, 8, 60000)


@pytest.fixture(scope="module")
def masks():
    """{frame: (port from path, port from array, JAX from path)}."""
    out = {}
    for name in FRAMES:
        path = os.path.join(RES, f"{name}.jpg")
        out[name] = (masking.mask_starfield(path, device="cpu"),
                     masking.mask_starfield(load_image(path), device="cpu"),
                     jmasking.mask_starfield(path))
    return out


@pytest.mark.parametrize("name", FRAMES)
def test_mask_starfield_golden_and_jax(masks, name):
    golden = np.load(os.path.join(RES, f"golden_masking_{name}.npz"))
    (mask, sigma), (amask, asigma), (jmask, jsigma) = masks[name]
    assert mask.dtype == bool and mask.shape == golden["mask"].shape
    assert int((mask != golden["mask"]).sum()) == 0
    assert np.array_equal(mask, jmask) and np.array_equal(amask, mask)
    assert sigma == jsigma == asigma
    assert sigma == pytest.approx(float(golden["sigma"]), rel=1e-2)


def test_mask_rect_needs_no_cv2(monkeypatch):
    img = np.random.default_rng(0).integers(0, 256, (96, 128, 3), np.uint8)
    want = jmasking.mask_starfield_rect(img, (10, 5), (100, 60))
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now fails
    got = masking.mask_starfield_rect(img, (10, 5), (100, 60))
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    with pytest.raises(ValueError, match="RGB"):
        masking.mask_starfield_rect(img[..., 0], (0, 0), (4, 4))


def synthetic_frame(seed=1, h=240, w=320):
    """A dark star field with a bright 'Earth' over the lower third and a
    thin bright line (a spacecraft strut)."""
    rng = np.random.default_rng(seed)
    img = rng.normal(12, 3, (h, w, 3)).clip(0, 255)
    ys, xs = rng.integers(0, h, 60), rng.integers(0, w, 60)
    img[ys, xs] = 230
    img[2 * h // 3:] = rng.normal(150, 20, (h - 2 * h // 3, w, 3)).clip(0, 255)
    img[20:24, 40:300] = 200
    return img.astype(np.uint8)


@pytest.mark.parametrize("channel,kw", [(None, {}), ("G", {}), ("b", {}),
                                        (None, {"blacken_lower_part": False,
                                                "ignore_very_dark": False})])
def test_mask_starfield_synthetic_matches_jax(channel, kw):
    img = synthetic_frame()
    mask, sigma = masking.mask_starfield(img, channel=channel, device="cpu",
                                         **kw)
    jmask, jsigma = jmasking.mask_starfield(img, channel=channel, **kw)
    assert np.array_equal(mask, jmask) and sigma == jsigma
    assert 0 < mask.mean() < 1


def test_masking_helpers_match_jax():
    gray = synthetic_frame()[..., 1].copy()
    for a, b in zip(masking.binarize_starfield(gray),
                    jmasking.binarize_starfield(gray)):
        assert np.array_equal(a, b)
    binary = masking.binarize_starfield(gray)[0]
    ours = masking.categorize_contours(binary)
    theirs = jmasking.categorize_contours(binary)
    assert len(ours[0]) == len(theirs[0]) > 0
    for a, b in zip(ours[1:], theirs[1:]):
        assert np.array_equal(a, b)
    rng = np.random.default_rng(2)
    for _ in range(5):
        m = rng.random((12, 16)) > 0.3
        assert masking._max_size_rectangle(m) == \
            jmasking._max_size_rectangle(m)
    assert masking._block_shape((240, 320)) == (20, 20)
    with pytest.raises(ValueError, match="not divisible"):
        masking._block_shape((241, 320))
    for mod, kw in ((masking, {"device": "cpu"}), (jmasking, {})):
        with pytest.raises(ValueError, match="channel"):
            mod.mask_starfield(synthetic_frame(), channel="X", **kw)
    with pytest.raises(IOError):
        masking.mask_starfield(os.path.join(RES, "missing.jpg"), device="cpu")


def test_noise_matches_jax():
    rng = np.random.default_rng(3)
    for im in (rng.normal(128, 7, (64, 80)), rng.integers(0, 256, (30, 20)),
               np.full((16, 16), 9.0)):
        assert noise.estimate_noise_level(im) == \
            jnoise.estimate_noise_level(im)


@pytest.mark.parametrize("kw", [
    {}, {"scale_range": (20.0, 40.0), "sigma": 3.5},
    {"timeout_cpu": 60, "pixel_error": 3, "no_tweak": False,
     "extra_args": ["--downsample", "2"], "solve_field": "bin/sf"}])
def test_build_solve_command_matches_jax(kw):
    cmd = solving.build_solve_command("img.png", "/tmp/out", **kw)
    assert cmd == jsolving.build_solve_command("img.png", "/tmp/out", **kw)
    assert cmd[:2] == [kw.get("solve_field", "solve-field"), "img.png"]
    assert solving.STRATEGIES == jsolving.STRATEGIES


def test_estimate_arcsec_range_matches_jax(tmp_path):
    for name in FRAMES:
        path = os.path.join(RES, f"{name}.jpg")
        got = solving.estimate_arcsec_range(path, 4256)
        assert got == jsolving.estimate_arcsec_range(path, 4256)
        assert 0 < got[0] < got[1]
    bare = tmp_path / "bare.png"
    from auromat_tpu_torch.io.image import save_image

    save_image(str(bare), np.zeros((8, 8, 3), np.uint8))
    assert solving.estimate_arcsec_range(str(bare), 8) is None


def test_timeout_kills_process_group(tmp_path):
    pids = tmp_path / "pids"
    t0 = time.time()
    code, out, err = solving.run_with_timeout(
        [sys.executable, "-c", "import os,subprocess,sys,time;"
         "p=subprocess.Popen([sys.executable,'-c','import time;"
         "time.sleep(60)']);"
         f"open({str(pids)!r},'w').write(f'{{os.getpid()}} {{p.pid}}');"
         "time.sleep(60)"], timeout=2)
    assert code is None and (out, err) == (b"", b"timeout")
    assert time.time() - t0 < 20
    parent, child = map(int, pids.read_text().split())
    assert os.getpgid(0) != parent  # the command had a group of its own
    deadline = time.time() + 10
    while live_group_members(parent) and time.time() < deadline:
        time.sleep(0.1)
    assert live_group_members(parent) == [] and child != parent


def test_run_with_timeout_returns_output():
    code, out, err = solving.run_with_timeout(
        ["sh", "-c", "echo hi; echo oops >&2; exit 3"], timeout=10)
    assert (code, out, err) == (3, b"hi\n", b"oops\n")


def _images(folder):
    """The images the stand-in solver was given, in call order."""
    return [img for _, img in solver_calls(folder)]


def test_solve_image_bytes_match_jax(tmp_path, monkeypatch):
    from auromat_tpu_torch.io.image import save_image

    img_path = str(tmp_path / "frame.png")
    save_image(img_path, synthetic_frame())
    fake = fake_solve_field(tmp_path, WCS)
    work = tmp_path / "work"
    work.mkdir()
    out = {}
    for name, mod, kw in (("port", solving, {"device": "cpu"}),
                          ("jax", jsolving, {})):
        wcs = str(tmp_path / f"{name}.wcs")
        assert mod.solve_image(img_path, wcs, solve_field=fake,
                               work_dir=str(work), **kw) == wcs
        out[name] = open(wcs, "rb").read()
    assert out["port"] == out["jax"]
    h = fits.read_header(tmp_path / "port.wcs")
    assert (h["IMAGEW"], h["IMAGEH"]) == (320, 240)
    # the solver saw the masked PNG of this image in the shared work_dir,
    # and every strategy stopped at the first solution
    assert _images(tmp_path) == [str(work / "frame_masked.png")] * 2
    masked = load_image(str(work / "frame_masked.png"))
    assert (masked == 0).any() and masked.shape == (240, 320, 3)
    # without a work_dir the temp dir is removed
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tempfile.tempdir)
    assert solving.solve_image(img_path, str(tmp_path / "x.wcs"),
                               mask=False, solve_field=fake)
    assert os.listdir(tempfile.tempdir) == []


def test_solve_image_failures(tmp_path):
    img_path = str(tmp_path / "frame.png")
    from auromat_tpu_torch.io.image import save_image

    save_image(img_path, synthetic_frame())
    failing = fake_solve_field(tmp_path, WCS, exit_code=1)
    assert solving.solve_image(img_path, mask=False, solve_field=failing,
                               scale_range=(1, 2)) is None
    assert len(_images(tmp_path)) == len(solving.STRATEGIES)
    slow = fake_solve_field(tmp_path, WCS, sleep=30)
    t0 = time.time()
    assert solving.solve_image(img_path, mask=False, solve_field=slow,
                               timeout=2, strategies=solving.STRATEGIES[:1]
                               ) is None
    assert time.time() - t0 < 15
    assert not os.path.exists(str(tmp_path / "frame.wcs"))
    with pytest.raises(RuntimeError, match="not found"):
        solving.solve_image(img_path, solve_field="definitely-not-a-binary")


def test_solve_images_thread_pool(tmp_path):
    from auromat_tpu_torch.io.image import save_image

    fake = fake_solve_field(tmp_path, WCS)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"f{i}.png")
        save_image(p, synthetic_frame(seed=i))
        paths.append(p)
    work = tmp_path / "work"
    work.mkdir()
    res = solving.solve_images(paths + [str(tmp_path / "missing.png")],
                               max_workers=3, solve_field=fake,
                               work_dir=str(work), device="cpu")
    assert res == {**{p: p[:-4] + ".wcs" for p in paths},
                   str(tmp_path / "missing.png"): None}
    assert sorted(_images(tmp_path)) == sorted(
        str(work / f"f{i}_masked.png") for i in range(3))


def _exif_frames(folder, n=3):
    """``n`` small JPEGs with EXIF capture times one second apart from the
    ISS030-E-102170 frame's."""
    from PIL import Image

    folder.mkdir()
    for i in range(n):
        exif = Image.Exif()
        t = DATE_OBS + timedelta(seconds=i)
        ifd = exif.get_ifd(0x8769)
        ifd[0x9003] = t.strftime("%Y:%m:%d %H:%M:%S")  # DateTimeOriginal
        ifd[0x9291] = "%03d" % (t.microsecond // 1000)  # SubSecTimeOriginal
        Image.fromarray(synthetic_frame(seed=i)).save(
            folder / f"ISS030-E-{102170 + i}.jpg", exif=exif)


def test_solve_sequence_matches_jax_and_resumes(tmp_path):
    images = tmp_path / "images"
    _exif_frames(images)
    tle = tmp_path / "iss.tle"
    tle.write_text(ISS_TLE)
    fits.write_header(unstamped(fits.read_header(WCS)),
                      tmp_path / "solved.wcs")
    fake = fake_solve_field(tmp_path, tmp_path / "solved.wcs")
    kw = dict(tle_path=str(tle), solve_field=fake, mask=False,
              scale_range=(40.0, 60.0))
    res = spacecraft.solve_sequence(str(images), str(tmp_path / "port"), **kw)
    jres = jspacecraft.solve_sequence(str(images), str(tmp_path / "jax"), **kw)
    assert len(_images(tmp_path)) == 6
    names = sorted(os.listdir(images))
    assert list(res) == list(jres) == names
    real = np.array(fits.get_spacecraft_position(fits.read_header(WCS)))
    for i, name in enumerate(names):
        ours, theirs = open(res[name], "rb").read(), open(jres[name], "rb").read()
        assert ours == theirs
        h = fits.read_header(res[name])
        assert fits.get_norad_id(h) == spacecraft.ISS_NORAD_ID == 25544
        assert (h["IMAGEW"], h["IMAGEH"]) == (320, 240)
        assert fits.get_photo_time(h) == DATE_OBS + timedelta(seconds=i)
        pos = np.array(fits.get_spacecraft_position(h))
        assert np.linalg.norm(pos - real) < 15.0 + 8.0 * i
    # resume: every frame is solved already, the solver is not called
    again = spacecraft.solve_sequence(str(images), str(tmp_path / "port"), **kw)
    assert again == res and len(_images(tmp_path)) == 6
    spacecraft.solve_sequence(str(images), str(tmp_path / "port"),
                              overwrite=True, **kw)
    assert len(_images(tmp_path)) == 9
    # one frame through solve(): the same stamp as JAX's
    one = os.path.join(images, names[0])
    assert spacecraft.solve(one, str(tmp_path / "a.wcs"), **kw)
    assert jspacecraft.solve(one, str(tmp_path / "b.wcs"), **kw)
    assert (tmp_path / "a.wcs").read_bytes() == \
        (tmp_path / "b.wcs").read_bytes() == open(res[names[0]], "rb").read()
    with pytest.raises(FileExistsError):
        spacecraft.solve(one, str(tmp_path / "a.wcs"), **kw)


def _pointed(header, sign):
    """``header`` turned to look straight down (-1) or up (+1) from its
    camera; the frame's 40 x 27 deg field is far inside the ~70 deg Earth
    disk seen from the ISS."""
    return pointed(header, fits.get_shifted_spacecraft_position(header)[:3],
                   sign)


def check_headers():
    h = fits.read_header(WCS)
    return {"ISS030": h, "ISS029": fits.read_header(
        os.path.join(RES, "ISS029-E-8492.wcs")),
        "all-Earth": _pointed(h, -1), "all-sky": _pointed(h, 1)}


@pytest.mark.parametrize("name,expected", [
    ("ISS030", True), ("ISS029", True), ("all-Earth", False),
    ("all-sky", False)])
def test_earth_checks_match_jax(name, expected):
    from auromat_tpu.coordinates.wcs import TanWcs as JTanWcs
    from auromat_tpu.mapping.spacecraft import \
        resolve_camera_position as jresolve
    from auromat_tpu.ops.georef import GeorefParams as JParams
    from auromat_tpu.ops.georef import georeference_points as jpoints

    header = check_headers()[name]
    jheader = jfits.FitsHeader(header)
    assert spacecraft.is_consistent(header, device="cpu") == \
        jspacecraft.is_consistent(jheader) == expected
    hits = spacecraft.intersects_earth(header, device="cpu")
    assert hits == jspacecraft.intersects_earth(jheader) == \
        (name != "all-sky")
    # the latitudes both decide on, at the emission altitude
    lat, (px, py) = spacecraft._latitudes(header, 110.0, "cpu")
    ours = lat(px, py)
    pos, t, _ = jresolve(jheader)
    want = np.asarray(jpoints(JParams.from_wcs(JTanWcs(jheader), pos, t,
                                               110.0), px, py)[0])
    assert ours.dtype == np.float64 and ours.shape == (32, 32)
    assert np.array_equal(np.isnan(ours), np.isnan(want))
    ok = ~np.isnan(want)
    if ok.any():
        assert np.abs(ours[ok] - want[ok]).max() < 1e-9


def test_is_consistent_rejects_stars_on_the_earth():
    h = check_headers()["ISS030"]
    sky, ground = [[2128.0, 10.0]], [[2128.0, 2800.0]]
    for stars, want in ((sky, True), (ground, False), (sky + ground, False)):
        assert spacecraft.is_consistent(h, star_px_coords=stars,
                                        device="cpu") == want
        assert jspacecraft.is_consistent(jfits.FitsHeader(h),
                                         star_px_coords=stars) == want
