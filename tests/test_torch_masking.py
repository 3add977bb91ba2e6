"""The port's star-field masking (``auromat_tpu_torch.solving.masking``)
without OpenCV, on the CPU: each stage against the cv2 call the JAX
package makes, and the whole against the JAX package and the executed
reference's goldens.

* The pixel stages (torch on the CPU): the gray conversion, ``calcHist``
  and the threshold, ``blur`` 89 and 3, ``medianBlur(3)``, the masked
  adaptive threshold on both checked-in frames, pixel-equal to cv2.
* The host geometry (``utils``): ``findContours(RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)`` contours in cv2's order, ``contourArea``,
  ``boundingRect``, ``fillPoly`` and ``line`` pixels, ``minAreaRect``'s
  side lengths (1e-4 relative: the same sides up to their order, where the
  least area is not tied; the long/short booleans wherever the ratio is
  not 5 within 1e-4), and the
  labelled subset of contours that ``mask_starfield`` traces.
* ``_hough_p_plain`` (the plain version of the ``HOUGH_P`` kernel) equal
  to ``cv2.HoughLinesP`` line for line, in order, on chip_smoke.py's
  seeded 240x320 frames at thresholds 200 and 60, on its stress frames
  (``hough_stress_frame``) and on both checked-in frames' Hough inputs;
  its trajectory counters on those inputs (checked in as
  tests/resources/hough_input_*.npz, equal to what the stages compute
  from the JPEGs).
* The visit order the order kernel's way (``_hough_draws`` by jump-ahead,
  ``_hough_order_chains``) equal to OpenCV's loop (``_hough_order``).
* ``mask_starfield(device="cpu")`` with cv2 unimportable on both frames:
  0 pixels from golden_masking_*.npz, equal to the JAX package's mask,
  the same sigma; and on chip_smoke.py's seeded 4256x2832 star-field
  frame (contours and Hough lines both fire there), equal to JAX's.
"""

import math
import os
import re
import sys

import cv2
import numpy as np
import pytest
import torch

from auromat_tpu.solving import masking as jmasking
from auromat_tpu_torch import utils
from auromat_tpu_torch.io.image import load_image
from auromat_tpu_torch.solving import masking

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "tests", "resources")
FRAMES = ("ISS030-E-102170_dc", "ISS029-E-8492")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (numpy-only helpers: the seeded frames)


def t(a):
    return torch.from_numpy(np.array(a))


def bgr(rgb):
    return np.ascontiguousarray(rgb[..., ::-1])


@pytest.fixture(scope="module")
def stages():
    """{frame: (rgb, gray, step-1 binary, step-1 mask, Hough input)} from
    the port's stages on the CPU, each checked against cv2's on the way."""
    out = {}
    for name in FRAMES:
        rgb = load_image(os.path.join(RES, f"{name}.jpg"))
        gray = masking._gray(t(rgb), None)
        assert np.array_equal(gray.numpy(),
                              cv2.cvtColor(bgr(rgb), cv2.COLOR_BGR2GRAY))
        fudge = 20
        while True:
            binary, _, _, _ = masking._binarize(gray, fudge, 150)
            c, a, big = masking._big_contours(binary.numpy())
            mask = masking._contour_mask(gray.shape, c, a, big, True, "cpu")
            jc, ja, jbig, _, _ = jmasking.categorize_contours(binary.numpy())
            assert np.array_equal(mask.numpy(), jmasking._mask_from_contours(
                gray.shape, jc, ja, jbig, True))
            if mask.float().mean().item() >= 0.1 or fudge > 100:
                break
            fudge += 20
        g = gray * mask
        adaptive = masking._adaptive_threshold(g, mask, 255, 89, -1)
        jadaptive = jmasking.masked_adaptive_threshold(g.numpy(), mask.numpy(),
                                                       255, 89, -1)
        assert np.array_equal(adaptive.numpy(), jadaptive)
        hin = masking._median3_binary(adaptive).numpy()
        assert np.array_equal(hin, cv2.medianBlur(jadaptive, 3))
        out[name] = (rgb, gray.numpy(), binary.numpy(), mask.numpy(), hin)
    return out


def test_gray_and_histogram_match_cv2(stages):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    assert np.array_equal(masking._gray(t(rgb), None).numpy(),
                          cv2.cvtColor(bgr(rgb), cv2.COLOR_BGR2GRAY))
    for ch, i in (("R", 2), ("g", 1), ("B", 0)):
        assert np.array_equal(masking._gray(t(rgb), ch).numpy(), bgr(rgb)[..., i])
    with pytest.raises(ValueError, match="channel"):
        masking._gray(t(rgb), "X")
    for gray in [rgb[..., 0].copy()] + [s[1] for s in stages.values()]:
        hist = torch.bincount(t(gray).reshape(-1).long(), minlength=256)
        want = cv2.calcHist([gray], [0], None, [256], [0, 255]).reshape(256)
        assert np.array_equal(np.where(np.arange(256) < 255, hist.numpy(), 0),
                              want)
        for fudge in (20, 60):
            ours = masking.binarize_starfield(gray, fudge)
            theirs = jmasking.binarize_starfield(gray, fudge)
            for a, b in zip(ours, theirs):
                assert np.array_equal(a, b)
        assert torch.equal(masking.binarize_starfield(t(gray))[0],
                           t(jmasking.binarize_starfield(gray)[0]))


@pytest.mark.parametrize("k", [89, 3])
def test_box_blur_matches_cv2(stages, k):
    rng = np.random.default_rng(k)
    images = [rng.integers(0, 256, (97, 131), dtype=np.uint8),
              (rng.random((240, 320)) < 0.3).astype(np.uint8) * 255,
              stages[FRAMES[0]][1]]
    for img in images:
        assert np.array_equal(masking._box_blur(t(img), k).numpy(),
                              cv2.blur(img, (k, k)))


def test_median_matches_cv2():
    rng = np.random.default_rng(1)
    for p in (0.2, 0.5, 0.8):
        img = (rng.random((61, 83)) < p).astype(np.uint8) * 255
        assert np.array_equal(masking._median3_binary(t(img)).numpy(),
                              cv2.medianBlur(img, 3))


def test_masked_adaptive_threshold_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 40, (120, 160), dtype=np.uint8)
    mask = rng.random((120, 160)) < 0.7
    img[~mask] = 0
    got = masking.masked_adaptive_threshold(img, mask, 255, 89, -1)
    assert np.array_equal(got, jmasking.masked_adaptive_threshold(
        img, mask, 255, 89, -1))
    assert torch.equal(masking.masked_adaptive_threshold(
        t(img), t(mask), 255, 89, -1), t(got))


def _cv2_contours(binary):
    padded = np.zeros((binary.shape[0] + 2, binary.shape[1] + 2), np.uint8)
    padded[1:-1, 1:-1] = binary
    cs, _ = cv2.findContours(padded, cv2.RETR_EXTERNAL,
                             cv2.CHAIN_APPROX_SIMPLE)
    return [c.reshape(-1, 2) - 1 for c in cs]


@pytest.fixture(scope="module")
def binaries(stages):
    """Binaries with many contours: a seeded blob field, ISS030's first
    step at fudge 20 and 40, ISS029's at fudge 20 (2027 contours) and, for
    the traced subset only, at 60 (48180 contours)."""
    rng = np.random.default_rng(3)
    blobs = cv2.medianBlur((rng.random((240, 320)) < 0.45).astype(np.uint8)
                           * 255, 3)
    g30, g29 = stages[FRAMES[0]][1], stages[FRAMES[1]][1]
    return [blobs] + [masking.binarize_starfield(g, f)[0]
                      for g, f in ((g30, 20), (g30, 40), (g29, 20), (g29, 60))]


def test_contours_match_cv2(binaries):
    for binary in binaries[:4]:
        ours = masking.categorize_contours(binary)
        want = _cv2_contours(binary)
        assert len(ours[0]) == len(want) > 0
        for c, w in zip(ours[0], want):
            assert np.array_equal(c, w)
        areas = np.array([cv2.contourArea(c.astype(np.int32)) for c in want])
        assert np.array_equal(ours[1], areas)
        for c in want:
            assert utils.bounding_rect(c) == cv2.boundingRect(
                c.astype(np.int32))
        theirs = jmasking.categorize_contours(binary)
        for a, b in zip(ours[2:], theirs[2:]):  # big, small-long, small-short
            assert np.array_equal(a, b)


def test_big_contours_are_cv2s(binaries):
    """The traced subset: every big contour and every one that could be the
    biggest, in cv2's order, with cv2's points and areas."""
    for binary in binaries:
        want = _cv2_contours(binary)
        at = {tuple(c[0]): i for i, c in enumerate(want)}  # by start point
        areas = np.array([cv2.contourArea(c.astype(np.int32)) for c in want])
        big = int(0.000013 * binary.size)
        contours, got_areas, is_big = masking._big_contours(binary)
        order = [at[tuple(c[0])] for c in contours]
        assert order == sorted(order)  # cv2's order
        for i, c, a in zip(order, contours, got_areas):
            assert np.array_equal(c, want[i]) and a == areas[i]
        assert set(np.flatnonzero((areas > big) | (areas == areas.max()))) \
            <= set(order)
        assert np.array_equal(is_big, got_areas > big)
        assert order[int(np.argmax(got_areas))] == int(np.argmax(areas))


def test_fill_poly_matches_cv2(binaries):
    rng = np.random.default_rng(4)
    h, w = 60, 80
    for _ in range(300):
        polys = [rng.integers(0, [w, h], (int(rng.integers(1, 9)), 2))
                 for _ in range(int(rng.integers(1, 4)))]
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [p.astype(np.int32) for p in polys], 255)
        got = masking._fill_polys((h, w), polys, "cpu").numpy()
        assert np.array_equal(got, want != 0)
    for binary in binaries[:3]:
        want_c = [c for c in _cv2_contours(binary) if len(c) > 2][:200]
        want = np.zeros(binary.shape, np.uint8)
        cv2.fillPoly(want, [c.astype(np.int32) for c in want_c], 255)
        got = masking._fill_polys(binary.shape, want_c, "cpu").numpy()
        assert np.array_equal(got, want != 0)


def test_line_matches_cv2():
    rng = np.random.default_rng(5)
    h, w = 70, 90
    segs = [rng.integers(0, [w, h, w, h]) for _ in range(500)]
    segs += [np.array([5, 5, 5, 5]), np.array([0, 0, 89, 69]),
             np.array([89, 0, 0, 69]), np.array([3, 60, 3, 1])]
    for s in segs:
        want = np.zeros((h, w), np.uint8)
        cv2.line(want, (int(s[0]), int(s[1])), (int(s[2]), int(s[3])), 255)
        got = masking._draw_lines((h, w), [s], "cpu").numpy()
        assert np.array_equal(got, want != 0), s
    want = np.zeros((h, w), np.uint8)
    for s in segs[:20]:
        cv2.line(want, (int(s[0]), int(s[1])), (int(s[2]), int(s[3])), 255)
    assert np.array_equal(masking._draw_lines((h, w), segs[:20], "cpu").numpy(),
                          want != 0)


def test_min_area_rect_axes_match_cv2(binaries):
    rng = np.random.default_rng(6)
    sets = [c for b in binaries[:3] for c in _cv2_contours(b)]
    sets += [rng.integers(0, 50, (int(rng.integers(1, 30)), 2))
             for _ in range(500)]
    n_unique = 0
    for p in sets:
        got = np.sort(utils.min_area_rect_axes(p))
        want = np.sort(cv2.minAreaRect(p.astype(np.int32))[1])
        # the same long/short classification as categorize_contours',
        # except at a ratio of 5 within 1e-4, where cv2's float32 rounding
        # decides
        long = lambda a: bool(a[1] > 5 * a[0]) if a[0] > 0 else a[1] > 0
        if abs(got[1] - 5 * got[0]) > 1e-4 * got[1]:
            assert long(got) == long(want), p.tolist()
        assert got[0] * got[1] <= want[0] * want[1] * (1 + 1e-4) + 1e-4
        # where the least area is not tied, the same sides
        if abs(got[0] * got[1] - want[0] * want[1]) <= 1e-4 * max(
                1.0, want[0] * want[1]) and _unique_min(p):
            n_unique += 1
            assert np.allclose(got, want, rtol=1e-4, atol=1e-4), p.tolist()
    assert n_unique > len(sets) // 2


def _unique_min(p):
    """Whether one hull-edge orientation alone gives the least area."""
    h = utils._hull_int(p).astype(np.float64)
    if len(h) < 3:
        return True
    e = np.roll(h, -1, axis=0) - h
    u = e / np.hypot(e[:, 0], e[:, 1])[:, None]
    al, ac = h @ u.T, h @ np.stack([-u[:, 1], u[:, 0]], 1).T
    areas = (al.max(0) - al.min(0)) * (ac.max(0) - ac.min(0))
    near = np.abs(areas - areas.min()) <= 1e-6 * max(1.0, areas.min())
    dirs = np.round(np.degrees(np.arctan2(u[near, 1], u[near, 0])) % 90, 6)
    return len(np.unique(dirs)) == 1


def _cv2_lines(img, thr, length):
    lines = cv2.HoughLinesP(img.copy(), 1, math.pi / 180, thr,
                            minLineLength=length, maxLineGap=4)
    return np.zeros((0, 4), np.int32) if lines is None else lines.reshape(-1, 4)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("thr,length", [(200, 100), (60, 30)])
def test_hough_plain_matches_cv2(seed, thr, length):
    img = chip_smoke.hough_frame(np, seed)
    want = _cv2_lines(img, thr, length)
    got = masking._hough_p_plain(img, 1, math.pi / 180, thr, length, 4)
    assert len(want) > 0 and got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(masking.hough_lines_p(t(img), 1, math.pi / 180, thr,
                                                length, 4), want)


@pytest.mark.parametrize("name", FRAMES)
def test_hough_plain_matches_cv2_on_the_frames(stages, name):
    hin = stages[name][4]
    want = _cv2_lines(hin, 200, 100)
    got = masking._hough_p_plain(hin, 1, math.pi / 180, 200, 100, 4)
    assert len(want) > 0 and np.array_equal(got, want)


def test_hough_order_and_setup():
    # OpenCV's RNG(2^64-1).uniform(0, n) sequence, drawn by hand
    state, m32, order, perm = (1 << 64) - 1, 0xFFFFFFFF, [], list(range(5))
    for c in range(5, 0, -1):
        state = (state & m32) * 4164903690 + (state >> 32)
        i = (state & m32) % c
        order.append(perm[i])
        perm[i] = perm[c - 1]
    assert masking._hough_order(5).tolist() == order
    assert sorted(masking._hough_order(1000).tolist()) == list(range(1000))
    numangle, numrho, c, s = masking._hough_setup((2832, 4256), 1, math.pi / 180)
    assert (numangle, numrho) == (180, 14177)
    assert c.dtype == s.dtype == np.float32 and c[0] == 1 and s[90] == 1


@pytest.mark.parametrize("count", [0, 1, 2, 3, 5, 1000, 376447, 910556])
def test_hough_order_from_draws_and_chains(count):
    # the order kernel's two steps in numpy (jump-ahead draws, then the
    # permutation's chains) against OpenCV's loop; the two large counts
    # are the checked-in frames' candidate pixels
    draws = masking._hough_draws(count)
    assert draws.shape == (count,) and np.all(draws < count - np.arange(count))
    order = masking._hough_order_chains(draws)
    assert np.array_equal(order, masking._hough_order(count))


def test_mwc_jump_ahead_matches_the_recurrence():
    state, m32, states = (1 << 64) - 1, 0xFFFFFFFF, []
    for _ in range(3000):
        state = (state & m32) * 4164903690 + (state >> 32)
        states.append(state)
    assert [masking._mwc_state(n) for n in range(1, 3001)] == states
    assert states[0] >= masking._RNG_MOD > max(states[1:])  # only s_1 >= m
    for _ in range(3000, 10**6):
        state = (state & m32) * 4164903690 + (state >> 32)
    assert masking._mwc_state(10**6) == state


@pytest.mark.parametrize("name", sorted(chip_smoke.HOUGH_STRESS))
def test_hough_plain_matches_cv2_on_stress_frames(name):
    thr, length, gap = chip_smoke.HOUGH_STRESS[name]
    img = chip_smoke.hough_stress_frame(np, name)
    lines = cv2.HoughLinesP(img.copy(), 1, math.pi / 180, thr,
                            minLineLength=length, maxLineGap=gap)
    want = np.zeros((0, 4), np.int32) if lines is None else lines.reshape(-1, 4)
    counts = {}
    got = masking._hough_p_plain(img, 1, math.pi / 180, thr, length, gap,
                                 counts)
    assert np.array_equal(got, want)
    assert counts["lines"] == len(want) and counts["triggers"] >= len(want)
    if name == "segments":  # short segments trigger and keep no line
        assert counts["triggers"] > 1000 * max(counts["lines"], 1)
    if name == "octants":  # lines of more than 64 px in every direction
        d = want[:, 2:].astype(float) - want[:, :2]
        octant = (np.arctan2(d[:, 1], d[:, 0]) % np.pi) // (np.pi / 4)
        assert set(octant) == {0, 1, 2, 3} and np.hypot(*d.T).min() > 64


@pytest.mark.parametrize("name", FRAMES)
def test_hough_inputs_checked_in_match_the_jpegs(stages, name):
    assert np.array_equal(chip_smoke.hough_input(np, name), stages[name][4])


# visited pixels still set (voters), votes reaching the threshold
# (triggers), positions the clearing walks visit (each direction from the
# seed up to and including its end), lines kept: the counts of an
# instrumented copy of the plain version on these inputs
FRAME_COUNTS = {"ISS030-E-102170_dc": (376447, 128458, 26055, 426214, 182),
                "ISS029-E-8492": (910556, 333681, 157492, 1333125, 2)}


@pytest.mark.parametrize("name", FRAMES)
def test_hough_counters_on_the_frames(name):
    hin = chip_smoke.hough_input(np, name)
    counts = {}
    lines = masking.hough_lines_p(t(hin), 1, math.pi / 180, 200, 100, 4,
                                  counters=counts)
    assert int((hin > 0).sum()) == FRAME_COUNTS[name][0]
    assert tuple(counts[k] for k in masking.HOUGH_COUNTERS) == \
        FRAME_COUNTS[name][1:]
    assert len(lines) == counts["lines"]


def test_hough_lines_p_checks_its_input():
    img = chip_smoke.hough_frame(np, 1)
    with pytest.raises(ValueError, match="uint8"):
        masking.hough_lines_p(t(img).float(), 1, math.pi / 180, 60, 30, 4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        masking.hough_lines_p(t(img).to("meta"), 1, math.pi / 180, 60, 30, 4)


@pytest.fixture(scope="module")
def jax_masks():
    return {name: jmasking.mask_starfield(os.path.join(RES, f"{name}.jpg"))
            for name in FRAMES}


@pytest.mark.parametrize("name", FRAMES)
def test_mask_starfield_without_cv2(jax_masks, monkeypatch, name):
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now fails
    golden = np.load(os.path.join(RES, f"golden_masking_{name}.npz"))
    mask, sigma = masking.mask_starfield(os.path.join(RES, f"{name}.jpg"),
                                         device="cpu")
    jmask, jsigma = jax_masks[name]
    assert mask.dtype == bool and mask.shape == golden["mask"].shape
    assert int((mask != golden["mask"]).sum()) == 0
    assert np.array_equal(mask, jmask) and sigma == jsigma


def test_chip_smoke_starfield_frame_matches_jax(monkeypatch):
    frame = chip_smoke.starfield_frame(np)
    assert frame.shape == (2832, 4256, 3) and frame.dtype == np.uint8
    jmask, jsigma = jmasking.mask_starfield(frame)
    gray = masking._gray(t(frame), None)
    binary = masking._binarize(gray, 20, 150)[0]
    _, _, is_big = masking._big_contours(binary.numpy())
    monkeypatch.setitem(sys.modules, "cv2", None)
    mask, sigma = masking.mask_starfield(frame, device="cpu")
    assert np.array_equal(mask, jmask) and sigma == jsigma
    assert is_big.sum() >= 2 and 0.2 < mask.mean() < 0.8  # contours fire
    # and so does the Hough transform: its lines mask sky blocks
    monkeypatch.setattr(masking, "hough_lines_p",
                        lambda *a: np.zeros((0, 4), np.int32))
    no_lines, _ = masking.mask_starfield(frame, device="cpu")
    assert no_lines.sum() > mask.sum()


def test_no_opencv_in_the_port():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "auromat_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for f in files:
        with open(f) as fh:
            src = fh.read()
        assert not re.search(r"^\s*(import|from)\s+cv2\b", src, re.M), f
