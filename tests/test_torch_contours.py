"""The star-field mask's contour stage in ``auromat_tpu_torch.solving.
masking`` on the CPU: the plain versions of the kernels CCL8 / CCL4
(``_ccl_plain``) and CONTOUR_TRACE (``_contour_trace_plain``), and the
route the card takes (``external_contours`` -> ``_label_mask``) computed
from them.

* ``_ccl_plain`` (8 and 4, set and unset pixels) equals a brute-force
  flood fill on seeded small frames, each pixel labelled with its
  component's first pixel in raster order.
* ``external_contours`` (CCL4 of the unset pixels, the hole fill, CCL8,
  the trace) equals ``cv2.findContours(RETR_EXTERNAL,
  CHAIN_APPROX_SIMPLE)`` with ``contourArea`` and ``boundingRect``, and
  the JAX package's ``categorize_contours``: the same contours, points in
  order, areas, boxes, in cv2's order reversed (ascending starts); the
  fill equals ``scipy.ndimage.binary_fill_holes``. On chip_smoke.py's
  stress frames (``contour_stress_frame``: nested rings, one-pixel
  pinches, diagonal-only chains, edges and corners, single pixels, a
  full-frame component, random noise, a spiral of ~77,000 border steps).
* Painting the hole-filled labels of the big contours equals
  ``_fill_polys`` of their points, pixel for pixel, on every stress frame
  and on ISS030's and ISS029's first binarizations; ``_label_mask`` (the
  card's route) equals ``_contour_mask`` of ``_big_contours`` (the CPU's).
* The checked-in binaries (tests/resources/contour_input_*.npz) equal
  ``_binarize`` of the JPEGs at each fudge ``mask_starfield`` reaches.
"""

import os
import sys
from collections import deque

import cv2
import numpy as np
import pytest
import torch
from scipy import ndimage

from auromat_tpu.solving import masking as jmasking
from auromat_tpu_torch.io.image import load_image
from auromat_tpu_torch.solving import masking

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "tests", "resources")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (numpy-only helpers: the seeded frames)


def _flood_roots(img, connectivity, fg):
    """Each pixel of the chosen value labelled with the smallest flat index
    of its component, by breadth-first flood fill from each pixel in
    raster order."""
    h, w = img.shape
    on = (img != 0) == fg
    out = np.full((h, w), -1, dtype=np.int64)
    steps = [(0, 1), (1, 0), (0, -1), (-1, 0)]
    if connectivity == 8:
        steps += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    for y in range(h):
        for x in range(w):
            if not on[y, x] or out[y, x] >= 0:
                continue
            root = y * w + x
            out[y, x] = root
            todo = deque([(y, x)])
            while todo:
                cy, cx = todo.popleft()
                for dy, dx in steps:
                    ny, nx = cy + dy, cx + dx
                    if 0 <= ny < h and 0 <= nx < w and on[ny, nx] and \
                            out[ny, nx] < 0:
                        out[ny, nx] = root
                        todo.append((ny, nx))
    return out


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("fg", [True, False])
def test_ccl_plain_matches_flood_fill(connectivity, fg):
    rng = np.random.default_rng(7)
    frames = [(rng.random((37, 53)) < p).astype(np.uint8) * 255
              for p in (0.2, 0.45, 0.6, 0.8)]
    frames += [chip_smoke.contour_stress_frame(np, n)[:48, :64]
               for n in ("rings", "diagonals", "edges")]
    frames += [np.zeros((5, 7), np.uint8), np.full((1, 9), 255, np.uint8)]
    for img in frames:
        got = masking._ccl_plain(img, connectivity, fg)
        assert got.dtype == np.int32
        assert np.array_equal(got, _flood_roots(img, connectivity, fg))
        assert torch.equal(masking.ccl(torch.from_numpy(img), connectivity,
                                       fg), torch.from_numpy(got))


def _cv2_external(binary):
    padded = np.zeros((binary.shape[0] + 2, binary.shape[1] + 2), np.uint8)
    padded[1:-1, 1:-1] = binary
    cs, _ = cv2.findContours(padded, cv2.RETR_EXTERNAL,
                             cv2.CHAIN_APPROX_SIMPLE)
    return [c.reshape(-1, 2) - 1 for c in cs]


def _held_against_cv2(img):
    """external_contours of ``img`` on the CPU against cv2 and the JAX
    package's categorize_contours; returns (roots, labels, borders,
    cv2's contours in ascending order of their starts)."""
    h, w = img.shape
    t = torch.from_numpy(img)
    filled = masking._fill_holes(t, masking.ccl(t, 4, fg=False))
    assert np.array_equal(filled.numpy(), ndimage.binary_fill_holes(img != 0))
    roots, labels, b = masking.external_contours(t, points=True)
    want = _cv2_external(img)[::-1]
    jc, ja, jbig, _, _ = jmasking.categorize_contours(img)
    assert len(roots) == len(want) == len(jc)
    off = np.concatenate([[0], np.cumsum(b.count.numpy())])
    assert b.points.shape == (off[-1], 2) and b.points.dtype == torch.int32
    for k, (c, jcont) in enumerate(zip(want, jc[::-1])):
        assert np.array_equal(b.points[off[k]:off[k + 1]].numpy(), c)
        assert np.array_equal(jcont.reshape(-1, 2), c)
        assert roots[k].item() == c[0, 1] * w + c[0, 0]
        assert b.area2[k].item() == 2 * cv2.contourArea(c.astype(np.int32))
        assert tuple(b.box[k].tolist()) == cv2.boundingRect(c.astype(np.int32))
        assert b.length[k].item() >= b.count[k].item() == len(c)
    assert np.array_equal(b.area2.numpy(), 2 * ja[::-1])
    big = int(0.000013 * h * w)
    assert np.array_equal((b.area2 > 2 * big).numpy(), jbig[::-1])
    assert labels[tuple(roots // w), tuple(roots % w)].tolist() == \
        roots.tolist()
    return roots, labels, b, want


@pytest.mark.parametrize("name", chip_smoke.CONTOUR_STRESS)
def test_external_contours_match_cv2_on_stress_frames(name):
    img = chip_smoke.contour_stress_frame(np, name)
    assert img.shape == (240, 320) and img.dtype == np.uint8
    roots, _, b, _ = _held_against_cv2(img)
    if name == "spiral":  # a border of tens of thousands of steps
        assert len(roots) == 1 and b.length[0].item() > 70000
    if name == "full":
        assert len(roots) == 1 and tuple(b.box[0].tolist()) == (0, 0, 320, 240)


def test_external_contours_small_cases():
    for img in (np.zeros((4, 6), np.uint8), np.full((1, 1), 255, np.uint8),
                np.full((3, 5), 255, np.uint8)):
        _held_against_cv2(img)
    corners = np.zeros((6, 9), np.uint8)
    corners[[0, 0, 5, 5], [0, 8, 0, 8]] = 255
    roots, _, b, _ = _held_against_cv2(corners)
    assert roots.tolist() == [0, 8, 45, 53] and b.count.tolist() == [1] * 4


def test_contour_stage_checks_its_input():
    img = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        masking.external_contours(img.float())
    with pytest.raises(ValueError, match="cpu or cuda"):
        masking.ccl(img.to("meta"), 8)
    with pytest.raises(ValueError, match="connectivity"):
        masking.ccl(img, 6)
    with pytest.raises(ValueError, match="connectivity"):
        masking._ccl_plain(img.numpy(), 6)


def _painted_and_filled(img, roots, labels, b, contours, ratio):
    """(the big contours' hole-filled labels painted, _fill_polys of their
    points) as bool arrays."""
    h, w = img.shape
    big = (b.area2 > 2 * int(ratio * h * w)).numpy()
    flag = torch.zeros(h * w + 1, dtype=torch.bool)
    flag[roots[torch.from_numpy(big)]] = True
    painted = flag[torch.where(labels >= 0, labels, h * w).long()]
    filled = masking._fill_polys((h, w), [contours[k] for k in
                                          np.flatnonzero(big)], "cpu")
    return painted.numpy(), filled.numpy(), int(big.sum())


def _label_mask_held(img, contours_t, ratio, blacken):
    c, a, is_big = masking._big_contours(img, ratio)
    want = masking._contour_mask(img.shape, c, a, is_big, blacken, "cpu")
    got = masking._label_mask(img.shape, contours_t, blacken, ratio)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", chip_smoke.CONTOUR_STRESS)
def test_label_paint_equals_fill_polys_on_stress_frames(name):
    img = chip_smoke.contour_stress_frame(np, name)
    roots, labels, b, want = _held_against_cv2(img)
    n_bigs = []
    for ratio in (0.000013, 0.0005):
        painted, filled, n_big = _painted_and_filled(img, roots, labels, b,
                                                     want, ratio)
        n_bigs.append(n_big)
        assert np.array_equal(painted, filled)
        cv = np.zeros(img.shape, np.uint8)
        big = (b.area2 > 2 * int(ratio * img.size)).numpy()
        cv2.fillPoly(cv, [want[k].astype(np.int32)
                          for k in np.flatnonzero(big)], 255)
        assert np.array_equal(filled, cv != 0)
        for blacken in (True, False):
            _label_mask_held(img, (roots, labels, b), ratio, blacken)
    assert n_bigs[0] >= 1


@pytest.fixture(scope="module")
def frame_binaries():
    """{(frame, fudge): binary} of the checked-in contour inputs."""
    return {(name, f): img for name in chip_smoke.CONTOUR_FUDGES
            for f, img in chip_smoke.contour_input(np, name).items()}


@pytest.mark.parametrize("key", [("ISS030-E-102170_dc", 20),
                                 ("ISS029-E-8492", 20)])
def test_label_paint_equals_fill_polys_on_the_frames(frame_binaries, key):
    img = frame_binaries[key]
    roots, labels, b = masking.external_contours(torch.from_numpy(img),
                                                 points=True)
    off = np.concatenate([[0], np.cumsum(b.count.numpy())])
    pts = b.points.numpy()
    contours = [pts[off[k]:off[k + 1]] for k in range(len(roots))]
    painted, filled, n_big = _painted_and_filled(img, roots, labels, b,
                                                 contours, 0.000013)
    assert n_big == {"ISS030-E-102170_dc": 83, "ISS029-E-8492": 128}[key[0]]
    assert np.array_equal(painted, filled)
    _label_mask_held(img, (roots, labels, b), 0.000013, True)


@pytest.mark.parametrize("name", sorted(chip_smoke.CONTOUR_FUDGES))
def test_contour_inputs_checked_in_match_the_jpegs(frame_binaries, name):
    rgb = np.array(load_image(os.path.join(RES, f"{name}.jpg")))
    gray = masking._gray(torch.from_numpy(rgb), None)
    fudges = []
    fudge = 20
    while True:  # _dark_area_mask's loop on the CPU
        binary = masking._binarize(gray, fudge, 150)[0].numpy()
        assert np.array_equal(binary, frame_binaries[(name, fudge)])
        fudges.append(fudge)
        c, a, is_big = masking._big_contours(binary)
        mask = masking._contour_mask(binary.shape, c, a, is_big, True, "cpu")
        if mask.float().mean().item() >= 0.1 or fudge > 100:
            break
        fudge += 20
    assert tuple(fudges) == chip_smoke.CONTOUR_FUDGES[name]
