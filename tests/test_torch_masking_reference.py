"""The benchmark's plain reference of star-field masking
(``benchmark/reference/masking.py``) against the port's CPU path
(``auromat_tpu_torch.solving.masking``), and against the executed
original's golden mask.

The reference is written from OpenCV's definitions and shares no code
with the port: its pieces are held against the port's on seeded inputs
(components, the line raster, the box mean, the histogram's spike, the
rectangle search, the noise sigma, the Hough transform with its
trajectory counts), and the whole ``mask_starfield`` on seeded
star-field frames at two small block-divisible sizes, three seeds each:
masks equal, sigma within 1e-9,
and the Hough counts of the port's ``masking.lines`` span equal to the
reference's. On ISS030-E-102170 at full size (the benchmark's gray plane
of the JPEG) the reference gives the golden mask to the pixel.
"""

import ast
import math
import os
import sys

import numpy as np
import pytest
import torch

from auromat_tpu_torch import profiling, utils
from auromat_tpu_torch.solving import masking

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark.reference import masking as reference  # noqa: E402

DATA = os.path.join(ROOT, "benchmark", "configs", "data")


def starfield(seed, h, w):
    """A seeded (h, w, 3) uint8 star-field frame: a dark noisy sky with
    stars, the Earth below a curved horizon, three dim struts (the Hough
    lines find them) and a bright panel in a top corner."""
    rng = np.random.default_rng(seed)
    img = rng.integers(8, 13, (h, w)).astype(np.int16)
    n = h * w // 400
    ys, xs = rng.integers(1, h - 1, n), rng.integers(1, w - 1, n)
    val = rng.integers(120, 256, n)
    for dy in (0, 1):
        for dx in (0, 1):
            img[ys + dy, xs + dx] = val
    horizon = (0.6 + 0.1 * rng.random()) * h
    earth = np.arange(h)[:, None] > horizon + 40 * ((np.arange(w) - w / 2) / w) ** 2 * h / w
    img[earth] = (110 + rng.integers(0, 40, (h, w)))[earth]
    for _ in range(3):
        x0, x1 = sorted(rng.integers(0, w, 2))
        y0, y1 = rng.integers(2, int(horizon) - 2, 2)
        if x1 - x0 < w // 2:
            x0, x1 = 0, w - 1
        t = np.linspace(0, 1, max(abs(x1 - x0), abs(y1 - y0)) + 1)
        px = np.rint(x0 + t * (x1 - x0)).astype(int)
        py = np.rint(y0 + t * (y1 - y0)).astype(int)
        img[py, px] = img[py + 1, px] = 24
    side = rng.integers(h // 10, h // 5)
    if rng.random() < 0.5:
        img[:side, :side] = 200
    else:
        img[:side, w - side:] = 200
    return np.repeat(img.astype(np.uint8)[..., None], 3, axis=2)


def _program(frame):
    """The port's mask, sigma and ``masking.lines`` counts on the CPU."""
    with profiling.recording() as window:
        mask, sigma = masking.mask_starfield(frame, device="cpu")
    lines = [s for s in window.spans() if s.name == "masking.lines"]
    return mask, sigma, lines[-1].counts


def test_reference_imports_nothing_of_the_program_opencv_or_scipy():
    tree = ast.parse(open(reference.__file__).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    tops = {n.split(".")[0] for n in names if n}
    assert tops <= {"math", "dataclasses", "numpy", "torch"}, tops


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_components_match_the_ports_labels(connectivity, seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        h, w = rng.integers(1, 70, 2)
        on = rng.random((h, w)) < rng.random()
        got = reference.components(torch.from_numpy(on), connectivity).numpy()
        want = masking._ccl_plain(on.astype(np.uint8), connectivity)
        assert np.array_equal(got, want), (h, w)


def test_fill_holes_and_borders_match_the_ports_contours():
    frame = starfield(5, 264, 352)
    g = reference.gray(torch.from_numpy(frame))
    for thr in (20, 60, 150):
        binary = g > thr
        roots, labels, borders = masking.external_contours(binary.to(torch.uint8))
        filled = reference.fill_holes(binary)
        assert torch.equal(reference.components(filled, 8), labels.long())
        h, w = binary.shape
        img = np.pad(filled.numpy(), 1).astype(np.uint8).tobytes()
        for r, a2 in zip(roots.tolist(), borders.area2.tolist()):
            start = (r // w + 1) * (w + 2) + r % w + 1
            pts = reference.outer_border(img, w + 2, start)
            assert reference.area2(pts, w + 2) == a2


def test_line_points_match_the_ports_raster():
    rng = np.random.default_rng(7)
    for _ in range(300):
        x0, y0, x1, y1 = rng.integers(0, 60, 4).tolist()
        xs, ys = utils.line_pixels(x0, y0, x1, y1)
        assert reference.line_points(x0, y0, x1, y1) == list(zip(xs.tolist(), ys.tolist()))


def test_box_mean_spike_and_rectangle_match_the_port():
    rng = np.random.default_rng(11)
    for k in (3, 89):
        img = torch.from_numpy(rng.integers(0, 256, (97, 131), dtype=np.uint8))
        assert torch.equal(reference.box_mean(img, k), masking._box_blur(img, k))
    for _ in range(5):
        g = torch.from_numpy(np.clip(rng.normal(40, 15, (60, 80)), 0, 255).astype(np.uint8))
        assert reference.first_spike(g) == masking._binarize(g, 20, 150)[3]
    for _ in range(200):
        grid = rng.random((12, 16)) < rng.choice([0.5, 0.8, 0.95])
        if grid.any():
            assert reference.largest_rectangle(grid) == tuple(masking._max_size_rectangle(grid))


def test_noise_sigma_of_a_tensor_is_the_arrays_to_the_bit():
    # mask_starfield estimates sigma on the gray where it lies (a tensor)
    from auromat_tpu_torch.solving.noise import estimate_noise_level

    rng = np.random.default_rng(3)
    for shape in ((5, 7), (236, 266), (708, 1064)):
        g = rng.integers(0, 256, shape, dtype=np.uint8)
        want = estimate_noise_level(g)
        assert estimate_noise_level(torch.from_numpy(g)) == want
        assert reference.noise_sigma(g) == pytest.approx(want, rel=1e-15)


@pytest.mark.parametrize("seed", [0, 1])
def test_hough_lines_match_the_ports_plain_transform(seed):
    frame = starfield(40 + seed, 264, 352)
    g = masking._gray(torch.from_numpy(frame), None)
    mask, _ = masking._dark_area_mask(g, True)
    binary = masking._line_candidates(g * mask, mask).numpy()
    counts = {}
    want = masking._hough_p_plain(binary, 1, math.pi / 180, 120, 60, 4, counts)
    lines, got, numangle = reference.hough_lines(binary != 0, 1, math.pi / 180, 120, 60, 4)
    assert numangle == 180 and len(want) > 0
    assert np.array_equal(lines, want) and got == counts


@pytest.mark.parametrize("h,w", [(264, 352), (528, 704)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_the_ports_mask_starfield(seed, h, w):
    frame = starfield(seed, h, w)
    mask, sigma, counts = _program(frame)
    ref = reference.mask_starfield(frame, "cpu")
    assert np.array_equal(mask, ref.mask)
    assert 0.0 < mask.mean() < 1.0
    assert sigma == pytest.approx(ref.sigma, rel=1e-9)
    assert counts == ref.counts and ref.counts["lines"] > 0


def test_reference_gives_the_golden_mask_of_a_real_frame():
    name = "ISS030-E-102170_dc"
    gray = np.load(os.path.join(DATA, f"{name}_gray.npz"))["gray"]
    golden = np.load(os.path.join(DATA, f"golden_masking_{name}.npz"))
    ref = reference.mask_starfield(np.repeat(gray[..., None], 3, axis=2), "cpu")
    assert int((ref.mask != golden["mask"]).sum()) == 0
    assert ref.sigma == pytest.approx(float(golden["sigma"]), rel=1e-12)
    # the port's trajectory counts of this frame's Hough input
    assert ref.counts == {"voters": 128458, "triggers": 26055, "clear_steps": 426214,
                          "lines": 182}
