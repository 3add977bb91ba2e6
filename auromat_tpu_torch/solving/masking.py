"""Automatic star-field masking for astrometric solving.

Isolates the star sky from Earth/spacecraft structures so astrometry.net
only sees stars. Same pipeline as the reference (auromat/solving/
masking.py:209-417), reimplemented around OpenCV + numpy block views:

1. binarize using the histogram's first spike + fudge (the starfield
   background is the darkest part of the image),
2. categorize contours (big / small-long / small-short); big contours are
   spacecraft/Earth, mask their 16x12 blocks; optionally blacken the lower
   part of the image from the biggest contour downwards,
3. masked adaptive threshold + probabilistic Hough lines to catch thin
   structures; mask blocks containing lines,
4. optionally mask blocks that are almost totally black (dark structures),
5. remove lonely starfield blocks,
6. estimate the noise sigma from the largest remaining starfield rectangle
   (Immerkaer).

Counterpart of ``auromat_tpu.solving.masking``: the same numpy and OpenCV
calls, cv2 imported inside each function that needs it (the card's
machine has no cv2, so ``mask_starfield`` runs only where it is
installed). An RGB array is turned into BGR by reversing its channels in
numpy, which is what ``cv2.cvtColor(RGB2BGR)`` does to uint8, so
``mask_starfield_rect`` on an array needs no cv2.
"""

import math
import os

import numpy as np

from auromat_tpu_torch.solving.noise import estimate_noise_level


def view_as_blocks(arr, block_shape):
    """(h, w) -> (h//bh, w//bw, bh, bw) writable block view."""
    bh, bw = block_shape
    h, w = arr.shape[:2]
    assert h % bh == 0 and w % bw == 0, (arr.shape, block_shape)
    return arr.reshape(h // bh, bh, w // bw, bw, *arr.shape[2:]).swapaxes(1, 2)


def _block_shape(shape):
    """Roughly square 16x12 block grid (reference masking.py:128-143)."""
    blocks_x, blocks_y = 16, 12
    if shape[0] % blocks_y != 0:
        blocks_y = 8
    if shape[0] % blocks_y != 0 or shape[1] % blocks_x != 0:
        raise ValueError(
            f"image of shape {shape} not divisible into {blocks_x}x{blocks_y} blocks"
        )
    return shape[0] // blocks_y, shape[1] // blocks_x


def binarize_starfield(imgray, fudge=20, max_threshold=150):
    """Threshold = histogram first spike + fudge.

    :returns: (binary, hist, threshold, first_spike)
    """
    import cv2 as cv

    hist = cv.calcHist([imgray], [0], None, [256], [0, 255]).reshape(256)
    hist[1:-1] = (hist[:-2] + hist[1:-1] + hist[2:]) / 3  # light smoothing
    hist_diff = hist[1:] - hist[:-1]
    first_spike = int(np.argmax(hist_diff < 0))
    threshold = min(first_spike + fudge, max_threshold)
    _, binary = cv.threshold(imgray, threshold, 255, cv.THRESH_BINARY)
    return binary, hist, threshold, first_spike


def categorize_contours(binary, big_area_ratio=0.000013, long_ratio=5.0):
    """:returns: (contours, areas, is_big, is_small_long, is_small_short)"""
    import cv2 as cv

    padded = np.zeros((binary.shape[0] + 2, binary.shape[1] + 2), dtype=np.uint8)
    padded[1:-1, 1:-1] = binary
    contours, _ = cv.findContours(padded, cv.RETR_EXTERNAL, cv.CHAIN_APPROX_SIMPLE)
    contours = [c - 1 for c in contours]
    if not contours:
        z = np.zeros(0, dtype=bool)
        return contours, np.zeros(0), z, z, z
    areas = np.array([cv.contourArea(c) for c in contours])
    rect_axes = np.array([cv.minAreaRect(c)[1] for c in contours])
    big_area = big_area_ratio * binary.shape[0] * binary.shape[1]
    is_big = areas > int(big_area)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = rect_axes[:, 0] / rect_axes[:, 1]
    with np.errstate(invalid="ignore"):
        is_long = (areas > 20) & ((ratio > long_ratio) | (ratio < 1 / long_ratio))
    is_small = ~is_big
    return contours, areas, is_big, is_small & is_long, is_small & ~is_long


def _mask_from_contours(shape, contours, areas, offending, blacken_lower_part):
    import cv2 as cv

    mask = np.ones(shape, dtype=bool)
    bh, bw = _block_shape(shape)

    if blacken_lower_part and len(contours):
        # if the biggest contour sits in the lower part it is likely Earth:
        # blacken from its top edge down (else from mid-image)
        biggest = contours[int(np.argmax(areas))]
        _, y, _, h = cv.boundingRect(biggest)
        from_y = y if (y > shape[0] / 3 and y + h > shape[0] / 2) else shape[0] // 2
        from_block = int(math.ceil(from_y / bh) * bh)
        mask[from_block:] = False

    if np.any(offending):
        filled = np.zeros(shape, dtype=np.uint8)
        cv.fillPoly(filled, [contours[i] for i in np.flatnonzero(offending)], 255)
        bad_blocks = (view_as_blocks(filled, (bh, bw)) == 255).any(axis=(-1, -2))
        bv = view_as_blocks(mask, (bh, bw))
        bv[bad_blocks] = False
    return mask


def masked_adaptive_threshold(image, mask, max_value, size, c):
    """Adaptive threshold restricted to unmasked pixels (image must be black
    under the mask). Reference masking.py:192-207."""
    import cv2 as cv

    m8 = mask.astype(np.uint8) * 255
    conv = cv.blur(image, (size, size)).astype(float)
    neighbours = cv.blur(m8, (size, size)).astype(float)
    with np.errstate(invalid="ignore"):
        diff = image - 255 * (conv / neighbours)
    binary = np.zeros_like(image, dtype=np.uint8)
    binary[(diff > -c) & mask] = max_value
    return binary


def _max_size_rectangle(mat):
    """(row, col), (height, width) of the largest all-True rectangle."""
    rows, cols = mat.shape
    heights = np.zeros(cols, dtype=int)
    best = (0, (0, 0), (0, 0))
    for r in range(rows):
        heights = np.where(mat[r], heights + 1, 0)
        stack = []
        for c in range(cols + 1):
            h = heights[c] if c < cols else 0
            start = c
            while stack and stack[-1][1] >= h:
                s, sh = stack.pop()
                area = sh * (c - s)
                if area > best[0]:
                    best = (area, (r - sh + 1, s), (sh, c - s))
                start = s
            stack.append((start, h))
    _, pos, size = best
    return pos, size


def mask_starfield_rect(image, top_left, bottom_right):
    """Manual rectangular mask (reference masking.py:43-66).

    :returns: (mask, sigma)
    """
    im = _load_bgr(image)
    h, w = im.shape[:2]
    x1, y1 = top_left
    x2, y2 = bottom_right
    mask = np.zeros((h, w), dtype=bool)
    mask[y1 : y2 + 1, x1 : x2 + 1] = True
    sigma = _scale_sigma(estimate_noise_level(im[y1 : y2 + 1, x1 : x2 + 1, 0]))
    return mask, sigma


def _scale_sigma(sigma):
    # astrometry.net tends to estimate higher sigmas (reference masking.py:412)
    return max(0.9, sigma * 2.5)


def _load_bgr(image):
    if isinstance(image, np.ndarray):
        image = np.require(image, np.uint8)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected an (h, w, 3) RGB image, got shape "
                             f"{image.shape}")
        return np.ascontiguousarray(image[..., ::-1])
    import cv2 as cv

    im = cv.imread(image)
    if im is None:
        raise IOError(f"cannot read image {image}")
    return im


def mask_starfield(image, channel=None, blacken_lower_part=True,
                   ignore_very_dark=True):
    """Automatically mask the star-sky region of an image.

    :param image: path or (h, w, 3) RGB uint8 array
    :param channel: 'R', 'G', 'B' or None (grayscale combine)
    :returns: (mask (h, w) bool — True = starfield, sigma)
    """
    import cv2 as cv
    from scipy.signal import convolve2d

    im = _load_bgr(image)
    if channel is None:
        imgray = cv.cvtColor(im, cv.COLOR_BGR2GRAY)
    else:
        idx = {"r": 2, "g": 1, "b": 0}.get(str(channel).lower())
        if idx is None:
            raise ValueError(f"channel is {channel!r} but must be R,G,B or None")
        imgray = im[:, :, idx]
    imgray = np.require(imgray, np.uint8, "C")
    shape = imgray.shape

    # step 1: dark-area candidate mask, raising the threshold while the
    # starfield area stays implausibly small (reference masking.py:265-289)
    fudge = 20
    while True:
        binary, hist, threshold, first_spike = binarize_starfield(imgray, fudge)
        contours, areas, is_big, is_small_long, _ = categorize_contours(binary)
        mask = _mask_from_contours(shape, contours, areas, is_big, blacken_lower_part)
        ratio = mask.mean()
        if ratio >= 0.1 or fudge > 100:
            break
        fudge += 20

    imgray = imgray.copy()
    imgray[~mask] = 0
    bh, bw = _block_shape(shape)
    bv_mask = view_as_blocks(mask, (bh, bw))

    # step 2a: Hough lines over a masked adaptive threshold
    binary = masked_adaptive_threshold(imgray, mask, 255, 89, -1)
    binary = cv.medianBlur(binary, 3)
    lines = cv.HoughLinesP(binary.copy(), 1, math.pi / 180, 200,
                           minLineLength=100, maxLineGap=4)
    if lines is not None:
        filled = np.zeros(shape, dtype=np.uint8)
        for line in lines.reshape(-1, 4):
            cv.line(filled, (line[0], line[1]), (line[2], line[3]), 255)
        bad = (view_as_blocks(filled, (bh, bw)) == 255).any(axis=(-1, -2))
        bv_mask[bad] = False

    # step 2b: mask blocks that are essentially pure black
    if ignore_very_dark:
        cutoff = cv.blur(imgray.copy(), (3, 3))
        cutoff_threshold = max(30, first_spike + 20)
        cutoff[cutoff < cutoff_threshold] = 0
        pure_black = (view_as_blocks(cutoff, (bh, bw)) == 0).all(axis=(-1, -2))
        bv_mask[pure_black] = False

    # step 3: drop starfield blocks with no starfield neighbours
    is_star_block = bv_mask.all(axis=(-1, -2))
    kernel = np.ones((3, 3), dtype=int)
    kernel[1, 1] = 0
    neighbours = convolve2d(is_star_block.astype(int), kernel, mode="same")
    bv_mask[is_star_block & (neighbours == 0)] = False

    # noise sigma from the largest remaining starfield rectangle
    is_star_block = bv_mask.all(axis=(-1, -2))
    if is_star_block.any():
        (ry, rx), (rh, rw) = _max_size_rectangle(is_star_block)
        rect = imgray[ry * bh : (ry + rh) * bh, rx * bw : (rx + rw) * bw]
        sigma = _scale_sigma(estimate_noise_level(rect))
    else:
        sigma = _scale_sigma(estimate_noise_level(imgray))
    return mask, sigma
