"""Automatic star-field masking for astrometric solving.

Isolates the star sky from Earth/spacecraft structures so astrometry.net
only sees stars. Same pipeline as the reference (auromat/solving/
masking.py:209-417):

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

Counterpart of ``auromat_tpu.solving.masking``, which calls OpenCV; this
module needs none, and its masks are the JAX package's pixel for pixel.
The pixel stages are torch on ``device`` in OpenCV's integer arithmetic:
the gray conversion ``(9798 R + 19235 G + 3735 B + 16384) >> 15``, the
histogram of ``calcHist(.., [256], [0, 255])`` (value 255 falls outside),
the box blurs as reflect-101 sums of an int64 integral image rounded
half up (``k*k`` is odd: no ties), the 3x3 median of a 0/255 image as
"at least 5 of 9 set" with the edge replicated, the block reductions and
the rasters of lines and polygons (``utils.line_pixels``,
``utils.poly_fill_spans``) painted onto the image and reduced to blocks.

The contours are those of ``findContours(RETR_EXTERNAL)``: one external
contour for each 8-connected component of the hole-filled binary (holes
are the 4-connected zero components that touch no image edge). On a
CUDA tensor the whole contour stage runs on the card and nothing of the
binary goes to the host (``external_contours``, ``_label_mask``): CCL4
labels the zero pixels (``ops/csrc/ccl.cu``, ``ops._kernels.CCL4``), the
holes are filled with torch, CCL8 labels the filled image (each pixel
holds its component's first pixel in raster order, the contour's start),
CONTOUR_TRACE (``ops/csrc/contour_trace.cu``) follows each outer border
on the binary and measures it, and the big contours are painted as their
filled labels, which are the pixels ``fillPoly`` sets for them. On a CPU
tensor ``mask_starfield`` labels the filled binary with ``scipy.ndimage``
and traces only the labels whose bounding box could hold a big contour
(a contour's area is at most ``(w-1)(h-1)`` of its box) and those that
could be the biggest (``_big_contours``), then rasters their polygons
(``_contour_mask``); ``_ccl_plain`` and ``_contour_trace_plain`` are the
kernels' plain versions, which ``external_contours`` runs on a CPU
tensor.

The probabilistic Hough transform is ``cv2.HoughLinesP``'s algorithm:
set pixels visited in the order of OpenCV's RNG (seed 2^64-1, the visit
order fixed by the count alone), a float32 vote ``rint(x c + y s)`` per
angle (``theta`` rounded to float32 first, as OpenCV's signature does),
the first maximum, the 16-bit fixed-point walks. On a CUDA tensor
``hough_lines_p`` draws the visit order on the card
(``ops/csrc/hough_order.cu``, ``ops._kernels.HOUGH_ORDER``) and launches
the kernel ``ops/csrc/hough_p.cu`` (``ops._kernels.HOUGH_P``); on a CPU
tensor it runs ``_hough_p_plain``, the same algorithm sequentially in
numpy. Both give OpenCV's lines in OpenCV's order, and the same counts of
the trajectory (voters, triggers, clearing steps, lines).
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from auromat_tpu_torch.solving.noise import estimate_noise_level
from auromat_tpu_torch.utils import (_contour_area, _external_borders,
                                     bounding_rect, contour_approx_simple,
                                     line_pixels, min_area_rect_axes,
                                     poly_fill_spans, trace_outer_borders)


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


def _blocks_any(t, block):
    """(h, w) tensor -> (h//bh, w//bw) bool: any element of a block set."""
    bh, bw = block
    h, w = t.shape
    return t.reshape(h // bh, bh, w // bw, bw).any(dim=3).any(dim=1)


def _clear_blocks(mask, bad, block):
    """mask[block] = False in place for every True of ``bad``."""
    bh, bw = block
    h, w = mask.shape
    mask.view(h // bh, bh, w // bw, bw).logical_and_(~bad[:, None, :, None])


def _as_tensor(a):
    return a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))


def _gray(im, channel):
    """(h, w) uint8 gray of an (h, w, 3) uint8 RGB tensor: OpenCV's
    ``COLOR_BGR2GRAY`` in 15-bit fixed point, or one channel."""
    if channel is None:
        r, g, b = (im[..., i].to(torch.int32) for i in range(3))
        return ((9798 * r + 19235 * g + 3735 * b + 16384) >> 15).to(torch.uint8)
    idx = {"r": 0, "g": 1, "b": 2}.get(str(channel).lower())
    if idx is None:
        raise ValueError(f"channel is {channel!r} but must be R,G,B or None")
    return im[..., idx].contiguous()


def _reflect101(n, pad, device):
    """Indices of 0..n-1 padded by ``pad`` on each side, reflect-101
    (OpenCV's default border: ``gfedcb|abcdefgh|gfedcba``)."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _box_blur(img, k):
    """``cv2.blur(img, (k, k))`` of a uint8 tensor: reflect-101 border, the
    k*k window sum from an int64 integral image, rounded half up (k odd)."""
    h, w = img.shape
    p = k // 2
    padded = img[_reflect101(h, p, img.device)][:, _reflect101(w, p, img.device)]
    ii = torch.zeros((h + 2 * p + 1, w + 2 * p + 1), dtype=torch.int64,
                     device=img.device)
    ii[1:, 1:] = padded.to(torch.int64).cumsum(0).cumsum(1)
    s = ii[k:, k:] - ii[:-k, k:] - ii[k:, :-k] + ii[:-k, :-k]
    return ((2 * s + k * k) // (2 * k * k)).to(torch.uint8)


def _median3_binary(binary):
    """``cv2.medianBlur(binary, 3)`` of a 0/255 uint8 tensor: 255 where at
    least 5 of the 3x3 neighbourhood are set (edges replicated)."""
    h, w = binary.shape
    rows = torch.arange(-1, h + 1, device=binary.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=binary.device).clamp(0, w - 1)
    s = (binary != 0)[rows][:, cols].to(torch.int32)
    n = sum(s[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))
    return (n >= 5).to(torch.uint8) * 255


def _paint(shape, spans, pixels, device):
    """(h, w) bool tensor on ``device``: the (rows, first, last) spans and
    the (xs, ys) pixels set, clipped to the image."""
    h, w = shape
    (rows, first, last), (xs, ys) = spans, pixels
    first, last = np.maximum(first, 0), np.minimum(last, w - 1)
    ok = (rows >= 0) & (rows < h) & (first <= last)
    rows, first, last = rows[ok], first[ok], last[ok]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs, ys = xs[ok], ys[ok]
    diff = torch.zeros(h * (w + 1), dtype=torch.int32, device=device)
    ones = torch.ones(len(rows), dtype=torch.int32, device=device)
    diff.index_add_(0, torch.from_numpy(rows * (w + 1) + first).to(device), ones)
    diff.index_add_(0, torch.from_numpy(rows * (w + 1) + last + 1).to(device),
                    -ones)
    painted = diff.view(h, w + 1).cumsum(1)[:, :w] > 0
    painted.view(-1)[torch.from_numpy(ys * w + xs).to(device)] = True
    return painted


def _fill_polys(shape, polys, device):
    """``cv2.fillPoly`` of integer polygons as an (h, w) bool tensor."""
    return _paint(shape, *poly_fill_spans(polys), device)


def _draw_lines(shape, lines, device):
    """``cv2.line`` of each (x0, y0, x1, y1) as an (h, w) bool tensor."""
    z = np.zeros(0, dtype=np.int64)
    pix = [line_pixels(*ln) for ln in lines]
    xs = np.concatenate([p[0] for p in pix]) if pix else z
    ys = np.concatenate([p[1] for p in pix]) if pix else z
    return _paint(shape, (z, z, z), (xs, ys), device)


def _binarize(gray, fudge, max_threshold):
    """(binary uint8 tensor, float32 histogram, threshold, first spike)."""
    hist = torch.bincount(gray.reshape(-1).to(torch.int64), minlength=256)
    hist = hist.cpu().numpy().astype(np.float32)
    hist[255] = 0  # calcHist's range [0, 255) leaves 255 out
    hist[1:-1] = (hist[:-2] + hist[1:-1] + hist[2:]) / 3  # light smoothing
    hist_diff = hist[1:] - hist[:-1]
    first_spike = int(np.argmax(hist_diff < 0))
    threshold = min(first_spike + fudge, max_threshold)
    binary = (gray > threshold).to(torch.uint8) * 255
    return binary, hist, threshold, first_spike


def binarize_starfield(imgray, fudge=20, max_threshold=150):
    """Threshold = histogram first spike + fudge.

    :param imgray: (h, w) uint8 array, or tensor (computed on its device)
    :returns: (binary, hist, threshold, first_spike); ``binary`` is an
        array for an array and a tensor for a tensor
    """
    binary, hist, threshold, spike = _binarize(_as_tensor(imgray), fudge,
                                               max_threshold)
    if not torch.is_tensor(imgray):
        binary = binary.numpy()
    return binary, hist, threshold, spike


def categorize_contours(binary, big_area_ratio=0.000013, long_ratio=5.0):
    """:returns: (contours, areas, is_big, is_small_long, is_small_short)"""
    binary = np.asarray(binary.cpu() if torch.is_tensor(binary) else binary)
    padded = np.zeros((binary.shape[0] + 2, binary.shape[1] + 2), dtype=np.uint8)
    padded[1:-1, 1:-1] = binary
    contours = [contour_approx_simple(c) - 1 for c in _external_borders(padded)]
    if not contours:
        z = np.zeros(0, dtype=bool)
        return contours, np.zeros(0), z, z, z
    areas = np.array([_contour_area(c) for c in contours])
    rect_axes = np.array([min_area_rect_axes(c) for c in contours])
    big_area = big_area_ratio * binary.shape[0] * binary.shape[1]
    is_big = areas > int(big_area)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = rect_axes[:, 0] / rect_axes[:, 1]
    with np.errstate(invalid="ignore"):
        is_long = (areas > 20) & ((ratio > long_ratio) | (ratio < 1 / long_ratio))
    is_small = ~is_big
    return contours, areas, is_big, is_small & is_long, is_small & ~is_long


def _big_contours(binary, big_area_ratio=0.000013):
    """The external contours of ``binary`` (host uint8) that
    ``_contour_mask`` reads, in ``categorize_contours``' order:
    (contours, areas, is_big) of every contour that is big and of every
    one that could be the biggest. The rest are not traced: a label's
    contour has an area of at most (w-1)(h-1) of its bounding box."""
    from scipy import ndimage

    h, w = binary.shape
    filled = ndimage.binary_fill_holes(binary != 0)
    labels, _ = ndimage.label(filled, structure=np.ones((3, 3), dtype=bool))
    boxes = ndimage.find_objects(labels)
    bound = np.array([(b[0].stop - b[0].start - 1) * (b[1].stop - b[1].start - 1)
                      for b in boxes], dtype=np.int64)
    big = int(big_area_ratio * h * w)
    todo = list(np.flatnonzero(bound > big))  # every possibly big label
    rest = [i for i in np.argsort(-bound, kind="stable") if bound[i] <= big]
    padded = np.zeros((h + 2, w + 2), dtype=np.uint8)
    padded[1:-1, 1:-1] = binary

    traced = {}

    def trace(labs):
        starts = []
        for i in labs:
            ys, xs = boxes[i]
            row = labels[ys.start, xs]
            x = xs.start + int(np.argmax(row == i + 1))
            starts.append((ys.start + 1) * (w + 2) + x + 1)
        for i, s, c in zip(labs, starts, trace_outer_borders(padded, starts)):
            c = contour_approx_simple(c) - 1
            traced[i] = (s, c, _contour_area(c))

    trace(todo)
    best = max((a for _, _, a in traced.values()), default=-1.0)
    for i in rest:  # labels that could still be (or tie) the biggest
        if bound[i] < best:
            break
        trace([i])
        best = max(best, traced[i][2])
    # OpenCV lists the contours in reverse raster order of their starts
    keys = sorted(traced, key=lambda i: -traced[i][0])
    contours = [traced[i][1] for i in keys]
    areas = np.array([traced[i][2] for i in keys])
    return contours, areas, areas > big


def _check_binary(binary, what):
    if binary.dim() != 2 or binary.dtype != torch.uint8:
        raise ValueError(f"{what}: expected an (h, w) uint8 tensor, got "
                         f"{tuple(binary.shape)} {binary.dtype}")
    if binary.numel() >= 1 << 31:
        raise ValueError(f"{what}: {tuple(binary.shape)} has 2^31 pixels "
                         f"or more (int32 flat indices)")
    if binary.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {binary.device}")


def _ccl_plain(binary, connectivity, fg=True):
    """The plain version of CCL8 / CCL4 (``ops/csrc/ccl.cu``): an int32
    (h, w) array holding, at each pixel that is non-zero (``fg``) or zero
    (not ``fg``), the flat index ``y*w + x`` of the first pixel in raster
    order of its 8- or 4-connected component of such pixels; -1 at every
    other pixel. ``scipy.ndimage.label`` with the 3x3 or the cross
    structure, each label mapped to its first pixel."""
    from scipy import ndimage

    if connectivity not in (4, 8):
        raise ValueError(f"connectivity is {connectivity}, not 4 or 8")
    on = (np.asarray(binary) != 0) == bool(fg)
    structure = ndimage.generate_binary_structure(2, 2 if connectivity == 8
                                                  else 1)
    labels, n = ndimage.label(on, structure=structure)
    flat = labels.ravel()
    nz = np.flatnonzero(flat)
    _, first = np.unique(flat[nz], return_index=True)  # first occurrences
    roots = np.full(n + 1, -1, dtype=np.int32)
    roots[1:] = nz[first]
    return roots[labels]


def ccl(binary, connectivity, fg=True):
    """Connected components of a (h, w) uint8 tensor's non-zero (``fg``)
    or zero pixels, 8- or 4-connected: an int32 (h, w) tensor holding at
    each such pixel the flat index of its component's first pixel in
    raster order (the root), -1 elsewhere. On a CUDA tensor it launches
    ``CCL8`` or ``CCL4`` (``ops/csrc/ccl.cu``), on a CPU tensor it runs
    ``_ccl_plain``."""
    _check_binary(binary, "ccl")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity is {connectivity}, not 4 or 8")
    if binary.device.type == "cpu":
        return torch.from_numpy(_ccl_plain(binary.numpy(), connectivity, fg))
    import ctypes

    from auromat_tpu_torch.ops import _kernels

    binary = binary.contiguous()
    h, w = binary.shape
    labels = torch.empty((h, w), dtype=torch.int32, device=binary.device)
    P = ctypes.c_void_p
    kernel = _kernels.CCL8 if connectivity == 8 else _kernels.CCL4
    kernel(P(binary.data_ptr()), w, h, int(bool(fg)), P(labels.data_ptr()),
           P(torch.cuda.current_stream(binary.device).cuda_stream))
    return labels


class Borders(NamedTuple):
    """The outer borders traced from a list of roots, one entry a root in
    the roots' order: twice the area (int64: ``cv2.contourArea`` of the
    ``CHAIN_APPROX_SIMPLE`` contour, doubled, exact), the box (int32 (n, 4):
    ``cv2.boundingRect``'s x, y, w, h), the chain's length (int64: the
    ``CHAIN_APPROX_NONE`` points) and the count of its simple points
    (int64), and the simple points themselves (int32 (sum of the counts,
    2), x and y, each contour's in ``findContours``' order from its start)
    or None."""
    area2: torch.Tensor
    box: torch.Tensor
    length: torch.Tensor
    count: torch.Tensor
    points: Optional[torch.Tensor]


def _contour_trace_plain(binary, roots, points=False):
    """The plain version of CONTOUR_TRACE (``ops/csrc/contour_trace.cu``):
    the outer border of ``binary`` (a (h, w) array, non-zero set) from each
    root (flat indices of components' first pixels in raster order) by
    ``trace_outer_borders``, reduced by ``contour_approx_simple``, measured
    by ``_contour_area`` and ``bounding_rect``. A ``Borders`` of arrays."""
    binary = np.asarray(binary)
    h, w = binary.shape
    roots = np.asarray(roots, dtype=np.int64).reshape(-1)
    padded = np.zeros((h + 2, w + 2), dtype=np.uint8)
    padded[1:-1, 1:-1] = binary != 0
    starts = (roots // w + 1) * (w + 2) + roots % w + 1
    n = len(roots)
    area2, length, count = (np.zeros(n, dtype=np.int64) for _ in range(3))
    box = np.zeros((n, 4), dtype=np.int32)
    pts = []
    for k, c in enumerate(trace_outer_borders(padded, starts)):
        s = contour_approx_simple(c) - 1
        area2[k] = int(2 * _contour_area(s))
        box[k] = bounding_rect(s)
        length[k], count[k] = len(c), len(s)
        if points:
            pts.append(s)
    if points:
        pts = (np.concatenate(pts).astype(np.int32) if pts
               else np.zeros((0, 2), dtype=np.int32))
    return Borders(area2, box, length, count, pts if points else None)


def contour_trace(binary, roots, points=False):
    """The outer borders of a (h, w) uint8 tensor's non-zero pixels traced
    from ``roots`` (an int tensor of flat indices, each the first pixel in
    raster order of an 8-connected component, or of the hole-filled
    component around one): a ``Borders`` of tensors on ``binary``'s
    device. On a CUDA tensor it launches ``CONTOUR_TRACE`` once, and once
    more at the prefix sum of the counts when ``points``; on a CPU tensor
    it runs ``_contour_trace_plain``."""
    _check_binary(binary, "contour_trace")
    if binary.device.type == "cpu":
        out = _contour_trace_plain(binary.numpy(), roots.cpu().numpy(), points)
        return Borders(*(None if a is None else torch.from_numpy(a)
                         for a in out))
    return _contour_trace_cuda(binary, roots, points)


def _contour_trace_cuda(binary, roots, points=False, cycles=None):
    """``contour_trace`` on the card. ``cycles``, an int64 tensor of one
    entry a root if given, gets each thread's ``clock64()`` cycles of its
    walk (of the first launch)."""
    import ctypes

    from auromat_tpu_torch.ops import _kernels

    binary = binary.contiguous()
    dev = binary.device
    h, w = binary.shape
    roots = roots.to(device=dev, dtype=torch.int32).contiguous()
    n = roots.numel()
    area2, length, count = (torch.empty(n, dtype=torch.int64, device=dev)
                            for _ in range(3))
    box = torch.empty((n, 4), dtype=torch.int32, device=dev)
    bits = torch.empty(((h + 7) // 8) * ((w + 7) // 8), dtype=torch.int64,
                       device=dev)  # the image as 8x8-pixel tiles
    P = ctypes.c_void_p
    stream = P(torch.cuda.current_stream(dev).cuda_stream)

    def launch(offsets, pts, clocks):
        ptr = lambda t: P(None if t is None else t.data_ptr())
        _kernels.CONTOUR_TRACE(P(binary.data_ptr()), w, h,
                               P(roots.data_ptr()), n, P(area2.data_ptr()),
                               P(box.data_ptr()), P(length.data_ptr()),
                               P(count.data_ptr()), ptr(offsets), ptr(pts),
                               ptr(clocks), P(bits.data_ptr()), stream)

    launch(None, None, cycles)
    pts = None
    if points:
        bad, total = torch.stack([(length < 0).sum(), count.sum()]).tolist()
        if bad:
            raise RuntimeError(f"contour_trace failed on {bad} roots")
        offsets = torch.cumsum(count, 0) - count
        pts = torch.empty((total, 2), dtype=torch.int32, device=dev)
        launch(offsets, pts, None)
    return Borders(area2, box, length, count, pts)


def _fill_holes(binary, bg):
    """``scipy.ndimage.binary_fill_holes`` of a (h, w) uint8 tensor given
    ``bg``, the 4-connected roots of its zero pixels (``ccl(binary, 4,
    fg=False)``): a zero pixel is filled unless its component's root is
    the root of a zero pixel on an image edge. A bool tensor."""
    h, w = bg.shape
    sink = h * w  # stands for -1: the set pixels
    idx = torch.where(bg >= 0, bg, sink).long()
    edge = torch.cat([idx[0], idx[-1], idx[:, 0], idx[:, -1]])
    outside = torch.zeros(sink + 1, dtype=torch.bool, device=bg.device)
    outside[edge] = True
    outside[sink] = True
    return (binary != 0) | ~outside[idx]


def external_contours(binary, points=False):
    """The external contours of a (h, w) uint8 tensor, as
    ``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)`` sees them:
    (roots, labels, borders). ``labels`` holds the 8-connected roots of the
    hole-filled image (``ccl`` of ``_fill_holes``; one component, one
    external contour), ``roots`` (int64, ascending: the starts in raster
    order, the reverse of OpenCV's list) its components' first pixels, and
    ``borders`` the ``Borders`` traced from them on ``binary``. On a CUDA
    tensor: CCL4, the fill, CCL8 and CONTOUR_TRACE on the card, one host
    read (the number of roots); on a CPU tensor the plain versions."""
    bg = ccl(binary, 4, fg=False)
    filled = _fill_holes(binary, bg).to(torch.uint8)
    del bg
    labels = ccl(filled, 8)
    del filled
    flat = labels.view(-1)
    roots = torch.nonzero(flat == torch.arange(flat.numel(), dtype=flat.dtype,
                                               device=flat.device)).view(-1)
    return roots, labels, contour_trace(binary, roots, points)


def _label_mask(shape, contours, blacken_lower_part, big_area_ratio=0.000013):
    """``_contour_mask`` from ``external_contours``' tensors, on their
    device: the big contours are painted as their hole-filled labels (the
    pixels ``cv2.fillPoly`` sets for an outer border: the border runs
    through pixel centres and its simple points drop only collinear ones);
    the biggest is the largest area, on a tie the larger start (OpenCV
    lists the contours in reverse raster order of their starts). Reads
    three numbers on the host: the biggest's top row and height, and the
    count of roots whose trace failed (raises if not 0)."""
    roots, labels, borders = contours
    h, w = shape
    dev = labels.device
    mask = torch.ones(shape, dtype=torch.bool, device=dev)
    block = _block_shape(shape)
    bh = block[0]
    is_big = borders.area2 > 2 * int(big_area_ratio * h * w)
    if len(roots):
        last = len(roots) - 1 - int(torch.argmax(borders.area2.flip(0)))
        y, height, bad = torch.stack([
            borders.box[last, 1].long(), borders.box[last, 3].long(),
            (borders.length < 0).sum()]).tolist()
        if bad:
            raise RuntimeError(f"contour_trace failed on {bad} roots")
        if blacken_lower_part:
            from_y = (y if (y > shape[0] / 3 and y + height > shape[0] / 2)
                      else shape[0] // 2)
            mask[int(math.ceil(from_y / bh) * bh):] = False
    flag = torch.zeros(h * w + 1, dtype=torch.bool, device=dev)
    flag[roots[is_big]] = True
    painted = flag[torch.where(labels >= 0, labels, h * w).long()]
    _clear_blocks(mask, _blocks_any(painted, block), block)
    return mask


def _contour_mask(shape, contours, areas, offending, blacken_lower_part,
                  device):
    """The starfield mask (bool tensor on ``device``) of step 1."""
    mask = torch.ones(shape, dtype=torch.bool, device=device)
    block = _block_shape(shape)
    bh = block[0]

    if blacken_lower_part and len(contours):
        # if the biggest contour sits in the lower part it is likely Earth:
        # blacken from its top edge down (else from mid-image)
        biggest = contours[int(np.argmax(areas))]
        _, y, _, h = bounding_rect(biggest)
        from_y = y if (y > shape[0] / 3 and y + h > shape[0] / 2) else shape[0] // 2
        from_block = int(math.ceil(from_y / bh) * bh)
        mask[from_block:] = False

    if np.any(offending):
        filled = _fill_polys(shape, [contours[i] for i in np.flatnonzero(offending)],
                             device)
        _clear_blocks(mask, _blocks_any(filled, block), block)
    return mask


def _mask_from_contours(shape, contours, areas, offending, blacken_lower_part):
    return _contour_mask(shape, contours, areas, offending, blacken_lower_part,
                         "cpu").numpy()


def _adaptive_threshold(image, mask, max_value, size, c):
    """``masked_adaptive_threshold`` of tensors on their device."""
    m8 = mask.to(torch.uint8) * 255
    conv = _box_blur(image, size).to(torch.float64)
    neighbours = _box_blur(m8, size).to(torch.float64)
    diff = image.to(torch.float64) - 255 * (conv / neighbours)
    return ((diff > -c) & mask).to(torch.uint8) * max_value


def masked_adaptive_threshold(image, mask, max_value, size, c):
    """Adaptive threshold restricted to unmasked pixels (image must be black
    under the mask). Reference masking.py:192-207."""
    out = _adaptive_threshold(_as_tensor(image), _as_tensor(mask), max_value,
                              size, c)
    return out if torch.is_tensor(image) else out.numpy()


_RNG_COEFF = 4164903690  # OpenCV's RNG: multiply with carry, CV_RNG_COEFF
_RNG_MOD = _RNG_COEFF * (1 << 32) - 1  # the MWC's modulus m
# the state after one step from 2^64-1; the only state >= m on the way
_RNG_S1 = (_RNG_COEFF + 1) * ((1 << 32) - 1)
_RNG_INV32 = pow(1 << 32, -1, _RNG_MOD)  # one step multiplies by 2^-32 mod m
_HOUGH_SHIFT = 16  # fixed-point fraction bits of the walks


def _hough_order(count):
    """The order in which ``HoughLinesP`` visits ``count`` set pixels, as
    indices into their raster-order list: OpenCV's RNG (state 2^64-1,
    ``state = (state & 0xffffffff) * 4164903690 + (state >> 32)``) draws
    ``idx = (state & 0xffffffff) % remaining``; the drawn pixel is
    replaced by the last remaining one. It depends on ``count`` only.
    The plain version of the order kernel (``ops/csrc/hough_order.cu``),
    one draw at a time; ``_hough_order_chains(_hough_draws(count))`` is
    the same order computed the kernel's way."""
    state = (1 << 64) - 1
    m32 = 0xFFFFFFFF
    perm = list(range(count))
    out = [0] * count
    for k, c in enumerate(range(count, 0, -1)):
        state = (state & m32) * _RNG_COEFF + (state >> 32)
        idx = (state & m32) % c
        out[k] = perm[idx]
        perm[idx] = perm[c - 1]
    return np.array(out, dtype=np.int64)


def _mwc_state(n):
    """The RNG's state after ``n >= 1`` steps from 2^64-1, by jump-ahead:
    a step maps a state s to ``(s & 0xffffffff) c + (s >> 32)``, which is
    ``s 2^-32 (mod m)`` for ``m = c 2^32 - 1``, and every state after the
    first is below m, so ``s_n = (2^-32)^(n-1) s_1 mod m`` for n >= 2."""
    if n == 1:
        return _RNG_S1
    return pow(_RNG_INV32, n - 1, _RNG_MOD) * _RNG_S1 % _RNG_MOD


def _hough_draws(count):
    """OpenCV's draws for ``count`` pixels: ``idx_k = (s_(k+1) &
    0xffffffff) % (count - k)`` (int64). Each segment of 1024 draws starts
    from its state by jump-ahead (``_mwc_state``); the segments then step
    together in uint64 numpy (a step's value stays below 2^64)."""
    seg = 1024
    draws = np.zeros(count, dtype=np.int64)
    starts = np.arange(0, count, seg)
    state = np.array([_mwc_state(int(k) + 1) for k in starts], dtype=np.uint64)
    m32, coeff, s32 = np.uint64(0xFFFFFFFF), np.uint64(_RNG_COEFF), np.uint64(32)
    for t in range(seg):
        k = starts + t
        ok = k < count
        if not ok.any():
            break
        k, st = k[ok], state[ok]
        draws[k] = ((st & m32) % (count - k).astype(np.uint64)).astype(np.int64)
        state = (state & m32) * coeff + (state >> s32)
    return draws


def _hough_order_chains(draws):
    """The visit order from OpenCV's draws, every output at once: output k
    is the value in slot ``idx_k`` at step k. That slot holds its own
    index unless an earlier step j wrote it (``idx_j == idx_k``, ``idx_j
    != count-1-j``: step j moved slot ``count-1-j``'s value there); then
    the value is the one slot ``count-1-j`` held at step j, for the last
    such j, and so on back in time. The (slot, step) pairs of the writes
    are sorted once; each pass moves every unfinished output one hop back
    by a binary search (at 910,556 pixels: at most 18 hops, 1.0 on
    average). The plain version of the order kernel's second step."""
    draws = np.asarray(draws, dtype=np.int64)
    count = len(draws)
    steps = np.arange(count, dtype=np.int64)
    writes = draws != count - 1 - steps
    keys = np.sort(draws[writes] * count + steps[writes])
    slot, when = draws.copy(), steps.copy()
    out = np.empty(count, dtype=np.int64)
    todo = steps
    while len(todo):
        pos = np.searchsorted(keys, slot[todo] * count + when[todo]) - 1
        hit = pos >= 0
        hit[hit] = keys[pos[hit]] // count == slot[todo[hit]]
        out[todo[~hit]] = slot[todo[~hit]]
        todo, j = todo[hit], keys[pos[hit]] % count
        slot[todo], when[todo] = count - 1 - j, j
    return out


def _hough_setup(shape, rho, theta):
    """(numangle, numrho, float32 cos table, float32 sin table) as OpenCV
    computes them: ``theta`` and ``1/rho`` in float32, each entry
    ``(float)(cos(n * theta) / rho)`` in double before the rounding."""
    h, w = shape
    theta = float(np.float32(theta))
    irho = float(np.float32(1.0) / np.float32(rho))
    numangle = int(math.floor(math.pi / theta)) + 1
    if numangle > 1 and abs(math.pi - (numangle - 1) * theta) < theta / 2:
        numangle -= 1
    numrho = int(np.rint(((w + h) * 2 + 1) / float(np.float32(rho))))
    cos_t = np.array([math.cos(n * theta) * irho for n in range(numangle)],
                     dtype=np.float32)
    sin_t = np.array([math.sin(n * theta) * irho for n in range(numangle)],
                     dtype=np.float32)
    return numangle, numrho, cos_t, sin_t


def _walk_step(a, b):
    """(xflag, dx0, dy0) of a walk along the direction (a, b) = (-sin,
    cos) in OpenCV's float32 arithmetic: the major axis steps by 1, the
    minor one by ``rint(minor * 65536 / |major|)`` (16-bit fixed point);
    ``xflag`` when x is the major axis."""
    one = np.float32(1 << _HOUGH_SHIFT)
    if abs(a) > abs(b):
        return True, (1 if a > 0 else -1), int(np.rint(np.float32(b * one) / abs(a)))
    return False, int(np.rint(np.float32(a * one) / abs(b))), (1 if b > 0 else -1)


HOUGH_COUNTERS = ("voters", "triggers", "clear_steps", "lines")


def _hough_p_plain(binary, rho, theta, threshold, line_length, line_gap,
                   counters=None):
    """``cv2.HoughLinesP`` of a (h, w) uint8 array, sequentially on the
    host: (n, 4) int32 lines (x0, y0, x1, y1) in OpenCV's order. The plain
    version of ``ops/csrc/hough_p.cu``, in the same arithmetic: the votes
    of a chunk of pixels are computed at once in float32 numpy, the rest
    (the vote, the walks) pixel by pixel.

    :param counters: a dict, if given, gets the trajectory's counts
        (``HOUGH_COUNTERS``): ``voters``, the visited pixels still set
        (each votes once); ``triggers``, the votes whose maximum reached
        ``threshold`` (each walks); ``clear_steps``, the positions the
        clearing walks visit (both directions, the seed in each, up to and
        including each end); ``lines``, the lines kept. The kernel counts
        the same four: equal counts mean the same trajectory.
    """
    binary = np.asarray(binary)
    h, w = binary.shape
    numangle, numrho, cos_t, sin_t = _hough_setup((h, w), rho, theta)
    ys, xs = np.nonzero(binary)
    order = _hough_order(len(xs))
    vx, vy = xs[order], ys[order]
    mask = bytearray((binary != 0).astype(np.uint8).tobytes())
    acc = np.zeros(numangle * numrho, dtype=np.int32)
    base = np.arange(numangle, dtype=np.int64) * numrho + (numrho - 1) // 2
    steps = [_walk_step(-sin_t[n], cos_t[n]) for n in range(numangle)]
    shift, half = _HOUGH_SHIFT, 1 << (_HOUGH_SHIFT - 1)

    def bins(x, y):  # (n, numangle) flat accumulator indices: x c + y s
        return base + np.rint(x.astype(np.float32)[:, None] * cos_t
                              + y.astype(np.float32)[:, None] * sin_t
                              ).astype(np.int64)

    def walk(px, py, dx, dy, xflag):  # the last set pixel before a long gap
        gap, end = 0, None
        while True:
            j1, i1 = (px, py >> shift) if xflag else (px >> shift, py)
            if j1 < 0 or j1 >= w or i1 < 0 or i1 >= h:
                return end
            if mask[i1 * w + j1]:
                gap, end = 0, (j1, i1)
            else:
                gap += 1
                if gap > line_gap:
                    return end
            px += dx
            py += dy

    def clear(px, py, dx, dy, xflag, end, cleared):  # up to ``end``
        while True:
            n_clear[0] += 1
            j1, i1 = (px, py >> shift) if xflag else (px >> shift, py)
            k = i1 * w + j1
            if mask[k]:
                cleared.append((j1, i1))
                mask[k] = 0
            if (j1, i1) == end:
                return
            px += dx
            py += dy

    lines = []
    n_voters = n_triggers = 0
    n_clear = [0]
    chunk = 1 << 15
    for c0 in range(0, len(vx), chunk):
        cx, cy = vx[c0:c0 + chunk], vy[c0:c0 + chunk]
        cbins = bins(cx, cy)
        for j, (x, y) in enumerate(zip(cx.tolist(), cy.tolist())):
            if not mask[y * w + x]:
                continue  # taken by an earlier line
            n_voters += 1
            idx = cbins[j]
            votes = acc[idx]
            votes += 1
            acc[idx] = votes
            if votes.max() < threshold:
                continue
            n_triggers += 1
            xflag, dx0, dy0 = steps[int(votes.argmax())]  # the first maximum
            x0, y0 = (x, (y << shift) + half) if xflag else ((x << shift) + half, y)
            ends = (walk(x0, y0, dx0, dy0, xflag), walk(x0, y0, -dx0, -dy0, xflag))
            good = (abs(ends[1][0] - ends[0][0]) >= line_length or
                    abs(ends[1][1] - ends[0][1]) >= line_length)
            cleared = []
            clear(x0, y0, dx0, dy0, xflag, ends[0], cleared)
            clear(x0, y0, -dx0, -dy0, xflag, ends[1], cleared)
            if good:  # a kept line gives its pixels' votes back
                cl = np.array(cleared, dtype=np.int64)
                np.subtract.at(acc, bins(cl[:, 0], cl[:, 1]).ravel(), 1)
                lines.append((*ends[0], *ends[1]))
    if counters is not None:
        counters.update(zip(HOUGH_COUNTERS, (n_voters, n_triggers, n_clear[0],
                                             len(lines))))
    return np.array(lines, dtype=np.int32).reshape(-1, 4)


def hough_lines_p(binary, rho, theta, threshold, min_line_length, max_line_gap,
                  counters=None):
    """``cv2.HoughLinesP(binary, rho, theta, threshold, minLineLength=...,
    maxLineGap=...)`` of a (h, w) uint8 tensor: (n, 4) int32 numpy lines
    in OpenCV's order. On a CUDA tensor it launches ``HOUGH_ORDER``
    (``ops/csrc/hough_order.cu``, the visit order) and ``HOUGH_P``
    (``ops/csrc/hough_p.cu``) once each, on a CPU tensor it runs
    ``_hough_p_plain``. ``counters``, a dict if given, gets the
    trajectory's counts (``_hough_p_plain``'s ``HOUGH_COUNTERS``) from
    either."""
    _check_binary(binary, "hough_lines_p")
    if binary.device.type == "cpu":
        return _hough_p_plain(binary.numpy(), rho, theta, threshold,
                              min_line_length, max_line_gap, counters)
    return _hough_p_cuda(binary, rho, theta, threshold, min_line_length,
                         max_line_gap, counters)


def _hough_p_cuda(binary, rho, theta, threshold, line_length, line_gap,
                  counters=None):
    """``hough_lines_p`` on the card: one launch of ``HOUGH_ORDER`` and one
    of ``HOUGH_P``, then one read of the four counts."""
    args = _hough_p_args(binary, rho, theta, threshold, line_length, line_gap)
    lines, stats = _hough_p_launch(args)
    stats = stats.tolist()
    if counters is not None:
        counters.update(zip(HOUGH_COUNTERS, stats))
    return lines[: stats[3]].cpu().numpy()


def _hough_order_cuda(count, device):
    """``_hough_order(count)`` drawn on the card by ``HOUGH_ORDER``: an
    int64 tensor on ``device``."""
    import ctypes

    from auromat_tpu_torch.ops import _kernels

    order = torch.empty(count, dtype=torch.int64, device=device)
    work = torch.empty(4 * count + 3 + (count + 1) // 1024, dtype=torch.int32,
                       device=device)
    P = ctypes.c_void_p
    _kernels.HOUGH_ORDER(count, P(order.data_ptr()), P(work.data_ptr()),
                         work.numel(),
                         P(torch.cuda.current_stream(device).cuda_stream))
    return order


def _hough_p_args(binary, rho, theta, threshold, line_length, line_gap):
    """The kernel's arguments as a dict: the visited (x, y) pairs in
    OpenCV's order (the set pixels from ``torch.nonzero``, the order from
    ``HOUGH_ORDER``: nothing of the count's size on the host), the mask the
    walks clear, the zeroed accumulator, the float32 trig table, the
    scratch list of a kept line's pixels, the outputs (lines, and the four
    counts as int64)."""
    from auromat_tpu_torch.ops import _kernels

    h, w = binary.shape
    dev = binary.device
    numangle, numrho, cos_t, sin_t = _hough_setup((h, w), rho, theta)
    if numangle > _kernels.HOUGH_P_THREADS:
        raise ValueError(f"hough_lines_p on the card takes at most "
                         f"{_kernels.HOUGH_P_THREADS} angles, not {numangle}")
    if max(h, w) > _kernels.HOUGH_P_MAX_SIDE:
        raise ValueError(f"hough_lines_p on the card takes sides of at most "
                         f"{_kernels.HOUGH_P_MAX_SIDE} pixels, not {w}x{h}")
    binary = binary.contiguous()
    nz = torch.nonzero(binary)  # raster order, as OpenCV collects them
    count = nz.shape[0]
    # the kernel keeps a bin's votes in 16 bits of its reduction key: at
    # most the candidates, or the pixels of one strip of width rho
    if count >= 1 << 16 and max(h, w) * (2 * max(rho, 1.0) + 1) >= 1 << 16:
        raise ValueError(f"hough_lines_p on the card: {count} candidates at "
                         f"rho {rho} on {w}x{h} may put 2^16 votes in a bin")
    order = _hough_order_cuda(count, dev)
    return {"pts": nz[order].flip(1).to(torch.int32).contiguous(),
            "count": count, "mask": (binary != 0).to(torch.uint8),
            "width": w, "height": h,
            "acc": torch.zeros(numangle * numrho, dtype=torch.int32, device=dev),
            "numangle": numangle, "numrho": numrho,
            "trig": torch.from_numpy(np.concatenate([cos_t, sin_t])).to(dev),
            "threshold": int(threshold), "line_length": int(line_length),
            "line_gap": int(line_gap),
            "lines": torch.empty((max(count, 1), 4), dtype=torch.int32,
                                 device=dev),
            "list": torch.empty(2 * (w + h) + 2, dtype=torch.int32, device=dev),
            "stats": torch.zeros(4, dtype=torch.int64, device=dev)}


def _hough_p_launch(a):
    """Launch ``HOUGH_P`` on ``_hough_p_args``' dict (its mask and
    accumulator are changed); returns (lines, counts) on the card, the
    counts in ``HOUGH_COUNTERS``' order (the fourth is the number of
    lines)."""
    import ctypes

    from auromat_tpu_torch.ops import _kernels

    P = ctypes.c_void_p
    _kernels.HOUGH_P(P(a["pts"].data_ptr()), a["count"],
                     P(a["mask"].data_ptr()), a["width"], a["height"],
                     P(a["acc"].data_ptr()), a["numangle"], a["numrho"],
                     P(a["trig"].data_ptr()), a["threshold"],
                     a["line_length"], a["line_gap"],
                     P(a["lines"].data_ptr()), P(a["list"].data_ptr()),
                     P(a["stats"].data_ptr()),
                     P(torch.cuda.current_stream(a["mask"].device).cuda_stream))
    return a["lines"], a["stats"]


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
    im = _load_rgb(image)
    h, w = im.shape[:2]
    x1, y1 = top_left
    x2, y2 = bottom_right
    mask = np.zeros((h, w), dtype=bool)
    mask[y1 : y2 + 1, x1 : x2 + 1] = True
    sigma = _scale_sigma(estimate_noise_level(im[y1 : y2 + 1, x1 : x2 + 1, 2]))
    return mask, sigma


def _scale_sigma(sigma):
    # astrometry.net tends to estimate higher sigmas (reference masking.py:412)
    return max(0.9, sigma * 2.5)


def _load_rgb(image):
    """(h, w, 3) uint8 RGB of an array or of a path (``io.image``'s
    decoder; a 16-bit image keeps its high byte, as ``cv.imread`` does)."""
    if not isinstance(image, np.ndarray):
        import os

        from auromat_tpu_torch.io.image import load_image

        if not os.path.isfile(image):
            raise IOError(f"cannot read image {image}")
        image = load_image(image)
        if image.dtype == np.uint16:
            image = (image >> 8).astype(np.uint8)
    image = np.require(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (h, w, 3) RGB image, got shape "
                         f"{image.shape}")
    return image


def _dark_area_mask(imgray, blacken_lower_part):
    """Step 1 of ``mask_starfield`` on a uint8 gray tensor: the dark-area
    candidate mask (bool tensor), raising the threshold while the
    starfield area stays implausibly small (reference masking.py:265-289);
    returns (mask, first spike of the last histogram)."""
    fudge = 20
    while True:
        binary, _, _, first_spike = _binarize(imgray, fudge, 150)
        if imgray.device.type == "cpu":
            contours, areas, is_big = _big_contours(binary.numpy())
            mask = _contour_mask(tuple(imgray.shape), contours, areas, is_big,
                                 blacken_lower_part, "cpu")
        else:
            mask = _label_mask(tuple(imgray.shape), external_contours(binary),
                               blacken_lower_part)
        if mask.float().mean().item() >= 0.1 or fudge > 100:
            return mask, first_spike
        fudge += 20


def _line_candidates(imgray, mask):
    """The Hough transform's input in ``mask_starfield``: the masked
    adaptive threshold (89x89, C = -1) of the masked gray tensor, after a
    3x3 median."""
    return _median3_binary(_adaptive_threshold(imgray, mask, 255, 89, -1))


def mask_starfield(image, channel=None, blacken_lower_part=True,
                   ignore_very_dark=True, device="cuda"):
    """Automatically mask the star-sky region of an image.

    :param image: path or (h, w, 3) RGB uint8 array
    :param channel: 'R', 'G', 'B' or None (grayscale combine)
    :param device: where the pixel stages and the Hough transform run
        (the card by default; raises if it is CUDA and there is none)
    :returns: (mask (h, w) bool — True = starfield, sigma)
    """
    from auromat_tpu_torch.ops.georef import compute_device

    device = compute_device(device)
    im = torch.from_numpy(np.array(_load_rgb(image))).to(device)
    imgray = _gray(im, channel)
    del im
    shape = tuple(imgray.shape)
    block = _block_shape(shape)

    mask, first_spike = _dark_area_mask(imgray, blacken_lower_part)
    imgray = imgray * mask

    # step 2a: Hough lines over a masked adaptive threshold
    binary = _line_candidates(imgray, mask)
    lines = hough_lines_p(binary, 1, math.pi / 180, 200, 100, 4)
    del binary
    if len(lines):
        drawn = _draw_lines(shape, lines, device)
        _clear_blocks(mask, _blocks_any(drawn, block), block)

    # step 2b: mask blocks that are essentially pure black
    if ignore_very_dark:
        cutoff = _box_blur(imgray, 3)
        cutoff_threshold = max(30, first_spike + 20)
        _clear_blocks(mask, ~_blocks_any(cutoff >= cutoff_threshold, block),
                      block)

    # step 3: drop starfield blocks with no starfield neighbours
    def star_blocks():
        return ~_blocks_any(~mask, block)

    is_star = star_blocks()
    s = torch.nn.functional.pad(is_star.to(torch.int32), (1, 1, 1, 1))
    nby, nbx = is_star.shape
    neighbours = sum(s[dy:dy + nby, dx:dx + nbx] for dy in range(3)
                     for dx in range(3)) - is_star.to(torch.int32)
    _clear_blocks(mask, is_star & (neighbours == 0), block)

    # noise sigma from the largest remaining starfield rectangle
    is_star = star_blocks().cpu().numpy()
    bh, bw = block
    if is_star.any():
        (ry, rx), (rh, rw) = _max_size_rectangle(is_star)
        rect = imgray[ry * bh : (ry + rh) * bh, rx * bw : (rx + rw) * bw]
        sigma = _scale_sigma(estimate_noise_level(rect.cpu().numpy()))
    else:
        sigma = _scale_sigma(estimate_noise_level(imgray.cpu().numpy()))
    return mask.cpu().numpy(), sigma
