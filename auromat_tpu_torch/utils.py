"""Geometry utilities, counterpart of ``auromat_tpu.utils``.

The vector helpers (lengths, unit vectors, angles) are tensor functions
that keep their input's dtype and device; they take tensors only
(TypeError on arrays), as ``coordinates.wcs.world2pix`` does. The rest is host numpy, as the
mapping data model, resampling and the all-sky providers need it: the
outline of a binary image, its convex hull, point-in-polygon, polygon area
and centroid, the nearest element of a sorted array, consecutive
duplicates dropped, and the longitude wrap.

``outline`` is a numpy border follower, not OpenCV: the card's machine
has no cv2. It reproduces ``cv2.findContours(RETR_EXTERNAL,
CHAIN_APPROX_NONE)`` point for point (Suzuki & Abe 1985, in OpenCV's
formulation: the same raster scan, start pixels, neighbour order and
border marks), so its output is array-equal to the JAX package's
``utils.outline``, start point and orientation included —
``Mapping.boundingBox`` samples the convex hull of that outline by index.

The star-field masking's geometry is OpenCV's, in numpy:
``trace_outer_borders`` (the borders of chosen components),
``contour_approx_simple`` (``CHAIN_APPROX_SIMPLE``), ``bounding_rect``,
``min_area_rect_axes`` (``minAreaRect``'s sides, up to ties of the least
area), and the pixels ``cv2.line`` and ``cv2.fillPoly`` set
(``line_pixels``, ``poly_fill_spans``), equal to OpenCV's.

``points_inside_polygon`` is numpy, not matplotlib (the card's machine has
none either): the crossing test of matplotlib's ``point_in_path``, with
the same predicates in the same float64 arithmetic, so its answer is
array-equal to ``matplotlib.path.Path.contains_points``.

Not ported: ``host_f64_device`` (a TPU workaround; the port computes host
float64 with numpy or CPU torch directly).
"""

import numpy as np
import torch


def _tensors(*ts):
    """The vector helpers take tensors only: an array or a list would be
    computed on the host without the caller choosing it."""
    for t in ts:
        if not torch.is_tensor(t):
            raise TypeError(f"expected a tensor, got {type(t).__name__}")


def vector_lengths(vectors, axis=-1):
    """Euclidean lengths along ``axis`` of a tensor of vectors."""
    _tensors(vectors)
    return torch.sqrt((vectors * vectors).sum(dim=axis))


def unit_vectors(vectors, axis=-1):
    """``vectors`` scaled to unit length along ``axis``."""
    return vectors / vector_lengths(vectors, axis).unsqueeze(axis)


def angle_between(v1, v2, axis=-1):
    """Angles in radians between unit-vector tensors, in [0, pi]."""
    _tensors(v1, v2)
    return torch.arccos(torch.clamp((v1 * v2).sum(dim=axis), -1, 1))


def signed_angle_between(v1, v2):
    """Signed angles in radians between (n, 2) vector tensors, in
    [-pi, pi]."""
    _tensors(v1, v2)
    return torch.atan2(v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0],
                       v1[:, 0] * v2[:, 0] + v1[:, 1] * v2[:, 1])


# OpenCV's 8-neighbour chain code: direction s -> (dx, dy), counterclockwise
# from east with y pointing down (CV_INIT_3X3_DELTAS)
_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_MARK = 2  # a followed border pixel whose east neighbour is not background
# ... and -_MARK where the follower passed its east neighbour as background


def _follow_outer_border(a, i0, deltas):
    """Follow the outer border that starts at flat index ``i0`` of the
    int8 image ``a`` (0 background, 1 unvisited foreground), marking its
    pixels as it goes; returns the border's flat indices in order."""
    s_end = s = 4
    while True:  # first foreground neighbour clockwise from the west
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if a[i1] != 0 or s == s_end:
            break
    if s == s_end:  # a single-pixel component
        a[i0] = -_MARK
        return [i0]
    pts = []
    i3 = i0
    while True:
        s_end = s
        while s < 15:  # next foreground neighbour counterclockwise
            s += 1
            i4 = i3 + deltas[s]
            if a[i4] != 0:
                break
        s &= 7
        if 0 <= s - 1 < s_end:  # the scan passed the (background) east pixel
            a[i3] = -_MARK
        elif a[i3] == 1:
            a[i3] = _MARK
        pts.append(i3)
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def _external_borders(padded):
    """All outer borders of ``padded`` (uint8/bool, zero border) in the order
    ``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_NONE)`` returns them, as
    (n, 2) int32 (x, y) arrays in ``padded``'s coordinates."""
    h, w = padded.shape
    a = (np.asarray(padded) != 0).astype(np.int8).ravel()
    deltas = [1, -w + 1, -w, -w - 1, -1, w - 1, w, w + 1] * 2
    found = []
    for y in range(1, h - 1):
        off = y * w
        row = a[off:off + w]  # a view: sees the marks of earlier traces
        lnbd = off  # last border pixel met on this row (column 0: background)
        prev = 0
        x = 1
        while x < w - 1:
            ahead = np.flatnonzero(row[x:w - 1] != prev)
            if ahead.size == 0:
                break
            x += int(ahead[0])
            p = int(row[x])
            if prev == 0 and p == 1:  # the start of an outer border ...
                if a[lnbd] <= 0:  # ... of a component not inside another
                    found.append(_follow_outer_border(a, off + x, deltas))
                    x += 1
                    prev = int(row[x - 1])
                    continue
            elif p == 0 and prev >= 1 and prev != 1:  # a hole's border
                lnbd = off + x - 1
            prev = p
            if prev not in (0, 1):
                lnbd = off + x
            x += 1
    out = []
    for pts in reversed(found):  # OpenCV lists the last one found first
        idx = np.asarray(pts, dtype=np.int64)
        out.append(np.stack([idx % w, idx // w], axis=1).astype(np.int32))
    return out


def trace_outer_borders(padded, starts):
    """The outer borders that start at the flat indices ``starts`` of
    ``padded`` (uint8/bool, zero border), each as ``_external_borders``
    gives it: (n, 2) int32 (x, y) in ``padded``'s coordinates. A start is
    the first pixel in raster order of an 8-connected component; the
    follower reads only that component, so the borders are the ones
    ``cv2.findContours`` traces from those pixels."""
    w = padded.shape[1]
    a = (np.asarray(padded) != 0).astype(np.int8).ravel()
    deltas = [1, -w + 1, -w, -w - 1, -1, w - 1, w, w + 1] * 2
    out = []
    for i0 in starts:
        idx = np.asarray(_follow_outer_border(a, int(i0), deltas),
                         dtype=np.int64)
        out.append(np.stack([idx % w, idx // w], axis=1).astype(np.int32))
    return out


def contour_approx_simple(c):
    """``CHAIN_APPROX_SIMPLE`` of a ``CHAIN_APPROX_NONE`` contour: the
    points whose outgoing step differs from their incoming one (the start
    point included: OpenCV compares it with the step that closes the
    contour)."""
    c = np.asarray(c)
    if len(c) < 2:
        return c
    keep = ((np.roll(c, -1, axis=0) - c) != (c - np.roll(c, 1, axis=0))).any(
        axis=1)
    return c[keep]


def bounding_rect(c):
    """``cv2.boundingRect`` of (n, 2) integer points: (x, y, w, h)."""
    c = np.asarray(c).reshape(-1, 2)
    lo, hi = c.min(axis=0), c.max(axis=0)
    return int(lo[0]), int(lo[1]), int(hi[0] - lo[0] + 1), int(hi[1] - lo[1] + 1)


def _hull_int(points):
    """Convex hull of (n, 2) integer points (Andrew's monotone chain), its
    vertices in order, collinear points dropped; fewer than 3 when the
    points are one point or on one line."""
    p = np.unique(np.asarray(points, dtype=np.int64).reshape(-1, 2), axis=0)
    if len(p) < 3:
        return p

    def chain(seq):
        out = []
        for q in seq:
            while len(out) >= 2:
                (ox, oy), (ax, ay) = out[-2], out[-1]
                if (ax - ox) * (q[1] - oy) - (ay - oy) * (q[0] - ox) > 0:
                    break
                out.pop()
            out.append((int(q[0]), int(q[1])))
        return out[:-1]

    return np.array(chain(p) + chain(p[::-1]), dtype=np.int64).reshape(-1, 2)


def min_area_rect_axes(c):
    """The side lengths of the least-area rectangle around (n, 2) integer
    points, as ``cv2.minAreaRect(c)[1]`` gives them up to their order:
    rotating calipers over the convex hull's edges (a rectangle of least
    area has a side on a hull edge). Two points give (length, 0), one
    point (0, 0). Where several orientations tie for the least area,
    OpenCV's float32 calipers may settle on another of them."""
    h = _hull_int(c).astype(np.float64)
    if len(h) == 1:
        return 0.0, 0.0
    if len(h) == 2:
        return float(np.hypot(*(h[1] - h[0]))), 0.0
    e = np.roll(h, -1, axis=0) - h
    u = e / np.hypot(e[:, 0], e[:, 1])[:, None]
    along = h @ u.T  # (points, edges)
    across = h @ np.stack([-u[:, 1], u[:, 0]], axis=1).T
    w = along.max(axis=0) - along.min(axis=0)
    ht = across.max(axis=0) - across.min(axis=0)
    k = int(np.argmin(w * ht))
    return float(w[k]), float(ht[k])


def line_pixels(x0, y0, x1, y1):
    """The pixels ``cv2.line(img, (x0, y0), (x1, y1), color)`` sets
    (8-connected, thickness 1), as int64 arrays (xs, ys): OpenCV's
    ``LineIterator`` from the left end point, whose Bresenham steps take
    the minor axis ``m_i = (2 minor i + major - 1) // (2 major)`` times
    after ``i`` major steps."""
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    major, minor = max(dx, abs(dy)), min(dx, abs(dy))
    i = np.arange(major + 1, dtype=np.int64)
    m = (2 * minor * i + major - 1) // (2 * major) if major else i
    if abs(dy) > dx:
        return x0 + m, y0 + sy * i
    return x0 + i, y0 + sy * m


_XY_SHIFT = 16  # OpenCV's fixed-point fraction bits of polygon edges


def poly_fill_spans(polys):
    """What ``cv2.fillPoly(img, polys, color)`` (8-connected, no shift)
    sets, as (rows, first, last) spans (int64, ``last`` inclusive) and the
    (xs, ys) pixels of the edges it draws. OpenCV collects every
    non-horizontal edge of every polygon into one list; on each row ``y``
    an edge from (x0, y0) down to y1 > y0 crosses at
    ``x0 + (y - y0) * dx`` in 16-bit fixed point (``dx`` the truncated
    quotient) for ``y0 <= y < y1``; the crossings, sorted, pair up (even-
    odd) and each pair fills ``ceil(xa) .. floor(xb)``. The vertices must
    lie inside the image (OpenCV moves the crossings of clipped edges)."""
    rows, xs_fp, lx, ly = [], [], [], []
    for p in polys:
        p = np.asarray(p, dtype=np.int64).reshape(-1, 2)
        q = np.roll(p, 1, axis=0)  # each edge runs from the previous vertex
        for (ax, ay), (bx, by) in zip(q, p):
            x, y = line_pixels(ax, ay, bx, by)
            lx.append(x)
            ly.append(y)
        keep = q[:, 1] != p[:, 1]
        (ax, ay), (bx, by) = q[keep].T, p[keep].T
        ax, bx = ax << _XY_SHIFT, bx << _XY_SHIFT
        num, den = bx - ax, by - ay
        dx = np.sign(num) * np.sign(den) * (np.abs(num) // np.abs(den))
        down = ay < by
        top = np.where(down, ay, by)
        n = np.abs(by - ay)
        e = np.repeat(np.arange(len(n)), n)
        k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        rows.append(top[e] + k)
        xs_fp.append(np.where(down, ax, bx)[e] + k * dx[e])
    if not lx:
        z = np.zeros(0, dtype=np.int64)
        return (z, z, z), (z, z)
    rows, xs_fp = np.concatenate(rows), np.concatenate(xs_fp)
    order = np.lexsort((xs_fp, rows))
    rows, xs_fp = rows[order], xs_fp[order]
    first = (xs_fp[0::2] + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
    last = xs_fp[1::2] >> _XY_SHIFT
    return (rows[0::2], first, last), (np.concatenate(lx), np.concatenate(ly))


def _contour_area(c):
    """|shoelace area| of a closed contour (cv2.contourArea)."""
    x = c[:, 0].astype(np.float64)
    y = c[:, 1].astype(np.float64)
    return abs(0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def outline(im):
    """Outline of a binary image (True = inside) as (n, 2) int32 x, y.

    The outer border of the largest component by area (ties: the one
    OpenCV lists first), every border pixel (concave runs kept), in
    OpenCV's start point and orientation. Border-touching regions are kept
    by padding the image with one background pixel.
    Reference: auromat/utils.py:76-151 (via OpenCV in the JAX package).
    """
    padded = np.zeros((im.shape[0] + 2, im.shape[1] + 2), dtype=np.uint8)
    padded[1:-1, 1:-1] = np.asarray(im, dtype=bool)
    contours = _external_borders(padded)
    if not contours:
        raise ValueError("binary image contains no region")
    contour = contours[int(np.argmax([_contour_area(c) for c in contours]))]
    return contour - 1


def convex_hull(points):
    """Convex hull of (n, 2) integer points, as ordered (m, 2) array."""
    from scipy.spatial import ConvexHull

    points = np.asarray(points)
    return points[ConvexHull(points).vertices]


def points_inside_polygon(points, polygon):
    """For each (n, 2) point, whether it lies inside the unclosed polygon
    (``matplotlib.path.Path(polygon).contains_points(points)``).

    matplotlib's crossing test (``_path.h::point_in_path_impl``): the
    polygon is closed implicitly; an edge (x0, y0) -> (x1, y1) toggles a
    point (tx, ty) when ``(y0 >= ty) != (y1 >= ty)`` and
    ``((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == (y1 >= ty)``.
    A point with a non-finite coordinate is outside, and so is every point
    of a polygon of fewer than 3 vertices. The first predicate holds
    exactly for ty in (min(y0, y1), max(y0, y1)], so each edge tests only
    that band of the points sorted by y: the result is the same, the work
    is the band's instead of every point's.
    """
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    poly = np.asarray(polygon, dtype=np.float64).reshape(-1, 2)
    inside = np.zeros(len(pts), dtype=bool)
    if len(poly) < 3:
        return inside
    finite = np.flatnonzero(np.isfinite(pts).all(axis=1))
    order = finite[np.argsort(pts[finite, 1], kind="stable")]
    tx, ty = pts[order, 0], pts[order, 1]
    flip = np.zeros(len(order), dtype=bool)
    x0, y0 = poly[-1]  # the closing edge first: the toggles commute
    for x1, y1 in poly:
        lo, hi = (y0, y1) if y0 < y1 else (y1, y0)
        if lo < hi:
            a = np.searchsorted(ty, lo, side="right")
            b = np.searchsorted(ty, hi, side="right")
            if a < b:
                yflag1 = y1 >= ty[a:b]
                flip[a:b] ^= (((y1 - ty[a:b]) * (x0 - x1)
                               >= (x1 - tx[a:b]) * (y0 - y1)) == yflag1)
        x0, y0 = x1, y1
    inside[order] = flip
    return inside


def polygon_area(poly, signed=False):
    """Area of an unclosed polygon via the shoelace formula."""
    poly = np.asarray(poly, dtype=np.float64)
    x, y = poly[:, 0], poly[:, 1]
    a = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return a if signed else abs(a)


def polygon_centroid(poly):
    """Centroid of an unclosed polygon (planar shoelace centroid)."""
    poly = np.asarray(poly, dtype=np.float64)
    x, y = poly[:, 0], poly[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    cross = x * yn - xn * y
    a = 0.5 * cross.sum()
    if a == 0:
        return float(x.mean()), float(y.mean())
    cx = ((x + xn) * cross).sum() / (6 * a)
    cy = ((y + yn) * cross).sum() / (6 * a)
    return float(cx), float(cy)


def find_nearest(a, value):
    """Index of the element of sorted array ``a`` nearest to ``value``."""
    a = np.asarray(a)
    idx = int(np.searchsorted(a, value))
    if idx == 0:
        return 0
    if idx >= len(a):
        return len(a) - 1
    return idx if abs(a[idx] - value) < abs(a[idx - 1] - value) else idx - 1


def without_consecutive_duplicates(points):
    """Drop consecutive duplicate rows of an (n, d) array (reference
    utils.withoutConsecutiveDuplicates, used on traced outlines)."""
    points = np.asarray(points)
    if len(points) < 2:
        return points
    keep = np.ones(len(points), dtype=bool)
    keep[1:] = (points[1:] != points[:-1]).any(axis=1)
    return points[keep]


def wrap_lon_180(lon):
    """Wrap degrees into [-180, 180), host-side numpy float64."""
    return (np.asarray(lon, dtype=np.float64) + 180.0) % 360.0 - 180.0
