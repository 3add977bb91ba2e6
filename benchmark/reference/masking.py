"""Plain reference of auromat's automatic star-field masking
(``solving/masking.py::maskStarfield`` with its defaults: gray, fudge 20
raised by 20 while the star field covers under 10%, 16x12 blocks,
``HoughLinesP(1 px, 1 deg, 200, 100, 4)`` over an 89x89 masked adaptive
threshold, the very dark and lonely blocks, Immerkaer's noise sigma),
written from the definitions of the OpenCV calls it makes. Plain PyTorch
and NumPy: it imports nothing of the program, of JAX, of OpenCV or of
SciPy. The pixel stages run in torch on the device given; the histogram,
the border following, the Hough transform, the line raster and the
rectangle search run sequentially on the host.

The definitions followed:

- gray: ``COLOR_RGB2GRAY`` in 15-bit fixed point, ``(9798 R + 19235 G +
  3735 B + 16384) >> 15``;
- ``calcHist([gray], [0], None, [256], [0, 255])``: value v in bin v, 255
  in none; float32 counts, smoothed ``(h[i-1] + h[i] + h[i+1]) / 3`` in
  float32; the first spike is the first i with ``h[i+1] < h[i]``;
  ``threshold(gray, min(spike + fudge, 150), 255, THRESH_BINARY)``;
- ``findContours(RETR_EXTERNAL)``: one outer border for each 8-connected
  component of the binary with its holes (the 4-connected zero
  components that touch no image edge) filled. Components are labelled
  by the first pixel in raster order (min-label union-find with pointer
  jumping, vectorised in torch), and a border is followed as Suzuki and
  Abe's algorithm 1 does from that pixel: clockwise from the west
  neighbour for the second point, then counterclockwise from the
  neighbour after the previous point, until the walk is back at the
  start about to take the second point again. ``contourArea`` is the
  shoelace area of the points (the simple chain drops collinear points
  only, which leaves it), ``boundingRect`` the component's box;
  OpenCV lists the contours in reverse raster order of their starts, so
  the biggest on a tie is the one starting last;
- ``blur(img, (k, k))``: the k x k mean over the reflect-101 border,
  rounded to the nearest (k*k is odd: no ties); the masked adaptive
  threshold sets a pixel where ``gray - 255 * blur(gray) / blur(mask)``
  exceeds 1, in float64, inside the mask; ``medianBlur(img, 3)`` of a
  0/255 image sets a pixel where at least 5 of its 3x3 neighbourhood
  are set, the border replicated;
- ``HoughLinesP``: OpenCV's algorithm. The set pixels in raster order
  are visited in the order of OpenCV's RNG (multiply with carry, state
  2^64 - 1, ``state = (state & 0xffffffff) * 4164903690 + (state >>
  32)``, the drawn pixel replaced by the last); a visited pixel that is
  still set votes ``rint(x cos(n theta) / rho + y sin(n theta) / rho)``
  in float32 (theta and 1/rho rounded to float32 first, each table entry
  computed in double) for every angle; the first maximum at or above
  the threshold walks both ways in 16-bit fixed point, bridging gaps of
  up to ``line_gap``, then clears (and, for a line of at least
  ``line_length`` along either axis, takes back the votes of) the set
  pixels up to each end. The counts of the trajectory: ``voters`` (the
  visited pixels still set), ``triggers`` (votes that reached the
  threshold), ``clear_steps`` (positions the clearing walks visit, both
  directions, the seed in each, up to and including each end) and
  ``lines``;
- ``line(img, p0, p1, 255)``: ``LineIterator`` with 8-connectivity drawn
  left to right: the major axis steps by one, the minor one when the
  error term is negative;
- the largest all-true rectangle of the star blocks: of the largest area,
  the one whose bottom row is the highest, then whose right edge is the
  leftmost, then the tallest (the order the stack search of the
  original meets them in);
- Immerkaer (1996): ``sqrt(pi / 2) * sum |I * L| / (6 (W - 2) (H - 2))``
  over the valid part of the convolution with ``[[1, -2, 1], [-2, 4,
  -2], [1, -2, 1]]``, in float64; sigma is ``max(0.9, 2.5 sigma)``.

Departures from the original, none of which changes a result:

- ``fillPoly`` of a big contour is taken as its component's pixels with
  the holes filled. The border runs through pixel centres, so the
  polygon covers exactly those pixels, and only the blocks they touch
  are read.
- Only the borders that can matter are followed: a component whose box
  is w x h has a border of area at most (w - 1)(h - 1), so the borders
  of boxes too small to be big are followed only while they could still
  be the biggest.
- A 16-bit-fixed-point walk of OpenCV's stops at the image's edge; the
  clearing walks never reach it (they stop at the ends the first walks
  found), so they are not clipped here either.
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch

BIG_AREA_RATIO = 0.000013
MAX_THRESHOLD = 150
HOUGH = {"rho": 1.0, "theta": math.pi / 180, "threshold": 200, "line_length": 100,
         "line_gap": 4}
COUNTS = ("voters", "triggers", "clear_steps", "lines")

_MWC = 4164903690  # the multiplier of OpenCV's RNG
_SHIFT = 16  # fixed-point fraction bits of the Hough walks
# the eight neighbours (dx, dy), counterclockwise on the screen (y down)
_DIRS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


@dataclass
class Masked:
    """The reference's answer for one frame and the work it found.

    :param mask: (h, w) bool, True on the star field
    :param sigma: the scaled noise sigma
    :param counts: the Hough trajectory's counts (``COUNTS``)
    :param candidates: set pixels of the Hough input
    :param numangle: the Hough transform's angles
    :param binarizations: one (components, border pixels) a binarization of
        the dark-area step: the outer borders it has, and the pixels of the
        hole-filled components that touch the outside (4-neighbours)
    """

    mask: np.ndarray
    sigma: float
    counts: dict
    candidates: int
    numangle: int
    binarizations: list = field(default_factory=list)

    @property
    def shape(self):
        return self.mask.shape


def gray(rgb):
    """(h, w) uint8 gray of an (h, w, 3) uint8 RGB tensor."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + 16384) >> 15).to(torch.uint8)


def blocks(shape):
    """(block height, block width): 16 blocks across, 12 down (8 where 12
    do not divide the height)."""
    h, w = shape
    ny = 12 if h % 12 == 0 else 8
    if h % ny or w % 16:
        raise ValueError(f"{w}x{h} is not divisible into 16x{ny} blocks")
    return h // ny, w // 16


def block_any(t, block):
    """(h, w) bool tensor -> (h // bh, w // bw): any pixel of a block set."""
    bh, bw = block
    h, w = t.shape
    return t.reshape(h // bh, bh, w // bw, bw).any(3).any(1)


def clear_blocks(mask, bad, block):
    """Unset every pixel of the blocks ``bad`` marks, in place."""
    bh, bw = block
    full = bad.repeat_interleave(bh, 0).repeat_interleave(bw, 1)
    mask &= ~full


def first_spike(g):
    """The first spike of ``calcHist``'s smoothed float32 histogram."""
    hist = np.bincount(g.reshape(-1).cpu().numpy(), minlength=256).astype(np.float32)
    hist[255] = 0  # the range [0, 255) leaves 255 out
    smooth = hist.copy()
    for i in range(1, 255):
        smooth[i] = (hist[i - 1] + hist[i] + hist[i + 1]) / np.float32(3)
    for i in range(255):
        if smooth[i + 1] < smooth[i]:
            return i
    return 0


def components(on, connectivity):
    """Each set pixel of the (h, w) bool tensor ``on`` labelled with the flat
    index of its component's first pixel in raster order (int64), -1
    elsewhere; 8- or 4-connected. The runs of set pixels along the rows
    are numbered in raster order; the runs of neighbouring rows that touch
    are paired (once, where they first touch); every pair hooks the larger
    of its two runs' roots onto the smaller, then every run jumps to its
    root, until each pair shares one."""
    h, w = on.shape
    dev = on.device
    starts = on.clone()
    starts[:, 1:] &= ~on[:, :-1]
    first = torch.nonzero(starts.view(-1)).view(-1)  # a run's first pixel
    if not len(first):
        return torch.full((h, w), -1, dtype=torch.int64, device=dev)
    run = (torch.cumsum(starts.view(-1), 0) - 1).view(h, w)  # a pixel's run
    up, down = on[:-1], on[1:]
    both = up & down
    below = both.clone()
    below[:, 1:] &= ~both[:, :-1]  # the pixels to the left pair the same runs
    a, b = [run[:-1][below]], [run[1:][below]]
    if connectivity == 8:  # diagonals, where the pixel below does not pair them
        right = up[:, :-1] & down[:, 1:] & ~down[:, :-1]
        left = up[:, 1:] & down[:, :-1] & ~down[:, 1:]
        a += [run[:-1, :-1][right], run[:-1, 1:][left]]
        b += [run[1:, 1:][right], run[1:, :-1][left]]
    a, b = torch.cat(a), torch.cat(b)
    root = torch.arange(len(first), device=dev)
    while True:  # a pair that shares a root keeps sharing one
        ra, rb = root[a], root[b]
        apart = ra != rb
        if not bool(apart.any()):
            break
        a, b, ra, rb = a[apart], b[apart], ra[apart], rb[apart]
        lo = torch.minimum(ra, rb)
        root.scatter_reduce_(0, ra, lo, "amin")
        root.scatter_reduce_(0, rb, lo, "amin")
        while True:
            nxt = root[root]
            if torch.equal(nxt, root):
                break
            root = nxt
    return torch.where(on, first[root[run.clamp(min=0)]], -1)


def fill_holes(binary):
    """The bool tensor ``binary`` with its holes set: the zero pixels whose
    4-connected zero component touches no image edge."""
    h, w = binary.shape
    bg = components(~binary, 4)
    edge = torch.cat([bg[0], bg[-1], bg[:, 0], bg[:, -1]])
    outside = torch.zeros(h * w + 1, dtype=torch.bool, device=binary.device)
    outside[edge[edge >= 0]] = True
    return binary | ~outside[torch.where(bg >= 0, bg, h * w)]


def outer_border(img, width, start):
    """The points (flat indices into ``img``, a zero-bordered bytes-like
    image ``width`` wide) of the outer border that starts at ``start``, the
    first pixel in raster order of its component."""
    offs = [dx + dy * width for dx, dy in _DIRS]
    s = 4  # the west neighbour, which is unset
    for _ in range(7):  # clockwise from the west for the second point
        s = (s - 1) & 7
        if img[start + offs[s]]:
            break
    else:
        return [start]  # a single pixel
    second = start + offs[s]
    pts, here = [], start
    while True:
        pts.append(here)
        for k in range(1, 9):  # counterclockwise from after the last point
            t = (s + k) & 7
            nxt = here + offs[t]
            if img[nxt]:
                break
        if nxt == start and here == second:
            return pts
        here, s = nxt, (t + 4) & 7


def area2(pts, width):
    """Twice the shoelace area of a closed chain of flat indices."""
    p = np.asarray(pts, dtype=np.int64)
    x, y = p % width, p // width
    return abs(int((x * np.roll(y, -1) - np.roll(x, -1) * y).sum()))


def contour_mask(binary, blacken_lower_part):
    """The dark-area step's mask for one binarization (bool tensor), and
    (components, border pixels) of it."""
    h, w = binary.shape
    dev = binary.device
    block = blocks((h, w))
    filled = fill_holes(binary)
    lab = components(filled, 8).view(-1)
    flat = torch.arange(h * w, device=dev)
    roots = torch.nonzero(lab == flat).view(-1)
    n = len(roots)
    cid = torch.full((h * w,), -1, dtype=torch.int64, device=dev)
    cid[roots] = torch.arange(n, device=dev)
    on = lab >= 0
    comp = cid[lab[on]]
    ys, xs = flat[on] // w, flat[on] % w
    y1 = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce_(0, comp, ys, "amax")
    x0 = torch.full((n,), w, dtype=torch.int64, device=dev).scatter_reduce_(0, comp, xs, "amin")
    x1 = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce_(0, comp, xs, "amax")
    y0 = roots // w
    pad = torch.nn.functional.pad(filled, (1, 1, 1, 1))
    inner = (pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:])
    border_px = int((filled & ~inner).sum())

    mask = torch.ones((h, w), dtype=torch.bool, device=dev)
    if n == 0:
        return mask, (0, border_px)
    roots_h, y0_h, y1_h = roots.tolist(), y0.tolist(), y1.tolist()
    bound = ((x1 - x0) * (y1 - y0)).tolist()  # a border's area is at most this
    big2 = 2 * int(BIG_AREA_RATIO * h * w)
    img = np.pad(filled.cpu().numpy(), 1).astype(np.uint8).tobytes()
    traced = {}

    def trace(i):
        r = roots_h[i]
        start = (r // w + 1) * (w + 2) + r % w + 1
        traced[i] = area2(outer_border(img, w + 2, start), w + 2)

    for i in range(n):
        if 2 * bound[i] > big2:
            trace(i)
    best = max(traced.values(), default=-1)
    for i in sorted((i for i in range(n) if 2 * bound[i] <= big2), key=lambda i: -bound[i]):
        if 2 * bound[i] < best:
            break
        trace(i)
        best = max(best, traced[i])
    if blacken_lower_part:
        top = max(traced, key=lambda i: (traced[i], roots_h[i]))
        y, height = y0_h[top], y1_h[top] - y0_h[top] + 1
        from_y = y if (y > h / 3 and y + height > h / 2) else h // 2
        mask[math.ceil(from_y / block[0]) * block[0]:] = False
    big = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    big[[i for i, a in traced.items() if a > big2]] = True
    painted = big[torch.where(on, cid[lab.clamp(min=0)], n)].view(h, w)
    clear_blocks(mask, block_any(painted, block), block)
    return mask, (n, border_px)


def box_mean(img, k):
    """``blur(img, (k, k))`` of a uint8 tensor: the rounded k x k mean over
    the reflect-101 border."""
    h, w = img.shape
    p = k // 2

    def reflect(n):
        i = torch.arange(-p, n + p, device=img.device).abs()
        return torch.where(i > n - 1, 2 * (n - 1) - i, i)

    x = img.to(torch.int64)[reflect(h)][:, reflect(w)]
    c = torch.nn.functional.pad(x.cumsum(0), (0, 0, 1, 0))
    x = c[k:] - c[:-k]
    c = torch.nn.functional.pad(x.cumsum(1), (1, 0))
    s = c[:, k:] - c[:, :-k]
    return torch.round(s.double() / (k * k)).to(torch.uint8)


def median3(binary):
    """``medianBlur`` (3x3) of a bool tensor, the border replicated."""
    h, w = binary.shape
    x = binary.to(torch.int32)
    x = torch.cat([x[:1], x, x[-1:]])
    x = torch.cat([x[:, :1], x, x[:, -1:]], 1)
    n = sum(x[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3))
    return n >= 5


def hough_setup(shape, rho, theta):
    """(numangle, numrho, float32 cos table, float32 sin table)."""
    h, w = shape
    theta = float(np.float32(theta))
    irho = float(np.float32(1) / np.float32(rho))
    numangle = math.floor(math.pi / theta) + 1
    if numangle > 1 and abs(math.pi - (numangle - 1) * theta) < theta / 2:
        numangle -= 1
    numrho = int(np.rint(np.float32(((w + h) * 2 + 1) / np.float32(rho))))
    cos_t = np.array([math.cos(n * theta) * irho for n in range(numangle)], np.float32)
    sin_t = np.array([math.sin(n * theta) * irho for n in range(numangle)], np.float32)
    return numangle, numrho, cos_t, sin_t


def visit_order(count):
    """The order ``HoughLinesP`` visits ``count`` points in: OpenCV's RNG
    draws an index below the points left; the point drawn is replaced by
    the last one left."""
    left = list(range(count))
    order = []
    state = (1 << 64) - 1
    for n in range(count, 0, -1):
        state = (state & 0xFFFFFFFF) * _MWC + (state >> 32)
        i = (state & 0xFFFFFFFF) % n
        order.append(left[i])
        left[i] = left[n - 1]
    return order


def hough_lines(binary, rho, theta, threshold, line_length, line_gap, votes=np.float32):
    """``HoughLinesP`` of an (h, w) bool array: (lines (n, 4) int32 as
    (x0, y0, x1, y1), counts, angles). ``votes`` is the float type the
    votes are computed in (float32 in OpenCV); a vote outside the
    accumulator, which only a lower precision casts, goes to its edge."""
    h, w = binary.shape
    numangle, numrho, cos_t, sin_t = hough_setup((h, w), rho, theta)
    cos_v, sin_v = cos_t.astype(votes), sin_t.astype(votes)
    rows = np.arange(numangle, dtype=np.int64) * numrho + (numrho - 1) // 2

    def cells(x, y):  # (len(x), numangle) flat accumulator cells voted for
        r = np.rint(x.astype(votes)[:, None] * cos_v + y.astype(votes)[:, None] * sin_v)
        r = r.astype(np.int64)
        if votes is not np.float32:
            r = np.clip(r, -((numrho - 1) // 2), numrho // 2)
        return rows + r

    ys, xs = np.nonzero(binary)
    order = np.array(visit_order(len(xs)), dtype=np.int64)
    vx, vy = xs[order], ys[order]
    mask = bytearray(binary.astype(np.uint8).tobytes())
    acc = np.zeros(numangle * numrho, dtype=np.int32)
    one = np.float32(1 << _SHIFT)
    lines = []
    voters = triggers = clear_steps = 0
    chunk = 1 << 14
    for c0 in range(0, len(vx), chunk):
        px, py = vx[c0:c0 + chunk].tolist(), vy[c0:c0 + chunk].tolist()
        voted = cells(vx[c0:c0 + chunk], vy[c0:c0 + chunk])
        for k, (x, y) in enumerate(zip(px, py)):
            if not mask[y * w + x]:
                continue
            voters += 1
            cell = voted[k]
            got = acc[cell] + 1
            acc[cell] = got
            if got.max() < threshold:
                continue
            triggers += 1
            n = int(np.argmax(got))  # the first maximum
            a, b = -sin_t[n], cos_t[n]
            if abs(a) > abs(b):  # x is the major axis
                xflag, dx0 = True, (1 if a > 0 else -1)
                dy0 = int(np.rint(np.float32(b * one) / abs(a)))
                x0, y0 = x, (y << _SHIFT) + (1 << (_SHIFT - 1))
            else:
                xflag, dy0 = False, (1 if b > 0 else -1)
                dx0 = int(np.rint(np.float32(a * one) / abs(b)))
                x0, y0 = (x << _SHIFT) + (1 << (_SHIFT - 1)), y
            ends = []
            for sx, sy in ((dx0, dy0), (-dx0, -dy0)):
                cx, cy, gap, end = x0, y0, 0, None
                while True:
                    jx, iy = (cx, cy >> _SHIFT) if xflag else (cx >> _SHIFT, cy)
                    if jx < 0 or jx >= w or iy < 0 or iy >= h:
                        break
                    if mask[iy * w + jx]:
                        gap, end = 0, (jx, iy)
                    else:
                        gap += 1
                        if gap > line_gap:
                            break
                    cx += sx
                    cy += sy
                ends.append(end)
            good = (abs(ends[1][0] - ends[0][0]) >= line_length
                    or abs(ends[1][1] - ends[0][1]) >= line_length)
            cleared = []
            for (sx, sy), end in zip(((dx0, dy0), (-dx0, -dy0)), ends):
                cx, cy = x0, y0
                while True:
                    clear_steps += 1
                    jx, iy = (cx, cy >> _SHIFT) if xflag else (cx >> _SHIFT, cy)
                    if mask[iy * w + jx]:
                        mask[iy * w + jx] = 0
                        cleared.append((jx, iy))
                    if (jx, iy) == end:
                        break
                    cx += sx
                    cy += sy
            if good:  # the line's pixels take their votes back
                back = np.array(cleared, dtype=np.int64)
                np.subtract.at(acc, cells(back[:, 0], back[:, 1]).ravel(), 1)
                lines.append((*ends[0], *ends[1]))
    counts = dict(zip(COUNTS, (voters, triggers, clear_steps, len(lines))))
    return np.array(lines, dtype=np.int32).reshape(-1, 4), counts, numangle


def line_points(x0, y0, x1, y1):
    """The pixels ``line`` sets from (x0, y0) to (x1, y1): [(x, y)]."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    out = []
    for _ in range(dx + 1):
        out.append((x, y))
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += sx if minor else 0
        else:
            x += sx
            y += sy if minor else 0
    return out


def largest_rectangle(grid):
    """((row, col), (height, width)) of the largest all-true rectangle of a
    small bool array; ties as the module's docstring says."""
    rows, cols = grid.shape
    c = np.zeros((rows + 1, cols + 1), dtype=np.int64)
    c[1:, 1:] = grid.astype(np.int64).cumsum(0).cumsum(1)
    best, key = None, None
    for top in range(rows):
        for bottom in range(top + 1, rows + 1):
            for left in range(cols):
                for right in range(left + 1, cols + 1):
                    hh, ww = bottom - top, right - left
                    if c[bottom, right] - c[top, right] - c[bottom, left] + c[top, left] != hh * ww:
                        break  # wider is not all true either
                    k = (hh * ww, -bottom, -right, hh)
                    if key is None or k > key:
                        best, key = ((top, left), (hh, ww)), k
    return best


def noise_sigma(plane):
    """Immerkaer's noise sigma of a 2-D array, float64."""
    im = np.asarray(plane, dtype=np.float64)
    h, w = im.shape
    lap = (im[:-2, :-2] - 2 * im[:-2, 1:-1] + im[:-2, 2:]
           - 2 * im[1:-1, :-2] + 4 * im[1:-1, 1:-1] - 2 * im[1:-1, 2:]
           + im[2:, :-2] - 2 * im[2:, 1:-1] + im[2:, 2:])
    return math.sqrt(math.pi / 2) * float(np.abs(lap).sum()) / (6 * (w - 2) * (h - 2))


def mask_starfield(rgb, device, channel=None, blacken_lower_part=True,
                   ignore_very_dark=True, votes=np.float32):
    """The star-field mask and sigma of an (h, w, 3) uint8 RGB host array
    (its gray, or its ``channel``: 'R', 'G' or 'B'), with the work found
    on the way: a :class:`Masked`."""
    im = torch.from_numpy(np.ascontiguousarray(rgb)).to(device)
    g = gray(im) if channel is None else im[..., "RGB".index(channel.upper())]
    del im
    h, w = g.shape
    block = blocks((h, w))

    # step 1: the dark-area mask, the threshold raised while the star field
    # covers under 10%
    fudge, found = 20, []
    while True:
        spike = first_spike(g)
        mask, work = contour_mask(g > min(spike + fudge, MAX_THRESHOLD), blacken_lower_part)
        found.append(work)
        if int(mask.sum()) / mask.numel() >= 0.1 or fudge > 100:
            break
        fudge += 20
    g = torch.where(mask, g, torch.zeros((), dtype=g.dtype, device=g.device))

    # step 2a: lines over the masked adaptive threshold
    conv = box_mean(g, 89).double()
    seen = box_mean(mask.to(torch.uint8) * 255, 89).double()
    binary = median3((g.double() - 255 * (conv / seen) > 1) & mask).cpu().numpy()
    lines, counts, numangle = hough_lines(binary, **HOUGH, votes=votes)
    if len(lines):
        drawn = np.zeros((h, w), dtype=bool)
        for x0, y0, x1, y1 in lines.tolist():
            for x, y in line_points(x0, y0, x1, y1):
                drawn[y, x] = True
        clear_blocks(mask, block_any(torch.from_numpy(drawn).to(device), block), block)

    # step 2b: blocks that are (nearly) pure black
    if ignore_very_dark:
        lit = box_mean(g, 3) >= max(30, spike + 20)
        clear_blocks(mask, ~block_any(lit, block), block)

    # step 3: star blocks with no star block around them
    star = ~block_any(~mask, block)
    s = torch.nn.functional.pad(star.to(torch.int32), (1, 1, 1, 1))
    ny, nx = star.shape
    around = sum(s[dy:dy + ny, dx:dx + nx] for dy in range(3) for dx in range(3)) - star.int()
    clear_blocks(mask, star & (around == 0), block)

    # the noise sigma of the largest star rectangle
    star = (~block_any(~mask, block)).cpu().numpy()
    if star.any():
        (ry, rx), (rh, rw) = largest_rectangle(star)
        bh, bw = block
        plane = g[ry * bh:(ry + rh) * bh, rx * bw:(rx + rw) * bw]
    else:
        plane = g
    sigma = max(0.9, 2.5 * noise_sigma(plane.cpu().numpy()))
    return Masked(mask=mask.cpu().numpy(), sigma=sigma, counts=counts,
                  candidates=int(binary.sum()), numangle=numangle, binarizations=found)
