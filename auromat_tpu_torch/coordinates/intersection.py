"""Ray/sphere and ray/ellipsoid intersection as torch tensor code.

Counterpart of ``auromat_tpu.coordinates.intersection``; the semantics are
the reference's (auromat/coordinates/intersection.py):

* the quadratic is solved in ellipsoid-scaled space;
* ``directed=True`` returns the first hit along the ray; an origin inside
  the body returns the forward exit point; a hit behind the origin is NaN;
* ``directed=False`` returns the hit closest (by |distance|) to the origin;
* a miss is NaN.

NaN is the mask of the whole framework, so the NaN rules are load-bearing.
Each function computes in the dtype and on the device of
``line_direction``; ``line_origin`` broadcasts against it, so an origin of
shape (S, 1, 1, 3) serves a batch of S stations' (S, h, w, 3) rays.
"""

import torch


def _as_like(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _is_inside_ellipsoid(point, a, b):
    x, y, z = point[..., 0], point[..., 1], point[..., 2]
    return (x / a) ** 2 + (y / a) ** 2 + (z / b) ** 2 < 1.0


def _scaled_terms(a, b, origin, direction):
    """(dir·ori, dir·dir, root term) of the quadratic in scaled space."""
    inv = _as_like([1.0 / a, 1.0 / a, 1.0 / b], direction)
    ds = direction * inv  # scaled direction
    os_ = -origin * inv  # scaled (negated) origin, the reference's sign use
    dir_dot_ori = torch.sum(ds * os_, dim=-1)
    dir_dot_dir = torch.sum(ds * ds, dim=-1)
    ori_dot_ori = torch.sum(os_ * os_, dim=-1)
    root_term = (dir_dot_ori * dir_dot_ori - ori_dot_ori * dir_dot_dir
                 + dir_dot_dir)
    return dir_dot_ori, dir_dot_dir, root_term


def ellipsoid_line_intersection(a, b, line_origin, line_direction,
                                directed=True):
    """Intersection points of rays with an origin-centred ellipsoid of
    revolution.

    :param a: equatorial semi-axis
    :param b: polar semi-axis
    :param line_origin: (..., 3) origin(s), broadcastable to the directions
    :param line_direction: (..., 3) direction vectors (need not be unit)
    :returns: (..., 3) intersection points; NaN where there is no (forward)
        hit
    """
    direction = torch.as_tensor(line_direction)
    origin = _as_like(line_origin, direction)
    dir_dot_ori, dir_dot_dir, root_term = _scaled_terms(a, b, origin,
                                                        direction)
    root = torch.sqrt(root_term)  # NaN when there is no intersection
    d1 = dir_dot_ori - root
    d2 = dir_dot_ori + root
    if directed:
        inside = _is_inside_ellipsoid(origin, a, b)
        d_min = torch.where(inside, d2, d1)
        d_min = torch.where(d_min < 0, torch.nan, d_min)
    else:
        d_min = torch.where(torch.abs(d1) < torch.abs(d2), d1, d2)
    d_min = d_min / dir_dot_dir
    return direction * d_min[..., None] + origin


def ellipsoid_line_intersects(a, b, line_origin, line_direction,
                              directed=True):
    """Boolean variant of :func:`ellipsoid_line_intersection`.

    Reference: auromat/coordinates/intersection.py:165-237.
    """
    direction = torch.as_tensor(line_direction)
    origin = _as_like(line_origin, direction)
    dir_dot_ori, _, root_term = _scaled_terms(a, b, origin, direction)
    if directed:
        root = torch.sqrt(root_term)
        inside = _is_inside_ellipsoid(origin, a, b)
        d_min = torch.where(inside, dir_dot_ori + root, dir_dot_ori - root)
        return d_min >= 0
    return root_term >= 0


def sphere_line_intersection(radius, line_origin, line_direction,
                             directed=True):
    """Intersection of rays with an origin-centred sphere.

    ``line_direction`` must be unit vectors (the reference's contract,
    auromat/coordinates/intersection.py:12-48).
    """
    direction = torch.as_tensor(line_direction)
    origin = _as_like(line_origin, direction)
    dir_pos_dot = torch.sum(direction * origin, dim=-1)
    root_term = (dir_pos_dot * dir_pos_dot - torch.sum(origin * origin, dim=-1)
                 + radius * radius)
    root = torch.sqrt(root_term)
    neg = -dir_pos_dot
    d1 = neg - root
    d2 = neg + root
    if directed:
        inside = torch.linalg.norm(origin, dim=-1) < radius
        d_min = torch.where(inside, d2, d1)
        d_min = torch.where(d_min < 0, torch.nan, d_min)
    else:
        d_min = torch.where(torch.abs(d1) < torch.abs(d2), d1, d2)
    return origin + d_min[..., None] * direction
