"""Bundled constellation stick-figure dataset (Xephem figures).

The data are Xephem's constellation line figures (courtesy of Elwood
Downey; BSD-licensed via AURA's misc_astro redistribution) — the same
public dataset the reference vendors as a Python table
(auromat/coordinates/constellations.py:33-49). It ships as a compressed
npz resource of the port's own (auromat_tpu_torch/resources/
constellations.npz, the JAX package's file byte for byte, built by
tools/build_constellations.py) of per-constellation (drawcode, ra_deg,
dec_deg) rows, where drawcode 0 = move (pen up) and 1 = draw (line to).
"""

import os
from functools import lru_cache

import numpy as np

_RESOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "resources", "constellations.npz")


@lru_cache(maxsize=1)
def load():
    """All constellations: dict of name -> (n, 3) float32
    (drawcode, ra_deg, dec_deg) arrays."""
    with np.load(_RESOURCE) as f:
        return {name: f[name] for name in f.files}


def figure_segments(name=None):
    """Stick-figure line segments in degrees.

    :param name: one constellation, or None for all
    :returns: dict of name -> list of ((ra1, dec1), (ra2, dec2)) segment
        tuples — the input format of the JAX package's
        ``draw.draw_constellations``
    """
    data = load()
    names = [name] if name is not None else list(data)
    out = {}
    for n in names:
        rows = data[n]
        segs = []
        for prev, cur in zip(rows[:-1], rows[1:]):
            if cur[0] == 1:  # draw from the previous point
                segs.append(((float(prev[1]), float(prev[2])),
                             (float(cur[1]), float(cur[2]))))
        out[n] = segs
    return out


@lru_cache(maxsize=1)
def bright_stars():
    """Unique figure-vertex stars as an (n, 2) float64 (ra_deg, dec_deg).

    The Xephem figures connect ~700 distinct naked-eye stars (roughly
    V < 4.5); their vertices double as an OFFLINE bright-star catalog for
    reference-star overlays when no network catalog is reachable.
    Positions are quantized to the dataset's 2-arcmin resolution and carry
    no magnitudes.
    """
    pts = np.concatenate([rows[:, 1:3] for rows in load().values()], axis=0)
    return np.unique(np.round(pts.astype(np.float64), 6), axis=0)
