"""Bundled map-background datasets: coastline polylines + city points.

Counterpart of ``auromat_tpu.coastlines`` (host numpy). The reference
draws coastlines/cities via Basemap's bundled GSHHS data and Natural Earth
shapefiles (reference draw.py:319-362, 403-420). Here a coarse
hand-digitized coastline (~2-4 deg fidelity, auroral-zone coasts densest)
and the public-domain Natural Earth populated places ship as npz resources
of the port's own (auromat_tpu_torch/resources/coastlines_coarse.npz and
cities_ne50m.npz, the JAX package's files byte for byte, built by
tools/build_coastlines.py and tools/build_cities.py) — geographic context
for diagnostic plots. For publication-grade maps pass your own
GSHHS/Natural Earth polylines to ``draw_stereographic(coastlines=...)``.
"""

import os
from functools import lru_cache

import numpy as np

_RES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "resources")


@lru_cache(maxsize=1)
def coastline_latlon():
    """The bundled coastline as an (n, 2) float32 array of [lat, lon]
    polyline vertices with NaN separators between segments (the format
    ``draw_stereographic(coastlines=...)`` consumes)."""
    with np.load(os.path.join(_RES, "coastlines_coarse.npz")) as d:
        return np.stack([d["lats"], d["lons"]], axis=-1)


@lru_cache(maxsize=1)
def land_rings():
    """Closed land polygons for the filled land/sea map background
    (reference draw.py:345 ``drawlsmask``): list of (n, 2) float32
    [lat, lon] rings (first vertex == last). Same fidelity caveats as
    :func:`coastline_latlon`; the open Eurasia coast polylines are
    stitched into one closed ring by tools/build_coastlines.py."""
    with np.load(os.path.join(_RES, "coastlines_coarse.npz")) as d:
        flat = np.stack([d["ring_lats"], d["ring_lons"]], axis=-1)
    brk = np.flatnonzero(np.isnan(flat[:, 0]))
    return [r for r in np.split(flat, brk)
            for r in [r[~np.isnan(r[:, 0])]] if len(r)]


@lru_cache(maxsize=1)
def city_points():
    """Bundled Natural Earth populated places: (lats, lons, natscale)
    float32 arrays (~1250 places; natscale = display-size rank)."""
    with np.load(os.path.join(_RES, "cities_ne50m.npz")) as d:
        return d["lats"], d["lons"], d["natscale"]


def near_hemisphere(lats_deg, lons_deg, lat0, lon0, min_cos=0.05):
    """Mask for points within ~87 deg great-circle distance of (lat0, lon0)
    — stereographic projections blow up towards the antipode, so plots
    drop the far hemisphere."""
    lat = np.deg2rad(np.asarray(lats_deg, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lons_deg, dtype=np.float64))
    cosc = (np.sin(np.deg2rad(lat0)) * np.sin(lat)
            + np.cos(np.deg2rad(lat0)) * np.cos(lat)
            * np.cos(lon - np.deg2rad(lon0)))
    return cosc > min_cos
