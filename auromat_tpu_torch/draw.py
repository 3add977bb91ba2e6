"""Map and diagnostic plotting.

Counterpart of ``auromat_tpu.draw``. Covers the drawing surface of the
reference (auromat/draw.py) with plain matplotlib — no basemap dependency.
The stereographic projection is computed directly (it is a three-line
formula); coastlines are optional (supply a (n, 2) lat/lon polyline file —
basemap's bundled datasets are not shipped).

matplotlib (and PIL, for the KML overlay's PNG) is imported inside the
functions that draw, so the module imports where neither is installed; a
figure function called there raises the ImportError. The entry points that
compute on a device — ``draw_kml_image`` (``resample('mean')``),
``draw_horizon`` (``georeference_points`` at altitude 0), ``draw_ra_dec``
(``tan_pix2world``) and ``draw_constellations`` (``tan_world2pix``) — take
``device="cuda"`` like every other entry point of the port (pass
``device="cpu"`` for the CPU) and raise without a card. Each does its
device work in a private helper that returns host numpy arrays and needs
neither matplotlib nor PIL (``_kml_overlay``, ``_horizon_grid``,
``_ra_dec_grid``, ``_constellation_segments``), and only then draws.

Main entry points:
  draw_plot                  lat/lon plate-carree polygon plot
  draw_stereographic         stereographic projection plot (geo or MLat/MLT)
  draw_mlat_mlt_polar        polar MLat/MLT dial plot
  draw_kml_image             Google-Earth KML + ground overlay
  draw_scanlines_co          keogram-style sequence coroutine
  draw_parallels_meridians   graticule in image space
  draw_horizon               Earth horizon overlay in image space
  draw_histogram             simple histogram plot (masking diagnostics)
  draw_astrometry_pixel_scales  pixel-scale diagnostic
  draw_scanlines_map_co      geodesic scanline sequence map (coroutine)
  draw_azimuth_plots_co      centroid/footpoint track diagnostics (coroutine)
  draw_line_plot / draw_corr_seq_plot / draw_astrometry_rotation_angles /
  draw_cd11_cd21 / draw_ra_dec_seq / draw_right_ascension /
  draw_declination / draw_camera_footpoints   solved-sequence diagnostics
  draw_date / draw_heatmaps / draw_array_heatmap /
  draw_lens_distortion_derivative             per-mapping diagnostics
All ``draw_*`` functions return a matplotlib Figure; use
:func:`auromat_tpu_torch.draw_helpers.save_fig` to write it out.
"""

import os

import numpy as np
import torch

from auromat_tpu_torch.draw_helpers import (
    mlt_formatter,
    overlap_polygons,
    polygons_from_mapping_or_collection,
    save_fig,  # noqa: F401  (re-export, reference draw.saveFig)
    set_colors,  # noqa: F401  (re-export, reference draw.setColors)
)
from auromat_tpu_torch.coordinates.transform import mlt_to_sm_lon
from auromat_tpu_torch.ops.georef import compute_device


def _new_axes(figsize=(10, 8), facecolor="white"):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize, facecolor=facecolor)
    return fig, ax


def _poly_collection(ax, verts, colors, rasterized=True):
    from matplotlib.collections import PolyCollection

    coll = PolyCollection(
        overlap_polygons(verts, 0.12), facecolors=colors, edgecolors="none",
        rasterized=rasterized,
    )
    ax.add_collection(coll)
    return coll


def draw_plot(mapping, figsize=(10, 8)):
    """Pixel polygons in raw lat/lon coordinates (reference draw.py:67)."""
    verts, colors = polygons_from_mapping_or_collection(mapping)
    fig, ax = _new_axes(figsize)
    _poly_collection(ax, verts, colors)
    ax.set_xlim(np.nanmin(verts[..., 0]), np.nanmax(verts[..., 0]))
    ax.set_ylim(np.nanmin(verts[..., 1]), np.nanmax(verts[..., 1]))
    ax.set_xlabel("Longitude [deg]")
    ax.set_ylabel("Latitude [deg]")
    ax.set_aspect("auto")
    return fig


def stereographic_project(lats_deg, lons_deg, lat0, lon0, radius=6371.0):
    """Stereographic projection about (lat0, lon0), km in the tangent plane."""
    lat = np.deg2rad(np.asarray(lats_deg, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lons_deg, dtype=np.float64))
    lat0r, lon0r = np.deg2rad(lat0), np.deg2rad(lon0)
    cosc = (
        np.sin(lat0r) * np.sin(lat)
        + np.cos(lat0r) * np.cos(lat) * np.cos(lon - lon0r)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        k = 2.0 * radius / (1.0 + cosc)
    x = k * np.cos(lat) * np.sin(lon - lon0r)
    y = k * (
        np.cos(lat0r) * np.sin(lat)
        - np.sin(lat0r) * np.cos(lat) * np.cos(lon - lon0r)
    )
    return x, y


def _graticule(ax, lat0, lon0, width_km, height_km, mlt_labels=False):
    lat_lines = np.arange(-80, 81, 5)
    lon_lines = np.arange(-180, 180, 10)
    for lat in lat_lines:
        lons = np.linspace(-180, 180, 361)
        x, y = stereographic_project(np.full_like(lons, float(lat)), lons, lat0, lon0)
        ax.plot(x, y, color="gray", lw=0.4, alpha=0.6, zorder=1)
    for lon in lon_lines:
        lats = np.linspace(-80, 80, 161)
        x, y = stereographic_project(lats, np.full_like(lats, float(lon)), lat0, lon0)
        ax.plot(x, y, color="gray", lw=0.4, alpha=0.6, zorder=1)


def _draw_cities(ax, lat0, lon0, color="red", alpha=0.6, min_natscale=0.0):
    """Scatter bundled Natural Earth city points onto a stereographic axes
    (reference draw.py:403-420 _drawCities; near hemisphere only)."""
    from auromat_tpu_torch.coastlines import city_points, near_hemisphere

    lats, lons, natscale = city_points()
    keep = natscale >= min_natscale
    lats, lons, natscale = lats[keep], lons[keep], natscale[keep]
    near = near_hemisphere(lats, lons, lat0, lon0)
    x, y = stereographic_project(lats[near], lons[near], lat0, lon0)
    s = ax.scatter(x, y, natscale[near] / 10.0, color, marker="o",
                   edgecolors="none", zorder=10, alpha=alpha)
    s.set_gid("cities")  # addressable in svg output, like the reference
    return s


def _draw_lsmask(ax, lat0, lon0, ocean_color="0.8", land_color="0.6",
                 min_cos=0.05):
    """Filled land/sea background (reference draw.py:345 ``drawlsmask``,
    same ocean_color='0.8'/land_color='0.6'): an ocean disk covering the
    plotted near hemisphere, with the bundled closed land rings
    (auromat_tpu_torch.coastlines.land_rings) filled on top. Far-side ring
    vertices are clamped RADIALLY onto the cap circle (the stereographic
    image of the far hemisphere is the disk exterior, so azimuths stay
    correct): the ring stays closed and hidden arcs ride the horizon
    instead of chording across the visible map, which could paint ocean
    as land between disjoint visible arcs. (A ring enclosing the exact
    antipode would still over-fill — not reachable from the bundled
    rings for real auroral footprint centres.)"""
    import matplotlib.patches as mpatches

    from auromat_tpu_torch.coastlines import land_rings, near_hemisphere

    # stereographic radius of the near-hemisphere cap (cos c = min_cos):
    # r = 2 R tan(c/2) = 2 R sin(c) / (1 + cos(c))
    r_cap = 2.0 * 6371.0 * np.sqrt(1.0 - min_cos**2) / (1.0 + min_cos)
    ax.add_patch(mpatches.Circle((0.0, 0.0), r_cap, facecolor=ocean_color,
                                 edgecolor="none", zorder=0.4))
    for ring in land_rings():
        near = near_hemisphere(ring[:, 0], ring[:, 1], lat0, lon0,
                               min_cos=min_cos)
        if not near.any():
            continue
        x, y = stereographic_project(ring[:, 0], ring[:, 1], lat0, lon0)
        r = np.hypot(x, y)
        # keep only vertices whose projection is finite (a vertex at the
        # exact antipode diverges); then clamp |r| to the cap
        finite = np.isfinite(r)
        x, y, r = x[finite], y[finite], r[finite]
        with np.errstate(invalid="ignore", divide="ignore"):
            scale = np.where(r > r_cap, r_cap / r, 1.0)
        ax.fill(x * scale, y * scale, facecolor=land_color,
                edgecolor="none", zorder=0.5)


def draw_stereographic(mapping_or_collection, mlatmlt=False, *,
                       coastlines="default", cities=False, lsmask=False,
                       figsize=(10, 10),
                       bgcolor="black", bounding_box=None):
    """Stereographic plot centred on the data (reference draw.py:140-222).

    :param bounding_box: optional BoundingBox fixing the map centre/extent
        instead of the data's own — pass the merged sequence bbox so every
        movie frame shares one map (reference drawStereographic's
        ``boundingBox``; userguide movie recipe). Under ``mlatmlt`` it
        fixes only the extent (a BoundingBox is geographic; the centre
        stays the magnetic vertex mean)
    :param mlatmlt: plot in the MLat/MLT system (drawStereographicMLatMLT)
    :param coastlines: (n, 2) lat/lon polyline array (NaN-separated), the
        string 'default' for the bundled coarse world coastline
        (auromat_tpu_torch.coastlines — the out-of-box map background the
        reference gets from Basemap, reference draw.py:319-362), or None
        to disable. Geographic plots only (skipped under mlatmlt).
    :param cities: scatter the bundled Natural Earth populated places
        (reference draw.py:403-420); geographic plots only.
    :param lsmask: fill a land/sea background (reference draw.py:345
        ``drawlsmask``, ocean '0.8' / land '0.6') from the bundled closed
        land rings; geographic plots only. Off by default (the reference's
        Basemap raster default predates black-background aurora plots —
        filled gray land under a black figure is an explicit opt-in here).
    """
    verts, colors = polygons_from_mapping_or_collection(
        mapping_or_collection, mlatmlt=mlatmlt
    )
    if mlatmlt:
        # verts currently hold (mlt, mlat); convert mlt -> SM longitude
        verts = verts.copy()
        verts[..., 0] = mlt_to_sm_lon(verts[..., 0])
    bb = (bounding_box if bounding_box is not None
          else mapping_or_collection.boundingBox)
    center = bb.center
    size = bb.size
    lat0, lon0 = center.lat, center.lon
    if mlatmlt:
        # centre in magnetic coordinates: use mean of vertices — a caller-
        # supplied bounding_box is geographic, so under mlatmlt it fixes
        # only the EXTENT (bb.size below), never the centre (its lat/lon
        # are meaningless in the SM frame and would place the data
        # off-screen)
        lat0 = float(np.nanmean(verts[..., 1]))
        lon0 = float(np.nanmean(verts[..., 0]))

    px, py = stereographic_project(verts[..., 1], verts[..., 0], lat0, lon0)
    pverts = np.stack([px, py], axis=-1)

    fig, ax = _new_axes(figsize, facecolor=bgcolor)
    ax.set_facecolor(bgcolor)
    if lsmask and not mlatmlt:
        _draw_lsmask(ax, lat0, lon0)
    _graticule(ax, lat0, lon0, size.width, size.height)
    if mlatmlt:
        # geographic polylines (bundled OR caller-supplied) are meaningless
        # in the MLat/MLT frame — the docstring scopes the whole parameter
        # to geographic plots
        coastlines = None
    elif isinstance(coastlines, str) and coastlines == "default":
        from auromat_tpu_torch.coastlines import coastline_latlon

        coastlines = coastline_latlon()
    if coastlines is not None:
        from auromat_tpu_torch.coastlines import near_hemisphere

        cx, cy = stereographic_project(coastlines[:, 0], coastlines[:, 1], lat0, lon0)
        # mask the far hemisphere: stereographic blows up towards the
        # antipode and a polyline crossing it would streak across the plot
        near = near_hemisphere(coastlines[:, 0], coastlines[:, 1], lat0, lon0)
        cx = np.where(near, cx, np.nan)
        cy = np.where(near, cy, np.nan)
        ax.plot(cx, cy, color="#888888", lw=0.6, zorder=2)
    if cities and not mlatmlt:
        _draw_cities(ax, lat0, lon0)
    _poly_collection(ax, pverts, colors)
    half_w = max(size.width, 100) * 0.75
    half_h = max(size.height, 100) * 0.75
    ax.set_xlim(-half_w, half_w)
    ax.set_ylim(-half_h, half_h)
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])
    return fig


def draw_stereographic_mlat_mlt(mapping_or_collection, **kw):
    """Reference drawStereographicMLatMLT (draw.py:224)."""
    return draw_stereographic(mapping_or_collection, mlatmlt=True, **kw)


def draw_mlat_mlt_polar(mapping_or_collection, min_mlat=40, figsize=(10, 10)):
    """Polar dial: radius = 90-MLat, angle = MLT (reference draw.py:242)."""
    import matplotlib.pyplot as plt

    verts, colors = polygons_from_mapping_or_collection(
        mapping_or_collection, mlatmlt=True
    )
    # verts: (mlt hours, mlat deg) -> polar (theta, r); midnight-at-bottom
    # comes from set_theta_zero_location("S") below — adding an extra
    # -pi/2 here would rotate the DATA 6 hours against the tick labels
    theta = verts[..., 0] * (2 * np.pi / 24.0)
    r = 90.0 - verts[..., 1]
    pverts = np.stack([theta, r], axis=-1)

    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(projection="polar")
    from matplotlib.collections import PolyCollection

    ax.add_collection(PolyCollection(pverts, facecolors=colors, edgecolors="none"))
    ax.set_rmax(90 - min_mlat)
    ax.set_theta_zero_location("S")
    ax.set_xticks(np.arange(0, 2 * np.pi, np.pi / 4))
    ax.set_xticklabels([mlt_formatter(h) for h in range(0, 24, 3)])
    yticks = np.arange(10, 90 - min_mlat + 1, 10)
    ax.set_yticks(yticks)
    ax.set_yticklabels([f"{90 - t:.0f}" for t in yticks])
    return fig


def _kml_overlay(kml_path, mapping, resample_arcsec=100, device="cuda"):
    """The numbers of :func:`draw_kml_image`: the overlay's (h, w, 4) uint8
    RGBA array (alpha 0 on masked cells) and the KML text naming the PNG
    beside ``kml_path``. A mapping that is not plate carree is resampled
    with ``resample('mean')`` on ``device``. Needs neither matplotlib nor
    PIL."""
    from auromat_tpu_torch.mapping.mapping import is_plate_carree
    from auromat_tpu_torch.resample import resample

    m = mapping
    if not is_plate_carree(m.lats, m.lons):
        m = resample(mapping, arcsec_per_px=resample_arcsec, method="mean",
                     device=device)
    rgb = np.asarray(m.rgb.filled(0))
    alpha = (~m.center_mask * 255).astype(np.uint8)
    rgba = np.dstack([rgb, alpha])
    png_name = os.path.basename(os.path.splitext(kml_path)[0] + ".png")
    bb = m.boundingBox
    name = m.identifier or "mapping"
    # KML LatLonBox requires east > west: shift east +360 for boxes
    # crossing the antimeridian (else the overlay wraps the long way)
    kml_east = bb.lonEast + 360.0 if bb.lonWest > bb.lonEast else bb.lonEast
    kml = f"""<?xml version="1.0" encoding="UTF-8"?>
<kml xmlns="http://www.opengis.net/kml/2.2">
  <GroundOverlay>
    <name>{name}</name>
    <Icon><href>{png_name}</href></Icon>
    <LatLonBox>
      <north>{bb.latNorth}</north>
      <south>{bb.latSouth}</south>
      <east>{kml_east}</east>
      <west>{bb.lonWest}</west>
    </LatLonBox>
  </GroundOverlay>
</kml>
"""
    return rgba, kml


def draw_kml_image(kml_path, mapping, resample_arcsec=100, device="cuda"):
    """Google-Earth KML with a plate-carree ground overlay PNG.

    Reference drawKmlImage (draw.py:103). The mapping is resampled to a
    regular grid on ``device`` (the card by default); the PNG (written
    with PIL) + .kml file pair is written next to each other.
    """
    from auromat_tpu_torch.io import image

    rgba, kml = _kml_overlay(kml_path, mapping, resample_arcsec,
                             compute_device(device))
    png_path = os.path.splitext(kml_path)[0] + ".png"
    image.save_image(png_path, rgba)
    with open(kml_path, "w") as f:
        f.write(kml)
    return kml_path, png_path


def draw_parallels_meridians(mapping, lat_step=2.0, lon_step=5.0,
                             figsize=(12, 8)):
    """Graticule drawn in image space over the photograph.

    Contours of the per-pixel latitude/longitude grids (simpler and exact
    compared to the reference's resample-pixel-coordinates trick,
    draw.py:1482-1609).
    """
    fig, ax = _new_axes(figsize)
    ax.imshow(np.asarray(mapping.rgb_unmasked))
    lats = np.asarray(mapping.latsCenter.filled(np.nan))
    lons = np.asarray(mapping.lonsCenter.filled(np.nan))
    lat_levels = np.arange(np.floor(np.nanmin(lats)), np.ceil(np.nanmax(lats)), lat_step)
    lon_levels = np.arange(np.floor(np.nanmin(lons)), np.ceil(np.nanmax(lons)), lon_step)
    cs1 = ax.contour(lats, levels=lat_levels, colors="yellow", linewidths=0.6)
    cs2 = ax.contour(lons, levels=lon_levels, colors="cyan", linewidths=0.6)
    ax.clabel(cs1, inline=True, fontsize=7, fmt="%.0f°")
    ax.clabel(cs2, inline=True, fontsize=7, fmt="%.0f°")
    ax.set_xticks([])
    ax.set_yticks([])
    return fig


def _horizon_grid(mapping, device="cuda"):
    """The numbers of :func:`draw_horizon`: the strided pixel grid (px, py)
    (every ``max(1, w // 512)``-th pixel) and its ``hit`` mask (the pixel's
    ray meets the non-inflated Earth), from ``georeference_points`` at
    altitude 0 on ``device``; host numpy arrays."""
    from auromat_tpu_torch.ops.georef import GeorefParams, georeference_points

    h, w = mapping.img_unmasked.shape[:2]
    params = GeorefParams.from_wcs(
        _wcs_from_mapping(mapping, w, h), mapping.cameraPosGCRS,
        mapping.photoTime, altitude=0.0,
    )
    stride = max(1, w // 512)
    px, py = np.meshgrid(np.arange(0, w, stride, dtype=float),
                         np.arange(0, h, stride, dtype=float))
    lat, _ = georeference_points(params, px, py, device=device)
    return px, py, torch.isfinite(lat).cpu().numpy()


def draw_horizon(mapping, figsize=(12, 8), color="red", device="cuda"):
    """Earth-horizon line overlaid on the photograph (reference draw.py:446).

    The horizon is the boundary of the set of pixels whose rays hit the
    (non-inflated) Earth; the rays are georeferenced on ``device`` (the
    card by default).
    """
    px, py, hit = _horizon_grid(mapping, compute_device(device))
    fig, ax = _new_axes(figsize)
    ax.imshow(np.asarray(mapping.rgb_unmasked))
    ax.contour(px, py, hit.astype(float), levels=[0.5], colors=color,
               linewidths=1.2)
    ax.set_xticks([])
    ax.set_yticks([])
    return fig


def _wcs_from_mapping(mapping, w, h):
    wcs_header = getattr(mapping, "wcs_header", None)
    if wcs_header is None:
        raise ValueError(
            "mapping has no WCS header attached; draw_horizon needs an "
            "astrometric mapping"
        )
    from auromat_tpu_torch.coordinates.wcs import TanWcs

    return TanWcs(wcs_header)


def draw_scanlines_co(out, column=None, mlatmlt=False, figsize=(14, 6)):
    """Keogram-style coroutine: send mappings, receive a figure at close.

    Mirrors the drawScanLinesCo/drawScanLinesMLatMLTCo coroutines
    (reference draw.py:589-856): one column (default: centre) is extracted
    per mapping and stacked on a time axis.

    Usage::

        result = {}
        co = draw_scanlines_co(result)
        for m in provider.getSequence(...):
            co.send(m)
        co.close()
        fig = result["figure"]
    """
    from auromat_tpu_torch.util.coroutine import coroutine

    @coroutine
    def _co():
        slices, lats, times = [], [], []
        try:
            while True:
                m = yield
                rgb = np.asarray(m.rgb.filled(0))
                col = column if column is not None else rgb.shape[1] // 2
                slices.append(rgb[:, col])
                if mlatmlt:
                    mlat, _ = m.mLatMltCenter
                    lats.append(np.asarray(mlat.filled(np.nan))[:, col])
                else:
                    lats.append(np.asarray(m.latsCenter.filled(np.nan))[:, col])
                times.append(m.photoTime)
        except GeneratorExit:
            if not slices:
                return
            img = np.stack(slices, axis=1)  # (h, t, 3)
            fig, ax = _new_axes(figsize)
            ax.imshow(img, aspect="auto")
            ax.set_xlabel("Frame")
            stacked = np.stack(lats)
            cnt = np.sum(np.isfinite(stacked), axis=0)
            lat_axis = np.where(
                cnt > 0, np.nansum(stacked, axis=0) / np.maximum(cnt, 1),
                np.nan,
            )  # nanmean without the all-NaN-column RuntimeWarning
            step = max(1, len(lat_axis) // 8)
            ax.set_yticks(np.arange(0, len(lat_axis), step))
            ax.set_yticklabels(
                ["" if not np.isfinite(v) else f"{v:.1f}"
                 for v in lat_axis[::step]]
            )
            ax.set_ylabel("MLat [deg]" if mlatmlt else "Latitude [deg]")
            out["figure"] = fig
            out["times"] = times

    return _co()


def draw_histogram(hist, vlines=(), xlabel=None, ylabel=None, linecolor="black",
                   figsize=(8, 5)):
    """Histogram curve with optional marked positions (masking diagnostics,
    reference draw.py:531-586)."""
    fig, ax = _new_axes(figsize)
    ax.plot(np.arange(len(hist)), hist, color=linecolor, lw=1.0)
    for pos, color in vlines:
        ax.axvline(pos, color=color, lw=1.0)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    return fig


def draw_astrometry_pixel_scales(mapping, figsize=(8, 5)):
    """Distribution of per-pixel angular sizes (reference draw.py:1825+)."""
    scales = mapping.arcSecPerPx
    fig, ax = _new_axes(figsize)
    names = ["width", "height", "diagonal"]
    means = [scales.width.mean, scales.height.mean, scales.diagonal.mean]
    mins = [scales.width.min, scales.height.min, scales.diagonal.min]
    maxs = [scales.width.max, scales.height.max, scales.diagonal.max]
    x = np.arange(3)
    ax.errorbar(
        x, means,
        yerr=[np.array(means) - mins, np.array(maxs) - np.array(means)],
        fmt="o", capsize=4,
    )
    ax.set_xticks(x)
    ax.set_xticklabels(names)
    ax.set_ylabel("arcsec / px")
    return fig


def _ra_dec_grid(mapping, stride=64, device="cuda"):
    """The numbers of :func:`draw_ra_dec`: RA/Dec (degrees, host float64
    arrays) of every ``stride``-th pixel of the frame, from
    ``tan_pix2world`` on float64 tensors on ``device``."""
    from auromat_tpu_torch.coordinates.wcs import tan_pix2world

    wcs = _wcs_from_mapping(mapping, *mapping.img_unmasked.shape[1::-1])
    px, py = np.meshgrid(np.arange(0, wcs.width, stride, dtype=float),
                         np.arange(0, wcs.height, stride, dtype=float))
    ra, dec = tan_pix2world(wcs, torch.from_numpy(px).to(device),
                            torch.from_numpy(py).to(device))
    return ra.cpu().numpy(), dec.cpu().numpy()


def draw_ra_dec(mapping, stride=64, figsize=(10, 8), device="cuda"):
    """RA/Dec of the frame's pixel grid (astrometry diagnostic,
    reference draw.py:1901-1935), projected on ``device`` (the card by
    default)."""
    ra, dec = _ra_dec_grid(mapping, stride, compute_device(device))
    fig, ax = _new_axes(figsize)
    ax.scatter(ra.ravel(), dec.ravel(), s=1)
    ax.set_xlabel("RA [deg]")
    ax.set_ylabel("Dec [deg]")
    return fig


def draw_reference_stars(image, xy_lists, colors=("lime", "red", "cyan"),
                         radius=8, figsize=(12, 8)):
    """Detected / reference star positions over the photograph.

    Reference: auromat/draw.py:1193-1290 (drawReferenceStars) — circles at
    the star-list pixel positions of one or more astrometry.net artifacts.

    :param image: (h, w[, 3]) array (or None for positions-only plot)
    :param xy_lists: one (x, y) pair or a sequence of them (e.g. the .axy
        detections and the .xyls reference stars from
        :func:`auromat_tpu_torch.io.fits.read_xy`)
    """
    fig, ax = _new_axes(figsize)
    if image is not None:
        ax.imshow(np.asarray(image), cmap="gray", origin="upper")
    if isinstance(xy_lists, tuple) and len(xy_lists) == 2 and \
            np.ndim(xy_lists[0]) == 1:
        xy_lists = [xy_lists]
    for (x, y), color in zip(xy_lists, colors):
        ax.scatter(np.asarray(x), np.asarray(y), s=radius ** 2,
                   facecolors="none", edgecolors=color, linewidths=1.0)
    ax.set_xlabel("x [px]")
    ax.set_ylabel("y [px]")
    return fig


def draw_indx_plot(image, quadpix, color="yellow", figsize=(12, 8)):
    """The matched astrometry.net quad drawn over the photograph.

    Reference: auromat/draw.py:1292-1360 (drawIndxPlot); quad pixel
    coordinates come from :func:`auromat_tpu_torch.io.fits.read_quad_match`.
    """
    fig, ax = _new_axes(figsize)
    if image is not None:
        ax.imshow(np.asarray(image), cmap="gray", origin="upper")
    q = np.asarray(quadpix, dtype=float)
    loop = np.vstack([q, q[:1]])
    ax.plot(loop[:, 0] - 1, loop[:, 1] - 1, color=color, linewidth=1.5)
    ax.scatter(q[:, 0] - 1, q[:, 1] - 1, color=color, s=30)
    return fig


def draw_corr_plot(corr, image=None, figsize=(12, 8)):
    """Field->index star correspondence residuals (solver diagnostic).

    Reference: auromat/draw.py:1660-1737 (drawCorrPlot). Draws a segment
    from each detected (field) position to its matched catalog (index)
    position; long segments reveal a bad fit region.

    :param corr: (field_x, field_y, index_x, index_y) from
        :func:`auromat_tpu_torch.io.fits.read_corr`
    """
    fx, fy, ix, iy = (np.asarray(v, dtype=float) for v in corr)
    fig, ax = _new_axes(figsize)
    if image is not None:
        ax.imshow(np.asarray(image), cmap="gray", origin="upper")
    ax.scatter(fx - 1, fy - 1, s=25, facecolors="none", edgecolors="lime",
               label="field")
    ax.scatter(ix - 1, iy - 1, s=10, color="red", label="index")
    for a, b, c, d in zip(fx, fy, ix, iy):
        ax.plot([a - 1, c - 1], [b - 1, d - 1], color="orange",
                linewidth=0.8)
    ax.legend()
    return fig


def get_fixed_constellation_colors(colors=None):
    """Per-constellation colors such that sky-neighbors differ.

    Greedy graph coloring over the Delaunay triangulation of the bundled
    figures' midpoints (reference draw.py:1349-1397
    getFixedConstellationColors) — gives every constellation a stable
    color assignment reusable across a whole frame sequence.

    :param colors: iterable of base color names (default: the reference's
        9-color set)
    :returns: dict of constellation name -> color string
    """
    from scipy.spatial import Delaunay

    from auromat_tpu_torch.coordinates.constellations import load

    base = list(colors) if colors is not None else [
        "white", "lime", "red", "orange", "cyan", "magenta",
        "lightblue", "hotpink", "yellow",
    ]
    data = load()
    names = list(data)
    points = np.array([[r[len(r) // 2][1], r[len(r) // 2][2]]
                       for r in data.values()])
    tri = Delaunay(points)
    neighbors = {i: set() for i in range(len(names))}
    for simplex in tri.simplices:
        for a in simplex:
            neighbors[a].update(int(b) for b in simplex if b != a)
    assigned = {}
    for i in range(len(names)):
        used = {assigned[j] for j in neighbors[i] if j in assigned}
        free = [c for c in base if c not in used]
        # more neighbors than base colors: fall back to cycling (the
        # reference reuses colors too once the palette is exhausted)
        assigned[i] = free[0] if free else base[i % len(base)]
    return {names[i]: assigned[i] for i in range(len(names))}


def _constellation_segments(wcs, data, device="cuda"):
    """The numbers of :func:`draw_constellations`: for each name of
    ``data`` (name -> [((ra1, dec1), (ra2, dec2)), ...] degrees), a
    (n, 4) host float64 array of its segments' pixel end points
    (x1, y1, x2, y2), NaN behind the tangent plane, from one
    ``tan_world2pix`` of every end point on float64 tensors on
    ``device``."""
    from auromat_tpu_torch.coordinates.wcs import tan_world2pix

    counts = [len(segments) for segments in data.values()]
    ends = np.array([p for segments in data.values()
                     for seg in segments for p in seg],
                    dtype=np.float64).reshape(-1, 2)
    t = torch.from_numpy(ends).to(device)
    x, y = tan_world2pix(wcs, t[:, 0], t[:, 1])
    xy = torch.stack([x, y], dim=-1).cpu().numpy().reshape(-1, 4)
    return dict(zip(data, np.split(xy, np.cumsum(counts)[:-1])))


def draw_constellations(wcs_or_mapping, data=None, color="white",
                        figsize=(12, 8), image=None, device="cuda"):
    """Constellation stick figures over the frame.

    Reference: auromat/draw.py:1399-1480 (drawConstellations). By default
    uses the bundled Xephem figure dataset
    (auromat_tpu_torch.coordinates.constellations); pass ``data`` as a
    mapping of ``name -> [((ra1, dec1), (ra2, dec2)), ...]`` degree
    segments to override. The end points are projected on ``device`` (the
    card by default).

    :param color: a single color name, a list of names cycled over
        constellations, or a dict of ``name -> color`` (e.g. from
        :func:`get_fixed_constellation_colors`)
    """
    import itertools

    from auromat_tpu_torch.coordinates.wcs import TanWcs

    device = compute_device(device)
    if data is None:
        from auromat_tpu_torch.coordinates.constellations import figure_segments

        data = figure_segments()
    if isinstance(color, dict):
        color_of = color.get
        fallback = "white"
        def color_fn(name):
            return color_of(name, fallback)
    elif isinstance(color, str):
        def color_fn(name):
            return color
    else:
        cycle = itertools.cycle(color)
        def color_fn(name):
            return next(cycle)

    wcs = (wcs_or_mapping if isinstance(wcs_or_mapping, TanWcs)
           else _wcs_from_mapping(wcs_or_mapping,
                                  *wcs_or_mapping.img_unmasked.shape[1::-1]))
    segments = _constellation_segments(wcs, data, device)
    fig, ax = _new_axes(figsize)
    if image is not None:
        ax.imshow(np.asarray(image), cmap="gray", origin="upper")
    for name, xy in segments.items():
        c = color_fn(name)
        pts = []
        for x1, y1, x2, y2 in xy.tolist():
            if (0 <= x1 <= wcs.width and 0 <= y1 <= wcs.height) or \
               (0 <= x2 <= wcs.width and 0 <= y2 <= wcs.height):
                ax.plot([x1, x2], [y1, y2], color=c, linewidth=0.8)
                pts.append((x1, y1))
        if pts:
            cx, cy = np.mean(pts, axis=0)
            ax.annotate(name, (cx, cy), color=c, fontsize=8)
    ax.set_xlim(0, wcs.width)
    ax.set_ylim(wcs.height, 0)
    return fig


def draw_heatmap(lats, lons, bins=100, figsize=(10, 8)):
    """Coverage heatmap of one or many mappings (reference draw.py:531-586).

    :param lats, lons: flat arrays (NaN entries ignored)
    """
    lats = np.asarray(lats, dtype=float).ravel()
    lons = np.asarray(lons, dtype=float).ravel()
    m = ~np.isnan(lats) & ~np.isnan(lons)
    fig, ax = _new_axes(figsize)
    h, xe, ye = np.histogram2d(lons[m], lats[m], bins=bins)
    ax.pcolormesh(xe, ye, h.T, cmap="viridis")
    ax.set_xlabel("longitude [deg]")
    ax.set_ylabel("latitude [deg]")
    return fig


def draw_distortion_displacement(shape=(2832, 4256), model="ptlens",
                                 params=(0.0, 0.0, 0.0), figsize=(10, 7)):
    """Lens-distortion displacement magnitude field.

    Reference: auromat/draw.py:1075-1094 (drawLensDistortionDisplacement);
    the field comes from
    :func:`auromat_tpu_torch.util.lensdistortion.distortion_displacement`.
    """
    from auromat_tpu_torch.util.lensdistortion import distortion_displacement

    dx, dy = distortion_displacement(shape, model, params)
    mag = np.hypot(np.asarray(dx), np.asarray(dy))
    fig, ax = _new_axes(figsize)
    im = ax.imshow(mag, origin="upper")
    fig.colorbar(im, ax=ax, label="displacement [px]")
    return fig


# ---------------------------------------------------------------------------
# sequence diagnostics (reference draw.py:589-1935)
# ---------------------------------------------------------------------------


def draw_line_plot(x, y, xlabel=None, ylabel=None, title=None, linecolor=None,
                   linewidth=None, figsize=(8, 5), **kw):
    """Generic line plot; datetime x values get a formatted time axis.

    Reference: draw.py:1019-1059 (drawLinePlot). Returns (fig, ax).
    """
    import datetime as _dt

    import matplotlib
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if title:
        ax.set_title(title)
    if linecolor is not None:
        kw["color"] = linecolor
    x = list(x)
    if len(x) > 0 and isinstance(x[0], _dt.datetime):
        xs = matplotlib.dates.date2num(x)
        (line,) = ax.plot(xs, y, "b-", **kw)
        ax.xaxis.set_major_formatter(
            matplotlib.dates.DateFormatter("%H:%M:%S"))
        fig.autofmt_xdate()
    else:
        (line,) = ax.plot(x, y, **kw)
    if linewidth:
        line.set_linewidth(linewidth)
    return fig, ax


def draw_corr_seq_plot(corr_paths, x=None, xlabel="Frame", figsize=(8, 5)):
    """Mean +- std distance between corresponding stars per .corr file.

    Reference: draw.py:1673-1706 (drawCorrSeqPlot) — the per-sequence
    astrometry residual overview. Returns (fig, ax).
    """
    import matplotlib.pyplot as plt

    from auromat_tpu_torch.io.fits import read_corr

    corr_paths = list(corr_paths)
    if x is None:
        x = list(range(len(corr_paths)))
    assert len(x) == len(corr_paths)
    means, stds = [], []
    for path in corr_paths:
        fx, fy, ix_, iy_ = read_corr(path)
        dist = np.hypot(np.asarray(fx) - np.asarray(ix_),
                        np.asarray(fy) - np.asarray(iy_))
        means.append(float(np.mean(dist)))
        stds.append(float(np.std(dist)))
    fig, ax = plt.subplots(figsize=figsize)
    ax.set_xlabel(xlabel)
    ax.set_ylabel("Mean distance (pixels)")
    ax.set_title("Distances between corresponding stars")
    ax.errorbar(x, means, stds, linestyle="None", marker="s")
    ax.set_xlim(x[0] - 1, x[-1] + 1)
    return fig, ax


def _headers_of(wcs_headers_or_paths_or_mappings):
    from auromat_tpu_torch.io import fits as _fits

    out = []
    for item in wcs_headers_or_paths_or_mappings:
        if isinstance(item, (str, bytes)):
            out.append(_fits.read_header(item))
        elif hasattr(item, "wcs_header"):
            out.append(item.wcs_header)
        else:
            out.append(item)
    return out


def draw_astrometry_rotation_angles(wcs_headers, x=None, xlabel="Time",
                                    ylabel="Rotation angle (deg)", **kw):
    """Celestial rotation angle atan2(CD21, CD11) over a solved sequence.

    Wraps angles at 180 deg when the sequence straddles the discontinuity,
    relabelling the axis accordingly (reference draw.py:1769-1808).
    """
    from auromat_tpu_torch.io import fits as _fits

    headers = _headers_of(wcs_headers)
    if x is None:
        x = [_fits.get_photo_time(h) for h in headers]
    assert len(x) == len(headers)
    angles = np.asarray([_fits.get_rotation_angle(h) for h in headers])
    # shift by 180 ONLY when it actually tightens the spread (a sequence
    # hugging +-180); a wide but continuous sequence must not be wrapped
    shifted = np.mod(angles, 360.0) - 180.0
    wrapped = (angles.max() - angles.min()) > (shifted.max() - shifted.min())
    if wrapped:
        angles = shifted
    fig, ax = draw_line_plot(
        x, angles, xlabel=xlabel, ylabel=ylabel,
        title=r"Rotation Angle ($\operatorname{atan}(CD_{21},CD_{11})$)", **kw)
    if wrapped:
        from matplotlib.ticker import FuncFormatter

        ax.yaxis.set_major_formatter(FuncFormatter(
            lambda v, pos: "{:g}".format(np.mod(v + 360.0, 360.0) - 180.0)))
    return fig, ax


def draw_cd11_cd21(wcs_headers, xlabel="$CD_{11}$", ylabel="$CD_{21}$", **kw):
    """CD11-vs-CD21 trajectory with the median-pixel-scale circle.

    A well-behaved solved sequence traces an arc of the circle (constant
    pixel scale, drifting rotation); outliers jump off it
    (reference draw.py:1810-1845).
    """
    import matplotlib.pyplot as plt

    from auromat_tpu_torch.io import fits as _fits

    headers = _headers_of(wcs_headers)
    cd11 = [h["CD1_1"] for h in headers]
    cd21 = [h["CD2_1"] for h in headers]
    scale = float(np.median([_fits.get_pixel_scale_deg(h) for h in headers]))
    fig, ax = draw_line_plot(cd11, cd21, xlabel=xlabel, ylabel=ylabel,
                             title="WCS Transformation Matrix Values", **kw)
    circle = plt.Circle((0, 0), scale, fill=False)
    ax.add_patch(circle)
    ax.legend([circle], [f"{scale * 3600:0.2f} arcsec/px (median)"],
              loc="upper right", frameon=False)
    ax.set_aspect("equal", adjustable="datalim")
    return fig, ax


def draw_ra_dec_seq(wcs_headers, **kw):
    """RA/Dec trajectory of the image centers (CRVAL) over a sequence
    (reference draw.py:1847-1866, drawRaDec)."""
    headers = _headers_of(wcs_headers)
    ra = [h["CRVAL1"] for h in headers]
    dec = [h["CRVAL2"] for h in headers]
    return draw_line_plot(ra, dec, xlabel="Right ascension (deg)",
                          ylabel="Declination (deg)",
                          title="Equatorial Coordinates of Image Centers",
                          **kw)


def draw_right_ascension(wcs_headers, x=None, **kw):
    """Image-center right ascension over time (reference draw.py:1868-1890)."""
    from auromat_tpu_torch.io import fits as _fits

    headers = _headers_of(wcs_headers)
    if x is None:
        x = [_fits.get_photo_time(h) for h in headers]
    ra = [h["CRVAL1"] for h in headers]
    return draw_line_plot(x, ra, xlabel="Time",
                          ylabel="Right ascension (deg)",
                          title="Right Ascension of Image Centers", **kw)


def draw_declination(wcs_headers, x=None, **kw):
    """Image-center declination over time (reference draw.py:1892-1915)."""
    from auromat_tpu_torch.io import fits as _fits

    headers = _headers_of(wcs_headers)
    if x is None:
        x = [_fits.get_photo_time(h) for h in headers]
    dec = [h["CRVAL2"] for h in headers]
    return draw_line_plot(x, dec, xlabel="Time", ylabel="Declination (deg)",
                          title="Declination of Image Centers", **kw)


def draw_camera_footpoints(mappings, **kw):
    """Camera footpoint (sub-camera ground point) track of a sequence
    (reference draw.py:1917-1935)."""
    foot = [m.cameraFootpoint for m in mappings]
    return draw_line_plot([f.lon for f in foot], [f.lat for f in foot],
                          xlabel="Longitude (deg)", ylabel="Latitude (deg)",
                          title="Camera Footpoints", **kw)


def draw_date(figax, mapping, color="white"):
    """Stamp the mapping's photo time in the top centre of a figure image
    (reference draw.py:1611-1622)."""
    ax = figax[1]
    fontsize = ax.get_xlim()[1] * 0.016
    ax.text(0.5, 0.98, mapping.photoTime.strftime("%Y-%m-%d %H:%M:%S UTC"),
            fontsize=fontsize, color=color, horizontalalignment="center",
            verticalalignment="top", transform=ax.transAxes)
    return figax


def draw_array_heatmap(data, cb_label=None, xlabel=None, ylabel=None,
                       figsize=(10, 8)):
    """Blue-red heatmap of one per-pixel array (NaN transparent)
    (reference draw.py:562-586, drawHeatmap)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    arr = np.ma.masked_invalid(np.asarray(
        data.filled(np.nan) if hasattr(data, "filled") else data,
        dtype=np.float64))
    im = ax.imshow(arr, cmap="coolwarm", interpolation="nearest")
    cb = fig.colorbar(im, ax=ax)
    if cb_label:
        cb.set_label(cb_label)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    return fig, ax


def draw_heatmaps(mapping, path_prefix="heat_", xlabel="Image Width (px)",
                  ylabel="Image Height (px)", widthPx=None, dpi=None):
    """Write lats/lons/elevation (and azimuth when available) heatmap PNGs
    for one mapping (reference draw.py:531-560, drawHeatmaps).

    :returns: list of written paths
    """
    written = []

    def _save(name, data, label):
        fig, _ = draw_array_heatmap(data, cb_label=label, xlabel=xlabel,
                                    ylabel=ylabel)
        path = f"{path_prefix}{name}.png"
        save_fig(path, fig, dpi=dpi, width_px=widthPx)
        written.append(path)

    _save("lats", mapping.lats, "Latitude (deg)")
    _save("lons", mapping.lons, "Longitude (deg)")
    # CDF/netCDF re-imports without zenith_angle carry elevation=None
    # (a supported state: resample/export/check_guarantees all allow it).
    if mapping.elevation is not None:
        _save("elevation", mapping.elevation, "Elevation angle (deg)")
    az = getattr(mapping, "azimuthCenter", None)
    if az is not None:
        _save("azimuth", az, "Azimuth (deg)")
    return written


def draw_lens_distortion_derivative(model, terms, focal_length=None,
                                    crop_factor=1.0, figsize=(8, 5)):
    """Lens distortion derivative dD/dh over the sensor radius: positive =
    pincushion, negative = barrel (reference draw.py:1096-1169).

    :param model: 'ptlens' | 'poly3' | 'poly5'
    :param terms: model coefficients (a,b,c) / (k1,) / (k1,k2)
    """
    if model == "ptlens":
        a, b, c = terms
        deriv = lambda ru: 3 * a * ru**2 + 2 * b * ru + c
        label = f"ptlens(a={a:g}, b={b:g}, c={c:g})"
    elif model == "poly3":
        (k1,) = tuple(terms)[:1]
        deriv = lambda ru: 2 * k1 * ru
        label = f"poly3(k1={k1:g})"
    elif model == "poly5":
        k1, k2 = tuple(terms)[:2]
        deriv = lambda ru: 2 * k1 * ru + 4 * k2 * ru**3
        label = f"poly5(k1={k1:g}, k2={k2:g})"
    else:
        raise NotImplementedError(model)

    # sensor half height sets lensfun's unit radius (reference 1139-1153)
    w_fx, h_fx = 36.0, 24.0
    d_fx = np.hypot(w_fx, h_fx)
    alpha = np.arcsin(w_fx / d_fx)
    d = d_fx / crop_factor
    half_height = np.cos(alpha) * d / 2
    half_diag = d / 2
    xs = np.linspace(0, half_diag, 100)
    fig, ax = draw_line_plot(xs, deriv(xs / half_height) * half_height,
                             xlabel=r"$h\;(\mathrm{mm})$",
                             ylabel=r"$dD/dh\;(\mathrm{mm}^{-1})$",
                             title=label, figsize=figsize)
    ax.set_xlim([0, half_diag])
    ymin, ymax = ax.get_ylim()
    ax.autoscale(False)
    pin = ax.fill_between([0, half_diag], 0, max(ymax, 1e-9),
                          facecolor="peachpuff")
    bar = ax.fill_between([0, half_diag], min(ymin, -1e-9), 0,
                          facecolor="lightblue")
    ax.legend([pin, bar], ["pincushion", "barrel"], loc="lower right")
    return fig, ax


def draw_azimuth_plots_co(out, figsize=(8, 5)):
    """Coroutine: centroid/footpoint track diagnostics over a sequence.

    Send mappings (or their ``.properties``), close, then read figures from
    ``out``: az_centroid, az_centroid_from_cam, latlon_centroid,
    latlon_centroid_from_az, latlon_cam_foot — the five overview plots of
    reference draw.py:889-1017 (drawAzimuthPlotsCo). The recalculated
    centroids assume a fixed camera tilt: the centroid azimuth track is
    rebuilt from the (much smoother) camera footpoint track.
    """
    from auromat_tpu_torch.coordinates import geodesic
    from auromat_tpu_torch.util.coroutine import coroutine

    @coroutine
    def _co():
        props = []
        try:
            while True:
                m = yield
                props.append(m if hasattr(m, "cameraFootpoint") and not
                             hasattr(m, "img") else m.properties)
        except GeneratorExit:
            if len(props) < 2:
                raise ValueError("mapping sequence too short")
            photo_times, centroids, cam_feet = [], [], []
            az_centroid, az_centroid_from_cam, centroids_from_az = [], [], []
            delta_dist = delta_az = None
            for cur, nxt in zip(props[:-1], props[1:]):
                photo_times.append(cur.photoTime)
                centroids.append(cur.centroid)
                cam_feet.append(cur.cameraFootpoint)
                az_cam = geodesic.course(cur.cameraFootpoint,
                                         nxt.cameraFootpoint)
                if delta_dist is None:
                    delta_dist = geodesic.distance(cur.cameraFootpoint,
                                                   cur.centroid)
                    delta_az = az_cam - geodesic.course(cur.cameraFootpoint,
                                                        cur.centroid)
                az_centroid.append(geodesic.course(cur.centroid,
                                                   nxt.centroid))
                az_c2c = az_cam - delta_az
                c_cur = geodesic.destination(cur.cameraFootpoint, az_c2c,
                                             delta_dist)
                c_nxt = geodesic.destination(nxt.cameraFootpoint, az_c2c,
                                             delta_dist)
                centroids_from_az.append(c_cur)
                az_centroid_from_cam.append(geodesic.course(c_cur, c_nxt))

            out["az_centroid"] = draw_line_plot(
                photo_times, az_centroid, xlabel="Time",
                ylabel=r"Azimuth ($^\circ$) using centroid",
                figsize=figsize)[0]
            out["az_centroid_from_cam"] = draw_line_plot(
                photo_times, az_centroid_from_cam, xlabel="Time",
                ylabel=r"Azimuth ($^\circ$) using recalculated centroid",
                figsize=figsize)[0]
            out["latlon_centroid"] = draw_line_plot(
                [c.lon for c in centroids], [c.lat for c in centroids],
                xlabel=r"Longitude ($^\circ$) of centroid",
                ylabel=r"Latitude ($^\circ$) of centroid",
                figsize=figsize)[0]
            out["latlon_centroid_from_az"] = draw_line_plot(
                [c.lon for c in centroids_from_az],
                [c.lat for c in centroids_from_az],
                xlabel=r"Longitude ($^\circ$) of recalculated centroid",
                ylabel=r"Latitude ($^\circ$) of recalculated centroid",
                figsize=figsize)[0]
            out["latlon_cam_foot"] = draw_line_plot(
                [c.lon for c in cam_feet], [c.lat for c in cam_feet],
                xlabel=r"Longitude ($^\circ$) of camera footpoint",
                ylabel=r"Latitude ($^\circ$) of camera footpoint",
                figsize=figsize)[0]

    return _co()


def draw_scanlines_map_co(out, arcsec_per_px=100, line_width_factor=1.0,
                          mlatmlt=False, figsize=(14, 8)):
    """Geodesic scanline sequence overview on a stereographic map.

    The faithful counterpart of reference drawScanLinesCo (draw.py:589-856):
    each mapping contributes the strip of its pixels inside a spherical
    rectangle centred on its centroid and oriented perpendicular to the
    flight direction (derived from the camera-footpoint track, which is far
    smoother than the raw centroid track); strips are polygon-masked and
    drawn together with a geodesic time axis.

    Usage: send RESAMPLED mappings (or dicts {'props': unresampled-props,
    'mapping': resampled}) like the keogram coroutine; close; read
    ``out['figure']``. With ``mlatmlt=True`` sent mappings are converted to
    the SM frame first (the reference's drawScanLinesMLatMLTCo wrapper,
    draw.py:859-887). ``draw_scanlines_co`` remains the cheap keogram
    variant.
    """
    from auromat_tpu_torch.coordinates import geodesic
    from auromat_tpu_torch.mapping.mapping import BoundingBox, convert_mapping_to_sm
    from auromat_tpu_torch.util.coroutine import coroutine

    @coroutine
    def _co():
        entries = []  # (props, mapping)
        try:
            while True:
                m = yield
                if isinstance(m, dict):
                    # dict sends carry caller-prepared (possibly SM) data
                    pm = (m["props"], m["mapping"])
                elif mlatmlt:
                    sm = convert_mapping_to_sm(m)
                    pm = (sm.properties, sm)
                else:
                    pm = (m.properties, m)
                entries.append(pm)
        except GeneratorExit:
            if len(entries) < 2:
                raise ValueError(
                    "mapping sequence too short, need at least 2 mappings")
            props = [p for p, _ in entries]
            bb0 = props[0].boundingBox
            height = geodesic.distance(bb0.topLeft, bb0.bottomRight) * 1.5
            # flight direction from the footpoint track, fixed camera tilt
            az_cam0 = geodesic.course(props[0].cameraFootpoint,
                                      props[1].cameraFootpoint)
            delta_dist = geodesic.distance(props[0].cameraFootpoint,
                                           props[0].centroid)
            delta_az = az_cam0 - geodesic.course(props[0].cameraFootpoint,
                                                 props[0].centroid)
            width = geodesic.distance(props[0].centroid,
                                      props[1].centroid) * 3.0 \
                * line_width_factor

            verts_arr, colors_arr = [], []
            centroids, azimuths, photo_times, line_bbs = [], [], [], []
            max_height = 0.0
            az = 0.0
            for i, (p, m) in enumerate(entries):
                if i + 1 < len(entries):
                    az_cam = geodesic.course(p.cameraFootpoint,
                                             entries[i + 1][0].cameraFootpoint)
                    az_c2c = az_cam - delta_az
                    c_cur = geodesic.destination(p.cameraFootpoint, az_c2c,
                                                 delta_dist)
                    c_nxt = geodesic.destination(
                        entries[i + 1][0].cameraFootpoint, az_c2c, delta_dist)
                    az = geodesic.course(c_cur, c_nxt)
                # else: reuse the previous azimuth (last frame)
                photo_times.append(p.photoTime)
                centroids.append(p.centroid)
                azimuths.append(az)
                mid_r = geodesic.destination(p.centroid, az, width / 2)
                mid_l = geodesic.destination(p.centroid, az + 180, width / 2)
                tl = geodesic.destination(mid_l, az - 90, height / 2)
                bl = geodesic.destination(mid_l, az + 90, height / 2)
                tr = geodesic.destination(mid_r, az - 90, height / 2)
                br = geodesic.destination(mid_r, az + 90, height / 2)
                polygon = np.concatenate([
                    geodesic.line(tl, tr)[:-1], geodesic.line(tr, br)[:-1],
                    geodesic.line(br, bl)[:-1], geodesic.line(bl, tl)[:-1]])
                strip = m.maskedByPolygon(polygon)
                sb = strip.boundingBox
                line_bbs.append(sb)
                max_height = max(max_height,
                                 geodesic.distance(sb.topLeft, sb.bottomRight))
                verts, colors = polygons_from_mapping_or_collection(strip)
                verts_arr.append(verts)
                colors_arr.append(colors)

            # geodesic time axis alongside the strip band
            n = len(entries)
            axis_dist = max_height / 2 * 1.1
            idx_line = np.round(np.linspace(0, n - 1, max(4, n // 10))) \
                .astype(int)
            axis_line = [geodesic.destination(centroids[i], azimuths[i] - 90,
                                              axis_dist) for i in idx_line]
            idx_tick = np.round(np.linspace(0, n - 1, 4)).astype(int)
            ticks = [(geodesic.destination(centroids[i], azimuths[i] - 90,
                                           axis_dist),
                      geodesic.destination(centroids[i], azimuths[i] - 90,
                                           axis_dist * 1.04),
                      photo_times[i]) for i in idx_tick]
            label_edges = [geodesic.destination(centroids[i],
                                                azimuths[i] - 90,
                                                axis_dist * 1.32)
                           for i in idx_tick]
            bbs = line_bbs + [BoundingBox.minimumBoundingBox(
                [[p.lat, p.lon] for p in label_edges])]
            bb = BoundingBox.mergedBoundingBoxes(bbs)
            lat0, lon0 = bb.center.lat, bb.center.lon

            fig, ax = _new_axes(figsize)
            for verts, colors in zip(verts_arr, colors_arr):
                if len(verts) == 0:
                    continue
                # polygon verts are (lon, lat) — see create_polygons_and_colors
                pv = np.stack([
                    np.stack(stereographic_project(
                        v[:, 1], v[:, 0], lat0, lon0), axis=-1)
                    for v in verts])
                _poly_collection(ax, pv, colors)
            xs, ys = stereographic_project(
                np.array([p.lat for p in axis_line]),
                np.array([p.lon for p in axis_line]), lat0, lon0)
            ax.plot(xs, ys, color="gray")
            for p1, p2, date in ticks:
                txs, tys = stereographic_project(
                    np.array([p1.lat, p2.lat]), np.array([p1.lon, p2.lon]),
                    lat0, lon0)
                ax.plot(txs, tys, color="gray")
                ax.text(txs[1], tys[1], date.strftime("%H:%M:%S"),
                        ha="center", va="bottom", fontsize=8)
            ax.autoscale()
            ax.set_aspect("equal")
            t0, t1 = min(photo_times), max(photo_times)
            fig.suptitle(t0.strftime("%Y-%m-%d %H:%M:%S") + " - "
                         + t1.strftime("%H:%M:%S UTC")
                         + (" (MLat/MLT)" if mlatmlt else ""))
            out["figure"] = fig
            out["times"] = photo_times

    return _co()

