"""Resample mappings onto regular plate-carree grids, and compose
collections into one mosaic.

Counterpart of ``auromat_tpu.resample``: pole rotation and discontinuity
shifting on the host, the binning and the device interpolators on
``device``. The 'mean' binning routes as the JAX package routes on a TPU
(resample.py:157-178), with a CUDA device in the TPU's place:

- uint8 RGB with elevation -> K1 (``'pallas_rgbelev'``,
  :func:`auromat_tpu_torch.ops.georegrid.bin_mean_rgbelev`);
- any other uint8 image -> K2 (``'pallas_taint'``,
  :func:`auromat_tpu_torch.ops.regrid_pallas.bin_mean_pallas_taint`);
- anything else, and every image on the CPU -> ``'sorted'``, the float64
  scatter of :func:`auromat_tpu_torch.ops.regrid.bin_mean`.

An explicit ``'pallas_*'`` method on the CPU runs the kernel's plain
version. The K1/K2 routes divide means in float32, so a uint8 mean that
sits on a .5 boundary may round one step away from the float64 route.

The interpolation methods route as the JAX package's do (resample.py:
142-156, 500-542):

- 'nearest' on a CUDA device -> 'nearest_device' (the jump flood of
  :func:`auromat_tpu_torch.ops.regrid.bin_nearest`); on the CPU, and as
  'nearest_host' anywhere, host scipy ``griddata``;
- 'linear' and 'cubic' are host scipy ``griddata``; 'linear_device' and
  'cubic_device' invert the pixel mesh on ``device``
  (``interp_linear_structured``, ``interp_cubic_structured``);
- every interpolated grid is masked by the mapping's concave outline
  (:func:`auromat_tpu_torch.utils.points_inside_polygon`).

:func:`mosaic` composes a collection by elevation priority with
``bin_take_best`` on ``device``. :func:`resample_mlat_mlt` resamples in
solar-magnetic coordinates, so that MLat/MLT become the regular grids. The
JAX package's TPU workarounds (``host_f64_device``,
``_initialized_backend_is_tpu``) have no counterpart here: host math is
numpy or CPU torch in float64 directly.
"""

from functools import partial as _partial

import numpy as np
import torch

from auromat_tpu_torch.coordinates import geodesic
from auromat_tpu_torch.coordinates.geodesic import Location
from auromat_tpu_torch.coordinates.transform import rotate_pole
from auromat_tpu_torch.mapping.mapping import (BoundingBox, Mapping,
                                               MappingCollection,
                                               convert_mapping_to_sm,
                                               convert_sm_mapping_to_geo)
from auromat_tpu_torch.ops.georef import compute_device
from auromat_tpu_torch.ops.regrid import (bin_mean, bin_nearest,
                                          bin_take_best, fixed_grid,
                                          interp_cubic_structured,
                                          interp_linear_structured)
from auromat_tpu_torch.profiling import span
from auromat_tpu_torch.utils import points_inside_polygon
from auromat_tpu_torch.utils import wrap_lon_180 as _wrap_lon_np

_INTERP_METHODS = ("nearest", "nearest_device", "linear", "linear_device",
                   "cubic", "cubic_device")


def plate_carree_resolution(bounding_box: BoundingBox, arcsec_per_px):
    """(lat_px_per_deg, lon_px_per_deg) approximating a spherical resolution
    at the bbox centre. Reference: auromat/resample.py:36-61."""
    deg_per_px = arcsec_per_px / 3600.0
    lat_px_per_deg = 1.0 / deg_per_px
    lat_middle = (bounding_box.latNorth + bounding_box.latSouth) / 2
    middle_left = Location(lat_middle, bounding_box.lonWest)
    middle_right = Location(lat_middle, bounding_box.lonEast)
    lon_middle_distance = geodesic.angular_distance(middle_left, middle_right)
    px = lon_middle_distance / deg_per_px
    lon_east = bounding_box.lonEast
    if bounding_box.lonWest > lon_east:
        lons = lon_east + 360 - bounding_box.lonWest
    else:
        lons = lon_east - bounding_box.lonWest
    lon_ppd = px / lons
    if not lon_ppd > 0:
        # pole-containing boxes span -180..180: the two mid-edge points
        # coincide and the measured lon width degenerates to zero. The pole
        # path resamples in a rotated frame anyway, where the original lon
        # resolution has no special meaning.
        lon_ppd = lat_px_per_deg
    return lat_px_per_deg, lon_ppd


def resample(mapping_or_collection, px_per_deg=25, arcsec_per_px=None,
             contains_pole=None, method="mean", bin_method="auto",
             device="cuda"):
    """Resample image+elevation onto a regular lat/lon grid.

    With 'mean' binning, high target resolutions produce empty cells at low
    elevations — mask by elevation first (reference resample.py:79-84).

    :param px_per_deg: scalar or (lat, lon) pixels per degree
    :param arcsec_per_px: spherical resolution (overrides px_per_deg)
    :param method: 'mean' (binning on ``device``) | 'nearest' (the device
        jump flood on a CUDA device, host scipy on the CPU) |
        'nearest_device' | 'nearest_host' | 'linear' (host scipy Delaunay)
        | 'linear_device' (mesh inversion + bilinear on ``device``) |
        'cubic' (host scipy Clough-Tocher) | 'cubic_device' (mesh
        inversion + Catmull-Rom bicubic on ``device``). 'nearest_device'
        may pick a different, equally near or nearby sample than the
        KD-tree in a few cells (see ``bin_nearest``)
    :param bin_method: for 'mean': 'auto' (see the module docstring),
        'pallas_rgbelev' (K1), 'pallas_taint' (K2) or any
        ``ops.regrid._BIN_METHODS`` name
    :param device: where the binning and the device interpolators run (the
        card by default; pass ``device="cpu"`` for the CPU); the result is
        a host Mapping
    :rtype: Mapping or MappingCollection
    """
    if isinstance(mapping_or_collection, MappingCollection):
        return MappingCollection(
            [resample(m, px_per_deg, arcsec_per_px, contains_pole, method,
                      bin_method, device)
             for m in mapping_or_collection.mappings],
            mapping_or_collection.identifier,
            mayOverlap=mapping_or_collection.mayOverlap,
        )
    mapping = mapping_or_collection
    if not isinstance(mapping, Mapping):
        raise ValueError(f"not a mapping or collection: {type(mapping)}")
    if method not in ("mean", "nearest_host") + _INTERP_METHODS:
        raise NotImplementedError(method)
    device = compute_device(device)
    with span("resample"):
        return _resample_mapping(mapping, px_per_deg, arcsec_per_px,
                                 contains_pole, method, bin_method, device)


def resample_mlat_mlt(mapping, device="cuda", **kw):
    """Resample so MLat/MLT become regular grids (reference resample.py:63-71):
    the mapping in solar-magnetic coordinates through :func:`resample`
    (``**kw``), then back to geodetic coordinates at the mapping altitude,
    both on ``device`` (the card by default; ``device="cpu"`` for the CPU)."""
    device = compute_device(device)
    sm = convert_mapping_to_sm(mapping)
    sm_resampled = resample(sm, device=device, **kw)
    return convert_sm_mapping_to_geo(sm_resampled, device=device)


def _rotate_pole_deg(la_deg, lo_deg, angle, altitude):
    """Degrees-in/degrees-out rotate-pole about the x-axis at the emission
    altitude: the one wrapper behind every pole rotation and unrotation
    here. Host float64 (CPU torch); NaN coordinates pass through as NaN."""
    la2, lo2 = rotate_pole(
        torch.from_numpy(np.deg2rad(np.asarray(la_deg, dtype=np.float64))),
        torch.from_numpy(np.deg2rad(np.asarray(lo_deg, dtype=np.float64))),
        altitude, angle_deg=angle, axis=(1, 0, 0))
    return np.rad2deg(la2.numpy()), np.rad2deg(lo2.numpy())


def _finalize_int_image(img_r, img_dtype):
    """Float resampled image -> the source integer dtype.

    Clamps to the integer range (a cast would wrap) and turns NaN (masked)
    cells into 0; the mask is re-derived from coordinates, so the fill
    value is irrelevant."""
    with np.errstate(invalid="ignore"):
        img_r = np.round(img_r)
        info = np.iinfo(img_dtype)
        img_r = np.clip(img_r, info.min, info.max)
    return np.where(np.isnan(img_r), 0, img_r).astype(img_dtype)


def grid_mapping(grid, img_r, elev_r, altitude, photo_time, identifier,
                 shift=False):
    """Assemble a :class:`Mapping` from a plate-carree
    :class:`~auromat_tpu_torch.ops.regrid.GridSpec` and finalized per-cell
    channels (camera_pos is NaN: a grid product has no single camera).
    ``shift=True`` unwraps +180-deg-shifted longitudes (the
    discontinuity-handling convention of :func:`resample`)."""
    lat_grid, lon_grid = grid.corner_grids()
    lat_grid_c, lon_grid_c = grid.center_grids()
    if shift:
        lon_grid = _wrap_lon_np(lon_grid + 180.0)
        lon_grid_c = _wrap_lon_np(lon_grid_c + 180.0)
    return Mapping(
        lat_grid, lon_grid, lat_grid_c, lon_grid_c, elev_r, altitude, img_r,
        np.full(3, np.nan), photo_time, identifier,
    )


def _bin_mean_on(device, grid, lats_center, lons_center, data, bin_method):
    """Mean-bin host arrays on ``device``; host float64 means back."""
    lats, lons, data = _to_device(device, lats_center, lons_center, data)
    with span("resample.bin"):
        if bin_method == "pallas_rgbelev":
            from auromat_tpu_torch.ops.georegrid import bin_mean_rgbelev

            _, data_r = bin_mean_rgbelev(grid, lats, lons, data)
        elif bin_method == "pallas_taint":
            from auromat_tpu_torch.ops.regrid_pallas import \
                bin_mean_pallas_taint

            _, data_r = bin_mean_pallas_taint(grid, lats, lons, data)
        else:
            _, data_r = bin_mean(grid, lats, lons, data, method=bin_method)
    return _to_host(data_r)


def _to_device(device, *arrays):
    nbytes = 0 if device.type == "cpu" else sum(a.nbytes for a in arrays)
    with span("resample.to_device", nbytes=nbytes):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays]


def _to_host(data_r):
    """A device grid as host float64."""
    nbytes = 0 if data_r.device.type == "cpu" else data_r.nbytes
    with span("resample.to_host", nbytes=nbytes):
        return data_r.to(device="cpu", dtype=torch.float64).numpy()


def _interpolate(method, device, grid, lats_center, lons_center, data):
    """An interpolation method's grid (n_lat, n_lon, C) float64, before the
    outline mask."""
    if method == "nearest_device":
        data_r, _ = bin_nearest(grid, *_to_device(
            device, lats_center, lons_center, data))
    elif method in ("linear_device", "cubic_device"):
        fn = (interp_linear_structured if method == "linear_device"
              else interp_cubic_structured)
        data_r, _ = fn(grid, *_to_device(device, lats_center, lons_center,
                                         data))
    else:
        import scipy.interpolate

        ok = ~np.isnan(lats_center.ravel())
        pts = (lats_center.ravel()[ok], lons_center.ravel()[ok])
        vals = data.reshape(-1, data.shape[-1])[ok]
        return scipy.interpolate.griddata(
            pts, vals, (grid.lat_centers[:, None], grid.lon_centers[None, :]),
            method=method)
    return _to_host(data_r)


def _target_grid(outline_fn, bbox, px_per_deg, contains_pole, shift,
                 altitude):
    """The regular grid a mapping resamples onto, in its working frame:
    rotated 90 deg about the x-axis when the mapping holds a pole, its
    longitudes shifted by 180 deg when it crosses the antimeridian.

    :param outline_fn: returns a copy of the mapping's outline
    :returns: the grid, a function returning the outline in the working
        frame, the grid's corner (lat, lon) in that frame, and the output
        corner and centre grids (lat, lon, lat_c, lon_c) in true coordinates
    """
    lat_min, lat_max = bbox.latSouth, bbox.latNorth
    lon_min, lon_max = bbox.lonWest, bbox.lonEast
    if contains_pole:
        outline = outline_fn()
        outline[:, 0], outline[:, 1] = _rotate_pole_deg(
            outline[:, 0], outline[:, 1], 90.0, altitude)
        lat_min, lat_max = outline[:, 0].min(), outline[:, 0].max()
        lon_min, lon_max = outline[:, 1].min(), outline[:, 1].max()
        outline_fn = lambda: outline
    elif shift:
        outline = outline_fn()
        outline[:, 1] = _wrap_lon_np(outline[:, 1] + 180.0)
        lon_min, lon_max = outline[:, 1].min(), outline[:, 1].max()
        outline_fn = lambda: outline

    grid = fixed_grid(px_per_deg, lat_min, lat_max, lon_min, lon_max)
    lat_grid, lon_grid = grid.corner_grids()
    lat_grid_c, lon_grid_c = grid.center_grids()
    corners = (lat_grid, lon_grid)
    if contains_pole:
        def unrotate(la, lo):
            la2, lo2 = _rotate_pole_deg(la.ravel(), lo.ravel(), -90.0,
                                        altitude)
            return la2.reshape(la.shape), lo2.reshape(lo.shape)

        lat_grid, lon_grid = unrotate(lat_grid, lon_grid)
        lat_grid_c, lon_grid_c = unrotate(lat_grid_c, lon_grid_c)
    elif shift:
        lon_grid = _wrap_lon_np(lon_grid + 180.0)
        lon_grid_c = _wrap_lon_np(lon_grid_c + 180.0)
    return grid, outline_fn, corners, (lat_grid, lon_grid, lat_grid_c,
                                       lon_grid_c)


def _resample_mapping(mapping, px_per_deg, arcsec_per_px, contains_pole,
                      method, bin_method, device):
    """:func:`resample` of one Mapping: the target grid, the samples in its
    frame, their binning or interpolation on ``device``, the Mapping."""
    altitude = mapping.altitude
    with span("resample.grid"):
        bbox = mapping.boundingBox
        if contains_pole is None:
            contains_pole = bbox.containsPole
        if arcsec_per_px:
            px_per_deg = plate_carree_resolution(bbox, arcsec_per_px)
        else:
            try:
                _, _ = px_per_deg
            except TypeError:
                px_per_deg = (px_per_deg, px_per_deg)
        shift = not contains_pole and bbox.containsDiscontinuity
        grid, outline_fn, corners, grids = _target_grid(
            lambda: mapping.outline.copy(), bbox, px_per_deg, contains_pole,
            shift, altitude)

    with span("resample.prepare"):
        img = mapping.img
        img_dtype = img.dtype
        if method == "nearest" and device.type == "cuda":
            method = "nearest_device"
        elif method == "nearest_host":
            method = "nearest"
        if bin_method == "auto" and method == "mean":
            n_ch = img.shape[2] if img.ndim == 3 else 1
            on_gpu = device.type == "cuda"
            if on_gpu and img_dtype == np.uint8 and n_ch == 3 and \
                    mapping.elevation is not None:
                # K1; its NaN-data-adds-0 contract equals taint semantics
                # here: mask invariants put NaN data only at NaN coordinates
                bin_method = "pallas_rgbelev"
            elif on_gpu and img_dtype == np.uint8:
                bin_method = "pallas_taint"
            else:
                bin_method = "sorted"
        elif bin_method == "auto":
            bin_method = "sorted"
        img3 = img if img.ndim == 3 else img[:, :, None]
        parts = [np.asarray(img3.astype(np.float64).filled(np.nan))]
        has_elevation = mapping.elevation is not None
        if has_elevation:  # CDF/netCDF files without zenith_angle have none
            parts.append(
                np.asarray(mapping.elevation.filled(np.nan))[:, :, None])
        data = np.concatenate(parts, axis=-1)
        lats_center = np.asarray(mapping.latsCenter.filled(np.nan))
        lons_center = np.asarray(mapping.lonsCenter.filled(np.nan))
        if contains_pole:
            la, lo = _rotate_pole_deg(lats_center.ravel(),
                                      lons_center.ravel(), 90.0, altitude)
            lats_center = la.reshape(lats_center.shape)
            lons_center = lo.reshape(lons_center.shape)
        elif shift:
            lons_center = _wrap_lon_np(lons_center + 180.0)

    if method == "mean":
        data_r = _bin_mean_on(device, grid, lats_center, lons_center, data,
                              bin_method)
    else:
        data_r = _interpolate(method, device, grid, lats_center, lons_center,
                              data)
        # mask cells outside the (concave) outline: griddata only clips to
        # the convex hull (reference resample.py:248-259)
        flat = np.stack([corners[0].ravel(), corners[1].ravel()], axis=-1)
        outside = ~points_inside_polygon(flat, outline_fn()).reshape(
            corners[0].shape)
        cell_outside = (outside[:-1, :-1] | outside[1:, :-1]
                        | outside[:-1, 1:] | outside[1:, 1:])
        data_r[cell_outside] = np.nan

    with span("resample.finish"):
        img_r = data_r[..., :-1] if has_elevation else data_r
        elevation_r = data_r[..., -1] if has_elevation else None
        if np.issubdtype(img_dtype, np.integer):
            img_r = _finalize_int_image(img_r, img_dtype)
        if img3.shape[2] == 1:
            img_r = img_r[..., 0]
        return mapping.createResampled(*grids, elevation_r, img_r)


def _min_lon_interval_deg(lons):
    """Smallest directional [west, east] longitude interval covering a
    POINT set on the circle: the complement of the largest gap between
    consecutive sorted longitudes. Wrap-aware, unlike vertex min/max, which
    returns the complement interval for a footprint straddling +-180.
    NaNs ignored. The endpoints are the original values (no mod
    round-trip), so a compact set away from +-180 gives exactly
    [min(lons), max(lons)]."""
    x0 = np.asarray(lons, dtype=np.float64).ravel()
    x0 = x0[np.isfinite(x0)]
    if x0.size == 0:
        raise ValueError("no finite longitudes")
    key = np.mod(x0, 360.0)
    order = np.argsort(key, kind="stable")
    key_s, orig_s = key[order], x0[order]
    gaps = np.diff(np.concatenate((key_s, key_s[:1] + 360.0)))
    i = int(np.argmax(gaps))

    def _w(v):
        v = float(v)
        return v if -180.0 <= v <= 180.0 else float(_wrap_lon_np(v))

    return _w(orig_s[(i + 1) % x0.size]), _w(orig_s[i])


def mosaic(collection, px_per_deg=25, arcsec_per_px=None, device="cuda"):
    """Compose a MappingCollection into ONE plate-carree mosaic mapping.

    Where mappings overlap (neighbouring THEMIS all-sky imagers) each grid
    cell takes the pixel of the station viewing it at the HIGHEST
    elevation — the overlap priority the reference applies when drawing
    collections (reference draw_helpers.py:128-178), materialized as data
    in one pass of :func:`auromat_tpu_torch.ops.regrid.bin_take_best` on
    ``device`` over all stations' samples.

    All mappings must carry elevation and share the emission altitude,
    image channel count and dtype. A collection whose members do not
    overlap gives a DISCONNECTED footprint: ``outline``/``boundingBox``/
    ``containsPole`` of the result follow the largest connected component
    only (the reference's single-contour outline). Returns a single
    :class:`Mapping` (camera_pos NaN; photoTime from the first member,
    identifier from the collection). Pole-containing collections compose
    in the rotated frame and return an irregular-grid mapping; a member
    that surrounds the rotated pole is refused. Antimeridian-crossing ones
    use the +180-deg lon shift.

    :param collection: MappingCollection or list of Mappings
    :param device: where the composite runs (the card by default)
    """
    device = compute_device(device)
    mappings = (collection.mappings
                if isinstance(collection, MappingCollection)
                else list(collection))
    identifier = getattr(collection, "identifier", None) or "collection"
    if not mappings:
        raise ValueError("empty collection")
    for m in mappings:
        if m.elevation is None:
            raise ValueError(
                f"mosaic needs elevation for overlap priority; {m.identifier}"
                " has none")
    altitude = mappings[0].altitude
    if any(abs(m.altitude - altitude) > 1e-9 for m in mappings):
        raise ValueError("mappings map different emission altitudes")
    n_ch = mappings[0].img.shape[2] if mappings[0].img.ndim == 3 else 1
    bbox = BoundingBox.mergedBoundingBoxes(m.boundingBox for m in mappings)
    contains_pole = any(m.containsPole for m in mappings)
    shift = bbox.containsDiscontinuity and not contains_pole
    if arcsec_per_px:
        px_per_deg = plate_carree_resolution(bbox, arcsec_per_px)
    try:
        _, _ = px_per_deg
    except TypeError:
        px_per_deg = (px_per_deg, px_per_deg)

    _rot = _partial(_rotate_pole_deg, altitude=altitude)

    lats_l, lons_l, data_l = [], [], []
    img_dtype = None
    rot_boxes = []
    for m in mappings:
        img = m.img
        img3 = img if img.ndim == 3 else img[:, :, None]
        if img3.shape[2] != n_ch:
            raise ValueError("mappings have different image channel counts")
        if img_dtype is None:
            img_dtype = img3.dtype
        elif img3.dtype != img_dtype:
            # a cast to the first dtype would wrap out-of-range values
            raise ValueError(
                f"mappings have different image dtypes: {img_dtype} vs "
                f"{img3.dtype}")
        la = np.asarray(m.latsCenter.filled(np.nan)).ravel()
        lo = np.asarray(m.lonsCenter.filled(np.nan)).ravel()
        if contains_pole:
            la, lo = _rot(la, lo, 90.0)
            ola, olo = _rot(m.outline[:, 0], m.outline[:, 1], 90.0)
            # each member's extent must be wrap-aware in the rotated frame;
            # a member surrounding a rotated pole has no lon interval
            if geodesic.contains_or_crosses_pole(
                    np.stack([ola, olo], axis=1)):
                raise ValueError(
                    f"{m.identifier}: footprint covers the rotated-frame "
                    "pole — the collection spans too much of the sphere "
                    "to compose in one rotated plate-carree frame; "
                    "mosaic such members separately")
            w, e = _min_lon_interval_deg(olo)
            rot_boxes.append(BoundingBox(float(ola.min()), w,
                                         float(ola.max()), e))
        elif shift:
            lo = _wrap_lon_np(lo + 180.0)
        el = np.asarray(m.elevation.filled(np.nan)).ravel()
        im = np.asarray(img3.astype(np.float32).filled(np.nan)).reshape(
            -1, n_ch)
        lats_l.append(la)
        lons_l.append(lo)
        data_l.append(np.concatenate([im, el[:, None]], axis=-1))
    lats = np.concatenate(lats_l)
    lons = np.concatenate(lons_l)
    data = np.concatenate(data_l, axis=0)

    rot_shift = False
    if contains_pole:
        rot_bbox = BoundingBox.mergedBoundingBoxes(rot_boxes)
        lat_min, lat_max = rot_bbox.latSouth, rot_bbox.latNorth
        lon_min, lon_max = rot_bbox.lonWest, rot_bbox.lonEast
        # the merged interval crosses +-180 in the rotated frame: compose in
        # the +180-shifted rotated frame, unshifted before unrotation
        rot_shift = lon_min > lon_max
        if rot_shift:
            lons = _wrap_lon_np(lons + 180.0)
            lon_min = _wrap_lon_np(lon_min + 180.0)
            lon_max = _wrap_lon_np(lon_max + 180.0)
            if lon_min > lon_max:
                # near-full-circle coverage: grid the whole circle
                lon_min, lon_max = -180.0, 180.0
    else:
        lat_min, lat_max = bbox.latSouth, bbox.latNorth
        lon_min, lon_max = ((bbox.lonWest, bbox.lonEast) if not shift else
                            (_wrap_lon_np(bbox.lonWest + 180.0),
                             _wrap_lon_np(bbox.lonEast + 180.0)))

    grid = fixed_grid(px_per_deg, float(lat_min), float(lat_max),
                      float(lon_min), float(lon_max))
    la_d, lo_d, pri_d, data_d = _to_device(device, lats, lons,
                                           -data[:, -1], data)
    best, _ = bin_take_best(grid, la_d, lo_d, pri_d, data_d)
    best = best.to(device="cpu", dtype=torch.float64).numpy()
    img_r, elev_r = best[..., :n_ch], best[..., n_ch]

    if np.issubdtype(img_dtype, np.integer):
        img_r = _finalize_int_image(img_r, img_dtype)
    if n_ch == 1:
        img_r = img_r[..., 0]
    if contains_pole:
        # unrotate the regular rotated-frame grid back to true lat/lon: an
        # irregular-grid Mapping, like the per-frame pole path
        lat_grid, lon_grid = grid.corner_grids()
        lat_grid_c, lon_grid_c = grid.center_grids()
        if rot_shift:
            lon_grid = _wrap_lon_np(lon_grid + 180.0)
            lon_grid_c = _wrap_lon_np(lon_grid_c + 180.0)
        shp, shpc = lat_grid.shape, lat_grid_c.shape
        lat_grid, lon_grid = (a.reshape(shp) for a in _rot(
            lat_grid.ravel(), lon_grid.ravel(), -90.0))
        lat_grid_c, lon_grid_c = (a.reshape(shpc) for a in _rot(
            lat_grid_c.ravel(), lon_grid_c.ravel(), -90.0))
        return Mapping(
            lat_grid, lon_grid, lat_grid_c, lon_grid_c, elev_r, altitude,
            img_r, np.full(3, np.nan), mappings[0].photoTime,
            f"{identifier}.mosaic",
        )
    return grid_mapping(grid, img_r, elev_r, altitude,
                        mappings[0].photoTime, f"{identifier}.mosaic",
                        shift=shift)


def ResampleProvider(provider, **kw):
    """Wrap a provider so that every mapping it returns is resampled
    (``get``, ``getById``, ``getSequence`` and, where the provider has it,
    ``getSequenceBatched``)."""
    import copy

    fn = _partial(resample, **kw)
    provider = copy.copy(provider)
    orig_get, orig_get_by_id, orig_seq = (provider.get, provider.getById,
                                          provider.getSequence)
    provider.get = lambda *a, **k: fn(orig_get(*a, **k))
    provider.getById = lambda *a, **k: fn(orig_get_by_id(*a, **k))
    provider.getSequence = lambda *a, **k: map(fn, orig_seq(*a, **k))
    if hasattr(provider, "getSequenceBatched"):
        orig_batched = provider.getSequenceBatched
        provider.getSequenceBatched = lambda *a, **k: map(
            fn, orig_batched(*a, **k))
    return provider
