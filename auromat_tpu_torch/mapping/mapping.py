"""Core data model: a georeferenced image with NaN-masked coordinate grids.

Counterpart of ``auromat_tpu.mapping.mapping``. As in the JAX package the
geometry stays on the host: a :class:`Mapping` holds numpy float64 arrays
where NaN is the mask, with numpy masked-array views for API familiarity,
and the mask-consistency invariants (reference mapping.py:295-316) are
enforced by :func:`sanitize_masks`.

Mask invariants (identical to the reference):
  - lats[y,x] defined <=> lons[y,x] defined
  - lats_center[y,x] defined <=> lons_center[y,x] defined
      <=> img[y,x] defined <=> elevation[y,x] defined
  - a corner is defined iff at least one adjacent centre is defined
  - a centre is defined iff all 4 of its corners are defined

Where the arithmetic runs: a property or method of :class:`Mapping`
cannot be told a device, so its tensor arithmetic (``mLatMlt``,
``cameraFootpoint``, ``maskedByPolygon``'s pole rotation) is float64 torch
on the CPU, next to the host arrays it reads. The module's functions that
do per-pixel work on whole grids (:func:`inflated_earth_intersection`,
:func:`convert_sm_mapping_to_geo`) take ``device="cuda"`` like every other
entry point and raise without a card.
"""

import copy as _copy
from collections import namedtuple

import numpy as np
import numpy.ma as ma
import torch

from auromat_tpu_torch import utils
from auromat_tpu_torch.constants import EARTH_RADIUS, WGS84_A, WGS84_B
from auromat_tpu_torch.coordinates import geodesic
from auromat_tpu_torch.coordinates.frames import FrameMatrices
from auromat_tpu_torch.coordinates.geodesic import (Location,
                                                    contains_or_crosses_pole)
from auromat_tpu_torch.coordinates.intersection import (
    ellipsoid_line_intersection, sphere_line_intersection)
from auromat_tpu_torch.coordinates.transform import (geo_to_mlat_mlt,
                                                     geodetic_to_ecef,
                                                     j2000_to_latlon,
                                                     mlt_to_sm_lon,
                                                     rotate_pole,
                                                     sm_to_latlon)
from auromat_tpu_torch.ops.georef import compute_device

Size = namedtuple("Size", ["width", "height"])
PixelScales = namedtuple("PixelScales", ["width", "height", "diagonal"])
PixelScale = namedtuple("PixelScale", ["mean", "median", "min", "max"])
MappingProperties = namedtuple(
    "MappingProperties",
    "altitude cameraPosGCRS boundingBox photoTime centroid cameraFootpoint identifier",
)


class BoundingBox:
    """Geographic bounding box that can span the 180-degree discontinuity.

    Reference: auromat/mapping/mapping.py:44-287.
    """

    def __init__(self, latSouth, lonWest, latNorth, lonEast):
        assert -180 <= lonWest <= 180, lonWest
        assert -180 <= lonEast <= 180, lonEast
        assert -90 <= latSouth <= 90, latSouth
        assert -90 <= latNorth <= 90, latNorth
        self._latSouth = float(latSouth)
        self._lonWest = float(lonWest)
        self._latNorth = float(latNorth)
        self._lonEast = float(lonEast)
        self._min_rect = None

    latSouth = property(lambda self: self._latSouth)
    lonWest = property(lambda self: self._lonWest)
    latNorth = property(lambda self: self._latNorth)
    lonEast = property(lambda self: self._lonEast)
    topLeft = property(lambda self: Location(self._latNorth, self._lonWest))
    bottomLeft = property(lambda self: Location(self._latSouth, self._lonWest))
    topRight = property(lambda self: Location(self._latNorth, self._lonEast))
    bottomRight = property(lambda self: Location(self._latSouth, self._lonEast))

    @property
    def containsDiscontinuity(self):
        return self._lonWest > self._lonEast or self.containsPole

    @property
    def containsPole(self):
        return (
            self._lonWest == -180
            and self._lonEast == 180
            and (self._latNorth == 90 or self._latSouth == -90)
        )

    def _min_spherical_rectangle(self):
        """(center, Size(km)) of the smallest spherical rectangle fitting the
        box (used as stereographic projection parameters for drawing).
        Reference: mapping.py:119-172."""
        if self._min_rect is not None:
            return self._min_rect
        if self.containsPole:
            if self._latNorth == 90:
                center = Location(90.0, 0.0)
                width = geodesic.distance(center, Location(self._latSouth, 0.0)) * 2
            else:
                center = Location(-90.0, 0.0)
                width = geodesic.distance(center, Location(self._latNorth, 0.0)) * 2
            size = Size(width / 1000, width / 1000)
        else:
            lon_west, lon_east = self._lonWest, self._lonEast
            if lon_west > lon_east:
                lon_east += 360
            lonc = utils.wrap_lon_180((lon_west + lon_east) / 2)
            width = geodesic.distance(self.bottomLeft, self.bottomRight)
            width2 = geodesic.distance(self.topLeft, self.topRight)
            if width2 > width:
                width = width2
                bottom_center = geodesic.intermediate(self.bottomLeft, self.bottomRight, 0.5)
                top_center = Location(self._latNorth, float(lonc))
                height = geodesic.distance(top_center, bottom_center)
                center = geodesic.intermediate(top_center, bottom_center, 0.5)
            else:
                top_center = geodesic.intermediate(self.topLeft, self.topRight, 0.5)
                bottom_center = Location(self._latSouth, float(lonc))
                height = geodesic.distance(bottom_center, top_center)
                center = geodesic.intermediate(bottom_center, top_center, 0.5)
            size = Size(width / 1000, height / 1000)
        self._min_rect = (center, size)
        return self._min_rect

    @property
    def center(self):
        return self._min_spherical_rectangle()[0]

    @property
    def size(self):
        return self._min_spherical_rectangle()[1]

    @staticmethod
    def mergedBoundingBoxes(boxes):
        boxes = list(boxes)
        lat_south = min(bb.latSouth for bb in boxes)
        lat_north = max(bb.latNorth for bb in boxes)
        lons = [(bb.lonWest, bb.lonEast) for bb in boxes]
        lon_west, lon_east = BoundingBox._minimum_bbox_lons(lons)
        return BoundingBox(lat_south, lon_west, lat_north, lon_east)

    @staticmethod
    def minimumBoundingBox(lat_lons):
        boxes = [BoundingBox(lat, lon, lat, lon) for lat, lon in lat_lons]
        return BoundingBox.mergedBoundingBoxes(boxes)

    @staticmethod
    def _minimum_bbox_lons(lons):
        """Smallest longitude interval covering all [west, east] intervals,
        allowing discontinuity wraps (gis.stackexchange.com/a/17987;
        reference mapping.py:250-275). Each [west, east] pair is directional
        (the interval runs eastward from west), so its width is
        (east - west) mod 360."""
        lons = np.asarray(lons, dtype=np.float64)
        xs = np.sort(lons.ravel())
        xs = np.concatenate((xs, [xs[0] + 360]))
        west = lons[:, 0]
        span = np.mod(lons[:, 1] - west, 360.0)
        span = np.where((span == 0) & (lons[:, 1] != west), 360.0, span)
        unwrapped = np.stack([west, west + span], axis=1)
        covers = np.zeros(len(xs) - 1, dtype=bool)
        for i in range(1, len(xs)):
            for bb in unwrapped:
                # intervals live on a circle: test the +-360 copies too
                if any(bb[0] + s <= xs[i - 1] and bb[1] + s >= xs[i]
                       for s in (-360.0, 0.0, 360.0)):
                    covers[i - 1] = True
                    break
        if covers.all():
            return -180.0, 180.0
        gap_lengths = ma.masked_array(xs[1:] - xs[:-1], covers)
        biggest = int(np.argmax(gap_lengths))
        lon_west = float(utils.wrap_lon_180(xs[biggest + 1]))
        lon_east = float(utils.wrap_lon_180(xs[biggest]))
        return lon_west, lon_east

    def __eq__(self, other):
        return (
            isinstance(other, BoundingBox)
            and self.latNorth == other.latNorth
            and self.latSouth == other.latSouth
            and self.lonWest == other.lonWest
            and self.lonEast == other.lonEast
        )

    def __repr__(self):
        return (
            f"BoundingBox(latSouth={self.latSouth}, lonWest={self.lonWest}, "
            f"latNorth={self.latNorth}, lonEast={self.lonEast})"
        )


def sanitize_masks(corner_mask, center_mask, after_masking=False):
    """Make corner/centre masks mutually consistent (True = masked).

    Pure-function equivalent of the reference's in-place fixpoint
    (auromat/mapping/mapping.py:1063-1125):
      1. corners with no defined neighbouring centre become masked,
      2. centres with any masked corner become masked,
      3. step 1 again for newly masked centres.

    :returns: (corner_mask, center_mask)
    """
    corner_mask = np.asarray(corner_mask, dtype=bool).copy()
    center_mask = np.asarray(center_mask, dtype=bool).copy()

    def corners_without_neighbors(cm):
        padded = np.ones((cm.shape[0] + 2, cm.shape[1] + 2), dtype=bool)
        padded[1:-1, 1:-1] = cm
        return (
            padded[1:, 1:] & padded[1:, :-1] & padded[:-1, :-1] & padded[:-1, 1:]
        )

    corner_mask |= corners_without_neighbors(center_mask)
    if not after_masking:
        any_corner_missing = (
            corner_mask[:-1, :-1]
            | corner_mask[1:, :-1]
            | corner_mask[1:, 1:]
            | corner_mask[:-1, 1:]
        )
        center_mask |= any_corner_missing
        corner_mask |= corners_without_neighbors(center_mask)
    return corner_mask, center_mask


def check_guarantees(mapping):
    """Assert the mask invariants hold (test oracle; reference
    mapping.py:362-428)."""
    lats, lons = mapping.lats, mapping.lons
    lats_c, lons_c = mapping.latsCenter, mapping.lonsCenter
    img = mapping.img
    elevation = mapping.elevation
    mlat, mlt = mapping.mLatMlt
    mlat_c, mlt_c = mapping.mLatMltCenter

    assert not np.any(np.isnan(lats)), "masked arrays must not contain NaN"
    assert not np.any(np.isnan(lats_c))
    assert not np.any(np.isnan(mlat))
    if elevation is not None:  # CDF/netCDF files without zenith_angle
        assert not np.any(np.isnan(elevation))

    cm = ma.getmaskarray(lats)
    assert np.array_equal(cm, ma.getmaskarray(lons))
    ccm = ma.getmaskarray(lats_c)
    assert np.array_equal(ccm, ma.getmaskarray(lons_c))

    padded = np.zeros((ccm.shape[0] + 2, ccm.shape[1] + 2), dtype=bool)
    padded[1:-1, 1:-1] = ~ccm
    assert np.all(cm | padded[1:, 1:] | padded[1:, :-1] | padded[:-1, :-1] | padded[:-1, 1:])

    ok = ~cm
    assert np.all(ccm | (ok[:-1, :-1] & ok[1:, :-1] & ok[1:, 1:] & ok[:-1, 1:]))

    img_mask = np.atleast_3d(ma.getmaskarray(img))  # grayscale img may be 2D
    for d in range(img_mask.shape[2]):
        assert np.array_equal(img_mask[:, :, d], ccm)
    if elevation is not None:
        assert np.array_equal(ma.getmaskarray(elevation), ccm)
    assert np.array_equal(ma.getmaskarray(mlat_c), ccm)
    assert np.array_equal(ma.getmaskarray(mlt_c), ccm)
    assert np.array_equal(ma.getmaskarray(mlat), cm)
    assert np.array_equal(ma.getmaskarray(mlt), cm)


def check_plate_carree(lats, lons):
    """Raise ValueError unless lats/lons form a regular plate-carree grid.

    Reference: auromat/mapping/mapping.py:931-961.
    """
    if ma.isMaskedArray(lats):
        lats, lons = lats.data, lons.data
    if np.any(np.isnan(lats)):
        raise ValueError("coordinates contain NaNs")
    lons = np.unwrap(np.deg2rad(lons))
    if lons[0, -1] - lons[0, 0] <= 0:
        raise ValueError("longitudes are not monotonically increasing")
    if lats[0, 0] - lats[-1, 0] <= 0:
        raise ValueError("latitudes are not monotonically decreasing")
    eps = 1e-4
    d_lon = lons[0, 1:] - lons[0, :-1]
    if np.max(d_lon) - np.min(d_lon) >= eps:
        raise ValueError("longitudes are not evenly spaced")
    d_lat = lats[:-1, 0] - lats[1:, 0]
    if np.max(d_lat) - np.min(d_lat) >= eps:
        raise ValueError("latitudes are not evenly spaced")


def is_plate_carree(lats, lons):
    try:
        check_plate_carree(lats, lons)
        return True
    except Exception:
        return False


class Mapping:
    """A georeferenced image for a given emission altitude.

    Construct with NaN-masked float arrays (degrees):
      lats, lons          (h+1, w+1)  pixel-corner coordinates
      lats_center, ...    (h, w)      pixel-centre coordinates
      elevation           (h, w)      viewing elevation, 0=horizon 90=nadir
      img                 (h, w, C)   uint8/uint16 image data
      camera_pos          (3,)        GCRS km
      photo_time          datetime
      altitude            km

    ``sanitized=False`` runs the mask fixpoint on construction.
    """

    def __init__(self, lats, lons, lats_center, lons_center, elevation, altitude,
                 img, camera_pos, photo_time, identifier, metadata=None,
                 sanitized=False, mlat_mlt=None, mlat_mlt_center=None,
                 frame_matrices=None):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        h, w = img.shape[0], img.shape[1]
        lats = self._data(lats)
        lons = self._data(lons)
        lats_center = self._data(lats_center)
        lons_center = self._data(lons_center)
        elevation = self._data(elevation) if elevation is not None else None
        assert lats.shape == lons.shape == (h + 1, w + 1), (lats.shape, (h, w))
        assert lats_center.shape == lons_center.shape == (h, w)

        # masks are stored apart from the data so that masking never
        # destroys the underlying values (a resampled mapping's coordinate
        # grids stay regular under the mask)
        corner_mask = np.isnan(lats) | np.isnan(lons)
        center_mask = np.isnan(lats_center) | np.isnan(lons_center)
        if elevation is not None:
            center_mask |= np.isnan(elevation)
        if not sanitized:
            corner_mask, center_mask = sanitize_masks(corner_mask, center_mask)
        self._corner_mask_arr = corner_mask
        self._center_mask_arr = center_mask

        self._lats = lats
        self._lons = lons
        self._lats_center = lats_center
        self._lons_center = lons_center
        self._elevation = elevation
        self._img = img
        self._altitude = float(altitude)
        self._camera_pos = np.asarray(camera_pos, dtype=np.float64)
        self._photo_time = photo_time
        self._identifier = identifier
        self._metadata = metadata or {}
        self._frame_matrices = frame_matrices
        self._mlatmlt = mlat_mlt
        self._mlatmlt_center = mlat_mlt_center
        self._outlines = None
        self._bounding_box = None
        self._centroid = None
        self._pixel_scales = None

    @staticmethod
    def _data(a):
        if a is None:
            return None
        if ma.isMaskedArray(a):
            return np.asarray(a.filled(np.nan), dtype=np.float64)
        return np.array(a, dtype=np.float64)

    # ---- core array properties (masked-array views, reference API names)

    @property
    def corner_mask(self):
        return self._corner_mask_arr

    @property
    def center_mask(self):
        return self._center_mask_arr

    @property
    def lats(self):
        return ma.masked_array(self._lats, self._corner_mask_arr, copy=False)

    @property
    def lons(self):
        return ma.masked_array(self._lons, self._corner_mask_arr, copy=False)

    @property
    def latsCenter(self):
        return ma.masked_array(self._lats_center, self._center_mask_arr, copy=False)

    @property
    def lonsCenter(self):
        return ma.masked_array(self._lons_center, self._center_mask_arr, copy=False)

    @property
    def elevation(self):
        if self._elevation is None:
            return None
        return ma.masked_array(self._elevation, self._center_mask_arr, copy=False)

    @property
    def img(self):
        mask = np.repeat(self.center_mask[:, :, None], self._img.shape[2], 2)
        return ma.masked_array(self._img, mask)

    @property
    def img_unmasked(self):
        return self._img

    @property
    def rgb(self):
        # rgb_unmasked is always (h, w, 3); the img mask is (h, w, C) with
        # C possibly 1 (grayscale) — rebuild at 3 channels
        mask = np.repeat(self.center_mask[:, :, None], 3, 2)
        return ma.masked_array(self.rgb_unmasked, mask)

    @property
    def rgb_unmasked(self):
        img = self._img
        if img.dtype == np.uint16:
            img = (img.astype(np.float64) * (255 / 65535)).astype(np.uint8)
        elif img.dtype != np.uint8:
            raise NotImplementedError(str(img.dtype))
        if img.shape[2] == 3:
            return img
        if img.shape[2] == 1:
            return np.repeat(img, 3, 2)
        raise NotImplementedError("unknown img format")

    # ---- scalar metadata

    altitude = property(lambda self: self._altitude)
    cameraPosGCRS = property(lambda self: self._camera_pos)
    photoTime = property(lambda self: self._photo_time)
    identifier = property(lambda self: self._identifier)
    metadata = property(lambda self: self._metadata)

    @property
    def frame_matrices(self):
        if self._frame_matrices is None:
            self._frame_matrices = FrameMatrices(self._photo_time)
        return self._frame_matrices

    @property
    def cameraFootpoint(self):
        """Geodetic location below the camera (float64 torch on the CPU)."""
        lat, lon = j2000_to_latlon(
            torch.from_numpy(self._camera_pos[None, :].copy()),
            self.frame_matrices.j2000_to_geo)
        return Location(float(lat[0]), float(lon[0]))

    @property
    def properties(self):
        return MappingProperties(
            altitude=self.altitude,
            cameraPosGCRS=self.cameraPosGCRS,
            boundingBox=self.boundingBox,
            photoTime=self.photoTime,
            centroid=self.centroid,
            cameraFootpoint=self.cameraFootpoint,
            identifier=self.identifier,
        )

    # ---- magnetic coordinates

    def _mlat_mlt(self, lats_deg, lons_deg, mask):
        """MLat/MLT from geodetic coordinates at the mapping's altitude
        (host float64, CPU torch)."""
        t = lambda a: torch.from_numpy(np.deg2rad(a))
        x, y, z = geodetic_to_ecef(t(lats_deg), t(lons_deg), self._altitude)
        mlat, mlt = geo_to_mlat_mlt(torch.stack([x, y, z], dim=-1),
                                    self.frame_matrices.geo_to_sm)
        return (ma.masked_array(mlat.numpy(), mask, copy=False),
                ma.masked_array(mlt.numpy(), mask, copy=False))

    @property
    def mLatMlt(self):
        """(mlat, mlt) masked arrays for pixel corners."""
        if self._mlatmlt is None:
            self._mlatmlt = self._mlat_mlt(self._lats, self._lons,
                                           self._corner_mask_arr)
        return self._mlatmlt

    @property
    def mLatMltCenter(self):
        if self._mlatmlt_center is None:
            self._mlatmlt_center = self._mlat_mlt(
                self._lats_center, self._lons_center, self._center_mask_arr)
        return self._mlatmlt_center

    # ---- derived geometry

    @property
    def outline(self):
        """Full (possibly concave) outline as (n, 2) lat/lon degrees."""
        return self._full_and_convex_outlines()[0]

    @property
    def outlineConvexHull(self):
        return self._full_and_convex_outlines()[1]

    def _full_and_convex_outlines(self):
        if self._outlines is None:
            outl = utils.outline(~self.corner_mask)
            full = np.stack(
                [self._lats[outl[:, 1], outl[:, 0]], self._lons[outl[:, 1], outl[:, 0]]],
                axis=-1,
            )
            hull = utils.convex_hull(outl)
            convex = np.stack(
                [self._lats[hull[:, 1], hull[:, 0]], self._lons[hull[:, 1], hull[:, 0]]],
                axis=-1,
            )
            self._outlines = (full, convex)
        return self._outlines

    @property
    def boundingBox(self):
        """Reference: auromat/mapping/mapping.py:693-743 (degenerate when a
        pole is contained: spans the full longitude range)."""
        if self._bounding_box is None:
            outl = self.outline
            lat_min, lat_max = float(np.min(outl[:, 0])), float(np.max(outl[:, 0]))
            lon_min, lon_max = float(np.min(outl[:, 1])), float(np.max(outl[:, 1]))

            hull = self.outlineConvexHull
            count = len(hull)
            sample = min(count, 50)
            idx = np.round(np.linspace(0, count - 1, sample)).astype(int)
            reduced = hull[idx]

            if contains_or_crosses_pole(reduced):
                lon_west, lon_east = -180.0, 180.0
                if lat_max < 0:
                    lat_south, lat_north = -90.0, lat_max
                else:
                    lat_south, lat_north = lat_min, 90.0
            else:
                if lon_max - lon_min > 180:
                    west = outl[:, 1] > 0
                    lon_west = float(np.min(outl[west, 1]))
                    lon_east = float(np.max(outl[~west, 1]))
                else:
                    lon_west, lon_east = lon_min, lon_max
                lat_south, lat_north = lat_min, lat_max
            self._bounding_box = BoundingBox(lat_south, lon_west, lat_north, lon_east)
        return self._bounding_box

    @property
    def containsDiscontinuity(self):
        return self.boundingBox.containsDiscontinuity

    @property
    def containsPole(self):
        return self.boundingBox.containsPole

    @property
    def centroid(self):
        if self._centroid is None:
            if self.containsPole:
                raise NotImplementedError("centroid of pole-containing mapping")
            outl = self.outline
            if self.containsDiscontinuity:
                lons = utils.wrap_lon_180(outl[:, 1] + 180.0)
                lat, lon = utils.polygon_centroid(np.stack([outl[:, 0], lons], axis=-1))
                self._centroid = Location(lat, float(utils.wrap_lon_180(lon + 180.0)))
            else:
                lat, lon = utils.polygon_centroid(outl)
                self._centroid = Location(lat, lon)
        return self._centroid

    @property
    def arcSecPerPx(self):
        """Angular pixel sizes from 1000 sampled polygons; one vectorized
        geodesic call per direction (the reference loops host-side because
        geographiclib is scalar-only, mapping.py:786-843)."""
        if self._pixel_scales is None:
            ll = np.stack([self._lats, self._lons], axis=-1)
            quads = np.stack(
                [ll[:-1, :-1], ll[:-1, 1:], ll[1:, 1:], ll[1:, :-1]], axis=2
            ).reshape(-1, 4, 2)
            has_nan = np.isnan(quads).any(axis=(1, 2))
            quads = quads[~has_nan]
            count = quads.shape[0]
            sample = min(count, 1000)
            idx = np.round(np.linspace(0, count - 1, sample)).astype(int)
            q = quads[idx]
            scales = []
            for i, j in ((0, 1), (1, 2), (0, 2)):
                deg = geodesic.angular_distance(
                    (q[:, i, 0], q[:, i, 1]), (q[:, j, 0], q[:, j, 1])
                )
                arcsec = np.asarray(deg) * 3600.0
                scales.append(
                    PixelScale(float(arcsec.mean()), float(np.median(arcsec)),
                               float(arcsec.min()), float(arcsec.max()))
                )
            self._pixel_scales = PixelScales(*scales)
        return self._pixel_scales

    # ---- masking

    def createMasked(self, center_mask):
        """New Mapping with the given centre mask added (corner mask is
        re-derived by the sanitize fixpoint)."""
        corner_mask, center_mask = sanitize_masks(
            self.corner_mask, self.center_mask | center_mask, after_masking=True
        )
        m = self._clone(self._lats, self._lons, self._lats_center,
                        self._lons_center, self._elevation, self._img)
        m._corner_mask_arr = corner_mask
        m._center_mask_arr = center_mask
        # carry precomputed MLat/MLT (the J2000-derived values of
        # astrometry mappings) under the widened masks — recomputing them
        # lazily would switch to the less accurate geodetic path
        if self._mlatmlt is not None:
            a, b = self._mlatmlt
            m._mlatmlt = (
                ma.masked_array(np.asarray(ma.filled(a, np.nan)), corner_mask),
                ma.masked_array(np.asarray(ma.filled(b, np.nan)), corner_mask),
            )
        if self._mlatmlt_center is not None:
            a, b = self._mlatmlt_center
            m._mlatmlt_center = (
                ma.masked_array(np.asarray(ma.filled(a, np.nan)), center_mask),
                ma.masked_array(np.asarray(ma.filled(b, np.nan)), center_mask),
            )
        return m

    def _clone(self, lats, lons, lats_c, lons_c, elev, img):
        m = type(self)(
            lats, lons, lats_c, lons_c, elev, self._altitude, img,
            self._camera_pos, self._photo_time, self._identifier,
            metadata=self._metadata, sanitized=True,
            frame_matrices=self._frame_matrices,
        )
        if hasattr(self, "wcs_header"):
            m.wcs_header = self.wcs_header
        return m

    def maskedByElevation(self, min_elevation=10):
        """Reference: auromat/mapping/mapping.py:845-864."""
        if self._elevation is None:
            raise ValueError("the mapping has no elevation to mask by")
        with np.errstate(invalid="ignore"):
            center_mask = ~(self._elevation >= min_elevation)
        if np.all(center_mask):
            raise ValueError(f"minElevation={min_elevation} would mask all pixels!")
        return self.createMasked(center_mask)

    def maskedByPolygon(self, polygon):
        """Mask pixels whose corners are not all inside the polygon.

        Reference: auromat/mapping/mapping.py:866-917 (with the same
        best-effort discontinuity/pole handling).
        """
        polygon = np.asarray(polygon, dtype=np.float64)
        grid = np.stack([self._lats, self._lons], axis=-1).reshape(-1, 2)
        poly_bb = BoundingBox.minimumBoundingBox(polygon)
        poly_pole = contains_or_crosses_pole(polygon)
        # pole FIRST: a pole-containing bbox spans -180..180 and therefore
        # also reports containsDiscontinuity, but the 180-degree shift
        # neither removes the pole singularity nor moves the polygon off
        # the discontinuity -- only the pole rotation does (same order as
        # _resample in resample.py)
        if self.containsPole or poly_pole:
            polygon = polygon.copy()
            for arr in (grid, polygon):  # float64 torch on the CPU
                la, lo = rotate_pole(
                    torch.from_numpy(np.deg2rad(arr[:, 0])),
                    torch.from_numpy(np.deg2rad(arr[:, 1])),
                    self._altitude, angle_deg=90.0, axis=(1, 0, 0),
                )
                arr[:, 0] = np.rad2deg(la.numpy())
                arr[:, 1] = np.rad2deg(lo.numpy())
        elif self.containsDiscontinuity or poly_bb.containsDiscontinuity:
            polygon = polygon.copy()
            grid[:, 1] = utils.wrap_lon_180(grid[:, 1] + 180.0)
            polygon[:, 1] = utils.wrap_lon_180(polygon[:, 1] + 180.0)
        with np.errstate(invalid="ignore"):
            inside = utils.points_inside_polygon(grid, polygon).reshape(self._lats.shape)
        mask = ~inside | self.corner_mask
        if np.all(mask):
            raise ValueError("the given polygon would mask all pixels!")
        center_mask = mask[:-1, :-1] | mask[1:, :-1] | mask[:-1, 1:] | mask[1:, 1:]
        return self.createMasked(center_mask)

    # ---- conversion/creation

    def createResampled(self, lats, lons, lats_center, lons_center, elevation, img):
        return Mapping(
            lats, lons, lats_center, lons_center, elevation, self._altitude, img,
            self._camera_pos, self._photo_time, self._identifier,
            metadata=self._metadata, frame_matrices=self._frame_matrices,
        )

    def checkGuarantees(self):
        check_guarantees(self)

    @property
    def isPlateCarree(self):
        return is_plate_carree(self._lats, self._lons)

    def checkPlateCarree(self):
        check_plate_carree(self._lats, self._lons)


GenericMapping = Mapping


class MappingCollection:
    """Mappings for the same instant (e.g. all THEMIS stations).

    Reference: auromat/mapping/mapping.py:1315-1373.
    """

    def __init__(self, mappings, identifier=None, mayOverlap=True):
        self._mappings = list(mappings)
        self._identifier = identifier
        self._may_overlap = mayOverlap

    identifier = property(lambda self: self._identifier)
    mappings = property(lambda self: self._mappings)
    mayOverlap = property(lambda self: self._may_overlap)

    @property
    def empty(self):
        return len(self._mappings) == 0

    def maskedByElevation(self, min_elevation=10):
        return MappingCollection(
            [m.maskedByElevation(min_elevation) for m in self._mappings],
            self._identifier, self._may_overlap,
        )

    @property
    def boundingBox(self):
        return BoundingBox.mergedBoundingBoxes(m.boundingBox for m in self._mappings)

    @property
    def photoTime(self):
        times = sorted(m.photoTime for m in self._mappings)
        return times[len(times) // 2]

    def __len__(self):
        return len(self._mappings)

    def __iter__(self):
        return iter(self._mappings)


class BaseMappingProvider:
    """Provider protocol: get / getById / getSequence / contains / range.

    Reference: auromat/mapping/mapping.py:1375-1445.
    """

    def __init__(self, maxTimeOffset=3):
        self.maxTimeOffset = maxTimeOffset

    @property
    def range(self):
        raise NotImplementedError

    def contains(self, date):
        raise NotImplementedError

    def containsAny(self, dates):
        return any(self.contains(d) for d in dates)

    def get(self, date):
        raise NotImplementedError

    def getById(self, identifier):
        raise NotImplementedError

    def getSequence(self, dateBegin=None, dateEnd=None):
        raise NotImplementedError


def MaskByElevationProvider(provider, *args, **kw):
    """Wrap a provider so every mapping is masked by elevation."""
    provider = _copy.copy(provider)
    orig_get, orig_get_by_id, orig_seq = provider.get, provider.getById, provider.getSequence
    provider.get = lambda *a, **k: orig_get(*a, **k).maskedByElevation(*args, **kw)
    provider.getById = lambda *a, **k: orig_get_by_id(*a, **k).maskedByElevation(*args, **kw)
    provider.getSequence = lambda *a, **k: (
        m.maskedByElevation(*args, **kw) for m in orig_seq(*a, **k)
    )
    # batched-pipeline dispatch probes hasattr(provider, "getSequenceBatched")
    # (cli/convert.py): wrap it too, or batched consumers would silently get
    # UNMASKED mappings from the copied provider
    if hasattr(provider, "getSequenceBatched"):
        orig_batched = provider.getSequenceBatched
        provider.getSequenceBatched = lambda *a, **k: (
            m.maskedByElevation(*args, **kw) for m in orig_batched(*a, **k)
        )
    return provider


def inflated_earth_intersection(directions, camera_pos, earth_inflation=110,
                                earth_model="wgs84", device="cuda"):
    """Ray/inflated-Earth intersections (reference mapping.py:1474-1510) as
    a host float64 array, computed in float64 on ``device`` (the card by
    default; pass ``device="cpu"`` for the CPU). The fused pipelines in
    :mod:`auromat_tpu_torch.ops.georef` carry their own intersection.
    """
    device = compute_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                  device=device)
    if earth_model == "wgs84":
        out = ellipsoid_line_intersection(
            WGS84_A + earth_inflation, WGS84_B + earth_inflation,
            t(camera_pos), t(directions))
    elif earth_model == "sphere":
        out = sphere_line_intersection(
            EARTH_RADIUS + earth_inflation, t(camera_pos), t(directions))
    else:
        raise ValueError("unsupported earth model: " + earth_model)
    return out.cpu().numpy()


def convert_mapping_to_sm(mapping: Mapping) -> Mapping:
    """Coordinates -> solar-magnetic lat/lon (for magnetic-grid resampling).

    Reference: auromat/mapping/mapping.py:1519-1547. Host arithmetic only:
    the mapping's MLat/MLT (precomputed by ``create_mapping``, else the
    ``mLatMlt`` property) become the coordinates.
    """
    mlat, mlt = mapping.mLatMlt
    mlat_c, mlt_c = mapping.mLatMltCenter
    return Mapping(
        np.asarray(mlat.filled(np.nan)), mlt_to_sm_lon(np.asarray(mlt.filled(np.nan))),
        np.asarray(mlat_c.filled(np.nan)), mlt_to_sm_lon(np.asarray(mlt_c.filled(np.nan))),
        np.asarray(mapping.elevation.filled(np.nan)) if mapping.elevation is not None else None,
        mapping.altitude, mapping.img_unmasked, mapping.cameraPosGCRS,
        mapping.photoTime, mapping.identifier, metadata=mapping.metadata,
        sanitized=True, frame_matrices=mapping.frame_matrices,
    )


def convert_sm_mapping_to_geo(mapping: Mapping, device="cuda") -> Mapping:
    """Inverse of :func:`convert_mapping_to_sm` (at the mapping altitude —
    see sm_to_latlon for the deviation from the reference's unit-radius
    version), in float64 on ``device``."""
    device = compute_device(device)
    fm = mapping.frame_matrices
    # convert the UNDERLYING regular grids (resampled SM mappings keep
    # regular coordinate data with the mask stored separately — the module
    # convention), then carry the source masks over explicitly: deriving
    # them from NaNs of the converted data would silently return an
    # all-False corner mask
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                  device=device)
    lats, lons = sm_to_latlon(
        t(mapping.lats.data), t(mapping.lons.data), fm.sm_to_geo,
        altitude=mapping.altitude)
    lats_c, lons_c = sm_to_latlon(
        t(mapping.latsCenter.data), t(mapping.lonsCenter.data), fm.sm_to_geo,
        altitude=mapping.altitude)
    h = lambda a: a.cpu().numpy()
    out = Mapping(
        h(lats), h(lons), h(lats_c), h(lons_c),
        np.asarray(mapping.elevation.filled(np.nan)) if mapping.elevation is not None else None,
        mapping.altitude, mapping.img_unmasked, mapping.cameraPosGCRS,
        mapping.photoTime, mapping.identifier, metadata=mapping.metadata,
        sanitized=True, frame_matrices=fm,
    )
    out._corner_mask_arr = out._corner_mask_arr | mapping.corner_mask
    out._center_mask_arr = out._center_mask_arr | mapping.center_mask
    return out
