"""MIRACLE ground all-sky camera provider (FMI network).

Counterpart of ``auromat_tpu.mapping.miracle`` (reference
auromat/mapping/miracle.py): the ``cal.txt`` calibration table (station
position, optical centre xc/yc, radial scale k, rotation, validity
window), the fisheye model pixel -> azimuth/elevation, az/el -> direction
vectors rotated to the station, and the inflated-ellipsoid intersection of
the corner and centre grids in float64 on ``device``; plus the 'simple'
constant plate-carree grid mode. Everything happens in the GEO (ECEF)
frame.

:func:`get_mapping` reads the JPEG with PIL (imported inside
``io.image.load_image``). :func:`create_mapping` takes the image array and
does all the rest, so a machine without PIL builds MIRACLE mappings from
arrays.
"""

import datetime
import fnmatch
import os
from collections import namedtuple

import numpy as np
import torch

from auromat_tpu_torch.constants import WGS84_A, WGS84_B
from auromat_tpu_torch.coordinates.frames import FrameMatrices, rot_y, rot_z
from auromat_tpu_torch.coordinates.intersection import \
    ellipsoid_line_intersection
from auromat_tpu_torch.coordinates.transform import (ecef_to_geodetic,
                                                     station_ecef)
from auromat_tpu_torch.io.image import load_image
from auromat_tpu_torch.mapping.mapping import (BaseMappingProvider,
                                               BoundingBox, Mapping,
                                               MappingCollection)
from auromat_tpu_torch.ops.georef import compute_device
from auromat_tpu_torch.timeutil import naive_epoch
from auromat_tpu_torch.utils import find_nearest

FILE_DATETIME_FORMAT = "%y%m%d_%H%M%S"

# xc, yc, k are relative to a 512x512 image; xc is the vertical axis
CalibrationData = namedtuple(
    "CalibrationData",
    ["station", "validFrom", "validTo", "lat", "lon", "xc", "yc", "k",
     "rotation", "boundingBoxSimple"],
)


def get_calibration_data(path, station, date) -> CalibrationData:
    """Parse cal.txt and select the entry valid for (station, date).

    Reference: auromat/mapping/miracle.py:367-404; the validity columns are
    fractional years (yyyy + (mm-1)/12).
    """
    entries = np.loadtxt(
        path,
        dtype={
            "names": ("station", "lat", "lon", "from", "to", "xc", "yc", "k",
                      "rotation", "lat+", "lat-", "lon-", "lon+", "i1", "i2",
                      "i3"),
            "formats": ("U3",) + ("f8",) * 12 + ("b1",) * 3,
        },
        ndmin=1,
    )
    for e in entries:
        if e["station"] != station:
            continue
        from_y = int(e["from"])
        from_m = int((e["from"] - from_y) * 12 + 1)
        to_y = int(e["to"])
        to_m = int((e["to"] - to_y) * 12 + 1)
        valid_from = datetime.datetime(from_y, from_m, 1)
        to_m += 1
        if to_m > 12:
            to_y, to_m = to_y + 1, to_m - 12
        valid_to = datetime.datetime(to_y, to_m, 1)
        if not valid_from <= date <= valid_to:
            continue
        lat, lon = float(e["lat"]), float(e["lon"])
        bb = BoundingBox(
            latSouth=lat + e["lat-"], lonWest=lon + e["lon-"],
            latNorth=lat + e["lat+"], lonEast=lon + e["lon+"],
        )
        return CalibrationData(
            station=e["station"], validFrom=valid_from, validTo=valid_to,
            lat=lat, lon=lon, xc=float(e["xc"]), yc=float(e["yc"]),
            k=float(e["k"]), rotation=float(e["rotation"]),
            boundingBoxSimple=bb,
        )
    raise ValueError(f"No MIRACLE calibration data found for {station} station")


def fisheye_az_el(cal: CalibrationData, size, corner=False):
    """Pixel grid -> (azimuth deg in [0, 360), elevation deg), host float64.

    Fisheye model (reference miracle.py:314-347): azimuth is the signed
    angle between (pixel - optical centre) and image north ([-1, 0] in
    (row, col) space) minus the camera rotation; elevation is 90 - dist/k
    (k calibrated for 512 px images, rescaled to the actual size).
    """
    w = size
    scale = w / 512.0
    xc, yc, k = cal.xc * scale, cal.yc * scale, cal.k * scale
    n = w + 1 if corner else w
    off = 0.0 if corner else 0.5
    rows = np.arange(n, dtype=np.float64)[:, None] + off - xc
    cols = np.arange(n, dtype=np.float64)[None, :] + off - yc
    rows, cols = np.broadcast_arrays(rows, cols)
    # signed angle between v = (rows, cols) and north = (-1, 0)
    az = np.arctan2(cols, -rows)
    az = az - cal.rotation
    az_deg = np.rad2deg(az) % 360.0
    dist = np.hypot(rows, cols)
    el_deg = 90.0 - np.rad2deg(dist / k)
    return az_deg, el_deg


def az_el_to_geo_directions(cal: CalibrationData, az_deg, el_deg):
    """Local az/el -> unit direction vectors in the GEO frame, host float64.

    Reference: miracle.py:240-258 — spherical directions at the pole rotated
    by Ry(90-lat) then Rz(lon).
    """
    el = np.deg2rad(el_deg)
    az = np.deg2rad(-(az_deg - 180.0))
    x = np.cos(el) * np.cos(az)
    y = np.cos(el) * np.sin(az)
    z = np.sin(el)
    mat = rot_z(np.deg2rad(cal.lon)) @ rot_y(np.deg2rad(90.0 - cal.lat))
    vecs = np.stack([x, y, z], axis=-1)
    return vecs @ mat.T


class MIRACLEMapping(Mapping):
    pass


def _grid_latlon(cal, w, altitude, cam_geo, corner, device):
    """Corner or centre grid: fisheye directions (host float64), their
    intersection with the shell at ``altitude`` in float64 on ``device``."""
    az, el = fisheye_az_el(cal, w, corner=corner)
    dirs = torch.from_numpy(az_el_to_geo_directions(cal, az, el)).to(device)
    origin = torch.from_numpy(cam_geo).to(device)
    inter = ellipsoid_line_intersection(WGS84_A + altitude, WGS84_B + altitude,
                                        origin, dirs)
    lat, lon = ecef_to_geodetic(inter[..., 0], inter[..., 1], inter[..., 2])
    out = torch.stack([torch.rad2deg(lat), torch.rad2deg(lon)]).cpu().numpy()
    return out[0], out[1]


def create_mapping(img, cal: CalibrationData, date, altitude=110,
                   simple=False, device="cuda"):
    """Build a MIRACLE Mapping from an image array (the work of
    :func:`get_mapping` after reading the file; reference
    miracle.py:350-365).

    :param img: (w, w, 3) image array (a caption below the square image
        area is cut off)
    :param cal: the station's :class:`CalibrationData`
    :param date: the exposure time
    :param simple: the constant plate-carree grid of ``cal``'s
        boundingBoxSimple (altitude 110) instead of the fisheye model
    :param device: where the fisheye rays meet the shell (the card by
        default; ``device="cpu"`` for the CPU)
    """
    device = compute_device(device)
    img = np.asarray(img)
    if img.shape[0] != img.shape[1]:
        img = img[: img.shape[1], :]
    w = img.shape[0]
    altitude = 110 if simple or altitude is None else altitude

    fm = FrameMatrices(date)
    cam_geo = station_ecef(cal.lat, cal.lon)
    cam_gcrs = fm.geo_to_j2000 @ cam_geo
    identifier = cal.station + "." + date.strftime("%Y.%m.%d.%H.%M.%S")

    if simple:
        bb = cal.boundingBoxSimple
        lat_space = np.linspace(bb.latNorth, bb.latSouth, w + 1)
        lon_space = np.linspace(bb.lonWest, bb.lonEast, w + 1)
        lats = np.broadcast_to(lat_space[:, None], (w + 1, w + 1)).copy()
        lons = np.broadcast_to(lon_space[None, :], (w + 1, w + 1)).copy()
        d_lat = lat_space[1] - lat_space[0]
        d_lon = lon_space[1] - lon_space[0]
        lats_c = lats[:-1, :-1] + d_lat / 2
        lons_c = lons[:-1, :-1] + d_lon / 2
    else:
        lats, lons = _grid_latlon(cal, w, altitude, cam_geo, True, device)
        lats_c, lons_c = _grid_latlon(cal, w, altitude, cam_geo, False,
                                      device)
    _, el_c = fisheye_az_el(cal, w, corner=False)

    mapping = MIRACLEMapping(
        lats, lons, lats_c, lons_c, el_c, altitude, img, cam_gcrs, date,
        identifier, frame_matrices=fm,
    )
    # 0.1 deg absorbs rounding at the fisheye rim (reference miracle.py:364)
    return mapping.maskedByElevation(0.1)


def get_mapping(image_path, altitude=110, simple=False, cal_path=None,
                device="cuda"):
    """Build a Mapping from a MIRACLE all-sky image file such as
    SOD120304_171900_557_1000.jpg (reading it needs PIL) and the
    ``cal.txt`` beside it (or ``cal_path``); :func:`create_mapping` does
    the rest on ``device``."""
    device = compute_device(device)
    filename = os.path.basename(image_path)
    station = filename[:3]
    date = datetime.datetime.strptime(filename[3:16], FILE_DATETIME_FORMAT)
    cal_path = cal_path or os.path.join(os.path.dirname(image_path),
                                        "cal.txt")
    cal = get_calibration_data(cal_path, station, date)
    return create_mapping(load_image(image_path), cal, date, altitude, simple,
                          device)


class MIRACLEMappingProvider(BaseMappingProvider):
    """Provider over a folder of images and cal.txt (reference
    miracle.py:36-107).

    :param device: where the mappings are computed (the card by default;
        ``device="cpu"`` for the CPU)
    """

    def __init__(self, imageFolder, altitude=110, simple=False,
                 maxTimeOffset=5, device="cuda"):
        super().__init__(maxTimeOffset)
        self.device = compute_device(device)
        self.imageFolder = imageFolder
        self.altitude = altitude
        self.simple = simple
        self.imageFileExtension = "jpg"
        names = sorted(fnmatch.filter(os.listdir(imageFolder),
                                      "*." + self.imageFileExtension))
        self.imageDates = []
        self.images = {}
        for f in names:
            try:
                d = datetime.datetime.strptime(f[3:16], FILE_DATETIME_FORMAT)
            except ValueError:
                continue  # not a MIRACLE-named file
            self.imageDates.append(d)
            self.images.setdefault(f[:3], []).append((f, d))

    def __len__(self):
        return len(self.imageDates)

    @property
    def range(self):
        dates = sorted(self.imageDates)
        return dates[0], dates[-1]

    def _mapping(self, filename):
        return get_mapping(os.path.join(self.imageFolder, filename),
                           self.altitude, self.simple, device=self.device)

    def _nearest(self, images, date):
        """The (file, date) of ``images`` nearest to ``date`` within
        maxTimeOffset, or None."""
        dates = [naive_epoch(d) for _, d in images]
        idx = find_nearest(dates, naive_epoch(date))
        if abs(dates[idx] - naive_epoch(date)) <= self.maxTimeOffset:
            return images[idx]
        return None

    def contains(self, date):
        return any(self._nearest(images, date) is not None
                   for images in self.images.values())

    def get(self, date):
        mappings = []
        for images in self.images.values():
            hit = self._nearest(images, date)
            if hit is not None:
                mappings.append(self._mapping(hit[0]))
        ident = "MIRACLE." + date.strftime("%Y.%m.%d.%H.%M.%S")
        return MappingCollection(mappings, identifier=ident, mayOverlap=True)

    def getById(self, identifier):
        station, rest = identifier.split(".", 1)
        date = datetime.datetime.strptime(rest, "%Y.%m.%d.%H.%M.%S")
        for f, d in self.images.get(station, []):
            if d == date:
                return self._mapping(f)
        raise ValueError(f"no mapping with identifier {identifier!r}")

    def getSequence(self, dateBegin=None, dateEnd=None):
        entries = sorted(
            (d, f) for files in self.images.values() for f, d in files)
        for d, f in entries:
            if dateBegin is not None and d < dateBegin:
                continue
            if dateEnd is not None and d > dateEnd:
                continue
            yield self._mapping(f)
