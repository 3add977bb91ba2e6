"""THEMIS ground all-sky imager (ASI) provider.

Counterpart of ``auromat_tpu.mapping.themis`` (reference
auromat/mapping/themis.py): the 24-station network, L1 (image frames) and
L2 (calibration: per-pixel az/el and corner lat/lon at 3 reference
altitudes) CDFs, download caching with .404 tombstones, altitude
reprojection by re-intersecting reconstructed rays, IDL-bytscl display
scaling and a forced 1-degree elevation pre-mask.

CDFs are read with the port's pure-python :mod:`auromat_tpu_torch.io.cdflib`.
The altitude reprojection of all stations is ONE batched float64 torch call
on ``device`` over the station axis (:func:`reproject_batch`); the JAX
package's host pinning (``host_f64_device``) is a TPU workaround that an
H100, which has float64, does not need.
"""

import functools
import os
from datetime import datetime, timedelta

import numpy as np
import numpy.ma as ma
import torch

from auromat_tpu_torch.constants import WGS84_A, WGS84_B
from auromat_tpu_torch.coordinates.frames import FrameMatrices
from auromat_tpu_torch.coordinates.intersection import \
    ellipsoid_line_intersection
from auromat_tpu_torch.coordinates.transform import (ecef_to_geodetic,
                                                     geodetic_to_ecef,
                                                     geodetic_to_ecef_zero,
                                                     station_ecef)
from auromat_tpu_torch.io import cdflib
from auromat_tpu_torch.mapping.mapping import (BaseMappingProvider, Mapping,
                                               MappingCollection)
from auromat_tpu_torch.ops.georef import compute_device
from auromat_tpu_torch.util.osutil import touch
from auromat_tpu_torch.util.url import download_file
from auromat_tpu_torch.utils import find_nearest

STATIONS = [
    "atha", "chbg", "ekat", "fsim", "fsmi", "fykn",
    "gako", "gbay", "gill", "inuv", "kapu", "kian",
    "kuuj", "mcgr", "nrsq", "pgeo", "pina", "rank",
    "snap", "snkq", "talo", "tpas", "whit", "yknf",
]

L1_BASE_URL = "http://themis.ssl.berkeley.edu/data/themis/thg/l1/asi/"
L2_BASE_URL = "http://themis.ssl.berkeley.edu/data/themis/thg/l2/asi/cal/"
L1_FILENAME = "thg_l1_asf_{station}_{date}_v01.cdf"
L2_FILENAME = "thg_l2_asc_{station}_19700101_v01.cdf"

# The L2 'offset' is 2500 for every pixel of every station and the
# multipliers are 1.0 (reference themis.py:438-442): subtract the scalar.
L1_COUNT_OFFSET = 2500


def bytscl(array, max_=None, min_=None, top=255):
    """IDL BYTSCL (float formula), used for THEMIS display scaling."""
    if max_ is None:
        max_ = np.nanmax(array)
    if min_ is None:
        min_ = np.nanmin(array)
    # clamp before the integer cast: a saturated pixel far above max_ would
    # overflow int16 and wrap negative; IDL BYTSCL clamps to top
    scaled = (top + 0.9999) * (array - min_) / (max_ - min_)
    return np.clip(scaled, 0, top).astype(np.int16)


class ThemisMapping(Mapping):
    """Grayscale uint16 ASI mapping with median-normalised RGB display."""

    def __init__(self, *args, minBrightness=None, maxBrightness=None, **kw):
        super().__init__(*args, **kw)
        self.minBrightness = minBrightness
        self.maxBrightness = maxBrightness

    def _brightness_scaled(self, img):
        img = np.asarray(img, dtype=np.float64)
        if self.minBrightness is not None or self.maxBrightness is not None:
            return bytscl(img, min_=self.minBrightness,
                          max_=self.maxBrightness)
        med = np.median(img[img > 1]) if np.any(img > 1) else 1.0
        return np.minimum(img / med * 64, 255)

    @property
    def rgb_unmasked(self):
        scaled = self._brightness_scaled(self._img[:, :, 0])
        return np.repeat(scaled[:, :, None], 3, 2).astype(np.uint8)

    @property
    def rgb(self):
        mask = np.repeat(self.center_mask[:, :, None], 3, 2)
        return ma.masked_array(self.rgb_unmasked, mask=mask)

    def createResampled(self, lats, lons, lats_center, lons_center,
                        elevation, img):
        return ThemisMapping(
            lats, lons, lats_center, lons_center, elevation, self.altitude,
            img, self.cameraPosGCRS, self.photoTime, self.identifier,
            metadata=self.metadata, minBrightness=self.minBrightness,
            maxBrightness=self.maxBrightness,
        )


def reproject(lat_lon_asi, lats_ref, lons_ref, height_ref, height_new,
              device="cuda"):
    """Reproject one station's calibration grid to another emission
    altitude: rebuild the per-pixel rays from the station through the
    reference-height grid and re-intersect the inflated ellipsoid at the
    new height (reference themis.py:224-253). :func:`reproject_batch` with
    one station, float64 on ``device``.

    :returns: (lats, lons) degrees, host float64
    """
    lats, lons = reproject_batch(
        np.asarray(lat_lon_asi, dtype=np.float64)[None],
        np.asarray(lats_ref)[None], np.asarray(lons_ref)[None],
        height_ref, height_new, device=device)
    return lats[0], lons[0]


def reproject_batch(lat_lon_asi, lats_ref, lons_ref, height_ref, height_new,
                    device="cuda"):
    """All-station altitude reprojection in one batched float64 call on
    ``device`` (the reference loops its ASIs serially, themis.py:465-473
    and 224-253): stations are the leading axis of every tensor, each
    station's origin broadcasts over its grid.

    :param lat_lon_asi: (S, 2) station geodetic lat/lon degrees
    :param lats_ref, lons_ref: (S, h, w) calibration grids, degrees
    :param height_ref: scalar or (S,) reference altitude km
    :param height_new: target altitude km
    :param device: the card by default; ``device="cpu"`` for the CPU
    :returns: (lats (S, h, w), lons (S, h, w)) degrees, host float64
    """
    device = compute_device(device)
    f64 = torch.float64
    to = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   device=device)
    ll = to(lat_lon_asi)
    h_ref = torch.broadcast_to(to(height_ref), ll.shape[:1])
    ox, oy, oz = geodetic_to_ecef_zero(torch.deg2rad(ll[:, 0]),
                                       torch.deg2rad(ll[:, 1]))
    origin = torch.stack([ox, oy, oz], dim=-1)[:, None, None, :]
    x, y, z = geodetic_to_ecef(torch.deg2rad(to(lats_ref)),
                               torch.deg2rad(to(lons_ref)),
                               h_ref[:, None, None])
    dirs = torch.stack([x, y, z], dim=-1) - origin
    h_new = float(height_new)
    inter = ellipsoid_line_intersection(WGS84_A + h_new, WGS84_B + h_new,
                                        origin, dirs)
    lat, lon = ecef_to_geodetic(inter[..., 0], inter[..., 1], inter[..., 2])
    out = torch.stack([torch.rad2deg(lat), torch.rad2deg(lon)]).to(
        device="cpu", dtype=f64).numpy()
    return out[0], out[1]


# ---------------------------------------------------------------------------
# L1/L2 cache handling
# ---------------------------------------------------------------------------


def l1_filename(station, date):
    return L1_FILENAME.format(station=station, date=date.strftime("%Y%m%d%H"))


def has_l2_data(l2_folder, station):
    return os.path.exists(os.path.join(l2_folder,
                                       L2_FILENAME.format(station=station)))


def download_l2_data(l2_folder, station):
    if has_l2_data(l2_folder, station):
        return
    filename = L2_FILENAME.format(station=station)
    download_file(L2_BASE_URL + filename, os.path.join(l2_folder, filename))


def has_l1_data(l1_folder, station, date, retry_404_after=timedelta(days=30)):
    path = os.path.join(l1_folder, l1_filename(station, date))
    if os.path.exists(path):
        return True
    path404 = path + ".404"
    if os.path.exists(path404):
        mtime = datetime.fromtimestamp(os.path.getmtime(path404))
        if datetime.now() - mtime > retry_404_after:
            os.remove(path404)
        else:
            return "404"
    return False


def download_l1_data(l1_folder, station, date):
    status = has_l1_data(l1_folder, station, date)
    if status is True:
        return True
    if status == "404":
        return False
    filename = l1_filename(station, date)
    path = os.path.join(l1_folder, filename)
    url = (L1_BASE_URL
           + f"{station}/{date.strftime('%Y')}/{date.strftime('%m')}/"
           + filename)
    import urllib.error

    try:
        download_file(url, path, unify_errors=False)
    except urllib.error.HTTPError as e:
        if e.code == 404:
            touch(path + ".404")
        return False
    except Exception:
        return False
    return True


@functools.lru_cache(maxsize=64)
def _read_cdf_cached(path, mtime):
    return cdflib.CDFReader(path)


def _read_cdf(path):
    """Parse a CDF, cached by (path, mtime): a sequence would otherwise
    re-parse the same calibration and hour files on every frame tick."""
    return _read_cdf_cached(path, os.path.getmtime(path))


def get_l2_data(l2_folder, station):
    """:returns: ((lat, lon) station, az, el, lats_ref (3, 257, 257),
    lons_ref, heights_ref (km))"""
    path = os.path.join(l2_folder, L2_FILENAME.format(station=station))
    cdf = _read_cdf(path)
    lat_asi = float(np.asarray(cdf[f"thg_asc_{station}_glat"].data).ravel()[0])
    lon_asi = float(np.asarray(cdf[f"thg_asc_{station}_glon"].data).ravel()[0])
    az = np.asarray(cdf[f"thg_asf_{station}_azim"][0])
    el = np.asarray(cdf[f"thg_asf_{station}_elev"][0])
    lats_ref = np.asarray(cdf[f"thg_asf_{station}_glat"][0])
    lons_ref = np.asarray(cdf[f"thg_asf_{station}_glon"][0])
    heights = np.asarray(cdf[f"thg_asf_{station}_alti"].data).ravel()
    # (257, 257, 3) -> (3, 257, 257)
    lats_ref = np.moveaxis(lats_ref, 2, 0)
    lons_ref = np.moveaxis(lons_ref, 2, 0)
    return (lat_asi, lon_asi), az, el, lats_ref, lons_ref, heights / 1000.0


def _epoch_times(cdf, station):
    epoch_var = cdf[f"thg_asf_{station}_epoch"]
    if epoch_var.cdf_type == cdflib.CDF_TIME_TT2000:
        return [cdflib.tt2000_to_datetime(int(v)) for v in epoch_var.data]
    return [cdflib.epoch_to_datetime(float(v)) for v in epoch_var.data]


def l1_times(l1_folder, station, date):
    """All frame timestamps in the hour-file covering ``date`` (empty when
    the file is absent)."""
    path = os.path.join(l1_folder, l1_filename(station, date))
    if not os.path.exists(path):
        return []
    return _epoch_times(_read_cdf(path), station)


def get_l1_data(l1_folder, station, date, maxTimeOffset=2):
    """The image nearest to ``date``, and its time (or (None, None))."""
    cdf = _read_cdf(os.path.join(l1_folder, l1_filename(station, date)))
    times = _epoch_times(cdf, station)
    idx = find_nearest([t.timestamp() for t in times], date.timestamp())
    if abs((times[idx] - date).total_seconds()) > maxTimeOffset:
        return None, None
    return np.asarray(cdf[f"thg_asf_{station}"][idx]), times[idx]


def _station_inputs(station, date, l1_folder, l2_folder, maxTimeOffset=2,
                    offline=False):
    """IO phase: the nearest cached L1 frame and the L2 calibration, or
    None."""
    if offline and has_l1_data(l1_folder, station, date) is False:
        raise RuntimeError("offline=True but L1 data not cached yet")
    if not offline and not download_l1_data(l1_folder, station, date):
        return None
    if offline and not os.path.exists(
            os.path.join(l1_folder, l1_filename(station, date))):
        return None
    img, img_date = get_l1_data(l1_folder, station, date, maxTimeOffset)
    if img is None:
        return None
    if not offline:
        download_l2_data(l2_folder, station)
    return img, img_date, get_l2_data(l2_folder, station)


def _ref_altitude_index(heights_ref, altitude):
    """Index of ``altitude`` among the calibration's reference altitudes,
    or None (the ray reprojection is needed)."""
    if altitude * 1000 in heights_ref * 1000:
        return int(np.where(np.isclose(heights_ref, altitude))[0][0])
    return None


def _build_mapping(station, img, img_date, lat_lon_asi, el, lats, lons,
                   altitude, minBrightness=None, maxBrightness=None):
    """The pre-masked ThemisMapping from resolved corner grids."""
    # THEMIS grids do not span the discontinuity: centres as corner means
    lats_c = (lats[:-1, :-1] + lats[1:, :-1] + lats[:-1, 1:]
              + lats[1:, 1:]) / 4
    lons_c = (lons[:-1, :-1] + lons[1:, :-1] + lons[:-1, 1:]
              + lons[1:, 1:]) / 4

    img = img.astype(np.int32) - L1_COUNT_OFFSET
    img = np.clip(img, 0, np.iinfo(np.uint16).max).astype(np.uint16)

    fm = FrameMatrices(img_date)
    cam_gcrs = fm.geo_to_j2000 @ station_ecef(*lat_lon_asi)

    identifier = station + "." + img_date.strftime("%Y.%m.%d.%H.%M.%S")
    mapping = ThemisMapping(
        lats, lons, lats_c, lons_c, np.asarray(el, dtype=np.float64),
        altitude, img, cam_gcrs, img_date, identifier,
        minBrightness=minBrightness, maxBrightness=maxBrightness,
        frame_matrices=fm,
    )
    # L2 data is partly wrong at very low elevations: pre-mask at 1 degree
    # (reference themis.py:450-453)
    return mapping.maskedByElevation(1)


def mapping_single_asi(station, date, l1_folder, l2_folder, maxTimeOffset=2,
                       altitude=110, minBrightness=None, maxBrightness=None,
                       offline=False, device="cuda"):
    """One station's mapping at ``date`` (None without data); a
    non-reference ``altitude`` is reprojected on ``device``."""
    device = compute_device(device)
    inputs = _station_inputs(station, date, l1_folder, l2_folder,
                             maxTimeOffset, offline)
    if inputs is None:
        return None
    img, img_date, l2 = inputs
    lat_lon_asi, _, el, lats_ref, lons_ref, heights_ref = l2

    ref_idx = _ref_altitude_index(heights_ref, altitude)
    if ref_idx is not None:
        lats, lons = lats_ref[ref_idx], lons_ref[ref_idx]
    else:
        lats, lons = reproject(lat_lon_asi, lats_ref[0], lons_ref[0],
                               heights_ref[0], altitude, device=device)
    return _build_mapping(station, img, img_date, lat_lon_asi, el, lats, lons,
                          altitude, minBrightness, maxBrightness)


def get_mappings(photo_time, l1_folder, l2_folder, altitude=110,
                 maxTimeOffset=2, minBrightness=None, maxBrightness=None,
                 offline=False, stations=None, device="cuda"):
    """MappingCollection over all stations with data near ``photo_time``.

    IO runs per station (cache and tombstone handling); the altitude
    reprojection — the only per-pixel math — runs for ALL stations that
    need it in one batched call on ``device`` per calibration grid shape
    (:func:`reproject_batch`; the reference's serial per-station loop is
    themis.py:465-473).
    """
    device = compute_device(device)
    rows = []  # (station, img, img_date, l2, lats-or-None, lons-or-None)
    pending = []  # indices into rows that need the batched reprojection
    for station in stations or STATIONS:
        try:
            inputs = _station_inputs(station, photo_time, l1_folder,
                                     l2_folder, maxTimeOffset, offline)
        except (FileNotFoundError, RuntimeError):
            inputs = None
        if inputs is None:
            continue
        img, img_date, l2 = inputs
        _, _, _, lats_ref, lons_ref, heights_ref = l2
        ref_idx = _ref_altitude_index(heights_ref, altitude)
        if ref_idx is not None:
            rows.append((station, img, img_date, l2,
                         lats_ref[ref_idx], lons_ref[ref_idx]))
        else:
            pending.append(len(rows))
            rows.append((station, img, img_date, l2, None, None))
    if pending:
        # one call per grid shape: a deployment's grids usually share one,
        # but a station with another calibration resolution must not break
        # the collection
        by_shape = {}
        for i in pending:
            by_shape.setdefault(rows[i][3][3][0].shape, []).append(i)
        for idx in by_shape.values():
            l2s = [rows[i][3] for i in idx]
            lats_b, lons_b = reproject_batch(
                np.array([l2[0] for l2 in l2s], dtype=np.float64),
                np.stack([l2[3][0] for l2 in l2s]),
                np.stack([l2[4][0] for l2 in l2s]),
                np.array([l2[5][0] for l2 in l2s], dtype=np.float64),
                altitude, device=device)
            for k, i in enumerate(idx):
                rows[i] = rows[i][:4] + (lats_b[k], lons_b[k])
    mappings = [
        _build_mapping(st, img, d, l2[0], l2[2], lats, lons, altitude,
                       minBrightness, maxBrightness)
        for st, img, d, l2, lats, lons in rows
    ]
    identifier = "THEMIS." + photo_time.strftime("%Y.%m.%d.%H.%M.%S")
    return MappingCollection(mappings, identifier, mayOverlap=True)


class ThemisMappingProvider(BaseMappingProvider):
    """Provider over L1/L2 cache folders (reference themis.py:36-108).

    :param device: where the altitude reprojection runs (the card by
        default; ``device="cpu"`` for the CPU)
    """

    def __init__(self, cdfL1CacheFolder, cdfL2CacheFolder, altitude=110,
                 minBrightness=None, maxBrightness=None, offline=False,
                 stations=None, device="cuda"):
        super().__init__(maxTimeOffset=2)
        self.device = compute_device(device)
        self.offline = offline
        if not offline:
            os.makedirs(cdfL1CacheFolder, exist_ok=True)
            os.makedirs(cdfL2CacheFolder, exist_ok=True)
        self.l1_folder = cdfL1CacheFolder
        self.l2_folder = cdfL2CacheFolder
        self.altitude = altitude
        self.minBrightness = minBrightness
        self.maxBrightness = maxBrightness
        self.stations = stations or STATIONS

    @property
    def range(self):
        raise NotImplementedError("THEMIS archive range is unbounded")

    def contains(self, date):
        for station in self.stations:
            try:
                img, _ = get_l1_data(self.l1_folder, station, date,
                                     self.maxTimeOffset)
                if img is not None:
                    return True
            except FileNotFoundError:
                continue
        return False

    def download(self, dateBegin, dateEnd):
        """Cache all L1 hours and L2 calibrations in the interval."""
        if not (dateBegin and dateEnd):
            raise ValueError("start and end dates must be given")
        if dateBegin > dateEnd:
            raise ValueError("start date must be earlier than end date")
        begin = datetime(*dateBegin.timetuple()[:4])
        end = datetime(*dateEnd.timetuple()[:4])
        hours = int((end - begin).total_seconds()) // 3600
        dates = [begin + timedelta(hours=h) for h in range(hours + 1)]
        for station in self.stations:
            if self.offline:
                if not has_l2_data(self.l2_folder, station):
                    raise RuntimeError(
                        "offline=True but L2 data not cached yet")
            else:
                download_l2_data(self.l2_folder, station)
            for date in dates:
                if self.offline:
                    if has_l1_data(self.l1_folder, station, date) is False:
                        raise RuntimeError(
                            "offline=True but L1 data not cached yet")
                else:
                    download_l1_data(self.l1_folder, station, date)

    def get(self, date):
        mappings = get_mappings(
            date, self.l1_folder, self.l2_folder, self.altitude,
            self.maxTimeOffset, self.minBrightness, self.maxBrightness,
            offline=self.offline, stations=self.stations, device=self.device,
        )
        if mappings.empty:
            raise ValueError(
                f"No THEMIS mappings found at {date} +- {self.maxTimeOffset}s")
        return mappings

    def getById(self, identifier):
        station, rest = identifier.split(".", 1)
        date = datetime.strptime(rest, "%Y.%m.%d.%H.%M.%S")
        m = mapping_single_asi(
            station, date, self.l1_folder, self.l2_folder,
            maxTimeOffset=self.maxTimeOffset, altitude=self.altitude,
            minBrightness=self.minBrightness,
            maxBrightness=self.maxBrightness, offline=self.offline,
            device=self.device,
        )
        if m is None:
            raise ValueError(f"no mapping with identifier {identifier!r}")
        return m

    def availableTimes(self, dateBegin, dateEnd):
        """Sorted union of cached frame timestamps in the interval, with
        cross-station ticks within maxTimeOffset merged into one."""
        times = set()
        begin_hour = datetime(*dateBegin.timetuple()[:4])
        n_hours = int((dateEnd - begin_hour).total_seconds()) // 3600
        for station in self.stations:
            for hh in range(n_hours + 1):
                hour = begin_hour + timedelta(hours=hh)
                for t in l1_times(self.l1_folder, station, hour):
                    if dateBegin <= t <= dateEnd:
                        times.add(t)
        merged = []
        for t in sorted(times):
            if merged and \
                    (t - merged[-1]).total_seconds() <= self.maxTimeOffset:
                continue
            merged.append(t)
        return merged

    def getSequence(self, dateBegin=None, dateEnd=None):
        """Yield one MappingCollection (all stations) per cached frame tick
        (the reference raises NotImplementedError, themis.py:107-108; the
        cached L1 hour files carry every frame's time). Needs both dates:
        the archive is unbounded."""
        if dateBegin is None or dateEnd is None:
            raise ValueError("THEMIS sequences need explicit begin/end dates")
        for t in self.availableTimes(dateBegin, dateEnd):
            try:
                yield self.get(t)
            except ValueError:
                continue


def mask_by_l2(mask, img):
    """Mask image pixels flagged by the L2 mask (NaN where mask == 1).

    .. warning:: as the reference warns (themis.py:255-269), the published
        L2 masks hold inconsistent data (0/1 mixed up in at least one
        case): prefer elevation masking.
    """
    img = np.asarray(img).astype(np.float32)  # astype always copies
    img[np.asarray(mask) == 1] = np.nan
    return img
