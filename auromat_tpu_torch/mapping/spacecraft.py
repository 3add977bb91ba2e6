"""Spacecraft (ISS DSLR) mapping provider: image files + .wcs solutions.

Counterpart of ``auromat_tpu.mapping.spacecraft``: pairs image files with
astrometric ``.wcs`` headers, resolves the camera position from the
header cards (time-shift-corrected position preferred, then the plain
position), and yields Mappings georeferenced on the provider's device.

The reference's NuMap process-parallel sequence pipeline
(spacecraft.py:308-377) becomes bursts:
:meth:`SpacecraftMappingProvider.getSequenceBatched` /
:func:`get_mapping_batch` stack a burst's calibration into one
DynGeorefParams and georeference its frames in float32 on the device;
:meth:`SpacecraftMappingProvider.iterParamBursts` feeds calibration and
imagery straight to :func:`auromat_tpu_torch.parallel.mosaic_sequence`.
The per-frame ``get``/``getSequence`` path keeps float64.

Not ported yet: the TLE fallback of the camera position (it needs
``coordinates.ephem``). Reading an image needs PIL.
"""

import os
from datetime import datetime, timedelta

import numpy as np
import numpy.ma as ma
import torch

from auromat_tpu_torch.coordinates.frames import FrameMatrices
from auromat_tpu_torch.coordinates.wcs import TanWcs
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.io.image import load_image
from auromat_tpu_torch.mapping.astrometry import (AstrometryMapping,
                                                  create_mapping)
from auromat_tpu_torch.mapping.mapping import BaseMappingProvider
from auromat_tpu_torch.ops.georef import (DynGeorefParams, GeorefParams,
                                          compute_device, georeference_dyn)

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".tif", ".tiff")


def resolve_camera_position(header, tle_path=None, spacetrack=None):
    """Camera GCRS position (km) and photo time from a .wcs header.

    Order (reference spacecraft.py:428-485): shifted position cards ->
    plain position cards -> TLE propagation at DATE-OBS (not ported yet).

    :returns: (position (3,), photo_time, shift_seconds)
    """
    photo_time = fits.get_photo_time(header)
    shifted = fits.get_shifted_spacecraft_position(header)
    if shifted is not None:
        x, y, z, shift = shifted
        return np.array([x, y, z]), photo_time + timedelta(seconds=shift), shift
    pos = fits.get_spacecraft_position(header)
    if pos is not None:
        return np.asarray(pos, dtype=np.float64), photo_time, 0.0
    norad_id = fits.get_norad_id(header)
    if tle_path is not None and norad_id is not None and photo_time is not None:
        raise NotImplementedError(
            "the camera position from a TLE needs coordinates.ephem, which "
            "is not ported yet")
    raise ValueError(
        "no spacecraft position in header and no TLE fallback available"
    )


def get_mapping(image_path, wcs_path, altitude=110.0, identifier=None,
                fast_center=False, tle_path=None, metadata=None, dtype=None,
                device="cuda"):
    """Georeference one image + .wcs pair on ``device`` (the card by
    default; reference spacecraft.py:380-426). Reading the image needs
    PIL."""
    device = compute_device(device)
    header = fits.read_header(wcs_path)
    pos, photo_time, _ = resolve_camera_position(header, tle_path)
    img = load_image(image_path)
    if identifier is None:
        identifier = os.path.splitext(os.path.basename(image_path))[0]
    return create_mapping(
        header, img, pos, photo_time, altitude=altitude, identifier=identifier,
        metadata=metadata, fast_center=fast_center,
        dtype=dtype or torch.float64, device=device,
    )


class SpacecraftMappingProvider(BaseMappingProvider):
    """Provider over a directory of images and a directory of .wcs files.

    Frames are matched by basename and ordered by (shifted) photo time.
    Reference: auromat/mapping/spacecraft.py:40-146.

    :param dtype: torch dtype of the per-frame chain (None: float64)
    :param device: where frames are georeferenced (the card by default;
        pass ``device="cpu"`` for the CPU)
    """

    def __init__(self, image_dir, wcs_dir=None, tle_path=None, altitude=110.0,
                 fast_center=False, maxTimeOffset=3, dtype=None,
                 device="cuda"):
        super().__init__(maxTimeOffset)
        self.image_dir = image_dir
        self.wcs_dir = wcs_dir or image_dir
        self.tle_path = tle_path
        self.altitude = altitude
        self.fast_center = fast_center
        self.dtype = dtype
        self.device = compute_device(device)
        self._index = None

    def _build_index(self):
        if self._index is not None:
            return self._index
        wcs_files = {
            os.path.splitext(f)[0]: os.path.join(self.wcs_dir, f)
            for f in os.listdir(self.wcs_dir)
            if f.lower().endswith(".wcs")
        }
        entries = []
        for f in sorted(os.listdir(self.image_dir)):
            base, ext = os.path.splitext(f)
            if ext.lower() not in IMAGE_EXTENSIONS or base not in wcs_files:
                continue
            wcs_path = wcs_files[base]
            header = fits.read_header(wcs_path)
            try:
                _, photo_time, _ = resolve_camera_position(header, self.tle_path)
            except (ValueError, NotImplementedError):
                photo_time = fits.get_photo_time(header)
            entries.append(
                {"id": base, "image": os.path.join(self.image_dir, f),
                 "wcs": wcs_path, "time": photo_time,
                 "shape": (header.get("IMAGEW"), header.get("IMAGEH"))}
            )
        entries.sort(key=lambda e: (e["time"] is None,
                                    e["time"] or datetime.min, e["id"]))
        self._index = entries
        return entries

    @property
    def range(self):
        idx = self._build_index()
        if not idx:
            raise ValueError("no image/wcs pairs found")
        return idx[0]["time"], idx[-1]["time"]

    def timeRange(self, dateBegin=None, dateEnd=None):
        """(first, last) photo times of the frames a dateBegin/dateEnd-
        filtered sequence (getSequence, getSequenceBatched, iterParamBursts:
        one shared filter) includes; (None, None) if nothing timed is in
        range. Unlike :attr:`range` this respects the query window, so a
        sequence product (``convert --mosaic``) is never stamped with the
        time of an excluded frame."""
        times = [e["time"]
                 for chunk in self._iter_entry_chunks(dateBegin, dateEnd, 1)
                 for e in chunk if e["time"] is not None]
        if not times:
            return None, None
        return times[0], times[-1]

    def contains(self, date):
        return any(
            e["time"] is not None
            and abs((e["time"] - date).total_seconds()) <= self.maxTimeOffset
            for e in self._build_index()
        )

    def _load(self, entry):
        return get_mapping(
            entry["image"], entry["wcs"], altitude=self.altitude,
            identifier=entry["id"], fast_center=self.fast_center,
            tle_path=self.tle_path, dtype=self.dtype, device=self.device,
        )

    def get(self, date):
        candidates = [e for e in self._build_index() if e["time"] is not None]
        if not candidates:
            raise ValueError("no dated mappings available")
        best = min(candidates,
                   key=lambda e: abs((e["time"] - date).total_seconds()))
        if abs((best["time"] - date).total_seconds()) > self.maxTimeOffset:
            raise ValueError(f"no mapping within maxTimeOffset of {date}")
        return self._load(best)

    def getById(self, identifier):
        for e in self._build_index():
            if e["id"] == identifier:
                return self._load(e)
        raise ValueError(f"no mapping with identifier {identifier!r}")

    def getSequence(self, dateBegin=None, dateEnd=None):
        for chunk in self._iter_entry_chunks(dateBegin, dateEnd, 1):
            yield self._load(chunk[0])

    def getSequenceBatched(self, dateBegin=None, dateEnd=None, batch=4,
                           with_mlatmlt=True):
        """The sequence in bursts of ``batch`` same-shaped frames, each
        georeferenced in float32 on the provider's device (use
        :meth:`getSequence` for float64). A shape change mid-sequence
        closes the current burst."""
        for chunk in self._iter_entry_chunks(dateBegin, dateEnd, batch):
            yield from get_mapping_batch(
                [(e["image"], e["wcs"]) for e in chunk],
                altitude=self.altitude, tle_path=self.tle_path,
                identifiers=[e["id"] for e in chunk],
                with_mlatmlt=with_mlatmlt, fast_center=self.fast_center,
                device=self.device)

    def _iter_entry_chunks(self, dateBegin, dateEnd, batch):
        """Date-filter the index and yield same-shaped entry chunks of at
        most ``batch`` frames: the burst-splitting rule shared by
        :meth:`getSequenceBatched` and :meth:`iterParamBursts` (a shape
        change mid-sequence closes the current burst)."""
        entries = [e for e in self._build_index()
                   if not (dateBegin is not None and (e["time"] is None
                                                      or e["time"] < dateBegin))
                   and not (dateEnd is not None and (e["time"] is None
                                                     or e["time"] > dateEnd))]
        chunk = []
        for e in entries:
            if chunk and e.get("shape") != chunk[-1].get("shape"):
                yield chunk
                chunk = []
            chunk.append(e)
            if len(chunk) == batch:
                yield chunk
                chunk = []
        if chunk:
            yield chunk

    def iterParamBursts(self, dateBegin=None, dateEnd=None, batch=8):
        """Yield (params_list, imgs) bursts for
        :func:`auromat_tpu_torch.parallel.mosaic_sequence`: calibration and
        uint8 imagery (B, h, w, 3) only, no per-pixel host arrays (the
        georeference runs inside the mosaic step). Same date filtering and
        burst splitting as :meth:`getSequenceBatched`.
        """
        for chunk in self._iter_entry_chunks(dateBegin, dateEnd, batch):
            params, imgs = [], []
            for e in chunk:
                img, p = _load_frame_calibration(
                    e["image"], e["wcs"], self.altitude, self.tle_path)
                img = np.asarray(img)
                # K1's contract is integer-valued 0..255 imagery; a uint16
                # source would wrap or clamp downstream, so refuse it here
                if img.dtype != np.uint8:
                    raise ValueError(
                        f"{e['image']}: mosaic bursts need uint8 imagery "
                        f"(got {img.dtype}); the device binning kernels "
                        "are specified for integer 0..255 values — "
                        "rescale the source images first")
                params.append(p)
                imgs.append(img)
            yield params, np.stack(imgs)


def _load_frame_calibration(image_path, wcs_path, altitude=110.0,
                            tle_path=None, full=False):
    """Load one frame's imagery + device calibration (no per-pixel work).

    :returns: (img, GeorefParams) — or with ``full=True`` additionally
        (header, photo_time, camera_pos, FrameMatrices) for callers that
        construct Mapping objects.
    """
    header = fits.read_header(wcs_path)
    pos, photo_time, _ = resolve_camera_position(header, tle_path)
    img = load_image(image_path)
    fm = FrameMatrices(photo_time)
    p = GeorefParams.from_wcs(TanWcs(header), pos, photo_time, altitude, fm)
    if (img.shape[1], img.shape[0]) != (p.width, p.height):
        raise ValueError(f"{image_path} is {img.shape[1]}x{img.shape[0]}, "
                         f"its WCS solution {p.width}x{p.height}")
    if full:
        return img, p, header, photo_time, pos, fm
    return img, p


def get_mapping_batch(image_wcs_pairs, altitude=110.0, tle_path=None,
                      identifiers=None, with_mlatmlt=True, fast_center=True,
                      device="cuda"):
    """Georeference a burst of same-shaped frames on ``device`` (the card
    by default).

    The burst's calibration stacks into one DynGeorefParams (one transfer)
    and each frame runs the full georeference chain in float32 (adequate
    for binned products; use :func:`get_mapping` for float64).

    :param image_wcs_pairs: [(image_path, wcs_path), ...] — all frames must
        share the image shape
    :returns: list of AstrometryMapping
    """
    device = compute_device(device)
    loaded = [_load_frame_calibration(image_path, wcs_path, altitude,
                                      tle_path, full=True)
              for image_path, wcs_path in image_wcs_pairs]
    shapes = {(p.width, p.height) for _, p, *_ in loaded}
    if len(shapes) != 1:
        raise ValueError(f"a batch must share one frame shape, got {shapes}")
    w, h = shapes.pop()
    dyn = DynGeorefParams.stack([p for _, p, *_ in loaded],
                                dtype=torch.float32, device=device)

    mappings = []
    for i, ((image_path, _), (img, _, header, photo_time, pos, fm)) in \
            enumerate(zip(image_wcs_pairs, loaded)):
        out = georeference_dyn(dyn.frame(i), w, h, fast_center=fast_center,
                               with_mlatmlt=with_mlatmlt, dtype=torch.float32)
        get = lambda k: out[k].to(device="cpu", dtype=torch.float64).numpy()
        ident = (identifiers[i] if identifiers
                 else os.path.splitext(os.path.basename(image_path))[0])
        m = AstrometryMapping(
            get("lats"), get("lons"), get("lats_center"), get("lons_center"),
            get("elevation"), altitude, img, pos, photo_time, ident,
            sanitized=fast_center, frame_matrices=fm,
        )
        m.wcs_header = header
        if with_mlatmlt:
            def masked(key, mask):
                a = get(key)
                a[mask] = np.nan
                return ma.masked_invalid(a, copy=False)

            cm, ccm = m.corner_mask, m.center_mask
            m._mlatmlt = (masked("mlat", cm), masked("mlt", cm))
            m._mlatmlt_center = (masked("mlat_center", ccm),
                                 masked("mlt_center", ccm))
        mappings.append(m)
    return mappings
