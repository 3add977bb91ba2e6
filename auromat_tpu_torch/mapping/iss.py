"""ESA ISS Auroral Photography archive provider.

Counterpart of ``auromat_tpu.mapping.iss`` (reference
auromat/mapping/iss.py): REST client for the georef_seqs API (api.json +
metadata.json + per-frame image/WCS downloads into a cache folder), the RAW
postprocessing pipeline (demosaic + bad-pixel repair via rawpy, 180-degree
flip, the archive's lens distortion model corrected on the provider's
device, crop to a multiple of 16 to match the archive WCS), and an offline
mode. Frames are georeferenced on the provider's device (the card by
default).

rawpy is imported where a RAW frame is decoded; without it the provider
uses the archive JPEGs, which need PIL. An image array that is already
decoded takes :meth:`ISSMappingProvider._postprocess_common` and
:meth:`ISSMappingProvider._array_mapping`, which need neither.
"""

import glob
import importlib.util
import json
import os
from collections import OrderedDict
from datetime import datetime

import numpy as np

from auromat_tpu_torch.io import fits
from auromat_tpu_torch.io.image import cropped_image, save_image
from auromat_tpu_torch.mapping.astrometry import create_mapping
from auromat_tpu_torch.mapping.mapping import BaseMappingProvider
from auromat_tpu_torch.mapping.spacecraft import (get_mapping,
                                                  resolve_camera_position)
from auromat_tpu_torch.ops.georef import compute_device
from auromat_tpu_torch.timeutil import naive_epoch
from auromat_tpu_torch.util.lensdistortion import correct_lens_distortion
from auromat_tpu_torch.util.url import download_file
from auromat_tpu_torch.utils import find_nearest

DEFAULT_BASE_URL = "https://arrrgh-tools.cosmos.esa.int/api/georef_seqs/"
ISO_DATE_FORMAT = "%Y-%m-%dT%H:%M:%S.%f"


def _parse_dates(dic):
    for k in {"date", "date_start", "date_end"} & set(dic.keys()):
        if isinstance(dic[k], str):
            dic[k] = datetime.strptime(dic[k], ISO_DATE_FORMAT)
    return dic


def has_rawpy():
    """Whether the RAW decoder can be imported (without importing it)."""
    return importlib.util.find_spec("rawpy") is not None


class ISSMappingProvider(BaseMappingProvider):
    """Provider for ESA's ISS auroral photography mapping sequences.

    :param device: where frames are undistorted and georeferenced (the
        card by default; pass ``device="cpu"`` for the CPU)
    """

    def __init__(self, cacheFolder, id_=None, useRaw=True, altitude=110,
                 fastCenterCalculation=False, maxTimeOffset=3,
                 raw_white_balance=None, raw_gamma=(1, 1), raw_bps=16,
                 raw_auto_bright=False, noRawPostprocessCaching=True,
                 baseUrl=DEFAULT_BASE_URL, offline=False, device="cuda"):
        super().__init__(maxTimeOffset=maxTimeOffset)
        self.device = compute_device(device)
        os.makedirs(cacheFolder, exist_ok=True)
        self.cacheFolder = cacheFolder
        self.offline = offline
        self.noRawPostprocessCaching = noRawPostprocessCaching

        self.apiDataPath = os.path.join(cacheFolder, "api.json")
        if not os.path.exists(self.apiDataPath):
            if offline:
                raise RuntimeError("offline=True and api.json not cached")
            if not id_:
                raise ValueError("the id_ parameter must be given the first time")
            download_file(baseUrl + str(id_), self.apiDataPath)
        with open(self.apiDataPath) as f:
            self.apiData = json.load(f, object_hook=_parse_dates)

        self.metadataPath = os.path.join(cacheFolder, "metadata.json")
        if not os.path.exists(self.metadataPath):
            if offline:
                raise RuntimeError("offline=True and metadata.json not cached")
            download_file(self.apiData["metadata_uri"], self.metadataPath)
        with open(self.metadataPath) as f:
            self.metadata = json.load(f, object_hook=_parse_dates)

        self.apiImages = OrderedDict(
            sorted(self.apiData["images"].items(), key=lambda kv: kv[1]["date"])
        )
        self.useRaw = useRaw and has_rawpy() and "raw_extension" in self.apiData
        self.altitude = altitude
        self.fastCenterCalculation = fastCenterCalculation
        self.processedImagePaths = {}
        self.rawImagePaths = {}
        self.wcsPaths = {}
        if self.useRaw:
            self.raw_white_balance = raw_white_balance
            self.raw_gamma = raw_gamma
            self.raw_bps = raw_bps
            self.raw_no_auto_bright = not raw_auto_bright
            self.badPixelsPath = os.path.join(cacheFolder, "bad_pixels.gz")
            if not os.path.exists(self.badPixelsPath) and not offline:
                download_file(self.apiData["raw_bad_pixels_uri"], self.badPixelsPath)
            self.badPixels = (
                np.loadtxt(self.badPixelsPath, dtype=int)
                if os.path.exists(self.badPixelsPath) else None
            )

    @property
    def range(self):
        return self.apiData["date_start"], self.apiData["date_end"]

    def _dates(self):
        return [i["date"] for i in self.apiImages.values()]

    def _idx_with_offset(self, date):
        dates = self._dates()
        idx = find_nearest([naive_epoch(d) for d in dates], naive_epoch(date))
        return idx, abs((dates[idx] - date).total_seconds())

    def contains(self, date):
        _, offset = self._idx_with_offset(date)
        return offset <= self.maxTimeOffset

    def _frame_metadata(self, key):
        return dict(
            list(self.metadata.get("sequence_metadata", {}).items())
            + list(self.metadata.get("image_metadata", {}).get(key, {}).items())
        )

    def get(self, date):
        idx, offset = self._idx_with_offset(date)
        if offset > self.maxTimeOffset:
            raise ValueError(f"no image within {self.maxTimeOffset}s of {date}")
        key = list(self.apiImages.keys())[idx]
        return self._mapping_for_key(key)

    def getById(self, identifier):
        return self._mapping_for_key(identifier)

    def _mapping_for_key(self, key):
        self._download_files(key)
        img = self._processed_image(key)
        if isinstance(img, str):
            return get_mapping(
                img, self.wcsPaths[key], altitude=self.altitude, identifier=key,
                fast_center=self.fastCenterCalculation,
                metadata=self._frame_metadata(key), device=self.device,
            )
        return self._array_mapping(key, img)

    def _array_mapping(self, key, img):
        """Georeference a decoded, postprocessed image array of frame
        ``key`` with its cached WCS solution."""
        header = fits.read_header(self.wcsPaths[key])
        pos, photo_time, _ = resolve_camera_position(header)
        return create_mapping(
            header, img, pos, photo_time, altitude=self.altitude,
            identifier=key, metadata=self._frame_metadata(key),
            fast_center=self.fastCenterCalculation, device=self.device,
        )

    def getSequence(self, dateBegin=None, dateEnd=None):
        for key in self.download(dateBegin, dateEnd):
            yield self._mapping_for_key(key)

    def download(self, dateBegin=None, dateEnd=None):
        """Download frames in range; returns their keys (resume-safe)."""
        if not dateBegin:
            dateBegin = self.range[0]
        if not dateEnd:
            dateEnd = self.range[1]
        keys = [
            k for k, v in self.apiImages.items()
            if dateBegin <= v["date"] <= dateEnd
        ]
        for key in keys:
            self._download_files(key)
        return keys

    def removePostProcessedImages(self):
        for p in glob.glob(os.path.join(self.cacheFolder, "*.tiff")):
            os.remove(p)
        self.processedImagePaths = {}

    def _processed_image(self, key):
        """Path or RGB array of the display-ready image for a frame."""
        if key in self.processedImagePaths:
            return self.processedImagePaths[key]
        if not self.useRaw:
            raise RuntimeError(f"{key}: non-raw images are registered at "
                               "download time")
        import rawpy
        import rawpy.enhance

        raw = rawpy.imread(self.rawImagePaths[key])
        if self.badPixels is not None:
            rawpy.enhance.repair_bad_pixels(raw, self.badPixels)
        if self.raw_white_balance:
            # a 3-tuple WB maps onto the sensor pattern only for RGBG
            # 3-color RAWs (the reference's guard, iss.py:216-222)
            if raw.color_desc != b"RGBG" or raw.num_colors != 3:
                raise NotImplementedError(
                    f"user white balance for color pattern "
                    f"{raw.color_desc!r}/{raw.num_colors} colors")
            wb = [self.raw_white_balance[0], self.raw_white_balance[1],
                  self.raw_white_balance[2], self.raw_white_balance[1]]
        else:
            wb = self.apiData["raw_white_balance"]
        rgb = raw.postprocess(
            user_wb=wb, output_bps=self.raw_bps,
            no_auto_bright=self.raw_no_auto_bright, gamma=self.raw_gamma,
            user_flip=False,
        )
        rgb = self._postprocess_common(rgb)
        if self.noRawPostprocessCaching or rgb.dtype != np.uint8:
            # the tiff cache writer is 8-bit; caching a 16-bps postprocess
            # would silently quantize it (the reference forces caching off
            # for 16 bps the same way, iss.py:73-78)
            return rgb
        path = os.path.join(self.cacheFolder, key + ".tiff")
        save_image(path, rgb)
        self.processedImagePaths[key] = path
        return path

    def _postprocess_common(self, rgb):
        """Flip + archive distortion model (on the provider's device) +
        crop (shared raw/jpeg path)."""
        if self.apiData.get("raw_is_upside_down"):
            rgb = rgb[::-1, ::-1]
        dist = self.apiData.get("distortion_correction")
        if dist:
            rgb = correct_lens_distortion(rgb, dist["model"], dist["params"],
                                          device=self.device)
        # archive WCS solutions are based on divisible-by-16 cropped images
        return cropped_image(rgb, divisible_by=16)

    def _download_files(self, key):
        api_image = self.apiImages[key]
        image_url = api_image["raw_uri" if self.useRaw else "image_uri"]
        wcs_url = api_image["wcs_uri"]
        ext = self.apiData["raw_extension" if self.useRaw else "image_extension"]
        image_path = os.path.join(self.cacheFolder, key + ext)
        wcs_path = os.path.join(self.cacheFolder, key + ".wcs")
        if not os.path.exists(image_path):
            if self.offline:
                raise RuntimeError(f"offline=True but {image_path} not cached")
            download_file(image_url, image_path)
        if not os.path.exists(wcs_path):
            if self.offline:
                raise RuntimeError(f"offline=True but {wcs_path} not cached")
            download_file(wcs_url, wcs_path)
        if self.useRaw:
            self.rawImagePaths[key] = image_path
        else:
            self.processedImagePaths[key] = image_path
        self.wcsPaths[key] = wcs_path
