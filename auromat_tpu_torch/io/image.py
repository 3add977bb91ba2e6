"""Image file I/O (host side), counterpart of ``auromat_tpu.io.image``.

Loads and saves via PIL and reads EXIF tags with it, imported inside each
function: PIL is optional for the port, and a machine without it (the GPU
machine the port is checked on has none) can still build mappings from an
image array (:func:`auromat_tpu_torch.mapping.astrometry.create_mapping`).
"""

import numpy as np


def load_image(path):
    """Load an image as (h, w, 3) uint8/uint16 RGB (alpha dropped)."""
    import warnings

    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("I;16", "I;16B", "I"):
            arr = np.asarray(im)
            if arr.ndim == 2:
                arr = np.repeat(arr[:, :, None], 3, 2)
            if im.mode == "I" and (arr.min() < 0 or arr.max() > 65535):
                # 32-bit integer source beyond uint16: a plain astype
                # would wrap modulo 65536
                warnings.warn(
                    f"{path}: 32-bit pixel values outside uint16 range "
                    "are clipped")
                arr = np.clip(arr, 0, 65535)
            return arr.astype(np.uint16)
        if im.mode != "RGB":
            im = im.convert("RGB")
        return np.asarray(im)


def save_image(path, img):
    """Save (h, w[, 3]) uint8 (or uint16 -> scaled to uint8) image data;
    masked entries are written as 0."""
    from PIL import Image

    if np.ma.isMaskedArray(img):
        # before np.asarray: that would strip the mask and write the
        # underlying buffer contents at masked pixels
        img = img.filled(0)
    img = np.asarray(img)
    if img.dtype == np.uint16:
        img = (img.astype(np.float64) * (255 / 65535)).astype(np.uint8)
    Image.fromarray(img).save(path)


def cropped_image(img, divisible_by=16):
    """Crop so both dimensions are divisible by ``divisible_by``.

    Crops bottom/right (reference: auromat/util/image.py:59-72).
    """
    h, w = img.shape[0], img.shape[1]
    return img[: h - h % divisible_by, : w - w % divisible_by]


def _exif(path):
    from PIL import Image
    from PIL.ExifTags import TAGS

    with Image.open(path) as im:
        raw = im.getexif()
        tags = {TAGS.get(k, k): v for k, v in raw.items()}
        try:
            ifd = raw.get_ifd(0x8769)  # Exif SubIFD
            tags.update({TAGS.get(k, k): v for k, v in ifd.items()})
        except Exception:
            pass
    return tags


def read_exif_time(path):
    """Capture time incl. sub-second part, or None.

    Reference: auromat/util/image.py:113-144.
    """
    tags = _exif(path)
    raw = tags.get("DateTimeOriginal") or tags.get("DateTime")
    if raw is None:
        return None
    sub = tags.get("SubsecTimeOriginal") or tags.get("SubsecTime")
    return convert_exif_date(raw, sub)


def read_focal_length_35mm(path):
    """35mm-equivalent focal length in mm, or None."""
    tags = _exif(path)
    v = tags.get("FocalLengthIn35mmFilm")
    return float(v) if v else None


def read_exposure_time(path):
    tags = _exif(path)
    v = tags.get("ExposureTime")
    return float(v) if v else None


def convert_exif_date(date_str, subsec_str=None):
    """EXIF date/time string (+ optional sub-second part) -> datetime.

    Reference: auromat/util/image.py:128-152 (exiftool may hand back an
    int when the sub-second field has no leading zeros).
    """
    from datetime import datetime

    t = datetime.strptime(str(date_str), "%Y:%m:%d %H:%M:%S")
    if subsec_str is not None:
        frac = str(subsec_str).strip()
        if frac.isdigit():
            t = t.replace(microsecond=int(float("0." + frac) * 1e6))
    return t


def _normalize_image(rgb):
    """(Masked) image -> float [0, 255] range; masked entries NaN.

    Reference: auromat/util/image.py:74-94 (converts to float BEFORE
    filling, so masked uint8 pixels become NaN, not 0).
    """
    import numpy.ma as ma

    if rgb.dtype == np.uint16:
        rgb = rgb * (255 / 65535)
    elif rgb.dtype != np.uint8 and np.nanmax(rgb) <= 1.0:
        rgb = rgb * 255.0
    if ma.isMaskedArray(rgb):
        rgb = rgb.astype(np.float64).filled(np.nan)
    return rgb


def image_to_mpl(rgb):
    """Image -> float [0, 1] range for matplotlib (reference image2mpl)."""
    return np.asarray(_normalize_image(rgb), dtype=np.float64) / 255.0


def image_to_cv(rgb):
    """RGB image -> BGR uint8 for OpenCV (reference image2cv). Masked
    pixels come out BLACK (a NaN->uint8 cast is undefined); grayscale
    passes through unchanged (the channel reversal applies to the color
    axis only — on a 2D array it would mirror the image)."""
    norm = _normalize_image(rgb)
    if np.issubdtype(np.asarray(norm).dtype, np.floating):
        norm = np.nan_to_num(norm, nan=0.0)
    rgb = np.require(norm, np.uint8, "C")
    if rgb.ndim == 3 and rgb.shape[-1] == 3:
        return rgb[..., ::-1].copy()
    return rgb
