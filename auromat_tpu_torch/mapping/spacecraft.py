"""Spacecraft (ISS DSLR) mappings: image files + astrometric ``.wcs`` headers.

Counterpart of the single-frame half of ``auromat_tpu.mapping.spacecraft``:
the camera position comes from the header cards (time-shift-corrected
position preferred, then the plain position), and the frame is
georeferenced on the requested device. Not ported yet: the TLE fallback
(it needs ``coordinates.ephem``), the directory provider and the batched
burst path.
"""

import os
from datetime import timedelta

import numpy as np
import torch

from auromat_tpu_torch.io import fits
from auromat_tpu_torch.io.image import load_image
from auromat_tpu_torch.mapping.astrometry import create_mapping


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
                device="cpu"):
    """Georeference one image + .wcs pair on ``device`` (reference
    spacecraft.py:380-426). Reading the image needs PIL."""
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
