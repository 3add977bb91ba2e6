"""Astrometric mappings: build a Mapping from a WCS solution + camera state.

Counterpart of ``auromat_tpu.mapping.astrometry``: one call into the
georeference chain (:func:`auromat_tpu_torch.ops.georef.georeference`) on
the requested device, then the results come back to the host as float64
numpy arrays for the :class:`Mapping`, as in the JAX package. MLat/MLT is
computed straight from the J2000 intersections, like the reference
(astrometry.py:170-198).

The JAX package's ``"df64"`` double-float chain exists because TPUs have
no float64; here ``dtype="df64"`` is native float64 on any device and
for every projection family. TAN headers (every astrometry.net solution)
take the fused trig-free path; any other projection :func:`make_wcs`
builds goes through the generic plane->native->celestial chain.
"""

from datetime import datetime

import numpy as np
import numpy.ma as ma
import torch

from auromat_tpu_torch.coordinates.frames import FrameMatrices
from auromat_tpu_torch.coordinates.wcs import TanWcs, make_wcs
from auromat_tpu_torch.mapping.mapping import Mapping
from auromat_tpu_torch.ops.georef import (GeorefParams, georeference,
                                          georeference_generic)


class AstrometryMapping(Mapping):
    """Mapping whose MLat/MLT was computed from the J2000 intersections."""


def create_mapping(wcs_header, img, camera_pos, photo_time: datetime,
                   altitude=110.0, identifier=None, metadata=None,
                   fast_center=True, with_mlatmlt=True, dtype=torch.float64,
                   frame_matrices=None, device="cuda") -> AstrometryMapping:
    """Georeference an image with a WCS solution into a Mapping.

    TAN headers take the fused fast path; any other supported FITS
    projection (the full Paper II catalogue of
    :func:`auromat_tpu_torch.coordinates.wcs.make_wcs`) routes through the
    generic plane->native->celestial chain into the same intersection/
    Bowring/elevation/MLat-MLT pipeline — the reference georeferences
    such headers through its astropy fallback (reference wcs.py:18-64).

    :param wcs_header: FITS header dict (astrometry.net .wcs solution)
    :param img: (h, w[, C]) uint8/uint16 image matching IMAGEW/IMAGEH
    :param camera_pos: (3,) GCRS km
    :param fast_center: centre coords as 4-corner means (reference
        fastCenterCalculation, astrometry.py:154-160); mask invariants then
        hold by construction
    :param dtype: torch dtype of the per-pixel chain (float64 for the
        reference's precision); ``"df64"`` is float64
    :param device: where the per-pixel chain runs (the card by default;
        pass ``device="cpu"`` for the CPU); the mapping's arrays are host
        numpy float64 whatever the device
    """
    img = np.asarray(img)
    h, w = img.shape[0], img.shape[1]
    try:
        wcs = TanWcs(wcs_header)
    except ValueError:
        wcs = make_wcs(wcs_header)  # any supported FITS projection
        if (wcs_header.get("CTYPE1") or "")[:5] != "RA---":
            # the georef chain reads pixel directions as GCRS~ICRS; a
            # galactic/ecliptic header would be silently mis-framed
            raise ValueError(
                "georeferencing needs an equatorial (RA---/DEC--) WCS; "
                f"got {wcs_header.get('CTYPE1')!r} (use coordinates.wcs."
                "pix2world directly for non-equatorial imagery)")
        if wcs.width is None or wcs.height is None:
            wcs.width, wcs.height = w, h  # non-astrometry.net headers
    if (w, h) != (wcs.width, wcs.height):
        raise ValueError(f"image is {w}x{h}, the WCS solution "
                         f"{wcs.width}x{wcs.height}")
    fm = frame_matrices or FrameMatrices(photo_time)
    params = GeorefParams.from_wcs(wcs, camera_pos, photo_time, altitude, fm)
    if isinstance(dtype, str):
        fast_center = False  # the df64 chain computes exact centres
    if isinstance(wcs, TanWcs):
        out = georeference(params, fast_center=fast_center,
                           with_mlatmlt=with_mlatmlt, dtype=dtype,
                           device=device)
    else:
        out = georeference_generic(wcs, params, fast_center=fast_center,
                                   with_mlatmlt=with_mlatmlt, dtype=dtype,
                                   device=device)
    get = lambda k: out[k].to(device="cpu", dtype=torch.float64).numpy()
    mapping = AstrometryMapping(
        get("lats"), get("lons"), get("lats_center"), get("lons_center"),
        get("elevation"), altitude, img, camera_pos, photo_time,
        identifier, metadata=metadata, sanitized=fast_center,
        frame_matrices=fm,
    )
    mapping.wcs_header = wcs_header
    if with_mlatmlt:
        # align the J2000-derived magnetic coords with the (possibly
        # sanitize-extended) lat/lon masks
        def masked(key, mask):
            a = get(key)
            a[mask] = np.nan
            return ma.masked_invalid(a, copy=False)

        cm, ccm = mapping.corner_mask, mapping.center_mask
        mapping._mlatmlt = (masked("mlat", cm), masked("mlt", cm))
        mapping._mlatmlt_center = (
            masked("mlat_center", ccm), masked("mlt_center", ccm),
        )
    return mapping
