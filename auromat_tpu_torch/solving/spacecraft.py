"""Sequence solving for spacecraft imagery: EXIF times + TLEs + solve-field.

Orchestration mirroring auromat/solving/spacecraft.py:28-159: read EXIF
capture times, update the TLE archive, blind-solve each frame (skipping
already-solved ones — the implicit checkpoint/resume of the system,
SURVEY.md section 5), and stamp NORAD id + TLE-derived camera position into
each solved header. Counterpart of ``auromat_tpu.solving.spacecraft``: SGP4
runs on the host; the solution checks (:func:`intersects_earth`,
:func:`is_consistent`) georeference their points in float64 on ``device``,
the card by default, and so does the star-field masking of each frame
(``solve_image``'s ``device``, passed through ``solve_kw``).
"""

import os

import numpy as np

from auromat_tpu_torch.coordinates.ephem import EphemerisCalculator
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.io.image import read_exif_time
from auromat_tpu_torch.solving.solving import solve_image

ISS_NORAD_ID = 25544


def solve_sequence(image_dir, wcs_dir, tle_path=None, norad_id=ISS_NORAD_ID,
                   spacetrack_user=None, spacetrack_password=None,
                   overwrite=False, **solve_kw):
    """Solve every image in ``image_dir`` into ``wcs_dir``.

    :param tle_path: TLE archive file; if None and space-track credentials
        are given, the archive is downloaded/updated first
    :param solve_kw: for ``solve_image``; its ``device`` (the card by
        default) is where the star-field masking computes
    :returns: dict image filename -> wcs path or None
    """
    os.makedirs(wcs_dir, exist_ok=True)
    images = sorted(
        f for f in os.listdir(image_dir)
        if os.path.splitext(f)[1].lower() in (".jpg", ".jpeg", ".png", ".tif", ".tiff")
    )
    times = {}
    for f in images:
        t = read_exif_time(os.path.join(image_dir, f))
        if t is not None:
            times[f] = t

    if tle_path is None and spacetrack_user:
        from auromat_tpu_torch.coordinates.spacetrack import Spacetrack

        st = Spacetrack(spacetrack_user, spacetrack_password, wcs_dir)
        tle_path = st.update_tles_for(norad_id, list(times.values()))

    calc = None
    if tle_path and os.path.exists(tle_path):
        calc = EphemerisCalculator(tle_path, norad_id=norad_id)

    results = {}
    for f in images:
        base = os.path.splitext(f)[0]
        wcs_path = os.path.join(wcs_dir, base + ".wcs")
        if os.path.exists(wcs_path) and not overwrite:
            results[f] = wcs_path  # already solved: skip (resume semantics)
            continue
        solved = solve_image(os.path.join(image_dir, f), wcs_path, **solve_kw)
        if solved is None:
            results[f] = None
            continue
        header = fits.read_header(solved)
        fits.set_norad_id(header, norad_id)
        t = times.get(f)
        if t is not None and calc is not None:
            pos = calc(t)
            fits.set_spacecraft_position(header, np.asarray(pos), t)
        fits.write_header(header, solved)
        results[f] = solved
    return results


def _latitudes(header, altitude, device):
    """``lat(px, py)``: host float64 latitudes of pixel coordinates under
    ``header``'s solution, georeferenced in float64 on ``device``; and the
    32x32 grid over the frame that the checks test."""
    from auromat_tpu_torch.coordinates.wcs import TanWcs
    from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position
    from auromat_tpu_torch.ops.georef import (GeorefParams, compute_device,
                                              georeference_points)

    device = compute_device(device)
    wcs = TanWcs(header)
    pos, photo_time, _ = resolve_camera_position(header)
    params = GeorefParams.from_wcs(wcs, pos, photo_time, altitude)

    def lat(px, py):
        return georeference_points(params, px, py,
                                   device=device)[0].cpu().numpy()

    xs = np.linspace(0, wcs.width - 1, 32)
    ys = np.linspace(0, wcs.height - 1, 32)
    return lat, np.meshgrid(xs, ys)


def intersects_earth(header, altitude=110.0, device="cuda"):
    """Plausibility: do any frame rays hit the inflated Earth?

    Reference spacecraft.py:508-522 sanity-checks solutions this way.
    """
    lat, (px, py) = _latitudes(header, altitude, device)
    return bool(np.isfinite(lat(px, py)).any())


def is_consistent(header, altitude=0.0, star_px_coords=None, device="cuda"):
    """Solve-sanity check (reference spacecraft.py:523-555): a plausible
    oblique aurora frame intersects the Earth PARTIALLY — all-Earth or
    all-sky means a wrong timestamp/solution — regardless of which edge
    the Earth sits on (the camera may be mounted in any orientation).
    Optionally rejects solutions whose quad stars would be covered by the
    modelled Earth.

    :param star_px_coords: (n, 2) x,y pixel coords of solve stars
    """
    lat, (px, py) = _latitudes(header, altitude, device)
    hits = np.isfinite(lat(px, py))
    if hits.all() or not hits.any():
        return False
    if star_px_coords is not None:
        spx = np.asarray(star_px_coords, dtype=np.float64)
        if np.isfinite(lat(spx[:, 0], spx[:, 1])).any():
            return False  # a solve star would sit on the Earth disk
    return True


def solve(image_path, wcs_path, tle_path=None, norad_id=ISS_NORAD_ID,
          overwrite=False, **solve_kw):
    """Solve a single image into ``wcs_path``; returns True on success
    (reference solving/spacecraft.py:28-65). The spacecraft position is
    stamped from the TLE archive when available, like solve_sequence;
    ``solve_kw`` goes to ``solve_image`` (``device`` among them)."""
    if os.path.exists(wcs_path) and not overwrite:
        raise FileExistsError(wcs_path)
    solved = solve_image(image_path, wcs_path, **solve_kw)
    if solved is None:
        return False
    header = fits.read_header(solved)
    fits.set_norad_id(header, norad_id)
    t = read_exif_time(image_path)
    if t is not None and tle_path and os.path.exists(tle_path):
        calc = EphemerisCalculator(tle_path, norad_id=norad_id)
        fits.set_spacecraft_position(header, np.asarray(calc(t)), t)
    fits.write_header(header, solved)
    return True
