"""Lens distortion models and image undistortion on the device.

Counterpart of ``auromat_tpu.util.lensdistortion``: the distortion
polynomials (ptlens / poly3 / poly5, the models lensfun's database uses)
are evaluated directly in torch and the image remap is a bilinear gather
on the image's device, so the correction of a 12 MP frame is a handful of
elementwise kernels on the card.

Radii are normalised by half the smaller image dimension (lensfun's
convention).
"""

import bisect

import numpy as np
import torch

from auromat_tpu_torch.ops.georef import compute_device


def distortion_factor(model, params, ru):
    """rd/ru as a function of the undistorted radius ru (a tensor, an
    array or a float).

    models: 'ptlens' (a, b, c), 'poly3' (k1,), 'poly5' (k1, k2)

    The powers are written out as the products the JAX package's
    ``integer_pow`` evaluates (``ru**3`` is ``ru * (ru * ru)``, ``ru**4``
    is ``(ru * ru) * (ru * ru)``), so both round alike.
    """
    if model == "ptlens":
        a, b, c = params
        ru2 = ru * ru
        return a * (ru * ru2) + b * ru2 + c * ru + (1.0 - a - b - c)
    if model == "poly3":
        (k1,) = params
        return 1.0 - k1 + k1 * ru * ru
    if model == "poly5":
        k1, k2 = params
        ru2 = ru * ru
        return 1.0 + k1 * ru * ru + k2 * (ru2 * ru2)
    raise ValueError(f"unknown distortion model {model!r}")


def undistorted_radius(model, params, rd, iterations=8):
    """Invert rd = ru * f(ru) by fixed-point iteration."""
    ru = rd
    for _ in range(iterations):
        ru = rd / distortion_factor(model, params, ru)
    return ru


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32, as a fused multiply-add does:
    ``a`` is a float32 tensor, ``b`` and ``c`` float32 tensors or floats
    that float32 holds exactly, so the product is exact in float64."""
    return (a.double() * b + c).float()


def _factor_fused(model, params, ru):
    """:func:`distortion_factor` on a float32 tensor, rounded as the JAX
    package's jitted remap rounds it on the CPU: the parameters in float32,
    and each add of a product one fused multiply-add (XLA's CPU backend
    contracts them; eager torch would round every product)."""
    p32 = [float(np.float32(v)) for v in params]
    if model == "ptlens":
        a, b, c = params
        ru2 = ru * ru
        f = _fma(ru2, p32[1], (ru2 * ru) * p32[0])
        return _fma(ru, p32[2], f) + (1.0 - a - b - c)
    if model == "poly3":
        (k1,) = params
        return _fma(ru * p32[0], ru, float(np.float32(1.0 - k1)))
    if model == "poly5":
        ru2 = ru * ru
        return _fma(ru2 * ru2, p32[1], _fma(ru * p32[0], ru, 1.0))
    raise ValueError(f"unknown distortion model {model!r}")


def _remap(img, model, params):
    """Bilinear undistortion of an (h, w, C) tensor on its own device;
    float32 (h, w, C), 0 where the sampling position leaves the image.

    Rounded step by step as the JAX package's jitted remap is on the CPU
    (a division by a constant as a product with its float32 reciprocal,
    the fused multiply-adds of :func:`_factor_fused`, the sampling
    positions and the blend), so sampling positions and blends agree to
    the last bit but for rare double roundings.
    """
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    half = min(h, w) / 2.0
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    inv = float(np.float32(1.0 / half))
    ys = (torch.arange(h, dtype=torch.float32, device=dev) - cy) * inv
    xs = (torch.arange(w, dtype=torch.float32, device=dev) - cx) * inv
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    # corrected image pixel -> sampling position in the distorted source:
    # the stored image is distorted, so the distortion is evaluated at the
    # undistorted (output) radius
    # the float32 root through float64: torch's CPU float32 sqrt is not
    # always correctly rounded, the float64 one is, and rounding it to
    # float32 gives the correctly rounded float32 root. (XLA's CPU loop
    # over a full frame's row fuses xx * xx into the sum, one it unrolls
    # rounds it apart as here: at 4256x2832 about 0.4% of the sampling
    # positions differ from the JAX package's by one float32 step.)
    ru = torch.sqrt((xx * xx + yy * yy).double()).float()
    factor = _factor_fused(model, params, ru)
    sx = _fma(xx * factor, half, cx)
    sy = _fma(yy * factor, half, cy)
    del ru, xx, yy, factor
    x0 = torch.floor(sx).to(torch.int32).clamp_(0, w - 2)
    y0 = torch.floor(sy).to(torch.int32).clamp_(0, h - 2)
    fx = (sx - x0).clamp_(0.0, 1.0)[..., None]
    fy = (sy - y0).clamp_(0.0, 1.0)[..., None]
    eps = 1e-3  # tolerate float rounding at the exact border
    inside = (sx >= -eps) & (sx <= w - 1 + eps) & (sy >= -eps) & (sy <= h - 1 + eps)
    del sx, sy
    img_f = img.to(torch.float32)
    x0, y0 = x0.long(), y0.long()
    gx, gy = 1 - fx, 1 - fy
    out = _fma(img_f[y0, x0] * gx, gy, img_f[y0, x0 + 1] * fx * gy)
    out = _fma(img_f[y0 + 1, x0] * gx, fy, out)
    out = _fma(img_f[y0 + 1, x0 + 1] * fx, fy, out)
    return torch.where(inside[..., None], out, 0.0)


# integer dtypes torch supports only partly, carried in a wider signed one
_CARRIER = {np.dtype(np.uint16): np.int32, np.dtype(np.uint32): np.int64}


def correct_lens_distortion(img, model="ptlens", params=(0.0, 0.0, 0.0),
                            device="cuda"):
    """Undistort an (h, w[, C]) image on ``device`` (the card by default);
    returns the same dtype.

    A numpy array comes back as a numpy array (copied to the device and
    back); a tensor comes back as a tensor on ``device``. Integer images are
    rounded half to even and clipped to their dtype's range.

    Reference: auromat/util/lensdistortion.py:159-196 (lensfun
    ``apply_geometry_distortion`` + cv2.remap).
    """
    device = compute_device(device)
    params = tuple(float(p) for p in params)
    is_tensor = isinstance(img, torch.Tensor)
    if is_tensor:
        t = img.to(device)
        integer = not t.dtype.is_floating_point
        info = torch.iinfo(t.dtype) if integer else None
    else:
        img = np.asarray(img)
        integer = np.issubdtype(img.dtype, np.integer)
        info = np.iinfo(img.dtype) if integer else None
        host = img.astype(_CARRIER.get(img.dtype, img.dtype), copy=False)
        # torch.from_numpy wants a writable array (a decoded image may not be)
        t = torch.from_numpy(np.require(host, requirements="CW")).to(device)
    squeeze = t.ndim == 2
    out = _remap(t[:, :, None] if squeeze else t, model, params)
    if integer:
        out = torch.round(out).clamp_(info.min, info.max)
    out = out.to(t.dtype)
    if squeeze:
        out = out[:, :, 0]
    if is_tensor:
        return out
    return out.cpu().numpy().astype(img.dtype, copy=False)


def distortion_displacement(shape, model="ptlens", params=(0.0, 0.0, 0.0)):
    """Per-pixel displacement field (dx, dy) introduced by the correction,
    float64 numpy on the host (reference lensdistortion.py:234-267)."""
    h, w = shape
    half = min(h, w) / 2.0
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = (np.arange(h) - cy) / half
    xs = (np.arange(w) - cx) / half
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    ru = np.sqrt(xx * xx + yy * yy)
    factor = np.asarray(distortion_factor(model, tuple(params), ru))
    dx = (xx * factor - xx) * half
    dy = (yy * factor - yy) * half
    return dx, dy


# ---------------------------------------------------------------------------
# EXIF-driven model lookup (replaces the reference's lensfun-DB path,
# auromat/util/lensdistortion.py:44-107, without the lensfun C library)
# ---------------------------------------------------------------------------

def _norm(s):
    return " ".join(str(s).lower().split())


# (camera_model, lens_model) -> sorted list of (focal_mm, model, terms);
# crop factor keyed per camera. The bundled coefficients are APPROXIMATE
# poly3 fits from published rectilinear-distortion figures (D ~= k1 at the
# image half-height); the ISS archive path does not use this table, the
# ESA archive supplies per-sequence model parameters (mapping/iss.py).
# Register calibrated entries with :func:`register_lens`.
LENS_DB = {}
CAMERA_CROP = {}


def register_lens(camera, lens, focal_mm, model, terms, crop_factor=None):
    """Register distortion parameters for (camera, lens) at one focal
    length, REPLACING any existing entry at that focal length (so a
    calibrated entry overrides the bundled approximate one).

    :param crop_factor: the CAMERA's crop factor; None keeps a previously
        registered value (defaults to 1.0 for a new camera) — a defaulted
        parameter must not silently reset another lens's registration
    """
    key = (_norm(camera), _norm(lens))
    focal_mm = float(focal_mm)
    entries = [e for e in LENS_DB.get(key, []) if e[0] != focal_mm]
    entries.append((focal_mm, model, tuple(terms)))
    entries.sort(key=lambda e: e[0])
    LENS_DB[key] = entries
    if crop_factor is not None:
        CAMERA_CROP[_norm(camera)] = float(crop_factor)
    else:
        CAMERA_CROP.setdefault(_norm(camera), 1.0)


# the ISS aurora imagery bodies/lenses (NASA EOL metadata); approximate
for _cam in ("NIKON D3S", "NIKON D3", "NIKON D4"):
    register_lens(_cam, "24.0 mm f/1.4", 24.0, "poly3", (-0.019,), 1.0)
    register_lens(_cam, "28.0 mm f/1.4", 28.0, "poly3", (-0.015,), 1.0)
    register_lens(_cam, "50.0 mm f/1.4", 50.0, "poly3", (-0.007,), 1.0)
    register_lens(_cam, "85.0 mm f/1.4", 85.0, "poly3", (0.002,), 1.0)
del _cam


def lookup_from_exif(exif):
    """Distortion model parameters for an EXIF tag dict.

    Accepts the tag names written by exiftool (``Model``, ``LensModel``/
    ``Lens``, ``FocalLength``) or plain keys (camera/lens/focal_length).
    Interpolates terms linearly between the two nearest registered focal
    lengths of the matched lens (the lensfun behaviour).

    :returns: dict(model=..., params=..., crop_factor=..., focal_length=...)
    :raises LookupError: when no entry matches
    """
    cam = exif.get("Model") or exif.get("camera")
    lens = exif.get("LensModel") or exif.get("Lens") or exif.get("lens")
    focal = exif.get("FocalLength") or exif.get("focal_length")
    if cam is None or lens is None or focal is None:
        raise LookupError("EXIF lacks Model/LensModel/FocalLength")
    focal = float(str(focal).split()[0])
    key = (_norm(cam), _norm(lens))
    entries = LENS_DB.get(key)
    if not entries:
        # partial lens-name match (exiftool and lensfun spell lenses
        # differently; match on the shared focal/aperture designation)
        for (c, l), e in LENS_DB.items():
            if c == _norm(cam) and (l in _norm(lens) or _norm(lens) in l):
                entries = e
                break
    if not entries:
        raise LookupError(f"no distortion entry for {cam!r} + {lens!r}; "
                          "register one with register_lens()")
    focals = [e[0] for e in entries]
    if focal <= focals[0]:
        _, model, terms = entries[0]
    elif focal >= focals[-1]:
        _, model, terms = entries[-1]
    else:
        i = bisect.bisect_left(focals, focal)
        f0, m0, t0 = entries[i - 1]
        f1, m1, t1 = entries[i]
        if m0 != m1 or len(t0) != len(t1):
            _, model, terms = entries[i if focal - f0 > f1 - focal else i - 1]
        else:
            w = (focal - f0) / (f1 - f0)
            model = m0
            terms = tuple((1 - w) * a + w * b for a, b in zip(t0, t1))
    return dict(model=model, params=tuple(terms),
                crop_factor=CAMERA_CROP.get(_norm(cam), 1.0),
                focal_length=focal)


def correct_lens_distortion_exif(img, exif, device="cuda"):
    """Undistort an image on ``device`` using EXIF-matched model
    parameters."""
    info = lookup_from_exif(exif)
    return correct_lens_distortion(img, model=info["model"],
                                   params=info["params"], device=device)
