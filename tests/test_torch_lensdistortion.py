"""The port's lens distortion correction (auromat_tpu_torch.util.
lensdistortion) against the JAX package's on the CPU.

* ``correct_lens_distortion`` (and so ``_remap``) for ptlens, poly3 and
  poly5 on a seeded 240x320x3 uint8 image, the same image as uint16, a
  float32 image on [0, 1] and a 2-D plane: uint8/uint16 within one step
  with at most 1e-3 of the values differing, float32 within 1e-4. The port
  rounds as the JAX package's jitted remap does on the CPU (its fused
  multiply-adds emulated in float64), so at this size they agree bit for
  bit; at 4256x2832 XLA also fuses the squared radius, which moves about
  0.4% of the sampling positions by one float32 step.
* Zero distortion returns a uint8 image exactly.
* ``distortion_factor``, ``undistorted_radius`` and
  ``distortion_displacement`` within rtol 1e-6 (float32) and 1e-12
  (float64).
* The lens registry equals the JAX package's bundled one, and
  ``lookup_from_exif`` answers as the JAX package's does on the cases of
  tests/test_eol_raw.py and a registered zoom lens (interpolation, partial
  names, LookupError).
* ``device="cuda"`` without a card raises; a tensor comes back as a tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auromat_tpu.util import lensdistortion as J
from auromat_tpu_torch.util import lensdistortion as T

MODELS = [("ptlens", (0.01, -0.02, 0.005)), ("poly3", (-0.019,)),
          ("poly5", (0.1, 0.01))]


def images():
    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    return {"uint8": u8, "uint16": u8.astype(np.uint16) * 257,
            "float32": rng.random((240, 320, 3), dtype=np.float32),
            "plane": u8[..., 1].copy()}


IMAGES = images()


@pytest.mark.parametrize("kind", list(IMAGES))
@pytest.mark.parametrize("model,params", MODELS, ids=[m for m, _ in MODELS])
def test_correct_lens_distortion_matches_jax(model, params, kind):
    img = IMAGES[kind]
    want = J.correct_lens_distortion(img, model, params)
    got = T.correct_lens_distortion(img, model, params, device="cpu")
    assert got.dtype == img.dtype and got.shape == img.shape
    if kind == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    else:
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    # the remap itself, before rounding: float32 within 1e-4 of the range
    t = torch.from_numpy(img if img.ndim == 3 else img[..., None])
    raw = T._remap(t, model, params).numpy()
    jraw = np.asarray(J._remap(jnp.asarray(t.numpy()), model, params,
                               img.shape[:2]))
    scale = 1.0 if kind == "float32" else float(np.iinfo(img.dtype).max)
    assert np.abs(raw - jraw).max() <= 1e-4 * scale


@pytest.mark.parametrize("kind", ["uint8", "plane"])
def test_zero_distortion_is_identity(kind):
    img = IMAGES[kind]
    out = T.correct_lens_distortion(img, "ptlens", (0, 0, 0), device="cpu")
    assert np.array_equal(out, img)


def test_tensor_in_tensor_out_and_the_card_by_default():
    t = torch.from_numpy(IMAGES["uint8"])
    out = T.correct_lens_distortion(t, "poly3", (-0.019,), device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    assert np.array_equal(out.numpy(), T.correct_lens_distortion(
        IMAGES["uint8"], "poly3", (-0.019,), device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.correct_lens_distortion(IMAGES["uint8"], "poly3", (-0.019,))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("model,params", MODELS, ids=[m for m, _ in MODELS])
def test_radial_functions_match_jax(model, params, dtype):
    rtol = 1e-6 if dtype == "float32" else 1e-12
    ru = np.linspace(0.0, 1.3, 257).astype(dtype)
    got = T.distortion_factor(model, params, torch.from_numpy(ru)).numpy()
    want = np.asarray(J.distortion_factor(model, params, jnp.asarray(ru)))
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got, want, rtol=rtol)
    rd = ru[1:] * want[1:]
    back = T.undistorted_radius(model, params, torch.from_numpy(rd)).numpy()
    jback = np.asarray(J.undistorted_radius(model, params, jnp.asarray(rd)))
    np.testing.assert_allclose(back, jback, rtol=rtol)
    for a, b in zip(T.distortion_displacement((48, 64), model, params),
                    J.distortion_displacement((48, 64), model, params)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="unknown distortion model"):
        T.distortion_factor("poly7", params, ru)


def bundled(registry):
    """The bundled NIKON entries (other tests of the JAX package register
    more in the process they share)."""
    return {k: v for k, v in registry.items()
            if (k[0] if isinstance(k, tuple) else k).startswith("nikon")}


def test_lens_registry_matches_jax():
    assert T.LENS_DB == bundled(J.LENS_DB)
    assert T.CAMERA_CROP == bundled(J.CAMERA_CROP)
    assert len(T.LENS_DB) == 12 and all(len(v) == 1 for v in T.LENS_DB.values())


EXIF_CASES = [
    {"Model": "NIKON D3S", "LensModel": "24.0 mm f/1.4",
     "FocalLength": "24.0 mm"},
    {"Model": "Nikon D3s", "Lens": "AF-S Nikkor 50.0 mm f/1.4G",
     "FocalLength": 50.0},
    {"camera": "NIKON D4", "lens": "28.0 mm f/1.4", "focal_length": 40},
    {"Model": "NIKON D3", "LensModel": "85.0 mm f/1.4", "FocalLength": 200},
    {"Model": "NIKON D3", "LensModel": "24.0 mm f/1.4", "FocalLength": 10},
]


@pytest.fixture
def zoom(monkeypatch):
    """A zoom lens registered at two focal lengths in both packages (on
    copies of their registries), and a mixed-model one."""
    for mod in (T, J):
        monkeypatch.setattr(mod, "LENS_DB", dict(mod.LENS_DB))
        monkeypatch.setattr(mod, "CAMERA_CROP", dict(mod.CAMERA_CROP))
        mod.register_lens("ZCAM", "24-70 mm f/2.8", 24, "poly3", (-0.02,), 1.5)
        mod.register_lens("ZCAM", "24-70 mm f/2.8", 70, "poly3", (0.01,))
        mod.register_lens("ZCAM", "MIX 10-20", 10, "poly3", (0.01,))
        mod.register_lens("ZCAM", "MIX 10-20", 20, "poly5", (0.01, 0.02))


@pytest.mark.parametrize("exif", EXIF_CASES + [
    {"Model": "ZCAM", "LensModel": "24-70 mm f/2.8", "FocalLength": 50},
    {"Model": "ZCAM", "LensModel": "24-70 mm f/2.8", "FocalLength": "31 mm"},
    {"Model": "ZCAM", "LensModel": "MIX 10-20", "FocalLength": 12},
    {"Model": "ZCAM", "LensModel": "MIX 10-20", "FocalLength": 18},
])
def test_lookup_from_exif_matches_jax(exif, zoom):
    assert T.lookup_from_exif(exif) == J.lookup_from_exif(exif)


@pytest.mark.parametrize("exif", [
    {"Model": "NOCAM", "LensModel": "9.9 mm f/9", "FocalLength": 9.9},
    {"Model": "NIKON D3S", "FocalLength": 24.0},
    {"Model": "NIKON D3S", "LensModel": "300 mm f/2.8", "FocalLength": 300},
])
def test_lookup_from_exif_refusals(exif):
    with pytest.raises(LookupError):
        J.lookup_from_exif(exif)
    with pytest.raises(LookupError):
        T.lookup_from_exif(exif)


def test_register_lens_and_exif_correction(monkeypatch):
    monkeypatch.setattr(T, "LENS_DB", dict(T.LENS_DB))
    monkeypatch.setattr(T, "CAMERA_CROP", dict(T.CAMERA_CROP))
    exif = {"Model": "TESTCAM", "LensModel": "9.9 mm f/9", "FocalLength": 9.9}
    T.register_lens("TESTCAM", "9.9 mm f/9", 9.9, "ptlens",
                    (0.01, -0.02, 0.0), crop_factor=1.5)
    info = T.lookup_from_exif(exif)
    assert info["model"] == "ptlens" and info["crop_factor"] == 1.5
    T.register_lens("TESTCAM", "9.9 mm f/9", 9.9, "poly3", (-0.01,))
    assert T.lookup_from_exif(exif)["model"] == "poly3"
    assert T.CAMERA_CROP["testcam"] == 1.5  # kept, not reset to 1.0
    img = IMAGES["uint8"]
    nikon = {"Model": "NIKON D3S", "LensModel": "24.0 mm f/1.4",
             "FocalLength": "24.0 mm"}
    assert np.array_equal(
        T.correct_lens_distortion_exif(img, nikon, device="cpu"),
        T.correct_lens_distortion(img, "poly3", (-0.019,), device="cpu"))
