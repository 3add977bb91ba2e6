"""Regenerate the benchmark's star-field frames: the gray planes of the two
checked-in ISS JPEGs, which the card's machine cannot decode (no PIL).

    python tools/make_starfield_frames.py

Each of tests/resources/ISS029-E-8492.jpg and ISS030-E-102170_dc.jpg is
decoded with ``auromat_tpu_torch.io.image.load_image`` and turned to gray
with OpenCV's ``COLOR_RGB2GRAY`` weights in 15-bit fixed point,
``(9798 R + 19235 G + 3735 B + 16384) >> 15``. The weights sum to 2^15, so
the plane repeated into three channels gives the same gray back, and
``mask_starfield`` of that RGB frame masks what it masks of the JPEG.
The planes go to benchmark/configs/data/<frame>_gray.npz (key ``gray``,
``np.savez_compressed``), beside a copy of each frame's
golden_masking_<frame>.npz (the executed original's mask and sigma).
"""

import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = os.path.join(ROOT, "tests", "resources")
OUT = os.path.join(ROOT, "benchmark", "configs", "data")
FRAMES = ("ISS029-E-8492", "ISS030-E-102170_dc")


def gray_plane(rgb):
    """OpenCV's gray of an (h, w, 3) uint8 RGB array, as uint8."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + 16384) >> 15).astype(np.uint8)


def main():
    sys.path.insert(0, ROOT)
    from auromat_tpu_torch.io.image import load_image

    os.makedirs(OUT, exist_ok=True)
    for name in FRAMES:
        gray = gray_plane(load_image(os.path.join(RES, f"{name}.jpg")))
        again = gray_plane(np.repeat(gray[..., None], 3, axis=2))
        assert np.array_equal(gray, again), name
        path = os.path.join(OUT, f"{name}_gray.npz")
        np.savez_compressed(path, gray=gray)
        shutil.copy(os.path.join(RES, f"golden_masking_{name}.npz"), OUT)
        print(f"{name}: {gray.shape[1]}x{gray.shape[0]} gray, "
              f"{os.path.getsize(path) / 1e6:.2f} MB -> {path}")


if __name__ == "__main__":
    main()
