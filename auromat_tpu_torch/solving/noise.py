"""Image noise estimation (Immerkaer 1996 fast method).

Reference: auromat/solving/noiseestimation.py:34-63. A copy of
``auromat_tpu.solving.noise`` (float64 numpy); a tensor is reduced in
float64 on its own device.
"""

import math

import numpy as np
import torch


def estimate_noise_level(imgray) -> float:
    """Noise sigma of a grayscale image via the Immerkaer Laplacian kernel.

    A tensor (``mask_starfield`` passes its uint8 gray on the card) is
    reduced in float64 on its device; its Laplacian holds integers, whose
    absolute sum is exact in any order, so the sigma is the array's to the
    bit."""
    if torch.is_tensor(imgray):
        im = imgray.to(torch.float64)
    else:
        im = np.asarray(imgray, dtype=np.float64)
    h, w = im.shape
    # convolution with [[1,-2,1],[-2,4,-2],[1,-2,1]] expressed via shifts
    c = (
        im[:-2, :-2] + im[:-2, 2:] + im[2:, :-2] + im[2:, 2:]
        - 2 * (im[:-2, 1:-1] + im[2:, 1:-1] + im[1:-1, :-2] + im[1:-1, 2:])
        + 4 * im[1:-1, 1:-1]
    )
    sigma = float(abs(c).sum()) * math.sqrt(0.5 * math.pi) / (6.0 * (w - 2) * (h - 2))
    return sigma
