"""Image noise estimation (Immerkaer 1996 fast method).

Reference: auromat/solving/noiseestimation.py:34-63. A copy of
``auromat_tpu.solving.noise`` (float64 numpy).
"""

import math

import numpy as np


def estimate_noise_level(imgray) -> float:
    """Noise sigma of a grayscale image via the Immerkaer Laplacian kernel."""
    im = np.asarray(imgray, dtype=np.float64)
    h, w = im.shape
    # convolution with [[1,-2,1],[-2,4,-2],[1,-2,1]] expressed via shifts
    c = (
        im[:-2, :-2] + im[:-2, 2:] + im[2:, :-2] + im[2:, 2:]
        - 2 * (im[:-2, 1:-1] + im[2:, 1:-1] + im[1:-1, :-2] + im[1:-1, 2:])
        + 4 * im[1:-1, 1:-1]
    )
    sigma = np.abs(c).sum() * math.sqrt(0.5 * math.pi) / (6.0 * (w - 2) * (h - 2))
    return float(sigma)
