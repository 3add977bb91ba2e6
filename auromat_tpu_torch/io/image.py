"""Image file input (host side), counterpart of ``auromat_tpu.io.image``.

Loads via PIL, imported inside the function: PIL is optional for the
port, and a machine without it (the GPU machine the port is checked on
has none) can still build mappings from an image array
(:func:`auromat_tpu_torch.mapping.astrometry.create_mapping`).
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
