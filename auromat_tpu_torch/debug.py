"""Ad-hoc debug entry points (reference auromat/debug.py:22-95):
quick horizon/graticule checks from an image + wcs pair, batch masking.

Counterpart of ``auromat_tpu.debug``. The mapping, and ``batch_mask``'s
star-field masking (``solving.masking.mask_starfield``), are computed on
``device`` (the card by default; pass ``device="cpu"`` for the CPU);
reading the image and writing the PNG need PIL and matplotlib.
"""

import os


def check_horizon(image_path, wcs_path, out_path=None, altitude=110.0,
                  device="cuda"):
    """Overlay the computed Earth horizon on the photo; returns the PNG path."""
    from auromat_tpu_torch.draw import draw_horizon
    from auromat_tpu_torch.draw_helpers import save_fig
    from auromat_tpu_torch.mapping.spacecraft import get_mapping

    m = get_mapping(image_path, wcs_path, altitude=altitude, fast_center=True,
                    device=device)
    fig = draw_horizon(m, device=device)
    out_path = out_path or os.path.splitext(image_path)[0] + "_horizon.png"
    return save_fig(out_path, fig)


def check_graticule(image_path, wcs_path, out_path=None, altitude=110.0,
                    device="cuda"):
    """Overlay parallels/meridians on the photo; returns the PNG path."""
    from auromat_tpu_torch.draw import draw_parallels_meridians
    from auromat_tpu_torch.draw_helpers import save_fig
    from auromat_tpu_torch.mapping.spacecraft import get_mapping

    m = get_mapping(image_path, wcs_path, altitude=altitude, fast_center=True,
                    device=device)
    fig = draw_parallels_meridians(m)
    out_path = out_path or os.path.splitext(image_path)[0] + "_grid.png"
    return save_fig(out_path, fig)


def batch_mask(image_folder, out_folder, device="cuda"):
    """Run star-field masking over a folder on ``device``, writing masked
    previews."""

    from auromat_tpu_torch.io.image import load_image, save_image
    from auromat_tpu_torch.ops.georef import compute_device
    from auromat_tpu_torch.solving.masking import mask_starfield

    device = compute_device(device)  # before anything is written
    os.makedirs(out_folder, exist_ok=True)
    results = {}
    for f in sorted(os.listdir(image_folder)):
        if os.path.splitext(f)[1].lower() not in (".jpg", ".jpeg", ".png"):
            continue
        img = load_image(os.path.join(image_folder, f))
        mask, sigma = mask_starfield(img, device=device)
        preview = img.copy()
        preview[~mask] = 0
        out = os.path.join(out_folder, f)
        save_image(out, preview)
        results[f] = (out, sigma)
    return results
