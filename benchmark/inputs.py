"""Inputs that the benchmark makes or reads itself and hands to both sides:
the frames' headers (read once here, the same values given to the program
and to the reference) and seeded uint8 images made on the device."""

import os

import torch

from benchmark.reference.header import calibration, read_cards, shrink_cards

HERE = os.path.dirname(os.path.abspath(__file__))


def frames(config, shrink=1):
    """[(path, cards)] of the configuration's frames, each header's cards
    as the run uses them (``shrink`` > 1 only in the harness's tests)."""
    out = []
    for rel in config["frames"]:
        path = os.path.join(HERE, "configs", rel)
        out.append((path, shrink_cards(read_cards(path), shrink)))
    return out


def calibrations(config, shrink=1):
    return [calibration(cards) for _, cards in frames(config, shrink)]


def program_header(path, cards):
    """The program's own header object of ``path``, holding ``cards``' values
    (the same numbers the reference reads)."""
    from auromat_tpu_torch.io import fits

    header = fits.read_header(path)
    header.update({k: v for k, v in cards.items() if k in header})
    return header


def seeded_images(seed, n, height, width, device):
    """``n`` uint8 (height, width, 3) images drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, height, width, 3), dtype=torch.uint8,
                         generator=gen, device=device)
