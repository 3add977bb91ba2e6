"""A FITS header as astrometry.net writes it, read with no library.

The benchmark reads every `.wcs` file of a configuration itself and hands
the same values to the program and to the reference, so the reference never
takes a calibration that the program parsed.
"""

from dataclasses import dataclass
from datetime import datetime, timedelta

CARD = 80


def _value(raw):
    raw = raw.strip()
    if raw.startswith("'"):
        return raw[1:raw.rindex("'")].replace("''", "'").rstrip()
    if raw in ("T", "F"):
        return raw == "T"
    try:
        return int(raw)
    except ValueError:
        return float(raw)


def read_cards(path):
    """{keyword: value} of the valued cards of a FITS header file."""
    with open(path, "rb") as f:
        data = f.read()
    cards = {}
    for off in range(0, len(data), CARD):
        card = data[off:off + CARD].decode("ascii")
        key = card[:8].rstrip()
        if key == "END":
            break
        if not key or card[8:10] != "= ":
            continue
        rest, in_str = card[10:], False
        for i, c in enumerate(rest):  # a '/' outside a string starts the comment
            if c == "'":
                in_str = not in_str
            elif c == "/" and not in_str:
                rest = rest[:i]
                break
        cards[key] = _value(rest)
    return cards


def shrink_cards(cards, factor):
    """The cards of the same field of view seen on a frame ``factor`` times
    smaller along each axis (the harness's tests run at such sizes): the
    CD matrix grows by ``factor``, the reference pixel moves with it."""
    out = dict(cards)
    if factor == 1:
        return out
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        out[k] = cards[k] * factor
    for k in ("CRPIX1", "CRPIX2"):
        out[k] = (cards[k] - 1.0) / factor + 1.0
    out["IMAGEW"] = cards["IMAGEW"] // factor
    out["IMAGEH"] = cards["IMAGEH"] // factor
    return out


@dataclass(frozen=True)
class Calibration:
    """One frame's calibration as the original auromat reads it: the TAN
    solution, the camera's GCRS position (km) and the photo time."""

    width: int
    height: int
    crpix: tuple
    cd: tuple  # ((CD1_1, CD1_2), (CD2_1, CD2_2)), degrees per pixel
    crval: tuple  # (RA, Dec) of the reference point, degrees
    lonpole: float
    camera_pos: tuple
    photo_time: datetime


def calibration(cards):
    """The calibration of a header: the shifted position and time where the
    header has them (POS*SHIF, DATESHIF), else POS* at DATE-OBS."""
    if cards.get("CTYPE1") != "RA---TAN" or cards.get("CTYPE2") != "DEC--TAN":
        raise ValueError("the reference reads TAN solutions only")
    t = datetime.fromisoformat(cards["DATE-OBS"])
    if cards.get("POSXSHIF") is not None and cards.get("DATESHIF") is not None:
        pos = tuple(float(cards[k]) for k in ("POSXSHIF", "POSYSHIF", "POSZSHIF"))
        t = t + timedelta(seconds=float(cards["DATESHIF"]))
    else:
        pos = tuple(float(cards[k]) for k in ("POSX", "POSY", "POSZ"))
    return Calibration(
        width=int(cards["IMAGEW"]), height=int(cards["IMAGEH"]),
        crpix=(float(cards["CRPIX1"]), float(cards["CRPIX2"])),
        cd=((float(cards["CD1_1"]), float(cards["CD1_2"])),
            (float(cards["CD2_1"]), float(cards["CD2_2"]))),
        crval=(float(cards["CRVAL1"]), float(cards["CRVAL2"])),
        lonpole=float(cards.get("LONPOLE", 180.0)),
        camera_pos=pos, photo_time=t)
