"""Minimal FITS header reader (no astropy dependency), header-only subset.

astrometry.net ``.wcs`` artifacts are header-only FITS files (NAXIS=0).
Covers the card grammar those files use: strings, logicals, integers,
floats, HISTORY/COMMENT, and the spacecraft-position cards the reference
defines (auromat/fits.py:347-466). Writing headers stays in
``auromat_tpu.io.fits`` until a ported caller needs it.
"""

from datetime import datetime, timedelta

CARD = 80


class FitsHeader(dict):
    """An ordered keyword->value mapping plus HISTORY/COMMENT lists."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.comments = {}
        self.history = []
        self.comment_cards = []

    def copy(self):
        h = FitsHeader(self)
        h.comments = dict(self.comments)
        h.history = list(self.history)
        h.comment_cards = list(self.comment_cards)
        return h


def _parse_value(raw: str):
    raw = raw.strip()
    if not raw:
        return None
    if raw.startswith("'"):
        # FITS string: ends at closing quote; '' is an escaped quote
        out = []
        i = 1
        while i < len(raw):
            c = raw[i]
            if c == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(c)
            i += 1
        return "".join(out).rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw.replace("D", "E").replace("d", "e"))
    except ValueError:
        return raw


def parse_card(card: str):
    """Parse one 80-char card -> (keyword, value, comment) or None for blanks."""
    key = card[:8].rstrip()
    if not key:
        return None
    if key in ("HISTORY", "COMMENT"):
        return key, card[8:].rstrip(), None
    if key == "END":
        return "END", None, None
    if card[8:10] != "= ":
        # commentary-style card without value indicator
        return key, card[8:].rstrip(), None
    rest = card[10:]
    # split off comment: a '/' outside of a quoted string
    in_str = False
    slash = -1
    i = 0
    while i < len(rest):
        c = rest[i]
        if c == "'":
            if in_str and i + 1 < len(rest) and rest[i + 1] == "'":
                i += 2
                continue
            in_str = not in_str
        elif c == "/" and not in_str:
            slash = i
            break
        i += 1
    if slash >= 0:
        value_raw, comment = rest[:slash], rest[slash + 1 :].strip()
    else:
        value_raw, comment = rest, None
    return key, _parse_value(value_raw), comment


def read_header(path_or_bytes) -> FitsHeader:
    """Read the primary header of a FITS file into a :class:`FitsHeader`."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    header = FitsHeader()
    for off in range(0, len(data), CARD):
        card = data[off : off + CARD].decode("ascii", errors="replace")
        parsed = parse_card(card)
        if parsed is None:
            continue
        key, value, comment = parsed
        if key == "END":
            break
        if key == "HISTORY":
            header.history.append(value)
            continue
        if key == "COMMENT":
            header.comment_cards.append(value)
            continue
        header[key] = value
        if comment:
            header.comments[key] = comment
    return header


# ---------------------------------------------------------------------------
# Spacecraft-position header cards (reference: auromat/fits.py:347-466)
# ---------------------------------------------------------------------------

_DATE_OBS_FORMATS = ("%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S")


def parse_date_obs(value: str) -> datetime:
    for fmt in _DATE_OBS_FORMATS:
        try:
            return datetime.strptime(value, fmt)
        except ValueError:
            continue
    raise ValueError("unparseable DATE-OBS: %r" % value)


def get_photo_time(header):
    value = header.get("DATE-OBS")
    return parse_date_obs(value) if value else None


def get_spacecraft_position(header):
    """(x, y, z) GCRS km at DATE-OBS, or None."""
    x = header.get("POSX")
    if x is None:
        return None
    return (x, header["POSY"], header["POSZ"])


def get_norad_id(header):
    v = header.get("NORADID")
    return int(v) if v is not None else None


def get_shifted_spacecraft_position(header):
    """(x, y, z, shift_seconds) for the time-shift-corrected position, or None.

    Reference: auromat/fits.py:427-445.
    """
    x = header.get("POSXSHIF")
    if x is None or header.get("DATESHIF") is None:
        return None
    return (x, header["POSYSHIF"], header["POSZSHIF"], header["DATESHIF"])


def get_shifted_photo_time(header):
    """The time-shift-corrected photo time, falling back to DATE-OBS
    (reference fits.py:381-391)."""
    t = get_photo_time(header)
    shifted = get_shifted_spacecraft_position(header)
    if shifted is not None and t is not None:
        return t + timedelta(seconds=shifted[3])
    return t
