"""Minimal FITS reader/writer (no astropy dependency).

Counterpart of ``auromat_tpu.io.fits``. astrometry.net ``.wcs`` artifacts
are header-only FITS files (NAXIS=0). Covers the card grammar those files
use: strings, logicals, integers, floats, HISTORY/COMMENT, and the
spacecraft-position cards the reference defines (auromat/fits.py:347-466);
the header writer, the DATASUM/CHECKSUM convention, the BINTABLE subset of
astrometry.net's star lists (.xyls/.axy/.match/.corr) and catalog-star
pixel positions. The two functions that project stars through a WCS
(``recompute_xyls_pixel_positions``, ``get_catalog_stars``) compute on
``device``, the card by default.

Headers serialize byte for byte as the JAX package's do, HISTORY texts
included, so a ``.wcs`` either package writes is the same file.
"""

import math
from datetime import datetime, timedelta

BLOCK = 2880
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


def _format_value(value) -> str:
    if isinstance(value, bool):
        return "T".rjust(20) if value else "F".rjust(20)
    if isinstance(value, int):
        return str(value).rjust(20)
    if isinstance(value, float):
        if math.isfinite(value):
            s = repr(value)
        else:
            raise ValueError("non-finite FITS value: %r" % value)
        return s.rjust(20)
    if isinstance(value, str):
        body = value.replace("'", "''")
        body = body.ljust(8)  # min 8 chars in a FITS string
        return ("'%s'" % body).ljust(20)
    raise TypeError("unsupported FITS value type: %r" % type(value))


def format_card(key: str, value, comment=None) -> str:
    if key in ("HISTORY", "COMMENT"):
        card = key.ljust(8) + str(value or "")
    elif value is None and comment is None:
        card = key.ljust(8)
    else:
        card = key.ljust(8) + "= " + _format_value(value)
        if len(card) > CARD:
            # truncating the VALUE would cut a closing quote / digits and
            # silently corrupt the card; only comments may be trimmed
            raise ValueError(
                f"FITS card value for {key!r} exceeds 80 chars: {card!r}")
        if comment:
            card += " / " + comment
    return card[:CARD].ljust(CARD)


def header_bytes(header: FitsHeader) -> bytes:
    """Serialize a header-only HDU (NAXIS=0) to padded FITS bytes."""
    cards = []
    base = {"SIMPLE": (True, "conforms to FITS standard"),
            "BITPIX": (8, "array data type"),
            "NAXIS": (0, "number of array dimensions")}
    for key, (val, cmt) in base.items():
        cards.append(format_card(key, header.get(key, val), header.comments.get(key, cmt)))
    for key, value in header.items():
        if key in base:
            continue
        cards.append(format_card(key, value, header.comments.get(key)))
    for h in getattr(header, "history", []):
        cards.append(format_card("HISTORY", h))
    for c in getattr(header, "comment_cards", []):
        cards.append(format_card("COMMENT", c))
    cards.append(format_card("END", None))
    blob = "".join(cards).encode("ascii")
    pad = (-len(blob)) % BLOCK
    return blob + b" " * pad


def write_header(header: FitsHeader, path):
    """Write a header-only FITS file (NAXIS=0) with the given cards."""
    with open(path, "wb") as f:
        f.write(header_bytes(header))


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


def set_spacecraft_position(header, xyz, date: datetime):
    if header.get("POSX") is None:
        header.history.append("POS* & DATE-OBS added by auromat_tpu")
    header["POSX"] = float(xyz[0])
    header["POSY"] = float(xyz[1])
    header["POSZ"] = float(xyz[2])
    header.comments["POSX"] = "X coordinate of spacecraft in GCRS at DATE-OBS"
    header.comments["POSY"] = "Y coordinate of spacecraft in GCRS at DATE-OBS"
    header.comments["POSZ"] = "Z coordinate of spacecraft in GCRS at DATE-OBS"
    header["DATE-OBS"] = date.isoformat()
    header.comments["DATE-OBS"] = "EXIF timestamp of the photograph"


def get_shifted_spacecraft_position(header):
    """(x, y, z, shift_seconds) for the time-shift-corrected position, or None.

    Reference: auromat/fits.py:427-445.
    """
    x = header.get("POSXSHIF")
    if x is None or header.get("DATESHIF") is None:
        return None
    return (x, header["POSYSHIF"], header["POSZSHIF"], header["DATESHIF"])


def set_shifted_spacecraft_position(header, xyz, delta_seconds: float):
    if header.get("POSXSHIF") is None:
        header.history.append("POS*SHIF & DATESHIF added by auromat_tpu")
    header["POSXSHIF"] = float(xyz[0])
    header["POSYSHIF"] = float(xyz[1])
    header["POSZSHIF"] = float(xyz[2])
    header["DATESHIF"] = float(delta_seconds)
    header.comments["POSXSHIF"] = "X coordinate of spacecraft in GCRS at DATESHIF"
    header.comments["POSYSHIF"] = "Y coordinate of spacecraft in GCRS at DATESHIF"
    header.comments["POSZSHIF"] = "Z coordinate of spacecraft in GCRS at DATESHIF"
    header.comments["DATESHIF"] = "DATE-OBS shift in seconds"


def get_norad_id(header):
    v = header.get("NORADID")
    return int(v) if v is not None else None


def set_norad_id(header, norad_id: int):
    if header.get("NORADID") is None:
        header.history.append("NORADID added by auromat_tpu")
    header["NORADID"] = str(norad_id)
    header.comments["NORADID"] = "NORAD ID of spacecraft"


def get_cd_matrix(header):
    return (
        (header["CD1_1"], header["CD1_2"]),
        (header["CD2_1"], header["CD2_2"]),
    )


def get_pixel_scale_deg(header):
    """Pixel scale in deg/px from the CD matrix determinant."""
    cd = get_cd_matrix(header)
    det = cd[0][0] * cd[1][1] - cd[0][1] * cd[1][0]
    return math.sqrt(abs(det))


def get_center_radec(header):
    return header["CRVAL1"], header["CRVAL2"]


def get_rotation_angle(header):
    """Celestial rotation angle atan2(CD2_1, CD1_1) in degrees.

    Reference: auromat/fits.py:43-92 (getRotationAngle).
    """
    cd = get_cd_matrix(header)
    return math.degrees(math.atan2(cd[1][0], cd[0][0]))


# ---------------------------------------------------------------------------
# FITS checksums (DATASUM/CHECKSUM, the standard ones-complement scheme)
# ---------------------------------------------------------------------------


def _ones_complement_sum32(data: bytes) -> int:
    import numpy as _np

    padded = data + b"\x00" * ((-len(data)) % 4)
    words = _np.frombuffer(padded, dtype=">u4").astype(_np.uint64)
    total = int(words.sum())
    while total >> 32:
        total = (total & 0xFFFFFFFF) + (total >> 32)
    return total


# ASCII codes excluded from checksum chars (the FITS checksum convention
# allows only 0-9 A-Z a-z): ':' .. '@' and '[' .. '`'
_CHECKSUM_EXCLUDE = tuple(range(0x3A, 0x41)) + tuple(range(0x5B, 0x61))


def _encode_checksum(value: int) -> str:
    """Encode a 32-bit complemented sum into the 16-char FITS ASCII form.

    Canonical algorithm (Seaman's checksum convention): each of the 4 sum
    bytes splits into 4 ASCII chars that add back to it; excluded
    punctuation is removed by balanced +1/-1 shifts on char PAIRS,
    iterated until every char is clean (a single pass can re-dirty an
    already-checked char); the string rotates right one place to match
    the value's byte alignment inside the CHECKSUM card.
    """
    value = ~value & 0xFFFFFFFF
    ascii_zero = 0x30
    out = [0] * 16
    for i in range(4):
        byte = (value >> (24 - 8 * i)) & 0xFF
        ch = [byte // 4 + ascii_zero] * 4
        ch[0] += byte % 4
        dirty = True
        while dirty:
            dirty = False
            for k in _CHECKSUM_EXCLUDE:
                for j in (0, 2):
                    if ch[j] == k or ch[j + 1] == k:
                        ch[j] += 1
                        ch[j + 1] -= 1
                        dirty = True
        for j in range(4):
            out[4 * j + i] = ch[j]
    s = "".join(chr(c) for c in out)
    return s[-1] + s[:-1]  # rotate right one place


def _fold32(total: int) -> int:
    """Ones-complement fold keeping the end-around carry (dropping it
    makes CHECKSUM off by one whenever the sum crosses 2^32)."""
    while total >> 32:
        total = (total & 0xFFFFFFFF) + (total >> 32)
    return total


def compute_datasum(data: bytes) -> int:
    return _ones_complement_sum32(data)


def set_checksums(header: FitsHeader, data: bytes = b""):
    """Set DATASUM and CHECKSUM (reference writes checksums via astropy,
    auromat/fits.py:29-41)."""
    datasum = compute_datasum(data)
    header["DATASUM"] = str(datasum)
    header["CHECKSUM"] = "0000000000000000"
    # serialize the header with zero checksum in memory, then encode
    blob = header_bytes(header)
    total = _fold32(_ones_complement_sum32(blob) + datasum)
    header["CHECKSUM"] = _encode_checksum(total)
    return header


def verify_checksum(blob: bytes, data: bytes = b"") -> bool:
    """True iff the ones-complement sum of header+data (with the encoded
    CHECKSUM chars included) folds to 0xFFFFFFFF — the defining property
    of the FITS checksum convention."""
    total = _fold32(_ones_complement_sum32(blob)
                    + _ones_complement_sum32(data))
    return total == 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal binary-table (BINTABLE) support for astrometry.net artifacts
# ---------------------------------------------------------------------------

_TFORM_DTYPES = {
    # FITS logicals are ASCII 'T'/'F' bytes (both nonzero!), decoded to
    # bool after the frombuffer pass — mapping "L" to numpy '?' would read
    # every value (including 'F' = 0x46) as True
    "L": "S1", "B": "u1", "I": ">i2", "J": ">i4", "K": ">i8",
    "E": ">f4", "D": ">f8",
}


def _header_size_cards(data, offset):
    """Parse a header starting at offset; return (FitsHeader, data_offset)."""
    header = FitsHeader()
    pos = offset
    ended = False
    while pos < len(data) and not ended:
        block = data[pos : pos + BLOCK]
        for i in range(0, BLOCK, CARD):
            card = block[i : i + CARD].decode("ascii", errors="replace")
            parsed = parse_card(card)
            if parsed is None:
                continue
            key, value, comment = parsed
            if key == "END":
                ended = True
                break
            if key in ("HISTORY", "COMMENT"):
                continue
            header[key] = value
        pos += BLOCK
    return header, pos


def _parse_tform(tform):
    tform = str(tform).strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    if code == "A":
        return repeat, f"S{repeat}", 1
    return repeat, _TFORM_DTYPES[code], repeat


def read_bintable(path, hdu=1):
    """Read one BINTABLE extension into a dict of column name -> ndarray.

    Supports the column types astrometry.net artifacts use (E/D/I/J/K/A).
    """
    import numpy as _np

    with open(path, "rb") as f:
        data = f.read()
    # walk HDUs
    pos = 0
    for h in range(hdu + 1):
        header, data_off = _header_size_cards(data, pos)
        if h == hdu:
            break
        # skip this HDU's data
        if header.get("NAXIS", 0):
            nbytes = abs(int(header.get("BITPIX", 8))) // 8
            for ax in range(1, int(header["NAXIS"]) + 1):
                nbytes *= int(header[f"NAXIS{ax}"])
        else:
            nbytes = 0
        pos = data_off + nbytes + ((-nbytes) % BLOCK)
    if header.get("XTENSION", "").strip() != "BINTABLE":
        raise ValueError(f"HDU {hdu} is not a BINTABLE: {header.get('XTENSION')!r}")
    n_rows = int(header["NAXIS2"])
    n_fields = int(header["TFIELDS"])
    names, formats, logical = [], [], set()
    for i in range(1, n_fields + 1):
        name = str(header.get(f"TTYPE{i}", f"col{i}")).strip()
        names.append(name)
        tform = str(header[f"TFORM{i}"]).strip()
        repeat, base, _ = _parse_tform(tform)
        if tform.lstrip("0123456789").startswith("L"):
            logical.add(name)
            base = "S1"
        if base.startswith("S") and "A" in tform:
            formats.append(base)
        elif repeat == 1:
            formats.append(base)
        else:
            formats.append((base, (repeat,)))
    dtype = _np.dtype({"names": names, "formats": formats})
    assert dtype.itemsize == int(header["NAXIS1"]), (dtype.itemsize, header["NAXIS1"])
    table = _np.frombuffer(
        data, dtype=dtype, count=n_rows, offset=data_off
    )
    out = {}
    for name in names:
        col = table[name]
        if name in logical:
            col = col == b"T"
        elif col.dtype.kind in "if":
            col = col.astype(col.dtype.newbyteorder("="))
        out[name] = col
    return out


def write_bintable(path, columns, primary_header=None):
    """Write a dict of name -> 1D array as a single BINTABLE extension.

    Used for .xyls star lists fed to astrometry.net (reference
    auromat/fits.py:318-345 writeXyls).
    """
    import numpy as _np

    names = list(columns.keys())
    arrays = [_np.asarray(columns[n]) for n in names]
    n_rows = len(arrays[0])
    formats = []
    tforms = []
    inv = {v: k for k, v in _TFORM_DTYPES.items()}
    for j, a in enumerate(arrays):
        if a.dtype.kind == "b":
            # FITS logical column: 'T'/'F' ASCII bytes
            arrays[j] = a = _np.where(a, b"T", b"F").astype("S1")
            tforms.append("L")
            formats.append("S1")
            continue
        be = a.dtype.newbyteorder(">")
        code = inv.get(be.str.lstrip("=<>|"), None) or inv.get(be.str, None)
        if code is None:
            mapping = {"f8": "D", "f4": "E", "i2": "I", "i4": "J", "i8": "K"}
            code = mapping[a.dtype.str[-2:]]
        tforms.append(code)
        formats.append(">" + a.dtype.str[-2:])
    dtype = _np.dtype({"names": names, "formats": formats})
    table = _np.zeros(n_rows, dtype=dtype)
    for n, a in zip(names, arrays):
        table[n] = a

    prim = FitsHeader(primary_header or {})
    prim["EXTEND"] = True
    ext_cards = []
    ext_cards.append(format_card("XTENSION", "BINTABLE", "binary table extension"))
    ext_cards.append(format_card("BITPIX", 8))
    ext_cards.append(format_card("NAXIS", 2))
    ext_cards.append(format_card("NAXIS1", dtype.itemsize))
    ext_cards.append(format_card("NAXIS2", n_rows))
    ext_cards.append(format_card("PCOUNT", 0))
    ext_cards.append(format_card("GCOUNT", 1))
    ext_cards.append(format_card("TFIELDS", len(names)))
    for i, (n, t) in enumerate(zip(names, tforms), start=1):
        ext_cards.append(format_card(f"TTYPE{i}", n))
        ext_cards.append(format_card(f"TFORM{i}", t))
    ext_cards.append(format_card("END", None))
    ext_blob = "".join(ext_cards).encode("ascii")
    ext_blob += b" " * ((-len(ext_blob)) % BLOCK)
    data_blob = table.tobytes()
    data_blob += b"\x00" * ((-len(data_blob)) % BLOCK)

    with open(path, "wb") as f:
        f.write(header_bytes(prim) + ext_blob + data_blob)


def write_xyls(path, x, y, flux=None):
    """Write a star x/y list for astrometry.net (1-based pixel origin)."""
    import numpy as _np

    cols = {"X": _np.asarray(x, dtype=_np.float64) + 1,
            "Y": _np.asarray(y, dtype=_np.float64) + 1}
    if flux is not None:
        cols["FLUX"] = _np.asarray(flux, dtype=_np.float64)
    write_bintable(path, cols)


def read_xy(path, sort=False, sort_key="FLUX", sort_reverse=True):
    """x, y (0-based) from an .axy/.xyls star list (reference fits.py:167-191)."""
    import numpy as _np

    table = read_bintable(path)
    x = table["X"] - 1
    y = table["Y"] - 1
    if sort:
        order = _np.argsort(table[sort_key])
        if sort_reverse:
            order = order[::-1]
        x, y = x[order], y[order]
    return x, y


def read_quad_match(path):
    """Pixel coordinates of the matched quad stars from a .match artifact."""
    import numpy as _np

    table = read_bintable(path)
    star_count = int(_np.ravel(table["DIMQUADS"])[0])
    quadpix = _np.asarray(table["QUADPIX"])[0].reshape(-1, 2)
    return quadpix[:star_count]


def read_corr(path):
    """(field_x, field_y, index_x, index_y) from a .corr artifact."""
    table = read_bintable(path)
    return (table["field_x"], table["field_y"],
            table["index_x"], table["index_y"])


def recompute_xyls_pixel_positions(original_xyls_path, original_wcs_path,
                                   new_wcs_path_or_header, device="cuda"):
    """Pixel positions of reference stars under a different WCS solution,
    projected in float64 on ``device`` (the card by default; pass
    ``device="cpu"`` for the CPU); returns numpy arrays.

    Reference: auromat/fits.py:194-216 (used to compare solver runs).
    """
    from auromat_tpu_torch.coordinates.wcs import (TanWcs, tan_pix2world,
                                                   tan_world2pix)
    from auromat_tpu_torch.ops.georef import compute_device

    device = compute_device(device)
    orig = TanWcs(read_header(original_wcs_path))
    x, y = read_xy(original_xyls_path)
    ra, dec = tan_pix2world(orig, _f64_tensor(x, device),
                            _f64_tensor(y, device))
    if isinstance(new_wcs_path_or_header, (str, bytes)):
        new = TanWcs(read_header(new_wcs_path_or_header))
    else:
        new = TanWcs(new_wcs_path_or_header)
    nx, ny = tan_world2pix(new, ra, dec)
    return nx.cpu().numpy(), ny.cpu().numpy()


def _f64_tensor(a, device):
    """Host values as a float64 tensor on ``device``: the port's WCS
    functions take tensors and compute on their device."""
    import numpy as _np
    import torch

    return torch.from_numpy(_np.array(a, dtype=_np.float64)).to(device)


def _query_vizier_tycho2(center_ra, center_dec, radius_deg, row_limit,
                         max_vmag=None, timeout=60):
    """Cone-search Tycho-2 via VizieR's ASU-TSV endpoint (no astroquery).

    :returns: (ra, dec, vmag) float64 arrays sorted by VTmag
    """
    import io as _io
    import urllib.parse
    import urllib.request

    import numpy as _np

    params = {
        "-source": "I/259/tyc2",
        "-c": f"{center_ra:+.6f}{center_dec:+.6f}",
        "-c.rd": f"{radius_deg:.4f}",
        "-out": "RA(ICRS) DE(ICRS) VTmag",
        "-sort": "VTmag",
        "-out.max": str(row_limit if row_limit > 0 else 999999),
    }
    if max_vmag:
        params["VTmag"] = f"<{max_vmag}"
    url = ("https://vizier.cds.unistra.fr/viz-bin/asu-tsv?"
           + urllib.parse.urlencode(params))
    with urllib.request.urlopen(url, timeout=timeout) as r:
        text = r.read().decode("utf-8", errors="replace")
    rows = []
    for line in text.splitlines():
        if not line or line.startswith("#") or line[0].isalpha() \
                or line.startswith("-"):
            continue
        parts = line.split("\t")
        if len(parts) < 3:
            continue
        try:
            rows.append((float(parts[0]), float(parts[1]),
                         float(parts[2]) if parts[2].strip() else _np.nan))
        except ValueError:
            continue
    if not rows:
        return (_np.empty(0),) * 3
    a = _np.asarray(rows, dtype=_np.float64)
    return a[:, 0], a[:, 1], a[:, 2]


def get_catalog_stars(header, limit=500, limit_factor=2.5, max_vmag=None,
                      ret_vmag=False, catalog="bright", retry=1,
                      device="cuda"):
    """Catalog-star pixel positions inside the frame.

    Mirrors the reference's getCatalogStars (fits.py:218-316): cone-search a
    star catalog around the frame centre (radius = half diagonal + a small
    border so circles at the frame edge draw as half circles), project to
    pixels and keep in-frame stars.

    :param catalog: 'bright' — the bundled OFFLINE naked-eye star set
        (positions only; vmag comes back NaN and ordering is undefined);
        'tycho2' — a live VizieR Tycho-2 cone search, sorted by VTmag
        (needs network; retried ``retry`` times)
    :param device: where the stars are projected, in float64 (the card by
        default; pass ``device="cpu"`` for the CPU)
    :returns: (x, y) or (x, y, vmag) numpy arrays, origin (0, 0)
    """
    import numpy as _np

    from auromat_tpu_torch.coordinates.wcs import TanWcs, tan_world2pix
    from auromat_tpu_torch.ops.georef import compute_device

    device = compute_device(device)
    w, h = header["IMAGEW"], header["IMAGEH"]
    wcs = TanWcs(header)
    center_ra, center_dec = get_center_radec(header)
    scale = get_pixel_scale_deg(header)
    border = 0.01 * w
    radius = scale * (math.hypot(w, h) / 2 + border)

    if catalog == "bright":
        from auromat_tpu_torch.coordinates.constellations import bright_stars

        stars = bright_stars()
        ra, dec = stars[:, 0], stars[:, 1]
        vmag = _np.full(len(ra), _np.nan)
    elif catalog == "tycho2":
        row_limit = int(limit_factor * limit) if limit else -1
        last = None
        for _ in range(max(1, retry + 1)):
            try:
                ra, dec, vmag = _query_vizier_tycho2(
                    center_ra, center_dec, radius, row_limit, max_vmag)
                break
            except Exception as e:  # network errors
                last = e
        else:
            raise RuntimeError(f"Vizier query failed: {last!r}")
    else:
        raise ValueError(f"unknown catalog {catalog!r}")

    x, y = tan_world2pix(wcs, _f64_tensor(ra, device),
                         _f64_tensor(dec, device))
    x, y = x.cpu().numpy(), y.cpu().numpy()
    inside = (x >= -border) & (x < w + border) & (y >= -border) & (y < h + border)
    x, y, vmag = x[inside], y[inside], _np.asarray(vmag)[inside]
    order = _np.argsort(_np.where(_np.isnan(vmag), _np.inf, vmag),
                        kind="stable")
    x, y, vmag = x[order], y[order], vmag[order]
    if limit:
        x, y, vmag = x[:limit], y[:limit], vmag[:limit]
    return (x, y, vmag) if ret_vmag else (x, y)


def cd11_cd21(scale, rotation_deg):
    """(CD1_1, CD2_1) from pixel scale (deg/px) and rotation (deg).

    Reference: auromat/fits.py:67-78.
    """
    rho = math.radians(rotation_deg)
    return scale * math.cos(rho), scale * math.sin(rho)


def set_cd_matrix(header, scale, rotation_deg):
    """Set the WCS CD matrix from pixel scale (deg/px) and rotation (deg).

    Reference: auromat/fits.py:80-92.
    """
    cd11, cd21 = cd11_cd21(scale, rotation_deg)
    header["CD1_1"] = cd11
    header["CD1_2"] = -cd21
    header["CD2_1"] = cd21
    header["CD2_2"] = cd11


def get_radius(header, extend=0.0):
    """Radius (deg) of the circle enclosing the image, from the CD-matrix
    pixel scale and IMAGEW/IMAGEH (reference fits.py:94-106).

    Uses the reference's own scale definition — the first-column norm
    sqrt(CD1_1^2 + CD2_1^2) (reference getPixelScale, fits.py:43-52) —
    NOT sqrt|det|: on a skewed/anisotropic solve the geometric-mean scale
    is smaller and would under-cover the catalog query region this
    radius bounds.

    :param extend: fractional enlargement in [0, 1]
    """
    diag_px = math.hypot(header["IMAGEW"], header["IMAGEH"])
    scale = math.hypot(header["CD1_1"], header["CD2_1"])
    return scale * diag_px / 2 * (1 + extend)


def set_center_radec(header, ra, dec):
    """Point the WCS reference pixel at the image centre with the given
    celestial coordinates (reference fits.py:120-137)."""
    assert 0 <= ra <= 360
    assert -90 <= dec <= 90
    w, h = header["IMAGEW"], header["IMAGEH"]
    header["CRPIX1"] = int(w // 2 + 1)  # FITS is 1-based
    header["CRPIX2"] = int(h // 2 + 1)
    header["CRVAL1"] = ra
    header["CRVAL2"] = dec


def get_shifted_photo_time(header):
    """The time-shift-corrected photo time, falling back to DATE-OBS
    (reference fits.py:381-391)."""
    t = get_photo_time(header)
    shifted = get_shifted_spacecraft_position(header)
    if shifted is not None and t is not None:
        return t + timedelta(seconds=shifted[3])
    return t
