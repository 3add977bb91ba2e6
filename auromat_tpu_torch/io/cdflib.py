"""Minimal pure-Python NASA CDF (Common Data Format) v3 reader/writer (a
copy of ``auromat_tpu.io.cdflib``, which imports no jax).

Replaces the spacepy.pycdf/C-library dependency of the reference
(auromat/export/cdf.py:20, auromat/mapping/themis.py:11). Implements the
subset of the CDF 3.x internal format the framework needs:

* single-file CDFs with zVariables, global + variable attributes
* NETWORK (big-endian) and IBMPC (little-endian) encodings on read;
  NETWORK on write
* whole-file gzip compression (CCR) and gzip-compressed variable records
  (CVVR) on read; uncompressed or gzip-CVVR on write
* CDF_EPOCH and CDF_TIME_TT2000 time types with leap-second handling

Format reference: the public "CDF Internal Format Description" (NASA/GSFC).
"""

import gzip
import struct
import zlib
from datetime import datetime, timedelta

import numpy as np

# record types
CDR_ = 1
GDR_ = 2
rVDR_ = 3
ADR_ = 4
AgrEDR_ = 5
VXR_ = 6
VVR_ = 7
zVDR_ = 8
AzEDR_ = 9
CCR_ = 10
CPR_ = 11
SPR_ = 12
CVVR_ = 13

# data types
CDF_INT1 = 1
CDF_INT2 = 2
CDF_INT4 = 4
CDF_INT8 = 8
CDF_UINT1 = 11
CDF_UINT2 = 12
CDF_UINT4 = 14
CDF_REAL4 = 21
CDF_REAL8 = 22
CDF_EPOCH = 31
CDF_EPOCH16 = 32
CDF_TIME_TT2000 = 33
CDF_BYTE = 41
CDF_FLOAT = 44
CDF_DOUBLE = 45
CDF_CHAR = 51
CDF_UCHAR = 52

_DTYPE_MAP = {
    CDF_INT1: "i1", CDF_BYTE: "i1", CDF_INT2: "i2", CDF_INT4: "i4",
    CDF_INT8: "i8", CDF_UINT1: "u1", CDF_UINT2: "u2", CDF_UINT4: "u4",
    CDF_REAL4: "f4", CDF_FLOAT: "f4", CDF_REAL8: "f8", CDF_DOUBLE: "f8",
    CDF_EPOCH: "f8", CDF_TIME_TT2000: "i8", CDF_CHAR: "S", CDF_UCHAR: "S",
}

_NP_TO_CDF = {
    np.dtype(np.int8): CDF_INT1, np.dtype(np.int16): CDF_INT2,
    np.dtype(np.int32): CDF_INT4, np.dtype(np.int64): CDF_INT8,
    np.dtype(np.uint8): CDF_UINT1, np.dtype(np.uint16): CDF_UINT2,
    np.dtype(np.uint32): CDF_UINT4, np.dtype(np.float32): CDF_REAL4,
    np.dtype(np.float64): CDF_REAL8,
}

NETWORK_ENCODING = 1
IBMPC_ENCODING = 6
_LITTLE_ENDIAN_ENCODINGS = {6, 13, 16}  # IBMPC, DECSTATION, ALPHAOSF1, ...

GLOBAL_SCOPE = 1
VARIABLE_SCOPE = 2

# ---------------------------------------------------------------------------
# time conversions
# ---------------------------------------------------------------------------

def datetime_to_epoch(dt: datetime) -> float:
    """datetime -> CDF_EPOCH (milliseconds since 01-Jan-0000)."""
    delta = dt - datetime(2000, 1, 1)
    # ms from 0 AD to 2000-01-01 per CDF convention: 63113904000000.0
    return 63113904000000.0 + delta.total_seconds() * 1e3


def epoch_to_datetime(ms: float) -> datetime:
    return datetime(2000, 1, 1) + timedelta(milliseconds=ms - 63113904000000.0)


# (UTC date, TAI-UTC seconds) from 1972, derived from the single canonical
# leap-second table in timeutil: TAI-UTC starts at 10 s on 1972-01-01 and
# grows by 1 at each insertion instant (the day after each listed day).
from auromat_tpu_torch.timeutil import _LEAP_SECOND_DAYS as _LS_DAYS

_LEAP_SECONDS = [(datetime(1972, 1, 1), 10)] + [
    (datetime(y, m, d) + timedelta(days=1), 11 + i)
    for i, (y, m, d) in enumerate(_LS_DAYS)
]


def _tai_minus_utc(dt: datetime) -> int:
    off = 10
    for d, v in _LEAP_SECONDS:
        if dt >= d:
            off = v
    return off


def datetime_to_tt2000(dt: datetime) -> int:
    """datetime (UTC) -> CDF_TIME_TT2000 (ns since J2000 TT)."""
    # TT = TAI + 32.184 s; J2000 = 2000-01-01T12:00:00 TT
    delta = dt - datetime(2000, 1, 1, 12)
    utc_ns = (delta.days * 86400 + delta.seconds) * 1_000_000_000 \
        + delta.microseconds * 1000
    return utc_ns + _tai_minus_utc(dt) * 1_000_000_000 + 32_184_000_000


def tt2000_to_datetime(ns: int) -> datetime:
    # invert approximately then fix the leap offset (stable away from the
    # exact leap-second instant, which datetime cannot represent anyway)
    approx = datetime(2000, 1, 1, 12) + timedelta(seconds=ns / 1e9)
    off = _tai_minus_utc(approx) + 32.184
    return datetime(2000, 1, 1, 12) + timedelta(seconds=(ns - off * 1e9) / 1e9)


# ---------------------------------------------------------------------------
# low-level helpers
# ---------------------------------------------------------------------------


def _pack_str(s: str, length: int) -> bytes:
    b = s.encode("ascii")[:length]
    return b + b"\x00" * (length - len(b))


class Var:
    def __init__(self, name, data, cdf_type, rec_vary, num_elems, dim_sizes,
                 attrs, pad=None):
        self.name = name
        self.data = data
        self.cdf_type = cdf_type
        self.rec_vary = rec_vary
        self.num_elems = num_elems
        self.dim_sizes = dim_sizes
        self.attrs = attrs
        self.pad = pad


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class CDFWriter:
    """Write a single-file CDF v3 (NETWORK encoding; row-major by default,
    majority="column" emits IDL-style Fortran-ordered records).

    Usage::

        with CDFWriter(path) as cdf:
            cdf.attrs["Project"] = "..."
            cdf.new("lat", arr2d[np.newaxis, ...])       # record-varying
            cdf.new("altitude", 110000.0, rec_vary=False)
            cdf.var_attrs("lat", UNITS="degrees")

    With ``compress=True`` variable values are written as gzip CVVR records
    (readable by this module and by the NASA library).
    """

    def __init__(self, path, compress=False, majority="row"):
        assert majority in ("row", "column")
        self.majority = majority
        self.path = path
        self.compress = compress
        self.attrs = {}
        self._vars = []
        self._var_by_name = {}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.close()

    def new(self, name, data, cdf_type=None, rec_vary=True, pad=None):
        """Add a zVariable. For rec_vary, axis 0 of ``data`` is the record
        axis. datetimes auto-convert to CDF_EPOCH (or pass
        cdf_type=CDF_TIME_TT2000)."""
        if isinstance(data, (list, tuple)) and data and isinstance(data[0], datetime):
            if cdf_type == CDF_TIME_TT2000:
                data = np.array([datetime_to_tt2000(d) for d in data], dtype=np.int64)
            else:
                cdf_type = CDF_EPOCH
                data = np.array([datetime_to_epoch(d) for d in data], dtype=np.float64)
        if np.ma.isMaskedArray(data):
            if data.dtype.kind != "f" and np.ma.getmaskarray(data).any():
                # filling masked integers with any in-range value silently
                # destroys the mask; callers must fill explicitly with a
                # recorded FILLVAL (export/cdf.py promotes the dtype for
                # exactly this)
                raise ValueError(
                    f"variable {name!r}: masked integer data has no NaN; "
                    "fill explicitly with a FILLVAL before new()"
                )
            data = data.filled(np.nan if data.dtype.kind == "f" else 0)
        data = np.asarray(data)
        num_elems = 1
        if data.dtype.kind == "U":
            data = np.char.encode(data, "ascii")
        if data.dtype.kind == "S":
            num_elems = data.dtype.itemsize
            cdf_type = cdf_type or CDF_CHAR
        if cdf_type is None:
            cdf_type = _NP_TO_CDF[data.dtype]
        if rec_vary:
            if data.ndim == 0:
                data = data[None]
            dim_sizes = list(data.shape[1:])
        else:
            dim_sizes = list(data.shape)
        v = Var(name, data, cdf_type, rec_vary, num_elems, dim_sizes, {}, pad)
        self._vars.append(v)
        self._var_by_name[name] = v
        return v

    def var_attrs(self, name, **attrs):
        self._var_by_name[name].attrs.update(attrs)

    # -- serialization helpers (each builds a full record given offsets)

    @staticmethod
    def _record(rtype, payload):
        return struct.pack(">qi", 12 + len(payload), rtype) + payload

    @staticmethod
    def _encode_value(value):
        """-> (cdf_type, num_elems, big-endian bytes)."""
        if isinstance(value, bool):
            value = int(value)
        if isinstance(value, bytes):
            value = value.decode("ascii", "replace")
        if isinstance(value, str):
            b = value.encode("ascii", "replace") or b" "
            return CDF_CHAR, len(b), b
        if isinstance(value, datetime):
            return CDF_EPOCH, 1, struct.pack(">d", datetime_to_epoch(value))
        arr = np.asarray(value)
        if arr.dtype.kind == "f":
            return CDF_REAL8, arr.size, arr.astype(">f8").tobytes()
        if arr.dtype.kind in "iu":
            return CDF_INT8, arr.size, arr.astype(">i8").tobytes()
        raise TypeError(f"unsupported attribute value {value!r}")

    def _var_bytes(self, v):
        base = _DTYPE_MAP[v.cdf_type]
        data = v.data
        if self.majority == "column" and data.ndim > 1:
            # Fortran element order WITHIN each record (leading axis =
            # records stays outermost), like IDL-written files
            rec_axes = tuple(range(data.ndim - 1, 0, -1))
            data = data.transpose((0,) + rec_axes)
            data = np.ascontiguousarray(data)
        if base == "S":
            return data.astype(f"S{v.num_elems}").tobytes()
        return data.astype(">" + base).tobytes()

    def _vdr(self, v, num, vdr_next, vxr_head, cpr_off=-1):
        n_recs = v.data.shape[0] if v.rec_vary else 1
        flags = (1 if v.rec_vary else 0) | (2 if v.pad is not None else 0)
        if self.compress:
            flags |= 4  # bit 2: variable compression (CPR present)
        n_dims = len(v.dim_sizes)
        pad_bytes = b""
        if v.pad is not None:
            pad_bytes = np.asarray(v.pad).astype(">" + _DTYPE_MAP[v.cdf_type]).tobytes()
        payload = (
            struct.pack(
                ">qiiqqiiiiiii",
                vdr_next,          # VDRnext
                v.cdf_type,        # DataType
                n_recs - 1,        # MaxRec
                vxr_head,          # VXRhead
                vxr_head,          # VXRtail
                flags,             # Flags
                0, 0, 0, -1,       # SRecords, rfuB, rfuC, rfuF
                v.num_elems,       # NumElems
                num,               # Num
            )
            + struct.pack(">q", cpr_off)  # CPRorSPRoffset (-1 = none)
            + struct.pack(">i", 0)   # BlockingFactor
            + _pack_str(v.name, 256)
            + struct.pack(">i", n_dims)
            + struct.pack(f">{n_dims}i", *v.dim_sizes)
            + struct.pack(f">{n_dims}i", *([-1] * n_dims))
            + pad_bytes
        )
        return self._record(zVDR_, payload)

    def _vxr(self, n_recs, vvr_offset):
        payload = (
            struct.pack(">qii", 0, 1, 1)     # VXRnext, Nentries, NusedEntries
            + struct.pack(">i", 0)            # First
            + struct.pack(">i", n_recs - 1)   # Last
            + struct.pack(">q", vvr_offset)   # Offset
        )
        return self._record(VXR_, payload)

    def _cpr(self):
        # cType 5 = GZIP, pCount 1, cParms[0] = level
        return self._record(CPR_, struct.pack(">iiii", 5, 0, 1, 6))

    def _vvr(self, data_bytes):
        if self.compress:
            # the CDF GZIP convention stores an RFC1952 gzip stream (the
            # NASA library and pypi cdflib call gzip on it); an earlier
            # version wrote raw zlib, unreadable outside this module
            comp = gzip.compress(data_bytes, 6)
            return self._record(CVVR_, struct.pack(">iq", 0, len(comp)) + comp)
        return self._record(VVR_, data_bytes)

    def _adr(self, name, num, scope, adr_next, aedr_head, n_entries, max_entry, is_z):
        payload = (
            struct.pack(">q", adr_next)
            + struct.pack(">q", 0 if is_z else aedr_head)      # AgrEDRhead
            + struct.pack(">iiii", scope, num,
                          0 if is_z else n_entries,            # NgrEntries
                          -1 if is_z else max_entry)           # MAXgrEntry
            + struct.pack(">i", 0)                             # rfuA
            + struct.pack(">q", aedr_head if is_z else 0)      # AzEDRhead
            + struct.pack(">iii",
                          n_entries if is_z else 0,            # NzEntries
                          max_entry if is_z else -1,           # MAXzEntry
                          0)                                   # rfuE
            + _pack_str(name, 256)
        )
        return self._record(ADR_, payload)

    def _aedr(self, attr_num, entry_num, value, aedr_next, is_z):
        t, n, b = self._encode_value(value)
        payload = (
            struct.pack(">q", aedr_next)
            + struct.pack(">iiiiiiiii", attr_num, t, entry_num, n,
                          1, 0, 0, 0, 0)  # NumStrings, rfuB..rfuE
            + b
        )
        return self._record(AzEDR_ if is_z else AgrEDR_, payload)

    def close(self):
        # attribute table: globals first, then variable attrs
        attr_list = [(k, GLOBAL_SCOPE, [(0, v)], False) for k, v in self.attrs.items()]
        var_attr_names = []
        for v in self._vars:
            for a in v.attrs:
                if a not in var_attr_names:
                    var_attr_names.append(a)
        for a in var_attr_names:
            entries = [(i, v.attrs[a]) for i, v in enumerate(self._vars) if a in v.attrs]
            attr_list.append((a, VARIABLE_SCOPE, entries, True))

        # VVR/CVVR records don't depend on offsets: build them once, not in
        # both passes (with compress=True that halves the gzip CPU time)
        vvr_recs = [self._vvr(self._var_bytes(v)) for v in self._vars]

        # two passes: first with zero offsets to learn sizes, then for real
        def build(offsets):
            (vdr_offs, cpr_offs, vxr_offs, vvr_offs, adr_offs, aedr_offs) = offsets
            recs = []
            flags = 0b0011 if self.majority == "row" else 0b0010
            # bit 0 = row major, bit 1 = single-file
            cdr_payload = (
                struct.pack(">q", offsets_gdr[0])
                + struct.pack(">iiiiiiiii", 3, 8, NETWORK_ENCODING, flags, 0, 0, 0, 2, 0)
                + _pack_str("auromat_tpu pure-python CDF writer", 256)
            )
            recs.append(self._record(CDR_, cdr_payload))
            gdr_payload = (
                struct.pack(">qqqq",
                            0,                                   # rVDRhead
                            vdr_offs[0] if vdr_offs else 0,      # zVDRhead
                            adr_offs[0] if adr_offs else 0,      # ADRhead
                            offsets_eof[0])                      # eof
                + struct.pack(">iiiii", 0, len(attr_list), -1, 0, len(self._vars))
                + struct.pack(">q", 0)                           # UIRhead
                + struct.pack(">iii", 0, -1, 0)                  # rfuC, LeapSecondLastUpdated, rfuE
            )
            recs.append(self._record(GDR_, gdr_payload))
            for i, v in enumerate(self._vars):
                nxt = vdr_offs[i + 1] if i + 1 < len(vdr_offs) else 0
                cpr = cpr_offs[i] if self.compress else -1
                recs.append(self._vdr(v, i, nxt, vxr_offs[i], cpr))
                if self.compress:
                    recs.append(self._cpr())
                n_recs = v.data.shape[0] if v.rec_vary else 1
                recs.append(self._vxr(n_recs, vvr_offs[i]))
                recs.append(vvr_recs[i])
            k = 0
            for ai, (name, scope, entries, is_z) in enumerate(attr_list):
                nxt = adr_offs[ai + 1] if ai + 1 < len(adr_offs) else 0
                head = aedr_offs[k] if entries else 0
                max_entry = max((n for n, _ in entries), default=-1)
                recs.append(self._adr(name, ai, scope, nxt, head, len(entries), max_entry, is_z))
                for ei, (num, value) in enumerate(entries):
                    nxt_e = aedr_offs[k + 1] if ei + 1 < len(entries) else 0
                    recs.append(self._aedr(ai, num, value, nxt_e, is_z))
                    k += 1
            return recs

        n_vars = len(self._vars)
        n_aedrs = sum(len(e) for _, _, e, _ in attr_list)
        zeros = ([0] * n_vars, [0] * n_vars, [0] * n_vars, [0] * n_vars,
                 [0] * len(attr_list), [0] * n_aedrs)
        offsets_gdr = [0]
        offsets_eof = [0]
        recs = build(zeros)
        # compute real offsets from sizes (record order is fixed)
        sizes = [len(r) for r in recs]
        pos = 8
        rec_offsets = []
        for sz in sizes:
            rec_offsets.append(pos)
            pos += sz
        offsets_eof[0] = pos
        offsets_gdr[0] = rec_offsets[1]
        vdr_offs, cpr_offs, vxr_offs, vvr_offs = [], [], [], []
        idx = 2
        for _ in self._vars:
            vdr_offs.append(rec_offsets[idx]); idx += 1
            if self.compress:
                cpr_offs.append(rec_offsets[idx]); idx += 1
            else:
                cpr_offs.append(-1)
            vxr_offs.append(rec_offsets[idx]); idx += 1
            vvr_offs.append(rec_offsets[idx]); idx += 1
        adr_offs, aedr_offs = [], []
        for name, scope, entries, is_z in attr_list:
            adr_offs.append(rec_offsets[idx]); idx += 1
            for _ in entries:
                aedr_offs.append(rec_offsets[idx]); idx += 1
        recs = build((vdr_offs, cpr_offs, vxr_offs, vvr_offs, adr_offs,
                      aedr_offs))
        with open(self.path, "wb") as f:
            f.write(struct.pack(">II", 0xCDF30001, 0x0000FFFF))
            for r in recs:
                f.write(r)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


class CDFVariable:
    def __init__(self, name, data, cdf_type, rec_vary, attrs):
        self.name = name
        self.data = data
        self.cdf_type = cdf_type
        self.rec_vary = rec_vary
        self.attrs = attrs

    def __getitem__(self, idx):
        return self.data[idx]

    @property
    def shape(self):
        return self.data.shape


class CDFReader:
    """Read a CDF v3 file: variables + attributes, eagerly materialised."""

    def __init__(self, path):
        with open(path, "rb") as f:
            raw = f.read()
        magic1, magic2 = struct.unpack(">II", raw[:8])
        if magic1 not in (0xCDF30001, 0xCDF26002):
            raise ValueError(f"not a CDF v2.6+/3 file: {magic1:#x}")
        self._v3 = magic1 == 0xCDF30001
        if magic2 == 0xCCCC0001:
            # compressed CDF: CCR wraps the remainder
            size, rtype = self._rec_header(raw, 8)
            assert rtype == CCR_
            if self._v3:
                cpr_off, usize = struct.unpack(">qq", raw[20:36])
                data = raw[36 + 4 : 8 + size]
            else:
                cpr_off, usize = struct.unpack(">ii", raw[16:24])
                data = raw[24 + 4 : 8 + size]
            raw = raw[:8] + self._gunzip(data)
        self.raw = raw
        self.variables = {}
        self.attrs = {}
        self._var_attr_entries = []
        self._parse()

    @staticmethod
    def _gunzip(data):
        try:
            return gzip.decompress(data)
        except Exception:
            return zlib.decompress(data)

    def _rec_header(self, raw, off):
        if self._v3:
            return struct.unpack(">qi", raw[off : off + 12])
        size, rtype = struct.unpack(">ii", raw[off : off + 8])
        return size, rtype

    def _i(self, off):
        """Offset-sized int at off (8 bytes v3, 4 bytes v2)."""
        if self._v3:
            return struct.unpack(">q", self.raw[off : off + 8])[0]
        return struct.unpack(">i", self.raw[off : off + 4])[0]

    @property
    def _osz(self):
        return 8 if self._v3 else 4

    def _parse(self):
        raw = self.raw
        osz = self._osz
        hdr = 12 if self._v3 else 8
        # CDR
        cdr_off = 8
        gdr_off = self._i(cdr_off + hdr)
        enc_off = cdr_off + hdr + osz + 8
        self.encoding = struct.unpack(">i", raw[enc_off : enc_off + 4])[0]
        self._le = self.encoding in _LITTLE_ENDIAN_ENCODINGS
        cdr_flags = struct.unpack(">i", raw[enc_off + 4 : enc_off + 8])[0]
        # CDR flags bit 0: 1 = row major (C order); 0 = column major
        # (Fortran order — IDL-written files, e.g. the real THEMIS archive)
        self.row_major = bool(cdr_flags & 1)
        # GDR
        p = gdr_off + hdr
        rvdr_head = self._i(p); p += osz
        zvdr_head = self._i(p); p += osz
        adr_head = self._i(p); p += osz
        p += osz  # eof
        # fixed GDR fields: NrVars, NumAttr, rMaxRec, rNumDims, NzVars
        _, _, _, r_num_dims, _ = struct.unpack(">iiiii", raw[p : p + 20])
        p += 20
        p += osz  # UIRhead
        p += 4 * 3  # rfuC, LeapSecondLastUpdated, rfuE
        # rDimSizes follow the fixed fields (sizes of ALL rVariables)
        self._gdr_r_dims = list(struct.unpack(
            f">{r_num_dims}i", raw[p : p + 4 * r_num_dims])) if r_num_dims else []
        # walk zVDRs (and rVDRs if present, treated the same way)
        for head, is_z in ((zvdr_head, True), (rvdr_head, False)):
            off = head
            while off:
                off = self._parse_vdr(off, is_z)
        # attributes
        off = adr_head
        while off:
            off = self._parse_adr(off)
        # attach variable attrs: rVariable (grEntry) and zVariable (zEntry)
        # numbering are INDEPENDENT namespaces both starting at 0, so the
        # key must include which chain the entry came from
        by_num = {(v._is_z, v._num): v for v in self.variables.values()}
        for attr_name, entry_is_z, num, value in self._var_attr_entries:
            if (entry_is_z, num) in by_num:
                by_num[(entry_is_z, num)].attrs[attr_name] = value

    def _np_dtype(self, cdf_type, num_elems):
        base = _DTYPE_MAP[cdf_type]
        if base == "S":
            return np.dtype(f"S{num_elems}")
        return np.dtype(("<" if self._le else ">") + base)

    def _parse_vdr(self, off, is_z):
        raw = self.raw
        hdr = 12 if self._v3 else 8
        osz = self._osz
        p = off + hdr
        vdr_next = self._i(p); p += osz
        data_type = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
        max_rec = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
        vxr_head = self._i(p); p += osz
        p += osz  # VXRtail
        flags = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
        s_records = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
        p += 4 * 3  # rfuB, rfuC, rfuF
        num_elems = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
        num = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
        p += osz  # CPRorSPRoffset
        p += 4  # blocking factor
        # the Name field is 256 bytes since CDF 3.0, 64 bytes in 2.x
        nsz = 256 if self._v3 else 64
        name = raw[p : p + nsz].split(b"\x00")[0].decode("ascii"); p += nsz
        if s_records:
            # sparse records leave gaps in the record index space; the
            # contiguous concatenation below would silently misplace data
            raise NotImplementedError(
                f"variable {name!r} uses sparse records (SRecords="
                f"{s_records})")
        if is_z:
            n_dims = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
            dim_sizes = list(struct.unpack(f">{n_dims}i", raw[p : p + 4 * n_dims]))
            p += 4 * n_dims
            dim_varys = list(struct.unpack(f">{n_dims}i", raw[p : p + 4 * n_dims]))
            p += 4 * n_dims
        else:
            dim_sizes = []
            dim_varys = []
        rec_vary = bool(flags & 1)
        n_recs = max_rec + 1
        dtype = self._np_dtype(data_type, num_elems)
        eff_dims = [s for s, vy in zip(dim_sizes, dim_varys) if vy] if dim_sizes else []
        rec_items = int(np.prod(eff_dims)) if eff_dims else 1

        chunks = []
        vxr_off = vxr_head
        while vxr_off:
            vxr_off = self._parse_vxr(vxr_off, chunks)
        data = b"".join(
            self._record_data(off_, first, last, rec_items, dtype)
            for first, last, off_ in chunks
        )
        if not is_z and dim_sizes == [] and self._gdr_r_dims:
            # dimensioned rVariables would need the GDR rDimSizes + this
            # VDR's dim variances to decode; fail loudly instead of
            # silently misreading (zVariables cover every modern file)
            raise NotImplementedError(
                f"rVariable {name!r} with GDR rDimSizes="
                f"{self._gdr_r_dims} is not supported")
        if n_recs <= 0:
            arr = np.zeros((0,) + tuple(eff_dims), dtype=dtype)
        else:
            arr = np.frombuffer(data, dtype=dtype, count=n_recs * rec_items)
            if eff_dims and not self.row_major:
                # column-major records: elements are Fortran-ordered
                arr = arr.reshape(
                    (n_recs,) + tuple(reversed(eff_dims))
                ).transpose((0,) + tuple(range(len(eff_dims), 0, -1)))
            else:
                arr = arr.reshape((n_recs,) + tuple(eff_dims))
        if not rec_vary:
            arr = arr[0] if n_recs else arr
        if dtype.kind != "S":
            arr = arr.astype(dtype.newbyteorder("="))
        var = CDFVariable(name, arr, data_type, rec_vary, {})
        var._num = num
        var._is_z = is_z
        self.variables[name] = var
        return vdr_next

    def _parse_vxr(self, off, chunks):
        raw = self.raw
        hdr = 12 if self._v3 else 8
        osz = self._osz
        p = off + hdr
        vxr_next = self._i(p); p += osz
        n_entries, n_used = struct.unpack(">ii", raw[p : p + 8]); p += 8
        firsts = struct.unpack(f">{n_entries}i", raw[p : p + 4 * n_entries])
        p += 4 * n_entries
        lasts = struct.unpack(f">{n_entries}i", raw[p : p + 4 * n_entries])
        p += 4 * n_entries
        if self._v3:
            offs = struct.unpack(f">{n_entries}q", raw[p : p + 8 * n_entries])
        else:
            offs = struct.unpack(f">{n_entries}i", raw[p : p + 4 * n_entries])
        for i in range(n_used):
            chunks.append((firsts[i], lasts[i], offs[i]))
        return vxr_next

    def _record_data(self, off, first, last, rec_items, dtype):
        raw = self.raw
        hdr = 12 if self._v3 else 8
        size, rtype = self._rec_header(raw, off)
        if rtype == VVR_:
            return raw[off + hdr : off + size]
        if rtype == CVVR_:
            p = off + hdr + 4  # rfuA
            csize = self._i(p)
            p += self._osz
            return self._gunzip(raw[p : p + csize])
        if rtype == VXR_:
            # nested index record
            chunks = []
            self._parse_vxr(off, chunks)
            return b"".join(
                self._record_data(o, f, l, rec_items, dtype) for f, l, o in chunks
            )
        raise ValueError(f"unexpected record type {rtype} at {off}")

    def _parse_adr(self, off):
        raw = self.raw
        hdr = 12 if self._v3 else 8
        osz = self._osz
        p = off + hdr
        adr_next = self._i(p); p += osz
        agr_head = self._i(p); p += osz
        scope = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
        p += 4  # num
        p += 4  # NgrEntries
        p += 4  # MAXgrEntry
        p += 4  # rfuA
        az_head = self._i(p); p += osz
        p += 4  # NzEntries
        p += 4  # MAXzEntry
        p += 4  # rfuE
        nsz = 256 if self._v3 else 64  # 64-byte Name field in CDF 2.x
        name = raw[p : p + nsz].split(b"\x00")[0].decode("ascii")
        for head, entry_is_z in ((agr_head, False), (az_head, True)):
            e_off = head
            while e_off:
                e_off = self._parse_aedr(e_off, name, scope, entry_is_z)
        return adr_next

    def _parse_aedr(self, off, attr_name, scope, entry_is_z):
        raw = self.raw
        hdr = 12 if self._v3 else 8
        osz = self._osz
        size, _ = self._rec_header(raw, off)
        p = off + hdr
        nxt = self._i(p); p += osz
        p += 4  # attr num
        data_type = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
        num = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
        num_elems = struct.unpack(">i", raw[p : p + 4])[0]; p += 4
        p += 4 * 5  # NumStrings + rfus
        value_bytes = raw[p : off + size]
        dtype = self._np_dtype(data_type, num_elems)
        if dtype.kind == "S":
            value = value_bytes[: num_elems].decode("ascii", "replace").rstrip("\x00")
        else:
            value = np.frombuffer(value_bytes, dtype=dtype, count=num_elems)
            value = value.astype(dtype.newbyteorder("="))
            if value.size == 1:
                value = value[0].item()
        if scope == GLOBAL_SCOPE:
            if attr_name in self.attrs:
                prev = self.attrs[attr_name]
                self.attrs[attr_name] = (prev if isinstance(prev, list) else [prev]) + [value]
            else:
                self.attrs[attr_name] = value
        else:
            self._var_attr_entries.append((attr_name, entry_is_z, num, value))
        return nxt

    def __getitem__(self, name):
        return self.variables[name]

    def __contains__(self, name):
        return name in self.variables
