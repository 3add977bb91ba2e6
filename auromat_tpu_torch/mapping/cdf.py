"""Re-import provider for CDF files written by ``export.cdf`` (of this
package or of the JAX package: the files are the same).

Counterpart of ``auromat_tpu.mapping.cdf``, over this package's ``io.cdflib``;
the mapping's arrays are host numpy, as the exported ones are.

Mirrors auromat/mapping/cdf.py: Epoch -> (path, record) index, FILLVAL ->
mask/dtype reconstruction, corner grids from *_bounds.
"""

import os
from datetime import datetime

import numpy as np

from auromat_tpu_torch.io import cdflib
from auromat_tpu_torch.mapping.mapping import BaseMappingProvider, Mapping

_UNPROMOTE = {
    np.dtype(np.int16): np.uint8,
    np.dtype(np.int32): np.uint16,
    np.dtype(np.int64): np.uint32,
}


def _epoch_datetime(cdf, rec=0) -> datetime:
    epoch = cdf["Epoch"]
    val = epoch[rec]
    if epoch.cdf_type == cdflib.CDF_TIME_TT2000:
        return cdflib.tt2000_to_datetime(int(val))
    return cdflib.epoch_to_datetime(float(val))


def read_mapping(path, identifier=None, record=0):
    """Read one exported CDF file back into a Mapping."""
    cdf = cdflib.CDFReader(path)
    photo_time = _epoch_datetime(cdf, record)
    altitude = float(np.asarray(cdf["altitude"].data)) / 1000.0
    camera_pos = np.asarray(cdf["camera_pos"][record], dtype=np.float64)

    lats_c = np.array(cdf["lat"][record], dtype=np.float64)
    lons_c = np.array(cdf["lon"][record], dtype=np.float64)
    if "lat_bounds" in cdf:
        lats = np.array(cdf["lat_bounds"][record], dtype=np.float64)
        lons = np.array(cdf["lon_bounds"][record], dtype=np.float64)
    else:
        raise ValueError("CDF without corner bounds cannot be re-imported")

    bands = [b for b in ("img", "img_red", "img_green", "img_blue") if b in cdf]
    channels = []
    mask = np.zeros(lats_c.shape, dtype=bool)
    target_dtype = None
    for b in bands:
        var = cdf[b]
        data = np.array(var[record])
        fill = var.attrs.get("FILLVAL")
        if fill is not None:
            mask |= data == fill
            target_dtype = _UNPROMOTE.get(data.dtype, data.dtype)
        else:
            target_dtype = data.dtype
        channels.append(data)
    img = np.stack(channels, axis=-1)
    img = np.where(mask[..., None], 0, img).astype(target_dtype)

    elevation = None
    if "zenith_angle" in cdf:
        elevation = 90.0 - np.array(cdf["zenith_angle"][record], dtype=np.float64)
    if elevation is not None:
        elevation[mask] = np.nan
    else:
        # no elevation channel: carry the mask through the centre coords
        lats_c[mask] = np.nan
        lons_c[mask] = np.nan

    metadata = {
        k: (v.decode() if isinstance(v, bytes) else v)
        for k, v in cdf.attrs.items()
        if not k.startswith("geospatial")
    }
    mapping = Mapping(
        lats, lons, lats_c, lons_c, elevation, altitude, img, camera_pos,
        photo_time, identifier or os.path.splitext(os.path.basename(path))[0],
        metadata=metadata,
    )
    if "mlat" in cdf:
        import numpy.ma as ma

        cm = mapping.center_mask
        mlat_c = np.array(cdf["mlat"][record], dtype=np.float64)
        mlt_c = np.array(cdf["mlt"][record], dtype=np.float64)
        mapping._mlatmlt_center = (
            ma.masked_array(mlat_c, cm), ma.masked_array(mlt_c, cm),
        )
        if "mlat_bounds" in cdf:
            km = mapping.corner_mask
            mlat = np.array(cdf["mlat_bounds"][record], dtype=np.float64)
            mlt = np.array(cdf["mlt_bounds"][record], dtype=np.float64)
            mapping._mlatmlt = (ma.masked_array(mlat, km), ma.masked_array(mlt, km))
    return mapping


class CDFMappingProvider(BaseMappingProvider):
    """Provider over a directory of exported .cdf files."""

    def __init__(self, directory, maxTimeOffset=3):
        super().__init__(maxTimeOffset)
        self.directory = directory
        self._index = None

    def _build_index(self):
        if self._index is None:
            entries = []
            for f in sorted(os.listdir(self.directory)):
                if not f.endswith(".cdf"):
                    continue
                path = os.path.join(self.directory, f)
                cdf = cdflib.CDFReader(path)
                for rec in range(cdf["Epoch"].data.shape[0]):
                    entries.append(
                        {"id": os.path.splitext(f)[0], "path": path,
                         "time": _epoch_datetime(cdf, rec), "rec": rec}
                    )
            entries.sort(key=lambda e: e["time"])
            self._index = entries
        return self._index

    @property
    def range(self):
        idx = self._build_index()
        if not idx:
            raise ValueError("no .cdf files found")
        return idx[0]["time"], idx[-1]["time"]

    def contains(self, date):
        return any(
            abs((e["time"] - date).total_seconds()) <= self.maxTimeOffset
            for e in self._build_index()
        )

    def get(self, date):
        idx = self._build_index()
        best = min(idx, key=lambda e: abs((e["time"] - date).total_seconds()))
        if abs((best["time"] - date).total_seconds()) > self.maxTimeOffset:
            raise ValueError(f"no mapping within maxTimeOffset of {date}")
        return read_mapping(best["path"], best["id"], best["rec"])

    def getById(self, identifier):
        for e in self._build_index():
            if e["id"] == identifier:
                return read_mapping(e["path"], e["id"], e["rec"])
        raise ValueError(f"no mapping with identifier {identifier!r}")

    def getSequence(self, dateBegin=None, dateEnd=None):
        for e in self._build_index():
            if dateBegin is not None and e["time"] < dateBegin:
                continue
            if dateEnd is not None and e["time"] > dateEnd:
                continue
            yield read_mapping(e["path"], e["id"], e["rec"])
