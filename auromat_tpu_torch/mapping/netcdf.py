"""Re-import provider for netCDF files written by ``export.netcdf`` (of
this package or of the JAX package: the files are the same).

Counterpart of ``auromat_tpu.mapping.netcdf``: NETCDF4 through this
package's ``io.nc4`` (h5py, imported where used), NETCDF3 through
``scipy.io.netcdf_file``.

Mirrors auromat/mapping/netcdf.py: reconstructs Mappings (including 2D
corner grids from 1D plate-carree bounds) and provides get/getById/
getSequence over a directory of .nc files.
"""

import os
from datetime import datetime, timedelta

import numpy as np

from auromat_tpu_torch.mapping.mapping import BaseMappingProvider, Mapping


def _corners_from_bounds1d(bounds):
    """(n, 2) vertex bounds -> (n+1,) corner coordinates."""
    return np.concatenate([bounds[:, 0], bounds[-1:, 1]])


def _open_nc(path):
    """Open either container format: NetCDF-4/HDF5 (h5py) or classic."""
    from auromat_tpu_torch.io.nc4 import Nc4Reader, is_hdf5

    if is_hdf5(path):
        return Nc4Reader(path)
    from scipy.io import netcdf_file

    return netcdf_file(path, "r", mmap=False)


def read_mapping(path, identifier=None):
    """Read one netCDF file back into a Mapping."""
    with _open_nc(path) as f:
        v = f.variables
        photo_time = datetime(1970, 1, 1) + timedelta(seconds=float(v["time"][0]))
        altitude = float(v["altitude"][0]) / 1000.0
        camera_pos = np.array(v["camera_pos"][:], dtype=np.float64)

        lat = np.array(v["lat"][:], dtype=np.float64)
        lon = np.array(v["lon"][:], dtype=np.float64)
        plate_carree = lat.ndim == 1
        if plate_carree:
            lats_c = np.broadcast_to(lat[:, None], (len(lat), len(lon))).copy()
            lons_c = np.broadcast_to(lon[None, :], (len(lat), len(lon))).copy()
            if "lat_bounds" in v:
                lat_corner = _corners_from_bounds1d(np.array(v["lat_bounds"][:]))
                lon_corner = _corners_from_bounds1d(np.array(v["lon_bounds"][:]))
            else:
                dlat = lat[1] - lat[0]
                dlon = lon[1] - lon[0]
                lat_corner = np.concatenate([lat - dlat / 2, [lat[-1] + dlat / 2]])
                lon_corner = np.concatenate([lon - dlon / 2, [lon[-1] + dlon / 2]])
            lats = np.broadcast_to(
                lat_corner[:, None], (len(lat_corner), len(lon_corner))
            ).copy()
            lons = np.broadcast_to(
                lon_corner[None, :], (len(lat_corner), len(lon_corner))
            ).copy()
        else:
            lats_c, lons_c = lat, lon
            if "lat_bounds" not in v:
                raise ValueError("2D coordinates require *_bounds variables")
            lat_b = np.array(v["lat_bounds"][:])
            lon_b = np.array(v["lon_bounds"][:])
            h, w = lat_b.shape[:2]
            lats = np.full((h + 1, w + 1), np.nan)
            lons = np.full((h + 1, w + 1), np.nan)
            # vertex order: (y,x), (y,x+1), (y+1,x+1), (y+1,x)
            lats[:-1, :-1] = lat_b[:, :, 0]
            lats[:-1, 1:] = np.where(np.isnan(lats[:-1, 1:]), lat_b[:, :, 1], lats[:-1, 1:])
            lats[1:, 1:] = np.where(np.isnan(lats[1:, 1:]), lat_b[:, :, 2], lats[1:, 1:])
            lats[1:, :-1] = np.where(np.isnan(lats[1:, :-1]), lat_b[:, :, 3], lats[1:, :-1])
            lons[:-1, :-1] = lon_b[:, :, 0]
            lons[:-1, 1:] = np.where(np.isnan(lons[:-1, 1:]), lon_b[:, :, 1], lons[:-1, 1:])
            lons[1:, 1:] = np.where(np.isnan(lons[1:, 1:]), lon_b[:, :, 2], lons[1:, 1:])
            lons[1:, :-1] = np.where(np.isnan(lons[1:, :-1]), lon_b[:, :, 3], lons[1:, :-1])

        bands = [b for b in ("img", "img_red", "img_green", "img_blue") if b in v]
        channels = []
        fill = None
        for b in bands:
            var = v[b]
            data = np.array(var[:])
            fill = getattr(var, "_FillValue", None)
            channels.append(data)
        img = np.stack(channels, axis=-1)
        masked = np.zeros(img.shape[:2], dtype=bool)
        if fill is not None:
            masked = (img == fill).any(axis=-1)
        # undo the signed-type promotion (reference mapping/cdf.py:164-183)
        if img.dtype == np.int16:
            img_u = np.where(masked[..., None], 0, img).astype(np.uint8)
        elif img.dtype == np.int32:
            img_u = np.where(masked[..., None], 0, img).astype(np.uint16)
        else:
            img_u = img

        elevation = None
        if "zenith_angle" in v:
            zena = np.array(v["zenith_angle"][:], dtype=np.float64)
            elevation = 90.0 - zena
        lats_c = lats_c.copy()
        lons_c = lons_c.copy()
        if elevation is not None:
            elevation[masked] = np.nan
        else:
            lats_c[masked] = np.nan
            lons_c[masked] = np.nan

        metadata = {}
        for k, val in getattr(f, "_attributes", {}).items():
            if k.startswith("geospatial") or k == "Conventions" or k.startswith("_"):
                continue
            if isinstance(val, bytes):
                val = val.decode()
            if isinstance(val, (str, int, float)):
                metadata[k] = val

        mapping = Mapping(
            lats, lons, lats_c, lons_c, elevation, altitude, img_u, camera_pos,
            photo_time, identifier or os.path.splitext(os.path.basename(path))[0],
            metadata=metadata,
        )
        if "mlat" in v:
            import numpy.ma as ma

            mlat_c = np.array(v["mlat"][:], dtype=np.float64)
            mlt_c = np.array(v["mlt"][:], dtype=np.float64)
            if mlat_c.ndim == 1:
                mlat_c = np.broadcast_to(mlat_c[:, None], lats_c.shape).copy()
                mlt_c = np.broadcast_to(mlt_c[None, :], lats_c.shape).copy()
            cm = mapping.center_mask
            mapping._mlatmlt_center = (
                ma.masked_array(mlat_c, cm), ma.masked_array(mlt_c, cm),
            )
        return mapping


class NetCDFMappingProvider(BaseMappingProvider):
    """Provider over a directory of exported .nc files."""

    def __init__(self, directory, maxTimeOffset=3):
        super().__init__(maxTimeOffset)
        self.directory = directory
        self._index = None

    def _build_index(self):
        if self._index is None:
            entries = []
            for f in sorted(os.listdir(self.directory)):
                if not f.endswith(".nc"):
                    continue
                path = os.path.join(self.directory, f)
                with _open_nc(path) as nc:
                    t = datetime(1970, 1, 1) + timedelta(
                        seconds=float(nc.variables["time"][0])
                    )
                entries.append({"id": os.path.splitext(f)[0], "path": path, "time": t})
            entries.sort(key=lambda e: e["time"])
            self._index = entries
        return self._index

    @property
    def range(self):
        idx = self._build_index()
        if not idx:
            raise ValueError("no .nc files found")
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
        return read_mapping(best["path"], best["id"])

    def getById(self, identifier):
        for e in self._build_index():
            if e["id"] == identifier:
                return read_mapping(e["path"], e["id"])
        raise ValueError(f"no mapping with identifier {identifier!r}")

    def getSequence(self, dateBegin=None, dateEnd=None):
        for e in self._build_index():
            if dateBegin is not None and e["time"] < dateBegin:
                continue
            if dateEnd is not None and e["time"] > dateEnd:
                continue
            yield read_mapping(e["path"], e["id"])
