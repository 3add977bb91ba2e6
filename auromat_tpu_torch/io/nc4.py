"""Minimal NetCDF-4 (HDF5) read/write layer on h5py (a copy of
``auromat_tpu.io.nc4``; h5py is imported where it is used).

The reference writes NETCDF4 with zlib compression + GDAL-friendly chunking
(reference export/netcdf.py:62-117); the netCDF4 C library is not a
dependency, h5py is — and NetCDF-4 is HDF5 with a small set of
conventions (dimension scales, ``_NCProperties``), so files written here are
readable by the netCDF4/h5netcdf/GDAL stacks and vice versa.

The writer mimics the subset of the ``scipy.io.netcdf_file`` API the export
layer uses (``createDimension``/``createVariable``/attribute assignment), so
:mod:`auromat_tpu_torch.export.netcdf` can target either container format.
"""

import numpy as np

_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"

# compress only payloads where gzip actually pays for its header/CPU
_COMPRESS_MIN_BYTES = 4096


def is_hdf5(path):
    """True if the file at path is an HDF5 container (NetCDF-4)."""
    try:
        with open(path, "rb") as f:
            return f.read(8) == _HDF5_MAGIC
    except OSError:
        return False


def _phony_dim_name(n):
    # the exact string the netCDF-4 library writes for dims without a
    # coordinate variable (required for it to list the dimension)
    return np.bytes_(
        "This is a netCDF dimension but not a netCDF variable."
        + f" {n:10d}"
    )


class Nc4Variable:
    """Write handle for one variable; attribute assignment -> HDF5 attrs."""

    __slots__ = ("_nc4_ds",)

    def __init__(self, ds):
        object.__setattr__(self, "_nc4_ds", ds)

    def __setitem__(self, key, value):
        self._nc4_ds[key] = value

    def __getitem__(self, key):
        return self._nc4_ds[key]

    def __setattr__(self, name, value):
        self._nc4_ds.attrs[name] = value

    def __getattr__(self, name):
        try:
            return self._nc4_ds.attrs[name]
        except KeyError:
            raise AttributeError(name)


class Nc4Writer:
    """NetCDF-4 writer with zlib compression (scipy-netcdf_file-like API)."""

    def __init__(self, path, complevel=4, compress=True):
        import h5py

        object.__setattr__(self, "_nc4_h5", h5py.File(path, "w"))
        object.__setattr__(self, "_nc4_dims", {})
        object.__setattr__(self, "_nc4_complevel", int(complevel))
        object.__setattr__(self, "_nc4_compress", bool(compress))
        self._nc4_h5.attrs["_NCProperties"] = np.bytes_(
            "version=2,auromat_tpu=1"
        )

    def createDimension(self, name, size):
        import h5py

        ds = self._nc4_h5.create_dataset(name, shape=(size,), dtype="f4")
        ds.make_scale(name)
        # netCDF-4 marks dims without a coordinate variable with this NAME
        ds.attrs["NAME"] = _phony_dim_name(size)
        ds.attrs["_Netcdf4Dimid"] = np.int32(len(self._nc4_dims))
        self._nc4_dims[name] = ds

    def createVariable(self, name, dtype, dims, zlib=True, chunksizes=None):
        shape = tuple(self._nc4_dims[d].shape[0] for d in dims)
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        kwargs = {}
        if chunksizes:
            # explicit chunk layout applies regardless of compression
            kwargs["chunks"] = tuple(chunksizes)
        if zlib and self._nc4_compress and nbytes >= _COMPRESS_MIN_BYTES:
            kwargs.update(
                compression="gzip",
                compression_opts=self._nc4_complevel,
                shuffle=True,
            )
            kwargs.setdefault("chunks", True)
        is_coord = dims == (name,) and name in self._nc4_dims
        if is_coord:
            # COORDINATE variable (shares its dimension's name, the CF
            # association convention): replace the placeholder scale with
            # the real dataset, which becomes the dimension scale itself
            dimid = self._nc4_dims[name].attrs.get("_Netcdf4Dimid",
                                                   np.int32(0))
            del self._nc4_h5[name]
        ds = self._nc4_h5.create_dataset(name, shape=shape, dtype=dtype,
                                         **kwargs)
        if is_coord:
            ds.make_scale(name)
            ds.attrs["_Netcdf4Dimid"] = dimid
            self._nc4_dims[name] = ds
            return Nc4Variable(ds)
        for i, d in enumerate(dims):
            ds.dims[i].attach_scale(self._nc4_dims[d])
        return Nc4Variable(ds)

    def __setattr__(self, name, value):
        if name.startswith("_nc4_"):
            object.__setattr__(self, name, value)
        else:
            self._nc4_h5.attrs[name] = value

    def close(self):
        self._nc4_h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Nc4Reader:
    """Reader exposing the subset of scipy.io.netcdf_file the re-import
    provider uses: ``.variables`` dict, per-variable attrs, ``_attributes``.
    """

    def __init__(self, path):
        import h5py

        self._h5 = h5py.File(path, "r")
        self.variables = {}
        for name, ds in self._h5.items():
            if not hasattr(ds, "attrs"):
                continue
            nm = ds.attrs.get("NAME")
            if isinstance(nm, bytes) and nm.startswith(
                b"This is a netCDF dimension"
            ):
                continue  # placeholder dimension scale, not a variable
            self.variables[name] = Nc4Variable(ds)

    @property
    def _attributes(self):
        out = {}
        for k, v in self._h5.attrs.items():
            if isinstance(v, np.generic):
                v = v.item()
            out[k] = v
        return out

    def close(self):
        self._h5.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
