"""netCDF export of mappings, following CF-1.6 / NODC conventions.

Mirrors the reference's variable schema (auromat/export/netcdf.py:48-351):
time, lat/lon (1D coordinate variables + vertex2 bounds when the grid is
plate carree, else 2D auxiliary coordinates + vertex4 bounds), altitude,
mlat/mlt (+bounds) with the 'mcrs' geomagnetic-pole container, img or
img_red/green/blue with dtype-promoted fill values, zenith_angle
(= 90 - elevation), camera_pos, and the 'crs' WGS84 container.

Container format: NetCDF-4 (HDF5 via h5py, zlib-compressed + chunked like
the reference's NETCDF4 output, export/netcdf.py:115-117) by default, or
NetCDF-3 classic (scipy.io.netcdf_file, uncompressed) with format="NETCDF3".
"""

from datetime import datetime

import numpy as np

from auromat_tpu_torch.coordinates.frames import north_geomagnetic_pole_location
from auromat_tpu_torch.mapping.mapping import is_plate_carree

IMG_DTYPE_MAP = {
    np.dtype(np.uint8): np.int16,
    np.dtype(np.uint16): np.int32,
}


def _unix(dt: datetime) -> float:
    return (dt - datetime(1970, 1, 1)).total_seconds()


def _bounds1d(arr):
    arr = np.asarray(arr)[:, None]
    return np.concatenate((arr[:-1], arr[1:]), axis=1)


def _bounds2d(arr):
    arr = np.asarray(arr)[:, :, None]
    return np.concatenate(
        (arr[:-1, :-1], arr[:-1, 1:], arr[1:, 1:], arr[1:, :-1]), axis=2
    )


def write(output_path, mapping, metadata=None, includeBounds=True,
          includeMagCoords=True, includeGeoCoords=True, use1dIfPossible=True,
          compress=True, format="NETCDF4", complevel=4):
    """Export a mapping to a self-contained netCDF file.

    :param metadata: extra root attributes (override mapping.metadata)
    :param compress: zlib-compress variables (NETCDF4 only)
    :param format: "NETCDF4" (HDF5, compressed, the reference's format) or
        "NETCDF3" (classic, via scipy; no compression)
    """
    if not includeGeoCoords:
        raise ValueError("geodetic coordinates are essential to netCDF export")

    if format == "NETCDF4":
        from auromat_tpu_torch.io.nc4 import Nc4Writer

        def open_file():
            return Nc4Writer(output_path, complevel=complevel,
                             compress=compress)
    elif format == "NETCDF3":
        from scipy.io import netcdf_file

        def open_file():
            return netcdf_file(output_path, "w", version=2)
    else:
        raise ValueError(f"unknown netCDF format {format!r}")

    mlats_c = mlts_c = None
    lat_lon_pc = use1dIfPossible and is_plate_carree(mapping.lats, mapping.lons)
    if includeMagCoords:
        mlats_c, mlts_c = mapping.mLatMltCenter
        mlat_mlt_pc = use1dIfPossible and is_plate_carree(*mapping.mLatMlt)
    else:
        mlat_mlt_pc = None

    h, w = mapping.img.shape[0], mapping.img.shape[1]

    with open_file() as root:
        root.Conventions = "CF-1.6"
        meta = dict(mapping.metadata)
        meta.update(metadata or {})
        for k, v in meta.items():
            if isinstance(v, bool):
                v = np.uint8(v)
            setattr(root, k, v)
        bb = mapping.boundingBox
        root.geospatial_lat_min = bb.latSouth
        root.geospatial_lat_max = bb.latNorth
        root.geospatial_lon_min = bb.lonWest
        root.geospatial_lon_max = bb.lonEast
        root.geospatial_lat_units = "degrees_north"
        root.geospatial_lon_units = "degrees_east"

        # plate-carree dims share the coordinate variables' names so CF
        # tooling auto-associates img(lat, lon) with the 1-D coordinates
        if lat_lon_pc:
            root.createDimension("lat", h)
            root.createDimension("lon", w)
        if mlat_mlt_pc:
            root.createDimension("mlat", h)
            root.createDimension("mlt", w)
        if not lat_lon_pc or mlat_mlt_pc is False:
            root.createDimension("y", h)
            root.createDimension("x", w)
        if includeBounds:
            if lat_lon_pc or mlat_mlt_pc:
                root.createDimension("vertex2", 2)
            if not lat_lon_pc or mlat_mlt_pc is False:
                root.createDimension("vertex4", 4)
        # no variable uses 'channel' (bands are separate 2D variables) —
        # kept because the reference's schema creates it too (ref
        # export/netcdf.py:92) and re-importers may key on the dim list
        root.createDimension("channel", mapping.img.shape[2])
        root.createDimension("xyz", 3)
        root.createDimension("scalar", 1)

        def scalar_var(name, dtype):
            v = root.createVariable(name, dtype, ("scalar",))
            return v

        time = scalar_var("time", np.float64)
        time.units = b"seconds since 1970-01-01 00:00:00"
        time.calendar = b"gregorian"
        time.standard_name = b"time"
        time.axis = b"T"
        time[:] = _unix(mapping.photoTime)

        if lat_lon_pc:
            lats_c = mapping.latsCenter.data[:, 0]
            lons_c = mapping.lonsCenter.data[0, :]
            lat = root.createVariable("lat", np.float64, ("lat",))
            lat[:] = lats_c
            lat.actual_range = np.float64([lats_c[-1], lats_c[0]])
            lon = root.createVariable("lon", np.float64, ("lon",))
            lon[:] = lons_c
            lon.actual_range = np.float64([lons_c[0], lons_c[-1]])
        else:
            lat = root.createVariable("lat", np.float64, ("y", "x"))
            lat[:] = np.ma.getdata(mapping.latsCenter)
            lat.actual_range = np.float64(
                [np.min(mapping.latsCenter), np.max(mapping.latsCenter)]
            )
            lon = root.createVariable("lon", np.float64, ("y", "x"))
            lon[:] = np.ma.getdata(mapping.lonsCenter)
            lon.actual_range = np.float64(
                [np.min(mapping.lonsCenter), np.max(mapping.lonsCenter)]
            )
        lat.units = b"degrees_north"
        lat.valid_min, lat.valid_max = np.float64(-90), np.float64(90)
        lat.standard_name = b"latitude"
        lat.axis = b"Y"
        lat.comment = b"Geodetic latitude"
        lon.units = b"degrees_east"
        lon.valid_min, lon.valid_max = np.float64(-180), np.float64(180)
        lon.standard_name = b"longitude"
        lon.axis = b"X"
        lon.comment = b"Geodetic longitude"

        altitude = scalar_var("altitude", np.int32)
        altitude.units = b"meters"
        altitude.standard_name = b"height_above_reference_ellipsoid"
        altitude.axis = b"Z"
        altitude[:] = int(mapping.altitude * 1000)

        if includeBounds:
            lat.bounds = b"lat_bounds"
            lon.bounds = b"lon_bounds"
            if lat_lon_pc:
                lat_b = root.createVariable("lat_bounds", np.float64, ("lat", "vertex2"))
                lat_b[:] = _bounds1d(mapping.lats.data[:, 0])
                lon_b = root.createVariable("lon_bounds", np.float64, ("lon", "vertex2"))
                lon_b[:] = _bounds1d(mapping.lons.data[0, :])
            else:
                lat_b = root.createVariable("lat_bounds", np.float64, ("y", "x", "vertex4"))
                lat_b[:] = _bounds2d(mapping.lats.filled(np.nan))
                lon_b = root.createVariable("lon_bounds", np.float64, ("y", "x", "vertex4"))
                lon_b[:] = _bounds2d(mapping.lons.filled(np.nan))

        if includeMagCoords:
            if mlat_mlt_pc:
                mlat = root.createVariable("mlat", np.float64, ("mlat",))
                mlat[:] = mlats_c.data[:, 0]
                mlt = root.createVariable("mlt", np.float64, ("mlt",))
                mlt[:] = mlts_c.data[0, :]
            else:
                mlat = root.createVariable("mlat", np.float64, ("y", "x"))
                mlat[:] = mlats_c.filled(np.nan)
                mlt = root.createVariable("mlt", np.float64, ("y", "x"))
                mlt[:] = mlts_c.filled(np.nan)
            mlat.long_name = b"Geomagnetic latitude"
            mlat.units = b"degrees"
            mlat.valid_min, mlat.valid_max = np.float64(-90), np.float64(90)
            mlat.crs = b"mcrs"
            mlt.long_name = b"Magnetic local time"
            mlt.units = b"hours"
            mlt.valid_min, mlt.valid_max = np.float64(0), np.float64(24)
            mlt.crs = b"mcrs"

            if includeBounds:
                mlat.bounds = b"mlat_bounds"
                mlt.bounds = b"mlt_bounds"
                mlats, mlts = mapping.mLatMlt
                if mlat_mlt_pc:
                    mb = root.createVariable("mlat_bounds", np.float64, ("mlat", "vertex2"))
                    mb[:] = _bounds1d(mlats.data[:, 0])
                    tb = root.createVariable("mlt_bounds", np.float64, ("mlt", "vertex2"))
                    tb[:] = _bounds1d(mlts.data[0, :])
                else:
                    mb = root.createVariable("mlat_bounds", np.float64, ("y", "x", "vertex4"))
                    mb[:] = _bounds2d(mlats.filled(np.nan))
                    tb = root.createVariable("mlt_bounds", np.float64, ("y", "x", "vertex4"))
                    tb[:] = _bounds2d(mlts.filled(np.nan))

            pole_lat, pole_lon = north_geomagnetic_pole_location(mapping.photoTime)
            mcrs = scalar_var("mcrs", np.int8)
            mcrs[:] = 0
            mcrs.north_geomagnetic_pole_lat = pole_lat
            mcrs.north_geomagnetic_pole_lon = pole_lon
            mcrs.comment = b"Geocentric MLat/MLT system based on the given geomagnetic pole position"

        # data variables
        y = "lat" if lat_lon_pc else "y"
        x = "lon" if lat_lon_pc else "x"
        img_src = mapping.img
        if img_src.dtype not in IMG_DTYPE_MAP:
            raise NotImplementedError(f"image dtype {img_src.dtype}")
        img_dtype = IMG_DTYPE_MAP[img_src.dtype]
        fillval = np.iinfo(img_dtype).min
        img_filled = img_src.astype(img_dtype).filled(fillval)
        bands = (
            ["img"] if img_filled.shape[2] == 1
            else ["img_red", "img_green", "img_blue"]
        )
        if img_filled.shape[2] not in (1, 3):
            raise NotImplementedError
        for i, band in enumerate(bands):
            var = root.createVariable(band, img_dtype, (y, x))
            var._FillValue = img_dtype(fillval)
            var.units = b"unitless"
            var.valid_min = img_dtype(np.iinfo(img_src.dtype).min)
            var.valid_max = img_dtype(np.iinfo(img_src.dtype).max)
            ch = img_src[:, :, i]
            if ch.count() > 0:  # fully masked channel: np.min returns
                # ma.masked and np.array(...) raises MaskError
                var.actual_range = np.array(
                    [np.min(ch), np.max(ch)], dtype=img_dtype)
            var.coordinates = (
                b"altitude time" if lat_lon_pc else b"lat lon altitude time"
            )
            var.grid_mapping = b"crs"
            var[:] = img_filled[:, :, i]

        if mapping.elevation is not None:
            zena = 90 - mapping.elevation
            za = root.createVariable("zenith_angle", np.float32, (y, x))
            za.units = b"degrees"
            za.valid_min, za.valid_max = np.float32(0), np.float32(90)
            if zena.count() > 0:
                za.actual_range = np.float32([np.min(zena), np.max(zena)])
            za.standard_name = b"zenith_angle"
            za.long_name = b"Absolute sensor zenith angle"
            za.coordinates = (b"altitude time" if lat_lon_pc
                              else b"lat lon altitude time")
            za.grid_mapping = b"crs"
            za[:] = zena.filled(np.nan).astype(np.float32)
        # elevation=None (source file had no zenith_angle): skip the var

        cam = root.createVariable("camera_pos", np.float64, ("xyz",))
        cam.units = b"kilometers"
        cam.long_name = b"Camera position in cartesian GCRS coordinates"
        cam.comment = b"Axis order: xyz"
        cam[:] = mapping.cameraPosGCRS

        crs = scalar_var("crs", np.int8)
        crs[:] = 0
        crs.grid_mapping_name = b"latitude_longitude"
        crs.semi_major_axis = 6378137.0
        crs.inverse_flattening = 298.257223563
        crs.comment = b"Geographic Coordinate System, WGS 84"
