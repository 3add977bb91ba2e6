"""CDF export of mappings following the ISTP/IACG guidelines.

Mirrors the reference's variable schema exactly (auromat/export/cdf.py:61-285):
Epoch (TT2000 or EPOCH), lat/lon centres + *_bounds corners (record axis 0 of
length 1), altitude, mlat/mlt (+bounds) with the 'mcrs' pole container,
img or img_red/green/blue with dtype-promoting FILLVAL masking, zenith_angle
(= 90 - elevation), camera_pos, and the 'crs' WGS84 container.
"""

import numpy as np

from auromat_tpu_torch.coordinates.frames import north_geomagnetic_pole_location
from auromat_tpu_torch.io import cdflib

IMG_DTYPE_MAP = {
    np.dtype(np.uint8): np.int16,  # no overhead vs separate mask
    np.dtype(np.uint16): np.int32,
    np.dtype(np.uint32): np.int64,
}


def write(output_path, mapping, metadata=None, includeBounds=True,
          includeMagCoords=True, includeGeoCoords=True, compress=True,
          useTT2000=True):
    """Export a mapping to a self-contained CDF file.

    :param metadata: extra global attributes (override mapping.metadata);
        see the ISTP global-attribute guide for common keys
    :param useTT2000: CDF_TIME_TT2000 Epoch (else CDF_EPOCH)
    """
    with cdflib.CDFWriter(output_path, compress=compress) as root:
        meta = dict(mapping.metadata)
        meta.update(metadata or {})
        for k, v in meta.items():
            if isinstance(v, bool):
                v = int(v)
            root.attrs[k] = v
        bb = mapping.boundingBox
        root.attrs["geospatial_lat_min"] = bb.latSouth
        root.attrs["geospatial_lat_max"] = bb.latNorth
        root.attrs["geospatial_lon_min"] = bb.lonWest
        root.attrs["geospatial_lon_max"] = bb.lonEast
        root.attrs["geospatial_lat_units"] = "degrees_north"
        root.attrs["geospatial_lon_units"] = "degrees_east"

        epoch_type = cdflib.CDF_TIME_TT2000 if useTT2000 else cdflib.CDF_EPOCH
        root.new("Epoch", [mapping.photoTime], cdf_type=epoch_type)
        root.var_attrs("Epoch", VAR_TYPE="support_data")

        def coord_var(name, data, fieldnam, units, vmin, vmax, crs, notes=None,
                      bounds=None, depend=("y_pixel", "x_pixel")):
            # raw data, not filled: a resampled mapping's regular coordinate
            # grids stay regular under the mask (mask is carried by the img
            # FILLVAL / zenith_angle NaNs)
            root.new(name, np.ma.getdata(data)[np.newaxis, :])
            attrs = dict(
                VAR_TYPE="data", DEPEND_0="Epoch", DEPEND_1=depend[0],
                DEPEND_2=depend[1], UNITS=units, VALIDMIN=vmin, VALIDMAX=vmax,
                FIELDNAM=fieldnam, crs=crs,
            )
            if notes is not None:
                attrs["VAR_NOTES"] = notes
            if bounds is not None:
                attrs["bounds"] = bounds
            root.var_attrs(name, **attrs)

        if includeGeoCoords:
            coord_var("lat", mapping.latsCenter, "Latitude of pixel center",
                      "degrees", -90.0, 90.0, "crs", "Geodetic latitude",
                      bounds="lat_bounds" if includeBounds else None)
            coord_var("lon", mapping.lonsCenter, "Longitude of pixel center",
                      "degrees", -180.0, 180.0, "crs", "Geodetic longitude",
                      bounds="lon_bounds" if includeBounds else None)
            if includeBounds:
                coord_var("lat_bounds", mapping.lats, "Latitude of pixel corner",
                          "degrees", -90.0, 90.0, "crs", "Geodetic latitude",
                          depend=("y_corner", "x_corner"))
                coord_var("lon_bounds", mapping.lons, "Longitude of pixel corner",
                          "degrees", -180.0, 180.0, "crs", "Geodetic longitude",
                          depend=("y_corner", "x_corner"))

        root.new("altitude", np.float64(mapping.altitude * 1000), rec_vary=False)
        root.var_attrs("altitude", VAR_TYPE="support_data", UNITS="meters",
                       FIELDNAM="Height above reference ellipsoid", crs="crs")

        if includeMagCoords:
            mlats_c, mlts_c = mapping.mLatMltCenter
            coord_var("mlat", mlats_c, "Geomagnetic latitude of pixel center",
                      "degrees", -90.0, 90.0, "mcrs",
                      bounds="mlat_bounds" if includeBounds else None)
            coord_var("mlt", mlts_c, "Magnetic local time of pixel center",
                      "hours", 0.0, 24.0, "mcrs",
                      bounds="mlt_bounds" if includeBounds else None)
            if includeBounds:
                mlats, mlts = mapping.mLatMlt
                coord_var("mlat_bounds", mlats,
                          "Geomagnetic latitude of pixel corner", "degrees",
                          -90.0, 90.0, "mcrs", depend=("y_corner", "x_corner"))
                coord_var("mlt_bounds", mlts,
                          "Magnetic local time of pixel corner", "hours",
                          0.0, 24.0, "mcrs", depend=("y_corner", "x_corner"))
            pole_lat, pole_lon = north_geomagnetic_pole_location(mapping.photoTime)
            root.new("mcrs", np.int8(0), rec_vary=False)
            root.var_attrs(
                "mcrs", VAR_TYPE="support_data",
                north_geomagnetic_pole_lat=pole_lat,
                north_geomagnetic_pole_lon=pole_lon,
                VAR_NOTES="Geocentric MLat/MLT system based on the given "
                          "geomagnetic pole position",
            )

        img_src = mapping.img
        if np.any(np.ma.getmaskarray(img_src)):
            if img_src.dtype not in IMG_DTYPE_MAP:
                raise NotImplementedError(f"image dtype {img_src.dtype}")
            img_dtype = IMG_DTYPE_MAP[img_src.dtype]
            fillval = img_dtype(np.iinfo(img_dtype).min)
            img_ = img_src.astype(img_dtype).filled(fillval)
        else:
            img_dtype = img_src.dtype
            fillval = None
            img_ = np.asarray(img_src.data)

        if img_.shape[2] == 1:
            bands = ["img"]
        elif img_.shape[2] == 3:
            bands = ["img_red", "img_green", "img_blue"]
        else:
            raise NotImplementedError
        for i, band in enumerate(bands):
            root.new(band, img_[np.newaxis, :, :, i])
            attrs = dict(
                VAR_TYPE="data", DEPEND_0="Epoch", DEPEND_1="y_pixel",
                DEPEND_2="x_pixel", FIELDNAM="",
                VALIDMIN=int(np.iinfo(img_src.dtype).min),
                VALIDMAX=int(np.iinfo(img_src.dtype).max),
                UNITS="unitless",
            )
            if fillval is not None:
                attrs["FILLVAL"] = int(fillval)
            root.var_attrs(band, **attrs)

        if mapping.elevation is not None:
            zena = (90 - mapping.elevation).astype(np.float32)
            root.new("zenith_angle", np.ma.filled(zena, np.nan)[np.newaxis, :])
            root.var_attrs(
                "zenith_angle", VAR_TYPE="data", DEPEND_0="Epoch",
                DEPEND_1="y_pixel", DEPEND_2="x_pixel", UNITS="degrees",
                VALIDMIN=0.0, VALIDMAX=90.0,
                FIELDNAM="Absolute sensor zenith angle of pixel center",
            )
        # mappings re-imported from files without zenith_angle carry
        # elevation=None -> skip the variable (re-import restores None)

        root.new("camera_pos", np.asarray(mapping.cameraPosGCRS)[np.newaxis, :])
        root.var_attrs(
            "camera_pos", VAR_TYPE="support_data", DEPEND_0="Epoch",
            UNITS="kilometers",
            FIELDNAM="Camera position in cartesian GCRS coordinates",
            VAR_NOTES="Axis order: xyz",
        )

        root.new("crs", np.int8(0), rec_vary=False)
        root.var_attrs(
            "crs", VAR_TYPE="support_data", semi_major_axis=6378137.0,
            inverse_flattening=298.257223563,
            VAR_NOTES="Geographic Coordinate System, WGS 84",
        )
