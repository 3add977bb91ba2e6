"""Physical and geodetic constants.

Mirrors the constants the reference derives from geographiclib/astropy
(reference: auromat/coordinates/geodesic.py:20-21, mapping/mapping.py:1503).
All lengths are in kilometres, matching the reference's unit convention.
"""

# WGS84 ellipsoid (geographiclib Constants.WGS84_a / WGS84_f)
WGS84_F = 1.0 / 298.257223563  # flattening
WGS84_A = 6378.137  # equatorial radius, km
WGS84_B = WGS84_A * (1.0 - WGS84_F)  # polar radius, km

# IAU Earth radius used for the 'sphere' earth model
# (reference uses astropy const.R_earth = nominal IAU 2015 equatorial radius)
EARTH_RADIUS = 6378.1366  # km

# Default auroral emission altitude in km (reference default, e.g.
# auromat/mapping/spacecraft.py getMapping(altitude=110))
DEFAULT_EMISSION_ALTITUDE = 110.0

# Seconds per Julian day / days per Julian century
SECONDS_PER_DAY = 86400.0
DAYS_PER_JULIAN_CENTURY = 36525.0

# J2000.0 epoch as Julian date
JD_J2000 = 2451545.0
