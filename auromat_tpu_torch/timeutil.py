"""Host-side time-scale arithmetic.

The reference uses astropy.time.Time to obtain Julian dates
(reference: auromat/coordinates/transform.py:525-532). astropy is not a
dependency here; UTC datetime -> JD is plain calendar arithmetic
(Fliegel & Van Flandern algorithm), which matches astropy's UTC ``jd``
attribute to well below a millisecond for modern dates.
"""

from datetime import datetime, timedelta, timezone

from auromat_tpu_torch.constants import JD_J2000, SECONDS_PER_DAY


def julian_date(t: datetime) -> float:
    """UTC datetime -> Julian date (float days)."""
    if t.tzinfo is not None:
        t = t.astimezone(timezone.utc).replace(tzinfo=None)
    y, m = t.year, t.month
    if m <= 2:
        y -= 1
        m += 12
    a = y // 100
    b = 2 - a + a // 4
    jd0 = int(365.25 * (y + 4716)) + int(30.6001 * (m + 1)) + t.day + b - 1524.5
    frac = (
        t.hour + (t.minute + (t.second + t.microsecond / 1e6) / 60.0) / 60.0
    ) / 24.0
    return jd0 + frac


def ephemeris_seconds(t: datetime) -> float:
    """UTC datetime -> seconds since the J2000.0 epoch.

    Reference: auromat/coordinates/transform.py:525-532 (``date2es``).
    """
    return (julian_date(t) - JD_J2000) * SECONDS_PER_DAY


def julian_centuries_since_j2000(et: float) -> float:
    """Ephemeris seconds -> Julian centuries since J2000.0 (``T0`` in Hapgood)."""
    return (et / SECONDS_PER_DAY) / 36525.0


def hours_since_midnight(et: float) -> float:
    """Ephemeris seconds -> hours since the preceding UT midnight.

    Reference: auromat/coordinates/transform.py:541-551 (``H``).
    """
    jd = (et / SECONDS_PER_DAY) - 0.5
    dfrac = jd - int(jd)
    hh = dfrac * 24.0
    if hh < 0.0:
        hh += 24.0
    return hh


def datetime_from_julian_date(jd: float) -> datetime:
    """Julian date -> UTC datetime (inverse of :func:`julian_date`)."""
    # offset from the Unix epoch in days
    days = jd - 2440587.5
    return datetime(1970, 1, 1) + timedelta(days=days)


def fractional_year_index(et: float) -> tuple:
    """Ephemeris seconds -> (index, fraction) into the 5-year IGRF epochs.

    The IGRF tables start at 1900; 157788000 s is five Julian years.
    Reference: auromat/coordinates/transform.py:497-523.
    """
    frac_year_index = (et + 3155803200.0) / 157788000.0
    frac_year = frac_year_index % 1.0
    return frac_year_index, frac_year


def parse_cli_date(s):
    """Parse the CLI date formats shared by auromat-download/convert
    (raises argparse.ArgumentTypeError so both parsers report it nicely)."""
    import argparse
    from datetime import datetime

    for fmt in ("%Y-%m-%dT%H:%M:%S", "%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            return datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise argparse.ArgumentTypeError(f"unparseable date {s!r}")


def naive_epoch(dt):
    """Timezone-independent seconds-since-1970 for NAIVE datetimes.

    datetime.timestamp() interprets naive values in the HOST timezone and
    is non-monotonic across DST transitions — fatal for searchsorted-based
    nearest-frame lookups over sorted date lists. Timezone-aware inputs are
    converted to UTC first (callers of the providers this replaced
    .timestamp() in may pass aware dates).
    """
    from datetime import datetime, timezone

    if dt.tzinfo is not None:
        dt = dt.astimezone(timezone.utc).replace(tzinfo=None)
    return (dt - datetime(1970, 1, 1)).total_seconds()


# UTC leap-second insertion instants (end of listed day, IERS Bulletin C).
# The list is complete through 2016-12-31; no further leap seconds have been
# scheduled, and CGPM voted (2022) to abandon them by 2035.
# CANONICAL table: io.cdflib derives its TAI-UTC offsets from this list.
_LEAP_SECOND_DAYS = (
    (1972, 6, 30), (1972, 12, 31), (1973, 12, 31), (1974, 12, 31),
    (1975, 12, 31), (1976, 12, 31), (1977, 12, 31), (1978, 12, 31),
    (1979, 12, 31), (1981, 6, 30), (1982, 6, 30), (1983, 6, 30),
    (1985, 6, 30), (1987, 12, 31), (1989, 12, 31), (1990, 12, 31),
    (1992, 6, 30), (1993, 6, 30), (1994, 6, 30), (1995, 12, 31),
    (1997, 6, 30), (1998, 12, 31), (2005, 12, 31), (2008, 12, 31),
    (2012, 6, 30), (2015, 6, 30), (2016, 12, 31),
)


def contains_leap_second(d1, d2):
    """True if the UTC range [d1, d2] contains a leap-second insertion.

    Offline equivalent of the reference's astropy-based check
    (auromat/util/time.py:7-20), using the static IERS table above instead
    of astropy's ERFA tables. The insertion instant is taken as the end of
    the listed UTC day (the 23:59:60 second). Naive datetimes are
    interpreted as UTC; tz-aware datetimes are converted.
    """
    # normalize BEFORE comparing: mixed naive/aware operands cannot be
    # ordered and would raise TypeError in the swap
    if d1.tzinfo is not None:
        d1 = d1.astimezone(timezone.utc).replace(tzinfo=None)
    if d2.tzinfo is not None:
        d2 = d2.astimezone(timezone.utc).replace(tzinfo=None)
    if d2 < d1:
        d1, d2 = d2, d1
    for y, m, d in _LEAP_SECOND_DAYS:
        # the inserted second is 23:59:60, i.e. the second ENDING at this
        # instant: a range starting exactly at the instant excludes it
        instant = datetime(y, m, d) + timedelta(days=1)
        if d1 < instant <= d2:
            return True
    return False


# reference API alias (auromat/util/time.py:7)
containsLeapSecond = contains_leap_second
