"""First three IGRF Gauss coefficients (g01, g11, h11) per 5-year epoch.

These define the centred-dipole geomagnetic pole used for the MLat/MLT
coordinate system. Reference: auromat/coordinates/igrf.py:25-53; the
coefficient values themselves are the public IGRF model data (epochs
1900..2020, the last epoch extrapolated via secular variation).
"""

import numpy as np

# fmt: off
G01 = np.array([
    -31543, -31464, -31354, -31212, -31060, -30926, -30805, -30715,
    -30654, -30594, -30554, -30500, -30421, -30334, -30220, -30100,
    -29992, -29873, -29775, -29692, -29619.4, -29554.63, -29496.5,
    -29442, -29390.5], dtype=np.float64)

G11 = np.array([
    -2298, -2298, -2297, -2306, -2317, -2318, -2316, -2306, -2292, -2285,
    -2250, -2215, -2169, -2119, -2068, -2013, -1956, -1905, -1848, -1784,
    -1728.2, -1669.05, -1585.9, -1501, -1410.5], dtype=np.float64)

H11 = np.array([
    5922, 5909, 5898, 5875, 5845, 5817, 5808, 5812, 5821, 5810, 5815,
    5820, 5791, 5776, 5737, 5675, 5604, 5500, 5406, 5306, 5186.1, 5077.99,
    4944.26, 4797.1, 4664.1], dtype=np.float64)
# fmt: on

NUM_EPOCHS = len(G01)
FIRST_YEAR = 1900
DEFINED_UNTIL_YEAR = FIRST_YEAR + (NUM_EPOCHS - 1) * 5


def _interp(table: np.ndarray, frac_year_index: float, frac_year: float) -> float:
    if frac_year_index >= NUM_EPOCHS - 1:
        raise ValueError(
            "date is beyond the IGRF coefficient table (defined until %d); "
            "update auromat_tpu_torch.coordinates.igrf" % DEFINED_UNTIL_YEAR
        )
    lo = int(np.floor(frac_year_index))
    hi = int(np.ceil(frac_year_index))
    return float(table[lo] * (1.0 - frac_year) + table[hi] * frac_year)


def g01(frac_year_index: float, frac_year: float) -> float:
    return _interp(G01, frac_year_index, frac_year)


def g11(frac_year_index: float, frac_year: float) -> float:
    return _interp(G11, frac_year_index, frac_year)


def h11(frac_year_index: float, frac_year: float) -> float:
    return _interp(H11, frac_year_index, frac_year)
