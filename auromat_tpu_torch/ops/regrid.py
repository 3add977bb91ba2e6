"""Plate-carree regridding: the fixed global grid and its bin indices.

Counterpart of ``auromat_tpu.ops.regrid``: the host-side grid definition
(:class:`GridSpec`, :func:`fixed_grid`), the per-sample bin index
(:func:`bin_indices`), the final divide (:func:`finalize_mean`), and the
float64 mean binning with the reference's NaN-taint semantics
(:func:`bin_mean`, :func:`bin_partial`). The kernels that bin are K1
(:mod:`auromat_tpu_torch.ops.georegrid`) and K2/K3
(:mod:`auromat_tpu_torch.ops.regrid_pallas`).

The all-sky-imager path's device functions are plain torch on the
tensors' device, as they are plain XLA (not Pallas) in the JAX package:
per-cell winners (:func:`bin_take_best`, :func:`plan_take_best` +
:func:`apply_take_best`, and the seeding of :func:`bin_nearest`) come from
one stable sort of packed (cell, float32) int64 keys, the nearest-sample
grid from a jump flood, and the structured interpolators
(:func:`interp_linear_structured`, :func:`interp_cubic_structured`) from a
Newton inversion of the pixel mesh.

Grid alignment: all resamplings share one global grid per resolution
(reference resample.py:281-299 ``fixedGrid``) so mosaics line up cell-exact.
"""

from dataclasses import dataclass

import numpy as np
import torch


def round_up(x, m):
    """Smallest multiple of m >= x (tile/window padding helper)."""
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class GridSpec:
    """A fixed plate-carree grid (host-side).

    Latitudes DEcrease along rows (north at row 0), longitudes increase along
    columns — the reference's output orientation (resample.py:228-237).
    ``lat0``/``lon0`` are the *centre* coordinates of the first (north-west)
    cell; ``lat_step`` is positive.
    """

    n_lat: int
    n_lon: int
    lat0: float
    lon0: float
    lat_step: float
    lon_step: float

    @property
    def lat_centers(self):
        return self.lat0 - np.arange(self.n_lat) * self.lat_step

    @property
    def lon_centers(self):
        return self.lon0 + np.arange(self.n_lon) * self.lon_step

    @property
    def lat_corners(self):
        return self.lat0 + self.lat_step / 2 - np.arange(self.n_lat + 1) * self.lat_step

    @property
    def lon_corners(self):
        return self.lon0 - self.lon_step / 2 + np.arange(self.n_lon + 1) * self.lon_step

    def corner_grids(self):
        """(lats, lons) 2D corner arrays of shape (n_lat+1, n_lon+1)."""
        return np.meshgrid(self.lon_corners, self.lat_corners)[::-1]

    def center_grids(self):
        return np.meshgrid(self.lon_centers, self.lat_centers)[::-1]


def fixed_grid(px_per_deg, lat_min, lat_max, lon_min, lon_max):
    """Align a bounding box to the global fixed grid; return a GridSpec.

    Semantics follow the reference exactly (auromat/resample.py:281-299 plus
    the first/last trimming at resample.py:229-237): the returned grid's
    *centre* rows/columns are the global grid lines strictly inside the
    aligned box (first and last alignment line dropped).

    :param px_per_deg: (lat_px_per_deg, lon_px_per_deg) or a scalar
    :param lon_min, lon_max: must NOT contain the discontinuity
    """
    try:
        lat_ppd, lon_ppd = px_per_deg
    except TypeError:
        lat_ppd = lon_ppd = float(px_per_deg)
    assert lat_ppd > 0 and lon_ppd > 0

    n_lat_all = int(round(lat_ppd * 180 + 1))
    n_lon_all = int(round(lon_ppd * 360 + 1))
    lat_all = np.linspace(-90, 90, n_lat_all)
    lon_all = np.linspace(-180, 180, n_lon_all)
    lat_lo = lat_all[np.argmax(lat_all > lat_min) - 1]
    lat_hi = lat_all[np.argmax(lat_all >= lat_max)]
    lon_lo = lon_all[np.argmax(lon_all > lon_min) - 1]
    lon_hi = lon_all[np.argmax(lon_all >= lon_max)]
    n_lat = int(round(lat_ppd * (lat_hi - lat_lo) + 1))
    n_lon = int(round(lon_ppd * (lon_hi - lon_lo) + 1))
    assert n_lat > 2 and n_lon > 2, (n_lat, n_lon)

    # canonical global steps (identical for every bbox at this resolution,
    # unlike the reference's per-bbox linspace retstep which carries float
    # jitter in the last ulps, resample.py:229-230)
    lat_step = 180.0 / (n_lat_all - 1)
    lon_step = 360.0 / (n_lon_all - 1)
    # drop the outermost centre lines (reference resample.py:232-237)
    return GridSpec(
        n_lat=n_lat - 2,
        n_lon=n_lon - 2,
        lat0=lat_hi - lat_step,
        lon0=lon_lo + lon_step,
        lat_step=lat_step,
        lon_step=lon_step,
    )


def bin_indices(grid: GridSpec, lats, lons):
    """Flat bin index per sample; out-of-range/NaN -> n_bins (dump slot).

    Bin edges are centre +- step/2, matching the reference's histogram2d
    ranges (resample.py:330-338). Following numpy histogram semantics the
    right-most edge is inclusive.

    The cell arithmetic runs in float64 with true division whatever the
    dtype of ``lats``/``lons``: that is what the JAX package computes
    (``fixed_grid``'s float64 edges promote its f32 coordinates under x64),
    and it is the only form that puts every f32 sample in the same cell.
    Validity is decided on the float values, so a NaN, inf or out-of-range
    coordinate is never cast to int32.

    :returns: (flat int32, valid bool), both shaped like ``lats``
    """
    lat_hi_edge = grid.lat0 + grid.lat_step / 2
    lon_lo_edge = grid.lon0 - grid.lon_step / 2
    fy = (lat_hi_edge - lats.double()) / grid.lat_step
    fx = (lons.double() - lon_lo_edge) / grid.lon_step
    iy = torch.floor(fy)
    ix = torch.floor(fx)
    # inclusive right-most edge: clamp samples exactly on the far edge
    iy = torch.where(fy == grid.n_lat, grid.n_lat - 1.0, iy)
    ix = torch.where(fx == grid.n_lon, grid.n_lon - 1.0, ix)
    # NaN fails every comparison; +-inf fails the range test
    valid = (iy >= 0) & (iy < grid.n_lat) & (ix >= 0) & (ix < grid.n_lon)
    flat = torch.where(valid, iy * grid.n_lon + ix, grid.n_lat * grid.n_lon)
    return flat.to(torch.int32), valid


def finalize_mean(count, sums):
    """Divide reduced partial sums by counts; NaN where empty."""
    c = count[..., None]
    return torch.where(c > 0, sums / c, torch.nan)


def _bin_sum_index_add(flat_idx, data, n_bins):
    """(n_bins, 1 + C) float64 [count, channel sums]: one ``index_add_``,
    with the invalid samples (``flat_idx == n_bins``) in a dropped slot."""
    vals = torch.cat([torch.ones_like(data[:, :1]), data], dim=1)
    acc = torch.zeros(n_bins + 1, vals.shape[1], dtype=torch.float64,
                      device=data.device)
    acc.index_add_(0, flat_idx.long(), vals)
    return acc[:-1]


# The JAX package's binning methods (segment sums, a scatter, and three
# sort + compensated-prefix-sum variants) exist because a TPU serializes
# scatter-adds. A GPU adds in place, so every method name is the same plain
# float64 index_add_; the names stay so that callers' code runs unchanged.
_BIN_METHODS = {name: _bin_sum_index_add for name in (
    "segment", "scatter", "sorted", "sorted_gather", "sorted_packed")}


def _flat_samples(grid, lats, lons, data):
    n_ch = data.shape[-1]
    flat_idx, valid = bin_indices(grid, lats.reshape(-1), lons.reshape(-1))
    flat_data = data.reshape(-1, n_ch).to(torch.float64)
    # zero out data of invalid samples so the dropped slot stays finite
    return flat_idx, torch.where(valid[:, None], flat_data, 0.0)


def bin_mean(grid: GridSpec, lats, lons, data, method="sorted"):
    """Mean-bin multi-channel samples onto the grid (float64 sums).

    :param lats, lons: sample coordinates (any shape), NaN = masked
    :param data: (..., C) channel values per sample. NaN data at VALID
        coordinates taints its bin's mean in that channel only (numpy
        bincount/histogram2d semantics, which the reference relies on: it
        bins img+elevation filled with NaN). NaNs are zeroed and binned
        alongside per-channel taint indicator channels.
    :param method: any name of ``_BIN_METHODS``
    :returns: (count (n_lat, n_lon), means (n_lat, n_lon, C)), in the
        promotion of ``data``'s dtype and float32; means are NaN where
        count == 0
    """
    fn = _BIN_METHODS[method]
    n_ch = data.shape[-1]
    out_dtype = torch.promote_types(data.dtype, torch.float32)
    flat_idx, flat_data = _flat_samples(grid, lats, lons, data)
    taint = torch.isnan(flat_data)
    flat_data = torch.cat([torch.where(taint, 0.0, flat_data),
                           taint.to(torch.float64)], dim=1)
    acc = fn(flat_idx, flat_data, grid.n_lat * grid.n_lon)
    count = acc[:, 0].reshape(grid.n_lat, grid.n_lon)
    sums = acc[:, 1:1 + n_ch].reshape(grid.n_lat, grid.n_lon, n_ch)
    taints = acc[:, 1 + n_ch:].reshape(grid.n_lat, grid.n_lon, n_ch)
    means = torch.where(taints > 0, torch.nan, finalize_mean(count, sums))
    return count.to(out_dtype), means.to(out_dtype)


def bin_partial(grid: GridSpec, lats, lons, data, method="segment"):
    """Per-shard partial accumulation: (count, sums) without the divide.

    NaN data at valid coordinates is treated as 0 here (partial sums must
    stay finite for a cross-shard reduction); use :func:`bin_mean` for the
    reference's NaN-taint semantics.

    ``method='pallas'`` goes to the K2 binning kernel
    (:func:`auromat_tpu_torch.ops.regrid_pallas.bin_partial_pallas2`,
    (h, w) inputs, 'uint8' channel contract). Any other method name sums
    in float64 and returns the promotion of ``data``'s dtype and float32.
    """
    if method == "pallas":
        from auromat_tpu_torch.ops.regrid_pallas import bin_partial_pallas2

        return bin_partial_pallas2(grid, lats, lons, data, "uint8")
    fn = _BIN_METHODS[method]
    n_ch = data.shape[-1]
    out_dtype = torch.promote_types(data.dtype, torch.float32)
    flat_idx, flat_data = _flat_samples(grid, lats, lons, data)
    flat_data = torch.where(torch.isnan(flat_data), 0.0, flat_data)
    acc = fn(flat_idx, flat_data, grid.n_lat * grid.n_lon)
    count = acc[:, 0].reshape(grid.n_lat, grid.n_lon)
    sums = acc[:, 1:].reshape(grid.n_lat, grid.n_lon, n_ch)
    return count.to(out_dtype), sums.to(out_dtype)


# ---------------------------------------------------------------------------
# Per-cell winners: take-best (ASI composites) and nearest sample
# ---------------------------------------------------------------------------

_U32 = 1 << 32


def _ordered_u32(x):
    """int64 holding a 32-bit unsigned image of float32 ``x`` whose integer
    order is the float order of the JAX package's sorts
    (``lax._float_to_int_for_sort``): -0.0 counts as +0.0, every NaN (-NaN
    too) as +NaN, which sorts after +inf. A non-negative float gets its top
    bit set, a negative one has all its bits flipped."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = torch.where(x == 0, 0, bits)
    bits = torch.where(torch.isnan(x), (1 << 31) - 1, bits)
    return torch.where(bits < 0, -1 - bits, bits + (1 << 31))


def _first_of_each_cell(grid, key, secondary):
    """(winner sample (n_bins,) int64, occupied (n_bins,) bool): for each
    cell the first sample in (cell, float32 ``secondary``) order. ``key``
    is the cell index, ``n_bins`` (the dump slot) for invalid samples.

    The JAX package's stable two-key ``lax.sort(num_keys=2)`` becomes ONE
    stable sort of a packed int64: the cell in the high bits,
    :func:`_ordered_u32` of ``secondary`` in the low 32; ties keep the
    lower sample index. Each cell's first position comes from a binary
    search of the sorted cells (``searchsorted``, side 'left')."""
    n_bins = grid.n_lat * grid.n_lon
    packed = key.to(torch.int64) * _U32 + _ordered_u32(secondary)
    spacked, perm = torch.sort(packed, stable=True)
    skey = spacked >> 32
    bins_ext = torch.arange(n_bins + 1, dtype=torch.int64, device=key.device)
    starts_ext = torch.searchsorted(skey, bins_ext, side="left")
    starts, ends = starts_ext[:-1], starts_ext[1:]
    occupied = ends > starts
    at = torch.clamp(starts, max=skey.shape[0] - 1)
    return perm[at], occupied


def _flat_take_inputs(grid, lats, lons, data=None):
    """Flattened float32 coordinates (and payload), their cells, validity."""
    f32 = torch.float32
    flat_lats = lats.reshape(-1).to(f32)
    flat_lons = lons.reshape(-1).to(f32)
    flat_idx, valid = bin_indices(grid, flat_lats, flat_lons)
    key = torch.where(valid, flat_idx, grid.n_lat * grid.n_lon)
    if data is None:
        return flat_lats, flat_lons, key, valid, None
    flat_data = data.reshape(-1, data.shape[-1]).to(f32)
    return flat_lats, flat_lons, key, valid, flat_data


def bin_take_best(grid: GridSpec, lats, lons, priority, data):
    """Per-cell winner selection: each occupied grid cell takes the payload
    of its sample with the SMALLEST priority value.

    The device form of the reference's elevation-sorted overlap priority
    for multi-ASI collections (reference draw_helpers.py:128-178): pass
    ``priority=-elevation`` and bin the samples of ALL stations in one call
    — each cell keeps the highest-elevation station's pixel. One stable
    sort of packed (cell, priority) keys and a binary search for each
    cell's first sample; no scatter.

    Semantics: NaN-coordinate samples never win. NaN *priority* at valid
    coordinates sorts last, so such a sample wins only when its cell has no
    finite-priority competitor; -0.0 ties with +0.0. A winning sample's NaN
    payload channel stays NaN. Ties go to the lower sample index.

    :param lats, lons, priority: tensors of one shape; computed as float32
    :param data: (..., C) payload channels per sample
    :returns: (data_grid (n_lat, n_lon, C) float32 — NaN where empty,
               best_priority (n_lat, n_lon) — +inf where empty)
    """
    _, _, key, valid, flat_data = _flat_take_inputs(grid, lats, lons, data)
    pri = torch.where(valid, priority.reshape(-1).to(torch.float32),
                      torch.inf)
    winner, occupied = _first_of_each_cell(grid, key, pri)
    shape = (grid.n_lat, grid.n_lon)
    occupied = occupied.reshape(shape)
    # invalid samples never win; zero their payload as the JAX package does
    pay = torch.where(valid[:, None], flat_data, 0.0)
    planes = torch.where(occupied[..., None], pay[winner].reshape(
        shape + (pay.shape[1],)), torch.nan)
    best = torch.where(occupied, pri[winner].reshape(shape), torch.inf)
    return planes, best


class TakeBestPlan:
    """:func:`plan_take_best` result: the winning flat sample of each cell
    (``winner`` (n_lat*n_lon,) int64), ``occupied`` (n_lat, n_lon),
    ``best_priority`` (n_lat, n_lon) — +inf where empty — and
    ``n_samples``, the planned sample count as a Python int, against which
    :func:`apply_take_best` checks every exposure. Unpacks like a
    4-tuple."""

    def __init__(self, winner, occupied, best_priority, n_samples):
        self.winner = winner
        self.occupied = occupied
        self.best_priority = best_priority
        self.n_samples = int(n_samples)

    def __iter__(self):
        return iter((self.winner, self.occupied, self.best_priority,
                     self.n_samples))

    def __getitem__(self, i):
        return (self.winner, self.occupied, self.best_priority,
                self.n_samples)[i]


def plan_take_best(grid: GridSpec, lats, lons, priority):
    """Precompute the per-cell winning SAMPLE for a static geometry.

    ASI deployments composite every exposure (THEMIS: one per 3 s) with the
    same station calibration grids: coordinates and elevation priorities
    are static per night, only imagery changes. This runs the sort once;
    :func:`apply_take_best` then composites an exposure with one gather,
    bit-identical to :func:`bin_take_best` (the same sort decides).

    :returns: :class:`TakeBestPlan`
    """
    _, _, key, valid, _ = _flat_take_inputs(grid, lats, lons)
    pri = torch.where(valid, priority.reshape(-1).to(torch.float32),
                      torch.inf)
    winner, occupied = _first_of_each_cell(grid, key, pri)
    occupied = occupied.reshape(grid.n_lat, grid.n_lon)
    best = torch.where(occupied, pri[winner].reshape(occupied.shape),
                       torch.inf)
    return TakeBestPlan(winner, occupied, best, key.shape[0])


def apply_take_best(plan, data):
    """Composite one exposure's payloads with a :func:`plan_take_best`
    plan: one gather instead of a sort. ``data`` must have the planner's
    sample layout (...) x C; a different sample count raises (a gather
    would composite the wrong samples silently). A winning sample's NaN
    payload channel stays NaN; empty cells are NaN."""
    winner, occupied, _, n_samples = plan
    n_ch = data.shape[-1]
    flat = data.reshape(-1, n_ch).to(torch.float32)
    if flat.shape[0] != int(n_samples):
        raise ValueError(
            f"exposure has {flat.shape[0]} samples but the plan was built "
            f"for {int(n_samples)} — re-plan for this geometry (a clamped "
            "gather would composite the wrong samples silently)")
    vals = flat[winner].reshape(occupied.shape + (n_ch,))
    return torch.where(occupied[..., None], vals, torch.nan)


def _shift_into(dst, src, dy, dx, fill):
    """``dst[..., i, j] = src[..., i - dy, j - dx]``, ``fill`` where that
    index leaves the grid (the JAX package's pad-and-slice, without the
    padded copy)."""
    n, m = src.shape[-2], src.shape[-1]
    if abs(dy) >= n or abs(dx) >= m:
        dst.fill_(fill)
        return dst
    ys, yd = (slice(0, n - dy), slice(dy, n)) if dy >= 0 else \
        (slice(-dy, n), slice(0, n + dy))
    xs, xd = (slice(0, m - dx), slice(dx, m)) if dx >= 0 else \
        (slice(-dx, m), slice(0, m + dx))
    dst[..., yd, xd] = src[..., ys, xs]
    if dy > 0:
        dst[..., :dy, :] = fill
    elif dy < 0:
        dst[..., n + dy:, :] = fill
    if dx > 0:
        dst[..., :, :dx] = fill
    elif dx < 0:
        dst[..., :, m + dx:] = fill
    return dst


def _jfa_steps(n_lat, n_lon):
    n = max(n_lat, n_lon)
    steps = []
    s = 1 << max(0, int(np.ceil(np.log2(max(n, 2)))) - 1)
    while s >= 1:
        steps.append(s)
        s //= 2
    steps.append(1)  # an extra unit pass cleans up classic JFA misses
    return steps


def bin_nearest(grid: GridSpec, lats, lons, data, oversample=2):
    """Nearest-SAMPLE resampling on the device (scipy.griddata('nearest')
    semantics: every grid cell takes the value of the closest sample in
    lat/lon degree space).

    Two phases, as in the JAX package:

    1. **seed**: a stable sort by (cell, float32 squared distance to the
       cell centre) makes each occupied cell's nearest local sample the
       first of its cell;
    2. **jump-flood**: log2(grid) rounds of 8-neighbour shifted
       min-distance propagation of (seed_lat, seed_lon, payload) planes,
       plus one extra unit round.

    Only the best sample of each seed cell survives seeding, so a
    co-binned sample that is the true winner of a neighbouring cell is
    lost; ``oversample`` runs seeding and the flood on an s-times finer
    grid (cost s^2) with a ``pad`` ring of s fine cells beyond every edge
    and reads the coarse centres off it. ``fixed_grid`` puts row 0 at the
    north, so the fine grid's ``lat0`` moves north (+) and its ``lon0``
    west (-). Cells outside the footprint also get a nearest sample;
    callers mask by outline as the reference does (resample.py:250-259).

    :param lats, lons: sample coordinates (any shape); computed as float32
    :param data: (..., C) payload channels per sample
    :returns: (data_grid (n_lat, n_lon, C) float32, dist2_grid (n_lat,
        n_lon) — squared degree distance to the winning sample; +inf when
        there are no valid samples at all)
    """
    s_over = int(oversample)
    if s_over > 1:
        pad = s_over
        fine = GridSpec(
            n_lat=(grid.n_lat - 1) * s_over + 1 + 2 * pad,
            n_lon=(grid.n_lon - 1) * s_over + 1 + 2 * pad,
            lat0=grid.lat0 + pad * grid.lat_step / s_over,
            lon0=grid.lon0 - pad * grid.lon_step / s_over,
            lat_step=grid.lat_step / s_over,
            lon_step=grid.lon_step / s_over,
        )
        dg, d2g = bin_nearest(fine, lats, lons, data, oversample=1)
        sl_lat = slice(pad, pad + (grid.n_lat - 1) * s_over + 1, s_over)
        sl_lon = slice(pad, pad + (grid.n_lon - 1) * s_over + 1, s_over)
        return dg[sl_lat, sl_lon], d2g[sl_lat, sl_lon]
    f32 = torch.float32
    dev = lats.device
    flat_lats, flat_lons, key, valid, flat_data = _flat_take_inputs(
        grid, lats, lons, data)
    n_lat, n_lon = grid.n_lat, grid.n_lon
    lat_c = torch.as_tensor(grid.lat_centers, dtype=f32, device=dev)
    lon_c = torch.as_tensor(grid.lon_centers, dtype=f32, device=dev)
    iy = torch.clamp(torch.div(key, n_lon, rounding_mode="floor"), 0,
                     n_lat - 1).long()
    ix = torch.clamp(key % n_lon, 0, n_lon - 1).long()
    d2 = (flat_lats - lat_c[iy]) ** 2 + (flat_lons - lon_c[ix]) ** 2
    d2 = torch.where(valid, d2, torch.inf)
    winner, occupied = _first_of_each_cell(grid, key, d2)
    shape = (n_lat, n_lon)
    occupied = occupied.reshape(shape)
    # a NaN-masked payload that wins stays NaN, as on the scipy path;
    # invalid samples never win and their payload is zeroed
    la = torch.where(valid, flat_lats, 0.0)[winner].reshape(shape)
    lo = torch.where(valid, flat_lons, 0.0)[winner].reshape(shape)
    pay = torch.where(valid[:, None], flat_data, 0.0)[winner]
    state = torch.cat([la[None], lo[None],
                       pay.T.reshape((-1,) + shape)], dim=0)
    state = torch.where(occupied[None], state, 0.0)

    cy = lat_c[:, None]
    cx = lon_c[None, :]
    best = torch.where(occupied, (state[0] - cy) ** 2 + (state[1] - cx) ** 2,
                       torch.inf)
    stp = torch.empty_like(state)
    bp = torch.empty_like(best)
    for s in _jfa_steps(n_lat, n_lon):
        for dy in (-s, 0, s):
            for dx in (-s, 0, s):
                if dy == 0 and dx == 0:
                    continue
                _shift_into(stp, state, dy, dx, 0.0)
                _shift_into(bp, best, dy, dx, torch.inf)
                cand_d = torch.where(torch.isinf(bp), torch.inf,
                                     (stp[0] - cy) ** 2 + (stp[1] - cx) ** 2)
                take = cand_d < best
                best = torch.where(take, cand_d, best)
                state = torch.where(take[None], stp, state)
    return state[2:].movedim(0, -1), best


# ---------------------------------------------------------------------------
# Structured interpolation: invert the smooth pixel -> lat/lon mesh
# ---------------------------------------------------------------------------


def _patch_bilinear(field, y0, x0, fy, fx):
    """Bilinear patch value + analytic in-patch derivatives at (fy, fx)."""
    f00 = field[y0, x0]
    f01 = field[y0, x0 + 1]
    f10 = field[y0 + 1, x0]
    f11 = field[y0 + 1, x0 + 1]
    val = ((1 - fy) * ((1 - fx) * f00 + fx * f01)
           + fy * ((1 - fx) * f10 + fx * f11))
    ddx = (1 - fy) * (f01 - f00) + fy * (f11 - f10)
    ddy = (1 - fx) * (f10 - f00) + fx * (f11 - f01)
    return val, ddx, ddy


def _patch_of(pos, n):
    """Clamped position, its patch index (NaN -> 0, as XLA converts) and
    the fraction inside the patch."""
    pc = torch.clamp(pos, 0.0, n - 1.0)
    p0 = torch.nan_to_num(torch.clamp(torch.floor(pc), 0, n - 2),
                          nan=0.0).long()
    return pc, p0, pc - p0.to(pc.dtype)


def _invert_mesh(grid: GridSpec, lat_src, lon_src, n_iter):
    """Fractional source position of every target cell centre on the
    smooth (h, w) lat/lon mesh: jump-flood nearest seeding + Newton on the
    bilinear patch map. Returns (yc, xc, y0, x0, fy, fx, ok): clamped
    positions, their patch index/fraction decomposition, and the
    converged-and-in-footprint predicate."""
    h, w = lat_src.shape
    dtype, dev = lat_src.dtype, lat_src.device

    rows = torch.arange(h, dtype=dtype, device=dev)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=dtype, device=dev)[None, :].expand(h, w)
    seed, _ = bin_nearest(grid, lat_src, lon_src,
                          torch.stack([rows, cols], dim=-1), oversample=1)
    y = seed[..., 0].to(dtype)
    x = seed[..., 1].to(dtype)

    tgt_lat = torch.as_tensor(grid.lat_centers, dtype=dtype,
                              device=dev)[:, None]
    tgt_lon = torch.as_tensor(grid.lon_centers, dtype=dtype,
                              device=dev)[None, :]

    for _ in range(n_iter):
        yc, y0, fy = _patch_of(y, h)
        xc, x0, fx = _patch_of(x, w)
        la, la_dx, la_dy = _patch_bilinear(lat_src, y0, x0, fy, fx)
        lo, lo_dx, lo_dy = _patch_bilinear(lon_src, y0, x0, fy, fx)
        r_lat = la - tgt_lat
        r_lon = lo - tgt_lon
        det = la_dx * lo_dy - la_dy * lo_dx
        safe = torch.abs(det) > 1e-30
        det = torch.where(safe, det, 1.0)
        dx = (r_lat * lo_dy - r_lon * la_dy) / det
        dy = (r_lon * la_dx - r_lat * lo_dx) / det
        dx = torch.where(safe, dx, torch.nan)
        dy = torch.where(safe, dy, torch.nan)
        x = xc - dx
        y = yc - dy

    # converged and in range? (cells outside the footprint run to the
    # border clamp and keep a large residual)
    yc, y0, fy = _patch_of(y, h)
    xc, x0, fx = _patch_of(x, w)
    la, _, _ = _patch_bilinear(lat_src, y0, x0, fy, fx)
    lo, _, _ = _patch_bilinear(lon_src, y0, x0, fy, fx)
    cell2 = (torch.tensor(grid.lat_step, dtype=dtype) ** 2
             + torch.tensor(grid.lon_step, dtype=dtype) ** 2).to(dev)
    ok = ((la - tgt_lat) ** 2 + (lo - tgt_lon) ** 2) < cell2
    ok &= (y == yc) & (x == xc)
    return yc, xc, y0, x0, fy, fx, ok


def interp_linear_structured(grid: GridSpec, lat_src, lon_src, data,
                             n_iter=3):
    """Linear interpolation onto the grid from a STRUCTURED source.

    The reference's 'linear' triangulates the scattered pixel centres with
    scipy.griddata (reference resample.py:323-326), a host Delaunay pass. A
    mapping's pixel centres form a smooth (h, w) mesh in lat/lon, so linear
    interpolation is the inverse of that mesh map: seed each target cell
    with its nearest source pixel (:func:`bin_nearest` carrying (row, col)
    payloads), Newton-invert the bilinear patch map around it (``n_iter``
    steps with the analytic patch Jacobian), and sample the payload
    bilinearly there. Bilinear-on-quads rather than
    linear-on-Delaunay-triangles: both reproduce locally affine fields
    exactly. A cell whose quad touches a NaN source coordinate is NaN, and
    so is a cell outside the footprint (the caller masks by outline).
    Computes in ``lat_src``'s dtype.

    :param lat_src, lon_src: (h, w) source-mesh coordinates, NaN = masked
    :param data: (h, w, C) payload channels
    :returns: (data_grid (n_lat, n_lon, C), src_pos (n_lat, n_lon, 2)
        fractional (row, col) source position per cell — NaN where
        unsolved)
    """
    lon_src, data = lon_src.to(lat_src.dtype), data.to(lat_src.dtype)
    yc, xc, y0, x0, fy, fx, ok = _invert_mesh(grid, lat_src, lon_src, n_iter)
    outs = []
    for c in range(data.shape[-1]):
        val, _, _ = _patch_bilinear(data[..., c], y0, x0, fy, fx)
        outs.append(torch.where(ok, val, torch.nan))
    pos = torch.stack([torch.where(ok, yc, torch.nan),
                       torch.where(ok, xc, torch.nan)], dim=-1)
    return torch.stack(outs, dim=-1), pos


def _catmull_rom_weights(t):
    """Catmull-Rom basis for taps at offsets (-1, 0, 1, 2)."""
    t2 = t * t
    t3 = t2 * t
    return (
        0.5 * (-t3 + 2 * t2 - t),
        0.5 * (3 * t3 - 5 * t2 + 2),
        0.5 * (-3 * t3 + 4 * t2 + t),
        0.5 * (t3 - t2),
    )


def interp_cubic_structured(grid: GridSpec, lat_src, lon_src, data,
                            n_iter=3):
    """Cubic interpolation: the mesh inversion of
    :func:`interp_linear_structured`, sampled with a separable Catmull-Rom
    bicubic kernel (C1 interpolating, like the reference's Clough-Tocher
    'cubic', reference resample.py:323-326, but on the structured mesh).
    A cell whose 4x4 stencil would leave the mesh or touch a NaN source
    value is NaN (a <= 2-cell band at the footprint edge): an edge-clamped
    stencil would lose the kernel's linear precision there."""
    lon_src, data = lon_src.to(lat_src.dtype), data.to(lat_src.dtype)
    h, w = lat_src.shape
    yc, xc, y0, x0, fy, fx, ok = _invert_mesh(grid, lat_src, lon_src, n_iter)
    # the full un-clamped 4x4 stencil only (see the docstring)
    ok &= (y0 >= 1) & (y0 <= h - 3) & (x0 >= 1) & (x0 <= w - 3)
    wy = _catmull_rom_weights(fy)
    wx = _catmull_rom_weights(fx)
    ys = [torch.clamp(y0 + m - 1, 0, h - 1) for m in range(4)]
    xs = [torch.clamp(x0 + n - 1, 0, w - 1) for n in range(4)]
    outs = []
    for c in range(data.shape[-1]):
        f = data[..., c]
        val = 0.0
        for m in range(4):
            row = 0.0
            for n in range(4):
                row = row + wx[n] * f[ys[m], xs[n]]
            val = val + wy[m] * row
        outs.append(torch.where(ok, val, torch.nan))
    pos = torch.stack([torch.where(ok, yc, torch.nan),
                       torch.where(ok, xc, torch.nan)], dim=-1)
    return torch.stack(outs, dim=-1), pos
