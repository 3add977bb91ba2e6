"""The port's per-cell winner selection and nearest-sample resampling
(``auromat_tpu_torch.ops.regrid``) against the JAX package on the CPU.

* ``bin_take_best`` and ``plan_take_best`` + ``apply_take_best``: bit-equal
  to JAX (float32 bits, NaN positions, ``best_priority`` and the winners)
  on seeded samples with repeated priorities, NaN and -NaN priority at valid
  coordinates, NaN coordinates, NaN payload and -0.0/+0.0 priorities; the
  order the sort keys give floats; a mismatched exposure raises.
* ``bin_nearest`` (oversample 1 and 2): bit-equal to JAX on dyadic
  coordinates (exact in float32, so the float32 squared distances cannot
  round differently); on random coordinates at least 99.9% of cells
  bit-equal and every cell's winning distance within 4 ulp of JAX's (XLA
  may contract ``a*a + b*b`` into an FMA where eager torch rounds twice,
  ROADMAP F2).
* ``resample`` with 'nearest', 'linear' and 'cubic' (host scipy) on
  golden_resample_methods.npz with the gates of
  ``tests/test_resample_parity.py::TestInterpMethods``, and uint8-equal to
  the JAX package's host routes; 'nearest' on the CPU is the host route,
  'nearest_device' on the CPU equals JAX's 'nearest_device' (masks equal,
  uint8 within one step on the cells the tie rule above allows). The JAX
  device route runs at 8 px/deg (its jump flood takes minutes on the CPU
  at the golden's 25); the port's runs at both.

The structured linear/cubic interpolators are in
tests/test_torch_interp_structured.py, the card's runs in
tests/test_torch_gpu.py.
"""

import dataclasses
import os
from datetime import datetime

import numpy as np
import pytest
import torch

from auromat_tpu.mapping.mapping import Mapping as JMapping
from auromat_tpu.ops import regrid as jr
from auromat_tpu.resample import resample as jresample
from auromat_tpu_torch.mapping.mapping import Mapping
from auromat_tpu_torch.ops import regrid as tr
from auromat_tpu_torch.resample import resample

RES = os.path.join(os.path.dirname(__file__), "resources")
GRID = tr.fixed_grid(4, 10.0, 20.0, 30.0, 45.0)  # dyadic centres, 39x59


def bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def assert_bit_equal(ours, theirs):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    assert np.array_equal(bits(ours), bits(theirs))


def take_best_samples(seed, n=20000):
    """Seeded samples over GRID with every special case of the contract."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(9.5, 20.5, n).astype(np.float32)
    lon = rng.uniform(29.5, 45.5, n).astype(np.float32)
    pri = rng.integers(-5, 5, n).astype(np.float32)  # many ties
    for value in (np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf):
        pri[rng.random(n) < 0.04] = value
    lat[rng.random(n) < 0.02] = np.nan
    lon[rng.random(n) < 0.02] = np.nan
    data = rng.random((n, 2)).astype(np.float32)
    data[rng.random(n) < 0.05, 0] = np.nan
    return lat, lon, pri, data


def torch_args(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_take_best_bit_equal_to_jax(seed):
    lat, lon, pri, data = take_best_samples(seed)
    jd, jb = jr.bin_take_best(GRID, lat, lon, pri, data)
    td, tb = tr.bin_take_best(GRID, *torch_args(lat, lon, pri, data))
    assert_bit_equal(td, jd)
    assert_bit_equal(tb, jb)
    # every special case decided at least one cell
    assert np.signbit(tb.numpy()[tb.numpy() == 0]).any()
    assert np.isnan(tb.numpy()).any() and np.isinf(tb.numpy()).any()
    assert np.isnan(td.numpy()[..., 0][np.isfinite(tb.numpy())]).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_apply_take_best_bit_equal_to_jax(seed):
    lat, lon, pri, data = take_best_samples(seed)
    jplan = jr.plan_take_best(GRID, lat, lon, pri)
    plan = tr.plan_take_best(GRID, *torch_args(lat, lon, pri))
    assert np.array_equal(plan.winner.numpy(), np.asarray(jplan.winner))
    assert np.array_equal(plan.occupied.numpy(), np.asarray(jplan.occupied))
    assert_bit_equal(plan.best_priority, jplan.best_priority)
    assert plan.n_samples == jplan.n_samples == len(lat)
    for k in range(3):  # exposures share the geometry
        d = np.random.default_rng(seed + 10 * k).random(
            (len(lat), 3)).astype(np.float32)
        d[::7, 1] = np.nan
        applied = tr.apply_take_best(plan, torch.from_numpy(d))
        assert_bit_equal(applied, jr.apply_take_best(jplan, d))
        td, _ = tr.bin_take_best(GRID, *torch_args(lat, lon, pri, d))
        assert_bit_equal(applied, td)
    winner, occupied, best, n = plan  # unpacks like the JAX 4-tuple
    assert n == plan[3] == len(lat)


def test_apply_take_best_refuses_another_exposure():
    lat, lon, pri, data = take_best_samples(0, n=1000)
    plan = tr.plan_take_best(GRID, *torch_args(lat, lon, pri))
    with pytest.raises(ValueError, match="re-plan"):
        tr.apply_take_best(plan, torch.zeros(999, 2))
    with pytest.raises(ValueError, match="re-plan"):
        tr.apply_take_best(plan, torch.zeros(10, 101, 2))


def test_take_best_empty_and_all_invalid():
    lat = np.full(50, np.nan, np.float32)
    lon = np.full(50, 35.0, np.float32)
    pri = np.zeros(50, np.float32)
    data = np.ones((50, 2), np.float32)
    td, tb = tr.bin_take_best(GRID, *torch_args(lat, lon, pri, data))
    jd, jb = jr.bin_take_best(GRID, lat, lon, pri, data)
    assert_bit_equal(td, jd)
    assert_bit_equal(tb, jb)
    assert torch.isnan(td).all() and torch.isinf(tb).all()


def test_ordered_keys_follow_the_float_order():
    """The packed sort key orders float32 like JAX's stable sort: -inf <
    negatives < -0.0 == +0.0 < positives < +inf < NaN == -NaN."""
    vals = np.array([np.nan, -np.inf, -3.5, -1e-40, -0.0, 0.0, 1e-40, 2.0,
                     np.inf, -np.nan, -2.0], np.float32)
    keys = tr._ordered_u32(torch.from_numpy(vals)).numpy()
    assert (keys >= 0).all() and (keys < 2 ** 32).all()
    order = np.argsort(keys, kind="stable")
    assert list(order) == [1, 2, 10, 3, 4, 5, 6, 7, 8, 0, 9]
    assert keys[4] == keys[5] and keys[0] == keys[9]


def golden_bbox():
    """The golden_resample_methods mapping's bounding box (lat S/N, lon
    W/E)."""
    g = np.load(os.path.join(RES, "golden_resample_methods.npz"))
    bb = JMapping(*methods_args(g)).boundingBox
    return bb.latSouth, bb.latNorth, bb.lonWest, bb.lonEast


def jax_bin_nearest(grid, lat, lon, data, oversample):
    """JAX's ``bin_nearest`` called as its resample route calls it (the
    default oversample unnamed: jit keys on the call's arguments)."""
    jgrid = jr.GridSpec(**dataclasses.asdict(grid))
    if oversample == 2:
        return jr.bin_nearest(jgrid, lat, lon, data)
    return jr.bin_nearest(jgrid, lat, lon, data, oversample)


def nearest_grid():
    """The grid ``resample(px_per_deg=8)`` of the golden mapping makes:
    dyadic centres, and the same static argument as the JAX route below
    (one compile of JAX's jump flood serves both)."""
    return tr.fixed_grid((8, 8), *golden_bbox())


def nearest_samples(seed, dyadic, shape=(140, 140)):
    """float64 samples of the golden mapping's shapes over its box."""
    s, n, w, e = golden_bbox()
    rng = np.random.default_rng(seed)
    lat = rng.uniform(s - 0.3, n + 0.3, shape)
    lon = rng.uniform(w - 0.3, e + 0.3, shape)
    if dyadic:
        lat, lon = np.round(lat * 64) / 64, np.round(lon * 64) / 64
    lat[rng.random(shape) < 0.01] = np.nan
    data = rng.random(shape + (4,))
    data[rng.random(shape) < 0.01, 2] = np.nan
    return lat, lon, data


@pytest.mark.parametrize("oversample", [1, 2])
def test_bin_nearest_dyadic_bit_equal_to_jax(oversample):
    grid = nearest_grid()
    lat, lon, data = nearest_samples(oversample, dyadic=True)
    jd, jd2 = jax_bin_nearest(grid, lat, lon, data, oversample)
    td, td2 = tr.bin_nearest(grid, *torch_args(lat, lon, data), oversample)
    assert_bit_equal(td, jd)
    assert_bit_equal(td2, jd2)
    assert np.isfinite(td2.numpy()).all()


@pytest.mark.parametrize("oversample", [1, 2])
def test_bin_nearest_random_within_the_fma_class(oversample):
    grid = nearest_grid()
    lat, lon, data = nearest_samples(10 + oversample, dyadic=False)
    jd, jd2 = jax_bin_nearest(grid, lat, lon, data, oversample)
    td, td2 = tr.bin_nearest(grid, *torch_args(lat, lon, data), oversample)
    same = (bits(td) == bits(jd)).all(axis=-1)
    assert same.mean() >= 0.999
    # the winning distances themselves may differ by the FMA's rounding
    ulp = np.abs(td2.numpy().view(np.int32).astype(np.int64)
                 - np.asarray(jd2).view(np.int32).astype(np.int64))
    assert ulp.max() <= 4


def test_bin_nearest_no_valid_sample():
    lat = np.full(30, np.nan, np.float32)
    lon = np.full(30, 35.0, np.float32)
    td, td2 = tr.bin_nearest(GRID, *torch_args(lat, lon, np.ones((30, 2),
                                                              np.float32)))
    assert torch.isinf(td2).all() and (td == 0).all()


def test_shift_into_matches_pad_and_slice():
    src = torch.arange(2 * 5 * 7, dtype=torch.float32).reshape(2, 5, 7)
    dst = torch.empty_like(src)
    for dy in (-6, -2, 0, 3, 5):
        for dx in (-7, -1, 0, 4, 9):
            pad = torch.nn.functional.pad(src, (abs(dx),) * 2 + (abs(dy),) * 2,
                                          value=-1.0)
            want = pad[:, abs(dy) - dy:abs(dy) - dy + 5,
                       abs(dx) - dx:abs(dx) - dx + 7]
            assert torch.equal(tr._shift_into(dst, src, dy, dx, -1.0), want)


# -- resample's interpolation routes on the golden input -----------------------

@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(RES, "golden_resample_methods.npz"))


def methods_args(golden):
    return (golden["in_lats"], golden["in_lons"], golden["in_lats_center"],
            golden["in_lons_center"], golden["in_elevation"], 110.0,
            golden["in_img"], [0.0, 0.0, 6871.0],
            datetime(2012, 1, 25, 9, 27, 57), "synthetic_methods")


@pytest.fixture(scope="module")
def mappings(golden):
    args = methods_args(golden)
    return Mapping(*args), JMapping(*args)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
def test_resample_host_routes_pass_the_golden_gates(golden, mappings, method):
    """TestInterpMethods's gates on the port's host routes, and the JAX
    package's host route cell for cell."""
    m, jm = mappings
    ppd = float(golden["px_per_deg"])
    r = resample(m, px_per_deg=ppd, contains_pole=False, method=method,
                 device="cpu")
    img = r.img
    mask = np.ma.getmaskarray(img)
    assert (mask != golden[f"{method}_img_mask"]).sum() == 0
    both = ~mask.any(axis=-1)
    ours = np.asarray(img.filled(0)).astype(np.int64)
    diff = np.abs(ours - golden[f"{method}_img"].astype(np.int64))
    diff[~both] = 0
    if method == "cubic":  # the clamp-vs-wrap cells, as TestInterpMethods
        over = diff > 1
        assert over.sum() < 100 and np.isin(ours[over], (0, 255)).all()
        diff[over] = 0
    assert (diff > 1).sum() == 0 and (diff == 1).mean() < 1e-3
    elev = np.asarray(r.elevation.filled(np.nan))
    ge = golden[f"{method}_elevation"]
    ok = ~np.isnan(elev) & ~np.isnan(ge)
    assert ok.any() and np.abs(elev[ok] - ge[ok]).max() < 1e-4
    jr_ = jresample(jm, px_per_deg=ppd, contains_pole=False, method=method)
    assert np.array_equal(mask, np.ma.getmaskarray(jr_.img))
    assert np.array_equal(img.filled(0), jr_.img.filled(0))
    assert np.array_equal(r.lats.filled(np.nan), jr_.lats.filled(np.nan),
                          equal_nan=True)
    # 'nearest_host' is the same route
    if method == "nearest":
        rh = resample(m, px_per_deg=ppd, contains_pole=False,
                      method="nearest_host", device="cpu")
        assert np.array_equal(rh.img.filled(0), img.filled(0))


def test_resample_nearest_device_matches_jax(golden, mappings):
    """'nearest_device' on the CPU against JAX's at 8 px/deg: the masks
    are the outline's, the uint8 image within one step where the
    float32 distance tie rule allows a different winner."""
    m, jm = mappings
    r = resample(m, px_per_deg=8, contains_pole=False,
                 method="nearest_device", device="cpu")
    jr_ = jresample(jm, px_per_deg=8, contains_pole=False,
                    method="nearest_device")
    mask = np.ma.getmaskarray(r.img)
    assert np.array_equal(mask, np.ma.getmaskarray(jr_.img))
    assert (~mask).sum() > 1000
    d = np.abs(r.img.filled(0).astype(int) - jr_.img.filled(0).astype(int))
    assert (d > 1).sum() == 0 and (d != 0).mean() < 1e-3
    e = np.abs(r.elevation.filled(np.nan) - jr_.elevation.filled(np.nan))
    assert np.nanmax(e) < 1e-4


def test_resample_nearest_device_at_the_golden_resolution(golden, mappings):
    """At 25 px/deg the device jump flood keeps the golden's outline mask
    and takes a nearby sample where scipy's KD-tree takes another."""
    m, _ = mappings
    r = resample(m, px_per_deg=float(golden["px_per_deg"]),
                 contains_pole=False, method="nearest_device", device="cpu")
    mask = np.ma.getmaskarray(r.img)
    assert (mask != golden["nearest_img_mask"]).sum() == 0
    ok = ~mask.any(axis=-1)
    d = np.abs(r.img.filled(0).astype(int)
               - golden["nearest_img"].astype(int))[ok]
    assert (d == 0).mean() > 0.95
