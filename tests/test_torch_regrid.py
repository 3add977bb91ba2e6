"""The port's bin indices and mean finalisation (auromat_tpu_torch.ops.regrid)
against the JAX package. ``bin_indices`` must be bit-exact on float32
coordinates: the JAX package computes the cell in float64 (its grid's
float64 edges promote the f32 coordinates), and so does the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auromat_tpu.ops import regrid as jregrid
from auromat_tpu_torch.ops import regrid as tregrid

GRIDS = {
    # the main path's grid: ~100 arcsec cells, steps not exact in binary
    "bench": ((36, 25), 47.0, 62.0, -112.0, -91.0),
    # binary-exact steps and edges: exact-edge and far-edge samples exist
    "exact": ((4, 2), 10.0, 20.0, -30.0, -10.0),
}


def both(key, lats, lons):
    args = GRIDS[key]
    jf, jv = jregrid.bin_indices(jregrid.fixed_grid(*args),
                                 jnp.asarray(lats), jnp.asarray(lons))
    tf, tv = tregrid.bin_indices(tregrid.fixed_grid(*args),
                                 torch.from_numpy(lats), torch.from_numpy(lons))
    assert tf.dtype == torch.int32 and tv.dtype == torch.bool
    return (np.asarray(jf), np.asarray(jv)), (tf.numpy(), tv.numpy())


def assert_same(key, lats, lons):
    (jf, jv), (tf, tv) = both(key, lats, lons)
    assert np.array_equal(tv, jv)
    assert np.array_equal(tf, jf)
    return tv


@pytest.mark.parametrize("key", sorted(GRIDS))
def test_random_f32(key):
    _, lat_min, lat_max, lon_min, lon_max = GRIDS[key]
    rng = np.random.default_rng(11)
    n = 200_000
    lats = rng.uniform(lat_min - 1, lat_max + 1, n).astype(np.float32)
    lons = rng.uniform(lon_min - 1, lon_max + 1, n).astype(np.float32)
    v = assert_same(key, lats, lons)
    assert 0.5 < v.mean() < 1.0


@pytest.mark.parametrize("key", sorted(GRIDS))
def test_cell_edges(key):
    """Every cell edge, and the float32 neighbours on either side."""
    g = tregrid.fixed_grid(*GRIDS[key])
    lat_e = g.lat_corners.astype(np.float32)
    lon_e = g.lon_corners.astype(np.float32)
    lat_e = np.concatenate([lat_e, np.nextafter(lat_e, np.float32(np.inf)),
                            np.nextafter(lat_e, np.float32(-np.inf))])
    lon_e = np.concatenate([lon_e, np.nextafter(lon_e, np.float32(np.inf)),
                            np.nextafter(lon_e, np.float32(-np.inf))])
    lats, lons = np.meshgrid(lat_e, lon_e)
    assert_same(key, lats.ravel(), lons.ravel())


def test_far_edge_is_inclusive():
    g = tregrid.fixed_grid(*GRIDS["exact"])
    south = np.float32(g.lat_corners[-1])  # fy == n_lat exactly
    east = np.float32(g.lon_corners[-1])  # fx == n_lon exactly
    assert float(south) == g.lat_corners[-1] and float(east) == g.lon_corners[-1]
    lats = np.array([south, south, g.lat0, south], np.float32)
    lons = np.array([g.lon0, east, east, np.nextafter(east, np.float32(99))],
                    np.float32)
    (_, _), (tf, tv) = both("exact", lats, lons)
    assert_same("exact", lats, lons)
    assert tv.tolist() == [True, True, True, False]
    n = g.n_lon
    assert tf[:3].tolist() == [(g.n_lat - 1) * n, g.n_lat * n - 1, n - 1]


@pytest.mark.parametrize("key", sorted(GRIDS))
def test_non_finite(key):
    _, lat_min, _, lon_min, _ = GRIDS[key]
    bad = [np.nan, np.inf, -np.inf, 3e38, -3e38]
    ok_lat, ok_lon = np.float32(lat_min + 0.5), np.float32(lon_min + 0.5)
    lats = np.array(bad + [ok_lat] * 5 + [np.nan], np.float32)
    lons = np.array([ok_lon] * 5 + bad + [np.nan], np.float32)
    (_, _), (tf, tv) = both(key, lats, lons)
    assert not tv.any()
    g = tregrid.fixed_grid(*GRIDS[key])
    assert np.all(tf == g.n_lat * g.n_lon)
    assert_same(key, lats, lons)


def test_float64_input():
    """f64 coordinates (the full-precision chain) bin identically too."""
    rng = np.random.default_rng(5)
    lats = rng.uniform(46, 63, 50_000)
    lons = rng.uniform(-113, -90, 50_000)
    assert_same("bench", lats, lons)


def test_finalize_mean():
    rng = np.random.default_rng(2)
    count = rng.integers(0, 4, (7, 9)).astype(np.float32)
    sums = rng.uniform(0, 500, (7, 9, 4)).astype(np.float32)
    want = np.asarray(jregrid.finalize_mean(jnp.asarray(count),
                                            jnp.asarray(sums)))
    got = tregrid.finalize_mean(torch.from_numpy(count),
                                torch.from_numpy(sums)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(np.isnan(got), count[..., None].repeat(4, -1) == 0)
    assert np.array_equal(got, want, equal_nan=True)
