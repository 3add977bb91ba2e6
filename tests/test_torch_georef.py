"""The port's georeference chain (auromat_tpu_torch.ops.georef).

* float64: against the executed-reference goldens
  (golden_georef_*.npz) at < 1e-6 deg with identical NaN masks — the gate
  of tests/test_georef_parity.py.
* float32 (``georef_latlon_dyn``, the main path's dtype): against the
  port's own float64 chain and against the JAX package's float32 chain on
  identical calibration. XLA-CPU contracts a*b+c into fma where eager
  torch rounds after each op, so the f32 chains agree to a tolerance, not
  bitwise; the bounds below sit about 2x above the values measured on the
  128x96 scaled frame.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auromat_tpu.ops.georef import DynGeorefParams as JaxDyn
from auromat_tpu.ops.georef import georef_latlon_dyn as jax_georef
from auromat_tpu_torch.coordinates.wcs import TanWcs
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.ops.georef import (DynGeorefParams, GeorefParams,
                                          dyn_params_from_numpy,
                                          georef_latlon_dyn)
from test_georegrid import small_params

RES = os.path.join(os.path.dirname(__file__), "resources")
FRAMES = ["ISS030-E-102170_dc", "ISS029-E-8492"]


@pytest.mark.parametrize("name", FRAMES)
def test_f64_chain_matches_golden(name):
    golden = np.load(os.path.join(RES, f"golden_georef_{name}.npz"))
    header = fits.read_header(os.path.join(RES, f"{name}.wcs"))
    shifted = fits.get_shifted_spacecraft_position(header)
    pos = shifted[:3] if shifted else fits.get_spacecraft_position(header)
    np.testing.assert_allclose(np.array(pos), golden["camera_pos"])
    params = GeorefParams.from_wcs(TanWcs(header), pos,
                                   fits.get_photo_time(header),
                                   altitude=float(golden["altitude"]))
    dyn = DynGeorefParams.from_static(params, "cpu", torch.float64)
    px, py = np.meshgrid(golden["xs"] - 0.5, golden["ys"] - 0.5)
    out = georef_latlon_dyn(dyn, torch.from_numpy(px), torch.from_numpy(py),
                            dtype=torch.float64, with_elevation=True)
    lat, lon = out["lat"].numpy(), out["lon"].numpy()
    assert np.array_equal(np.isnan(lat), np.isnan(golden["lat"])), "NaN mask"
    assert np.array_equal(np.isnan(lon), np.isnan(golden["lon"])), "NaN mask"
    m = ~np.isnan(golden["lat"])
    assert m.sum() > 100 and (~m).sum() > 0  # both sky and Earth pixels
    assert np.abs(lat[m] - golden["lat"][m]).max() < 1e-6
    assert np.abs(lon[m] - golden["lon"][m]).max() < 1e-6
    el = out["elevation"].numpy()
    assert np.array_equal(np.isnan(el), ~m)
    assert np.all((el[m] >= -90) & (el[m] <= 90))


@pytest.fixture(scope="module")
def small():
    params, _ = small_params()
    jdyn = JaxDyn.from_static(params, dtype=jnp.float32)
    fields = {f: np.asarray(getattr(jdyn, f)) for f in JaxDyn._fields}
    h, w = params.height, params.width
    px, py = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    jo = jax_georef(jdyn, jnp.asarray(px), jnp.asarray(py), dtype=jnp.float32,
                    with_elevation=True)
    t32 = georef_latlon_dyn(dyn_params_from_numpy(fields, "cpu", torch.float32),
                            torch.from_numpy(px), torch.from_numpy(py),
                            dtype=torch.float32, with_elevation=True)
    t64 = georef_latlon_dyn(DynGeorefParams.from_static(params, "cpu",
                                                        torch.float64),
                            torch.from_numpy(px.astype(np.float64)),
                            torch.from_numpy(py.astype(np.float64)),
                            dtype=torch.float64, with_elevation=True)
    return ({k: np.asarray(v) for k, v in jo.items()},
            {k: v.numpy() for k, v in t32.items()},
            {k: v.numpy() for k, v in t64.items()})


def _stats(a, b):
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return np.median(d), np.quantile(d, 0.99), d.max()


# per-key (median, q99, max) bounds in degrees. Measured on this frame:
# vs f64  lat (1.7e-5, 1.1e-4, 1.8e-3) lon (9.2e-6, 1.2e-4, 3.5e-3)
#         elevation (1.7e-5, 1.3e-4, 2.6e-3) — the JAX f32 chain measures
#         the same against f64 (the max sits at grazing rays near the
#         horizon, where the intersection is ill-conditioned);
# vs JAX  lat (0, 1.1e-5, 1.6e-4) lon (0, 7.6e-6, 1.4e-4)
#         elevation (0, 1.5e-5, 1.7e-4)
F64_BOUNDS = {"lat": (4e-5, 3e-4, 4e-3), "lon": (2e-5, 3e-4, 7e-3),
              "elevation": (4e-5, 3e-4, 5e-3)}
JAX_BOUNDS = {"lat": (1e-6, 3e-5, 4e-4), "lon": (1e-6, 2e-5, 3e-4),
              "elevation": (1e-6, 3e-5, 4e-4)}


@pytest.mark.parametrize("key", ["lat", "lon", "elevation"])
def test_f32_chain_tolerance(small, key):
    jo, t32, t64 = small
    a, b, c = jo[key], t32[key], t64[key]
    assert b.dtype == np.float32
    # the ray-miss (NaN) mask is identical across all three chains here
    assert np.array_equal(np.isnan(b), np.isnan(c))
    assert np.array_equal(np.isnan(b), np.isnan(a))
    m = ~np.isnan(b)
    assert 0.3 < m.mean() < 0.9
    for got, bounds in ((_stats(b[m], c[m]), F64_BOUNDS[key]),
                        (_stats(b[m], a[m]), JAX_BOUNDS[key])):
        assert all(g < lim for g, lim in zip(got, bounds)), (got, bounds)


def test_dyn_params_to_and_from_numpy():
    params, _ = small_params()
    d64 = DynGeorefParams.from_static(params, "cpu", torch.float64)
    assert all(v.dtype == torch.float64 for v in d64)
    assert np.array_equal(d64.rotmat.numpy(), np.asarray(params.rotmat))
    d32 = d64.to("cpu", torch.float32)
    assert isinstance(d32, DynGeorefParams)
    assert all(v.dtype == torch.float32 for v in d32)
    back = dyn_params_from_numpy({f: getattr(d32, f).numpy()
                                  for f in DynGeorefParams._fields},
                                 "cpu", torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(back, d32))
