"""The port's K2/K3 binning (auromat_tpu_torch.ops.regrid_pallas) and its
float64 ``bin_mean``/``bin_partial`` (auromat_tpu_torch.ops.regrid) against
the JAX package.

Inputs are the ``synthetic()`` samples of tests/test_regrid_pallas.py
(spill rows and holes). The port's bin indices are bit-exact with JAX's,
so every sample lands in the same cell on both sides. Tolerances:

* count and integer channels: bit-exact;
* 'uint8' elevation: per cell |d sum| / count < 2^-14 (the JAX kernel's
  limb-split class, as in tests/test_torch_georegrid.py);
* 'full' against JAX: |d sum| <= count * 2^-9 + |sum| * 2^-22. The JAX
  kernel rounds each sample's fraction limb to bf16 (< 2^-9) and
  accumulates and recombines three limbs in float32 (a few ulps of the
  sum); the port is within 2^-21 a sample plus one float32 rounding;
* 'full' against the float64 oracle: |d sum| <= count * 2^-(S-1) +
  |sum| * 2^-24, S = FIXED_SHIFT (the fixed-point quantum and the final
  float32 rounding);
* 'raw' (bf16-exact values): |d sum| <= count * 2^-21 + |sum| * 2^-22;
* ``bin_mean``: counts and NaN masks equal, means within 1e-12 relative.

The kernels themselves run on the card: tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auromat_tpu.ops import regrid as jregrid
from auromat_tpu.ops import regrid_pallas as jrp
from auromat_tpu_torch.ops import regrid as tregrid
from auromat_tpu_torch.ops import regrid_pallas as trp
from auromat_tpu_torch.ops.georegrid import split_bin_indices
from test_regrid_pallas import synthetic

S = trp.FIXED_SHIFT


def grid_for(lats, lons):
    args = (25, float(np.nanmin(lats)), float(np.nanmax(lats)) + 0.1,
            float(np.nanmin(lons)), float(np.nanmax(lons)) + 0.1)
    return jregrid.fixed_grid(*args), tregrid.fixed_grid(*args)


@pytest.fixture(scope="module")
def samples():
    lats, lons, data = synthetic(spill_rows=4)
    jg, tg = grid_for(lats, lons)
    rng = np.random.default_rng(5)
    full = (rng.random(data.shape) * 65535).astype(np.float32)
    raw = np.asarray(jnp.asarray(
        rng.uniform(-100, 100, data.shape).astype(np.float32))
        .astype(jnp.bfloat16).astype(jnp.float32))
    return {"lats": lats, "lons": lons, "jg": jg, "tg": tg,
            "data": {"uint8": data, "full": full, "raw": raw}}


def t(a):
    return torch.from_numpy(np.array(a))


def port_partial(s, mode, entry):
    fn = {"K2": trp.bin_partial_pallas2, "K3": trp.bin_partial_pallas}[entry]
    c, m = fn(s["tg"], t(s["lats"]), t(s["lons"]), t(s["data"][mode]), mode)
    assert c.dtype == m.dtype == torch.float32
    return c.numpy(), m.numpy()


@pytest.fixture(scope="module")
def jax_partial(samples):
    """JAX K2 (bin_partial_pallas2) and K3 (bin_partial_pallas) in
    interpret mode, per mode."""
    s = samples
    out = {}
    for mode in trp.MODES:
        args = (s["jg"], s["lats"], s["lons"], s["data"][mode], mode)
        out["K2", mode] = tuple(map(np.asarray, jrp.bin_partial_pallas2(
            *args, interpret=True)))
    out["K3", "uint8"] = tuple(map(np.asarray, jrp.bin_partial_pallas(
        s["jg"], s["lats"], s["lons"], s["data"]["uint8"], "uint8", True)))
    return out


def oracle(s, mode):
    """float64 (count, sums) of the valid samples."""
    flat, valid = map(np.asarray, jregrid.bin_indices(
        s["jg"], s["lats"].ravel(), s["lons"].ravel()))
    nb = s["jg"].n_lat * s["jg"].n_lon
    d = s["data"][mode].reshape(-1, s["data"][mode].shape[-1])
    count = np.bincount(flat[valid], minlength=nb).astype(np.float64)
    sums = np.zeros((nb, d.shape[1]))
    np.add.at(sums, flat[valid], d[valid].astype(np.float64))
    shape = (s["jg"].n_lat, s["jg"].n_lon)
    return count.reshape(shape), sums.reshape(shape + (d.shape[1],))


def assert_uint8_parity(got, want):
    (c, m), (jc, jm) = got, want
    assert c.shape == jc.shape and m.shape == jm.shape
    assert np.array_equal(c, jc)
    assert np.array_equal(m[..., :-1], jm[..., :-1])
    per_sample = np.abs(m[..., -1] - jm[..., -1]) / np.maximum(c, 1)
    assert per_sample.max() < 2 ** -14, per_sample.max()


@pytest.mark.parametrize("entry", ["K2", "K3"])
def test_uint8_plain_matches_jax_kernel(samples, jax_partial, entry):
    got = port_partial(samples, "uint8", entry)
    assert got[0].sum() == oracle(samples, "uint8")[0].sum() > 1000
    assert_uint8_parity(got, jax_partial[entry, "uint8"])


def test_full_plain_matches_jax_kernel_and_oracle(samples, jax_partial):
    c, m = port_partial(samples, "full", "K2")
    jc, jm = jax_partial["K2", "full"]
    oc, om = oracle(samples, "full")
    assert np.array_equal(c, jc) and np.array_equal(c, oc)
    cnt = c[..., None]
    assert np.all(np.abs(m - jm) <= cnt * 2.0 ** -9 + np.abs(om) * 2.0 ** -22)
    assert np.all(np.abs(m - om) <= cnt * 2.0 ** -(S - 1) + np.abs(om) * 2.0 ** -24)
    assert np.abs(om).max() > 1e5  # the 65535-scale regime


def test_raw_plain_matches_jax_kernel(samples, jax_partial):
    c, m = port_partial(samples, "raw", "K2")
    jc, jm = jax_partial["K2", "raw"]
    _, om = oracle(samples, "raw")
    assert np.array_equal(c, jc)
    cnt = c[..., None]
    assert np.all(np.abs(m - jm) <= cnt * 2.0 ** -21 + np.abs(om) * 2.0 ** -22)
    assert (m < 0).any() and (m > 0).any()


@pytest.mark.parametrize("mode", list(trp.MODES))
def test_cw_entry_matches_jax_cw(samples, mode):
    """K2's lower-level entry from (iy, ix): the port takes the channels
    unsplit where the JAX package takes its limb split."""
    s = samples
    data = s["data"][mode]
    flat, valid = tregrid.bin_indices(s["tg"], t(s["lats"]), t(s["lons"]))
    iy, ix = split_bin_indices(s["tg"], flat, valid)
    data = np.where(np.isnan(s["lats"])[..., None], 0.0, data).astype(np.float32)
    split = {"uint8": jrp._split_elevation, "full": jrp._split_full,
             "raw": lambda d: d}[mode]
    jc, jm = map(np.asarray, jrp.bin_partial_pallas_cw(
        s["jg"], (jnp.asarray(iy.numpy()), jnp.asarray(ix.numpy())),
        split(jnp.asarray(data)), data.shape[-1], mode, True))
    c, m = trp.bin_partial_pallas_cw(s["tg"], (iy, ix), t(data), data.shape[-1],
                                     mode)
    c, m = c.numpy(), m.numpy()
    if mode == "uint8":
        assert_uint8_parity((c, m), (jc, jm))
    else:
        assert np.array_equal(c, jc)
        bound = 2.0 ** -9 if mode == "full" else 2.0 ** -21
        assert np.all(np.abs(m - jm) <= c[..., None] * bound
                      + np.abs(jm) * 2.0 ** -22)


def test_taint_matches_jax_kernel(samples):
    s = samples
    data = s["data"]["uint8"].copy()
    rng = np.random.default_rng(11)
    for ch in range(data.shape[-1]):  # NaN at valid coordinates, per channel
        data[..., ch] = np.where(rng.random(data.shape[:2]) < 0.02, np.nan,
                                 data[..., ch])
    jc, jm = map(np.asarray, jrp.bin_mean_pallas_taint(
        s["jg"], s["lats"], s["lons"], data, interpret=True))
    c, m = trp.bin_mean_pallas_taint(s["tg"], t(s["lats"]), t(s["lons"]), t(data))
    c, m = c.numpy(), m.numpy()
    assert np.array_equal(c, jc)
    assert np.array_equal(np.isnan(m), np.isnan(jm))
    ok = ~np.isnan(jm)
    assert ok.any() and (~ok).any()
    assert np.array_equal(m[..., :-1][ok[..., :-1]], jm[..., :-1][ok[..., :-1]])
    d = np.abs(m[..., -1] - jm[..., -1])[ok[..., -1]]
    assert d.max() < 2 ** -14


def test_bin_mean_pallas_matches_partial(samples):
    s = samples
    args = (s["tg"], t(s["lats"]), t(s["lons"]), t(s["data"]["uint8"]))
    c, m = trp.bin_mean_pallas(*args)
    pc, ps = trp.bin_partial_pallas2(*args)
    assert torch.equal(c, pc)
    ok = pc > 0
    assert torch.equal(m[ok], ps[ok] / pc[ok][:, None])
    assert torch.isnan(m[~ok]).all()


@pytest.mark.parametrize("method", sorted(tregrid._BIN_METHODS))
def test_bin_mean_matches_jax(samples, method):
    s = samples
    data = s["data"]["uint8"].astype(np.float64)
    rng = np.random.default_rng(13)
    data[rng.random(data.shape) < 0.02] = np.nan  # taints at valid coords
    jc, jm = map(np.asarray, jregrid.bin_mean(
        s["jg"], s["lats"], s["lons"], data, method))
    c, m = tregrid.bin_mean(s["tg"], t(s["lats"]), t(s["lons"]), t(data), method)
    c, m = c.numpy(), m.numpy()
    assert c.dtype == m.dtype == np.float64
    assert np.array_equal(c, jc)
    assert np.array_equal(np.isnan(m), np.isnan(jm))
    ok = ~np.isnan(jm)
    assert ok.any() and (~ok).any()
    assert np.all(np.abs(m[ok] - jm[ok]) <= 1e-12 * np.abs(jm[ok]))


def test_bin_partial_matches_jax(samples):
    s = samples
    data = s["data"]["uint8"].astype(np.float64)
    data[3, 5:9] = np.nan
    jc, js = map(np.asarray, jregrid.bin_partial(s["jg"], s["lats"], s["lons"],
                                                 data))
    c, sums = tregrid.bin_partial(s["tg"], t(s["lats"]), t(s["lons"]), t(data))
    assert np.array_equal(c.numpy(), jc)
    assert np.all(np.abs(sums.numpy() - js) <= 1e-12 * np.abs(js))
    # method='pallas' is K2 in the 'uint8' mode
    pc, ps = tregrid.bin_partial(s["tg"], t(s["lats"]), t(s["lons"]),
                                 t(data.astype(np.float32)), "pallas")
    kc, ks = trp.bin_partial_pallas2(s["tg"], t(s["lats"]), t(s["lons"]),
                                     t(data.astype(np.float32)), "uint8")
    assert torch.equal(pc, kc) and torch.equal(ps, ks)
    assert np.array_equal(pc.numpy(), jc)


def test_wrappers_refuse_bad_input(samples):
    s = samples
    g = s["tg"]
    flat, valid = tregrid.bin_indices(g, t(s["lats"]), t(s["lons"]))
    iy, ix = split_bin_indices(g, flat, valid)
    good = t(s["data"]["uint8"])
    n = good.shape[-1]
    call = lambda d, mode="uint8", iyix=(iy, ix): trp.bin_partial_pallas_cw(
        g, iyix, d, d.shape[-1], mode)
    call(good)  # accepted
    with pytest.raises(ValueError, match="integers"):
        call(good + 0.5)
    with pytest.raises(ValueError, match="integers"):
        call(torch.where(torch.arange(n) == 0, -1.0, good))
    with pytest.raises(ValueError, match="65536"):
        call(good * 300, "full")
    with pytest.raises(ValueError, match="bf16"):
        call(good + 1e-3, "raw")
    with pytest.raises(ValueError, match="overflow"):
        call(torch.round(good) * 2.0 ** 50, "raw")
    with pytest.raises(ValueError, match="mode"):
        call(good, "bf16")
    with pytest.raises(ValueError):
        call(good, iyix=(iy.long(), ix))
    with pytest.raises(ValueError, match="channels"):
        trp.bin_partial_pallas_cw(g, (iy, ix), good, n + 1)
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent path
        meta = lambda x: x.to("meta")
        trp.bin_partial_pallas_cw(g, (meta(iy), meta(ix)), meta(good), n)
    # NaN data and data at invalid samples are not held to the range
    bad_invalid = good.clone()
    bad_invalid[~valid.reshape(iy.shape)] = 1e30
    bad_invalid[0, 0, 0] = torch.nan
    call(bad_invalid)
