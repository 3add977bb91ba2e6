"""The port's sequence-mosaic path (auromat_tpu_torch.parallel) and K1 on
frame bursts, against the JAX package on the CPU.

* K1 takes a burst: a 2-frame stacked input with n * 255 >= 2^32 bins and
  equals the sum of its one-frame calls; a cell past the uint32 bound and
  a call of 2^32 samples still raise.
* ``DynGeorefParams.stack`` / ``frame`` equal the per-frame calibration.
* The step's finish of K1's int64 sums on the CPU, with and without
  ``finalize``, equals a numpy finish bit for bit on random sums, counts
  past 2^24 and elevation sums at both ends of the fixed-point range, and
  refuses a count past the int64 elevation bound.
* The grid-sharded step on a world of one against JAX
  ``make_grid_sharded_mosaic_step`` on a 1-device CPU mesh ('sorted', and
  'pallas' in interpret mode on a small grid), on a burst of the 128x96
  scaled real frame. The two f32 georeference chains round differently
  (ROADMAP.md F2), so the tolerance is that of
  tests/test_torch_georegrid.py::test_georegrid_mean_matches_jax: equal
  count totals, |d count| <= 1 on < 1% of the cells, means within rtol
  1e-3 / atol 0.05 where the counts agree.
* The same step fed the JAX package's lat/lon/elevation, against the JAX
  package's binning of them: counts and RGB bit-exact, elevation means
  within 0.01 deg (the JAX dry run's class: its 'sorted' binning sums in
  float32, the port's in fixed point or float64).
* ``make_sharded_mosaic_step``, ``sharded_batch_georef`` (float64 chain,
  1e-9 deg) and ``mosaic_sequence`` against JAX; the K1 and index-add
  branches bit-exact on counts and RGB; multi-burst == one step bit for
  bit; null frames add nothing; the ``min_elevation`` premask; NaN
  imagery; the contract errors.
* ``dryrun_multichip(2)`` and ``(4)``: gloo processes, bit-exact against
  the world of one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import auromat_tpu.parallel as jpar
from auromat_tpu.ops.georef import DynGeorefParams as JaxDyn
from auromat_tpu.ops.georef import georef_latlon_dyn as jgeoref_latlon_dyn
from auromat_tpu.ops.regrid import bin_partial as jbin_partial
from auromat_tpu.ops.regrid import finalize_mean as jfinalize_mean
from auromat_tpu.ops.regrid import fixed_grid as jfixed_grid
from auromat_tpu_torch.entry import dryrun_multichip
from auromat_tpu_torch.ops.georef import (DynGeorefParams, GeorefParams,
                                          dyn_params_from_numpy,
                                          georef_latlon_dyn)
from auromat_tpu_torch.ops.georegrid import (MAX_CELL_COUNT,
                                             bin_rgbelev_from_indices,
                                             bin_rgbelev_plain_int,
                                             georegrid_inputs)
from auromat_tpu_torch.ops.regrid import bin_indices, fixed_grid
from auromat_tpu_torch.parallel import (gather_bands,
                                        make_grid_sharded_mosaic_step,
                                        make_mesh, make_sharded_mosaic_step,
                                        mosaic_sequence, null_georef_params,
                                        sharded_batch_georef)
from auromat_tpu_torch.parallel import sharding
from auromat_tpu_torch.parallel.sharding import Mesh
from test_georegrid import small_params
from test_torch_gpu import (FINISH_CASES, assert_bits_equal, numpy_finish,
                            planted_int_sums)

GLOBAL = (2, -89.0, 89.0, -179.0, 179.0)  # 2 px/deg global grid, 355 x 715
REGION = (2, 30.0, 75.0, -140.0, -60.0)  # the small grid of the JAX tests
B = 3


def jitter(p, i):
    return dataclasses.replace(
        p, camera_pos=tuple(c + 5.0 * i for c in p.camera_pos))


@pytest.fixture(scope="module")
def burst():
    """(JAX params, port params, JAX stacked f32 dyn, the port's carried
    copy of it, imgs (B, 96, 128, 3) integer-valued float32)."""
    base, _ = small_params()
    jparams = [jitter(base, i) for i in range(B)]
    tparams = [GeorefParams(**dataclasses.asdict(p)) for p in jparams]
    jdyn = JaxDyn.stack(jparams, dtype=jnp.float32)
    dyn = dyn_params_from_numpy({f: np.asarray(getattr(jdyn, f))
                                 for f in JaxDyn._fields}, "cpu",
                                torch.float32)
    imgs = np.random.default_rng(4).integers(
        0, 256, (B, base.height, base.width, 3)).astype(np.float32)
    return jparams, tparams, jdyn, dyn, imgs


def jmesh1():
    return jpar.make_mesh(jax.devices()[:1])


def assert_mosaic_close(got, want):
    """The f32-chain tolerance class (module docstring); both (count,
    means) as numpy on the same grid."""
    (c, m), (jc, jm) = got, want
    assert c.shape == jc.shape and m.shape == jm.shape
    assert c.sum() > 1000 and c.sum() == jc.sum()
    d = c - jc
    assert np.abs(d).max() <= 1
    assert (d != 0).mean() < 1e-2, (d != 0).mean()
    same = (d == 0) & (c > 0)
    ok = same[..., None] & ~np.isnan(jm)
    assert np.array_equal(np.isnan(m[same]), np.isnan(jm[same]))
    assert_allclose(m[ok], jm[ok], rtol=1e-3, atol=0.05)
    assert np.all(np.isnan(m[c == 0]))


def port_np(mesh, grid, out):
    return tuple(gather_bands(mesh, t, grid.n_lat).numpy() for t in out)


def jax_np(grid, out):
    return tuple(np.asarray(t)[:grid.n_lat] for t in out)


# -- K1 on bursts ------------------------------------------------------------

K1_GRID = fixed_grid((2.0, 1.0), 0.05, 19.95, 0.5, 129.5)  # 39 x 129 cells


def stacked_k1_inputs(h, w, n_frames, valid_rows=7):
    """n_frames stacked (h, w) frames as expanded tensors: the first
    ``valid_rows`` rows of each frame fall into K1_GRID, the rest are
    invalid (cheap to bin, but they count against the sample bound)."""
    rows = torch.arange(n_frames * h, dtype=torch.int32)
    r = rows % h
    iy = torch.where(r < valid_rows, r, -1)[:, None].expand(-1, w)
    ix = (torch.arange(w, dtype=torch.int32) % K1_GRID.n_lon)[None].expand(
        n_frames * h, -1)
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.integers(0, 256, (3, 1, w)).astype(np.float32))
    elev = torch.from_numpy(rng.uniform(-90, 90, (1, w)).astype(np.float32))
    return iy, ix, img.expand(3, n_frames * h, w), elev.expand(n_frames * h, w)


def test_k1_bins_a_burst_above_the_old_bound():
    """Two stacked 2100x4096 frames: 17.2 M samples, 255 x that >= 2^32
    (refused before), few samples a cell. Binned, they equal the sum of
    the two one-frame calls exactly."""
    h, w = 2100, 4096
    iy, ix, img, elev = stacked_k1_inputs(h, w, 2)
    assert iy.numel() * 255 >= 2 ** 32 > h * w * 255
    count, sums = bin_rgbelev_from_indices(K1_GRID, iy, ix, img, elev)
    assert count.sum() == 2 * 7 * w
    both = bin_rgbelev_plain_int(K1_GRID, iy, ix, img, elev)
    parts = [bin_rgbelev_plain_int(K1_GRID, iy[sl], ix[sl], img[:, sl],
                                   elev[sl])
             for sl in (slice(0, h), slice(h, 2 * h))]
    for a, p0, p1 in zip(both, *parts):
        assert torch.equal(a, p0 + p1)
    assert torch.equal(count.reshape(-1), both[0][:, 0].float())


def test_k1_refuses_what_could_wrap():
    # one cell past 16,843,009 samples: its uint32 R/G/B sums could wrap
    n = MAX_CELL_COUNT + 1
    iy = torch.zeros(1, 1, dtype=torch.int32).expand(n // 2, 2)
    img = torch.full((3, 1, 1), 255.0).expand(3, n // 2, 2)
    elev = torch.zeros(1, 1).expand(n // 2, 2)
    assert iy.numel() == n
    with pytest.raises(ValueError, match="overflow"):
        bin_rgbelev_from_indices(K1_GRID, iy, iy, img, elev)
    # 2^32 samples could wrap the counts themselves: refused up front
    big = torch.zeros(1, 1, dtype=torch.int32).expand(2 ** 16, 2 ** 16)
    with pytest.raises(ValueError, match="overflow"):
        bin_rgbelev_from_indices(K1_GRID, big, big,
                                 torch.zeros(1, 1, 1).expand(3, 2 ** 16, 2 ** 16),
                                 torch.zeros(1, 1).expand(2 ** 16, 2 ** 16))


# -- the finish --------------------------------------------------------------

@pytest.mark.parametrize("finalize", [True, False])
@pytest.mark.parametrize("case", FINISH_CASES)
def test_k1_finish_on_the_cpu_as_before(case, finalize):
    """The step's finish of K1's int64 sums on the CPU (the plain route:
    finish_int_sums, then finalize_mean with ``finalize``) equals the numpy
    finish bit for bit, counts its cells (no K1_MEAN launch), and refuses a
    cell past the int64 elevation bound."""
    grid = fixed_grid(*REGION)
    step = make_grid_sharded_mosaic_step(make_mesh(device="cpu"), grid, 8, 8,
                                         bin_method="pallas",
                                         finalize=finalize)
    n_cells = step.band * grid.n_lon
    cnt_rgb, elev_fixed = planted_int_sums(n_cells, case)
    counters = {}
    count, out = step.finish((cnt_rgb, elev_fixed), counters)
    assert counters == {"mean_kernel": 0, "cells": n_cells}
    assert count.shape == (step.band, grid.n_lon)
    assert out.shape == (step.band, grid.n_lon, 4)
    want_c, want_out = numpy_finish(cnt_rgb.numpy(), elev_fixed.numpy(),
                                    finalize)
    assert_bits_equal(count.reshape(-1), torch.from_numpy(want_c), "count")
    assert_bits_equal(out.reshape(-1, 4), torch.from_numpy(want_out), "out")
    assert torch.isnan(out[count == 0]).all() == finalize
    cnt_rgb[n_cells // 2, 0] = sharding._ELEV_INT64_MAX_COUNT + 1
    with pytest.raises(ValueError, match="overflow"):
        step.finish((cnt_rgb, elev_fixed))


# -- calibration stacks ------------------------------------------------------

def test_stack_and_frame_equal_per_frame_params(burst):
    _, tparams, _, carried, _ = burst
    dyn = DynGeorefParams.stack(tparams, dtype=torch.float32, device="cpu")
    assert dyn.cd.shape == (B, 2, 2) and dyn.camera_pos.shape == (B, 3)
    assert dyn.px_ref.shape == (B,)
    for i, p in enumerate(tparams):
        want = DynGeorefParams.from_static(p, "cpu", dtype=torch.float32)
        for a, b, c in zip(dyn.frame(i), want, carried.frame(i)):
            assert torch.equal(a, b) and torch.equal(a, c)


# -- the grid-sharded step against JAX ---------------------------------------

def test_grid_sharded_step_matches_jax_sorted(burst):
    jparams, _, jdyn, dyn, imgs = burst
    h, w = imgs.shape[1:3]
    mesh = make_mesh(device="cpu")
    grid = fixed_grid(*GLOBAL)
    want = jax_np(grid, jpar.make_grid_sharded_mosaic_step(
        jmesh1(), jfixed_grid(*GLOBAL), h, w)(jdyn, imgs))
    for method in ("pallas", "sorted"):
        step = make_grid_sharded_mosaic_step(mesh, grid, h, w,
                                             bin_method=method)
        c, m = step(dyn, imgs)
        assert c.shape == (360, grid.n_lon) and m.shape == (360, grid.n_lon, 4)
        assert c.dtype == torch.float32 and m.dtype == torch.float32
        assert_mosaic_close(port_np(mesh, grid, (c, m)), want)


def test_grid_sharded_step_matches_jax_pallas_interpret(burst):
    _, _, jdyn, dyn, imgs = burst
    h, w = imgs.shape[1:3]
    grid = fixed_grid(*REGION)
    want = jax_np(grid, jpar.make_grid_sharded_mosaic_step(
        jmesh1(), jfixed_grid(*REGION), h, w, bin_method="pallas",
        interpret=True)(jdyn, imgs))
    mesh = make_mesh(device="cpu")
    got = make_grid_sharded_mosaic_step(mesh, grid, h, w,
                                        bin_method="pallas")(dyn, imgs)
    assert_mosaic_close(port_np(mesh, grid, got), want)


_jgeoref = jax.jit(jgeoref_latlon_dyn,
                   static_argnames=("dtype", "with_elevation"))


def jax_georef(dyn, px, py, with_elevation=True):
    """The JAX package's f32 georeference of one port calibration."""
    out = _jgeoref(JaxDyn(*(jnp.asarray(v.numpy()) for v in dyn)),
                   jnp.asarray(px.numpy()), jnp.asarray(py.numpy()),
                   dtype=jnp.float32, with_elevation=with_elevation)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def pixel_grid(h, w, row0=0):
    px = torch.arange(w, dtype=torch.float32)[None].expand(h, w)
    py = torch.arange(row0, row0 + h, dtype=torch.float32)[:, None]
    return px, py.expand(h, w)


@pytest.fixture
def fed_jax_georef(monkeypatch):
    """The port's step georeferences with the JAX package's f32 chain."""
    def georef_cells_jax(grid, dyn, iy, ix, elev, row0=0):
        out = jax_georef(dyn, *pixel_grid(*iy.shape, row0))
        flat, valid = bin_indices(grid, out["lat"], out["lon"])
        iy.copy_(torch.where(valid, flat // grid.n_lon, -1))
        ix.copy_(torch.where(valid, flat % grid.n_lon, -1))
        elev.copy_(out["elevation"])

    monkeypatch.setattr(sharding, "georef_cells", georef_cells_jax)
    monkeypatch.setattr(sharding, "georef_latlon_dyn",
                        lambda d, px, py, dtype, with_elevation:
                        jax_georef(d, px, py, with_elevation))


def test_grid_sharded_step_fed_jax_latlon_is_exact(burst, fed_jax_georef):
    """Given the JAX package's lat/lon/elevation, the port's step bins as
    the JAX package's own binning (``bin_partial``, 'sorted') does."""
    _, _, _, dyn, imgs = burst
    h, w = imgs.shape[1:3]
    mesh = make_mesh(device="cpu")
    for args in (GLOBAL, REGION):
        grid, jgrid = fixed_grid(*args), jfixed_grid(*args)
        jc = js = 0.0
        for i in range(B):
            out = jax_georef(dyn.frame(i), *pixel_grid(h, w))
            data = np.concatenate([imgs[i], out["elevation"].numpy()[..., None]],
                                  axis=-1)
            c, s = jbin_partial(jgrid, jnp.asarray(out["lat"].numpy()),
                                jnp.asarray(out["lon"].numpy()),
                                jnp.asarray(data), "sorted")
            jc, js = jc + c, js + s
        jc, jm = np.asarray(jc), np.asarray(jfinalize_mean(jc, js))
        for method in ("pallas", "sorted"):
            c, m = port_np(mesh, grid, make_grid_sharded_mosaic_step(
                mesh, grid, h, w, bin_method=method)(dyn, imgs))
            assert c.sum() > 1000 and np.array_equal(c, jc)
            assert np.array_equal(m[..., :3], jm[..., :3], equal_nan=True)
            assert np.array_equal(np.isnan(m), np.isnan(jm))
            ok = c > 0
            assert_allclose(m[ok][:, 3], jm[ok][:, 3], rtol=0, atol=0.01)


def test_k1_and_index_add_branches_agree(burst):
    _, _, _, dyn, imgs = burst
    h, w = imgs.shape[1:3]
    mesh = make_mesh(device="cpu")
    grid = fixed_grid(*GLOBAL)
    out = {m: make_grid_sharded_mosaic_step(mesh, grid, h, w, bin_method=m)(
        dyn, imgs) for m in ("pallas", "pallas_plain", "sorted", "segment")}
    # on the CPU both K1 routes are its plain version
    assert all(torch.equal(a.nan_to_num(-1), b.nan_to_num(-1))
               for a, b in zip(out["pallas_plain"], out["pallas"]))
    kc, km = out["pallas"]
    for m in ("sorted", "segment"):
        c, mm = out[m]
        assert torch.equal(c, kc)
        assert torch.equal(mm[..., :3].nan_to_num(-1), km[..., :3].nan_to_num(-1))
        ok = c > 0
        assert torch.allclose(mm[ok][:, 3], km[ok][:, 3], rtol=0, atol=1e-4)


def test_sharded_mosaic_step_matches_jax(burst):
    _, _, jdyn, dyn, imgs = burst
    h, w = imgs.shape[1:3]
    grid = fixed_grid(*REGION)
    want = tuple(np.asarray(t) for t in jpar.make_sharded_mosaic_step(
        jmesh1(), jfixed_grid(*REGION), h, w)(jdyn, imgs))
    c, m = make_sharded_mosaic_step(make_mesh(device="cpu"), grid, h, w)(dyn, imgs)
    assert c.shape == (grid.n_lat, grid.n_lon) and c.dtype == torch.float32
    assert_mosaic_close((c.numpy(), m.numpy()), want)
    gc, _ = make_grid_sharded_mosaic_step(make_mesh(device="cpu"), grid, h, w,
                                          bin_method="pallas")(dyn, imgs)
    assert torch.equal(gc[:grid.n_lat], c)


def test_sharded_batch_georef_matches_jax(burst):
    jparams, tparams, _, _, _ = burst
    h, w = jparams[0].height, jparams[0].width
    want = jpar.sharded_batch_georef(jmesh1(), h, w, dtype=jnp.float64,
                                     with_mlatmlt=True)(
        JaxDyn.stack(jparams, dtype=jnp.float64))
    got = sharded_batch_georef(make_mesh(device="cpu"), h, w, dtype=torch.float64,
                               with_mlatmlt=True)(
        DynGeorefParams.stack(tparams, dtype=torch.float64, device="cpu"))
    assert set(got) == set(want) == {"lat", "lon", "elevation", "mlat", "mlt"}
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape == (B, h, w)
        assert np.array_equal(np.isnan(got[k].numpy()), np.isnan(v))
        ok = ~np.isnan(v)
        assert ok.mean() > 0.3
        assert np.abs(got[k].numpy()[ok] - v[ok]).max() < 1e-9


# -- mosaic_sequence ---------------------------------------------------------

def test_mosaic_sequence_multi_burst_equals_one_step(burst):
    jparams, tparams, jdyn, dyn, imgs = burst
    h, w = imgs.shape[1:3]
    mesh = make_mesh(device="cpu")
    grid = fixed_grid(*GLOBAL)
    one = make_grid_sharded_mosaic_step(mesh, grid, h, w,
                                        bin_method="pallas")(dyn, imgs)
    # bursts of 2 + 1 frames, re-chunked to batch 2: the last padded
    seq = mosaic_sequence(mesh, grid, [(tparams[:2], imgs[:2]),
                                       (tparams[2:], torch.from_numpy(imgs[2:]))],
                          batch=2)
    for a, b in zip(seq, one):
        assert torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0))
    want = jax_np(grid, jpar.mosaic_sequence(
        jmesh1(), jfixed_grid(*GLOBAL), [(jparams, imgs)], batch=2,
        bin_method="sorted"))
    assert_mosaic_close(port_np(mesh, grid, seq), want)
    with pytest.raises(ValueError, match="empty"):
        mosaic_sequence(mesh, grid, [], batch=2)


def test_null_frames_contribute_nothing(burst):
    _, tparams, _, _, imgs = burst
    null = null_georef_params(tparams[0])
    dyn = DynGeorefParams.from_static(null, "cpu", dtype=torch.float32)
    px = torch.arange(null.width, dtype=torch.float32)[None].expand(
        null.height, null.width)
    py = torch.arange(null.height, dtype=torch.float32)[:, None].expand(
        null.height, null.width)
    out = georef_latlon_dyn(dyn, px, py, with_elevation=True)
    assert torch.isnan(out["lat"]).all() and torch.isnan(out["lon"]).all()
    mesh = make_mesh(device="cpu")
    grid = fixed_grid(*GLOBAL)
    c, _ = mosaic_sequence(mesh, grid, [([null] * 2, imgs[:2] + 1.0)], batch=2)
    assert c.sum() == 0


def test_min_elevation_premask(burst):
    jparams, tparams, jdyn, dyn, imgs = burst
    h, w = imgs.shape[1:3]
    thr = 20.0
    mesh = make_mesh(device="cpu")
    grid = fixed_grid(*GLOBAL)
    n_keep = 0
    for i in range(B):
        iy, _, out = georegrid_inputs(grid, dyn.frame(i), h, w)
        n_keep += int(((iy >= 0) & (out["elevation"] >= thr)).sum())
    want = jax_np(grid, jpar.make_grid_sharded_mosaic_step(
        jmesh1(), jfixed_grid(*GLOBAL), h, w, min_elevation=thr)(jdyn, imgs))
    full, _ = make_grid_sharded_mosaic_step(mesh, grid, h, w,
                                            bin_method="pallas")(dyn, imgs)
    for method in ("pallas", "sorted"):
        c, m = make_grid_sharded_mosaic_step(
            mesh, grid, h, w, bin_method=method, min_elevation=thr)(dyn, imgs)
        assert int(c.sum()) == n_keep < int(full.sum())
        assert (m[..., 3][c > 0] >= thr).all()
        assert_mosaic_close(port_np(mesh, grid, (c, m)), want)
    c, _ = mosaic_sequence(mesh, grid, [(tparams, imgs)], batch=B,
                           min_elevation=thr)
    assert int(c.sum()) == n_keep
    with pytest.raises(ValueError, match="with_elevation"):
        make_grid_sharded_mosaic_step(mesh, grid, h, w, with_elevation=False,
                                      min_elevation=thr)


def test_nan_imagery_adds_zero(burst):
    _, _, jdyn, dyn, imgs = burst
    h, w = imgs.shape[1:3]
    imgs = imgs.copy()
    imgs[:, 40:50, :, 1] = np.nan
    mesh = make_mesh(device="cpu")
    grid = fixed_grid(*GLOBAL)
    want = jax_np(grid, jpar.make_grid_sharded_mosaic_step(
        jmesh1(), jfixed_grid(*GLOBAL), h, w)(jdyn, imgs))
    zeroed = np.nan_to_num(imgs, nan=0.0)
    for method in ("pallas", "sorted"):
        step = make_grid_sharded_mosaic_step(mesh, grid, h, w,
                                             bin_method=method)
        c, m = step(dyn, imgs)
        assert torch.isfinite(m[c > 0]).all()
        zc, zm = step(dyn, zeroed)
        assert torch.equal(c, zc) and torch.equal(m.nan_to_num(-1),
                                                   zm.nan_to_num(-1))
        assert_mosaic_close(port_np(mesh, grid, (c, m)), want)


# -- contract ----------------------------------------------------------------

def test_mesh_and_step_contract(burst):
    _, tparams, _, dyn, imgs = burst
    h, w = imgs.shape[1:3]
    grid = fixed_grid(*GLOBAL)
    mesh = make_mesh(device="cpu")
    assert (mesh.dp, mesh.sp, mesh.rank, mesh.size) == (1, 1, 0, 1)
    assert sharding.factorise(8) == (4, 2) and sharding.factorise(2) == (2, 1)
    assert sharding.factorise(4, sp=4) == (1, 4)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(dp=2, device="cpu")
    two = Mesh(dp=2, sp=1, rank=0, device=torch.device("cpu"))
    step = make_grid_sharded_mosaic_step(two, grid, h, w, bin_method="pallas")
    with pytest.raises(ValueError, match="dp=2"):
        step(dyn, imgs)  # 3 frames over 2 ranks
    with pytest.raises(ValueError, match="imgs shape"):
        make_grid_sharded_mosaic_step(mesh, grid, h, w)(dyn, imgs[:, :, :-1])
    with pytest.raises(ValueError, match="sp=2"):
        make_grid_sharded_mosaic_step(Mesh(1, 2, 0, torch.device("cpu")),
                                      grid, 95, w)
    with pytest.raises(ValueError, match="channels=3"):
        make_grid_sharded_mosaic_step(mesh, grid, h, w, channels=1,
                                      bin_method="pallas")
    with pytest.raises(ValueError, match="float32"):
        make_grid_sharded_mosaic_step(mesh, grid, h, w, dtype=torch.float64,
                                      bin_method="pallas")
    with pytest.raises(ValueError, match="divide"):
        mosaic_sequence(two, grid, [(tparams, imgs)], batch=3)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    got = dryrun_multichip(n)
    assert got["pallas_count"].sum() > 1000
    assert np.array_equal(got["seq_count"], got["pallas_count"])
