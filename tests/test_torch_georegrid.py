"""The port's fused georegrid path (auromat_tpu_torch.ops.georegrid).

* K1's plain version against the JAX package's K1 Pallas kernel (interpret
  mode) fed the same (iy, ix, img, elev): count and R/G/B bit-exact;
  elevation within the JAX kernel's limb-split error class
  (per-cell |d sum| / count < 2^-14, as in tests/test_georegrid.py).
* K1-i8's plain version against the JAX int8 kernel (``compute='i8'``,
  interpret mode): count and R/G/B bit-exact; both quantize each
  elevation to the same floor(fl32(e + 90) * 2^16), so the elevation sums
  differ only by the float32 rounding of the JAX recombination (three
  limb sums added in float32) against the port's one rounding of the
  exact sum: |d sum| <= 4 ulp(|sum| + 90 * count).
* The synthetic empty / boundary-row cases of tests/test_georegrid.py.
* The slice: port ``georegrid_mean`` against JAX ``georegrid_mean``
  (interpret mode) on the 128x96 scaled real frame, with the tolerance
  class of tests/test_georegrid.py::test_matches_oracle: the two f32
  georef chains round differently (fma contraction), so a pixel on a cell
  edge may flip to the neighbouring cell.
* CPU tensors take GEOREF_CELLS's plain twin, the eager chain: the same
  bits as the chain written out, row blocks written straight into a
  burst's planes, no launch of the kernel; the planes' refusals; the
  kernel's float32 constants are torch's roundings of the chain's Python
  floats.
* A CUDA request on a machine without CUDA raises.

K1 on the card is tested in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from auromat_tpu.ops.georef import DynGeorefParams as JaxDyn
from auromat_tpu.ops.georegrid import bin_rgbelev_from_indices as jax_k1
from auromat_tpu.ops.georegrid import georegrid_mean as jax_georegrid_mean
from auromat_tpu.ops.regrid import fixed_grid as jax_fixed_grid
from auromat_tpu_torch.entry import entry, frame_setup
from auromat_tpu_torch.ops import _kernels
from auromat_tpu_torch.constants import WGS84_A, WGS84_B
from auromat_tpu_torch.ops.georef import (dyn_params_from_numpy,
                                          georef_latlon_dyn)
from auromat_tpu_torch.ops.georegrid import (_CHAIN_CONSTS, bin_mean_rgbelev,
                                             bin_rgbelev_from_indices,
                                             bin_rgbelev_plain, cell_planes,
                                             georef_cells, georegrid_inputs,
                                             georegrid_mean, georegrid_partial,
                                             split_bin_indices)
from auromat_tpu_torch.ops.regrid import bin_indices, fixed_grid
from test_georegrid import small_params

GRID_ARGS = ((36, 25), 47.0, 62.0, -112.0, -91.0)


@pytest.fixture(scope="module")
def setup():
    params, _ = small_params()
    jdyn = JaxDyn.from_static(params, dtype=jnp.float32)
    dyn = dyn_params_from_numpy({f: np.asarray(getattr(jdyn, f))
                                 for f in JaxDyn._fields}, "cpu", torch.float32)
    h, w = params.height, params.width
    img = np.random.default_rng(3).integers(0, 256, (3, h, w)).astype(np.float32)
    return jdyn, dyn, img


def run_jax_k1(grid_args, iy, ix, img, elev, compute="bf16"):
    c, s = jax_k1(jax_fixed_grid(*grid_args), jnp.asarray(iy), jnp.asarray(ix),
                  jnp.asarray(img), jnp.asarray(elev), interpret=True,
                  compute=compute)
    return np.asarray(c), np.asarray(s)


def run_port_k1(grid_args, iy, ix, img, elev, compute="bf16"):
    c, s = bin_rgbelev_from_indices(fixed_grid(*grid_args),
                                    torch.from_numpy(iy), torch.from_numpy(ix),
                                    torch.from_numpy(img), torch.from_numpy(elev),
                                    compute=compute)
    assert c.dtype == torch.float32 and s.dtype == torch.float32
    return c.numpy(), s.numpy()


def assert_k1_parity(got, want):
    (c, s), (jc, js) = got, want
    assert c.shape == jc.shape and s.shape == js.shape
    assert np.array_equal(c, jc)
    assert np.array_equal(s[..., :3], js[..., :3])
    per_sample = np.abs(s[..., 3] - js[..., 3]) / np.maximum(c, 1)
    assert per_sample.max() < 2 ** -14, per_sample.max()


def test_k1_plain_matches_jax_kernel(setup):
    _, dyn, img = setup
    grid = fixed_grid(*GRID_ARGS)
    iy, ix, out = georegrid_inputs(grid, dyn, *img.shape[1:])
    elev = out["elevation"].numpy()
    elev[5, :40] = np.nan  # NaN data at valid coordinates adds 0
    img = img.copy()
    img[1, 50, :] = np.nan
    args = (GRID_ARGS, iy.numpy(), ix.numpy(), img, elev)
    got, want = run_port_k1(*args), run_jax_k1(*args)
    assert got[0].sum() == (iy.numpy() >= 0).sum() > 1000
    assert_k1_parity(got, want)


def test_k1_i8_plain_matches_jax_kernel(setup):
    _, dyn, img = setup
    grid = fixed_grid(*GRID_ARGS)
    iy, ix, out = georegrid_inputs(grid, dyn, *img.shape[1:])
    elev = out["elevation"].numpy()
    elev[5, :40] = np.nan  # NaN data at valid coordinates adds 0
    img = img.copy()
    img[1, 50, :] = np.nan
    args = (GRID_ARGS, iy.numpy(), ix.numpy(), img, elev)
    (c, s), (jc, js) = run_port_k1(*args, "i8"), run_jax_k1(*args, "i8")
    assert c.sum() == (iy.numpy() >= 0).sum() > 1000
    assert np.array_equal(c, jc) and np.array_equal(s[..., :3], js[..., :3])
    ulp = np.spacing((np.abs(s[..., 3]) + 90 * c).astype(np.float32))
    assert np.all(np.abs(s[..., 3] - js[..., 3]) <= 4 * ulp)
    # the i8 and bf16 modes differ only in the elevation quantization
    cb, sb = run_port_k1(*args)
    assert np.array_equal(c, cb) and np.array_equal(s[..., :3], sb[..., :3])
    assert np.all(np.abs(s[..., 3] - sb[..., 3]) <= c * 2.0 ** -16 + 4 * ulp)


class TestSyntheticIndices:
    """The synthetic cases of tests/test_georegrid.py::TestHullAlignedSlabs
    (the slab machinery they exercised has no counterpart in the port;
    the boundary rows and empty input still do)."""

    GRID = ((2.0, 1.0), 0.05, 19.95, 0.5, 129.5)  # 39 x 129 cells
    H, W = 16, 256

    def _run(self, iy, ix, elev=None):
        img = np.random.default_rng(7).integers(
            0, 256, (3, self.H, self.W)).astype(np.float32)
        if elev is None:
            elev = np.full((self.H, self.W), 12.5, np.float32)
        got = run_port_k1(self.GRID, iy, ix, img, elev)
        assert_k1_parity(got, run_jax_k1(self.GRID, iy, ix, img, elev))
        return got[0], got[1], img

    def _oracle_count(self, iy, ix):
        g = fixed_grid(*self.GRID)
        v = iy >= 0
        return np.bincount(iy[v] * g.n_lon + ix[v], minlength=g.n_lat * g.n_lon
                           ).reshape(g.n_lat, g.n_lon)

    def test_empty_input(self):
        iy = np.full((self.H, self.W), -1, np.int32)
        count, sums, _ = self._run(iy, iy)
        assert np.all(count == 0) and np.all(sums == 0)

    @pytest.mark.parametrize("row", [0, -1])  # first / LAST grid row
    def test_single_boundary_row(self, row):
        g = fixed_grid(*self.GRID)
        row = row % g.n_lat
        rng = np.random.default_rng(1)
        iy = np.full((self.H, self.W), row, np.int32)
        ix = rng.integers(0, g.n_lon, (self.H, self.W)).astype(np.int32)
        iy[:, :7] = -1
        count, sums, img = self._run(iy, ix)
        assert np.array_equal(count, self._oracle_count(iy, ix))
        other = np.ones(g.n_lat, bool)
        other[row] = False
        assert np.all(count[other] == 0) and np.all(sums[other] == 0)
        v = iy >= 0
        assert sums[row, :, 0].sum() == img[0][v].sum()
        assert np.array_equal(sums[row, :, 3], 12.5 * count[row])

    def test_full_grid_random_elevation(self):
        g = fixed_grid(*self.GRID)
        rng = np.random.default_rng(2)
        iy = rng.integers(0, g.n_lat, (self.H, self.W)).astype(np.int32)
        ix = rng.integers(0, g.n_lon, (self.H, self.W)).astype(np.int32)
        iy[0, ::3] = -1
        elev = rng.uniform(-90, 90, (self.H, self.W)).astype(np.float32)
        count, sums, _ = self._run(iy, ix, elev)
        assert np.array_equal(count, self._oracle_count(iy, ix))
        # the fixed-point sum is within float32 rounding of the f64 sum
        want = np.zeros(g.n_lat * g.n_lon)
        v = iy >= 0
        np.add.at(want, iy[v] * g.n_lon + ix[v], elev[v].astype(np.float64))
        assert_allclose(sums[..., 3].ravel(), want, rtol=2e-7, atol=1e-4)


def test_out_of_grid_indices_contribute_nothing():
    g = fixed_grid(*TestSyntheticIndices.GRID)
    iy = np.array([[0, g.n_lat, 3, 3]], np.int32)
    ix = np.array([[0, 0, g.n_lon, -1]], np.int32)
    img = np.full((3, 1, 4), 7.0, np.float32)
    c, s = run_port_k1(TestSyntheticIndices.GRID, iy, ix, img,
                       np.zeros((1, 4), np.float32))
    assert c.sum() == 1 and c[0, 0] == 1 and s[0, 0, 0] == 7.0


@pytest.mark.parametrize("masked", [False, True])
def test_georegrid_mean_matches_jax(setup, masked):
    jdyn, dyn, img = setup
    h, w = img.shape[1:]
    mask = np.zeros((h, w), bool)
    mask[: h // 2] = True
    jc, jm = jax_georegrid_mean(jax_fixed_grid(*GRID_ARGS), jdyn,
                                jnp.asarray(img),
                                mask=jnp.asarray(mask) if masked else None,
                                interpret=True)
    c, m = georegrid_mean(fixed_grid(*GRID_ARGS), dyn, torch.from_numpy(img),
                          mask=torch.from_numpy(mask) if masked else None)
    jc, jm, c, m = np.asarray(jc), np.asarray(jm), c.numpy(), m.numpy()
    assert c.shape == (539, 524) and m.shape == (539, 524, 4)
    assert c.sum() > 1000
    assert c.sum() == jc.sum()
    d = c - jc
    assert np.abs(d).max() <= 1
    assert (d != 0).mean() < 1e-2, (d != 0).mean()
    same = (d == 0) & (c > 0)
    assert np.array_equal(np.isnan(m[same]), np.isnan(jm[same]))
    ok = same[..., None] & ~np.isnan(jm)
    assert_allclose(m[ok], jm[ok], rtol=1e-3, atol=0.05)
    assert np.all(np.isnan(m[c == 0]))
    if masked:
        iy, _, _ = georegrid_inputs(fixed_grid(*GRID_ARGS), dyn, h, w,
                                    torch.from_numpy(mask))
        assert c.sum() == (iy.numpy() >= 0).sum()
        assert np.all(iy.numpy()[: h // 2] == -1)


def _bits(t):
    return t.numpy().view(np.int32) if t.dtype == torch.float32 else t.numpy()


def eager_chain(grid, dyn, h, w, mask=None, row0=0):
    """The eager chain written out: georef_latlon_dyn on the pixel grid,
    the float64 bin_indices, the mask, split_bin_indices."""
    px = torch.arange(w, dtype=torch.float32)[None].expand(h, w)
    py = torch.arange(row0, row0 + h, dtype=torch.float32)[:, None].expand(h, w)
    out = georef_latlon_dyn(dyn, px, py, dtype=torch.float32,
                            with_elevation=True)
    flat, valid = bin_indices(grid, out["lat"], out["lon"])
    if mask is not None:
        valid &= ~mask
    return (*split_bin_indices(grid, flat, valid), out)


@pytest.mark.parametrize("case", ["frame", "masked", "row_block"])
def test_georegrid_inputs_cpu_is_the_eager_chain(setup, case):
    """CPU tensors take GEOREF_CELLS's plain twin, the eager chain: the same
    bits on all five planes, and no launch of the kernel."""
    _, dyn, img = setup
    h, w = img.shape[1:]
    grid = fixed_grid(*GRID_ARGS)
    mask, row0 = None, 0
    if case == "masked":
        mask = torch.zeros((h, w), dtype=torch.bool)
        mask[::3, 5:70] = True
    if case == "row_block":
        h, row0 = 40, 37
    before = _kernels.GEOREF_CELLS.launches
    iy, ix, out = georegrid_inputs(grid, dyn, h, w, mask, row0)
    wiy, wix, want = eager_chain(grid, dyn, h, w, mask, row0)
    assert _kernels.GEOREF_CELLS.launches == before
    assert np.array_equal(_bits(iy), _bits(wiy))
    assert np.array_equal(_bits(ix), _bits(wix))
    for k in ("lat", "lon", "elevation"):
        assert np.array_equal(_bits(out[k]), _bits(want[k])), k
    assert (iy.numpy() >= 0).sum() > 1000 and bool(torch.isnan(out["lat"]).any())


def test_georef_cells_cpu_fills_a_burst(setup):
    """Two row blocks written straight into a burst's planes, as the
    mosaic step writes its frames: each equal to the eager chain."""
    _, dyn, img = setup
    h, w = img.shape[1:]
    grid = fixed_grid(*GRID_ARGS)
    iy, ix, elev = cell_planes(2 * h, w, "cpu")
    lat = torch.empty((h, w))
    lon = torch.empty((h, w))
    before = _kernels.GEOREF_CELLS.launches
    georef_cells(grid, dyn, iy[:h], ix[:h], elev[:h], lat=lat, lon=lon)
    georef_cells(grid, dyn, iy[h:], ix[h:], elev[h:], row0=24)
    assert _kernels.GEOREF_CELLS.launches == before
    for rows, row0, ll in ((slice(0, h), 0, (lat, lon)),
                           (slice(h, 2 * h), 24, None)):
        wiy, wix, want = eager_chain(grid, dyn, h, w, row0=row0)
        assert np.array_equal(_bits(iy[rows]), _bits(wiy))
        assert np.array_equal(_bits(ix[rows]), _bits(wix))
        assert np.array_equal(_bits(elev[rows]), _bits(want["elevation"]))
        if ll is not None:
            assert np.array_equal(_bits(ll[0]), _bits(want["lat"]))
            assert np.array_equal(_bits(ll[1]), _bits(want["lon"]))


def test_georegrid_partial_cpu_bins_the_eager_cells(setup):
    _, dyn, img = setup
    grid = fixed_grid(*GRID_ARGS)
    iy, ix, want = eager_chain(grid, dyn, *img.shape[1:])
    t = torch.from_numpy(img)
    pc, ps = bin_rgbelev_plain(grid, iy, ix, t, want["elevation"])
    c, s = georegrid_partial(grid, dyn, t)
    assert torch.equal(c, pc) and torch.equal(s, ps)


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided", "lat_alone",
                                 "device"])
def test_georef_cells_refuses_bad_planes(setup, bad):
    _, dyn, img = setup
    h, w = img.shape[1:]
    iy, ix, elev = cell_planes(h, w, "cpu")
    kw = {}
    if bad == "shape":
        elev = elev[:-1]
    if bad == "dtype":
        ix = ix.long()
    if bad == "strided":
        iy = torch.empty((w, h), dtype=torch.int32).t()
    if bad == "lat_alone":
        kw["lat"] = torch.empty((h, w))
    if bad == "device":
        elev = elev.to("meta")
    before = _kernels.GEOREF_CELLS.launches
    with pytest.raises(ValueError):
        georef_cells(fixed_grid(*GRID_ARGS), dyn, iy, ix, elev, **kw)
    assert _kernels.GEOREF_CELLS.launches == before


def test_chain_constants_round_as_torch():
    """GEOREF_CELLS's float32 constants are the eager chain's Python floats
    as torch rounds them when they meet a float32 tensor."""
    u = 180.0 / np.pi
    a2b2 = WGS84_A * WGS84_A - WGS84_B * WGS84_B
    floats = (u * u, u, WGS84_A, WGS84_B, a2b2 / WGS84_B,
              a2b2 / (WGS84_A * WGS84_A) * WGS84_A)
    one = torch.ones((), dtype=torch.float32)
    assert _CHAIN_CONSTS[:6] == tuple((one * v).item() for v in floats)
    assert _CHAIN_CONSTS[6] == torch.rad2deg(one).item()


def test_bin_mean_rgbelev_matches_partial(setup):
    _, dyn, img = setup
    grid = fixed_grid(*GRID_ARGS)
    h, w = img.shape[1:]
    _, _, out = georegrid_inputs(grid, dyn, h, w)
    data = torch.cat([torch.from_numpy(img).permute(1, 2, 0),
                      out["elevation"][..., None]], dim=-1)
    count, means = bin_mean_rgbelev(grid, out["lat"], out["lon"], data)
    pc, ps = georegrid_partial(grid, dyn, torch.from_numpy(img))
    assert torch.equal(count, pc)
    ok = pc > 0
    assert torch.equal(means[ok], ps[ok] / pc[ok][:, None])


def test_k1_contract_errors(setup):
    _, dyn, img = setup
    grid = fixed_grid(*GRID_ARGS)
    iy, ix, out = georegrid_inputs(grid, dyn, *img.shape[1:])
    t = torch.from_numpy(img)
    with pytest.raises(ValueError, match="compute"):
        bin_rgbelev_from_indices(grid, iy, ix, t, out["elevation"], compute="i4")
    with pytest.raises(ValueError):
        bin_rgbelev_from_indices(grid, iy, ix, t.double(), out["elevation"])
    with pytest.raises(ValueError):
        bin_rgbelev_from_indices(grid, iy.long(), ix, t, out["elevation"])
    with pytest.raises(ValueError):  # neither cpu nor cuda: no silent path
        meta = lambda x: x.to("meta")
        bin_rgbelev_from_indices(grid, meta(iy), meta(ix), meta(t),
                                 meta(out["elevation"]))


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        entry()
    with pytest.raises(RuntimeError, match="cuda"):
        frame_setup("cuda")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_kernels, "_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.find_nvcc()
    k = _kernels.CudaKernel("georegrid_bin.cu", "georegrid_bin_launch", [])
    with pytest.raises(RuntimeError, match="nvcc"):
        k.build()
    assert k.launches == 0
    assert not (tmp_path / "build").exists()
