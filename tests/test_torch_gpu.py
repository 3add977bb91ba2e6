"""The port's CUDA kernels on the card (marked ``gpu``; each test skips
without a CUDA device).

This file imports neither jax nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: ``tests/conftest.py`` configures jax.)

* K1 against its plain version on the same CUDA tensors: bit-equal on all
  five outputs, since both sum in integers (order-independent atomics).
* The main path on the card against the same path on the CPU. The f32
  georeference chain rounds differently on the two devices (their
  transcendental functions differ in the last ulps), so a pixel on a cell
  edge may move to the neighbouring cell; the bounds are those of the CPU
  comparison with the JAX package (tests/test_torch_georegrid.py).
* The wrapper refuses what the kernel does not take.
* K2 in every mode (and the taint stack), K3's entry and K1-i8 against
  their plain versions at the full frame's bin indices: bit-equal.
* ``resample`` on the card (the K1 and K2 routes) against ``resample`` on
  the CPU for the same mapping: masks equal, uint8 within one step on at
  most 0.1% of the cells (the K1/K2 routes divide in float32).
* K1 on an 8-frame stacked burst of the 12 MP frame (above the old
  h*w*255 < 2^32 bound) bit-equal to its plain version; a cell past the
  uint32 bound raises after the kernel, 2^32 samples before it.
* The grid-sharded mosaic step on the card: K1 == its plain version bit
  for bit, one launch per burst, and the CPU's result within the bounds
  above.
* The tile histograms' paths: seeded random indices over the whole grid
  (every tile's cell box overflows shared memory: the warp-aggregated
  fallback), ragged planes (w not a multiple of 4 or of the 128-column
  tile, one row, no valid sample, bases off the 16-byte vector alignment),
  all bit-equal to the plain versions for K1, K1-i8, K2 (every mode) and
  K3; and the refusals (a cell past MAX_CELL_COUNT, an out-of-range K2
  channel) raise the plain version's message.
* The all-sky-imager path on the card against the CPU: take-best and its
  plan (NaN, -NaN, -0.0 and +0.0 priorities, all-invalid input) and the
  jump-flood nearest bit-equal; the structured linear/cubic interpolators
  within 1e-9 with equal NaN masks; a MIRACLE mapping built on the card,
  its resample routes ('nearest' takes the device route; 'mean' launches
  K1 and equals K1's plain twin) and ``mosaic``; ``reproject_batch``.
* The magnetic grid and the generic projections on the card against the
  CPU: ``resample_mlat_mlt`` (K1 and K2 routes; grids within 1e-9 deg,
  masks equal, uint8 within one step on at most 0.1% of the cells) and
  ``georeference_points_generic`` in float64 for ZEA, HPX, QSC and PCO
  (1e-9 deg, NaN masks equal; float32 stays float32).
* The ISS archive path on the card against the CPU: the lens distortion
  correction (ptlens, poly3, poly5; uint8 and uint16, numpy and tensor
  inputs) within one step on at most 1e-3 of the values; the ISS
  provider's array route (flip, poly3 correction, crop, ``create_mapping``)
  on a seeded frame at the scaled calibration, grids within 1e-9 deg of the
  CPU's; ``resample`` of it launches K1; its CDF and NETCDF3 exports read
  back and resampled on the card give the same uint8 image; the TLE camera
  position through ``create_mapping`` on the card; ``profiling.benchmark``
  times CUDA outputs with events, and ``profiling.span`` the stream; the
  fused frame and the library slice record their spans in order, with
  stream times and the bytes of each copy.
* The solving path's checks on the card against the CPU:
  ``is_consistent``/``intersects_earth`` on the ISS030 header and on it
  turned to nadir and zenith (the same booleans, float64 latitudes within
  1e-9 deg, NaN masks equal), and ``util.histogram.histogram2d`` with a
  list of weights (counts and edges equal, sums within 1e-12 relative);
  ``io.fits.get_catalog_stars('bright')`` and
  ``recompute_xyls_pixel_positions``, projected in float64 on the card,
  within 1e-9 px of the CPU's.
* The star-field masking on the card: HOUGH_P (``ops/csrc/hough_p.cu``)
  against ``_hough_p_plain`` (the same lines in the same order, the same
  four trajectory counts, one launch of HOUGH_P and one of HOUGH_ORDER a
  call) on chip_smoke.py's seeded 240x320 frames at thresholds 200 and
  60, on its stress frames and on both checked-in frames' Hough inputs,
  and its refusal of more angles than its block has threads; HOUGH_ORDER
  (``ops/csrc/hough_order.cu``) equal to ``_hough_order`` at counts from 0
  to 910,556; ``hough_lines_p`` on a CUDA tensor with ``_hough_order``
  made to raise (the order is drawn on the card); ``mask_starfield`` of
  chip_smoke.py's seeded 4256x2832 star-field frame on the card equal to
  the CPU's (pixels and sigma), each Hough kernel launched once and the
  contour kernels once a binarization.
* The contour stage on the card: CCL8 and CCL4 (``ops/csrc/ccl.cu``) of
  the set and the unset pixels bit-equal to ``_ccl_plain``, and
  ``external_contours`` (CCL4, the hole fill, CCL8, CONTOUR_TRACE from
  ``ops/csrc/contour_trace.cu``) equal to its plain route (roots, labels,
  doubled areas, boxes, chain lengths, simple counts and points in order)
  on chip_smoke.py's contour stress frames and the checked-in frames'
  binarizations (tests/resources/contour_input_*.npz);
  ``mask_starfield`` on a CUDA tensor with scipy's labelling, the host
  border follower and the host polygon raster made to raise.
* The drawing layer's numeric helpers on the card against the CPU, on a
  512x384 mapping of the scaled calibration: the KML overlay (its
  ``resample('mean')`` launches K1; KML text and RGBA equal), the horizon
  hit mask (equal), the RA/Dec grid and the constellation end points
  (within 1e-9).
"""

import os

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from auromat_tpu_torch.coordinates.wcs import TanWcs
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.ops import _kernels
from auromat_tpu_torch.ops.georef import DynGeorefParams, GeorefParams
from auromat_tpu_torch.ops.georegrid import (bin_rgbelev_from_indices,
                                             bin_rgbelev_plain,
                                             georegrid_inputs, georegrid_mean)
from auromat_tpu_torch.ops import regrid_pallas as rp
from auromat_tpu_torch.ops.regrid import bin_indices, fixed_grid
from torch_solving_stand_ins import pointed

RES = os.path.join(os.path.dirname(__file__), "resources")
GRID = fixed_grid((36, 25), 47.0, 62.0, -112.0, -91.0)


def small_params(w=128, h=96):
    """The real ISS030-E-102170 calibration scaled down to (h, w) pixels
    (the port's twin of tests/test_georegrid.py::small_params)."""
    header = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    base = GeorefParams.from_wcs(
        TanWcs(header), fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_photo_time(header), altitude=110.0)
    scale = base.width / w
    return GeorefParams(
        width=w, height=h,
        cd=tuple(tuple(v * scale for v in row) for row in base.cd),
        px_ref=base.px_ref / scale, py_ref=base.py_ref / scale,
        rotmat=base.rotmat, camera_pos=base.camera_pos,
        altitude=base.altitude, mat_j2000_to_geo=base.mat_j2000_to_geo,
        mat_j2000_to_sm=base.mat_j2000_to_sm)


def small_dyn(device, w=128, h=96):
    """:func:`small_params` as float32 on ``device``."""
    return DynGeorefParams.from_static(small_params(w, h), device,
                                       torch.float32), h, w


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def frame():
    return np.random.default_rng(3).integers(0, 256, (3, 96, 128)
                                             ).astype(np.float32)


@pytest.mark.gpu
def test_k1_kernel_matches_plain(cuda, frame):
    dyn, h, w = small_dyn(cuda)
    iy, ix, out = georegrid_inputs(GRID, dyn, h, w)
    img = torch.from_numpy(frame).to(cuda)
    elev = out["elevation"].clone()
    elev[5, :40] = torch.nan  # NaN data at valid coordinates adds 0
    img[1, 50, :] = torch.nan
    before = _kernels.GEOREGRID_BIN.launches
    kc, ks = bin_rgbelev_from_indices(GRID, iy, ix, img, elev)
    pc, ps = bin_rgbelev_plain(GRID, iy, ix, img, elev)
    torch.cuda.synchronize()
    assert _kernels.GEOREGRID_BIN.launches == before + 1
    assert torch.equal(kc, pc) and torch.equal(ks, ps)
    assert kc.sum().item() == (iy >= 0).sum().item() > 1000


@pytest.mark.gpu
def test_k1_kernel_full_grid_random(cuda):
    """Every cell of a small grid hit, elevations over their whole range."""
    rng = np.random.default_rng(2)
    g = fixed_grid((2.0, 1.0), 0.05, 19.95, 0.5, 129.5)
    shape = (64, 256)
    iy = torch.from_numpy(rng.integers(-1, g.n_lat, shape).astype(np.int32))
    ix = torch.from_numpy(rng.integers(0, g.n_lon, shape).astype(np.int32))
    img = torch.from_numpy(rng.integers(0, 256, (3,) + shape).astype(np.float32))
    elev = torch.from_numpy(rng.uniform(-90, 90, shape).astype(np.float32))
    args = [t.to(cuda) for t in (iy, ix, img, elev)]
    kc, ks = bin_rgbelev_from_indices(g, *args)
    pc, ps = bin_rgbelev_plain(g, *args)
    cc, cs = bin_rgbelev_plain(g, iy, ix, img, elev)  # the CPU's plain
    assert torch.equal(kc, pc) and torch.equal(ks, ps)
    assert torch.equal(kc.cpu(), cc) and torch.equal(ks.cpu(), cs)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True])
def test_georegrid_mean_gpu_matches_cpu(cuda, frame, masked):
    dyn_c, h, w = small_dyn("cpu")
    dyn_g, _, _ = small_dyn(cuda)
    mask = torch.zeros((h, w), dtype=torch.bool)
    mask[: h // 2] = True
    m = mask if masked else None
    c, mean = georegrid_mean(GRID, dyn_c, torch.from_numpy(frame), m)
    before = _kernels.GEOREGRID_BIN.launches
    gc, gmean = georegrid_mean(GRID, dyn_g, torch.from_numpy(frame).to(cuda),
                               None if m is None else m.to(cuda))
    assert _kernels.GEOREGRID_BIN.launches == before + 1
    gc, gmean = gc.cpu().numpy(), gmean.cpu().numpy()
    c, mean = c.numpy(), mean.numpy()
    assert gc.shape == (GRID.n_lat, GRID.n_lon)
    assert c.sum() > 1000 and gc.sum() == c.sum()
    d = gc - c
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-2
    same = (d == 0) & (c > 0)
    ok = same[..., None] & ~np.isnan(mean)
    assert_allclose(gmean[ok], mean[ok], rtol=1e-3, atol=0.05)
    assert np.all(np.isnan(gmean[gc == 0]))


@pytest.mark.gpu
def test_k1_wrapper_refuses_bad_input(cuda, frame):
    dyn, h, w = small_dyn(cuda)
    iy, ix, out = georegrid_inputs(GRID, dyn, h, w)
    img = torch.from_numpy(frame).to(cuda)
    elev = out["elevation"]
    with pytest.raises(ValueError, match="contiguous"):
        bin_rgbelev_from_indices(GRID, iy.t().contiguous().t(), ix, img, elev)
    with pytest.raises(ValueError):  # mixed devices
        bin_rgbelev_from_indices(GRID, iy, ix, img.cpu(), elev)
    with pytest.raises(ValueError):
        bin_rgbelev_from_indices(GRID, iy, ix, img.half(), elev)


@pytest.fixture(scope="module")
def full_frame():
    """(grid, iy, ix, lat, lon, elevation) of the full 4256x2832 frame on
    the card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from auromat_tpu_torch.entry import frame_setup

    grid, dyn, params = frame_setup("cuda")
    iy, ix, out = georegrid_inputs(grid, dyn, params.height, params.width)
    return grid, iy, ix, out["lat"], out["lon"], out["elevation"]


def k2_data(kind, shape, elev):
    """Seeded (h, w, n_ch) float32 data on the card for each K2 mode."""
    g = torch.Generator(device="cuda").manual_seed(7)
    rand = lambda c: torch.rand(shape + (c,), generator=g, device="cuda")
    if kind == "uint8":
        return torch.cat([torch.floor(rand(3) * 256), elev[..., None]], -1)
    if kind == "taint":  # 3 image, 4 taint indicators, elevation
        return torch.cat([torch.floor(rand(3) * 256),
                          (rand(4) < 0.01).float(), elev[..., None]], -1)
    if kind == "full":
        return rand(2) * 65535.0
    return (rand(2) * 200 - 100).to(torch.bfloat16).float()  # raw


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["uint8", "taint", "full", "raw"])
def test_k2_kernel_matches_plain_full_frame(full_frame, kind):
    grid, iy, ix, _, _, elev = full_frame
    data = k2_data(kind, tuple(iy.shape), elev)
    mode = "uint8" if kind == "taint" else kind
    before = _kernels.REGRID_BIN.launches
    kc, ks = rp.bin_partial_pallas_cw(grid, (iy, ix), data, data.shape[-1], mode)
    pc, ps = rp.bin_partial_cw_plain(grid, iy, ix, data, mode)
    torch.cuda.synchronize()
    assert _kernels.REGRID_BIN.launches == before + 1
    assert torch.equal(kc, pc) and torch.equal(ks, ps)
    assert kc.sum().item() == (iy >= 0).sum().item() > 6_000_000


@pytest.mark.gpu
def test_k3_entry_matches_plain_full_frame(full_frame):
    grid, iy, ix, lat, lon, elev = full_frame
    data = k2_data("uint8", tuple(iy.shape), elev)
    before = _kernels.REGRID_BIN_V1.launches
    kc, ks = rp.bin_partial_pallas(grid, lat, lon, data, "uint8")
    flat, valid = bin_indices(grid, lat, lon)
    assert torch.equal(torch.where(valid, flat // grid.n_lon, -1).int(), iy)
    pc, ps = rp.bin_partial_cw_plain(grid, iy, ix, data, "uint8")
    torch.cuda.synchronize()
    assert _kernels.REGRID_BIN_V1.launches == before + 1
    assert torch.equal(kc, pc) and torch.equal(ks, ps)


@pytest.mark.gpu
def test_k1_i8_kernel_matches_plain_full_frame(full_frame):
    grid, iy, ix, _, _, elev = full_frame
    img = k2_data("uint8", tuple(iy.shape), elev)[..., :3]
    img = img.permute(2, 0, 1).contiguous()
    before = _kernels.GEOREGRID_BIN_I8.launches
    kc, ks = bin_rgbelev_from_indices(grid, iy, ix, img, elev, compute="i8")
    pc, ps = bin_rgbelev_plain(grid, iy, ix, img, elev, compute="i8")
    torch.cuda.synchronize()
    assert _kernels.GEOREGRID_BIN_I8.launches == before + 1
    assert torch.equal(kc, pc) and torch.equal(ks, ps)


@pytest.mark.gpu
def test_k2_wrapper_refuses_bad_input(cuda, frame):
    dyn, h, w = small_dyn(cuda)
    iy, ix, out = georegrid_inputs(GRID, dyn, h, w)
    data = torch.from_numpy(frame).to(cuda).permute(1, 2, 0).contiguous()
    call = lambda d, mode="uint8", i=iy: rp.bin_partial_pallas_cw(
        GRID, (i, ix), d, d.shape[-1], mode)
    call(data)
    with pytest.raises(ValueError, match="contiguous"):
        call(data, i=iy.t().contiguous().t())
    with pytest.raises(ValueError, match="integers"):
        call(data + 0.5)
    with pytest.raises(ValueError, match="65536"):
        call(data * 1000, "full")
    with pytest.raises(ValueError, match="overflow"):
        call(torch.round(data) * 2.0 ** 50, "raw")
    with pytest.raises(ValueError):  # mixed devices
        call(data.cpu())


@pytest.mark.gpu
def test_resample_gpu_matches_cpu(cuda):
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from auromat_tpu_torch.resample import resample

    header = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    scale = header["IMAGEW"] / 512
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        header[k] = header[k] * scale
    header["CRPIX1"], header["CRPIX2"] = (header["CRPIX1"] / scale,
                                          header["CRPIX2"] / scale)
    header["IMAGEW"], header["IMAGEH"] = 512, 384
    img = np.random.default_rng(3).integers(0, 256, (384, 512, 3), dtype=np.uint8)
    m = create_mapping(header, img, fits.get_shifted_spacecraft_position(header)[:3],
                       fits.get_shifted_photo_time(header), device=cuda)
    want = resample(m, px_per_deg=5, device="cpu")
    for method, kernel in (("auto", _kernels.GEOREGRID_BIN),
                           ("pallas_taint", _kernels.REGRID_BIN)):
        before = kernel.launches
        got = resample(m, px_per_deg=5, bin_method=method, device=cuda)
        assert kernel.launches == before + 1
        assert np.array_equal(got.lats.data, want.lats.data)
        mask = np.ma.getmaskarray(got.img)
        assert np.array_equal(mask, np.ma.getmaskarray(want.img))
        ok = ~mask
        assert ok.mean() > 0.2
        d = np.abs(got.img.data.astype(int) - want.img.data.astype(int))[ok]
        assert d.max() <= 1 and (d == 1).mean() < 1e-3
        e = np.abs(got.elevation.data - want.elevation.data)[ok[..., 0]]
        assert e.max() < 1e-4


@pytest.mark.gpu
def test_k1_kernel_matches_plain_8_frame_burst(full_frame):
    grid, iy, ix, _, _, elev = full_frame
    n = 8
    iy8, ix8 = iy.repeat(n, 1), ix.repeat(n, 1)
    g = torch.Generator(device="cuda").manual_seed(11)
    img = torch.floor(torch.rand((3,) + tuple(iy8.shape), generator=g,
                                 device="cuda") * 256)
    el8 = elev.repeat(n, 1)
    assert iy8.numel() * 255 >= 2 ** 32
    before = _kernels.GEOREGRID_BIN.launches
    kc, ks = bin_rgbelev_from_indices(grid, iy8, ix8, img, el8)
    pc, ps = bin_rgbelev_plain(grid, iy8, ix8, img, el8)
    torch.cuda.synchronize()
    assert _kernels.GEOREGRID_BIN.launches == before + 1
    assert torch.equal(kc, pc) and torch.equal(ks, ps)
    assert kc.sum().item() == n * (iy >= 0).sum().item()


@pytest.mark.gpu
def test_k1_refuses_what_could_wrap_on_cuda(cuda):
    from auromat_tpu_torch.ops.georegrid import MAX_CELL_COUNT

    g = fixed_grid((2.0, 1.0), 0.05, 19.95, 0.5, 129.5)
    n = MAX_CELL_COUNT + 1
    iy = torch.zeros((n // 2, 2), dtype=torch.int32, device=cuda)
    img = torch.full((3, n // 2, 2), 255.0, device=cuda)
    elev = torch.zeros((n // 2, 2), device=cuda)
    with pytest.raises(ValueError, match="overflow"):
        bin_rgbelev_from_indices(g, iy, iy, img, elev)
    big = torch.zeros(1, 1, dtype=torch.int32, device=cuda).expand(2 ** 16,
                                                                   2 ** 16)
    before = _kernels.GEOREGRID_BIN.launches
    with pytest.raises(ValueError, match="overflow"):
        bin_rgbelev_from_indices(
            g, big, big, torch.zeros(1, 1, 1, device=cuda).expand(3, 2 ** 16, 2 ** 16),
            torch.zeros(1, 1, device=cuda).expand(2 ** 16, 2 ** 16))
    assert _kernels.GEOREGRID_BIN.launches == before


@pytest.mark.gpu
def test_grid_sharded_step_on_cuda(cuda):
    import dataclasses

    from auromat_tpu_torch.parallel import (make_grid_sharded_mosaic_step,
                                            make_mesh)

    p = small_params()
    h, w = p.height, p.width
    params = [dataclasses.replace(p, camera_pos=tuple(
        c + 5.0 * i for c in p.camera_pos)) for i in range(3)]
    imgs = np.random.default_rng(4).integers(0, 256, (3, h, w, 3), np.uint8)
    grid = fixed_grid(2, -89.0, 89.0, -179.0, 179.0)
    out = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh(device=dev)
        d = DynGeorefParams.stack(params, device=dev)
        for b in ("pallas", "pallas_plain"):
            before = _kernels.GEOREGRID_BIN.launches
            out[str(dev), b] = [t.cpu().numpy() for t in
                                make_grid_sharded_mosaic_step(
                                    mesh, grid, h, w, bin_method=b)(d, imgs)]
            launched = _kernels.GEOREGRID_BIN.launches - before
            assert launched == (1 if (dev != "cpu" and b == "pallas") else 0)
    (c, m), (pc, pm) = out["cuda", "pallas"], out["cuda", "pallas_plain"]
    assert np.array_equal(c, pc) and np.array_equal(m, pm, equal_nan=True)
    cc, cm = out["cpu", "pallas"]
    assert c.sum() > 1000 and c.sum() == cc.sum()
    d = c - cc
    assert np.abs(d).max() <= 1 and (d != 0).mean() < 1e-2
    ok = ((d == 0) & (c > 0))[..., None] & ~np.isnan(cm)
    assert_allclose(m[ok], cm[ok], rtol=1e-3, atol=0.05)


def all_kernels(g, iy, ix, img, elev, data):
    """(name, kernel result, plain result) of K1, K1-i8, K2 in every mode
    and K3's plain twin, on the same CUDA tensors; ``img`` (3, n, w)
    integer-valued, ``data`` (n, w, 4) = image + elevation."""
    out = []
    for compute in ("bf16", "i8"):
        out.append((f"K1 {compute}",
                    bin_rgbelev_from_indices(g, iy, ix, img, elev, compute),
                    bin_rgbelev_plain(g, iy, ix, img, elev, compute)))
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = tuple(iy.shape)
    kinds = {"uint8": data,
             "taint": torch.cat([data[..., :3], (torch.rand(
                 shape + (4,), generator=gen, device="cuda") < 0.3).float(),
                 data[..., 3:]], -1),
             "full": torch.rand(shape + (2,), generator=gen,
                                device="cuda") * 65535.0,
             "raw": (torch.rand(shape + (3,), generator=gen, device="cuda")
                     * 200 - 100).to(torch.bfloat16).float()}
    for kind, d in kinds.items():
        mode = "uint8" if kind == "taint" else kind
        d = d.contiguous()
        out.append((f"K2 {kind}",
                    rp.bin_partial_pallas_cw(g, (iy, ix), d, d.shape[-1], mode),
                    rp.bin_partial_cw_plain(g, iy, ix, d, mode)))
    return out


def assert_all_equal(results, n_valid):
    torch.cuda.synchronize()
    for name, (kc, ks), (pc, ps) in results:
        assert torch.equal(kc, pc), name
        assert torch.equal(ks, ps), name
        assert int(kc.sum(dtype=torch.float64).item()) == n_valid, name


def random_inputs(g, shape, seed, offset=0):
    """Seeded iy, ix over the whole grid (10% invalid, some past its edge),
    image and elevation (some NaN) on the card; ``offset`` > 0 cuts every
    tensor from a buffer that many elements in, off the vector alignment."""
    rng = np.random.default_rng(seed)
    iy = rng.integers(0, g.n_lat, shape)
    ix = rng.integers(0, g.n_lon + 2, shape)
    iy[rng.random(shape) < 0.1] = -1
    img = rng.integers(0, 256, (3,) + shape).astype(np.float32)
    elev = rng.uniform(-90, 90, shape).astype(np.float32)
    elev[rng.random(shape) < 0.01] = np.nan

    def dev(a, dtype):
        flat = torch.zeros(a.size + offset, dtype=dtype, device="cuda")
        t = flat[offset:].view(a.shape)
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        return t

    iy, ix = dev(iy, torch.int32), dev(ix, torch.int32)
    img, elev = dev(img, torch.float32), dev(elev, torch.float32)
    data = dev(np.concatenate([np.moveaxis(img.cpu().numpy(), 0, -1),
                               elev.cpu().numpy()[..., None]], -1),
               torch.float32)
    valid = (iy >= 0) & (iy < g.n_lat) & (ix >= 0) & (ix < g.n_lon)
    return iy, ix, img, elev, data, int(valid.sum().item())


@pytest.mark.gpu
def test_kernels_fallback_path_random_cells(cuda):
    """Random cells over the 539x524 grid: every tile's box is the whole
    grid, far past shared memory, so every tile takes the fallback."""
    iy, ix, img, elev, data, n_valid = random_inputs(GRID, (2832, 4256), 0)
    assert n_valid > 10_000_000
    assert_all_equal(all_kernels(GRID, iy, ix, img, elev, data), n_valid)
    # K3's entry, from seeded coordinates over the grid's extent
    rng = np.random.default_rng(6)
    lat = torch.from_numpy(rng.uniform(46.9, 62.1, (2832, 4256))).cuda()
    lon = torch.from_numpy(rng.uniform(-112.1, -90.9, (2832, 4256))).cuda()
    before = _kernels.REGRID_BIN_V1.launches
    got = rp.bin_partial_pallas(GRID, lat, lon, data, "uint8")
    want = rp.bin_partial_pallas_plain(GRID, lat, lon, data, "uint8")
    assert_all_equal([("K3", got, want)],
                     int((bin_indices(GRID, lat, lon)[1]).sum().item()))
    assert _kernels.REGRID_BIN_V1.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape,offset", [
    ((96, 131), 0), ((37, 4257), 0), ((1, 4256), 0), ((1, 3), 0),
    ((64, 256), 1), ((33, 130), 2)],
    ids=["w131", "w4257", "one-row", "one-row-w3", "unaligned",
         "unaligned-w130"])
def test_kernels_ragged_planes(cuda, shape, offset):
    iy, ix, img, elev, data, n_valid = random_inputs(
        fixed_grid((2.0, 1.0), 0.05, 19.95, 0.5, 129.5), shape, 1, offset)
    g = fixed_grid((2.0, 1.0), 0.05, 19.95, 0.5, 129.5)
    assert_all_equal(all_kernels(g, iy, ix, img, elev, data), n_valid)


@pytest.mark.gpu
def test_kernels_no_valid_sample(cuda):
    iy, ix, img, elev, data, _ = random_inputs(GRID, (64, 512), 2)
    iy.fill_(-1)
    results = all_kernels(GRID, iy, ix, img, elev, data)
    assert_all_equal(results, 0)
    for name, (kc, ks), _ in results:
        assert not kc.any() and not ks.any(), name


@pytest.mark.gpu
def test_kernels_fast_and_fallback_tiles_mixed(full_frame):
    """The frame's own cells (fast path), with one band of rows moved to
    random cells (fallback) and a burst of two frames whose tiles straddle
    the frame boundary (2832 is not a multiple of the 32-row tile)."""
    grid, iy, ix, _, _, elev = full_frame
    rng = np.random.default_rng(9)
    iy2, ix2 = iy.clone(), ix.clone()
    rows = slice(1000, 1100)
    iy2[rows] = torch.from_numpy(rng.integers(0, grid.n_lat, (100, iy.shape[1]))
                                 .astype(np.int32)).cuda()
    ix2[rows] = torch.from_numpy(rng.integers(0, grid.n_lon, (100, iy.shape[1]))
                                 .astype(np.int32)).cuda()
    iyb, ixb = torch.cat([iy, iy2]), torch.cat([ix, ix2])
    elb = torch.cat([elev, elev])
    g = torch.Generator(device="cuda").manual_seed(3)
    img = torch.floor(torch.rand((3,) + tuple(iyb.shape), generator=g,
                                 device="cuda") * 256)
    data = torch.cat([img.permute(1, 2, 0), elb[..., None]], -1).contiguous()
    n_valid = int((iyb >= 0).sum().item())
    assert_all_equal(all_kernels(grid, iyb, ixb, img, elb, data), n_valid)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 4096], ids=["fast", "fallback"])
def test_k1_cell_count_refusal_matches_plain(cuda, w):
    """MAX_CELL_COUNT + 1 samples in one cell (w=2: every tile's box is
    that one cell; w=4096: a sample in a far cell on every row spreads
    each tile's box past shared memory) raise the plain version's message."""
    from auromat_tpu_torch.ops.georegrid import MAX_CELL_COUNT

    g = fixed_grid((2.0, 1.0), 0.05, 19.95, 0.5, 129.5)
    n = -(-(MAX_CELL_COUNT + 1) // (w if w == 2 else w - 1))
    iy = torch.zeros((n, w), dtype=torch.int32, device=cuda)
    ix = torch.zeros_like(iy)
    if w > 2:
        ix[:, 0] = 100
        iy[:, 0] = 30
    img = torch.full((3, n, w), 255.0, device=cuda)
    elev = torch.zeros((n, w), device=cuda)
    msgs = []
    for fn in (bin_rgbelev_from_indices, bin_rgbelev_plain):
        with pytest.raises(ValueError, match="overflow") as e:
            fn(g, iy, ix, img, elev)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,value", [("uint8", 0.5), ("uint8", 256.0),
                                        ("full", 65536.0), ("raw", 1.0001),
                                        ("raw", 2.0 ** 60)])
def test_k2_refusals_match_plain(cuda, mode, value):
    iy, ix, _, _, data, _ = random_inputs(GRID, (64, 512), 4)
    d = data if mode == "uint8" else torch.round(data[..., :2])
    d = d.clone()
    iy[10, 10], ix[10, 10] = 3, 3
    d[10, 10, 0] = value
    msgs = []
    for fn in (lambda: rp.bin_partial_pallas_cw(GRID, (iy, ix), d,
                                                d.shape[-1], mode),
               lambda: rp.bin_partial_cw_plain(GRID, iy, ix, d, mode)):
        with pytest.raises(ValueError) as e:
            fn()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# -- the all-sky-imager path: take-best, nearest, mesh inversion -------------

def _asi_samples(seed, n=50000):
    """Seeded samples over ASI_GRID with repeated, NaN, -NaN, -0.0 and
    +0.0 priorities, NaN coordinates and NaN payload."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(9.5, 20.5, n).astype(np.float32)
    lon = rng.uniform(29.5, 45.5, n).astype(np.float32)
    pri = rng.integers(-5, 5, n).astype(np.float32)
    for value in (np.nan, -np.nan, -0.0, 0.0):
        pri[rng.random(n) < 0.05] = value
    lat[rng.random(n) < 0.02] = np.nan
    data = rng.random((n, 2)).astype(np.float32)
    data[rng.random(n) < 0.05, 0] = np.nan
    return [torch.from_numpy(a) for a in (lat, lon, pri, data)]


ASI_GRID = fixed_grid(4, 10.0, 20.0, 30.0, 45.0)


def _bits_equal(a, b):
    a, b = a.cpu(), b.cpu()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("all_invalid", [False, True])
def test_take_best_cuda_matches_cpu(cuda, all_invalid):
    from auromat_tpu_torch.ops.regrid import (apply_take_best, bin_take_best,
                                              plan_take_best)

    args = _asi_samples(0)
    if all_invalid:
        args[0][:] = float("nan")
    want = bin_take_best(ASI_GRID, *args)
    got = bin_take_best(ASI_GRID, *(a.to(cuda) for a in args))
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and _bits_equal(g, w)
    plan = plan_take_best(ASI_GRID, *(a.to(cuda) for a in args[:3]))
    cplan = plan_take_best(ASI_GRID, *args[:3])
    assert torch.equal(plan.winner.cpu(), cplan.winner)
    assert _bits_equal(plan.best_priority, cplan.best_priority)
    assert _bits_equal(apply_take_best(plan, args[3].to(cuda)), want[0])
    with pytest.raises(ValueError, match="re-plan"):
        apply_take_best(plan, args[3][1:].to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("oversample", [1, 2])
def test_bin_nearest_cuda_matches_cpu(cuda, oversample):
    from auromat_tpu_torch.ops.regrid import bin_nearest

    lat, lon, _, data = _asi_samples(1, n=3000)
    want = bin_nearest(ASI_GRID, lat, lon, data, oversample)
    got = bin_nearest(ASI_GRID, lat.to(cuda), lon.to(cuda), data.to(cuda),
                      oversample)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


def _mesh(h=48, w=64):
    yy, xx = np.mgrid[:h, :w].astype(np.float64)
    lat = 60.0 - 0.05 * yy + 0.004 * xx + 0.002 * np.sin(xx / 7.0)
    lon = 10.0 + 0.07 * xx + 0.01 * yy
    lat[:3, :5] = np.nan
    lon[:3, :5] = np.nan
    data = np.random.default_rng(2).random((h, w, 3)) * 255
    return fixed_grid(30, 57.7, 60.0, 10.4, 14.4), lat, lon, data


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["linear", "cubic"])
def test_interp_structured_cuda_matches_cpu(cuda, kind):
    from auromat_tpu_torch.ops import regrid

    fn = getattr(regrid, f"interp_{kind}_structured")
    grid, lat, lon, data = _mesh()
    t = [torch.from_numpy(a) for a in (lat, lon, data)]
    want = fn(grid, *t)
    got = fn(grid, *(a.to(cuda) for a in t))
    for g, w in zip(got, want):
        g = g.cpu()
        assert g.dtype == torch.float64
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert ok.float().mean() > 0.3
        assert (g[ok] - w[ok]).abs().max().item() < 1e-9


def _miracle_small(device, w=128):
    import datetime

    from auromat_tpu_torch.mapping import miracle

    date = datetime.datetime(2012, 3, 4, 17, 19)
    cal = miracle.get_calibration_data(os.path.join(RES, "cal.txt"), "SOD",
                                       date)
    img = np.random.default_rng(4).integers(0, 256, (w, w, 3), np.uint8)
    return miracle.create_mapping(img, cal, date, 110, device=device)


@pytest.mark.gpu
def test_miracle_mapping_and_resample_routes_cuda_match_cpu(cuda):
    from auromat_tpu_torch.resample import mosaic, resample

    m = _miracle_small(cuda)
    mc = _miracle_small("cpu")
    assert np.array_equal(m.center_mask, mc.center_mask)
    d = np.abs(m.lats.filled(np.nan) - mc.lats.filled(np.nan))
    assert np.nanmax(d) < 1e-9
    for method, cpu_method in (("nearest", "nearest_device"),
                               ("linear_device", "linear_device"),
                               ("cubic_device", "cubic_device"),
                               ("mean", "mean")):
        got = resample(m, px_per_deg=10, method=method, device=cuda)
        want = resample(m, px_per_deg=10, method=cpu_method, device="cpu",
                        bin_method="pallas_rgbelev" if method == "mean"
                        else "auto")
        mask = np.ma.getmaskarray(got.img)
        assert np.array_equal(mask, np.ma.getmaskarray(want.img))
        assert (~mask).sum() > 3000
        step = np.abs(got.img.filled(0).astype(int)
                      - want.img.filled(0).astype(int)).max()
        assert step <= (0 if method in ("nearest", "mean") else 1)
    got = mosaic([m], px_per_deg=10, device=cuda)
    want = mosaic([m], px_per_deg=10, device="cpu")
    assert np.array_equal(got.img.filled(0), want.img.filled(0))


@pytest.mark.gpu
def test_reproject_batch_cuda_matches_cpu(cuda):
    from auromat_tpu_torch.coordinates.transform import station_ecef
    from auromat_tpu_torch.mapping import miracle, themis

    lats, lons, ll = [], [], []
    for i, (la, lo) in enumerate(((56.4, -94.6), (60.0, -120.0))):
        cal = miracle.CalibrationData(
            station=f"S{i}", validFrom=None, validTo=None, lat=la, lon=lo,
            xc=256.0, yc=256.0, k=155.0, rotation=0.0, boundingBoxSimple=None)
        a, b = miracle._grid_latlon(cal, 64, 110.0,
                                    station_ecef(cal.lat, cal.lon), True,
                                    torch.device("cpu"))
        lats.append(a)
        lons.append(b)
        ll.append((la, lo))
    args = (np.array(ll), np.stack(lats), np.stack(lons), 110.0, 100.0)
    want = themis.reproject_batch(*args, device="cpu")
    got = themis.reproject_batch(*args, device=cuda)
    for g, w in zip(got, want):
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.nanmax(np.abs(g - w)) < 1e-9


def _scaled_header(w=512, h=384, code=None):
    """The real calibration scaled to (h, w) pixels; with ``code`` its
    CTYPE swapped to that projection (LONPOLE/LATPOLE dropped)."""
    header = dict(fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs")))
    scale = header["IMAGEW"] / w
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        header[k] = header[k] * scale
    header["CRPIX1"], header["CRPIX2"] = (header["CRPIX1"] / scale,
                                          header["CRPIX2"] / scale)
    header["IMAGEW"], header["IMAGEH"] = w, h
    if code:
        header = {k: v for k, v in header.items()
                  if k.upper() not in ("LONPOLE", "LATPOLE")}
        header["CTYPE1"], header["CTYPE2"] = f"RA---{code}", f"DEC--{code}"
    return header


@pytest.mark.gpu
def test_resample_mlat_mlt_gpu_matches_cpu(cuda):
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from auromat_tpu_torch.mapping.mapping import check_guarantees
    from auromat_tpu_torch.resample import resample_mlat_mlt

    header = _scaled_header()
    img = np.random.default_rng(3).integers(0, 256, (384, 512, 3), dtype=np.uint8)
    m = create_mapping(header, img, fits.get_shifted_spacecraft_position(header)[:3],
                       fits.get_shifted_photo_time(header), device=cuda)
    want = resample_mlat_mlt(m, px_per_deg=5, contains_pole=False,
                             device="cpu")
    for method, kernel in (("auto", _kernels.GEOREGRID_BIN),
                           ("pallas_taint", _kernels.REGRID_BIN)):
        before = kernel.launches
        got = resample_mlat_mlt(m, px_per_deg=5, contains_pole=False,
                                bin_method=method, device=cuda)
        assert kernel.launches == before + 1
        check_guarantees(got)
        for name in ("lats", "lons", "latsCenter", "lonsCenter"):
            d = np.abs(getattr(got, name).data - getattr(want, name).data)
            assert np.minimum(d, 360.0 - d).max() < 1e-9, name
        mask = np.ma.getmaskarray(got.img)
        assert np.array_equal(mask, np.ma.getmaskarray(want.img))
        ok = ~mask
        assert ok.mean() > 0.2
        d = np.abs(got.img.data.astype(int) - want.img.data.astype(int))[ok]
        assert d.max() <= 1 and (d == 1).mean() < 1e-3
        e = np.abs(got.elevation.data - want.elevation.data)[ok[..., 0]]
        assert e.max() < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("code", ["ZEA", "HPX", "QSC", "PCO"])
def test_georeference_points_generic_gpu_matches_cpu(cuda, code):
    from auromat_tpu_torch.coordinates.wcs import make_wcs
    from auromat_tpu_torch.ops.georef import georeference_points_generic

    header = _scaled_header(code=code)
    wcs = make_wcs(header)
    params = GeorefParams.from_wcs(
        wcs, fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_shifted_photo_time(header), altitude=110.0)
    px, py = np.meshgrid(np.arange(0, 512, 2, dtype=np.float64),
                         np.arange(0, 384, 2, dtype=np.float64))
    got = georeference_points_generic(wcs, params, px, py, torch.float64, True,
                                      device=cuda)
    want = georeference_points_generic(wcs, params, px, py, torch.float64,
                                       True, device="cpu")
    for name, a, b in zip(("lat", "lon", "elevation"), got, want):
        assert a.device.type == "cuda" and a.dtype == torch.float64
        a, b = a.cpu().numpy(), b.numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b)), name
        ok = ~np.isnan(b)
        assert 0.2 < ok.mean() < 0.9
        d = np.abs(a[ok] - b[ok])
        if name == "lon":
            d = np.minimum(d, 360.0 - d)
        assert d.max() < 1e-9, (name, d.max())
    la32, _ = georeference_points_generic(
        wcs, params, px.astype(np.float32), py.astype(np.float32),
        torch.float32, device=cuda)
    assert la32.dtype == torch.float32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
@pytest.mark.parametrize("model,params", [("ptlens", (0.01, -0.02, 0.005)),
                                          ("poly3", (-0.019,)),
                                          ("poly5", (0.1, 0.01))])
def test_lens_correction_gpu_matches_cpu(cuda, model, params, dtype):
    from auromat_tpu_torch.util.lensdistortion import correct_lens_distortion

    img = np.random.default_rng(4).integers(0, 256, (480, 640, 3),
                                            dtype=np.uint8)
    if dtype == "uint16":
        img = img.astype(np.uint16) * 257
    want = correct_lens_distortion(img, model, params, device="cpu")
    got = correct_lens_distortion(img, model, params, device=cuda)
    assert got.dtype == img.dtype and got.shape == img.shape
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    # a 2-D tensor stays on the card; its plane equals the image's
    t = correct_lens_distortion(torch.from_numpy(img[..., 0].astype(np.int32)),
                                model, params, device=cuda)
    assert t.device.type == "cuda" and t.dtype == torch.int32
    assert np.array_equal(t.cpu().numpy(), got[..., 0])


def _iss_cache(folder, header):
    """An offline ISS archive cache around ``header`` (its .wcs written
    with the port's header cards), poly3 (-0.019) and the 180-degree flip."""
    import json

    os.makedirs(folder, exist_ok=True)
    key = "ISS030-E-102170"
    with open(os.path.join(RES, "ISS030-E-102170_dc.wcs"), "rb") as f:
        raw = f.read()
    cards = [raw[i:i + 80] for i in range(0, len(raw), 80)]
    out = []
    for c in cards:
        k = c[:8].decode().strip()
        if k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2", "CRPIX1", "CRPIX2",
                 "IMAGEW", "IMAGEH"):
            c = f"{k:<8}= {header[k]!r:>20}".ljust(80).encode()
        out.append(c)
    with open(os.path.join(folder, f"{key}.wcs"), "wb") as f:
        f.write(b"".join(out))
    # the frame's file is never decoded: the array route takes decoded ones
    open(os.path.join(folder, f"{key}.jpg"), "wb").close()
    date = "2012-01-25T09:27:08.060000"
    api = {"id": 77, "date_start": date, "date_end": date,
           "image_extension": ".jpg", "metadata_uri": "unused",
           "raw_is_upside_down": True,
           "distortion_correction": {"model": "poly3", "params": [-0.019]},
           "images": {key: {"date": date, "image_uri": "unused",
                            "wcs_uri": "unused"}}}
    with open(os.path.join(folder, "api.json"), "w") as f:
        json.dump(api, f)
    with open(os.path.join(folder, "metadata.json"), "w") as f:
        json.dump({"sequence_metadata": {"Project": "THOR"}}, f)
    return key


@pytest.mark.gpu
def test_iss_array_route_and_read_back_gpu(cuda, tmp_path):
    from auromat_tpu_torch.export import cdf as export_cdf
    from auromat_tpu_torch.export import netcdf as export_nc
    from auromat_tpu_torch.mapping.cdf import read_mapping as read_cdf
    from auromat_tpu_torch.mapping.iss import ISSMappingProvider
    from auromat_tpu_torch.mapping.netcdf import read_mapping as read_nc
    from auromat_tpu_torch.resample import resample

    header = _scaled_header()
    key = _iss_cache(str(tmp_path / "iss"), header)
    assert fits.read_header(str(tmp_path / "iss" / f"{key}.wcs"))["IMAGEW"] == 512
    decoded = np.random.default_rng(9).integers(0, 256, (384, 512, 3),
                                                dtype=np.uint8)
    maps = {}
    for dev in (cuda, "cpu"):
        prov = ISSMappingProvider(str(tmp_path / "iss"), offline=True,
                                  fastCenterCalculation=True, device=dev)
        prov._download_files(key)
        img = prov._postprocess_common(decoded)
        maps[str(dev)] = (img, prov._array_mapping(key, img))
    (img_g, m), (img_c, mc) = maps["cuda"], maps["cpu"]
    d = np.abs(img_g.astype(int) - img_c.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    for name in ("lats", "lons", "latsCenter", "lonsCenter"):
        a, b = getattr(m, name).filled(np.nan), getattr(mc, name).filled(np.nan)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        assert np.abs(a[ok] - b[ok]).max() < 1e-9
    before = _kernels.GEOREGRID_BIN.launches
    r = resample(m, px_per_deg=5, device=cuda)
    assert _kernels.GEOREGRID_BIN.launches == before + 1
    assert (~r.center_mask).sum() > 100
    for write, read, name in ((export_cdf.write, read_cdf, "a.cdf"),
                              (lambda p, mm: export_nc.write(
                                  p, mm, format="NETCDF3"), read_nc, "a.nc")):
        path = str(tmp_path / name)
        write(path, m)
        back = read(path)
        rb = resample(back, px_per_deg=5, device=cuda)
        assert np.array_equal(rb.center_mask, r.center_mask)
        assert np.array_equal(rb.img.filled(0), r.img.filled(0))


@pytest.mark.gpu
def test_tle_position_mapping_gpu(cuda, tmp_path):
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position

    tle = tmp_path / "iss.tle"
    tle.write_text(
        "1 25544U 98067A   12025.39384329  .00000000  00000-0  00000-0 0    04\n"
        "2 25544  51.6283 123.3888 0093999 252.4012 171.2148 15.81821010    06\n")
    header = {k: v for k, v in _scaled_header().items()
              if not k.startswith("POS")}
    pos, t, _ = resolve_camera_position(header, str(tle))
    hpos = fits.get_spacecraft_position(_scaled_header())
    assert np.linalg.norm(pos - np.array(hpos)) < 15.0
    img = np.zeros((384, 512, 3), np.uint8)
    m = create_mapping(header, img, pos, t, device=cuda)
    mc = create_mapping(header, img, pos, t, device="cpu")
    a, b = m.latsCenter.filled(np.nan), mc.latsCenter.filled(np.nan)
    ok = ~np.isnan(a) & ~np.isnan(b)
    assert ok.mean() > 0.3 and np.abs(a[ok] - b[ok]).max() < 1e-9


@pytest.mark.gpu
def test_profiling_benchmark_uses_cuda_events(cuda):
    from auromat_tpu_torch.profiling import benchmark, recording, span

    x = torch.ones(1 << 20, device=cuda)
    med, times = benchmark(lambda: x * 2, iters=5)
    assert len(times) == 5 and 0 < med < 1.0
    with recording() as rec:
        with span("mul", stream=cuda):
            for _ in range(20):
                x = x * 3
    (mul,) = rec.spans()  # resolving waits for the stream
    assert mul.name == "mul" and 0 < mul.device_ms < 1000.0 and mul.ms > 0


@pytest.mark.gpu
def test_spans_on_the_card_time_the_stream_and_count_the_copies(cuda):
    """The fused frame and the library slice on the card under
    ``recording``: stream times on the georeference and bin-index stages,
    K1's status read as a wait, and the bytes each copy moves, reckoned
    from the shapes."""
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position
    from auromat_tpu_torch.ops.georef import DynGeorefParams, GeorefParams
    from auromat_tpu_torch.ops.georegrid import georegrid_mean
    from auromat_tpu_torch.ops.regrid import fixed_grid
    from auromat_tpu_torch.profiling import recording
    from auromat_tpu_torch.resample import resample

    h, w = 384, 512
    header = _scaled_header(w, h)
    pos, t, _ = resolve_camera_position(header)
    img = np.random.default_rng(4).integers(0, 256, (h, w, 3)).astype(np.uint8)
    dyn = DynGeorefParams.from_static(
        GeorefParams.from_wcs(TanWcs(header), pos, t, altitude=110.0),
        device=cuda, dtype=torch.float32)
    grid = fixed_grid((36, 25), 47.0, 62.0, -112.0, -91.0)
    chw = torch.from_numpy(img).to(cuda).permute(2, 0, 1).float().contiguous()
    with recording() as rec:
        georegrid_mean(grid, dyn, chw)
        m = create_mapping(header, img, pos, t, fast_center=False, device=cuda)
        r = resample(m, arcsec_per_px=100, device=cuda)
    got = rec.spans()
    names = [s.name for s in got]
    assert names == [
        "georegrid", "georegrid.georef", "georegrid.bin_indices", "k1.wait",
        "create_mapping", "create_mapping.to_host", "create_mapping.masks",
        "resample", "resample.grid", "resample.prepare", "resample.to_device",
        "resample.bin", "georegrid", "georegrid.bin_indices", "k1.wait",
        "resample.to_host", "resample.finish"]
    for s in got:
        if s.name in ("georegrid.georef", "georegrid.bin_indices"):
            assert 0 < s.device_ms < 1000.0
        else:
            assert s.device_ms is None
    nbytes = {s.name: s.nbytes for s in got if s.nbytes is not None}
    corners, centres = (h + 1) * (w + 1), h * w
    # lats, lons, mlat, mlt at the corners; lat/lon, elevation, mlat/mlt
    # at the centres, float64
    assert nbytes["create_mapping.to_host"] == 8 * (4 * corners + 5 * centres)
    # the centres and the (R, G, B, elevation) samples, float64
    assert nbytes["resample.to_device"] == 8 * (2 * centres + 4 * centres)
    # K1's float32 means of the grid
    assert nbytes["resample.to_host"] == 4 * r.img.shape[0] * r.img.shape[1] * 4


@pytest.mark.gpu
def test_earth_checks_gpu_match_cpu(cuda):
    from auromat_tpu_torch.solving import spacecraft

    header = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    pos = fits.get_shifted_spacecraft_position(header)[:3]
    for h, want in ((header, True), (pointed(header, pos, -1), False),
                    (pointed(header, pos, 1), False)):
        assert spacecraft.is_consistent(h, device=cuda) == \
            spacecraft.is_consistent(h, device="cpu") == want
        assert spacecraft.intersects_earth(h, device=cuda) == \
            spacecraft.intersects_earth(h, device="cpu")
        lat, (px, py) = spacecraft._latitudes(h, 110.0, cuda)
        clat, _ = spacecraft._latitudes(h, 110.0, "cpu")
        a, b = lat(px, py), clat(px, py)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        assert not ok.any() or np.abs(a[ok] - b[ok]).max() < 1e-9


@pytest.mark.gpu
def test_histogram2d_gpu_matches_cpu(cuda):
    from auromat_tpu_torch.util.histogram import histogram2d

    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 11, 200_000)
    y = rng.uniform(-2, 6, 200_000).astype(np.float32)
    x[:100] = 10.0
    y[100:200] = np.nan
    ws = [None, rng.random(200_000), rng.integers(0, 256, 200_000)]
    for rng_ in ([[0, 10], [-1, 5]], None):
        xs, ys = (x, y) if rng_ else (x[200:], y[200:])
        wl = ws if rng_ else [w if w is None else w[200:] for w in ws]
        got = histogram2d(torch.from_numpy(xs).to(cuda), ys, (70, 50),
                          range=rng_, weights=wl, device=cuda)
        want = histogram2d(xs, ys, (70, 50), range=rng_, weights=wl,
                           device="cpu")
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2])
        assert np.array_equal(got[0][0], want[0][0])
        for g, w in zip(got[0][1:], want[0][1:]):
            assert_allclose(g, w, rtol=1e-12, atol=0)


@pytest.mark.gpu
def test_fits_star_projections_gpu_match_cpu(cuda, tmp_path):
    header = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    for limit in (500, 0):
        got = fits.get_catalog_stars(header, limit=limit, device=cuda)
        want = fits.get_catalog_stars(header, limit=limit, device="cpu")
        assert len(got[0]) == len(want[0]) > 0
        for g, w in zip(got, want):
            assert_allclose(g, w, rtol=0, atol=1e-9)
    rng = np.random.default_rng(3)
    fits.write_xyls(tmp_path / "s.xyls", rng.random(40) * 4256,
                    rng.random(40) * 2832)
    moved = header.copy()
    moved["CRVAL1"] += 0.05
    moved["CD1_2"] *= 1.001
    wcs = os.path.join(RES, "ISS030-E-102170_dc.wcs")
    got = fits.recompute_xyls_pixel_positions(tmp_path / "s.xyls", wcs,
                                              moved, device=cuda)
    want = fits.recompute_xyls_pixel_positions(tmp_path / "s.xyls", wcs,
                                               moved, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.float64 and g.shape == (40,)
        assert_allclose(g, w, rtol=0, atol=1e-9)


@pytest.fixture
def draw_mapping():
    """The scaled ISS030-E-102170 calibration (512x384) over a seeded image,
    built on the CPU (a host Mapping with its WCS header)."""
    from auromat_tpu_torch.mapping.astrometry import create_mapping

    header = _scaled_header()
    pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
    img = np.random.default_rng(10).integers(0, 256, (384, 512, 3), np.uint8)
    return create_mapping(header, img, pos, fits.get_shifted_photo_time(header),
                          identifier="draw", device="cpu")


@pytest.mark.gpu
def test_draw_numeric_helpers_gpu_match_cpu(cuda, draw_mapping):
    """The numbers of the device-reaching figures on the card against the
    CPU: the KML overlay (its resample launches K1) equal, the horizon hit
    mask equal, the RA/Dec grid and the constellation end points within
    1e-9."""
    from auromat_tpu_torch import draw
    from auromat_tpu_torch.coordinates.constellations import figure_segments

    m = draw_mapping
    before = _kernels.GEOREGRID_BIN.launches
    rgba, kml = draw._kml_overlay("o.kml", m, 300, device=cuda)
    assert _kernels.GEOREGRID_BIN.launches == before + 1
    crgba, ckml = draw._kml_overlay("o.kml", m, 300, device="cpu")
    assert kml == ckml and np.array_equal(rgba, crgba)
    assert rgba.dtype == np.uint8 and (rgba[..., 3] == 255).sum() > 100
    got, want = (draw._horizon_grid(m, device=d) for d in (cuda, "cpu"))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert 0 < got[2].mean() < 1
    for g, w in zip(draw._ra_dec_grid(m, 16, device=cuda),
                    draw._ra_dec_grid(m, 16, device="cpu")):
        assert g.dtype == np.float64 and g.shape == (24, 32)
        assert_allclose(g, w, rtol=0, atol=1e-9)
    wcs = TanWcs(m.wcs_header)
    data = figure_segments()
    got = draw._constellation_segments(wcs, data, device=cuda)
    want = draw._constellation_segments(wcs, data, device="cpu")
    assert list(got) == list(want) == list(data)
    for name in data:
        assert_allclose(got[name], want[name], rtol=0, atol=1e-9)


def _chip_smoke():
    """chip_smoke.py (numpy-only helpers: the seeded frames)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("thr,length", [(200, 100), (60, 30)])
def test_hough_p_gpu_matches_plain(cuda, seed, thr, length):
    import math

    from auromat_tpu_torch.solving import masking

    img = _chip_smoke().hough_frame(np, seed)
    want_counts, counts = {}, {}
    want = masking._hough_p_plain(img, 1, math.pi / 180, thr, length, 4,
                                  want_counts)
    before = _hough_launches()
    got = masking.hough_lines_p(torch.from_numpy(img).to(cuda), 1,
                                math.pi / 180, thr, length, 4, counts)
    assert _hough_launches() == [n + 1 for n in before]
    assert len(want) > 0 and got.dtype == np.int32
    assert np.array_equal(got, want) and counts == want_counts
    with pytest.raises(ValueError, match="angles"):
        masking.hough_lines_p(torch.from_numpy(img).to(cuda), 1,
                              math.pi / 360, thr, length, 4)


def _hough_launches():
    return [_kernels.HOUGH_P.launches, _kernels.HOUGH_ORDER.launches]


def _hough_on_card(cuda, img, thr, length, gap):
    """HOUGH_P on the card against the plain version: the same lines in
    the same order and the same four counts, one launch of each kernel."""
    import math

    from auromat_tpu_torch.solving import masking

    want_counts, counts = {}, {}
    want = masking._hough_p_plain(img, 1, math.pi / 180, thr, length, gap,
                                  want_counts)
    before = _hough_launches()
    got = masking.hough_lines_p(torch.from_numpy(img).to(cuda), 1,
                                math.pi / 180, thr, length, gap, counts)
    assert _hough_launches() == [n + 1 for n in before]
    assert np.array_equal(got, want) and counts == want_counts
    return want, counts


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["segments", "octants", "gaps", "borders",
                                  "same_bin"])
def test_hough_p_gpu_stress_frames(cuda, name):
    cs = _chip_smoke()
    want, counts = _hough_on_card(cuda, cs.hough_stress_frame(np, name),
                                  *cs.HOUGH_STRESS[name])
    assert counts["lines"] == len(want) and counts["triggers"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ISS030-E-102170_dc", "ISS029-E-8492"])
def test_hough_p_gpu_checked_in_frames(cuda, name):
    # the frames' Hough inputs: 376,447 and 910,556 candidates
    want, counts = _hough_on_card(cuda, _chip_smoke().hough_input(np, name),
                                  200, 100, 4)
    assert len(want) == {"ISS030-E-102170_dc": 182, "ISS029-E-8492": 2}[name]


@pytest.mark.gpu
@pytest.mark.parametrize("count", [0, 1, 2, 3, 5, 1000, 8193, 376447, 910556])
def test_hough_order_gpu_matches_plain(cuda, count):
    from auromat_tpu_torch.solving import masking

    before = _kernels.HOUGH_ORDER.launches
    got = masking._hough_order_cuda(count, cuda)
    assert _kernels.HOUGH_ORDER.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert np.array_equal(got.cpu().numpy(), masking._hough_order(count))


@pytest.mark.gpu
def test_hough_lines_p_gpu_draws_no_host_order(cuda, monkeypatch):
    import math

    from auromat_tpu_torch.solving import masking

    img = _chip_smoke().hough_frame(np, 2)
    want = masking._hough_p_plain(img, 1, math.pi / 180, 60, 30, 4)

    def refuse(count):
        raise AssertionError("the card's route drew the order on the host")

    monkeypatch.setattr(masking, "_hough_order", refuse)
    got = masking.hough_lines_p(torch.from_numpy(img).to(cuda), 1,
                                math.pi / 180, 60, 30, 4)
    assert len(want) > 0 and np.array_equal(got, want)


@pytest.mark.gpu
def test_mask_starfield_gpu_matches_cpu(cuda):
    from auromat_tpu_torch.solving import masking

    frame = _chip_smoke().starfield_frame(np)
    before = _hough_launches()
    contours_before = _contour_launches()
    mask, sigma = masking.mask_starfield(frame, device=cuda)
    assert _hough_launches() == [n + 1 for n in before]
    # one contour stage a binarization: CCL4, CCL8, CONTOUR_TRACE once each
    n = [a - b for a, b in zip(_contour_launches(), contours_before)]
    assert n[0] >= 1 and n == [n[0]] * 3
    cmask, csigma = masking.mask_starfield(frame, device="cpu")
    assert np.array_equal(mask, cmask) and sigma == csigma
    assert 0.2 < mask.mean() < 0.8


def _contour_launches():
    return [_kernels.CCL8.launches, _kernels.CCL4.launches,
            _kernels.CONTOUR_TRACE.launches]


def _contour_frames():
    """(name, binary) of the contour stage's checks: the stress frames and
    the checked-in frames' binarizations."""
    cs = _chip_smoke()
    out = [(n, cs.contour_stress_frame(np, n)) for n in cs.CONTOUR_STRESS]
    for name in sorted(cs.CONTOUR_FUDGES):
        out += [(f"{name} fudge {f}", img)
                for f, img in cs.contour_input(np, name).items()]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("connectivity", [8, 4])
def test_ccl_gpu_matches_plain(cuda, connectivity):
    from auromat_tpu_torch.solving import masking

    kernel = _kernels.CCL8 if connectivity == 8 else _kernels.CCL4
    for what, img in _contour_frames():
        for fg in (True, False):
            before = kernel.launches
            got = masking.ccl(torch.from_numpy(img).to(cuda), connectivity, fg)
            assert kernel.launches == before + 1
            assert got.device.type == "cuda" and got.dtype == torch.int32
            want = masking._ccl_plain(img, connectivity, fg)
            assert np.array_equal(got.cpu().numpy(), want), (what, fg)


@pytest.mark.gpu
def test_contour_trace_gpu_matches_plain(cuda):
    # external_contours on the card (CCL4, the fill, CCL8, CONTOUR_TRACE
    # twice: the counts, then the points) against the plain route: roots,
    # labels, doubled areas, boxes, lengths, counts and points, in order
    from auromat_tpu_torch.solving import masking

    for what, img in _contour_frames():
        before = _contour_launches()
        roots, labels, b = masking.external_contours(
            torch.from_numpy(img).to(cuda), points=True)
        assert _contour_launches() == [before[0] + 1, before[1] + 1,
                                       before[2] + 2]
        want = masking.external_contours(torch.from_numpy(img), points=True)
        assert torch.equal(roots.cpu(), want[0]), what
        assert torch.equal(labels.cpu(), want[1]), what
        for field in masking.Borders._fields:
            assert torch.equal(getattr(b, field).cpu(),
                               getattr(want[2], field)), (what, field)


@pytest.mark.gpu
def test_mask_starfield_gpu_traces_no_contour_on_the_host(cuda, monkeypatch):
    # the contour stage of mask_starfield on a CUDA tensor: no scipy label,
    # no host border follower, no host polygon raster
    from scipy import ndimage

    from auromat_tpu_torch import utils
    from auromat_tpu_torch.solving import masking

    frame = _chip_smoke().starfield_frame(np)
    want = masking.mask_starfield(frame, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("the card's route ran a host contour step")

    for mod, name in ((ndimage, "label"), (ndimage, "binary_fill_holes"),
                      (ndimage, "find_objects"), (utils, "trace_outer_borders"),
                      (masking, "trace_outer_borders"),
                      (utils, "poly_fill_spans"), (masking, "poly_fill_spans"),
                      (masking, "_big_contours"), (masking, "_fill_polys")):
        monkeypatch.setattr(mod, name, refuse)
    before = _contour_launches()
    mask, sigma = masking.mask_starfield(frame, device=cuda)
    assert all(n > b for n, b in zip(_contour_launches(), before))
    assert np.array_equal(mask, want[0]) and sigma == want[1]
