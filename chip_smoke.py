#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (auromat_tpu_torch) on one NVIDIA GPU.

Drives the port's main path — georeference the real 12 MP ISS frame
ISS030-E-102170 (4256x2832) and mean-regrid it onto the 539x524 fixed grid
— through ``auromat_tpu_torch.entry``, then the public slice
``create_mapping`` -> ``resample('mean')`` of the same frame, the sequence
mosaic, the all-sky-imager path (THEMIS and MIRACLE providers,
``mosaic``, the interpolation routes, ``convert``), the magnetic grid
(``resample_mlat_mlt``), georeferencing through the generic FITS
projections and the ESA ISS archive path (lens correction on the card,
products read back, TLE camera positions), and checks them:

1. the card (``nvidia-smi`` name and power limit);
2. starts the build of every kernel source from this checkout, one nvcc
   each, all at once, and waits for K1's (``ops/csrc/georegrid_bin.cu``);
3. K1 against its plain PyTorch version on the card at the frame's shapes:
   all five outputs must be bit-equal;
4. the main path on a few frames (one masked), with the kernel launch
   counters zeroed just before and read just after: every kernel must have
   launched, the counts must equal the valid samples, the latitudes must
   cover the aurora over Canada, and the output must be bit-equal to the
   same path with the plain binning; the float64 chain on the card must
   match the executed-reference golden to < 1e-6 deg;
5. times (CUDA events, after warm-up): the main path per frame, K1 against
   its plain version;
6. waits for the other builds: K2/K3 (``ops/csrc/regrid_bin.cu``) and
   K1-i8 (the i8 entry point of K1's library);
7. at the full frame's bin indices: K2 in its 'uint8', 'full' and 'raw'
   modes and on the taint stack, K3 through ``bin_partial_pallas``, and
   K1-i8 each bit-equal to their plain versions, count totals equal to
   the valid samples;
8. the slice on the card: ``create_mapping`` of the frame (seeded image,
   float64) and ``resample`` at the golden's 25 px/deg with the 'auto'
   route (must launch K1) and the 'pallas_taint' route (must launch K2),
   each held against golden_resample_ISS030-E-102170_dc.npz (grids,
   elevation, mask), against each other and against ``resample`` on the
   CPU; then K3's and K1-i8's entry points on the same frame;
9. times: each new kernel against its plain version (CUDA events), and
   ``create_mapping`` and ``resample`` wall time split into device and
   host time;
10. K1 on an 8-frame burst of the real sequence ISS029-E-8493..8500
    (tests/resources/seq/, 4256x2832 each, stacked to 22656x4256) into the
    band-padded global 0.05 deg grid (3600x7199): bit-equal to its plain
    version, and timed against it;
11. the sequence-mosaic path: ``mosaic_sequence(batch=8)`` on a world of one
    over the 10 frames of that sequence (seeded uint8 images), onto the
    global 0.05 deg grid — two bursts, the second padded with null frames —
    with the launch counters zeroed just before and read just after: K1
    must have launched, the count total must equal the frames' valid
    samples, and the result must be bit-equal to the same sequence through
    K1's plain version and to one step of all 10 frames; a
    ``min_elevation=10`` run must count the valid samples at >= 10 deg;
12. ``cli.convert.convert_mosaic`` on the card with an in-memory provider
    of those frames, writing a CDF of the global 0.25 deg mosaic: its
    printed occupied cells equal ``mosaic_sequence``'s and the file's;
13. times: the grid-sharded step on an 8-frame burst of the main frame
    (539x524 grid) against the same step with K1's plain version (CUDA
    events), ``mosaic_sequence`` over 100 jittered frames from a
    device-resident 8-frame buffer (wall clock ending in a synchronize),
    and the step on the global 0.05 deg grid with 4 frames, in ms/frame;
14. the tile histograms' other paths at full size: seeded random cells
    over the main grid (every tile's cell box overflows shared memory, so
    every tile takes the warp-aggregated fallback) for K1, K1-i8, K2 in
    every mode and K3; ragged planes (w not a multiple of 4 or of the
    128-column tile, one row, no valid sample, bases off the 16-byte
    alignment); each bit-equal to its plain version with count totals
    equal to the valid samples; and the refusals (MAX_CELL_COUNT + 1
    samples in one cell, an out-of-range K2 channel) raising the plain
    version's message.

15. the all-sky-imager path at deployment scale: 24 synthetic THEMIS
    stations (bench.py's geometry: 256x256 frames, 257x257 calibration
    corner grids at 90/110/150 km) written as L1/L2 CDFs;
    ``ThemisMappingProvider(offline=True, device='cuda').get`` at 100 km
    must reproject all stations in one batched call on the card, within
    1e-9 deg of the same call on the CPU; ``mosaic`` of the collection at
    25 px/deg on the card must equal the CPU's (uint16 image, elevation,
    mask);
16. themis24: ``bin_take_best`` on fixed_grid(10, 40, 72, -160, -50)
    (319x1099) for the 24 stations' samples with 2 channels,
    ``plan_take_best`` and ``apply_take_best``, each bit-equal to the CPU
    and timed (CUDA events, median of 20);
17. a 512x512 MIRACLE frame (seeded RGB, the real cal.txt SOD entry),
    built on the card with ``miracle.create_mapping`` (no JPEG decoder
    here): ``resample`` with 'mean' (one K1 launch; equal to K1's plain
    twin on the CPU), 'nearest' (must take the device route; equal to
    'nearest_device' on the CPU), 'linear_device' and 'cubic_device'
    (masks equal, uint8 within one step), wall and device times; K1 at
    this frame's shapes against its plain version;
18. ``cli.convert.main --grid geo --platform cuda`` on the THEMIS folder
    (one tick, 24 files; a file's filled cells equal ``resample`` on the
    card) and on a MIRACLE folder of two seeded frames (saved with numpy
    under MIRACLE file names, read through ``np.load`` in place of the
    JPEG reader): two files, K1 launched;
19. the magnetic (MLat/MLT) grid: the array-built mapping of phase 8
    through ``resample_mlat_mlt(px_per_deg=25, contains_pole=False)`` on
    the card with the 'auto' route (must launch K1) and 'pallas_taint'
    (must launch K2), counters zeroed before each: longitudes within 1e-9
    deg and elevation within 1e-4 of
    golden_resample_mlatmlt_ISS030-E-102170_dc.npz with the same mask
    cells; equal to the same call on the CPU (grids 1e-9 deg, masks
    equal, uint8 equal); K1 and K2 on the solar-magnetic mapping's own
    arguments (recorded from that run) bit-equal to their plain versions
    and timed; the path's wall time, and the device time inside it read
    from a profiler trace of one call (kernels and copies), beside the
    binning and the grid's SM -> geodetic conversion each run again alone;
20. georeferencing through the generic FITS projections: the frame's
    header with its CTYPE swapped (LONPOLE/LATPOLE dropped).
    ``georeference_generic`` for ZEA at the full frame (fast centres,
    MLat/MLT, float32) timed as ``generic_ms``;
    ``georeference_points_generic`` at every 8th pixel for ZEA, HPX and
    QSC in float32 against float64 on the card (``generic_parity_deg``:
    under 1e-2 deg over the rays that meet the shell at 0.25 deg of
    elevation or more, the number of grazing rays left out and their worst
    point printed; mask mismatch at most 5e-4; the CPU's float32 chain
    held and printed the same way), and for ZEA, HPX, QSC and PCO in
    float64 on the card against
    the CPU (1e-9 deg, masks equal); PCO's eager bisection on the full
    frame timed, its every 8th pixel equal to the CPU's; ``create_mapping``
    on the ZEA header -> ``resample('mean')``: K1 launched, equal to the
    plain ('sorted') binning on the card and to the CPU, K1 on that
    mapping's arguments bit-equal to its plain version;
21. the full-precision point functions (native float64 here):
    ``georeference_points_df64`` and ``_df64_full`` on the card against
    golden_georef_ISS030-E-102170_dc.npz (< 1e-6, masks equal), and the
    times of those public functions at the 12 MP frame, host arrays
    included, as ``df64_georef_ms``, ``df64_full_ms`` and
    ``df64_zen_full_ms`` (the ZEA radial law), each beside its kernel and
    copy time from a profiler trace;
22. the lens distortion correction of the ISS path (``util.
    lensdistortion``, eager torch) on the full 4256x2832x3 uint8 seeded
    frame for ptlens, poly3 and poly5: the card against the same code on
    the CPU (at most one step), device time (CUDA events, median of 20),
    wall time with the host copies (median of 3) and its bound;
23. the ESA ISS archive path: an offline cache in a temp dir (the real
    .wcs, api.json with the archive's poly3 (-0.019) model and the flip,
    metadata.json, the seeded frame under the RAW file's name, read by a
    stub decoder: no rawpy or PIL here) through
    ``ISSMappingProvider(device='cuda').get`` (flip, correction on the
    card, crop, ``create_mapping``) and ``resample(px_per_deg=25)``: K1
    launched and bit-equal to its plain version on the recorded arguments,
    grids within 1e-9 deg of the same route on the CPU, uint8 equal; CDF
    and NETCDF3 (and NETCDF4 where h5py is present) exports read back
    through ``CDFMappingProvider``/``NetCDFMappingProvider`` and resampled
    on the card equal the first composite; wall times of the stages and
    the device share from a profiler trace of one get + resample;
24. TLE camera positions: the header without its POS* cards and the ISS
    TLE fitted to it (tests/test_ephem.py) through
    ``resolve_camera_position`` (SGP4 on the host) and ``create_mapping``
    on the card, against the mapping from the header's own position;
25. ``profiling.benchmark`` of K1 at the main path's shapes beside [5]'s
    CUDA-event median.

Every kernel row gets, beside its time and its plain version's, its bound
(``bound_ms``: the bytes the function must move — every index, the data
of the valid samples, every output once — over the H100's 3.35 TB/s) and
``library_ms``: one PyTorch call of the same function, timed in turns with
the kernel: one int64 ``index_add_`` of the same (count, channel,
fixed-point elevation) sums given the cell indices, and for K3, whose
function starts from coordinates, the chain of float64 ``bin_indices``,
the valid samples' data (NaN zeroed) and that ``index_add_`` (the
``index_add_`` alone is kept as ``library_ms_given_indices``). The port
never calls them.

Prints one line per phase, then the card's line, a JSON line of
per-kernel results, and as the last line ``{"ok": true, "device":
{...}}``. Any failure raises and the exit code is nonzero; without a CUDA
device it fails at once.

    python3 chip_smoke.py
"""

import datetime
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
N_FRAMES = 3  # main-path requests; the last one is masked
N_TIMED = 20  # timed repetitions per measurement
N_WALL = 3  # timed repetitions of the slice's host-inclusive wall times
N_BURST_TIMED = 5  # timed repetitions per burst-sized measurement
N_SEQ = 100  # frames of the timed sequence (burst100)
RES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                   "resources")
GOLDEN = os.path.join(RES, "golden_georef_ISS030-E-102170_dc.npz")
GOLDEN_RESAMPLE = os.path.join(RES, "golden_resample_ISS030-E-102170_dc.npz")
GOLDEN_MLATMLT = os.path.join(
    RES, "golden_resample_mlatmlt_ISS030-E-102170_dc.npz")
SEQ_WCS = [os.path.join(RES, "seq", f"ISS029-E-{n}.wcs")
           for n in range(8493, 8503)]
GLOBAL_005 = (20, -89.999, 89.999, -179.999, 179.999)  # 0.05 deg, 3599x7199
N_STATIONS, ASI_SIZE = 24, 256  # the THEMIS network's stations and frames
THEMIS_DATE = datetime.datetime(2012, 2, 4, 7, 56, 26)
SOD_DATE = datetime.datetime(2012, 3, 4, 17, 19)  # cal.txt's SOD entry
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Median ms of ``fn()`` over ``reps`` runs, each timed with CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_busy_ms(torch, fn):
    """Device time of one ``fn()`` as the profiler's device trace shows it:
    (ms in kernels, ms in copies and memsets, number of kernels), each the
    sum of the events' own durations; None where the trace recorded no
    device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels_us = copies_us = n_kernels = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
            continue
        if evt.name.startswith(("Memcpy", "Memset")):
            copies_us += evt.self_device_time_total
        else:
            kernels_us += evt.self_device_time_total
            n_kernels += 1
    if n_kernels == 0:
        return None
    return kernels_us / 1e3, copies_us / 1e3, n_kernels


def start_builds(kernels):
    """Build each kernel's library in its own thread, all started together;
    {source: future of the build's seconds}."""
    from concurrent.futures import ThreadPoolExecutor

    def build(k):
        t0 = time.perf_counter()
        k.build()
        return time.perf_counter() - t0

    pool = ThreadPoolExecutor(max_workers=len(kernels))
    futures = {k.source: pool.submit(build, k) for k in kernels}
    pool.shutdown(wait=False)
    return futures


def check_equal(torch, name, got, want):
    """Raise unless the (count, sums) pairs are bit-equal; max |d| (0.0)."""
    for what, a, b in zip(("count", "sums"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} kernel != plain version on {what}: "
                                 f"max |d| {(a - b).abs().max().item()}")
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def in_turns(torch, kernel, plain, reps=N_TIMED):
    """Median CUDA-event ms of kernel and plain, measured plain, kernel,
    kernel, plain on one card; then each side's runs."""
    kernel(), plain()
    runs = {kernel: [], plain: []}
    for f in (plain, kernel, kernel, plain):
        runs[f].append(cuda_ms(torch, f, reps))
    return (statistics.median(runs[kernel]), statistics.median(runs[plain]),
            runs[kernel], runs[plain])


def bound_ms(n_bytes):
    """The least time the card could take to move ``n_bytes``."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def bin_bytes(idx_bytes, n_samples, n_valid, in_ch, n_cells, out_words,
              out_bytes=4):
    """Bytes a binning function must move: every sample's two indices (or
    coordinates) of ``idx_bytes`` each, the ``in_ch`` float32 channels of
    the valid samples, and ``out_words`` words of ``out_bytes`` a cell."""
    return (2 * idx_bytes * n_samples + 4 * in_ch * n_valid
            + out_bytes * out_words * n_cells)


def kernel_row(name, source, replaces, launches, err, k_ms, p_ms, n_bytes,
               lib_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms(n_bytes),
            "bound_by": "bytes", "library_ms": lib_ms}


def library_call(torch, grid, iy, ix, terms):
    """One PyTorch call computing a binning kernel's integer sums:
    ``zeros(n_cells, k).index_add_(0, cell, vals)`` with ``cell``
    (n_valid,) and ``vals`` (n_valid, k) = [1, *terms] int64, prepared
    here, outside the call."""
    valid = (iy >= 0) & (iy < grid.n_lat) & (ix >= 0) & (ix < grid.n_lon)
    cell = (iy.long() * grid.n_lon + ix.long())[valid]
    vals = torch.stack([torch.ones_like(cell)] + [t[valid] for t in terms], 1)
    n_cells = grid.n_lat * grid.n_lon
    return lambda: torch.zeros(n_cells, vals.shape[1], dtype=torch.int64,
                               device=cell.device).index_add_(0, cell, vals)


def k3_library_chain(torch, grid, lat, lon, data):
    """K3's whole function as one PyTorch call chain, for ``library_ms``:
    the float64 cell of each coordinate (``bin_indices``), the valid
    samples' data with NaN zeroed, one int64 ``index_add_`` of the same
    fixed-point sums."""
    from auromat_tpu_torch.ops.regrid import bin_indices

    n_cells = grid.n_lat * grid.n_lon

    def call():
        flat, valid = bin_indices(grid, lat, lon)
        keep = valid.reshape(-1).nonzero().squeeze(1)
        d = data.reshape(-1, data.shape[-1])[keep]
        d = torch.where(d == d, d, 0.0)
        q = torch.round((d[:, 3].double() + 90.0) * 2.0 ** 30).long()
        vals = torch.cat([torch.ones_like(q)[:, None], d[:, :3].long(),
                          q[:, None]], 1)
        return torch.zeros(n_cells, 5, dtype=torch.int64,
                           device=lat.device).index_add_(
            0, flat.reshape(-1)[keep].long(), vals)

    return call


def fixed_terms(torch, chans, elev, shift=30, i8=False):
    """int64 terms of K1/K2's 'uint8' contract: integer channels as they
    are, elevation in fixed point (NaN adds 0)."""
    nan0 = lambda t: torch.where(t == t, t, 0.0)
    e = nan0(elev)
    q = (torch.floor((e + 90.0) * 2.0 ** 16) if i8
         else torch.round((e.double() + 90.0) * 2.0 ** shift))
    return [nan0(c).long() for c in chans] + [q.long()]


def wall_ms(torch, fn, reps):
    """Median host-clock ms of ``fn()`` ending in a device synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def gate_resampled(np, name, r, golden):
    """The slice's golden gates on a resampled mapping: grid coordinates
    within 1e-9 deg, elevation within 1e-4, at most 4 mask cells apart."""
    lats = np.asarray(r.lats.filled(np.nan))
    if lats.shape != golden["lats"].shape:
        raise AssertionError(f"{name}: grid {lats.shape} != golden "
                             f"{golden['lats'].shape}")
    gerr = 0.0
    for ours, key in ((lats, "lats"), (r.lons.filled(np.nan), "lons"),
                      (r.latsCenter.filled(np.nan), "lats_center"),
                      (r.lonsCenter.filled(np.nan), "lons_center")):
        ours = np.asarray(ours)
        both = ~np.isnan(ours) & ~np.isnan(golden[key])
        gerr = max(gerr, np.abs(ours[both] - golden[key][both]).max())
    elev = np.asarray(r.elevation.filled(np.nan))
    both = ~np.isnan(elev) & ~np.isnan(golden["elevation"])
    eerr = np.abs(elev[both] - golden["elevation"][both]).max()
    mdiff = int((np.ma.getmaskarray(r.img) != golden["img_mask"])
                .any(axis=-1).sum())
    if not (gerr < 1e-9 and eerr < 1e-4 and mdiff <= 4):
        raise AssertionError(f"{name} vs golden: grids {gerr}, elevation "
                             f"{eerr}, {mdiff} mask cells")
    return gerr, eerr, mdiff


def gate_routes(np, name, r, ref):
    """Two resamplings of one mapping: equal masks (equal counts), uint8
    within one step on at most 0.1% of the cells; returns (max step,
    fraction off by one)."""
    mask = np.ma.getmaskarray(r.img)
    if not np.array_equal(mask, np.ma.getmaskarray(ref.img)):
        raise AssertionError(f"{name}: masks differ")
    ok = ~mask
    d = np.abs(r.img.data.astype(int) - ref.img.data.astype(int))[ok]
    if not (d.max() <= 1 and (d == 1).mean() < 1e-3):
        raise AssertionError(f"{name}: uint8 max step {d.max()}, "
                             f"{(d == 1).mean()} off by one")
    return int(d.max()), float((d == 1).mean())


def slice_phases(torch, np, builds, grid, iy, ix, out, card):
    """Phases 6-9 at the main path's frame (its bin indices ``iy``, ``ix``
    on ``grid`` and its georeference ``out``); returns the kernels-line
    rows of K1-i8, K2 and K3."""
    from auromat_tpu_torch.io import fits
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from auromat_tpu_torch.mapping.mapping import sanitize_masks
    from auromat_tpu_torch.ops import _kernels
    from auromat_tpu_torch.ops import regrid_pallas as rp
    from auromat_tpu_torch.ops.georef import GeorefParams, georeference
    from auromat_tpu_torch.ops.georegrid import (bin_mean_rgbelev,
                                                 bin_rgbelev_from_indices,
                                                 bin_rgbelev_plain,
                                                 split_bin_indices)
    from auromat_tpu_torch.ops.regrid import bin_indices, fixed_grid
    from auromat_tpu_torch.coordinates.wcs import TanWcs
    from auromat_tpu_torch.resample import resample
    from auromat_tpu_torch.utils import convex_hull, outline

    dev = torch.device("cuda")
    elev, lat, lon = out["elevation"], out["lat"], out["lon"]
    k1, k1i8 = _kernels.GEOREGRID_BIN, _kernels.GEOREGRID_BIN_I8
    k2, k3 = _kernels.REGRID_BIN, _kernels.REGRID_BIN_V1

    # -- 6. the other builds ------------------------------------------------
    secs = builds[k2.source].result()
    print(f"[6] built K2/K3 ({k2.source}) in {secs:.2f} s -> "
          f"{os.path.relpath(k2.path)}", flush=True)
    for name, k in (("K3", k3), ("K1-i8", k1i8)):
        t0 = time.perf_counter()
        k.build()
        print(f"[6] loaded {name} ({k.source}, {k.symbol}) in "
              f"{time.perf_counter() - t0:.3f} s (library built with "
              f"{'K2' if k is k3 else 'K1'})", flush=True)

    # -- 7. each new kernel vs its plain version at the frame's shapes -------
    shape = tuple(iy.shape)
    n_valid = int((iy >= 0).sum().item())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda c: torch.rand(shape + (c,), generator=gen, device=dev)
    img3 = torch.floor(rand(3) * 256)
    data = {
        "uint8": torch.cat([img3, elev[..., None]], -1).contiguous(),
        "taint": torch.cat([img3, (rand(4) < 0.01).float(), elev[..., None]],
                           -1).contiguous(),
        "full": (rand(2) * 65535.0).contiguous(),
        "raw": (rand(2) * 200 - 100).to(torch.bfloat16).float().contiguous(),
    }
    err = {}
    for kind, d in data.items():
        mode = "uint8" if kind == "taint" else kind
        got = rp.bin_partial_pallas_cw(grid, (iy, ix), d, d.shape[-1], mode)
        want = rp.bin_partial_cw_plain(grid, iy, ix, d, mode)
        torch.cuda.synchronize()
        err["K2"] = max(err.get("K2", 0.0),
                        check_equal(torch, f"K2 '{kind}'", got, want))
        if int(got[0].sum().item()) != n_valid:
            raise AssertionError(f"K2 '{kind}': count total != valid samples")
    got = rp.bin_partial_pallas(grid, lat, lon, data["uint8"], "uint8")
    want = rp.bin_partial_cw_plain(grid, iy, ix, data["uint8"], "uint8")
    torch.cuda.synchronize()
    err["K3"] = check_equal(torch, "K3", got, want)
    if int(got[0].sum().item()) != n_valid:
        raise AssertionError("K3: count total != valid samples")
    img_chw = img3.permute(2, 0, 1).contiguous()
    got = bin_rgbelev_from_indices(grid, iy, ix, img_chw, elev, compute="i8")
    want = bin_rgbelev_plain(grid, iy, ix, img_chw, elev, compute="i8")
    torch.cuda.synchronize()
    err["K1-i8"] = check_equal(torch, "K1-i8", got, want)
    if int(got[0].sum().item()) != n_valid:
        raise AssertionError("K1-i8: count total != valid samples")
    print(f"[7] K2 ('uint8', 'full', 'raw', taint stack), K3 and K1-i8 == "
          f"plain (torch.equal) at {shape[0]}x{shape[1]} -> "
          f"{grid.n_lat}x{grid.n_lon}, {n_valid} valid samples", flush=True)

    # -- 8. the slice: create_mapping -> resample on the card ----------------
    golden = np.load(GOLDEN_RESAMPLE)
    header = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
    photo_time = fits.get_shifted_photo_time(header)
    frame = np.random.default_rng(SEED).integers(
        0, 256, (header["IMAGEH"], header["IMAGEW"], 3), dtype=np.uint8)
    altitude, ppd = float(golden["altitude"]), float(golden["px_per_deg"])
    make = lambda: create_mapping(header, frame, pos, photo_time,
                                  altitude=altitude, fast_center=False,
                                  identifier="ISS030-E-102170_dc", device=dev)
    m = make()
    bb = m.boundingBox  # this frame has no pole and no discontinuity
    rgrid = fixed_grid(ppd, bb.latSouth, bb.latNorth, bb.lonWest, bb.lonEast)
    launches = {}
    routes = {}
    for route, kernel in (("auto", k1), ("pallas_taint", k2)):
        for k in (k1, k1i8, k2, k3):
            k.launches = 0
        routes[route] = resample(m, px_per_deg=ppd, bin_method=route,
                                 device=dev)
        torch.cuda.synchronize()
        launches[route] = kernel.launches
        if kernel.launches < 1:
            raise AssertionError(f"resample bin_method={route!r} never "
                                 f"launched {kernel.source}")
        gerr, eerr, mdiff = gate_resampled(np, route, routes[route], golden)
        print(f"[8] resample {route!r} on the card: {kernel.launches} launch(es) "
              f"of {'K1' if kernel is k1 else 'K2'}; vs golden: grids "
              f"{gerr:.3g} deg, elevation {eerr:.3g}, {mdiff} mask cells",
              flush=True)
    cpu = resample(m, px_per_deg=ppd, device="cpu")
    step, off1 = gate_routes(np, "auto vs pallas_taint", routes["auto"],
                             routes["pallas_taint"])
    print(f"[8] routes agree: masks equal, uint8 max step {step}, "
          f"{off1:.2e} off by one", flush=True)
    for route, r in routes.items():
        step, off1 = gate_routes(np, f"{route} vs cpu", r, cpu)
        print(f"[8] {route!r} vs resample on the CPU ('sorted', float64): "
              f"masks equal, uint8 max step {step}, {off1:.2e} off by one",
              flush=True)
    # K3's and K1-i8's entry points on the same frame
    lats_c = torch.from_numpy(m.latsCenter.filled(np.nan)).to(dev)
    lons_c = torch.from_numpy(m.lonsCenter.filled(np.nan)).to(dev)
    merged = torch.from_numpy(np.concatenate(
        [frame.astype(np.float32), m.elevation.filled(np.nan)[..., None]
         .astype(np.float32)], -1)).to(dev)
    for k in (k1, k1i8, k2, k3):
        k.launches = 0
    c3, _ = rp.bin_partial_pallas(rgrid, lats_c, lons_c, merged, "uint8")
    torch.cuda.synchronize()
    launches["K3"] = k3.launches
    for k in (k1, k1i8, k2, k3):
        k.launches = 0
    riy, rix = split_bin_indices(rgrid, *bin_indices(rgrid, lats_c, lons_c))
    ci8, _ = bin_rgbelev_from_indices(
        rgrid, riy, rix, merged[..., :3].permute(2, 0, 1).contiguous(),
        merged[..., 3].contiguous(), compute="i8")
    torch.cuda.synchronize()
    launches["K1-i8"] = k1i8.launches
    for name in ("K3", "K1-i8"):
        if launches[name] < 1:
            raise AssertionError(f"{name}'s entry point never launched it")
    if not torch.equal(c3, ci8):
        raise AssertionError("K3 and K1-i8 counts differ on the frame")
    n_cells = int((c3 > 0).sum().item())
    if n_cells != int((~np.ma.getmaskarray(routes["auto"].img)[..., 0]).sum()):
        raise AssertionError("K3 filled cells != the resampled mapping's")
    print(f"[8] K3 (bin_partial_pallas) and K1-i8 on the frame's centres: "
          f"counts equal, {int(c3.sum().item())} samples into {n_cells} "
          f"cells", flush=True)

    # -- 9. times -------------------------------------------------------------
    times = {}
    for kind in ("taint", "uint8", "full"):
        d = data[kind]
        mode = "uint8" if kind == "taint" else kind
        times["K2", kind] = in_turns(
            torch, lambda: rp.bin_partial_pallas_cw(grid, (iy, ix), d,
                                                    d.shape[-1], mode),
            lambda: rp.bin_partial_cw_plain(grid, iy, ix, d, mode))
    # K2 alone on the taint stack (binning, checks and epilogue), without
    # the wrapper's zero-fill and status read
    taint, n_cells = data["taint"], grid.n_lat * grid.n_lon
    bufs = (torch.zeros(n_cells, 1 + taint.shape[-1], dtype=torch.int64,
                        device=dev),
            torch.zeros(3, dtype=torch.int64, device=dev),
            torch.empty(n_cells, dtype=torch.float32, device=dev),
            torch.empty(n_cells, taint.shape[-1], dtype=torch.float32,
                        device=dev))
    k2_alone_ms = cuda_ms(torch, lambda: rp.launch_k2(
        grid, iy, ix, taint, "uint8", *bufs), N_TIMED)
    del bufs
    # one int64 index_add_ of the same sums, timed in turns with the kernel
    lib = {
        "K2": (lambda: rp.bin_partial_pallas_cw(grid, (iy, ix), taint, 8,
                                                "uint8"),
               library_call(torch, grid, iy, ix, fixed_terms(
                   torch, [taint[..., c] for c in range(7)], taint[..., 7]))),
        "K3": (lambda: rp.bin_partial_pallas(grid, lat, lon, data["uint8"],
                                             "uint8"),
               k3_library_chain(torch, grid, lat, lon, data["uint8"])),
        "K3 given indices": (
            lambda: rp.bin_partial_pallas(grid, lat, lon, data["uint8"],
                                          "uint8"),
            library_call(torch, grid, iy, ix, fixed_terms(
                torch, [img3[..., c] for c in range(3)], elev))),
        "K1-i8": (lambda: bin_rgbelev_from_indices(grid, iy, ix, img_chw, elev,
                                                   compute="i8"),
                  library_call(torch, grid, iy, ix, fixed_terms(
                      torch, [img3[..., c] for c in range(3)], elev,
                      i8=True))),
    }
    lib_ms = {}
    for name, (kernel, call) in lib.items():
        _, lib_ms[name], _, _ = in_turns(torch, kernel, call)
    k3_lib = lib["K3"][1]()
    if not torch.equal(k3_lib[:, 0].float().reshape(grid.n_lat, grid.n_lon),
                       rp.bin_partial_pallas(grid, lat, lon, data["uint8"],
                                             "uint8")[0]):
        raise AssertionError("K3's library chain counts != K3's")
    del lib, k3_lib
    n_bytes = {
        "K2": bin_bytes(4, iy.numel(), n_valid, 8, n_cells, 9),
        "K3": bin_bytes(lat.element_size(), iy.numel(), n_valid, 4, n_cells,
                        5),
        "K1-i8": bin_bytes(4, iy.numel(), n_valid, 4, n_cells, 5)}
    times["K3"] = in_turns(
        torch, lambda: rp.bin_partial_pallas(grid, lat, lon, data["uint8"],
                                             "uint8"),
        lambda: rp.bin_partial_pallas_plain(grid, lat, lon, data["uint8"],
                                            "uint8"))
    times["K1-i8"] = in_turns(
        torch, lambda: bin_rgbelev_from_indices(grid, iy, ix, img_chw, elev,
                                                compute="i8"),
        lambda: bin_rgbelev_plain(grid, iy, ix, img_chw, elev, compute="i8"))
    for key, (k_ms, p_ms, _, _) in times.items():
        label = key if isinstance(key, str) else f"{key[0]} {key[1]!r}"
        print(f"[9] {label}: {k_ms:.3f} ms vs plain {p_ms:.3f} ms at "
              f"{shape[0]}x{shape[1]} -> {grid.n_lat}x{grid.n_lon}; on {card}",
              flush=True)
    print(f"[9] K2 kernel alone on the taint stack: {k2_alone_ms:.3f} ms; on "
          f"{card}", flush=True)
    for name in ("K2", "K3", "K1-i8"):
        print(f"[9] {name}: one int64 index_add_ of the same sums "
              f"{lib_ms[name]:.3f} ms; bound {bound_ms(n_bytes[name]):.4f} ms "
              f"({n_bytes[name]} bytes at 3.35 TB/s); on {card}", flush=True)
    print(f"[9] K3's library_ms is its whole function as one call chain "
          f"(float64 bin_indices of the f32 lat/lon, the valid samples' data, "
          f"one int64 index_add_): {lib_ms['K3']:.3f} ms; the index_add_ "
          f"alone, given the cell indices: {lib_ms['K3 given indices']:.3f} "
          f"ms; on {card}", flush=True)

    params = GeorefParams.from_wcs(TanWcs(header), pos, photo_time, altitude)
    georef_ms = cuda_ms(torch, lambda: georeference(params, False, True,
                                                    torch.float64, dev), 5)
    out = georeference(params, False, True, torch.float64, dev)
    keys = ("lats", "lons", "lats_center", "lons_center", "elevation")
    d2h_ms = wall_ms(torch, lambda: [out[k].cpu() for k in keys], N_WALL)
    cm, ccm = np.isnan(m._lats), np.isnan(m._lats_center)
    t0 = time.perf_counter()
    sanitize_masks(cm, ccm)
    sanitize_ms = (time.perf_counter() - t0) * 1e3
    create_ms = wall_ms(torch, make, N_WALL)
    print(f"[9] create_mapping (4256x2832, float64, exact centres, MLat/MLT): "
          f"{create_ms:.1f} ms wall = georeference {georef_ms:.1f} ms on the "
          f"device + {create_ms - georef_ms:.1f} ms host (of which "
          f"device->host copies of 5 float64 arrays {d2h_ms:.1f} ms, "
          f"sanitize_masks {sanitize_ms:.1f} ms); on {card}", flush=True)

    t0 = time.perf_counter()
    o = outline(~m.corner_mask)
    convex_hull(o)
    outline_ms = (time.perf_counter() - t0) * 1e3
    host_in = [m.latsCenter.filled(np.nan), m.lonsCenter.filled(np.nan),
               np.concatenate([frame.astype(np.float64),
                               m.elevation.filled(np.nan)[..., None]], -1)]
    h2d_ms = wall_ms(torch, lambda: [torch.from_numpy(a).to(dev)
                                     for a in host_in], N_WALL)
    dev_in = [torch.from_numpy(a).to(dev) for a in host_in]
    bin_ms = {
        "auto": cuda_ms(torch, lambda: bin_mean_rgbelev(rgrid, *dev_in), 5),
        "pallas_taint": cuda_ms(
            torch, lambda: rp.bin_mean_pallas_taint(rgrid, *dev_in), 5)}

    def fresh_resample(route):
        m._outlines = m._bounding_box = None  # time the outline too
        resample(m, px_per_deg=ppd, bin_method=route, device=dev)

    wall = {}
    for route in ("auto", "pallas_taint"):
        wall[route] = wall_ms(torch, lambda: fresh_resample(route), N_WALL)
        print(f"[9] resample {route!r} (-> {rgrid.n_lat}x{rgrid.n_lon}): "
              f"{wall[route]:.1f} ms wall = binning {bin_ms[route]:.1f} ms on "
              f"the device + {wall[route] - bin_ms[route]:.1f} ms host (of "
              f"which outline + hull {outline_ms:.1f} ms, host->device copies "
              f"of 3 float64 arrays {h2d_ms:.1f} ms); on {card}", flush=True)
    slice_ms = create_ms + wall["auto"]
    device_ms = georef_ms + bin_ms["auto"]
    print(f"[9] slice per frame (create_mapping + resample 'auto'): "
          f"{slice_ms:.1f} ms, of which {device_ms:.1f} ms on the device; "
          f"on {card}", flush=True)

    k1_src = "auromat_tpu_torch/ops/csrc/georegrid_bin.cu"
    k2_src = "auromat_tpu_torch/ops/csrc/regrid_bin.cu"
    return [
        kernel_row("georegrid_bin i8 (K1-i8)", k1_src,
                   "auromat_tpu/ops/georegrid.py:142", launches["K1-i8"],
                   err["K1-i8"], *times["K1-i8"][:2], n_bytes["K1-i8"],
                   lib_ms["K1-i8"]),
        kernel_row("regrid_bin (K2), taint stack", k2_src,
                   "auromat_tpu/ops/regrid_pallas.py:292",
                   launches["pallas_taint"], err["K2"],
                   *times["K2", "taint"][:2], n_bytes["K2"], lib_ms["K2"]),
        dict(kernel_row("regrid_bin via bin_partial_pallas (K3)", k2_src,
                        "auromat_tpu/ops/regrid_pallas.py:68", launches["K3"],
                        err["K3"], *times["K3"][:2], n_bytes["K3"],
                        lib_ms["K3"]),
             library_ms_given_indices=lib_ms["K3 given indices"]),
    ]


def seq_frames(np):
    """The 10 real calibrations of SEQ_WCS (GeorefParams, photo times) and
    seeded uint8 images (10, 2832, 4256, 3) on the host."""
    from auromat_tpu_torch.coordinates.wcs import TanWcs
    from auromat_tpu_torch.io import fits
    from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position
    from auromat_tpu_torch.ops.georef import GeorefParams

    params, times = [], []
    for path in SEQ_WCS:
        header = fits.read_header(path)
        pos, t, _ = resolve_camera_position(header)
        params.append(GeorefParams.from_wcs(TanWcs(header), pos, t, 110.0))
        times.append(t)
    h, w = params[0].height, params[0].width
    imgs = np.random.default_rng(SEED).integers(
        0, 256, (len(params), h, w, 3), dtype=np.uint8)
    return params, times, imgs


def check_equal_all(torch, name, got, want):
    """Raise unless every tensor pair is bit-equal (NaN == NaN)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0)):
            raise AssertionError(f"{name}: output {i} differs")


def mosaic_phases(torch, np, card):
    """Phases 10-13: K1 on a frame burst, the sequence-mosaic path on the
    card, ``convert --mosaic`` and the burst/sequence/config-5 times;
    returns the kernels-line row of K1 on the mosaic path."""
    import contextlib
    import dataclasses
    import io
    import re
    import tempfile

    from auromat_tpu_torch.cli import convert
    from auromat_tpu_torch.entry import frame_setup
    from auromat_tpu_torch.io import cdflib
    from auromat_tpu_torch.ops import _kernels
    from auromat_tpu_torch.ops.georef import DynGeorefParams
    from auromat_tpu_torch.ops.georegrid import (bin_rgbelev_int,
                                                 bin_rgbelev_plain_int,
                                                 georegrid_inputs)
    from auromat_tpu_torch.ops.regrid import fixed_grid, round_up
    from auromat_tpu_torch.parallel import (make_grid_sharded_mosaic_step,
                                            make_mesh, mosaic_sequence)

    dev = torch.device("cuda")
    k1 = _kernels.GEOREGRID_BIN
    all_kernels = (k1, _kernels.GEOREGRID_BIN_I8, _kernels.REGRID_BIN,
                   _kernels.REGRID_BIN_V1)
    params, times, imgs = seq_frames(np)
    n_seq, h, w = imgs.shape[:3]
    g5 = fixed_grid(*GLOBAL_005)
    mesh = make_mesh(device=dev)

    # -- 10. K1 on an 8-frame stacked burst ---------------------------------
    g5_pad = dataclasses.replace(g5, n_lat=round_up(g5.n_lat, 8))
    dyn = DynGeorefParams.stack(params[:8], device=dev)
    parts = [georegrid_inputs(g5, dyn.frame(i), h, w) for i in range(8)]
    iy8 = torch.cat([p[0] for p in parts])
    ix8 = torch.cat([p[1] for p in parts])
    el8 = torch.cat([p[2]["elevation"] for p in parts])
    del parts
    img8 = torch.from_numpy(imgs[:8]).to(dev).permute(3, 0, 1, 2).reshape(
        3, 8 * h, w).float().contiguous()
    got = bin_rgbelev_int(g5_pad, iy8, ix8, img8, el8)
    want = bin_rgbelev_plain_int(g5_pad, iy8, ix8, img8, el8)
    torch.cuda.synchronize()
    for what, a, b in zip(("count/RGB", "elevation"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"K1 on the 8-frame burst != plain on {what}")
    burst_err = max(float((a - b).abs().max().item()) for a, b in zip(got, want))
    n_valid8 = int((iy8 >= 0).sum().item())
    if int(got[0][:, 0].sum().item()) != n_valid8 or n_valid8 == 0:
        raise AssertionError("K1 on the burst: count total != valid samples")
    print(f"[10] K1 on an 8-frame burst ({8 * h}x{w} samples, "
          f"{8 * h * w * 255 / 2 ** 32:.1f}x the old 2^32/255 bound) -> "
          f"{g5_pad.n_lat}x{g5_pad.n_lon}: == plain (torch.equal, integer "
          f"sums), {n_valid8} valid samples", flush=True)
    k1b_ms, k1b_plain, _, _ = in_turns(
        torch, lambda: bin_rgbelev_int(g5_pad, iy8, ix8, img8, el8),
        lambda: bin_rgbelev_plain_int(g5_pad, iy8, ix8, img8, el8),
        N_BURST_TIMED)
    del got, want
    _, k1b_lib, _, _ = in_turns(
        torch, lambda: bin_rgbelev_int(g5_pad, iy8, ix8, img8, el8),
        library_call(torch, g5_pad, iy8, ix8, fixed_terms(
            torch, list(img8), el8)), N_BURST_TIMED)
    n_cells5 = g5_pad.n_lat * g5_pad.n_lon
    k1b_bytes = bin_bytes(4, iy8.numel(), n_valid8, 4, n_cells5, 5, 8)
    print(f"[10] K1 on the 8-frame burst: {k1b_ms:.3f} ms vs plain "
          f"{k1b_plain:.3f} ms (integer sums; the cell-count check is in "
          f"the kernel) and one int64 index_add_ {k1b_lib:.3f} ms; bound "
          f"{bound_ms(k1b_bytes):.4f} ms ({k1b_bytes} bytes at 3.35 TB/s); "
          f"on {card}", flush=True)
    del iy8, ix8, el8, img8

    # -- 11. the sequence-mosaic path -----------------------------------------
    n_valid = n_high = 0
    for p in params:
        iy, _, out = georegrid_inputs(
            g5, DynGeorefParams.from_static(p, dev, torch.float32), h, w)
        n_valid += int((iy >= 0).sum().item())
        n_high += int(((iy >= 0) & (out["elevation"] >= 10.0)).sum().item())
        del iy, out
    bursts = [(params, imgs)]
    for k in all_kernels:
        k.launches = 0
    count, means = mosaic_sequence(mesh, g5, bursts, batch=8,
                                   bin_method="pallas")
    torch.cuda.synchronize()
    seq_launches = k1.launches
    if seq_launches < 1:
        raise AssertionError("the sequence-mosaic path never launched K1")
    if tuple(count.shape) != (g5_pad.n_lat, g5.n_lon) or \
            tuple(means.shape) != (g5_pad.n_lat, g5.n_lon, 4):
        raise AssertionError(f"mosaic shapes {tuple(count.shape)} "
                             f"{tuple(means.shape)}")
    total = int(count.sum(dtype=torch.float64).item())  # > 2^24: not in f32
    if total != n_valid:
        raise AssertionError(f"mosaic count {total} != {n_valid} valid samples")
    filled = count > 0
    if not torch.isfinite(means[filled]).all() or \
            not torch.isnan(means[~filled]).all():
        raise AssertionError("mosaic means not finite exactly where filled")
    plain = mosaic_sequence(mesh, g5, bursts, batch=8,
                            bin_method="pallas_plain")
    check_equal_all(torch, "mosaic vs plain binning", (count, means), plain)
    one = mosaic_sequence(mesh, g5, bursts, batch=n_seq)
    check_equal_all(torch, "2 bursts vs one step", (count, means), one)
    masked, _ = mosaic_sequence(mesh, g5, bursts, batch=8, min_elevation=10.0)
    n_masked = int(masked.sum(dtype=torch.float64).item())
    if n_masked != n_high:
        raise AssertionError(f"min_elevation=10: {n_masked} != {n_high}")
    print(f"[11] mosaic_sequence(batch=8) of {n_seq} frames "
          f"({os.path.basename(SEQ_WCS[0])}..) -> {g5.n_lat}x{g5.n_lon}: "
          f"{seq_launches} launches of K1, {total} samples into "
          f"{int(filled.sum().item())} cells (= the frames' valid samples), "
          f"== plain binning, == one 10-frame step (bit-equal, elevation "
          f"too); min_elevation=10: {n_high} samples", flush=True)
    del count, means, plain, one, masked

    # -- 12. convert --mosaic on the card ---------------------------------------
    class SeqProvider:
        altitude = 110.0

        def timeRange(self, dateBegin=None, dateEnd=None):
            return times[0], times[-1]

        def iterParamBursts(self, dateBegin=None, dateEnd=None, batch=8):
            for i in range(0, n_seq, batch):
                yield params[i:i + batch], imgs[i:i + batch]

    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "ISS029-E-8493-8502")
        args = convert.build_parser().parse_args(
            [folder, "--mosaic", "0.25", "--format", "cdf", "--out", tmp,
             "--platform", "cuda"])
        device = convert.platform_device(args.platform)
        for k in all_kernels:
            k.launches = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            path = convert.convert_mosaic(SeqProvider(), args, tmp, device)
        torch.cuda.synchronize()
        cli_launches = k1.launches
        m = re.search(r"\((\d+) occupied cells\)", log.getvalue())
        if path is None or m is None or cli_launches < 1:
            raise AssertionError(f"convert_mosaic: {log.getvalue()!r}, "
                                 f"{cli_launches} K1 launches")
        g25 = fixed_grid(4, -89.999, 89.999, -179.999, 179.999)
        c25, _ = mosaic_sequence(mesh, g25, SeqProvider().iterParamBursts(),
                                 batch=8)
        occupied = int((c25[:g25.n_lat] > 0).sum().item())
        red = cdflib.CDFReader(path)["img_red"]
        in_file = int((np.asarray(red[0]) != red.attrs["FILLVAL"]).sum())
        if not int(m.group(1)) == occupied == in_file:
            raise AssertionError(f"convert_mosaic: {m.group(1)} occupied cells "
                                 f"printed, {occupied} in the mosaic, "
                                 f"{in_file} in the file")
        size = os.path.getsize(path)
    print(f"[12] convert_mosaic on {device} ({g25.n_lat}x{g25.n_lon}, "
          f"{cli_launches} K1 launches): {occupied} occupied cells printed "
          f"== mosaic_sequence's == the CDF's ({size} bytes)", flush=True)

    # -- 13. times -------------------------------------------------------------
    grid, _, p0 = frame_setup(dev)
    h0, w0 = p0.height, p0.width
    frame = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (1, h0, w0, 3), dtype=np.uint8)).to(dev)
    imgs8 = frame.expand(8, -1, -1, -1).contiguous()
    dyn8 = DynGeorefParams.stack([p0] * 8, device=dev)
    step8, plain8 = (make_grid_sharded_mosaic_step(mesh, grid, h0, w0,
                                                   bin_method=b)
                     for b in ("pallas", "pallas_plain"))
    check_equal_all(torch, "burst8 step vs plain", step8(dyn8, imgs8),
                    plain8(dyn8, imgs8))
    b8_ms, b8_plain, b8_runs, _ = in_turns(
        torch, lambda: step8(dyn8, imgs8), lambda: plain8(dyn8, imgs8),
        N_BURST_TIMED)
    print(f"[13] burst8 (grid-sharded step, B=8, {h0}x{w0} -> "
          f"{grid.n_lat}x{grid.n_lon}): {b8_ms / 8:.3f} ms/frame (plain "
          f"binning {b8_plain / 8:.3f} ms/frame; step runs "
          f"{[round(t, 3) for t in b8_runs]} ms); on {card}", flush=True)

    rng = np.random.default_rng(SEED)
    base = np.asarray(p0.camera_pos)
    p100 = [dataclasses.replace(p0, camera_pos=tuple(
        base * (1.0 + 1e-4 * rng.standard_normal(3)))) for _ in range(N_SEQ)]

    def run100():
        chunks = ((p100[i:i + 8], imgs8[:len(p100[i:i + 8])])
                  for i in range(0, N_SEQ, 8))
        return mosaic_sequence(mesh, grid, chunks, batch=8)

    c100, _ = run100()
    if int(c100.sum().item()) <= 0:
        raise AssertionError("burst100: nothing binned")
    seq_ms = wall_ms(torch, run100, N_WALL)
    print(f"[13] burst100 (mosaic_sequence, {N_SEQ} jittered frames, "
          f"device-resident 8-frame buffer): {seq_ms / N_SEQ:.3f} ms/frame "
          f"wall ({seq_ms:.1f} ms); on {card}", flush=True)

    dyn4 = DynGeorefParams.stack([p0] * 4, device=dev)
    imgs4 = imgs8[:4]
    step5 = make_grid_sharded_mosaic_step(mesh, g5, h0, w0,
                                          bin_method="pallas")
    c5, _ = step5(dyn4, imgs4)
    if int(c5.sum().item()) <= 0:
        raise AssertionError("config5: nothing binned")
    torch.cuda.reset_peak_memory_stats()
    c5_ms = cuda_ms(torch, lambda: step5(dyn4, imgs4), N_BURST_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[13] config5 (grid-sharded step, B=4, {h0}x{w0} -> "
          f"{g5.n_lat}x{g5.n_lon}): {c5_ms / 4:.3f} ms/frame; peak device "
          f"memory {peak:.2f} GiB; on {card}", flush=True)

    return kernel_row("georegrid_bin (K1) on the mosaic path, 8-frame burst",
                      "auromat_tpu_torch/ops/csrc/georegrid_bin.cu",
                      "auromat_tpu/ops/georegrid.py:65", seq_launches,
                      burst_err, k1b_ms, k1b_plain, k1b_bytes, k1b_lib)


def tile_path_phases(torch, np, grid, card):
    """Phase 14: the tile histograms' fallback and ragged paths, and the
    refusals, at full size."""
    from auromat_tpu_torch.ops import regrid_pallas as rp
    from auromat_tpu_torch.ops.georegrid import (MAX_CELL_COUNT,
                                                 bin_rgbelev_from_indices,
                                                 bin_rgbelev_plain)
    from auromat_tpu_torch.ops.regrid import bin_indices, fixed_grid

    dev = torch.device("cuda")
    small = fixed_grid((2.0, 1.0), 0.05, 19.95, 0.5, 129.5)

    def inputs(g, shape, seed, offset=0):
        """Seeded iy, ix over the whole grid (10% invalid, some past its
        edge), image, elevation (1% NaN) and (image, elevation) channels
        on the card, each cut ``offset`` elements into a buffer."""
        rng = np.random.default_rng(seed)
        iy = rng.integers(0, g.n_lat, shape)
        ix = rng.integers(0, g.n_lon + 2, shape)
        iy[rng.random(shape) < 0.1] = -1
        img = rng.integers(0, 256, (3,) + shape).astype(np.float32)
        elev = rng.uniform(-90, 90, shape).astype(np.float32)
        elev[rng.random(shape) < 0.01] = np.nan
        data = np.concatenate([np.moveaxis(img, 0, -1), elev[..., None]], -1)

        def on(a, dtype):
            flat = torch.zeros(a.size + offset, dtype=dtype, device=dev)
            t = flat[offset:].view(a.shape)
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            return t

        return (on(iy, torch.int32), on(ix, torch.int32),
                on(img, torch.float32), on(elev, torch.float32),
                on(data, torch.float32))

    def check_all(name, g, iy, ix, img, elev, data):
        """K1, K1-i8 and K2 in every mode == plain; count totals."""
        valid = (iy >= 0) & (iy < g.n_lat) & (ix >= 0) & (ix < g.n_lon)
        n_valid = int(valid.sum().item())
        gen = torch.Generator(device=dev).manual_seed(SEED)
        shape = tuple(iy.shape)
        rand = lambda c: torch.rand(shape + (c,), generator=gen, device=dev)
        k2 = {"uint8": data,
              "taint": torch.cat([data[..., :3], (rand(4) < 0.3).float(),
                                  data[..., 3:]], -1).contiguous(),
              "full": rand(2) * 65535.0,
              "raw": (rand(3) * 200 - 100).to(torch.bfloat16).float()}
        pairs = [(f"K1 {c}",
                  lambda c=c: bin_rgbelev_from_indices(g, iy, ix, img, elev, c),
                  lambda c=c: bin_rgbelev_plain(g, iy, ix, img, elev, c))
                 for c in ("bf16", "i8")]
        pairs += [(f"K2 {kind}",
                   lambda d=d, m=("uint8" if kind == "taint" else kind):
                   rp.bin_partial_pallas_cw(g, (iy, ix), d, d.shape[-1], m),
                   lambda d=d, m=("uint8" if kind == "taint" else kind):
                   rp.bin_partial_cw_plain(g, iy, ix, d, m))
                  for kind, d in k2.items()]
        for label, kernel, plain in pairs:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            check_equal(torch, f"{name}: {label}", got, want)
            if int(got[0].sum(dtype=torch.float64).item()) != n_valid:
                raise AssertionError(f"{name}: {label} count != valid samples")
        return n_valid

    # -- random cells: every tile's box is the whole grid (the fallback) --
    h, w = 2832, 4256
    iy, ix, img, elev, data = inputs(grid, (h, w), SEED)
    n_valid = check_all("random cells", grid, iy, ix, img, elev, data)
    rng = np.random.default_rng(SEED)
    lat = torch.from_numpy(rng.uniform(46.9, 62.1, (h, w))).to(dev)
    lon = torch.from_numpy(rng.uniform(-112.1, -90.9, (h, w))).to(dev)
    got = rp.bin_partial_pallas(grid, lat, lon, data, "uint8")
    want = rp.bin_partial_pallas_plain(grid, lat, lon, data, "uint8")
    torch.cuda.synchronize()
    check_equal(torch, "random coordinates: K3", got, want)
    if int(got[0].sum().item()) != int(bin_indices(grid, lat, lon)[1].sum()):
        raise AssertionError("K3 on random coordinates: count != valid")
    rand_ms, rand_plain, _, _ = in_turns(
        torch, lambda: bin_rgbelev_from_indices(grid, iy, ix, img, elev),
        lambda: bin_rgbelev_plain(grid, iy, ix, img, elev))
    print(f"[14] random cells over {grid.n_lat}x{grid.n_lon} at {h}x{w} "
          f"(every tile on the fallback): K1, K1-i8, K2 ('uint8', taint, "
          f"'full', 'raw') and K3 == plain, {n_valid} valid samples; K1 "
          f"{rand_ms:.3f} ms vs plain {rand_plain:.3f} ms; on {card}",
          flush=True)
    del iy, ix, img, elev, data, lat, lon, got, want

    # -- ragged planes ----------------------------------------------------
    cases = {"w=4257": ((37, 4257), 0), "w=131": ((96, 131), 0),
             "one row": ((1, 4256), 0), "1x3": ((1, 3), 0),
             "unaligned": ((64, 256), 1), "unaligned w=130": ((33, 130), 2)}
    for name, (shape, offset) in cases.items():
        check_all(name, small, *inputs(small, shape, SEED + 1, offset))
    iy, ix, img, elev, data = inputs(small, (64, 512), SEED + 2)
    iy.fill_(-1)
    check_all("no valid sample", small, iy, ix, img, elev, data)
    print(f"[14] ragged planes ({', '.join(cases)}, no valid sample): "
          f"every kernel == plain", flush=True)

    # -- the refusals: the kernel raises the plain version's message -------
    def same_refusal(name, kernel, plain):
        msgs = []
        for fn in (kernel, plain):
            try:
                fn()
            except ValueError as e:
                msgs.append(str(e))
            else:
                raise AssertionError(f"{name}: no refusal")
        if msgs[0] != msgs[1]:
            raise AssertionError(f"{name}: {msgs[0]!r} != {msgs[1]!r}")
        return msgs[0]

    for w in (2, 4096):  # one cell a tile (fast) / a far cell a row (fallback)
        n = -(-(MAX_CELL_COUNT + 1) // (w if w == 2 else w - 1))
        iy = torch.zeros((n, w), dtype=torch.int32, device=dev)
        ix = torch.zeros_like(iy)
        if w > 2:
            iy[:, 0], ix[:, 0] = 30, 100
        img = torch.full((3, n, w), 255.0, device=dev)
        elev = torch.zeros((n, w), device=dev)
        msg = same_refusal(
            f"K1, {w} columns",
            lambda: bin_rgbelev_from_indices(small, iy, ix, img, elev),
            lambda: bin_rgbelev_plain(small, iy, ix, img, elev))
        del iy, ix, img, elev
    iy, ix, img, elev, data = inputs(small, (64, 512), SEED + 3)
    iy[10, 10], ix[10, 10] = 3, 3
    data[10, 10, 0] = 0.5
    msg2 = same_refusal(
        "K2 'uint8'",
        lambda: rp.bin_partial_pallas_cw(small, (iy, ix), data, 4, "uint8"),
        lambda: rp.bin_partial_cw_plain(small, iy, ix, data, "uint8"))
    print(f"[14] refusals raise the plain version's message: K1 "
          f"MAX_CELL_COUNT + 1 in one cell ({msg!r}), K2 ({msg2!r})",
          flush=True)


def synth_themis(np, torch, folder, n_stations=N_STATIONS, size=ASI_SIZE,
                 n_frames=3, seed=1):
    """THEMIS L1/L2 CDFs of ``n_stations`` synthetic stations in ``folder``,
    with bench.py:395-419's geometry (seed 1, stations at lat 51-62 and lon
    -150..-60, fisheye k=155): L2 calibration corner grids ((size + 1)^2)
    at the reference altitudes 90/110/150 km, L1 hour files of ``n_frames``
    seeded exposures 3 s apart; written with the port's CDFWriter under
    the network's station names. Returns (station names, exposure times)."""
    from datetime import timedelta

    from auromat_tpu_torch.constants import WGS84_A, WGS84_B
    from auromat_tpu_torch.coordinates.intersection import \
        ellipsoid_line_intersection
    from auromat_tpu_torch.coordinates.transform import (ecef_to_geodetic,
                                                         station_ecef)
    from auromat_tpu_torch.io import cdflib
    from auromat_tpu_torch.mapping import miracle, themis

    rng = np.random.default_rng(seed)
    st_lats = 51.0 + 11.0 * rng.random(n_stations)
    st_lons = -150.0 + 90.0 * rng.random(n_stations)
    heights = np.array([90e3, 110e3, 150e3])
    times = [THEMIS_DATE + timedelta(seconds=3 * i) for i in range(n_frames)]
    stations = themis.STATIONS[:n_stations]  # the provider's default list
    for i, st in enumerate(stations):
        cal = miracle.CalibrationData(
            station=st.upper(), validFrom=None, validTo=None,
            lat=float(st_lats[i]), lon=float(st_lons[i]),
            xc=size / 2 * 512 / size, yc=size / 2 * 512 / size, k=155.0,
            rotation=0.0, boundingBoxSimple=None)
        az_c, el_c = miracle.fisheye_az_el(cal, size, corner=False)
        az_k, el_k = miracle.fisheye_az_el(cal, size, corner=True)
        dirs = torch.from_numpy(miracle.az_el_to_geo_directions(cal, az_k,
                                                                el_k))
        origin = torch.from_numpy(station_ecef(cal.lat, cal.lon))
        refs = []
        for h in heights / 1000.0:
            inter = ellipsoid_line_intersection(WGS84_A + h, WGS84_B + h,
                                                origin, dirs)
            refs.append([np.rad2deg(a.numpy()) for a in ecef_to_geodetic(
                inter[..., 0], inter[..., 1], inter[..., 2])])
        lats_ref = np.stack([r[0] for r in refs], axis=-1)
        lons_ref = np.stack([r[1] for r in refs], axis=-1)
        with cdflib.CDFWriter(os.path.join(
                folder, themis.L2_FILENAME.format(station=st))) as cdf:
            cdf.new(f"thg_asc_{st}_glat", np.float32(cal.lat), rec_vary=False)
            cdf.new(f"thg_asc_{st}_glon", np.float32(cal.lon), rec_vary=False)
            cdf.new(f"thg_asf_{st}_azim", az_c[None].astype(np.float32))
            cdf.new(f"thg_asf_{st}_elev", el_c[None].astype(np.float32))
            cdf.new(f"thg_asf_{st}_glat", lats_ref[None].astype(np.float32))
            cdf.new(f"thg_asf_{st}_glon", lons_ref[None].astype(np.float32))
            cdf.new(f"thg_asf_{st}_alti", heights.astype(np.float32),
                    rec_vary=False)
        imgs = (rng.random((n_frames, size, size)) * 8000 + 2500).astype(
            np.int32)
        with cdflib.CDFWriter(os.path.join(
                folder, themis.l1_filename(st, times[0]))) as cdf:
            cdf.new(f"thg_asf_{st}_epoch", times)
            cdf.new(f"thg_asf_{st}", imgs)
    return stations, times


def asi_phases(torch, np, card):
    """Phases 15-18: the all-sky-imager path on the card; returns the
    kernels-line row of K1 on it (MIRACLE ``resample('mean')``)."""
    import contextlib
    import io
    import tempfile
    from datetime import timedelta

    from auromat_tpu_torch import resample as resample_mod
    from auromat_tpu_torch.cli import convert
    from auromat_tpu_torch.io import cdflib
    from auromat_tpu_torch.mapping import miracle, themis
    from auromat_tpu_torch.ops import _kernels
    from auromat_tpu_torch.ops.georegrid import (bin_mean_rgbelev,
                                                 bin_rgbelev_from_indices,
                                                 bin_rgbelev_plain,
                                                 split_bin_indices)
    from auromat_tpu_torch.ops.regrid import (apply_take_best, bin_indices,
                                              bin_nearest, bin_take_best,
                                              fixed_grid,
                                              interp_cubic_structured,
                                              interp_linear_structured,
                                              plan_take_best)
    from auromat_tpu_torch.resample import mosaic, resample

    dev = torch.device("cuda")
    all_kernels = (_kernels.GEOREGRID_BIN, _kernels.GEOREGRID_BIN_I8,
                   _kernels.REGRID_BIN, _kernels.REGRID_BIN_V1)
    k1 = _kernels.GEOREGRID_BIN
    bits = lambda t: t.contiguous().view(torch.int32).cpu()
    bit_equal = lambda a, b: a.shape == b.shape and torch.equal(bits(a),
                                                                bits(b))
    tmp = tempfile.TemporaryDirectory()
    th_dir = os.path.join(tmp.name, "themis")
    os.makedirs(th_dir)
    t0 = time.perf_counter()
    stations, times = synth_themis(np, torch, th_dir)
    synth_s = time.perf_counter() - t0

    # -- 15. THEMIS at deployment scale --------------------------------------
    calls = []
    real_batch = themis.reproject_batch

    def counted(*a, **k):
        calls.append((tuple(np.shape(a[1])), str(k.get("device"))))
        return real_batch(*a, **k)

    prov = themis.ThemisMappingProvider(th_dir, th_dir, altitude=100,
                                        offline=True, stations=stations,
                                        device=dev)
    themis.reproject_batch = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coll = prov.get(times[1])
        torch.cuda.synchronize()
        get_ms = (time.perf_counter() - t0) * 1e3
    finally:
        themis.reproject_batch = real_batch
    if len(coll) != N_STATIONS or calls != [((N_STATIONS, ASI_SIZE + 1,
                                              ASI_SIZE + 1), "cuda")]:
        raise AssertionError(f"THEMIS get: {len(coll)} mappings, reprojection "
                             f"calls {calls}")
    cpu_coll = themis.ThemisMappingProvider(
        th_dir, th_dir, altitude=100, offline=True, stations=stations,
        device="cpu").get(times[1])
    gerr = 0.0
    for m, c in zip(coll.mappings, cpu_coll.mappings):
        if m.identifier != c.identifier or \
                not np.array_equal(m.corner_mask, c.corner_mask) or \
                not np.array_equal(m.img.filled(0), c.img.filled(0)):
            raise AssertionError(f"THEMIS {m.identifier}: card != CPU")
        for a, b in ((m.lats, c.lats), (m.lons, c.lons)):
            a, b = a.filled(np.nan), b.filled(np.nan)
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                raise AssertionError(f"THEMIS {m.identifier}: NaN masks")
            gerr = max(gerr, float(np.nanmax(np.abs(a - b))))
    if not gerr <= 1e-9:
        raise AssertionError(f"THEMIS reprojection card vs CPU: {gerr} deg")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mo = mosaic(coll, device=dev)
    torch.cuda.synchronize()
    mosaic_ms = (time.perf_counter() - t0) * 1e3
    mo_cpu = mosaic(coll, device="cpu")
    occupied = int((~mo.center_mask).sum())
    if not (np.array_equal(mo.center_mask, mo_cpu.center_mask)
            and np.array_equal(mo.img.filled(0), mo_cpu.img.filled(0))
            and np.array_equal(mo.elevation.filled(np.nan),
                               mo_cpu.elevation.filled(np.nan),
                               equal_nan=True)
            and mo.img.dtype == np.uint16 and occupied > 0):
        raise AssertionError("THEMIS mosaic: card != CPU")
    print(f"[15] THEMIS {N_STATIONS} stations x {ASI_SIZE}x{ASI_SIZE} "
          f"(synthetic CDFs written in {synth_s:.1f} s): "
          f"ThemisMappingProvider(device='cuda').get at 100 km "
          f"{get_ms:.1f} ms wall, one batched reprojection on the card "
          f"{calls[0][0]}, {gerr:.3g} deg from the CPU's; mosaic at 25 "
          f"px/deg -> {mo.img.shape[0]}x{mo.img.shape[1]}: {occupied} "
          f"occupied cells, {mosaic_ms:.1f} ms wall, == the CPU mosaic (uint16 "
          f"image, elevation, mask); on {card}", flush=True)

    # -- 16. themis24: the composite, its plan and one exposure's gather -------
    g24 = fixed_grid(10, 40.0, 72.0, -160.0, -50.0)
    stack = lambda name: np.stack([getattr(m, name).filled(np.nan)
                                   for m in coll.mappings])
    la24, lo24, el24 = (stack(n).astype(np.float32)
                        for n in ("latsCenter", "lonsCenter", "elevation"))
    gray = np.random.default_rng(1).random(la24.shape).astype(np.float32) * 255
    host = [la24, lo24, -el24, np.stack([gray, el24], axis=-1)]
    cpu_in = [torch.from_numpy(a) for a in host]
    dev_in = [a.to(dev) for a in cpu_in]
    tb = bin_take_best(g24, *dev_in)
    tb_cpu = bin_take_best(g24, *cpu_in)
    plan = plan_take_best(g24, *dev_in[:3])
    applied = apply_take_best(plan, dev_in[3])
    plan_cpu = plan_take_best(g24, *cpu_in[:3])
    if not (all(bit_equal(a, b) for a, b in zip(tb, tb_cpu))
            and torch.equal(plan.winner.cpu(), plan_cpu.winner)
            and bit_equal(applied, tb_cpu[0])
            and bit_equal(apply_take_best(plan_cpu, cpu_in[3]), tb_cpu[0])):
        raise AssertionError("themis24: card != CPU")
    n_cells24 = int(plan.occupied.sum().item())
    themis24_ms = cuda_ms(torch, lambda: bin_take_best(g24, *dev_in), N_TIMED)
    plan_ms = cuda_ms(torch, lambda: plan_take_best(g24, *dev_in[:3]), N_TIMED)
    apply_ms = cuda_ms(torch, lambda: apply_take_best(plan, dev_in[3]),
                       N_TIMED)
    print(f"[16] themis24 ({N_STATIONS}x{ASI_SIZE}x{ASI_SIZE} samples, 2 "
          f"channels -> {g24.n_lat}x{g24.n_lon}, {n_cells24} cells won): "
          f"themis24_ms {themis24_ms:.3f}, themis24_plan_ms {plan_ms:.3f}, "
          f"themis24_apply_ms {apply_ms:.3f} (CUDA events, median of "
          f"{N_TIMED}); composite, plan and gather == the CPU's bit for "
          f"bit; on {card}", flush=True)
    del dev_in, tb, plan, applied

    # -- 17. a MIRACLE frame: resample's routes on the card --------------------
    cal = miracle.get_calibration_data(os.path.join(RES, "cal.txt"), "SOD",
                                       SOD_DATE)
    frame = np.random.default_rng(SEED).integers(0, 256, (512, 512, 3),
                                                 dtype=np.uint8)
    m = miracle.create_mapping(frame, cal, SOD_DATE, 110, device=dev)
    m_cpu = miracle.create_mapping(frame, cal, SOD_DATE, 110, device="cpu")
    merr = float(np.nanmax(np.abs(m.lats.filled(np.nan)
                                  - m_cpu.lats.filled(np.nan))))
    if not (np.array_equal(m.center_mask, m_cpu.center_mask) and merr < 1e-9):
        raise AssertionError(f"MIRACLE mapping card vs CPU: {merr} deg")
    bb = m.boundingBox
    grid = fixed_grid((25, 25), bb.latSouth, bb.latNorth, bb.lonWest,
                      bb.lonEast)
    lats_c = torch.from_numpy(m.latsCenter.filled(np.nan)).to(dev)
    lons_c = torch.from_numpy(m.lonsCenter.filled(np.nan)).to(dev)
    merged = torch.from_numpy(np.concatenate(
        [frame.astype(np.float64), m.elevation.filled(np.nan)[..., None]],
        -1)).to(dev)
    ops = {"mean": lambda: bin_mean_rgbelev(grid, lats_c, lons_c, merged),
           "nearest": lambda: bin_nearest(grid, lats_c, lons_c, merged),
           "linear_device": lambda: interp_linear_structured(
               grid, lats_c, lons_c, merged),
           "cubic_device": lambda: interp_cubic_structured(
               grid, lats_c, lons_c, merged)}
    cpu_route = {"mean": dict(method="mean", bin_method="pallas_rgbelev"),
                 "nearest": dict(method="nearest_device"),
                 "linear_device": dict(method="linear_device"),
                 "cubic_device": dict(method="cubic_device")}
    nearest_calls = []
    real_nearest = resample_mod.bin_nearest
    resample_mod.bin_nearest = lambda *a, **k: (nearest_calls.append(
        a[1].device.type), real_nearest(*a, **k))[1]
    k1_launches = 0
    try:
        for method, op in ops.items():
            for k in all_kernels:
                k.launches = 0
            nearest_calls.clear()
            r = resample(m, method=method, device=dev)
            torch.cuda.synchronize()
            if method == "mean":
                k1_launches = k1.launches
                if k1_launches != 1:
                    raise AssertionError(f"resample('mean'): {k1_launches} "
                                         "K1 launches")
            if method == "nearest" and nearest_calls != ["cuda"]:
                raise AssertionError(f"resample('nearest') on the card took "
                                     f"{nearest_calls}")
            want = resample(m, device="cpu", **cpu_route[method])
            mask = np.ma.getmaskarray(r.img)
            if not np.array_equal(mask, np.ma.getmaskarray(want.img)):
                raise AssertionError(f"MIRACLE {method}: masks differ")
            step = int(np.abs(r.img.filled(0).astype(int)
                              - want.img.filled(0).astype(int)).max())
            if step > (0 if method in ("mean", "nearest") else 1):
                raise AssertionError(f"MIRACLE {method}: uint8 step {step}")
            wall = wall_ms(torch, lambda: resample(m, method=method,
                                                   device=dev), N_WALL)
            dev_ms = cuda_ms(torch, op, 5)
            print(f"[17] MIRACLE 512x512 resample({method!r}) on the card -> "
                  f"{r.img.shape[0]}x{r.img.shape[1]}: {wall:.1f} ms wall, "
                  f"{dev_ms:.2f} ms on the device; {int((~mask[..., 0]).sum())} "
                  f"cells, == the CPU's {cpu_route[method]} (masks equal, "
                  f"uint8 max step {step}); on {card}", flush=True)
    finally:
        resample_mod.bin_nearest = real_nearest

    # K1 at this path's shapes, against its plain version
    iy, ix = split_bin_indices(grid, *bin_indices(grid, lats_c, lons_c))
    img_chw = merged[..., :3].float().permute(2, 0, 1).contiguous()
    elev = merged[..., 3].float().contiguous()
    got = bin_rgbelev_from_indices(grid, iy, ix, img_chw, elev)
    want = bin_rgbelev_plain(grid, iy, ix, img_chw, elev)
    torch.cuda.synchronize()
    k1_err = check_equal(torch, "K1 on the MIRACLE frame", got, want)
    n_valid = int((iy >= 0).sum().item())
    k_ms, p_ms, _, _ = in_turns(
        torch, lambda: bin_rgbelev_from_indices(grid, iy, ix, img_chw, elev),
        lambda: bin_rgbelev_plain(grid, iy, ix, img_chw, elev))
    _, lib_ms, _, _ = in_turns(
        torch, lambda: bin_rgbelev_from_indices(grid, iy, ix, img_chw, elev),
        library_call(torch, grid, iy, ix, fixed_terms(torch, list(img_chw),
                                                      elev)))
    k1_bytes = bin_bytes(4, iy.numel(), n_valid, 4, grid.n_lat * grid.n_lon,
                         5)
    print(f"[17] K1 on the MIRACLE frame ({n_valid} valid samples -> "
          f"{grid.n_lat}x{grid.n_lon}): == plain; {k_ms:.3f} ms vs plain "
          f"{p_ms:.3f} ms, one int64 index_add_ {lib_ms:.3f} ms, bound "
          f"{bound_ms(k1_bytes):.4f} ms; on {card}", flush=True)

    # -- 18. convert on THEMIS and MIRACLE folders -----------------------------
    out = os.path.join(tmp.name, "out")
    span = ["--start", (times[1] - timedelta(seconds=1)).isoformat(),
            "--end", (times[1] + timedelta(seconds=1)).isoformat()]
    log = io.StringIO()
    for k in all_kernels:
        k.launches = 0
    with contextlib.redirect_stdout(log):
        rc = convert.main([th_dir, "--grid", "geo", "--platform", "cuda",
                           "--altitude", "100", "--out", out + "_th", *span])
    th_files = sorted(os.listdir(out + "_th"))
    if rc != 0 or len(th_files) != N_STATIONS:
        raise AssertionError(f"convert THEMIS: rc {rc}, {len(th_files)} files")
    first = coll.mappings[0]
    r0 = resample(first, arcsec_per_px=100, device=dev)
    img0 = cdflib.CDFReader(os.path.join(out + "_th",
                                         f"{first.identifier}.cdf"))["img"]
    in_file = int((np.asarray(img0[0]) != img0.attrs["FILLVAL"]).sum())
    if in_file != int((~r0.center_mask).sum()) or in_file == 0:
        raise AssertionError(f"convert THEMIS: {in_file} cells in the file")

    mi_dir = os.path.join(tmp.name, "miracle")
    os.makedirs(mi_dir)
    with open(os.path.join(RES, "cal.txt")) as f_in, \
            open(os.path.join(mi_dir, "cal.txt"), "w") as f_out:
        f_out.write(f_in.read())
    rng = np.random.default_rng(SEED + 1)
    for name in ("SOD120304_171900_557_1000.jpg",
                 "SOD120304_172000_557_1000.jpg"):
        with open(os.path.join(mi_dir, name), "wb") as f:
            np.save(f, rng.integers(0, 256, (512, 512, 3), dtype=np.uint8))
    real_load = miracle.load_image
    miracle.load_image = np.load  # no JPEG decoder here: seeded arrays
    try:
        with contextlib.redirect_stdout(log):
            rc = convert.main([mi_dir, "--grid", "geo", "--platform", "cuda",
                               "--out", out + "_mi"])
    finally:
        miracle.load_image = real_load
    mi_files = sorted(os.listdir(out + "_mi"))
    red = cdflib.CDFReader(os.path.join(out + "_mi", mi_files[0]))["img_red"]
    in_file_mi = int((np.asarray(red[0]) != red.attrs["FILLVAL"]).sum())
    if rc != 0 or len(mi_files) != 2 or in_file_mi == 0 or k1.launches < 2:
        raise AssertionError(f"convert MIRACLE: rc {rc}, files {mi_files}, "
                             f"{in_file_mi} cells, {k1.launches} K1 launches")
    print(f"[18] convert --grid geo --platform cuda: THEMIS folder ({N_STATIONS} "
          f"stations, one tick) -> {len(th_files)} CDFs, {th_files[0]} holds "
          f"{in_file} cells == resample on the card; MIRACLE folder (2 seeded "
          f"512x512 frames) -> {len(mi_files)} CDFs ({in_file_mi} cells in "
          f"{mi_files[0]}), {k1.launches} K1 launches", flush=True)
    tmp.cleanup()
    return kernel_row("georegrid_bin (K1) on the ASI path, MIRACLE "
                      "resample('mean')",
                      "auromat_tpu_torch/ops/csrc/georegrid_bin.cu",
                      "auromat_tpu/ops/georegrid.py:65", k1_launches, k1_err,
                      k_ms, p_ms, k1_bytes, lib_ms)


class recorded:
    """Within the block, ``module.name`` also appends each call's positional
    arguments to ``self.calls[name]``; the functions are put back after."""

    def __init__(self, *targets):
        self.targets, self.calls, self.real = targets, {}, {}

    def __enter__(self):
        for module, name in self.targets:
            real = self.real[name] = getattr(module, name)
            calls = self.calls[name] = []
            setattr(module, name, lambda *a, _r=real, _c=calls, **k: (
                _c.append(a), _r(*a, **k))[1])
        return self

    def __exit__(self, *exc):
        for module, name in self.targets:
            setattr(module, name, self.real[name])


def gate_card_vs_cpu(np, name, r, cpu):
    """A resampled mapping from the card against the same call on the CPU:
    grids within 1e-9 deg, masks equal, uint8 image equal."""
    gerr = 0.0
    for key in ("lats", "lons", "latsCenter", "lonsCenter"):
        a, b = getattr(r, key).data, getattr(cpu, key).data
        if a.shape != b.shape:
            raise AssertionError(f"{name}: {key} {a.shape} != {b.shape}")
        d = np.abs(a - b)
        if key.startswith("lons"):
            d = np.minimum(d, 360.0 - d)
        gerr = max(gerr, float(np.nanmax(d)))
    step, _ = gate_routes(np, name, r, cpu)
    if not (gerr < 1e-9 and step == 0 and
            np.array_equal(r.corner_mask, cpu.corner_mask)):
        raise AssertionError(f"{name}: grids {gerr} deg, uint8 step {step}")
    return gerr


def kernels_on_recorded(torch, rec, card, tag, label):
    """K1 and K2 on the arguments a resample recorded (``rec.calls``), each
    against its plain version (bit-equal) and timed in turns with it and
    with one int64 ``index_add_``; {kernel: (err, ms, plain_ms, bytes,
    library_ms, valid samples, shape)}."""
    from auromat_tpu_torch.ops import regrid_pallas as rp
    from auromat_tpu_torch.ops.georegrid import bin_rgbelev_plain

    res = {}
    for name, key in (("K1", "bin_rgbelev_from_indices"),
                      ("K2", "bin_partial_pallas_cw")):
        if not rec.calls.get(key):
            continue
        args = rec.calls[key][0]
        if name == "K1":
            grid, iy, ix, img_chw, elev = args
            kernel = lambda: rec.real[key](grid, iy, ix, img_chw, elev)
            plain = lambda: bin_rgbelev_plain(grid, iy, ix, img_chw, elev)
            terms = fixed_terms(torch, list(img_chw), elev)
            in_ch = 4
        else:
            grid, (iy, ix), data, n_ch, mode = args
            data = data.to(torch.float32).contiguous()
            kernel = lambda: rec.real[key](grid, (iy, ix), data, n_ch, mode)
            plain = lambda: rp.bin_partial_cw_plain(grid, iy, ix, data, mode)
            terms = fixed_terms(torch, [data[..., c] for c in range(n_ch - 1)],
                                data[..., n_ch - 1])
            in_ch = n_ch
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = check_equal(torch, f"{name} on {label}", got, want)
        n_valid = int((iy >= 0).sum().item())
        if int(got[0].double().sum().item()) != n_valid or n_valid == 0:
            raise AssertionError(f"{name} on {label}: count total != "
                                 f"{n_valid} valid samples")
        k_ms, p_ms, _, _ = in_turns(torch, kernel, plain)
        _, lib_ms, _, _ = in_turns(torch, kernel,
                                   library_call(torch, grid, iy, ix, terms))
        n_cells = grid.n_lat * grid.n_lon
        n_bytes = bin_bytes(4, iy.numel(), n_valid, in_ch, n_cells, in_ch + 1)
        filled = int((got[0] > 0).sum().item())
        print(f"{tag} {name} on {label} ({n_valid} valid samples of "
              f"{iy.shape[0]}x{iy.shape[1]}, {in_ch} channels -> {filled} of "
              f"{grid.n_lat}x{grid.n_lon} cells): == plain (torch.equal); {k_ms:.3f} ms vs "
              f"plain {p_ms:.3f} ms, one int64 index_add_ {lib_ms:.3f} ms, "
              f"bound {bound_ms(n_bytes):.4f} ms; on {card}", flush=True)
        res[name] = (err, k_ms, p_ms, n_bytes, lib_ms)
    return res


def magnetic_generic_phases(torch, np, card):
    """Phases 19-21: the magnetic (MLat/MLT) grid, georeferencing through
    the generic FITS projections, and the full-precision point functions,
    at the 4256x2832 frame; returns the kernels-line rows of K1 and K2 on
    the magnetic path."""
    from auromat_tpu_torch.coordinates.transform import sm_to_latlon
    from auromat_tpu_torch.coordinates.wcs import TanWcs, make_wcs
    from auromat_tpu_torch.io import fits
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from auromat_tpu_torch.mapping.mapping import (check_guarantees,
                                                   convert_mapping_to_sm)
    from auromat_tpu_torch.ops import _kernels, georegrid
    from auromat_tpu_torch.ops import georef as gr
    from auromat_tpu_torch.ops import regrid_pallas as rp
    from auromat_tpu_torch.resample import resample, resample_mlat_mlt

    dev = torch.device("cuda")
    k1, k2 = _kernels.GEOREGRID_BIN, _kernels.REGRID_BIN
    all_kernels = (k1, _kernels.GEOREGRID_BIN_I8, k2, _kernels.REGRID_BIN_V1)
    taps = ((georegrid, "bin_rgbelev_from_indices"),
            (georegrid, "bin_mean_rgbelev"),
            (rp, "bin_partial_pallas_cw"), (rp, "bin_mean_pallas_taint"))

    # -- 19. the magnetic grid on the card -------------------------------------
    golden = np.load(GOLDEN_MLATMLT)
    header = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    pos = np.array(fits.get_shifted_spacecraft_position(header)[:3])
    photo_time = fits.get_shifted_photo_time(header)
    h, w = header["IMAGEH"], header["IMAGEW"]
    frame = np.random.default_rng(SEED).integers(0, 256, (h, w, 3),
                                                 dtype=np.uint8)
    altitude, ppd = float(golden["altitude"]), float(golden["px_per_deg"])
    m = create_mapping(header, frame, pos, photo_time, altitude=altitude,
                       fast_center=False, identifier="ISS030-E-102170_dc",
                       device=dev)
    mag = lambda route, device: resample_mlat_mlt(
        m, px_per_deg=ppd, contains_pole=False, bin_method=route,
        device=device)
    routes, launches = {}, {}
    with recorded(*taps) as rec:
        for route, kernel in (("auto", k1), ("pallas_taint", k2)):
            for k in all_kernels:
                k.launches = 0
            routes[route] = mag(route, dev)
            torch.cuda.synchronize()
            launches[route] = kernel.launches
            if kernel.launches < 1:
                raise AssertionError(f"resample_mlat_mlt bin_method={route!r} "
                                     f"never launched {kernel.source}")
    for route, r in routes.items():
        check_guarantees(r)
        lons, elev = r.lons.filled(np.nan), r.elevation.filled(np.nan)
        if lons.shape != golden["lons"].shape:
            raise AssertionError(f"magnetic grid {lons.shape} != golden "
                                 f"{golden['lons'].shape}")
        both = ~np.isnan(lons) & ~np.isnan(golden["lons"])
        lerr = float(np.abs(lons[both] - golden["lons"][both]).max())
        both = ~np.isnan(elev) & ~np.isnan(golden["elevation"])
        eerr = float(np.abs(elev[both] - golden["elevation"][both]).max())
        mdiff = int((np.ma.getmaskarray(r.img) != golden["img_mask"])
                    .any(axis=-1).sum())
        if not (lerr < 1e-9 and eerr < 1e-4 and mdiff == 0):
            raise AssertionError(f"magnetic grid {route!r} vs golden: lons "
                                 f"{lerr}, elevation {eerr}, {mdiff} mask cells")
        print(f"[19] resample_mlat_mlt {route!r} on the card -> "
              f"{r.img.shape[0]}x{r.img.shape[1]}: {launches[route]} launch(es) "
              f"of {'K1' if route == 'auto' else 'K2'}; vs golden: lons "
              f"{lerr:.3g} deg, elevation {eerr:.3g}, {mdiff} mask cells",
              flush=True)
    cpu = mag("auto", "cpu")
    gerr = gate_card_vs_cpu(np, "magnetic grid, card vs CPU", routes["auto"],
                            cpu)
    step, off1 = gate_routes(np, "magnetic grid, auto vs pallas_taint",
                             routes["auto"], routes["pallas_taint"])
    n_cells = int((~routes["auto"].center_mask).sum())
    print(f"[19] 'auto' == resample_mlat_mlt on the CPU ('sorted', float64): "
          f"grids {gerr:.3g} deg, masks equal, uint8 max step 0, {n_cells} "
          f"cells; 'pallas_taint' agrees (masks equal, uint8 max step {step}, "
          f"{off1:.2e} off by one)", flush=True)
    on_sm = kernels_on_recorded(torch, rec, card, "[19]", "the SM mapping")

    # wall time of the path, and its device part: the binning and the two
    # SM -> geodetic conversions of the regular grid
    bin_args = rec.calls["bin_mean_rgbelev"][0]
    bin_ms = cuda_ms(torch, lambda: rec.real["bin_mean_rgbelev"](*bin_args), 5)
    sm_r = resample(convert_mapping_to_sm(m), px_per_deg=ppd,
                    contains_pole=False, device=dev)
    fm = sm_r.frame_matrices
    grids = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
             (sm_r.lats.data, sm_r.lons.data, sm_r.latsCenter.data,
              sm_r.lonsCenter.data)]

    def back():
        sm_to_latlon(grids[0], grids[1], fm.sm_to_geo, altitude=altitude)
        sm_to_latlon(grids[2], grids[3], fm.sm_to_geo, altitude=altitude)

    back()
    back_ms = cuda_ms(torch, back, 5)
    t0 = time.perf_counter()
    convert_mapping_to_sm(m)
    to_sm_ms = (time.perf_counter() - t0) * 1e3
    mag_wall = wall_ms(torch, lambda: mag("auto", dev), N_WALL)
    alone = (f"binning {bin_ms:.2f} ms and the grid's SM -> geodetic "
             f"conversion {back_ms:.2f} ms when each is run again alone")
    busy = device_busy_ms(torch, lambda: mag("auto", dev))
    on_device = ("not measured (the profiler recorded no device event)"
                 if busy is None else
                 f"{busy[0]:.2f} ms in {busy[2]} kernels + {busy[1]:.2f} ms in "
                 f"copies = {(busy[0] + busy[1]) / mag_wall:.4f} of the wall")
    print(f"[19] resample_mlat_mlt 'auto' (4256x2832 -> {sm_r.img.shape[0]}x"
          f"{sm_r.img.shape[1]}): {mag_wall:.1f} ms wall (of which "
          f"convert_mapping_to_sm {to_sm_ms:.1f} ms on the host); on the "
          f"device, by the profiler's trace of one call: {on_device}; {alone}; "
          f"on {card}", flush=True)
    del rec, bin_args, grids, routes

    # -- 20. generic WCS on the card -------------------------------------------
    def swapped(code):
        h2 = {k: v for k, v in dict(header).items()
              if k.upper() not in ("LONPOLE", "LATPOLE")}
        h2["CTYPE1"], h2["CTYPE2"] = f"RA---{code}", f"DEC--{code}"
        return h2

    wcs = {c: make_wcs(swapped(c)) for c in ("ZEA", "HPX", "QSC", "PCO")}
    par = {c: gr.GeorefParams.from_wcs(v, pos, photo_time, altitude)
           for c, v in wcs.items()}
    generic = lambda: gr.georeference_generic(wcs["ZEA"], par["ZEA"], True,
                                              True, torch.float32, dev)
    out = generic()
    nan_frac = float(torch.isnan(out["lats"]).float().mean().item())
    if out["lats"].shape != (h + 1, w + 1) or out["mlt_center"].shape != (h, w) \
            or out["lats"].dtype != torch.float32 or not 0.2 < nan_frac < 0.8:
        raise AssertionError(f"georeference_generic ZEA: shape "
                             f"{tuple(out['lats'].shape)}, NaN {nan_frac}")
    del out
    generic_ms = cuda_ms(torch, generic, 5)
    print(f"[20] generic_ms: georeference_generic (ZEA, 4256x2832, fast "
          f"centres, MLat/MLT, float32, eager): {generic_ms:.2f} ms; on {card}",
          flush=True)

    pxg, pyg = np.meshgrid(np.arange(0, w, 8, dtype=np.float64),
                           np.arange(0, h, 8, dtype=np.float64))
    points = lambda c, dtype, device: [
        a.double().cpu().numpy() for a in gr.georeference_points_generic(
            wcs[c], par[c], pxg, pyg, dtype, True, device=device)]

    def worst_deg(a, b, min_elevation=None):
        """(largest |d lat| or |d lon|, its flat index, points compared)
        where both are defined (and b's ray meets the shell at
        ``min_elevation`` degrees or more)."""
        both = ~np.isnan(a[0]) & ~np.isnan(b[0])
        if min_elevation is not None:
            both &= b[2] >= min_elevation
        dlo = np.abs(a[1] - b[1])
        d = np.where(both, np.maximum(np.abs(a[0] - b[0]),
                                      np.minimum(dlo, 360.0 - dlo)), -1.0)
        at = int(d.argmax())
        return float(d.flat[at]), at, int(both.sum())

    # float32 against float64 is gated over the rays that meet the shell at
    # MIN_CLEAR degrees of elevation or more, at the tests' limit of 1e-2
    # deg: a ray grazing the shell is ill-conditioned in float32 (the error
    # grows as 1 / elevation); the worst point below that is printed, not
    # gated. The CPU's float32 chain is read on the same points.
    MIN_CLEAR = 0.25
    generic_parity_deg, holes = 0.0, {}
    for c in wcs:
        g64 = points(c, torch.float64, dev)
        c64 = points(c, torch.float64, "cpu")
        if not np.array_equal(np.isnan(g64[0]), np.isnan(c64[0])):
            raise AssertionError(f"generic {c}: float64 masks card != CPU")
        derr = worst_deg(g64, c64)[0]
        if not derr < 1e-9:
            raise AssertionError(f"generic {c}: float64 card vs CPU {derr} deg")
        holes[c] = float(np.isnan(g64[0]).mean())
        print(f"[20] {c} at every 8th pixel ({pxg.size} points, "
              f"{holes[c]:.3f} off the map or the Earth): float64 card vs "
              f"CPU {derr:.3g} deg, masks equal", flush=True)
        if c == "PCO":
            continue
        for where, device in (("card", dev), ("CPU", "cpu")):
            f32 = points(c, torch.float32, device)
            whole, at, n_all = worst_deg(f32, g64)
            clear, _, n_clear = worst_deg(f32, g64, MIN_CLEAR)
            half = worst_deg(f32, g64, 0.5)[0]
            mism = float((np.isnan(f32[0]) != np.isnan(g64[0])).mean())
            if not (clear < 1e-2 and mism <= 5e-4):
                raise AssertionError(
                    f"generic {c}: float32 on the {where} vs float64 on the "
                    f"card {clear} deg at >= {MIN_CLEAR} deg elevation, mask "
                    f"mismatch {mism}")
            if where == "card":
                generic_parity_deg = max(generic_parity_deg, clear)
            print(f"[20] {c} float32 on the {where} vs float64 on the card: "
                  f"{clear:.3e} deg over the {n_clear} rays at >= {MIN_CLEAR} "
                  f"deg elevation (limit 1e-2; {n_all - n_clear} grazing rays "
                  f"left out), {half:.3e} at >= 0.5 deg; mask mismatch "
                  f"{mism:.2e}; worst of all {n_all} rays {whole:.3e} deg at "
                  f"pixel ({int(pxg.flat[at])}, {int(pyg.flat[at])}), "
                  f"elevation {g64[2].flat[at]:.3f} deg (printed, not gated)",
                  flush=True)
    print(f"[20] generic_parity_deg: {generic_parity_deg:.3e} (float32 vs "
          f"float64 on the card, worst of ZEA, HPX, QSC over the rays at >= "
          f"{MIN_CLEAR} deg elevation; limit 1e-2); on {card}", flush=True)

    # PCO's inverse (45 bisection rounds + 2 Newton steps) on the full frame
    fx, fy = torch.meshgrid(torch.arange(w, dtype=torch.float64, device=dev),
                            torch.arange(h, dtype=torch.float64, device=dev),
                            indexing="xy")
    pco = lambda: gr.georeference_points_generic(wcs["PCO"], par["PCO"], fx, fy,
                                                 torch.float64, device=dev)
    la, lo = pco()
    sub = [a[::8, ::8].cpu().numpy() for a in (la, lo)]
    c64 = points("PCO", torch.float64, "cpu")[:2]
    if not np.array_equal(np.isnan(sub[0]), np.isnan(c64[0])) or \
            not worst_deg(sub, c64)[0] < 1e-9:
        raise AssertionError("generic PCO: the full frame on the card != CPU")
    del la, lo
    pco_ms = cuda_ms(torch, pco, 3)
    print(f"[20] pco_full_frame_ms: georeference_points_generic (PCO, "
          f"4256x2832 points, float64, eager bisection): {pco_ms:.1f} ms, its "
          f"every 8th pixel == the CPU within 1e-9 deg; on {card}", flush=True)
    del fx, fy

    # create_mapping on the ZEA header -> resample('mean')
    zea = lambda device: create_mapping(
        swapped("ZEA"), frame, pos, photo_time, altitude=altitude,
        identifier="zea", device=device)
    mz = zea(dev)
    check_guarantees(mz)
    with recorded(*taps) as rec:
        for k in all_kernels:
            k.launches = 0
        rz = resample(mz, px_per_deg=ppd, device=dev)
        torch.cuda.synchronize()
        zea_launches = k1.launches
    if zea_launches < 1:
        raise AssertionError("resample of the ZEA mapping never launched K1")
    check_guarantees(rz)
    step, off1 = gate_routes(np, "ZEA, K1 vs plain binning", rz,
                             resample(mz, px_per_deg=ppd, bin_method="sorted",
                                      device=dev))
    mz_cpu = zea("cpu")
    merr = float(np.nanmax(np.abs(mz.lats.filled(np.nan)
                                  - mz_cpu.lats.filled(np.nan))))
    if not (np.array_equal(mz.center_mask, mz_cpu.center_mask) and merr < 1e-9):
        raise AssertionError(f"ZEA mapping card vs CPU: {merr} deg")
    gerr = gate_card_vs_cpu(np, "ZEA resample, card vs CPU", rz,
                            resample(mz_cpu, px_per_deg=ppd, device="cpu"))
    print(f"[20] create_mapping (RA---ZEA, float64) -> resample('mean', "
          f"{ppd:g} px/deg) -> {rz.img.shape[0]}x{rz.img.shape[1]}: "
          f"{zea_launches} launch(es) of K1, {int((~rz.center_mask).sum())} "
          f"cells; mapping card vs CPU {merr:.3g} deg, masks equal; == plain "
          f"binning on the card (uint8 max step {step}, {off1:.2e} off by one) "
          f"and == the CPU (grids {gerr:.3g} deg, masks equal, uint8 max step "
          f"0)", flush=True)
    kernels_on_recorded(torch, rec, card, "[20]", "the ZEA mapping")
    del rec, mz, mz_cpu, rz

    # -- 21. full-precision points (native float64) ----------------------------
    g = np.load(GOLDEN)
    p64 = gr.GeorefParams.from_wcs(
        TanWcs(header), fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_photo_time(header), altitude=float(g["altitude"]))
    gx, gy = np.meshgrid(g["xs"] - 0.5, g["ys"] - 0.5)
    lat, lon = gr.georeference_points_df64(p64, gx, gy, device=dev)
    full = gr.georeference_points_df64_full(p64, gx, gy, device=dev)
    ok = ~np.isnan(g["lat"])
    derr = 0.0
    for name, got in (("lat", lat), ("lon", lon), ("lat", full["lat"]),
                      ("lon", full["lon"]), ("mlat", full["mlat"]),
                      ("mlt", full["mlt"])):
        if got.dtype != np.float64 or \
                not np.array_equal(np.isnan(got), ~ok):
            raise AssertionError(f"df64 {name}: NaN mask != golden")
        d = np.abs(got[ok] - g[name][ok])
        if name == "mlt":
            d = np.minimum(d, 24.0 - d)
        derr = max(derr, float(d.max()))
    if not derr < 1e-6 or not np.array_equal(np.isnan(full["elevation"]), ~ok):
        raise AssertionError(f"df64 points on the card: {derr} from golden")
    px, py = torch.meshgrid(torch.arange(w, dtype=torch.float64, device=dev),
                            torch.arange(h, dtype=torch.float64, device=dev),
                            indexing="xy")
    calls = {
        "df64_georef_ms": lambda: gr.georeference_points_df64(
            p64, px, py, device=dev),
        "df64_full_ms": lambda: gr.georeference_points_df64_full(
            p64, px, py, device=dev),
        "df64_zen_full_ms": lambda: gr.georeference_points_df64_full(
            p64, px, py, projection="ZEA", device=dev)}
    print(f"[21] georeference_points_df64 and _df64_full on the card vs "
          f"{os.path.basename(GOLDEN)}: max {derr:.3g} (lat, lon, MLat deg; "
          f"MLT h), masks equal", flush=True)
    for key, call in calls.items():
        call()
        ms = cuda_ms(torch, call, 5)
        busy = device_busy_ms(torch, call)
        on_device = ("device time not measured (the profiler recorded no "
                     "device event)" if busy is None else
                     f"{busy[0]:.2f} ms in {busy[2]} kernels + {busy[1]:.2f} "
                     f"ms in copies on the device, by the profiler's trace of "
                     f"one call")
        print(f"[21] {key}: {ms:.2f} (the public function at 4256x2832 "
              f"points, native float64, its host arrays included; CUDA "
              f"events, median of 5); {on_device}; on {card}", flush=True)

    k1_src = "auromat_tpu_torch/ops/csrc/georegrid_bin.cu"
    k2_src = "auromat_tpu_torch/ops/csrc/regrid_bin.cu"
    return [
        kernel_row("georegrid_bin (K1) on the magnetic path, "
                   "resample_mlat_mlt 'auto'", k1_src,
                   "auromat_tpu/ops/georegrid.py:65", launches["auto"],
                   *on_sm["K1"]),
        kernel_row("regrid_bin (K2) on the magnetic path, resample_mlat_mlt "
                   "'pallas_taint'", k2_src,
                   "auromat_tpu/ops/regrid_pallas.py:292",
                   launches["pallas_taint"], *on_sm["K2"]),
    ]


LENS_MODELS = (("ptlens", (0.01, -0.02, 0.005)), ("poly3", (-0.019,)),
               ("poly5", (0.1, 0.01)))
ISS_KEY = "ISS030-E-102170"
ISS_DATE = "2012-01-25T09:27:08.060000"  # DATE-OBS of the frame's header
# tests/test_ephem.py::iss_tle_from_header: a TLE fitted to the header's
# two camera positions
ISS_TLE = ("1 25544U 98067A   12025.39384329  .00000000  00000-0  00000-0 0    04\n"
           "2 25544  51.6283 123.3888 0093999 252.4012 171.2148 15.81821010    06\n")


def lens_phase(torch, np, card):
    """Phase 22: the lens distortion correction of the full frame on the
    card against the same torch code on the CPU, and its times."""
    from auromat_tpu_torch.util.lensdistortion import correct_lens_distortion

    dev = torch.device("cuda")
    h, w = 2832, 4256
    frame = np.random.default_rng(SEED).integers(0, 256, (h, w, 3),
                                                 dtype=np.uint8)
    on_card = torch.from_numpy(frame).to(dev)
    n_bytes = 2 * frame.nbytes  # the frame read once, the result written once
    for model, params in LENS_MODELS:
        got = correct_lens_distortion(frame, model, params, device=dev)
        want = correct_lens_distortion(frame, model, params, device="cpu")
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        step, n_diff = int(d.max()), int((d > 0).sum())
        if got.dtype != np.uint8 or got.shape != frame.shape or step > 1:
            raise AssertionError(f"lens correction {model}: card vs CPU max "
                                 f"step {step} ({n_diff} values differ)")
        call = lambda: correct_lens_distortion(on_card, model, params,
                                               device=dev)
        call()
        dev_ms = cuda_ms(torch, call, N_TIMED)
        host_ms = wall_ms(torch, lambda: correct_lens_distortion(
            frame, model, params, device=dev), N_WALL)
        print(f"[22] correct_lens_distortion {model} {params} on the card "
              f"({w}x{h}x3 uint8, {frame.nbytes / 1e6:.1f} MB; float32 working "
              f"copy {4 * frame.nbytes / 1e6:.1f} MB) vs the same code on the "
              f"CPU: max step {step}, {n_diff} of {frame.size} values differ; "
              f"device {dev_ms:.3f} ms (CUDA events, median of {N_TIMED}), "
              f"wall with the host copies {host_ms:.1f} ms (median of "
              f"{N_WALL}); {n_bytes} bytes in and out, bound "
              f"{bound_ms(n_bytes):.4f} ms at 3.35 TB/s; on {card}",
              flush=True)
    del on_card


class StubRaw:
    """What ``rawpy.imread`` returns here: the card's machine has no RAW
    decoder, so the 'RAW' file holds a seeded frame saved with numpy and
    ``postprocess`` loads it. Only the decoder is replaced; the provider's
    code around it (white balance, flip, distortion, crop, georeference)
    runs as it is."""

    color_desc, num_colors = b"RGBG", 3

    def __init__(self, path):
        self.path = path

    def postprocess(self, **kw):
        import numpy as np

        return np.load(self.path)


def stub_rawpy():
    """A ``rawpy`` module with :class:`StubRaw` as its decoder."""
    import importlib.machinery
    import types

    mod = types.ModuleType("rawpy")
    mod.__spec__ = importlib.machinery.ModuleSpec("rawpy", None)
    mod.imread = StubRaw
    mod.enhance = types.ModuleType("rawpy.enhance")
    mod.enhance.repair_bad_pixels = lambda raw, bad: None
    return mod


def iss_cache(np, folder):
    """An offline ESA ISS archive cache: the real .wcs, api.json with the
    archive's poly3 (-0.019) model and the 180-degree flip, metadata.json,
    and the seeded frame under the RAW name; returns the frame."""
    import shutil

    os.makedirs(folder, exist_ok=True)
    shutil.copy(os.path.join(RES, "ISS030-E-102170_dc.wcs"),
                os.path.join(folder, f"{ISS_KEY}.wcs"))
    api = {"id": 77, "date_start": ISS_DATE, "date_end": ISS_DATE,
           "image_extension": ".jpg", "raw_extension": ".NEF",
           "raw_white_balance": [2.0, 1.0, 1.5, 1.0],
           "raw_bad_pixels_uri": "unused", "metadata_uri": "unused",
           "raw_is_upside_down": True,
           "distortion_correction": {"model": "poly3", "params": [-0.019]},
           "images": {ISS_KEY: {"date": ISS_DATE, "raw_uri": "unused",
                                "image_uri": "unused", "wcs_uri": "unused"}}}
    with open(os.path.join(folder, "api.json"), "w") as f:
        json.dump(api, f)
    with open(os.path.join(folder, "metadata.json"), "w") as f:
        json.dump({"sequence_metadata": {"Project": "THOR"},
                   "image_metadata": {ISS_KEY: {"exposure": 1.0}}}, f)
    frame = np.random.default_rng(SEED + 7).integers(0, 256, (2832, 4256, 3),
                                                     dtype=np.uint8)
    with open(os.path.join(folder, f"{ISS_KEY}.NEF"), "wb") as f:
        np.save(f, frame)
    return frame


def iss_phases(torch, np, card, k1_ms_main):
    """Phases 22-25: the lens correction, the ISS archive path (provider ->
    correction on the card -> create_mapping -> resample on K1 -> CDF and
    netCDF -> read back -> resample), TLE camera positions and
    ``profiling.benchmark``; returns the kernels-line row of K1 on the ISS
    path."""
    import importlib.util
    import tempfile

    from auromat_tpu_torch.entry import frame_setup
    from auromat_tpu_torch.export import cdf as export_cdf
    from auromat_tpu_torch.export import netcdf as export_nc
    from auromat_tpu_torch.io import fits
    from auromat_tpu_torch.mapping import iss
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from auromat_tpu_torch.mapping.cdf import CDFMappingProvider
    from auromat_tpu_torch.mapping.mapping import check_guarantees
    from auromat_tpu_torch.mapping.netcdf import NetCDFMappingProvider
    from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position
    from auromat_tpu_torch.ops import _kernels, georegrid
    from auromat_tpu_torch.ops.georegrid import (bin_rgbelev_from_indices,
                                                 georegrid_inputs)
    from auromat_tpu_torch.profiling import benchmark
    from auromat_tpu_torch.resample import resample

    dev = torch.device("cuda")
    k1 = _kernels.GEOREGRID_BIN
    lens_phase(torch, np, card)

    # -- 23. the ISS archive path on the card ------------------------------
    tmp = tempfile.TemporaryDirectory()
    folder = os.path.join(tmp.name, "iss")
    frame = iss_cache(np, folder)
    real = {k: sys.modules.get(k) for k in ("rawpy", "rawpy.enhance")}
    sys.modules["rawpy"] = mod = stub_rawpy()
    sys.modules["rawpy.enhance"] = mod.enhance
    try:
        date = datetime.datetime.strptime(ISS_DATE, iss.ISO_DATE_FORMAT)
        provider = lambda device: iss.ISSMappingProvider(
            folder, offline=True, raw_bps=8, device=device)
        prov = provider(dev)
        if not prov.useRaw:
            raise AssertionError("the ISS provider did not take the RAW route")
        m = prov.get(date)
        check_guarantees(m)
        with recorded((georegrid, "bin_rgbelev_from_indices")) as rec:
            k1.launches = 0
            r = resample(m, px_per_deg=25, device=dev)
            torch.cuda.synchronize()
            launches = k1.launches
        if launches < 1:
            raise AssertionError("resample of the ISS mapping never launched K1")
        check_guarantees(r)
        on_iss = kernels_on_recorded(torch, rec, card, "[23]",
                                     "the ISS mapping")
        m_cpu = provider("cpu").get(date)
        merr = max(float(np.nanmax(np.abs(getattr(m, k).filled(np.nan)
                                          - getattr(m_cpu, k).filled(np.nan))))
                   for k in ("lats", "lons", "latsCenter", "lonsCenter"))
        img_step = int(np.abs(m.img.data.astype(np.int16)
                              - m_cpu.img.data.astype(np.int16)).max())
        if not (merr < 1e-9 and img_step <= 1 and
                np.array_equal(m.center_mask, m_cpu.center_mask)):
            raise AssertionError(f"ISS mapping card vs CPU: grids {merr} deg, "
                                 f"corrected image step {img_step}")
        r_cpu = resample(m_cpu, px_per_deg=25, device="cpu")
        gerr = gate_card_vs_cpu(np, "ISS resample, card vs CPU", r, r_cpu)
        n_cells = int((~r.center_mask).sum())
        print(f"[23] ISSMappingProvider(offline, RAW route; the decoder "
              f"replaced by a seeded 4256x2832 frame: no rawpy or PIL on this "
              f"machine).get -> flip, poly3 (-0.019) on the card, crop, "
              f"create_mapping (float64) -> resample(px_per_deg=25) -> "
              f"{r.img.shape[0]}x{r.img.shape[1]}: {launches} launch(es) of "
              f"K1, {n_cells} cells; mapping card vs CPU {merr:.3g} deg "
              f"(corrected image max step {img_step}), composite card vs CPU "
              f"grids {gerr:.3g} deg, masks equal, uint8 max step 0",
              flush=True)

        # export, read back through the providers, resample on the card;
        # the files hold the unresampled frame (0.5-1.1 GB each), so each
        # is written and read once, uncompressed, without MLat/MLT
        writers = [("cdf", ".cdf", CDFMappingProvider,
                    lambda p: export_cdf.write(p, m, compress=False,
                                               includeMagCoords=False)),
                   ("NETCDF3", ".nc", NetCDFMappingProvider,
                    lambda p: export_nc.write(p, m, format="NETCDF3",
                                              includeMagCoords=False))]
        has_h5py = importlib.util.find_spec("h5py") is not None
        if has_h5py:
            writers.append(("NETCDF4", ".nc", NetCDFMappingProvider,
                            lambda p: export_nc.write(
                                p, m, format="NETCDF4", compress=False,
                                includeMagCoords=False)))
        io_ms = {}
        for fmt, ext, provider_cls, write in writers:
            out_dir = os.path.join(tmp.name, fmt)
            os.makedirs(out_dir)
            path = os.path.join(out_dir, ISS_KEY + ext)
            t0 = time.perf_counter()
            write(path)
            t1 = time.perf_counter()
            back = provider_cls(out_dir).get(m.photoTime)
            t2 = time.perf_counter()
            size = os.path.getsize(path)
            os.remove(path)
            k1.launches = 0
            rb = resample(back, px_per_deg=25, device=dev)
            torch.cuda.synchronize()
            same = (np.array_equal(rb.img.filled(0), r.img.filled(0))
                    and np.array_equal(rb.center_mask, r.center_mask)
                    and all(np.array_equal(getattr(rb, k).data,
                                           getattr(r, k).data, equal_nan=True)
                            for k in ("lats", "lons")))
            if not same or k1.launches < 1 or back.identifier != ISS_KEY:
                raise AssertionError(f"{fmt} read-back composite differs from "
                                     f"the first ({k1.launches} K1 launches)")
            io_ms[fmt] = ((t1 - t0) * 1e3, (t2 - t1) * 1e3, size)
        print(f"[23] export -> {', '.join(io_ms)} (h5py "
              f"{'present' if has_h5py else 'absent: no NETCDF4'}), read back "
              f"through CDFMappingProvider/NetCDFMappingProvider.get, resample "
              f"on the card: == the first composite (uint8, masks, grids), K1 "
              f"launched each time", flush=True)

        # times of the path's stages
        header = fits.read_header(os.path.join(folder, f"{ISS_KEY}.wcs"))
        pos, photo_time, _ = resolve_camera_position(header)
        corrected = m.img.data
        stages = {
            "provider get": lambda: prov.get(date),
            "correction (_postprocess_common)": lambda: prov._postprocess_common(
                frame),
            "create_mapping": lambda: create_mapping(
                header, corrected, pos, photo_time, fast_center=False,
                device=dev),
            "resample": lambda: resample(m, px_per_deg=25, device=dev),
        }
        times = {k: wall_ms(torch, f, N_WALL) for k, f in stages.items()}
        path_ms = times["provider get"] + times["resample"]
        busy = device_busy_ms(torch, lambda: resample(prov.get(date),
                                                      px_per_deg=25, device=dev))
        on_device = ("not measured (the profiler recorded no device event)"
                     if busy is None else
                     f"{busy[0]:.2f} ms in {busy[2]} kernels + {busy[1]:.2f} ms "
                     f"in copies = {(busy[0] + busy[1]) / path_ms:.4f} of the "
                     f"wall")
        print(f"[23] ISS path wall ms (median of {N_WALL}): "
              + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
              + f"; get + resample {path_ms:.1f}; on the device, by the "
              f"profiler's trace of one get + resample: {on_device}; export / "
              f"read-back ms (one run each): "
              + ", ".join(f"{k} {w_:.1f} / {r_:.1f} ({s / 1e6:.0f} MB)"
                          for k, (w_, r_, s) in io_ms.items())
              + f"; on {card}", flush=True)
    finally:
        for k, v in real.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
        tmp.cleanup()
    del m, m_cpu, r, r_cpu, rec

    # -- 24. TLE camera positions on the card -------------------------------
    with tempfile.TemporaryDirectory() as d:
        tle_path = os.path.join(d, "iss.tle")
        with open(tle_path, "w") as f:
            f.write(ISS_TLE)
        full = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
        header = fits.FitsHeader({k: v for k, v in full.items()
                                  if not k.startswith("POS")})
        pos, t, _ = resolve_camera_position(header, tle_path)
    hpos = np.array(fits.get_spacecraft_position(full))
    dist = float(np.linalg.norm(pos - hpos))
    m_tle = create_mapping(header, frame, pos, t, device=dev)
    m_hdr = create_mapping(header, frame, hpos, t, device=dev)
    both = ~m_tle.center_mask & ~m_hdr.center_mask

    def max_diff(sel):
        dlat = np.abs(m_tle.latsCenter.data - m_hdr.latsCenter.data)[sel]
        dlon = np.abs(m_tle.lonsCenter.data - m_hdr.lonsCenter.data)[sel]
        return float(dlat.max()), float(np.minimum(dlon, 360.0 - dlon).max())

    # grazing rays move far for a few km of camera position: gate the
    # pixels at 10 deg of elevation or more in both mappings
    high = both & (m_tle.elevation.filled(0) >= 10) & \
        (m_hdr.elevation.filled(0) >= 10)
    (dlat, dlon), (alat, alon) = max_diff(high), max_diff(both)
    if not (dist < 15.0 and high.mean() > 0.3 and max(dlat, dlon) < 0.5):
        raise AssertionError(f"TLE mapping: position {dist} km from the "
                             f"header's, lat/lon {dlat}/{dlon} deg")
    print(f"[24] the header without POS* cards + the fitted ISS TLE -> SGP4 "
          f"position {dist:.3f} km from the header's -> create_mapping on the "
          f"card (4256x2832, float64): lat/lon vs the header-position "
          f"mapping max {dlat:.4f} / {dlon:.4f} deg over the {int(high.sum())} "
          f"pixels at >= 10 deg elevation ({alat:.4f} / {alon:.4f} over all "
          f"{int(both.sum())})", flush=True)
    del m_tle, m_hdr

    # -- 25. profiling.benchmark of K1 -----------------------------------------
    grid, dyn, params = frame_setup(dev)
    h, w = params.height, params.width
    iy, ix, out = georegrid_inputs(grid, dyn, h, w)
    img = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (3, h, w), dtype=np.uint8)).to(dev).float()
    args = (grid, iy, ix, img, out["elevation"])
    # in turns with this script's own CUDA-event timer on the same call, so
    # that the card's state at this point of the run is the same for both
    runs = {"benchmark": [], "cuda_ms": []}
    for how in ("benchmark", "cuda_ms", "cuda_ms", "benchmark"):
        runs[how].append(
            benchmark(bin_rgbelev_from_indices, *args, iters=N_TIMED)[0] * 1e3
            if how == "benchmark" else
            cuda_ms(torch, lambda: bin_rgbelev_from_indices(*args), N_TIMED))
    bench_ms, here_ms = (statistics.median(runs[k]) for k in runs)
    if not 0 < bench_ms < 100:
        raise AssertionError(f"profiling.benchmark of K1: {bench_ms} ms")
    print(f"[25] profiling.benchmark(bin_rgbelev_from_indices) at the main "
          f"path's shapes: {bench_ms:.3f} ms (CUDA events, median of "
          f"{N_TIMED}; runs {[round(t, 3) for t in runs['benchmark']]}), "
          f"in turns with cuda_ms of the same call {here_ms:.3f} ms (runs "
          f"{[round(t, 3) for t in runs['cuda_ms']]}); [5]'s K1 wrapper "
          f"{k1_ms_main:.3f} ms; on {card}", flush=True)
    return kernel_row("georegrid_bin (K1) on the ISS path, ISSMappingProvider "
                      "-> resample('mean')",
                      "auromat_tpu_torch/ops/csrc/georegrid_bin.cu",
                      "auromat_tpu/ops/georegrid.py:65", launches,
                      *on_iss["K1"])


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device; this smoke "
                         "run needs an NVIDIA GPU")
    import numpy as np

    from auromat_tpu_torch.entry import entry, frame_setup
    from auromat_tpu_torch.io import fits
    from auromat_tpu_torch.coordinates.wcs import TanWcs
    from auromat_tpu_torch.ops import _kernels
    from auromat_tpu_torch.ops.georef import (DynGeorefParams, GeorefParams,
                                              georef_latlon_dyn)
    from auromat_tpu_torch.ops.georegrid import (bin_rgbelev_from_indices,
                                                 bin_rgbelev_plain,
                                                 georegrid_inputs, launch_k1)
    from auromat_tpu_torch.ops.regrid import finalize_mean

    dev = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build every kernel source at once; wait for K1's ---------------
    builds = start_builds([_kernels.GEOREGRID_BIN, _kernels.REGRID_BIN])
    kernels = {"K1": _kernels.GEOREGRID_BIN}
    for name, k in kernels.items():
        secs = builds[k.source].result()
        print(f"[2] built {name} ({k.source}) in {secs:.2f} s "
              f"-> {os.path.relpath(k.path)}", flush=True)

    # -- 3. K1 vs its plain version at the frame's shapes ------------------
    grid, dyn, params = frame_setup(dev)
    h, w = params.height, params.width
    rng = np.random.default_rng(SEED)
    frames = [torch.from_numpy(rng.integers(0, 256, (3, h, w), dtype=np.uint8))
              .to(dev).float() for _ in range(N_FRAMES)]
    mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
    mask[:, : w // 3] = True
    masks = [None] * (N_FRAMES - 1) + [mask]

    iy, ix, out = georegrid_inputs(grid, dyn, h, w)
    elev = out["elevation"]
    k_args = (grid, iy, ix, frames[0], elev)
    kc, ks = bin_rgbelev_from_indices(*k_args)
    pc, ps = bin_rgbelev_plain(*k_args)
    torch.cuda.synchronize()
    names = ["count", "sum R", "sum G", "sum B", "sum elevation"]
    got = [kc] + [ks[..., i] for i in range(4)]
    want = [pc] + [ps[..., i] for i in range(4)]
    for n, a, b in zip(names, got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"K1 kernel != plain version on {n}: max |d| "
                                 f"{(a - b).abs().max().item()}")
    k1_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    n_valid = int((iy >= 0).sum().item())
    if int(kc.sum().item()) != n_valid:
        raise AssertionError("K1 count total != valid samples")
    print(f"[3] K1 == plain on all 5 outputs (torch.equal) at {h}x{w} -> "
          f"{grid.n_lat}x{grid.n_lon}, {n_valid} valid samples", flush=True)

    # -- 4. the main path, through the entry point -------------------------
    fn, (example,) = entry("cuda")
    if tuple(example.shape) != (3, h, w):
        raise AssertionError(f"entry example shape {tuple(example.shape)}")
    for k in kernels.values():
        k.launches = 0
    results = [fn(img, m) for img, m in zip(frames, masks)]
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"the main path never launched {name}")

    for i, ((count, means), img, m) in enumerate(zip(results, frames, masks)):
        if count.shape != (grid.n_lat, grid.n_lon) or \
                means.shape != (grid.n_lat, grid.n_lon, 4):
            raise AssertionError(f"frame {i}: shapes {count.shape} {means.shape}")
        fiy, fix, fout = georegrid_inputs(grid, dyn, h, w, m)
        valid = int((fiy >= 0).sum().item())
        if int(count.sum().item()) != valid or valid == 0:
            raise AssertionError(f"frame {i}: count {count.sum().item()} != "
                                 f"{valid} valid samples")
        lat = fout["lat"][~torch.isnan(fout["lat"])]
        lo, hi = lat.min().item(), lat.max().item()
        if not (47 < lo < 49 and 60 < hi < 62):
            raise AssertionError(f"frame {i}: latitude range [{lo}, {hi}]")
        filled = count > 0
        if not torch.isfinite(means[filled]).all() or \
                not torch.isnan(means[~filled]).all():
            raise AssertionError(f"frame {i}: means not finite where filled")
        pc, ps = bin_rgbelev_plain(grid, fiy, fix, img, fout["elevation"])
        pm = finalize_mean(pc, ps)
        if not (torch.equal(count, pc) and
                torch.equal(torch.nan_to_num(means, nan=-1.0),
                            torch.nan_to_num(pm, nan=-1.0))):
            raise AssertionError(f"frame {i}: main path != plain binning path")
        print(f"[4] frame {i}{' (masked)' if m is not None else ''}: "
              f"{valid} samples into {int(filled.sum().item())} cells, lat "
              f"[{lo:.3f}, {hi:.3f}], == plain binning path", flush=True)

    golden = np.load(GOLDEN)
    header = fits.read_header(fits_path := os.path.join(
        os.path.dirname(GOLDEN), "ISS030-E-102170_dc.wcs"))
    p64 = GeorefParams.from_wcs(TanWcs(header),
                                fits.get_shifted_spacecraft_position(header)[:3],
                                fits.get_photo_time(header),
                                altitude=float(golden["altitude"]))
    gx, gy = np.meshgrid(golden["xs"] - 0.5, golden["ys"] - 0.5)
    g = georef_latlon_dyn(DynGeorefParams.from_static(p64, dev, torch.float64),
                          torch.from_numpy(gx).to(dev),
                          torch.from_numpy(gy).to(dev), dtype=torch.float64)
    glat, glon = g["lat"].cpu().numpy(), g["lon"].cpu().numpy()
    gm = ~np.isnan(golden["lat"])
    if not np.array_equal(np.isnan(glat), ~gm):
        raise AssertionError("f64 chain on the card: NaN mask != golden")
    gerr = max(np.abs(glat[gm] - golden["lat"][gm]).max(),
               np.abs(glon[gm] - golden["lon"][gm]).max())
    if not gerr < 1e-6:
        raise AssertionError(f"f64 chain on the card: {gerr} deg from golden")
    print(f"[4] f64 chain on the card vs {os.path.basename(GOLDEN)} "
          f"({os.path.basename(fits_path)}): max {gerr:.3g} deg, masks equal",
          flush=True)

    # -- 5. times ----------------------------------------------------------
    for img in frames:  # warm-up
        fn(img)
    path_ms = cuda_ms(torch, lambda: fn(frames[0]), N_TIMED)

    def plain_path():
        piy, pix, pout = georegrid_inputs(grid, dyn, h, w)
        finalize_mean(*bin_rgbelev_plain(grid, piy, pix, frames[0],
                                         pout["elevation"]))

    plain_path()
    plain_path_ms = cuda_ms(torch, plain_path, N_TIMED)
    print(f"[5] main path: {path_ms:.3f} ms/frame median of {N_TIMED} "
          f"(plain binning: {plain_path_ms:.3f}) at {h}x{w} -> "
          f"{grid.n_lat}x{grid.n_lon} on {card}", flush=True)

    k1_ms, plain_ms, k1_runs, plain_runs = in_turns(
        torch, lambda: bin_rgbelev_from_indices(*k_args),
        lambda: bin_rgbelev_plain(*k_args))
    # the kernel and its epilogue alone, without the wrapper's zero-fill
    # and status read
    n_cells = grid.n_lat * grid.n_lon
    acc = torch.zeros(n_cells, 4, dtype=torch.int64, device=dev)
    eacc = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    status = torch.zeros(1, dtype=torch.int64, device=dev)
    outs = (torch.empty(n_cells, device=dev), torch.empty(n_cells, 4, device=dev))
    raw_ms = cuda_ms(torch, lambda: launch_k1(grid, iy, ix, frames[0], elev,
                                              acc, eacc, status, *outs),
                     N_TIMED)
    raw_int_ms = cuda_ms(torch, lambda: launch_k1(grid, iy, ix, frames[0],
                                                  elev, acc, eacc, status),
                         N_TIMED)
    del acc, eacc, status, outs
    _, lib_ms, _, _ = in_turns(
        torch, lambda: bin_rgbelev_from_indices(*k_args),
        library_call(torch, grid, iy, ix, fixed_terms(torch, list(frames[0]),
                                                      elev)))
    k1_bytes = bin_bytes(4, iy.numel(), n_valid, 4, n_cells, 5)
    print(f"[5] K1 wrapper {k1_ms:.3f} ms vs plain {plain_ms:.3f} ms "
          f"(runs {[round(t, 3) for t in k1_runs]} / "
          f"{[round(t, 3) for t in plain_runs]}); K1 kernel + epilogue alone "
          f"{raw_ms:.3f} ms (kernel alone {raw_int_ms:.3f}); one int64 "
          f"index_add_ of the same sums {lib_ms:.3f} ms; bound "
          f"{bound_ms(k1_bytes):.4f} ms ({k1_bytes} bytes at 3.35 TB/s; "
          f"{bound_ms(bin_bytes(4, iy.numel(), iy.numel(), 4, n_cells, 5)):.4f}"
          f" ms counting every sample's data); on {card}", flush=True)

    rows = [kernel_row("georegrid_bin (K1)",
                       "auromat_tpu_torch/ops/csrc/georegrid_bin.cu",
                       "auromat_tpu/ops/georegrid.py:65", launches["K1"],
                       k1_err, k1_ms, plain_ms, k1_bytes, lib_ms)]
    rows += slice_phases(torch, np, builds, grid, iy, ix, out, card)
    del iy, ix, out, elev, k_args
    rows.append(mosaic_phases(torch, np, card))
    tile_path_phases(torch, np, grid, card)
    rows.append(asi_phases(torch, np, card))
    rows += magnetic_generic_phases(torch, np, card)
    rows.append(iss_phases(torch, np, card, k1_ms))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
