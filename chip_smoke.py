#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (auromat_tpu_torch) on one NVIDIA GPU.

Drives the port's main path — georeference the real 12 MP ISS frame
ISS030-E-102170 (4256x2832) and mean-regrid it onto the 539x524 fixed grid
— through ``auromat_tpu_torch.entry``, then the public slice
``create_mapping`` -> ``resample('mean')`` of the same frame, the sequence
mosaic, the all-sky-imager path (THEMIS and MIRACLE providers,
``mosaic``, the interpolation routes, ``convert``), the magnetic grid
(``resample_mlat_mlt``), georeferencing through the generic FITS
projections, the ESA ISS archive path (lens correction on the card,
products read back, TLE camera positions), the solving path
(``solve_sequence`` with a stand-in ``solve-field``, the star-field
masking and its Hough kernel and the Earth checks on the card) and the
drawing layer's numbers (the KML overlay on K1, the horizon, RA/Dec and
constellation overlays), and checks them:

1. the card (``nvidia-smi`` name and power limit);
2. starts the build of every kernel source from this checkout, one nvcc
   each, all at once, and waits for K1's (``ops/csrc/georegrid_bin.cu``)
   and GEOREF_CELLS's (``ops/csrc/georef_cells.cu``);
3. GEOREF_CELLS against its plain twin, the eager chain, on the frame: iy,
   ix, lat, lon and elevation bit-equal; K1 against its plain PyTorch
   version on the card at the frame's shapes: all five outputs must be
   bit-equal;
4. the main path on a few frames (one masked), with the kernel launch
   counters zeroed just before and read just after: every kernel must have
   launched, the counts must equal the valid samples, the latitudes must
   cover the aurora over Canada, and the output must be bit-equal to the
   same path with the plain binning; the float64 chain on the card must
   match the executed-reference golden to < 1e-6 deg;
5. times (CUDA events, after warm-up): the main path per frame, K1 against
   its plain version, GEOREF_CELLS against the eager chain;
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
    CUDA-event median;
26. the solving path: the seeded 4256x2832 star-field frame
    (``starfield_frame``: stars, an Earth below a curved horizon, dim
    struts, a bright panel) under three names (saved with numpy;
    ``load_image``, ``save_image`` and ``read_exif_time`` replaced by
    numpy stand-ins for the phase: no PIL here) and a stand-in
    ``solve-field`` (a sh script writing the real .wcs without its POS*
    cards) through ``solve_sequence(mask=True, device='cuda')`` with the
    fitted ISS TLE: ``mask_starfield`` on the card for each frame (HOUGH_P
    counted from 0: one launch a frame), NORAD id, IMAGEW/IMAGEH and SGP4
    positions within 15 km of the real header's stamped; a second call
    runs the solver 0 times; a solver sleeping past a 2 s timeout gives
    None and leaves no process of its group; ``is_consistent`` and
    ``intersects_earth`` on the card equal the CPU (True, False, False for
    the stamped header and the header turned to nadir and zenith), timed;
    the stamped header through ``create_mapping`` -> ``resample`` of the
    ISS frame (K1 launched, held against its plain version on the recorded
    arguments and timed: a kernel row of its own) equal to [24]'s TLE
    mapping resampled; ``util.histogram.histogram2d`` with the weights
    (count, R, G, B, elevation) over the mapping's valid centres on the
    card against the host (counts equal, sums within 1e-12 relative),
    timed; ``io.fits.get_catalog_stars('bright')`` and
    ``recompute_xyls_pixel_positions`` on the card against the CPU;
    HOUGH_P (``ops/csrc/hough_p.cu``) against ``_hough_p_plain`` (the
    same lines in the same order and the same four trajectory counts:
    voters, triggers, clearing steps, lines) on seeded 240x320 frames at
    thresholds 200 and 60, on the stress frames (``hough_stress_frame``),
    on the star-field frame's Hough input and on both checked-in frames'
    Hough inputs (tests/resources/hough_input_*.npz); HOUGH_ORDER
    (``ops/csrc/hough_order.cu``, the visit order) against
    ``_hough_order`` at small counts and at each of those inputs' counts;
    both kernels timed (CUDA events) beside their bounds on the star field
    (3 launches each on the path: the main path's rows) and on both frames
    (rows of their own), and ``hough_lines_p``'s wall time; the contour
    stage's kernels (counted from 0 on the path: one launch each a
    binarization of each frame): CCL4 and CCL8 (``ops/csrc/ccl.cu``)
    bit-equal to ``_ccl_plain`` and CONTOUR_TRACE
    (``ops/csrc/contour_trace.cu``) equal to ``_contour_trace_plain``
    (doubled areas, boxes, chain lengths, simple counts and points in
    order) on the stress frames (``contour_stress_frame``), on the star
    field's binarizations and on both checked-in frames' binarizations
    (tests/resources/contour_input_*.npz), each kernel timed there (rows
    of their own: the star field's on the main path), with the walk's
    ``clock64()`` cycles a step and the stage's wall time; the path's masks
    equal ``mask_starfield`` on the CPU (pixels and sigma); the masking's
    wall time on the card and the CPU and its device time (profiler);
27. the drawing layer's numbers on the card against the CPU, on the seeded
    frame's 12 MP mapping (the real header, ``create_mapping`` on the
    card): ``draw_kml_image`` (PIL's writer replaced by numpy for the
    phase) resampling with ``resample('mean')`` at 100 arcsec (K1
    launched, held against its plain version on the recorded arguments
    and timed: a kernel row of its own), the KML text and RGBA equal; the
    horizon hit mask (``georeference_points`` at altitude 0) equal; the
    RA/Dec grid (``tan_pix2world``) and the constellation segments' end
    points (``tan_world2pix``) within 1e-9; wall ms of each on both; host
    ms of ``polygons_from_mapping_or_collection`` and
    ``stereographic_project`` on the resampled overlay; ``draw_plot``
    raising ImportError where matplotlib is not installed.

Every kernel row gets, beside its time and its plain version's, its bound
(``bound_ms``: the bytes the function must move — every index, the data
of the valid samples, every output once — over the H100's 3.35 TB/s) and
``library_ms``: one PyTorch call of the same function, timed in turns with
the kernel: one int64 ``index_add_`` of the same (count, channel,
fixed-point elevation) sums given the cell indices, and for K3, whose
function starts from coordinates, the chain of float64 ``bin_indices``,
the valid samples' data (NaN zeroed) and that ``index_add_`` (the
``index_add_`` alone is kept as ``library_ms_given_indices``). The port
never calls them. The rows of HOUGH_P, HOUGH_ORDER, CCL8, CCL4 and
CONTOUR_TRACE have no library call (``library_ms`` null): no PyTorch call
computes OpenCV's probabilistic Hough transform, draws OpenCV's RNG,
labels connected components or follows borders; their bounds count the
visit order's (x, y) pairs, the mask and the lines (HOUGH_P), the order's
int64 indices (HOUGH_ORDER), the image and the int32 labels (CCL), and
each chain pixel once with the roots and 40 bytes a root out
(CONTOUR_TRACE).

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
                                                 georegrid_inputs_plain)
    from auromat_tpu_torch.ops.regrid import fixed_grid, round_up
    from auromat_tpu_torch.parallel import (make_grid_sharded_mosaic_step,
                                            make_mesh, mosaic_sequence)

    dev = torch.device("cuda")
    k1 = _kernels.GEOREGRID_BIN
    gc = _kernels.GEOREF_CELLS
    all_kernels = (k1, gc, _kernels.GEOREGRID_BIN_I8, _kernels.REGRID_BIN,
                   _kernels.REGRID_BIN_V1)
    params, times, imgs = seq_frames(np)
    n_seq, h, w = imgs.shape[:3]
    g5 = fixed_grid(*GLOBAL_005)
    mesh = make_mesh(device=dev)

    # -- 10. K1 on an 8-frame stacked burst ---------------------------------
    g5_pad = dataclasses.replace(g5, n_lat=round_up(g5.n_lat, 8))
    dyn = DynGeorefParams.stack(params[:8], device=dev)
    # the eager chain's cells: K1 is checked here, not GEOREF_CELLS
    parts = [georegrid_inputs_plain(g5, dyn.frame(i), h, w) for i in range(8)]
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
    n_valid = n_high = 0  # from the eager chain, apart from the path's kernel
    for p in params:
        iy, _, out = georegrid_inputs_plain(
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
    seq_launches, gc_launches = k1.launches, gc.launches
    if seq_launches < 1:
        raise AssertionError("the sequence-mosaic path never launched K1")
    n_slots = -(-n_seq // 8) * 8  # the last step padded with null frames
    if gc_launches != n_slots:
        raise AssertionError(f"the sequence-mosaic path launched GEOREF_CELLS "
                             f"{gc_launches} times for {n_slots} frame slots")
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
          f"{seq_launches} launches of K1, {gc_launches} of GEOREF_CELLS "
          f"(one a frame slot), {total} samples into "
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


def iss_frame(np):
    """The seeded 4256x2832 uint8 frame of the ISS path ([23], [24], [26])."""
    return np.random.default_rng(SEED + 7).integers(0, 256, (2832, 4256, 3),
                                                    dtype=np.uint8)


def starfield_frame(np):
    """The seeded 4256x2832 uint8 star-field frame of [26]'s masking: a
    dark sky with 4000 stars, the Earth below a curved horizon, three dim
    struts (a little brighter than the sky: the Hough lines find them,
    the first threshold does not) and a bright panel in the top left
    corner (a big contour, like the Earth)."""
    h, w = 2832, 4256
    rng = np.random.default_rng(SEED + 11)
    img = rng.integers(8, 13, (h, w), dtype=np.int16)
    ys, xs = rng.integers(1, h - 1, 4000), rng.integers(1, w - 1, 4000)
    val = rng.integers(120, 256, 4000)
    for dy in (0, 1):
        for dx in (0, 1):
            img[ys + dy, xs + dx] = val
    earth = np.arange(h)[:, None] > 0.62 * h + 4e-5 * (np.arange(w) - w / 2) ** 2
    img[earth] = (110 + rng.integers(0, 40, (h, w)))[earth]
    for x0, y0, x1, y1 in ((300, 150, 3900, 900), (600, 1400, 3500, 300),
                           (2000, 100, 2100, 1500)):
        t = np.linspace(0, 1, max(abs(x1 - x0), abs(y1 - y0)) + 1)
        px = np.rint(x0 + t * (x1 - x0)).astype(int)
        py = np.rint(y0 + t * (y1 - y0)).astype(int)
        img[py, px] = img[py + 1, px] = 24
    img[:300, :500] = 200
    return np.repeat(img.astype(np.uint8)[..., None], 3, axis=2)


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
    frame = iss_frame(np)
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


def stand_ins():
    """tests/torch_solving_stand_ins.py, loaded by path (numpy and the
    standard library only): the stand-in ``solve-field``, its call log, the
    process-group scan and the header turned to nadir or zenith."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_solving_stand_ins",
        os.path.join(os.path.dirname(RES), "torch_solving_stand_ins.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def solving_phase(torch, np, card):
    """Phase 26: the solving path on the card. A folder of the seeded ISS
    frame under three names and a stand-in ``solve-field`` through
    ``solve_sequence`` (TLE positions), the resume and the timeout kill;
    the Earth checks on the card against the CPU; the stamped header
    through ``create_mapping`` -> ``resample`` on K1 against [24]'s TLE
    mapping; ``histogram2d`` with a list of weights on the card against the
    host; the star projections of ``io.fits`` on the card against the CPU.
    Returns the kernel row of its resample's K1."""
    import tempfile

    from auromat_tpu_torch.io import fits
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position
    from auromat_tpu_torch.ops import _kernels, georegrid
    from auromat_tpu_torch.resample import resample
    from auromat_tpu_torch.solving import solving, spacecraft
    from auromat_tpu_torch.util.histogram import histogram2d

    si = stand_ins()
    dev = torch.device("cuda")
    k1, hp, ho = _kernels.GEOREGRID_BIN, _kernels.HOUGH_P, _kernels.HOUGH_ORDER
    frame = iss_frame(np)
    sky = starfield_frame(np)
    date = datetime.datetime.strptime(ISS_DATE, "%Y-%m-%dT%H:%M:%S.%f")
    names = [f"ISS030-E-{102170 + i}.jpg" for i in range(3)]
    # no PIL on this machine: the star-field frame is saved with numpy
    # under the JPEG names, and the three readers the path calls are
    # replaced for the phase (load_image, save_image; read_exif_time gives
    # the header's DATE-OBS: one frame under three names); the masks the
    # path computes are kept
    path_masks = []

    def keep_mask(img, **kw):
        path_masks.append(real[(solving, "mask_starfield")](img, **kw))
        return path_masks[-1]

    stubs = {(solving, "load_image"): lambda path: np.load(path),
             (solving, "save_image"): lambda path, img: np.save(path, img),
             (spacecraft, "read_exif_time"): lambda path: date,
             (solving, "mask_starfield"): keep_mask}
    real = {k: getattr(*k) for k in stubs}
    for (mod, name), fn in stubs.items():
        setattr(mod, name, fn)
    tmp = tempfile.TemporaryDirectory()
    try:
        images = os.path.join(tmp.name, "images")
        os.makedirs(images)
        with open(os.path.join(images, names[0]), "wb") as f:
            np.save(f, sky)
        for n in names[1:]:
            os.link(os.path.join(images, names[0]), os.path.join(images, n))
        real_header = fits.read_header(os.path.join(RES,
                                                    "ISS030-E-102170_dc.wcs"))
        solved_src = os.path.join(tmp.name, "solved.wcs")
        fits.write_header(si.unstamped(real_header), solved_src)
        tle_path = os.path.join(tmp.name, "iss.tle")
        with open(tle_path, "w") as f:
            f.write(ISS_TLE)
        fake = si.fake_solve_field(tmp.name, solved_src)
        wcs_dir = os.path.join(tmp.name, "wcs")
        kw = dict(tle_path=tle_path, mask=True, device="cuda",
                  solve_field=fake, scale_range=(40.0, 60.0))
        torch.cuda.synchronize()
        hp.launches = ho.launches = 0
        for k in CONTOUR_KERNELS:
            getattr(_kernels, k).launches = 0
        t0 = time.perf_counter()
        res = spacecraft.solve_sequence(images, wcs_dir, **kw)
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
        hough_launches = {"HOUGH_P": hp.launches, "HOUGH_ORDER": ho.launches,
                          **contour_launches()}
        n_first = len(si.solver_calls(tmp.name))
        hpos = np.array(fits.get_spacecraft_position(real_header))
        dists = []
        for n in names:
            h = fits.read_header(res[n])
            dists.append(float(np.linalg.norm(
                np.array(fits.get_spacecraft_position(h)) - hpos)))
            if not (fits.get_norad_id(h) == 25544 and h["IMAGEW"] == 4256
                    and h["IMAGEH"] == 2832 and dists[-1] < 15.0
                    and fits.get_photo_time(h) == date):
                raise AssertionError(f"solve_sequence stamped {n}: NORAD "
                                     f"{fits.get_norad_id(h)}, "
                                     f"{h.get('IMAGEW')}x{h.get('IMAGEH')}, "
                                     f"position {dists[-1]} km off")
        again = spacecraft.solve_sequence(images, wcs_dir, **kw)
        n_again = len(si.solver_calls(tmp.name)) - n_first
        if n_first != 3 or n_again != 0 or again != res:
            raise AssertionError(f"solve_sequence: {n_first} solver calls, "
                                 f"{n_again} on the resumed run")
        # one Hough transform a frame, one contour stage (CCL4, CCL8,
        # CONTOUR_TRACE) a binarization of each frame
        n_stage = hough_launches["CCL8"]
        if ([hough_launches["HOUGH_P"], hough_launches["HOUGH_ORDER"]]
                != [3, 3] or hp.launches != 3 or ho.launches != 3
                or len(path_masks) != 3 or n_stage < 3 or n_stage % 3
                or [hough_launches[k] for k in CONTOUR_KERNELS]
                != [n_stage] * 3):
            raise AssertionError(f"solve_sequence(mask=True): launches "
                                 f"{hough_launches} for 3 frames "
                                 f"({hp.launches}, {ho.launches} after the "
                                 f"resumed run), {len(path_masks)} masks")
        # the timeout kill: a solver that sleeps past a 2 s timeout
        slow = si.fake_solve_field(tmp.name, solved_src, sleep=60)
        t0 = time.perf_counter()
        out = solving.solve_image(os.path.join(images, names[0]),
                                  os.path.join(tmp.name, "slow.wcs"),
                                  mask=False, solve_field=slow, timeout=2,
                                  strategies=solving.STRATEGIES[:1],
                                  scale_range=(40.0, 60.0))
        kill_s = time.perf_counter() - t0
        pgid = si.solver_calls(tmp.name)[-1][0]
        deadline = time.time() + 10
        while si.live_group_members(pgid) and time.time() < deadline:
            time.sleep(0.1)
        left = si.live_group_members(pgid)
        if out is not None or left or kill_s > 20:
            raise AssertionError(f"solve_image past its timeout returned "
                                 f"{out!r} after {kill_s:.1f} s, group "
                                 f"{pgid} still has {left}")
        stamped = fits.read_header(res[names[0]])
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
        tmp.cleanup()
    print(f"[26] solve_sequence(mask=True, device='cuda') over 3 names of "
          f"the seeded 4256x2832 star-field frame (numpy stand-ins for PIL's "
          f"load_image/save_image and the EXIF time) with a stand-in "
          f"solve-field and the fitted ISS TLE: mask_starfield on the card "
          f"for each frame, {hough_launches} launches, 3 "
          f"solver calls, 3 headers with NORADID 25544, IMAGEW/IMAGEH "
          f"4256x2832, SGP4 positions {max(dists):.3f} km from the real "
          f"header's, {seq_ms:.1f} ms wall; resumed: 0 solver calls; a "
          f"solver sleeping past a 2 s timeout: None after {kill_s:.2f} s, "
          f"its process group gone", flush=True)

    # -- the Earth checks on the card and on the CPU ------------------------
    pos, t, _ = resolve_camera_position(stamped)
    checks = {"stamped": (stamped, True),
              "all-Earth": (si.pointed(stamped, pos, -1), False),
              "all-sky": (si.pointed(stamped, pos, 1), False)}
    check_ms = {}
    for name, (h, want) in checks.items():
        got = {d: (spacecraft.is_consistent(h, device=d),
                   spacecraft.intersects_earth(h, device=d))
               for d in (dev, "cpu")}
        if got[dev] != got["cpu"] or got[dev][0] != want or \
                got[dev][1] != (name != "all-sky"):
            raise AssertionError(f"Earth checks on {name}: card {got[dev]}, "
                                 f"CPU {got['cpu']}, want consistent {want}")
        check_ms[name] = wall_ms(torch, lambda: spacecraft.is_consistent(
            h, device=dev), N_TIMED)
    print(f"[26] is_consistent / intersects_earth on the card == the CPU: "
          f"stamped True/True, all-Earth False/True, all-sky False/False; "
          f"is_consistent wall ms on the card (median of {N_TIMED}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in check_ms.items())
          + f"; on {card}", flush=True)

    # -- the stamped header -> create_mapping -> resample on K1 -------------
    m = create_mapping(stamped, frame, pos, t, device=dev)
    with recorded((georegrid, "bin_rgbelev_from_indices")) as rec:
        k1.launches = 0
        r = resample(m, px_per_deg=25, device=dev)
        torch.cuda.synchronize()
        launches = k1.launches
    with tempfile.TemporaryDirectory() as d:  # [24]'s TLE mapping
        tle_path = os.path.join(d, "iss.tle")
        with open(tle_path, "w") as f:
            f.write(ISS_TLE)
        header24 = fits.FitsHeader({k: v for k, v in real_header.items()
                                    if not k.startswith("POS")})
        pos24, t24, _ = resolve_camera_position(header24, tle_path)
    r24 = resample(create_mapping(header24, frame, pos24, t24, device=dev),
                   px_per_deg=25, device=dev)
    same = (np.array_equal(pos, pos24) and t == t24 and
            np.array_equal(r.img.filled(0), r24.img.filled(0)) and
            np.array_equal(r.center_mask, r24.center_mask) and
            all(np.array_equal(getattr(r, k).data, getattr(r24, k).data,
                               equal_nan=True) for k in ("lats", "lons")))
    if launches < 1 or not same:
        raise AssertionError(f"stamped header composite != [24]'s TLE "
                             f"mapping resampled ({launches} K1 launches)")
    print(f"[26] the stamped header -> create_mapping (float64, on the card) "
          f"-> resample(px_per_deg=25) -> {r.img.shape[0]}x{r.img.shape[1]}: "
          f"{launches} launch(es) of K1, == [24]'s TLE mapping resampled "
          f"(same position, uint8, masks, grids)", flush=True)
    on_solved = kernels_on_recorded(torch, rec, card, "[26]",
                                    "the solved header's mapping")
    del rec

    # -- histogram2d with a list of weights, card vs host -------------------
    ok = ~m.center_mask
    x, y = m.lonsCenter.data[ok], m.latsCenter.data[ok]
    weights = [None] + [m.img.data[..., c][ok] for c in range(3)] + \
        [m.elevation.data[ok]]
    bins = (int(np.ptp(x) * 25) + 1, int(np.ptp(y) * 25) + 1)
    rng_ = [[float(x.min()), float(x.max())], [float(y.min()), float(y.max())]]
    call = lambda d: histogram2d(x, y, bins, range=rng_, weights=weights,
                                 device=d)
    (hc, xe, ye), (hh, hxe, hye) = call(dev), call("cpu")
    rel = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
              for a, b in zip(hc[1:], hh[1:]))
    if not (np.array_equal(hc[0], hh[0]) and np.array_equal(xe, hxe) and
            np.array_equal(ye, hye) and rel <= 1e-12 and
            int(hc[0].sum()) == int(ok.sum())):
        raise AssertionError(f"histogram2d card vs host: counts equal "
                             f"{np.array_equal(hc[0], hh[0])}, sums {rel}")
    card_ms = wall_ms(torch, lambda: call(dev), N_WALL)
    xs, ys = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    ws = [w if w is None else torch.from_numpy(np.ascontiguousarray(w)).to(
        dev) for w in weights]
    resident_ms = wall_ms(torch, lambda: histogram2d(
        xs, ys, bins, range=rng_, weights=ws, device=dev), N_WALL)
    host_ms = wall_ms(torch, lambda: call("cpu"), N_WALL)
    print(f"[26] histogram2d(count, R, G, B, elevation) over the mapping's "
          f"{int(ok.sum())} valid centres into {bins[0]}x{bins[1]} bins: "
          f"card == host (counts equal, sums within {rel:.3g} relative); "
          f"wall ms (median of {N_WALL}) card {card_ms:.1f} from host arrays, "
          f"{resident_ms:.1f} from tensors on the card, host {host_ms:.1f}; "
          f"on {card}", flush=True)

    # -- the star projections of io.fits, card vs CPU -----------------------
    moved = stamped.copy()
    moved["CRVAL1"] += 0.05
    moved["CD1_2"] *= 1.001
    with tempfile.TemporaryDirectory() as d:
        xyls, wcs = os.path.join(d, "s.xyls"), os.path.join(d, "s.wcs")
        rng = np.random.default_rng(SEED)
        fits.write_xyls(xyls, rng.random(1000) * 4256, rng.random(1000) * 2832)
        fits.write_header(stamped, wcs)
        proj = {dv: (fits.get_catalog_stars(stamped, limit=0, device=dv),
                     fits.recompute_xyls_pixel_positions(xyls, wcs, moved,
                                                         device=dv))
                for dv in (dev, "cpu")}
    n_stars = len(proj["cpu"][0][0])
    perr = max(float(np.max(np.abs(a - b), initial=0.0))
               for pair in zip(proj[dev], proj["cpu"])
               for a, b in zip(*pair))
    if not (n_stars > 0 and len(proj[dev][0][0]) == n_stars and perr < 1e-9):
        raise AssertionError(f"fits star projections card vs CPU: {n_stars} "
                             f"stars, {perr} px")
    print(f"[26] io.fits on the card == the CPU: get_catalog_stars('bright') "
          f"{n_stars} stars in the frame, recompute_xyls_pixel_positions of "
          f"1000 stars under a moved solution; max {perr:.3g} px", flush=True)
    return [kernel_row("georegrid_bin (K1) on the solving path, the solved "
                       "header -> create_mapping -> resample('mean') "
                       f"-> {r.img.shape[0]}x{r.img.shape[1]}",
                       "auromat_tpu_torch/ops/csrc/georegrid_bin.cu",
                       "auromat_tpu/ops/georegrid.py:65", launches,
                       *on_solved["K1"])] + \
        masking_phase(torch, np, card, sky, path_masks, hough_launches)


def hough_frame(np, seed):
    """A seeded 240x320 0/255 frame for HOUGH_P's small check: 4% random
    pixels and four long lines across it."""
    from auromat_tpu_torch.utils import line_pixels

    rng = np.random.default_rng(SEED + seed)
    img = (rng.random((240, 320)) < 0.04).astype(np.uint8) * 255
    ends = [(0, y0, 319, y1) for y0, y1 in rng.integers(0, 240, (3, 2))]
    ends.append((rng.integers(0, 320), 0, rng.integers(0, 320), 239))
    for e in ends:
        xs, ys = line_pixels(*e)
        img[ys, xs] = 255
    return img


HOUGH_FRAMES = ("ISS030-E-102170_dc", "ISS029-E-8492")  # checked-in frames


def hough_input(np, name):
    """The Hough input (a 2832x4256 0/255 uint8 array) ``mask_starfield``
    computes for the checked-in frame ``name`` (tests/resources/
    hough_input_<name>.npz, packed bits; the card's machine cannot decode
    the JPEG)."""
    with np.load(os.path.join(RES, f"hough_input_{name}.npz")) as z:
        shape = tuple(int(n) for n in z["shape"])
        bits = np.unpackbits(z["bits"], count=shape[0] * shape[1])
    return bits.reshape(shape) * np.uint8(255)


# HOUGH_P's stress frames: name -> (threshold, minLineLength, maxLineGap)
HOUGH_STRESS = {"segments": (12, 40, 4), "octants": (40, 64, 4),
                "gaps": (30, 60, 4), "borders": (40, 50, 4),
                "same_bin": (20, 30, 2)}


def hough_stress_frame(np, name):
    """A seeded 0/255 frame that drives one of HOUGH_P's hard cases (its
    Hough arguments are ``HOUGH_STRESS[name]``): ``segments``, ~400 short
    segments (8-24 px) that reach the threshold and keep no line;
    ``octants``, 32 lines of 70-140 px from the centre in every direction
    (all eight octants, both ways); ``gaps``, dashed lines whose gaps are
    exactly 4 (bridged at maxLineGap 4) and 5 (not bridged); ``borders``,
    lines on every border row and column and diagonals into the corners;
    ``same_bin``, thick bands and solid blocks (many candidates of one
    window in one accumulator bin). Each over 1-3% random pixels."""
    from auromat_tpu_torch.utils import line_pixels

    seed = sorted(HOUGH_STRESS).index(name) + 11
    rng = np.random.default_rng(SEED + seed)
    h, w = 240, 320
    img = (rng.random((h, w)) < 0.02).astype(np.uint8)
    ends = []
    if name == "segments":
        for _ in range(400):
            x0, y0 = rng.integers(0, w), rng.integers(0, h)
            a, n = rng.uniform(0, 2 * np.pi), rng.integers(8, 25)
            ends.append((x0, y0, int(np.clip(x0 + n * np.cos(a), 0, w - 1)),
                         int(np.clip(y0 + n * np.sin(a), 0, h - 1))))
    elif name == "octants":
        for k in range(32):
            a = k * np.pi / 16 + rng.uniform(0.02, 0.15)
            n = rng.integers(70, 115)
            x0, y0 = w // 2 + rng.integers(-8, 9), h // 2 + rng.integers(-8, 9)
            ends.append((x0, y0, int(np.clip(x0 + n * np.cos(a), 0, w - 1)),
                         int(np.clip(y0 + n * np.sin(a), 0, h - 1))))
    elif name == "gaps":
        for k, gap in enumerate((4, 5, 4, 5, 4, 5)):
            y = 20 + 38 * k
            on = np.zeros(w, dtype=bool)
            for x in range(5, w - 5, 12 + gap):
                on[x:x + 12] = True
            img[y, 5:w - 5] = on[5:w - 5]
            ends.append((10 + 3 * k, 12 + 30 * k, 300 - 5 * k, 40 + 30 * k)
                        if k % 2 else (40 * k + 8, 2, 40 * k + 60, h - 3))
    elif name == "borders":
        ends += [(0, 0, w - 1, 0), (0, h - 1, w - 1, h - 1), (0, 0, 0, h - 1),
                 (w - 1, 0, w - 1, h - 1), (0, 0, h - 1, h - 1),
                 (w - 1, 0, w - h, h - 1), (0, 60, 100, 0), (w - 1, 150, 200, h - 1)]
    elif name == "same_bin":
        img[30:70, 40:80] = 1
        img[150:160, 20:300] = 1
        img[20:220, 200:206] = 1
        img[100:140, 100:180] = rng.random((40, 80)) < 0.6
        ends += [(0, 230, w - 1, 180), (10, 10, 300, 120)]
    else:
        raise ValueError(f"no stress frame {name!r}")
    for e in ends:
        xs, ys = line_pixels(*e)
        img[ys, xs] = 1
    return img * np.uint8(255)


# the binarizations mask_starfield makes of the checked-in frames (ISS030
# stops at the first), as packed bits in tests/resources/contour_input_*.npz
CONTOUR_FUDGES = {"ISS030-E-102170_dc": (20,), "ISS029-E-8492": (20, 40, 60)}


def contour_input(np, name):
    """{fudge: the (2832, 4256) 0/255 uint8 binary ``_binarize`` makes of
    the checked-in frame ``name`` at that fudge}, from
    tests/resources/contour_input_<name>.npz (packed bits)."""
    out = {}
    with np.load(os.path.join(RES, f"contour_input_{name}.npz")) as z:
        shape = tuple(int(n) for n in z["shape"])
        for fudge in CONTOUR_FUDGES[name]:
            bits = np.unpackbits(z[f"fudge{fudge}"], count=shape[0] * shape[1])
            out[fudge] = bits.reshape(shape) * np.uint8(255)
    return out


CONTOUR_STRESS = ("rings", "pinches", "diagonals", "edges", "singles",
                  "full", "noise", "spiral")


def contour_stress_frame(np, name):
    """A seeded 240x320 0/255 frame that drives one of the contour stage's
    hard cases: ``rings``, nested rings (holes, islands in the holes,
    rings in the islands' holes); ``pinches``, blobs joined through one
    pixel (side and corner) and holes that touch at a corner; ``diagonals``,
    45-degree lines, zigzags, diamond rings and checkerboard patches (every
    hole a single 4-isolated pixel); ``edges``, components and notches on
    every image edge and in every corner, U shapes open to an edge (no
    hole), a ring cut by the edge; ``singles``, isolated pixels and pairs,
    in the corners too; ``full``, one component over the whole frame with
    holes inside and bays open to the edges; ``noise``, 45% random pixels;
    ``spiral``, a one-pixel square spiral over the frame (a border of some
    76,000 steps)."""
    rng = np.random.default_rng(SEED + 31 + CONTOUR_STRESS.index(name))
    h, w = 240, 320
    img = np.zeros((h, w), dtype=np.uint8)
    yy, xx = np.mgrid[:h, :w]
    if name == "rings":
        for _ in range(9):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            r = np.hypot(yy - cy, xx - cx)
            step = int(rng.integers(2, 7))
            img[(r < 6 * step) & ((r // step) % 2 == 0)] = 1
        img[(rng.random((h, w)) < 0.01)] = 1
    elif name == "pinches":
        for k in range(40):
            y, x = rng.integers(4, h - 24), rng.integers(4, w - 44)
            a, b = int(rng.integers(3, 9)), int(rng.integers(3, 9))
            img[y:y + a, x:x + a] = 1
            if k % 2:  # a one-pixel bridge on the side
                img[y + a // 2, x + a] = 1
                img[y:y + b, x + a + 1:x + a + 1 + b] = 1
            else:  # touching at a corner only
                img[y + a:y + a + b, x + a:x + a + b] = 1
        for k in range(8):  # two holes meeting at a corner
            y, x = rng.integers(2, h - 12), rng.integers(2, w - 12)
            img[y:y + 9, x:x + 9] = 1
            img[y + 2:y + 4, x + 2:x + 4] = 0
            img[y + 4:y + 7, x + 4:x + 7] = 0
    elif name == "diagonals":
        for k in range(30):
            y, x, n = rng.integers(0, h), rng.integers(0, w), rng.integers(5, 60)
            s = 1 if k % 2 else -1
            i = np.arange(n)
            ok = (y + i < h) & (x + s * i >= 0) & (x + s * i < w)
            img[(y + i)[ok], (x + s * i)[ok]] = 1
        for k in range(12):  # zigzags and diamond rings
            y, x, r = rng.integers(12, h - 12), rng.integers(12, w - 12), \
                int(rng.integers(3, 11))
            d = np.abs(yy - y) + np.abs(xx - x)
            img[d == r] = 1
            if k % 3 == 0:
                img[y, x] = 1  # an island in the diamond's hole
        for k in range(4):
            y, x = rng.integers(0, h - 20), rng.integers(0, w - 20)
            patch = ((yy[:16, :16] + xx[:16, :16]) % 2 == 0)
            img[y:y + 16, x:x + 16] |= patch.astype(np.uint8)
    elif name == "edges":
        img[0, 10:60] = img[h - 1, 40:120] = img[50:90, 0] = 1
        img[100:180, w - 1] = 1
        img[:3, :3] = img[:3, w - 3:] = img[h - 3:, :3] = img[h - 3:, w - 3:] = 1
        img[0:30, 150:190] = 1
        img[0:20, 160:180] = 0  # a U open to the top edge: no hole
        img[h - 30:h, 220:260] = 1
        img[h - 25:h - 5, 230:250] = 0  # a hole near the bottom edge
        r = np.hypot(yy - 120, xx - (w - 5))
        img[(r >= 15) & (r < 22)] = 1  # a ring cut by the right edge
        r = np.hypot(yy - 5, xx - 5)
        img[(r >= 20) & (r < 24)] = 1
        img[rng.random((h, w)) < 0.005] = 1
    elif name == "singles":
        img[rng.random((h, w)) < 0.004] = 1
        ys, xs = rng.integers(0, h - 1, 60), rng.integers(0, w - 1, 60)
        img[ys, xs] = 1
        img[ys + 1, xs + 1] = 1  # diagonal pairs
        img[0, 0] = img[0, w - 1] = img[h - 1, 0] = img[h - 1, w - 1] = 1
    elif name == "full":
        img[:] = 1
        for _ in range(25):
            y, x = rng.integers(1, h - 12), rng.integers(1, w - 12)
            img[y:y + rng.integers(1, 10), x:x + rng.integers(1, 10)] = 0
        img[0:15, 100:104] = 0  # bays open to the edges
        img[h - 8:h, 30:50] = 0
        img[60:63, w - 20:w] = 0
        for y, x in rng.integers(3, 9, (6, 2)) + [40, 40]:
            img[y, x] = 1
    elif name == "noise":
        img[rng.random((h, w)) < 0.45] = 1
    elif name == "spiral":  # a turtle: right w-1, down h-1, left w-1,
        # then up and right, down and left, two shorter each turn
        lens = [w - 1, h - 1, w - 1]
        a, b = h - 3, w - 3
        while a > 0 and b > 0:
            lens += [a, b]
            a, b = a - 2, b - 2
        y = x = 0
        img[0, 0] = 1
        for k, n in enumerate(lens):
            dy, dx = ((0, 1), (1, 0), (0, -1), (-1, 0))[k % 4]
            img[y + dy * np.arange(1, n + 1), x + dx * np.arange(1, n + 1)] = 1
            y, x = y + dy * n, x + dx * n
    else:
        raise ValueError(f"no stress frame {name!r}")
    return img * np.uint8(255)


CONTOUR_KERNELS = ("CCL8", "CCL4", "CONTOUR_TRACE")


def contour_launches():
    from auromat_tpu_torch.ops import _kernels

    return {k: getattr(_kernels, k).launches for k in CONTOUR_KERNELS}


def contour_held(torch, np, what, binary):
    """The contour stage on the card against its plain versions on one
    (h, w) 0/255 binary: CCL4 of the zero pixels and CCL8 of the
    hole-filled image bit-equal to ``_ccl_plain``, CONTOUR_TRACE (with
    its points) equal to ``_contour_trace_plain`` (doubled areas, boxes,
    chain lengths, simple counts, points in order). Returns the card's
    tensors and the plain versions' host ms."""
    from auromat_tpu_torch.solving import masking

    dev = torch.device("cuda")
    plain_ms = {}
    t0 = time.perf_counter()
    bg_want = masking._ccl_plain(binary, 4, fg=False)
    plain_ms["CCL4"] = (time.perf_counter() - t0) * 1e3
    filled_want = masking._fill_holes(torch.from_numpy(binary),
                                      torch.from_numpy(bg_want)).numpy()
    t0 = time.perf_counter()
    labels_want = masking._ccl_plain(filled_want, 8)
    plain_ms["CCL8"] = (time.perf_counter() - t0) * 1e3
    roots_want = np.flatnonzero(labels_want.ravel() ==
                                np.arange(binary.size))
    t0 = time.perf_counter()
    trace_want = masking._contour_trace_plain(binary, roots_want, points=True)
    plain_ms["CONTOUR_TRACE"] = (time.perf_counter() - t0) * 1e3

    g = torch.from_numpy(binary).to(dev)
    bg = masking.ccl(g, 4, fg=False)
    filled = masking._fill_holes(g, bg).to(torch.uint8)
    labels = masking.ccl(filled, 8)
    roots, labels_path, borders = masking.external_contours(g, points=True)
    torch.cuda.synchronize()
    checks = {"CCL4": np.array_equal(bg.cpu().numpy(), bg_want),
              "fill": np.array_equal(filled.cpu().numpy() != 0, filled_want),
              "CCL8": np.array_equal(labels.cpu().numpy(), labels_want)
              and torch.equal(labels, labels_path),
              "roots": np.array_equal(roots.cpu().numpy(), roots_want)}
    for field in masking.Borders._fields:
        checks[field] = np.array_equal(getattr(borders, field).cpu().numpy(),
                                       getattr(trace_want, field))
    if not all(checks.values()):
        raise AssertionError(f"the contour stage on {what} != the plain "
                             f"versions: {checks}")
    return g, filled, roots, borders, plain_ms


def contour_rows(torch, np, card, what, binary, launches):
    """CCL8, CCL4 and CONTOUR_TRACE on one binarization: held against the
    plain versions (``contour_held``) and timed (CUDA events, median of 5);
    the walk's ``clock64()`` cycles a step on the longest border; the
    stage's wall ms (``external_contours`` and ``_label_mask``, median of
    5). Returns their three kernel rows and the stage's wall ms."""
    from auromat_tpu_torch.solving import masking

    g, filled, roots, borders, plain_ms = contour_held(torch, np, what,
                                                       binary)
    dev = g.device
    before = contour_launches()
    masking.external_contours(g)
    calls = {k: n - before[k] for k, n in contour_launches().items()}
    if list(calls.values()) != [1, 1, 1]:
        raise AssertionError(f"external_contours on {what}: launches {calls}")
    ms = {"CCL4": cuda_ms(torch, lambda: masking.ccl(g, 4, fg=False), 5),
          "CCL8": cuda_ms(torch, lambda: masking.ccl(filled, 8), 5),
          "CONTOUR_TRACE": cuda_ms(
              torch, lambda: masking._contour_trace_cuda(g, roots), 5)}
    cycles = torch.zeros(len(roots), dtype=torch.int64, device=dev)
    masking._contour_trace_cuda(g, roots, cycles=cycles)
    longest = int(torch.argmax(borders.length))
    steps = int(borders.length[longest])
    per_step = int(cycles[longest]) / max(steps, 1)
    stage_ms = wall_ms(torch, lambda: masking._label_mask(
        binary.shape, masking.external_contours(g), True), 5)
    n, h, w = len(roots), *binary.shape
    # bytes the functions must move: CCL reads the image (a byte a pixel)
    # and writes the int32 labels; CONTOUR_TRACE reads each chain pixel
    # once, the int32 roots, and writes 40 bytes a root (doubled area,
    # box, length, count)
    nbytes = {"CCL4": 5 * h * w, "CCL8": 5 * h * w,
              "CONTOUR_TRACE": int(borders.length.sum()) + 44 * n}
    n_big = int((borders.area2 > 2 * int(0.000013 * h * w)).sum())
    print(f"[26] contour stage on {what}: {n} external contours ({n_big} "
          f"big), the longest {steps} steps; CCL4, fill, CCL8 and "
          f"CONTOUR_TRACE == the plain versions (labels, roots, areas, "
          f"boxes, lengths, counts, {int(borders.count.sum())} points); "
          f"CUDA ms (median of 5) CCL4 {ms['CCL4']:.3f}, CCL8 "
          f"{ms['CCL8']:.3f}, CONTOUR_TRACE {ms['CONTOUR_TRACE']:.3f} "
          f"({per_step:.1f} cycles a step of the longest walk, clock64); "
          f"stage wall {stage_ms:.2f} ms; plain (host) ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in plain_ms.items())
          + f"; bounds ms " + ", ".join(f"{k} {bound_ms(v):.5f}"
                                       for k, v in nbytes.items())
          + f"; launches {launches or calls}; on {card}", flush=True)
    names = {"CCL8": "ccl (CCL8), the hole-filled image's 8-connected "
                     "components",
             "CCL4": "ccl (CCL4), the zero pixels' 4-connected components "
                     "(the holes)",
             "CONTOUR_TRACE": f"contour_trace (CONTOUR_TRACE), {n} outer "
                              f"borders, the longest {steps} steps"}
    sources = {"CCL8": "ccl.cu", "CCL4": "ccl.cu",
               "CONTOUR_TRACE": "contour_trace.cu"}
    rows = [{"name": f"{names[k]}, on {what} (no TPU kernel: the JAX "
                     f"package calls cv2.findContours on the host; no "
                     f"PyTorch call labels components or follows borders)",
             "route": "cuda",
             "source": f"auromat_tpu_torch/ops/csrc/{sources[k]}",
             "replaces": "auromat_tpu/solving/masking.py:70",
             "launches": (launches or calls)[k], "max_abs_err": 0.0,
             "ms": ms[k], "plain_ms": plain_ms[k],
             "bound_ms": bound_ms(nbytes[k]), "bound_by": "bytes",
             "library_ms": None} for k in CONTOUR_KERNELS]
    return rows, stage_ms


def contour_phase(torch, np, card, gray, launches):
    """The contour stage's kernels against their plain versions on the
    stress frames (``contour_stress_frame``), on the binarizations
    ``mask_starfield`` makes of the star field (``gray``) and on the
    checked-in frames' binarizations; kernel rows for the star field's
    (the path's: ``launches`` from its run) and each frame's."""
    from auromat_tpu_torch.solving import masking

    stress = {}
    for name in CONTOUR_STRESS:
        _, _, roots, borders, _ = contour_held(
            torch, np, f"the stress frame {name!r}",
            contour_stress_frame(np, name))
        stress[name] = (len(roots), int(borders.length.max()))
    print(f"[26] CCL4, CCL8, CONTOUR_TRACE == the plain versions on the "
          f"stress frames (contours, longest border): {stress}", flush=True)
    with recorded((masking, "external_contours")) as rec:
        masking._dark_area_mask(gray, True)
    sky_bins = [a[0].cpu().numpy() for a in rec.calls["external_contours"]]
    if not sky_bins:
        raise AssertionError("_dark_area_mask on the card ran no contour stage")
    rows, stage = [], {}
    for k, binary in enumerate(sky_bins):
        what = f"the star-field frame's binarization {k + 1} (the path's)"
        r, stage[f"star field {k + 1}"] = contour_rows(torch, np, card, what,
                                                       binary, launches)
        rows += r
    for name in HOUGH_FRAMES:
        for fudge, binary in contour_input(np, name).items():
            r, stage[f"{name} fudge {fudge}"] = contour_rows(
                torch, np, card, f"{name}'s binarization at fudge {fudge}",
                binary, None)
            rows += r
    print(f"[26] the contour stage's wall ms a binarization: "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
          + f"; on {card}", flush=True)
    return rows


def masking_phase(torch, np, card, sky, path_masks, launches):
    """Phase 26, the masking: HOUGH_P against ``_hough_p_plain`` (lines and
    the four counts) on small seeded frames, the stress frames, the
    star-field frame's Hough input and both checked-in frames' Hough
    inputs; HOUGH_ORDER against ``_hough_order``; both kernels timed on the
    star field and on the frames; the masks ``solve_sequence`` made on the
    card against ``mask_starfield`` on the CPU; the masking's wall and
    device time on the card and its wall time on the CPU. Returns the
    kernel rows of HOUGH_P and HOUGH_ORDER (the star field's, on the main
    path, then each frame's)."""
    import math

    from auromat_tpu_torch.ops import _kernels
    from auromat_tpu_torch.solving import masking

    dev = torch.device("cuda")
    args = (1, math.pi / 180)
    kernels = (_kernels.HOUGH_P, _kernels.HOUGH_ORDER)

    def held(what, img, thr, length, gap):
        """HOUGH_P on the card == the plain version, lines and counts;
        (lines, counts, plain ms, {kernel: launches of the call})."""
        want_counts, got_counts = {}, {}
        t0 = time.perf_counter()
        want = masking._hough_p_plain(img, *args, thr, length, gap,
                                      want_counts)
        plain_ms = (time.perf_counter() - t0) * 1e3
        binary = torch.from_numpy(img).to(dev)
        for k in kernels:
            k.launches = 0
        got = masking.hough_lines_p(binary, *args, thr, length, gap,
                                    got_counts)
        calls = dict(zip(("HOUGH_P", "HOUGH_ORDER"),
                         (k.launches for k in kernels)))
        if not (np.array_equal(got, want) and got_counts == want_counts):
            raise AssertionError(f"HOUGH_P on {what}: {len(got)} lines, "
                                 f"counts {got_counts}; the plain version "
                                 f"{len(want)} lines, {want_counts}")
        if list(calls.values()) != [1, 1]:
            raise AssertionError(f"hough_lines_p on {what}: launches {calls}")
        return want, want_counts, plain_ms, calls

    n_small = 0
    for seed in (1, 2, 3):
        for thr, length in ((200, 100), (60, 30)):
            want = held(f"the seeded 240x320 frame {seed} (threshold {thr})",
                        hough_frame(np, seed), thr, length, 4)[0]
            if len(want) == 0:
                raise AssertionError(f"no line on the seeded frame {seed}")
            n_small += len(want)
    stress = {}
    for name, hargs in HOUGH_STRESS.items():
        want, counts, _, _ = held(f"the stress frame {name!r}",
                                  hough_stress_frame(np, name), *hargs)
        stress[name] = f"{len(want)} lines / {counts['triggers']} triggers"
    print(f"[26] HOUGH_P == _hough_p_plain (the same lines in the same "
          f"order, the same voters, triggers, clearing steps and lines) on "
          f"3 seeded 240x320 frames at thresholds 200 and 60 ({n_small} "
          f"lines) and on the stress frames: {stress}", flush=True)
    for count in (0, 1, 2, 3, 5, 1000, 8193):
        got = masking._hough_order_cuda(count, dev).cpu().numpy()
        if not np.array_equal(got, masking._hough_order(count)):
            raise AssertionError(f"HOUGH_ORDER != _hough_order at {count}")

    def kernel_rows(what, img, hough_launches):
        """HOUGH_P and HOUGH_ORDER on ``img`` (threshold 200, length 100,
        gap 4) held and timed: CUDA-event medians of 5, a fresh mask and
        accumulator for each HOUGH_P run; returns their two rows."""
        want, counts, plain_ms, calls = held(what, img, 200, 100, 4)
        binary = torch.from_numpy(img).to(dev)
        a = masking._hough_p_args(binary, *args, 200, 100, 4)
        mask0 = a["mask"].clone()
        runs = []
        for _ in range(5):
            a["mask"].copy_(mask0)
            a["acc"].zero_()
            runs.append(cuda_ms(torch, lambda: masking._hough_p_launch(a), 1))
        count = a["count"]
        t0 = time.perf_counter()
        order_want = masking._hough_order(count)
        order_plain_ms = (time.perf_counter() - t0) * 1e3
        order = masking._hough_order_cuda(count, dev)
        if not np.array_equal(order.cpu().numpy(), order_want):
            raise AssertionError(f"HOUGH_ORDER != _hough_order at {count}")
        order_runs = [cuda_ms(torch, lambda: masking._hough_order_cuda(
            count, dev), 1) for _ in range(5)]

        def wrapper():
            out = masking.hough_lines_p(binary, *args, 200, 100, 4)
            torch.cuda.synchronize()
            return out

        wrap_ms = wall_ms(torch, wrapper, N_WALL)
        k_ms, o_ms = statistics.median(runs), statistics.median(order_runs)
        p_bytes = 8 * count + img.size + 16 * len(want) + 8 * a["numangle"]
        print(f"[26] {what}: {count} candidate pixels, {len(want)} lines, "
              f"counts {counts} == plain; HOUGH_P {k_ms:.2f} ms (CUDA "
              f"events, median of 5: {[round(r, 2) for r in runs]}), plain "
              f"(numpy, host) {plain_ms:.1f} ms, bound "
              f"{bound_ms(p_bytes):.4f} ms; HOUGH_ORDER {o_ms:.3f} ms "
              f"({[round(r, 3) for r in order_runs]}) == _hough_order "
              f"({order_plain_ms:.1f} ms on the host), bound "
              f"{bound_ms(8 * count):.5f} ms; hough_lines_p wall "
              f"{wrap_ms:.1f} ms (median of {N_WALL}); launches "
              f"{hough_launches or calls}; on {card}", flush=True)
        n_p = (hough_launches or calls)["HOUGH_P"]
        n_o = (hough_launches or calls)["HOUGH_ORDER"]
        return [
            {"name": f"hough_p (HOUGH_P), cv2.HoughLinesP's algorithm, on "
                     f"{what} (no TPU kernel: the JAX package calls "
                     f"OpenCV on the host)",
             "route": "cuda", "source": "auromat_tpu_torch/ops/csrc/hough_p.cu",
             "replaces": "auromat_tpu/solving/masking.py:221",
             "launches": n_p, "max_abs_err": 0.0, "ms": k_ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms(p_bytes),
             "bound_by": "bytes", "library_ms": None},
            {"name": f"hough_order (HOUGH_ORDER), HoughLinesP's visit order "
                     f"of {count} pixels, on {what} (no TPU kernel: OpenCV's "
                     f"RNG on the host)",
             "route": "cuda",
             "source": "auromat_tpu_torch/ops/csrc/hough_order.cu",
             "replaces": "auromat_tpu/solving/masking.py:221",
             "launches": n_o, "max_abs_err": 0.0, "ms": o_ms,
             "plain_ms": order_plain_ms, "bound_ms": bound_ms(8 * count),
             "bound_by": "bytes", "library_ms": None}]

    gray = masking._gray(torch.from_numpy(sky).to(dev), None)
    mask, _ = masking._dark_area_mask(gray, True)
    host = masking._line_candidates(gray * mask, mask).cpu().numpy()
    rows = kernel_rows("the star-field frame's Hough input (the path's "
                       "shape)", host, launches)
    for name in HOUGH_FRAMES:
        rows += kernel_rows(f"{name}'s Hough input", hough_input(np, name),
                            None)
    rows += contour_phase(torch, np, card, gray, launches)

    # the masks the path made, against mask_starfield on the CPU
    t0 = time.perf_counter()
    cmask, csigma = masking.mask_starfield(sky, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    for m, sigma in path_masks:
        if not (np.array_equal(m, cmask) and sigma == csigma):
            raise AssertionError(f"mask_starfield on the card != the CPU: "
                                 f"{int((m != cmask).sum())} pixels, sigma "
                                 f"{sigma} vs {csigma}")
    card_ms = wall_ms(torch, lambda: masking.mask_starfield(sky, device=dev),
                      N_WALL)
    busy = device_busy_ms(torch, lambda: masking.mask_starfield(sky,
                                                                device=dev))
    busy_txt = ("no device events traced" if busy is None else
                f"{busy[0]:.1f} ms in {busy[2]} kernels + {busy[1]:.1f} ms "
                f"in copies")
    print(f"[26] mask_starfield of the star-field frame: the 3 masks of the "
          f"path (card) == the CPU's (0 pixels apart, sigma {csigma:.6f}), "
          f"starfield {cmask.mean():.4f} of the frame; wall ms on the card "
          f"{card_ms:.1f} (median of {N_WALL}; device: {busy_txt}), on the "
          f"CPU {cpu_ms:.1f}; on {card}", flush=True)
    return rows


def drawing_phase(torch, np, card):
    """Phase 27: the numeric halves of the drawing layer's device-reaching
    figures on the card and again on the CPU, on the seeded ISS frame's
    12 MP mapping: ``draw_kml_image`` (its PNG written by a numpy stand-in
    for PIL; ``resample('mean')`` at 100 arcsec launches K1), the horizon
    hit mask, the RA/Dec grid and the constellation segments; the host
    times of the polygons and the stereographic projection; and a figure
    function without matplotlib. Returns the kernel row of the overlay's
    K1."""
    import importlib.util
    import tempfile

    from auromat_tpu_torch import draw
    from auromat_tpu_torch.coordinates.constellations import figure_segments
    from auromat_tpu_torch.coordinates.wcs import TanWcs
    from auromat_tpu_torch.draw_helpers import (
        polygons_from_mapping_or_collection)
    from auromat_tpu_torch.io import fits, image
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position
    from auromat_tpu_torch.ops import _kernels, georegrid
    from auromat_tpu_torch.resample import resample

    dev = torch.device("cuda")
    k1 = _kernels.GEOREGRID_BIN
    header = fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs"))
    pos, t, _ = resolve_camera_position(header)
    m = create_mapping(header, iss_frame(np), pos, t, device=dev)

    # -- the KML overlay: PIL's writer replaced by numpy for the phase ------
    def save_npy(path, img):
        with open(path, "wb") as f:
            np.save(f, img)

    real_save = image.save_image
    image.save_image = save_npy
    tmp = tempfile.TemporaryDirectory()
    try:
        def kml(device, name):
            kml_path, png_path = draw.draw_kml_image(
                os.path.join(tmp.name, f"{name}.kml"), m, device=device)
            with open(kml_path) as f:
                return f.read(), np.load(png_path)

        with recorded((georegrid, "bin_rgbelev_from_indices")) as rec:
            k1.launches = 0
            text, rgba = kml(dev, "overlay")
            torch.cuda.synchronize()
            launches = k1.launches
        ctext, crgba = kml("cpu", "overlay")
        kml_ms = wall_ms(torch, lambda: kml(dev, "overlay"), N_WALL)
        ckml_ms = wall_ms(torch, lambda: kml("cpu", "overlay"), N_WALL)
    finally:
        image.save_image = real_save
        tmp.cleanup()
    if launches < 1:
        raise AssertionError("draw_kml_image on the card never launched K1")
    if text != ctext or not np.array_equal(rgba, crgba) or \
            rgba.dtype != np.uint8 or rgba.shape[-1] != 4:
        raise AssertionError(f"KML overlay card vs CPU: text equal "
                             f"{text == ctext}, RGBA {rgba.shape} equal "
                             f"{np.array_equal(rgba, crgba)}")
    n_cells = int((rgba[..., 3] == 255).sum())
    print(f"[27] draw_kml_image (the PNG written with numpy: no PIL here) of "
          f"the seeded 4256x2832 frame's mapping -> resample('mean', 100 "
          f"arcsec) -> {rgba.shape[0]}x{rgba.shape[1]} RGBA, {n_cells} opaque "
          f"cells: {launches} launch(es) of K1; card == CPU (KML text equal, "
          f"RGBA equal); wall ms (median of {N_WALL}) card {kml_ms:.1f}, "
          f"CPU {ckml_ms:.1f}; on {card}", flush=True)
    on_kml = kernels_on_recorded(torch, rec, card, "[27]",
                                 "the KML overlay's mapping")
    del rec

    # -- the horizon, RA/Dec and constellation numbers ----------------------
    wcs = TanWcs(m.wcs_header)
    segments = figure_segments()
    helpers = {
        "horizon": lambda d: draw._horizon_grid(m, device=d),
        "ra_dec": lambda d: draw._ra_dec_grid(m, 64, device=d),
        "constellations": lambda d: tuple(draw._constellation_segments(
            wcs, segments, device=d).values()),
    }
    times = {}
    for name, fn in helpers.items():
        got, want = fn(dev), fn("cpu")
        if len(got) != len(want):
            raise AssertionError(f"{name}: {len(got)} != {len(want)} arrays")
        err = 0.0
        for g, w in zip(got, want):
            g, w = g.astype(np.float64), w.astype(np.float64)
            if g.shape != w.shape or not np.array_equal(np.isnan(g),
                                                        np.isnan(w)):
                raise AssertionError(f"{name} card vs CPU: shapes or NaNs")
            ok = ~np.isnan(w)
            err = max(err, float(np.max(np.abs(g[ok] - w[ok]), initial=0.0)))
        if name == "horizon" and not all(np.array_equal(g, w)
                                         for g, w in zip(got, want)):
            raise AssertionError("horizon hit mask card != CPU")
        if not err < 1e-9:
            raise AssertionError(f"{name} card vs CPU: {err}")
        times[name] = (wall_ms(torch, lambda: fn(dev), N_WALL),
                       wall_ms(torch, lambda: fn("cpu"), N_WALL), err)
    _, _, hit = helpers["horizon"]("cpu")
    n_seg = sum(len(v) for v in segments.values())
    print(f"[27] card == CPU: horizon hit mask of {hit.shape[0]}x"
          f"{hit.shape[1]} strided pixels (equal, {hit.mean():.4f} on Earth), "
          f"RA/Dec of every 64th pixel (max {times['ra_dec'][2]:.3g} deg), "
          f"{n_seg} constellation segments' end points (max "
          f"{times['constellations'][2]:.3g} px); wall ms (median of "
          f"{N_WALL}) card / CPU: " + ", ".join(
              f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in times.items())
          + f"; on {card}", flush=True)

    # -- host times of the figure-side numbers; a figure without matplotlib -
    r = resample(m, arcsec_per_px=100, method="mean", device=dev)
    verts, colors = polygons_from_mapping_or_collection(r)
    poly_ms = wall_ms(torch, lambda: polygons_from_mapping_or_collection(r),
                      N_WALL)
    bb = r.boundingBox.center
    stereo_ms = wall_ms(torch, lambda: draw.stereographic_project(
        verts[..., 1], verts[..., 0], bb.lat, bb.lon), N_WALL)
    print(f"[27] host ms (median of {N_WALL}) on the {r.img.shape[0]}x"
          f"{r.img.shape[1]} overlay mapping: polygons_from_mapping_or_"
          f"collection {poly_ms:.2f} ({len(verts)} quads), "
          f"stereographic_project {stereo_ms:.2f}", flush=True)
    if importlib.util.find_spec("matplotlib") is None:
        try:
            draw.draw_plot(r)
        except ImportError as e:
            print(f"[27] draw_plot without matplotlib on this machine raised "
                  f"ImportError: {e}", flush=True)
        else:
            raise AssertionError("draw_plot returned without matplotlib")
    else:
        fig = draw.draw_plot(r)
        print(f"[27] matplotlib is installed here: draw_plot drew "
              f"{len(fig.axes[0].collections)} collection(s)", flush=True)
    return kernel_row("georegrid_bin (K1), KML overlay -> 100 arcsec grid "
                      f"(draw_kml_image -> resample('mean') -> "
                      f"{rgba.shape[0]}x{rgba.shape[1]})",
                      "auromat_tpu_torch/ops/csrc/georegrid_bin.cu",
                      "auromat_tpu/ops/georegrid.py:65", launches,
                      *on_kml["K1"])


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
                                                 cell_planes, georef_cells,
                                                 georegrid_inputs,
                                                 georegrid_inputs_plain,
                                                 launch_k1)
    from auromat_tpu_torch.ops.regrid import finalize_mean

    dev = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card} | {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 2. build every kernel source at once; wait for K1's ---------------
    builds = start_builds([_kernels.GEOREGRID_BIN, _kernels.GEOREF_CELLS,
                           _kernels.REGRID_BIN, _kernels.HOUGH_P,
                           _kernels.HOUGH_ORDER, _kernels.CCL8,
                           _kernels.CONTOUR_TRACE])
    kernels = {"K1": _kernels.GEOREGRID_BIN,
               "GEOREF_CELLS": _kernels.GEOREF_CELLS}
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
    plain_cells = georegrid_inputs_plain(grid, dyn, h, w)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    gc_err = 0.0  # the largest gap where both are numbers
    for n, a, b in zip(("iy", "ix", "lat", "lon", "elevation"),
                       (iy, ix, out["lat"], out["lon"], out["elevation"]),
                       (*plain_cells[:2], *(plain_cells[2][k] for k in (
                           "lat", "lon", "elevation")))):
        nan = b != b
        if not (torch.equal(a != a, nan)
                and torch.equal(bits(a)[~nan], bits(b)[~nan])):
            raise AssertionError(f"GEOREF_CELLS != the eager chain on {n}")
        gap = (a[~nan].double() - b[~nan].double()).abs()
        gc_err = max(gc_err, float(gap.max().item()) if gap.numel() else 0.0)
    del plain_cells, gap
    print(f"[3] GEOREF_CELLS == the eager chain bit for bit on iy, ix, lat, "
          f"lon and elevation at {h}x{w}", flush=True)
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
    if launches["GEOREF_CELLS"] != N_FRAMES:
        raise AssertionError(f"GEOREF_CELLS launched {launches['GEOREF_CELLS']}"
                             f" times for {N_FRAMES} frames, not once each")

    for i, ((count, means), img, m) in enumerate(zip(results, frames, masks)):
        if count.shape != (grid.n_lat, grid.n_lon) or \
                means.shape != (grid.n_lat, grid.n_lon, 4):
            raise AssertionError(f"frame {i}: shapes {count.shape} {means.shape}")
        # the reference's cells from the eager chain, not the kernel
        fiy, fix, fout = georegrid_inputs_plain(grid, dyn, h, w, m)
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
              f"[{lo:.3f}, {hi:.3f}], == the eager chain + plain binning; "
              f"GEOREF_CELLS launched once a frame", flush=True)

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

    planes = cell_planes(h, w, dev)
    gc_ms, gc_plain_ms, gc_runs, gc_plain_runs = in_turns(
        torch, lambda: georef_cells(grid, dyn, *planes),
        lambda: georegrid_inputs_plain(grid, dyn, h, w))
    del planes
    gc_bytes = 12 * h * w  # iy, ix and the elevation written
    print(f"[5] GEOREF_CELLS {gc_ms:.4f} ms vs the eager chain "
          f"{gc_plain_ms:.3f} ms (runs {[round(t, 4) for t in gc_runs]} / "
          f"{[round(t, 3) for t in gc_plain_runs]}); bound "
          f"{bound_ms(gc_bytes):.4f} ms ({gc_bytes} bytes at 3.35 TB/s); on "
          f"{card}", flush=True)

    rows = [kernel_row("georegrid_bin (K1)",
                       "auromat_tpu_torch/ops/csrc/georegrid_bin.cu",
                       "auromat_tpu/ops/georegrid.py:65", launches["K1"],
                       k1_err, k1_ms, plain_ms, k1_bytes, lib_ms),
            kernel_row("georef_cells (GEOREF_CELLS)",
                       "auromat_tpu_torch/ops/csrc/georef_cells.cu",
                       "none (XLA's fusion of auromat_tpu/ops/georef.py::"
                       "georef_latlon_dyn and the cells)",
                       launches["GEOREF_CELLS"], gc_err, gc_ms, gc_plain_ms,
                       gc_bytes, None)]
    rows += slice_phases(torch, np, builds, grid, iy, ix, out, card)
    del iy, ix, out, elev, k_args
    rows.append(mosaic_phases(torch, np, card))
    tile_path_phases(torch, np, grid, card)
    rows.append(asi_phases(torch, np, card))
    rows += magnetic_generic_phases(torch, np, card)
    rows.append(iss_phases(torch, np, card, k1_ms))
    rows += solving_phase(torch, np, card)
    rows.append(drawing_phase(torch, np, card))

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
