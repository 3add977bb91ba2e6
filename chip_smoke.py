#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (auromat_tpu_torch) on one NVIDIA GPU.

Drives the port's main path — georeference the real 12 MP ISS frame
ISS030-E-102170 (4256x2832) and mean-regrid it onto the 539x524 fixed grid
— through ``auromat_tpu_torch.entry``, and checks it:

1. the card (``nvidia-smi`` name and power limit);
2. builds every kernel of the path (K1, ``ops/csrc/georegrid_bin.cu``) from
   the sources in this checkout;
3. K1 against its plain PyTorch version on the card at the frame's shapes:
   all five outputs must be bit-equal;
4. the main path on a few frames (one masked), with the kernel launch
   counters zeroed just before and read just after: every kernel must have
   launched, the counts must equal the valid samples, the latitudes must
   cover the aurora over Canada, and the output must be bit-equal to the
   same path with the plain binning; the float64 chain on the card must
   match the executed-reference golden to < 1e-6 deg;
5. times (CUDA events, after warm-up): the main path per frame, K1 against
   its plain version.

Prints one line per phase, then a JSON line of per-kernel results, and
as the last line ``{"ok": true, "device": {...}}``. Any failure raises and
the exit code is nonzero; without a CUDA device it fails at once.

    python3 chip_smoke.py
"""

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 0
N_FRAMES = 3  # main-path requests; the last one is masked
N_TIMED = 20  # timed repetitions per measurement
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "resources", "golden_georef_ISS030-E-102170_dc.npz")


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

    # -- 2. build every kernel of the path --------------------------------
    kernels = {"K1": _kernels.GEOREGRID_BIN}
    for name, k in kernels.items():
        t0 = time.perf_counter()
        path = k.build()
        print(f"[2] built {name} ({k.source}) in {time.perf_counter() - t0:.2f} s "
              f"-> {os.path.relpath(path)}", flush=True)

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

    k1 = lambda: bin_rgbelev_from_indices(*k_args)
    plain = lambda: bin_rgbelev_plain(*k_args)
    k1(), plain()
    order = [plain, k1, k1, plain]  # in turns, on one card
    runs = {k1: [], plain: []}
    for f in order:
        runs[f].append(cuda_ms(torch, f, N_TIMED))
    k1_ms, plain_ms = statistics.median(runs[k1]), statistics.median(runs[plain])
    # the kernel alone, without the wrapper's zero-fill and f32 epilogue
    acc = torch.zeros(grid.n_lat * grid.n_lon, 4, dtype=torch.int32, device=dev)
    eacc = torch.zeros(grid.n_lat * grid.n_lon, dtype=torch.int64, device=dev)
    raw_ms = cuda_ms(torch, lambda: launch_k1(grid, iy, ix, frames[0], elev,
                                              acc, eacc), N_TIMED)
    print(f"[5] K1 wrapper {k1_ms:.3f} ms vs plain {plain_ms:.3f} ms "
          f"(runs {[round(t, 3) for t in runs[k1]]} / "
          f"{[round(t, 3) for t in runs[plain]]}); K1 kernel alone "
          f"{raw_ms:.3f} ms; on {card}", flush=True)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "georegrid_bin (K1)", "route": "cuda",
        "source": "auromat_tpu_torch/ops/csrc/georegrid_bin.cu",
        "replaces": "auromat_tpu/ops/georegrid.py:65",
        "launches": launches["K1"], "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
