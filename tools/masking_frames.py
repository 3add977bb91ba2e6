"""Star-field masking of the two checked-in ISS frames, on the host and on
the card.

The card's machine has neither PIL nor OpenCV, so this runs in two steps:

    python tools/masking_frames.py prepare DIR   # where PIL and cv2 are
    python tools/masking_frames.py card DIR      # on the card

``prepare`` decodes tests/resources/ISS030-E-102170_dc.jpg and
ISS029-E-8492.jpg with ``io.image.load_image`` into DIR/<name>.npy and
mask_starfield's Hough input of each (computed by the port on the CPU)
into DIR/<name>_hough.npz, and prints host times (median of 3):
``cv2.HoughLinesP`` on that input, ``_hough_p_plain`` on it (and whether
their lines are equal), the JAX package's ``mask_starfield`` (OpenCV) and
the port's on the CPU.

``card`` prints, for each frame: HOUGH_P against ``_hough_p_plain`` on the
Hough input (lines equal, and the four trajectory counts: voters,
triggers, clearing steps, lines), the kernel's time (CUDA events, median
of 5, a fresh mask and accumulator each run), HOUGH_ORDER's time (the
visit order on the card, median of 5) and the wrapper's wall time; for
each binarization of the frame (tests/resources/contour_input_*.npz) the
contour stage on the card: CCL4, CCL8 and CONTOUR_TRACE (CUDA events,
median of 5) and the stage's wall time (``external_contours`` and
``_label_mask``, median of 3); and ``mask_starfield(device='cuda')``
against the executed reference's golden_masking_*.npz (pixels apart,
sigma), its wall time (median of 3) beside the 1050.9 / 7385.5 ms the
same call took with the contours on the host (NVIDIA H100 80GB HBM3,
700 W).
"""

import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
RES = os.path.join(ROOT, "tests", "resources")
FRAMES = ("ISS030-E-102170_dc", "ISS029-E-8492")
HOUGH = (1, math.pi / 180, 200, 100, 4)
# mask_starfield's wall ms on the card when its contours ran on the host
# (NVIDIA H100 80GB HBM3, 700 W)
HOST_CONTOURS_MS = {"ISS030-E-102170_dc": 1050.9, "ISS029-E-8492": 7385.5}


def median_s(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def events_ms(fn, reps=5):
    """Median CUDA-event ms of ``fn()`` over ``reps`` runs."""
    import torch

    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end))
    return statistics.median(runs)


def prepare(folder):
    import cv2
    import torch

    from auromat_tpu.solving import masking as jmasking
    from auromat_tpu_torch.io.image import load_image
    from auromat_tpu_torch.solving import masking

    os.makedirs(folder, exist_ok=True)
    for name in FRAMES:
        path = os.path.join(RES, f"{name}.jpg")
        rgb = load_image(path)
        np.save(os.path.join(folder, f"{name}.npy"), rgb)
        gray = masking._gray(torch.from_numpy(np.array(rgb)), None)
        mask, _ = masking._dark_area_mask(gray, True)
        hin = masking._line_candidates(gray * mask, mask).numpy()
        np.savez_compressed(os.path.join(folder, f"{name}_hough.npz"), b=hin)
        cv_s, cv_lines = median_s(lambda: cv2.HoughLinesP(
            hin.copy(), *HOUGH[:3], minLineLength=HOUGH[3],
            maxLineGap=HOUGH[4]).reshape(-1, 4))
        plain_s, lines = median_s(lambda: masking._hough_p_plain(hin, *HOUGH), 1)
        jax_s, _ = median_s(lambda: jmasking.mask_starfield(path))
        port_s, _ = median_s(lambda: masking.mask_starfield(path, device="cpu"),
                             1)
        print(f"{name}: {int((hin > 0).sum())} candidate pixels, "
              f"{len(lines)} lines, == cv2.HoughLinesP: "
              f"{np.array_equal(lines, cv_lines)}; host s: cv2.HoughLinesP "
              f"{cv_s:.3f}, _hough_p_plain {plain_s:.2f}, mask_starfield "
              f"JAX (cv2) {jax_s:.2f}, port (CPU) {port_s:.2f}", flush=True)


def card(folder):
    import torch

    from auromat_tpu_torch.ops import _kernels
    from auromat_tpu_torch.solving import masking

    if not torch.cuda.is_available():
        raise SystemExit("masking_frames card: torch finds no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    import chip_smoke

    for k in (_kernels.HOUGH_P, _kernels.HOUGH_ORDER, _kernels.CCL8,
              _kernels.CCL4, _kernels.CONTOUR_TRACE):
        k.build()

    for name in FRAMES:
        for fudge, binary in chip_smoke.contour_input(np, name).items():
            g = torch.from_numpy(binary).to(dev)
            roots, _, borders = masking.external_contours(g)
            filled = masking._fill_holes(g, masking.ccl(g, 4, fg=False)).to(
                torch.uint8)
            ccl4 = events_ms(lambda: masking.ccl(g, 4, fg=False))
            ccl8 = events_ms(lambda: masking.ccl(filled, 8))
            trace = events_ms(lambda: masking._contour_trace_cuda(g, roots))

            def stage():
                masking._label_mask(binary.shape, masking.external_contours(g),
                                    True)
                torch.cuda.synchronize()

            stage_s, _ = median_s(stage)
            print(f"{name} fudge {fudge}: {len(roots)} external contours, "
                  f"the longest {int(borders.length.max())} steps; card ms "
                  f"CCL4 {ccl4:.3f}, CCL8 {ccl8:.3f}, CONTOUR_TRACE "
                  f"{trace:.3f}; contour stage wall {stage_s * 1e3:.2f} ms",
                  flush=True)
    for name in FRAMES:
        hin = np.load(os.path.join(folder, f"{name}_hough.npz"))["b"]
        want_counts, counts = {}, {}
        want = masking._hough_p_plain(hin, *HOUGH, counters=want_counts)
        b = torch.from_numpy(hin).to(dev)
        got = masking.hough_lines_p(b, *HOUGH, counters=counts)
        a = masking._hough_p_args(b, *HOUGH)
        mask0 = a["mask"].clone()
        runs = []
        for _ in range(5):
            a["mask"].copy_(mask0)
            a["acc"].zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            masking._hough_p_launch(a)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end))
        order_ms = events_ms(lambda: masking._hough_order_cuda(a["count"],
                                                               dev))

        def wrapper():
            out = masking.hough_lines_p(b, *HOUGH)
            torch.cuda.synchronize()
            return out

        wrap_s, _ = median_s(wrapper)
        rgb = np.load(os.path.join(folder, f"{name}.npy"))
        golden = np.load(os.path.join(RES, f"golden_masking_{name}.npz"))

        def mask_card():
            out = masking.mask_starfield(rgb, device=dev)
            torch.cuda.synchronize()
            return out

        mask_card()
        wall_s, (m, sigma) = median_s(mask_card)
        print(f"{name}: HOUGH_P == _hough_p_plain: "
              f"{np.array_equal(got, want) and counts == want_counts} "
              f"({len(got)} lines, {a['count']} candidate pixels, counts "
              f"{counts}); kernel {statistics.median(runs):.1f} ms (runs "
              f"{[round(r, 1) for r in runs]}), HOUGH_ORDER "
              f"{order_ms:.3f} ms, wrapper wall "
              f"{wrap_s * 1e3:.1f} ms; mask_starfield on the card: "
              f"{int((m != golden['mask']).sum())} pixels from the golden, "
              f"sigma {sigma} (golden {float(golden['sigma'])}), wall "
              f"{wall_s * 1e3:.1f} ms (with the contours on the host: "
              f"{HOST_CONTOURS_MS[name]} ms)", flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("prepare", "card"):
        raise SystemExit(__doc__)
    {"prepare": prepare, "card": card}[sys.argv[1]](sys.argv[2])
