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
visit order on the card, median of 5) and the wrapper's wall time, and
``mask_starfield(device='cuda')`` against the executed reference's
golden_masking_*.npz (pixels apart, sigma), its wall time (median of 3).
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


def median_s(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


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
    _kernels.HOUGH_P.build()
    _kernels.HOUGH_ORDER.build()
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
        order_runs = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            masking._hough_order_cuda(a["count"], dev)
            end.record()
            end.synchronize()
            order_runs.append(start.elapsed_time(end))

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
              f"{statistics.median(order_runs):.3f} ms, wrapper wall "
              f"{wrap_s * 1e3:.1f} ms; mask_starfield on the card: "
              f"{int((m != golden['mask']).sum())} pixels from the golden, "
              f"sigma {sigma} (golden {float(golden['sigma'])}), wall "
              f"{wall_s * 1e3:.1f} ms", flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("prepare", "card"):
        raise SystemExit(__doc__)
    {"prepare": prepare, "card": card}[sys.argv[1]](sys.argv[2])
