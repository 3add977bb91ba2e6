"""Star-field masking of real ISS frames: one request is
``solving/masking.py::mask_starfield`` of the next frame of a ring (a host
uint8 RGB array, as a decoded frame arrives) with the configuration's
options, on the card, returning the host mask and the noise sigma.

The frames are the configuration's fixed real ones, the same pixels for
every seed: masking does data-dependent work (the Hough visit order and
walks, the contours, the dark-area fixpoint), so the seed picks only the
frame the ring starts at (and the harness the answers it checks). Each
request runs inside ``profiling.recording()``, so that its answer carries
the Hough trajectory's counts from the program's ``masking.lines`` span.

The check holds the harness's sample of answers and the window's last
answer of each frame (so both frames are checked in every run) against
the plain reference of their frame, run after the window:

- ``mask_px_off``: mask pixels that differ from the reference's;
- ``golden_px_off``: mask pixels that differ from the executed original's
  golden mask (a crop, which only the harness's CPU tests make, has no
  golden: the reference's mask stands in);
- ``sigma_rel_err``: the sigma's relative gap to the reference's;
- ``hough_counts_off``: the four trajectory counts' summed gap to the
  reference's (a program whose spans hold no counts is held to the rest).

Each is the worst over the answers checked. The work the check returns is
each hand-written kernel's least time over the window's requests
(``benchmark/roofline_masking.py``).
"""

import dataclasses
import math
import os

import numpy as np

from benchmark import roofline_masking
from benchmark.reference import masking as reference

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(config, shrink):
    """[(name, host RGB frame, golden mask or None)]. ``shrink`` > 1 (the
    harness's CPU tests) takes the top right corner of each frame, about
    1/shrink of its sides, cut to the blocks."""
    out = []
    for f in config["frames"]:
        gray = np.load(os.path.join(HERE, "configs", f["gray"]))["gray"]
        golden = np.load(os.path.join(HERE, "configs", f["golden"]))["mask"]
        if shrink > 1:
            h, w = gray.shape
            gray = gray[:h // shrink // 12 * 12, w - w // shrink // 16 * 16:]
            golden = None
        out.append((f["name"], np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=2)),
                    golden))
    return out


def _lines_counts(window):
    """The counts of the last ``masking.lines`` span of a recording window,
    None where there is none or it holds none."""
    for s in reversed(window.spans()):
        if s.name == "masking.lines":
            return getattr(s, "counts", None)
    return None


def _program_counts():
    """Whether the program's spans can hold counts."""
    from auromat_tpu_torch import profiling

    return "counts" in {f.name for f in dataclasses.fields(profiling.Span)}


class State:
    frames_per_request = 1

    def __init__(self, config, traffic, device, seed, shrink, spans):
        from auromat_tpu_torch.profiling import recording
        from auromat_tpu_torch.solving.masking import mask_starfield

        self.device, self.warm = device, traffic["warm"]
        self.options = dict(config["masking"])
        self.frames = _frames(config, shrink)
        self.first = seed % len(self.frames)
        self.served, self.last = [], {}

        def request(i):
            k = (self.first + i) % len(self.frames)
            with recording() as window:
                mask, sigma = mask_starfield(self.frames[k][1], device=device,
                                             **self.options)
            out = (mask, sigma, _lines_counts(window))
            self.served.append(k)
            self.last[k] = out
            return out

        self.request = request

    def release(self):
        self.request = None

    def use_control(self):
        """The reference in the program's place, its Hough votes in float16,
        one precision below the configuration's float32."""
        def control(i):
            k = (self.first + i) % len(self.frames)
            m = reference.mask_starfield(self.frames[k][1], self.device,
                                         votes=np.float16, **self.options)
            return m.mask, m.sigma, dict(m.counts)

        self.request = control

    def check(self, kept):
        ring = len(self.frames)
        answers = [((self.first + i) % ring, out) for i, out in kept]
        answers += sorted(self.last.items())
        refs = {k: reference.mask_starfield(rgb, self.device, **self.options)
                for k, (_, rgb, _) in enumerate(self.frames)}
        counted = _program_counts()
        worst = {"mask_px_off": 0.0, "golden_px_off": 0.0, "sigma_rel_err": 0.0,
                 "hough_counts_off": 0.0}
        for k, (mask, sigma, counts) in answers:
            ref, golden = refs[k], self.frames[k][2]
            golden = ref.mask if golden is None else golden
            got = {"mask_px_off": _px_off(mask, ref.mask),
                   "golden_px_off": _px_off(mask, golden),
                   "sigma_rel_err": _rel(sigma, ref.sigma),
                   "hough_counts_off": (_counts_off(counts, ref.counts) if counted
                                        else 0.0)}
            worst = {n: max(v, got[n]) for n, v in worst.items()}
        if not answers:
            worst = {}
        least = [roofline_masking.least_s(refs[k]) for k in range(ring)]
        window = self.served[self.warm:]
        work = {f"{kernel}_least_s": sum(least[k][kernel] for k in window)
                for kernel in roofline_masking.KERNELS}
        return worst, work


def _px_off(mask, want):
    mask = np.asarray(mask)
    if mask.shape != want.shape or mask.dtype != bool:
        return math.inf
    return float((mask != want).sum())


def _rel(x, want):
    x = float(x)
    return math.inf if math.isnan(x) else abs(x - want) / abs(want)


def _counts_off(counts, want):
    if not isinstance(counts, dict) or set(counts) != set(want):
        return math.inf
    return float(sum(abs(int(counts[k]) - want[k]) for k in want))


def setup(config, traffic, device, seed, shrink, spans):
    return State(config, traffic, device, seed, shrink, spans)
