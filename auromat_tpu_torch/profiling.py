"""Tracing and per-stage timing on CUDA.

Counterpart of ``auromat_tpu.profiling``. The reference scatters
wall-clock prints through its hot paths (mapping.py:1125,
transform.py:335, astrometry.py:264). Here timing is structured: a
:class:`StageTimer` collects named stage durations, :func:`device_trace`
records a ``torch.profiler`` trace (a Chrome trace file), and
:func:`benchmark` times a callable with CUDA events when its output lies on
a CUDA device, by the host clock otherwise.
"""

import contextlib
import os
import statistics
import time
from collections import defaultdict

import torch


def _first_tensor(out):
    """The first tensor in ``out`` (a tensor, or nested lists, tuples and
    dicts of them), or None."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def _sync(out):
    """Wait until the device of the first tensor in ``out`` is done."""
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class _StageHandle:
    def __init__(self, enabled):
        self.enabled = enabled

    def sync(self, out):
        """Wait for the device that holds ``out``'s first tensor, so the
        stage's time includes its device work; returns ``out``."""
        if self.enabled:
            _sync(out)
        return out


class StageTimer:
    """Collects named wall-clock stage timings.

    Usage::

        timer = StageTimer()
        with timer("georef") as stage:
            out = georeference(...)
            stage.sync(out)
        print(timer.report())
    """

    def __init__(self, sync=True):
        self.times = defaultdict(list)
        self.sync = sync

    @contextlib.contextmanager
    def __call__(self, name):
        """Time a stage. CUDA work is asynchronous: pass the stage's OUTPUT
        to the yielded handle's ``sync`` so the stage ends when the device
        is done with it; without it the stage measures the enqueue."""
        handle = _StageHandle(self.sync)
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            self.times[name].append(time.perf_counter() - t0)

    def total(self, name):
        return sum(self.times[name])

    def report(self):
        lines = []
        for name, ts in self.times.items():
            total = sum(ts)
            lines.append(
                f"{name}: {total*1e3:.2f} ms total, {len(ts)} calls, "
                f"{total/len(ts)*1e3:.2f} ms avg"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir):
    """Record a ``torch.profiler`` trace of the block (the CPU, and CUDA
    where torch finds it) into ``log_dir/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto).

    Counterpart of the reference's cProfile harness
    (auromat/test/profiling.py:16-73).
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def benchmark(fn, *args, iters=10, warmup=2):
    """Median time of ``fn(*args)`` in seconds.

    When the first tensor of the output lies on a CUDA device, each call is
    timed with CUDA events on the current stream (the device's time from
    the enqueue of the first to the end of the last of its work); otherwise
    by the host clock. At least one warm-up call is made.

    :returns: (median_seconds, all_times)
    """
    for _ in range(max(warmup, 1)):  # the last one shows the device
        out = fn(*args)
        _sync(out)
    t = _first_tensor(out)
    times = []
    if t is not None and t.device.type == "cuda":
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            _sync(fn(*args))
            times.append(time.perf_counter() - t0)
    return float(statistics.median(times)), times


def annotate(name):
    """Named range visible in ``torch.profiler`` traces."""
    return torch.profiler.record_function(name)
