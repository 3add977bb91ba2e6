"""Spans, traces and timing of the port on CUDA.

Counterpart of ``auromat_tpu.profiling``. The reference scatters
wall-clock prints through its hot paths (mapping.py:1125,
transform.py:335, astrometry.py:264). Here the program opens named spans
at its layer boundaries with :func:`span`. They are recorded while a
``torch.profiler`` session is active or inside :func:`recording`, and cost
one check otherwise. :func:`spans` and :func:`report` read what the last
recording window holds. :func:`device_trace` records a ``torch.profiler``
trace (a Chrome trace file, the spans in it), and :func:`benchmark` times
a callable with CUDA events when its output lies on a CUDA device, by the
host clock otherwise.

A recorded span keeps its name, its start and end on
``time.perf_counter_ns``, the index of the span open when it opened (its
parent) and a trace id, which a root span draws and its descendants
share; ``nbytes`` counts the bytes a stage copies between host and
device, and ``counts`` holds the integer counts a stage adds to its span
with :meth:`Span.count` (the work it found: pixels visited, borders
traced). A span opened with ``stream=<a CUDA device>`` also records a CUDA
event pair on that device's current stream: the stage's time on the
stream, in-stage gaps included, read once the device has finished. Each
recorded span enters ``torch.profiler.record_function`` under its name
while a profiler session is active, so the profiler's timeline holds it on
the clock of the kernels and copies.

Usage::

    with profiling.recording() as rec:
        georegrid_mean(grid, dyn, img)
        torch.cuda.synchronize()
    print(rec.report())
"""

import contextlib
import dataclasses
import itertools
import os
import statistics
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span.

    :param parent: index in its window of the span open when it opened, -1
        for a root
    :param trace: the id its root drew; every descendant shares it
    :param nbytes: bytes the stage copied between host and device (None
        where the span does not count them)
    :param device_ms: the stage's time on its CUDA stream (None without
        ``stream`` or off CUDA), set by :meth:`Window.spans`
    :param counts: the integer counts the stage added (None where it added
        none)
    """

    name: str
    parent: int
    trace: int
    start_ns: int
    end_ns: int = 0
    nbytes: int | None = None
    device_ms: float | None = None
    counts: dict | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def ms(self):
        """Duration on the host's clock, ms."""
        return (self.end_ns - self.start_ns) / 1e6

    def count(self, **counts):
        """Add each integer of ``counts`` to the span's count of that name.
        A stage reaches its span as ``with span(...) as s``, where ``s`` is
        None while recording is off: it counts with ``if s is not None:
        s.count(...)``, so that an off span stays free."""
        if self.counts is None:
            self.counts = {}
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + int(v)


class Window:
    """The spans of one recording window, in the order they opened."""

    def __init__(self):
        self._spans = []
        self._trace_ids = itertools.count()

    def spans(self):
        """The window's spans, stream times resolved: a span whose device
        work has not finished waits for it."""
        for s in self._spans:
            if s.events is not None and s.end_ns:
                start, end = s.events
                end.synchronize()
                s.device_ms, s.events = start.elapsed_time(end), None
        return list(self._spans)

    def self_times(self):
        """Self time by span name, ms: each span's duration less what its
        children cover. They add up to the roots' durations."""
        spans = self.spans()
        own = [s.end_ns - s.start_ns for s in spans]
        for s in spans:
            if s.parent >= 0:
                own[s.parent] -= s.end_ns - s.start_ns
        out = {}
        for s, ns in zip(spans, own):
            out[s.name] = out.get(s.name, 0.0) + ns / 1e6
        return out

    def report(self):
        """One line a span name, most self time first: calls, self ms, and
        where recorded, device ms, MB copied and the counts."""
        spans = self.spans()
        rows = {}
        for s in spans:
            calls, dev, nbytes, counts = rows.get(s.name, (0, None, None, None))
            if s.device_ms is not None:
                dev = (dev or 0.0) + s.device_ms
            if s.nbytes is not None:
                nbytes = (nbytes or 0) + s.nbytes
            if s.counts is not None:
                counts = dict(counts or {})
                for k, v in s.counts.items():
                    counts[k] = counts.get(k, 0) + v
            rows[s.name] = (calls + 1, dev, nbytes, counts)
        lines = []
        by_self = sorted(self.self_times().items(), key=lambda kv: -kv[1])
        for name, ms in by_self:
            calls, dev, nbytes, counts = rows[name]
            line = f"{name}: {calls} calls, {ms:.3f} ms self"
            if dev is not None:
                line += f", {dev:.3f} ms on the stream"
            if nbytes is not None:
                line += f", {nbytes / 1e6:.3f} MB copied"
            if counts is not None:
                line += ", " + ", ".join(f"{k} {v}" for k, v in counts.items())
            lines.append(line)
        return "\n".join(lines)


class _Recorder:
    """The process's recording state: how many :func:`recording` blocks are
    open, the current window, and each thread's stack of open spans."""

    def __init__(self):
        self.depth = 0
        self.window = Window()
        self.local = threading.local()

    def on(self):
        return bool(self.depth or _autograd_profiler._is_profiler_enabled)

    def stack(self):
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


_REC = _Recorder()


_OFF = contextlib.nullcontext()  # every span while recording is off


class _Recorded:
    """The context manager of a span that records."""

    __slots__ = ("name", "stream", "nbytes", "window", "span", "function")

    def __init__(self, name, stream, nbytes):
        self.name, self.stream, self.nbytes = name, stream, nbytes

    def __enter__(self):
        window = self.window = _REC.window
        stack = _REC.stack()
        parent = stack[-1][1] if stack and stack[-1][0] is window else -1
        self.function = None
        if _autograd_profiler._is_profiler_enabled:
            self.function = torch.profiler.record_function(self.name)
            self.function.__enter__()
        trace = (window._spans[parent].trace if parent >= 0
                 else next(window._trace_ids))
        span = self.span = Span(self.name, parent, trace, 0,
                                nbytes=self.nbytes)
        if self.stream:
            dev = torch.device(self.stream)
            if dev.type == "cuda":
                stream = torch.cuda.current_stream(dev)
                span.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                span.events[0].record(stream)
                self.stream = stream
            else:
                self.stream = None
        stack.append((window, len(window._spans)))
        window._spans.append(span)
        span.start_ns = time.perf_counter_ns()
        return span

    def __exit__(self, *exc):
        span = self.span
        span.end_ns = time.perf_counter_ns()
        if span.events is not None:
            span.events[1].record(self.stream)
        if self.function is not None:
            self.function.__exit__(*exc)
        stack = _REC.stack()
        if stack and stack[-1][0] is self.window:
            stack.pop()
        return False


def span(name, *, stream=False, nbytes=None):
    """A context manager around one stage of the program, named ``name``.

    Off (no ``torch.profiler`` session, no :func:`recording` block) it is
    one shared no-op: no allocation, no clock read, and ``with`` gives
    None. On, it records a :class:`Span` in the current window, which
    ``with`` gives the stage (to add counts to).

    :param stream: False, or the device the stage's work runs on: on a
        CUDA device the span times the stage on that device's current
        stream too
    :param nbytes: the bytes the stage copies between host and device (0
        for a copy from CPU to CPU)
    """
    if _REC.depth or _autograd_profiler._is_profiler_enabled:
        return _Recorded(name, stream, nbytes)
    return _OFF


def _fresh_window():
    _REC.window = Window()


@contextlib.contextmanager
def recording():
    """Record the program's spans in the block, without the profiler.

    Yields the :class:`Window` the block records into: a fresh one unless
    recording was already on (an enclosing block, a profiler session)."""
    if not _REC.on():
        _fresh_window()
    _REC.depth += 1
    try:
        yield _REC.window
    finally:
        _REC.depth -= 1


def _watch_profiler_start():
    """Start a fresh window whenever a profiler session turns recording on:
    chained onto the hook torch's profilers call as a session starts."""
    start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
    if start is None or getattr(start, "starts_a_span_window", False):
        return

    def run_on_profiler_start():
        if not _REC.on():
            _fresh_window()
        start()

    run_on_profiler_start.starts_a_span_window = True
    _autograd_profiler._run_on_profiler_start = run_on_profiler_start


_watch_profiler_start()


def spans():
    """The spans of the current window (the last one once recording is
    off), in the order they opened, stream times resolved."""
    return _REC.window.spans()


def self_times():
    """:meth:`Window.self_times` of the current window."""
    return _REC.window.self_times()


def report():
    """:meth:`Window.report` of the current window."""
    return _REC.window.report()


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


@contextlib.contextmanager
def device_trace(log_dir):
    """Record a ``torch.profiler`` trace of the block (the CPU, and CUDA
    where torch finds it) into ``log_dir/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto) that holds the program's spans.

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
