"""Reduction of a ``torch.profiler`` trace of the traced window to what the
per-layer readers and the result line need: the device's busy time, the
time of each device operation, and the idle gaps labelled by what the host
was doing meanwhile."""

import re
from dataclasses import dataclass, field

WINDOW_SPAN = "bench.window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)  # (name, seconds), one a launch
    copies: list = field(default_factory=list)  # memcpy / memset: (name, seconds)
    idle_gaps: list = field(default_factory=list)  # (host activity, seconds)

    def kernel_seconds(self, match):
        """Total seconds of the kernels whose name ``match`` accepts."""
        return sum(s for n, s in self.kernels if match(n))

    def device_ops(self, top=10):
        """The device operations that took most time: [[name, seconds]]."""
        tot = {}
        for n, s in self.kernels + self.copies:
            tot[n] = tot.get(n, 0.0) + s
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def gaps_by_host(self, top=10):
        """Idle seconds summed by what the host was doing: [[label, seconds]]."""
        tot = {}
        for label, s in self.idle_gaps:
            tot[label] = tot.get(label, 0.0) + s
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_label(cpu, t):
    """The innermost host event running at time ``t`` (us), else idle."""
    best = None
    for a, b, name in cpu:
        if a > t:
            break
        if b >= t and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "host between calls"


def summarize(events, gap_labels=200):
    """A :class:`Trace` of profiler ``events`` (``prof.events()``) over the
    ``bench.window`` span; None if the trace holds no device activity."""
    from torch.autograd import DeviceType

    win = [e for e in events if e.name == WINDOW_SPAN and e.device_type == DeviceType.CPU]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    kernels, copies, spans, cpu = [], [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.is_user_annotation or b < w0 or a > w1:
                continue
            a, b = max(a, w0), min(b, w1)
            (copies if re.match(r"(Memcpy|Memset)", e.name) else kernels).append(
                (e.name, (b - a) / 1e6))
            spans.append((a, b))
        elif e.device_type == DeviceType.CPU and e.name != WINDOW_SPAN and b >= w0 and a <= w1:
            cpu.append((a, b, e.name))
    if not spans:
        return None
    busy = _merge(spans)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    cpu.sort()
    labelled = [(_host_label(cpu, (a + b) / 2), (b - a) / 1e6) for a, b in gaps[:gap_labels]]
    rest = sum(b - a for a, b in gaps[gap_labels:]) / 1e6
    if rest:
        labelled.append(("shorter gaps", rest))
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=sum(b - a for a, b in busy) / 1e6,
                 kernels=kernels, copies=copies, idle_gaps=labelled)
