"""The benchmark's driver: finds a cell's files by name, sets the program
up, drives one closed-loop client for the window, checks what the program
produced against the reference and prints the result line.

Everything that belongs to one configuration, traffic mix, path, metric or
cell is a file of its own, found by the name ``BENCHMARK.json`` gives:

    benchmark/configs/<config>.json     sizes, inputs, precision, source
    benchmark/traffic/<traffic>.json    the closed loop's parameters
    benchmark/workloads/<cell>.json     path and limits of each number checked
    benchmark/paths/<path>.py           set-up, one request, the check
    benchmark/end_to_end/<metric>.py    ``read(run) -> number | None``
    benchmark/layer_metrics/<metric>.py ``read(run) -> number | None``
"""

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import random
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")  # build and kernel caches stay in the checkout


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    name = "bench_" + os.path.relpath(path, HERE).replace(os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict  # benchmark/workloads/<cell>.json
    path: object  # the path driver module
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name, root=ROOT):
    """The :class:`Cell` of workload ``name``: its entry in ``BENCHMARK.json``
    and the configuration, traffic, cell and path files that entry names."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = os.path.join(root, "benchmark")
    spec = load_json(os.path.join(here, "workloads", f"{name}.json"))
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(here, "traffic", f"{entry['traffic']}.json")),
        spec=spec, path=load_module(os.path.join(here, "paths", f"{spec['path']}.py")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(kind, name, root=ROOT):
    """``read`` of ``benchmark/<kind>/<name>.py``."""
    return load_module(os.path.join(root, "benchmark", kind, f"{name}.py")).read


@dataclass
class Run:
    """What a run measured: the readers' only input."""

    cell: Cell
    device: object
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    frames_per_request: int = 1
    peak_window_bytes: int = 0
    spans: dict = field(default_factory=dict)  # name -> [seconds], traced run
    trace: object = None  # tracing.Trace of the traced window
    work: dict = field(default_factory=dict)  # per-request work from shapes
    handwritten: tuple = ()  # names of the program's hand-written kernels
    card: str = ""
    kept: list = field(default_factory=list)  # indices of the answers checked

    @property
    def requests(self):
        return len(self.latencies_s)

    @property
    def frames(self):
        return self.requests * self.frames_per_request


class Spans:
    """Host spans the paths open around calls into a layer; each ends after
    a device synchronize, so it holds the layer's device work too."""

    def __init__(self, sync, record):
        self.sync, self.record, self.times = sync, record, {}

    @contextlib.contextmanager
    def __call__(self, name):
        with self.record(f"bench.{name}"):
            t0 = time.perf_counter()
            yield
            self.sync()
            self.times.setdefault(name, []).append(time.perf_counter() - t0)


def handwritten_kernels():
    """Names of the ``__global__`` functions in the program's CUDA sources."""
    import re

    csrc = os.path.join(ROOT, "auromat_tpu_torch", "ops", "csrc")
    # the identifier before the parameter list, after any __launch_bounds__(...)
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                      r"\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    names = set()
    for f in sorted(os.listdir(csrc)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f)) as fh:
                names |= set(decl.findall(fh.read()))
    return tuple(sorted(names))


def _cuda_tensors(out):
    """The CUDA tensors in ``out`` (nested tuples, lists and dicts), in order."""
    import torch

    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, tuple | list):
        return [t for x in out for t in _cuda_tensors(x)]
    return [out] if isinstance(out, torch.Tensor) and out.is_cuda else []


def _keep(out, slot):
    """``out`` with its CUDA tensors, in :func:`_cuda_tensors`' order, copied
    into the tensors of ``slot``."""
    import torch

    if isinstance(out, dict):
        return {k: _keep(v, slot) for k, v in out.items()}
    if isinstance(out, tuple | list):
        return type(out)(_keep(x, slot) for x in out)
    if isinstance(out, torch.Tensor) and out.is_cuda:
        return next(slot).copy_(out)
    return out


def card_line():
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def drive(cell, seed, seconds, trace, device, t0, shrink=1, fault=None):
    """Set up, warm up, run the window and check; returns (result, run).

    ``fault`` is handed the path's state after set-up and may replace the
    request it makes: the control and the tests' planted faults.
    """
    import torch

    from benchmark import tracing
    from benchmark.modcheck import forbidden_modules

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run = Run(cell=cell, device=dev, seed=seed)
    spans = Spans(sync, torch.profiler.record_function)
    state = cell.path.setup(cell.config, cell.traffic, dev, seed, shrink, spans)
    if fault is not None:
        fault(state)
    run.frames_per_request = state.frames_per_request
    # warm-up: every request of the window has the same shapes; one answer
    # is held at a time, as in the window
    warm = None
    for i in range(cell.traffic["warm"]):
        del warm
        warm = state.request(i)
        sync()
    spans.times.clear()
    k = cell.traffic["check_sample"]
    slots, slot_bytes = [], 0
    if cuda:
        run.card = card_line()
        run.handwritten = handwritten_kernels()
        setup_peak = torch.cuda.max_memory_allocated(dev)
        # the answers the check keeps are copied into slots made before the
        # window: no allocation of the check's falls in it, and its peak,
        # less the slots, is the program's
        a0 = torch.cuda.memory_allocated(dev)
        slots = [[torch.empty_like(t) for t in _cuda_tensors(warm)] for _ in range(k)]
        slot_bytes = torch.cuda.memory_allocated(dev) - a0
    del warm
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = time.perf_counter() - t0

    # the answers the check compares, drawn from the seed: a traced window
    # is a count of requests, and k of those are drawn; otherwise a time in
    # each of k equal parts of the window's first half, and the request running
    # at that time (or the first to start after it) is kept
    n_trace = cell.traffic["trace_requests"] if trace else None
    rng = random.Random(seed * 7919 + 17)
    due = (sorted(rng.sample(range(n_trace), min(k, n_trace))) if n_trace
           else [(j + rng.random()) * seconds / 2 / k for j in range(k)])
    kept, failed, attempted = [], 0, 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    with torch.profiler.record_function(tracing.WINDOW_SPAN):
        start = time.perf_counter()
        end = start + seconds
        i = 0
        while True:
            r0 = time.perf_counter()
            attempted += 1
            try:
                with torch.profiler.record_function("bench.request"):
                    out = state.request(i)
                    sync()
            except Exception as exc:  # a request that fails counts as failed
                failed += 1
                print(f"request {i} failed: {exc!r}", file=sys.stderr)
                out = None
            r1 = time.perf_counter()
            now = i if n_trace else r1 - start
            if due and now >= due[0]:
                while due and now >= due[0]:
                    due.pop(0)
                if out is not None:
                    kept.append((i, _keep(out, iter(slots[len(kept)])) if slots else out))
            if out is not None:
                run.latencies_s.append(r1 - r0)
            del out
            i += 1
            if r1 >= end or (n_trace and i >= n_trace):
                break
        run.window_s = r1 - start
    if prof is not None:
        prof.__exit__(None, None, None)
    if cuda:
        run.peak_window_bytes = torch.cuda.max_memory_allocated(dev) - slot_bytes
        peak = max(setup_peak, run.peak_window_bytes)
    run.spans = dict(spans.times)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    if prof is not None:
        run.trace = tracing.summarize(prof.events())
        del prof

    # the program's state goes before the reference runs
    state.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    run.kept = [i for i, _ in kept]
    checks, run.work = state.check(kept)
    limits = cell.spec["limits"]
    checks = {k: checks.get(k, math.inf) for k in limits}  # no answer checked: inf
    correct = failed == 0 and all(checks[k] <= limits[k] for k in limits)

    metrics = {}
    kind = "layer_metrics" if trace else "end_to_end"
    for m in cell.per_layer if trace else cell.end_to_end:
        v = metric_reader(kind, m["name"])(run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics}
    if cuda:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                            "count": cell.chips, "memory_peak_bytes": int(peak)}
        if trace and run.trace is not None:
            result["device"]["busy_s"] = run.trace.busy_s
            result["device"]["window_s"] = run.trace.window_s
            result["breakdown"] = {"device_ops": run.trace.device_ops(),
                                   "idle_gaps": run.trace.gaps_by_host()}
    result["checks"] = {k: {"value": _json_number(checks[k]), "limit": limits[k]}
                        for k in limits}
    return result, run


def main(argv, t0):
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # kernel caches a later version of the program may use stay in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(CACHE, sub))
    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, run = drive(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    print(f"card: {run.card}; {run.requests} requests in {run.window_s:.3f} s",
          file=sys.stderr)
    for k, v in result["checks"].items():
        ok = "ok" if isinstance(v["value"], float | int) and v["value"] <= v["limit"] else "FAILS"
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r}) {ok}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0


def _json_number(x):
    """A reading as JSON holds it: an infinite or NaN one as text."""
    return x if math.isfinite(x) else str(x)


def quantile(values, q):
    """The ``q``-th percentile (1..99) of ``values`` by ``statistics.quantiles``
    (n=100, exclusive method); the value itself for fewer than two."""
    if len(values) < 2:
        return values[0] if values else math.nan
    return statistics.quantiles(values, n=100)[q - 1]
