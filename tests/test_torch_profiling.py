"""The port's spans, traces and timing (auromat_tpu_torch.profiling) on
the CPU, after tests/test_debug_igrf_profiling.py: ``span`` off (one shared
no-op, nothing recorded) and on (under ``torch.profiler`` and in
``recording``), the windows, self times, the profiler's timeline and the
benchmark's gap labeller reading it, ``benchmark`` (host clock for CPU
outputs, nested outputs, at least one warm-up), ``device_trace`` (a Chrome
trace holding the spans), and the spans the three benchmarked paths open,
in order. The CUDA routes (stream times, copied bytes) run in
tests/test_torch_gpu.py and chip_smoke.py."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from auromat_tpu_torch import profiling
from auromat_tpu_torch.profiling import (benchmark, device_trace, recording,
                                         span, spans)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark import tracing  # noqa: E402  (the gap labeller the benchmark uses)

RES = os.path.join(ROOT, "tests", "resources")


def _outer_inner():
    """Two nested spans, each holding a torch op and a sleep."""
    with span("outer", nbytes=5):
        _ = torch.ones(16, 16) @ torch.ones(16, 16)
        time.sleep(0.02)
        with span("outer.inner"):
            _ = torch.ones(8) + 1
            time.sleep(0.02)
    with span("second"):
        pass


def test_benchmark():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x + 1}

    med, times = benchmark(fn, torch.ones(4), iters=3, warmup=1)
    assert med >= 0.0 and len(times) == 3 and len(calls) == 4
    calls.clear()
    med, times = benchmark(fn, torch.ones(4), iters=2, warmup=0)
    assert len(times) == 2 and len(calls) == 3  # one warm-up all the same
    med, times = benchmark(lambda: None, iters=2)
    assert len(times) == 2 and med >= 0.0


def test_annotate_and_device_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")):
        with span("auromat_stage"):
            _ = torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / "trace.json"
    assert os.path.exists(path)
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "auromat_stage" in names
    assert [s.name for s in spans()] == ["auromat_stage"]


def test_span_off_is_one_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    with recording():
        pass
    off = span("a")
    assert off is span("b", stream=torch.device("cpu"), nbytes=3)
    with off as s:
        assert s is None
    assert spans() == []  # the last window, untouched by spans while off

    def loop_s(with_span, n=100_000):
        """The CPU time of this thread (not the wall: the tests share the
        host's cores) of the least loaded of five loops of ``n``."""
        best = float("inf")
        for _ in range(5):
            t0 = time.thread_time()
            if with_span:
                for _ in range(n):
                    with span("x"):
                        pass
            else:
                for _ in range(n):
                    pass
            best = min(best, time.thread_time() - t0)
        return best / n

    cost = loop_s(True) - loop_s(False)  # an off span, less the loop's own step
    assert cost < 1e-6, f"{cost * 1e9:.0f} ns an off span"
    assert spans() == []


def test_spans_under_the_profiler_reach_its_timeline():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _outer_inner()
    got = spans()
    assert [(s.name, s.parent, s.trace, s.nbytes) for s in got] == [
        ("outer", -1, 0, 5), ("outer.inner", 0, 0, None), ("second", -1, 1, None)]
    assert all(s.start_ns < s.end_ns and s.device_ms is None for s in got)
    assert got[0].start_ns < got[1].start_ns <= got[1].end_ns < got[0].end_ns
    assert got[1].ms >= 20.0 and got[0].ms >= 40.0
    self_ms = profiling.self_times()
    roots = sum(s.ms for s in got if s.parent < 0)
    assert sum(self_ms.values()) == pytest.approx(roots, abs=1e-9)
    assert self_ms["outer"] == pytest.approx(got[0].ms - got[1].ms, abs=1e-9)
    assert "outer: 1 calls" in profiling.report() and "0.000 MB copied" in profiling.report()

    # the same names, nested, in the profiler's events; its gap labeller
    # names a moment in each span's sleep by that span
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    by_name = {e.name: e for e in events}
    outer, inner = by_name["outer"], by_name["outer.inner"]
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "outer"
    cpu = sorted((e.time_range.start, e.time_range.end, e.name) for e in events)
    mm = next(e for e in events if e.name == "aten::mm")
    in_outer = (mm.time_range.end + inner.time_range.start) / 2
    add = next(e for e in events if e.name == "aten::add")
    in_inner = (add.time_range.end + inner.time_range.end) / 2
    assert tracing._host_label(cpu, in_outer) == "outer"
    assert tracing._host_label(cpu, in_inner) == "outer.inner"


def test_a_second_profiler_session_starts_a_fresh_window():
    with profile(activities=[ProfilerActivity.CPU]):
        _outer_inner()
    assert len(spans()) == 3
    with profile(activities=[ProfilerActivity.CPU]):
        with span("only"):
            pass
    assert [(s.name, s.trace) for s in spans()] == [("only", 0)]


def test_recording_without_the_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    with recording() as rec:
        _outer_inner()
        with recording() as nested:  # the same window
            with span("in_nested", stream=torch.device("cpu"), nbytes=0):
                pass
    assert nested is rec
    got = rec.spans()
    assert [s.name for s in got] == ["outer", "outer.inner", "second", "in_nested"]
    assert got[-1].nbytes == 0 and got[-1].device_ms is None
    assert [s.name for s in spans()] == [s.name for s in got]
    with span("after"):  # off again
        pass
    with recording() as fresh:
        pass
    assert fresh is not rec and fresh.spans() == [] and len(rec.spans()) == 4


# -- the spans of the benchmarked paths, on the CPU at small sizes ----------

GRID_ARGS = ((36, 25), 47.0, 62.0, -112.0, -91.0)


def _small_header(w=128, h=96):
    from auromat_tpu_torch.io import fits

    header = dict(fits.read_header(os.path.join(RES, "ISS030-E-102170_dc.wcs")))
    scale = header["IMAGEW"] / w
    for k in ("CD1_1", "CD1_2", "CD2_1", "CD2_2"):
        header[k] = header[k] * scale
    header["CRPIX1"], header["CRPIX2"] = header["CRPIX1"] / scale, header["CRPIX2"] / scale
    header["IMAGEW"], header["IMAGEH"] = w, h
    return header


def _small_frames(n):
    from auromat_tpu_torch.coordinates.wcs import TanWcs
    from auromat_tpu_torch.io import fits
    from auromat_tpu_torch.ops.georef import GeorefParams

    header = _small_header()
    params = GeorefParams.from_wcs(
        TanWcs(header), fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_shifted_photo_time(header), altitude=110.0)
    imgs = np.random.default_rng(5).integers(0, 256, (n, 96, 128, 3)).astype(np.uint8)
    return params, imgs


def _fused():
    from auromat_tpu_torch.ops.georef import DynGeorefParams
    from auromat_tpu_torch.ops.georegrid import georegrid_mean
    from auromat_tpu_torch.ops.regrid import fixed_grid

    params, imgs = _small_frames(1)
    dyn = DynGeorefParams.from_static(params, device="cpu", dtype=torch.float32)
    img = torch.from_numpy(imgs[0]).permute(2, 0, 1).float()
    return lambda: georegrid_mean(fixed_grid(*GRID_ARGS), dyn, img)


def _mosaic():
    from auromat_tpu_torch.ops.regrid import fixed_grid
    from auromat_tpu_torch.parallel.mosaic import mosaic_sequence
    from auromat_tpu_torch.parallel.sharding import make_mesh

    params, imgs = _small_frames(2)
    mesh = make_mesh(device="cpu")
    return lambda: mosaic_sequence(mesh, fixed_grid(*GRID_ARGS),
                                   [([params, params], imgs)], batch=2)


def _library():
    from auromat_tpu_torch.mapping.astrometry import create_mapping
    from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position
    from auromat_tpu_torch.resample import resample

    header = _small_header()
    pos, t, _ = resolve_camera_position(header)
    _, imgs = _small_frames(1)

    def request():
        m = create_mapping(header, imgs[0], pos, t, fast_center=False, device="cpu")
        # K1's route, as on the card ('auto' takes the float64 scatter here)
        return resample(m, arcsec_per_px=100, bin_method="pallas_rgbelev", device="cpu")

    return request


# (name, parent's name): on the CPU no K1 status word is read (no k1.wait)
# and no byte crosses between host and device
PATH_SPANS = {
    "fused": (_fused, [("georegrid", None), ("georegrid.georef", "georegrid"),
                       ("georegrid.bin_indices", "georegrid")]),
    "mosaic": (_mosaic, [("mosaic", None)]
               + [("georegrid.georef", "mosaic"), ("georegrid.bin_indices", "mosaic")] * 2
               + [("mosaic.finish", "mosaic"), ("mosaic.finish.wait", "mosaic.finish")]),
    "library": (_library, [
        ("create_mapping", None), ("create_mapping.to_host", "create_mapping"),
        ("create_mapping.masks", "create_mapping"), ("resample", None),
        ("resample.grid", "resample"), ("resample.prepare", "resample"),
        ("resample.to_device", "resample"), ("resample.bin", "resample"),
        ("georegrid", "resample.bin"), ("georegrid.bin_indices", "georegrid"),
        ("resample.to_host", "resample"), ("resample.finish", "resample")]),
}


@pytest.mark.parametrize("path", sorted(PATH_SPANS))
def test_each_benchmarked_path_records_its_spans_in_order(path):
    make, want = PATH_SPANS[path]
    request = make()
    request()  # off: nothing recorded
    with recording() as rec:
        request()
    got = rec.spans()
    assert [(s.name, got[s.parent].name if s.parent >= 0 else None)
            for s in got] == want
    roots = [s for s in got if s.parent < 0]
    assert [s.trace for s in roots] == list(range(len(roots)))
    assert all(s.trace == got[s.parent].trace for s in got if s.parent >= 0)
    assert all(s.device_ms is None for s in got)  # stream times need CUDA
    copies = [s for s in got if s.name.endswith((".to_host", ".to_device"))]
    assert all(s.nbytes == 0 for s in copies)
    assert all(s.nbytes is None for s in got if s not in copies)
