"""The port's tracing and timing helpers (auromat_tpu_torch.profiling) on
the CPU, after tests/test_debug_igrf_profiling.py: ``StageTimer`` (with
and without the handle's sync), ``benchmark`` (host clock for CPU
outputs, nested outputs, at least one warm-up), ``annotate`` and
``device_trace`` (a Chrome trace holding the annotated range). The CUDA
event route runs in tests/test_torch_gpu.py and chip_smoke.py."""

import json
import os

import torch

from auromat_tpu_torch.profiling import (StageTimer, annotate, benchmark,
                                         device_trace)


def test_stage_timer():
    t = StageTimer(sync=False)
    with t("a"):
        _ = torch.ones(8, 8) @ torch.ones(8, 8)
    with t("a") as stage:
        assert stage.sync({"x": [torch.ones(2)]})["x"][0].shape == (2,)
    with t("b"):
        pass
    assert t.total("a") >= 0.0 and len(t.times["a"]) == 2
    rep = t.report()
    assert "a:" in rep and "2 calls" in rep and "b:" in rep
    synced = StageTimer()
    with synced("c") as stage:
        out = stage.sync((None, torch.arange(4) + 1))
    assert out[1].tolist() == [1, 2, 3, 4] and synced.total("c") >= 0.0


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
        with annotate("auromat_stage"):
            _ = torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / "trace.json"
    assert os.path.exists(path)
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "auromat_stage" in names
