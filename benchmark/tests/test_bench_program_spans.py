"""The readers of the program's own spans on the CPU: the library cell's
traced run at the tests' shrink reports its host stages, copies and bytes
(no byte crosses to a device here), every new per-layer entry finds its
reader by name, and a program without the recorder reports nothing."""

import json
import os
import sys
import time
import types

from benchmark import harness, program_spans

SPAN_METRICS = {"georef_device_ms", "bin_indices_device_ms", "host_wait_ms",
                "mosaic_finish_ms", "host_stage_ms", "copy_ms", "copy_mb"}


def test_every_span_metric_finds_its_reader_by_name():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert SPAN_METRICS <= entries.keys()
    cells = {w["name"] for w in bench["workloads"]}
    for name in SPAN_METRICS:
        assert set(entries[name]["workloads"]) <= cells
        assert callable(harness.metric_reader("layer_metrics", name))


def test_the_library_cell_reports_its_host_stages_and_copies():
    cell = harness.find_cell("iss030_library")
    result, run = harness.drive(cell, 2 ** 31 + 11, 300.0, True, "cpu",
                                time.perf_counter(), shrink=16)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    assert {"host_stage_ms", "copy_ms", "copy_mb"} <= got.keys()
    assert got["copy_mb"]["value"] == 0.0 and got["copy_mb"]["unit"] == "MB"
    assert 0 < got["copy_ms"]["value"] < got["host_stage_ms"]["value"]
    assert got["host_stage_ms"]["value"] < got["resample_ms"]["value"] + \
        got["create_mapping_ms"]["value"]
    # stream times and waits need the card
    for name in ("georef_device_ms", "bin_indices_device_ms", "host_wait_ms"):
        assert harness.metric_reader("layer_metrics", name)(run) is None
    names = [s.name for s in program_spans.of(run)]
    assert names.count("create_mapping") == names.count("resample") == run.requests


def test_a_program_without_the_recorder_reports_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "auromat_tpu_torch.profiling",
                        types.ModuleType("auromat_tpu_torch.profiling"))
    run = harness.Run(cell=None, device="cpu", seed=1, latencies_s=[0.1],
                      frames_per_request=1)
    for name in sorted(SPAN_METRICS):
        assert harness.metric_reader("layer_metrics", name)(run) is None
