"""The harness on the CPU at small sizes: files found by name, the module
guard, K1's byte count, and ``correct``: true for the program, false for
the control and for each fault a cell can have, planted under the timed
path."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness, tracing
from benchmark.modcheck import forbidden_modules
from benchmark.roofline import bound_s, k1_bytes

ROOT = harness.ROOT
# each cell's frames shrunk this many times. The window is the traced one,
# a count of requests whose answers are drawn by index, so that a loaded
# host cannot make the answers checked fewer than two
CELLS = {"iss030_fused": 16, "iss029_mosaic_seq16": 64, "iss030_library": 16}


def _drive(name, fault=None, root=ROOT, answers=2, traced=True):
    cell = harness.find_cell(name, root)
    result, run = harness.drive(cell, 2 ** 31 + 11, 300.0 if traced else 0.5, traced,
                                "cpu", time.perf_counter(),
                                shrink=CELLS.get(name, CELLS["iss030_fused"]), fault=fault)
    assert len(run.kept) >= answers
    return result, run


def test_every_cell_finds_its_files_by_name():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = harness.find_cell(w["name"])
        assert cell.chips == w["chips"] and cell.config["name"] == w["config"]
        assert set(cell.spec["limits"]) and callable(cell.path.setup)
        for m in cell.end_to_end + cell.per_layer:
            kind = "end_to_end" if m in cell.end_to_end else "layer_metrics"
            assert callable(harness.metric_reader(kind, m["name"]))
    with pytest.raises(KeyError):
        harness.find_cell("no_such_cell")


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    """A new traffic mix and cell, as data files and an entry, run unedited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append({"name": "iss030_fused_ring2", "config": "iss030_dslr_100as",
                               "traffic": "frame_ring2", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:  # reported as iss030_fused's are
        if "iss030_fused" in m.get("workloads", ()):
            m["workloads"].append("iss030_fused_ring2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.load(open(os.path.join(ROOT, "benchmark/traffic/frame_ring4.json")))
    (tmp_path / "benchmark/traffic/frame_ring2.json").write_text(json.dumps(traffic | {"ring": 2}))
    shutil.copy(os.path.join(ROOT, "benchmark/workloads/iss030_fused.json"),
                tmp_path / "benchmark/workloads/iss030_fused_ring2.json")
    result, run = _drive("iss030_fused_ring2", root=str(tmp_path), answers=1, traced=False)
    assert result["correct"] and run.cell.traffic["ring"] == 2
    assert set(result["metrics"]) == {"frame_ms", "request_p95_ms", "setup_s"}  # no peak: no card


def test_forbidden_modules_compare_whole_top_level_names():
    assert forbidden_modules({"auromat_tpu_torch": 0, "auromat_tpu_torch.ops": 0,
                              "jaxtyping": 0, "flaxen.x": 0, "numpy": 0}) == []
    assert forbidden_modules({"auromat_tpu.ops.georef": 0, "jax": 0, "jaxlib.xla": 0,
                              "flax.linen": 0}) == ["auromat_tpu", "flax", "jax", "jaxlib"]


def test_a_run_without_a_card_prints_no_result():
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "iss030_fused",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout == ""


def test_k1_bytes_against_hand_counted_shapes():
    # the fused frame: 4256 x 2832 samples, 7,032,896 valid, 539 x 524 cells
    assert k1_bytes(4256 * 2832, 7_032_896, 539 * 524, int_sums=False) == (
        2 * 4 * 12_052_992 + 4 * 4 * 7_032_896 + 5 * 4 * 282_436) == 214_598_992
    # an 8-frame step adding into 150,000 touched cells of int64 sums
    assert k1_bytes(8 * 12_052_992, 38_701_255, 150_000, int_sums=True) == (
        8 * 8 * 12_052_992 + 16 * 38_701_255 + 40 * 150_000)
    assert bound_s(3.35e12) == 1.0


def test_handwritten_kernels_are_found_past_launch_bounds():
    names = harness.handwritten_kernels()
    for k in ("k1_bin_kernel", "k1_finish_kernel", "k2_bin_kernel", "hough_p_kernel",
              "tile_kernel", "seam_kernel", "trace_kernel"):
        assert k in names
    assert "__launch_bounds__" not in names and "void" not in names


def test_trace_summary_busy_and_gaps():
    class T:
        def __init__(self, start, end):
            self.start, self.end = start, end

    class E:
        def __init__(self, name, dev, a, b, annot=False):
            from torch.autograd import DeviceType
            self.name, self.time_range, self.is_user_annotation = name, T(a, b), annot
            self.device_type = DeviceType.CUDA if dev else DeviceType.CPU

    ev = [E(tracing.WINDOW_SPAN, False, 0, 1000), E("host work", False, 100, 400),
          E("k_a", True, 0, 100), E("k_b", True, 50, 100), E("Memcpy DtoH", True, 400, 600),
          E("k_a", True, 900, 1200)]
    tr = tracing.summarize(ev)
    assert tr.window_s == 1e-3 and abs(tr.busy_s - 4e-4) < 1e-12
    assert tr.device_ops()[0] == ["k_a", 2e-4]
    gaps = dict(tr.gaps_by_host())
    assert gaps.keys() == {"host work", "host between calls"}
    assert abs(gaps["host work"] - 3e-4) < 1e-12 and abs(gaps["host between calls"] - 3e-4) < 1e-12
    assert tracing.summarize([E(tracing.WINDOW_SPAN, False, 0, 10)]) is None


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_program_is_correct(name):
    result, run = _drive(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and run.requests >= 2


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_is_not_correct(name):
    result, _ = _drive(name, fault=lambda state: state.use_control(), answers=1)
    assert not result["correct"], result["checks"]


def _stale(state):
    """Each answer is the previous request's: the step left its state unchanged."""
    request, last = state.request, {}

    def stale(i):
        prev, last["out"] = last.get("out"), request(i)
        return last["out"] if prev is None else prev

    state.request = stale


def _altered(state):
    """Each answer altered where it is produced: red off by one step."""
    request = state.request

    def altered(i):
        out = request(i)
        if isinstance(out[0], dict):  # the library's (mapping, resampled)
            return out[0], out[1] | {"img": out[1]["img"] ^ 1}
        count, means = out
        return count, means + torch.tensor([1.0, 0.0, 0.0, 0.0])

    state.request = altered


def _half_rows(monkeypatch):
    """K1 bins every other row of what it is given (half a frame, or half
    of a step's frames), and the mean is taken over the rest."""
    from auromat_tpu_torch.ops import georegrid
    from auromat_tpu_torch.parallel import sharding

    def halve(fn):
        def binned(grid, iy, ix, *a, **k):
            iy, ix = iy.clone(), ix.clone()
            iy[1::2], ix[1::2] = -1, -1
            return fn(grid, iy, ix, *a, **k)
        return binned

    monkeypatch.setattr(georegrid, "bin_rgbelev_from_indices",
                        halve(georegrid.bin_rgbelev_from_indices))
    monkeypatch.setitem(sharding._K1_BINNERS, "pallas", halve(sharding._K1_BINNERS["pallas"]))


def _step_unchanged(monkeypatch):
    """Every second mosaic step returns nothing: the sum it adds into is
    left as it was."""
    from auromat_tpu_torch.parallel import sharding

    partial, calls = sharding.GridShardedStep.partial, [0]

    def unchanged(self, dyn, imgs):
        calls[0] += 1
        part = partial(self, dyn, imgs)
        return part if calls[0] % 2 else tuple(torch.zeros_like(p) for p in part)

    monkeypatch.setattr(sharding.GridShardedStep, "partial", unchanged)


FAULTS = [("iss030_fused", "stale"), ("iss030_fused", "altered"), ("iss030_fused", "half"),
          ("iss029_mosaic_seq16", "stale"), ("iss029_mosaic_seq16", "altered"),
          ("iss029_mosaic_seq16", "half"), ("iss029_mosaic_seq16", "step_unchanged"),
          ("iss030_library", "stale"), ("iss030_library", "altered")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_each_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    if fault == "half":
        _half_rows(monkeypatch)
        plant = None
    elif fault == "step_unchanged":
        _step_unchanged(monkeypatch)
        plant = None
    else:
        plant = {"stale": _stale, "altered": _altered}[fault]
    result, _ = _drive(name, fault=plant)
    assert not result["correct"], result["checks"]
