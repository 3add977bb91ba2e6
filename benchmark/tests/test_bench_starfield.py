"""The star-field masking cell (``iss029_starfield_mask``) driven on the CPU
on block-divisible crops of its two real frames: every number of the check
reads 0 for the program, the window's work holds each masking kernel's
least time, and ``correct`` comes out false for the control (the reference
with float16 Hough votes in the program's place) and for each fault planted
under the timed path: a stale answer, the Hough step skipped, the sigma
taken from the whole frame."""

import time

import numpy as np
import pytest

from benchmark import harness, roofline_masking

CELL = "iss029_starfield_mask"
SHRINK = 6  # 468 x 704 crops of the 2832 x 4256 frames


def _drive(fault=None):
    cell = harness.find_cell(CELL)
    return harness.drive(cell, 2 ** 31 + 23, 300.0, True, "cpu", time.perf_counter(),
                         shrink=SHRINK, fault=fault)


def test_the_program_is_correct():
    result, run = _drive()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and run.requests == 6 and len(run.kept) == 2
    assert {k: v["value"] for k, v in result["checks"].items()} == {
        "mask_px_off": 0.0, "golden_px_off": 0.0, "sigma_rel_err": 0.0,
        "hough_counts_off": 0.0}
    assert set(run.work) == {f"{k}_least_s" for k in roofline_masking.KERNELS}
    assert all(v > 0 for v in run.work.values())
    # no card: the host stages' times only
    assert set(result["metrics"]) == {"starfield_host_ms"}


def test_the_frames_alternate_from_a_frame_the_seed_picks():
    cell = harness.find_cell(CELL)
    firsts = set()
    for seed in (2 ** 31 + 1, 2 ** 31 + 2):
        state = cell.path.setup(cell.config, cell.traffic, "cpu", seed, SHRINK, None)
        firsts.add(state.first)
        names = [state.frames[(state.first + i) % 2][0] for i in range(4)]
        assert names[0] != names[1] and names[:2] == names[2:]
    assert firsts == {0, 1}


def test_the_control_is_not_correct():
    result, _ = _drive(lambda state: state.use_control())
    assert not result["correct"], result["checks"]


def _stale(state):
    """Each answer is the previous request's."""
    request, last = state.request, {}

    def stale(i):
        prev, last["out"] = last.get("out"), request(i)
        return last["out"] if prev is None else prev

    state.request = stale


def _no_hough(monkeypatch):
    """The Hough step finds no line and counts nothing."""
    from auromat_tpu_torch.solving import masking

    monkeypatch.setattr(masking, "hough_lines_p", lambda *a: np.zeros((0, 4), np.int32))


def _whole_frame_sigma(monkeypatch):
    """The sigma is estimated over the whole frame, not the star rectangle."""
    from auromat_tpu_torch.solving import masking

    monkeypatch.setattr(masking, "_max_size_rectangle", lambda grid: ((0, 0), grid.shape))


@pytest.mark.parametrize("fault", ["stale", "no_hough", "whole_frame_sigma"])
def test_each_fault_makes_the_run_incorrect(fault, monkeypatch):
    plant = None
    if fault == "stale":
        plant = _stale
    else:
        {"no_hough": _no_hough, "whole_frame_sigma": _whole_frame_sigma}[fault](monkeypatch)
    result, _ = _drive(plant)
    assert not result["correct"], result["checks"]
