"""Each cell on the card at its own size for a short window: the program
correct, the control not (run on the card's machine with
``python -m pytest -m gpu benchmark/tests/test_bench_gpu.py``)."""

import time

import pytest

from benchmark import harness

CELLS = ("iss030_fused", "iss029_mosaic_seq16", "iss030_library")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, cuda):
    cell = harness.find_cell(name)
    result, run = harness.drive(cell, 2 ** 31 + 3, 1.0, False, cuda, time.perf_counter())
    assert result["correct"], result["checks"]
    control, _ = harness.drive(cell, 2 ** 31 + 3, 1.0, False, cuda, time.perf_counter(),
                               fault=lambda state: state.use_control())
    assert not control["correct"], control["checks"]
