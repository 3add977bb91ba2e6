"""Star-field masking of the two real 12 MP ISS frames on the card (marked
``gpu``; each test skips without a CUDA device). This file imports neither
jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_starfield.py -q

``mask_starfield(device="cuda")``, called as a user calls it (a host RGB
frame, the defaults), of the benchmark's frames (the JPEGs' gray planes,
``benchmark/configs/data``): 0 pixels from the executed original's golden
masks and from the plain reference (``benchmark/reference/masking.py``,
its pixel stages on the card), sigma equal to the reference's, the
``masking.lines`` span's four Hough counts equal to the reference's
trajectory counts, and one launch of HOUGH_ORDER and one of HOUGH_P a
call; the stage spans in order, with stream times and the copies' bytes.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from benchmark.reference import masking as reference  # noqa: E402

DATA = os.path.join(ROOT, "benchmark", "configs", "data")
FRAMES = ("ISS029-E-8492", "ISS030-E-102170_dc")
STAGES = ["masking", "masking.to_device", "masking.dark_area", "masking.lines",
          "masking.blocks", "masking.sigma", "masking.to_host"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frame(name):
    gray = np.load(os.path.join(DATA, f"{name}_gray.npz"))["gray"]
    return np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=2))


@pytest.mark.gpu
@pytest.mark.parametrize("name", FRAMES)
def test_mask_starfield_of_a_real_frame_on_the_card(cuda, name):
    from auromat_tpu_torch.ops import _kernels
    from auromat_tpu_torch.profiling import recording
    from auromat_tpu_torch.solving.masking import mask_starfield

    frame = _frame(name)
    golden = np.load(os.path.join(DATA, f"golden_masking_{name}.npz"))
    mask_starfield(frame, device=cuda)  # builds the kernels
    before = [_kernels.HOUGH_ORDER.launches, _kernels.HOUGH_P.launches]
    with recording() as window:
        mask, sigma = mask_starfield(frame, device=cuda)
    assert [_kernels.HOUGH_ORDER.launches, _kernels.HOUGH_P.launches] == [
        n + 1 for n in before]
    spans = window.spans()
    assert [s.name for s in spans] == STAGES
    by = {s.name: s for s in spans}
    assert all(by[n].device_ms > 0 for n in STAGES[2:5])
    assert by["masking.to_device"].nbytes == frame.nbytes
    assert by["masking.to_host"].nbytes == mask.size

    ref = reference.mask_starfield(frame, cuda)
    assert mask.dtype == bool and mask.shape == frame.shape[:2]
    assert int((mask != golden["mask"]).sum()) == 0
    assert int((mask != ref.mask).sum()) == 0
    assert sigma == pytest.approx(ref.sigma, rel=1e-12)
    assert sigma == pytest.approx(float(golden["sigma"]), rel=1e-2)
    assert by["masking.lines"].counts == ref.counts
    assert by["masking.dark_area"].counts["binarizations"] == len(ref.binarizations)
    assert by["masking.dark_area"].counts["borders"] == sum(
        n for n, _ in ref.binarizations)
