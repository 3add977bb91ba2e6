"""What surrounds the port's CUDA kernels, on the CPU (no jax).

* ``_kernels.CudaKernel`` names a library by its source, every shared
  header (``csrc/*.cuh``) and the flags, so an edited header is rebuilt
  (checked on a copy of ``csrc/``).
* K2's checks: the kernel writes three status words (violation, float32
  bits of the largest magnitude over the valid samples, valid samples);
  ``decode_status`` turns them into what the plain version's
  ``input_status`` computes, and ``check_status`` raises the same errors.
  The status words are made here as the kernel makes them (numpy over the
  valid samples), from crafted inputs.
* K1's status word (the count of a cell past MAX_CELL_COUNT) raises the
  plain version's error.
* The kernel boundary, ``CudaKernel.__call__``, with the launcher stubbed:
  tensors become their pointers in order, None a null pointer, numbers
  pass as they are; the stream comes last; a CPU tensor and a
  non-contiguous one are refused before the launcher runs; ``launches``
  counts only a launch that returned 0; the tensors' device is made
  current only when it is not. CPU tensors stand in for CUDA ones on
  device -1 where the case needs a card (the ``gpu`` tests launch through
  every call site on one).
"""

import contextlib
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from auromat_tpu_torch.ops import _kernels
from auromat_tpu_torch.ops import regrid_pallas as rp
from auromat_tpu_torch.ops.georegrid import (MAX_CELL_COUNT,
                                             _check_cell_counts,
                                             refuse_cell_count)
from auromat_tpu_torch.ops.regrid import fixed_grid

GRID = fixed_grid((2.0, 1.0), 0.05, 19.95, 0.5, 129.5)  # 40 x 129 cells


@pytest.mark.parametrize("source,symbol", [
    ("georegrid_bin.cu", "georegrid_bin_launch"),
    ("regrid_bin.cu", "regrid_bin_launch")])
def test_library_path_follows_shared_headers(monkeypatch, tmp_path, source,
                                             symbol):
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels._CSRC, csrc)
    monkeypatch.setattr(_kernels, "_CSRC", str(csrc))
    k = _kernels.CudaKernel(source, symbol, [])
    first = k._lib_path()
    assert os.path.basename(first).startswith(f"lib{source[:-3]}-")
    header = csrc / "bin_tile.cuh"
    text = header.read_bytes()
    header.write_bytes(text + b"\n// edited\n")
    edited = k._lib_path()
    assert edited != first
    header.write_bytes(text)
    assert k._lib_path() == first
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert k._lib_path() != first
    assert not k.launches and k.path is None  # nothing built or loaded


def kernel_status(iy, ix, data, mode):
    """The three status words as the kernel computes them, from numpy."""
    iy, ix, d = iy.numpy(), ix.numpy(), data.numpy().astype(np.float32)
    valid = (iy >= 0) & (iy < GRID.n_lat) & (ix >= 0) & (ix < GRID.n_lon)
    d = np.where(np.isnan(d), np.float32(0), d)[valid]
    with np.errstate(invalid="ignore"):
        if mode == "uint8":
            lead = d[:, :-1]
            bad = ~((lead >= 0) & (lead <= 255) & (lead == np.floor(lead)))
            mag = np.abs(d[:, -1] + np.float32(90))
        elif mode == "full":
            bad = ~((d >= 0) & (d < 65536))
            mag = np.abs(d)
        else:
            bad = (d.view(np.uint32) & 0xFFFF) != 0
            mag = np.abs(d)
    most = mag.max() if mag.size else np.float32(0)
    return [int(bad.any()), int(np.float32(most).view(np.uint32)),
            int(valid.sum())]


def crafted(case):
    """(mode, iy, ix, data) of one crafted case: 64 x 48 samples, a third
    of them invalid, seeded."""
    rng = np.random.default_rng(len(case))
    shape = (64, 48)
    iy = rng.integers(-1, GRID.n_lat, shape)
    iy[::3] = -1
    ix = rng.integers(0, GRID.n_lon + 3, shape)  # some past the grid
    img = rng.integers(0, 256, shape + (3,)).astype(np.float32)
    elev = rng.uniform(-90, 90, shape + (1,)).astype(np.float32)
    mode = "uint8"
    data = np.concatenate([img, elev], -1)
    if case == "uint8_nan":
        data[1::2, :, 1] = np.nan
        data[::5, :, 3] = np.nan
    elif case == "uint8_fraction":
        data[5, 7, 0] = 3.5
        iy[5, 7], ix[5, 7] = 2, 2
    elif case == "uint8_256":
        data[6, 1, 2] = 256.0
        iy[6, 1], ix[6, 1] = 1, 1
    elif case == "uint8_bad_but_invalid":
        data[::3, :, 0] = 0.5  # only on invalid rows: nothing the kernel adds
    elif case == "uint8_near_minus_90":  # invalid samples set the bound, 90
        data[..., 3] = -89.5
    elif case == "uint8_overflow":
        data[..., 3] = 1e10
    elif case.startswith("full"):
        mode = "full"
        data = rng.uniform(0, 65535, shape + (2,)).astype(np.float32)
        if case == "full_high":
            data[4, 4, 1] = 65536.0
            iy[4, 4], ix[4, 4] = 0, 0
    elif case.startswith("raw"):
        mode = "raw"
        data = torch.from_numpy(rng.uniform(-100, 100, shape + (2,)).astype(
            np.float32)).to(torch.bfloat16).float().numpy()
        iy[7, 3], ix[7, 3] = 3, 3
        if case == "raw_inexact":
            data[7, 3, 0] = 1.0 + 2.0 ** -12
        elif case == "raw_overflow":
            data[7, 3, 1] = 2.0 ** 50
        elif case == "raw_inf":
            data[7, 3, 1] = np.inf
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    return mode, t(iy, torch.int32), t(ix, torch.int32), t(data, torch.float32)


CASES = ["uint8_ok", "uint8_nan", "uint8_fraction", "uint8_256",
         "uint8_bad_but_invalid", "uint8_near_minus_90", "uint8_overflow",
         "full_ok", "full_high", "raw_ok", "raw_inexact", "raw_overflow",
         "raw_inf"]


@pytest.mark.parametrize("case", CASES)
def test_k2_status_decodes_to_the_plain_checks(case):
    mode, iy, ix, data = crafted(case)
    status = torch.tensor(kernel_status(iy, ix, data, mode), dtype=torch.int64)
    decoded = rp.decode_status(status.tolist(), mode, iy.numel())
    assert decoded == rp.input_status(GRID, iy, ix, data, mode)
    try:
        rp._check_inputs(GRID, iy, ix, data, mode)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            rp.check_status(mode, *decoded)
        assert str(got.value) == str(e)
        assert not case.endswith(("_ok", "_nan", "_invalid", "_90"))
    else:
        rp.check_status(mode, *decoded)
        assert case.endswith(("_ok", "_nan", "_invalid", "_90"))
        want = rp.bin_partial_cw_plain(GRID, iy, ix, data, mode)
        assert int(want[0].sum().item()) == decoded[1]


def test_k2_status_of_no_samples():
    iy = torch.full((0, 5), -1, dtype=torch.int32)
    data = torch.zeros((0, 5, 4))
    assert rp.decode_status([0, 0, 0], "uint8", 0) == rp.input_status(
        GRID, iy, iy, data, "uint8") == (False, 0, 0.0)
    rp.check_status("uint8", False, 0, 0.0)


@pytest.mark.parametrize("most", [0, 1, MAX_CELL_COUNT, MAX_CELL_COUNT + 1,
                                  2 ** 32 - 1])
def test_k1_status_raises_the_plain_error(most):
    count = torch.tensor([0, most, 3], dtype=torch.int64)
    if most <= MAX_CELL_COUNT:
        refuse_cell_count(most)
        _check_cell_counts(count)
        return
    with pytest.raises(ValueError) as want:
        _check_cell_counts(count)
    with pytest.raises(ValueError) as got:
        refuse_cell_count(most)
    assert str(got.value) == str(want.value)
    assert str(most) in str(got.value)


BOUNDARY_CASES = ["pointers", "launch", "device_switch", "refused_launch",
                  "cpu_tensor", "non_contiguous"]


@pytest.mark.parametrize("case", BOUNDARY_CASES)
def test_the_kernel_boundary(monkeypatch, case):
    k = _kernels.CudaKernel("ccl.cu", "ccl8_launch", [])
    calls = []
    rc = 5 if case == "refused_launch" else 0
    k._fn = lambda *args: calls.append((args, torch.cuda.current_device())) \
        or rc
    a, b = torch.arange(6, dtype=torch.int32), torch.zeros(2, 3)
    args = (a, None, 3, 2.5, b)
    ptrs = [a.data_ptr(), None, 3, 2.5, b.data_ptr()]
    if case == "pointers":
        got, lead = k._c_args(args)
        assert got == ptrs and lead is a
        got, lead = k._c_args((7, b))
        assert got == [7, b.data_ptr()] and lead is b
        assert k._c_args((7, None)) == ([7, None], None)
        return
    if case == "cpu_tensor":
        with pytest.raises(ValueError, match="ccl8_launch: argument 0 is on "
                                             "cpu, not on a CUDA device"):
            k(*args)
        assert not calls and k.launches == 0
        return
    # a card: device -1 (a CPU tensor's get_device()), its stream 999
    current = [2 if case == "device_switch" else -1]
    switched = []

    @contextlib.contextmanager
    def device(d):
        switched.append(d)
        current[0], before = d, current[0]
        yield
        current[0] = before

    monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=1000 + d))
    if case == "non_contiguous":
        with pytest.raises(ValueError, match="ccl8_launch: argument 4 must "
                                             "be contiguous"):
            k(a, None, 3, 2.5, b.t())
        assert not calls and k.launches == 0
        return
    if case == "refused_launch":
        with pytest.raises(RuntimeError, match="ccl8_launch launch failed: "
                                               "CUDA error 5"):
            k(*args)
    else:
        k(*args)
    assert calls == [(tuple(ptrs) + (999,), -1)]
    assert k.launches == (0 if case == "refused_launch" else 1)
    assert switched == ([-1] if case == "device_switch" else [])
    assert current == [2 if case == "device_switch" else -1]
