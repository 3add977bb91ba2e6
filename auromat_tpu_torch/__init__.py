"""auromat_tpu_torch — the PyTorch/CUDA port of ``auromat_tpu``.

The same aurora georeferencing framework for NVIDIA GPUs: the per-pixel
camera->sky->Earth chain is plain PyTorch tensor code, and every kernel
that ``auromat_tpu`` wrote in Pallas for the TPU is a kernel written by
hand in CUDA C++ for Hopper (``ops/csrc/``), built at first use. Module
layout and names mirror ``auromat_tpu`` so each counterpart is easy to
find; ``auromat_tpu`` stays the reference the port is tested against.

This package never imports jax and sets no global dtype: every function
takes its tensors' dtype and device from its arguments.
"""

__version__ = "0.1.0"

from auromat_tpu_torch import constants  # noqa: E402,F401
