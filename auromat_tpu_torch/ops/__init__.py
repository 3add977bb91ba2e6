"""Device compute ops: the fused georeference chain and the K1 binning
kernel (CUDA C++ sources under ``csrc/``, loaded by ``_kernels``)."""
