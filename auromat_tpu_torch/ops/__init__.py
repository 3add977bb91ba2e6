"""Device compute ops: the georeference chain, the regrid binning and their
kernels (CUDA C++ sources under ``csrc/``, loaded by ``_kernels``)."""
