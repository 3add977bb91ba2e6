"""Build and load the hand-written CUDA kernels of ``ops/csrc/``.

Each kernel source is compiled at first use with ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds) and loaded with ``ctypes``. The library lands in
``auromat_tpu_torch/_build/``, named by a hash of the source, of every
shared header (``csrc/*.cuh``) and of the compiler flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Nothing is built when this module is imported, and a failed build raises.

A :class:`CudaKernel` is the one place a launch is made: its wrappers pass
tensors, and it packs their pointers, checks that they are contiguous and on
one CUDA device, makes that device current and appends its current stream.
Each counts its launches in ``launches``: one per successful launch, so a
run can show that its path went through the kernel.
Two handles may share a source (one library, built once): each entry point
of the JAX package that reached a TPU kernel has its own handle, and so its
own count.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "_build")
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default install
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_BUILD_LOCKS = {}  # library path -> lock: one build per library
_BUILD_LOCKS_LOCK = threading.Lock()


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install. Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), NVCC_DEFAULT]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of auromat_tpu_torch are built at "
                       "first use and need the CUDA toolkit")


class CudaKernel:
    """One ``extern "C"`` launcher in one ``csrc/*.cu`` file.

    :param source: file name under ``csrc/``
    :param symbol: the C function; it launches on the stream it is given
        and returns ``cudaGetLastError()`` of the launch
    :param argtypes: ctypes argument types (``c_void_p`` for every pointer
        and for the stream, which comes last)
    """

    def __init__(self, source, symbol, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.path = None  # the loaded library, once built
        self._fn = None
        self._lock = threading.Lock()

    def build(self):
        """Compile (if not yet built) and load; returns the library path."""
        with self._lock:
            if self._fn is None:
                path = self._compile()
                fn = getattr(ctypes.CDLL(path), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn, self.path = fn, path
            return self.path

    def _lib_path(self):
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
        for name in [self.source] + headers:
            with open(os.path.join(_CSRC, name), "rb") as f:
                digest.update(name.encode() + b"\0" + f.read())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(_BUILD, f"lib{stem}-{digest.hexdigest()[:16]}.so")

    def _compile(self):
        path = self._lib_path()
        with _BUILD_LOCKS_LOCK:
            lock = _BUILD_LOCKS.setdefault(path, threading.Lock())
        with lock:
            return self._compile_locked(path)

    def _compile_locked(self, path):
        if os.path.isfile(path):
            return path
        nvcc = find_nvcc()
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {self.source} failed "
                               f"({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
        return path

    def _c_args(self, args):
        """The launcher's arguments from ``args``, and the first tensor
        among them (None without one): a tensor becomes its data pointer;
        None (a null pointer), ints and floats pass as they are. Raises
        ValueError on a tensor that is not contiguous or not on the first
        tensor's device."""
        out, lead = [], None
        for a in args:
            if a is not None and not isinstance(a, (int, float)):
                if lead is None:
                    lead, dev = a, a.get_device()
                elif a.get_device() != dev:
                    raise self._refusal(args, a, f"is on {a.device}, the "
                                        f"first tensor on {lead.device}")
                if not a.is_contiguous():
                    raise self._refusal(args, a, "must be contiguous")
                a = a.data_ptr()
            out.append(a)
        return out, lead

    def _refusal(self, args, tensor, what):
        i = next(i for i, a in enumerate(args) if a is tensor)
        return ValueError(f"{self.symbol}: argument {i} {what}")

    def __call__(self, *args):
        """Launch with the launcher's arguments in their C order, less the
        stream (:meth:`_c_args`), on the tensors' CUDA device and its
        current stream; raises ValueError before the launch on a tensor
        that is not a contiguous CUDA tensor on that device, RuntimeError
        if the launch was refused."""
        c_args, lead = self._c_args(args)
        if lead is None:
            raise ValueError(f"{self.symbol} launches on CUDA tensors, got "
                             "none")
        if not lead.is_cuda:
            raise self._refusal(args, lead, f"is on {lead.device}, not on a "
                                "CUDA device")
        if self._fn is None:
            self.build()
        dev = lead.get_device()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dev == torch.cuda.current_device():
            rc = self._fn(*c_args, stream)
        else:  # a launch goes to the current device (K1's and K2's
            # launchers also size their grids by it)
            with torch.cuda.device(dev):
                rc = self._fn(*c_args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error {rc}")
        self.launches += 1


_P = ctypes.c_void_p

_K1_ARGS = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _P, _P, _P, _P, _P, _P]
# K1 and K1-i8 (ops/georegrid.py::bin_rgbelev_from_indices, compute='bf16'
# and compute='i8'): one source, one kernel template, two entry points
GEOREGRID_BIN = CudaKernel("georegrid_bin.cu", "georegrid_bin_launch", _K1_ARGS)
GEOREGRID_BIN_I8 = CudaKernel("georegrid_bin.cu", "georegrid_bin_i8_launch",
                              _K1_ARGS)
# K1_MEAN (ops/georegrid.py::mean_int_sums, the sequence mosaic's finish):
# K1's float32 epilogue, the mean and the largest count in one pass over
# the int64 sums; XLA compiles the JAX package's finish, so it replaces no
# TPU kernel
K1_MEAN = CudaKernel("georegrid_bin.cu", "georegrid_mean_launch",
                     [_P, _P, ctypes.c_longlong, ctypes.c_double, _P, _P, _P,
                      _P])

# GEOREF_CELLS (ops/georegrid.py::georef_cells): the float32 georeference
# chain and its cells in one pass, bit-equal to the eager chain on the card;
# XLA fuses that chain on the TPU, so it replaces no TPU kernel
GEOREF_CELLS = CudaKernel("georef_cells.cu", "georef_cells_launch",
                          [_P] * 8 + [ctypes.c_int] * 5
                          + [ctypes.c_double] * 4 + [ctypes.c_float] * 7
                          + [_P] * 6)

_K2_ARGS = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
            _P, _P, _P]
# K2 (ops/regrid_pallas.py::bin_partial_pallas_cw and the functions built on
# it) and K3 (ops/regrid_pallas.py::bin_partial_pallas): one kernel, counted
# per entry point
REGRID_BIN = CudaKernel("regrid_bin.cu", "regrid_bin_launch", _K2_ARGS)
REGRID_BIN_V1 = CudaKernel("regrid_bin.cu", "regrid_bin_launch", _K2_ARGS)

# HOUGH_P (solving/masking.py::hough_lines_p): OpenCV's probabilistic Hough
# transform, which the JAX package calls on the host (no TPU kernel); one
# block of HOUGH_P_THREADS threads, one thread an angle, reading the
# accumulator for 16 live candidates at a time and resolving every trigger
# among them from registers
HOUGH_P_THREADS = 192
HOUGH_P_MAX_SIDE = 16383  # the walks keep 512 rounds of 32 positions
HOUGH_P = CudaKernel("hough_p.cu", "hough_p_launch",
                     [_P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P,
                      ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, _P, _P, _P, _P])
# HOUGH_ORDER (solving/masking.py::_hough_order_cuda): HoughLinesP's visit
# order (OpenCV's RNG and its swap-with-last permutation) on the card
HOUGH_ORDER = CudaKernel("hough_order.cu", "hough_order_launch",
                         [ctypes.c_int, _P, _P, ctypes.c_longlong, _P])
# CCL8 / CCL4 (solving/masking.py::ccl): connected components of a binary
# image, each pixel labelled with its component's first pixel in raster
# order; the star-field mask's components and holes, which the JAX package
# finds with cv2.findContours on the host (no TPU kernel)
_CCL_ARGS = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P]
CCL8 = CudaKernel("ccl.cu", "ccl8_launch", _CCL_ARGS)
CCL4 = CudaKernel("ccl.cu", "ccl4_launch", _CCL_ARGS)
# CONTOUR_TRACE (solving/masking.py::contour_trace): the outer border from
# each root, with its doubled area, box, length and simple points
# (cv2.findContours, cv2.contourArea, cv2.boundingRect on the host in the
# JAX package); one thread a root, walking a bit-packed copy of the image
CONTOUR_TRACE = CudaKernel("contour_trace.cu", "contour_trace_launch",
                           [_P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int,
                            _P, _P, _P, _P, _P, _P, _P, _P, _P])
