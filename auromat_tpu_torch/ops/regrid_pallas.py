"""Mean binning with precomputed bin indices: K2 and K3, and their plain
versions.

Counterpart of ``auromat_tpu.ops.regrid_pallas`` (same function names and
signatures, minus ``interpret`` and ``tiles``). The JAX package holds two
Pallas kernels here, K3 (``bin_partial_pallas``: full-width one-hot
matrices) and K2 (``bin_partial_pallas_cw``: 128-column windows); the
split between them is TPU tiling, and their contract is one. Both run the
same CUDA kernel, ``csrc/regrid_bin.cu`` (shared-memory tile histograms
on the engine of ``csrc/bin_tile.cuh``, with a fused float32 epilogue),
counted per entry point
(``_kernels.REGRID_BIN`` for K2 and what is built on it,
``_kernels.REGRID_BIN_V1`` for K3). CUDA tensors go to the kernel, CPU
tensors to its plain version (:func:`bin_partial_cw_plain`), and any other
device raises.

Channel modes. The TPU kernels split channels into bf16-exact limbs so that
their one-hot products are exact; here the limbs are not a data format,
their job moves into integer arithmetic in the kernel, and every channel is
summed exactly as an int64:

- ``'uint8'``: the leading channels are integers 0..255 (imagery, taint
  indicators) and sum as they are; the last channel (elevation) sums in
  fixed point, round((x + 90) * 2^30), as in K1.
- ``'full'`` (values in [0, 65536)) and ``'raw'`` (bf16-exact values):
  every channel sums in fixed point, round(x * 2^FIXED_SHIFT), so each
  sample is within 2^-(FIXED_SHIFT + 1) = 2^-21 of its value — far inside
  the JAX 'full' mode's bf16 fraction limb (up to 2^-9 a sample).

The wrappers refuse values outside the mode's range and inputs whose
worst-case cell sum (every valid sample in one cell) could overflow int64
(:func:`check_status`). The plain version computes what that takes with
tensor reductions (:func:`input_status`); the kernel computes it while it
bins, into three status words that the wrapper reads once
(:func:`decode_status`), and both raise the same errors.
Sums come back as float32, as from the JAX kernels. NaN data at a valid
coordinate adds 0; :func:`bin_mean_pallas_taint` layers the reference's
NaN-taint semantics on top.
"""

import ctypes
import struct

import torch

from auromat_tpu_torch.ops._kernels import REGRID_BIN, REGRID_BIN_V1
from auromat_tpu_torch.ops.georegrid import split_bin_indices
from auromat_tpu_torch.ops.regrid import GridSpec, bin_indices

ELEV_OFFSET = 90.0
ELEV_SHIFT = 30  # 'uint8' mode: fixed-point scale 2^30 of the last channel
FIXED_SHIFT = 20  # 'full'/'raw' modes: fixed-point scale 2^20 of every channel
MODES = {"uint8": 0, "full": 1, "raw": 2}
_INT64_MAX = 2 ** 63 - 1
_VIOLATIONS = {
    "uint8": "'uint8' mode: the leading channels must hold integers 0..255",
    "full": "'full' mode: values must lie in [0, 65536)",
    "raw": "'raw' mode: values must be bf16-exact",
}


def _check_layout(grid, iy, ix, data, mode):
    """Mode, shapes, dtypes and devices."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    h, w = iy.shape
    if data.dim() != 3 or tuple(data.shape[:2]) != (h, w) or data.shape[2] < 1:
        raise ValueError(f"data: want (h, w, n_ch) with (h, w) = {(h, w)}, "
                         f"got {tuple(data.shape)}")
    for name, t, dtype in (("iy", iy, torch.int32), ("ix", ix, torch.int32),
                           ("data", data, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype}, got {t.dtype}")
        if t.device != iy.device:
            raise ValueError(f"{name} is on {t.device}, iy on {iy.device}")
    if tuple(ix.shape) != (h, w):
        raise ValueError(f"ix: want {(h, w)}, got {tuple(ix.shape)}")
    if grid.n_lat * grid.n_lon >= 2 ** 31:
        raise ValueError("grid too large for int32 cell indices")


def input_status(grid, iy, ix, data, mode):
    """What the refusals need, by tensor reductions (the plain version):
    (bad, n_valid, bound) — whether a value the kernel adds breaks the
    mode's range, the number of valid samples, and the largest magnitude
    (``'uint8'``: |last + 90| in float32; else |x|) over every sample with
    invalid or NaN data as 0."""
    valid = ((iy >= 0) & (iy < grid.n_lat) & (ix >= 0) & (ix < grid.n_lon))
    n_valid = int(valid.sum().item())
    # only the samples the kernel adds are held to the mode; NaN adds 0
    d = torch.where(valid[..., None] & ~torch.isnan(data), data, 0.0)
    if mode == "uint8":
        lead, last = d[..., :-1], d[..., -1]
        ok = (lead >= 0) & (lead <= 255) & (lead == torch.floor(lead))
        bound = (last + ELEV_OFFSET).abs().max().item() if last.numel() else 0.0
    else:
        if mode == "full":
            ok = (d >= 0) & (d < 65536)
        else:
            ok = d.to(torch.bfloat16).float() == d
        bound = d.abs().max().item() if d.numel() else 0.0
    return not bool(ok.all().item()), n_valid, bound


def decode_status(status, mode, n_samples):
    """(bad, n_valid, bound) of :func:`input_status` from the kernel's three
    status words [violation, float32 bits of the largest magnitude over the
    valid samples, valid samples] for ``n_samples`` samples."""
    viol, bits, n_valid = (int(v) for v in status)
    bound = struct.unpack("<f", struct.pack("<I", bits))[0]
    if mode == "uint8" and n_valid < n_samples:
        bound = max(bound, ELEV_OFFSET)  # an invalid sample counts as 0 + 90
    return bool(viol), n_valid, bound


def check_status(mode, bad, n_valid, bound):
    """Raise if a value breaks the mode's range, or if a cell holding every
    valid sample at magnitude ``bound`` could overflow an int64 sum."""
    if bad:
        raise ValueError(_VIOLATIONS[mode])
    scale = 2.0 ** (ELEV_SHIFT if mode == "uint8" else FIXED_SHIFT)
    # a cell may get every valid sample; each term rounds up by at most 1
    if not (bound * scale + 1.0) * max(n_valid, 1) < _INT64_MAX:
        raise ValueError(f"{n_valid} samples of magnitude up to {bound} could "
                         "overflow the int64 fixed-point sums")


def _check_inputs(grid, iy, ix, data, mode):
    """Shapes, dtypes, devices, value ranges and int64 headroom, by tensor
    reductions (several host syncs)."""
    _check_layout(grid, iy, ix, data, mode)
    check_status(mode, *input_status(grid, iy, ix, data, mode))


def _finish(grid, acc, n_ch, mode):
    """int64 (n_cells, 1 + n_ch) sums -> f32 count (n_lat, n_lon) and sums
    (n_lat, n_lon, n_ch)."""
    count = acc[:, 0]
    if mode == "uint8":
        el = (acc[:, n_ch].double() * 2.0 ** -ELEV_SHIFT
              - ELEV_OFFSET * count.double())
        sums = torch.cat([acc[:, 1:n_ch].float(), el.float()[:, None]], dim=1)
    else:
        sums = (acc[:, 1:].double() * 2.0 ** -FIXED_SHIFT).float()
    return (count.float().reshape(grid.n_lat, grid.n_lon),
            sums.reshape(grid.n_lat, grid.n_lon, n_ch))


def bin_partial_cw_plain(grid: GridSpec, iy, ix, data, mode="uint8"):
    """Plain PyTorch version of the K2/K3 kernel with its arithmetic
    contract (int64 ``index_add_``; bit-equal to the kernel).

    :param iy, ix: (h, w) int32 grid row/col per sample; -1 = invalid
        (samples outside the grid contribute nothing either)
    :param data: (h, w, n_ch) float32 in ``mode``'s range; NaN adds 0
    :returns: count (n_lat, n_lon), sums (n_lat, n_lon, n_ch), float32
    """
    _check_inputs(grid, iy, ix, data, mode)
    n_ch = data.shape[-1]
    valid = ((iy >= 0) & (iy < grid.n_lat) & (ix >= 0) & (ix < grid.n_lon))
    cell = (iy.long() * grid.n_lon + ix.long())[valid]
    d = data[valid]
    d = torch.where(d == d, d, 0.0).double()
    if mode == "uint8":
        q = torch.cat([d[:, :-1].long(), torch.round(
            (d[:, -1:] + ELEV_OFFSET) * 2.0 ** ELEV_SHIFT).long()], dim=1)
    else:
        q = torch.round(d * 2.0 ** FIXED_SHIFT).long()
    acc = torch.zeros(grid.n_lat * grid.n_lon, 1 + n_ch, dtype=torch.int64,
                      device=iy.device)
    acc.index_add_(0, cell, torch.cat([torch.ones_like(cell)[:, None], q], 1))
    return _finish(grid, acc, n_ch, mode)


def launch_k2(grid, iy, ix, data, mode, acc, status, count, sums,
              kernel=REGRID_BIN):
    """Launch the K2/K3 kernel on the current stream: add into ``acc``
    ((n_cells, 1 + n_ch) int64), write the checks into ``status`` ((3,)
    int64, zeroed) and the float32 ``count`` (n_cells,) and ``sums``
    (n_cells, n_ch). Layouts are validated by the caller
    (:func:`_check_layout`)."""
    for name, t in (("iy", iy), ("ix", ix), ("data", data)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the K2 kernel")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    h, w = iy.shape
    with torch.cuda.device(iy.device):  # the launcher reads the current device
        kernel(ptr(iy), ptr(ix), ptr(data), h, w, data.shape[-1],
               grid.n_lat, grid.n_lon, MODES[mode],
               ELEV_SHIFT if mode == "uint8" else FIXED_SHIFT, ptr(acc),
               ptr(status), ptr(count), ptr(sums),
               ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))


def _bin(grid, iy, ix, data, mode, kernel):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if iy.device.type == "cuda":
        _check_layout(grid, iy, ix, data, mode)
        n_cells, n_ch, dev = grid.n_lat * grid.n_lon, data.shape[-1], iy.device
        # one zero-fill for the sums and the status words
        zeros = torch.zeros(n_cells * (1 + n_ch) + 3, dtype=torch.int64,
                            device=dev)
        acc, status = zeros[:-3].view(n_cells, 1 + n_ch), zeros[-3:]
        count = torch.empty(n_cells, dtype=torch.float32, device=dev)
        sums = torch.empty(n_cells, n_ch, dtype=torch.float32, device=dev)
        launch_k2(grid, iy, ix, data, mode, acc, status, count, sums, kernel)
        check_status(mode, *decode_status(status.tolist(), mode, iy.numel()))
        return (count.reshape(grid.n_lat, grid.n_lon),
                sums.reshape(grid.n_lat, grid.n_lon, n_ch))
    if iy.device.type == "cpu":
        return bin_partial_cw_plain(grid, iy, ix, data, mode)
    raise ValueError(f"K2 runs on cuda (kernel) or cpu (plain); got {iy.device}")


def bin_partial_pallas_cw(grid: GridSpec, iyix, data_k, n_ch_in,
                          unsplit_mode="uint8"):
    """K2: binning from precomputed bin indices.

    :param iyix: (iy, ix), (h, w) int32 row/col bin indices (-1 = invalid)
    :param data_k: (h, w, n_ch_in) channel data in ``unsplit_mode``'s range.
        The JAX package passes its limb-split channels here; the port takes
        the channels themselves (no split is a data format here).
    :param unsplit_mode: 'uint8', 'full' or 'raw' (the module's modes)
    :returns: (count (n_lat, n_lon), sums (n_lat, n_lon, n_ch_in)), float32
    """
    if data_k.shape[-1] != n_ch_in:
        raise ValueError(f"data_k has {data_k.shape[-1]} channels, n_ch_in "
                         f"{n_ch_in} (the port takes unsplit channels)")
    iy, ix = iyix
    return _bin(grid, iy, ix, data_k.to(torch.float32).contiguous(),
                unsplit_mode, REGRID_BIN)


def _indices_and_data(grid, lats, lons, data):
    """(iy, ix) from the float64 bin indices, and the float32 data with
    NaN or invalid-coordinate samples zeroed (bin_partial contract)."""
    flat, valid = bin_indices(grid, lats, lons)
    iy, ix = split_bin_indices(grid, flat, valid)
    data = data.to(torch.float32)
    data = torch.where(valid[..., None] & ~torch.isnan(data), data, 0.0)
    return iy, ix, data.contiguous()


def bin_partial_pallas(grid: GridSpec, lats, lons, data, mode="uint8"):
    """K3 entry: per-shard partial (count, sums) from coordinates.

    :param lats, lons: (h, w) sample coordinates (NaN = masked)
    :param data: (h, w, C) channel data in ``mode``'s range
    :returns: (count (n_lat, n_lon), sums (n_lat, n_lon, C)), float32
    """
    iy, ix, data = _indices_and_data(grid, lats, lons, data)
    return _bin(grid, iy, ix, data, mode, REGRID_BIN_V1)


def bin_partial_pallas_plain(grid: GridSpec, lats, lons, data, mode="uint8"):
    """Plain version of :func:`bin_partial_pallas` and
    :func:`bin_partial_pallas2` on any device (bit-equal to them)."""
    iy, ix, data = _indices_and_data(grid, lats, lons, data)
    return bin_partial_cw_plain(grid, iy, ix, data, mode)


def bin_partial_pallas2(grid: GridSpec, lats, lons, data, mode="uint8"):
    """:func:`bin_partial_pallas` through K2 (same contract)."""
    iy, ix, data = _indices_and_data(grid, lats, lons, data)
    return bin_partial_pallas_cw(grid, (iy, ix), data, data.shape[-1], mode)


def bin_mean_pallas(grid: GridSpec, lats, lons, data, mode="uint8"):
    """Mean binning via K2; NaN where empty."""
    count, sums = bin_partial_pallas2(grid, lats, lons, data, mode)
    means = torch.where(count[..., None] > 0, sums / count[..., None],
                        torch.nan)
    return count, means


def bin_mean_pallas_taint(grid: GridSpec, lats, lons, data):
    """bin_mean with the reference's NaN-data semantics via K2.

    A NaN sample at a valid coordinate taints its bin's mean in that
    channel (numpy histogram2d semantics). NaNs are zeroed and per-channel
    0/1 taint indicator channels are binned alongside; tainted (bin,
    channel) means are NaN'd afterwards.

    Channel contract: 'uint8' mode — leading channels are 0..255 integers
    (imagery), the LAST is elevation; the indicators ride as extra integer
    channels: the kernel bins [C-1 image, C taint, 1 elevation].
    """
    n = data.shape[-1]
    nan = torch.isnan(data)
    dataz = torch.where(nan, 0.0, data.to(torch.float32))
    taints = nan.to(torch.float32)
    chans = torch.cat([dataz[..., : n - 1], taints, dataz[..., n - 1:]], dim=-1)
    count, sums = bin_partial_pallas2(grid, lats, lons, chans, "uint8")
    sums_data = torch.cat([sums[..., : n - 1], sums[..., -1:]], dim=-1)
    taint_counts = sums[..., n - 1: 2 * n - 1]
    means = torch.where(count[..., None] > 0, sums_data / count[..., None],
                        torch.nan)
    means = torch.where(taint_counts > 0, torch.nan, means)
    return count, means
