"""Sharded batch georeferencing + mosaic regrid over torch.distributed ranks.

Counterpart of ``auromat_tpu.parallel.sharding``. The JAX package runs
one program over a ``jax.sharding.Mesh`` of devices (``shard_map``); here
one process drives one device, every process runs the same code, and a
:class:`Mesh` names this process's place in a (dp, sp) grid of ranks:

  dp — frames sharded over ranks (data parallel)
  sp — image rows sharded over ranks (spatial parallel; halo-free, the
       per-pixel chain is embarrassingly parallel)

rank = dp_index * sp + sp_index, the linear mesh index of the JAX
package's out_specs (sharding.py:368). A step takes the GLOBAL burst (all
B frames, as the JAX step does) and each rank slices out its frames and
rows; only those reach its device. Partial bins travel between ranks by
``torch.distributed`` collectives (NCCL between GPUs, gloo between CPU
processes); without a process group the mesh is a world of one and no
collective runs.

The TPU workarounds of the JAX module have no counterpart: no
``interpret`` (the plain version of K1 runs on CPU tensors), no
``slab_budget_bytes`` (the band-padded accumulator lives in device memory
whole), no jit surface (``.lower``/``.jitted``).
"""

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from auromat_tpu_torch.ops.georef import compute_device, georef_latlon_dyn
from auromat_tpu_torch.ops.georegrid import (bin_rgbelev_int, finish_int_sums,
                                             bin_rgbelev_plain_int,
                                             georegrid_inputs)
from auromat_tpu_torch.ops.regrid import (_BIN_METHODS, GridSpec, bin_indices,
                                          bin_partial, finalize_mean, round_up)

# K1's integer binning, by bin_method: the kernel on CUDA tensors (its
# plain version on CPU tensors), or its plain version on any device
_K1_BINNERS = {"pallas": bin_rgbelev_int, "pallas_plain": bin_rgbelev_plain_int}
# the int64 elevation sum of a cell holds < 180 * 2^30 a sample
_ELEV_INT64_MAX_COUNT = (2 ** 63 - 1) // (180 * 2 ** 30)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a (dp, sp) mesh over the ranks of the
    default torch.distributed process group (or a world of one).

    :param rank: the linear mesh index, dp_index * sp + sp_index
    :param device: the device this rank computes on
    """

    dp: int
    sp: int
    rank: int
    device: torch.device

    @property
    def size(self):
        return self.dp * self.sp

    @property
    def dp_index(self):
        return self.rank // self.sp

    @property
    def sp_index(self):
        return self.rank % self.sp


def factorise(n, dp=None, sp=None):
    """(dp, sp) with dp * sp == n; the most square-ish split (sp the
    largest divisor <= sqrt(n)) when neither is given."""
    if dp is None and sp is None:
        sp = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                sp = cand
                break
        dp = n // sp
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"a {dp} x {sp} mesh does not fit {n} ranks")
    return dp, sp


def make_mesh(dp=None, sp=None, device="cuda"):
    """A (dp, sp) mesh over the ranks of the default process group (a
    world of one when none is initialised); ``device`` is this rank's
    (the card by default; pass ``device="cpu"`` for the CPU).

    Picks the most square-ish factorisation when sizes are not given.
    """
    if dist.is_available() and dist.is_initialized():
        n, rank = dist.get_world_size(), dist.get_rank()
    else:
        n, rank = 1, 0
    dp, sp = factorise(n, dp, sp)
    return Mesh(dp, sp, rank, compute_device(device))


def _reduce_scatter_rows(mesh, x):
    """Sum ``x`` over the mesh's ranks; rank r keeps the r-th of
    ``mesh.size`` equal row blocks of dim 0."""
    if mesh.size == 1:
        return x
    out = x.new_empty((x.shape[0] // mesh.size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous())
    return out


def gather_bands(mesh, x, n_lat):
    """Every rank's band of a grid-sharded result, concatenated in rank
    order on every rank and cut to ``n_lat`` rows: the counterpart of
    ``np.asarray(global_array)[:n_lat]`` in the JAX package."""
    if mesh.size > 1:
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(parts, x.contiguous())
        x = torch.cat(parts)
    return x[:n_lat]


def _check_rows(mesh, height):
    if height % mesh.sp:
        raise ValueError(f"height {height} must divide by mesh sp={mesh.sp}")
    return height // mesh.sp


def _local_pixel_grid(mesh, rows, width, dtype):
    """Pixel-centre grid of this rank's row block (sp offset)."""
    row0 = mesh.sp_index * rows
    dev = mesh.device
    px = torch.arange(width, dtype=dtype, device=dev)[None, :].expand(rows, width)
    py = torch.arange(row0, row0 + rows, dtype=dtype, device=dev)[:, None]
    return px, py.expand(rows, width)


def _local_frames(mesh, n_frames):
    """This rank's slice of a stacked burst's frame axis: (first, count)."""
    if n_frames % mesh.dp:
        raise ValueError(f"batch {n_frames} must divide by mesh dp={mesh.dp}")
    per = n_frames // mesh.dp
    return mesh.dp_index * per, per


def _local_imgs(mesh, imgs, f0, nb, rows):
    """This rank's (nb, rows, w, C) block of the burst on its device; a
    host array crosses to the device in its own dtype, a device tensor
    does not cross at all."""
    r0 = mesh.sp_index * rows
    block = imgs[f0:f0 + nb, r0:r0 + rows]
    if not isinstance(block, torch.Tensor):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.to(mesh.device)


def _check_imgs(imgs, height, width, channels):
    if tuple(imgs.shape[1:]) != (height, width, channels):
        raise ValueError(f"imgs shape {tuple(imgs.shape[1:])} != "
                         f"({height}, {width}, {channels})")


def make_sharded_mosaic_step(mesh: Mesh, grid: GridSpec, height, width,
                             channels=3, dtype=torch.float32,
                             with_elevation=True, bin_method="sorted"):
    """The full pipeline step with the whole grid on every rank.

    step(dyn_params, imgs) -> (count, means)
      dyn_params: DynGeorefParams stacked over frames (leading axis B)
      imgs: (B, height, width, channels), host array or tensor
      count: (n_lat, n_lon), means: (n_lat, n_lon, channels[+1]) in
      ``dtype``, the same on every rank (last channel = mean elevation
      when with_elevation)

    Each rank bins its frames and rows (``ops.regrid.bin_partial`` with
    ``bin_method``; 'pallas' is K2's 'uint8' contract), the partials are
    summed in float64 across frames and by one ``all_reduce`` across
    ranks, and the mean is taken in ``dtype``. B must divide by mesh dp,
    height by sp.
    """
    rows = _check_rows(mesh, height)

    def run(dyn_params, imgs):
        _check_imgs(imgs, height, width, channels)
        f0, nb = _local_frames(mesh, imgs.shape[0])
        dyn = dyn_params.to(mesh.device, dtype)
        imgs_local = _local_imgs(mesh, imgs, f0, nb, rows).to(dtype)
        px, py = _local_pixel_grid(mesh, rows, width, dtype)
        shape = (grid.n_lat, grid.n_lon)
        n_ch = channels + (1 if with_elevation else 0)
        count = torch.zeros(shape, dtype=torch.float64, device=mesh.device)
        sums = torch.zeros(shape + (n_ch,), dtype=torch.float64,
                           device=mesh.device)
        for i in range(nb):
            out = georef_latlon_dyn(dyn.frame(f0 + i), px, py, dtype=dtype,
                                    with_elevation=with_elevation)
            data = imgs_local[i]
            if with_elevation:
                data = torch.cat([data, out["elevation"][..., None]], dim=-1)
            c, s = bin_partial(grid, out["lat"], out["lon"], data, bin_method)
            count += c
            sums += s
        if mesh.size > 1:
            dist.all_reduce(count)
            dist.all_reduce(sums)
        count, sums = count.to(dtype), sums.to(dtype)
        return count, finalize_mean(count, sums)

    return run


class GridShardedStep:
    """The step of :func:`make_grid_sharded_mosaic_step`.

    ``step(dyn, imgs)`` returns this rank's band of (count, means) — or of
    (count, sums) if built with ``finalize=False``. :meth:`partial` and
    :meth:`finish` split it in two: partials of several bursts add up
    (integer sums for the K1 branches, float64 for the others) and are
    finished once, so a sequence equals one step over all its frames.
    """

    def __init__(self, mesh, grid, height, width, channels, dtype,
                 with_elevation, bin_method, chunk_rows, finalize,
                 min_elevation):
        self.mesh, self.grid = mesh, grid
        self.height, self.width, self.channels = height, width, channels
        self.dtype, self.with_elevation = dtype, with_elevation
        self.bin_method, self.finalize = bin_method, finalize
        self.min_elevation = min_elevation
        self.rows = _check_rows(mesh, height)
        n_dev = mesh.size
        # 8-aligned rows per rank; rank r owns grid rows [r*band, (r+1)*band)
        self.band = round_up(-(-grid.n_lat // n_dev), 8)
        if chunk_rows is None:
            chunk_rows = max(8, round_up(self.band // n_dev, 8))
        self.chunk_rows = min(chunk_rows, self.band)
        self.n_chunks = -(-self.band // self.chunk_rows)
        self.n_ch = channels + (1 if with_elevation else 0)
        if min_elevation is not None and not with_elevation:
            raise ValueError("min_elevation needs with_elevation=True "
                             "(the mask tests the per-sample elevation)")
        if bin_method in _K1_BINNERS:
            if channels != 3 or not with_elevation:
                raise ValueError(
                    f"bin_method={bin_method!r} requires channels=3 + "
                    "with_elevation (K1's uint8 RGB+elevation contract)")
            if dtype != torch.float32:
                raise ValueError(f"bin_method={bin_method!r} georeferences "
                                 f"in float32 (K1's inputs), not {dtype}")
        elif bin_method not in _BIN_METHODS:
            raise ValueError(f"unknown bin_method {bin_method!r}")

    def __call__(self, dyn_params, imgs):
        return self.finish(self.partial(dyn_params, imgs))

    def partial(self, dyn_params, imgs):
        """This rank's band of the burst's sums, reduced over all ranks: a
        tuple of tensors that add elementwise across bursts."""
        _check_imgs(imgs, self.height, self.width, self.channels)
        f0, nb = _local_frames(self.mesh, imgs.shape[0])
        dyn = dyn_params.to(self.mesh.device, self.dtype)
        imgs_local = _local_imgs(self.mesh, imgs, f0, nb, self.rows)
        if self.bin_method in _K1_BINNERS:
            return self._partial_k1(dyn, imgs_local, f0, nb)
        return self._partial_index_add(dyn, imgs_local, f0, nb)

    def _keep(self, elev):
        # pre-binning sample mask (Mapping.maskedByElevation-before-
        # resample semantics); NaN elevation compares False -> invalid
        return elev >= self.min_elevation

    def _partial_k1(self, dyn, imgs_local, f0, nb):
        rows, w, dev = self.rows, self.width, self.mesh.device
        n = nb * rows
        iy = torch.empty((n, w), dtype=torch.int32, device=dev)
        ix = torch.empty_like(iy)
        elev = torch.empty((n, w), dtype=torch.float32, device=dev)
        # one frame's georeference at a time: only its bin indices and
        # elevation stay alive for the burst's single K1 call
        for i in range(nb):
            fiy, fix, out = georegrid_inputs(
                self.grid, dyn.frame(f0 + i), rows, w,
                row0=self.mesh.sp_index * rows)
            if self.min_elevation is not None:
                keep = self._keep(out["elevation"])
                fiy = torch.where(keep, fiy, -1)
                fix = torch.where(keep, fix, -1)
            sl = slice(i * rows, (i + 1) * rows)
            iy[sl], ix[sl], elev[sl] = fiy, fix, out["elevation"]
            del fiy, fix, out
        img_chw = torch.empty((3, n, w), dtype=torch.float32, device=dev)
        img_chw.view(3, nb, rows, w).copy_(imgs_local.permute(3, 0, 1, 2))
        # bin straight into the band-padded grid (the indices come from the
        # real grid, so rows >= n_lat never receive a sample); its rows are
        # already in rank order, so one reduce-scatter routes every band
        grid_pad = dataclasses.replace(self.grid,
                                       n_lat=self.band * self.mesh.size)
        cnt_rgb, elev_fixed = _K1_BINNERS[self.bin_method](
            grid_pad, iy, ix, img_chw, elev)
        return (_reduce_scatter_rows(self.mesh, cnt_rgb),
                _reduce_scatter_rows(self.mesh, elev_fixed))

    def _partial_index_add(self, dyn, imgs_local, f0, nb):
        grid, band, n_lon = self.grid, self.band, self.grid.n_lon
        cr, n_dev = self.chunk_rows, self.mesh.size
        px, py = _local_pixel_grid(self.mesh, self.rows, self.width,
                                   self.dtype)
        iys, ixs, valids, datas = [], [], [], []
        for i in range(nb):
            out = georef_latlon_dyn(dyn.frame(f0 + i), px, py,
                                    dtype=self.dtype,
                                    with_elevation=self.with_elevation)
            flat, valid = bin_indices(grid, out["lat"], out["lon"])
            data = imgs_local[i].to(torch.float64)
            if self.with_elevation:
                if self.min_elevation is not None:
                    valid &= self._keep(out["elevation"])
                data = torch.cat([data, out["elevation"].double()[..., None]],
                                 dim=-1)
            flat = flat.reshape(-1).long()
            iys.append(flat // n_lon)
            ixs.append(flat % n_lon)
            valids.append(valid.reshape(-1))
            datas.append(data.reshape(-1, self.n_ch))
        iy, ix = torch.cat(iys), torch.cat(ixs)
        valid = torch.cat(valids)
        data = torch.cat(datas)
        # NaN data at valid coordinates adds 0, and invalid samples nothing
        data = torch.where(valid[:, None] & ~torch.isnan(data), data, 0.0)
        band_id = iy // band
        rib = iy - band_id * band  # row inside the destination band
        chunk_bins = n_dev * cr * n_lon
        parts = []
        for c in range(self.n_chunks):
            sel = valid & (rib // cr == c)
            local_row = band_id * cr + (rib - c * cr)
            flat_local = torch.where(sel, local_row * n_lon + ix, chunk_bins)
            acc = _BIN_METHODS[self.bin_method](flat_local, data, chunk_bins)
            # rank d receives rows [d*cr, (d+1)*cr) of the stacked chunk:
            # chunk c of its own band
            parts.append(_reduce_scatter_rows(
                self.mesh, acc.reshape(n_dev * cr, n_lon, 1 + self.n_ch)))
        return (torch.cat(parts)[:band],)

    def finish(self, partial):
        """(count, means) — or (count, sums) without ``finalize`` — of
        this rank's band, in float32 for the K1 branches and in ``dtype``
        for the others; rows >= grid.n_lat are padding."""
        band_grid = dataclasses.replace(self.grid, n_lat=self.band)
        if self.bin_method in _K1_BINNERS:
            cnt_rgb, elev_fixed = partial
            most = int(cnt_rgb[:, 0].max().item())
            if most > _ELEV_INT64_MAX_COUNT:
                raise ValueError(f"a cell holds {most} samples: its int64 "
                                 "elevation sum could overflow")
            count, sums = finish_int_sums(band_grid, cnt_rgb, elev_fixed, "bf16")
        else:
            (acc,) = partial
            count = acc[..., 0].to(self.dtype)
            sums = acc[..., 1:].to(self.dtype)
        return count, (finalize_mean(count, sums) if self.finalize else sums)


def make_grid_sharded_mosaic_step(mesh: Mesh, grid: GridSpec, height, width,
                                  channels=3, dtype=torch.float32,
                                  with_elevation=True, bin_method="sorted",
                                  chunk_rows=None, finalize=True,
                                  min_elevation=None):
    """Mission-scale mosaic step: the GRID is sharded, not just the samples.

    Every rank OWNS one latitude band of the grid (band =
    round_up(ceil(n_lat / n_ranks), 8) rows, assigned by linear mesh index)
    and receives its band's sums from every rank by reduce-scatter, so no
    rank ever holds the finished global grid.

    ``bin_method='pallas'`` bins the rank's whole burst with ONE K1 call
    (:func:`auromat_tpu_torch.ops.georegrid.bin_rgbelev_int`: the CUDA
    kernel on a GPU, its plain version on the CPU) straight into the
    band-padded grid, and reduce-scatters the int64 sums once; the float32
    epilogue runs after the reduction, so the result does not depend on
    the number of ranks. ``'pallas_plain'`` is the same with K1's plain
    version on any device (the kernel's reference). Both need
    channels=3 + with_elevation and float32.

    Any other ``bin_method`` (a ``ops.regrid._BIN_METHODS`` name) bins in
    float64 with ``index_add_`` in row chunks of ``chunk_rows`` rows per
    band, one reduce-scatter a chunk, so the working accumulator stays at
    ranks * chunk_rows * n_lon cells.

    step(dyn_params, imgs) -> (count, means): this rank's band, shapes
    (band, n_lon) and (band, n_lon, channels[+1]); rows >= n_lat of the
    concatenated bands are padding (:func:`gather_bands`).
    ``finalize=False`` returns (count, sums). ``min_elevation`` (degrees)
    masks SAMPLES below the threshold before binning (needs
    ``with_elevation``).

    :param dyn_params: DynGeorefParams stacked over the B frames of the
        burst (every rank passes the whole burst)
    :param imgs: (B, height, width, channels) integer-valued 0..255; a
        host array or a tensor (a tensor already on the rank's device is
        used in place)
    """
    return GridShardedStep(mesh, grid, height, width, channels, dtype,
                           with_elevation, bin_method, chunk_rows, finalize,
                           min_elevation)


def sharded_batch_georef(mesh: Mesh, height, width, dtype=torch.float32,
                         with_elevation=True, with_mlatmlt=False):
    """Batched georef: frames over dp, rows over sp, no communication.

    fn(dyn_params) -> dict of (B / dp, height / sp, width) tensors (lat,
    lon, ...) on the rank's device: its frames' rows.
    """
    rows = _check_rows(mesh, height)

    def fn(dyn_params):
        f0, nb = _local_frames(mesh, dyn_params.cd.shape[0])
        dyn = dyn_params.to(mesh.device, dtype)
        px, py = _local_pixel_grid(mesh, rows, width, dtype)
        outs = [georef_latlon_dyn(dyn.frame(f0 + i), px, py, dtype=dtype,
                                  with_elevation=with_elevation,
                                  with_mlatmlt=with_mlatmlt)
                for i in range(nb)]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return fn
