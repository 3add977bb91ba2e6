"""Provider burst -> grid-sharded mosaic: the sequence-mosaic production path.

Counterpart of ``auromat_tpu.parallel.mosaic``: bursts of same-shaped
frames (e.g. ``SpacecraftMappingProvider.iterParamBursts``) stream through
the grid-sharded step (:func:`~auromat_tpu_torch.parallel.sharding.
make_grid_sharded_mosaic_step`), the partial sums of the bursts add up with
the row-band sharding intact, and the mean is taken once at the end. With
``bin_method='pallas'`` the partials are K1's integer sums, so a sequence
of any number of bursts equals one step over all its frames bit for bit,
elevation included.

Remainder bursts are padded to the batch size with
:func:`null_georef_params` frames, which contribute exactly nothing, so
every burst has the shape of the first and divides over the ranks.
"""

import functools

import numpy as np
import torch

from auromat_tpu_torch.ops.georef import DynGeorefParams, GeorefParams
from auromat_tpu_torch.ops.regrid import GridSpec, finalize_mean
from auromat_tpu_torch.parallel.sharding import (Mesh,
                                                 make_grid_sharded_mosaic_step)

_EYE3 = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


def null_georef_params(like: GeorefParams) -> GeorefParams:
    """A same-shaped frame that contributes NOTHING to any mosaic.

    The camera sits 1e9 km up the +z axis with an identity rotation, so
    every pixel ray has a positive z component (n = u / sqrt(x^2 + y^2 +
    u^2) > 0 in the TAN unprojection) and points away from the ellipsoid:
    the intersection's b term is negative and the near root b - sqrt(.)
    negative too (or its square root NaN), so every ray misses in any
    floating-point precision, on any device. lat/lon are NaN, every sample
    is invalid, and the frame adds exactly zero to every count and sum.
    """
    return GeorefParams(
        width=like.width, height=like.height, cd=like.cd,
        px_ref=like.px_ref, py_ref=like.py_ref, rotmat=_EYE3,
        camera_pos=(0.0, 0.0, 1.0e9), altitude=like.altitude,
        mat_j2000_to_geo=_EYE3, mat_j2000_to_sm=_EYE3,
    )


@functools.lru_cache(maxsize=8)
def _step_for(mesh, grid, h, w, dtype, bin_method, chunk_rows, min_elevation):
    """The grid-sharded step of one frame shape, shared across
    mosaic_sequence calls; bounded, least recently used first out."""
    return make_grid_sharded_mosaic_step(
        mesh, grid, h, w, channels=3, dtype=dtype, bin_method=bin_method,
        chunk_rows=chunk_rows, finalize=False, min_elevation=min_elevation)


def mosaic_sequence(mesh: Mesh, grid: GridSpec, bursts, batch=8,
                    bin_method="pallas", dtype=torch.float32,
                    chunk_rows=None, min_elevation=None):
    """Mosaic a whole frame sequence through the grid-sharded step.

    :param bursts: iterable of (params_list, imgs) — same-shaped frame
        groups. ``params_list`` is a list of :class:`GeorefParams`;
        ``imgs`` is (B, h, w, 3), integer-valued 0..255 (K1's contract): a
        host array, or a tensor, which stays where it is (a tensor on the
        mesh device never crosses to the host). Groups may have ANY length;
        they are re-chunked and padded to ``batch``.
    :param batch: frames per step call; must divide by mesh dp
    :param min_elevation: mask samples below this elevation (degrees)
        BEFORE binning — the per-pixel ``maskedByElevation`` semantics of
        the per-frame convert path, inside the step
    :returns: (count, means) of this rank's band, shapes (band, n_lon) and
        (band, n_lon, 4); means channels are (R, G, B, elevation), NaN
        where empty; rows >= grid.n_lat of the concatenated bands are
        padding (:func:`~auromat_tpu_torch.parallel.sharding.gather_bands`)
    """
    if batch % mesh.dp != 0:
        raise ValueError(f"batch {batch} must divide by mesh dp={mesh.dp}")
    total = None
    step = None

    def run_chunk(params, imgs):
        nonlocal total, step
        n = len(params)
        h, w = imgs.shape[1:3]
        if n < batch:  # pad to the batch size with null frames
            params = list(params) + [null_georef_params(params[0])] * (batch - n)
            pad = (batch - n,) + tuple(imgs.shape[1:])
            if isinstance(imgs, torch.Tensor):
                imgs = torch.cat([imgs, imgs.new_zeros(pad)])
            else:
                imgs = np.concatenate([imgs, np.zeros(pad, imgs.dtype)])
        step = _step_for(mesh, grid, h, w, dtype, bin_method, chunk_rows,
                         min_elevation)
        dyn = DynGeorefParams.stack(params, dtype=dtype, device=mesh.device)
        part = step.partial(dyn, imgs)
        total = part if total is None else tuple(
            a.add_(b) for a, b in zip(total, part))

    for params_list, imgs in bursts:
        params_list = list(params_list)
        if not isinstance(imgs, torch.Tensor):
            imgs = np.asarray(imgs)
        for i in range(0, len(params_list), batch):
            run_chunk(params_list[i:i + batch], imgs[i:i + batch])

    if total is None:
        raise ValueError("empty sequence: no frames to mosaic")
    count, sums = step.finish(total)
    return count, finalize_mean(count, sums)
