"""Entry points of the port (counterparts of ``__graft_entry__``).

``entry()``: the main path, the fused georeference + regrid forward of one
real 12 MP ISS DSLR frame onto the fixed global plate-carree grid.

    fn, (img,) = entry()          # on the GPU
    count, means = fn(img)        # (539, 524) and (539, 524, 4)

``dryrun_multichip(n)``: the multi-rank mosaic steps in ``n`` gloo
processes on the CPU at tiny shapes, held bit for bit against the same
steps on a world of one.

    python -m auromat_tpu_torch.entry 4
"""

import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch

from auromat_tpu_torch.coordinates.wcs import TanWcs
from auromat_tpu_torch.io import fits
from auromat_tpu_torch.ops.georef import (DynGeorefParams, GeorefParams,
                                          compute_device)
from auromat_tpu_torch.ops.georegrid import georegrid_mean
from auromat_tpu_torch.ops.regrid import fixed_grid

FRAME_WCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "tests", "resources", "ISS030-E-102170_dc.wcs")


def frame_setup(device="cuda"):
    """The main path's frame and grid: (grid, dyn, params).

    The calibration is the astrometry.net solution of ISS030-E-102170
    (4256x2832, 12.05 MPix); the grid covers the frame at ~100 arcsec per
    cell (36 x 25 cells per degree, 539 x 524 cells).
    """
    device = compute_device(device)
    header = fits.read_header(FRAME_WCS)
    params = GeorefParams.from_wcs(
        TanWcs(header),
        fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_shifted_photo_time(header),
        altitude=110.0,
    )
    dyn = DynGeorefParams.from_static(params, device=device, dtype=torch.float32)
    grid = fixed_grid((36, 25), 47.0, 62.0, -112.0, -91.0)
    return grid, dyn, params


def entry(device="cuda"):
    """(fn, example_args): ``fn(img_chw, mask=None) -> (count, means)``
    georeferences and mean-regrids one (3, h, w) frame on ``device``."""
    grid, dyn, params = frame_setup(device)

    def forward(img_chw, mask=None):
        return georegrid_mean(grid, dyn, img_chw, mask)

    example_img = torch.zeros((3, params.height, params.width),
                              dtype=torch.float32, device=dyn.cd.device)
    return forward, (example_img,)


def _dryrun_frames(dp, sp):
    """The dry run's burst: 2 frames per dp rank, 16 rows per sp rank, 64
    columns — the real ISS030-E-102170 calibration scaled down, each axis
    by its own factor so that the whole field of view (its upper part is
    sky) fits any height; each frame 2 km further along the track;
    integer-valued 0..255 imagery."""
    from auromat_tpu_torch.coordinates.wcs import TanWcs
    from auromat_tpu_torch.io import fits
    from auromat_tpu_torch.ops.georef import GeorefParams

    header = fits.read_header(FRAME_WCS)
    base = GeorefParams.from_wcs(
        TanWcs(header), fits.get_shifted_spacecraft_position(header)[:3],
        fits.get_shifted_photo_time(header), 110.0)
    n_frames, h, w = 2 * dp, 16 * sp, 64
    sx, sy = base.width / w, base.height / h
    frames = [GeorefParams(
        width=w, height=h,
        cd=tuple((row[0] * sx, row[1] * sy) for row in base.cd),
        px_ref=base.px_ref / sx, py_ref=base.py_ref / sy,
        rotmat=base.rotmat,
        camera_pos=tuple(c + 2.0 * i for c in base.camera_pos),
        altitude=base.altitude, mat_j2000_to_geo=base.mat_j2000_to_geo,
        mat_j2000_to_sm=base.mat_j2000_to_sm) for i in range(n_frames)]
    imgs = np.random.default_rng(0).integers(
        0, 256, (n_frames, h, w, 3)).astype(np.float32)
    return frames, imgs


def _dryrun_results(mesh, dp, sp):
    """Every mosaic step of the port on ``mesh`` over the dry run's burst
    for a (dp, sp) mesh, with the dry run's asserts; the results gathered
    to every rank as numpy arrays."""
    from auromat_tpu_torch.ops.georef import DynGeorefParams
    from auromat_tpu_torch.ops.regrid import fixed_grid
    from auromat_tpu_torch.parallel import (gather_bands,
                                            make_grid_sharded_mosaic_step,
                                            make_sharded_mosaic_step,
                                            mosaic_sequence)

    frames, imgs = _dryrun_frames(dp, sp)
    n_frames, h, w = imgs.shape[:3]
    dyn = DynGeorefParams.stack(frames, device=mesh.device)
    out = {}
    grid = fixed_grid(2, 30.0, 75.0, -140.0, -60.0)
    count, means = make_sharded_mosaic_step(mesh, grid, h, w)(dyn, imgs)
    out["psum_count"], out["psum_means"] = count, means
    if not count.sum() > 0:
        raise AssertionError("dry run produced no binned samples")

    # the GRID sharded: each rank owns a latitude band
    gg = fixed_grid(2, -89.0, 89.0, -179.0, 179.0)
    band = (-(-gg.n_lat // mesh.size) + 7) // 8 * 8
    for method in ("sorted", "pallas"):
        step = make_grid_sharded_mosaic_step(mesh, gg, h, w,
                                             bin_method=method)
        c, m = step(dyn, imgs)
        if tuple(c.shape) != (band, gg.n_lon) or \
                tuple(m.shape) != (band, gg.n_lon, 4):
            raise AssertionError(f"{method}: rank {mesh.rank} holds "
                                 f"{tuple(c.shape)}, not a {band}-row band")
        out[f"{method}_count"] = gather_bands(mesh, c, gg.n_lat)
        out[f"{method}_means"] = gather_bands(mesh, m, gg.n_lat)
    if out["sorted_count"].sum() != count.sum():
        raise AssertionError("grid-sharded and psum count totals differ")
    # counts and integer channels bit-exact across binning branches;
    # elevation within the float64-vs-fixed-point class of the JAX dry run
    sm, pm = out["sorted_means"], out["pallas_means"]
    if not torch.equal(out["sorted_count"], out["pallas_count"]) or \
            not torch.equal(sm[..., :3].nan_to_num(-1.0),
                            pm[..., :3].nan_to_num(-1.0)):
        raise AssertionError("pallas vs index-add: counts or RGB differ")
    ok = ~torch.isnan(sm[..., 3])
    if not torch.allclose(pm[..., 3][ok], sm[..., 3][ok], rtol=0, atol=0.01):
        raise AssertionError("pallas vs index-add: elevation")

    # the provider-burst -> sequence shape: two bursts, the second padded
    # with null frames, equal to the single step bit for bit
    c, m = mosaic_sequence(mesh, gg, [(frames[:-1], imgs[:-1]),
                                      (frames[-1:], imgs[-1:])],
                           batch=n_frames)
    out["seq_count"] = gather_bands(mesh, c, gg.n_lat)
    out["seq_means"] = gather_bands(mesh, m, gg.n_lat)
    if not torch.equal(out["seq_count"], out["pallas_count"]) or \
            not torch.equal(out["seq_means"].nan_to_num(-1.0),
                            pm.nan_to_num(-1.0)):
        raise AssertionError("mosaic_sequence != one step")
    return {k: v.cpu().numpy() for k, v in out.items()}


def _dryrun_rank(rank, n, init_method, out_dir, timeout):
    """One rank of :func:`dryrun_multichip` (run in its own process)."""
    import torch.distributed as dist

    from auromat_tpu_torch.parallel.sharding import factorise, make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=n, timeout=timedelta(seconds=timeout))
    try:
        mesh = make_mesh(device="cpu")
        res = _dryrun_results(mesh, *factorise(n))
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), **res)
    finally:
        dist.destroy_process_group()


DRYRUN_TIMEOUT = 180.0  # seconds each dry-run rank may take, start included


def dryrun_multichip(n_devices: int):
    """Run every mosaic step on an ``n_devices``-rank mesh of gloo
    processes on the CPU and hold it against a world of one.

    The ranks rendezvous through a file in a temporary directory (no
    network port) and each must finish within :data:`DRYRUN_TIMEOUT`
    seconds, or all are killed and this raises. Inside, every rank checks the JAX dry
    run's asserts: it holds a band-sized shard; the K1 and index-add
    branches agree bit for bit on counts and RGB; the all-reduce step's
    count total equals the grid-sharded one's; ``mosaic_sequence`` over
    two bursts with a padded remainder equals one step. Then the gathered
    results must equal those of a world of one bit for bit.

    :returns: dict of the gathered results (numpy arrays)
    """
    from auromat_tpu_torch.parallel.sharding import factorise, make_mesh

    dp, sp = factorise(n_devices)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(n_devices)]
        procs = [subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from auromat_tpu_torch.entry import _dryrun_rank; "
             "_dryrun_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
             "sys.argv[4], float(sys.argv[5]))",
             str(r), str(n_devices), init, tmp, str(DRYRUN_TIMEOUT)],
            env=env, cwd=repo, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n_devices)]
        deadline = time.monotonic() + DRYRUN_TIMEOUT
        try:
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks still "
                               f"running after {DRYRUN_TIMEOUT} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            with open(os.path.join(tmp, f"rank{failed[0]}.log")) as f:
                log = f.read()
            raise RuntimeError(f"dryrun_multichip({n_devices}): ranks "
                               f"{failed} failed; rank {failed[0]}:\n{log}")
        with np.load(os.path.join(tmp, "rank0.npz")) as z:
            got = dict(z)
    want = _dryrun_results(make_mesh(device="cpu"), dp, sp)
    for k, v in want.items():
        if not np.array_equal(got[k], v, equal_nan=True):
            raise AssertionError(f"dryrun_multichip({n_devices}): {k} != "
                                 "the world of one")
    print(f"dryrun_multichip OK: {n_devices} gloo ranks, mesh dp={dp} "
          f"sp={sp}; {int(want['psum_count'].sum())} samples; every step "
          f"equal to the world of one")
    return got


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
