"""The benchmark's plain reference against the port, on the CPU at small
sizes (this test may import both; the reference itself imports nothing of
the port)."""

import ast
import os

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.harness import find_cell
from benchmark.reference import frames, georef, grid as rgrid

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {c: find_cell(w).config for w, c in (("iss030_fused", "iss030_dslr_100as"),
                                               ("iss029_mosaic_seq16", "iss029_seq_global005"))}


def test_reference_imports_nothing_of_the_program():
    for f in sorted(os.listdir(os.path.join(HERE, "reference"))):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(HERE, "reference", f)).read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        tops = {n.split(".")[0] for n in names if n}
        assert not tops & {"auromat_tpu_torch", "auromat_tpu", "jax", "jaxlib"}, (f, tops)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_georef_matches_the_ports_float64_chain(config):
    from auromat_tpu_torch.coordinates.wcs import TanWcs
    from auromat_tpu_torch.mapping.spacecraft import resolve_camera_position
    from auromat_tpu_torch.ops.georef import (DynGeorefParams, GeorefParams,
                                              georef_latlon_dyn)

    cfg = CONFIGS[config]
    for (path, cards), cal in zip(inputs.frames(cfg), inputs.calibrations(cfg)):
        header = inputs.program_header(path, cards)
        pos, t, _ = resolve_camera_position(header)
        assert t == cal.photo_time and tuple(pos) == cal.camera_pos
        p = GeorefParams.from_wcs(TanWcs(header), pos, t, cfg["altitude_km"])
        dyn = DynGeorefParams.from_static(p, device="cpu", dtype=torch.float64)
        ys = torch.arange(0, cal.height, 61, dtype=torch.float64)
        xs = torch.arange(0, cal.width, 67, dtype=torch.float64)
        py, px = torch.meshgrid(ys, xs, indexing="ij")
        want = georef_latlon_dyn(dyn, px, py, dtype=torch.float64, with_elevation=True)
        lat, lon, elev = georef.georef(cal, cfg["altitude_km"], px, py)
        hit = ~torch.isnan(want["lat"])
        assert torch.equal(hit, ~torch.isnan(lat)) and hit.float().mean() > 0.3
        for ours, key in ((lat, "lat"), (lon, "lon"), (elev, "elevation")):
            assert (ours - want[key])[hit].abs().max() < 1e-9, key


def test_frame_matrix_matches_the_port():
    from auromat_tpu_torch.coordinates.frames import FrameMatrices

    for cal in inputs.calibrations(CONFIGS["iss029_seq_global005"]):
        np.testing.assert_allclose(frames.j2000_to_geo(cal.photo_time),
                                   FrameMatrices(cal.photo_time).j2000_to_geo,
                                   rtol=0, atol=1e-14)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_grid_and_cells_match_the_port(config):
    from auromat_tpu_torch.ops.regrid import bin_indices, fixed_grid

    g = CONFIGS[config]["grid"]
    ppd = tuple(g["px_per_deg"]) if isinstance(g["px_per_deg"], list) else g["px_per_deg"]
    ours, port = rgrid.fixed_grid(ppd, *g["lat"], *g["lon"]), fixed_grid(ppd, *g["lat"], *g["lon"])
    for f in ("n_lat", "n_lon", "lat0", "lon0", "lat_step", "lon_step"):
        assert getattr(ours, f) == getattr(port, f), f
    gen = torch.Generator().manual_seed(3)
    lat = g["lat"][0] - 1 + (g["lat"][1] - g["lat"][0] + 2) * torch.rand(200_000, generator=gen,
                                                                        dtype=torch.float64)
    lon = g["lon"][0] - 1 + (g["lon"][1] - g["lon"][0] + 2) * torch.rand(200_000, generator=gen,
                                                                        dtype=torch.float64)
    lat[::97] = torch.nan
    flat, valid = bin_indices(port, lat, lon)
    assert torch.equal(rgrid.cells(ours, lat, lon), torch.where(valid, flat.long(), -1))
