"""Convert cached mapping data to CDF/netCDF files (the port's convert CLI).

Counterpart of ``auromat_tpu.cli.convert`` (reference
auromat/cli/convert.py:148-218): detects the source type of a data folder,
optionally masks by elevation and resamples onto a geographic or magnetic
(MLat/MLT) grid, and exports each mapping with skip/overwrite logic — or, with ``--mosaic``,
streams the whole sequence through the grid-sharded mosaic
(:func:`auromat_tpu_torch.parallel.mosaic_sequence`, K1 on every burst)
into ONE file.

    python -m auromat_tpu_torch.cli.convert FOLDER --mosaic 0.05 --platform cuda
    torchrun --nproc_per_node=N -m auromat_tpu_torch.cli.convert FOLDER \
        --mosaic 0.05 --platform cuda      # one GPU per process

    python -m auromat_tpu_torch.cli.convert THEMIS_FOLDER --grid geo
    python -m auromat_tpu_torch.cli.convert FOLDER --grid mag --platform cuda

Under ``torchrun`` every rank streams the sequence, bins its share of each
burst's frames on its own GPU, and rank 0 writes the file. Source types:
spacecraft folders (image + .wcs pairs), ESA ISS archive caches (api.json,
metadata.json, frames and .wcs files; missing frames are downloaded),
THEMIS L1/L2 CDF caches (offline: nothing is downloaded) and MIRACLE
folders (images + cal.txt); a THEMIS or MIRACLE tick is a
MappingCollection, and each member becomes one file.
"""

import argparse
import fnmatch
import os
import sys

import torch

from auromat_tpu_torch.timeutil import parse_cli_date as _parse_date


def detect_source_type(folder):
    files = os.listdir(folder)
    if "api.json" in files:
        return "iss"
    if fnmatch.filter(files, "thg_l1_*"):
        return "themis"
    if "cal.txt" in files:
        return "miracle"
    if fnmatch.filter(files, "*.wcs"):
        return "spacecraft"
    raise ValueError(f"cannot detect mapping source type in {folder}")


def make_provider(source_type, folder, altitude, fast_center=True,
                  device="cuda"):
    if source_type == "spacecraft":
        from auromat_tpu_torch.mapping.spacecraft import \
            SpacecraftMappingProvider

        return SpacecraftMappingProvider(folder, folder, altitude=altitude,
                                         fast_center=fast_center,
                                         device=device)
    if source_type == "themis":
        from auromat_tpu_torch.mapping.themis import ThemisMappingProvider

        return ThemisMappingProvider(folder, folder, altitude=altitude,
                                     offline=True, device=device)
    if source_type == "miracle":
        from auromat_tpu_torch.mapping.miracle import MIRACLEMappingProvider

        return MIRACLEMappingProvider(folder, altitude=altitude,
                                      device=device)
    if source_type == "iss":
        from auromat_tpu_torch.mapping.iss import ISSMappingProvider

        return ISSMappingProvider(folder, altitude=altitude, offline=False,
                                  fastCenterCalculation=fast_center,
                                  device=device)
    raise ValueError(source_type)


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m auromat_tpu_torch.cli.convert",
        description="convert cached mapping data to CDF/netCDF files",
    )
    src = p.add_argument_group("input")
    src.add_argument("folder", help="data folder (source type auto-detected)")
    src.add_argument("--start", type=_parse_date, help="sequence start date")
    src.add_argument("--end", type=_parse_date, help="sequence end date (inclusive)")
    src.add_argument("--altitude", type=float, default=110,
                     help="emission altitude in km (default 110)")

    proc = p.add_argument_group("processing")
    proc.add_argument("--grid", choices=["none", "geo", "mag"], default="none",
                      help="resample onto a geographic or magnetic grid")
    proc.add_argument("--arcsecperpx", type=float, default=100,
                      help="grid resolution in arcsec/px (default 100)")
    proc.add_argument("--min-elevation", type=float, default=None,
                      help="mask pixels below this elevation before resampling")
    proc.add_argument("--precision", choices=["float64", "float32"],
                      default="float64", help="per-frame compute precision")
    proc.add_argument("--batched", type=int, default=0, metavar="N",
                      help="georeference N frames per burst (float32; "
                           "spacecraft sources only; 0 = per-frame float64); "
                           "with --mosaic, the burst size")
    proc.add_argument("--mosaic", type=float, default=None, metavar="DEG",
                      help="mosaic the WHOLE sequence into one plate-"
                           "carree grid at DEG degrees/cell (e.g. 0.05 = "
                           "the global production grid) and write a single "
                           "file: provider bursts stream through the grid-"
                           "sharded mosaic (parallel.mosaic_sequence); "
                           "spacecraft sources only")
    proc.add_argument("--mosaic-extent", type=float, nargs=4, default=None,
                      metavar=("S", "N", "W", "E"),
                      help="restrict the --mosaic grid to this lat/lon box "
                           "(default: global)")
    proc.add_argument("--platform", choices=["cuda", "cpu"], default="cuda",
                      help="where to compute: cuda (default; fails without "
                           "a CUDA device) or cpu")

    out = p.add_argument_group("output")
    out.add_argument("--format", choices=["cdf", "netcdf"], default="cdf")
    out.add_argument("--out", default=None, help="output folder (default: input)")
    out.add_argument("--overwrite", action="store_true",
                     help="overwrite existing output files")
    out.add_argument("--without-bounds", action="store_true",
                     help="omit pixel-corner coordinates")
    out.add_argument("--without-mag", action="store_true",
                     help="omit MLat/MLT coordinates")
    return p


def platform_device(platform):
    """The compute device for ``--platform``: CUDA is never replaced by
    the CPU unasked — 'cuda' without a CUDA device raises. Under a
    multi-process launch the CUDA device is ``cuda:LOCAL_RANK``."""
    from auromat_tpu_torch.ops.georef import compute_device
    from auromat_tpu_torch.parallel.distributed import local_device

    return compute_device(local_device(platform))


def _writer(fmt):
    if fmt == "cdf":
        from auromat_tpu_torch.export import cdf as writer
    else:
        from auromat_tpu_torch.export import netcdf as writer
    return writer


def convert_mapping(mapping, args, out_folder, device="cuda"):
    from auromat_tpu_torch.resample import resample, resample_mlat_mlt

    # skip-existing BEFORE the expensive mask+resample (the identifier is
    # unchanged by resampling)
    ext = ".cdf" if args.format == "cdf" else ".nc"
    out_path = os.path.join(out_folder, f"{mapping.identifier}{ext}")
    if os.path.exists(out_path) and not args.overwrite:
        print(f"skipping {out_path} (exists)")
        return out_path
    if args.min_elevation is not None:
        mapping = mapping.maskedByElevation(args.min_elevation)
    if args.grid == "geo":
        mapping = resample(mapping, arcsec_per_px=args.arcsecperpx,
                           method="mean", device=device)
    elif args.grid == "mag":
        mapping = resample_mlat_mlt(mapping, arcsec_per_px=args.arcsecperpx,
                                    method="mean", device=device)
    _writer(args.format).write(out_path, mapping,
                               includeBounds=not args.without_bounds,
                               includeMagCoords=not args.without_mag)
    print(f"wrote {out_path}")
    return out_path


def convert_mosaic(provider, args, out_folder, device="cuda"):
    """Stream the whole sequence through the grid-sharded mosaic
    (parallel.mosaic_sequence, K1 binning) and write ONE file (rank 0).

    The reference's convert loop writes one file per frame
    (auromat/cli/convert.py:176-218); the sequence mosaic has no
    reference counterpart.
    """
    import numpy as np

    from auromat_tpu_torch.ops.regrid import fixed_grid
    from auromat_tpu_torch.parallel import (gather_bands, global_mesh,
                                            mosaic_sequence)
    from auromat_tpu_torch.resample import _finalize_int_image, grid_mapping

    if not hasattr(provider, "iterParamBursts"):
        print("error: --mosaic needs a spacecraft source (image+wcs pairs)",
              file=sys.stderr)
        return None
    # validate the cheap host-side arguments BEFORE the skip-existing
    # early return: an invalid invocation fails even when the output exists
    if not args.mosaic > 0:
        print(f"error: --mosaic must be a positive deg/cell size, got "
              f"{args.mosaic}", file=sys.stderr)
        return None
    if args.mosaic_extent is not None:
        s, n, w, e = args.mosaic_extent
        if not (-90.0 <= s < n <= 90.0) or not (-180.0 <= w < e <= 180.0):
            print("error: --mosaic-extent wants SOUTH NORTH WEST EAST with "
                  f"south < north and west < east (no antimeridian "
                  f"crossing); got {args.mosaic_extent}", file=sys.stderr)
            return None
    # skip-existing next (the identifier derives from the folder alone):
    # resume must not pay the whole sequence stream
    identifier = (os.path.basename(os.path.normpath(args.folder))
                  + ".mosaic")
    ext = ".cdf" if args.format == "cdf" else ".nc"
    out_path = os.path.join(out_folder, f"{identifier}{ext}")
    if os.path.exists(out_path) and not args.overwrite:
        print(f"skipping {out_path} (exists)")
        return out_path
    if args.mosaic_extent is None:
        # global; epsilon keeps the inclusive +-90/+-180 edges out of the
        # open-ended last bin (the shape of the config-5 grid)
        s, n, w, e = -89.999, 89.999, -179.999, 179.999
    grid = fixed_grid(1.0 / args.mosaic, s, n, w, e)
    # frames data-parallel over every rank; the GRID is row-band sharded
    # over the whole mesh either way, so sp=1 keeps any frame height
    mesh = global_mesh(sp=1, device=device)
    dp = mesh.dp
    batch = max(args.batched or 8, dp)
    batch = -(-batch // dp) * dp
    print(f"mosaicking onto a {grid.n_lat} x {grid.n_lon} grid "
          f"({args.mosaic} deg/cell), {dp}-rank mesh on {device}, burst "
          f"size {batch}, K1 binning")
    # the product's time stamp = first frame ACTUALLY included
    first, _ = provider.timeRange(args.start, args.end)
    if first is None:
        print("error: no timed frames in the requested range",
              file=sys.stderr)
        return None
    count, means = mosaic_sequence(
        mesh, grid, provider.iterParamBursts(args.start, args.end,
                                             batch=batch), batch=batch,
        bin_method="pallas", min_elevation=args.min_elevation)
    count = gather_bands(mesh, count, grid.n_lat).cpu().numpy()
    means = gather_bands(mesh, means, grid.n_lat).cpu().numpy()
    occupied = int((count > 0).sum())
    if mesh.rank == 0:
        means = means.astype(np.float64)
        img_r = _finalize_int_image(means[..., :3], np.uint8)
        mapping = grid_mapping(grid, img_r, means[..., 3], provider.altitude,
                               first, identifier)
        _writer(args.format).write(out_path, mapping,
                                   includeBounds=not args.without_bounds,
                                   includeMagCoords=not args.without_mag)
        print(f"wrote {out_path} ({occupied} occupied cells)")
    return out_path


def main(argv=None):
    from auromat_tpu_torch.parallel import initialize

    args = build_parser().parse_args(argv)
    device = platform_device(args.platform)
    initialize(device.type)
    source_type = detect_source_type(args.folder)
    print(f"detected source type: {source_type}")
    provider = make_provider(source_type, args.folder, args.altitude,
                             device=device)
    if args.precision == "float32" and hasattr(provider, "dtype"):
        provider.dtype = torch.float32
    out_folder = args.out or args.folder
    os.makedirs(out_folder, exist_ok=True)

    if args.mosaic is not None:
        return 0 if convert_mosaic(provider, args, out_folder, device) else 1

    if args.batched and hasattr(provider, "getSequenceBatched"):
        seq = provider.getSequenceBatched(args.start, args.end,
                                          batch=args.batched,
                                          with_mlatmlt=not args.without_mag)
    else:
        if args.batched:
            print("warning: --batched unsupported for this source; using the "
                  "per-frame path", file=sys.stderr)
        seq = provider.getSequence(args.start, args.end)
    from auromat_tpu_torch.mapping.mapping import MappingCollection

    count = 0
    for item in seq:
        members = (item.mappings if isinstance(item, MappingCollection)
                   else [item])
        for mapping in members:
            convert_mapping(mapping, args, out_folder, device)
            count += 1
    print(f"converted {count} mappings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
