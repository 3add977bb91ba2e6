"""Fetch mapping source data into a cache folder (the port's download CLI).

Counterpart of ``auromat_tpu.cli.download`` (reference
auromat/cli/download.py:41-94): provider esa-iss (by sequence id) or
themis (by date range).

    python -m auromat_tpu_torch.cli.download esa-iss FOLDER --id 77
    python -m auromat_tpu_torch.cli.download themis FOLDER \
        --start 2012-02-04 --end 2012-02-05 --stations fsmi gill

Downloading computes nothing, so the providers are made with
``device="cpu"`` and no card is needed.
"""

import argparse
import sys

from auromat_tpu_torch.timeutil import parse_cli_date as _parse_date


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m auromat_tpu_torch.cli.download",
        description="download mapping source data into a cache folder",
    )
    sub = p.add_subparsers(dest="provider", required=True)

    iss = sub.add_parser("esa-iss", help="ESA ISS auroral photography archive")
    iss.add_argument("folder", help="cache folder (one per sequence)")
    iss.add_argument("--id", type=int, required=True, help="sequence id")
    iss.add_argument("--start", type=_parse_date)
    iss.add_argument("--end", type=_parse_date)
    iss.add_argument("--no-raw", action="store_true", help="download JPEGs")

    themis = sub.add_parser("themis", help="THEMIS all-sky imager archive")
    themis.add_argument("folder", help="cache folder (L1+L2)")
    themis.add_argument("--start", type=_parse_date, required=True)
    themis.add_argument("--end", type=_parse_date, required=True)
    themis.add_argument("--stations", nargs="*", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.provider == "esa-iss":
        from auromat_tpu_torch.mapping.iss import ISSMappingProvider

        provider = ISSMappingProvider(args.folder, id_=args.id,
                                      useRaw=not args.no_raw, device="cpu")
        keys = provider.download(args.start, args.end)
        print(f"downloaded {len(keys)} frames")
    elif args.provider == "themis":
        from auromat_tpu_torch.mapping.themis import ThemisMappingProvider

        provider = ThemisMappingProvider(args.folder, args.folder,
                                         stations=args.stations, device="cpu")
        provider.download(args.start, args.end)
        print("download complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
