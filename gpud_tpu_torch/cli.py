"""Command line of the PyTorch/CUDA port.

``python -m gpud_tpu_torch fleet-scan DB... [--window S] [--flap-threshold N]
[--crc-threshold N] [--json] [--device cuda|cpu]`` prints what
``tpud fleet-scan`` prints. The scan runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import List, Optional


def cmd_fleet_scan(args) -> int:
    """Fleet-wide link-history sweep (gpud_tpu_torch/fleet_scan.py)."""
    from gpud_tpu_torch.fleet_scan import fleet_scan

    res = fleet_scan(
        args.dbs,
        window_seconds=args.window,
        flap_threshold=args.flap_threshold,
        crc_threshold=args.crc_threshold,
        device=args.device,
    )
    if args.as_json:
        print(json.dumps(res, indent=2, sort_keys=True))
    else:
        s = res["summary"]
        print(
            f"{len(res['links'])} links across {len(args.dbs)} host DB(s) "
            f"on {res['devices']} device(s): "
            f"{s['healthy']} healthy, {s['degraded']} degraded, "
            f"{s['unhealthy']} unhealthy"
        )
        for name, label in sorted(res["links"].items()):
            if label != "healthy":
                print(f"  {label:9s}  {name}")
    return 1 if res["summary"]["unhealthy"] else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gpud_tpu_torch",
        description="tpud's accelerator tools on an NVIDIA GPU",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pfs = sub.add_parser(
        "fleet-scan",
        help="accelerated sweep over many hosts' link history DBs",
    )
    pfs.add_argument("dbs", nargs="+", help="per-host tpud state DB files")
    pfs.add_argument("--window", type=float, default=3600.0,
                     help="scan window in seconds")
    pfs.add_argument("--flap-threshold", type=int, default=3)
    pfs.add_argument("--crc-threshold", type=int, default=100)
    pfs.add_argument("--json", action="store_true", dest="as_json",
                     help="print the full result as JSON")
    pfs.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                     help="where the scan runs (default: the card)")
    pfs.set_defaults(fn=cmd_fleet_scan)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return args.fn(args)
