"""Command line of the PyTorch/CUDA port.

``python -m gpud_tpu_torch scan [--accelerator-type T] [--strict] [--json]``
checks this host's GPUs once (through NVML, or the mock backend under
``TPUD_GPU_MOCK_ALL_SUCCESS=1``) and prints the check table of ``tpud scan``.

``python -m gpud_tpu_torch fleet-scan DB... [--window S] [--flap-threshold N]
[--crc-threshold N] [--json] [--device cuda|cpu]`` prints what
``tpud fleet-scan`` prints. The scan runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import sys
from typing import List, Optional


def cmd_scan(args) -> int:
    """One-shot health scan of this host's GPUs (gpud_tpu_torch/scan.py)."""
    from gpud_tpu_torch.api.v1.types import HealthStateType
    from gpud_tpu_torch.scan import scan

    sink = io.StringIO() if args.as_json else sys.stdout
    results = scan(accelerator_type=args.accelerator_type, out=sink)
    if args.as_json:
        rows = [{
            "component": r.component_name(),
            "health": r.health_state_type(),
            "reason": r.summary(),
            "extra_info": dict(r.extra_info),
            "repair_actions": list(r.suggested_actions.repair_actions)
            if r.suggested_actions else [],
        } for r in results]
        print(json.dumps(rows, indent=2))
    unhealthy = [r for r in results if r.health_state_type() != HealthStateType.HEALTHY]
    return 1 if unhealthy and args.strict else 0


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

    ps = sub.add_parser("scan", help="one-shot health scan of this host's GPUs")
    ps.add_argument("--accelerator-type", default="",
                    help="e.g. h100-sxm-8 (default: from the enumerated GPUs)")
    ps.add_argument("--strict", action="store_true", help="exit 1 on any unhealthy check")
    ps.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable results instead of the table")
    ps.set_defaults(fn=cmd_scan)

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
