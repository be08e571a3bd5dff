"""Command line of the PyTorch/CUDA port.

``python -m gpud_tpu_torch scan [--accelerator-type T] [--strict] [--json]``
checks this host's GPUs once (through NVML, or the mock backend under
``TPUD_GPU_MOCK_ALL_SUCCESS=1``) and prints the check table of ``tpud scan``.

``python -m gpud_tpu_torch fleet-scan DB... [--window S] [--flap-threshold N]
[--crc-threshold N] [--json] [--device cuda|cpu]`` prints what
``tpud fleet-scan`` prints. The scan runs on the card unless ``--device cpu``.

``compact``, ``metadata``, ``history`` and ``remediation`` (each with
``--data-dir``) read the daemon's state DB offline, daemon up or not, and
print what ``tpud``'s subcommands of the same names print.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from typing import List, Optional

from gpud_tpu_torch import config as cfgmod
from gpud_tpu_torch.log import AuditLogger, set_audit_logger, setup as log_setup


def _add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--data-dir", default="", help="state directory (default /var/lib/tpud or ~/.tpud)")
    p.add_argument("--log-level", default="info")
    p.add_argument("--kmsg-path", default="", help="override /dev/kmsg (or env TPUD_KMSG_FILE_PATH)")


def _build_config(args) -> "cfgmod.Config":
    cfg = cfgmod.default_config()
    if getattr(args, "data_dir", ""):
        cfg.data_dir = args.data_dir
    if getattr(args, "kmsg_path", ""):
        cfg.kmsg_path = args.kmsg_path
    if getattr(args, "port", None):
        cfg.port = args.port
    if getattr(args, "db_in_memory", False):
        cfg.db_in_memory = True
    if getattr(args, "no_tls", False):
        cfg.tls = False
    if getattr(args, "accelerator_type", ""):
        cfg.accelerator_type_override = args.accelerator_type
    if getattr(args, "expected_gpu_count", 0):
        cfg.expected_gpu_count = args.expected_gpu_count
    if getattr(args, "plugin_specs", ""):
        cfg.plugin_specs_file = args.plugin_specs
    if getattr(args, "endpoint", ""):
        cfg.endpoint = args.endpoint
    if getattr(args, "token", ""):
        cfg.token = args.token
    if getattr(args, "disable_components", ""):
        cfg.components_disabled = [
            c.strip() for c in args.disable_components.split(",") if c.strip()
        ]
    if getattr(args, "pprof", False):
        cfg.pprof = True
    cfg.log_level = getattr(args, "log_level", "info")
    return cfg


def cmd_compact(args) -> int:
    """Reference: cmd/gpud compact (command.go:629) — offline VACUUM."""
    from gpud_tpu_torch.sqlite import DB

    cfg = _build_config(args)
    db = DB(cfg.state_file())
    secs = db.compact()
    print(f"compacted {cfg.state_file()} in {secs:.2f}s "
          f"({db.size_bytes()} bytes)")
    return 0


def cmd_metadata(args) -> int:
    """Reference: cmd/gpud metadata — dump the metadata table."""
    from gpud_tpu_torch.metadata import Metadata
    from gpud_tpu_torch.sqlite import DB

    cfg = _build_config(args)
    md = Metadata(DB(cfg.state_file()))
    print(json.dumps(md.all(), indent=2, sort_keys=True))
    return 0


def cmd_history(args) -> int:
    """Health-transition timeline from the persisted ledger. Reads the
    state DB directly (WAL mode), so it works whether or not the daemon is
    up — the offline analog of ``GET /v1/states/history``."""
    import os
    import time as _time
    from datetime import datetime

    from gpud_tpu_torch.health_history import HealthLedger
    from gpud_tpu_torch.sqlite import DB

    cfg = _build_config(args)
    path = cfg.state_file()
    if not os.path.isfile(path):
        print(f"no state DB at {path} (has the daemon ever run?)",
              file=sys.stderr)
        return 1
    ledger = HealthLedger(DB(path))
    since = _time.time() - args.since_hours * 3600.0
    component = args.component or None
    transitions = ledger.history(
        component=component, since=since, limit=args.limit
    )
    availability = ledger.availability_all()
    if getattr(args, "as_json", False):
        print(json.dumps(
            {"transitions": transitions, "availability": availability},
            indent=2, sort_keys=True,
        ))
        return 0
    if not transitions:
        print(f"no transitions in the last {args.since_hours:g}h")
    else:
        comp_w = max(len(t["component"]) for t in transitions)
        for t in transitions:
            when = datetime.fromtimestamp(t["time"]).strftime("%Y-%m-%d %H:%M:%S")
            line = (f"  {when}  {t['component']:<{comp_w}}  "
                    f"{t['from']} → {t['to']}")
            if t["reason"]:
                line += f"  ({t['reason']})"
            print(line)
    rows = sorted(availability.items())
    if component:
        rows = [(c, av) for c, av in rows if c == component]
    if rows:
        print()
        comp_w = max(len(c) for c, _ in rows)
        for c, av in rows:
            flap = "  FLAPPING" if ledger.is_flapping(c) else ""
            print(f"  {c:<{comp_w}}  {av['state']:<11}  "
                  f"availability {av['ratio'] * 100:6.2f}% "
                  f"over {av['window_seconds'] / 3600:g}h{flap}")
    return 0


def cmd_remediation(args) -> int:
    """Remediation audit ledger: what was diagnosed, what the policy
    decided, what ran. Reads the state DB directly (WAL mode), daemon up
    or not — the offline analog of ``GET /v1/remediation/audit``."""
    import os
    import time as _time
    from datetime import datetime

    from gpud_tpu_torch.remediation.audit import AuditStore
    from gpud_tpu_torch.sqlite import DB

    cfg = _build_config(args)
    path = cfg.state_file()
    if not os.path.isfile(path):
        print(f"no state DB at {path} (has the daemon ever run?)",
              file=sys.stderr)
        return 1
    store = AuditStore(DB(path))
    since = _time.time() - args.since_hours * 3600.0
    attempts = store.read(
        component=args.component or None,
        action=args.action or None,
        outcome=args.outcome or None,
        since=since,
        limit=args.limit,
    )
    summary = store.summary()
    if getattr(args, "as_json", False):
        print(json.dumps(
            {"attempts": attempts, "summary": summary},
            indent=2, sort_keys=True,
        ))
        return 0
    if not attempts:
        print(f"no remediation attempts in the last {args.since_hours:g}h")
    else:
        comp_w = max(len(a["component"]) for a in attempts)
        act_w = max(len(a["action"]) for a in attempts)
        for a in attempts:
            when = datetime.fromtimestamp(a["time"]).strftime(
                "%Y-%m-%d %H:%M:%S"
            )
            line = (f"  {when}  {a['component']:<{comp_w}}  "
                    f"{a['action']:<{act_w}}  {a['outcome']}")
            if a["detail"]:
                line += f"  ({a['detail']})"
            print(line)
    if summary["by_outcome"]:
        print()
        parts = ", ".join(
            f"{k}={v}" for k, v in sorted(summary["by_outcome"].items())
        )
        print(f"  total {summary['attempts_total']}  ({parts})")
    return 0


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

    pc = sub.add_parser("compact", help="VACUUM the state DB (daemon stopped)")
    _add_common_flags(pc)
    pc.set_defaults(fn=cmd_compact, audited=True)

    pm = sub.add_parser("metadata", help="dump the metadata table")
    _add_common_flags(pm)
    pm.set_defaults(fn=cmd_metadata)

    phy = sub.add_parser(
        "history", help="health-transition timeline + availability from the ledger"
    )
    _add_common_flags(phy)
    phy.add_argument("--component", default="", help="filter to one component")
    phy.add_argument("--since-hours", type=float, default=24.0,
                     help="lookback window in hours (default 24)")
    phy.add_argument("--limit", type=int, default=256,
                     help="max transitions to show (0 = all)")
    phy.add_argument("--json", action="store_true", dest="as_json",
                     help="machine-readable timeline + availability")
    phy.set_defaults(fn=cmd_history)

    prm = sub.add_parser(
        "remediation",
        help="remediation audit ledger: policy decisions and repair attempts",
    )
    _add_common_flags(prm)
    prm.add_argument("--component", default="", help="filter to one component")
    prm.add_argument("--action", default="",
                     help="filter by action (e.g. reboot_system)")
    prm.add_argument("--outcome", default="",
                     help="filter by outcome (e.g. dry_run, executed)")
    prm.add_argument("--since-hours", type=float, default=24.0,
                     help="lookback window in hours (default 24)")
    prm.add_argument("--limit", type=int, default=256,
                     help="max attempts to show (0 = all)")
    prm.add_argument("--json", action="store_true", dest="as_json",
                     help="machine-readable attempts + summary")
    prm.set_defaults(fn=cmd_remediation)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    import os

    args = build_parser().parse_args(argv)
    log_setup(getattr(args, "log_level", "info"))
    # privileged commands are audited into the data dir like the daemon's
    # own; read-only commands must not touch the data dir at all
    if getattr(args, "audited", False) and hasattr(args, "data_dir"):
        cfg = _build_config(args)
        if not cfg.db_in_memory:
            try:
                set_audit_logger(
                    AuditLogger(os.path.join(cfg.resolved_data_dir(),
                                             cfgmod.AUDIT_LOG_FILE))
                )
            except OSError:
                pass  # unwritable data dir: act unaudited rather than fail
    return args.fn(args)
