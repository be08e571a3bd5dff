"""Command line of the PyTorch/CUDA port.

``python -m gpud_tpu_torch scan [--accelerator-type T] [--strict] [--json]``
checks this host's GPUs once (through NVML, or the mock backend under
``TPUD_GPU_MOCK_ALL_SUCCESS=1``) and prints the check table of ``tpud scan``.

``python -m gpud_tpu_torch fleet-scan DB... [--window S] [--flap-threshold N]
[--crc-threshold N] [--json] [--device cuda|cpu] [--spans]`` prints what
``tpud fleet-scan`` prints. The scan runs on the card unless ``--device cpu``;
``--spans`` adds the sweep's spans from the trace ring as a JSON line on
stderr.

``compact``, ``metadata``, ``history`` and ``remediation`` (each with
``--data-dir``) read the daemon's state DB offline, daemon up or not, and
print what ``tpud``'s subcommands of the same names print.

``machine-info`` prints this host's machine info as JSON (``gpu_info`` from
NVML); ``release`` signs and verifies release artifacts (``gen-root-key``,
``gen-signing-key``, ``sign-key``, ``sign-package``, ``verify-package``;
needs ``cryptography``); ``update`` sets or checks the target version, or
installs one now (``--install``); ``list-plugins``, ``custom-plugins FILE``
and ``run-plugin-group FILE [--tag T]`` list, validate and run custom
plugins. Each prints what ``tpud``'s subcommand of the same name prints.

``run`` starts the daemon with its local API (``gpud_tpu_torch/server``;
HTTPS on port 15132 unless ``--port``/``--no-tls``) and prints
``tpud <version> listening on <url>``; ``status``, ``set-healthy``,
``predict``, ``fabric``, ``session status`` and ``chaos list|run`` ask a
running daemon over that API (the client SDK, ``gpud_tpu_torch/client/v1.py``);
``inject-fault`` writes a fault line into the kmsg file the daemon reads;
``notify`` records a startup or shutdown event in the state DB; ``up``
enrolls with a control plane and installs the systemd unit
(``gpud_tpu_torch/manager/systemd.py``), ``down`` removes it. Each has
``tpud``'s flags, output, ``--json`` schema and exit codes, in the port's
nouns (``--gpu-id``, Xid error names).

``manager serve`` runs the fleet manager (``gpud_tpu_torch/manager/
control_plane.py``: v1 on ``--port``, v2 on ``--grpc-port``, the journal
in ``--data-dir``, ``--shards`` ingest shards; with ``--peer-id`` and
``--peers``, a member of a federated peer set) and prints its endpoint as
one JSON line; ``manager machines`` and ``manager request ID METHOD``, and
``fleet rollup|fabric|predict|agents|peers|history|traces`` (``agents
--peer`` keeps one peer's cohort), ask a running manager over its operator
API (``--endpoint``, ``--admin-token``), with ``tpud``'s output, error text
and exit codes.
"""

from __future__ import annotations

import argparse
import io
import json
import signal
import sys
import time
from typing import List, Optional

from gpud_tpu_torch import config as cfgmod
from gpud_tpu_torch.log import AuditLogger, set_audit_logger, setup as log_setup
from gpud_tpu_torch.version import __version__


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
    """One-shot health scan of this host's GPUs (gpud_tpu_torch/scan.py).
    When a daemon has run here before, its persisted ledger adds the
    rolling-availability column (reference: cmd/gpud scan)."""
    import os

    from gpud_tpu_torch.api.v1.types import HealthStateType
    from gpud_tpu_torch.scan import scan

    if args.kmsg_path:
        # scan-mode components resolve the kmsg path via the env override
        os.environ["TPUD_KMSG_FILE_PATH"] = args.kmsg_path
    availability = {}
    cfg = _build_config(args)
    if not cfg.db_in_memory and os.path.isfile(cfg.state_file()):
        try:
            from gpud_tpu_torch.health_history import HealthLedger
            from gpud_tpu_torch.sqlite import DB

            availability = HealthLedger(DB(cfg.state_file())).availability_all()
        except Exception:  # noqa: BLE001 — a corrupt DB must not block scan
            availability = {}
    sink = io.StringIO() if args.as_json else sys.stdout
    results = scan(accelerator_type=args.accelerator_type, out=sink,
                   availability=availability)
    if args.as_json:
        rows = []
        for r in results:
            row = {
                "component": r.component_name(),
                "health": r.health_state_type(),
                "reason": r.summary(),
                "extra_info": dict(r.extra_info),
                "repair_actions": list(r.suggested_actions.repair_actions)
                if r.suggested_actions else [],
            }
            av = availability.get(r.component_name())
            if av is not None:
                row["availability"] = av
            rows.append(row)
        print(json.dumps(rows, indent=2))
    unhealthy = [r for r in results if r.health_state_type() != HealthStateType.HEALTHY]
    return 1 if unhealthy and args.strict else 0


def cmd_fleet_scan(args) -> int:
    """Fleet-wide link-history sweep (gpud_tpu_torch/fleet_scan.py)."""
    from gpud_tpu_torch.fleet_scan import COMPONENT, fleet_scan
    from gpud_tpu_torch.tracing import DEFAULT_TRACER

    t0 = time.time()
    res = fleet_scan(
        args.dbs,
        window_seconds=args.window,
        flap_threshold=args.flap_threshold,
        crc_threshold=args.crc_threshold,
        device=args.device,
    )
    if args.spans:
        spans = DEFAULT_TRACER.snapshot(component=COMPONENT, since=t0)
        # ids are handed out as spans open: oldest first
        print(json.dumps(sorted(spans, key=lambda s: s["span_id"])), file=sys.stderr)
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


def cmd_machine_info(args) -> int:
    from gpud_tpu_torch.gpu.instance import new_instance
    from gpud_tpu_torch.machine_info import get_machine_info

    mi = get_machine_info(gpu=new_instance(accelerator_type=args.accelerator_type))
    print(json.dumps(mi.to_dict(), indent=2, sort_keys=True))
    return 0


def cmd_list_plugins(args) -> int:
    """Reference: cmd/gpud list-plugins."""
    import os

    from gpud_tpu_torch.plugins.spec import load_specs

    cfg = _build_config(args)
    path = cfg.resolved_plugin_specs_file()
    if not os.path.isfile(path):
        print(f"no plugin specs at {path}")
        return 0
    try:
        specs = load_specs(path)
    except Exception as e:  # noqa: BLE001
        print(f"INVALID specs file {path}: {e}", file=sys.stderr)
        return 1
    for s in specs:
        print(f"{s.name}\t{s.plugin_type}\t{s.run_mode}\t"
              f"every {s.interval_seconds:.0f}s\t{len(s.steps)} step(s)")
    return 0


def cmd_release(args) -> int:
    """Reference: cmd/gpud release subcommands (command.go:446-570)."""
    from gpud_tpu_torch.release import distsign

    sub = args.release_cmd
    if sub == "gen-root-key":
        priv, pub = distsign.write_keypair(args.dir, "root")
        print(f"root key: {priv}\nroot pub: {pub}")
    elif sub == "gen-signing-key":
        priv, pub = distsign.write_keypair(args.dir, "signing")
        print(f"signing key: {priv}\nsigning pub: {pub}")
    elif sub == "sign-key":
        out = distsign.sign_key(args.root_key, args.signing_pub)
        print(f"key endorsement: {out}")
    elif sub == "sign-package":
        out = distsign.sign_package(args.signing_key, args.package)
        print(f"package signature: {out}")
    elif sub == "verify-package":
        err = distsign.verify_package(
            args.signing_pub, args.package,
            sig_path=args.sig or "",
            root_pub_path=args.root_pub or "",
            key_sig_path=args.key_sig or "",
        )
        if err:
            print(f"FAIL: {err}", file=sys.stderr)
            return 1
        print("OK: signature valid")
    return 0


def cmd_update(args) -> int:
    """Reference: cmd/gpud update(+check) — set/inspect the target-version
    file the watcher acts on, or (``--install``) run the built-in
    download→verify→install pipeline synchronously (update.go:19-50)."""
    from gpud_tpu_torch.update import read_target_version, write_target_version

    cfg = _build_config(args)
    path = cfg.target_version_file()
    if args.check:
        target = read_target_version(path)
        print(f"running: {__version__}\ntarget:  {target or '(none)'}")
        return 0
    if not args.target_version:
        print("error: --target-version required (or --check)", file=sys.stderr)
        return 1
    if args.install:
        from gpud_tpu_torch.update_install import perform_update

        err = perform_update(
            args.target_version,
            base_url=args.base_url,
            install_dir=args.install_dir,
            signing_pub=args.signing_pub,
            root_pub=args.root_pub,
        )
        if err:
            print(f"FAIL: {err}", file=sys.stderr)
            return 1
        print(f"installed {args.target_version}")
        return 0
    write_target_version(path, args.target_version)
    print(f"target version set to {args.target_version}; "
          "the running daemon restarts within 30s")
    return 0


def cmd_custom_plugins(args) -> int:
    """Reference: cmd/gpud custom-plugins — validate a specs file."""
    from gpud_tpu_torch.plugins.spec import load_specs

    try:
        specs = load_specs(args.file)
    except Exception as e:  # noqa: BLE001 — any parse failure is "invalid"
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print(f"OK: {len(specs)} valid plugin spec(s)")
    for s in specs:
        print(f"  {s.name} ({s.plugin_type}, {s.run_mode})")
    return 0


def cmd_run_plugin_group(args) -> int:
    """Reference: cmd/gpud run-plugin-group — run all plugins with a tag
    once and print results."""
    from gpud_tpu_torch.api.v1.types import HealthStateType
    from gpud_tpu_torch.components.base import TpudInstance
    from gpud_tpu_torch.plugins.component import build_components
    from gpud_tpu_torch.plugins.spec import load_specs

    specs = load_specs(args.file)
    comps = build_components(TpudInstance(), specs)
    if args.tag:
        comps = [c for c in comps if args.tag in c.tags()]
    bad = 0
    for c in comps:
        cr = c.check()
        glyph = "✔" if cr.health_state_type() == HealthStateType.HEALTHY else "✘"
        if cr.health_state_type() != HealthStateType.HEALTHY:
            bad += 1
        print(f"{glyph} {c.name()}: {cr.summary()}")
    return 1 if bad else 0


def cmd_run(args) -> int:
    """Reference: cmd/gpud run → pkg/server.New (SURVEY §3.1)."""
    cfg = _build_config(args)
    log_setup(cfg.log_level, cfg.log_file)
    # main() already wired the default data-dir audit logger; only an
    # explicit audit_log_file config overrides it here
    if cfg.audit_log_file:
        set_audit_logger(AuditLogger(cfg.audit_log_file))

    from gpud_tpu_torch.server.server import Server

    # handlers installed BEFORE boot: a SIGTERM during the (multi-second)
    # start sequence must still run the clean shutdown path
    stop = {"flag": False}

    def _sig(_s, _f):
        stop["flag"] = True

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)

    srv = Server(config=cfg)
    srv.start()
    print(f"tpud {__version__} listening on {srv.base_url()}", flush=True)
    try:
        while not stop["flag"]:
            time.sleep(0.5)
    finally:
        srv.stop()
    return 0


def cmd_inject_fault(args) -> int:
    """Reference: cmd/gpud inject-fault → pkg/fault-injector."""
    from gpud_tpu_torch.fault_injector import Injector, Request

    req = Request(
        gpu_error_name=args.name or "",
        gpu_id=args.gpu_id,
        detail=args.detail or "",
        kernel_message=args.kernel_message or "",
        repeat=getattr(args, "repeat", 1),
        interval_seconds=getattr(args, "interval_seconds", 0.0),
    )
    inj = Injector(kmsg_path=args.kmsg_path)
    res = inj.inject(req)
    if not res.ok:
        print(f"error: {res.error}", file=sys.stderr)
        return 1
    print(f"fault injected ({res.writes} write(s)): {res.line or res.entry}")
    return 0


def _client(args, timeout: Optional[float] = None):
    from gpud_tpu_torch.client.v1 import DEFAULT_TIMEOUT, Client

    scheme = "http" if getattr(args, "no_tls", False) else "https"
    return Client(base_url=f"{scheme}://localhost:{args.port}",
                  timeout=DEFAULT_TIMEOUT if timeout is None else timeout)


def cmd_status(args) -> int:
    """Reference: cmd/gpud status — queries the running daemon."""
    from gpud_tpu_torch.api.v1.types import HealthStateType

    try:
        c = _client(args)
        hz = c.healthz()
        states = c.get_health_states()
    except Exception as e:  # noqa: BLE001
        print(f"tpud unreachable on port {args.port}: {e}", file=sys.stderr)
        return 1
    bad = sum(
        1
        for comp in states
        for st in comp.states
        if st.health != HealthStateType.HEALTHY
    )
    if getattr(args, "as_json", False):
        print(json.dumps({
            "version": hz.get("version", ""),
            "unhealthy": bad,
            "components": [
                {"component": comp.component, "health": st.health,
                 "reason": st.reason}
                for comp in states for st in comp.states
            ],
        }, indent=2))
        return 1 if bad else 0
    print(f"tpud {hz.get('version', '?')} healthy")
    for comp in states:
        for st in comp.states:
            glyph = "✔" if st.health == HealthStateType.HEALTHY else "✘"
            print(f"  {glyph} {comp.component}: {st.health} {st.reason}")
    return 1 if bad else 0


def cmd_set_healthy(args) -> int:
    from gpud_tpu_torch.log import audit

    audit("cli_set_healthy", component=args.component)
    try:
        c = _client(args)
        c.set_healthy(args.component)
    except Exception as e:  # noqa: BLE001
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"set-healthy: {args.component}")
    return 0


def cmd_session(args) -> int:
    """Show the daemon's control-plane session health: connection state,
    circuit breaker, and the store-and-forward outbox backlog."""
    from gpud_tpu_torch.client.v1 import ClientError

    c = _client(args, timeout=float(args.timeout))
    try:
        out = c.get_session_status()
    except ClientError as e:
        print(f"error: {e.body[:500]}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001
        print(f"tpud unreachable on port {args.port}: {e}", file=sys.stderr)
        return 1
    if getattr(args, "as_json", False):
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0
    if not out.get("configured"):
        print("session: not configured (no control-plane endpoint/token)")
        return 0
    sess = out.get("session") or {}
    state = "connected" if sess.get("connected") else "disconnected"
    if sess.get("auth_failed"):
        state += " (auth failed; replay parked until token rotation)"
    print(f"session: {state}  endpoint={sess.get('endpoint', '?')}")
    if sess.get("last_connect_error"):
        print(f"  last connect error: {sess['last_connect_error']}")
    circuit = out.get("circuit") or {}
    if circuit:
        print(
            f"circuit: {circuit.get('state', '?')}  "
            f"failures={circuit.get('consecutive_failures', 0)}/"
            f"{circuit.get('failure_threshold', '?')}  "
            f"blocked_attempts={circuit.get('blocked_attempts', 0)}"
        )
    outbox = out.get("outbox") or {}
    if outbox:
        print(
            f"outbox: backlog={outbox.get('backlog', 0)}  "
            f"acked_seq={outbox.get('acked_seq', 0)}/"
            f"{outbox.get('last_seq', 0)}  "
            f"dropped(journal_full={outbox.get('dropped_journal_full', 0)}, "
            f"retention={outbox.get('dropped_retention', 0)})"
        )
    print(f"degraded: {str(bool(out.get('degraded'))).lower()}")
    return 0


def cmd_chaos(args) -> int:
    """Drive the running daemon's chaos campaign runner (docs/chaos.md):
    ``chaos list`` shows scenarios + past results, ``chaos run`` executes
    one and exits nonzero unless every expectation passed."""
    from gpud_tpu_torch.client.v1 import ClientError

    # a waited campaign holds the HTTP request for its whole duration
    c = _client(args, timeout=float(args.timeout))
    try:
        if args.chaos_cmd == "list":
            out = c.get_chaos_campaigns(limit=args.limit)
            if getattr(args, "as_json", False):
                print(json.dumps(out, indent=2, sort_keys=True))
                return 0
            print("scenarios:")
            for name in out.get("scenarios", []):
                print(f"  {name}")
            running = out.get("running")
            if running:
                print(f"running: {running['scenario']} (id {running['id']})")
            for res in out.get("campaigns", []):
                verdict = "PASS" if res.get("passed") else "FAIL"
                print(
                    f"  #{res.get('id', '?')} {res.get('scenario', '?')}: "
                    f"{verdict} ({len(res.get('phases', []))} phase(s), "
                    f"{res.get('duration_seconds', 0):g}s)"
                )
            return 0
        out = c.run_chaos(args.scenario, wait=not args.no_wait)
    except ClientError as e:
        print(f"error: {e.body[:500]}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001
        print(f"tpud unreachable on port {args.port}: {e}", file=sys.stderr)
        return 1
    if getattr(args, "as_json", False):
        print(json.dumps(out, indent=2, sort_keys=True))
    elif args.no_wait:
        print(f"campaign {out.get('scenario', '?')} launched (id {out.get('id', '?')})")
    else:
        for ph in out.get("phases", []):
            mark = "✔" if ph.get("passed") else "✘"
            print(f"{mark} phase {ph['name']}")
            for exp in ph.get("expectations", []):
                emark = "✔" if exp.get("ok") else "✘"
                print(f"    {emark} [{exp['kind']}] {exp.get('detail', '')}")
            for err in ph.get("step_errors", []):
                print(f"    ✘ step error: {err}")
        verdict = "PASS" if out.get("passed") else "FAIL"
        print(
            f"{verdict}: {out.get('scenario', '?')} "
            f"({out.get('duration_seconds', 0):g}s)"
        )
        if out.get("error"):
            print(f"campaign error: {out['error']}", file=sys.stderr)
    if args.no_wait:
        return 0
    return 0 if out.get("passed") else 1


def cmd_predict(args) -> int:
    """Show the predict engine's precursor scores: fused score, feature
    breakdown, armed/warned state, and measured lead times."""
    from gpud_tpu_torch.client.v1 import ClientError

    c = _client(args, timeout=float(args.timeout))
    try:
        if getattr(args, "calibration", False):
            out = c.get_predict_calibration(refit=getattr(args, "refit", False))
            print(json.dumps(out, indent=2, sort_keys=True))
            return 0
        out = c.get_predict_scores(component=args.component, history=args.history or None)
    except ClientError as e:
        print(f"error: {e.body[:500]}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001
        print(f"tpud unreachable on port {args.port}: {e}", file=sys.stderr)
        return 1
    if getattr(args, "as_json", False):
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0
    status = out.get("status") or {}
    print(
        f"predict: threshold={status.get('threshold', '?')}  "
        f"hysteresis={status.get('hysteresis', '?')}  "
        f"ticks={status.get('ticks', 0)}  "
        f"warnings={status.get('warnings_total', 0)}"
    )
    comps = out.get("components") or {}
    if not comps:
        print("no components scored yet")
        return 0
    for name, d in sorted(comps.items()):
        mark = " ARMED" if d.get("armed") else ""
        lead = d.get("lead_seconds")
        lead_s = f"  lead={lead:.1f}s" if lead is not None else ""
        feats = d.get("features") or {}
        feat_s = " ".join(f"{k}={v:g}" for k, v in sorted(feats.items()))
        print(f"  {name}: score={d.get('score', 0):.3f}{mark}{lead_s}  [{feat_s}]")
    return 0


def cmd_fabric(args) -> int:
    """Show the fabric plane's per-link health matrix over the GPUs'
    NVLink ports: discovered mesh shape, sweep status, and each link's
    state, latency, and EWMA deviation (docs/fabric.md)."""
    from gpud_tpu_torch.client.v1 import ClientError

    c = _client(args, timeout=float(args.timeout))
    try:
        out = c.get_fabric(link=args.link, since=args.since or None, limit=args.limit or None)
    except ClientError as e:
        print(f"error: {e.body[:500]}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001
        print(f"tpud unreachable on port {args.port}: {e}", file=sys.stderr)
        return 1
    if getattr(args, "as_json", False):
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0
    status = out.get("status") or {}
    mesh = status.get("mesh") or {}
    shape = "x".join(str(d) for d in (mesh.get("shape") or [])) or "?"
    print(
        f"fabric: mesh={shape} ({mesh.get('source', 'unknown')})  "
        f"links={status.get('links', 0)}  "
        f"sweeps={status.get('sweeps', 0)}  "
        f"degraded={len(status.get('degraded') or [])}  "
        f"down={len(status.get('down') or [])}"
    )
    matrix = out.get("matrix") or []
    if not matrix:
        print("no links observed (degraded 1x1 mesh or no sweep yet)")
        return 0
    for row in matrix:
        state = row.get("state") or "unswept"
        print(
            f"  {row.get('link')}: {state}"
            f"  latency={row.get('latency_seconds', 0):.6f}s"
            f"  deviation={row.get('deviation', 0):.2f}"
        )
    for row in out.get("history") or []:
        print(
            f"  [history] {row.get('ts', 0):.3f} {row.get('link')}: "
            f"{row.get('state')} latency={row.get('latency_seconds', 0):.6f}s"
        )
    return 0


def cmd_notify(args) -> int:
    """Reference: cmd/gpud notify startup/shutdown — record a lifecycle
    event in the os bucket so the control plane sees planned transitions."""
    from gpud_tpu_torch.api.v1.types import Event, EventType
    from gpud_tpu_torch.eventstore import EventStore
    from gpud_tpu_torch.sqlite import DB

    cfg = _build_config(args)
    es = EventStore(DB(cfg.state_file()))
    es.bucket("os").insert(
        Event(
            component="os",
            name=f"daemon_{args.phase}",
            type=EventType.INFO,
            message=f"tpud {args.phase} notification",
        )
    )
    print(f"recorded {args.phase} notification")
    return 0


def cmd_up(args) -> int:
    """Install + enroll (reference: cmd/gpud/up/command.go:25, SURVEY §3.5):
    optional login, systemd unit install, token hand-off via FIFO."""
    import os

    cfg = _build_config(args)
    if args.token and args.endpoint:
        from gpud_tpu_torch.gpu.instance import new_instance
        from gpud_tpu_torch.login import login as do_login
        from gpud_tpu_torch.metadata import Metadata
        from gpud_tpu_torch.providers import detect as provider_detect
        from gpud_tpu_torch.sqlite import DB

        prov = provider_detect.detect(timeout=3.0)
        md = Metadata(DB(cfg.state_file()))
        try:
            do_login(
                args.endpoint, args.token, md,
                gpu_instance=new_instance(),
                provider=prov.provider, region=prov.region,
            )
        except Exception as e:  # noqa: BLE001
            print(f"login failed: {e}", file=sys.stderr)
            return 1
        print("login ok")
    if args.no_systemd:
        print("skipping systemd install (--no-systemd)")
        return 0
    if os.geteuid() != 0:
        print("error: tpud up requires root for systemd install "
              "(use --no-systemd to skip)", file=sys.stderr)
        return 1
    from gpud_tpu_torch.daemon import Daemon
    from gpud_tpu_torch.manager import systemd

    flags = []
    if cfg.data_dir:
        flags.append(f"--data-dir {cfg.data_dir}")
    err = systemd.install_unit(flags=" ".join(flags))
    if err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    # hand a fresh token to the (possibly already-running) daemon; the
    # daemon creates the FIFO at boot, so retry briefly
    if args.token:
        err = "daemon fifo not ready"
        for _ in range(10):
            err = Daemon.write_token(args.token, cfg.fifo_file())
            if err is None:
                break
            time.sleep(1.0)
        if err is not None:
            print(f"warning: token hand-off failed: {err} — "
                  "run `tpud up --token ... --endpoint ...` to enroll",
                  file=sys.stderr)
            return 1
    print("tpud installed and started (systemd)")
    return 0


def cmd_down(args) -> int:
    """Reference: cmd/gpud down — stop + disable the unit."""
    from gpud_tpu_torch.manager import systemd

    err = systemd.uninstall_unit()
    if err:
        print(f"warning: {err}", file=sys.stderr)
    print("tpud stopped")
    return 0


def cmd_manager(args) -> int:
    """Standalone dev control plane (manager/control_plane.py): serve a
    manager process, or drive one over its operator API."""
    if args.manager_cmd == "serve":
        import threading

        from gpud_tpu_torch.manager.control_plane import ControlPlane

        cp = ControlPlane(
            port=args.port,
            grpc_port=args.grpc_port,
            session_token=args.session_token or None,
            admin_token=args.admin_token or None,
            instance_id=args.peer_id or None,
            data_dir=args.data_dir or None,
            shards=args.shards or None,
        )
        # handlers go in before the endpoint line: the printed JSON is the
        # readiness contract, and a supervisor may SIGTERM immediately after
        # reading it — the default disposition in that window would kill us
        # with a nonzero status
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        cp.start()
        if args.peers:
            # HA tier (docs/fleet.md "Federation & failover"): join the
            # peer set. The knob defaults mirror Config.federation_* —
            # the daemon-side dataclass is the documented reference for
            # these, even though the manager is configured by flags
            defaults = cfgmod.Config()
            cp.attach_peers(
                args.peer_id or cp.instance_id,
                list(args.peers),
                replication_interval=(
                    args.replication_interval
                    if args.replication_interval > 0
                    else defaults.federation_replication_interval_seconds
                ),
                probe_interval=(
                    args.probe_interval if args.probe_interval > 0
                    else defaults.federation_probe_interval_seconds
                ),
                fanout_timeout=(
                    args.fanout_timeout if args.fanout_timeout > 0
                    else defaults.federation_fanout_timeout_seconds
                ),
                dead_after_probes=(
                    args.dead_after_probes if args.dead_after_probes > 0
                    else defaults.federation_dead_after_probes
                ),
                auto_adopt=(
                    defaults.federation_auto_adopt
                    and not args.no_auto_adopt
                ),
            )
        print(
            json.dumps(
                {
                    "endpoint": cp.endpoint,
                    "grpc_port": cp.grpc_port,
                    "instance_id": cp.instance_id,
                }
            ),
            flush=True,
        )
        stop.wait()
        cp.stop()
        return 0

    # operator subcommands speak the manager's HTTP API
    try:
        return _manager_operator_cmd(args)
    except Exception as e:  # noqa: BLE001 - CLI boundary: no tracebacks
        print(f"error: {e}", file=sys.stderr)
        return 1


def _operator_client(args, timeout: float):
    """The SDK on a manager's operator API (``--endpoint``, with the admin
    bearer when ``--admin-token``)."""
    from gpud_tpu_torch.client.v1 import Client

    return Client(base_url=args.endpoint, timeout=timeout, admin_token=args.admin_token)


def cmd_fleet(args) -> int:
    """Fleet observability against a manager's operator API: rollup
    aggregates, paginated per-agent views, journaled history, and
    correlation-id trace stitching (docs/fleet.md)."""
    from gpud_tpu_torch.client.v1 import ClientError

    try:
        c = _operator_client(args, 30)
        if args.fleet_cmd == "rollup":
            data = c.get_fleet_rollup()
        elif args.fleet_cmd == "fabric":
            data = c.get_fleet_fabric(args.since or None)
        elif args.fleet_cmd == "predict":
            data = c.get_fleet_predict(args.top)
        elif args.fleet_cmd == "agents":
            data = c.get_fleet_agents(args.offset, args.limit)
            if args.peer:
                # cohort placement view: keep only rows the named peer
                # owns. Rows carry "peer" on federated managers; on a
                # standalone manager the filter matches nothing
                rows = [
                    a for a in data.get("agents", [])
                    if a.get("peer", "") == args.peer
                ]
                data["agents"] = rows
                data["peer_filter"] = args.peer
                data["filtered"] = len(rows)
        elif args.fleet_cmd == "history":
            data = c.get_fleet_history(args.machine_id, since=args.since or None,
                                       limit=args.limit, offset=args.offset)
        elif args.fleet_cmd == "traces":
            data = c.get_fleet_traces(args.correlation_id)
        elif args.fleet_cmd == "peers":
            data = c.get_fleet_peers()
        else:
            return 2
    except ClientError as e:
        print(f"error {e.status}: {e.body}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 - CLI boundary: no tracebacks
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(data, indent=2))
    return 0


def _manager_operator_cmd(args) -> int:
    from gpud_tpu_torch.client.v1 import ClientError

    if args.manager_cmd == "machines":
        try:
            data = _operator_client(args, 10)._req("GET", "/v1/machines")
        except ClientError as e:
            print(f"error {e.status}: {e.body}", file=sys.stderr)
            return 1
        print(json.dumps(data, indent=2))
        return 0
    if args.manager_cmd == "request":
        body = {}
        if args.params:
            params = json.loads(args.params)
            if not isinstance(params, dict):
                print("--params must be a JSON object", file=sys.stderr)
                return 2
            body.update(params)
        # the positional method always wins over a "method" key smuggled
        # into --params
        body["method"] = args.method
        try:
            data = _operator_client(args, args.timeout + 10)._req(
                "POST", f"/v1/machines/{args.machine_id}/request",
                params={"timeout": str(args.timeout)}, body=body,
            )
        except ClientError as e:
            print(f"error {e.status}: {e.body}", file=sys.stderr)
            return 1
        print(json.dumps(data, indent=2))
        return 0
    return 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m gpud_tpu_torch",
        description="tpud's accelerator tools on an NVIDIA GPU",
    )
    p.add_argument("--version", action="version", version=f"tpud {__version__}")
    sub = p.add_subparsers(dest="cmd", required=True)

    pu = sub.add_parser("up", help="install as systemd service + enroll")
    _add_common_flags(pu)
    pu.add_argument("--token", default="", help="control-plane join token")
    pu.add_argument("--endpoint", default="", help="control-plane endpoint URL")
    pu.add_argument("--no-systemd", action="store_true")
    pu.set_defaults(fn=cmd_up, audited=True)

    pd = sub.add_parser("down", help="stop and disable the systemd service")
    _add_common_flags(pd)
    pd.set_defaults(fn=cmd_down, audited=True)

    ps = sub.add_parser("scan", help="one-shot health scan of this host's GPUs")
    _add_common_flags(ps)
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
    pfs.add_argument("--spans", action="store_true",
                     help="print the sweep's spans, oldest first, as one JSON line on stderr")
    pfs.set_defaults(fn=cmd_fleet_scan)

    pr = sub.add_parser("run", help="run the daemon")
    _add_common_flags(pr)
    pr.add_argument("--port", type=int, default=cfgmod.DEFAULT_PORT)
    pr.add_argument("--db-in-memory", action="store_true")
    pr.add_argument("--no-tls", action="store_true")
    pr.add_argument("--accelerator-type", default="")
    pr.add_argument("--expected-gpu-count", type=int, default=0)
    pr.add_argument("--plugin-specs", default="", help="path to plugins.yaml")
    pr.add_argument("--endpoint", default="", help="control-plane endpoint")
    pr.add_argument("--token", default="", help="control-plane token")
    pr.add_argument("--disable-components", default="",
                    help="comma-separated component names to disable")
    pr.add_argument("--pprof", action="store_true",
                    help="enable /admin/pprof debug endpoints")
    pr.set_defaults(fn=cmd_run, audited=True)

    pi = sub.add_parser("inject-fault", help="inject a synthetic fault via kmsg")
    _add_common_flags(pi)
    pi.add_argument("--name", help="catalogued GPU error name (e.g. gpu_fallen_off_bus, Xid 79)")
    pi.add_argument("--gpu-id", type=int, default=0)
    pi.add_argument("--detail", default="")
    pi.add_argument("--kernel-message", default="", help="raw kernel message instead of --name")
    pi.add_argument("--repeat", type=int, default=1,
                    help="burst: write the fault N times (flap modelling)")
    pi.add_argument("--interval-seconds", type=float, default=0.0,
                    help="spacing between burst writes")
    pi.set_defaults(fn=cmd_inject_fault, audited=True)

    pst = sub.add_parser("status", help="query the running daemon")
    pst.add_argument("--port", type=int, default=cfgmod.DEFAULT_PORT)
    pst.add_argument("--no-tls", action="store_true", help="daemon runs with --no-tls")
    pst.add_argument("--json", action="store_true", dest="as_json",
                     help="machine-readable status")
    pst.set_defaults(fn=cmd_status)

    pc = sub.add_parser("compact", help="VACUUM the state DB (daemon stopped)")
    _add_common_flags(pc)
    pc.set_defaults(fn=cmd_compact, audited=True)

    ph = sub.add_parser("set-healthy", help="clear a component's sticky state")
    _add_common_flags(ph)  # data-dir locates the audit trail
    ph.add_argument("--port", type=int, default=cfgmod.DEFAULT_PORT)
    ph.add_argument("--no-tls", action="store_true", help="daemon runs with --no-tls")
    ph.add_argument("--component", required=True)
    ph.set_defaults(fn=cmd_set_healthy, audited=True)

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

    pch = sub.add_parser(
        "chaos", help="run declarative chaos campaigns against the daemon"
    )
    csub = pch.add_subparsers(dest="chaos_cmd", required=True)
    cr = csub.add_parser("run", help="execute a scenario; nonzero exit on FAIL")
    cr.add_argument("scenario",
                    help="shipped scenario name or a scenario file path")
    cr.add_argument("--port", type=int, default=cfgmod.DEFAULT_PORT)
    cr.add_argument("--no-tls", action="store_true")
    cr.add_argument("--no-wait", action="store_true",
                    help="launch on the daemon's pool and return immediately")
    cr.add_argument("--timeout", type=float, default=330.0,
                    help="HTTP timeout for the waited campaign (seconds)")
    cr.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable campaign result")
    cr.set_defaults(fn=cmd_chaos, audited=True)
    cl = csub.add_parser("list", help="list scenarios and past campaign results")
    cl.add_argument("--port", type=int, default=cfgmod.DEFAULT_PORT)
    cl.add_argument("--no-tls", action="store_true")
    cl.add_argument("--limit", type=int, default=10)
    cl.add_argument("--timeout", type=float, default=30.0)
    cl.add_argument("--json", action="store_true", dest="as_json")
    cl.set_defaults(fn=cmd_chaos)

    ppr = sub.add_parser(
        "predict",
        help="predictive health: per-component precursor scores",
    )
    ppr.add_argument("--component", default="", help="filter to one component")
    ppr.add_argument("--history", type=int, default=0,
                     help="append the last N score points per component")
    ppr.add_argument("--calibration", action="store_true",
                     help="show learned per-class threshold calibration")
    ppr.add_argument("--refit", action="store_true",
                     help="with --calibration: re-fit from the ledger first")
    ppr.add_argument("--port", type=int, default=cfgmod.DEFAULT_PORT)
    ppr.add_argument("--no-tls", action="store_true")
    ppr.add_argument("--timeout", type=float, default=30.0)
    ppr.add_argument("--json", action="store_true", dest="as_json",
                     help="machine-readable scores + status")
    ppr.set_defaults(fn=cmd_predict)

    pfa = sub.add_parser(
        "fabric",
        help="NVLink fabric health: per-link sweep matrix",
    )
    pfa.add_argument("--link", default="",
                     help="append history for one link (e.g. gpu0/nvlink0)")
    pfa.add_argument("--since", type=float, default=0.0,
                     help="history unix-timestamp floor")
    pfa.add_argument("--limit", type=int, default=0,
                     help="max history rows to append")
    pfa.add_argument("--port", type=int, default=cfgmod.DEFAULT_PORT)
    pfa.add_argument("--no-tls", action="store_true")
    pfa.add_argument("--timeout", type=float, default=30.0)
    pfa.add_argument("--json", action="store_true", dest="as_json",
                     help="machine-readable matrix + status")
    pfa.set_defaults(fn=cmd_fabric)

    pse = sub.add_parser(
        "session", help="control-plane session / outbox health"
    )
    ssub = pse.add_subparsers(dest="session_cmd", required=True)
    sst = ssub.add_parser(
        "status", help="connection, circuit-breaker, and outbox state"
    )
    sst.add_argument("--port", type=int, default=cfgmod.DEFAULT_PORT)
    sst.add_argument("--no-tls", action="store_true")
    sst.add_argument("--timeout", type=float, default=30.0)
    sst.add_argument("--json", action="store_true", dest="as_json")
    sst.set_defaults(fn=cmd_session)

    plp = sub.add_parser("list-plugins", help="list configured plugin specs")
    _add_common_flags(plp)
    plp.set_defaults(fn=cmd_list_plugins)

    pmi = sub.add_parser("machine-info", help="print machine info JSON")
    pmi.add_argument("--accelerator-type", default="")
    pmi.set_defaults(fn=cmd_machine_info)

    prl = sub.add_parser("release", help="release signing (ed25519)")
    rsub = prl.add_subparsers(dest="release_cmd", required=True)
    r1 = rsub.add_parser("gen-root-key")
    r1.add_argument("--dir", default=".")
    r2 = rsub.add_parser("gen-signing-key")
    r2.add_argument("--dir", default=".")
    r3 = rsub.add_parser("sign-key")
    r3.add_argument("--root-key", required=True)
    r3.add_argument("--signing-pub", required=True)
    r4 = rsub.add_parser("sign-package")
    r4.add_argument("--signing-key", required=True)
    r4.add_argument("--package", required=True)
    r5 = rsub.add_parser("verify-package")
    r5.add_argument("--signing-pub", required=True)
    r5.add_argument("--package", required=True)
    r5.add_argument("--sig", default="")
    r5.add_argument("--root-pub", default="")
    r5.add_argument("--key-sig", default="")
    prl.set_defaults(fn=cmd_release)

    pup = sub.add_parser("update", help="set or check the target version")
    _add_common_flags(pup)
    pup.add_argument("--check", action="store_true")
    pup.add_argument("--target-version", default="")
    pup.add_argument("--install", action="store_true",
                     help="download, verify, and install --target-version now")
    pup.add_argument("--base-url", default="")
    pup.add_argument("--install-dir", default="")
    pup.add_argument("--signing-pub", default="")
    pup.add_argument("--root-pub", default="")
    pup.set_defaults(fn=cmd_update, audited=True)

    pcp = sub.add_parser("custom-plugins", help="validate a plugin specs file")
    pcp.add_argument("file")
    pcp.set_defaults(fn=cmd_custom_plugins)

    prg = sub.add_parser("run-plugin-group", help="run plugins with a tag once")
    prg.add_argument("file")
    prg.add_argument("--tag", default="")
    prg.set_defaults(fn=cmd_run_plugin_group)

    pn = sub.add_parser("notify", help="record a lifecycle notification")
    _add_common_flags(pn)
    pn.add_argument("phase", choices=["startup", "shutdown"])
    pn.set_defaults(fn=cmd_notify, audited=True)

    pmg = sub.add_parser(
        "manager", help="standalone dev control plane (serve / drive)"
    )
    msub = pmg.add_subparsers(dest="manager_cmd", required=True)
    ms = msub.add_parser("serve", help="run a manager process")
    ms.add_argument("--port", type=int, default=15135)
    ms.add_argument("--grpc-port", type=int, default=15136)
    ms.add_argument("--session-token", default="")
    ms.add_argument("--admin-token", default="")
    ms.add_argument("--data-dir", default="",
                    help="persist the fleet rollup journal here "
                         "(default: in-memory)")
    ms.add_argument("--shards", type=int, default=0,
                    help="ingest/rollup shard count "
                         "(default: 8; agents hash to shards by stable "
                         "crc32 slots, so this is safe to change between "
                         "restarts)")
    ms.add_argument("--peer-id", default="",
                    help="stable peer id in the manager peer set (also "
                         "used as instance_id; required with --peers)")
    ms.add_argument("--peers", action="append", default=[],
                    metavar="ID=ENDPOINT[|GRPC]",
                    help="full peer map incl. this manager's own entry; "
                         "repeatable. Enables federation (docs/fleet.md)")
    ms.add_argument("--replication-interval", type=float, default=0.0,
                    help="journal replication tick seconds (0 = "
                         "federation_replication_interval_seconds default)")
    ms.add_argument("--probe-interval", type=float, default=0.0,
                    help="peer health probe seconds (0 = "
                         "federation_probe_interval_seconds default)")
    ms.add_argument("--fanout-timeout", type=float, default=0.0,
                    help="per-peer scatter-gather seconds (0 = "
                         "federation_fanout_timeout_seconds default)")
    ms.add_argument("--dead-after-probes", type=int, default=0,
                    help="consecutive failed probes before a peer is "
                         "declared dead (0 = federation_dead_after_probes "
                         "default)")
    ms.add_argument("--no-auto-adopt", action="store_true",
                    help="never auto-adopt a dead peer's replicated "
                         "cohort (overrides federation_auto_adopt)")
    ms.set_defaults(fn=cmd_manager)
    mm = msub.add_parser("machines", help="list connected agents")
    mm.add_argument("--endpoint", default="http://127.0.0.1:15135")
    mm.add_argument("--admin-token", default="")
    mm.set_defaults(fn=cmd_manager)
    mr = msub.add_parser("request", help="issue one request to an agent")
    mr.add_argument("machine_id")
    mr.add_argument("method")
    mr.add_argument("--params", default="", help="JSON object of parameters")
    mr.add_argument("--endpoint", default="http://127.0.0.1:15135")
    mr.add_argument("--admin-token", default="")
    mr.add_argument("--timeout", type=float, default=30.0)
    mr.set_defaults(fn=cmd_manager)

    pfl = sub.add_parser(
        "fleet", help="fleet observability via a manager's operator API"
    )
    fsub = pfl.add_subparsers(dest="fleet_cmd", required=True)

    def _fleet_common(sp) -> None:
        sp.add_argument("--endpoint", default="http://127.0.0.1:15135")
        sp.add_argument("--admin-token", default="")
        sp.set_defaults(fn=cmd_fleet)

    fr = fsub.add_parser("rollup", help="fleet-wide rollup aggregates")
    _fleet_common(fr)
    ff = fsub.add_parser(
        "fabric", help="fleet-wide NVLink matrix: degraded links since ts"
    )
    ff.add_argument("--since", type=float, default=0.0,
                    help="unix-timestamp floor for degraded-since")
    _fleet_common(ff)
    fp = fsub.add_parser(
        "predict",
        help="fleet-ranked predictive pane: top-K series by decayed risk",
    )
    fp.add_argument("--top", type=int, default=20,
                    help="how many ranked (agent, component) rows")
    _fleet_common(fp)
    fa = fsub.add_parser("agents", help="paginated per-agent rollups")
    fa.add_argument("--offset", type=int, default=0)
    fa.add_argument("--limit", type=int, default=100)
    fa.add_argument("--peer", default="",
                    help="only agents owned by this peer id (cohort "
                         "placement view; federated managers only)")
    _fleet_common(fa)
    fpe = fsub.add_parser(
        "peers",
        help="the manager peer map: ring, health, rendezvous cohorts, "
             "replication watermarks",
    )
    _fleet_common(fpe)
    fh = fsub.add_parser(
        "history", help="one agent's journaled records, newest first"
    )
    fh.add_argument("machine_id")
    fh.add_argument("--since", type=float, default=0.0,
                    help="unix-timestamp floor")
    fh.add_argument("--offset", type=int, default=0)
    fh.add_argument("--limit", type=int, default=100)
    _fleet_common(fh)
    ft = fsub.add_parser(
        "traces", help="fleet records stitched to one check's trace"
    )
    ft.add_argument("correlation_id")
    _fleet_common(ft)
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


if __name__ == "__main__":
    sys.exit(main())
