"""One entry point for every registration lint.

Each lint guards a registry that silently drifts: a metric module left
out of ``metrics_lint._METRIC_MODULES`` never gets linted, a store left
out of ``storage_lint.STORE_MODULES`` can regress to per-row commits,
and an HTTP route without a docstring ships an OpenAPI operation with
no summary. Running them as one suite — and wiring that suite into
tier-1 (tests/test_torch_lint_all.py) — turns "forgot to register it"
from a chip-run discovery into a failing unit test.

Checks:

- **metrics**: import every metric-defining module, lint the default
  registry (prefix, help text, unit suffixes, reserved labels).
- **storage**: AST-scan every SQLite-backed store's declared
  ``HOT_WRITE_METHODS`` for writer routing.
- **openapi**: build the node API's route table against a throwaway
  unstarted Server, render /openapi.json straight from it, and
  check both parity directions plus a non-empty summary per operation.
- **guard**: AST-verify every GUARDED_BY-annotated attribute access in
  the threaded modules sits under its declared lock (guard_lint).
- **parity**: config knobs referenced/documented/validated, dispatcher
  matrix + SDK coverage, /v1 route matrix coverage (parity_lint).
- **race**: the race harness (``tools/race.py``) stays wired — GIL
  amplifier, detector, exit gates and its call from ``chip_smoke.py``
  all present (the harness runs the chaos campaigns, so only its
  registration is linted here).
- **flow**: interprocedural hot-path reachability — no session-reader /
  shard-executor / scheduler / HTTP entrypoint reaches a blocking sink
  without a justified waiver (flow_lint).
- **boundary**: payloads crossing the outbox / Frame / ingest-executor
  serialization seams stay msgpack-safe and journal-derivable
  (boundary_lint).
- **schema**: the wire surface (codec prefixes, delta records,
  ``outbox_batch``, Frame revisions, journal rows, predict payloads)
  matches the frozen golden (schema_lint).

Run: ``python -m gpud_tpu_torch.tools.lint_all`` (exit 1 on any problem);
``--json`` emits a machine-readable problem list instead of text;
``--update-goldens`` regenerates the schema golden from the current
tree (bumping its version) instead of linting.
"""

from __future__ import annotations

import json
import os
import re
import sys
import tempfile
from typing import Dict, List


def openapi_parity_problems() -> List[str]:
    """Route-table vs document parity without sockets: the port's route
    table comes from ``build_routes`` over a Server that was built but
    never started, and its /openapi.json handler reads only that table, so
    it is called directly with no request."""
    from gpud_tpu_torch.config import default_config
    from gpud_tpu_torch.server.app import build_routes
    from gpud_tpu_torch.server.server import Server

    problems: List[str] = []
    with tempfile.TemporaryDirectory(prefix="tpud-lint-") as tmp:
        kmsg = os.path.join(tmp, "kmsg.fixture")
        with open(kmsg, "w", encoding="utf-8"):
            pass
        cfg = default_config(
            data_dir=os.path.join(tmp, "data"), port=0, tls=False,
            kmsg_path=kmsg,
        )
        cfg.components_disabled = ["network-latency"]  # egress-free
        srv = Server(config=cfg)
        try:
            handler = None
            served = set()
            for route in build_routes(srv):
                method = route.method.lower()
                if route.path == "/openapi.json" and method == "get":
                    handler = route.handler
                if route.path == "/openapi.json" or method == "head":
                    continue
                served.add((route.path, method))
            if handler is None:
                return ["/openapi.json route is not registered"]
            doc = json.loads(handler(None).body.decode())
            documented = {
                (path, method)
                for path, methods in doc["paths"].items()
                for method in methods
            }
            for path, method in sorted(served - documented):
                problems.append(
                    f"served but undocumented: {method.upper()} {path}"
                )
            for path, method in sorted(documented - served):
                problems.append(
                    f"documented but not served: {method.upper()} {path}"
                )
            for path, methods in sorted(doc["paths"].items()):
                for method, op in methods.items():
                    if not op.get("summary"):
                        problems.append(
                            f"{method.upper()} {path}: operation has no "
                            "summary (handler docstring missing)"
                        )
        finally:
            srv.stop()
    return problems


def race_harness_problems() -> List[str]:
    """The race harness itself runs the chaos campaigns (minutes), far too
    slow for tier-1, but its *wiring* is lintable: tools/race.py must keep
    its GIL-preemption amplifier, detector and exit gates, and the card's
    smoke script must keep calling it. This pins the harness against
    silent removal the same way the other registries are pinned."""
    import ast

    from gpud_tpu_torch.tools.guard_lint import _repo_root

    rel = "gpud_tpu_torch/tools/race.py"
    path = os.path.join(_repo_root(), rel)
    if not os.path.isfile(path):
        return [f"{rel}: missing (race harness unregistered)"]
    with open(path, encoding="utf-8") as f:
        src = f.read()
    problems: List[str] = []
    tree = ast.parse(src, filename=rel)
    fn = next(
        (n for n in tree.body
         if isinstance(n, ast.FunctionDef) and n.name == "run_race"),
        None,
    )
    if fn is None:
        return [f"{rel}: run_race() is gone — the race harness must "
                "stay registered"]
    seg = ast.get_source_segment(src, fn) or ""
    for needle, why in (
        ("sys.setswitchinterval(GIL_SWITCH_INTERVAL_S)",
         "GIL-preemption amplifier"),
        ("LockOrderDetector", "lock-order instrumentation"),
        ("det.cycles()", "acyclicity gate"),
        ("self_deadlocks", "self-deadlock gate"),
        ("_nondaemon_threads", "thread-leak audit"),
    ):
        if needle not in seg:
            problems.append(
                f"{rel}:{fn.lineno}: run_race() lost its "
                f"{why} ({needle!r} not found)"
            )
    if "GIL_SWITCH_INTERVAL_S = 1e-5" not in src:
        problems.append(f"{rel}: the switch interval is no longer 10 µs")
    smoke = os.path.join(_repo_root(), "chip_smoke.py")
    smoke_src = ""
    if os.path.isfile(smoke):
        with open(smoke, encoding="utf-8") as f:
            smoke_src = f.read()
    if "gpud_tpu_torch.tools.race" not in smoke_src:
        problems.append(
            "chip_smoke.py: the race phase no longer runs tools/race.py"
        )
    return problems


def run_all() -> List[str]:
    """Every lint, one problem list; [] = clean. Problems are prefixed
    with their lint's name so a CI log line is self-locating."""
    from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY
    from gpud_tpu_torch.tools import (
        boundary_lint,
        flow_lint,
        guard_lint,
        metrics_lint,
        parity_lint,
        schema_lint,
        storage_lint,
    )

    problems: List[str] = []
    metrics_lint.populate_default_registry()
    problems.extend(
        f"metrics: {p}" for p in metrics_lint.lint_registry(DEFAULT_REGISTRY)
    )
    problems.extend(f"storage: {p}" for p in storage_lint.run_lint())
    problems.extend(f"openapi: {p}" for p in openapi_parity_problems())
    problems.extend(f"guard: {p}" for p in guard_lint.run_lint())
    problems.extend(f"parity: {p}" for p in parity_lint.run_lint())
    problems.extend(f"race: {p}" for p in race_harness_problems())
    problems.extend(f"flow: {p}" for p in flow_lint.run_lint())
    problems.extend(f"boundary: {p}" for p in boundary_lint.run_lint())
    problems.extend(f"schema: {p}" for p in schema_lint.run_lint())
    return problems


# problems carry a "<lint>: <file>:<line>: <message>" shape when they
# anchor to a source line; lints that check cross-file invariants (e.g.
# openapi parity) omit the location
_PROBLEM_RE = re.compile(r"^(?P<lint>[a-z]+): (?:(?P<file>[^\s:]+\.(?:py|md|json))"
                         r"(?::(?P<line>\d+))?: )?(?P<message>.*)$", re.S)


def problems_as_json(problems: List[str]) -> List[Dict]:
    """Machine-readable problem list: lint name, file, line, message."""
    out: List[Dict] = []
    for p in problems:
        m = _PROBLEM_RE.match(p)
        if m is None:
            out.append({"lint": "", "file": None, "line": None, "message": p})
            continue
        out.append({
            "lint": m.group("lint"),
            "file": m.group("file"),
            "line": int(m.group("line")) if m.group("line") else None,
            "message": m.group("message"),
        })
    return out


def main(argv: List[str] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--update-goldens" in argv:
        from gpud_tpu_torch.tools import schema_lint

        path, changed = schema_lint.update_golden()
        print(f"lint-all: {'updated' if changed else 'unchanged'} {path}")
        return 0
    as_json = "--json" in argv
    problems = run_all()
    if as_json:
        print(json.dumps(problems_as_json(problems), indent=2))
        return 1 if problems else 0
    for p in problems:
        print(f"lint-all: {p}", file=sys.stderr)
    if problems:
        print(f"lint-all: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    print("lint-all: metrics + storage + openapi + guard + parity + "
          "race-wiring + flow + boundary + schema clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
