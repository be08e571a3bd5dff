"""Parity lint: the standing review rules, mechanized.

Three parity contracts would otherwise live only in review discipline
(docs/PARITY.md). Each is cheap to check syntactically and expensive to
discover broken at runtime, so this lint pins them:

1. **Config knobs** — every ``Config`` dataclass field must be
   *referenced* outside config.py (a knob nothing reads is a dead knob:
   operators set it and nothing changes), *documented* (its name appears
   in docs/ or the README), and — for numeric knobs — *validated* (a
   range check in ``Config.validate()``; a typo'd negative interval must
   die at startup, not wedge a scheduler job).
2. **Session dispatcher** — every ``_m_*`` method must have at least one
   row in the dispatcher error matrix (tests/test_dispatch_error_matrix
   .py, which tests/test_torch_dispatch.py runs on the port) and a
   declared SDK disposition in ``DISPATCH_TO_SDK`` below:
   either the ``client/v1.py`` method that fronts it, or ``None`` with a
   reason (control-plane-only verbs have no SDK surface by design). The
   mapping must cover the method set exactly — a new dispatch method
   fails the lint until its SDK story is stated.
3. **HTTP routes** — every registered ``/v1/*`` path in server/app.py
   AND in the manager's control_plane.py must appear in the HTTP route
   matrix (tests/test_http_route_matrix.py, which
   tests/test_torch_server.py runs on the port), so a new route ships with
   at least one method/shape row.

Run: ``python -m gpud_tpu_torch.tools.parity_lint`` (exit 1 on any problem);
registered in ``tools/lint_all.py`` so tier-1 enforces it.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, List, Optional, Set, Tuple

CONFIG_MODULE = "gpud_tpu_torch/config.py"
DISPATCH_MODULE = "gpud_tpu_torch/session/dispatch.py"
SDK_MODULE = "gpud_tpu_torch/client/v1.py"
APP_MODULE = "gpud_tpu_torch/server/app.py"
MANAGER_MODULE = "gpud_tpu_torch/manager/control_plane.py"
DISPATCH_MATRIX_TEST = "tests/test_dispatch_error_matrix.py"
ROUTE_MATRIX_TEST = "tests/test_http_route_matrix.py"

# Dispatcher method -> SDK method in client/v1.py, or None + reason.
# This table IS the parity statement: every dispatch verb either has a
# public SDK front door or an explicit "control-plane only" rationale.
DISPATCH_TO_SDK: Dict[str, Tuple[Optional[str], str]] = {
    "states": ("get_health_states", ""),
    "events": ("get_events", ""),
    "stateHistory": ("get_state_history", ""),
    "predictStatus": ("get_predict_scores", ""),
    "predictCalibration": ("get_predict_calibration", ""),
    "fabricStatus": ("get_fabric", ""),
    "remediationStatus": ("get_remediation_audit", ""),
    "remediationPolicy": ("get_remediation_policy", ""),
    "metrics": ("get_metrics", ""),
    "traces": (None, "node debug ring is /v1/debug/traces; the SDK "
                     "fronts the correlated manager view (get_fleet_traces)"),
    "gossip": (None, "session keep-alive frame; never operator-initiated"),
    "diagnostic": (None, "control-plane remote diagnostics channel"),
    "reboot": (None, "control-plane remediation verb; deliberately no "
                     "local SDK front door"),
    "setHealthy": ("set_healthy", ""),
    "triggerComponent": ("trigger_check", ""),
    "deregisterComponent": ("deregister_component", ""),
    "injectFault": ("inject_fault", ""),
    "chaosRun": ("run_chaos", ""),
    "chaosStatus": ("get_chaos_campaigns", ""),
    "outboxAck": (None, "manager->agent delivery ack; internal to the "
                        "at-least-once session protocol"),
    "outboxStatus": ("get_session_status", ""),
    "peerStatus": (None, "agent-side failover introspection over the "
                         "session channel; the operator pane is the "
                         "manager's GET /v1/fleet/peers (SDK "
                         "get_fleet_peers)"),
    "bootstrap": (None, "control-plane provisioning script channel"),
    "updateConfig": (None, "control-plane config push"),
    "updateToken": (None, "enrollment rotation; control-plane only"),
    "getToken": (None, "enrollment introspection; control-plane only"),
    "logout": (None, "machine lifecycle verb; control-plane only"),
    "delete": (None, "machine lifecycle verb; control-plane only"),
    "packageStatus": (None, "package manager status; served locally via "
                            "/admin/packages, no typed SDK call"),
    "update": (None, "self-update trigger; control-plane only"),
    "kapMTLSStatus": (None, "credential-plane status; control-plane only"),
    "kapMTLSUpdateCredentials": (None, "credential rotation; control-plane "
                                       "only"),
    "kapMTLSActivate": (None, "credential activation; control-plane only"),
    "getPluginSpecs": (None, "plugin spec sync; local read is /v1/plugins"),
    "setPluginSpecs": (None, "plugin spec push; control-plane only"),
}

# Non-numeric knobs (bool/str/list/dict) carry no range to validate;
# numeric knobs get no such pass.
_NUMERIC_ANNOTATIONS = {"int", "float"}


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def _read(root: str, rel: str) -> str:
    with open(os.path.join(root, rel), encoding="utf-8") as f:
        return f.read()


def _class_methods(tree: ast.Module, prefix: str = "") -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and item.name.startswith(prefix)):
                    out.add(item.name)
    return out


# -- 1. config knobs ---------------------------------------------------------

def config_problems(root: str) -> List[str]:
    src = _read(root, CONFIG_MODULE)
    tree = ast.parse(src, filename=CONFIG_MODULE)
    cls = next(
        (n for n in tree.body
         if isinstance(n, ast.ClassDef) and n.name == "Config"),
        None,
    )
    if cls is None:
        return [f"{CONFIG_MODULE}: no Config dataclass found"]
    fields: List[Tuple[str, int, str]] = []  # (name, line, annotation)
    validate_fn = None
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            ann = stmt.annotation
            ann_name = ann.id if isinstance(ann, ast.Name) else ""
            fields.append((stmt.target.id, stmt.lineno, ann_name))
        elif isinstance(stmt, ast.FunctionDef) and stmt.name == "validate":
            validate_fn = stmt
    problems: List[str] = []
    if validate_fn is None:
        return [f"{CONFIG_MODULE}: Config has no validate() method"]
    validated: Set[str] = {
        n.attr for n in ast.walk(validate_fn)
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
        and n.value.id == "self"
    }

    # one pass over the rest of the tree for reference detection
    code_blob: List[str] = []
    for sub, _dirs, files in os.walk(os.path.join(root, "gpud_tpu_torch")):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(sub, fn)
                if os.path.relpath(path, root) == CONFIG_MODULE:
                    continue
                with open(path, encoding="utf-8") as f:
                    code_blob.append(f.read())
    for extra in ("chip_smoke.py",):
        p = os.path.join(root, extra)
        if os.path.isfile(p):
            with open(p, encoding="utf-8") as f:
                code_blob.append(f.read())
    for sub, _dirs, files in os.walk(os.path.join(root, "tests")):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(sub, fn), encoding="utf-8") as f:
                    code_blob.append(f.read())
    code = "\n".join(code_blob)

    docs_blob: List[str] = []
    docs_dir = os.path.join(root, "docs")
    if os.path.isdir(docs_dir):
        for fn in os.listdir(docs_dir):
            if fn.endswith(".md"):
                with open(os.path.join(docs_dir, fn), encoding="utf-8") as f:
                    docs_blob.append(f.read())
    readme = os.path.join(root, "README.md")
    if os.path.isfile(readme):
        with open(readme, encoding="utf-8") as f:
            docs_blob.append(f.read())
    docs = "\n".join(docs_blob)

    for name, line, ann in fields:
        if not re.search(rf"\b{re.escape(name)}\b", code):
            problems.append(
                f"{CONFIG_MODULE}:{line}: Config.{name} is a dead knob — "
                "nothing outside config.py references it"
            )
        if not re.search(rf"\b{re.escape(name)}\b", docs):
            problems.append(
                f"{CONFIG_MODULE}:{line}: Config.{name} is undocumented — "
                "name it in docs/*.md or README.md (docs/config.md is the "
                "knob reference)"
            )
        if ann in _NUMERIC_ANNOTATIONS and name not in validated:
            problems.append(
                f"{CONFIG_MODULE}:{line}: Config.{name} is numeric but "
                "validate() never range-checks it — a typo'd value must "
                "die at startup"
            )
    return problems


# -- 2. dispatcher matrix + SDK parity ---------------------------------------

def dispatch_problems(root: str) -> List[str]:
    tree = ast.parse(_read(root, DISPATCH_MODULE), filename=DISPATCH_MODULE)
    methods = {
        name[len("_m_"):] for name in _class_methods(tree, prefix="_m_")
    }
    if not methods:
        return [f"{DISPATCH_MODULE}: no _m_* dispatch methods found"]
    problems: List[str] = []

    # matrix coverage
    mtree = ast.parse(
        _read(root, DISPATCH_MATRIX_TEST), filename=DISPATCH_MATRIX_TEST
    )
    covered: Set[str] = set()
    matrix_line = 0
    for node in mtree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "MATRIX" for t in node.targets
        ):
            matrix_line = node.lineno
            # rows hold non-literal params (float("nan")) — read only the
            # leading method-name constant of each tuple
            if isinstance(node.value, (ast.List, ast.Tuple)):
                for row in node.value.elts:
                    if (isinstance(row, ast.Tuple) and row.elts
                            and isinstance(row.elts[0], ast.Constant)
                            and isinstance(row.elts[0].value, str)):
                        covered.add(row.elts[0].value)
    if not covered:
        problems.append(
            f"{DISPATCH_MATRIX_TEST}: MATRIX literal missing or unparsable"
        )
    for m in sorted(methods - covered):
        problems.append(
            f"{DISPATCH_MATRIX_TEST}:{matrix_line}: dispatch method "
            f"{m!r} has no error-matrix row"
        )
    for m in sorted(covered - methods):
        problems.append(
            f"{DISPATCH_MATRIX_TEST}:{matrix_line}: matrix row for "
            f"{m!r} names no existing dispatch method (stale row)"
        )

    # SDK disposition
    sdk_tree = ast.parse(_read(root, SDK_MODULE), filename=SDK_MODULE)
    sdk_methods = _class_methods(sdk_tree)
    for m in sorted(methods - set(DISPATCH_TO_SDK)):
        problems.append(
            f"{DISPATCH_MODULE}: dispatch method {m!r} has no entry in "
            "parity_lint.DISPATCH_TO_SDK — state its SDK front door or "
            "waive it with a reason"
        )
    for m in sorted(set(DISPATCH_TO_SDK) - methods):
        problems.append(
            f"DISPATCH_TO_SDK names {m!r} but dispatch.py defines no "
            f"_m_{m} (stale mapping)"
        )
    for m, (sdk, reason) in sorted(DISPATCH_TO_SDK.items()):
        if sdk is None:
            if not reason.strip():
                problems.append(
                    f"DISPATCH_TO_SDK[{m!r}] waives the SDK counterpart "
                    "without a reason"
                )
        elif sdk not in sdk_methods:
            problems.append(
                f"DISPATCH_TO_SDK[{m!r}] names client method {sdk!r} "
                f"but {SDK_MODULE} defines no such method"
            )
    return problems


# -- 3. /v1 route matrix ------------------------------------------------------

def _module_routes(root: str, module: str) -> List[Tuple[str, str, int]]:
    """/v1/* routes registered in one of the port's three table shapes
    (``flow_lint.route_row``): ``add("GET", path, handler)``
    (server/app.py), ``Route("GET", path, handler, ...)`` and
    ``("GET", path, handler)`` rows (manager/control_plane.py)."""
    from gpud_tpu_torch.tools.flow_lint import route_row

    tree = ast.parse(_read(root, module), filename=module)
    routes: List[Tuple[str, str, int]] = []  # (method, path, line)
    for node in ast.walk(tree):
        row = route_row(node)
        if row is not None and row[1].startswith("/v1/"):
            routes.append((row[0], row[1], node.lineno))
    return routes


def route_problems(root: str) -> List[str]:
    matrix_src = _read(root, ROUTE_MATRIX_TEST)
    problems: List[str] = []
    for module in (APP_MODULE, MANAGER_MODULE):
        # the agent app is the lint's anchor and must exist; the manager
        # module is optional so the synthetic fixture trees the lint's
        # own tests build (agent app only) stay valid inputs
        if (module is not APP_MODULE
                and not os.path.isfile(os.path.join(root, module))):
            continue
        routes = _module_routes(root, module)
        if not routes:
            problems.append(
                f"{module}: no /v1/* routes found (parser drift?)"
            )
            continue
        for method, path, line in sorted(routes):
            if path not in matrix_src:
                problems.append(
                    f"{module}:{line}: {method} {path} has no row in "
                    f"{ROUTE_MATRIX_TEST}"
                )
    return problems


def run_lint(root: str = "") -> List[str]:
    """One problem string per violation; [] = clean."""
    root = root or _repo_root()
    problems: List[str] = []
    problems.extend(config_problems(root))
    problems.extend(dispatch_problems(root))
    problems.extend(route_problems(root))
    return problems


def main() -> int:
    problems = run_lint()
    for p in problems:
        print(f"parity-lint: {p}", file=sys.stderr)
    if problems:
        print(f"parity-lint: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    print("parity-lint: config knobs + dispatcher matrix/SDK + /v1 routes clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
