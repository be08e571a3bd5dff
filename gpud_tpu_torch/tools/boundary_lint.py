"""Boundary lint: payloads crossing process-shaped seams must be
serialization-safe.

Three seams in this codebase are *process boundaries in waiting*:

- ``outbox.publish(kind, payload, ...)`` — the payload is journaled,
  wire-encoded (msgpack/JSON via ``session.wire``), delta-framed, and
  replayed on the manager from the journal alone;
- ``Frame(data=...)`` — frame data goes straight onto a socket;
- ``ingest_executor.submit(id, closure)`` — today the closure hops to a
  shard worker *thread*; moving shard executors out of process would
  make anything the closure drags along have to pickle.

Today the GIL and shared address space make violations invisible: a
``threading.Lock`` smuggled inside a payload dict round-trips fine
through a thread handoff and only explodes when the boundary becomes a
real socket or a real ``fork``. This lint makes the seam's contract
lexical, so the multiprocess cut-over is a mechanical change rather
than an archaeology project:

- payload/data expressions must not *be* or *contain* unserializable
  AST shapes — ``lambda``, ``set`` literals/comprehensions, generator
  expressions (msgpack has no set type; generators and lambdas don't
  pickle);
- identifiers inside a payload expression (and inside a submitted
  closure's body) must not match the deny list of runtime-resource
  names — locks (``_mu``/``_lock``/``_cv``/``_cond*``), threads,
  sqlite handles (``db``/``conn*``), sockets, the BatchWriter — the
  things that are meaningful only in the sending process. Method
  *calls* through ``self`` are fine (they become dispatch on the far
  side); it is carrying the raw resource that is flagged.

Like every lint here the check is lexical and under-approximate: a
variable whose *value* is a set sails through. The seams it guards are
written in a literal style (dict literals of scalars, ``wire.*`` calls,
one lambda in ``AgentHandle.resolve``), so the lexical contract is the
real contract.

Waivers: ``WAIVERS[(rel, line-qualifier, pattern)] = reason`` with the
guard_lint conventions (non-empty reason, stale = error, ``until:
PR-N`` expiry).

Run: ``python -m gpud_tpu_torch.tools.boundary_lint``; registered in
``tools/lint_all.py`` so tier-1 enforces it.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

from gpud_tpu_torch.tools.guard_lint import _repo_root, waiver_reason_problems

# modules containing boundary call sites — keep in sync when a new
# publisher/shipper appears (a listed module with zero sites is an error
# so the list cannot silently rot)
BOUNDARY_MODULES = (
    "gpud_tpu_torch/daemon.py",
    "gpud_tpu_torch/manager/control_plane.py",
    "gpud_tpu_torch/manager/federation.py",
    "gpud_tpu_torch/session/dispatch.py",
    "gpud_tpu_torch/session/outbox.py",
    "gpud_tpu_torch/session/session.py",
    "gpud_tpu_torch/session/v2/client.py",
)

# identifiers that name in-process runtime resources; carrying one
# across a serialization seam is the bug this lint exists for
_DENY_RE = re.compile(
    r"(?:^|_)(?:mu|lock|locks|cv|cond|conds|thread|threads|db|conn|"
    r"connection|cursor|sock|socket|writer|pool|executor|session)\d*$"
)

# AST node kinds msgpack/pickle cannot carry
_UNSAFE_NODES = (ast.Lambda, ast.Set, ast.SetComp, ast.GeneratorExp)

# (rel, f"{site}@{name}", offender) -> reason; offender "*" waives the
# whole site. `site` is "publish" | "frame" | "submit-closure"; `name`
# is the enclosing function name.
WAIVERS: Dict[Tuple[str, str, str], str] = {
    # the current tree is clean — the seams pass dict literals of
    # scalars, pre-encoded bytes, and one enqueue-only lambda
}


class _SiteScanner(ast.NodeVisitor):
    """Finds boundary call sites in one module and checks their payload
    expressions."""

    def __init__(self, rel: str) -> None:
        self.rel = rel
        self.sites: List[Tuple[str, str, int, ast.expr]] = []
        # executor-locals: names assigned from an ingest_executor attr
        self._exec_names: set = set()
        self._func: List[str] = ["<module>"]

    # -- helpers -----------------------------------------------------------
    def _enclosing(self) -> str:
        return self._func[-1]

    def visit_FunctionDef(self, node) -> None:
        self._func.append(node.name)
        self.generic_visit(node)
        self._func.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        if (len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr == "ingest_executor"):
            self._exec_names.add(node.targets[0].id)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr == "publish" and node.args:
                # publish(kind, payload, **meta): payload + every kwarg
                # value is journaled
                for expr in node.args[1:] + [kw.value for kw in node.keywords]:
                    self.sites.append(
                        ("publish", self._enclosing(), node.lineno, expr)
                    )
            elif func.attr == "submit" and self._is_executor(func.value):
                for expr in node.args[1:]:
                    if isinstance(expr, ast.Lambda):
                        self.sites.append(
                            ("submit-closure", self._enclosing(),
                             node.lineno, expr.body)
                        )
                    else:
                        self.sites.append(
                            ("submit-closure", self._enclosing(),
                             node.lineno, expr)
                        )
        if (isinstance(func, ast.Name) and func.id == "Frame") or (
                isinstance(func, ast.Attribute) and func.attr == "Frame"):
            for expr in list(node.args) + [
                kw.value for kw in node.keywords if kw.arg in (None, "data")
            ]:
                self.sites.append(
                    ("frame", self._enclosing(), node.lineno, expr)
                )
        self.generic_visit(node)

    def _is_executor(self, recv: ast.expr) -> bool:
        if isinstance(recv, ast.Name):
            return recv.id in self._exec_names
        if isinstance(recv, ast.Attribute):
            return recv.attr == "ingest_executor"
        return False


def _offenders(expr: ast.expr) -> List[Tuple[int, str]]:
    """(line, offender) pairs for unserializable content in ``expr``."""
    out: List[Tuple[int, str]] = []
    for n in ast.walk(expr):
        if isinstance(n, _UNSAFE_NODES):
            kind = type(n).__name__
            out.append((
                getattr(n, "lineno", 0),
                {"Lambda": "a lambda", "Set": "a set literal",
                 "SetComp": "a set comprehension",
                 "GeneratorExp": "a generator expression"}[kind],
            ))
        elif isinstance(n, ast.Attribute) and _DENY_RE.search(n.attr):
            # self.method(...) is dispatch, not a carried resource
            if not _is_called(expr, n):
                out.append((n.lineno, n.attr))
        elif isinstance(n, ast.Name) and _DENY_RE.search(n.id):
            if not _is_called(expr, n):
                out.append((n.lineno, n.id))
    return out


def _is_called(root: ast.expr, node: ast.AST) -> bool:
    """True when ``node`` is the func of some Call in ``root`` (method
    dispatch through a deny-named receiver is allowed; carrying the
    receiver itself is not)."""
    for n in ast.walk(root):
        if isinstance(n, ast.Call) and n.func is node:
            return True
    return False


def lint_module(path: str, rel: str) -> Tuple[List[str], List[Tuple], int]:
    """(problems, flagged site keys, total sites) for one module.
    Flagged keys are pre-waiver so the caller can match waivers."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=rel)
    scanner = _SiteScanner(rel)
    scanner.visit(tree)
    problems: List[str] = []
    flagged: List[Tuple] = []
    for site, fname, line, expr in scanner.sites:
        for off_line, offender in _offenders(expr):
            flagged.append((rel, f"{site}@{fname}", offender,
                            off_line or line))
    return problems, flagged, len(scanner.sites)


def run_full(root: str = "",
             waivers: Optional[Dict] = None) -> Tuple[List[str], List[str]]:
    """(problems, waiver notes) across BOUNDARY_MODULES; ([], _) = clean."""
    root = root or _repo_root()
    waivers = WAIVERS if waivers is None else waivers
    problems: List[str] = []
    notes: List[str] = []
    used: set = set()
    for rel in BOUNDARY_MODULES:
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            problems.append(f"{rel}: boundary module missing")
            continue
        p, flagged, n_sites = lint_module(path, rel)
        problems.extend(p)
        if n_sites == 0:
            problems.append(
                f"{rel}: listed in BOUNDARY_MODULES but has no publish/"
                "Frame/ingest-submit site — remove it or the seam moved"
            )
        for rel_, key, offender, line in flagged:
            wkey = None
            for cand in ((rel_, key, offender), (rel_, key, "*")):
                if cand in waivers:
                    wkey = cand
                    break
            if wkey is not None:
                used.add(wkey)
                continue
            site = key.split("@")[0]
            problems.append(
                f"{rel_}:{line}: {key} payload carries {offender!r} across "
                f"the {site} serialization boundary — not msgpack-safe / "
                "journal-derivable"
            )
    for wkey, reason in sorted(waivers.items()):
        rel_ = wkey[0]
        problems.extend(
            f"{rel_}: boundary waiver {wkey}: {p}"
            for p in waiver_reason_problems(reason, root=root)
        )
        if wkey not in used:
            problems.append(
                f"{rel_}: boundary waiver {wkey} matches no flagged site "
                "(stale waiver — remove it)"
            )
        else:
            notes.append(f"{wkey[1]} ({wkey[2]}) in {rel_} — {reason}")
    return problems, notes


def run_lint(root: str = "") -> List[str]:
    return run_full(root)[0]


def main() -> int:
    problems, notes = run_full()
    for n in notes:
        print(f"boundary-lint: waived {n}")
    for p in problems:
        print(f"boundary-lint: {p}", file=sys.stderr)
    if problems:
        print(f"boundary-lint: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    print(
        f"boundary-lint: {len(BOUNDARY_MODULES)} module(s) clean, "
        f"{len(notes)} justified waiver(s)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
