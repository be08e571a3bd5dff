"""Guarded-by lint: threaded state must be touched under its lock.

The reference daemon gets this check for free from ``go test -race``;
CPython's GIL hides the same bugs until a preemption lands between a
check and an act. This lint is the static half of the port's answer
(the dynamic half is ``tools/race.py``): every threaded class in the
modules pinned below declares a clang-thread-safety-style mapping

    GUARDED_BY = {"_agents": "_lock", "_pending": "_cv", ...}

from attribute name to the ``self.<lock>`` that guards it, and the lint
verifies every read or mutation of a guarded attribute occurs lexically
inside a ``with self.<lock>:`` block. Three escape hatches, all
deliberate and all visible in the report:

  - ``__init__`` is always exempt — the object is pre-publication and
    no other thread can hold a reference yet.
  - methods named ``*_locked`` are exempt — the suffix is the repo's
    standing caller-holds-the-lock convention, and the lint checks the
    *callers* instead.
  - a class may declare ``_LOCK_FREE = {"method": "reason"}``; waived
    methods are skipped but every waiver must carry a non-empty reason
    string, must still be *needed* (a waiver over a clean method is a
    stale-marker error), and is printed in the lint report so review
    sees the full waiver surface on every run. A reason may carry an
    expiry stamp ``until: PR-N``: the waiver fails once PR N is being
    built (``current_pr_number`` = max CHANGES.md entry + 1), so
    temporary waivers cannot quietly become permanent.

The analysis is lexical, not interprocedural, with two affordances the
codebase's idiom requires:

  - **lock aliases**: ``cond = self._conds[i]`` (or a ``for`` target
    iterating ``self._conds``) marks ``cond`` as holding ``_conds``
    when used in ``with cond:`` — the lock-striped executor and every
    Condition-per-shard pattern binds locks to locals first.
  - **closure reset**: a nested ``def``/``lambda`` body is scanned with
    an *empty* held-lock set, because closures outlive the enclosing
    ``with`` block and run on other threads (the chaos runner's
    scenario thunks are the canonical case).
  - **base merge**: ``GUARDED_BY`` merges down from in-module base
    classes, so ``Gauge``/``Counter`` inherit ``_Metric``'s map.

Run: ``python -m gpud_tpu_torch.tools.guard_lint`` (exit 1 on any problem);
registered in ``tools/lint_all.py`` so tier-1 enforces it.
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, FrozenSet, List, Optional, Tuple

# repo-relative paths of every module that owns cross-thread mutable
# state — keep in sync when a new threaded subsystem appears
GUARD_MODULES = (
    "gpud_tpu_torch/chaos/runner.py",
    "gpud_tpu_torch/fabric/plane.py",
    "gpud_tpu_torch/health_history.py",
    "gpud_tpu_torch/manager/federation.py",
    "gpud_tpu_torch/manager/peers.py",
    "gpud_tpu_torch/manager/rollup.py",
    "gpud_tpu_torch/manager/shard.py",
    "gpud_tpu_torch/metrics/registry.py",
    "gpud_tpu_torch/predict/engine.py",
    "gpud_tpu_torch/scheduler/core.py",
    "gpud_tpu_torch/session/outbox.py",
    "gpud_tpu_torch/storage/writer.py",
)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


_UNTIL_RE = re.compile(r"until:\s*PR-(\d+)\b")
_PR_LINE_RE = re.compile(r"^PR (\d+)\b", re.M)
_pr_cache: Dict[str, int] = {}


def current_pr_number(root: str = "") -> int:
    """The PR being built right now: max ``PR N`` entry in CHANGES.md
    plus one (each session appends its line only at the end)."""
    root = root or _repo_root()
    cached = _pr_cache.get(root)
    if cached is not None:
        return cached
    seen = 0
    path = os.path.join(root, "CHANGES.md")
    try:
        with open(path, encoding="utf-8") as f:
            for m in _PR_LINE_RE.finditer(f.read()):
                seen = max(seen, int(m.group(1)))
    except OSError:
        pass
    _pr_cache[root] = seen + 1
    return seen + 1


def waiver_reason_problems(reason: object, root: str = "") -> List[str]:
    """Shared waiver-reason checks (guard_lint, flow_lint, boundary_lint):
    a reason must be a non-empty string, and may carry an expiry stamp
    ``until: PR-N`` — the waiver is good for PRs *before* N and fails
    once PR N is being built, forcing the owner to resolve or re-justify
    it in that PR."""
    if not (isinstance(reason, str) and reason.strip()):
        return ["has no justification — every waiver carries a reason"]
    m = _UNTIL_RE.search(reason)
    if m is not None:
        deadline = int(m.group(1))
        current = current_pr_number(root)
        if current >= deadline:
            return [
                f"expired: stamped `until: PR-{deadline}` and this is "
                f"PR {current} — resolve the waiver or restamp it with a "
                "new deadline and justification"
            ]
    return []


def _class_dict(cls: ast.ClassDef, name: str) -> Tuple[Optional[Dict], int]:
    """A class-level ``name = {...}`` literal, or (None, 0) when absent."""
    for stmt in cls.body:
        if not isinstance(stmt, ast.Assign):
            continue
        for tgt in stmt.targets:
            if isinstance(tgt, ast.Name) and tgt.id == name:
                try:
                    val = ast.literal_eval(stmt.value)
                except (ValueError, SyntaxError):
                    return None, stmt.lineno
                if isinstance(val, dict):
                    return val, stmt.lineno
                return None, stmt.lineno
    return None, 0


class _MethodScanner:
    """Lexical walk of one method body tracking which locks are held."""

    def __init__(self, guarded: Dict[str, str]) -> None:
        self.guarded = guarded
        self.locks = set(guarded.values())
        self.violations: List[Tuple[int, str, str]] = []  # (line, attr, lock)

    def scan(self, fn: ast.FunctionDef) -> None:
        self._stmts(fn.body, frozenset(), {})

    # -- helpers -------------------------------------------------------------
    def _lock_mentioned(self, expr: ast.AST) -> Optional[str]:
        """First ``self.<lock>`` attribute reachable in ``expr``."""
        for n in ast.walk(expr):
            if (isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self" and n.attr in self.locks):
                return n.attr
        return None

    def _lock_of(self, expr: ast.expr, aliases: Dict[str, str]) -> Optional[str]:
        """The lock a ``with <expr>:`` acquires, if we can tell."""
        if isinstance(expr, ast.Name):
            return aliases.get(expr.id)
        return self._lock_mentioned(expr)

    # -- expression scan -----------------------------------------------------
    def _expr(self, node: Optional[ast.AST], held: FrozenSet[str],
              aliases: Optional[Dict[str, str]] = None) -> None:
        aliases = aliases or {}
        if node is None:
            return
        stack: List[ast.AST] = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                # closure: runs later, possibly on another thread, with
                # no lock held — scan its body from a cold start
                self._expr(n.body, frozenset(), aliases)
                continue
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "wait_for"):
                # Condition.wait_for(predicate): the predicate runs with
                # the condition's lock re-acquired — its lambda body is
                # locked, not a cold closure
                lock = self._lock_of(n.func.value, aliases)
                if lock:
                    self._expr(n.func.value, held, aliases)
                    for arg in list(n.args) + [kw.value for kw in n.keywords]:
                        if isinstance(arg, ast.Lambda):
                            self._expr(arg.body, held | {lock}, aliases)
                        else:
                            self._expr(arg, held, aliases)
                    continue
            if (isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self" and n.attr in self.guarded):
                lock = self.guarded[n.attr]
                if lock not in held:
                    self.violations.append((n.lineno, n.attr, lock))
            stack.extend(ast.iter_child_nodes(n))

    # -- statement scan ------------------------------------------------------
    def _stmts(self, body: List[ast.stmt], held: FrozenSet[str],
               aliases: Dict[str, str]) -> None:
        for stmt in body:
            self._stmt(stmt, held, aliases)

    def _stmt(self, node: ast.stmt, held: FrozenSet[str],
              aliases: Dict[str, str]) -> None:
        if isinstance(node, _FUNC_NODES) or isinstance(node, ast.ClassDef):
            # nested scope = closure: scanned lock-free (see module doc)
            self._stmts(node.body, frozenset(), {})
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = set()
            for item in node.items:
                self._expr(item.context_expr, held, aliases)
                lock = self._lock_of(item.context_expr, aliases)
                if lock:
                    acquired.add(lock)
                    if isinstance(item.optional_vars, ast.Name):
                        aliases[item.optional_vars.id] = lock
            self._stmts(node.body, held | acquired, aliases)
            return
        if isinstance(node, ast.Assign):
            self._expr(node.value, held, aliases)
            for tgt in node.targets:
                self._expr(tgt, held, aliases)
            if len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                lock = self._lock_mentioned(node.value)
                if lock:
                    aliases[name] = lock
                else:
                    aliases.pop(name, None)  # rebound to something else
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._expr(node.iter, held, aliases)
            self._expr(node.target, held, aliases)
            lock = self._lock_mentioned(node.iter)
            if lock:
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        aliases[n.id] = lock
            self._stmts(node.body, held, aliases)
            self._stmts(node.orelse, held, aliases)
            return
        # generic statement: check contained expressions, recurse into
        # contained statement lists (If/While/Try/Match bodies)
        for _field, value in ast.iter_fields(node):
            if isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.stmt):
                        self._stmt(v, held, aliases)
                    elif isinstance(v, ast.expr):
                        self._expr(v, held, aliases)
                    elif isinstance(v, ast.excepthandler):
                        self._expr(v.type, held, aliases)
                        self._stmts(v.body, held, aliases)
                    elif isinstance(v, getattr(ast, "match_case", ())):
                        self._expr(v.guard, held, aliases)
                        self._stmts(v.body, held, aliases)
            elif isinstance(value, ast.stmt):
                self._stmt(value, held, aliases)
            elif isinstance(value, ast.expr):
                self._expr(value, held, aliases)


def _lock_defined(classes: List[ast.ClassDef], lock: str) -> bool:
    """The lock attribute is assigned somewhere in the class chain."""
    for cls in classes:
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self" and tgt.attr == lock):
                        return True
                    if isinstance(tgt, ast.Name) and tgt.id == lock:
                        return True
    return False


def lint_module(path: str, rel: str,
                root: str = "") -> Tuple[List[str], List[str]]:
    """Returns (problems, waivers) for one module."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=rel)
    problems: List[str] = []
    waivers: List[str] = []

    by_name: Dict[str, ast.ClassDef] = {
        n.name: n for n in tree.body if isinstance(n, ast.ClassDef)
    }
    annotated = 0
    for cls in by_name.values():
        own, gb_line = _class_dict(cls, "GUARDED_BY")
        if gb_line and own is None:
            problems.append(
                f"{rel}:{gb_line}: {cls.name}.GUARDED_BY is not a literal "
                "dict of str -> str"
            )
            continue
        # merge GUARDED_BY down from in-module bases (subclass wins)
        chain: List[ast.ClassDef] = [cls]
        guarded: Dict[str, str] = {}
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in by_name:
                base_cls = by_name[base.id]
                base_gb, _ = _class_dict(base_cls, "GUARDED_BY")
                if base_gb:
                    guarded.update(base_gb)
                    chain.append(base_cls)
        if own:
            guarded.update(own)
        if not guarded:
            continue
        annotated += 1

        for attr, lock in guarded.items():
            if not (isinstance(attr, str) and isinstance(lock, str)):
                problems.append(
                    f"{rel}:{gb_line}: {cls.name}.GUARDED_BY entries must "
                    "map attribute name -> lock attribute name (strings)"
                )
                continue
            if not _lock_defined(chain, lock):
                problems.append(
                    f"{rel}:{gb_line or cls.lineno}: {cls.name}.GUARDED_BY "
                    f"names lock {lock!r} for {attr!r} but the class never "
                    "assigns it (stale annotation)"
                )

        lock_free, lf_line = _class_dict(cls, "_LOCK_FREE")
        lock_free = lock_free or {}
        methods = {
            item.name: item for item in cls.body
            if isinstance(item, _FUNC_NODES)
        }
        for name, reason in lock_free.items():
            if name not in methods:
                problems.append(
                    f"{rel}:{lf_line}: {cls.name}._LOCK_FREE waives "
                    f"{name!r} but no such method exists (stale waiver)"
                )
            for why in waiver_reason_problems(reason, root=root):
                problems.append(
                    f"{rel}:{lf_line}: {cls.name}._LOCK_FREE[{name!r}] {why}"
                )

        for name, fn in methods.items():
            if name == "__init__" or name.endswith("_locked"):
                continue  # pre-publication / caller-holds-lock convention
            scanner = _MethodScanner(guarded)
            scanner.scan(fn)
            if name in lock_free:
                reason = lock_free[name]
                if not scanner.violations:
                    problems.append(
                        f"{rel}:{fn.lineno}: {cls.name}.{name}() is waived "
                        "in _LOCK_FREE but touches no guarded attribute "
                        "outside a lock (stale waiver — remove it)"
                    )
                else:
                    waivers.append(
                        f"{rel}:{fn.lineno}: {cls.name}.{name}() — {reason}"
                    )
                continue
            for line, attr, lock in scanner.violations:
                problems.append(
                    f"{rel}:{line}: {cls.name}.{name}() touches "
                    f"self.{attr} outside `with self.{lock}` "
                    "(GUARDED_BY violation)"
                )
    if not annotated:
        problems.append(
            f"{rel}: threaded module declares no GUARDED_BY class — every "
            "module in GUARD_MODULES must annotate its shared state"
        )
    return problems, waivers


def run_full(root: str = "") -> Tuple[List[str], List[str]]:
    """(problems, waivers) across GUARD_MODULES; ([], _) = clean."""
    root = root or _repo_root()
    problems: List[str] = []
    waivers: List[str] = []
    for rel in GUARD_MODULES:
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            problems.append(f"{rel}: guarded module missing")
            continue
        p, w = lint_module(path, rel, root=root)
        problems.extend(p)
        waivers.extend(w)
    return problems, waivers


def run_lint(root: str = "") -> List[str]:
    """One problem string per violation across GUARD_MODULES; [] = clean."""
    return run_full(root)[0]


def main() -> int:
    problems, waivers = run_full()
    for w in waivers:
        print(f"guard-lint: waived {w}")
    for p in problems:
        print(f"guard-lint: {p}", file=sys.stderr)
    if problems:
        print(f"guard-lint: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    print(
        f"guard-lint: {len(GUARD_MODULES)} module(s) clean, "
        f"{len(waivers)} justified waiver(s)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
