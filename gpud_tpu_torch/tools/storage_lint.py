"""Storage-path lint: hot-path writes must ride the write-behind layer.

Every store that migrated onto the batching ``BatchWriter``
(gpud_tpu_torch/storage/writer.py) declares its ingest entry points in a
module-level ``HOT_WRITE_METHODS`` tuple. This lint parses those modules
and enforces, per declared method:

  - the method actually exists on some class in the module (a stale
    marker is a lint error, not dead metadata), and
  - it submits through the writer (``*.submit``/``submit_many``), and
  - every direct ``db.execute()``/``db.executemany()`` inside it sits
    under an ``if`` whose test mentions ``writer`` — i.e. it is the
    explicit synchronous fallback for writer-less construction (tests,
    tools), never an unconditional hot-path commit.

The rule is deliberately syntactic: a per-row ``db.execute()`` on the
ingest path costs one implicit transaction + fsync per observation and
is exactly the pattern the write-behind layer exists to remove. Read
paths, purges, and schema setup are untouched — only the declared hot
write methods are scanned.

The store modules are pinned in ``STORE_MODULES``: a store that
drops its ``HOT_WRITE_METHODS`` declaration (or a new store added to the
list without one) fails the lint, so "all stores write through the
shared layer" stays true by construction. Runs in CI via
``tests/test_torch_lint_all.py`` and standalone:

    python -m gpud_tpu_torch.tools.storage_lint
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Dict, List, Tuple

# repo-relative paths of every module that owns a SQLite-backed store's
# ingest path — keep in sync when a new store appears
STORE_MODULES = (
    "gpud_tpu_torch/eventstore.py",
    "gpud_tpu_torch/health_history.py",
    "gpud_tpu_torch/manager/federation.py",
    "gpud_tpu_torch/manager/rollup.py",
    "gpud_tpu_torch/metrics/store.py",
    "gpud_tpu_torch/remediation/audit.py",
    "gpud_tpu_torch/session/outbox.py",
)

_EXEC_ATTRS = ("execute", "executemany")


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def _hot_methods(tree: ast.Module) -> Tuple[str, ...]:
    """The module-level HOT_WRITE_METHODS tuple, or () when absent."""
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and tgt.id == "HOT_WRITE_METHODS":
                try:
                    val = ast.literal_eval(node.value)
                except (ValueError, SyntaxError):
                    return ()
                if isinstance(val, (tuple, list)):
                    return tuple(str(v) for v in val)
    return ()


def _is_db_execute(call: ast.Call) -> bool:
    """True for ``<something>.db.execute*`` / ``db.execute*`` calls."""
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr in _EXEC_ATTRS):
        return False
    base = fn.value
    if isinstance(base, ast.Name):
        return base.id in ("db", "_db")
    if isinstance(base, ast.Attribute):
        return base.attr in ("db", "_db")
    return False


def _mentions_writer(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "writer" in sub.id:
            return True
        if isinstance(sub, ast.Attribute) and "writer" in sub.attr:
            return True
    return False


def _scan_method(path: str, cls: str, fn: ast.FunctionDef) -> List[str]:
    problems: List[str] = []
    submits = False
    # (node, guarded) work stack: guarded flips True once we descend into
    # any If whose test involves the writer — that branch IS the declared
    # synchronous fallback
    stack: List[Tuple[ast.AST, bool]] = [(s, False) for s in fn.body]
    while stack:
        node, guarded = stack.pop()
        if isinstance(node, ast.Call):
            fname = node.func
            if (isinstance(fname, ast.Attribute)
                    and fname.attr in ("submit", "submit_many")):
                submits = True
            if _is_db_execute(node) and not guarded:
                problems.append(
                    f"{path}:{node.lineno}: {cls}.{fn.name}() commits "
                    "per-row via db.execute* outside a writer-presence "
                    "branch — hot-path writes go through the batch writer"
                )
        child_guard = guarded
        if isinstance(node, ast.If) and _mentions_writer(node.test):
            child_guard = True
        for child in ast.iter_child_nodes(node):
            stack.append((child, child_guard))
    if not submits:
        problems.append(
            f"{path}: {cls}.{fn.name}() is declared in HOT_WRITE_METHODS "
            "but never submits to the batch writer"
        )
    return problems


def lint_module(path: str, rel: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=rel)
    hot = _hot_methods(tree)
    if not hot:
        return [
            f"{rel}: store module declares no HOT_WRITE_METHODS — every "
            "SQLite-backed store must mark its ingest entry points"
        ]
    problems: List[str] = []
    found: Dict[str, bool] = {name: False for name in hot}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        for item in node.body:
            if isinstance(item, ast.FunctionDef) and item.name in found:
                found[item.name] = True
                problems.extend(_scan_method(rel, node.name, item))
    for name, ok in found.items():
        if not ok:
            problems.append(
                f"{rel}: HOT_WRITE_METHODS names {name!r} but no class "
                "defines it (stale marker)"
            )
    return problems


def run_lint(root: str = "") -> List[str]:
    """One problem string per violation across STORE_MODULES; [] = clean."""
    root = root or _repo_root()
    problems: List[str] = []
    for rel in STORE_MODULES:
        path = os.path.join(root, rel)
        if not os.path.isfile(path):
            problems.append(f"{rel}: store module missing")
            continue
        problems.extend(lint_module(path, rel))
    return problems


def main() -> int:
    problems = run_lint()
    for p in problems:
        print(f"storage-lint: {p}", file=sys.stderr)
    if problems:
        print(f"storage-lint: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    print(f"storage-lint: {len(STORE_MODULES)} store module(s) clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
