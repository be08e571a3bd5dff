"""Flow lint: interprocedural hot-path blocking analysis.

guard_lint proves *lock discipline* lexically; nothing proved the other
standing invariant of the manager tier — that the threads with latency
contracts never *block*. The regression it guards against: outbox
ingest run inline on the session reader thread, so that one slow
BatchWriter flush stalls every agent frame behind it ("the reader only
enqueues" is the rule). So this lint walks the call graph:

- **Entrypoints** are classified by thread role (``ENTRYPOINTS`` plus
  two discovered families: every ``scheduler.add_job(...)`` target is a
  *scheduler worker*, and every handler of the port's route tables
  (``add("GET", path, handler)``, ``Route("GET", path, handler)`` and
  ``("GET", path, handler)`` rows) an *http handler*).
- Each role declares **forbidden sink categories** (``ROLES``): blocking
  SQLite calls, ``BatchWriter.flush``/``drain`` barriers, ``time.sleep``,
  socket I/O, unbounded waits.
- The lint builds an AST-derived call graph over ``gpud_tpu_torch/`` — methods
  via ``self``, in-module bases, ``self.attr = ClassName(...)`` type
  inference, cross-module ``from gpud_tpu_torch.x import y`` resolution — and
  walks **reachability** from every entrypoint, proving no hot
  entrypoint reaches a forbidden sink.
- **Role transitions** happen where closures are handed to another
  thread: ``ingest_executor.submit(id, lambda: ...)`` re-roots the
  closure under the *shard executor* role, ``run_in_executor(pool, fn)``
  and ``ThreadPoolExecutor.submit`` under the *op worker* role,
  ``Thread(target=...)`` under *thread worker* — so "the reader only
  enqueues" is checked on both sides of the handoff.
- Injected callbacks the AST cannot see are pinned declaratively:
  ``ATTR_BINDINGS`` types ``AgentHandle.ingest_executor``;
  ``DYNAMIC_CALLS`` lists what ``AgentHandle.on_records`` is bound to
  (``ControlPlane._register``: the rollup ingest, or the federation
  replica sink). If the wiring moves, the binding goes stale and the
  missing-entrypoint/stale-waiver errors surface it.

The analysis is deliberately *under*-approximate: a call it cannot
resolve (duck-typed parameter, ``srv.*`` through a closure) is not
walked, so a clean report means "no blocking sink on any *resolvable*
path", not a soundness proof. The resolvable set covers the paths the
invariants are about — the manager ingest spine is typed end-to-end.

Waivers follow the guard_lint convention: ``WAIVERS`` maps
``(role, function, category)`` — category ``"*"`` waives the whole
function under that role — to a non-empty justification; a waiver that
is never consulted during the walk is itself an error (stale), as is an
empty reason or an expired ``until: PR-N`` stamp (guard_lint expiry).

Run: ``python -m gpud_tpu_torch.tools.flow_lint`` (exit 1 on any problem);
registered in ``tools/lint_all.py`` so tier-1 enforces it.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Dict, List, Optional, Set, Tuple

from gpud_tpu_torch.tools.guard_lint import _repo_root, waiver_reason_problems

SCAN_ROOT = "gpud_tpu_torch"

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)

# role -> forbidden sink categories. A role absent here cannot be used.
ROLES: Dict[str, frozenset] = {
    # manager threads that read agent session frames: one slow frame
    # stalls every agent multiplexed behind it (it only enqueues)
    "session_reader": frozenset({"sql", "flush", "sleep", "socket", "wait"}),
    # per-shard ingest workers: may take shard locks and buffer writes
    # (bounded backpressure), must never commit, barrier, or leave process
    "shard_executor": frozenset({"sql", "flush", "sleep", "socket"}),
    # scheduler pool workers: blocking SQL/flush is their job; sleeping
    # steals a shared worker — cadence belongs to the scheduler heap
    "scheduler_worker": frozenset({"sleep"}),
    # asyncio handlers: anything blocking wedges the event loop; real
    # work must cross a run_in_executor transition first (the port's
    # listener gives each connection a thread: see _PER_CONNECTION)
    "http_handler": frozenset({"sql", "flush", "sleep", "socket", "wait"}),
    # replication shipper tick: reads the journal (sql) and does socket
    # I/O by design; must not sleep or barrier-flush on its cadence
    "federation_shipper": frozenset({"sleep", "flush"}),
    # offloaded blocking work: blocking is the point
    "op_worker": frozenset(),
    "thread_worker": frozenset(),
}

# (role, "rel/path.py::Qual.name", why this is an entrypoint)
ENTRYPOINTS: Tuple[Tuple[str, str, str], ...] = (
    ("session_reader",
     "gpud_tpu_torch/manager/control_plane.py::AgentHandle.resolve",
     "v1 write-stream loop and v2 drain_responses call resolve() for "
     "every frame an agent sends"),
    ("session_reader",
     "gpud_tpu_torch/manager/federation.py::JournalShipper._dispatch",
     "peer replication stream reader (outboxAck handling)"),
    ("session_reader",
     "gpud_tpu_torch/manager/federation.py::JournalShipper._on_connected",
     "runs on the peer session's reader thread at (re)connect"),
    ("federation_shipper",
     "gpud_tpu_torch/manager/federation.py::JournalShipper.tick",
     "replication tick: ships journal rows to the ring successor"),
    ("shard_executor",
     "gpud_tpu_torch/manager/shard.py::ShardIngestExecutor._worker",
     "per-shard worker loop (the submitted closures are additionally "
     "re-rooted here by the submit() transition)"),
)

# resolvable calls that ARE the contract boundaries, by category —
# walked-into bodies would report their internals; naming them keeps
# findings anchored where the contract lives. "append" is forbidden by
# no role: submit/submit_many are the sanctioned write-behind appends
# (bounded 50ms backpressure, sync fallback only on a *stopped* writer,
# i.e. daemon shutdown / CLI tools) — the walk stops at them instead of
# reporting their internal fallback SQL as if callers could reach it hot
PRIMITIVE_SINKS: Dict[str, str] = {
    "gpud_tpu_torch/storage/writer.py::BatchWriter.flush": "flush",
    "gpud_tpu_torch/storage/writer.py::BatchWriter.drain": "flush",
    "gpud_tpu_torch/storage/writer.py::BatchWriter.submit": "append",
    "gpud_tpu_torch/storage/writer.py::BatchWriter.submit_many": "append",
}

# method attr names that mark an unresolvable call as a sink
_SQL_ATTRS = frozenset({"execute", "executemany", "query", "query_one",
                        "run_batch"})
_SOCKET_ATTRS = frozenset({"urlopen", "create_connection", "getaddrinfo",
                           "recv", "sendall", "sendto"})
_WAIT_ATTRS = frozenset({"wait", "wait_for", "result"})
_FLUSH_ATTRS = frozenset({"flush", "drain"})

# attribute-name → type, for injected objects every store shares
GLOBAL_ATTR_TYPES: Dict[str, Tuple[str, str]] = {
    "writer": ("gpud_tpu_torch/storage/writer.py", "BatchWriter"),
}

# (rel, class, attr) -> (rel, class): dependency-injected attributes the
# AST can't type from an assignment in the owning module
ATTR_BINDINGS: Dict[Tuple[str, str, str], Tuple[str, str]] = {
    ("gpud_tpu_torch/manager/control_plane.py", "AgentHandle", "ingest_executor"):
        ("gpud_tpu_torch/manager/shard.py", "ShardIngestExecutor"),
}

# (rel, class, attr) -> callee quals: dynamically-bound callbacks
# (``ControlPlane._register`` wires AgentHandle.on_records)
DYNAMIC_CALLS: Dict[Tuple[str, str, str], Tuple[str, ...]] = {
    ("gpud_tpu_torch/manager/control_plane.py", "AgentHandle", "on_records"): (
        "gpud_tpu_torch/manager/rollup.py::FleetRollupStore.ingest",
        "gpud_tpu_torch/manager/federation.py::ReplicaStore.replica_ingest",
    ),
}

# the port's HTTP handlers run on their connection's own thread
# (server/listener.py ``Listener.process_request``), where the
# reference's run on one aiohttp event loop and hand blocking reads to its
# op pool: a handler that blocks holds up its own client and no other
_PER_CONNECTION = (
    "by design: the port's listener serves each connection on a thread of "
    "its own, so this read blocks only the client that asked, as the "
    "reference's op-pool hop does (ROADMAP C17; held by "
    "tests/test_torch_flow_lint.py::"
    "test_a_handler_that_blocks_holds_only_its_own_connection)"
)

# (role, qual, category) -> justification. category "*" = skip the whole
# function under that role. Conventions match guard_lint._LOCK_FREE:
# non-empty reason, stale waivers are errors, `until: PR-N` expires.
WAIVERS: Dict[Tuple[str, str, str], str] = {
    ("session_reader",
     "gpud_tpu_torch/manager/control_plane.py::AgentHandle._ingest_outbox", "*"):
        "inline fallback taken only when no ShardIngestExecutor is wired "
        "(standalone handles in unit tests and chaos harnesses); "
        "ControlPlane._register always wires one, so the enqueue-only "
        "path is the only reader path in a running manager — "
        "test_torch_flow_lint pins the regression fixture that would make "
        "this edge unconditional",
    ("shard_executor",
     "gpud_tpu_torch/manager/rollup.py::FleetRollupStore.ingest", "sql"):
        "db.executemany branch runs only when constructed without a "
        "BatchWriter (unit tests, CLI tools over a cold state file); the "
        "manager wires a writer and takes the buffered submit_many path "
        "pinned by storage_lint HOT_WRITE_METHODS",
    ("shard_executor",
     "gpud_tpu_torch/manager/rollup.py::FleetRollupStore.ingest", "flush"):
        "by design: where the writer's bounded queue has no room, the "
        "store waits for a drain before the agent is acked, instead of "
        "acking records the queue refused as the reference does; the wait "
        "holds back this shard's worker and, through its bounded queue, "
        "the agents (ROADMAP C12; held by "
        "tests/test_torch_manager_parity.py::"
        "test_a_full_writer_queue_drops_acked_records_in_the_reference_and_not_in_the_port)",
    ("shard_executor",
     "gpud_tpu_torch/manager/federation.py::ReplicaStore.replica_ingest", "sql"):
        "same writer-less fallback as FleetRollupStore.ingest: "
        "db.executemany only without a BatchWriter; the federation plane "
        "always passes the shared writer",
    ("shard_executor",
     "gpud_tpu_torch/manager/federation.py::ReplicaStore.replica_ingest", "flush"):
        "by design: the replica waits for the writer's drain where its "
        "queue has no room, so a replicated frame is acked only once every "
        "row is in the writer (ROADMAP C15; held by "
        "tests/test_torch_federation_parity.py::"
        "test_c15_the_replica_under_a_full_writer_queue)",
    ("http_handler",
     "gpud_tpu_torch/manager/rollup.py::FleetRollupStore._barrier", "flush"):
        _PER_CONNECTION,
    ("http_handler",
     "gpud_tpu_torch/manager/rollup.py::FleetRollupStore._compute_history", "sql"):
        _PER_CONNECTION,
    ("http_handler",
     "gpud_tpu_torch/manager/rollup.py::FleetRollupStore._compute_traces", "sql"):
        _PER_CONNECTION,
    ("http_handler",
     "gpud_tpu_torch/manager/federation.py::FederationPlane.scatter", "wait"):
        _PER_CONNECTION,
    ("http_handler",
     "gpud_tpu_torch/manager/federation.py::JournalShipper.journal_head", "sql"):
        _PER_CONNECTION,
    ("http_handler",
     "gpud_tpu_torch/server/app.py::build_routes.pprof_profile", "sleep"):
        "by design: the wall-clock profiler samples every thread for the "
        "seconds asked, on its connection's own thread (ROADMAP C17; held "
        "by tests/test_torch_flow_lint.py::"
        "test_a_handler_that_blocks_holds_only_its_own_connection)",
    ("http_handler",
     "gpud_tpu_torch/chaos/fake_plane.py::FakeControlPlane._session", "*"):
        "chaos-harness fake manager: the sleeps and inline ingest on "
        "this route ARE the fault injection (latency/disconnect "
        "scenarios exercising agent reconnect paths); test-only "
        "process, never part of the daemon",
}


# -- module index ------------------------------------------------------------

class _Func:
    __slots__ = ("qual", "rel", "cls", "name", "node")

    def __init__(self, qual: str, rel: str, cls: Optional[str], name: str,
                 node) -> None:
        self.qual = qual
        self.rel = rel
        self.cls = cls
        self.name = name
        self.node = node


class _Module:
    __slots__ = ("rel", "tree", "classes", "bases", "attr_types",
                 "mod_aliases", "name_aliases", "funcs")

    def __init__(self, rel: str, tree: ast.Module) -> None:
        self.rel = rel
        self.tree = tree
        self.classes: Dict[str, ast.ClassDef] = {}
        self.bases: Dict[str, List[str]] = {}
        # (class, attr) -> (rel, class) from `self.attr = ClassName(...)`
        self.attr_types: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self.mod_aliases: Dict[str, str] = {}    # alias -> rel of module
        self.name_aliases: Dict[str, Tuple[str, str]] = {}  # alias->(rel,nm)
        self.funcs: Dict[str, _Func] = {}        # qual-suffix -> _Func


class Index:
    """Every function in the scanned tree plus just enough typing to
    resolve the repo's call idioms."""

    def __init__(self, root: str) -> None:
        self.root = root
        self.modules: Dict[str, _Module] = {}
        self.funcs: Dict[str, _Func] = {}  # full qual -> _Func
        self._load()
        self._link()

    # -- loading -----------------------------------------------------------
    def _load(self) -> None:
        scan = os.path.join(self.root, SCAN_ROOT)
        for dirpath, _dirs, files in os.walk(scan):
            for fname in sorted(files):
                if not fname.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fname)
                rel = os.path.relpath(path, self.root).replace(os.sep, "/")
                try:
                    with open(path, encoding="utf-8") as f:
                        tree = ast.parse(f.read(), filename=rel)
                except (SyntaxError, OSError):
                    continue
                self.modules[rel] = self._index_module(rel, tree)

    def _index_module(self, rel: str, tree: ast.Module) -> _Module:
        mod = _Module(rel, tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                if not node.module.startswith("gpud_tpu_torch"):
                    continue
                target = self._module_rel(node.module)
                for alias in node.names:
                    name = alias.asname or alias.name
                    sub = self._module_rel(f"{node.module}.{alias.name}")
                    if sub is not None:
                        mod.mod_aliases[name] = sub
                    elif target is not None:
                        mod.name_aliases[name] = (target, alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.startswith("gpud_tpu_torch"):
                        target = self._module_rel(alias.name)
                        if target is not None:
                            name = alias.asname or alias.name.split(".")[-1]
                            mod.mod_aliases[name] = target
        for stmt in tree.body:
            if isinstance(stmt, _FUNC_NODES):
                self._add_func(mod, None, stmt.name, stmt)
                for inner in stmt.body:
                    if isinstance(inner, _FUNC_NODES):
                        self._add_func(
                            mod, None, f"{stmt.name}.{inner.name}", inner
                        )
            elif isinstance(stmt, ast.ClassDef):
                mod.classes[stmt.name] = stmt
                mod.bases[stmt.name] = [
                    b.id for b in stmt.bases if isinstance(b, ast.Name)
                ]
                for item in stmt.body:
                    if isinstance(item, _FUNC_NODES):
                        self._add_func(
                            mod, stmt.name, f"{stmt.name}.{item.name}", item
                        )
        return mod

    def _add_func(self, mod: _Module, cls: Optional[str], suffix: str,
                  node) -> None:
        qual = f"{mod.rel}::{suffix}"
        fn = _Func(qual, mod.rel, cls, suffix.rsplit(".", 1)[-1], node)
        mod.funcs[suffix] = fn
        self.funcs[qual] = fn

    def _module_rel(self, dotted: str) -> Optional[str]:
        rel = dotted.replace(".", "/") + ".py"
        if os.path.isfile(os.path.join(self.root, rel)):
            return rel
        pkg = dotted.replace(".", "/") + "/__init__.py"
        if os.path.isfile(os.path.join(self.root, pkg)):
            return pkg
        return None

    # -- typing pass -------------------------------------------------------
    def _link(self) -> None:
        for mod in self.modules.values():
            for cls_name, cls in mod.classes.items():
                for node in ast.walk(cls):
                    if not (isinstance(node, ast.Assign)
                            and isinstance(node.value, ast.Call)):
                        continue
                    typ = self.resolve_class(mod, node.value.func)
                    if typ is None:
                        continue
                    for tgt in node.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            mod.attr_types[(cls_name, tgt.attr)] = typ

    # -- resolution --------------------------------------------------------
    def resolve_class(self, mod: _Module,
                      func: ast.expr) -> Optional[Tuple[str, str]]:
        """``ClassName`` / ``alias.ClassName`` expression -> (rel, class)."""
        if isinstance(func, ast.Name):
            if func.id in mod.classes:
                return (mod.rel, func.id)
            tgt = mod.name_aliases.get(func.id)
            if tgt is not None:
                other = self.modules.get(tgt[0])
                if other is not None and tgt[1] in other.classes:
                    return (tgt[0], tgt[1])
        elif isinstance(func, ast.Attribute) and isinstance(func.value,
                                                            ast.Name):
            tgt_rel = mod.mod_aliases.get(func.value.id)
            if tgt_rel is not None:
                other = self.modules.get(tgt_rel)
                if other is not None and func.attr in other.classes:
                    return (tgt_rel, func.attr)
        return None

    def method(self, rel: str, cls: str, name: str) -> Optional[_Func]:
        """Method lookup walking in-module base classes."""
        mod = self.modules.get(rel)
        seen: Set[str] = set()
        while mod is not None and cls not in seen:
            seen.add(cls)
            fn = mod.funcs.get(f"{cls}.{name}")
            if fn is not None:
                return fn
            nxt = next((b for b in mod.bases.get(cls, ())
                        if b in mod.classes), None)
            if nxt is None:
                return None
            cls = nxt
        return None

    def attr_type(self, rel: str, cls: Optional[str],
                  attr: str) -> Optional[Tuple[str, str]]:
        if cls is not None:
            bound = ATTR_BINDINGS.get((rel, cls, attr))
            if bound is not None:
                return bound
            mod = self.modules.get(rel)
            if mod is not None:
                typ = mod.attr_types.get((cls, attr))
                if typ is not None:
                    return typ
        return GLOBAL_ATTR_TYPES.get(attr)


# -- per-function effects ----------------------------------------------------

class _Effects:
    """What one function body does: resolvable call edges, lexical
    sinks, and role-transition handoffs."""

    __slots__ = ("edges", "sinks", "transitions")

    def __init__(self) -> None:
        self.edges: List[Tuple[str, int]] = []          # (qual, line)
        self.sinks: List[Tuple[str, int, str]] = []     # (cat, line, what)
        self.transitions: List[Tuple[str, object, int]] = []  # (role, fn, ln)


def _callable_args(call: ast.Call) -> List[ast.expr]:
    out: List[ast.expr] = []
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        if isinstance(arg, (ast.Lambda, ast.Name, ast.Attribute)):
            out.append(arg)
    return out


class _Scanner:
    def __init__(self, index: Index, fn: _Func) -> None:
        self.index = index
        self.fn = fn
        self.mod = index.modules[fn.rel]
        self.eff = _Effects()
        # local name -> ("type", rel, cls) | ("dyn", key) aliases
        self.locals: Dict[str, tuple] = {}

    def scan(self) -> _Effects:
        node = self.fn.node
        body = node.body if not isinstance(node, ast.Lambda) else [
            ast.Expr(value=node.body)
        ]
        self._stmts(body)
        return self.eff

    # -- statements --------------------------------------------------------
    def _stmts(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _stmt(self, node: ast.stmt) -> None:
        if isinstance(node, _FUNC_NODES) or isinstance(node, ast.ClassDef):
            return  # nested defs are separate functions, reached if called
        if isinstance(node, ast.Assign):
            self._track_assign(node)
            self._expr(node.value)
            return
        for _field, value in ast.iter_fields(node):
            if isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.stmt):
                        self._stmt(v)
                    elif isinstance(v, ast.expr):
                        self._expr(v)
                    elif isinstance(v, ast.excepthandler):
                        self._stmts(v.body)
                    elif isinstance(v, getattr(ast, "match_case", ())):
                        self._stmts(v.body)
                    elif isinstance(v, (ast.withitem,)):
                        self._expr(v.context_expr)
            elif isinstance(value, ast.stmt):
                self._stmt(value)
            elif isinstance(value, ast.expr):
                self._expr(value)

    def _track_assign(self, node: ast.Assign) -> None:
        if len(node.targets) != 1 or not isinstance(node.targets[0], ast.Name):
            return
        name = node.targets[0].id
        val = node.value
        self.locals.pop(name, None)
        if (isinstance(val, ast.Attribute) and isinstance(val.value, ast.Name)
                and val.value.id == "self" and self.fn.cls is not None):
            key = (self.fn.rel, self.fn.cls, val.attr)
            if key in DYNAMIC_CALLS:
                self.locals[name] = ("dyn", key)
                return
            typ = self.index.attr_type(self.fn.rel, self.fn.cls, val.attr)
            if typ is not None:
                self.locals[name] = ("type",) + typ
        elif isinstance(val, ast.Call):
            typ = self.index.resolve_class(self.mod, val.func)
            if typ is not None:
                self.locals[name] = ("type",) + typ

    # -- expressions -------------------------------------------------------
    def _expr(self, node: Optional[ast.expr]) -> None:
        if node is None:
            return
        stack: List[ast.AST] = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                # inline lambda (sort keys, predicates): same thread
                stack.append(n.body)
                continue
            if isinstance(n, ast.Call):
                if self._call(n):
                    # transition consumed the callable args; still scan
                    # the non-callable ones
                    for arg in list(n.args) + [kw.value for kw in n.keywords]:
                        if not isinstance(arg, (ast.Lambda,)):
                            stack.append(arg)
                    stack.append(n.func)
                    continue
            stack.extend(ast.iter_child_nodes(n))

    def _call(self, call: ast.Call) -> bool:
        """Handle one call; returns True when it was a role transition
        (caller must not descend into its callable args)."""
        func = call.func
        line = call.lineno
        # -- role transitions ---------------------------------------------
        if isinstance(func, ast.Attribute):
            if func.attr == "run_in_executor":
                args = call.args
                if len(args) >= 2:
                    self._transition("op_worker", args[1], line)
                return True
            if func.attr == "submit":
                role = "op_worker"
                typ = self._receiver_type(func.value)
                if typ is not None and typ[1] == "ShardIngestExecutor":
                    role = "shard_executor"
                elif typ is not None and typ[1] == "BatchWriter":
                    return False  # buffered append, not a handoff
                for arg in _callable_args(call):
                    self._transition(role, arg, line)
                return True
        if (isinstance(func, ast.Name) and func.id == "Thread") or (
                isinstance(func, ast.Attribute) and func.attr == "Thread"):
            for kw in call.keywords:
                if kw.arg == "target":
                    self._transition("thread_worker", kw.value, line)
            return True
        if isinstance(func, ast.Attribute) and func.attr == "add_job":
            if len(call.args) >= 2:
                self._transition("scheduler_worker", call.args[1], line)
            return True
        # -- resolvable edges ----------------------------------------------
        target = self._resolve_call(func)
        if target is not None:
            if isinstance(target, list):
                for qual in target:
                    self.eff.edges.append((qual, line))
            else:
                self.eff.edges.append((target, line))
            return False
        # -- lexical sinks on unresolved calls -----------------------------
        if isinstance(func, ast.Attribute):
            attr = func.attr
            if attr in _SQL_ATTRS:
                self.eff.sinks.append(("sql", line, f".{attr}()"))
            elif attr == "sleep":
                self.eff.sinks.append(("sleep", line, "time.sleep()"))
            elif attr in _SOCKET_ATTRS:
                self.eff.sinks.append(("socket", line, f".{attr}()"))
            elif attr in _WAIT_ATTRS:
                self.eff.sinks.append(("wait", line, f".{attr}()"))
            elif attr in _FLUSH_ATTRS:
                self.eff.sinks.append(("flush", line, f".{attr}()"))
        elif isinstance(func, ast.Name) and func.id == "urlopen":
            self.eff.sinks.append(("socket", line, "urlopen()"))
        return False

    def _transition(self, role: str, fn_expr: ast.expr, line: int) -> None:
        self.eff.transitions.append((role, fn_expr, line))

    def _receiver_type(self, expr: ast.expr) -> Optional[Tuple[str, str]]:
        if isinstance(expr, ast.Name):
            ent = self.locals.get(expr.id)
            if ent is not None and ent[0] == "type":
                return (ent[1], ent[2])
            return None
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            return self.index.attr_type(self.fn.rel, self.fn.cls, expr.attr)
        return None

    def _resolve_call(self, func: ast.expr):
        """Call target -> qual, list of quals (dynamic), or None."""
        index, mod, fn = self.index, self.mod, self.fn
        if isinstance(func, ast.Name):
            ent = self.locals.get(func.id)
            if ent is not None and ent[0] == "dyn":
                return list(DYNAMIC_CALLS[ent[1]])
            # nested child (handlers defined inside this very function,
            # e.g. build_app registering its own nested async defs) …
            suffix = fn.qual.split("::", 1)[1]
            child = mod.funcs.get(f"{suffix}.{func.id}")
            if child is not None:
                return child.qual
            # … or nested sibling (one handler calling another)
            if "." in suffix:
                outer = suffix.split(".")[0]
                sib = mod.funcs.get(f"{outer}.{func.id}")
                if sib is not None:
                    return sib.qual
            target = mod.funcs.get(func.id)
            if target is not None and target.cls is None:
                return target.qual
            alias = mod.name_aliases.get(func.id)
            if alias is not None:
                other = index.modules.get(alias[0])
                if other is not None:
                    f2 = other.funcs.get(alias[1])
                    if f2 is not None:
                        return f2.qual
                    if alias[1] in other.classes:
                        init = index.method(alias[0], alias[1], "__init__")
                        return init.qual if init else None
            if func.id in mod.classes:
                init = index.method(mod.rel, func.id, "__init__")
                return init.qual if init else None
            return None
        if not isinstance(func, ast.Attribute):
            return None
        recv = func.value
        if isinstance(recv, ast.Name) and recv.id == "self":
            if fn.cls is None:
                return None
            key = (fn.rel, fn.cls, func.attr)
            if key in DYNAMIC_CALLS:
                return list(DYNAMIC_CALLS[key])
            target = index.method(fn.rel, fn.cls, func.attr)
            return target.qual if target else None
        if isinstance(recv, ast.Name):
            tgt_rel = mod.mod_aliases.get(recv.id)
            if tgt_rel is not None:
                other = index.modules.get(tgt_rel)
                if other is not None:
                    f2 = other.funcs.get(func.attr)
                    if f2 is not None:
                        return f2.qual
                    if func.attr in other.classes:
                        init = index.method(tgt_rel, func.attr, "__init__")
                        return init.qual if init else None
                return None
        typ = self._receiver_type(recv)
        if typ is not None:
            target = index.method(typ[0], typ[1], func.attr)
            return target.qual if target else None
        if (isinstance(recv, ast.Attribute)
                and isinstance(recv.value, ast.Name)
                and recv.value.id == "self"):
            inner = self.index.attr_type(fn.rel, fn.cls, recv.attr)
            if inner is not None:
                target = index.method(inner[0], inner[1], func.attr)
                return target.qual if target else None
        return None


# -- reachability walk -------------------------------------------------------

class _Walker:
    def __init__(self, index: Index, waivers: Dict) -> None:
        self.index = index
        self.waivers = waivers
        self.used_waivers: Set[Tuple[str, str, str]] = set()
        self.problems: List[str] = []
        self._effects: Dict[str, _Effects] = {}
        self._lambda_n = 0

    def effects_of(self, fn: _Func) -> _Effects:
        eff = self._effects.get(fn.qual)
        if eff is None:
            eff = _Scanner(self.index, fn).scan()
            self._effects[fn.qual] = eff
        return eff

    def _waived(self, role: str, qual: str, cat: str) -> bool:
        for key in ((role, qual, cat), (role, qual, "*")):
            if key in self.waivers:
                self.used_waivers.add(key)
                return True
        return False

    def walk(self, role: str, fn: _Func, why: str) -> None:
        forbidden = ROLES[role]
        if not forbidden:
            return
        if self._waived(role, fn.qual, "*"):
            return
        visited: Set[str] = set()
        # (func, call chain up to and including it)
        stack: List[Tuple[_Func, Tuple[str, ...]]] = [(fn, (fn.qual,))]
        while stack:
            cur, chain = stack.pop()
            if cur.qual in visited:
                continue
            visited.add(cur.qual)
            eff = self.effects_of(cur)
            for cat, line, what in eff.sinks:
                if cat not in forbidden:
                    continue
                if self._waived(role, cur.qual, cat):
                    continue
                self.problems.append(
                    f"{cur.rel}:{line}: [{role}] {chain[0]} reaches "
                    f"forbidden {cat} sink {what} "
                    f"via {' -> '.join(chain)} ({why})"
                )
            for qual, line in eff.edges:
                prim = PRIMITIVE_SINKS.get(qual)
                if prim is not None:
                    if prim in forbidden and not self._waived(
                            role, cur.qual, prim):
                        self.problems.append(
                            f"{cur.rel}:{line}: [{role}] {chain[0]} reaches "
                            f"forbidden {prim} barrier {qual.split('::')[1]} "
                            f"via {' -> '.join(chain)} ({why})"
                        )
                    continue
                nxt = self.index.funcs.get(qual)
                if nxt is None or nxt.qual in visited:
                    continue
                if self._waived(role, nxt.qual, "*"):
                    continue
                if len(chain) < 24:
                    stack.append((nxt, chain + (nxt.qual,)))
            for t_role, fn_expr, line in eff.transitions:
                target = self._transition_target(cur, fn_expr)
                if target is None:
                    continue
                t_forbidden = ROLES.get(t_role, frozenset())
                if not t_forbidden:
                    continue
                if not self._waived(t_role, target.qual, "*"):
                    self.walk(
                        t_role, target,
                        f"handed off at {cur.rel}:{line}",
                    )

    def _transition_target(self, cur: _Func,
                           fn_expr: ast.expr) -> Optional[_Func]:
        if isinstance(fn_expr, ast.Lambda):
            self._lambda_n += 1
            qual = f"{cur.qual}.<lambda:{fn_expr.lineno}>"
            fn = _Func(qual, cur.rel, cur.cls, "<lambda>", fn_expr)
            if qual not in self.index.funcs:
                self.index.funcs[qual] = fn
            return self.index.funcs[qual]
        scanner = _Scanner(self.index, cur)
        target = scanner._resolve_call(fn_expr)
        if isinstance(target, list):
            target = target[0] if target else None
        if target is None:
            return None
        return self.index.funcs.get(target)


# -- discovered entrypoint families ------------------------------------------

_HTTP_METHODS = frozenset({"GET", "POST", "PUT", "DELETE", "PATCH"})


def route_row(node: ast.AST) -> Optional[Tuple[str, str, ast.expr]]:
    """(method, path, handler expr) when ``node`` registers a route in one
    of the port's three table shapes: ``add("GET", path, handler)``,
    ``Route("GET", path, handler, ...)`` and a ``("GET", path, handler)``
    row of a table that is turned into Routes (parity_lint reads them
    too)."""
    if isinstance(node, ast.Call):
        elts = node.args
    elif isinstance(node, ast.Tuple):
        elts = node.elts
    else:
        return None
    if not (len(elts) >= 3
            and isinstance(elts[0], ast.Constant) and elts[0].value in _HTTP_METHODS
            and isinstance(elts[1], ast.Constant) and isinstance(elts[1].value, str)
            and elts[1].value.startswith("/")):
        return None
    return elts[0].value, elts[1].value, elts[2]


def _discovered_entrypoints(index: Index) -> List[Tuple[str, _Func, str]]:
    """Scheduler job targets and HTTP handlers, found at their
    registration sites so new jobs/routes are classified automatically."""
    out: List[Tuple[str, _Func, str]] = []
    seen: Set[Tuple[str, str]] = set()
    for mod in index.modules.values():
        for fn in list(mod.funcs.values()):
            scanner = _Scanner(index, fn)
            for node in ast.walk(fn.node):
                route = route_row(node)
                if route is not None:
                    target = scanner._resolve_call(route[2])
                    role, why = "http_handler", f"route {route[1]}"
                elif (isinstance(node, ast.Call)
                      and isinstance(node.func, ast.Attribute)
                      and node.func.attr == "add_job" and len(node.args) >= 2):
                    target = scanner._resolve_call(node.args[1])
                    job = ""
                    if isinstance(node.args[0], ast.Constant):
                        job = str(node.args[0].value)
                    role, why = "scheduler_worker", f"scheduler job {job!r}"
                else:
                    continue
                if isinstance(target, list):
                    target = target[0] if target else None
                if target is None or (role, target) in seen:
                    continue
                f2 = index.funcs.get(target)
                if f2 is None:
                    continue
                seen.add((role, target))
                out.append((role, f2, why))
    return out


# -- entry points ------------------------------------------------------------

def run_full(root: str = "", waivers: Optional[Dict] = None,
             entrypoints=None,
             counts: Optional[Dict[str, int]] = None) -> Tuple[List[str], List[str]]:
    """(problems, waiver notes) over the tree at ``root``; ([], _) = clean.
    ``counts``, when given, is filled with the discovered entrypoints by
    role: a clean report over a family of zero handlers proves nothing."""
    root = root or _repo_root()
    waivers = WAIVERS if waivers is None else waivers
    entrypoints = ENTRYPOINTS if entrypoints is None else entrypoints
    index = Index(root)
    walker = _Walker(index, waivers)

    problems: List[str] = []
    for role, qual, why in entrypoints:
        fn = index.funcs.get(qual)
        if fn is None:
            problems.append(
                f"{qual.split('::')[0]}: entrypoint {qual} is gone — "
                "renamed or moved; update flow_lint.ENTRYPOINTS"
            )
            continue
        walker.walk(role, fn, why)
    for role, fn, why in _discovered_entrypoints(index):
        if counts is not None:
            counts[role] = counts.get(role, 0) + 1
        walker.walk(role, fn, why)
    problems.extend(walker.problems)

    notes: List[str] = []
    for key, reason in sorted(waivers.items()):
        role, qual, cat = key
        rel = qual.split("::")[0]
        problems.extend(
            f"{rel}: flow waiver {key}: {p}"
            for p in waiver_reason_problems(reason, root=root)
        )
        if key not in walker.used_waivers:
            problems.append(
                f"{rel}: flow waiver {key} was never reached from any "
                f"{role} entrypoint (stale waiver — remove it)"
            )
        else:
            notes.append(f"[{role}] {qual} ({cat}) — {reason}")
    return problems, notes


def run_lint(root: str = "") -> List[str]:
    return run_full(root)[0]


def main() -> int:
    counts: Dict[str, int] = {}
    problems, notes = run_full(counts=counts)
    for n in notes:
        print(f"flow-lint: waived {n}")
    print("flow-lint: discovered entrypoints by role: " + ", ".join(
        f"{role} {n}" for role, n in sorted(counts.items())))
    for p in problems:
        print(f"flow-lint: {p}", file=sys.stderr)
    if problems:
        print(f"flow-lint: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    print(
        f"flow-lint: {len(ENTRYPOINTS)} pinned entrypoint(s) + discovered "
        f"scheduler/http families clean, {len(notes)} justified waiver(s)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
