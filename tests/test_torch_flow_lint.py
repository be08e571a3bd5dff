"""The port's flow lint (gpud_tpu_torch/tools/flow_lint.py) on fixture
trees, as tests/test_flow_lint.py holds the reference's: the walk must
catch an inline-ingest regression (a session reader reaching SQL and a
writer flush barrier through the call graph), stay quiet on the
enqueue-only shape, and keep its waiver book honest (used waivers clear
findings, unused waivers are errors, expired ``until: PR-N`` stamps fail).

The port's own cases: the http family is discovered from the port's three
route-table shapes, and on the real tree it holds a handler for every route
of the local API, the manager and the fake plane (so a clean report cannot
be vacuous); every by-design waiver names the test that holds it; and a
handler that blocks holds up only its own connection, the property the
http waivers rest on (ROADMAP C17).

The fixture trees mirror the port's layout (same module paths, same class
names) so the lint's declarative tables — PRIMITIVE_SINKS, ATTR_BINDINGS —
resolve against them exactly as they do in the real tree."""

import http.client
import os
import re
import threading

import pytest

from gpud_tpu_torch.tools import flow_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

READER_EP = (
    ("session_reader",
     "gpud_tpu_torch/manager/control_plane.py::AgentHandle.resolve",
     "per-frame reader"),
)

WRITER_MODULE = '''\
class BatchWriter:
    def __init__(self, db):
        self.db = db

    def submit_many(self, store, sql, rows):
        self.db.executemany(sql, rows)  # stopped-writer fallback

    def flush(self, timeout=30.0):
        pass
'''

SHARD_MODULE = '''\
class ShardIngestExecutor:
    def submit(self, machine_id, fn):
        self._q.append(fn)
'''


def _write(root, rel, text):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(text)


def _tree(tmp_path, control_plane_src):
    _write(tmp_path, "gpud_tpu_torch/storage/writer.py", WRITER_MODULE)
    _write(tmp_path, "gpud_tpu_torch/manager/shard.py", SHARD_MODULE)
    _write(tmp_path, "gpud_tpu_torch/manager/control_plane.py", control_plane_src)
    return str(tmp_path)


# -- the inline-ingest regression shape --------------------------------------

REGRESSION_CP = '''\
from gpud_tpu_torch.storage.writer import BatchWriter


class AgentHandle:
    def __init__(self, db):
        self.db = db
        self.writer = BatchWriter(db)

    def resolve(self, frame):
        # regression: ingest runs inline on the session reader thread
        self._ingest_outbox(frame.data)

    def _ingest_outbox(self, payload):
        self.db.execute("INSERT INTO j VALUES (?)", (payload,))
        self.writer.flush(timeout=5.0)
'''


def test_inline_ingest_regression_reaches_both_sinks(tmp_path):
    root = _tree(tmp_path, REGRESSION_CP)
    problems, _ = flow_lint.run_full(root=root, waivers={},
                                     entrypoints=READER_EP)
    blob = "\n".join(problems)
    assert "forbidden sql sink" in blob
    assert "forbidden flush barrier BatchWriter.flush" in blob
    # findings carry the full call chain for triage
    assert "AgentHandle.resolve -> " in blob
    assert "AgentHandle._ingest_outbox" in blob


def test_waiver_clears_the_regression_and_is_marked_used(tmp_path):
    root = _tree(tmp_path, REGRESSION_CP)
    waivers = {
        ("session_reader",
         "gpud_tpu_torch/manager/control_plane.py::AgentHandle._ingest_outbox",
         "*"): "fixture: inline path is test-only",
    }
    problems, notes = flow_lint.run_full(root=root, waivers=waivers,
                                         entrypoints=READER_EP)
    assert problems == []
    assert any("_ingest_outbox" in n for n in notes)


def test_stale_waiver_is_an_error(tmp_path):
    root = _tree(tmp_path, REGRESSION_CP)
    waivers = {
        ("session_reader",
         "gpud_tpu_torch/manager/control_plane.py::AgentHandle._ingest_outbox",
         "*"): "fixture waiver",
        ("session_reader",
         "gpud_tpu_torch/manager/control_plane.py::AgentHandle.never_reached",
         "*"): "points at nothing",
    }
    problems, _ = flow_lint.run_full(root=root, waivers=waivers,
                                     entrypoints=READER_EP)
    assert any("never reached" in p and "stale waiver" in p
               for p in problems)


def test_expired_waiver_fails_even_when_used(tmp_path):
    root = _tree(tmp_path, REGRESSION_CP)
    _write(tmp_path, "CHANGES.md", "PR 7 something earlier\n")
    waivers = {
        ("session_reader",
         "gpud_tpu_torch/manager/control_plane.py::AgentHandle._ingest_outbox",
         "*"): "temporary until: PR-3 while the executor lands",
    }
    problems, _ = flow_lint.run_full(root=root, waivers=waivers,
                                     entrypoints=READER_EP)
    assert any("expired" in p and "PR-3" in p for p in problems)


# -- the enqueue-only shape --------------------------------------------------

ENQUEUE_ONLY_CP = '''\
from gpud_tpu_torch.storage.writer import BatchWriter


class AgentHandle:
    def __init__(self, db):
        self.db = db
        self.writer = BatchWriter(db)
        self.ingest_executor = None

    def resolve(self, frame):
        payload = frame.data
        ex = self.ingest_executor
        if ex is not None:
            ex.submit("m1", lambda: self._ingest_outbox(payload))
            return
        self._ingest_outbox(payload)

    def _ingest_outbox(self, payload):
        self.writer.submit_many("journal", "INSERT", [(payload,)])
'''


def test_enqueue_only_reader_is_clean(tmp_path):
    """The reader hands the closure to the shard executor and the
    closure's own role (shard_executor) permits buffered appends — the
    walk stops at BatchWriter.submit_many instead of flagging its
    stopped-writer fallback SQL. The conditional inline edge still
    needs its waiver (path-insensitivity is the documented contract)."""
    root = _tree(tmp_path, ENQUEUE_ONLY_CP)
    waivers = {
        ("session_reader",
         "gpud_tpu_torch/manager/control_plane.py::AgentHandle._ingest_outbox",
         "*"): "inline fallback is executor-less test handles only",
    }
    problems, _ = flow_lint.run_full(root=root, waivers=waivers,
                                     entrypoints=READER_EP)
    assert problems == []


def test_submitted_closure_is_rechecked_as_shard_executor(tmp_path):
    """Moving work onto the shard executor does not launder it: a
    closure that sleeps is flagged under the shard_executor role even
    though the reader itself only enqueues."""
    src = ENQUEUE_ONLY_CP.replace(
        'ex.submit("m1", lambda: self._ingest_outbox(payload))',
        'ex.submit("m1", lambda: self._slow_ingest(payload))',
    ) + '''
    def _slow_ingest(self, payload):
        import time
        time.sleep(1.0)
'''
    root = _tree(tmp_path, src)
    waivers = {
        ("session_reader",
         "gpud_tpu_torch/manager/control_plane.py::AgentHandle._ingest_outbox",
         "*"): "inline fallback is executor-less test handles only",
    }
    problems, _ = flow_lint.run_full(root=root, waivers=waivers,
                                     entrypoints=READER_EP)
    assert any("[shard_executor]" in p and "sleep" in p for p in problems)


# -- discovered entrypoint families ------------------------------------------

def test_scheduler_job_target_must_not_sleep(tmp_path):
    _write(tmp_path, "gpud_tpu_torch/storage/writer.py", WRITER_MODULE)
    _write(tmp_path, "gpud_tpu_torch/svc.py", '''\
import time


class Svc:
    def start(self, scheduler):
        scheduler.add_job("svc-tick", self._tick, interval=5.0)

    def _tick(self):
        time.sleep(0.5)  # steals a shared scheduler worker
''')
    problems, _ = flow_lint.run_full(root=str(tmp_path), waivers={},
                                     entrypoints=())
    assert any("[scheduler_worker]" in p and "time.sleep()" in p
               and "svc-tick" in p for p in problems)


def test_http_handler_blocking_sql_is_flagged(tmp_path):
    _write(tmp_path, "gpud_tpu_torch/storage/writer.py", WRITER_MODULE)
    _write(tmp_path, "gpud_tpu_torch/server/app.py", '''\
def build_routes(srv):
    routes = []

    def add(method, path, handler):
        routes.append((method, path, handler))

    def states(request):
        return srv.db.query("SELECT * FROM states")

    add("GET", "/v1/states", states)
    return routes
''')
    problems, _ = flow_lint.run_full(root=str(tmp_path), waivers={},
                                     entrypoints=())
    assert any("[http_handler]" in p and "sql" in p and "/v1/states" in p
               for p in problems)


def test_route_objects_and_table_rows_are_http_handlers(tmp_path):
    # the manager's (method, path, handler) table and the fake plane's
    # Route(...) list: both handlers are walked as http handlers
    _write(tmp_path, "gpud_tpu_torch/storage/writer.py", WRITER_MODULE)
    _write(tmp_path, "gpud_tpu_torch/manager/plane.py", '''\
import time


class Plane:
    def _routes(self):
        table = [("GET", "/v1/fleet/rollup", self._rollup)]
        return table + [Route("POST", "/api/v1/session", self._session, "doc")]

    def _rollup(self, request):
        return self.db.query("SELECT 1")

    def _session(self, request):
        time.sleep(1.0)
''')
    counts = {}
    problems, _ = flow_lint.run_full(root=str(tmp_path), waivers={},
                                     entrypoints=(), counts=counts)
    blob = "\n".join(problems)
    assert "Plane._rollup reaches forbidden sql sink" in blob and "/v1/fleet/rollup" in blob
    assert "Plane._session reaches forbidden sleep sink" in blob
    assert counts == {"http_handler": 2}


def test_missing_pinned_entrypoint_is_drift(tmp_path):
    _write(tmp_path, "gpud_tpu_torch/storage/writer.py", WRITER_MODULE)
    eps = (("session_reader", "gpud_tpu_torch/gone.py::Gone.resolve", "x"),)
    problems, _ = flow_lint.run_full(root=str(tmp_path), waivers={},
                                     entrypoints=eps)
    assert any("is gone" in p and "ENTRYPOINTS" in p for p in problems)


# -- the real tree -----------------------------------------------------------

@pytest.fixture(scope="module")
def real_run():
    counts = {}
    problems, notes = flow_lint.run_full(counts=counts)
    return problems, notes, counts


def test_real_tree_reader_invariant_holds(real_run):
    """The reader-only-enqueues invariant, machine-checked: the declared
    entrypoints plus every discovered scheduler job and HTTP handler reach
    zero forbidden sinks, modulo the written waiver book."""
    problems, notes, _counts = real_run
    assert problems == []
    # the inline-fallback waiver is the load-bearing one; if it vanishes
    # from the book the invariant is no longer being proven end-to-end
    assert any("_ingest_outbox" in n for n in notes)


def test_roles_and_pinned_tables_are_the_references():
    from gpud_tpu.tools import flow_lint as ref

    def port_path(x):
        return x.replace("gpud_tpu/", "gpud_tpu_torch/")

    assert flow_lint.ROLES == ref.ROLES
    assert flow_lint.ENTRYPOINTS == tuple(
        (role, port_path(qual), why) for role, qual, why in ref.ENTRYPOINTS)
    assert flow_lint.ATTR_BINDINGS == {
        (port_path(r), c, a): (port_path(r2), c2)
        for (r, c, a), (r2, c2) in ref.ATTR_BINDINGS.items()}
    assert flow_lint.DYNAMIC_CALLS == {
        (port_path(r), c, a): tuple(port_path(q) for q in quals)
        for (r, c, a), quals in ref.DYNAMIC_CALLS.items()}
    assert flow_lint.PRIMITIVE_SINKS == {
        port_path(q): cat for q, cat in ref.PRIMITIVE_SINKS.items()}
    assert flow_lint.SCAN_ROOT == "gpud_tpu_torch"


def _route_tables(tmp_path):
    """(route table name, [(method, path, handler)]) of the port's local
    API (with the pprof routes), its manager and its fake plane."""
    from gpud_tpu_torch.chaos.fake_plane import FakeControlPlane
    from gpud_tpu_torch.config import default_config
    from gpud_tpu_torch.manager.control_plane import ControlPlane
    from gpud_tpu_torch.server.app import build_routes
    from gpud_tpu_torch.server.server import Server

    (tmp_path / "kmsg").write_text("")
    cfg = default_config(data_dir=str(tmp_path / "data"), port=0, tls=False,
                         kmsg_path=str(tmp_path / "kmsg"), pprof=True,
                         components_disabled=["network-latency"])
    srv = Server(config=cfg)
    cp = ControlPlane()
    fake = FakeControlPlane()
    fake.start()  # its table is built when it starts serving, on 127.0.0.1:0
    try:
        return {"local API": build_routes(srv), "manager": cp._routes(),
                "fake plane": list(fake._httpd.app.routes)}
    finally:
        fake.stop()
        cp.stop()
        srv.stop()


def test_every_route_of_the_ports_three_tables_has_an_http_entrypoint(real_run, tmp_path):
    discovered = {
        fn.qual for role, fn, _why in
        flow_lint._discovered_entrypoints(flow_lint.Index(REPO))
        if role == "http_handler"
    }
    tables = _route_tables(tmp_path)
    handlers = set()
    for name, routes in tables.items():
        assert routes, name
        for r in routes:
            module = r.handler.__module__.replace(".", "/") + ".py"
            qual = f"{module}::{r.handler.__qualname__.replace('.<locals>', '')}"
            assert qual in discovered, f"{name}: {r.method} {r.path} -> {qual}"
            handlers.add(qual)
    # one entrypoint per distinct handler (trigger-check and trigger-tag
    # share one), and the lint's count is exactly that
    assert len(tables["local API"]) == 31 and len(tables["manager"]) == 14
    assert len(tables["fake plane"]) == 2
    assert real_run[2]["http_handler"] == len(handlers) == len(discovered)
    assert real_run[2]["scheduler_worker"] >= 10


def test_main_prints_the_entrypoints_by_role(real_run, monkeypatch, capsys):
    problems, notes, counts = real_run

    def run_full(counts=None, **_kw):
        counts.update(real_run[2])
        return problems, notes

    monkeypatch.setattr(flow_lint, "run_full", run_full)
    assert flow_lint.main() == 0
    out = capsys.readouterr().out
    assert (f"flow-lint: discovered entrypoints by role: http_handler "
            f"{counts['http_handler']}, scheduler_worker {counts['scheduler_worker']}") in out


def test_every_by_design_waiver_names_a_roadmap_item_and_a_test_that_exists():
    by_design = {k: v for k, v in flow_lint.WAIVERS.items() if v.startswith("by design")}
    assert {k[2] for k in by_design} == {"flush", "sql", "wait", "sleep"}
    # the two drain waits on the shard executor (C12, C15) are among them
    assert ("shard_executor", "gpud_tpu_torch/manager/rollup.py::FleetRollupStore.ingest",
            "flush") in by_design
    assert ("shard_executor",
            "gpud_tpu_torch/manager/federation.py::ReplicaStore.replica_ingest",
            "flush") in by_design
    for key, reason in by_design.items():
        assert re.search(r"ROADMAP C\d+", reason), key
        path, name = re.search(r"(tests/\S+\.py)::(\w+)", reason).groups()
        with open(os.path.join(REPO, path), encoding="utf-8") as f:
            assert f"def {name}(" in f.read(), (key, path, name)


def test_a_handler_that_blocks_holds_only_its_own_connection():
    """The port's listener serves each connection on its own thread: while
    one handler blocks, another connection's request is answered."""
    from gpud_tpu_torch.server.app import App, Response, Route
    from gpud_tpu_torch.server.listener import Listener

    release, entered = threading.Event(), threading.Event()

    def slow(_req):
        entered.set()
        release.wait(10)
        return Response(status=200, body=b"slow", content_type="text/plain")

    def fast(_req):
        return Response(status=200, body=b"fast", content_type="text/plain")

    app = App(routes=[Route("GET", "/slow", slow, "slow"), Route("GET", "/fast", fast, "fast")],
              observe=False)
    httpd = Listener(("127.0.0.1", 0), app)
    serve = threading.Thread(target=httpd.serve_forever, kwargs={"poll_interval": 0.05},
                             daemon=True)
    serve.start()
    port = httpd.server_address[1]
    got = {}

    def get(path):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        try:
            conn.request("GET", path)
            got[path] = conn.getresponse().read()
        finally:
            conn.close()

    blocked = threading.Thread(target=get, args=("/slow",), daemon=True)
    try:
        blocked.start()
        assert entered.wait(5)
        get("/fast")  # answered while /slow's handler still blocks
        assert got == {"/fast": b"fast"} and blocked.is_alive()
        release.set()
        blocked.join(5)
        assert not blocked.is_alive() and got["/slow"] == b"slow"
    finally:
        release.set()
        httpd.shutdown()
        httpd.close(5)
        serve.join(5)
    assert not serve.is_alive()
