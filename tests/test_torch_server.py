"""The port's local API (gpud_tpu_torch/server/: app.py, server.py, tls.py)
against gpud_tpu's.

First the reference's own tests of its HTTP surface run on the port's
``Server`` (tests/torch_ref_tests.py, with tests/torch_live.py's
replacements and ``live_server``): the route matrix, the pprof routes, the
Prometheus exposition grammar, the remediation routes and the listener's
double start of tests/test_server_composition.py. Then cases of the port's
own: the OpenAPI document against the route table in both directions and
against the reference's, a reference server and a port server answering
every GET route alike on the same injected kmsg lines, the fabric routes on
the port's NVLink star, the restart flow of tests/test_restart_persistence.py
and the listener's own contract (405 ``Allow``, HEAD, the ``unmatched``
label, TLS, bounded stop). Every server binds 127.0.0.1:0."""

import http.client
import json
import re
import socket
import time
import urllib.request

import pytest

from gpud_tpu_torch.api.v1.types import HealthStateType
from gpud_tpu_torch.fault_injector import Request as InjectRequest
from gpud_tpu_torch.server import server as server_mod
from gpud_tpu_torch.server.server import Server

from torch_live import REF_TO_PORT, live_config, live_server, port_host  # noqa: F401
from torch_parity import COMPONENTS, GAUGES, nouns, stub_host_probes
from torch_ref_tests import port_tests

WAIT = 30.0

globals().update(port_tests("test_http_route_matrix.py", replace=REF_TO_PORT))
globals().update(port_tests("test_pprof_admin.py", replace=REF_TO_PORT))
globals().update(port_tests("test_metrics_exposition_contract.py", replace=REF_TO_PORT))
globals().update(port_tests("test_remediation_http.py", replace=REF_TO_PORT))
# the listener's double start, which tests/test_torch_daemon_slice.py leaves
# to the server; the file's other cases run there on the ``Daemon``
test_server_composition__double_start_is_a_noop = port_tests(
    "test_server_composition.py")["test_server_composition__double_start_is_a_noop"]


def _get(base, path, method="GET", body=None):
    c = http.client.HTTPConnection(*base, timeout=10)
    try:
        c.request(method, path, body=body)
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


@pytest.fixture(scope="module")
def addr(live_server):
    return ("127.0.0.1", live_server.port)


# -- the route table, its OpenAPI document and the reference's ------------------------


def _documented(doc):
    return {(p, m) for p, ms in doc["paths"].items() for m in ms}


def test_openapi_documents_exactly_the_route_table(addr, live_server):
    _, _, body = _get(addr, "/openapi.json")
    doc = json.loads(body)
    served = {(r.path, r.method.lower()) for r in live_server._app.routes
              if r.path != "/openapi.json"}
    assert _documented(doc) == served
    for (path, method), r in zip(sorted(served), sorted(
            (r for r in live_server._app.routes if r.path != "/openapi.json"),
            key=lambda r: (r.path, r.method.lower()))):
        assert doc["paths"][path][method]["summary"] == r.summary
    # the router serves every documented route (a handler may still say 404
    # about what the request names, as DELETE /v1/components does)
    for path, method in sorted(served):
        status, _, body = _get(addr, path, method.upper(),
                               body=b"{}" if method != "get" else None)
        assert status != 405 and body != b"404: Not Found", (path, method, status)


@pytest.fixture(scope="module")
def ref_openapi(tmp_path_factory):
    from gpud_tpu.config import default_config as ref_default_config
    from gpud_tpu.server.server import Server as RefServer

    mp = pytest.MonkeyPatch()
    stub_host_probes(mp)
    tmp = tmp_path_factory.mktemp("ref-openapi")
    (tmp / "k").write_text("")
    docs = {}
    try:
        for pprof in (False, True):
            s = RefServer(config=ref_default_config(
                data_dir=str(tmp / f"d{pprof}"), port=0, tls=False, kmsg_path=str(tmp / "k"),
                components_disabled=["network-latency"], endpoint="", token="",
                pprof=pprof))
            s.start()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/openapi.json",
                                            timeout=10) as r:
                    docs[pprof] = json.loads(r.read())
            finally:
                s.stop()
    finally:
        mp.undo()
    return docs


@pytest.mark.parametrize("pprof", [False, True])
def test_openapi_paths_methods_and_summaries_are_the_reference_s(ref_openapi, pprof, tmp_path):
    s = Server(config=live_config(tmp_path, pprof=pprof))
    s.start()
    try:
        status, _, body = _get(("127.0.0.1", s.port), "/openapi.json")
    finally:
        s.stop()
    assert status == 200
    port, ref = json.loads(body), ref_openapi[pprof]
    assert list(port["paths"]) == list(ref["paths"])
    assert {p: {m: nouns(d["summary"]) for m, d in ms.items()} for p, ms in ref["paths"].items()} \
        == {p: {m: d["summary"] for m, d in ms.items()} for p, ms in port["paths"].items()}
    assert port["openapi"] == ref["openapi"] and port["info"]["version"] == ref["info"]["version"]
    assert port["info"]["description"] == nouns(ref["info"]["description"])


# -- the listener's own contract -------------------------------------------------------


@pytest.mark.parametrize("method, path, allow", [
    ("POST", "/healthz", "GET,HEAD"), ("DELETE", "/v1/states", "GET,HEAD"),
    ("GET", "/inject-fault", "POST"), ("PUT", "/v1/components", "DELETE,GET,HEAD"),
    ("OPTIONS", "/v1/remediation/policy", "GET,HEAD,POST"),
])
def test_a_wrong_method_is_405_with_aiohttp_s_allow_header(addr, method, path, allow):
    status, headers, body = _get(addr, path, method)
    assert (status, headers["Allow"], body) == (405, allow, b"405: Method Not Allowed")


@pytest.mark.parametrize("path", ["/nope", "/v1/states/", "/v1", "/V1/states"])
def test_an_unknown_path_is_aiohttp_s_404(addr, path):
    status, headers, body = _get(addr, path)
    assert (status, headers["Content-Type"], body) == (
        404, "text/plain; charset=utf-8", b"404: Not Found")


def test_head_answers_a_get_route_without_a_body(addr):
    status, headers, body = _get(addr, "/healthz", "HEAD")
    assert status == 200 and body == b""
    assert int(headers["Content-Length"]) == len(_get(addr, "/healthz")[2])


def test_the_middleware_labels_by_template_and_collapses_the_rest(addr, live_server):
    for path, method in (("/v1/states?components=cpu", "GET"), ("/no/such/probe", "GET"),
                         ("/healthz", "POST")):
        _get(addr, path, method)
    text = live_server.metrics_registry.render_prometheus()
    assert re.search(r'tpud_http_requests_total\{method="GET",route="/v1/states",'
                     r'status="200"\} \d', text)
    assert 'tpud_http_requests_total{method="GET",route="unmatched",status="404"}' in text
    assert 'tpud_http_requests_total{method="POST",route="unmatched",status="405"}' in text
    assert "/no/such/probe" not in text
    assert 'tpud_http_request_duration_seconds_count{method="GET",route="/v1/states"}' in text
    spans = live_server.tracer.snapshot(component="http", limit=50)
    assert {"route": "/v1/states", "method": "GET", "status": "200"} in [
        s["attrs"] for s in spans if s["name"] == "http.request"]


def test_chaos_routes_answer_as_the_reference_with_chaos_disabled(server_pair):
    # both servers of the pair are built with chaos_enabled=False
    got = {}
    for name, s in server_pair.items():
        assert s.chaos is None
        a = ("127.0.0.1", s.port)
        got[name] = (_get(a, "/v1/chaos/campaigns")[::2],
                     _get(a, "/v1/chaos/run", "POST", b'{"scenario": "x"}')[::2])
    disabled = (400, b'{"error": "chaos is disabled (chaos_enabled)"}')
    assert got["port"] == got["ref"] == (disabled, disabled)


def test_bodies_over_the_limit_are_refused(addr):
    # refused on the declared length, before a byte of the body is read
    raw = socket.create_connection(addr, timeout=10)
    try:
        raw.sendall(b"POST /inject-fault HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n"
                    % (server_mod.MAX_BODY_BYTES + 1))
        assert raw.recv(1024).startswith(b"HTTP/1.1 413")
    finally:
        raw.close()


def test_a_chunked_body_is_read_and_a_bad_length_refused(addr):
    c = http.client.HTTPConnection(*addr, timeout=10)
    try:
        c.request("POST", "/v1/remediation/policy", body=iter([b'{"cooldown_', b'seconds": 300.0}']),
                  headers={"Content-Type": "application/json"}, encode_chunked=True)
        r = c.getresponse()
        assert (r.status, json.loads(r.read())["updated"]) == (200, ["cooldown_seconds"])
        c.request("GET", "/healthz")  # the connection stays in step
        assert c.getresponse().read().startswith(b'{"status": "ok"')
    finally:
        c.close()
    for length in (b"many", b"-1"):
        raw = socket.create_connection(addr, timeout=10)
        try:
            raw.sendall(b"POST /inject-fault HTTP/1.1\r\nHost: x\r\nContent-Length: %s\r\n\r\n"
                        % length)
            assert raw.recv(1024).startswith(b"HTTP/1.1 400")
        finally:
            raw.close()


def test_a_keep_alive_connection_serves_many_requests(addr):
    c = http.client.HTTPConnection(*addr, timeout=10)
    try:
        for _ in range(5):
            c.request("GET", "/healthz")
            r = c.getresponse()
            assert r.status == 200 and json.loads(r.read())["status"] == "ok"
    finally:
        c.close()


def test_tls_listener_serves_https_with_a_self_signed_cert_and_leaves_no_key(tmp_path):
    import ssl

    pytest.importorskip("cryptography")
    tmpdir = tmp_path / "tmp"
    tmpdir.mkdir()
    mp = pytest.MonkeyPatch()
    mp.setenv("TMPDIR", str(tmpdir))
    try:
        s = Server(config=live_config(tmp_path, tls=True))
        s.start()
    finally:
        mp.undo()
    try:
        assert s.base_url() == f"https://localhost:{s.port}"
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname, ctx.verify_mode = False, ssl.CERT_NONE
        c = http.client.HTTPSConnection("127.0.0.1", s.port, timeout=10, context=ctx)
        c.request("GET", "/healthz")
        assert json.loads(c.getresponse().read())["status"] == "ok"
        cert = c.sock.getpeercert(binary_form=True)
        c.close()
        assert cert
        # a plain-HTTP client gets no answer and the listener keeps serving
        raw = socket.create_connection(("127.0.0.1", s.port), timeout=10)
        raw.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        raw.settimeout(10)
        try:
            assert not raw.recv(1024).startswith(b"HTTP/1.1 200")
        except ConnectionResetError:
            pass
        raw.close()
        c = http.client.HTTPSConnection("127.0.0.1", s.port, timeout=10, context=ctx)
        c.request("GET", "/healthz")
        assert c.getresponse().status == 200
        c.close()
        assert list(tmpdir.iterdir()) == []  # the key left the disk
    finally:
        s.stop()


def test_a_failed_bind_is_reported_and_a_retry_serves(tmp_path):
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = taken.getsockname()[1]
        s = Server(config=live_config(tmp_path, port=port))
        try:
            with pytest.raises(RuntimeError, match="API listener failed"):
                s.start()
            assert s._start_error is not None and s._started.is_set()
        except BaseException:
            s.stop()
            raise
    try:
        s.start()  # the port is free again: the assembly is not re-run
        assert s._start_error is None and s.port == port
        assert _get(("127.0.0.1", port), "/healthz")[0] == 200
        jobs = s.scheduler.job_names()
        assert len(jobs) == len(set(jobs))
    finally:
        s.stop()


def test_stop_ends_idle_and_busy_connections_within_its_bound(tmp_path):
    s = Server(config=live_config(tmp_path))
    s.start()
    idle = [socket.create_connection(("127.0.0.1", s.port), timeout=10) for _ in range(3)]
    c = http.client.HTTPConnection("127.0.0.1", s.port, timeout=10)
    c.request("GET", "/healthz")
    c.getresponse().read()  # a kept-alive connection, idle on the server
    deadline = time.monotonic() + WAIT
    while len(s._httpd._conn_threads) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    serving = [s._thread, *s._httpd._conn_threads]
    assert len(serving) >= 5 and all(t.is_alive() for t in serving)
    t0 = time.monotonic()
    s.stop()
    assert time.monotonic() - t0 < 10.0
    assert [t.name for t in serving if t.is_alive()] == []
    for sock in idle:
        sock.close()
    c.close()


# -- the fabric routes on the port's NVLink star (tests/test_fabric.py:360-393) --------


def test_live_server_fabric_status_matrix(live_server):
    plane = live_server.fabric
    assert plane is not None
    plane.sweep_once()
    st = plane.status()
    links = [r["link"] for r in plane.matrix()]
    # the mock's eight GPUs, each with its NVLink ports: one link per port
    assert st["links"] == len(links) == len(live_server.gpu_instance.nvlink_links())
    assert tuple(st["mesh"]["shape"]) == (8, len(links) // 8)
    assert {"gpu0/nvlink0", "gpu7/nvlink0"} <= set(links)


def test_dispatch_fabric_status_history(live_server):
    from gpud_tpu_torch.session.dispatch import Dispatcher

    live_server.fabric.sweep_once()
    n = live_server.fabric.status()["links"]
    d = Dispatcher(live_server)
    resp = d({"method": "fabricStatus"})
    assert not resp.get("error")
    assert resp["status"]["links"] == n and len(resp["matrix"]) == n
    assert "history" not in resp
    resp = d({"method": "fabricStatus", "link": "gpu0/nvlink0", "limit": 4})
    assert not resp.get("error")
    assert resp["history"], "history filter must read the durable store"
    assert all(h["link"] == "gpu0/nvlink0" for h in resp["history"])


def test_fabric_route_and_cli_read_the_same_matrix(live_server, addr, capsys):
    from gpud_tpu_torch.cli import main

    live_server.fabric.sweep_once()
    _, _, body = _get(addr, "/v1/fabric?link=gpu0/nvlink0&limit=2")
    route = json.loads(body)
    assert len(route["history"]) == 2
    assert main(["fabric", "--no-tls", "--port", str(live_server.port), "--json",
                 "--link", "gpu0/nvlink0", "--limit", "2"]) == 0
    cli = json.loads(capsys.readouterr().out)
    assert [r["link"] for r in cli["matrix"]] == [r["link"] for r in route["matrix"]]
    assert main(["fabric", "--no-tls", "--port", str(live_server.port)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("fabric: mesh=8x") and "gpu0/nvlink0:" in out


# -- the restart flow of tests/test_restart_persistence.py -----------------------------

ERR = COMPONENTS["accelerator-tpu-error-kmsg"]


def _fault_state(srv, name, event):
    """The check's state once the injected line's event is in its store,
    from one check run through the API: a scheduled run that began before
    the event may store its older result last (ROADMAP C5)."""
    comp = srv.registry.get(name)
    deadline = time.monotonic() + WAIT
    while not any(e.name == event for e in comp.events(0)):
        if time.monotonic() > deadline:
            raise AssertionError(f"no {event} event in {name}'s store")
        time.sleep(0.05)
    return _trigger(srv, name)


def _trigger(srv, name):
    """One check of ``name`` now, through the API (ROADMAP C5: a scheduled
    run that started before the last store may cache its older result)."""
    status, _, body = _get(("127.0.0.1", srv.port),
                           f"/v1/components/trigger-check?componentName={name}")
    assert status == 200
    return json.loads(body)[0]["states"][0]


def test_events_and_health_survive_daemon_restart(tmp_path):
    s1 = Server(config=live_config(tmp_path))
    s1.start()
    try:
        res = s1.fault_injector.inject(InjectRequest(gpu_error_name="gpu_ecc_xid48", gpu_id=2))
        assert res.ok
        st = _fault_state(s1, ERR, "gpu_ecc_xid48")
        assert st["health"] == HealthStateType.UNHEALTHY and "gpu_ecc_xid48" in st["reason"]
    finally:
        s1.stop()
    # a new Server over the same state file: the persisted events must
    # re-evaluate to the same unhealthy state with per-GPU attribution
    s2 = Server(config=live_config(tmp_path))
    s2.start()
    try:
        assert s2.scheduler.wait_first_runs(WAIT) is not None
        st = _trigger(s2, ERR)
        assert st["health"] == HealthStateType.UNHEALTHY
        assert "gpu_ecc_xid48(GPU 2)" in st["reason"]
        comp = s2.registry.get(ERR)
        assert any(e.name == "gpu_ecc_xid48" for e in comp.events(0))
        comp.set_healthy()  # the operator's clear also persists
    finally:
        s2.stop()
    s3 = Server(config=live_config(tmp_path))
    s3.start()
    try:
        assert s3.scheduler.wait_first_runs(WAIT) is not None
        assert _trigger(s3, ERR)["health"] == HealthStateType.HEALTHY
        assert s3.registry.get(ERR).last_health_states()[0].health == HealthStateType.HEALTHY
    finally:
        s3.stop()


def test_db_in_memory_mode_leaves_no_state_file(tmp_path):
    s = Server(config=live_config(tmp_path, db_in_memory=True))
    s.start()
    try:
        assert s.fault_injector.inject(
            InjectRequest(gpu_error_name="gpu_power_fault", gpu_id=0)).ok
        assert _fault_state(s, ERR, "gpu_power_fault")["health"] == HealthStateType.UNHEALTHY
    finally:
        s.stop()
    assert not (tmp_path / "data" / "tpud.state").exists()
    s2 = Server(config=live_config(tmp_path, db_in_memory=True))
    s2.start()
    try:
        assert s2.scheduler.wait_first_runs(WAIT) is not None
        assert _trigger(s2, ERR)["health"] == HealthStateType.HEALTHY
        assert s2.registry.get(ERR).events(0) == []
    finally:
        s2.stop()


# -- a reference server and a port server, route by route ------------------------------

PARITY_COMPONENTS = ["accelerator-tpu-error-kmsg", "accelerator-tpu-chip-counts"]
PARITY_ROUTES = [
    "/healthz", "/v1/components", "/v1/states", "/v1/events", "/v1/info", "/v1/metrics",
    "/v1/states/history", "/v1/remediation/audit", "/v1/remediation/policy",
    "/v1/predict/scores", "/v1/predict/calibration", "/v1/fabric", "/v1/session/status",
    "/v1/plugins", "/admin/packages", "/admin/config", "/machine-info",
    "/v1/chaos/campaigns", "/openapi.json", "/v1/debug/traces",
]
# (reference, port) words of the answers, applied before the noun table
ANSWER_WORDS = [("TPU-ERR: ", "GPU-ERR: "), ("chip=", "gpu="), ("v5e-8", "h100-sxm-8"),
                ("expected_chip_count", "expected_gpu_count"), ("tpu_info", "gpu_info"),
                *sorted(GAUGES.items(), key=lambda kv: -len(kv[0])),
                *sorted(COMPONENTS.items()),
                ("tpu_hbm_ecc_uncorrectable", "gpu_ecc_xid48")]
MASKED = "<masked>"


def masked(x, key="", ref=False):
    """An answer with clocks, this run's paths, thread names and metric
    sample values (process-wide counters) masked; with ``ref``, a
    reference answer in the port's words."""
    if isinstance(x, dict):
        out = {(("gpu" if k == "chip" else masked(k, ref=True)) if ref else k):
               masked(v, k, ref) for k, v in x.items()}
        if key == "suggested_actions":
            out["description"] = MASKED  # the catalog's own text: TPU vs Xid
        return out
    if isinstance(x, list):
        return [masked(v, "", ref) for v in x]
    if (isinstance(x, (int, float)) and not isinstance(x, bool) and x > 1e9
            or key in ("data_dir", "kmsg_path", "thread", "duration_seconds", "start_unix",
                       "span_id", "unix_seconds", "value")):
        return MASKED
    if ref and isinstance(x, str) and key != "chip":
        for a, b in ANSWER_WORDS:
            x = x.replace(a, b)
        return nouns(x)
    return x


# the series a check writes itself; the health ledger's gauges (availability,
# MTTR, ...) are process-wide, and carry what other daemons of the same test
# process did to a component of the same name
CHECK_SERIES = ("tpud_component_check_duration_seconds", "tpud_gpu_count",
                "tpud_gpu_kmsg_errors_total")


PAIR_ERROR = "gpu_ecc_xid48"  # the one error injected; others count other tests'


def _check_series(metrics):
    return sorted({(m["name"], tuple(sorted(m.get("labels", {}).items())))
                   for m in metrics if m["name"].startswith(CHECK_SERIES)
                   and m.get("labels", {}).get("error", PAIR_ERROR) == PAIR_ERROR})


def _component_metrics(answer, comps):
    """The /v1/metrics check series of ``comps``, each once."""
    return sorted((e["component"], _check_series(e["metrics"]))
                  for e in answer if e["component"] in comps)


def _self_entry(info):
    """The ``tpud-self`` entry of /v1/info: this daemon's own figures
    compared, the process-wide trace ring's and sqlite's reduced to keys."""
    st = info[-1]["info"]["states"][0]
    ex = st["extra_info"]
    st["extra_info"] = {k: (v if k.startswith(("health_", "outbox_")) else MASKED)
                        for k, v in ex.items()}
    return info


def _series(text, keep):
    """Prometheus samples whose labels name one of ``keep`` (a component
    or an HTTP route), as {(name, labels): value}."""
    from tests.test_metrics_exposition_contract import parse_exposition

    return {k: v for k, v in parse_exposition(text).items()
            if any(val in keep for _, val in k[1])}


@pytest.fixture(scope="module")
def server_pair(port_host, tmp_path_factory):
    from gpud_tpu.config import default_config as ref_default_config
    from gpud_tpu.fault_injector import Request as RefInjectRequest
    from gpud_tpu.server.server import Server as RefServer

    mp = pytest.MonkeyPatch()
    stub_host_probes(mp)
    mp.setenv("TPUD_TPU_MOCK_ALL_SUCCESS", "1")
    tmp = tmp_path_factory.mktemp("pair")
    built = {}
    try:
        for name in ("ref", "port"):
            w = tmp / name
            w.mkdir()
            kw = dict(data_dir=str(w / "data"), port=0, tls=False, kmsg_path=str(w / "kmsg"),
                      components_disabled=["network-latency"], endpoint="", token="",
                      chaos_enabled=False,
                      components_enabled=[c if name == "ref" else COMPONENTS[c]
                                          for c in PARITY_COMPONENTS])
            (w / "kmsg").write_text("")
            built[name] = (RefServer(config=ref_default_config(**kw)) if name == "ref"
                           else Server(config=live_config(w, **kw)))
            built[name].start()
        for s in built.values():
            assert s.scheduler.wait_first_runs(WAIT) is not None
        # the reference's kmsg reader seeks on its own thread (ROADMAP C6)
        time.sleep(0.5)
        assert built["ref"].fault_injector.inject(
            RefInjectRequest(tpu_error_name="tpu_hbm_ecc_uncorrectable", chip_id=2)).ok
        assert built["port"].fault_injector.inject(
            InjectRequest(gpu_error_name="gpu_ecc_xid48", gpu_id=2)).ok
        for name, comp, event in (("ref", PARITY_COMPONENTS[0], "tpu_hbm_ecc_uncorrectable"),
                                  ("port", ERR, "gpu_ecc_xid48")):
            assert _fault_state(built[name], comp, event)["health"] == HealthStateType.UNHEALTHY
        for s in built.values():
            s.remediation.scan_once()
            s.metrics_syncer.sync_once()
            s.predictor.calibrate_now()
        yield built
    finally:
        for s in built.values():
            s.stop()
        mp.undo()


@pytest.fixture(scope="module")
def pair_answers(server_pair):
    """Every route of PARITY_ROUTES asked of both, in the same order, with
    the Prometheus samples the sweep moved."""
    keep = set(PARITY_ROUTES) | {COMPONENTS[c] for c in PARITY_COMPONENTS} \
        | set(PARITY_COMPONENTS)
    out = {}
    mp = pytest.MonkeyPatch()
    still_host(mp)
    for name, s in server_pair.items():
        before = _series(s.metrics_registry.render_prometheus(), keep)
        answers = {}
        for path in PARITY_ROUTES:
            status, _, body = _get(("127.0.0.1", s.port), path)
            answers[path] = (status, json.loads(body))
        after = _series(s.metrics_registry.render_prometheus(), keep)
        moved = {k for k, v in after.items() if before.get(k) != v}
        out[name] = (answers, moved, set(after))
    mp.undo()
    return out


def still_host(mp):
    """The figures of /machine-info that move between two reads (uptime,
    file-system usage, the block tree's used bytes) read once, through one
    function for both packages (tests/test_torch_machine_info.py)."""
    import psutil

    import gpud_tpu.blockdev as ref_blockdev
    import gpud_tpu.host as ref_host
    import gpud_tpu.machine_info as ref_mi
    from gpud_tpu_torch import blockdev as port_blockdev
    from gpud_tpu_torch import host as port_host
    from gpud_tpu_torch import procfs

    up = ref_host.uptime_seconds()
    mp.setattr(ref_host, "uptime_seconds", lambda: up)
    mp.setattr(port_host, "uptime_seconds", lambda: up)
    for read, targets in ((psutil.disk_usage, [(ref_mi.psutil, "disk_usage"),
                                               (procfs, "disk_usage")]),
                          (ref_blockdev._statvfs_used, [(ref_blockdev, "_statvfs_used"),
                                                        (port_blockdev, "_statvfs_used")])):
        seen = {}

        def once(path, read=read, seen=seen):
            if path not in seen:
                seen[path] = read(path)
            return seen[path]

        for module, attr in targets:
            mp.setattr(module, attr, once)


@pytest.mark.parametrize("path", PARITY_ROUTES)
def test_every_get_route_answers_as_the_reference_s(pair_answers, path):
    ref_status, ref = pair_answers["ref"][0][path]
    port_status, port = pair_answers["port"][0][path]
    assert port_status == ref_status
    ref, port = masked(ref, ref=True), masked(port)
    comps = {COMPONENTS[c] for c in PARITY_COMPONENTS}
    if path == "/machine-info":
        ref.pop("gpu_info")  # the reference's tpu_info
        assert port.pop("gpu_info")["gpus"]
    if path == "/v1/info":
        ref, port = _self_entry(ref), _self_entry(port)
        for entry in ref + port:  # each check series once, however many scrapes
            entry["info"]["metrics"] = _check_series(entry["info"]["metrics"])
    if path == "/v1/metrics":
        ref, port = _component_metrics(ref, comps), _component_metrics(port, comps)
        assert port
    if path == "/v1/debug/traces":
        # the process's trace ring: this sweep's newest requests, in order
        n = PARITY_ROUTES.index(path)
        ref, port = ([(s["name"], s["attrs"]) for s in d["spans"][:n]] for d in (ref, port))
    assert port == ref


def test_the_sweep_moves_the_same_prometheus_series(pair_answers):
    def names(keys, port=False):
        out = set()
        for name, labels in keys:
            lab = tuple(sorted((k, v if port else masked(v, ref=True)) for k, v in labels))
            out.add((name if port else GAUGES.get(name, name), lab))
        return out

    # the counters: which latency bucket a request lands in is the host's
    def counted(keys):
        return {k for k in keys if k[0].endswith(("_total", "_count"))}

    ref_moved, port_moved = (counted(pair_answers[k][1]) for k in ("ref", "port"))
    assert names(port_moved, port=True) == names(ref_moved)
    assert {n for n, _ in port_moved} >= {"tpud_http_requests_total",
                                          "tpud_http_request_duration_seconds_count"}
    # every series the two checks write, by name and labels
    comps = {COMPONENTS[c] for c in PARITY_COMPONENTS}

    def checks(keys, port=False):
        return {k for k in names(keys, port) if dict(k[1]).get("component") in comps
                and k[0].startswith(CHECK_SERIES)
                and dict(k[1]).get("error", PAIR_ERROR) == PAIR_ERROR}

    assert checks(pair_answers["port"][2], port=True) == checks(pair_answers["ref"][2])
    assert checks(pair_answers["port"][2], port=True)

