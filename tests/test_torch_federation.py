"""The port's manager federation (gpud_tpu_torch/manager/peers.py,
federation.py, ``ControlPlane.attach_peers`` and the federated panes).

The reference's own federation tests run on the port
(tests/torch_ref_tests.py ``port_tests``): peer specs, rendezvous balance
and minimal remap, ``PeerSet``, ``ReplicaStore``, the shipper's ack, stall,
rewind and reconnect, the five merges, breaker rotation, outbox watermarks,
``Session._apply_peer``, two real managers replicating, failing over and
scattering, and the plane's standalone bits. The agent ids and the one
component name they give are the reference's TPU nouns, turned into the
port's. Then the port's own cases: ``attach_peers`` before ``start()`` and
twice, ``?scope=local`` holding the fan-out to depth one, a dead peer shown
unreachable and never absent, and a fan-out that reads no proxy variable.
Every server binds 127.0.0.1:0 and every wait has a bound.
"""

import http.server
import json
import threading
import urllib.request

import pytest

from torch_ref_tests import port_tests

WAIT = 30.0

FEDERATION_NOUNS = [
    ("tpu-vm-", "gpu-vm-"),
    ('"component": "tpu"', '"component": "gpu"'),
]

globals().update(port_tests("test_federation.py", replace=FEDERATION_NOUNS))


# -- the port's own ------------------------------------------------------------------


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT) as resp:
        return json.loads(resp.read().decode())


def _spec(pid, cp):
    return f"{pid}=http://127.0.0.1:{cp.port}|127.0.0.1:{cp.grpc_port}"


def _plane(tmp_path, pid, **kw):
    from gpud_tpu_torch.manager.control_plane import ControlPlane

    cp = ControlPlane(instance_id=pid, data_dir=str(tmp_path / pid), shards=1, **kw)
    cp.start()
    return cp


def _closed_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_attach_peers_needs_a_started_manager_and_binds_once(tmp_path):
    from gpud_tpu_torch.manager.control_plane import ControlPlane

    cp = ControlPlane(instance_id="m-a", data_dir=str(tmp_path / "m-a"))
    with pytest.raises(RuntimeError, match="requires a started manager"):
        cp.attach_peers("m-a", ["m-a=http://127.0.0.1:1"])
    assert cp.federation is None
    cp.start()
    try:
        fed = cp.attach_peers("m-a", [_spec("m-a", cp), "m-b=http://127.0.0.1:2"],
                              probe_interval=600, replication_interval=600)
        assert cp.federation is fed and fed.peers.ring == ["m-a", "m-b"]
        with pytest.raises(RuntimeError, match="peers already attached"):
            cp.attach_peers("m-a", [_spec("m-a", cp)])
        assert cp.federation is fed
    finally:
        cp.stop()
    assert cp.federation is None  # stopped first, before the listener


def test_attach_peers_rejects_a_bad_peer_map(tmp_path):
    from gpud_tpu_torch.manager.peers import PeerSpecError

    cp = _plane(tmp_path, "m-a")
    try:
        for specs in (["m-a=not-a-url"], ["m-b=http://127.0.0.1:2"],
                      [_spec("m-a", cp), _spec("m-a", cp)]):
            with pytest.raises(PeerSpecError):
                cp.attach_peers("m-a", specs)
            assert cp.federation is None
    finally:
        cp.stop()


@pytest.fixture()
def three_managers(tmp_path):
    cps = {pid: _plane(tmp_path, pid) for pid in ("m-a", "m-b", "m-c")}
    specs = [_spec(pid, cp) for pid, cp in cps.items()]
    try:
        for pid, cp in cps.items():
            cp.attach_peers(pid, specs, replication_interval=600, probe_interval=600,
                            fanout_timeout=5.0)
        yield cps
    finally:
        for cp in cps.values():
            cp.stop()


def test_scope_local_holds_the_fan_out_to_depth_one(three_managers):
    a, b, c = (three_managers[p] for p in ("m-a", "m-b", "m-c"))
    for n, cp in enumerate((a, b, c)):
        cp.rollup.ingest(f"agent-{n}", [(1, 1000.0, "transition", f"k{n}",
                                         {"component": "cpu", "health": "healthy"})])
    pane = _get(f"{a.endpoint}/v1/fleet/rollup")
    assert pane["federated"] is True and pane["agents"] == 3
    assert sorted(pane["fanout"]) == ["m-b", "m-c"]
    assert all("error" not in r for r in pane["fanout"].values())
    assert sorted(pane["cohorts"]) == ["m-b", "m-c"]
    # the peers answered their own cohort only: neither fanned out again
    for cp in (b, c):
        s = cp.federation.stats()
        assert (s["scatter_ok"], s["scatter_errors"]) == (0, 0)
    assert a.federation.stats()["scatter_ok"] == 2
    local = _get(f"{a.endpoint}/v1/fleet/rollup?scope=local")
    assert "federated" not in local and local["agents"] == 1
    for path in ("fabric", "predict", "agents", "traces?correlation_id=x"):
        sep = "&" if "?" in path else "?"
        assert "federated" not in _get(f"{a.endpoint}/v1/fleet/{path}{sep}scope=local")
        assert _get(f"{a.endpoint}/v1/fleet/{path}")["federated"] is True
    # history is single-owner: a's journal lacks agent-1, b's has it
    hist = _get(f"{a.endpoint}/v1/fleet/agents/agent-1/history")
    assert hist["total"] == 1 and hist["peer"] == "m-b"
    assert _get(f"{a.endpoint}/v1/fleet/agents/agent-1/history?scope=local")["total"] == 0


def test_a_dead_peer_is_shown_unreachable_never_absent(tmp_path):
    cp = _plane(tmp_path, "m-b")
    try:
        fed = cp.attach_peers("m-b", [f"m-a=http://127.0.0.1:{_closed_port()}",
                                      _spec("m-b", cp)],
                              replication_interval=600, probe_interval=600,
                              fanout_timeout=2.0, dead_after_probes=2, auto_adopt=False)
        # before any probe the dead peer is a fan-out target, and its
        # failure is in the answer
        pane = _get(f"{cp.endpoint}/v1/fleet/rollup")
        assert "error" in pane["fanout"]["m-a"]
        assert {p["peer_id"] for p in pane["peers"]} == {"m-a", "m-b"}
        fed.probe_once()
        fed.probe_once()
        pane = _get(f"{cp.endpoint}/v1/fleet/rollup")
        dead = [p for p in pane["peers"] if p["peer_id"] == "m-a"]
        assert dead and dead[0]["reachable"] is False and dead[0]["adopted"] is False
        assert dead[0]["consecutive_failures"] == 2 and dead[0]["last_error"]
        assert pane["fanout"] == {}  # not a target any more, but still in the block
        view = _get(f"{cp.endpoint}/v1/fleet/peers")
        assert view["federation"] is True and view["ring"] == ["m-a", "m-b"]
        assert [p["peer_id"] for p in view["peers"]] == ["m-b", "m-a"]
        assert view["scatter"]["errors"] == 1
    finally:
        cp.stop()


class _Recorder(http.server.BaseHTTPRequestHandler):
    """Answers every GET with ``{}`` and records its request line: a peer
    and a proxy alike."""

    seen: list

    def do_GET(self):  # noqa: N802 — http.server's name
        self.seen.append(self.path)
        body = b"{}"
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *_a):
        pass


def _recorder():
    handler = type("Handler", (_Recorder,), {"seen": []})
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, handler.seen


@pytest.mark.parametrize("pkg", ["gpud_tpu", "gpud_tpu_torch"])
def test_the_fan_out_reads_no_proxy_variable(pkg, tmp_path, monkeypatch):
    """With every proxy variable pointing at a recording proxy, the port's
    fan-out still goes straight to the peer with ``scope=local`` pinned;
    the reference's ``urllib.request`` hands it to the proxy (a difference
    by design)."""
    import importlib

    fed_mod = importlib.import_module(f"{pkg}.manager.federation")
    peers_mod = importlib.import_module(f"{pkg}.manager.peers")
    rollup_mod = importlib.import_module(f"{pkg}.manager.rollup")
    DB = importlib.import_module(f"{pkg}.sqlite").DB

    proxy, via_proxy = _recorder()
    peer, at_peer = _recorder()
    for var in ("http_proxy", "HTTP_PROXY", "all_proxy", "ALL_PROXY"):
        monkeypatch.setenv(var, f"http://127.0.0.1:{proxy.server_address[1]}")
    for var in ("no_proxy", "NO_PROXY"):
        monkeypatch.delenv(var, raising=False)
    # urlopen's opener reads the variables once, when it is first built
    monkeypatch.setattr(urllib.request, "_opener", None)
    db = DB(str(tmp_path / "fp.db"))
    descs = [peers_mod.parse_peer_spec("m-a=http://127.0.0.1:1"),
             peers_mod.parse_peer_spec(f"m-b=http://127.0.0.1:{peer.server_address[1]}")]
    fp = fed_mod.FederationPlane(peers_mod.PeerSet("m-a", descs),
                                 rollup_mod.FleetRollupStore(db, shard_count=1), db,
                                 admin_token="adm", probe_interval=600, replication_interval=600)
    try:
        out = fp.scatter("/v1/fleet/agents", {"limit": 5})
        assert "data" in out["m-b"], out
    finally:
        fp.stop()
        proxy.shutdown()
        peer.shutdown()
        db.close()
    if pkg == "gpud_tpu_torch":
        assert via_proxy == []
        assert at_peer == ["/v1/fleet/agents?limit=5&scope=local"]
    else:
        assert at_peer == []
        assert via_proxy == [
            f"http://127.0.0.1:{peer.server_address[1]}/v1/fleet/agents?limit=5&scope=local"]


def test_the_fan_out_sends_the_admin_bearer(tmp_path):
    """The port's fan-out asks a peer with an admin token as the
    reference's does: the bearer is what lets the peer answer."""
    a = _plane(tmp_path, "m-a", admin_token="adm")
    b = _plane(tmp_path, "m-b", admin_token="adm")
    try:
        specs = [_spec("m-a", a), _spec("m-b", b)]
        for pid, cp in (("m-a", a), ("m-b", b)):
            cp.attach_peers(pid, specs, replication_interval=600, probe_interval=600)
        b.rollup.ingest("agent-b", [(1, 1000.0, "transition", "k",
                                     {"component": "cpu", "health": "healthy"})])
        pane = a.federation.federate("agents", a.rollup.agents_page(0, 50), {"limit": 50})
        assert [r["agent"] for r in pane["agents"]] == ["agent-b"]
        assert pane["agents"][0]["peer"] == "m-b"
        a.federation.admin_token = "wrong"
        pane = a.federation.federate("agents", a.rollup.agents_page(0, 50), {"limit": 50})
        assert pane["agents"] == [] and "401" in pane["fanout"]["m-b"]["error"]
    finally:
        a.stop()
        b.stop()
