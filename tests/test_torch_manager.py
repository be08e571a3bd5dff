"""The port's manager tier (gpud_tpu_torch/manager/: control_plane.py,
shard.py, rollup.py, exposition.py, federation.py) against gpud_tpu's.

The reference's own tests of the manager run on the port
(tests/torch_ref_tests.py, with tests/torch_live.py's replacements and its
``port_host``: mock GPUs, stubbed probes, servers on 127.0.0.1):
tests/test_control_plane.py, test_fleet_rollup.py,
test_fleet_ingest_executor.py, test_fleet_predict.py, test_manager_churn.py,
test_manager_daemon_lifecycle.py and test_manager_mixed_fleet.py. (The
cases that waited for the manager in the planes' tests, the
``AgentHandle`` cases of tests/test_session_outbox.py, the fabric rollup
cases of tests/test_fabric.py and the rev-2 agent against a rev-3 manager
of tests/test_session_wire.py, run on both packages in
test_torch_session_outbox.py, test_torch_fabric.py and
test_torch_session_wire.py.) Then the port's own cases: the v1 stream cap
and a manager without grpc, each beside the reference's; a bounded stop
with a stuck agent; and every operator command through both CLIs. Every
manager binds 127.0.0.1:0."""

import json
import sys
import threading
import time

import pytest

from torch_live import REF_TO_PORT, port_host  # noqa: F401
from torch_ref_tests import port_tests

WAIT = 30.0

# the port's analogs of the reference's fault and machine-info nouns
MANAGER_NOUNS = REF_TO_PORT + [
    ("tpu_ici_cable_fault", "gpu_nvlink_error"),
    # updateConfig's GPU sections (gpud_tpu_torch/session/dispatch.py)
    ("expected_chip_count", "expected_gpu_count"),
    ('"ici": {"expected_links": 7}', '"nvlink": {"expected_links": 7}'),
    ('"ici.expected_links"', '"nvlink.expected_links"'),
    # the login's machine-info tree (after REF_TO_PORT's chip_id -> gpu_id)
    ('"tpu_info": {', '"gpu_info": {'),
    ('"accelerator_type": "v5p-8",', '"product": "NVIDIA H100 80GB HBM3",'),
    ('"chip_count": 4,', '"architecture": "hopper",'),
    ('"chips": [{"gpu_id": 0, "device_path": "/dev/accel0"}],',
     '"gpus": [{"uuid": "GPU-0", "minor_number": 0}],'),
    ('tree["tpu_info"]["accelerator_type"] == "v5p-8"',
     'tree["gpu_info"]["product"] == "NVIDIA H100 80GB HBM3"'),
    ('tree["tpu_info"]["chips"][0]["device_path"] == "/dev/accel0"',
     'tree["gpu_info"]["gpus"][0]["minor_number"] == 0'),
]

globals().update(port_tests("test_control_plane.py", replace=MANAGER_NOUNS))
globals().update(port_tests("test_fleet_rollup.py", replace=MANAGER_NOUNS))
globals().update(port_tests("test_fleet_ingest_executor.py"))
globals().update(port_tests("test_fleet_predict.py"))
globals().update(port_tests("test_manager_churn.py", replace=MANAGER_NOUNS))
globals().update(port_tests("test_manager_daemon_lifecycle.py", replace=MANAGER_NOUNS))
globals().update(port_tests("test_manager_mixed_fleet.py", replace=MANAGER_NOUNS))


# -- the port's own: the v1 stream cap (beside the reference's), a bounded stop, a
# -- manager without grpc, the CLI beside tpud's ---------------------------------------


def _open_read_stream(cp, machine):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", cp.port, timeout=WAIT)
    conn.request("POST", "/api/v1/session", body=b"", headers={
        "X-TPUD-Session-Type": "read", "X-TPUD-Machine-ID": machine, "Authorization": "Bearer t"})
    resp = conn.getresponse()
    assert resp.status == 200 and resp.getheader("Content-Type") == "application/x-ndjson"
    return conn, resp


def _wait(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def capped_plane(pkg):
    """A started manager of ``pkg`` whose v1 read streams share 2 waiting
    slots: the reference's stream pool cut to 2 workers, the port's
    ``max_v1_agents``."""
    if pkg == "ref":
        from concurrent.futures import ThreadPoolExecutor

        from gpud_tpu.manager.control_plane import ControlPlane

        cp = ControlPlane()
        cp._stream_pool.shutdown(wait=False)
        cp._stream_pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="capped")
    else:
        from gpud_tpu_torch.manager.control_plane import ControlPlane

        cp = ControlPlane()
        cp.max_v1_agents = 2
    cp.start()
    return cp


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_a_v1_read_stream_past_the_cap_waits_for_a_slot(pkg):
    """The reference's read streams share ``max_v1_agents`` executor
    workers, one held while a stream waits for its next request; past the
    cap a stream is accepted and registered, and its requests wait for a
    worker to free. The port holds the same cap with a slot per waiting
    stream: both packages behave alike."""
    cp = capped_plane(pkg)
    streams = []
    try:
        for i in range(3):
            streams.append(_open_read_stream(cp, f"capped-{i}"))
            _wait(lambda: f"capped-{i}" in cp.agents, "registered")
        lines = {i: [] for i in range(3)}

        def read(i):
            for raw in iter(streams[i][1].readline, b""):
                lines[i].append(json.loads(raw))

        readers = [threading.Thread(target=read, args=(i,), daemon=True) for i in range(3)]
        for t in readers:
            t.start()
        handles = [cp.agent(f"capped-{i}") for i in range(3)]
        handles[2].outbound.put({"req_id": "r2", "data": {"method": "states"}})
        time.sleep(1.5)  # three of the port manager's polls: no slot frees
        assert lines[2] == []
        handles[0].mark_gone()  # the first stream ends and frees its slot
        _wait(lambda: lines[2], "the capped stream's request after a slot freed")
        assert lines[2] == [{"req_id": "r2", "data": {"method": "states"}}]
    finally:
        cp.stop()
        for conn, _resp in streams:
            conn.close()


def test_stop_is_bounded_with_a_stuck_agent_on_both_streams():
    """A write stream that never sends and a read stream nobody reads must
    not hold ``stop()``."""
    import socket

    from gpud_tpu_torch.manager.control_plane import ControlPlane

    cp = ControlPlane()
    cp.start()
    conn, _resp = _open_read_stream(cp, "stuck")
    w = socket.create_connection(("127.0.0.1", cp.port), timeout=WAIT)
    w.sendall(b"POST /api/v1/session HTTP/1.1\r\nHost: x\r\nX-TPUD-Session-Type: write\r\n"
              b"X-TPUD-Machine-ID: stuck\r\nAuthorization: Bearer t\r\n"
              b"Transfer-Encoding: chunked\r\n\r\n")
    _wait(lambda: "stuck" in cp.agents, "registered")
    h = cp.agent("stuck")
    for i in range(2000):  # more than the socket buffers hold
        h.outbound.put({"req_id": f"r{i}", "data": {"method": "states", "pad": "x" * 512}})
    t0 = time.monotonic()
    cp.stop()
    assert time.monotonic() - t0 < 15.0
    assert cp.agents == {}
    w.close()
    conn.close()


NO_GRPC = """
import json, logging, sys, urllib.request
sys.modules["grpc"] = None  # a host without grpcio
from {pkg}.manager.control_plane import ControlPlane
warnings = []
handler = logging.Handler()
handler.emit = lambda rec: warnings.append(rec.getMessage())
logging.getLogger("tpud").addHandler(handler)
cp = ControlPlane()
cp.start()
with urllib.request.urlopen(cp.endpoint + "/v1/machines", timeout=30) as r:
    status = r.status
cp.stop()
print(json.dumps([cp.grpc_port, status, [w for w in warnings if "grpc" in w]]))
"""


@pytest.mark.parametrize("pkg", ["gpud_tpu", "gpud_tpu_torch"])
def test_a_manager_without_grpc_serves_v1_and_says_so(pkg):
    import subprocess
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", NO_GRPC.format(pkg=pkg)], capture_output=True,
                          text=True, timeout=120, cwd=str(Path(__file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == [
        -1, 200, ["grpc unavailable; v2 transport disabled"]]


@pytest.fixture(scope="module")
def cli_plane():
    """A port manager with one agent answering on an AgentHandle, and a
    journal with one agent's records."""
    from gpud_tpu_torch.manager.control_plane import AgentHandle, ControlPlane
    from gpud_tpu_torch.session import wire

    cp = ControlPlane(admin_token="adm")
    cp.start()
    h = AgentHandle("cli-agent", "v1")
    cp._register(h)
    enc = wire.DeltaEncoder()
    recs = [enc.encode_record(n, 100.0 + n, "transition", f"k{n}",
                              {"component": "cpu", "from": "Healthy" if n % 2 else "Unhealthy",
                               "to": "Unhealthy" if n % 2 else "Healthy", "ts": 100.0 + n,
                               "correlation_id": "cid-cli" if n == 1 else ""})
            for n in range(1, 5)]
    h.resolve("outbox-1", wire.build_batch(recs))
    assert cp.ingest_executor.flush(timeout=WAIT)
    stop = threading.Event()

    def answer():  # the agent: echo every request but the acks
        while not stop.is_set():
            try:
                item = h.outbound.get(timeout=0.1)
            except Exception:  # noqa: BLE001 — queue.Empty
                continue
            if item and item["data"].get("method") != "outboxAck":
                h.resolve(item["req_id"], {"echo": item["data"]})

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    yield cp
    stop.set()
    t.join(timeout=5)
    cp.stop()


OPERATOR_ARGV = [
    ["manager", "machines"],
    ["manager", "request", "cli-agent", "states", "--params", '{"components": ["cpu"]}'],
    ["manager", "request", "cli-agent", "gossip", "--params", '{"method": "reboot"}'],
    ["manager", "request", "ghost", "states"],
    ["manager", "request", "cli-agent", "states", "--params", "{bad json"],
    ["manager", "request", "cli-agent", "states", "--params", "[1]"],
    ["fleet", "rollup"], ["fleet", "fabric", "--since", "50"], ["fleet", "predict", "--top", "3"],
    ["fleet", "agents", "--limit", "5"], ["fleet", "peers"], ["fleet", "history", "cli-agent"],
    ["fleet", "history", "cli-agent", "--since", "102", "--limit", "1", "--offset", "1"],
    ["fleet", "traces", "cid-cli"],
]


@pytest.mark.parametrize("argv", OPERATOR_ARGV, ids=[" ".join(a[:3]) for a in OPERATOR_ARGV])
@pytest.mark.parametrize("token", ["adm", "", "wrong"])
def test_the_operator_cli_answers_as_tpud_s(cli_plane, argv, token, capsys, monkeypatch):
    """``manager`` and ``fleet`` through the port's SDK print what
    ``tpud``'s print through ``requests``, with its exit codes and error
    text, against the same manager (with the admin token, without it and
    with a wrong one)."""
    from gpud_tpu.cli import main as ref_main

    from gpud_tpu_torch.cli import main

    monkeypatch.setattr(sys, "argv", ["tpud"])
    full = [*argv, "--endpoint", cli_plane.endpoint, "--admin-token", token]
    got = []
    for fn in (ref_main, main):
        rc = fn(list(full))
        out, err = capsys.readouterr()
        got.append((rc, out, err))
    (ref_rc, ref_out, ref_err), (rc, out, err) = got
    assert (rc, err) == (ref_rc, ref_err)
    if ref_rc == 0 and argv[:2] == ["fleet", "predict"]:
        # the pane is computed at the wall clock's "now" (cached for 2 s)
        assert {**json.loads(out), "now": 0} == {**json.loads(ref_out), "now": 0}
    else:
        assert out == ref_out


def test_the_operator_cli_without_a_manager_fails_as_tpud_s(capsys, monkeypatch):
    from gpud_tpu.cli import main as ref_main

    from gpud_tpu_torch.cli import main

    monkeypatch.setattr(sys, "argv", ["tpud"])
    for argv in (["manager", "machines"], ["fleet", "rollup"], ["fleet", "peers"]):
        codes = []
        for fn in (ref_main, main):
            codes.append(fn([*argv, "--endpoint", "http://127.0.0.1:1"]))
            out, err = capsys.readouterr()
            assert out == "" and err.startswith("error: ")  # the transport's own text
        assert codes == [1, 1]
