"""The port's client SDK (gpud_tpu_torch/client/v1.py, on ``http.client``)
and the ``GossipRequest`` wire type against gpud_tpu's.

The reference's own tests of its SDK and of the daemon's end-to-end API —
tests/test_client_sdk_errors.py and tests/test_server_e2e.py — run on the
port's ``Client`` and ``Server`` (tests/torch_ref_tests.py, with
tests/torch_live.py's replacements and ``live_server``); the e2e file's
servers serve HTTPS with the boot-generated certificate. Then both SDKs
against both servers: the same ``ClientError`` status and body for every
refusal, each SDK's answers decoded alike, and ``GossipRequest`` round trips
equal to the reference's bytes."""

import json
import socket

import numpy as np
import pytest

from gpud_tpu.api.v1 import types as ref_types
from gpud_tpu.client.v1 import Client as RefClient, ClientError as RefClientError

from gpud_tpu_torch.api.v1 import types as port_types
from gpud_tpu_torch.client.v1 import Client, ClientError
from gpud_tpu_torch.server.server import Server

from torch_live import REF_TO_PORT, live_config, live_server, port_host  # noqa: F401
from torch_parity import stub_host_probes
from torch_ref_tests import port_tests

SEED = 23

globals().update(port_tests("test_client_sdk_errors.py", replace=REF_TO_PORT))
globals().update(port_tests("test_server_e2e.py", replace=REF_TO_PORT))


# -- GossipRequest --------------------------------------------------------------------


def machine_info_dict(rng, with_gpu):
    d = {
        "machine_id": f"m-{int(rng.integers(1 << 30))}", "hostname": "h", "os": "Linux",
        "kernel_version": "6.1", "boot_id": "b", "uptime_seconds": int(rng.integers(1e6)),
        "cpu_model": "x", "cpu_logical_cores": int(rng.integers(1, 256)),
        "memory_total_bytes": int(rng.integers(1 << 40)), "provider": "p", "region": "r",
        "public_ip": "1.2.3.4", "private_ip": "10.0.0.1", "tpud_version": "0.1.0",
        "containerized": bool(rng.integers(2)),
        "disks": [{"device": "/dev/vda", "mount_point": "/", "fstype": "ext4",
                   "total_bytes": int(rng.integers(1 << 40)), "used_bytes": 7}],
        "nics": [{"name": "eth0", "mac": "aa:bb", "addresses": ["10.0.0.1"], "mtu": 1500,
                  "speed_mbps": 1000, "driver": "virtio", "virtual": False}],
        "block_devices": [],
    }
    if with_gpu:
        d["gpu_info"] = {"product": "NVIDIA H100 80GB HBM3", "manufacturer": "NVIDIA",
                         "architecture": "hopper", "driver_version": "580.159.03",
                         "cuda_version": "12.8", "memory_total_bytes": 85_520_809_984,
                         "gpus": [{"uuid": f"GPU-{i}", "serial": str(i), "minor_number": i,
                                   "pci_bus_id": f"00000000:{0x18 + i:02X}:00.0"}
                                  for i in range(int(rng.integers(1, 9)))]}
    return d


@pytest.mark.parametrize("seed", range(SEED, SEED + 4))
def test_gossip_request_round_trips_the_reference_s_bytes(seed):
    rng = np.random.default_rng(seed)
    for with_info in (False, True):
        mi = machine_info_dict(rng, with_gpu=False) if with_info else None
        ref = ref_types.GossipRequest(
            machine_id=f"m-{seed}",
            machine_info=ref_types.MachineInfo.from_dict(mi) if mi else None)
        wire = json.dumps(ref.to_dict(), sort_keys=True)
        port = port_types.GossipRequest.from_dict(json.loads(wire))
        assert json.dumps(port.to_dict(), sort_keys=True) == wire
        assert port_types.GossipRequest.from_dict(port.to_dict()) == port
        assert ref_types.GossipRequest.from_dict(port.to_dict()).to_dict() == ref.to_dict()


def test_gossip_request_carries_the_gpu_inventory():
    mi = machine_info_dict(np.random.default_rng(SEED), with_gpu=True)
    g = port_types.GossipRequest(machine_id="m", machine_info=port_types.MachineInfo.from_dict(mi))
    back = port_types.GossipRequest.from_dict(json.loads(json.dumps(g.to_dict())))
    assert back == g and back.to_dict()["machine_info"]["gpu_info"] == mi["gpu_info"]
    assert port_types.GossipRequest.from_dict({}) == port_types.GossipRequest()


# -- both SDKs against both servers ------------------------------------------------------

REFUSALS = [
    ("GET", "/v1/no-such-route", None, None),
    ("POST", "/healthz", None, {}),
    ("DELETE", "/v1/components", {"componentName": "cpu"}, None),
    ("DELETE", "/v1/components", {"componentName": "nope"}, None),
    ("GET", "/v1/components/trigger-check", None, None),
    ("GET", "/v1/components/trigger-check", {"componentName": "nope"}, None),
    ("GET", "/v1/components/trigger-tag", {"tagName": "nope"}, None),
    ("POST", "/v1/components/set-healthy", {"componentName": "nope"}, None),
    ("GET", "/v1/events", {"startTime": "yesterday"}, None),
    ("GET", "/v1/metrics", {"since": "x"}, None),
    ("GET", "/v1/info", {"startTime": "x"}, None),
    ("GET", "/v1/states/history", {"limit": "lots"}, None),
    ("GET", "/v1/remediation/audit", {"since": "x"}, None),
    ("GET", "/v1/predict/scores", {"history": "x"}, None),
    ("GET", "/v1/fabric", {"since": "yesterday"}, None),
    ("GET", "/v1/debug/traces", {"limit": "x"}, None),
    ("POST", "/v1/remediation/policy", None, [1]),
    ("POST", "/v1/remediation/policy", None, {"enforce_actions": ["bogus"]}),
    ("POST", "/inject-fault", None, [1]),
    ("POST", "/inject-fault", None, {"repeat": 0, "kernel_message": "x"}),
    ("POST", "/inject-fault", None, {"kernel_message": "x", "repeat": "many"}),
    ("POST", "/v1/chaos/run", None, {"scenario": "x"}),
    ("GET", "/v1/chaos/campaigns", None, None),
]


@pytest.fixture(scope="module")
def ref_server(tmp_path_factory):
    from gpud_tpu.config import default_config as ref_default_config
    from gpud_tpu.server.server import Server as RefServer

    mp = pytest.MonkeyPatch()
    stub_host_probes(mp)
    tmp = tmp_path_factory.mktemp("ref-server")
    (tmp / "k").write_text("")
    s = RefServer(config=ref_default_config(
        data_dir=str(tmp / "d"), port=0, tls=False, kmsg_path=str(tmp / "k"),
        components_disabled=["network-latency"], endpoint="", token="",
        chaos_enabled=False))
    s.start()
    yield s
    s.stop()
    mp.undo()


@pytest.fixture(scope="module")
def chaos_off_server(port_host, tmp_path_factory):
    """The port's server built as ``ref_server`` is, with chaos_enabled off."""
    s = Server(config=live_config(tmp_path_factory.mktemp("chaos-off"), chaos_enabled=False))
    s.start()
    yield s
    s.stop()


@pytest.mark.parametrize("method, path, params, body", REFUSALS,
                         ids=[f"{m} {p} {q or ''} {b or ''}" for m, p, q, b in REFUSALS])
def test_client_error_is_the_reference_s(ref_server, live_server, chaos_off_server, method, path,
                                         params, body):
    # the chaos routes refuse on a daemon with chaos off, on both packages
    port_server = chaos_off_server if path.startswith("/v1/chaos/") else live_server
    got = {}
    for name, cls, err, srv in (("ref", RefClient, RefClientError, ref_server),
                                ("port", Client, ClientError, port_server)):
        with pytest.raises(err) as ei:
            cls(f"http://127.0.0.1:{srv.port}", timeout=10)._req(method, path, params=params,
                                                                 body=body)
        got[name] = (ei.value.status, ei.value.body, str(ei.value))
    assert got["port"] == got["ref"]


def test_each_sdk_reads_the_other_s_server(ref_server, live_server):
    for cls in (RefClient, Client):
        for srv in (ref_server, live_server):
            c = cls(f"http://127.0.0.1:{srv.port}", timeout=10)
            assert c.healthz() == {"status": "ok", "version": srv.version}
            assert "cpu" in c.get_components()
            assert [s.component for s in c.get_health_states(components=["cpu"])] == ["cpu"]
            assert isinstance(c.get_prometheus_metrics(), str)
            assert c.get_remediation_policy()["policy"]["enforce_actions"] == []


def test_the_client_reuses_one_connection_and_reopens_a_closed_one(live_server):
    c = Client(f"http://127.0.0.1:{live_server.port}", timeout=10)
    c.healthz()
    conn = c._conn
    for _ in range(3):
        c.healthz()
    assert c._conn is conn
    conn.sock.shutdown(socket.SHUT_RDWR)  # as if the server closed it while idle
    assert c.healthz()["status"] == "ok"
    c.close()
    assert c._conn is None


def test_the_client_speaks_https_without_verifying_the_self_signed_cert(tmp_path):
    pytest.importorskip("cryptography")
    s = Server(config=live_config(tmp_path, tls=True))
    s.start()
    try:
        c = Client(s.base_url(), timeout=10)
        assert c.healthz()["status"] == "ok"
        assert c.get_machine_info().gpu_info is not None
    finally:
        s.stop()


def test_a_bad_base_url_is_refused():
    with pytest.raises(ValueError):
        Client("ftp://localhost:1")
