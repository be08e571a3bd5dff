"""Parity of the port's session dispatcher (gpud_tpu_torch/session/
dispatch.py) on its ``Daemon`` with the reference's on its ``Server``, both
on their mock accelerators, on the cases of the reference's
tests/test_dispatch.py and tests/test_dispatch_error_matrix.py.

Every ``_m_*`` method of the reference's ``Dispatcher`` is called on both
with the same request, its nouns mapped to the port's (tests/torch_parity.py:
component and catalog names; ``expected_chip_count`` and the ``ici`` section
of ``updateConfig`` are ``expected_gpu_count`` and ``nvlink``;
``injectFault`` names ``gpu_error_name``). Answers that depend only on the
request and the stores' contents must be equal after the mapping; answers
that carry clocks, host figures or check timings must have the same keys
and the same outcome. The reference's error matrix classifies every answer
of both packages the same way. Reboots and restarts are recorded, not
run."""

import base64
import os
import time

import pytest

import gpud_tpu.server.server as ref_server_mod
from gpud_tpu.config import default_config as ref_default_config
from gpud_tpu.session.dispatch import Dispatcher as RefDispatcher

from gpud_tpu_torch.config import default_config as port_default_config
from gpud_tpu_torch.daemon import Daemon
from gpud_tpu_torch.session.dispatch import Dispatcher as PortDispatcher

from tests.test_dispatch_error_matrix import MATRIX
from torch_parity import CATALOG_NAMES, COMPONENTS, nouns, stub_host_probes

WAIT = 30.0
ERR = {"ref": "accelerator-tpu-error-kmsg", "port": "accelerator-gpu-error-kmsg"}
CONFIG_KEYS = {"expected_chip_count": "expected_gpu_count", "ici": "nvlink",
               "tpu_error_name": "gpu_error_name", "chip_id": "gpu_id"}


class RefServer(ref_server_mod.Server):
    """The reference's ``Server``, started by its own code with no listener
    bound."""

    def _serve(self):
        self._started.set()

    def stop(self):
        super().stop()
        self.db_ro.close()
        self.db_rw.close()


def to_port(x):
    """A reference request, answer or name in the port's nouns."""
    if isinstance(x, dict):
        return {to_port(k): to_port(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port(v) for v in x]
    if isinstance(x, str):
        for a, b in list(COMPONENTS.items()) + list(CATALOG_NAMES.items()):
            x = x.replace(a, b)
        for a, b in CONFIG_KEYS.items():
            x = re.sub(rf"\b{a}\b", b, x)
        return nouns(x)
    return x


import re  # noqa: E402  (used by to_port)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    stub_host_probes(mp)
    mp.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "1")
    mp.setenv("TPUD_TPU_MOCK_ALL_SUCCESS", "1")
    built = {}
    calls = {"ref": [], "port": []}
    try:
        for name in ("ref", "port"):
            tmp = tmp_path_factory.mktemp(f"dispatch-{name}")
            kmsg = tmp / "kmsg"
            kmsg.touch()
            common = dict(data_dir=str(tmp / "data"), kmsg_path=str(kmsg),
                          components_disabled=["network-latency"])
            if name == "ref":
                d = RefServer(config=ref_default_config(tls=False, port=0, **common))
                disp = RefDispatcher(d)
            else:
                d = Daemon(port_default_config(**common))
                disp = PortDispatcher(d)
            d.start()
            assert d.scheduler.wait_first_runs(timeout=WAIT) is not None
            disp.reboot_fn = lambda n=name: calls[n].append("reboot")
            disp.exit_fn = lambda code, n=name: calls[n].append(("exit", code))
            built[name] = (d, disp)
        yield built, calls
    finally:
        for d, _ in built.values():
            d.stop()
        mp.undo()


def ask(pair, method, params=None, port_params=None):
    (built, _calls) = pair
    params = params or {}
    ref = built["ref"][1]({"method": method, **params})
    port = built["port"][1]({"method": method, **(port_params if port_params is not None
                                                   else to_port(params))})
    return ref, port


# (method, reference params) whose answers must be equal after the mapping
EXACT = [
    ("nope", {}),
    ("setHealthy", {"component": ERR["ref"]}),
    ("setHealthy", {"component": "ghost"}),
    ("triggerComponent", {"component": "cpu"}),
    ("triggerComponent", {"component": "ghost"}),
    ("deregisterComponent", {"component": "cpu"}),
    ("chaosRun", {"scenario": "x"}),
    ("chaosStatus", {}),
    ("outboxAck", {"seq": 0}),
    ("peerStatus", {}),
    ("bootstrap", {"script_base64": base64.b64encode(b"echo bootstrap-ok; exit 0").decode()}),
    ("bootstrap", {"script_base64": "!!!"}),
    ("updateConfig", {"configs": {"expected_chip_count": 4, "ici": {"flap_threshold": 5},
                                  "temperature": {"degraded_c": 80.0}}}),
    ("updateConfig", {"configs": {"temperature": 85}}),
    ("updateConfig", {"configs": {"ici": {"crc_delta_degraded": 777},
                                  "temperature": {"degraded_c": "hot"}}}),
    ("updateConfig", {"configs": {"ici": {"flap_threshold": -1, "scan_window": float("nan")}}}),
    ("updateConfig", {"configs": {"error_thresholds": {"tpu_thermal_trip": 3,
                                                       "no_such_error": 1}}}),
    ("updateConfig", {"configs": {"error_thresholds": {"tpu_thermal_trip": None}}}),
    ("updateConfig", {"configs": {"anomaly": {"score_degraded": 0.0, "min_samples": 5}}}),
    ("updateConfig", {"configs": {"nfs_groups": [{"dir": ""}, {"dir": "/x", "ttl_seconds": 1}]}}),
    ("updateToken", {"token": "tok-9"}),
    ("getToken", {}),
    ("packageStatus", {}),
    ("update", {"version": "9.9.9"}),
    ("kapMTLSStatus", {}),
    ("kapMTLSUpdateCredentials", {"version": "../evil"}),
    ("kapMTLSActivate", {"version": "never-installed"}),
    ("getPluginSpecs", {}),
    ("setPluginSpecs", {"specs": [{"name": "cpu", "steps": [{"name": "s", "script": "echo"}]}]}),
    ("reboot", {}),
    ("logout", {}),
    ("delete", {}),
]


@pytest.mark.parametrize("method,params", EXACT, ids=[f"{m}-{i}" for i, (m, _) in enumerate(EXACT)])
def test_the_answer_is_the_reference_s(pair, method, params):
    ref, port = ask(pair, method, params)
    # chaos answers name the shipped campaigns, which keep their names
    assert port == (ref if method.startswith("chaos") else to_port(ref))


# (method, reference params): answers with clocks, host figures or timings
SHAPED = [
    ("states", {}),
    ("states", {"components": ["cpu", ERR["ref"]]}),
    ("events", {"since": 0}),
    ("stateHistory", {}),
    ("metrics", {}),
    ("predictStatus", {}),
    ("predictCalibration", {}),
    ("fabricStatus", {}),
    ("remediationStatus", {}),
    ("remediationPolicy", {"policy": {"cooldown_seconds": 120}}),
    ("traces", {}),
    ("gossip", {}),
    ("diagnostic", {}),
    ("injectFault", {"kernel_message": "NVRM: Xid (PCI:0000:10:00): 13, test"}),
    ("outboxStatus", {}),
]


def shape(x):
    if isinstance(x, dict):
        return sorted(x)
    return type(x).__name__


@pytest.mark.parametrize("method,params", SHAPED,
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(SHAPED)])
def test_the_answer_has_the_reference_s_shape(pair, method, params):
    ref, port = ask(pair, method, params)
    assert shape(port) == shape(ref) and ("error" in port) == ("error" in ref)
    if method == "states":
        assert [s["component"] for s in port["states"]] == \
            [to_port(s["component"]) for s in ref["states"]]
    if method == "events":
        assert {e["component"] for e in port["events"]} == \
            {to_port(e["component"]) for e in ref["events"]}
    if method == "injectFault":
        assert (port["status"], port["writes"]) == (ref["status"], ref["writes"]) == ("ok", 1)
    if method == "outboxStatus":
        assert sorted(port["outbox"]) == sorted(ref["outbox"])
        assert sorted(port["circuit"]) == sorted(ref["circuit"])


def test_a_pushed_plugin_spec_persists_and_asks_for_a_restart(pair):
    built, calls = pair
    spec = {"specs": [{"name": "pushed-probe", "steps": [{"name": "s", "script": "echo ok"}]}]}
    ref, port = ask(pair, "setPluginSpecs", spec)
    try:
        assert port == ref == {"status": "ok", "restarting": True}
        for name in ("ref", "port"):
            d = built[name][0]
            with open(d.config.resolved_plugin_specs_file(), encoding="utf-8") as f:
                assert "pushed-probe" in f.read()
        deadline = time.monotonic() + 5
        while not all(("exit", 245) in calls[n] for n in calls) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert ("exit", 245) in calls["port"] and ("exit", 245) in calls["ref"]
    finally:
        for name in ("ref", "port"):
            try:
                os.unlink(built[name][0].config.resolved_plugin_specs_file())
            except OSError:
                pass


def test_the_methods_are_the_reference_s(pair):
    built, _ = pair
    methods = {n: sorted(m for m in dir(built[n][1]) if m.startswith("_m_")) for n in built}
    assert methods["port"] == methods["ref"]


@pytest.mark.parametrize("method,params,expect", MATRIX,
                         ids=[f"{m}-{i}" for i, (m, _, _) in enumerate(MATRIX)])
def test_the_error_matrix_classifies_as_the_reference(pair, method, params, expect):
    ref, port = ask(pair, method, params)
    assert isinstance(port, dict)
    assert bool(port.get("error")) == bool(ref.get("error")), (ref, port)
    if method.startswith("chaos"):
        # both run chaos and no campaign has run: the same answer, no id or
        # clock in it
        assert port == ref
    if expect == "error":
        assert port.get("error")
    elif expect == "ok":
        assert not port.get("error")


@pytest.mark.parametrize("bad", [None, 42, ["states"], {"m": 1}, "", "no-such-method"])
def test_a_malformed_method_errors_as_the_reference(pair, bad):
    built, _ = pair
    ref, port = built["ref"][1]({"method": bad}), built["port"][1]({"method": bad})
    assert port == ref and port.get("error")
    assert built["port"][1]({}) == built["ref"][1]({})
    assert built["port"][1]("x") == built["ref"][1]("x") == {"error": "request must be an object"}
