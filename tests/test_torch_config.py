"""Parity of the port's config, remediation policy, version and sd_notify
(gpud_tpu_torch/config.py, remediation/policy.py, version.py, sdnotify.py)
with gpud_tpu's: the same fields and defaults, the same validate()
messages word for word, the same policy updates, token-bucket decisions and
action mapping, the same version override and the same datagrams."""

import dataclasses
import importlib
import math
import os
import socket

import numpy as np
import pytest

import gpud_tpu.version as ref_version
import gpud_tpu_torch.version as port_version

from torch_daemon_parity import PKGS, PORT, REF, IDS
from torch_parity import ACTIONS

# the one field renamed by design (ROADMAP "Differences by design")
FIELD = {"expected_chip_count": "expected_gpu_count"}


def port_field(name: str) -> str:
    return FIELD.get(name, name)


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    return f.default_factory()


def test_module_constants_are_equal():
    names = [n for n in dir(REF.config) if n.isupper()]
    assert names and names == [n for n in dir(PORT.config) if n.isupper()]
    for n in names:
        assert getattr(REF.config, n) == getattr(PORT.config, n), n


def test_every_field_and_default_is_the_reference_s():
    ref = {f.name: _default(f) for f in dataclasses.fields(REF.config.Config)}
    port = {f.name: _default(f) for f in dataclasses.fields(PORT.config.Config)}
    assert [port_field(n) for n in ref] == list(port)
    for n, v in ref.items():
        assert port[port_field(n)] == v, n


# (field, value): the reference's tests/test_config_matrix.py cases, then one
# failing value per branch of validate() and the values at each bound
VALIDATE_CASES = [
    ("port", 0), ("port", 15132), ("port", 65535), ("port", 65536), ("port", -1),
    ("metrics_retention_seconds", 60), ("metrics_retention_seconds", 59),
    ("events_retention_seconds", 59), ("events_retention_seconds", 60),
    ("health_flap_threshold", 1), ("health_flap_threshold", 2),
    ("health_flap_window_seconds", 59), ("health_availability_window_seconds", 59),
    ("remediation_interval_seconds", 0), ("remediation_interval_seconds", 1),
    ("remediation_cooldown_seconds", -1), ("remediation_cooldown_seconds", 0),
    ("remediation_rate_capacity", 0), ("remediation_rate_refill_seconds", 0),
    ("remediation_max_reboots", 0), ("remediation_reboot_window_seconds", 59),
    ("remediation_escalation_threshold", 0), ("remediation_escalation_window_seconds", 59),
    ("predict_interval_seconds", 0.0), ("predict_threshold", 0.0),
    ("predict_threshold", 1.0), ("predict_threshold", 1.5),
    ("predict_hysteresis", -0.1), ("predict_hysteresis", 0.6),
    ("predict_arm_ticks", 0), ("predict_clear_ticks", 0),
    ("predict_window_seconds", 0.5), ("predict_history_limit", 0),
    ("predict_warn_cooldown_seconds", -1.0), ("predict_publish_interval_seconds", -1.0),
    ("predict_calibrate_interval_seconds", 0.0), ("predict_calibrate_min_history", 0),
    ("predict_calibrate_min_threshold", 0.0), ("predict_calibrate_min_threshold", 1.1),
    ("predict_calibrate_margin", 0.5), ("predict_calibrate_margin", -0.01),
    ("predict_calibrate_horizon_seconds", 0.5),
    ("fabric_sweep_interval_seconds", 0.0), ("fabric_sweep_latency_threshold_z", 0.0),
    ("fabric_sweep_ewma_alpha", 0.0), ("fabric_sweep_ewma_alpha", 1.0),
    ("fabric_sweep_warmup_sweeps", 0), ("fabric_sweep_retention_seconds", 59.0),
    ("chaos_max_campaign_seconds", 0), ("chaos_history_limit", 0),
    ("inject_rate_capacity", 0), ("inject_rate_refill_seconds", 0.0),
    ("storage_batch_flush_interval_seconds", 0.0), ("storage_batch_max_pending", 999),
    ("storage_batch_flush_threshold", 0), ("storage_batch_flush_threshold", 100_001),
    ("storage_batch_flush_threshold", 100_000),
    ("storage_batch_backpressure_seconds", -0.1), ("storage_wal_checkpoint_seconds", -1),
    ("storage_wal_checkpoint_seconds", 0),
    ("outbox_max_rows", 999), ("outbox_max_age_seconds", 59), ("outbox_replay_batch", 0),
    ("outbox_replay_interval_seconds", 0.0), ("session_circuit_failure_threshold", 0),
    ("session_circuit_open_seconds", 0.0),
    ("session_peers", ["http://a:1"]), ("session_peers", ["a:1"]), ("session_peers", [""]),
    ("session_peers", ["m-b=http://b:2|b:3"]),
    ("federation_replication_interval_seconds", 0.0),
    ("federation_probe_interval_seconds", 0.0), ("federation_fanout_timeout_seconds", 0.0),
    ("federation_dead_after_probes", 0), ("session_wire_keyframe_interval", 0),
    ("session_wire_compress_min_bytes", -1), ("outbox_redeliver_seconds", 0.0),
    ("outbox_replay_jitter_seconds", -1.0), ("scheduler_workers", 0),
    ("scheduler_watchdog_seconds", -1), ("scheduler_jitter_fraction", 0.51),
    ("scheduler_jitter_fraction", 0.5), ("scheduler_jitter_fraction", -0.01),
    ("poll_interval_seconds", 0), ("scrape_interval_seconds", 0),
    ("compact_period_seconds", -1), ("expected_chip_count", -1), ("expected_chip_count", 8),
    ("remediation_enforce_actions", ["reboot_system", "format_disk"]),
    ("remediation_enforce_actions", ["hardware_inspection"]),
    ("remediation_enforce_actions", ["retrigger_check", "set_healthy",
                                     "restart_runtime", "reboot_system"]),
]


@pytest.mark.parametrize("field, value", VALIDATE_CASES,
                         ids=[f"{f}={v}" for f, v in VALIDATE_CASES])
def test_validate_gives_the_reference_s_message(field, value):
    ref = REF.config.Config(**{field: value}).validate()
    port = PORT.config.Config(**{port_field(field): value}).validate()
    assert port == ref


def test_the_cases_reach_every_branch_of_validate():
    # validate() has 66 failing branches; the cases reach every one, the
    # session-peer branch with two specs and the enforce-action branch with
    # two lists, each with its own message: 69 messages in all
    msgs = {REF.config.Config(**{f: v}).validate() for f, v in VALIDATE_CASES}
    assert len(msgs - {None}) == 69


def test_default_config_validates_on_both():
    assert REF.config.default_config().validate() is None
    assert PORT.config.default_config().validate() is None


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_derived_paths_follow_data_dir(pkg, tmp_path):
    cfg = pkg.config.Config(data_dir=str(tmp_path))
    assert cfg.state_file() == str(tmp_path / "tpud.state")
    assert cfg.fifo_file() == str(tmp_path / "tpud.fifo")
    assert cfg.packages_dir() == str(tmp_path / "packages")
    assert cfg.target_version_file() == str(tmp_path / "target_version")
    assert cfg.resolved_plugin_specs_file() == str(tmp_path / "plugins.yaml")
    assert pkg.config.Config(db_in_memory=True).state_file() == ":memory:"
    assert pkg.config.Config(plugin_specs_file="/etc/tpud/p.yaml").resolved_plugin_specs_file() \
        == "/etc/tpud/p.yaml"


def test_resolve_data_dir_priority_is_the_reference_s(monkeypatch, tmp_path):
    monkeypatch.setenv("TPUD_DATA_DIR", str(tmp_path / "env"))
    for arg in (str(tmp_path / "arg"), ""):
        assert PORT.config.resolve_data_dir(arg) == REF.config.resolve_data_dir(arg)
    monkeypatch.delenv("TPUD_DATA_DIR")
    assert PORT.config.resolve_data_dir("") == REF.config.resolve_data_dir("")


def test_default_config_overrides_and_enrollment_env(monkeypatch):
    monkeypatch.setenv("TPUD_ENDPOINT", "https://cp.example")
    monkeypatch.setenv("TPUD_TOKEN", "t0k")
    kw = dict(port=0, tls=False, poll_interval_seconds=2, remediation_interval_seconds=2)
    ref, port = REF.config.default_config(**kw), PORT.config.default_config(**kw)
    assert dataclasses.asdict(port) == {port_field(k): v for k, v in dataclasses.asdict(ref).items()}
    assert port.endpoint == "https://cp.example" and port.token == "t0k"
    for pkg in PKGS:
        with pytest.raises(AttributeError, match="unknown config field: nope"):
            pkg.config.default_config(nope=1)


# -- remediation policy --------------------------------------------------------

def test_policy_vocabulary_is_the_reference_s():
    names = [n for n in dir(REF.policy) if n.isupper()]
    assert names == [n for n in dir(PORT.policy) if n.isupper()]
    for n in names:
        assert getattr(PORT.policy, n) == getattr(REF.policy, n), n


POLICY_UPDATES = [
    {"enforce_actions": ["reboot_system"], "cooldown_seconds": 5},
    {"enforce_actions": ["format_disk"]},
    {"enforce_actions": "reboot_system"},
    {"enforce_actions": [1, 2]},
    {"enforce_actions": ["set_healthy", "set_healthy", "retrigger_check"]},
    {"cooldown_seconds": float("nan")},
    {"cooldown_seconds": -1, "rate_capacity": 3},
    {"rate_capacity": 0, "rate_refill_seconds": 0.5, "max_reboots": "2"},
    {"reboot_window_seconds": 59, "escalation_threshold": 2,
     "escalation_window_seconds": 60},
    {"max_reboots": "x", "rate_capacity": 2.9},
    {"unknown_key": 1},
    [],
    "policy",
    {},
]


@pytest.mark.parametrize("update", POLICY_UPDATES, ids=[str(i) for i in range(len(POLICY_UPDATES))])
def test_policy_update_is_the_reference_s(update):
    ref, port = REF.policy.Policy(), PORT.policy.Policy()
    assert port.update(update) == ref.update(update)
    assert port.to_dict() == ref.to_dict()


@pytest.mark.parametrize("seed", range(4))
def test_token_bucket_decisions_are_the_reference_s(seed):
    rng = np.random.default_rng(seed)
    pr = REF.policy.Policy(rate_capacity=int(rng.integers(1, 5)),
                           rate_refill_seconds=float(rng.integers(5, 60)))
    pp = PORT.policy.Policy(rate_capacity=pr.rate_capacity,
                            rate_refill_seconds=pr.rate_refill_seconds)
    br, bp = REF.policy.TokenBucket(pr), PORT.policy.TokenBucket(pp)
    now = 1000.0
    for step in range(200):
        now += float(rng.exponential(8.0)) * (1 if step % 17 else -1)  # a clock step back too
        if step == 100:  # a runtime policy push applies on the next take
            pr.rate_capacity = pp.rate_capacity = 7
        assert bp.take(now) == br.take(now), step
        assert math.isclose(bp.available(now), br.available(now), rel_tol=0, abs_tol=0)


@pytest.mark.parametrize("action", [
    "IGNORE_NO_ACTION_REQUIRED", "PREDICTED_DEGRADATION", "CHECK_USER_APP_AND_TPU",
    "REBOOT_SYSTEM", "HARDWARE_INSPECTION", "NOT_AN_ACTION"])
@pytest.mark.parametrize("soft", [None, "restart_runtime"])
def test_map_suggested_action_is_the_reference_s(action, soft):
    assert PORT.policy.map_suggested_action(ACTIONS.get(action, action), soft) == \
        REF.policy.map_suggested_action(action, soft)


# -- version ---------------------------------------------------------------------

@pytest.mark.parametrize("override", [None, "9.9.9-test"])
def test_version_and_its_override(monkeypatch, override):
    if override is None:
        monkeypatch.delenv("TPUD_VERSION_OVERRIDE", raising=False)
    else:
        monkeypatch.setenv("TPUD_VERSION_OVERRIDE", override)
    try:
        assert importlib.reload(port_version).__version__ == \
            importlib.reload(ref_version).__version__ == (override or "0.1.0")
    finally:
        monkeypatch.undo()
        importlib.reload(port_version)
        importlib.reload(ref_version)


# -- sd_notify -------------------------------------------------------------------

def _notify_all(pkg):
    sd = pkg.sdnotify
    return [sd.ready(), sd.status("checks 22/22"), sd.stopping()]


def test_sd_notify_without_a_socket_is_a_no_op(monkeypatch):
    monkeypatch.delenv("NOTIFY_SOCKET", raising=False)
    assert _notify_all(PORT) == _notify_all(REF) == [False, False, False]


@pytest.mark.parametrize("abstract", [False, True], ids=["path", "abstract"])
def test_sd_notify_sends_the_reference_s_datagrams(monkeypatch, tmp_path, abstract):
    name = f"tpud-notify-test-{os.getpid()}" if abstract else str(tmp_path / "notify.sock")
    addr = "\0" + name if abstract else name
    with socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM) as srv:
        srv.bind(addr)
        srv.settimeout(5.0)
        monkeypatch.setenv("NOTIFY_SOCKET", "@" + name if abstract else name)
        got = {}
        for pkg in PKGS:
            assert _notify_all(pkg) == [True, True, True]
            got[pkg.name] = [srv.recv(256) for _ in range(3)]
    assert got["port"] == got["ref"] == [b"READY=1", b"STATUS=checks 22/22", b"STOPPING=1"]


def test_sd_notify_to_a_dead_socket_reports_failure(monkeypatch, tmp_path):
    monkeypatch.setenv("NOTIFY_SOCKET", str(tmp_path / "gone.sock"))
    assert _notify_all(PORT) == _notify_all(REF) == [False, False, False]
