"""The daemon's core, composed as ``chip_smoke.py``'s daemon phase composes it
(gpud_tpu_torch/daemon.py) on the mock GPUs, against the reference's own
``Server`` on its TPU mock, built and started by its own code with no listener
bound and the planes the port lacks (predict, fabric, outbox, chaos, update)
switched off.

Both run the checks as scheduler jobs over one state DB and one shared
writer; the same fault (Xid 79 on the port, its analog ``tpu_chip_lost`` on
the reference) goes through kmsg, the error check, the health ledger and the
remediation engine, then set-healthy, then a restart. The transitions, the
audit rows and the restart's zero new transitions are held against each
other, with nouns mapped through tests/torch_parity.py. Waits are events
with a bound; nothing sleeps, and the outside probes are stubbed."""

import threading

import pytest

import gpud_tpu.components.tpu.runtime as ref_runtime
import gpud_tpu_torch.components.gpu.runtime as port_runtime
from gpud_tpu import config as ref_config
from gpud_tpu.components.tpu import catalog as ref_catalog
from gpud_tpu.fault_injector import Injector as RefInjector
from gpud_tpu.fault_injector import Request as RefRequest
from gpud_tpu.server.server import Server as RefServer

from gpud_tpu_torch import config as port_config
from gpud_tpu_torch.daemon import Daemon
from gpud_tpu_torch.fault_injector import Injector, Request

from torch_daemon_parity import DAEMON_TABLES, schema
from torch_fakes import no_binary
from torch_parity import COMPONENTS, nouns, stub_host_probes
from torch_xid_corpus import ORGANIC

WAIT = 30.0
# the NVIDIA kernel module's Xid 79 line for GPU 0 of the mock (PCI bus 0x10 + N)
XID79 = ORGANIC["gpu_fallen_off_bus"][0].replace("PCI:0000:18:00", "PCI:0000:10:00")
NOUNS = {"tpu_chip_lost": "gpu_fallen_off_bus"}  # tests/test_torch_xid_catalog.py's analog
ERR = {"ref": "accelerator-tpu-error-kmsg", "port": "accelerator-gpu-error-kmsg"}
FAST = dict(poll_interval_seconds=2, remediation_interval_seconds=2, scrape_interval_seconds=2)


# the planes of the reference's server that the port has not ported yet
UNPORTED_PLANES = dict(predict_enabled=False, fabric_sweep_enabled=False, outbox_enabled=False,
                       chaos_enabled=False, enable_auto_update=False)


class RefDaemon(RefServer):
    """The reference's own ``Server`` on its TPU mock, built and started by
    its own code, with the planes the port lacks switched off in the config
    and the parts that reach outside the process stubbed: the HTTP listener
    (no socket is bound), the control-plane session, the token fifo and the
    package manager."""

    def __init__(self, cfg):
        super().__init__(config=cfg)
        self.kmsg_path = self._kmsg_path
        self.package_manager.start = lambda: None

    def _serve(self):
        self._started.set()

    def _maybe_start_session(self):
        pass

    def _start_token_fifo(self):
        pass

    def stop(self):
        super().stop()
        self.db_ro.close()
        self.db_rw.close()


@pytest.fixture(autouse=True)
def no_outside_probes(monkeypatch):
    stub_host_probes(monkeypatch)
    monkeypatch.setattr(ref_runtime, "run_command", no_binary)
    monkeypatch.setattr(port_runtime, "run_command", no_binary)
    monkeypatch.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "1")
    monkeypatch.setenv("TPUD_TPU_MOCK_ALL_SUCCESS", "1")


def build(name, workdir):
    workdir.mkdir(exist_ok=True)
    kmsg = workdir / "kmsg"
    kmsg.touch()
    if name == "port":
        return Daemon(port_config.default_config(data_dir=str(workdir), kmsg_path=str(kmsg), **FAST))
    return RefDaemon(ref_config.default_config(data_dir=str(workdir), kmsg_path=str(kmsg), tls=False,
                                               port=0, **FAST, **UNPORTED_PLANES))


def inject(name, d):
    if name == "port":
        return Injector(kmsg_path=d.kmsg_path).inject(Request(kernel_message=XID79))
    line = ref_catalog.injection_line("tpu_chip_lost", 0)
    return RefInjector(kmsg_path=d.kmsg_path).inject(RefRequest(kernel_message=line))


class Hooks:
    """Events set by the ledger's and the audit store's observers."""

    def __init__(self, d, component):
        self.transitions = []
        self.audits = []
        self.tx = threading.Event()
        self.audit = threading.Event()

        def on_tx(comp, frm, to, ts, reason):
            self.transitions.append((comp, frm, to))
            if comp == component:
                self.tx.set()

        def on_audit(row):
            if row["component"] == component:
                self.audits.append(row)
                self.audit.set()

        d.health_ledger.on_transition = on_tx
        d.remediation.audit.on_record = on_audit

    def wait_tx(self):
        assert self.tx.wait(WAIT), "no transition"
        self.tx.clear()


def drive(name, workdir):
    comp = ERR[name]
    d = build(name, workdir)
    refused = []
    d.remediation.executors.reboot_fn = lambda: refused.append("reboot") or "refused"
    d.remediation.executors.run_command_fn = lambda *a, **k: refused.append(a)
    hooks = Hooks(d, comp)
    try:
        d.start()
        assert d.scheduler.wait_first_runs(timeout=WAIT) is not None
        jobs = d.scheduler.job_names()
        assert inject(name, d).ok
        hooks.wait_tx()
        d.remediation.poke()  # the scan now, not at its next 2 s tick
        assert hooks.audit.wait(WAIT), "no audit row"
        d.registry.get(comp).set_healthy()
        hooks.wait_tx()
        d.storage_writer.flush()
        transitions = [(t["component"], t["from"], t["to"], t["reason"])
                       for t in d.health_ledger.history(component=comp)]
        audit = [{k: r[k] for k in ("component", "action", "suggested", "trigger_health",
                                    "trigger_reason", "decision", "outcome", "detail")}
                 for r in d.remediation.audit.read(component=comp)]
        total = len(d.health_ledger.history())
        tables = schema(d.db_rw)
    finally:
        d.stop()
    # the restart: a fresh daemon over the same state DB
    d2 = build(name, workdir)
    try:
        d2.start()
        assert d2.scheduler.wait_first_runs(timeout=WAIT) is not None
        d2.storage_writer.flush()
        after = len(d2.health_ledger.history())
        after_comp = len(d2.health_ledger.history(component=comp))
        state = d2.registry.get(comp).last_health_states()[0].health
    finally:
        d2.stop()
    return {
        "registered": len(d.registry.all()),
        "component_jobs": sorted(j for j in jobs if j.startswith("component:")),
        "transitions": transitions,
        "audit": audit,
        "refused_calls": refused,
        "restart_new_transitions": after - total,
        "restart_component_transitions": after_comp,
        "state_after_restart": state,
        "schema": tables,
    }


def noun(s: str) -> str:
    """A reference name or text in the port's nouns."""
    for a, b in list(COMPONENTS.items()) + list(NOUNS.items()):
        s = s.replace(a, b)
    return nouns(s)


def port_view(ref: dict) -> dict:
    """The reference's result in the port's nouns."""
    out = dict(ref)
    out["component_jobs"] = sorted(noun(j) for j in ref["component_jobs"])
    out["transitions"] = [tuple(noun(x) for x in t) for t in ref["transitions"]]
    out["audit"] = [{k: noun(v) for k, v in r.items()} for r in ref["audit"]]
    return out


def test_the_daemon_slice_is_the_reference_s(tmp_path):
    got = {name: drive(name, tmp_path / name) for name in ("ref", "port")}
    port, ref = got["port"], port_view(got["ref"])
    assert port["registered"] == ref["registered"] == 22
    assert port["component_jobs"] == ref["component_jobs"]
    assert port["transitions"] == ref["transitions"]
    assert [(c, f, t) for c, f, t, _ in port["transitions"]] == [
        (ERR["port"], "Unhealthy", "Healthy"), (ERR["port"], "Healthy", "Unhealthy")]
    # the trigger reason names the entry; the rest of the row is the same
    assert port["audit"] == ref["audit"]
    assert [(r["action"], r["decision"], r["outcome"]) for r in port["audit"]] == [
        ("reboot_system", "dry_run", "dry_run")]
    assert port["refused_calls"] == ref["refused_calls"] == []
    assert port["restart_new_transitions"] == ref["restart_new_transitions"] == 0
    assert port["restart_component_transitions"] == 2
    assert port["state_after_restart"] == ref["state_after_restart"] == "Healthy"
    # every table and index of the state DB, the slice's four tables among them
    assert port["schema"] == ref["schema"]
    assert set(DAEMON_TABLES) <= set(port["schema"])


def test_the_daemon_reports_an_invalid_config_as_the_reference(tmp_path):
    bad = dict(data_dir=str(tmp_path), scheduler_workers=0)
    with pytest.raises(ValueError, match="scheduler workers must be >= 1"):
        Daemon(port_config.default_config(**bad))
    assert ref_config.default_config(**bad).validate() == "scheduler workers must be >= 1"


WRITER_USERS = ("event_store", "health_ledger", "metrics_store")


def test_the_daemon_registers_the_reference_s_jobs(tmp_path):
    """The port's jobs are the ones the reference's ``Server.start``
    registers, and the same stores share the one writer."""
    got = {}
    for name in ("ref", "port"):
        d = build(name, tmp_path / name)
        try:
            d.start()
            d.start()  # idempotent
            assert d.scheduler.wait_first_runs(timeout=WAIT) is not None
            jobs = d.scheduler.job_names()
            assert len(jobs) == len(set(jobs))
            got[name] = {
                "jobs": sorted(jobs),
                "writer_users": [u for u in WRITER_USERS
                                 if getattr(d, u).writer is d.storage_writer],
                "audit_writer": d.remediation.audit.writer is d.storage_writer,
            }
        finally:
            d.stop()
    ref = dict(got["ref"], jobs=sorted(noun(j) for j in got["ref"]["jobs"]))
    assert got["port"] == ref
    assert {"retention-purge", "storage-writer-flush", "wal-checkpoint", "remediation-scan",
            "metrics-syncer", "self-metrics-recorder"} <= set(got["port"]["jobs"])
    assert got["port"]["writer_users"] == list(WRITER_USERS) and got["port"]["audit_writer"]
