"""The daemon's core and the planes it wires in, composed as ``chip_smoke.py``'s
daemon phase composes them (gpud_tpu_torch/daemon.py) on the mock GPUs, against
the reference's own ``Server`` on its TPU mock, built and started by its own
code with no listener bound and the planes the port lacks (chaos, update)
switched off.

Both run the checks as scheduler jobs over one state DB and one shared
writer; the same fault (Xid 79 on the port, its analog ``tpu_chip_lost`` on
the reference) goes through kmsg, the error check, the health ledger and the
remediation engine, then two predict ticks, then set-healthy, then a restart.
The transitions, the audit rows (the reactive one and the predicted one), the
predict scores, the fabric sweeps, the outbox journal by kind, its replay
through the wire codec and the restart's zero new transitions are held
against each other, with nouns mapped through tests/torch_parity.py. The
planes' jobs are registered at their cadence of an hour, and the test runs
their ticks itself (``tick_once``, ``sweep_once``, ``calibrate_now``,
``replay_once``), so their records do not hang on the scheduler's timing.
Waits are events with a bound; nothing sleeps, and the outside probes are
stubbed."""

import threading

import pytest

import gpud_tpu.components.tpu.runtime as ref_runtime
import gpud_tpu.kmsg.watcher as ref_watcher
import gpud_tpu.session.wire as ref_wire
import gpud_tpu_torch.components.gpu.runtime as port_runtime
import gpud_tpu_torch.session.wire as port_wire
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
# the planes' jobs stay registered; the test runs their ticks itself
PLANES_BY_HAND = dict(predict_interval_seconds=3600, predict_calibrate_interval_seconds=3600,
                      fabric_sweep_interval_seconds=3600, outbox_replay_interval_seconds=3600)
PLANE_JOBS = {"session-outbox-replay", "predict-scan", "predict-calibrate", "fabric-sweep"}
SWEEPS = 3


# the planes of the reference's server that the port has not ported yet
UNPORTED_PLANES = dict(chaos_enabled=False, enable_auto_update=False)


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


@pytest.fixture()
def ref_follows(monkeypatch):
    """Set once the reference's kmsg reader follows the file. Its watcher
    opens the file and seeks to the end on the reader thread, and asks for
    the file's inotify watch right after; a line written before that seek is
    skipped (ROADMAP C6). The port seeks in ``start()``, so its daemon needs
    no such wait."""
    follows = threading.Event()
    create = ref_watcher._InotifyWatch.create
    monkeypatch.setattr(ref_watcher._InotifyWatch, "create",
                        lambda path, *a: (follows.set(), create(path, *a))[1])
    return follows


def build(name, workdir):
    workdir.mkdir(exist_ok=True)
    kmsg = workdir / "kmsg"
    kmsg.touch()
    if name == "port":
        return Daemon(port_config.default_config(data_dir=str(workdir), kmsg_path=str(kmsg),
                                                 **FAST, **PLANES_BY_HAND))
    return RefDaemon(ref_config.default_config(data_dir=str(workdir), kmsg_path=str(kmsg), tls=False,
                                               port=0, **FAST, **PLANES_BY_HAND, **UNPORTED_PLANES))


def inject(name, d):
    if name == "port":
        return Injector(kmsg_path=d.kmsg_path).inject(Request(kernel_message=XID79))
    line = ref_catalog.injection_line("tpu_chip_lost", 0)
    return RefInjector(kmsg_path=d.kmsg_path).inject(RefRequest(kernel_message=line))


class Hooks:
    """Events set by the ledger's and the audit store's observers, and counts
    of what every producer of the outbox handed it. Each observer calls the
    one the daemon wired (the outbox's) first."""

    def __init__(self, d, component):
        self.transitions = []
        self.audits = []
        self.produced = {"event": 0, "transition": 0, "remediation_audit": 0,
                         "predict_score": 0, "ici_link": 0}
        self.tx = threading.Event()
        self.audit = threading.Event()

        def chain(kind, prev, then=None):
            def hook(*a):
                prev(*a)
                self.produced[kind] += 1
                if then is not None:
                    then(*a)
            return hook

        def on_tx(comp, frm, to, ts, reason):
            self.transitions.append((comp, frm, to))
            if comp == component:
                self.tx.set()

        def on_audit(row):
            if row["component"] == component:
                self.audits.append(row)
                self.audit.set()

        d.event_store.on_insert = chain("event", d.event_store.on_insert)
        d.health_ledger.on_transition = chain("transition", d.health_ledger.on_transition, on_tx)
        d.remediation.audit.on_record = chain("remediation_audit", d.remediation.audit.on_record,
                                              on_audit)
        d.predictor.on_publish = chain("predict_score", d.predictor.on_publish)
        d.fabric.on_publish = chain("ici_link", d.fabric.on_publish)

    def wait_tx(self):
        assert self.tx.wait(WAIT), "no transition"
        self.tx.clear()


class CaptureSession:
    """A connected session with no socket: ``send`` keeps the frame."""

    connected = True
    auth_failed = False

    def __init__(self):
        self.frames = []

    def send(self, frame):
        self.frames.append(frame)
        return True


def replay(d, wire):
    """One replay into a capture session, the frame through the wire codec
    and a fresh delta decoder; returns (records sent, decoded records)."""
    session = CaptureSession()
    sent = d.outbox.replay_once(session)
    decoder = wire.DeltaDecoder()
    decoded = []
    for frame in session.frames:
        batch = wire.parse_batch(wire.decode_payload(wire.encode_payload(frame.data)))
        decoded += [decoder.decode_record(r) for r in batch["records"]]
    return sent, decoded


def drive(name, workdir, ref_follows):
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
        d.fabric.sweep_once()
        if name == "ref":
            assert ref_follows.wait(WAIT), "the kmsg reader never followed the file"
        assert inject(name, d).ok
        hooks.wait_tx()
        d.remediation.poke()  # the scan now, not at its next 2 s tick
        assert hooks.audit.wait(WAIT), "no audit row"
        scores = [d.predictor.tick_once() for _ in range(2)]  # arms on the error check
        d.registry.get(comp).set_healthy()
        hooks.wait_tx()
        for _ in range(SWEEPS - 1):
            d.fabric.sweep_once()
        calibrated = d.predictor.calibrate_now()
        d.storage_writer.flush()
        transitions = [(t["component"], t["from"], t["to"], t["reason"])
                       for t in d.health_ledger.history(component=comp)]
        audit = [{k: r[k] for k in ("component", "action", "suggested", "trigger_health",
                                    "trigger_reason", "decision", "outcome", "detail")}
                 for r in d.remediation.audit.read(component=comp)]
        total = len(d.health_ledger.history())
        audit_total = len(d.remediation.audit.read())
        journal = d.outbox.pending(after=0)
        sent, decoded = replay(d, port_wire if name == "port" else ref_wire)
        d.outbox.ack(d.outbox.last_seq)
        backlog = d.outbox.backlog()
        fabric = (d.fabric.status(), d.fabric.store.row_count())
        tables = schema(d.db_rw)
    finally:
        d.stop()
    # the restart: a fresh daemon over the same state DB
    d2 = build(name, workdir)
    try:
        watermarks = (d2.outbox.last_seq, d2.outbox.acked_seq)
        d2.start()
        assert d2.scheduler.wait_first_runs(timeout=WAIT) is not None
        d2.storage_writer.flush()
        after = len(d2.health_ledger.history())
        after_comp = len(d2.health_ledger.history(component=comp))
        state = d2.registry.get(comp).last_health_states()[0].health
    finally:
        d2.stop()
    kinds = {}
    for row in journal:
        kinds[row[2]] = kinds.get(row[2], 0) + 1
    return {
        "registered": len(d.registry.all()),
        "component_jobs": sorted(j for j in jobs if j.startswith("component:")),
        "plane_jobs": sorted(PLANE_JOBS & set(jobs)),
        "transitions": transitions,
        "audit": audit,
        "scores": scores,
        "calibrated": calibrated,
        "refused_calls": refused,
        "journal_kinds": kinds,
        "produced": {k: n for k, n in hooks.produced.items() if n},
        "transitions_total": total,
        "audit_total": audit_total,
        "journal_seqs": [row[0] for row in journal],
        "replayed": sent,
        "replay_equals_journal": [list(r) for r in decoded] == [list(r) for r in journal],
        "backlog_after_ack": backlog,
        "watermarks_after_restart": watermarks,
        "fabric_sweeps": fabric[0]["sweeps"],
        "fabric_published": fabric[0]["published"],
        "fabric_rows_per_sweep": fabric[1] / SWEEPS,
        "fabric_links": fabric[0]["links"],
        "fabric_source": fabric[0]["mesh"]["source"],
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
    out["scores"] = [{noun(k): v for k, v in tick.items()} for tick in ref["scores"]]
    return out


# what differs by design: the fabric's links (a 2 x 4 torus of eight TPU
# chips, 12 links, against eight GPUs' NVLink ports, 144) and their source
FABRIC = ("fabric_rows_per_sweep", "fabric_links", "fabric_source")


def test_the_daemon_slice_is_the_reference_s(tmp_path, ref_follows):
    got = {name: drive(name, tmp_path / name, ref_follows) for name in ("ref", "port")}
    port, ref = got["port"], port_view(got["ref"])
    assert port["registered"] == ref["registered"] == 22
    assert port["component_jobs"] == ref["component_jobs"]
    assert port["plane_jobs"] == ref["plane_jobs"] == sorted(PLANE_JOBS)
    assert port["transitions"] == ref["transitions"]
    assert [(c, f, t) for c, f, t, _ in port["transitions"]] == [
        (ERR["port"], "Unhealthy", "Healthy"), (ERR["port"], "Healthy", "Unhealthy")]
    # the trigger reason names the entry; the rest of the row is the same.
    # Newest first: the predicted row of the second predict tick, then the
    # reactive one; predicted rows are dry runs and run nothing
    assert port["audit"] == ref["audit"]
    assert [(r["action"], r["decision"], r["outcome"]) for r in port["audit"]] == [
        ("predicted_warning", "dry_run", "dry_run"), ("reboot_system", "dry_run", "dry_run")]
    assert port["scores"] == ref["scores"]
    assert all(0.0 <= v <= 1.0 for tick in port["scores"] for v in tick.values())
    assert port["scores"][1][ERR["port"]] >= 0.6
    assert port["calibrated"] == ref["calibrated"]
    assert port["refused_calls"] == ref["refused_calls"] == []
    # the outbox holds one record per producer record, by kind, seqs 1..N,
    # and one replay through the wire codec gives back the journal
    assert port["journal_kinds"] == ref["journal_kinds"] == port["produced"] == ref["produced"]
    assert port["journal_kinds"]["transition"] == port["transitions_total"]
    assert port["journal_kinds"]["remediation_audit"] == port["audit_total"]
    n = len(port["journal_seqs"])
    assert port["journal_seqs"] == list(range(1, n + 1))
    assert port["replayed"] == n and port["replay_equals_journal"] and ref["replay_equals_journal"]
    assert port["backlog_after_ack"] == ref["backlog_after_ack"] == 0
    assert port["watermarks_after_restart"] == (n, n)
    assert ref["watermarks_after_restart"] == (len(ref["journal_seqs"]),) * 2
    # a healthy fabric: every sweep recorded every link and published nothing
    assert port["fabric_sweeps"] == ref["fabric_sweeps"] == SWEEPS
    assert port["fabric_published"] == ref["fabric_published"] == 0
    assert (port["fabric_rows_per_sweep"], port["fabric_links"], port["fabric_source"]) == (
        144, 144, "nvml")
    assert port["restart_new_transitions"] == ref["restart_new_transitions"] == 0
    assert port["restart_component_transitions"] == 2
    assert port["state_after_restart"] == ref["state_after_restart"] == "Healthy"
    # every table and index of the state DB, the slice's tables among them
    assert port["schema"] == ref["schema"]
    assert set(DAEMON_TABLES) <= set(port["schema"])
    assert {k: v for k, v in port.items() if k not in FABRIC} == \
        {k: v for k, v in ref.items() if k not in FABRIC}


def test_the_daemon_reports_an_invalid_config_as_the_reference(tmp_path):
    bad = dict(data_dir=str(tmp_path), scheduler_workers=0)
    with pytest.raises(ValueError, match="scheduler workers must be >= 1"):
        Daemon(port_config.default_config(**bad))
    assert ref_config.default_config(**bad).validate() == "scheduler workers must be >= 1"


WRITER_USERS = {
    "event_store": lambda d: d.event_store,
    "health_ledger": lambda d: d.health_ledger,
    "metrics_store": lambda d: d.metrics_store,
    "outbox": lambda d: d.outbox,
    "fabric": lambda d: d.fabric.store,
}


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
                "writer_users": [u for u, get in WRITER_USERS.items()
                                 if get(d).writer is d.storage_writer],
                "retention": [t for t, _ in d._retention_targets],
                "predictor_attached": (d.predictor.registry is d.registry,
                                       d.predictor.fabric is d.fabric),
                "audit_writer": d.remediation.audit.writer is d.storage_writer,
            }
        finally:
            d.stop()
    ref = dict(got["ref"], jobs=sorted(noun(j) for j in got["ref"]["jobs"]))
    assert got["port"] == ref
    assert {"retention-purge", "storage-writer-flush", "wal-checkpoint", "remediation-scan",
            "metrics-syncer", "self-metrics-recorder"} | PLANE_JOBS <= set(got["port"]["jobs"])
    assert got["port"]["writer_users"] == list(WRITER_USERS) and got["port"]["audit_writer"]
    assert got["port"]["retention"] == ["events", "health", "remediation-audit",
                                        "session-outbox", "fabric-matrix"]
    assert got["port"]["predictor_attached"] == (True, True)

