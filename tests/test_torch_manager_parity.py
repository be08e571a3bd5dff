"""Parity and interop of the port's manager tier (gpud_tpu_torch/manager/)
with gpud_tpu's.

Parity: one recorded stream of delivery frames (made from a numpy seed:
transitions, remediation audits, fabric link records of both shapes,
predict scores of known and newer schemas, events with correlation ids;
batches, legacy single-record frames, redeliveries after a reconnect and a
delta desync) goes through each package's ``AgentHandle`` into its
``FleetRollupStore`` on the same clock, at 8 and at 3 shards. The journal
rows (``SELECT *``, ordered), the acks, and the rollup, fabric, predict,
agents, history and traces panes at a fixed ``now`` must be equal with
``==``; the fleet ``/metrics`` text, rendered in a fresh interpreter, must
be equal once its clocks are masked.

Interop: a port agent (``Session`` and ``SessionOutbox``) enrolls with a
reference ``ControlPlane`` (aiohttp), and a reference agent with a port
``ControlPlane``, over v1 and over v2; each run delivers every record and
leaves the journal a run within one package leaves, column for column but
``ingested`` (the manager's wall clock). Managers bind 127.0.0.1:0."""

import copy
import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

import gpud_tpu.manager.control_plane as ref_control_plane
import gpud_tpu.manager.exposition as ref_exposition
import gpud_tpu.manager.rollup as ref_rollup
import gpud_tpu.session.outbox as ref_outbox
import gpud_tpu.session.session as ref_session
import gpud_tpu.session.wire as ref_wire
import gpud_tpu.sqlite as ref_sqlite
import gpud_tpu.storage.writer as ref_writer

import gpud_tpu_torch.manager.control_plane as port_control_plane
import gpud_tpu_torch.manager.exposition as port_exposition
import gpud_tpu_torch.manager.rollup as port_rollup
import gpud_tpu_torch.session.outbox as port_outbox
import gpud_tpu_torch.session.session as port_session
import gpud_tpu_torch.session.wire as port_wire
import gpud_tpu_torch.sqlite as port_sqlite
import gpud_tpu_torch.storage.writer as port_writer

REF = types.SimpleNamespace(
    name="ref", control_plane=ref_control_plane, exposition=ref_exposition, rollup=ref_rollup,
    outbox=ref_outbox, session=ref_session, wire=ref_wire, sqlite=ref_sqlite, writer=ref_writer)
PORT = types.SimpleNamespace(
    name="port", control_plane=port_control_plane, exposition=port_exposition,
    rollup=port_rollup, outbox=port_outbox, session=port_session, wire=port_wire,
    sqlite=port_sqlite, writer=port_writer)
PKGS = {"ref": REF, "port": PORT}

from torch_manager_frames import (  # noqa: E402
    AGENTS,
    CID,
    NOW,
    SEED,
    T0,
    TABLE,
    delivery_frames,
    interleaved,
    record_stream,
)

def ingest_stream(P, shards, db_path):
    """The recorded frames through ``P``'s AgentHandle into its store:
    (the journal rows, the acks per agent, the panes at NOW, the store)."""
    db = P.sqlite.DB(str(db_path))
    writer = P.writer.BatchWriter(db)
    store = P.rollup.FleetRollupStore(db, writer, shard_count=shards)
    clock = [2000.0]
    handles, acks = {}, {a: [] for a in AGENTS}
    for agent, (conn, req_id, frame) in interleaved(delivery_frames(ref_wire)):
        h = handles.get((agent, conn))
        if h is None:
            h = handles[(agent, conn)] = P.control_plane.AgentHandle(agent, "v2-rev3")
            h.on_records = lambda aid, recs: store.ingest(aid, recs, now=clock[0])
        h.resolve(req_id, copy.deepcopy(frame))
        clock[0] += 0.25
        while not h.outbound.empty():
            item = h.outbound.get_nowait()
            acks[agent].append((conn, item["data"]["method"], item["data"]["seq"]))
    writer.flush()
    rows = db.query(f"SELECT * FROM {TABLE} ORDER BY agent, seq, dedupe_key")
    rollup = dict(store.fleet_rollup())
    panes = {
        "rollup": rollup,
        "fabric": store.fleet_fabric(since=T0 + 100.0, now=NOW),
        "fabric_all": store.fleet_fabric(now=NOW),
        "predict": store.fleet_predict(top=500, now=NOW),
        "agents": store.agents_page(0, 500),
        "agents_paged": [store.agents_page(o, 3) for o in (0, 3, 6)],
        "history": {a: store.history(a, 0.0, 1000) for a in AGENTS},
        "history_since": {a: store.history(a, T0 + 200.0, 5, 2) for a in AGENTS},
        "traces": store.traces(CID),
        "snapshots": {a: store.agent_snapshot(a) for a in AGENTS},
        "dedupe": {a: store.dedupe_snapshot(a) for a in AGENTS},
        "records": [store.records_total(), store.duplicates_total(), store.journal_count()],
    }
    return rows, acks, panes, (db, writer, store)


def run_stream(P, shards, tmp):
    rows, acks, panes, (db, writer, _store) = ingest_stream(P, shards, tmp / f"{P.name}-{shards}.db")
    writer.close()
    db.close()
    return rows, acks, panes


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("manager-parity")
    return {(name, shards): run_stream(P, shards, tmp)
            for name, P in PKGS.items() for shards in (8, 3)}


def test_the_recorded_stream_exercises_every_path():
    frames = delivery_frames(ref_wire)
    flat = [f for fs in frames.values() for _c, _r, f in fs]
    assert any("outbox_seq" in f for f in flat) and any("outbox_batch" in f for f in flat)
    assert max(c for fs in frames.values() for c, _r, _f in fs) > 0  # reconnects


@pytest.mark.parametrize("shards", [8, 3])
def test_the_journal_rows_are_the_reference_s(streams, shards):
    ref_rows, port_rows = streams[("ref", shards)][0], streams[("port", shards)][0]
    assert len(ref_rows) > 200
    assert port_rows == ref_rows


@pytest.mark.parametrize("shards", [8, 3])
def test_the_acks_are_the_reference_s(streams, shards):
    ref_acks, port_acks = streams[("ref", shards)][1], streams[("port", shards)][1]
    assert sum(len(v) for v in ref_acks.values()) > 20
    assert port_acks == ref_acks


@pytest.mark.parametrize("pane", ["rollup", "fabric", "fabric_all", "predict", "agents",
                                  "agents_paged", "history", "history_since", "traces",
                                  "snapshots", "dedupe", "records"])
@pytest.mark.parametrize("shards", [8, 3])
def test_each_pane_is_the_reference_s(streams, shards, pane):
    ref, port = streams[("ref", shards)][2][pane], streams[("port", shards)][2][pane]
    assert port == ref


def test_the_stream_hit_desyncs_duplicates_and_every_kind(streams):
    panes = streams[("port", 8)][2]
    roll = panes["rollup"]
    assert roll["duplicates_suppressed"] > 0
    assert set(roll["records_by_kind"]) == {"transition", "remediation_audit", "ici_link",
                                            "predict_score", "event"}
    assert panes["predict"]["unknown_schema_records"] > 0
    assert panes["traces"]["count"] >= 2
    # the shard count changes no pane but the store-local generation
    for pane in ("fabric", "predict", "agents", "history", "traces", "snapshots", "dedupe"):
        a, b = streams[("port", 8)][2][pane], streams[("port", 3)][2][pane]
        if pane in ("fabric", "predict"):
            a, b = dict(a, generation=0), dict(b, generation=0)
        assert a == b, pane


def test_a_rebuild_at_either_shard_count_is_the_live_view(tmp_path):
    for P in (REF, PORT):
        _rows, _acks, panes, (db, writer, _store) = ingest_stream(P, 8, tmp_path / f"{P.name}.db")
        writer.close()
        views = []
        for shards, parallel in ((8, False), (8, True), (3, True)):
            st = P.rollup.FleetRollupStore(db, None, shard_count=shards, rebuild_parallel=parallel)
            roll = dict(st.fleet_rollup())
            views.append((roll["records_total"], st.agents_page(0, 500)["agents"],
                          st.fleet_fabric(now=NOW)["degraded"],
                          st.fleet_predict(top=500, now=NOW)["top"]))
        db.close()
        live = (panes["rollup"]["records_total"], panes["agents"]["agents"],
                panes["fabric_all"]["degraded"], panes["predict"]["top"])
        assert views == [live] * 3, P.name


# -- the fleet /metrics text, each package's manager in a fresh interpreter -------------

METRICS_CODE = """
import json, sys, urllib.request
sys.path.insert(0, {tests!r})
import torch_manager_frames as fr
import {pkg}.cli  # what `manager serve` loads
from {pkg}.manager.control_plane import AgentHandle, ControlPlane
from {pkg}.session import wire
cp = ControlPlane()
cp.start()
handles = {{}}
for agent, (conn, req_id, frame) in fr.interleaved(fr.delivery_frames(wire)):
    h = handles.get((agent, conn))
    if h is None:
        h = handles[(agent, conn)] = AgentHandle(agent, "v2-rev3")
        cp._register(h)
    h.resolve(req_id, frame)
    assert cp.ingest_executor.flush(timeout=30)
assert cp.writer.flush()
with urllib.request.urlopen(cp.endpoint + "/metrics", timeout=30) as r:
    text = r.read().decode()
cp.stop()
print(json.dumps(text))
"""

_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")


def masked(text):
    """The exposition with its clocks masked: every sample of a family
    that measures seconds (durations, the manager's wall clock at ingest
    behind the lag gauges, start-up time), and of the scheduler's, the
    write-behind layer's and SQLite's families, whose counts follow the
    writer's 0.2 s flush timer."""
    out = []
    for row in text.splitlines():
        m = _SAMPLE.match(row)
        if m and ("_seconds" in m.group(1) or m.group(1).startswith(
                ("tpud_scheduler_", "tpud_storage_", "tpud_sqlite_"))):
            row = f"{m.group(1)}{m.group(2) or ''} <clock>"
        out.append(row)
    return out


def manager_metrics(pkg):
    code = METRICS_CODE.format(tests=str(Path(__file__).parent), pkg=pkg)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=str(Path(__file__).parent.parent))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


def test_the_fleet_metrics_text_is_the_reference_s():
    ref, port = masked(manager_metrics("gpud_tpu")), masked(manager_metrics("gpud_tpu_torch"))
    assert any(r.startswith('tpud_fleet_agent_transitions{agent="agent-0"}') for r in port)
    assert sum(r.startswith("tpud_fleet_shard_records{") for r in port) == 8
    assert port == ref


# -- interop: each package's agent against the other's manager -----------------------------

RECORDS = 40


def deliver(agent_pkg, manager_pkg, protocol, tmp):
    """One agent of ``agent_pkg`` (a Session replaying a SessionOutbox of
    RECORDS records on a fixed clock) enrolled with a ``manager_pkg``
    ControlPlane over ``protocol`` until the manager acked every record;
    the journal's rows without ``ingested``."""
    A, M = PKGS[agent_pkg], PKGS[manager_pkg]
    cp = M.control_plane.ControlPlane(data_dir=str(tmp / f"mgr-{agent_pkg}-{manager_pkg}"))
    cp.start()
    clock = [T0]
    db = A.sqlite.DB(":memory:")
    outbox = A.outbox.SessionOutbox(db, replay_batch=8, time_now_fn=lambda: clock[0])
    rng = np.random.default_rng(SEED + 1)
    for kind, key, body in record_stream(rng, 1)[:RECORDS]:
        clock[0] = body["ts"]
        outbox.publish(kind, body, dedupe_key=key)

    def dispatch(req):
        if req.get("method") == "outboxAck":
            return {"acked_seq": outbox.ack(int(req["seq"]))}
        return {"error": f"unknown method {req.get('method')!r}"}

    s = A.session.Session(
        endpoint=cp.endpoint, machine_id="interop-agent", token="t", machine_proof="p",
        dispatch_fn=dispatch, protocol=protocol,
        v2_target=f"127.0.0.1:{cp.grpc_port}" if protocol == "v2" else "")
    s.time_sleep_fn = lambda sec: s._stop.wait(min(sec, 0.02))
    s.start()
    try:
        deadline = time.monotonic() + 30
        while outbox.acked_seq < RECORDS:
            if time.monotonic() > deadline:
                raise AssertionError(f"acked {outbox.acked_seq} of {RECORDS} "
                                     f"({agent_pkg} agent, {manager_pkg} manager, {protocol})")
            if s.connected:
                outbox.replay_once(s)
            time.sleep(0.01)
        handle = cp.agent("interop-agent")
        transport = handle.transport
    finally:
        s.stop()
    assert cp.ingest_executor.flush(timeout=10)
    cp.writer.flush()
    rows = cp.db.query(f"SELECT agent, seq, ts, kind, dedupe_key, correlation_id, payload, "
                       f"shard FROM {TABLE} ORDER BY seq")
    cp.stop()
    db.close()
    return transport, rows


@pytest.mark.parametrize("protocol", ["v1", "v2"])
def test_each_package_s_agent_enrolls_with_the_other_s_manager(protocol, tmp_path):
    if protocol == "v2":
        pytest.importorskip("grpc")
    runs = {(a, m): deliver(a, m, protocol, tmp_path) for a, m in (
        ("port", "ref"), ("ref", "port"), ("ref", "ref"), ("port", "port"))}
    want = "v1" if protocol == "v1" else "v2-rev3"
    assert {t for t, _rows in runs.values()} == {want}
    for (a, m), (_t, rows) in runs.items():
        assert [r[1] for r in rows] == list(range(1, RECORDS + 1)), (a, m)  # no record lost
    # each cross run journals what a run within one package journals
    assert runs[("port", "ref")][1] == runs[("ref", "ref")][1]
    assert runs[("ref", "port")][1] == runs[("port", "port")][1]
    assert runs[("port", "port")][1] == runs[("ref", "ref")][1]


# -- ROADMAP C12: a full write-behind queue and the ack ---------------------------------


def test_a_full_writer_queue_drops_acked_records_in_the_reference_and_not_in_the_port(tmp_path):
    """The fleet journal's rows go through the shared ``BatchWriter``,
    whose queue is bounded; the handle acks once ``ingest`` returns. With
    no room and no drain, the reference's store lets the queue drop the
    tail of a batch and the agent is acked past it: those records are in
    no journal and the agent prunes them. The port's store waits for a
    drain and hands the rest over, so the ack covers only journaled rows."""
    journaled = {}
    for P in (REF, PORT):
        db = P.sqlite.DB(str(tmp_path / f"{P.name}.db"))
        # a queue of 10 ops, no wait for room, and no scheduled drain
        writer = P.writer.BatchWriter(db, max_pending=10, backpressure_seconds=0.0)
        store = P.rollup.FleetRollupStore(db, writer)
        h = P.control_plane.AgentHandle("burst", "v2-rev3")
        h.on_records = lambda aid, recs: store.ingest(aid, recs, now=2000.0)
        enc = P.wire.DeltaEncoder()
        h.resolve("outbox-batch-1-50", P.wire.build_batch([
            enc.encode_record(n, T0 + n, "event", f"k{n}", {"component": "cpu", "n": n})
            for n in range(1, 51)]))
        assert h.outbox_acked == 50
        writer.flush()
        journaled[P.name] = store.journal_count()
        writer.close()
        db.close()
    assert journaled == {"ref": 10, "port": 50}
