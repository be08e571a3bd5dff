"""Parity and interop of the port's manager federation
(gpud_tpu_torch/manager/peers.py, federation.py) with gpud_tpu's.

Parity, on the same inputs made from a numpy seed: rendezvous owners and
ranks for 10,000 agent ids at ring sizes 1 to 5; ``PeerSet``'s health block
and cohort counts under one probe sequence; the five merges on the same
recorded panes; the shipper's frames for one journal, byte for byte; the
replica's rows for the same frames; the writer's bounded queue under
the replica (ROADMAP C15: the reference drops the tail it acks, the port
waits for a drain); and a replication stream that reaches its successor
before the successor attaches its peers (ROADMAP C10: the reference's
successor acks the journal into its own cohort, the port's shipper waits
until the successor is federated).

Interop: a port manager peered with a reference manager, both ways round,
over v1 and over v2. Each replica equals its source journal in every
column, and each manager's ``/v1/fleet/peers`` and federated panes equal
those of a reference manager in its place (an all-reference pair on the
same inputs), once ports, milliseconds and clocks are masked. Both CLIs
list the same ``manager serve`` flags and print the same ``fleet peers``
and ``fleet agents --peer`` answers with the same exit codes. Managers
bind 127.0.0.1:0; every wait has a bound."""

import json
import sys
import time
import types

import numpy as np
import pytest

import gpud_tpu.manager.control_plane as ref_control_plane
import gpud_tpu.manager.federation as ref_federation
import gpud_tpu.manager.peers as ref_peers
import gpud_tpu.manager.rollup as ref_rollup
import gpud_tpu.session.wire as ref_wire
import gpud_tpu.sqlite as ref_sqlite
import gpud_tpu.storage.writer as ref_writer

import gpud_tpu_torch.manager.control_plane as port_control_plane
import gpud_tpu_torch.manager.federation as port_federation
import gpud_tpu_torch.manager.peers as port_peers
import gpud_tpu_torch.manager.rollup as port_rollup
import gpud_tpu_torch.session.wire as port_wire
import gpud_tpu_torch.sqlite as port_sqlite
import gpud_tpu_torch.storage.writer as port_writer

# both CLIs bind the shared "tpud" logger once per process: port_host binds
# it to pytest's stream first where this module is the first to bind it, so
# the managers' later records never go to a closed capture stream (C10)
from torch_live import port_host  # noqa: F401
from torch_manager_frames import CID, NOW, TABLE, record_stream

REF = types.SimpleNamespace(
    name="ref", control_plane=ref_control_plane, federation=ref_federation, peers=ref_peers,
    rollup=ref_rollup, wire=ref_wire, sqlite=ref_sqlite, writer=ref_writer)
PORT = types.SimpleNamespace(
    name="port", control_plane=port_control_plane, federation=port_federation,
    peers=port_peers, rollup=port_rollup, wire=port_wire, sqlite=port_sqlite,
    writer=port_writer)
PKGS = {"ref": REF, "port": PORT}

SEED = 1313
WAIT = 60.0
PEER_IDS = ["m-a", "m-b", "m-c", "mgr-east-1", "mgr-west-2"]
AGENTS = [f"agent-{i}" for i in range(8)]
JOURNAL_COLUMNS = ("rowid, agent, seq, ts, ingested, kind, dedupe_key, correlation_id, "
                   "payload, shard")


def _agent_ids(n=10_000):
    rng = np.random.default_rng(SEED)
    ids = [f"gpu-node-{i}" for i in range(n // 2)]
    alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789-_.:"))
    while len(ids) < n:
        ids.append("".join(rng.choice(alphabet, size=int(rng.integers(1, 40)))))
    return ids


def _records(agent_index, rng):
    return [(seq, body["ts"], kind, key, body)
            for seq, (kind, key, body) in enumerate(record_stream(rng, agent_index), start=1)]


def _cohort_records():
    rng = np.random.default_rng(SEED)
    return {agent: _records(i, rng) for i, agent in enumerate(AGENTS)}


def _wait(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


# -- rendezvous routing --------------------------------------------------------------

@pytest.mark.parametrize("ring_size", [1, 2, 3, 4, 5])
def test_rendezvous_owner_and_rank_are_the_references(ring_size):
    ring = PEER_IDS[:ring_size]
    ids = _agent_ids()
    assert [port_peers.owner_of(a, ring) for a in ids] == \
        [ref_peers.owner_of(a, ring) for a in ids]
    assert [port_peers.rendezvous_rank(a, ring) for a in ids] == \
        [ref_peers.rendezvous_rank(a, ring) for a in ids]
    assert [port_peers.rendezvous_score(a, p) for a in ids[:500] for p in ring] == \
        [ref_peers.rendezvous_score(a, p) for a in ids[:500] for p in ring]


@pytest.mark.parametrize("spec", [
    "m-a=http://127.0.0.1:8000|127.0.0.1:8001", "m-b=http://h:9000/", " m-c = https://x ",
    "", "http://h:9000", "m-a=", "m-a=not-a-url", "=http://h:1", "m=ftp://h"])
def test_peer_specs_parse_as_the_references(spec):
    got = []
    for pkg in (REF, PORT):
        try:
            got.append(pkg.peers.parse_peer_spec(spec).to_dict())
        except pkg.peers.PeerSpecError as e:
            got.append(("PeerSpecError", str(e)))
    assert got[0] == got[1]


def _probe_sequence():
    rng = np.random.default_rng(SEED + 1)
    seq = []
    for step in range(400):
        peer = str(rng.choice(["m-b", "m-c", "m-d", "ghost"]))
        if rng.uniform() < 0.08:
            seq.append(("adopt", peer))
        else:
            seq.append(("probe", peer, bool(rng.uniform() < 0.55), 1000.0 + step,
                        float(rng.uniform(0, 50)), f"err-{step}"))
    return seq


@pytest.mark.parametrize("dead_after", [1, 2, 3])
def test_peerset_health_under_one_probe_sequence(dead_after):
    sets = []
    for pkg in (REF, PORT):
        descs = [pkg.peers.parse_peer_spec(f"{p}=http://127.0.0.1:{1000 + i}|127.0.0.1:{2000 + i}")
                 for i, p in enumerate(["m-c", "m-a", "m-d", "m-b"])]
        sets.append(pkg.peers.PeerSet("m-a", descs, dead_after_probes=dead_after))
    agents = _agent_ids(3000)
    for ps in sets:
        assert ps.cohort_counts(agents) == sets[0].cohort_counts(agents)
        assert ps.ring == sets[0].ring
        assert [p.peer_id for p in (ps.successor(), ps.predecessor())] == ["m-b", "m-d"]
    for step in _probe_sequence():
        outs = []
        for ps in sets:
            if step[0] == "adopt":
                ps.mark_adopted(step[1])
                out = None
            else:
                _, peer, ok, now, rtt, err = step
                out = ps.mark_probe(peer, ok, now, rtt_ms=rtt, error=err)
            outs.append((out, ps.health_block(step[-3] if step[0] == "probe" else 2000.0),
                         [p.peer_id for p in ps.live_others()],
                         {p: (ps.is_reachable(p), ps.is_adopted(p)) for p in PEER_IDS}))
        assert outs[0] == outs[1], step


# -- the merges ----------------------------------------------------------------------

def _recorded_panes():
    """Three cohorts' panes as a reference manager serves them at NOW,
    plus an empty answer (a peer whose pane is skipped)."""
    rng = np.random.default_rng(SEED + 2)
    panes = {}
    for c, pid in enumerate(["m-a", "m-b", "m-c"]):
        db = ref_sqlite.DB(":memory:")
        st = ref_rollup.FleetRollupStore(db, shard_count=2)
        for i in range(3):
            agent = f"{pid}-agent-{i}"
            st.ingest(agent, _records(3 * c + i, rng), now=NOW)
        panes[pid] = {
            "rollup": st.fleet_rollup(),
            "fabric": st.fleet_fabric(0.0, now=NOW),
            "predict": st.fleet_predict(4, now=NOW),
            "agents": st.agents_page(0, 50),
            "traces": st.traces(CID, 200),
        }
        db.close()
    return json.loads(json.dumps(panes))  # as a fan-out decodes them


@pytest.mark.parametrize("kind", ["rollup", "fabric", "predict", "agents", "traces"])
@pytest.mark.parametrize("limit", [2, 50])
def test_the_merges_are_the_references(kind, limit):
    panes = _recorded_panes()
    local = panes["m-a"][kind]
    remotes = {"m-b": panes["m-b"][kind], "m-c": panes["m-c"][kind], "m-d": {}}
    got = []
    for pkg in (REF, PORT):
        f = pkg.federation
        if kind == "agents":
            got.append(f.merge_agents(local, remotes, limit, self_id="m-a"))
        elif kind == "traces":
            got.append(f.merge_traces(local, remotes, limit))
        else:
            got.append(getattr(f, f"merge_{kind}")(local, remotes))
    assert got[0] == got[1]
    assert json.dumps(got[0], sort_keys=True) == json.dumps(got[1], sort_keys=True)


# -- the shipper and the replica -----------------------------------------------------

class _StubSession:
    """The shipper's session: connected, and records every frame."""

    connected = True
    active_protocol = "stub"

    def __init__(self):
        self.frames = []

    def send(self, frame):
        self.frames.append(frame)
        return True

    def start(self):
        pass

    def stop(self):
        pass


def _journal(tmp_path):
    """One journal, written by the reference's rollup store at NOW."""
    db = ref_sqlite.DB(str(tmp_path / "journal.db"))
    st = ref_rollup.FleetRollupStore(db, shard_count=3)
    for agent, recs in _cohort_records().items():
        st.ingest(agent, recs, now=NOW)
    return db


def _ship(pkg, db, clock):
    sh = pkg.federation.JournalShipper(
        db, pkg.peers.parse_peer_spec("m-b=http://127.0.0.1:1"), "m-a", ship_batch=37,
        redeliver_after=5.0, time_fn=lambda: clock[0])
    sh.session = _StubSession()
    trace = []
    while True:
        n = sh.tick()
        trace.append(n)
        if not n:
            break
    sh.on_ack(100)
    sh.on_ack(60)
    clock[0] = 10.0  # the ack stalls: redeliver from the watermark
    trace.append(sh.tick())
    sh._on_connected()
    trace.append(sh.tick())
    stats = sh.stats()
    stats.pop("transport")
    return sh.session.frames, trace, stats


def test_the_shipper_frames_are_the_references_byte_for_byte(tmp_path):
    db = _journal(tmp_path)
    try:
        (ref_frames, ref_trace, ref_stats) = _ship(REF, db, [0.0])
        (frames, trace, stats) = _ship(PORT, db, [0.0])
    finally:
        db.close()
    assert (trace, stats) == (ref_trace, ref_stats)
    assert len(frames) == len(ref_frames) > 10
    for f, rf in zip(frames, ref_frames):
        assert f.req_id == rf.req_id
        assert f.data == rf.data
        assert port_wire.encode_payload(f.data) == ref_wire.encode_payload(rf.data)


def test_the_replica_rows_are_the_references_for_the_same_frames(tmp_path):
    db = _journal(tmp_path)
    try:
        frames, _trace, _stats = _ship(REF, db, [0.0])
        src = db.query(f"SELECT {JOURNAL_COLUMNS} FROM {TABLE} ORDER BY rowid")
    finally:
        db.close()
    got = {}
    for pkg in (REF, PORT):
        rdb = pkg.sqlite.DB(str(tmp_path / f"replica_{pkg.name}.db"))
        rs = pkg.federation.ReplicaStore(rdb)
        dec = pkg.wire.DeltaDecoder()
        for n, fr in enumerate(frames):
            batch = pkg.wire.parse_batch(fr.data)
            if fr.req_id.startswith(f"outbox-batch-{src[0][0]}-"):
                dec = pkg.wire.DeltaDecoder()  # a keyframe-anchored redelivery
            recs = [dec.decode_record(r) for r in batch["records"]]
            if n == 1:  # malformed rows beside good ones
                recs += [(10**6, 0.0, "wrong-kind", "k", {}),
                         (10**6 + 1, 0.0, pkg.federation.REPLICA_KIND, "k", "not-a-dict"),
                         (10**6 + 2, 0.0, pkg.federation.REPLICA_KIND, "k",
                          {"payload_hex": "zz"})]
            rs.replica_ingest("m-a", recs)
        got[pkg.name] = (rs.rows("m-a"), rs.count("m-a"), rs.watermark("m-a"), rs.stats())
        rdb.close()
    assert got["port"] == got["ref"]
    rows = got["port"][0]
    assert [tuple(r) for r in rows] == [tuple(r) for r in src]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_c15_the_replica_under_a_full_writer_queue(pkg, tmp_path):
    """ROADMAP C15: ``replica_ingest`` returns (and the receiving handle
    acks) every row of a frame. The reference's writer drops what its
    bounded queue has no room for; the port waits for a drain and hands
    every row over."""
    p = PKGS[pkg]
    db = p.sqlite.DB(str(tmp_path / "r.db"))
    writer = p.writer.BatchWriter(db, max_pending=8, backpressure_seconds=0.01)
    rs = p.federation.ReplicaStore(db, writer)
    body = {"agent": "a", "seq": 1, "ts": 1.0, "ingested": 2.0, "kind": "transition",
            "dedupe_key": "k", "correlation_id": "", "payload_hex": "00ff", "shard": 0}
    acked = 0
    for frame in range(5):
        recs = [(rid, 0.0, p.federation.REPLICA_KIND, f"j:{rid}", dict(body, seq=rid))
                for rid in range(20 * frame + 1, 20 * frame + 21)]
        acked += rs.replica_ingest("m-a", recs)
    assert writer.flush(timeout=WAIT)
    durable, dropped = rs.count("m-a"), writer.stats()["dropped_ops"]
    db.close()
    assert acked == 100 and rs.watermark("m-a") == 100
    if pkg == "ref":
        assert durable < acked and durable + dropped == acked
    else:
        assert (durable, dropped) == (100, 0)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_c10_a_peer_stream_that_connects_before_attach_peers(pkg, tmp_path):
    """ROADMAP C10: manager a attaches its peers while b has not yet, and
    a's replication stream connects to b then. The reference's b takes the
    stream as an agent's: a's journal is acked into b's own cohort and b's
    replica of a stays empty after b attaches. The port's shipper sends
    nothing until b's ``/v1/fleet/peers`` says it is federated, and b's
    replica then equals a's journal in every column."""
    p = PKGS[pkg]
    cps = {}
    try:
        for pid in ("m-a", "m-b"):
            cp = p.control_plane.ControlPlane(instance_id=pid, data_dir=str(tmp_path / pid),
                                              shards=1)
            cp.start()
            cps[pid] = cp
        a, b = cps["m-a"], cps["m-b"]
        for agent, recs in _cohort_records().items():
            a.rollup.ingest(agent, recs, now=NOW)
        a.writer.flush(timeout=WAIT)
        specs = [f"{pid}=http://127.0.0.1:{cp.port}" for pid, cp in cps.items()]
        kwargs = {"replication_interval": 0.05, "probe_interval": 600, "ship_batch": 40}
        a.attach_peers("m-a", specs, **kwargs)
        head = a.federation.shipper.journal_head()
        assert head > 0
        _wait(lambda: "peer:m-a" in b.agents, "a's stream at b before b attaches")
        if pkg == "ref":
            _wait(lambda: a.federation.shipper.stats()["acked_rowid"] >= head,
                  "b's acks as an agent's")
        else:
            time.sleep(20 * kwargs["replication_interval"])
            assert a.federation.shipper.stats()["shipped_rows"] == 0
        b.writer.flush(timeout=WAIT)
        leaked = b.rollup.records_total()
        b.attach_peers("m-b", specs, **kwargs)
        if pkg == "ref":
            time.sleep(20 * kwargs["replication_interval"])
            assert leaked > 0 and b.federation.replica.watermark("m-a") == 0
            assert "peer:m-a" in b.rollup.agent_ids()
        else:
            _wait(lambda: b.federation.replica.watermark("m-a") >= head, "b's replica of a")
            b.writer.flush(timeout=WAIT)
            rows = a.db.query(f"SELECT {JOURNAL_COLUMNS} FROM {TABLE} ORDER BY rowid")
            assert [tuple(r) for r in b.federation.replica.rows("m-a")] == \
                [tuple(r) for r in rows]
            assert leaked == 0 and b.rollup.records_total() == 0
            assert "peer:m-a" not in b.rollup.agent_ids()
    finally:
        for cp in cps.values():
            cp.stop()


# -- mixed peer sets -----------------------------------------------------------------

MASKED = {"elapsed_ms", "rtt_ms", "last_seen", "age_seconds", "now", "endpoint",
          "grpc_target"}


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in MASKED else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _get(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=WAIT) as resp:
        return json.loads(resp.read().decode())


def run_pair(pkg_a, pkg_b, protocol, tmp_path, cli=None):
    """Managers m-a of ``pkg_a`` and m-b of ``pkg_b`` peered over
    ``protocol``, each holding the cohort the rendezvous gives it (journaled
    at NOW before the peers attach); returns what each serves once both
    replicas have caught up, after holding each replica to its source."""
    ids = ["m-a", "m-b"]
    cps = {}
    try:
        for pid, pkg in zip(ids, (pkg_a, pkg_b)):
            cp = PKGS[pkg].control_plane.ControlPlane(
                instance_id=pid, data_dir=str(tmp_path / f"{pkg_a}-{pkg_b}-{protocol}-{pid}"),
                shards=2)
            cp.start()
            cps[pid] = cp
        for agent, recs in _cohort_records().items():
            cps[ref_peers.owner_of(agent, ids)].rollup.ingest(agent, recs, now=NOW)
        for cp in cps.values():
            cp.writer.flush(timeout=WAIT)
        specs = [f"{pid}=http://127.0.0.1:{cp.port}"
                 + (f"|127.0.0.1:{cp.grpc_port}" if protocol == "v2" else "")
                 for pid, cp in cps.items()]
        # the replication streams start once both managers are federated:
        # a stream that reaches a manager before its attach_peers enrolls
        # as an agent there (ROADMAP C10)
        with pytest.MonkeyPatch.context() as mp:
            for pkg in PKGS.values():
                mp.setattr(pkg.federation.JournalShipper, "start", lambda self: None)
            for pid, cp in cps.items():
                # frames of 40 rows: the reference's v1 receiver reads a
                # frame as one line of at most 64 KiB (ROADMAP C16)
                cp.attach_peers(pid, specs, replication_interval=0.05, probe_interval=600,
                                fanout_timeout=10.0, ship_batch=40)
        for cp in cps.values():
            cp.federation.shipper.start()
        for src, dst in (("m-a", "m-b"), ("m-b", "m-a")):
            head = cps[src].federation.shipper.journal_head()
            assert head > 0
            _wait(lambda: cps[dst].federation.replica.watermark(src) >= head,
                  f"{dst}'s replica of {src}")
            _wait(lambda: cps[src].federation.shipper.stats()["acked_rowid"] >= head,
                  f"{src}'s acks from {dst}")
        for src, dst in (("m-a", "m-b"), ("m-b", "m-a")):
            cps[dst].writer.flush(timeout=WAIT)
            rows = cps[src].db.query(f"SELECT {JOURNAL_COLUMNS} FROM {TABLE} ORDER BY rowid")
            assert [tuple(r) for r in cps[dst].federation.replica.rows(src)] == \
                [tuple(r) for r in rows], (pkg_a, pkg_b, protocol, src)
            assert cps[src].federation.shipper.stats()["transport"] == protocol
        out = {}
        for pid, cp in cps.items():
            view = {"peers": _get(f"{cp.endpoint}/v1/fleet/peers")}
            for path in ("rollup", "fabric", "predict?top=5", "agents?limit=5",
                         "agents?limit=50", f"traces?correlation_id={CID}",
                         "agents/agent-3/history?limit=7", "agents/agent-4/history"):
                view[path] = _get(f"{cp.endpoint}/v1/fleet/{path}")
            out[pid] = _mask(view)
        if cli is not None:
            cli(cps)
        return out
    finally:
        for cp in cps.values():
            cp.stop()


@pytest.fixture(scope="module")
def ref_pairs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ref_pairs")
    return {protocol: run_pair("ref", "ref", protocol, base) for protocol in ("v1", "v2")}


@pytest.mark.parametrize("protocol", ["v1", "v2"])
@pytest.mark.parametrize("pair", [("port", "ref"), ("ref", "port")])
def test_a_mixed_peer_set_serves_what_a_reference_one_does(pair, protocol, ref_pairs,
                                                           tmp_path):
    got = run_pair(*pair, protocol, tmp_path)
    want = ref_pairs[protocol]
    for pid in ("m-a", "m-b"):
        for path in want[pid]:
            assert got[pid][path] == want[pid][path], (pid, path)
    assert got["m-b"]["rollup"]["federated"] is True
    assert got["m-b"]["agents?limit=50"]["total"] == len(AGENTS)


def test_both_clis_list_the_same_manager_serve_flags(capsys, monkeypatch):
    from gpud_tpu.cli import main as ref_main

    from gpud_tpu_torch.cli import main

    monkeypatch.setattr(sys, "argv", ["tpud"])
    helps = []
    for fn in (ref_main, main):
        with pytest.raises(SystemExit) as e:
            fn(["manager", "serve", "--help"])
        assert e.value.code == 0
        # the option list; the usage line names each program
        helps.append(capsys.readouterr().out.split("\noptions:\n", 1)[1])
    assert helps[0] == helps[1]
    for flag in ("--peer-id", "--peers", "--replication-interval", "--probe-interval",
                 "--fanout-timeout", "--dead-after-probes", "--no-auto-adopt"):
        assert flag in helps[1]


FLEET_ARGV = [["fleet", "peers"], ["fleet", "agents", "--peer", "m-a"],
              ["fleet", "agents", "--peer", "m-b", "--limit", "3"],
              ["fleet", "agents", "--peer", "nobody"], ["fleet", "agents"]]


def test_both_clis_print_the_same_federated_answers(tmp_path, capsys, monkeypatch):
    """``fleet peers`` and ``fleet agents --peer`` through ``tpud``'s CLI
    and the port's, against each manager of a mixed pair: the same exit
    codes and stdout (its milliseconds and ports masked). Stderr is left
    out: the managers run in this process, and their log records reach
    whatever stream the shared logger was first bound to."""
    from gpud_tpu.cli import main as ref_main

    from gpud_tpu_torch.cli import main

    monkeypatch.setattr(sys, "argv", ["tpud"])
    seen = []

    def cli(cps):
        for cp in cps.values():
            for argv in FLEET_ARGV:
                got = []
                for fn in (ref_main, main):
                    rc = fn([*argv, "--endpoint", cp.endpoint])
                    out = capsys.readouterr().out
                    got.append((rc, _mask(json.loads(out)) if rc == 0 else out))
                assert got[0] == got[1], argv
                seen.append((argv, got[1][0], got[1][1]))

    run_pair("port", "ref", "v1", tmp_path, cli=cli)
    assert len(seen) == 2 * len(FLEET_ARGV) and all(rc == 0 for _a, rc, _o in seen)
    filtered = [o for a, _rc, o in seen if "--peer" in a and a[-1] in ("m-a", "m-b")]
    assert all(o["filtered"] == len(o["agents"]) > 0 for o in filtered)
    assert all(r["peer"] == o["peer_filter"] for o in filtered for r in o["agents"])


@pytest.mark.parametrize("receiver", ["ref", "port"])
def test_c16_a_v1_replication_frame_past_64_kib(receiver, tmp_path, caplog):
    """ROADMAP C16: a replication frame crosses v1 as one ndjson line. The
    reference's manager (aiohttp) reads a line of at most 64 KiB; a frame of
    the default 2000-row batch is longer, so the write stream breaks
    ("Chunk too big") and nothing is replicated or acked (the shipper's next
    connection sends the same frame again). The port's listener reads a
    line of up to 1 MiB and takes it in one frame."""
    db = _journal(tmp_path)
    try:
        one = port_federation.JournalShipper(
            db, port_peers.parse_peer_spec("m-b=http://127.0.0.1:1"), "m-a")
        one.session = _StubSession()
        one.tick()
    finally:
        db.close()
    (frame,) = one.session.frames
    assert 2 ** 16 < len(json.dumps({"req_id": frame.req_id, "data": frame.data})) < 2 ** 20
    cps = {}
    try:
        for pid, pkg in (("m-a", "port"), ("m-b", receiver)):
            cp = PKGS[pkg].control_plane.ControlPlane(instance_id=pid,
                                                      data_dir=str(tmp_path / pid), shards=2)
            cp.start()
            cps[pid] = cp
        for agent, recs in _cohort_records().items():
            cps["m-a"].rollup.ingest(agent, recs, now=NOW)
        cps["m-a"].writer.flush(timeout=WAIT)
        specs = [f"{pid}=http://127.0.0.1:{cp.port}" for pid, cp in cps.items()]
        with pytest.MonkeyPatch.context() as mp:  # start once both are federated (C10)
            for pkg in PKGS.values():
                mp.setattr(pkg.federation.JournalShipper, "start", lambda self: None)
            for pid, cp in cps.items():
                cp.attach_peers(pid, specs, replication_interval=0.05, probe_interval=600)
        for cp in cps.values():
            cp.federation.shipper.start()
        head = cps["m-a"].federation.shipper.journal_head()
        replica = cps["m-b"].federation.replica
        if receiver == "port":
            _wait(lambda: replica.watermark("m-a") >= head, "the port's replica")
            assert cps["m-a"].federation.shipper.stats()["frames"] == 1
        else:
            _wait(lambda: any("Chunk too big" in r.getMessage() or
                              "Chunk too big" in str(r.exc_info and r.exc_info[1])
                              for r in caplog.records),
                  "aiohttp's refusal of the frame's line")
            assert replica.watermark("m-a") == 0 and replica.count("m-a") == 0
            assert cps["m-a"].federation.shipper.stats()["acked_rowid"] == 0
    finally:
        for cp in cps.values():
            cp.stop()
