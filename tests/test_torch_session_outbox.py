"""Parity of the port's durable outbox and circuit breaker
(gpud_tpu_torch/session/outbox.py) with gpud_tpu's, on the cases of the
reference's tests/test_session_outbox.py (:54-267: its ``FakeSession`` and
circuit cases).

Each case runs on both packages over its own SQLite DB with an injected
clock, and replays into a ``FakeSession`` (a connected transport with no
socket). The seqs, the acked and delivered watermarks, the journal rows,
the delivery frames (request ids and batch envelopes, record by record),
the purge and drop accounting and the breaker's states must be equal. The
manager's side of delivery, ``AgentHandle`` (:427-511: dedupe, the one
cumulative ack per batch, the decoded prefix acked on a delta desync),
runs on both packages too; the reference's ``Session`` and dispatcher
cases run in tests/test_torch_session.py and test_torch_dispatch.py."""

import pytest

from torch_plane_parity import IDS, PKGS, both


class FakeSession:
    """Transport stand-in for replay: connected unless told otherwise."""

    def __init__(self, connected=True, auth_failed=False, accept=None):
        self.connected = connected
        self.auth_failed = auth_failed
        self.frames = []
        self.accept = accept  # None = accept all, else max sends

    def send(self, frame) -> bool:
        if self.accept is not None and len(self.frames) >= self.accept:
            return False
        self.frames.append(frame)
        return True


def frames(sess):
    return [(f.req_id, f.data, f.to_json()) for f in sess.frames]


def T():
    """The journal's clock where a case does not move it."""
    return 1000.0


def memdb(P):
    return P.sqlite.DB(":memory:")


# -- journal / ack / replay -------------------------------------------------


def publish_seqs(P, tmp):
    db = memdb(P)
    ob = P.outbox.SessionOutbox(db, time_now_fn=T)
    seqs = [ob.publish("event", {"a": 1}, dedupe_key="k1"), ob.publish("gossip", {"b": 2})]
    assert seqs == [1, 2]
    rows = ob.pending()
    assert [(r[0], r[2], r[3]) for r in rows] == [(1, "event", "k1"), (2, "gossip", "gossip:2")]
    assert ob.backlog() == 2
    out = ([(r[0], r[2], r[3], r[4]) for r in rows], ob.stats(), ob.pending(limit=1),
           ob.pending(after=1))
    db.close()
    return out


def ack_monotonic(P, tmp):
    db = memdb(P)
    ob = P.outbox.SessionOutbox(db, time_now_fn=T)
    for i in range(5):
        ob.publish("event", {"i": i})
    acks = [ob.ack(3), ob.ack(1), ob.ack(-7), ob.ack("4")]
    assert acks[:3] == [3, 3, 3]
    out = (acks, [r[0] for r in ob.pending()], ob.backlog(), ob.delivered_seq, ob.stats())
    db.close()
    return out


def replay_batches(P, tmp):
    db = memdb(P)
    ob = P.outbox.SessionOutbox(db, replay_batch=2, time_now_fn=T)
    for i in range(3):
        ob.publish("event", {"i": i}, dedupe_key=f"k{i}")
    sess = FakeSession()
    assert ob.replay_once(sess) == 2
    assert len(sess.frames) == 1 and sess.frames[0].req_id == "outbox-batch-1-2"
    batch = sess.frames[0].data["outbox_batch"]
    assert (batch["first_seq"], batch["last_seq"], batch["count"]) == (1, 2, 2)
    recs = batch["records"]
    assert len(recs[0]) == 6 and recs[0][3] == "k0" and recs[0][5] == {"i": 0}
    assert len(recs[1]) == 7
    assert ob.replay_once(sess) == 1
    assert ob.replay_once(sess) == 0
    assert ob.delivered_seq == 3 and ob.acked_seq == 0
    ob.ack(3)
    assert ob.backlog() == 0
    out = (frames(sess), ob.stats())
    db.close()
    return out


def replay_noop(P, tmp):
    db = memdb(P)
    ob = P.outbox.SessionOutbox(db, time_now_fn=T)
    ob.publish("event", {})
    got = [ob.replay_once(None), ob.replay_once(FakeSession(connected=False)),
           ob.replay_once(FakeSession(auth_failed=True))]
    assert got == [0, 0, 0]
    out = (got, ob.stats())
    db.close()
    return out


def refused_batch(P, tmp):
    db = memdb(P)
    ob = P.outbox.SessionOutbox(db, time_now_fn=T)
    for i in range(4):
        ob.publish("event", {"component": "c", "i": i})
    sess = FakeSession(accept=0)
    assert ob.replay_once(sess) == 0 and ob.delivered_seq == 0
    sess.accept = None
    assert ob.replay_once(sess) == 4
    batch = sess.frames[0].data["outbox_batch"]
    assert (batch["first_seq"], batch["last_seq"]) == (1, 4)
    assert len(batch["records"][0]) == 6
    out = (frames(sess), ob.stats())
    db.close()
    return out


def ack_stall(P, tmp):
    db = memdb(P)
    now = [1000.0]
    ob = P.outbox.SessionOutbox(db, redeliver_after_seconds=5.0, time_now_fn=lambda: now[0])
    for i in range(3):
        ob.publish("event", {"i": i})
    sess = FakeSession()
    got = [ob.replay_once(sess), ob.replay_once(sess)]
    now[0] += 6.0
    got.append(ob.replay_once(sess))
    redo = sess.frames[-1].data["outbox_batch"]
    assert (redo["first_seq"], redo["last_seq"]) == (1, 3) and len(redo["records"][0]) == 6
    got.append(ob.replay_once(sess))
    assert got == [3, 0, 3, 0]
    # an ack inside the window moves the stall clock; later records follow
    ob.ack(2)
    ob.publish("event", {"i": 3})
    now[0] += 4.0
    got.append(ob.replay_once(sess))
    now[0] += 6.0
    got.append(ob.replay_once(sess))
    out = (got, frames(sess), ob.stats())
    db.close()
    return out


def reset_delivery(P, tmp):
    db = memdb(P)
    ob = P.outbox.SessionOutbox(db, keyframe_interval=3, time_now_fn=T)
    for i in range(5):
        ob.publish("transition", {"component": "a", "i": i})
    sess = FakeSession()
    ob.replay_once(sess)
    ob.ack(2)
    ob.reset_delivery()  # reconnect: back to the acked watermark, keyframes
    assert ob.delivered_seq == 2
    ob.replay_once(sess)
    out = (frames(sess), ob.stats())
    db.close()
    return out


def restart(P, tmp):
    state = str(tmp / f"{P.name}-outbox.state")
    db = P.sqlite.DB(state)
    ob = P.outbox.SessionOutbox(db, time_now_fn=T)
    for i in range(6):
        ob.publish("event", {"i": i})
    ob.ack(4)
    db.close()
    db2 = P.sqlite.DB(state)
    ob2 = P.outbox.SessionOutbox(db2, time_now_fn=T)
    assert ob2.acked_seq == 4 and ob2.last_seq == 6
    assert ob2.publish("event", {"i": 6}) == 7
    assert [r[0] for r in ob2.pending()] == [5, 6, 7]
    out = (ob2.stats(), [(r[0], r[2], r[3], r[4]) for r in ob2.pending()])
    db2.close()
    return out


def watermark_ahead_of_journal(P, tmp):
    # every acked row purged before the restart: seqs resume above the ack
    state = str(tmp / f"{P.name}-ahead.state")
    db = P.sqlite.DB(state)
    now = [50.0]
    ob = P.outbox.SessionOutbox(db, max_age_seconds=10.0, time_now_fn=lambda: now[0])
    for i in range(3):
        ob.publish("event", {"i": i})
    ob.ack(3)
    now[0] = 100.0
    purged = ob.purge_once()
    assert purged == 3
    db.close()
    db2 = P.sqlite.DB(state)
    ob2 = P.outbox.SessionOutbox(db2, time_now_fn=T)
    assert (ob2.last_seq, ob2.acked_seq) == (3, 3)
    out = (purged, ob2.publish("event", {}), ob2.stats())
    db2.close()
    return out


def retention(P, tmp):
    db = memdb(P)
    now = [1000.0]
    ob = P.outbox.SessionOutbox(db, max_rows=1000, max_age_seconds=100.0,
                                time_now_fn=lambda: now[0])
    for i in range(4):
        ob.publish("event", {"i": i})
    ob.ack(2)
    now[0] += 200.0
    assert ob.purge_once() == 2
    assert [r[0] for r in ob.pending()] == [3, 4]
    ob2 = P.outbox.SessionOutbox(db, max_rows=1, max_age_seconds=1e9, time_now_fn=lambda: now[0])
    purged = ob2.purge_once()
    assert ob2.stats()["dropped_retention"] == 1 and ob2.acked_seq == 3
    assert [r[0] for r in ob2.pending()] == [4]
    out = (purged, ob.stats(), ob2.stats())
    db.close()
    return out


def size_cap_over_a_backlog(P, tmp):
    db = memdb(P)
    ob = P.outbox.SessionOutbox(db, max_rows=4, time_now_fn=lambda: 10.0)
    for i in range(10):
        ob.publish("event", {"i": i})
    ob.ack(3)
    purged = ob.purge_once()
    out = (purged, ob.stats(), [r[0] for r in ob.pending()], ob.purge_once())
    db.close()
    return out


def batch_writer(P, tmp):
    db = P.sqlite.DB(str(tmp / f"{P.name}-wb.state"))
    writer = P.storage.BatchWriter(db)
    ob = P.outbox.SessionOutbox(db, writer=writer, time_now_fn=T)
    ob.publish("event", {"x": 1}, dedupe_key="wb")
    assert [r[3] for r in ob.pending()] == ["wb"]
    ob.ack(1)
    assert ob.pending() == []
    rows = db.query_one(f"SELECT COUNT(*) FROM {P.outbox.TABLE}")[0]
    assert rows == 1
    writer.close()
    acked = db.query_one(f"SELECT acked_seq FROM {P.outbox.ACK_TABLE}")[0]
    db.close()
    return rows, acked, ob.stats()


class RefusingWriter:
    """A write-behind buffer that is full: every submit is refused."""

    def submit(self, store, sql, params, key=None):
        return False

    def flush(self):
        return True


def journal_full(P, tmp):
    db = memdb(P)
    ob = P.outbox.SessionOutbox(db, writer=RefusingWriter(), time_now_fn=T)
    seqs = [ob.publish("event", {"i": i}) for i in range(3)]
    out = (seqs, ob.stats(), ob.pending())
    db.close()
    return out


def opaque_rows(P, tmp):
    # a corrupt journal row is delivered as an opaque blob, not a poison pill
    db = memdb(P)
    ob = P.outbox.SessionOutbox(db, time_now_fn=T)
    ob.publish("event", {"i": 0})
    db.execute(f"INSERT INTO {P.outbox.TABLE} (seq, ts, kind, dedupe_key, payload) "
               "VALUES (2, 1.0, 'event', 'bad', ?)", (b"\xc1\xc1garbage",))
    out = ob.pending(after=0)
    db.close()
    return [(r[0], r[3], r[4]) for r in out]


def schema(P, tmp):
    db = memdb(P)
    P.outbox.SessionOutbox(db, time_now_fn=T)
    out = db.query("SELECT name, sql FROM sqlite_master ORDER BY name")
    db.close()
    return out


OUTBOX_CASES = {
    "publish_seqs": publish_seqs,
    "ack_monotonic": ack_monotonic,
    "replay_batches": replay_batches,
    "replay_noop": replay_noop,
    "refused_batch": refused_batch,
    "ack_stall": ack_stall,
    "reset_delivery": reset_delivery,
    "restart": restart,
    "watermark_ahead_of_journal": watermark_ahead_of_journal,
    "retention": retention,
    "size_cap_over_a_backlog": size_cap_over_a_backlog,
    "batch_writer": batch_writer,
    "journal_full": journal_full,
    "opaque_rows": opaque_rows,
    "schema": schema,
}


@pytest.mark.parametrize("case", OUTBOX_CASES)
def test_the_outbox_is_the_reference_s(case, tmp_path):
    ref, port = both(OUTBOX_CASES[case], tmp_path)
    assert port == ref


def test_the_outbox_constants_are_the_reference_s():
    names = ("TABLE", "ACK_TABLE", "DEFAULT_MAX_ROWS", "DEFAULT_MAX_AGE",
             "DEFAULT_REPLAY_BATCH", "DEFAULT_REDELIVER_AFTER", "REPLAY_REQ_PREFIX",
             "HOT_WRITE_METHODS", "CIRCUIT_CLOSED", "CIRCUIT_OPEN", "CIRCUIT_HALF_OPEN",
             "DEFAULT_FAILURE_THRESHOLD", "DEFAULT_OPEN_SECONDS")
    ref, port = both(lambda P: [getattr(P.outbox, n) for n in names])
    assert port == ref


@pytest.mark.parametrize("P", PKGS, ids=IDS)
def test_the_frame_serializes_as_the_reference_s(P):
    f = P.session.Frame(req_id="outbox-batch-1-2", data={"outbox_batch": {"v": 1}})
    assert f.to_json() == '{"req_id": "outbox-batch-1-2", "data": {"outbox_batch": {"v": 1}}}'
    back = P.session.Frame.from_json(f.to_json())
    assert (back.req_id, back.data) == (f.req_id, f.data)
    assert P.session.Frame.from_json("not json") is None
    assert P.session.Frame.from_json("[1, 2]") is None
    assert P.session.Frame().data == {}


# -- circuit breaker --------------------------------------------------------


def opens_and_probes(P, tmp):
    O = P.outbox
    now = [0.0]
    cb = O.CircuitBreaker(failure_threshold=3, open_seconds=10.0, time_fn=lambda: now[0])
    assert cb.state == O.CIRCUIT_CLOSED
    for _ in range(2):
        cb.record_failure()
    assert cb.state == O.CIRCUIT_CLOSED
    cb.record_failure()
    assert cb.state == O.CIRCUIT_OPEN
    assert not cb.allow() and not cb.allow() and cb.blocked_count == 2
    assert cb.seconds_until_probe() == pytest.approx(10.0)
    now[0] = 10.0
    assert cb.allow() and cb.state == O.CIRCUIT_HALF_OPEN
    cb.record_success()
    assert cb.states_seen() == [O.CIRCUIT_CLOSED, O.CIRCUIT_OPEN, O.CIRCUIT_HALF_OPEN,
                                O.CIRCUIT_CLOSED]
    return cb.stats(), cb.recovery_age(), cb.history


def failed_probe_reopens(P, tmp):
    O = P.outbox
    now = [0.0]
    cb = O.CircuitBreaker(failure_threshold=1, open_seconds=5.0, time_fn=lambda: now[0])
    cb.record_failure()
    assert cb.state == O.CIRCUIT_OPEN
    now[0] = 5.0
    assert cb.allow() and cb.state == O.CIRCUIT_HALF_OPEN
    cb.record_failure()
    assert cb.state == O.CIRCUIT_OPEN
    assert not cb.allow()
    now[0] = 10.0
    assert cb.allow()
    return cb.stats(), cb.history, cb.seconds_until_probe(), cb.recovery_age()


def peer_failover(P, tmp):
    now = [0.0]
    cb = P.outbox.CircuitBreaker(failure_threshold=2, open_seconds=30.0, time_fn=lambda: now[0],
                                 peers=["m-a", "", "m-b", "m-c"])
    seen = []
    for step in range(12):
        allowed = cb.allow()
        if allowed:
            cb.record_failure()
        now[0] += 7.0
        seen.append((allowed, cb.state, cb.current_peer(), cb.seconds_until_probe()))
    cb.allow()
    cb.record_success()
    return seen, cb.stats(), cb.failover_count, cb.recovery_age()


def no_peers(P, tmp):
    cb = P.outbox.CircuitBreaker(time_fn=lambda: 0.0)
    return cb.current_peer(), cb.stats(), cb.recovery_age(), cb.seconds_until_probe()


CIRCUIT_CASES = {
    "opens_and_probes": opens_and_probes,
    "failed_probe_reopens": failed_probe_reopens,
    "peer_failover": peer_failover,
    "no_peers": no_peers,
}


@pytest.mark.parametrize("case", CIRCUIT_CASES)
def test_the_circuit_breaker_is_the_reference_s(case, tmp_path):
    ref, port = both(CIRCUIT_CASES[case], tmp_path)
    assert port == ref


# -- the manager's side: AgentHandle (tests/test_session_outbox.py:427-511) --


def drain_acks(h):
    acks = []
    while not h.outbound.empty():
        item = h.outbound.get_nowait()
        if item and item["data"].get("method") == "outboxAck":
            acks.append(item["data"]["seq"])
    return acks


def handle_dedupes_and_acks(P, tmp):
    h = P.control_plane.AgentHandle("m1", "v1")
    frame = {"outbox_seq": 1, "kind": "event", "dedupe_key": "k1", "ts": 1.0, "payload": {}}
    h.resolve("outbox-1", frame)
    h.resolve("outbox-1", frame)  # redelivery: recorded once
    h.resolve("outbox-2", {"outbox_seq": 2, "kind": "event", "dedupe_key": "k2", "ts": 2.0,
                           "payload": {}})
    assert [r["dedupe_key"] for r in h.outbox_records] == ["k1", "k2"]
    assert h.outbox_acked == 2
    acks = drain_acks(h)
    assert acks == [1, 1, 2]
    # the agent's responses to the acks are swallowed, not queued as noise
    h.resolve("op-1-ack", {"acked_seq": 1})
    assert h.unsolicited == []
    return h.outbox_records, h.outbox_acked, acks, list(h.outbox_keys)


def handle_batch_one_ack(P, tmp):
    h = P.control_plane.AgentHandle("m1", "v2-rev3")
    enc = P.wire.DeltaEncoder()
    recs = [enc.encode_record(i + 1, float(i), "event", f"k{i + 1}", {"component": "gpu0", "i": i})
            for i in range(5)]
    h.resolve("outbox-batch-1-5", P.wire.build_batch(recs))
    assert [r["outbox_seq"] for r in h.outbox_records] == [1, 2, 3, 4, 5]
    assert [r["payload"]["i"] for r in h.outbox_records] == [0, 1, 2, 3, 4]
    first = drain_acks(h)
    assert first == [5], "one cumulative ack per batch frame"
    # a redelivery dedupes but re-acks the watermark
    enc.reset()
    redo = [enc.encode_record(i + 1, float(i), "event", f"k{i + 1}", {"component": "gpu0", "i": i})
            for i in range(5)]
    h.resolve("outbox-batch-1-5", P.wire.build_batch(redo))
    assert len(h.outbox_records) == 5
    second = drain_acks(h)
    assert second == [5]
    return h.outbox_records, h.outbox_acked, first, second


def handle_prefix_on_desync(P, tmp):
    h = P.control_plane.AgentHandle("m1", "v2-rev3")
    good = P.wire.DeltaEncoder().encode_record(1, 1.0, "event", "k1", {"component": "a", "i": 0})
    # a delta whose keyframe was never delivered
    enc = P.wire.DeltaEncoder()
    enc.encode_record(1, 1.0, "event", "x", {"component": "b", "i": 0})
    orphan = enc.encode_record(2, 2.0, "event", "k2", {"component": "b", "i": 1})
    h.resolve("outbox-batch-1-2", P.wire.build_batch([good, orphan]))
    assert [r["dedupe_key"] for r in h.outbox_records] == ["k1"]
    assert h.outbox_acked == 1
    acks = drain_acks(h)
    assert acks == [1]
    return h.outbox_records, h.outbox_acked, acks


HANDLE_CASES = {
    "dedupes_and_acks": handle_dedupes_and_acks,
    "batch_one_cumulative_ack": handle_batch_one_ack,
    "decoded_prefix_on_delta_desync": handle_prefix_on_desync,
}


@pytest.mark.parametrize("case", HANDLE_CASES)
def test_the_manager_s_agent_handle_is_the_reference_s(case, tmp_path):
    ref, port = both(HANDLE_CASES[case], tmp_path)
    assert port == ref
