"""The port's v1 session transport (``http.client``, gpud_tpu_torch/
session/session.py) against the reference's (``requests``), over real
loopback sockets on 127.0.0.1.

Both packages' ``Session`` run against the reference's ``FakeControlPlane``
(aiohttp) and against the stdlib plane ``chip_smoke.py`` serves
(tests/torch_loopback_plane.py): requests down the read stream and answers
up the chunked write stream, a dropped connection and the reconnect, a 401
that parks the session and the token that resumes it, an outbox replay that
the plane acks. What each session saw, the headers each plane received and
the frames each plane decoded must be the same for both packages; the
reference ``Session`` passing against the stdlib plane holds that plane to
the protocol. Every wait has a bound."""

import re
import time
import types

import pytest

import gpud_tpu.session.dispatch as ref_dispatch
import gpud_tpu.session.outbox as ref_outbox
import gpud_tpu.session.session as ref_session
import gpud_tpu.session.wire as ref_wire
import gpud_tpu.sqlite as ref_sqlite
import gpud_tpu_torch.session.dispatch as port_dispatch
import gpud_tpu_torch.session.outbox as port_outbox
import gpud_tpu_torch.session.session as port_session
import gpud_tpu_torch.session.wire as port_wire
import gpud_tpu_torch.sqlite as port_sqlite
from gpud_tpu.chaos.fake_plane import FakeControlPlane
from gpud_tpu_torch import http_client

from torch_loopback_plane import LoopbackPlane

REF = types.SimpleNamespace(name="ref", session=ref_session, outbox=ref_outbox, wire=ref_wire,
                            sqlite=ref_sqlite, dispatch=ref_dispatch)
PORT = types.SimpleNamespace(name="port", session=port_session, outbox=port_outbox,
                             wire=port_wire, sqlite=port_sqlite, dispatch=port_dispatch)
WAIT = 15.0
SESSION_HEADERS = ("X-TPUD-Session-Type", "X-TPUD-Machine-ID", "X-TPUD-Version",
                   "Content-Type", "Authorization", "X-TPUD-Machine-Proof",
                   "Transfer-Encoding", "Content-Length")


def wait(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


class Plane:
    """One face over both planes: ``kind`` "fake" (the reference's
    FakeControlPlane) or "loopback" (the stdlib plane)."""

    def __init__(self, kind, wire=None):
        self.kind = kind
        self.p = FakeControlPlane() if kind == "fake" else LoopbackPlane(wire=wire, auto_ack=True)
        self.p.start()

    @property
    def endpoint(self):
        return f"http://127.0.0.1:{self.p.port}"

    def drop(self, machine):
        if self.kind == "fake":
            self.p.drop_session(machine)
        else:
            self.p.drop(machine)

    def send(self, machine, req_id, data):
        self.p.send_request(machine, req_id, data)
        got = self.p.wait_response(req_id, WAIT)
        assert got is not None, f"no answer to {req_id}"
        return got["data"]

    def stop(self):
        self.p.stop()


def session(P, endpoint, dispatch=None, token="t1"):
    """A v1 session whose backoff and auth re-check sleeps are cut to 20 ms."""
    s = P.session.Session(endpoint=endpoint, machine_id="m1", token=token,
                          machine_proof="proof-1", protocol="v1",
                          dispatch_fn=dispatch or (lambda req: {"echo": req}),
                          jitter_fn=lambda b: 0.02)
    s.time_sleep_fn = lambda secs: s._stop.wait(min(secs, 0.02))
    return s


def settle(plane, machine):
    """After a reconnect the replaced stream's pump may take one more frame
    (ROADMAP C7: the reference sends it to the closed stream): ask until an
    answer comes back, so the compared requests go to the new stream."""
    for i in range(100):
        rid = f"settle-{i}"
        plane.p.send_request(machine, rid, {"method": "settle"})
        if plane.p.wait_response(rid, 0.5) is not None:
            return
    raise AssertionError("no answer after the reconnect")


def lifecycle(P, kind, monkeypatch):
    """Requests and answers, a dropped connection, a 401 that parks the
    session, the token that resumes it. The write stream's poll is cut to
    20 ms; after each reconnect ``settle`` waits until answers reach the
    new stream."""
    monkeypatch.setattr(P.session, "PIPE_INTERVAL", 0.02)
    plane = Plane(kind)
    s = session(P, plane.endpoint)
    s.start()
    try:
        assert plane.p.connected.wait(WAIT)
        answers = [plane.send("m1", f"q{i}", {"method": "states", "i": i}) for i in range(3)]
        plane.drop("m1")
        assert wait(lambda: s.reconnect_count == 1 and plane.p.connected.is_set())
        settle(plane, "m1")
        answers.append(plane.send("m1", "q3", {"method": "events"}))
        plane.p.accept_token = "t2"
        plane.drop("m1")
        assert wait(lambda: s.auth_failed)
        parked_error = re.sub(r":\d+/", ":PORT/", s.last_connect_error)
        s.token = "t2"
        assert wait(lambda: s.connected and not s.auth_failed)
        assert wait(lambda: plane.p.connected.is_set())
        settle(plane, "m1")
        answers.append(plane.send("m1", "q4", {"method": "states"}))
        return (answers, s.reconnect_count, parked_error, s.active_protocol,
                s.connect_attempts)
    finally:
        s.stop()
        plane.stop()


@pytest.mark.parametrize("kind", ["fake", "loopback"])
def test_the_http_session_s_lifecycle_is_the_reference_s(kind, monkeypatch):
    ref, port = lifecycle(REF, kind, monkeypatch), lifecycle(PORT, kind, monkeypatch)
    assert port == ref
    assert port[2] == "401 Client Error: Unauthorized for url: http://127.0.0.1:PORT/api/v1/session"
    assert port[1] == 2 and port[3] == "v1"


def headers_seen(P):
    plane = LoopbackPlane().start()
    s = session(P, plane.endpoint)
    s.start()
    try:
        assert plane.connected.wait(WAIT)
        assert wait(lambda: len(plane.headers) >= 2)
        out = []
        for h in plane.headers[:2]:
            out.append({k: v for k, v in h.items() if k in SESSION_HEADERS})
        return sorted(out, key=lambda h: h["X-TPUD-Session-Type"]), s._headers("read")
    finally:
        s.stop()
        plane.stop()


def test_the_streams_carry_the_reference_s_headers():
    ref, port = headers_seen(REF), headers_seen(PORT)
    assert port == ref
    read, write = port[0]
    assert read["X-TPUD-Session-Type"] == "read" and read["Content-Length"] == "0"
    assert write["X-TPUD-Session-Type"] == "write" and write["Transfer-Encoding"] == "chunked"
    assert read["Authorization"] == "Bearer t1" and read["X-TPUD-Machine-Proof"] == "proof-1"
    assert read["Content-Type"] == "application/x-ndjson"


def keepalive_lines(P, monkeypatch):
    """The write stream's blank keep-alive line every ``PIPE_INTERVAL``
    (shortened for the test), and the answer's bytes on the wire."""
    monkeypatch.setattr(P.session, "PIPE_INTERVAL", 0.02)
    plane = LoopbackPlane().start()
    s = session(P, plane.endpoint)
    s.start()
    try:
        assert plane.connected.wait(WAIT)
        assert wait(lambda: plane.keepalives >= 3)
        plane.send_request("m1", "k1", {"method": "x", "n": "链"})
        assert plane.wait_response("k1", WAIT) is not None
        body = plane.write_bodies["m1"]
        line = [ln for ln in body.split(b"\n") if ln.strip()][0]
        return line, set(body.split(b"\n")) - {line, b""}
    finally:
        s.stop()
        plane.stop()


def test_the_write_stream_s_framing_and_keepalive_are_the_reference_s(monkeypatch):
    ref, port = keepalive_lines(REF, monkeypatch), keepalive_lines(PORT, monkeypatch)
    assert port == ref
    assert port[0] == b'{"req_id": "k1", "data": {"echo": {"method": "x", "n": "\\u94fe"}}}'
    assert port[1] == set()  # nothing between the answers but blank lines


class _Server:
    config = None

    def __init__(self, outbox):
        self.outbox = outbox


def outbox_over_http(P, kind):
    """Five journal records replayed into the live session; the plane
    decodes them, acks the batch, and the ack reaches the outbox through
    the dispatcher."""
    db = P.sqlite.DB(":memory:")
    ob = P.outbox.SessionOutbox(db, time_now_fn=lambda: 1000.0)
    for i in range(5):
        ob.publish("event", {"component": "gpu0", "i": i}, dedupe_key=f"k{i}")
    plane = Plane(kind, wire=P.wire)
    s = session(P, plane.endpoint, dispatch=P.dispatch.Dispatcher(_Server(ob)))
    s.start()
    try:
        assert plane.p.connected.wait(WAIT) and wait(lambda: s.connected)
        assert ob.replay_once(s) == 5
        assert wait(lambda: ob.acked_seq == 5)
        if kind == "fake":
            got = [(r["outbox_seq"], r["dedupe_key"], r["payload"]) for r in plane.p.outbox_frames]
        else:
            got = [(r[1], r[4], r[5]) for r in plane.p.records()]
        return got, ob.acked_seq, ob.backlog()
    finally:
        s.stop()
        plane.stop()
        db.close()


@pytest.mark.parametrize("kind", ["fake", "loopback"])
def test_an_outbox_replay_over_http_is_acked_as_the_reference_s(kind):
    ref, port = outbox_over_http(REF, kind), outbox_over_http(PORT, kind)
    assert port == ref
    assert [r[0] for r in port[0]] == [1, 2, 3, 4, 5] and port[1:] == (5, 0)


def test_a_refused_stream_raises_the_status_and_closes():
    plane = LoopbackPlane(accept_token="good").start()
    try:
        with pytest.raises(http_client.HTTPStatusError) as e:
            http_client.open_post(f"{plane.endpoint}/api/v1/session",
                                  {"X-TPUD-Session-Type": "read", "Authorization": "Bearer bad"})
        assert e.value.status == 401 and port_session.is_auth_error(e.value)
        assert str(e.value) == (f"401 Client Error: Unauthorized for url: "
                                f"{plane.endpoint}/api/v1/session")
        with pytest.raises(http_client.HTTPStatusError) as e:
            http_client.open_post(f"{plane.endpoint}/nowhere", {})
        assert e.value.status == 404 and not port_session.is_auth_error(e.value)
    finally:
        plane.stop()


def test_post_json_answers_as_requests_does():
    plane = LoopbackPlane().start()
    try:
        body = {"machine_id": "m-9", "token": "t"}
        port = http_client.post_json(f"{plane.endpoint}/api/v1/login", body, timeout=5.0)
        import requests

        r = requests.post(f"{plane.endpoint}/api/v1/login", json=body, timeout=5.0)
        r.raise_for_status()
        assert port == r.json() == {"machine_id": "m-9", "token": "cp-session-token",
                                    "machine_proof": "cp-proof"}
        assert plane.logins == [body, body]
    finally:
        plane.stop()


def frame_after_a_replaced_stream(P, monkeypatch):
    """ROADMAP C7, held deterministically: the first write stream's pump
    waits on the writer channel; the plane closes both streams and the
    transport is stopped; a second pair opens, its pump waiting behind the
    first; a frame is queued. The condition wakes the oldest waiter, the
    replaced pump. The reference's sends the frame to its closed stream;
    the port's hands it back to the channel, and the new stream sends it."""
    monkeypatch.setattr(P.session, "PIPE_INTERVAL", 10.0)
    plane = LoopbackPlane().start()
    s = session(P, plane.endpoint)
    try:
        stops = [s._http_reader(s), s._http_writer(s)]
        assert plane.connected.wait(WAIT) and wait(lambda: "m1" in plane._write_socks)
        time.sleep(0.1)  # the first pump waits on the channel
        plane.drop("m1")
        for stop in stops:
            stop()
        stops = [s._http_reader(s), s._http_writer(s)]
        assert plane.connected.wait(WAIT) and wait(lambda: "m1" in plane._write_socks)
        time.sleep(0.1)  # the second pump waits behind the first
        s.writer.put(P.session.Frame(req_id="after", data={"n": 1}))
        got = plane.wait_response("after", timeout=2.0)
        plane.drop("m1")  # the streams end before their transport stops
        for stop in stops:
            stop()
        return got is not None
    finally:
        s._stop.set()
        plane.stop()


def test_a_frame_queued_after_a_reconnect_reaches_the_new_stream(monkeypatch):
    assert frame_after_a_replaced_stream(PORT, monkeypatch)
    assert not frame_after_a_replaced_stream(REF, monkeypatch)
