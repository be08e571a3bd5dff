"""Parity of the port's control-plane session (gpud_tpu_torch/session/
session.py) with gpud_tpu's, on the cases of the reference's
tests/test_session.py, test_session_internals.py, test_session_auth_classify.py
and the transport cases of test_session_outbox.py (:268-511; the manager's
``AgentHandle`` cases wait for the manager tier).

Every case drives both packages' ``Session`` through the reference's own
hooks — ``start_reader_fn``, ``start_writer_fn``, ``jitter_fn`` and
``time_sleep_fn`` — with queues in memory and no socket, and returns what it
saw: connect counts, backoff and jitter sequences, park and resume, peer
failover, dropped-frame accounting, answers. The port's observations must
equal the reference's. Every wait has a bound; the fake sleeps return at
once, so nothing waits out a real backoff."""

import queue
import random
import threading
import time
import types

import numpy as np
import pytest

import gpud_tpu.session.dispatch as ref_dispatch
import gpud_tpu.session.outbox as ref_outbox
import gpud_tpu.session.session as ref_session
import gpud_tpu.sqlite as ref_sqlite
import gpud_tpu_torch.session.dispatch as port_dispatch
import gpud_tpu_torch.session.outbox as port_outbox
import gpud_tpu_torch.session.session as port_session
import gpud_tpu_torch.sqlite as port_sqlite
from gpud_tpu_torch.http_client import HTTPStatusError

REF = types.SimpleNamespace(name="ref", session=ref_session, outbox=ref_outbox,
                            sqlite=ref_sqlite, dispatch=ref_dispatch)
PORT = types.SimpleNamespace(name="port", session=port_session, outbox=port_outbox,
                             sqlite=port_sqlite, dispatch=port_dispatch)
WAIT = 10.0
SEED = 9


def both(scenario, *args):
    return scenario(REF, *args), scenario(PORT, *args)


def wait(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


class Transport:
    """A control plane in memory: ``push`` hands the session a request,
    ``responses`` collects its answers. The first ``fail`` connects raise
    ``error``; ``accept`` (endpoint, token) -> bool refuses others."""

    def __init__(self, P, fail=0, error="refused", accept=None, auth_error=None):
        self.P, self.fail, self.error, self.accept = P, fail, error, accept
        self.auth_error = auth_error
        self.responses, self.connects, self.endpoints = [], 0, []
        self.reader_stops = self.writer_stops = 0
        self.session = None
        self._alive = False

    def start_reader(self, session):
        self.connects += 1
        self.endpoints.append(session.endpoint)
        self.session = session
        refused = self.connects <= self.fail or (
            self.accept is not None and not self.accept(session.endpoint, session.token))
        if refused:
            e = ConnectionError(self.error)
            if self.auth_error is not None:
                e.auth_error = self.auth_error
            raise e

        def stop():
            self.reader_stops += 1

        return stop

    def start_writer(self, session):
        self._alive = True

        def pump():
            while self._alive:
                try:
                    self.responses.append(session.writer.get(timeout=0.01))
                except queue.Empty:
                    continue

        threading.Thread(target=pump, daemon=True).start()

        def stop():
            self._alive = False
            self.writer_stops += 1

        return stop

    def push(self, P, req_id, data):
        self.session.reader.put(P.session.Frame(req_id=req_id, data=data))


def make(P, tr, dispatch=None, sleeps=None, backoffs=None, jitter=None, **kw):
    """A session on ``tr`` whose sleeps return at once (recorded) and whose
    jitter records the backoff it is handed."""
    sleeps = sleeps if sleeps is not None else []
    backoffs = backoffs if backoffs is not None else []
    s = P.session.Session(
        endpoint=kw.pop("endpoint", "https://cp.example"), machine_id="m1",
        token=kw.pop("token", "t"),
        dispatch_fn=dispatch or (lambda req: {"echo": req}),
        start_reader_fn=tr.start_reader, start_writer_fn=tr.start_writer,
        jitter_fn=lambda b: (backoffs.append(b), (jitter or (lambda x: 0.0))(b))[1],
        **kw)
    s.time_sleep_fn = lambda secs: (sleeps.append(secs), s._stop.wait(0.001))[1]
    return s


# -- request and answer -------------------------------------------------------

def roundtrip(P):
    tr = Transport(P)
    s = make(P, tr)
    s.start()
    try:
        assert wait(lambda: s.connected)
        tr.push(P, "r1", {"method": "states"})
        assert wait(lambda: tr.responses)
        return [(f.req_id, f.data, f.to_json()) for f in tr.responses], s.active_protocol
    finally:
        s.stop()


def dispatch_exception(P):
    tr = Transport(P)

    def bad(req):
        raise ValueError("kaboom")

    s = make(P, tr, dispatch=bad)
    s.start()
    try:
        assert wait(lambda: s.connected)
        tr.push(P, "r2", {"method": "x"})
        assert wait(lambda: tr.responses)
        return [(f.req_id, f.data) for f in tr.responses]
    finally:
        s.stop()


def serve_order_and_unserializable(P):
    class Weird:
        pass

    results = iter([{"bad": Weird()}] + [{"i": i} for i in range(10)])
    s = P.session.Session(endpoint="http://127.0.0.1:1", machine_id="m", jitter_fn=lambda b: 0.0,
                          dispatch_fn=lambda req: next(results))
    t = threading.Thread(target=s._serve, daemon=True)
    t.start()
    try:
        for i in range(11):
            s.reader.put(P.session.Frame(req_id=f"r{i}", data={"method": "x"}))
        got = []
        deadline = time.monotonic() + WAIT
        while len(got) < 11 and time.monotonic() < deadline:
            try:
                got.append(s.writer.get(timeout=0.05))
            except queue.Empty:
                pass
        return [(f.req_id, f.data) for f in got]
    finally:
        s._stop.set()
        t.join(timeout=WAIT)


@pytest.mark.parametrize("scenario", [roundtrip, dispatch_exception,
                                      serve_order_and_unserializable])
def test_answers_are_the_reference_s(scenario):
    ref, port = both(scenario)
    assert port == ref


# -- keep-alive: backoff, jitter, reconnect --------------------------------------

def backoff_sequence(P, failures):
    """``failures`` refused connects, then a connected session; the backoff
    handed to the jitter and the sleeps taken, in order."""
    tr = Transport(P, fail=failures)
    sleeps, backoffs = [], []
    s = make(P, tr, sleeps=sleeps, backoffs=backoffs, jitter=lambda b: b * 0.5)
    s.start()
    try:
        assert wait(lambda: s.connected)
        return (tr.connects, backoffs, sleeps, s.last_connect_error, s.auth_failed,
                s.connect_attempts)
    finally:
        s.stop()


@pytest.mark.parametrize("failures", [0, 1, 3, 9])
def test_backoff_doubles_to_its_cap_as_the_reference_s(failures):
    ref, port = both(backoff_sequence, failures)
    assert port == ref
    assert port[0] == failures + 1 and port[1] == [min(2.0 ** i, 60.0) for i in range(failures)]


def default_jitter(P, seed):
    """The default jitter on backoffs drawn from a numpy seed, with
    ``random`` seeded the same way."""
    rng = np.random.default_rng(seed)
    backoffs = [float(b) for b in rng.choice([1.0, 2.0, 4.0, 60.0], size=16)]
    s = P.session.Session(endpoint="http://x", machine_id="m")
    random.seed(int(rng.integers(1 << 30)))
    return backoffs, [s.jitter_fn(b) for b in backoffs]


def test_default_jitter_is_the_reference_s():
    ref, port = both(default_jitter, SEED)
    assert port == ref
    assert all(0.5 * b <= j < 1.5 * b for b, j in zip(*port))


def reconnect_and_drain(P):
    tr = Transport(P)
    s = make(P, tr)
    s.start()
    try:
        assert wait(lambda: s.connected)
        s.reader.put(P.session.Frame(req_id="stale-1", data={"method": "x"}))
        s.signal_reconnect("remote closed")
        assert wait(lambda: tr.connects == 2 and s.connected)
        tr.push(P, "fresh", {"n": 1})
        assert wait(lambda: any(f.req_id == "fresh" for f in tr.responses))
        return (tr.connects, s.reconnect_count, tr.reader_stops, tr.writer_stops,
                s.last_connect_error, s.reader.empty(),
                sorted({f.req_id for f in tr.responses} - {"stale-1"}))
    finally:
        s.stop()


def test_a_reconnect_drains_the_reader_as_the_reference():
    ref, port = both(reconnect_and_drain)
    assert port == ref
    assert port[:2] == (2, 1)


# -- auth: parking and the token -----------------------------------------------------

def auth_park(P, text, explicit):
    tr = Transport(P, accept=lambda ep, tok: tok == "t2", error=text, auth_error=explicit)
    failures, sleeps = [], []
    s = make(P, tr, sleeps=sleeps)
    s.on_auth_failure = failures.append
    s.start()
    try:
        assert wait(lambda: s.auth_failed)
        at_park = tr.connects
        parked_sleeps = wait(lambda: len(sleeps) >= 5, timeout=WAIT)
        attempts_while_parked = tr.connects - at_park
        s.token = "t2"
        assert wait(lambda: s.connected)
        return (at_park, attempts_while_parked, parked_sleeps, failures, s.auth_failed,
                sorted(set(sleeps)), s.last_connect_error)
    finally:
        s.stop()


@pytest.mark.parametrize("text,explicit", [
    ("HTTP 401 Unauthorized: invalid token", None),
    ("connection reset", True),
    ("handshake rejected: bad token", None),
])
def test_an_auth_failure_parks_until_the_token_changes_as_the_reference(text, explicit):
    ref, port = both(auth_park, text, explicit)
    assert port == ref
    assert port[0] == 1 and port[1] == 0
    assert port[5] == [port_session.AUTH_RECHECK_INTERVAL]


def stop_while_parked(P):
    s = P.session.Session(endpoint="http://127.0.0.1:1", machine_id="m", token="revoked",
                          dispatch_fn=lambda req: {}, jitter_fn=lambda b: 0.0)

    def rejecting_connect():
        raise RuntimeError("HTTP 401 unauthorized: token revoked")

    s._connect = rejecting_connect
    s.start()
    assert wait(lambda: s.auth_failed)
    t0 = time.monotonic()
    s.stop()
    return time.monotonic() - t0 < 3.0, s.auth_failed


def test_stop_from_a_parked_session_is_prompt_as_the_reference():
    ref, port = both(stop_while_parked)
    assert port == ref == (True, True)


# -- the circuit breaker and peer failover --------------------------------------------

def circuit_suppresses(P):
    tr = Transport(P, fail=1 << 30)
    s = make(P, tr)
    s.circuit = P.outbox.CircuitBreaker(failure_threshold=2, open_seconds=60.0)
    s.start()
    try:
        assert wait(lambda: s.circuit.state == P.outbox.CIRCUIT_OPEN)
        at_open = tr.connects
        assert wait(lambda: s.circuit.blocked_count >= 5)
        return at_open, tr.connects - at_open, s.circuit.state
    finally:
        s.stop()


def auth_does_not_trip(P):
    tr = Transport(P, fail=1 << 30, error="401 unauthorized", auth_error=True)
    s = make(P, tr)
    s.circuit = P.outbox.CircuitBreaker(failure_threshold=1, open_seconds=60.0)
    s.start()
    try:
        assert wait(lambda: s.auth_failed)
        return s.circuit.state, tr.connects
    finally:
        s.stop()


def peer_failover(P):
    """The primary refuses; the breaker trips and rotates to the standby
    peer, which accepts (``endpoint|grpc`` and ``id=endpoint`` specs)."""
    tr = Transport(P, accept=lambda ep, tok: ep == "http://standby:8080")
    s = make(P, tr, endpoint="http://primary:8080")
    s.circuit = P.outbox.CircuitBreaker(failure_threshold=1, open_seconds=0.01)
    s.circuit.peers = ["http://primary:8080", "m-b=http://standby:8080|standby:9090"]
    s.start()
    try:
        assert wait(lambda: s.connected)
        st = s.circuit.stats()
        return (s.endpoint, s.v2_target, tr.endpoints[:2], st["peers"], st["peer_index"],
                st["failovers"], st["state"])
    finally:
        s.stop()


@pytest.mark.parametrize("scenario", [circuit_suppresses, auth_does_not_trip, peer_failover])
def test_the_circuit_and_failover_are_the_reference_s(scenario):
    ref, port = both(scenario)
    assert port == ref


def test_peer_failover_lands_on_the_standby():
    port = peer_failover(PORT)
    assert port[:3] == ("http://standby:8080", "standby:9090",
                        ["http://primary:8080", "http://standby:8080"])
    assert port[5] == 1


# -- dropped frames --------------------------------------------------------------------

def frame_drops(P):
    s = P.session.Session(endpoint="https://cp.example", machine_id="m1", token="t",
                          dispatch_fn=lambda req: {},
                          start_reader_fn=lambda session: (lambda: None),
                          start_writer_fn=lambda session: None)
    c = P.session._c_frames_dropped
    before = (c.get(labels={"direction": "write"}), c.get(labels={"direction": "read"}))
    hook = []
    s.on_frame_dropped = lambda direction, detail: hook.append((direction, detail))
    for _ in range(5):
        s.note_frame_dropped("write", "channel full")
    s.note_frame_dropped("read", "channel full")
    s.send_timeout = 0.001
    sent = sum(bool(s.send(P.session.Frame(req_id=f"r{i}", data={}))) for i in range(30))
    after = (c.get(labels={"direction": "write"}), c.get(labels={"direction": "read"}))
    return [a - b for a, b in zip(after, before)], hook, sent, P.session.CHANNEL_CAP


def test_dropped_frames_count_and_rate_limit_their_event_as_the_reference():
    ref, port = both(frame_drops)
    assert port == ref
    assert port[0] == [5 + 30 - port[2], 1] and port[1] == [("write", "channel full"),
                                                            ("read", "channel full")]


# -- the transport cases of test_session_outbox.py -------------------------------------

class _FakeServer:
    config = None

    def __init__(self, outbox=None):
        self.outbox = outbox


def dispatcher_ack(P):
    db = P.sqlite.DB(":memory:")
    ob = P.outbox.SessionOutbox(db, time_now_fn=lambda: 1000.0)
    for i in range(3):
        ob.publish("event", {"i": i})
    d = P.dispatch.Dispatcher(_FakeServer(outbox=ob))
    out = [d({"method": "outboxAck", "seq": 2}), d({"method": "outboxAck", "seq": 1}),
           d({"method": "outboxAck", "seq": "garbage"}), d({"method": "outboxAck", "seq": -1}),
           d({"method": "outboxAck"}), ob.acked_seq,
           P.dispatch.Dispatcher(_FakeServer(outbox=None))({"method": "outboxAck", "seq": 1})]
    db.close()
    return out


def test_the_dispatcher_s_ack_path_is_the_reference_s():
    ref, port = both(dispatcher_ack)
    assert port == ref
    assert port[:2] == [{"acked_seq": 2}, {"acked_seq": 2}]


# -- auth classification ---------------------------------------------------------------

class _HttpError(Exception):
    def __init__(self, status_code, text=None):
        class R:
            pass

        self.response = R()
        self.response.status_code = status_code
        super().__init__(text or f"HTTP {status_code}")


class _GrpcError(Exception):
    def __init__(self, name):
        self._name = name
        super().__init__(name)

    def code(self):
        return types.SimpleNamespace(name=self._name)


class _BrokenGrpcError(Exception):
    def code(self):
        raise RuntimeError("no status")


def _explicit(text, flag):
    e = RuntimeError(text)
    e.auth_error = flag
    return e


CLASSIFY = [
    _HttpError(401), _HttpError(403), _HttpError(500), _HttpError(429),
    _HttpError(503, "503 unauthorized proxy blurb"),
    _GrpcError("UNAUTHENTICATED"), _GrpcError("PERMISSION_DENIED"), _GrpcError("UNAVAILABLE"),
    _GrpcError("DEADLINE_EXCEEDED"), _BrokenGrpcError(),
    "401 Client Error: Unauthorized for url", "handshake rejected: bad token",
    "v2 stream: StatusCode.UNAUTHENTICATED", "connection refused", "read timeout",
    "GET http://cp/route4012 failed: connection reset", "grpc UNAUTHENTICATED: bad creds",
    "403 Forbidden", "connection refused to http://cp:4013/api",
    "[Errno 13] Permission denied: '/var/run/x'", "invalid machine proof",
    _explicit("connection reset", True), _explicit("401 unauthorized", False),
]


@pytest.mark.parametrize("reason", CLASSIFY, ids=[str(i) for i in range(len(CLASSIFY))])
def test_is_auth_error_classifies_as_the_reference(reason):
    assert port_session.is_auth_error(reason) is ref_session.is_auth_error(reason)


@pytest.mark.parametrize("status,auth", [(401, True), (403, True), (500, False), (429, False),
                                         (503, False)])
def test_the_port_s_http_error_classifies_as_requests_http_error(status, auth):
    """``HTTPStatusError`` (the port's transport) reads as the reference
    reads a ``requests`` ``HTTPError`` of the same status, whatever its
    text says."""
    e = HTTPStatusError(status, "Unauthorized" if status == 503 else "x", "http://cp/api")
    assert port_session.is_auth_error(e) is auth
    assert ref_session.is_auth_error(_HttpError(status, str(e))) is auth


def test_v2_handshake_rejection_carries_its_auth_flag_as_the_reference():
    from gpud_tpu.session.v2.client import HandshakeRejected as RefRejected
    from gpud_tpu_torch.session.v2.client import HandshakeRejected as PortRejected

    for cls in (RefRejected, PortRejected):
        exc = cls("bad token")
        exc.auth_error = True
        assert port_session.is_auth_error(exc) and ref_session.is_auth_error(exc)
        assert not port_session.is_auth_error(cls("draining"))


def test_frames_are_the_reference_s():
    for data in ({"x": 1}, {"nested": {"链": [1, {"x": None}]}}, {"msg": "line1\nline2"}):
        a, b = ref_session.Frame("r-ü", data), port_session.Frame("r-ü", data)
        assert a.to_json() == b.to_json() and "\n" not in b.to_json()
    for bad in ("", "not json", "[1,2]", '"just a string"', "42", '{"data": {}}'):
        a, b = ref_session.Frame.from_json(bad), port_session.Frame.from_json(bad)
        assert (a is None) == (b is None)
        assert a is None or (a.req_id, a.data) == (b.req_id, b.data)
