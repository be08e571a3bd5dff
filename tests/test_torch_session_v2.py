"""Parity of the port's session protocol v2 (gpud_tpu_torch/session/v2/:
the copied ``session_pb2``, ``typed`` and the gRPC ``client``) with
gpud_tpu's, on the cases of the reference's tests/test_session_v2.py and
test_session_v2_typed.py.

The typed requests of every method encode to the same bytes in both
packages and decode to the same dispatcher request; the port's names for
the accelerator (``gpu_error_name``, ``gpu_id``) ride the protocol's fields
``tpu_error_name`` and ``chip_id``. Both packages' ``Session`` then run
against an in-process gRPC manager on 127.0.0.1 — the reference test's
``FakeManagerV2`` at revisions 0-2 and the stdlib plane's gRPC front at
revision 3 — and what each manager received must be the same."""

import time
import types

import pytest

grpc = pytest.importorskip("grpc")

import gpud_tpu.session.outbox as ref_outbox  # noqa: E402
import gpud_tpu.session.session as ref_session  # noqa: E402
import gpud_tpu.session.wire as ref_wire  # noqa: E402
import gpud_tpu.sqlite as ref_sqlite  # noqa: E402
import gpud_tpu_torch.session.outbox as port_outbox  # noqa: E402
import gpud_tpu_torch.session.session as port_session  # noqa: E402
import gpud_tpu_torch.session.wire as port_wire  # noqa: E402
import gpud_tpu_torch.sqlite as port_sqlite  # noqa: E402
from gpud_tpu.session.v2 import client as ref_client  # noqa: E402
from gpud_tpu.session.v2 import session_pb2 as ref_pb  # noqa: E402
from gpud_tpu.session.v2 import typed as ref_typed  # noqa: E402
from gpud_tpu_torch.session.v2 import client as port_client  # noqa: E402
from gpud_tpu_torch.session.v2 import session_pb2 as port_pb  # noqa: E402
from gpud_tpu_torch.session.v2 import typed as port_typed  # noqa: E402

from tests.test_session_v2 import FakeManagerV2  # noqa: E402
from tests.test_session_v2_typed import ROUNDTRIP_CASES  # noqa: E402
from torch_loopback_plane import LoopbackPlane  # noqa: E402

REF = types.SimpleNamespace(name="ref", session=ref_session, typed=ref_typed, pb=ref_pb,
                            client=ref_client, outbox=ref_outbox, wire=ref_wire,
                            sqlite=ref_sqlite)
PORT = types.SimpleNamespace(name="port", session=port_session, typed=port_typed, pb=port_pb,
                             client=port_client, outbox=port_outbox, wire=port_wire,
                             sqlite=port_sqlite)
WAIT = 15.0
# the dispatcher's names for the accelerator, reference -> port
NOUNS = {"tpu_error_name": "gpu_error_name", "chip_id": "gpu_id"}


def wait(cond, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


def port_request(req: dict) -> dict:
    return {NOUNS.get(k, k): v for k, v in req.items()}


# -- typed requests -----------------------------------------------------------------

@pytest.mark.parametrize("req", ROUNDTRIP_CASES,
                         ids=[c["method"] + str(i) for i, c in enumerate(ROUNDTRIP_CASES)])
def test_typed_requests_encode_and_decode_as_the_reference(req):
    ref_pkt = ref_typed.dict_to_request(req, "rt-1")
    port_pkt = port_typed.dict_to_request(port_request(req), "rt-1")
    assert port_pkt.SerializeToString() == ref_pkt.SerializeToString()
    wire = port_pb.ManagerPacket.FromString(ref_pkt.SerializeToString())
    assert port_typed.request_to_dict(wire) == port_request(ref_typed.request_to_dict(ref_pkt))
    assert port_typed.request_to_dict(wire) == port_request(req)


def test_typed_covers_the_reference_s_methods():
    assert port_typed.FIELD_TO_METHOD == ref_typed.FIELD_TO_METHOD
    assert port_typed.METHOD_TO_FIELD == ref_typed.METHOD_TO_FIELD
    for T in (ref_typed, port_typed):
        with pytest.raises(T.UnsupportedRequest):
            T.dict_to_request({"method": "notAThing"}, "x")
        with pytest.raises(T.UnsupportedRequest):
            T.request_to_dict(port_pb.ManagerPacket())


@pytest.mark.parametrize("section,raw", [("nvlink", '{"flap_threshold": 3}'), ("bad", "{nope")])
def test_update_config_sections_decode_as_the_reference(section, raw):
    got = []
    for T in (ref_typed, port_typed):
        pkt = port_pb.ManagerPacket()
        pkt.update_config.configs_json[section] = raw
        try:
            got.append(T.request_to_dict(pkt))
        except T.UnsupportedRequest as e:
            got.append(str(e))
    assert got[0] == got[1]


@pytest.mark.parametrize("payload", [{"status": "ok"}, {"big": "x" * 5000}, {"error": "e"}])
@pytest.mark.parametrize("compress", [False, True])
def test_results_are_the_reference_s_bytes(payload, compress):
    a = ref_typed.make_result("req-1", payload, compress=compress).SerializeToString()
    b = port_typed.make_result("req-1", payload, compress=compress).SerializeToString()
    assert a == b
    assert ref_typed.error_result("r", "m", compress).SerializeToString() == \
        port_typed.error_result("r", "m", compress).SerializeToString()


def test_negotiation_and_targets_are_the_reference_s():
    for ack in range(-1, 5):
        for top in (1, 2, 3):
            assert port_typed.negotiate_revision(ack, top) == ref_typed.negotiate_revision(ack, top)
    for endpoint, override in [("https://cp.example", ""), ("http://1.2.3.4:9000", ""),
                               ("cp.example:15000", ""), ("https://cp:8443/x", "grpc:9443"),
                               ("https://cp", "http://plain:1"), ("http://cp", "https://tls:2")]:
        assert port_client.resolve_v2_target(endpoint, override) == \
            ref_client.resolve_v2_target(endpoint, override)
    assert (port_client.METHOD, port_client.MIN_REVISION, port_client.MAX_REVISION,
            port_client.CAPABILITIES) == (ref_client.METHOD, ref_client.MIN_REVISION,
                                          ref_client.MAX_REVISION, ref_client.CAPABILITIES)


# -- the gRPC client ------------------------------------------------------------------

def v2_session(P, port, dispatch, token="tok"):
    s = P.session.Session(endpoint=f"http://127.0.0.1:{port}", machine_id="m-v2", token=token,
                          machine_proof="proof", dispatch_fn=dispatch, protocol="v2",
                          jitter_fn=lambda b: 0.01)
    s.time_sleep_fn = lambda secs: s._stop.wait(min(secs, 0.02))
    return s


def against_fake_manager(P, revision):
    """Hello, a rev-1 frame or a rev-2 typed request, a drain notice and the
    reconnect, against the reference test's manager acking ``revision``."""
    m = FakeManagerV2(revision=revision)
    m.start()
    s = v2_session(P, m.port, lambda req: {"echo": req})
    s.start()
    try:
        assert wait(lambda: s.connected)
        h = m.hellos[0]
        hello = (h.machine_id, h.token, h.machine_proof, h.tpud_version, h.revision,
                 h.min_revision, h.max_revision, list(h.capabilities))
        if revision >= 2:
            pkt = ref_pb.ManagerPacket()
            pkt.request_id = "req-42"
            pkt.get_states.components.append("cpu")
            m.outbound.put(pkt)
            assert wait(lambda: m.results)
        else:
            m.outbound.put(("r1", {"method": "ping"}))
            assert wait(lambda: m.responses)
        m.drain.set()
        assert wait(lambda: s.reconnect_count >= 1)
        m.drain.clear()
        assert wait(lambda: s.connected and len(m.hellos) >= 2)
        return hello, m.responses, m.results, s.active_protocol
    finally:
        s.stop()
        m.stop()


@pytest.mark.parametrize("revision", [0, 1, 2])
def test_the_client_against_a_grpc_manager_is_the_reference_s(revision):
    ref, port = against_fake_manager(REF, revision), against_fake_manager(PORT, revision)
    assert port == ref
    assert port[0][4:7] == (1, 1, 3) and port[3] == "v2"


def rejected(P):
    m = FakeManagerV2(reject=True)
    m.start()
    s = v2_session(P, m.port, lambda req: {})
    s.start()
    try:
        assert wait(lambda: s.auth_failed)
        at_park = len(m.hellos)
        time.sleep(0.3)
        return s.last_connect_error, len(m.hellos) - at_park, s.connected
    finally:
        s.stop()
        m.stop()


def unauthenticated(P):
    class AuthRejectManager(FakeManagerV2):
        def __init__(self):
            super().__init__()
            self.attempts = 0

        def _connect(self, request_iterator, context):
            self.attempts += 1
            next(request_iterator)
            context.abort(grpc.StatusCode.UNAUTHENTICATED, "token revoked")
            yield  # unreachable; makes this a generator

    m = AuthRejectManager()
    m.start()
    s = v2_session(P, m.port, lambda req: {}, token="revoked")
    s.start()
    try:
        assert wait(lambda: s.auth_failed)
        at_park = m.attempts
        time.sleep(0.3)
        storm = m.attempts - at_park
        s.token = "fresh"
        assert wait(lambda: m.attempts > at_park)
        return storm, s.last_connect_error.split(":")[0]
    finally:
        s.stop()
        m.stop()


@pytest.mark.parametrize("scenario", [rejected, unauthenticated])
def test_a_refused_v2_session_parks_as_the_reference(scenario):
    ref, port = scenario(REF), scenario(PORT)
    assert port == ref
    assert port[1 if scenario is rejected else 0] == 0


def auto_falls_back(P):
    plane = LoopbackPlane().start()
    s = P.session.Session(endpoint=plane.endpoint, machine_id="m-auto", protocol="auto",
                          dispatch_fn=lambda req: {"ok": True}, jitter_fn=lambda b: 0.01)
    s.start()
    try:
        assert wait(lambda: s.connected)
        return s.active_protocol, s._v2_failed, s._v2_skip_cycles
    finally:
        s.stop()
        plane.stop()


def test_auto_falls_back_to_v1_and_remembers_as_the_reference():
    ref, port = auto_falls_back(REF), auto_falls_back(PORT)
    assert port == ref == ("v1", True, 10)


class _Server:
    config = None

    def __init__(self, outbox):
        self.outbox = outbox


def revision_3(P):
    """The stdlib plane's gRPC front at revision 3: a request, an outbox
    replay through the wire codec's framing, the plane's ack."""
    import gpud_tpu_torch.session.dispatch as port_dispatch
    import gpud_tpu.session.dispatch as ref_dispatch

    dispatch = ref_dispatch if P is REF else port_dispatch
    db = P.sqlite.DB(":memory:")
    ob = P.outbox.SessionOutbox(db, time_now_fn=lambda: 1000.0)
    for i in range(4):
        ob.publish("event", {"component": "gpu0", "i": i, "pad": "x" * 600}, dedupe_key=f"k{i}")
    plane = LoopbackPlane(wire=P.wire, pb=P.pb, auto_ack=True).start()
    plane.start_v2()
    s = P.session.Session(endpoint=plane.endpoint, machine_id="m3", token="tok",
                          v2_target=f"http://127.0.0.1:{plane.v2_port}", protocol="v2",
                          dispatch_fn=dispatch.Dispatcher(_Server(ob)), jitter_fn=lambda b: 0.01)
    s.start()
    try:
        assert wait(lambda: s.connected)
        plane.send_request("m3", "q1", {"method": "outboxStatus"})
        status = plane.wait_response("q1", WAIT)
        assert ob.replay_once(s) == 4
        assert wait(lambda: ob.acked_seq == 4)
        recs = [(r[1], r[2], r[3], r[4], r[5], r[6]) for r in plane.records()]
        hello = {k: v for k, v in plane.headers[0].items() if k != "tpud_version"}
        return hello, status["data"]["outbox"]["last_seq"], recs, ob.backlog()
    finally:
        s.stop()
        plane.stop()
        db.close()


def test_revision_3_through_the_stdlib_plane_is_the_reference_s():
    ref, port = revision_3(REF), revision_3(PORT)
    assert port == ref
    assert [r[0] for r in port[2]] == [1, 2, 3, 4] and port[3] == 0
