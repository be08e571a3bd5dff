"""Session v2 transport: gRPC bidi stream.

Reference: pkg/session/session_v2.go:36-80 — a single
``Connect(AgentPacket) ↔ ManagerPacket`` stream with Hello/HelloAck
handshake and DrainNotice handling; protocol "auto" tries v2 first and
falls back to legacy v1 (session_v2.go:49-80).

Stubs are hand-written over ``channel.stream_stream`` (grpc_tools isn't in
the image); messages come from protoc-generated session_pb2.

The port of ``gpud_tpu/session/v2/client.py``. ``grpc`` and the generated
messages load when ``start_v2_transport`` runs (the session's ``_connect``
imports this module only when it tries v2), never at import. A send pump
whose stream was replaced hands the frame it took back to the session's
writer channel (ROADMAP C7).
"""

from __future__ import annotations

import queue
import threading
from typing import TYPE_CHECKING, Callable, Optional

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.session.session import is_auth_error
from gpud_tpu_torch.session.v2 import typed
from gpud_tpu_torch.version import __version__

if TYPE_CHECKING:
    from gpud_tpu_torch.session.session import Session
    from gpud_tpu_torch.session.v2 import session_pb2 as pb

logger = get_logger(__name__)

METHOD = "/tpud.session.v2.Session/Connect"
# rev 1: JSON Frames over gRPC; rev 2: typed per-method ManagerPacket
# requests answered with Result packets (see session.proto header);
# rev 3: every Frame.data / Result.payload_json byte string carries the
# 1-byte wire-codec prefix (session/wire.py — "j" raw JSON, "z" zlib),
# negotiated exactly like rev 2 so a rev-2 peer still interoperates on
# bare JSON bytes
MIN_REVISION = 1
MAX_REVISION = 3
CAPABILITIES = ["typed-requests", "drain-notice", "wire-zlib"]
HANDSHAKE_TIMEOUT = 10.0


def grpc_target_from_endpoint(endpoint: str) -> str:
    """https://cp.example:8443/x → cp.example:8443 (gRPC dials host:port)."""
    from urllib.parse import urlparse

    u = urlparse(endpoint if "//" in endpoint else f"//{endpoint}")
    host = u.hostname or endpoint
    port = u.port or (443 if u.scheme == "https" else 80)
    return f"{host}:{port}"


def resolve_v2_target(endpoint: str, override: str) -> "tuple[str, bool]":
    """(host:port, use_tls) for the gRPC dial.

    Split-port deployments carry the gRPC target on the Session (param or
    TPUD_SESSION_V2_TARGET env — resolved in Session.__init__); an
    explicit scheme on the override pins its own TLS mode so a dev
    plaintext target doesn't get wrapped in ssl credentials, while a bare
    host:port inherits the endpoint's scheme."""
    if override:
        use_tls = (
            override.startswith("https://")
            if "//" in override
            else endpoint.startswith("https")
        )
        return grpc_target_from_endpoint(override), use_tls
    return grpc_target_from_endpoint(endpoint), endpoint.startswith("https")


class HandshakeRejected(Exception):
    """HelloAck rejection (or connect-time RpcError). ``auth_error``
    carries the structured auth-vs-network classification computed at the
    failure site — ``is_auth_error`` reads it before any text matching,
    so a revoked token parks the keep-alive loop the same way v1's HTTP
    401 does instead of retrying through backoff forever."""

    auth_error: bool = False


def start_v2_transport(session: "Session") -> Callable[[], None]:
    """Transport function with the (start_reader_fn) contract of
    Session: starts pump threads, returns a stop(). Raises on connection
    or handshake failure so the keep-alive loop can fall back to v1."""
    import grpc

    from gpud_tpu_torch.session.v2 import session_pb2 as pb

    target, use_tls = resolve_v2_target(
        session.endpoint, getattr(session, "v2_target", "")
    )
    if use_tls:
        channel = grpc.secure_channel(target, grpc.ssl_channel_credentials())
    else:
        channel = grpc.insecure_channel(target)

    stream = channel.stream_stream(
        METHOD,
        request_serializer=pb.AgentPacket.SerializeToString,
        response_deserializer=pb.ManagerPacket.FromString,
    )

    out_q: "queue.Queue[Optional[pb.AgentPacket]]" = queue.Queue()
    stopped = threading.Event()
    handshake_ok = threading.Event()
    handshake_err: list = []
    # parallel to handshake_err: structured auth classification computed
    # while the failure object (grpc code / rejection reason) was live
    handshake_auth: list = []
    # reconnect signals are only valid once this transport was adopted —
    # a failed v2 probe must not tear down the v1 fallback that follows
    established = threading.Event()

    hello = pb.AgentPacket()
    hello.hello.machine_id = session.machine_id
    hello.hello.token = session.token
    hello.hello.machine_proof = session.machine_proof
    hello.hello.tpud_version = __version__
    # rev-1 compat field: an old manager reads `revision` and never sees
    # the range; a rev-2 manager negotiates from [min, max]
    hello.hello.revision = MIN_REVISION
    hello.hello.min_revision = MIN_REVISION
    hello.hello.max_revision = MAX_REVISION
    hello.hello.capabilities.extend(CAPABILITIES)
    out_q.put(hello)
    # negotiated revision, fixed at handshake before send_pump starts
    negotiated = [MIN_REVISION]

    def request_iter():
        while not stopped.is_set():
            try:
                pkt = out_q.get(timeout=0.5)
            except queue.Empty:
                continue
            if pkt is None:
                return
            yield pkt

    call = stream(request_iter())

    def _signal_if_established(reason: str, auth: Optional[bool] = None) -> None:
        """A disconnect after adoption must reconnect the session; one
        during a failed probe must not poison the v1 fallback. The drain/
        EOF may race the main thread between handshake-ok and adoption, so
        wait briefly for the verdict instead of sampling it. ``auth``
        forwards the structured classification to the keep-alive loop."""
        if stopped.is_set():
            return
        if established.wait(HANDSHAKE_TIMEOUT) and not stopped.is_set():
            session.signal_reconnect(reason, auth=auth)

    def _enqueue_request(req_id: str, data) -> bool:
        """Hand one inbound request to the session serve loop; False when
        the reader channel is saturated."""
        from gpud_tpu_torch.session.session import Frame

        try:
            session.reader.put(Frame(req_id=req_id, data=data), timeout=5.0)
            return True
        except queue.Full:
            session.note_frame_dropped(
                "read", "v2 reader channel full; dropping request"
            )
            return False

    def recv_pump():
        try:
            for mpkt in call:
                if stopped.is_set():
                    return
                kind = mpkt.WhichOneof("payload")
                if kind == "hello_ack":
                    if not mpkt.hello_ack.accepted:
                        reason = mpkt.hello_ack.reason or "rejected"
                        handshake_err.append(reason)
                        # the HelloAck vocabulary is narrow ("bad token",
                        # "invalid machine proof" vs revision mismatch);
                        # classify here, at the authoritative site
                        handshake_auth.append(is_auth_error(reason))
                        handshake_ok.set()
                        return
                    negotiated[0] = typed.negotiate_revision(
                        mpkt.hello_ack.revision, MAX_REVISION
                    )
                    handshake_ok.set()
                elif kind == "frame":
                    import json

                    try:
                        if negotiated[0] >= 3:
                            from gpud_tpu_torch.session import wire

                            data = wire.decode_payload(mpkt.frame.data)
                        else:
                            data = json.loads(mpkt.frame.data.decode("utf-8"))
                    except ValueError:
                        continue
                    _enqueue_request(mpkt.frame.req_id, data)
                elif kind == "drain_notice":
                    logger.info(
                        "manager drain notice: %s", mpkt.drain_notice.reason
                    )
                    _signal_if_established("manager draining")
                    return
                else:
                    # rev-2 typed request (or a payload newer than this
                    # agent): adapt onto the same serve loop as rev-1
                    # frames; unknowns and overload answer an error Result
                    # so the manager's request_id never dangles
                    try:
                        req = typed.request_to_dict(mpkt)
                    except typed.UnsupportedRequest as e:
                        if mpkt.request_id:
                            out_q.put(typed.error_result(
                                mpkt.request_id, str(e),
                                compress=negotiated[0] >= 3,
                            ))
                        continue
                    if not _enqueue_request(mpkt.request_id, req) and mpkt.request_id:
                        out_q.put(
                            typed.error_result(
                                mpkt.request_id, "agent busy: request dropped",
                                compress=negotiated[0] >= 3,
                            )
                        )
            if not stopped.is_set():
                handshake_err.append("stream closed before ack")
                handshake_auth.append(False)
                handshake_ok.set()
                _signal_if_established("v2 stream closed", auth=False)
        except grpc.RpcError as e:
            # classify while the live error object still carries its grpc
            # code — the formatted string a later is_auth_error would see
            # loses UNAUTHENTICATED/PERMISSION_DENIED structure (v1 parity:
            # the HTTP transports classify from the response status)
            auth = is_auth_error(e)
            handshake_err.append(str(e))
            handshake_auth.append(auth)
            handshake_ok.set()
            if not stopped.is_set():
                _signal_if_established(f"v2 stream: {e.code()}", auth=auth)

    def send_pump():
        import json

        while not stopped.is_set():
            try:
                frame = session.writer.get(timeout=0.5)
            except queue.Empty:
                continue
            if stopped.is_set():
                # replaced while it waited: the next transport sends it
                # (ROADMAP C7)
                session.requeue_front(frame)
                return
            if negotiated[0] >= 2:
                # rev 2: responses are Result packets keyed by request_id;
                # rev 3 adds the wire-codec framing on the payload bytes
                pkt = typed.make_result(
                    frame.req_id, frame.data, compress=negotiated[0] >= 3
                )
            else:
                pkt = pb.AgentPacket()
                pkt.frame.req_id = frame.req_id
                pkt.frame.data = json.dumps(frame.data).encode("utf-8")
            out_q.put(pkt)

    recv_t = threading.Thread(target=recv_pump, name="tpud-v2-recv", daemon=True)
    recv_t.start()

    if not handshake_ok.wait(HANDSHAKE_TIMEOUT):
        stopped.set()
        call.cancel()
        channel.close()
        raise TimeoutError("v2 handshake timed out")
    if handshake_err:
        stopped.set()
        call.cancel()
        channel.close()
        exc = HandshakeRejected(handshake_err[0])
        exc.auth_error = bool(handshake_auth[0]) if handshake_auth else False
        raise exc

    established.set()
    send_t = threading.Thread(target=send_pump, name="tpud-v2-send", daemon=True)
    send_t.start()

    def stop():
        stopped.set()
        out_q.put(None)
        try:
            call.cancel()
        except Exception:  # noqa: BLE001
            pass
        channel.close()

    return stop
