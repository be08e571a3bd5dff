"""Control-plane session — bidirectional channel to the fleet manager; the
port of ``gpud_tpu/session/session.py``.

Reference: pkg/session (SURVEY §3.3). Protocol v1: two long-lived chunked
HTTP streams against ``<endpoint>/api/v1/session`` —
- writer: POST with ``X-TPUD-Session-Type: write``, chunked request body
  carrying newline-delimited JSON responses up (reference:
  session.go:525-575),
- reader: POST with type ``read``, streaming newline-delimited JSON
  requests down (reference: session.go:619+).

Each frame is ``{"req_id": str, "data": {...}}``. The keep-alive loop
reconnects both streams with exponential backoff + jitter, and drains the
reader channel on reconnect (reference: session_keepalive.go:11,
session_reconnect.go). Auth rides headers: machine id, token, machine
proof (reference: session.go:486-510).

Both v1 streams run on the standard library's ``http.client`` where the
reference package uses ``requests``: the same URL, headers, ndjson framing,
keep-alive line and timeouts, one transport on every host. A non-2xx
answer raises ``HTTPStatusError``, whose ``status`` ``is_auth_error``
reads as the reference reads ``requests``' ``HTTPError``. Protocol v2
(gRPC) is imported only when ``_connect`` tries it.

Every network-touching function is injectable for tests
(reference pattern: session.go:262-296 timeAfterFunc/jitterFunc/
startReaderFunc).
"""

from __future__ import annotations

import json
import queue
import random
import threading
import time
from typing import Callable, Dict, Optional

from gpud_tpu_torch import http_client
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter
from gpud_tpu_torch.version import __version__

logger = get_logger(__name__)

CHANNEL_CAP = 20          # reference: session.go:420-423
PIPE_INTERVAL = 3.0       # reference: server.go:616
BACKOFF_INITIAL = 1.0
BACKOFF_MAX = 60.0
BACKOFF_FACTOR = 2.0
# while auth-parked, how often to re-check whether the token changed
AUTH_RECHECK_INTERVAL = 5.0
# rate limit on the Warning event emitted when a session channel drops a
# frame (the counter still counts every drop)
FRAME_DROP_EVENT_INTERVAL = 30.0
# while the circuit breaker is open, cap each wait slice so stop() and
# token changes stay responsive
CIRCUIT_WAIT_SLICE = 1.0

_c_frames_dropped = counter(
    "tpud_session_frames_dropped_total",
    "frames dropped by a full session channel, by direction (read = "
    "manager requests, write = agent responses/outbox deliveries)",
)

# anchored so incidental digits ("port=4013") and local OS errors
# ("[Errno 13] Permission denied") never classify as auth failures
import re as _re

_AUTH_ERROR_RE = _re.compile(
    r"(\b40[13]\b"
    r"|unauthenticated"
    r"|unauthorized"
    r"|permission_denied"     # grpc enum spelling only, not OS errors
    r"|invalid token"
    r"|bad token"             # v2 HelloAck rejection vocabulary
    r"|invalid machine proof)",
    _re.IGNORECASE,
)


def is_auth_error(reason) -> bool:
    """Classify a connect failure as an auth failure (revoked/invalid
    token) vs a network blip (reference: session_reconnect.go:38-226 +
    session_v2.go:359 classify Unauthenticated/401). Prefers structured
    fields (a pre-classified ``auth_error`` attribute, HTTP status, grpc
    code); text matching is anchored."""
    explicit = getattr(reason, "auth_error", None)
    if explicit is not None:
        return bool(explicit)
    status = getattr(reason, "status", None)
    if isinstance(status, int) and not isinstance(status, bool):
        # the port's HTTP transport (HTTPStatusError): a definite status
        return status in (401, 403)
    resp = getattr(reason, "response", None)
    if resp is not None:
        code = getattr(resp, "status_code", None)
        if code in (401, 403):
            return True
        if code is not None:
            return False  # a definite non-auth HTTP status
    code_fn = getattr(reason, "code", None)
    if callable(code_fn):
        try:  # grpc.RpcError
            name = getattr(code_fn(), "name", "")
            if name in ("UNAUTHENTICATED", "PERMISSION_DENIED"):
                return True
            if name:
                return False  # a definite non-auth grpc code
        except Exception:  # noqa: BLE001
            pass
    return bool(_AUTH_ERROR_RE.search(str(reason)))

HEADER_SESSION_TYPE = "X-TPUD-Session-Type"
HEADER_MACHINE_ID = "X-TPUD-Machine-ID"
HEADER_TOKEN = "Authorization"
HEADER_MACHINE_PROOF = "X-TPUD-Machine-Proof"
HEADER_VERSION = "X-TPUD-Version"


class Frame:
    """One wire frame (reference: session.go Body{ReqID, Data})."""

    def __init__(self, req_id: str = "", data: Optional[dict] = None) -> None:
        self.req_id = req_id
        self.data = data or {}
        self._encoded: Optional[str] = None

    def to_json(self) -> str:
        # cached: the serve loop encodes once to validate serializability;
        # the transport writer reuses that encoding (frames are not
        # mutated after construction)
        if self._encoded is None:
            self._encoded = json.dumps({"req_id": self.req_id, "data": self.data})
        return self._encoded

    @classmethod
    def from_json(cls, line: str) -> Optional["Frame"]:
        try:
            d = json.loads(line)
        except ValueError:
            return None
        if not isinstance(d, dict):
            return None
        return cls(req_id=str(d.get("req_id", "")), data=d.get("data") or {})


class Session:
    """reference: session.NewSession (session.go:342)."""

    def __init__(
        self,
        endpoint: str,
        machine_id: str,
        token: str = "",
        machine_proof: str = "",
        dispatch_fn: Optional[Callable[[dict], dict]] = None,
        start_reader_fn=None,
        start_writer_fn=None,
        jitter_fn: Callable[[float], float] = None,
        time_sleep_fn: Callable[[float], bool] = None,
        audit_logger=None,
        protocol: str = "auto",
        v2_target: str = "",
    ) -> None:
        self.endpoint = endpoint.rstrip("/")
        # split-port deployments (e.g. the standalone dev control plane
        # serves HTTP and gRPC on different ports) advertise the gRPC
        # target apart from the HTTP endpoint. Resolution: explicit param
        # > TPUD_SESSION_V2_TARGET env > derived from endpoint. May carry
        # a scheme ("http://host:p" pins plaintext, "https://" pins TLS);
        # bare host:port inherits the endpoint's scheme.
        import os as _os

        self.v2_target = v2_target or _os.environ.get(
            "TPUD_SESSION_V2_TARGET", ""
        )
        self.machine_id = machine_id
        self.token = token
        self.machine_proof = machine_proof
        self.dispatch_fn = dispatch_fn or (lambda req: {"error": "no dispatcher"})

        self.reader: "queue.Queue[Frame]" = queue.Queue(maxsize=CHANNEL_CAP)
        self.writer: "queue.Queue[Frame]" = queue.Queue(maxsize=CHANNEL_CAP)

        self._stop = threading.Event()
        self._threads = []
        self._reconnect_signal = threading.Event()
        self._connected = threading.Event()
        self.reconnect_count = 0
        self.last_connect_error: str = ""
        # injectable like jitter_fn/time_sleep_fn: tests shrink it so the
        # full-queue path doesn't cost 5s of wall clock per probe
        self.send_timeout = 5.0
        # auth-failure classification (reference: session_reconnect.go
        # 38-226): a revoked token parks the reconnect loop instead of
        # hammering the control plane with the normal backoff forever
        self.auth_failed = False
        self.on_auth_failure: Optional[Callable[[str], None]] = None
        # fires after every successful connect with the credential that
        # worked — the server persists the endpoint+token pair here, so
        # only credentials the control plane actually accepted are recorded
        self.on_connected: Optional[Callable[[], None]] = None
        # set by the server's auth-failure handler after it promotes the
        # boot-flag token once; guards against credential ping-pong
        self.flag_token_tried = False
        # optional connect-path circuit breaker (session/outbox.py): the
        # server injects one so a hard-down manager stops costing connect
        # attempts; None = classic backoff-only behavior (tests, tools)
        self.circuit = None
        # frame-drop visibility (tpud_session_frames_dropped_total): the
        # server wires an event emitter here; calls are rate-limited to
        # one per direction per FRAME_DROP_EVENT_INTERVAL
        self.on_frame_dropped: Optional[Callable[[str, str], None]] = None
        self._last_drop_note: Dict[str, float] = {}
        # structured auth classification of last_connect_error: transports
        # classify mid-stream failures while the exception object is live
        # (HTTP status / grpc code) instead of regexing the formatted
        # string later; None = unclassified, fall back to is_auth_error()
        self._last_reason_auth: Optional[bool] = None
        # connect attempts ever made (chaos proves the open circuit keeps
        # this flat)
        self.connect_attempts = 0

        # protocol auto: try v2 gRPC, fall back to legacy v1 dual streams
        # (reference: session_v2.go:49-80); injected transports pin v1
        self.protocol = "v1" if start_reader_fn is not None else protocol
        self.active_protocol = ""

        # injectables
        self.start_reader_fn = start_reader_fn or self._http_reader
        self.start_writer_fn = start_writer_fn or self._http_writer
        self.jitter_fn = jitter_fn or (lambda b: b * (0.5 + random.random()))
        # returns True if stop was requested during the sleep
        self.time_sleep_fn = time_sleep_fn or (lambda s: self._stop.wait(s))
        self.audit_logger = audit_logger

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        for name, target in (
            ("tpud-session-keepalive", self._keep_alive),
            ("tpud-session-serve", self._serve),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._reconnect_signal.set()
        for t in self._threads:
            t.join(timeout=3.0)
        self._threads.clear()

    @property
    def connected(self) -> bool:
        return self._connected.is_set()

    def _apply_peer(self, spec: str) -> None:
        """Retarget this session at the breaker's current peer. Accepts
        a bare endpoint, ``endpoint|grpc_target``, or the full
        ``peer_id=endpoint[|grpc_target]`` manager spec; a no-op when
        the spec is empty or already the active target. Only the
        keep-alive thread calls this, between connects."""
        if not spec:
            return
        raw = spec.strip()
        _head, sep, tail = raw.partition("=")
        if sep and "://" in tail:
            raw = tail  # peer_id=endpoint form: the id is routing-only
        endpoint, _, grpc_target = raw.partition("|")
        endpoint = endpoint.strip().rstrip("/")
        grpc_target = grpc_target.strip()
        if not endpoint:
            return
        if endpoint == self.endpoint and (
            not grpc_target or grpc_target == self.v2_target
        ):
            return
        logger.warning(
            "session failing over: %s -> %s", self.endpoint, endpoint
        )
        self.endpoint = endpoint
        self.v2_target = grpc_target
        # the new peer negotiates its own transport: a v1-only previous
        # peer must not pin the replacement to v1
        self._v2_failed = False
        self._v2_skip_cycles = 0

    # -- keep-alive / reconnect (reference: session_keepalive.go,
    #    session_reconnect.go) -------------------------------------------
    def _keep_alive(self) -> None:
        backoff = BACKOFF_INITIAL
        while not self._stop.is_set():
            cb = self.circuit
            if cb is not None and not cb.allow():
                # circuit open: no network attempt at all until the
                # cooldown elapses (the connect-attempt counter must stay
                # flat); wake in bounded slices so stop() stays responsive
                wait = min(
                    max(cb.seconds_until_probe(), 0.05), CIRCUIT_WAIT_SLICE
                )
                if self.time_sleep_fn(wait):
                    return
                continue
            if cb is not None:
                # HA failover: the breaker owns which manager to dial
                # (it rotates current_peer() on every trip to open);
                # retarget BEFORE the attempt so the immediate failover
                # probe already lands on the new peer
                self._apply_peer(cb.current_peer())
            self._drain_reader()
            self._reconnect_signal.clear()
            self._last_reason_auth = None
            self.connect_attempts += 1
            try:
                stops = self._connect()
            except Exception as e:  # noqa: BLE001
                self.last_connect_error = str(e)
                logger.warning("session connect failed: %s", e)
                auth = is_auth_error(e)
                if cb is not None and not auth:
                    # auth rejections park below — counting them toward
                    # the circuit would double-suppress the token path
                    cb.record_failure()
                if auth:
                    if self._park_on_auth_failure(str(e)):
                        return
                    backoff = BACKOFF_INITIAL
                    continue
                if cb is not None and cb.state != "closed":
                    # the failure tripped (or re-tripped) the breaker:
                    # its cooldown is now the single pacing authority.
                    # Sleeping the exponential backoff on top would
                    # stack two waits and stall recovery long after the
                    # manager is back (a failed half-open probe with
                    # backoff grown to minutes is the worst case)
                    backoff = BACKOFF_INITIAL
                    continue
                if self.time_sleep_fn(self.jitter_fn(backoff)):
                    return
                backoff = min(backoff * BACKOFF_FACTOR, BACKOFF_MAX)
                continue
            if cb is not None:
                cb.record_success()
            self._connected.set()
            if self.on_connected is not None:
                try:
                    self.on_connected()
                except Exception:  # noqa: BLE001
                    logger.exception("on_connected callback failed")
            backoff = BACKOFF_INITIAL
            self._reconnect_signal.wait()
            self._connected.clear()
            self.reconnect_count += 1
            for stop in stops:
                try:
                    if stop:
                        stop()
                except Exception:  # noqa: BLE001
                    pass
            if self._stop.is_set():
                return
            # a 401/Unauthenticated may also arrive mid-stream via
            # signal_reconnect's reason rather than a connect exception;
            # prefer the transport's structured classification (v1 HTTP
            # status / v2 grpc code captured while the exception was live)
            # over regexing the formatted string
            auth = self._last_reason_auth
            if auth is None:
                auth = is_auth_error(self.last_connect_error)
            if auth:
                if self._park_on_auth_failure(self.last_connect_error):
                    return
                backoff = BACKOFF_INITIAL
                continue
            if self.time_sleep_fn(self.jitter_fn(backoff)):
                return
            backoff = min(backoff * BACKOFF_FACTOR, BACKOFF_MAX)

    def _park_on_auth_failure(self, reason: str) -> bool:
        """Suspend reconnecting until the token changes (new token via
        updateToken/FIFO) or the session stops. Returns True when stop was
        requested (caller should exit the keep-alive loop)."""
        self.auth_failed = True
        failed_token = self.token
        logger.warning(
            "session auth failure (%s); suspending reconnect until the "
            "token changes", reason,
        )
        if self.on_auth_failure is not None:
            try:
                self.on_auth_failure(reason)
            except Exception:  # noqa: BLE001
                logger.exception("on_auth_failure callback failed")
        while not self._stop.is_set() and self.token == failed_token:
            if self.time_sleep_fn(AUTH_RECHECK_INTERVAL):
                return True
        self.auth_failed = False
        return self._stop.is_set()

    def _connect(self):
        """Open the transport per protocol preference; returns stop fns."""
        skip = getattr(self, "_v2_skip_cycles", 0)
        if skip > 0:
            self._v2_skip_cycles = skip - 1
            if self._v2_skip_cycles == 0:
                self._v2_failed = False  # cooldown elapsed: re-probe v2
        if self.protocol == "v2" or (
            self.protocol == "auto" and not getattr(self, "_v2_failed", False)
        ):
            try:
                from gpud_tpu_torch.session.v2.client import start_v2_transport

                stop = start_v2_transport(self)
                self.active_protocol = "v2"
                return [stop]
            except Exception as e:  # noqa: BLE001
                if self.protocol == "v2":
                    raise
                # back off from v2 for a number of reconnect cycles rather
                # than forever: a transient UNAVAILABLE during a control-
                # plane rolling restart must not pin the daemon to v1 for
                # its whole lifetime
                self._v2_skip_cycles = 10
                self._v2_failed = True
                logger.info("session v2 unavailable (%s); using legacy v1", e)
        stops = [self.start_reader_fn(self), self.start_writer_fn(self)]
        self.active_protocol = "v1"
        return stops

    def signal_reconnect(self, reason: str = "", auth: Optional[bool] = None) -> None:
        """``auth`` carries the transport's structured classification of
        the failure (computed from the live exception's HTTP status/grpc
        code); None = unknown, the keep-alive loop falls back to text
        matching via ``is_auth_error``."""
        if reason:
            self.last_connect_error = reason
            self._last_reason_auth = auth
        self._reconnect_signal.set()

    def _drain_reader(self) -> None:
        while True:
            try:
                self.reader.get_nowait()
            except queue.Empty:
                return

    # -- serve loop (reference: session_serve.go:137) ----------------------
    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                frame = self.reader.get(timeout=0.5)
            except queue.Empty:
                continue
            if frame is None:  # sentinel/garbage must not kill the loop
                continue
            try:
                resp = self.dispatch_fn(frame.data)
            except Exception as e:  # noqa: BLE001
                logger.exception("request dispatch failed")
                resp = {"error": str(e)}
            # a dispatcher bug returning non-JSON-serializable data must
            # become an error response HERE — discovered later inside the
            # transport writer it would crash the pump mid-stream instead.
            # to_json() caches, so the writer pays no second serialization.
            out = Frame(req_id=frame.req_id, data=resp)
            try:
                out.to_json()
            except (TypeError, ValueError):
                logger.exception("dispatch result not serializable")
                out = Frame(
                    req_id=frame.req_id,
                    data={"error": "internal: dispatch result not serializable"},
                )
            self.send(out)

    def send(self, frame: Frame) -> bool:
        try:
            self.writer.put(frame, timeout=self.send_timeout)
            return True
        except queue.Full:
            self.note_frame_dropped(
                "write", "session writer channel full; dropping frame"
            )
            return False

    def requeue_front(self, frame: Frame) -> None:
        """Hand a frame a replaced transport took from the writer channel
        back to its head, in order, for the transport that replaced it. A
        stopped transport's pump still waits on the channel for up to its
        poll interval after a reconnect, beside its successor's; without
        this, the first frame queued after the reconnect could go to the
        closed stream and be lost (the reference package sends it there,
        ROADMAP C7). May hold the channel one frame over its cap."""
        q = self.writer
        with q.mutex:
            q.queue.appendleft(frame)
            q.unfinished_tasks += 1
            q.not_empty.notify()

    def note_frame_dropped(self, direction: str, detail: str) -> None:
        """Account one dropped frame: the counter counts every drop; the
        Warning event hook (server-wired) is rate-limited per direction so
        a sustained overflow doesn't flood the event store."""
        _c_frames_dropped.inc(labels={"direction": direction})
        logger.warning("%s", detail)
        hook = self.on_frame_dropped
        if hook is None:
            return
        now = time.monotonic()
        last = self._last_drop_note.get(direction)
        if last is not None and now - last < FRAME_DROP_EVENT_INTERVAL:
            return
        self._last_drop_note[direction] = now
        try:
            hook(direction, detail)
        except Exception:  # noqa: BLE001
            logger.exception("on_frame_dropped hook failed")

    # -- HTTP transport (http.client; replaced in tests) --------------------
    def _headers(self, session_type: str) -> Dict[str, str]:
        h = {
            HEADER_SESSION_TYPE: session_type,
            HEADER_MACHINE_ID: self.machine_id,
            HEADER_VERSION: __version__,
            "Content-Type": "application/x-ndjson",
        }
        if self.token:
            h[HEADER_TOKEN] = f"Bearer {self.token}"
        if self.machine_proof:
            h[HEADER_MACHINE_PROOF] = self.machine_proof
        return h

    def _http_reader(self, _self) -> Callable[[], None]:
        """Opens the read stream: requests arriving as ndjson lines."""
        conn, resp = http_client.open_post(
            f"{self.endpoint}/api/v1/session",
            self._headers("read"),
            connect_timeout=10,
        )
        stopped = threading.Event()

        def pump():
            try:
                while True:
                    raw = resp.readline()
                    if not raw:
                        break
                    if stopped.is_set() or self._stop.is_set():
                        return
                    line = raw.decode("utf-8").strip("\r\n")
                    if not line:
                        continue
                    frame = Frame.from_json(line)
                    if frame is not None:
                        try:
                            self.reader.put(frame, timeout=5.0)
                        except queue.Full:
                            self.note_frame_dropped(
                                "read",
                                "reader channel full; dropping request",
                            )
                # graceful server-side close is also a disconnect: without a
                # reconnect the session would look connected but be deaf
                if not stopped.is_set():
                    self.signal_reconnect("read stream closed")
            except Exception as e:  # noqa: BLE001
                if not stopped.is_set():
                    self.signal_reconnect(f"read stream: {e}", auth=is_auth_error(e))

        t = threading.Thread(target=pump, name="tpud-session-reader", daemon=True)
        t.start()

        def stop():
            stopped.set()
            http_client.shutdown(conn)

        return stop

    def _http_writer(self, _self) -> Callable[[], None]:
        """Opens the write stream: a chunked POST whose body is produced
        from the writer queue (reference: io.Pipe up, session.go:525-575)."""
        stopped = threading.Event()

        def body_gen():
            while not stopped.is_set() and not self._stop.is_set():
                try:
                    frame = self.writer.get(timeout=PIPE_INTERVAL)
                except queue.Empty:
                    yield b"\n"  # keep-alive blank line each pipe interval
                    continue
                if stopped.is_set():
                    # this stream was replaced while it waited: its
                    # successor sends the frame (ROADMAP C7)
                    self.requeue_front(frame)
                    return
                yield (frame.to_json() + "\n").encode()

        def run():
            try:
                conn, resp = http_client.open_post(
                    f"{self.endpoint}/api/v1/session",
                    self._headers("write"),
                    body=body_gen(),
                    connect_timeout=10,
                )
                resp.read()
                conn.close()
                # the POST returning at all means the server ended the
                # write stream — mute session without a reconnect otherwise
                if not stopped.is_set():
                    self.signal_reconnect("write stream closed")
            except Exception as e:  # noqa: BLE001
                if not stopped.is_set():
                    self.signal_reconnect(
                        f"write stream: {e}", auth=is_auth_error(e)
                    )

        t = threading.Thread(target=run, name="tpud-session-writer", daemon=True)
        t.start()

        def stop():
            stopped.set()

        return stop
