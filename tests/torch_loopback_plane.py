"""A fleet control plane on the loopback interface that speaks tpud's
session protocol, on the standard library; ``chip_smoke.py``'s session
phase serves it, and the port's transport tests hold both packages'
sessions against it.

Protocol v1 (``http.server.ThreadingHTTPServer``): ``POST
/api/v1/session`` with ``X-TPUD-Session-Type: read`` streams requests down
as chunked ndjson, one ``{"req_id", "data"}`` per line; ``write`` uploads
the agent's answers and outbox batches as a chunked ndjson body; ``POST
/api/v1/login`` answers a login; ``GET /<name>`` serves the files in
``files`` (release artifacts). Protocol v2 (``start_v2``, when ``grpc`` is
installed): the ``tpud.session.v2.Session/Connect`` bidi stream with the
Hello / HelloAck handshake, requests as rev-1 ``Frame`` packets and answers
as ``Frame`` or ``Result`` packets, the payloads in the wire codec's framing
from revision 3.

The plane binds ``127.0.0.1`` on a free port. It records every stream's
attempt (with its headers and the HTTP status or handshake verdict), every
answer with its arrival time, and every outbox record decoded through the
``wire`` module it is given (``parse_batch`` and a ``DeltaDecoder`` per
read connection, fresh on each connect, as the fleet manager's), grouped by
connection. ``accept_token`` makes it answer any other bearer token with
401 (v1) or a rejected HelloAck "bad token" (v2); ``drop`` ends a machine's
read stream and shuts its write stream; ``auto_ack`` answers each batch
with a cumulative ``outboxAck``, as the fleet manager does.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

SESSION_PATH = "/api/v1/session"
LOGIN_PATH = "/api/v1/login"
V2_METHOD_SERVICE = "tpud.session.v2.Session"


class LoopbackPlane:
    def __init__(self, wire=None, pb=None, accept_token: Optional[str] = None,
                 auto_ack: bool = False, v2_revision: int = 3) -> None:
        self.wire = wire
        self.pb = pb
        self.accept_token = accept_token
        self.auto_ack = auto_ack
        self.v2_revision = v2_revision
        self.files: Dict[str, bytes] = {}
        self.logins: List[dict] = []
        self._mu = threading.Lock()
        self._streams: Dict[str, "queue.Queue"] = {}
        self._write_socks: Dict[str, socket.socket] = {}
        self._decoders: Dict[str, object] = {}
        self._revision: Dict[str, int] = {}
        self.connected = threading.Event()
        # every session stream opened: (perf_counter, protocol, type, status)
        self.attempts: List[tuple] = []
        self.headers: List[dict] = []
        # accepted read connections, each with the records it delivered
        self.connections: List[dict] = []
        self.responses: List[dict] = []
        self.arrived: Dict[str, float] = {}
        self.sent: Dict[str, float] = {}
        self.acked: Dict[str, int] = {}
        self.keepalives = 0  # blank lines on the write streams
        self.write_bodies: Dict[str, bytes] = {}  # each machine's last upload, raw
        self._ack_n = 0
        self._stop = threading.Event()
        self._http: Optional[ThreadingHTTPServer] = None
        self._grpc = None
        self._pool = None
        self.port = 0
        self.v2_port = 0

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "LoopbackPlane":
        plane = self

        class Handler(_Handler):
            pass

        Handler.plane = plane
        self._http = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._http.daemon_threads = True
        self.port = self._http.server_address[1]
        threading.Thread(target=self._http.serve_forever, kwargs={"poll_interval": 0.1},
                         name="loopback-plane", daemon=True).start()
        return self

    def start_v2(self) -> int:
        """The gRPC front on its own loopback port; returns the port."""
        from concurrent import futures

        import grpc

        pb = self.pb
        self._pool = futures.ThreadPoolExecutor(max_workers=8)
        self._grpc = grpc.server(self._pool)
        handler = grpc.stream_stream_rpc_method_handler(
            self._v2_connect,
            request_deserializer=pb.AgentPacket.FromString,
            response_serializer=pb.ManagerPacket.SerializeToString,
        )
        self._grpc.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
            V2_METHOD_SERVICE, {"Connect": handler}),))
        self.v2_port = self._grpc.add_insecure_port("127.0.0.1:0")
        self._grpc.start()
        return self.v2_port

    def stop(self) -> None:
        self._stop.set()
        with self._mu:
            machines = list(self._streams)
        for m in machines:
            self.drop(m)
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        if self._grpc is not None:
            self._grpc.stop(grace=0.2).wait(timeout=3)
            self._pool.shutdown(wait=False, cancel_futures=True)

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    # -- control ----------------------------------------------------------------
    def send_request(self, machine: str, req_id: str, data: dict) -> None:
        with self._mu:
            q = self._streams.get(machine)
        if q is None:
            raise RuntimeError(f"no session for {machine}")
        self.sent[req_id] = time.perf_counter()
        q.put((req_id, data))

    def wait_response(self, req_id: str, timeout: float = 10.0) -> Optional[dict]:
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._mu:
                for r in self.responses:
                    if r.get("req_id") == req_id:
                        return r
            time.sleep(0.005)
        return None

    def drop(self, machine: str) -> bool:
        """End the machine's read stream and shut its write stream."""
        with self._mu:
            q = self._streams.pop(machine, None)
            sock = self._write_socks.pop(machine, None)
        self.connected.clear()
        if q is not None:
            q.put(None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        return q is not None

    def records(self) -> List[tuple]:
        """Every decoded outbox record in arrival order:
        (connection index, seq, ts, kind, dedupe key, payload, keyframe,
        arrival perf_counter)."""
        with self._mu:
            return [(i, *r) for i, c in enumerate(self.connections) for r in c["records"]]

    # -- admission ------------------------------------------------------------
    def _admit(self, protocol: str, stype: str, token: str, headers: dict) -> bool:
        ok = self.accept_token is None or token == self.accept_token
        with self._mu:
            self.attempts.append((time.perf_counter(), protocol, stype, 200 if ok else 401))
            self.headers.append(headers)
        return ok

    def _open(self, machine: str, protocol: str) -> "queue.Queue":
        q: "queue.Queue" = queue.Queue()
        with self._mu:
            old = self._streams.get(machine)
            self._streams[machine] = q
            # a fresh connection is a fresh set of delta streams
            self._decoders.pop(machine, None)
            self.connections.append({"t": time.perf_counter(), "machine": machine,
                                     "protocol": protocol, "records": []})
        if old is not None:
            old.put(None)
        self.connected.set()
        return q

    # -- answers and outbox ingest ---------------------------------------------
    def _answer(self, machine: str, d) -> None:
        if not isinstance(d, dict):
            return
        now = time.perf_counter()
        with self._mu:
            self.responses.append(d)
            self.arrived.setdefault(str(d.get("req_id", "")), now)
        data = d.get("data")
        if self.wire is not None and isinstance(data, dict) and "outbox_batch" in data:
            self._ingest(machine, data, now)

    def _ingest(self, machine: str, data: dict, now: float) -> None:
        wire = self.wire
        batch = wire.parse_batch(data)
        if batch is None:
            return
        last = None
        with self._mu:
            decoder = self._decoders.get(machine)
            if decoder is None:
                decoder = self._decoders[machine] = wire.DeltaDecoder()
            conn = next((c for c in reversed(self.connections) if c["machine"] == machine), None)
            if conn is None:
                return
            for rec in batch.get("records") or []:
                try:
                    seq, ts, kind, key, body = decoder.decode_record(rec)
                except (wire.DeltaDecodeError, TypeError, ValueError):
                    break  # the decoded prefix only
                conn["records"].append((seq, ts, kind, key, body, len(rec) == 6, now))
                last = seq
            if last is None or not self.auto_ack:
                return
            self.acked[machine] = max(self.acked.get(machine, 0), last)
            self._ack_n += 1
            req_id, seq = f"plane-ack-{self._ack_n}", self.acked[machine]
        try:
            self.send_request(machine, req_id, {"method": "outboxAck", "seq": seq})
        except RuntimeError:
            pass

    # -- protocol v2 ------------------------------------------------------------
    def _v2_connect(self, request_iterator, context):
        pb, wire = self.pb, self.wire
        first = next(request_iterator)
        hello = first.hello
        headers = {"machine_id": hello.machine_id, "token": hello.token,
                   "machine_proof": hello.machine_proof, "tpud_version": hello.tpud_version,
                   "min_revision": hello.min_revision, "max_revision": hello.max_revision,
                   "capabilities": list(hello.capabilities)}
        ack = pb.ManagerPacket()
        if not self._admit("v2", "connect", hello.token, headers):
            ack.hello_ack.accepted = False
            ack.hello_ack.reason = "bad token"
            yield ack
            return
        revision = min(self.v2_revision, hello.max_revision or 1)
        ack.hello_ack.accepted = True
        ack.hello_ack.revision = revision
        machine = hello.machine_id
        with self._mu:
            self._revision[machine] = revision
        q = self._open(machine, "v2")
        yield ack
        ended = threading.Event()

        def payload(raw: bytes):
            return wire.decode_payload(raw) if revision >= 3 else json.loads(raw.decode())

        def answers():
            try:
                for pkt in request_iterator:
                    kind = pkt.WhichOneof("payload")
                    if kind == "frame":
                        self._answer(machine, {"req_id": pkt.frame.req_id,
                                               "data": payload(pkt.frame.data)})
                    elif kind == "result":
                        self._answer(machine, {"req_id": pkt.result.request_id,
                                               "data": payload(pkt.result.payload_json)})
            except Exception:  # noqa: BLE001 — the agent cancelled its stream
                pass
            finally:
                ended.set()

        threading.Thread(target=answers, name="loopback-plane-v2", daemon=True).start()
        while not ended.is_set() and context.is_active() and not self._stop.is_set():
            try:
                item = q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                return
            req_id, data = item
            m = pb.ManagerPacket()
            m.frame.req_id = req_id
            m.frame.data = (wire.encode_payload(data) if revision >= 3
                            else json.dumps(data).encode())
            yield m


class _Handler(BaseHTTPRequestHandler):
    """Protocol v1 and the login and file routes of a ``LoopbackPlane``."""

    protocol_version = "HTTP/1.1"
    plane: LoopbackPlane = None  # set on the subclass ``start`` makes

    def log_message(self, fmt, *args) -> None:  # quiet
        pass

    def _reply(self, status: int, body: bytes, ctype: str = "application/json") -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self.wfile.flush()

    def do_GET(self) -> None:
        body = self.plane.files.get(self.path.lstrip("/"))
        if body is None:
            self._reply(404, b"not found", "text/plain")
        else:
            self._reply(200, body, "application/octet-stream")

    def do_POST(self) -> None:
        plane = self.plane
        if self.path == LOGIN_PATH:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
            plane.logins.append(body)
            self._reply(200, json.dumps({
                "machine_id": body.get("machine_id") or "cp-assigned-1",
                "token": "cp-session-token", "machine_proof": "cp-proof"}).encode())
            return
        if self.path != SESSION_PATH:
            self.close_connection = True
            self._reply(404, b"not found", "text/plain")
            return
        stype = self.headers.get("X-TPUD-Session-Type", "")
        machine = self.headers.get("X-TPUD-Machine-ID", "")
        token = self.headers.get("Authorization", "").removeprefix("Bearer ").strip()
        if not plane._admit("v1", stype, token, dict(self.headers.items())):
            self.close_connection = True
            self._reply(401, b"unauthorized", "text/plain")
            return
        if stype == "read":
            self._read_stream(machine)
        elif stype == "write":
            self._write_stream(machine)
        else:
            self.close_connection = True
            self._reply(400, b'{"error": "bad session type"}')

    def _read_stream(self, machine: str) -> None:
        n = int(self.headers.get("Content-Length", "0"))
        if n:
            self.rfile.read(n)
        q = self.plane._open(machine, "v1")
        self.close_connection = True
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self.wfile.flush()
        try:
            while not self.plane._stop.is_set():
                try:
                    item = q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if item is None:
                    break
                req_id, data = item
                line = (json.dumps({"req_id": req_id, "data": data}) + "\n").encode()
                self.wfile.write(f"{len(line):X}\r\n".encode() + line + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except OSError:
            pass

    def _write_stream(self, machine: str) -> None:
        plane = self.plane
        with plane._mu:
            plane._write_socks[machine] = self.connection
        self.close_connection = True
        buf = b""
        try:
            while True:
                size_line = self.rfile.readline()
                if not size_line:
                    return  # shut down (drop) or the agent went away
                size = int(size_line.split(b";")[0].strip() or b"0", 16)
                if size == 0:
                    while self.rfile.readline() not in (b"\r\n", b"\n", b""):
                        pass
                    break
                chunk = self.rfile.read(size)
                self.rfile.readline()
                with plane._mu:
                    plane.write_bodies[machine] = plane.write_bodies.get(machine, b"") + chunk
                buf += chunk
                *lines, buf = buf.split(b"\n")
                for ln in lines:
                    ln = ln.strip()
                    if not ln:
                        with plane._mu:
                            plane.keepalives += 1  # the agent's keep-alive line
                        continue
                    try:
                        d = json.loads(ln)
                    except ValueError:
                        continue
                    plane._answer(machine, d)
            self._reply(200, b'{"ok": true}')
        except (OSError, ValueError):
            return
