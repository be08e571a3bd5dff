"""Reusable fake control plane: tpud session protocol + chaos knobs; the
port of ``gpud_tpu/chaos/fake_plane.py``.

A minimal control plane implementing the dual chunked-ndjson session
streams and ``/api/v1/login``, served on the port's standard-library
listener (``server/listener.py``, an ``App`` route table without the
daemon's HTTP middleware) where the reference serves aiohttp on an asyncio
loop. Each stream runs on its connection's own thread: a read stream waits
on its machine's queue, a write stream reads the agent's lines as they
arrive. Beyond the protocol it carries the fault knobs a disconnect or
latency campaign needs:

  - ``reject_auth`` / ``accept_token``: 401 storms and token rotation
  - ``latency_seconds``: injected delay before a session stream starts
    serving and before each pushed frame (slow-control-plane modelling)
  - ``drop_session`` / ``drop_all`` / ``disconnect_storm``: scripted
    disconnect/reconnect churn against the agent's session loop
  - ``refuse_connects``: 503 every session stream — a hard-down manager
    for circuit-breaker drills (connect attempts are still counted)
  - outbox ingest: frames carrying ``outbox_seq`` on the write stream
    are recorded (``outbox_keys`` / ``outbox_frames``) and auto-acked
    via an ``outboxAck`` request on the read stream — the manager half
    of the store-and-forward contract (session/outbox.py)

The reference's ingest is atomic because one event loop runs it; here
``ingest_lock`` serializes it: every delivery's dedupe, journal and ack
run under it, and the ``manager_kill_rebuild`` fault swaps the rollup
store under it.

Run standalone: ``python -m gpud_tpu_torch.chaos.fake_plane <port>``.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Dict, List, Optional

from gpud_tpu_torch.server.app import App, Request, Response, Route, _json, _text

POLL_SECONDS = 0.5  # a read stream's longest wait between looks at stop()
JOIN_SECONDS = 5.0


class FakeControlPlane:
    def __init__(self, port: int = 0) -> None:
        self.port = port
        self.sessions: Dict[str, queue.Queue] = {}   # machine_id → outbound q
        self.responses: List[dict] = []
        self.logins: List[dict] = []
        self.connected = threading.Event()
        self.reject_auth = False   # return 401 on session streams
        self.accept_token: Optional[str] = None  # 401 any other bearer token
        self.auth_rejects = 0
        # chaos knobs
        self.latency_seconds = 0.0  # injected delay per stream-start/frame
        self.connects = 0           # read-stream accepts (reconnect counting)
        self.drops = 0              # sessions dropped via drop_session/drop_all
        self.refuse_connects = False  # 503 every session stream (hard-down)
        self.refused = 0
        # store-and-forward outbox ingest (auto-acked; see module docstring)
        self.outbox_frames: List[dict] = []
        self.outbox_keys: set = set()
        self.outbox_acked: Dict[str, int] = {}  # machine_id → highest seq
        self._ack_seq = 0
        # per-machine delta decoders for batched delivery frames
        # (session/wire.py); reset on reconnect like the real manager's
        # per-connection AgentHandle decoder
        self._outbox_decoders: Dict[str, object] = {}
        # optional fleet rollup store (manager/rollup.py): when attached,
        # every fresh (deduped) record is forwarded exactly like the real
        # control plane's AgentHandle.on_records hook, so chaos campaigns
        # can assert rollup/ingest consistency (`fleet` expectations)
        self.rollup = None
        self.ingest_lock = threading.Lock()
        self._mu = threading.Lock()  # sessions and the counters above
        self._stopping = threading.Event()
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    @property
    def running(self) -> bool:
        return self._httpd is not None and not self._stopping.is_set()

    def attach_rollup(self, data_dir=None, shard_count=None):
        """Attach a FleetRollupStore fed by the outbox ingest path;
        returns the store. Synchronous writes (no BatchWriter) — chaos
        asserts consistency, not throughput — which also means every
        journaled row is durable the instant ``ingest`` returns, so the
        ``manager_kill_rebuild`` fault can rebuild from the same DB at
        any point with zero durability window. ``data_dir`` persists
        the journal to ``<data_dir>/fleet.db`` (default in-memory);
        ``shard_count`` overrides the default shard striping."""
        import os

        from gpud_tpu_torch.manager.rollup import FleetRollupStore
        from gpud_tpu_torch.manager.shard import DEFAULT_SHARD_COUNT
        from gpud_tpu_torch.sqlite import DB

        db_path = ":memory:"
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            db_path = os.path.join(data_dir, "fleet.db")
        self.rollup = FleetRollupStore(
            DB(db_path), writer=None,
            shard_count=shard_count or DEFAULT_SHARD_COUNT,
        )
        return self.rollup

    # -- server ------------------------------------------------------------
    def _login(self, req: Request) -> Response:
        """Enrollment."""
        body = req.json()
        self.logins.append(body)
        return _json(
            {
                "machine_id": body.get("machine_id") or "cp-assigned-1",
                "token": "cp-session-token",
                "machine_proof": "cp-proof",
            }
        )

    def _session(self, req: Request) -> Response:
        """The session's read (manager → agent) and write streams."""
        if self.refuse_connects:
            # hard-down manager: the attempt reached us (counted) but no
            # stream is served — drives the agent's circuit breaker open
            with self._mu:
                self.refused += 1
            return _text("unavailable", 503)
        if self.reject_auth:
            with self._mu:
                self.auth_rejects += 1
            return _text("unauthorized", 401)
        if self.accept_token is not None:
            bearer = req.headers.get("Authorization", "")
            if bearer.removeprefix("Bearer ").strip() != self.accept_token:
                with self._mu:
                    self.auth_rejects += 1
                return _text("unauthorized", 401)
        if self.latency_seconds > 0:
            time.sleep(self.latency_seconds)
        stype = req.headers.get("X-TPUD-Session-Type", "")
        machine = req.headers.get("X-TPUD-Machine-ID", "")
        if stype == "read":
            return Response(content_type="application/x-ndjson",
                            chunks=self._read_stream(machine))
        if stype == "write":
            try:
                while True:
                    line = req.stream.readline()
                    if not line:
                        break
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        d = json.loads(line)
                    except ValueError:
                        continue
                    self.responses.append(d)
                    data = d.get("data") if isinstance(d, dict) else None
                    if isinstance(data, dict) and (
                        "outbox_seq" in data or "outbox_batch" in data
                    ):
                        self._ingest_outbox(machine, data)
            except (OSError, ValueError):
                pass  # the agent or stop() closed the stream
            return _json({"ok": True})
        return _json({"error": "bad session type"}, status=400)

    def _read_stream(self, machine: str):
        """Runs once the headers are out (the reference's prepare()): the
        machine's queue registers, then every frame put on it goes down
        the stream until a None sentinel or ``stop``."""
        q: queue.Queue = queue.Queue()
        with self._mu:
            self.sessions[machine] = q
            # fresh connection = fresh delta streams (the agent resets
            # its encoder on reconnect; mirror the real manager handle)
            self._outbox_decoders.pop(machine, None)
            self.connects += 1
        self.connected.set()
        try:
            while not self._stopping.is_set():
                try:
                    frame = q.get(timeout=POLL_SECONDS)
                except queue.Empty:
                    continue
                if frame is None:
                    break
                if self.latency_seconds > 0:
                    time.sleep(self.latency_seconds)
                if isinstance(frame, bytes):
                    # raw bytes (hostile-manager tests): sent verbatim
                    yield frame
                else:
                    yield (json.dumps(frame) + "\n").encode()
        finally:
            with self._mu:
                if self.sessions.get(machine) is q:
                    del self.sessions[machine]

    def _ingest_outbox(self, machine: str, data: dict) -> None:
        """Record one store-and-forward delivery frame — a batched
        delta-encoded ``outbox_batch`` (docs/session.md wire format) or a
        legacy per-record payload — and auto-ack ONE cumulative watermark
        on the machine's read stream (dedupe is by key — at-least-once
        means redeliveries are normal and must not double-record)."""
        from gpud_tpu_torch.session import wire

        with self.ingest_lock:
            batch = wire.parse_batch(data)
            if batch is not None:
                decoder = self._outbox_decoders.get(machine)
                if decoder is None:
                    decoder = self._outbox_decoders[machine] = wire.DeltaDecoder()
                records = []
                for rec in batch.get("records") or []:
                    try:
                        seq, ts, kind, key, body = decoder.decode_record(rec)
                    except (wire.DeltaDecodeError, TypeError, ValueError):
                        break  # ack the decoded prefix only
                    records.append({
                        "outbox_seq": seq,
                        "ts": ts,
                        "kind": kind,
                        "dedupe_key": key,
                        "payload": body,
                    })
                if not records:
                    return
                ack_to = records[-1]["outbox_seq"]
            else:
                try:
                    ack_to = int(data.get("outbox_seq", 0))
                except (TypeError, ValueError):
                    return
                records = [data]
            fresh = []
            for rec in records:
                key = str(rec.get("dedupe_key") or "")
                if key not in self.outbox_keys:
                    self.outbox_keys.add(key)
                    self.outbox_frames.append(rec)
                    fresh.append((
                        rec.get("outbox_seq") or 0,
                        rec.get("ts") or 0.0,
                        rec.get("kind") or "",
                        key,
                        rec.get("payload"),
                    ))
            if self.rollup is not None and fresh:
                try:
                    self.rollup.ingest(machine or "chaos-agent", fresh)
                except Exception:  # noqa: BLE001 — observability is best-effort
                    pass
            if ack_to > self.outbox_acked.get(machine, 0):
                self.outbox_acked[machine] = ack_to
            with self._mu:
                q = self.sessions.get(machine)
                self._ack_seq += 1
                ack_id = self._ack_seq
            if q is not None:
                q.put_nowait(
                    {
                        "req_id": f"fcp-ack-{ack_id}",
                        "data": {"method": "outboxAck",
                                 "seq": self.outbox_acked[machine]},
                    }
                )

    # -- control API for tests / campaigns -----------------------------------
    def _queue(self, machine_id: str) -> queue.Queue:
        with self._mu:
            q = self.sessions.get(machine_id)
        if q is None:
            raise RuntimeError(f"no session for {machine_id}")
        return q

    def send_request(self, machine_id: str, req_id: str, data: dict) -> None:
        self._queue(machine_id).put({"req_id": req_id, "data": data})

    def send_raw(self, machine_id: str, payload: bytes) -> None:
        """Push raw bytes down the read stream (malformed-frame tests)."""
        self._queue(machine_id).put(payload)

    def drop_session(self, machine_id: str) -> None:
        """End the read stream, forcing the agent to reconnect (used with
        accept_token changes to model a mid-stream revocation)."""
        with self._mu:
            q = self.sessions.pop(machine_id, None)
            if q is None:
                raise RuntimeError(f"no session for {machine_id}")
            self.connected.clear()
            self.drops += 1
        q.put(None)

    def drop_all(self) -> int:
        """Drop every live session (chaos ``plane_disconnect`` step);
        returns how many were dropped."""
        n = 0
        with self._mu:
            machines = list(self.sessions)
        for machine in machines:
            try:
                self.drop_session(machine)
                n += 1
            except RuntimeError:
                continue
        return n

    def disconnect_storm(self, count: int, interval: float = 0.5) -> int:
        """Scripted churn: drop all sessions ``count`` times, waiting out
        ``interval`` between rounds (and for the agent to reconnect, up
        to the same interval). Returns total sessions dropped."""
        total = 0
        for i in range(count):
            total += self.drop_all()
            if i < count - 1:
                self.connected.wait(timeout=max(interval, 0.05))
                time.sleep(interval)
        return total

    def wait_response(self, req_id: str, timeout: float = 10.0) -> Optional[dict]:
        deadline = time.time() + timeout
        while time.time() < deadline:
            for r in list(self.responses):
                if r.get("req_id") == req_id:
                    return r
            time.sleep(0.02)
        return None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        from gpud_tpu_torch.server.listener import Listener

        app = App(routes=[
            Route("POST", "/api/v1/login", self._login, "Enrollment."),
            Route("POST", "/api/v1/session", self._session,
                  "The session's read and write streams.", stream_body=True),
        ], observe=False)
        try:
            httpd = Listener(("127.0.0.1", self.port), app)
        except OSError as e:
            raise RuntimeError("fake control plane failed to start") from e
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="tpud-fake-plane", daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        """End every read stream, stop accepting, shut the open
        connections down and join their threads within a bound."""
        self._stopping.set()
        with self._mu:
            queues = list(self.sessions.values())
            self.sessions.clear()
        for q in queues:
            q.put(None)
        httpd, thread = self._httpd, self._thread
        if httpd is not None:
            if thread is not None and thread.is_alive():
                httpd.shutdown()
            httpd.close(JOIN_SECONDS)
        if thread is not None:
            thread.join(timeout=JOIN_SECONDS)
        self._thread = None


if __name__ == "__main__":
    import sys

    cp = FakeControlPlane(port=int(sys.argv[1]) if len(sys.argv) > 1 else 0)
    cp.start()
    print(f"fake control plane on http://127.0.0.1:{cp.port}", flush=True)
    try:
        while True:
            time.sleep(0.5)
    except KeyboardInterrupt:
        cp.stop()
