"""Standalone tpud control plane (dev/reference manager); the port of
``gpud_tpu/manager/control_plane.py``.

A runnable manager that real daemons enroll with and that operators can
drive — the server-side counterpart of ``gpud_tpu_torch/session`` —
speaking BOTH transports:

- v1: ``POST /api/v1/login`` + dual chunked ndjson streams on
  ``POST /api/v1/session`` (read = manager→agent requests, write =
  agent→manager responses), mirroring session/session.py's client.
- v2: gRPC bidi ``Connect`` with Hello/HelloAck revision negotiation;
  at rev 2 requests go out as typed ManagerPacket oneof arms
  (session/v2/typed.py dict_to_request) and responses come back as
  Result packets; rev-1 agents stay on JSON Frames.

Operator surface (same listener):

- ``GET  /v1/machines``                  — connected fleet
- ``POST /v1/machines/{id}/request``     — issue one method request and
  wait for the agent's response (body: ``{"method": ..., params...}``)
- ``POST /v1/drain``                     — notify v2 agents + close streams
- ``GET  /v1/fleet/*``                   — the fleet rollup store's panes
- ``GET  /metrics``                      — the federated exposition

The reference serves v1 and the operator API on aiohttp; here they run on
the standard library's ``http.server`` (``server/listener.py``) over one
``App`` route table (``server/app.py``), with the reference's paths,
methods, status codes, bodies and aiohttp's 404/405 answers. Each
connection has a thread of its own, so a handler blocks where the
reference's awaits its executor. A v1 read stream holds one of
``max_v1_agents`` slots while it waits for its next request, as the
reference's holds a ``_stream_pool`` worker; past the cap a stream waits
for a slot. Every wait is bounded, so ``stop`` never waits on a stuck
reader. ``grpc`` is imported only when v2 starts; the manager imports no
``torch``.

Federation (``attach_peers``, after ``start()``) joins a peer set
(``manager/peers.py``, ``manager/federation.py``): the journal ships to the
ring successor, a dead predecessor's replicated cohort is adopted, and the
``/v1/fleet/*`` panes fan out to every live peer unless ``?scope=local``.
Until then ``federation`` is None and ``/v1/fleet/peers`` answers the
standalone shape.

Run: ``python -m gpud_tpu_torch manager serve`` (cli.py) or
``ControlPlane().start()``.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.server.app import (
    PROMETHEUS_CONTENT_TYPE,
    App,
    Request,
    Response,
    Route,
    _json,
    _text,
)

logger = get_logger(__name__)

DEFAULT_REQUEST_TIMEOUT = 30.0
MAX_REQUEST_TIMEOUT = 600.0
# rev 2: typed requests; rev 3: wire-codec framed payload bytes
# (session/wire.py) — negotiation clamps to the agent's max, so rev-2
# agents keep speaking bare JSON bytes
MAX_REVISION = 3
# the longest any manager thread waits before it looks at its stop flag
POLL_SECONDS = 0.5
JOIN_SECONDS = 5.0


class AgentGone(Exception):
    """The agent disconnected (or was never connected)."""


class AgentHandle:
    """One connected agent: request/response plumbing + metadata."""

    def __init__(self, machine_id: str, transport: str, version: str = "") -> None:
        self.machine_id = machine_id
        self.transport = transport  # "v1" | "v2-rev1" | "v2-rev2" | "v2-rev3"
        self.version = version
        self.connected_at = time.time()
        self.last_seen = self.connected_at
        self.outbound: "queue.Queue[Optional[dict]]" = queue.Queue()
        self.unsolicited: List[dict] = []  # responses with unknown req_id
        self._pending: Dict[str, "queue.Queue[dict]"] = {}
        self._lock = threading.Lock()
        self._gone = threading.Event()
        self.draining = threading.Event()  # v2: send DrainNotice on teardown
        self.drain_reason = "manager draining"
        self._seq = 0
        # store-and-forward outbox ingest (session/outbox.py): delivery is
        # at-least-once, so dedupe by key; the manager acks the highest
        # sequence seen (frames arrive in seq order on one stream, so the
        # max IS the contiguous watermark). All bounded — a week-long
        # backlog replaying through must not grow manager memory
        self.outbox_keys: "OrderedDict[str, None]" = OrderedDict()
        self.outbox_keys_max = 8192
        self.outbox_records: List[dict] = []  # delivered frames, newest last
        self.outbox_records_max = 2048
        self.outbox_acked = 0
        # fleet-plane hook: the ControlPlane points this at the rollup
        # store's ingest so every fresh decoded record is journaled +
        # rolled up; the handle itself stays transport-only
        self.on_records = None
        # when set (ControlPlane._register), outbox frames are handed to
        # the per-shard ingest executor instead of running inline on the
        # session reader thread — delta decode, dedupe, journal submit,
        # and the ack all happen on the agent's shard worker, in FIFO
        # order, so a slow BatchWriter flush can no longer stall the
        # next frame's read. Standalone handles (unit tests, chaos
        # harnesses) keep the inline path.
        self.ingest_executor = None
        self._ack_req_ids: "OrderedDict[str, bool]" = OrderedDict()
        # per-connection delta decoder for batched delivery frames: the
        # agent resets its encoder on reconnect, so a fresh handle always
        # starts on keyframes (session/wire.py)
        from gpud_tpu_torch.session.wire import DeltaDecoder

        self._outbox_decoder = DeltaDecoder()

    # -- operator side -----------------------------------------------------
    def request(self, data: dict, timeout: float = DEFAULT_REQUEST_TIMEOUT) -> dict:
        """Send one method-dict request; block for the agent's response."""
        if self._gone.is_set():
            raise AgentGone(self.machine_id)
        with self._lock:
            self._seq += 1
            req_id = f"op-{self._seq}-{uuid.uuid4().hex[:8]}"
            q: "queue.Queue[dict]" = queue.Queue(maxsize=1)
            self._pending[req_id] = q
        self.outbound.put({"req_id": req_id, "data": data})
        try:
            return q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"agent {self.machine_id}: no response to "
                f"{data.get('method')!r} within {timeout}s"
            ) from None
        finally:
            with self._lock:
                self._pending.pop(req_id, None)

    # -- transport side ----------------------------------------------------
    def resolve(self, req_id: str, payload: dict) -> None:
        self.last_seen = time.time()
        if req_id.startswith("outbox-") or (
            isinstance(payload, dict)
            and ("outbox_seq" in payload or "outbox_batch" in payload)
        ):
            ex = self.ingest_executor
            if ex is not None:
                # reader thread only enqueues; a saturated shard drops the
                # frame UN-acked (backpressure is counted) and the agent's
                # durable outbox redelivers it keyframe-anchored later
                ex.submit(
                    self.machine_id, lambda: self._ingest_outbox(payload)
                )
                return
            self._ingest_outbox(payload)
            return
        with self._lock:
            if self._ack_req_ids.pop(req_id, False):
                return  # agent's response to our outboxAck; nothing to do
            q = self._pending.get(req_id)
        if q is None:
            self.unsolicited.append({"req_id": req_id, "data": payload})
            del self.unsolicited[:-64]  # bounded
            return
        try:
            q.put_nowait(payload)
        except queue.Full:
            pass

    def _ingest_outbox(self, payload: dict) -> None:
        """One replayed outbox frame off the agent's write stream: dedupe
        by key, record if fresh, and push ONE cumulative ``outboxAck``
        request for the new watermark onto the read stream.

        Two shapes arrive here: the batched delta-encoded
        ``{"outbox_batch": {...}}`` frame (docs/session.md wire format)
        and the legacy per-record ``{"outbox_seq": ...}`` payload older
        agents still send. A batch that stops decoding mid-way (delta
        without a keyframe base) acks only the decoded prefix — the
        agent's ack-stall fallback redelivers the rest keyframe-anchored.
        """
        if not isinstance(payload, dict):
            return
        from gpud_tpu_torch.session import wire

        batch = wire.parse_batch(payload)
        if batch is not None:
            decoded = []
            decode = self._outbox_decoder.decode_record
            for rec in batch.get("records") or []:
                try:
                    decoded.append(decode(rec))
                except (wire.DeltaDecodeError, TypeError, ValueError) as e:
                    logger.warning(
                        "%s: outbox batch decode stopped, acking prefix: %s",
                        self.machine_id, e,
                    )
                    break
            if not decoded:
                return
            ack_to = decoded[-1][0]
        else:
            try:
                seq = int(payload.get("outbox_seq", 0))
            except (TypeError, ValueError):
                return
            decoded = [(
                seq,
                payload.get("ts") or 0.0,
                payload.get("kind") or "",
                str(payload.get("dedupe_key") or ""),
                payload.get("payload"),
            )]
            ack_to = seq
        with self._lock:
            fresh = []
            for tup in decoded:
                key = tup[3]
                if key not in self.outbox_keys:
                    self.outbox_keys[key] = None
                    fresh.append(tup)
            while len(self.outbox_keys) > self.outbox_keys_max:
                self.outbox_keys.popitem(last=False)
            # only the tail of a big frame survives the record-buffer
            # trim; don't materialize dicts the trim would drop anyway
            for seq, ts, kind, key, body in fresh[-self.outbox_records_max:]:
                self.outbox_records.append({
                    "outbox_seq": seq,
                    "ts": ts,
                    "kind": kind,
                    "dedupe_key": key,
                    "payload": body,
                })
            del self.outbox_records[:-self.outbox_records_max]
            if ack_to > self.outbox_acked:
                self.outbox_acked = ack_to
            ack_seq = self.outbox_acked
            self._seq += 1
            ack_req_id = f"op-{self._seq}-ack"
            self._ack_req_ids[ack_req_id] = True
            # one ack per delivery frame; keep only recent ids so a
            # slow agent's late responses age into `unsolicited` (bounded)
            while len(self._ack_req_ids) > 512:
                self._ack_req_ids.popitem(last=False)
        # journal BEFORE queuing the ack: once the ack lands the agent
        # prunes these records and can never replay them, so the only
        # acceptable loss after this point is the BatchWriter's bounded
        # durability window (docs/fleet.md), not a whole unjournaled
        # batch. submit_many only buffers — the ack is not gated on a
        # commit — and a rollup failure must not kill the transport, so
        # ingest errors are logged and the ack still goes out (the
        # cumulative ack would cover these seqs on the next frame anyway).
        cb = self.on_records
        if cb is not None and fresh:
            try:
                cb(self.machine_id, fresh)
            except Exception:  # noqa: BLE001 — observability is best-effort
                logger.exception(
                    "%s: fleet rollup ingest failed", self.machine_id
                )
        if not self._gone.is_set():
            self.outbound.put(
                {"req_id": ack_req_id,
                 "data": {"method": "outboxAck", "seq": ack_seq}}
            )

    def mark_gone(self) -> None:
        self._gone.set()
        self.outbound.put(None)
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for q in pending:
            try:
                q.put_nowait({"error": "agent disconnected"})
            except queue.Full:
                pass

    @property
    def gone(self) -> bool:
        return self._gone.is_set()

    def to_dict(self) -> dict:
        return {
            "machine_id": self.machine_id,
            "transport": self.transport,
            "version": self.version,
            "connected_at": self.connected_at,
            "last_seen": self.last_seen,
        }


class ControlPlane:
    """Runnable manager process: v1 HTTP + v2 gRPC + operator API."""

    def __init__(
        self,
        port: int = 0,
        grpc_port: int = 0,
        *,
        session_token: Optional[str] = None,
        admin_token: Optional[str] = None,
        instance_id: Optional[str] = None,
        data_dir: Optional[str] = None,
        rollup_cache_ttl: float = 2.0,
        shards: Optional[int] = None,
        max_v2_agents: int = 64,
        predict_decay_seconds: Optional[float] = None,
    ) -> None:
        self.port = port
        self.grpc_port = grpc_port
        # session_token=None → accept any enrollment and issue a fresh
        # token per machine (dev mode); set → exact Bearer match required
        self.session_token = session_token
        self.admin_token = admin_token
        self.instance_id = instance_id or f"tpud-manager-{uuid.uuid4().hex[:8]}"
        self.agents: Dict[str, AgentHandle] = {}
        self._issued_tokens: Dict[str, str] = {}  # machine_id → token
        # machine_id → MachineInfo dict from the last login/gossip (the
        # reference control plane records the machine tree at enrollment).
        # Bounded: dev mode accepts logins from anyone and a restart-
        # looping agent with empty machine_id mints a fresh id per login
        self.machine_infos: Dict[str, dict] = {}
        self.machine_infos_max = 512
        self._lock = threading.Lock()
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self._grpc_server = None
        self.logins: List[dict] = []
        self._stopped = False
        self._start_called = False
        # set once stop() begins: every bounded wait below looks at it
        self._stopping = threading.Event()
        # reentrant: start()'s failure paths call stop() while holding it
        self._lifecycle = threading.RLock()
        # a v1 read stream holds one slot while it waits for its next
        # request (the reference's _stream_pool worker); operator requests
        # run on their connection's own thread
        self.max_v1_agents = 64
        self.max_v2_agents = max(1, int(max_v2_agents))
        self._stream_slots: Optional[threading.BoundedSemaphore] = None  # start() sizes it
        # fleet observability plane: journal + rollups behind the shared
        # write-behind layer. data_dir=None keeps everything in memory
        # (tests, dev) — same code path, no durability
        from gpud_tpu_torch.manager.rollup import FleetRollupStore
        from gpud_tpu_torch.manager.shard import (
            DEFAULT_SHARD_COUNT,
            ShardIngestExecutor,
        )
        from gpud_tpu_torch.sqlite import DB
        from gpud_tpu_torch.storage.writer import BatchWriter

        self.data_dir = data_dir
        db_path = ":memory:"
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            db_path = os.path.join(data_dir, "fleet.db")
        self.db = DB(db_path)
        self.writer = BatchWriter(self.db)
        self.shards = int(shards) if shards else DEFAULT_SHARD_COUNT
        rollup_kwargs = {}
        if predict_decay_seconds is not None:
            rollup_kwargs["predict_decay_seconds"] = predict_decay_seconds
        self.rollup = FleetRollupStore(
            self.db, self.writer, cache_ttl_seconds=rollup_cache_ttl,
            shard_count=self.shards, **rollup_kwargs,
        )
        # lock-striped offload for wire decode + rollup ingest: session
        # reader threads enqueue, shard workers journal + ack
        self.ingest_executor = ShardIngestExecutor(self.shards)
        self._scheduler = None
        # HA tier (manager/federation.py): None until attach_peers().
        # Specs can't be known at construction when ports are dynamic,
        # so federation always binds late
        self.federation = None
        # rate limiter for the mid-batch-abandon warning, per machine
        self._abandon_warn_ts: Dict[str, float] = {}

    # -- federation --------------------------------------------------------
    def attach_peers(
        self,
        peer_id: str,
        peer_specs: List[str],
        *,
        replication_interval: Optional[float] = None,
        probe_interval: Optional[float] = None,
        fanout_timeout: Optional[float] = None,
        dead_after_probes: Optional[int] = None,
        auto_adopt: bool = True,
        ship_batch: Optional[int] = None,
        redeliver_after: Optional[float] = None,
    ):
        """Join a peer set (manager/federation.py). ``peer_specs`` must
        include this manager's own ``peer_id=endpoint[|grpc]`` entry.
        Call after start() — peer addresses usually aren't known until
        every manager has bound its ports."""
        from gpud_tpu_torch.manager.federation import FederationPlane
        from gpud_tpu_torch.manager.peers import PeerSet, parse_peer_spec

        if self.federation is not None:
            raise RuntimeError("peers already attached")
        if self._scheduler is None:
            raise RuntimeError("attach_peers() requires a started manager")
        descriptors = [parse_peer_spec(s) for s in peer_specs]
        kwargs = {}
        if dead_after_probes is not None:
            kwargs["dead_after_probes"] = dead_after_probes
        peerset = PeerSet(peer_id, descriptors, **kwargs)
        fed_kwargs = {"auto_adopt": auto_adopt}
        for name, val in (
            ("replication_interval", replication_interval),
            ("probe_interval", probe_interval),
            ("fanout_timeout", fanout_timeout),
            ("ship_batch", ship_batch),
            ("redeliver_after", redeliver_after),
        ):
            if val is not None:
                fed_kwargs[name] = val
        self.federation = FederationPlane(
            peerset, self.rollup, self.db, self.writer,
            session_token=self.session_token,
            admin_token=self.admin_token,
            **fed_kwargs,
        )
        self.federation.start(self._scheduler)
        logger.info(
            "federation up: self=%s ring=%s", peer_id, peerset.ring
        )
        return self.federation

    # -- registry ----------------------------------------------------------
    def _register(self, handle: AgentHandle) -> None:
        # point the transport's outbox hook at the rollup store before
        # the handle is visible, so the very first frame is journaled.
        # Peer replication streams (machine_id "peer:<id>") choose their
        # sink per frame (_peer_records), so a stream that connected
        # before attach_peers reaches the replica once it is attached
        from gpud_tpu_torch.manager.federation import PEER_MACHINE_PREFIX

        if handle.machine_id.startswith(PEER_MACHINE_PREFIX):
            handle.on_records = self._peer_records
        else:
            handle.on_records = self.rollup.ingest
        handle.ingest_executor = self.ingest_executor
        with self._lock:
            old = self.agents.get(handle.machine_id)
            if old is not None:
                old.mark_gone()
            self.agents[handle.machine_id] = handle
        logger.info(
            "agent %s connected (%s)", handle.machine_id, handle.transport
        )

    def _peer_records(self, machine_id: str, records) -> None:
        """A peer's replicated rows journal into the replica store — a
        live peer's cohort must never leak into this manager's own pane.
        A standalone manager takes them as an agent's, as the reference's
        does; a federated shipper sends none before this manager is
        federated (ROADMAP C10)."""
        fed = self.federation
        if fed is None:
            self.rollup.ingest(machine_id, records)
        else:
            fed.replica_sink(machine_id)(machine_id, records)

    def _unregister(self, handle: AgentHandle) -> None:
        # sample BEFORE mark_gone(): it enqueues a None wake sentinel,
        # so qsize afterwards can't distinguish abandonment from drain
        leftover = handle.outbound.qsize()
        handle.mark_gone()
        with self._lock:
            if self.agents.get(handle.machine_id) is handle:
                del self.agents[handle.machine_id]
        if leftover > 0 and not handle.draining.is_set():
            # the agent walked away mid-batch: frames (usually cumulative
            # acks) it never read are dropped with the stream. Warn —
            # silently eating these is how "why did the agent redeliver
            # a whole batch" hunts start — but rate-limit per machine,
            # because a flapping agent would otherwise log every cycle
            now = time.monotonic()
            last = self._abandon_warn_ts.get(handle.machine_id, 0.0)
            if now - last >= 30.0:
                if len(self._abandon_warn_ts) >= 1024:
                    self._abandon_warn_ts.clear()
                self._abandon_warn_ts[handle.machine_id] = now
                logger.warning(
                    "agent %s abandoned its %s stream mid-batch: %d "
                    "undelivered frame(s) dropped (acked watermark %d); "
                    "the agent will redeliver above its last acked seq",
                    handle.machine_id, handle.transport, leftover,
                    handle.outbox_acked,
                )
        logger.info("agent %s disconnected", handle.machine_id)

    def agent(self, machine_id: str) -> AgentHandle:
        with self._lock:
            h = self.agents.get(machine_id)
        if h is None or h.gone:
            raise AgentGone(machine_id)
        return h

    def machines(self) -> List[dict]:
        with self._lock:
            return [h.to_dict() for h in self.agents.values()]

    # -- auth --------------------------------------------------------------
    def _check_session_auth(self, machine_id: str, auth_header: str) -> bool:
        token = auth_header.removeprefix("Bearer ").strip()
        if self.session_token is not None:
            return token == self.session_token
        issued = self._issued_tokens.get(machine_id)
        return issued is None or token == issued

    def _check_admin(self, request: Request) -> bool:
        if not self.admin_token:
            return True
        got = request.headers.get("Authorization", "")
        return got.removeprefix("Bearer ").strip() == self.admin_token

    # -- v1 HTTP app -------------------------------------------------------
    def _login(self, request: Request) -> Response:
        from gpud_tpu_torch.api.v1.types import LoginRequest, LoginResponse

        body = request.json()
        # decode through the shared wire type: the manager consumes
        # exactly what login.py's agent side encodes (api/v1/types.py),
        # including the nested MachineInfo tree. The body is UNTRUSTED —
        # a malformed tree must degrade to "no machine info", not fail
        # the enrollment itself
        if not isinstance(body, dict):
            body = {}
        try:
            req = LoginRequest.from_dict(body)
        except Exception:  # noqa: BLE001 — hostile/garbled machine_info
            req = LoginRequest(
                token=str(body.get("token", "") or ""),
                machine_id=str(body.get("machine_id", "") or ""),
            )
        self.logins.append(body)
        del self.logins[:-64]  # bounded like AgentHandle.unsolicited
        # fixed-token fleets must present the secret to enroll; otherwise
        # login would hand the session token to any caller
        if self.session_token is not None and req.token != self.session_token:
            return _text("bad join token", 401)
        machine_id = req.machine_id or f"m-{uuid.uuid4().hex[:12]}"
        token = self.session_token or f"tok-{uuid.uuid4().hex}"
        self._issued_tokens[machine_id] = token
        self._record_machine_info(
            machine_id, req.machine_info.to_dict() if req.machine_info else {}
        )
        return _json(
            LoginResponse(
                machine_id=machine_id,
                token=token,
                machine_proof=f"proof-{machine_id}",
            ).to_dict()
        )

    def _session(self, request: Request) -> Response:
        stype = request.headers.get("X-TPUD-Session-Type", "")
        machine = request.headers.get("X-TPUD-Machine-ID", "")
        version = request.headers.get("X-TPUD-Version", "")
        auth = request.headers.get("Authorization", "")
        if not machine:
            return _text("missing machine id", 400)
        if not self._check_session_auth(machine, auth):
            return _text("unauthorized", 401)

        if stype == "read":
            # manager → agent: stream requests as ndjson for as long as
            # the agent stays connected; the handle registers once the
            # headers are out, as the reference's after prepare()
            return Response(
                content_type="application/x-ndjson",
                chunks=self._read_stream(AgentHandle(machine, "v1", version)),
            )

        if stype == "write":
            # agent → manager: chunked ndjson responses, decoded as they
            # arrive; a shut-down connection ends the stream
            try:
                while True:
                    line = request.stream.readline()
                    if not line:
                        break
                    line = line.strip()
                    if not line:
                        continue  # keep-alive blank
                    try:
                        d = json.loads(line)
                    except ValueError:
                        continue
                    if not isinstance(d, dict):
                        continue
                    with self._lock:
                        handle = self.agents.get(machine)
                    if handle is not None:
                        handle.resolve(str(d.get("req_id", "")), d.get("data") or {})
            except OSError:
                pass  # the agent or stop() closed the stream
            return _text("ok")

        return _text(f"bad session type {stype!r}", 400)

    def _read_stream(self, handle: AgentHandle):
        self._register(handle)
        try:
            while not handle.gone:
                item = self._next_outbound(handle)
                if item is None:
                    if handle.gone or self._stopping.is_set():
                        break
                    continue
                yield (json.dumps(item) + "\n").encode()
        finally:
            self._unregister(handle)

    def _next_outbound(self, handle: AgentHandle) -> Optional[dict]:
        """The stream's next request, waiting in a slot of
        ``max_v1_agents`` (past the cap, waiting for one); None on
        ``mark_gone``'s sentinel or once the plane stops. No wait is
        longer than ``POLL_SECONDS`` between looks at the stop flag."""
        while not self._stopping.is_set():
            if not self._stream_slots.acquire(timeout=POLL_SECONDS):
                continue
            try:
                while not self._stopping.is_set():
                    try:
                        return handle.outbound.get(timeout=POLL_SECONDS)
                    except queue.Empty:
                        continue
            finally:
                self._stream_slots.release()
        return None

    # -- operator API ------------------------------------------------------
    def _machines_route(self, request: Request) -> Response:
        """Connected agents."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        return _json({"machines": self.machines()})

    # per-entry serialized-size cap: dev mode accepts unauthenticated
    # logins, so without it a caller could pin machine_infos_max ×
    # multi-MB trees in memory (entry *count* alone doesn't bound memory)
    MACHINE_INFO_MAX_BYTES = 256 * 1024

    def _record_machine_info(self, machine_id: str, tree: dict) -> None:
        """Insertion-ordered overwrite with FIFO eviction past the cap —
        login-derived state stays bounded (same convention as the logins
        list above). Oversized trees are dropped, not truncated: a
        partial tree would present as authoritative machine state."""
        try:
            size = len(json.dumps(tree))
        except (TypeError, ValueError):
            logger.warning("unserializable machine_info from %s; not recorded",
                           machine_id)
            return
        if size > self.MACHINE_INFO_MAX_BYTES:
            logger.warning(
                "machine_info from %s is %d bytes (cap %d); not recorded",
                machine_id, size, self.MACHINE_INFO_MAX_BYTES,
            )
            return
        with self._lock:
            self.machine_infos.pop(machine_id, None)  # re-insert = newest
            self.machine_infos[machine_id] = tree
            while len(self.machine_infos) > self.machine_infos_max:
                self.machine_infos.pop(next(iter(self.machine_infos)))

    def _machine_info_route(self, request: Request) -> Response:
        """The MachineInfo tree recorded at the machine's last login
        (reference: control plane machine view fed by LoginRequest)."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        machine_id = request.match_info["machine_id"]
        missing = object()
        with self._lock:  # racing FIFO eviction in _record_machine_info
            tree = self.machine_infos.get(machine_id, missing)
        if tree is missing:
            return _text(f"unknown machine {machine_id}", 404)
        return _json({"machine_id": machine_id, "machine_info": tree})

    def _request_route(self, request: Request) -> Response:
        """Issue one method request to an agent and wait for its answer."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        machine_id = request.match_info["machine_id"]
        try:
            body = request.json()
        except ValueError:
            return _text("body must be JSON", 400)
        if not isinstance(body, dict) or not body.get("method"):
            return _text('body needs a "method"', 400)
        try:
            timeout = float(
                request.query.get("timeout", DEFAULT_REQUEST_TIMEOUT)
            )
        except ValueError:
            return _text("timeout must be a number", 400)
        # each in-flight request holds its connection's thread for its
        # duration
        timeout = min(max(timeout, 0.1), MAX_REQUEST_TIMEOUT)
        try:
            handle = self.agent(machine_id)
        except AgentGone:
            return _text(f"no agent {machine_id!r}", 404)
        try:
            payload = handle.request(body, timeout=timeout)
        except (TimeoutError, AgentGone) as e:
            return _text(str(e), 504)
        if body["method"] == "gossip" and isinstance(payload, dict) and payload.get("machine_info"):
            # refresh the recorded tree from the agent's gossip answer,
            # normalized through the shared wire type. The answer already
            # reached us successfully — a malformed tree skips the
            # recording, it must not 500 the response the agent gave
            from gpud_tpu_torch.api.v1.types import GossipRequest

            try:
                g = GossipRequest.from_dict(
                    {"machine_id": machine_id,
                     "machine_info": payload["machine_info"]}
                )
                if g.machine_info is not None:
                    self._record_machine_info(
                        machine_id, g.machine_info.to_dict()
                    )
            except Exception:  # noqa: BLE001 — agent sent a garbled tree
                logger.warning(
                    "unparseable gossip machine_info from %s; not recorded",
                    machine_id,
                )
        return _json({"machine_id": machine_id, "response": payload})

    def _drain_route(self, request: Request) -> Response:
        """Notify v2 agents and close every stream."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        self.drain("operator drain")
        return _json({"drained": True})

    # -- fleet observability API -------------------------------------------
    @staticmethod
    def _q_num(request: Request, name: str, default, caster):
        raw = request.query.get(name)
        if raw is None or raw == "":
            return default
        return caster(raw)

    def _fleet_pane(self, kind: str, local_fn, params: dict, scope: str):
        """Run one local pane read and, when federated and the caller
        didn't pin ``?scope=local``, widen it across live peers. Every
        inter-peer fan-out pins ``scope=local`` so depth stops at one."""
        local = local_fn()
        fed = self.federation
        if fed is None or scope == "local":
            return local
        return fed.federate(kind, local, params)

    def _fleet_rollup_route(self, request: Request) -> Response:
        """Fleet-wide rollup aggregates (availability, MTTR/MTBF,
        flapping, remediation outcomes); one pane across all peers
        unless ``?scope=local``."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        scope = request.query.get("scope", "")
        return _json(self._fleet_pane("rollup", self.rollup.fleet_rollup, {}, scope))

    def _fleet_fabric_route(self, request: Request) -> Response:
        """Fleet-wide fabric matrix rollup: per-agent link aggregates
        from journaled ``ici_link`` sweep records — "which links degraded
        since ts" across every agent (``?since=``)."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        try:
            since = self._q_num(request, "since", 0.0, float)
        except ValueError:
            return _text("since must be a number", 400)
        scope = request.query.get("scope", "")
        return _json(self._fleet_pane(
            "fabric", lambda: self.rollup.fleet_fabric(since), {"since": since}, scope))

    def _fleet_predict_route(self, request: Request) -> Response:
        """Fleet-ranked prediction pane: top-K (agent, component) rows
        by time-decayed predicted-failure risk (``?top=``)."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        try:
            top = self._q_num(request, "top", 20, int)
        except ValueError:
            return _text("top must be an integer", 400)
        scope = request.query.get("scope", "")
        return _json(self._fleet_pane(
            "predict", lambda: self.rollup.fleet_predict(top), {"top": top}, scope))

    def _fleet_agents_route(self, request: Request) -> Response:
        """One page of per-agent rollups (``?offset=&limit=``)."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        try:
            offset = self._q_num(request, "offset", 0, int)
            limit = self._q_num(request, "limit", 50, int)
        except ValueError:
            return _text("offset/limit must be integers", 400)
        scope = request.query.get("scope", "")
        return _json(self._fleet_pane(
            "agents", lambda: self.rollup.agents_page(offset, limit),
            {"offset": offset, "limit": limit}, scope))

    def _fleet_history_route(self, request: Request) -> Response:
        """Journaled record timeline for one agent
        (``?since=&limit=&offset=``), newest first."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        agent_id = request.match_info["agent_id"]
        try:
            since = self._q_num(request, "since", 0.0, float)
            limit = self._q_num(request, "limit", 100, int)
            offset = self._q_num(request, "offset", 0, int)
        except ValueError:
            return _text("since/limit/offset must be numbers", 400)
        scope = request.query.get("scope", "")
        local = self.rollup.history(agent_id, since, limit, offset)
        fed = self.federation
        if fed is None or scope == "local":
            return _json(local)
        # history is single-owner data: proxy to the rendezvous owner
        # when the journal doesn't know the agent locally
        return _json(fed.federate_history(
            agent_id, local, {"since": since, "limit": limit, "offset": offset}))

    def _fleet_traces_route(self, request: Request) -> Response:
        """Fleet records stitched to one agent-side check trace
        (``?correlation_id=``)."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        cid = request.query.get("correlation_id", "")
        if not cid:
            return _text("correlation_id is required", 400)
        try:
            limit = self._q_num(request, "limit", 200, int)
        except ValueError:
            return _text("limit must be an integer", 400)
        scope = request.query.get("scope", "")
        return _json(self._fleet_pane(
            "traces", lambda: self.rollup.traces(cid, limit),
            {"correlation_id": cid, "limit": limit}, scope))

    def _fleet_peers_route(self, request: Request) -> Response:
        """The peer map itself: ring order, rendezvous cohort counts,
        replication + replica watermarks, per-peer health. Standalone
        managers answer ``federation: false`` (200, not 404) so probes
        and the CLI work unchanged against either shape."""
        if not self._check_admin(request):
            return _text("unauthorized", 401)
        fed = self.federation
        if fed is None:
            return _json({
                "federation": False,
                "instance_id": self.instance_id,
                "peers": [],
            })
        return _json(fed.peers_view())

    def _metrics_route(self, _request: Request) -> Response:
        """Federated Prometheus exposition: manager registry + bounded
        per-agent fleet series. Unauthenticated, like the node /metrics."""
        from gpud_tpu_torch.manager.exposition import render_fleet_metrics

        body = render_fleet_metrics(
            self.rollup,
            ingest_executor=self.ingest_executor,
            federation=self.federation,
        )
        return _text(body, content_type=PROMETHEUS_CONTENT_TYPE)

    def _routes(self) -> List[Route]:
        """The route table, in the reference's registration order."""
        table = [
            ("POST", "/api/v1/login", self._login),
            ("POST", "/api/v1/session", self._session),
            ("GET", "/v1/machines", self._machines_route),
            ("GET", "/v1/machines/{machine_id}/machine-info", self._machine_info_route),
            ("POST", "/v1/machines/{machine_id}/request", self._request_route),
            ("POST", "/v1/drain", self._drain_route),
            ("GET", "/v1/fleet/rollup", self._fleet_rollup_route),
            ("GET", "/v1/fleet/fabric", self._fleet_fabric_route),
            ("GET", "/v1/fleet/predict", self._fleet_predict_route),
            ("GET", "/v1/fleet/agents", self._fleet_agents_route),
            ("GET", "/v1/fleet/agents/{agent_id}/history", self._fleet_history_route),
            ("GET", "/v1/fleet/traces", self._fleet_traces_route),
            ("GET", "/v1/fleet/peers", self._fleet_peers_route),
            ("GET", "/metrics", self._metrics_route),
        ]
        return [
            Route(method, path, fn, (fn.__doc__ or fn.__name__).strip().split("\n")[0],
                  stream_body=path == "/api/v1/session")
            for method, path, fn in table
        ]

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """One-shot: after stop() (including the internal cleanup stop on
        a failed start) the pools are shut down — build a new ControlPlane
        instead of restarting this one."""
        with self._lifecycle:  # serializes whole-start vs whole-stop
            self._start_locked()

    def _start_locked(self) -> None:
        if self._stopped:
            raise RuntimeError(
                "ControlPlane cannot be restarted; create a new instance"
            )
        if self._start_called:
            raise RuntimeError("ControlPlane already started")
        self._start_called = True
        from gpud_tpu_torch.server.listener import Listener

        self._stream_slots = threading.BoundedSemaphore(max(1, int(self.max_v1_agents)))

        app = App(routes=self._routes(), observe=False)

        # the writer needs a periodic drain job (threshold pokes are
        # no-ops without one); the manager owns a one-worker scheduler
        from gpud_tpu_torch.scheduler.core import Scheduler

        self._scheduler = Scheduler(workers=1)
        self.writer.start(self._scheduler)
        # enforce the journal row cap: without this job purge() has no
        # caller and a --data-dir manager's fleet.db grows without bound
        self._scheduler.add_job(
            "fleet-journal-purge",
            self.rollup.purge,
            interval=60.0,
            initial_delay=60.0,
        )
        self._scheduler.start()

        try:
            httpd = Listener(("127.0.0.1", self.port), app)
        except OSError as e:
            self.stop()
            raise RuntimeError("manager HTTP server failed to start") from e
        self._httpd = httpd
        self.port = httpd.server_address[1]
        self._thread = threading.Thread(
            target=httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="tpud-manager-http", daemon=True,
        )
        self._thread.start()
        try:
            self._start_grpc()
        except Exception:
            # start() is atomic: a gRPC bind failure must not leak the
            # already-listening HTTP thread/socket
            self.stop()
            raise
        logger.info(
            "control plane up: http=127.0.0.1:%d grpc=127.0.0.1:%d",
            self.port,
            self.grpc_port,
        )

    def _start_grpc(self) -> None:
        try:
            import grpc
        except ImportError:
            logger.warning("grpc unavailable; v2 transport disabled")
            self.grpc_port = -1
            return
        from concurrent import futures

        from gpud_tpu_torch.session.v2 import session_pb2 as pb

        handler = grpc.stream_stream_rpc_method_handler(
            self._connect_v2,
            request_deserializer=pb.AgentPacket.FromString,
            response_serializer=pb.ManagerPacket.SerializeToString,
        )
        service = grpc.method_handlers_generic_handler(
            "tpud.session.v2.Session", {"Connect": handler}
        )
        # each v2 Connect stream pins one handler thread for its lifetime
        # — this is the v2 fleet-size cap (constructor `max_v2_agents`;
        # raise it to hold a multi-thousand-agent fleet of persistent
        # streams, each costing one mostly-idle pool thread)
        self._grpc_server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self.max_v2_agents),
            # without this, Linux SO_REUSEPORT lets a second manager bind
            # the same port and silently split the agent fleet
            options=[("grpc.so_reuseport", 0)],
        )
        self._grpc_server.add_generic_rpc_handlers((service,))
        requested = self.grpc_port
        self.grpc_port = self._grpc_server.add_insecure_port(
            f"127.0.0.1:{self.grpc_port}"
        )
        if self.grpc_port == 0:
            # grpc reports a failed bind as port 0 — surface it instead of
            # silently serving v1-only
            self._grpc_server = None
            raise RuntimeError(
                f"gRPC bind failed on 127.0.0.1:{requested} (port in use?)"
            )
        self._grpc_server.start()

    def _connect_v2(self, request_iterator, context):
        from gpud_tpu_torch.session.v2 import session_pb2 as pb
        from gpud_tpu_torch.session.v2 import typed

        try:
            first = next(request_iterator)
        except StopIteration:
            # stream opened and closed without a Hello (probe/scanner) —
            # returning here must not trip PEP 479 inside the generator
            return
        if first.WhichOneof("payload") != "hello":
            return  # protocol violation: close the stream
        hello = first.hello
        ack = pb.ManagerPacket()
        if not self._check_session_auth(hello.machine_id, f"Bearer {hello.token}"):
            ack.hello_ack.accepted = False
            ack.hello_ack.reason = "bad token"
            yield ack
            return
        # negotiate: the highest revision both sides speak (agent range
        # [min,max]; rev-1 agents leave max at 0 and set `revision`)
        agent_max = hello.max_revision or hello.revision or 1
        revision = min(agent_max, MAX_REVISION)
        if hello.min_revision and revision < hello.min_revision:
            # a future agent whose floor exceeds what this manager speaks
            # must be rejected, not driven at a revision it disclaimed
            ack.hello_ack.accepted = False
            ack.hello_ack.reason = (
                f"no common revision: agent [{hello.min_revision},"
                f"{hello.max_revision}] vs manager max {MAX_REVISION}"
            )
            yield ack
            return
        ack.hello_ack.accepted = True
        ack.hello_ack.revision = revision
        ack.hello_ack.manager_instance_id = self.instance_id
        yield ack

        handle = AgentHandle(
            hello.machine_id, f"v2-rev{revision}", hello.tpud_version
        )
        self._register(handle)
        stop = threading.Event()

        def decode_bytes(raw: bytes):
            # rev >= 3: wire-codec framed (prefix + optional zlib);
            # below: bare JSON bytes (ValueError either way on garbage)
            if revision >= 3:
                from gpud_tpu_torch.session import wire

                return wire.decode_payload(raw)
            return json.loads(raw.decode())

        def drain_responses() -> None:
            try:
                for pkt in request_iterator:
                    kind = pkt.WhichOneof("payload")
                    if kind == "frame":
                        try:
                            data = decode_bytes(pkt.frame.data)
                        except ValueError:
                            continue
                        handle.resolve(pkt.frame.req_id, data)
                    elif kind == "result":
                        try:
                            data = decode_bytes(pkt.result.payload_json)
                        except ValueError:
                            continue
                        handle.resolve(pkt.result.request_id, data)
            except Exception:  # noqa: BLE001 - client cancel mid-read
                pass
            finally:
                stop.set()
                # wake the response generator NOW: it polls outbound with a
                # 0.2s timeout, and that linger holds a gRPC pool slot per
                # closed stream — at fleet churn rates (thousands of short
                # sessions) the idle tail, not real work, becomes the cap
                handle.outbound.put(None)

        threading.Thread(
            target=drain_responses,
            name=f"tpud-manager-v2-{hello.machine_id}",
            daemon=True,
        ).start()

        try:
            while not stop.is_set() and context.is_active():
                if handle.draining.is_set():
                    d = pb.ManagerPacket()
                    d.drain_notice.reason = handle.drain_reason
                    yield d
                    return
                item = _q_get(handle.outbound, timeout=0.2)
                if item is None:
                    # drain's mark_gone() sentinel can land while we wait:
                    # the notice must still go out before the stream ends
                    if handle.draining.is_set():
                        d = pb.ManagerPacket()
                        d.drain_notice.reason = handle.drain_reason
                        yield d
                        return
                    if handle.gone:
                        return
                    continue
                req_id, data = item["req_id"], item["data"]
                if revision >= 2:
                    try:
                        mpkt = typed.dict_to_request(data, req_id)
                        yield mpkt
                        continue
                    except Exception:  # noqa: BLE001
                        # method outside the typed set, or params the
                        # encoder chokes on (e.g. since="abc") — fall back
                        # to the Frame tunnel so one bad operator request
                        # can't tear down a healthy agent's stream; the
                        # agent dispatcher answers a structured error
                        pass
                m = pb.ManagerPacket()
                m.frame.req_id = req_id
                if revision >= 3:
                    from gpud_tpu_torch.session import wire

                    m.frame.data = wire.encode_payload(data)
                else:
                    m.frame.data = json.dumps(data).encode()
                yield m
        finally:
            self._unregister(handle)

    def drain(self, reason: str = "shutdown") -> None:
        """Notify currently-connected v2 agents (DrainNotice) and end v1
        read streams. Drain is a point-in-time action: agents that
        reconnect afterwards are served normally."""
        with self._lock:
            handles = list(self.agents.values())
        for h in handles:
            h.drain_reason = reason
            h.draining.set()
            h.mark_gone()

    def stop(self) -> None:
        with self._lifecycle:  # a stop racing an in-flight start waits
            self._stop_locked()

    def _stop_locked(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        self._stopping.set()
        # federation first: the shipper's session threads reconnect-loop
        # against the successor, and the fan-out pool must stop taking
        # work before the listener beneath it does
        if self.federation is not None:
            self.federation.stop()
            self.federation = None
        self.drain("manager stopping")
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=1.0)
            self._grpc_server = None
        httpd, thread = self._httpd, self._thread
        if httpd is not None:
            if thread is not None and thread.is_alive():
                httpd.shutdown()  # returns once serve_forever has
            # ends every open stream's connection and joins its thread
            httpd.close(JOIN_SECONDS)
            self._httpd = None
        if thread is not None:
            thread.join(timeout=JOIN_SECONDS)
            self._thread = None
        # drain the shard workers before storage teardown: anything a
        # reader enqueued before its stream died still journals + acks
        self.ingest_executor.stop()
        # storage last: the final writer.close() barrier commits whatever
        # the torn-down transports journaled on their way out
        if self._scheduler is not None:
            self._scheduler.close()
            self._scheduler = None
        try:
            self.writer.close()
        finally:
            self.db.close()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"


def _q_get(q: "queue.Queue", timeout: float = 0.5):
    try:
        return q.get(timeout=timeout)
    except queue.Empty:
        return None
