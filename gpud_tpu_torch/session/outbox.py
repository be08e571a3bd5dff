"""Durable store-and-forward outbox for the control-plane session; the port
of ``gpud_tpu/session/outbox.py``.

The session's in-memory channels (``CHANNEL_CAP`` in session.py) are a
wire buffer, not a delivery contract: anything produced while the
control plane is unreachable — exactly the window the fleet operator
most needs this node's telemetry ("When GPUs Fail Quietly", PAPERS.md) —
was silently lost on overflow or daemon restart. The ``SessionOutbox``
closes that gap:

- producers (event inserts, health transitions, remediation audit rows,
  chaos campaign results, gossip) ``publish()`` outbound records; each
  is journaled to a SQLite table through the shared write-behind
  ``BatchWriter`` (docs/storage.md) and assigned a monotonic sequence
  number at publish time;
- a replay job drains everything above the last manager-acked watermark
  into the live session whenever it is connected — at-least-once
  delivery: a redelivered frame carries the same ``dedupe_key``, so the
  manager side deduplicates;
- the manager acks by calling the ``outboxAck`` session method with the
  highest contiguous sequence it has seen; the watermark only ever
  advances (``MAX(acked_seq, ?)`` both in memory and in SQL), so a crash
  or batch reorder can never regress it and re-deliver the world;
- retention bounds the journal by row count and age so a week-long
  partition degrades telemetry (oldest rows drop, with accounting in
  ``tpud_outbox_dropped_total``) instead of filling the disk.

The module also owns the session ``CircuitBreaker``
(closed → open on consecutive connect failures → half-open probe →
closed), exposed as ``tpud_session_circuit_state`` and consulted by the
session keep-alive loop so a hard-down manager stops costing connect
attempts. Delivery semantics are documented in docs/session.md.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, gauge
from gpud_tpu_torch.session import wire

logger = get_logger(__name__)

TABLE = "tpud_session_outbox_v0_1"
ACK_TABLE = "tpud_session_outbox_ack_v0_1"

DEFAULT_MAX_ROWS = 100_000        # journal hard cap (rows)
DEFAULT_MAX_AGE = 7 * 86400       # journal age cap: one week of partition
DEFAULT_REPLAY_BATCH = 500        # records packed into one delivery frame
DEFAULT_REDELIVER_AFTER = 30.0    # ack-stall window before redelivery

# delivery frames ride the normal agent→manager stream with this req_id
# prefix; the manager treats them as unsolicited data, not responses
REPLAY_REQ_PREFIX = "outbox-"

# write-behind contract (tools/storage_lint.py): these methods must route
# through the BatchWriter, never commit per-row via db.execute directly
HOT_WRITE_METHODS = ("publish", "ack")

_c_published = counter(
    "tpud_outbox_published_total",
    "records journaled into the session outbox, by kind",
)
_c_replayed = counter(
    "tpud_outbox_replayed_total",
    "outbox frames handed to the session transport (delivery attempts; "
    "at-least-once, so redeliveries count again)",
)
_c_dropped = counter(
    "tpud_outbox_dropped_total",
    "outbox records lost before ack, by reason (journal-full write drops, "
    "retention purging unacked rows past the hard cap)",
)
_c_purged = counter(
    "tpud_outbox_purged_total",
    "acked outbox rows removed by size/age retention (normal housekeeping, "
    "not data loss)",
)
_g_backlog = gauge(
    "tpud_outbox_backlog",
    "journaled outbox records not yet acked by the manager",
)
_g_acked = gauge(
    "tpud_outbox_acked_seq",
    "highest manager-acked outbox sequence number (the replay watermark)",
)
_g_circuit = gauge(
    "tpud_session_circuit_state",
    "control-plane circuit breaker state: 0=closed, 1=open, 2=half-open",
)
_c_circuit_transitions = counter(
    "tpud_session_circuit_transitions_total",
    "circuit breaker state transitions, by target state",
)
_c_circuit_blocked = counter(
    "tpud_session_circuit_blocked_total",
    "connect attempts suppressed because the circuit breaker was open",
)


class SessionOutbox:
    """Durable at-least-once delivery journal (module docstring).

    Thread-safe: ``publish`` may be called from any producer thread
    (component checks, the kmsg watcher, session dispatch, the chaos
    runner); ``ack`` arrives on the session serve thread; ``replay_once``
    runs on a scheduler worker. Sequence assignment and the watermark are
    guarded by one lock; SQL rides the shared ``BatchWriter`` buffer.
    """

    GUARDED_BY = {
        "_next_seq": "_mu",
        "_acked": "_mu",
        "_published": "_mu",
        "_replayed": "_mu",
        "_write_drops": "_mu",
        "_retention_drops": "_mu",
        "_delivered": "_mu",
        "_ack_progress_ts": "_mu",
        "_flushed_seq": "_mu",
        "_encoder": "_mu",
    }

    def __init__(
        self,
        db,
        writer=None,
        max_rows: int = DEFAULT_MAX_ROWS,
        max_age_seconds: float = DEFAULT_MAX_AGE,
        replay_batch: int = DEFAULT_REPLAY_BATCH,
        keyframe_interval: int = wire.DEFAULT_KEYFRAME_INTERVAL,
        redeliver_after_seconds: float = DEFAULT_REDELIVER_AFTER,
        time_now_fn: Callable[[], float] = time.time,
    ) -> None:
        self.db = db
        self.writer = writer
        self.max_rows = int(max_rows)
        self.max_age_seconds = float(max_age_seconds)
        self.replay_batch = max(1, int(replay_batch))
        self.redeliver_after_seconds = float(redeliver_after_seconds)
        self.time_now_fn = time_now_fn
        self._mu = threading.Lock()
        # per-stream delta encoder for delivery batches (docs/session.md
        # wire format); guarded by _mu — replay runs on a scheduler
        # worker, reset_delivery on the session keep-alive thread
        self._encoder = wire.DeltaEncoder(keyframe_interval)
        db.execute(
            f"""CREATE TABLE IF NOT EXISTS {TABLE} (
                seq INTEGER PRIMARY KEY,
                ts REAL NOT NULL,
                kind TEXT NOT NULL,
                dedupe_key TEXT NOT NULL,
                payload TEXT NOT NULL
            )"""
        )
        db.execute(
            f"""CREATE TABLE IF NOT EXISTS {ACK_TABLE} (
                id INTEGER PRIMARY KEY CHECK (id = 1),
                acked_seq INTEGER NOT NULL
            )"""
        )
        db.execute(
            f"INSERT OR IGNORE INTO {ACK_TABLE} (id, acked_seq) VALUES (1, 0)"
        )
        # restart: resume sequence numbering after the highest journaled
        # row and reload the persisted watermark — both only ever advance
        row = db.query_one(f"SELECT MAX(seq) FROM {TABLE}")
        self._next_seq = int(row[0] or 0) + 1 if row else 1
        row = db.query_one(f"SELECT acked_seq FROM {ACK_TABLE} WHERE id=1")
        self._acked = int(row[0] or 0) if row else 0
        # a restart may reload a watermark ahead of MAX(seq) if acked rows
        # were purged; never mint a seq at/below the watermark
        if self._acked >= self._next_seq:
            self._next_seq = self._acked + 1
        self._published = 0
        self._replayed = 0
        self._write_drops = 0
        self._retention_drops = 0
        # delivered-high-water: the highest seq already handed to the
        # live transport this connection. Purely in-memory — replay reads
        # above max(acked, delivered) so a slow ack doesn't cause a
        # redundant SELECT + re-encode every tick (dedupe keys make
        # redelivery safe; re-reading was pure wasted work). Falls back
        # to the durable watermark on reconnect (reset_delivery) or when
        # acks stall past redeliver_after_seconds.
        self._delivered = self._acked
        self._ack_progress_ts = self.time_now_fn()
        # journal-flush high-water: the highest seq known durable behind
        # the write-behind buffer. pending() only needs a flush barrier
        # when rows it could return are still buffered; skipping the
        # barrier otherwise keeps steady-state drain off the flusher's
        # critical path (the coalesced ack UPDATE is always buffered, but
        # it never gates a read — the replay floor is in-memory)
        self._flushed_seq = self._next_seq - 1
        _g_acked.set(self._acked)
        _g_backlog.set(self.backlog())

    # -- producer side -----------------------------------------------------
    def publish(
        self, kind: str, payload: Dict, dedupe_key: str = ""
    ) -> int:
        """Journal one outbound record; returns its sequence number.

        ``dedupe_key`` identifies the record across redeliveries (the
        manager's dedupe handle); empty derives a stable ``kind:seq`` key.
        """
        now = self.time_now_fn()
        with self._mu:
            seq = self._next_seq
            self._next_seq += 1
            self._published += 1
            # snapshot the watermark for the gauge below — reading
            # self._acked unlocked after the block raced ack()
            acked = self._acked
        key = dedupe_key or f"{kind}:{seq}"
        sql = (
            f"INSERT INTO {TABLE} (seq, ts, kind, dedupe_key, payload) "
            "VALUES (?, ?, ?, ?, ?)"
        )
        # wire.pack_obj: msgpack bytes when available (several times
        # faster to serialize AND to re-read on the replay hot path —
        # bench.py --wire), compact JSON otherwise; unpack_obj sniffs, so
        # journals mix encodings freely across upgrades
        params = (seq, now, kind, key, wire.pack_obj(payload))
        if self.writer is not None:
            if not self.writer.submit("outbox", sql, params):
                with self._mu:
                    self._write_drops += 1
                _c_dropped.inc(labels={"reason": "journal_full"})
        else:
            self.db.execute(sql, params)
        _c_published.inc(labels={"kind": kind})
        _g_backlog.set(max(0, seq - acked))
        return seq

    # -- manager ack path --------------------------------------------------
    def ack(self, seq: int) -> int:
        """Advance the replay watermark to ``seq``; returns the (possibly
        unchanged) watermark. Monotonic: a stale or duplicate ack — the
        manager replays acks too under at-least-once — never regresses it.
        """
        seq = int(seq)
        with self._mu:
            if seq <= self._acked:
                return self._acked
            self._acked = seq
            self._ack_progress_ts = self.time_now_fn()
            if seq > self._delivered:
                # an ack implies delivery even if this process never sent
                # the frame (restart raced a late manager ack)
                self._delivered = seq
        # MAX() in SQL too: group-commit batches may reorder vs. memory
        sql = f"UPDATE {ACK_TABLE} SET acked_seq = MAX(acked_seq, ?) WHERE id = 1"
        if self.writer is not None:
            # coalesce: many acks inside one flush window commit once
            self.writer.submit("outbox", sql, (seq,), key=("outbox-ack",))
        else:
            self.db.execute(sql, (seq,))
        _g_acked.set(seq)
        _g_backlog.set(self.backlog())
        return seq

    @property
    def acked_seq(self) -> int:
        with self._mu:
            return self._acked

    @property
    def last_seq(self) -> int:
        with self._mu:
            return self._next_seq - 1

    def backlog(self) -> int:
        with self._mu:
            return max(0, (self._next_seq - 1) - self._acked)

    @property
    def delivered_seq(self) -> int:
        with self._mu:
            return self._delivered

    def reset_delivery(self) -> None:
        """Reconnect hook (server on_connected): in-flight unacked frames
        may have died with the old connection and the manager's delta
        decoder is fresh — fall back to the durable watermark and restart
        every delta stream at a keyframe."""
        with self._mu:
            self._delivered = self._acked
            self._encoder.reset()
            self._ack_progress_ts = self.time_now_fn()

    # -- replay ------------------------------------------------------------
    def flush(self) -> None:
        """Read-after-write barrier (no-op without a writer, or when every
        published row is already known durable)."""
        if self.writer is None:
            return
        with self._mu:
            target = self._next_seq - 1
            if target <= self._flushed_seq:
                return
        if self.writer.flush():
            with self._mu:
                if target > self._flushed_seq:
                    self._flushed_seq = target

    def _read_pending(
        self, after: int, limit: int
    ) -> Tuple[List[Tuple], List]:
        """Rows above ``after`` plus their decoded payloads, as parallel
        lists (the replay hot path consumes them zipped without building
        combined 5-tuples). Callers handle the flush barrier."""
        sql = (
            f"SELECT seq, ts, kind, dedupe_key, payload FROM {TABLE} "
            "WHERE seq > ? ORDER BY seq"
        )
        params: list = [after]
        if limit:
            sql += " LIMIT ?"
            params.append(limit)
        rows = self.db.query(sql, params)
        raws = [r[4] for r in rows]
        try:
            payloads = wire.unpack_many(raws)
        except ValueError:
            # a corrupt row must not become a poison pill that fails every
            # replay tick — deliver it as an opaque blob instead
            payloads = []
            for raw in raws:
                try:
                    payloads.append(wire.unpack_obj(raw))
                except ValueError:
                    payloads.append({"raw": repr(raw)})
        return rows, payloads

    def pending(
        self, limit: int = 0, after: Optional[int] = None
    ) -> List[Tuple[int, float, str, str, Dict]]:
        """Journaled records above the watermark (or ``after``), oldest
        first: ``(seq, ts, kind, dedupe_key, payload)`` rows."""
        self.flush()
        rows, payloads = self._read_pending(
            self.acked_seq if after is None else int(after), limit
        )
        return [
            (seq, ts, kind, key, payloads[i])
            for i, (seq, ts, kind, key, _raw) in enumerate(rows)
        ]

    def replay_once(self, session) -> int:
        """Drain one delivery batch into a connected session.

        Packs up to ``replay_batch`` delta-encoded records into ONE
        ``outbox_batch`` frame (docs/session.md wire format); the manager
        answers a single cumulative ``outboxAck`` per batch. Returns the
        number of records handed to the transport (0 = nothing pending
        or the send was refused — the next tick retries keyframe-anchored,
        which is what at-least-once means). Reads above
        ``max(acked, delivered)`` so already-delivered-but-unacked rows
        aren't re-read and re-encoded every tick; an ack stalled past
        ``redeliver_after_seconds`` drops the delivered floor back to the
        durable watermark and restarts the delta streams. A disconnected
        or auth-parked session is a no-op: replay must not hammer a
        manager that just revoked the token.
        """
        if session is None or not session.connected or session.auth_failed:
            return 0
        from gpud_tpu_torch.session.session import Frame

        now = self.time_now_fn()
        with self._mu:
            if (
                self._delivered > self._acked
                and now - self._ack_progress_ts >= self.redeliver_after_seconds
            ):
                # frames in flight on a previous connection (or a stalled
                # manager) never acked: redeliver from the durable
                # watermark, keyframe-anchored — this is also the repair
                # path for a peer whose delta decoder lost sync
                logger.warning(
                    "outbox ack stalled %.0fs at seq %d (delivered %d); "
                    "redelivering", now - self._ack_progress_ts,
                    self._acked, self._delivered,
                )
                self._delivered = self._acked
                self._encoder.reset()
                self._ack_progress_ts = now
            floor = max(self._acked, self._delivered)
        self.flush()
        rows, payloads = self._read_pending(floor, self.replay_batch)
        if not rows:
            return 0
        with self._mu:
            encode = self._encoder.encode_record
            records = [
                encode(row[0], row[1], row[2], row[3], payloads[i])
                for i, row in enumerate(rows)
            ]
        first, last = rows[0][0], rows[-1][0]
        frame = Frame(
            req_id=f"{REPLAY_REQ_PREFIX}batch-{first}-{last}",
            data=wire.build_batch(records),
        )
        if not session.send(frame):
            with self._mu:
                # the peer may have read a prefix of the frame's streams;
                # restart them so redelivery is keyframe-anchored
                self._encoder.reset()
            return 0
        sent = len(rows)
        with self._mu:
            self._replayed += sent
            if last > self._delivered:
                self._delivered = last
        _c_replayed.inc(sent)
        return sent

    # -- retention ---------------------------------------------------------
    def purge_once(self) -> int:
        """Size/age retention pass (scheduler "retention-purge" target).

        Acked rows older than ``max_age_seconds`` go first (normal
        housekeeping). Past ``max_rows`` the oldest rows drop regardless
        of ack state — unacked drops are data loss and are accounted in
        ``tpud_outbox_dropped_total{reason=retention}``.
        """
        self.flush()
        cutoff = self.time_now_fn() - self.max_age_seconds
        acked = self.acked_seq
        cur = self.db.execute(
            f"DELETE FROM {TABLE} WHERE seq <= ? AND ts < ?", (acked, cutoff)
        )
        purged = max(0, int(getattr(cur, "rowcount", 0) or 0))
        row = self.db.query_one(f"SELECT COUNT(*), MIN(seq) FROM {TABLE}")
        count, min_seq = (int(row[0] or 0), int(row[1] or 0)) if row else (0, 0)
        if count > self.max_rows:
            excess = count - self.max_rows
            horizon = min_seq + excess - 1
            lost = self.db.query_one(
                f"SELECT COUNT(*) FROM {TABLE} WHERE seq <= ? AND seq > ?",
                (horizon, acked),
            )
            lost_n = int(lost[0] or 0) if lost else 0
            self.db.execute(f"DELETE FROM {TABLE} WHERE seq <= ?", (horizon,))
            purged += excess
            if lost_n:
                with self._mu:
                    self._retention_drops += lost_n
                _c_dropped.inc(lost_n, {"reason": "retention"})
                logger.warning(
                    "outbox retention dropped %d unacked record(s) "
                    "(journal past %d rows)", lost_n, self.max_rows,
                )
                # rows below the horizon are gone; pretend the manager
                # acked them so replay doesn't spin on a hole forever
                self.ack(horizon)
        if purged:
            _c_purged.inc(purged)
        _g_backlog.set(self.backlog())
        return purged

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict:
        with self._mu:
            published = self._published
            replayed = self._replayed
            acked = self._acked
            delivered = self._delivered
            next_seq = self._next_seq
            write_drops = self._write_drops
            retention_drops = self._retention_drops
            keyframe_interval = self._encoder.keyframe_interval
        return {
            "last_seq": next_seq - 1,
            "acked_seq": acked,
            "delivered_seq": delivered,
            "backlog": max(0, (next_seq - 1) - acked),
            "keyframe_interval": keyframe_interval,
            "redeliver_after_seconds": self.redeliver_after_seconds,
            "published": published,
            "replayed": replayed,
            "dropped_journal_full": write_drops,
            "dropped_retention": retention_drops,
            "max_rows": self.max_rows,
            "max_age_seconds": self.max_age_seconds,
        }


# -- circuit breaker -------------------------------------------------------

CIRCUIT_CLOSED = "closed"
CIRCUIT_OPEN = "open"
CIRCUIT_HALF_OPEN = "half_open"

_CIRCUIT_GAUGE_VALUES = {CIRCUIT_CLOSED: 0, CIRCUIT_OPEN: 1, CIRCUIT_HALF_OPEN: 2}

DEFAULT_FAILURE_THRESHOLD = 5
DEFAULT_OPEN_SECONDS = 30.0
_HISTORY_CAP = 64


class CircuitBreaker:
    """Connect-path circuit breaker (closed → open → half-open → closed).

    ``allow()`` gates each connect attempt: closed always permits; open
    denies until ``open_seconds`` elapse, then transitions to half-open
    and permits exactly one probe; the probe's ``record_success`` closes
    the circuit, its ``record_failure`` re-opens it for a fresh cooldown.
    State rides ``tpud_session_circuit_state`` and a bounded transition
    history feeds the chaos expectation layer.

    With a ``peers`` list (HA manager tier, docs/session.md) the breaker
    also owns failover: every trip to OPEN rotates ``current_peer()`` to
    the next configured manager, and until one full sweep of the peer
    list has failed, the rotation grants an immediate probe at the new
    peer instead of sitting out the cooldown — a dead manager costs
    reconnect latency, not ``open_seconds`` per peer. Once every peer
    has failed in one sweep, the normal cooldown resumes (the whole
    tier is down; hammering it helps nobody). The acked-watermark
    contract is unaffected: ``SessionOutbox.ack`` is monotonic MAX, so
    acks arriving late from the old peer can never regress what the new
    peer has acknowledged.
    """

    GUARDED_BY = {
        "_state": "_mu",
        "_failures": "_mu",
        "_opened_at": "_mu",
        "_blocked": "_mu",
        "history": "_mu",
        "_peer_index": "_mu",
        "_failover_probe": "_mu",
        "_sweep": "_mu",
        "_failovers": "_mu",
    }

    def __init__(
        self,
        failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        open_seconds: float = DEFAULT_OPEN_SECONDS,
        time_fn: Callable[[], float] = time.monotonic,
        peers: Optional[List[str]] = None,
    ) -> None:
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_seconds = float(open_seconds)
        self.time_fn = time_fn
        # peer endpoints in failover order; entry 0 is the primary. Set
        # at configuration time, before the session's keep-alive thread
        # starts — only the index is guarded
        self.peers: List[str] = [p for p in (peers or []) if p]
        self._mu = threading.Lock()
        self._state = CIRCUIT_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._blocked = 0
        self._peer_index = 0
        self._failover_probe = False
        self._sweep = 0  # consecutive peers failed in the current sweep
        self._failovers = 0
        # (monotonic_ts, state) transitions, oldest first, bounded
        self.history: List[Tuple[float, str]] = [(self.time_fn(), CIRCUIT_CLOSED)]
        _g_circuit.set(0)

    def _transition_locked(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        self.history.append((self.time_fn(), state))
        del self.history[:-_HISTORY_CAP]
        _g_circuit.set(_CIRCUIT_GAUGE_VALUES[state])
        _c_circuit_transitions.inc(labels={"to": state})

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def states_seen(self) -> List[str]:
        with self._mu:
            return [s for _ts, s in self.history]

    def allow(self) -> bool:
        """True when a connect attempt may proceed now."""
        with self._mu:
            if self._state == CIRCUIT_CLOSED:
                return True
            if self._state == CIRCUIT_OPEN:
                if self._failover_probe:
                    # a failover just rotated current_peer(): probe the
                    # new peer immediately instead of serving the dead
                    # peer's cooldown (one probe — it either closes the
                    # circuit or burns this peer too)
                    self._failover_probe = False
                    self._transition_locked(CIRCUIT_HALF_OPEN)
                    return True
                if self.time_fn() - self._opened_at >= self.open_seconds:
                    self._transition_locked(CIRCUIT_HALF_OPEN)
                    return True  # the single half-open probe
                self._blocked += 1
                _c_circuit_blocked.inc()
                return False
            # half-open: one probe is already in flight on the keep-alive
            # thread; there is exactly one caller, so permitting again is
            # harmless but keep the gate strict
            return True

    def recovery_age(self) -> Optional[float]:
        """Seconds since the breaker last closed out of half-open, or
        None when the latest transition isn't such a recovery. A fresh
        recovery means this connect is the first after an outage — the
        whole fleet is reconnecting at once, so the server jitters its
        outbox replay poke instead of bursting (docs/session.md)."""
        with self._mu:
            h = self.history
            if (
                len(h) >= 2
                and h[-1][1] == CIRCUIT_CLOSED
                and h[-2][1] == CIRCUIT_HALF_OPEN
            ):
                return max(0.0, self.time_fn() - h[-1][0])
        return None

    def seconds_until_probe(self) -> float:
        """Remaining cooldown while open (0 when an attempt may proceed)."""
        with self._mu:
            if self._state != CIRCUIT_OPEN:
                return 0.0
            if self._failover_probe:
                return 0.0  # a rotated peer is waiting for its probe
            return max(0.0, self.open_seconds - (self.time_fn() - self._opened_at))

    def record_success(self) -> None:
        with self._mu:
            self._failures = 0
            self._sweep = 0
            self._failover_probe = False
            self._transition_locked(CIRCUIT_CLOSED)

    def record_failure(self) -> None:
        with self._mu:
            self._failures += 1
            if self._state == CIRCUIT_HALF_OPEN:
                # failed probe: back to open for a fresh cooldown
                self._opened_at = self.time_fn()
                self._transition_locked(CIRCUIT_OPEN)
                self._rotate_peer_locked()
            elif (
                self._state == CIRCUIT_CLOSED
                and self._failures >= self.failure_threshold
            ):
                self._opened_at = self.time_fn()
                self._transition_locked(CIRCUIT_OPEN)
                self._rotate_peer_locked()

    def _rotate_peer_locked(self) -> None:
        """On every trip to OPEN with >1 configured peers: advance to
        the next peer and decide whether it gets an immediate probe
        (still inside the current sweep) or the normal cooldown (one
        full sweep failed — every peer is down)."""
        if len(self.peers) < 2:
            return
        self._peer_index = (self._peer_index + 1) % len(self.peers)
        self._failovers += 1
        self._sweep += 1
        if self._sweep < len(self.peers):
            self._failover_probe = True
        else:
            self._sweep = 0
            self._failover_probe = False

    def current_peer(self) -> str:
        """The endpoint spec the session should dial now ("" without a
        configured peer list)."""
        with self._mu:
            if not self.peers:
                return ""
            return self.peers[self._peer_index]

    @property
    def failover_count(self) -> int:
        with self._mu:
            return self._failovers

    @property
    def blocked_count(self) -> int:
        with self._mu:
            return self._blocked

    def stats(self) -> Dict:
        with self._mu:
            return {
                "state": self._state,
                "consecutive_failures": self._failures,
                "failure_threshold": self.failure_threshold,
                "open_seconds": self.open_seconds,
                "blocked_attempts": self._blocked,
                "states_seen": [s for _ts, s in self.history],
                "peers": list(self.peers),
                "peer_index": self._peer_index,
                "failovers": self._failovers,
            }
