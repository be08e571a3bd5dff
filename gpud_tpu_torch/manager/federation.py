"""Manager federation: journal stream-replication + scatter-gather; the
port of ``gpud_tpu/manager/federation.py``.

The HA manager tier (docs/fleet.md "Federation & failover"). Each
manager in a ``PeerSet`` (peers.py) runs three cooperating pieces:

- **JournalShipper** — ships this manager's rollup-journal appends
  (manager/rollup.py, ordered by SQLite rowid) to its ring successor
  over the same session transport agents use: a ``Session`` with a
  ``peer:`` machine id, delta-encoded ``outbox_batch`` frames, and the
  manager side's cumulative ``outboxAck`` watermark. The contract is
  the agent outbox contract (session/outbox.py) verbatim: at-least-once
  delivery above a monotonic acked watermark, keyframe-anchored
  redelivery after a reconnect or an ack stall.
- **ReplicaStore** — the receiving side: the successor journals every
  replicated row into a per-source replica table, byte-identical to the
  source's journal rows (payload blobs are carried hex-encoded, so the
  stored bytes ARE the source's bytes). The replica is kept apart from
  the local cohort so scatter-gather never double-counts a live peer.
- **FederationPlane** — owns the peer health probe loop, the dead-peer
  **adopt** path (replay the replicated journal prefix into the local
  rollup store, so the survivor's pane covers the dead peer's cohort —
  agents failing over then redeliver their unacked tail and dedupe
  against the adopted prefix exactly as after a manager SIGKILL), and
  the scatter-gather fan-out that keeps ``/v1/fleet/*`` a single pane
  (per-peer timeout, ``peers`` health block in every envelope).

Ack-vs-durability across peers: the shipper only reads journal rows the
BatchWriter has committed, and the receiver acks after submitting to its
own writer — so a replicated ack means "in the survivor's write-behind
buffer", with the same bounded durability window a single manager's
agent acks have (docs/fleet.md).

Three differences from the reference, all by design. The receiver hands
every replicated row to its writer before the frame is acked: where the
writer's bounded queue is full it waits for a drain, as the port's
``FleetRollupStore.ingest`` does, instead of dropping the tail and acking
it all the same (ROADMAP C15, the twin of C12). The plane ships on a
connection only once the successor's ``/v1/fleet/peers`` says it is
federated: a manager that has not yet run ``attach_peers`` takes a
``peer:`` stream as an agent's, so rows shipped to it then would be acked
into its own cohort and never reach its replica (ROADMAP C10). The fan-out
and the peer probes use the port's ``http_client`` instead of
``urllib.request``: the same URL, ``scope=local`` query, ``Authorization``
header and per-peer timeout, with no proxy variable read, so a proxy set
on the host cannot route a fan-out to 127.0.0.1 elsewhere.

The module imports no ``torch``; ``grpc`` loads only when a shipper's
session tries v2.
"""

from __future__ import annotations

import threading
import time
import urllib.parse
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from gpud_tpu_torch import http_client
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.manager.peers import PeerDescriptor, PeerSet
from gpud_tpu_torch.manager.rollup import TABLE as JOURNAL_TABLE
from gpud_tpu_torch.session import wire

logger = get_logger(__name__)

# machine-id namespace for manager→manager replication sessions: the
# receiving ControlPlane routes these handles' records into the replica
# store instead of its own cohort rollup
PEER_MACHINE_PREFIX = "peer:"

# record kind carried by replication frames (shows up in the receiving
# handle's dedupe ledger, never in the cohort rollup)
REPLICA_KIND = "fleet_journal"

REPLICA_TABLE = "tpud_fleet_replica_v0_1"

DEFAULT_REPLICATION_INTERVAL = 1.0   # shipper tick cadence (seconds)
DEFAULT_PROBE_INTERVAL = 5.0         # peer health probe cadence
DEFAULT_FANOUT_TIMEOUT = 2.0         # per-peer scatter-gather budget
DEFAULT_DEAD_AFTER_PROBES = 3        # consecutive failures → unreachable
DEFAULT_SHIP_BATCH = 2000            # journal rows per replication frame
DEFAULT_REDELIVER_AFTER = 30.0       # ack-stall window before redelivery

# write-behind contract (tools/storage_lint.py): replica journaling must
# ride the shared BatchWriter, never commit per-row on the ingest path
HOT_WRITE_METHODS = ("replica_ingest",)

_REPLICA_SCHEMA = f"""
CREATE TABLE IF NOT EXISTS {REPLICA_TABLE} (
    source_peer    TEXT    NOT NULL,
    src_rowid      INTEGER NOT NULL,
    agent          TEXT    NOT NULL,
    seq            INTEGER NOT NULL,
    ts             REAL    NOT NULL,
    ingested       REAL    NOT NULL,
    kind           TEXT    NOT NULL,
    dedupe_key     TEXT    NOT NULL,
    correlation_id TEXT    NOT NULL DEFAULT '',
    payload        BLOB,
    shard          INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (source_peer, src_rowid)
)
"""

_REPLICA_INSERT = (
    f"INSERT OR IGNORE INTO {REPLICA_TABLE} "
    "(source_peer, src_rowid, agent, seq, ts, ingested, kind, dedupe_key, "
    "correlation_id, payload, shard) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)"
)

_SHIP_SELECT = (
    "SELECT rowid, agent, seq, ts, ingested, kind, dedupe_key, "
    f"correlation_id, payload, shard FROM {JOURNAL_TABLE} "
    "WHERE rowid > ? ORDER BY rowid LIMIT ?"
)


def journal_row_body(row: Tuple) -> dict:
    """The shipped body for one journal row: every column, with the
    payload blob hex-encoded so the bytes survive any frame encoding
    (JSON v1 frames and rev-3 wire frames alike) unchanged."""
    rowid, agent, seq, ts, ingested, kind, key, cid, payload, shard = row
    return {
        "agent": agent,
        "seq": seq,
        "ts": ts,
        "ingested": ingested,
        "kind": kind,
        "dedupe_key": key,
        "correlation_id": cid or "",
        "payload_hex": payload.hex() if payload is not None else None,
        "shard": shard,
    }


class ReplicaStore:
    """Per-source replica of a peer's journal (receiving side)."""

    GUARDED_BY = {
        "_accepted": "_mu",
        "_malformed": "_mu",
        "_watermarks": "_mu",
    }

    def __init__(self, db, writer=None) -> None:
        self.db = db
        self.writer = writer
        self._mu = threading.Lock()
        self._accepted = 0
        self._malformed = 0
        # in-memory high-water mark per source (includes rows still in
        # the write-behind buffer; durable reads go through rows())
        self._watermarks: Dict[str, int] = {}
        db.execute(_REPLICA_SCHEMA)
        db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_fleet_replica_agent "
            f"ON {REPLICA_TABLE} (source_peer, agent, ts, seq)"
        )

    def replica_ingest(self, source_peer: str, records) -> int:
        """Journal one decoded replication batch. ``records`` are the
        receiving handle's fresh decoded outbox tuples
        ``(rep_seq, ts, kind, key, body)`` where ``rep_seq`` is the
        source journal rowid and ``body`` is ``journal_row_body()``."""
        rows: List[tuple] = []
        bad = 0
        for rep_seq, _ts, kind, _key, body in records:
            if kind != REPLICA_KIND or not isinstance(body, dict):
                bad += 1
                continue
            payload_hex = body.get("payload_hex")
            try:
                payload = (
                    bytes.fromhex(payload_hex)
                    if payload_hex is not None else None
                )
                rows.append((
                    source_peer,
                    int(rep_seq),
                    str(body.get("agent", "")),
                    int(body.get("seq", 0)),
                    float(body.get("ts", 0.0)),
                    float(body.get("ingested", 0.0)),
                    str(body.get("kind", "")),
                    str(body.get("dedupe_key", "")),
                    str(body.get("correlation_id", "") or ""),
                    payload,
                    int(body.get("shard", 0)),
                ))
            except (TypeError, ValueError):
                bad += 1
        with self._mu:
            self._malformed += bad
            if rows:
                self._accepted += len(rows)
                top = rows[-1][1]
                if top > self._watermarks.get(source_peer, 0):
                    self._watermarks[source_peer] = top
        if not rows:
            return 0
        if self.writer is not None:
            # every row goes into the writer before the frame is acked:
            # hand over what its bounded queue has room for, and where it
            # has none, wait for a drain (the flush barrier drives one).
            # The reference lets the queue drop the tail and acks it
            # anyway, so the replica falls short of the journal it acked
            # (ROADMAP C15, the twin of C12)
            unwritten = rows
            while unwritten:
                room = self.writer.max_pending - self.writer.pending_ops()
                if room <= 0:
                    self.writer.flush()
                    continue
                taken = self.writer.submit_many(
                    "fleet-replica", _REPLICA_INSERT, unwritten[:room]
                )
                unwritten = unwritten[taken:]
        else:
            self.db.executemany(_REPLICA_INSERT, rows)
        return len(rows)

    def rows(self, source_peer: str) -> List[tuple]:
        """The durable replicated prefix for one source, in source
        journal order — the survivor-rebuild input, byte-identical to
        the dead peer's own journal rows."""
        return self.db.query(
            f"SELECT src_rowid, agent, seq, ts, ingested, kind, "
            f"dedupe_key, correlation_id, payload, shard "
            f"FROM {REPLICA_TABLE} WHERE source_peer = ? ORDER BY src_rowid",
            (source_peer,),
        )

    def count(self, source_peer: str) -> int:
        row = self.db.query_one(
            f"SELECT COUNT(*) FROM {REPLICA_TABLE} WHERE source_peer = ?",
            (source_peer,),
        )
        return int(row[0]) if row else 0

    def watermark(self, source_peer: str) -> int:
        with self._mu:
            return self._watermarks.get(source_peer, 0)

    def stats(self) -> Dict:
        with self._mu:
            return {
                "accepted": self._accepted,
                "malformed": self._malformed,
                "watermarks": dict(self._watermarks),
            }


class JournalShipper:
    """Replication sender: local journal rows → the successor peer.

    Mirrors ``SessionOutbox.replay_once`` (session/outbox.py): a
    monotonic acked watermark (``outboxAck`` frames from the peer, MAX
    semantics), a delivered cursor ahead of it, delta-encoded batches,
    encoder reset + delivered→acked fallback on reconnect or ack stall.
    """

    GUARDED_BY = {
        "_acked": "_mu",
        "_delivered": "_mu",
        "_encoder": "_mu",
        "_ack_progress_ts": "_mu",
        "_shipped": "_mu",
        "_frames": "_mu",
        "_redeliveries": "_mu",
        "_connections": "_mu",
    }

    def __init__(
        self,
        db,
        peer: PeerDescriptor,
        self_id: str,
        token: str = "",
        ship_batch: int = DEFAULT_SHIP_BATCH,
        redeliver_after: float = DEFAULT_REDELIVER_AFTER,
        time_fn: Callable[[], float] = time.monotonic,
    ) -> None:
        from gpud_tpu_torch.session.session import Session

        self.db = db
        self.peer = peer
        self.self_id = self_id
        self.ship_batch = max(1, int(ship_batch))
        self.redeliver_after = float(redeliver_after)
        self.time_fn = time_fn
        self._mu = threading.Lock()
        self._acked = 0
        self._delivered = 0
        self._encoder = wire.DeltaEncoder()
        self._ack_progress_ts = time_fn()
        self._shipped = 0
        self._frames = 0
        self._redeliveries = 0
        self._connections = 0
        self.session = Session(
            endpoint=peer.endpoint,
            machine_id=f"{PEER_MACHINE_PREFIX}{self_id}",
            token=token or "",
            dispatch_fn=self._dispatch,
            protocol="auto" if peer.grpc_target else "v1",
            v2_target=peer.grpc_target,
        )
        self.session.on_connected = self._on_connected

    # -- session plumbing --------------------------------------------------
    def _dispatch(self, req: dict) -> dict:
        method = (req or {}).get("method", "")
        if method == "outboxAck":
            try:
                self.on_ack(int(req.get("seq", 0)))
            except (TypeError, ValueError):
                return {"error": "bad ack seq"}
            return {"ok": True}
        # peers are not agents: any other manager request is answered,
        # not served (the replication stream is one-purpose)
        return {"error": f"peer stream does not serve {method!r}"}

    def _on_connected(self) -> None:
        # fresh connection = fresh delta stream on the receiving handle:
        # restart keyframe-anchored from the acked watermark, exactly
        # like SessionOutbox.reset_delivery on an agent reconnect
        with self._mu:
            self._encoder = wire.DeltaEncoder()
            self._delivered = self._acked
            self._ack_progress_ts = self.time_fn()
            self._connections += 1

    @property
    def connection(self) -> int:
        """How many times the session has connected: names the current
        connection, so a check made on one is not taken for the next."""
        with self._mu:
            return self._connections

    def on_ack(self, seq: int) -> None:
        """Cumulative ack from the peer; the watermark only advances."""
        with self._mu:
            if seq > self._acked:
                self._acked = seq
                self._ack_progress_ts = self.time_fn()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.session.start()

    def stop(self) -> None:
        self.session.stop()

    # -- replication tick --------------------------------------------------
    def tick(self) -> int:
        """Ship the next batch of journal rows above the delivered
        cursor; returns rows shipped this tick."""
        if not self.session.connected:
            return 0
        now = self.time_fn()
        with self._mu:
            if (
                self._delivered > self._acked
                and now - self._ack_progress_ts >= self.redeliver_after
            ):
                # ack stall: the in-flight tail may be lost (peer restart
                # without a stream close we saw) — rewind to the watermark
                # and re-encode keyframe-anchored
                self._encoder = wire.DeltaEncoder()
                self._delivered = self._acked
                self._redeliveries += 1
                self._ack_progress_ts = now
            cursor = self._delivered
        rows = self.db.query(_SHIP_SELECT, (cursor, self.ship_batch))
        if not rows:
            return 0
        with self._mu:
            records = [
                self._encoder.encode_record(
                    int(r[0]), float(r[3]), REPLICA_KIND,
                    f"j:{int(r[0])}", journal_row_body(r),
                )
                for r in rows
            ]
            first, last = int(rows[0][0]), int(rows[-1][0])
        from gpud_tpu_torch.session.session import Frame

        sent = self.session.send(Frame(
            req_id=f"outbox-batch-{first}-{last}",
            data=wire.build_batch(records),
        ))
        with self._mu:
            if sent:
                self._delivered = last
                self._shipped += len(rows)
                self._frames += 1
            else:
                # the frame never entered the wire buffer: rewind so the
                # next tick re-encodes from a keyframe
                self._encoder = wire.DeltaEncoder()
                self._delivered = min(self._delivered, self._acked)
        return len(rows) if sent else 0

    def journal_head(self) -> int:
        row = self.db.query_one(f"SELECT MAX(rowid) FROM {JOURNAL_TABLE}")
        return int(row[0]) if row and row[0] is not None else 0

    def stats(self) -> Dict:
        with self._mu:
            acked, delivered = self._acked, self._delivered
            shipped, frames = self._shipped, self._frames
            redeliveries = self._redeliveries
        head = self.journal_head()
        return {
            "peer": self.peer.peer_id,
            "connected": self.session.connected,
            "transport": self.session.active_protocol,
            "acked_rowid": acked,
            "delivered_rowid": delivered,
            "journal_head_rowid": head,
            "lag_rows": max(0, head - acked),
            "shipped_rows": shipped,
            "frames": frames,
            "redeliveries": redeliveries,
        }


# -- scatter-gather merge helpers (pure; unit-tested directly) -------------

def _sum_into(dst: Dict, src: Dict, keys: Tuple[str, ...]) -> None:
    for k in keys:
        if isinstance(src.get(k), (int, float)):
            dst[k] = dst.get(k, 0) + src[k]


def _merge_counter(dst: Dict, src: Optional[Dict]) -> Dict:
    for k, v in (src or {}).items():
        dst[k] = dst.get(k, 0) + v
    return dst


def merge_rollup(local: Dict, remotes: Dict[str, Dict]) -> Dict:
    """One pane over every cohort. Sums and counter-merges are exact;
    availability/MTTR/MTBF are series-weighted means across peers (each
    peer's own number is exact for its cohort — docs/fleet.md)."""
    merged = dict(local)
    by_kind = _merge_counter({}, local.get("records_by_kind"))
    outcomes = _merge_counter({}, local.get("remediation_outcomes"))
    flapping = list(local.get("flapping") or [])
    cohorts: Dict[str, Dict] = {}
    weighted = [(local.get("series", 0), local)]
    for pid, pane in sorted(remotes.items()):
        if not pane:
            continue
        cohorts[pid] = {
            "agents": pane.get("agents", 0),
            "series": pane.get("series", 0),
            "records_total": pane.get("records_total", 0),
            "generation": pane.get("generation", 0),
        }
        _sum_into(merged, pane, (
            "agents", "series", "records_total", "duplicates_suppressed",
            "transitions_total", "failures_total", "unhealthy_series",
        ))
        _merge_counter(by_kind, pane.get("records_by_kind"))
        _merge_counter(outcomes, pane.get("remediation_outcomes"))
        flapping.extend(pane.get("flapping") or [])
        merged["max_outbox_lag_seconds"] = max(
            merged.get("max_outbox_lag_seconds", 0.0),
            pane.get("max_outbox_lag_seconds", 0.0),
        )
        weighted.append((pane.get("series", 0), pane))
    total_w = sum(max(w, 0) for w, _ in weighted)
    if total_w > 0:
        for key in ("availability", "mttr_seconds", "mtbf_seconds"):
            merged[key] = sum(
                max(w, 0) * float(p.get(key, 0.0)) for w, p in weighted
            ) / total_w
    merged["records_by_kind"] = dict(sorted(by_kind.items()))
    merged["remediation_outcomes"] = dict(sorted(outcomes.items()))
    flapping.sort(key=lambda f: (
        -f.get("flap_count", 0), f.get("agent", ""), f.get("component", ""),
    ))
    merged["flapping"] = flapping[:32]
    merged["cohorts"] = cohorts
    return merged


def merge_fabric(local: Dict, remotes: Dict[str, Dict]) -> Dict:
    merged = dict(local)
    by_state = _merge_counter({}, local.get("links_by_state"))
    degraded = list(local.get("degraded") or [])
    for pid, pane in sorted(remotes.items()):
        if not pane:
            continue
        _sum_into(merged, pane, (
            "agents", "links_total", "degraded_count", "links_truncated",
        ))
        _merge_counter(by_state, pane.get("links_by_state"))
        degraded.extend(pane.get("degraded") or [])
    rank = {"down": 3, "degraded": 2, "healthy": 1, "unknown": 0}
    degraded.sort(key=lambda r: (
        -rank.get(r.get("state", ""), 0),
        -r.get("last_degraded_ts", 0.0),
        r.get("agent", ""),
        r.get("link", ""),
    ))
    merged["links_by_state"] = dict(sorted(by_state.items()))
    merged["degraded"] = degraded[:256]
    return merged


def merge_predict(local: Dict, remotes: Dict[str, Dict]) -> Dict:
    merged = dict(local)
    buckets = _merge_counter({}, local.get("risk_buckets"))
    top = list(local.get("top") or [])
    lead = dict(local.get("lead") or {})
    lead_total = lead.get("mean_seconds", 0.0) * lead.get("count", 0)
    for pid, pane in sorted(remotes.items()):
        if not pane:
            continue
        _sum_into(merged, pane, (
            "agents", "series", "armed", "warns_total",
            "unknown_schema_records", "predict_truncated",
        ))
        _merge_counter(buckets, pane.get("risk_buckets"))
        top.extend(pane.get("top") or [])
        pl = pane.get("lead") or {}
        if pl.get("count"):
            if not lead.get("count") or pl["min_seconds"] < lead.get(
                "min_seconds", 0.0
            ):
                lead["min_seconds"] = pl["min_seconds"]
            lead["max_seconds"] = max(
                lead.get("max_seconds", 0.0), pl.get("max_seconds", 0.0)
            )
            lead["count"] = lead.get("count", 0) + pl["count"]
            lead_total += pl.get("mean_seconds", 0.0) * pl["count"]
    if lead.get("count"):
        lead["mean_seconds"] = lead_total / lead["count"]
    top.sort(key=lambda r: (
        -r.get("risk", 0.0), r.get("agent", ""), r.get("component", ""),
    ))
    merged["risk_buckets"] = buckets
    merged["lead"] = lead
    merged["top"] = top[: int(local.get("top_k", 20) or 20)]
    return merged


def merge_agents(
    local: Dict, remotes: Dict[str, Dict], limit: int, self_id: str = ""
) -> Dict:
    """Union of per-peer pages, re-sorted by agent id and capped at
    ``limit``. Federated pagination is approximate: ``offset`` applies
    per peer, not to the merged view (docs/fleet.md)."""
    rows = []
    for row in local.get("agents") or []:
        row = dict(row)
        if self_id:
            row.setdefault("peer", self_id)
        rows.append(row)
    merged = dict(local)
    more = local.get("next_offset") is not None
    for pid, page in sorted(remotes.items()):
        if not page:
            continue
        for row in page.get("agents") or []:
            row = dict(row)
            row.setdefault("peer", pid)
            rows.append(row)
        merged["total"] = merged.get("total", 0) + page.get("total", 0)
        more = more or page.get("next_offset") is not None
    rows.sort(key=lambda r: r.get("agent", ""))
    if len(rows) > limit:
        rows = rows[:limit]
        more = True
    merged["agents"] = rows
    merged["next_offset"] = (
        merged.get("offset", 0) + len(rows) if more else None
    )
    return merged


def merge_traces(local: Dict, remotes: Dict[str, Dict], limit: int) -> Dict:
    merged = dict(local)
    records = list(local.get("records") or [])
    seen = {
        (r.get("agent"), r.get("seq"), r.get("dedupe_key"))
        for r in records
    }
    for pid, pane in sorted(remotes.items()):
        if not pane:
            continue
        for r in pane.get("records") or []:
            key = (r.get("agent"), r.get("seq"), r.get("dedupe_key"))
            if key in seen:
                continue
            seen.add(key)
            records.append(r)
    records.sort(key=lambda r: (r.get("ts", 0.0), r.get("seq", 0)))
    merged["records"] = records[:limit]
    merged["count"] = len(merged["records"])
    return merged


class FederationPlane:
    """One manager's view of the federated tier (module docstring)."""

    # counters share one lock; peers/replica/shipper guard themselves.
    # _adopt_mu serializes adopt() so a probe edge racing an explicit
    # adopt can't double-apply the prefix.
    GUARDED_BY = {
        "_scatter_ok": "_mu",
        "_scatter_err": "_mu",
        "_adopts": "_mu",
        "_last_fanout": "_mu",
        "_shipping_on": "_mu",
    }

    PATHS = {
        "rollup": "/v1/fleet/rollup",
        "fabric": "/v1/fleet/fabric",
        "predict": "/v1/fleet/predict",
        "agents": "/v1/fleet/agents",
        "traces": "/v1/fleet/traces",
        "peers": "/v1/fleet/peers",
    }

    def __init__(
        self,
        peers: PeerSet,
        rollup,
        db,
        writer=None,
        session_token: Optional[str] = None,
        admin_token: Optional[str] = None,
        replication_interval: float = DEFAULT_REPLICATION_INTERVAL,
        probe_interval: float = DEFAULT_PROBE_INTERVAL,
        fanout_timeout: float = DEFAULT_FANOUT_TIMEOUT,
        auto_adopt: bool = True,
        ship_batch: int = DEFAULT_SHIP_BATCH,
        redeliver_after: float = DEFAULT_REDELIVER_AFTER,
    ) -> None:
        from concurrent.futures import ThreadPoolExecutor

        self.peers = peers
        self.rollup = rollup
        self.db = db
        self.writer = writer
        self.admin_token = admin_token
        self.replication_interval = max(0.05, float(replication_interval))
        self.probe_interval = max(0.1, float(probe_interval))
        self.fanout_timeout = max(0.1, float(fanout_timeout))
        self.auto_adopt = bool(auto_adopt)
        self._mu = threading.Lock()
        self._adopt_mu = threading.Lock()
        self._scatter_ok = 0
        self._scatter_err = 0
        self._adopts = 0
        self._last_fanout: Dict[str, Dict] = {}
        # the shipper connection on which the successor was seen federated
        self._shipping_on: Optional[int] = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, min(8, len(peers.ring))),
            thread_name_prefix="tpud-mgr-fanout",
        )
        successor = peers.successor()
        self.shipper: Optional[JournalShipper] = None
        if successor is not None:
            self.shipper = JournalShipper(
                db, successor, peers.self_id,
                token=session_token or "",
                ship_batch=ship_batch,
                redeliver_after=redeliver_after,
            )
        self.replica = ReplicaStore(db, writer)

    # -- lifecycle ---------------------------------------------------------
    def start(self, scheduler) -> None:
        if self.shipper is not None:
            self.shipper.start()
            scheduler.add_job(
                "federation-replicate",
                self.replicate_once,
                interval=self.replication_interval,
                initial_delay=self.replication_interval,
            )
        scheduler.add_job(
            "federation-probe",
            self.probe_once,
            interval=self.probe_interval,
            initial_delay=self.probe_interval,
        )

    def stop(self) -> None:
        if self.shipper is not None:
            self.shipper.stop()
        self._pool.shutdown(wait=False, cancel_futures=True)

    # -- replication -------------------------------------------------------
    def replicate_once(self) -> int:
        if self.shipper is None or not self._successor_federated():
            return 0
        return self.shipper.tick()

    def _successor_federated(self) -> bool:
        """Whether the successor serves this connection as a peer's: its
        ``/v1/fleet/peers`` says ``federation: true``, read once per
        connection (ROADMAP C10). Until then nothing is shipped, so no row
        is acked into the cohort of a manager that has not attached its
        peers yet."""
        shipper = self.shipper
        if not shipper.session.connected:
            return False
        conn = shipper.connection
        with self._mu:
            if self._shipping_on == conn:
                return True
        try:
            view = self._fetch(shipper.peer, self.PATHS["peers"], {})
        except Exception:  # noqa: BLE001 — unreachable: ask again next tick
            return False
        if not isinstance(view, dict) or view.get("federation") is not True:
            return False
        with self._mu:
            self._shipping_on = conn
        return True

    def replica_sink(self, machine_id: str):
        """The ``on_records`` hook for a ``peer:`` transport handle."""
        source = machine_id[len(PEER_MACHINE_PREFIX):] or machine_id

        def sink(_mid: str, fresh) -> None:
            self.replica.replica_ingest(source, fresh)

        return sink

    # -- health + adopt ----------------------------------------------------
    def probe_once(self) -> None:
        now = time.time()
        for peer in self.peers.others():
            t0 = time.monotonic()
            err = ""
            ok = True
            try:
                self._fetch(
                    peer, self.PATHS["peers"], {"scope": "local"}
                )
            except Exception as e:  # noqa: BLE001 — any failure is "down"
                ok = False
                err = f"{type(e).__name__}: {e}"
            rtt = (time.monotonic() - t0) * 1000.0
            flipped = self.peers.mark_probe(
                peer.peer_id, ok, now, rtt_ms=rtt, error=err
            )
            if flipped:
                logger.warning(
                    "peer %s unreachable after %d probe(s): %s",
                    peer.peer_id, self.peers.dead_after_probes, err,
                )
            if (
                not ok
                and self.auto_adopt
                and not self.peers.is_reachable(peer.peer_id)
                and not self.peers.is_adopted(peer.peer_id)
            ):
                succ = self.peers.successor_of(peer.peer_id)
                if succ is not None and succ.peer_id == self.peers.self_id:
                    self.adopt(peer.peer_id)

    def adopt(self, peer_id: str) -> int:
        """Survivor rebuild: replay the dead peer's replicated journal
        prefix into the local rollup store. Idempotent — the rollup's
        per-agent dedupe + the journal's UNIQUE(agent, dedupe_key) make
        a second adopt (or an agent's post-failover redelivery of the
        same records) a no-op."""
        with self._adopt_mu:
            if self.peers.is_adopted(peer_id):
                return 0
            if self.writer is not None:
                self.writer.flush(timeout=10.0)
            rows = self.replica.rows(peer_id)
            groups: "OrderedDict[str, List[tuple]]" = OrderedDict()
            for (_rid, agent, seq, ts, _ing, kind, key, _cid,
                 payload, _shard) in rows:
                body = (
                    wire.unpack_obj(payload) if payload is not None else {}
                )
                groups.setdefault(agent, []).append(
                    (seq, ts, kind, key, body)
                )
            applied = 0
            for agent, recs in groups.items():
                applied += self.rollup.ingest(agent, recs)
            self.peers.mark_adopted(peer_id)
            with self._mu:
                self._adopts += 1
            logger.warning(
                "adopted cohort of dead peer %s: %d replicated row(s), "
                "%d applied fresh", peer_id, len(rows), applied,
            )
            return applied

    # -- scatter-gather ----------------------------------------------------
    def _fetch(self, peer: PeerDescriptor, path: str, params: Dict) -> Dict:
        qs = urllib.parse.urlencode({**params, "scope": "local"})
        headers = {}
        if self.admin_token:
            headers["Authorization"] = f"Bearer {self.admin_token}"
        # the port's client reads no proxy variable (module docstring)
        return http_client.get_json(
            f"{peer.endpoint}{path}?{qs}", headers, self.fanout_timeout
        )

    def scatter(self, path: str, params: Dict) -> Dict[str, Dict]:
        """Fan one request out to every live remote peer with the
        per-peer timeout; returns ``{peer_id: {"data"|"error", ...}}``."""
        targets = self.peers.live_others()
        futures = {
            p.peer_id: self._pool.submit(self._fetch, p, path, params)
            for p in targets
        }
        out: Dict[str, Dict] = {}
        for pid, fut in futures.items():
            t0 = time.monotonic()
            try:
                data = fut.result(timeout=self.fanout_timeout + 0.5)
                out[pid] = {
                    "data": data,
                    "elapsed_ms": round((time.monotonic() - t0) * 1000, 2),
                }
                with self._mu:
                    self._scatter_ok += 1
            except Exception as e:  # noqa: BLE001 — a slow peer is a result
                out[pid] = {
                    "error": f"{type(e).__name__}: {e}",
                    "elapsed_ms": round((time.monotonic() - t0) * 1000, 2),
                }
                with self._mu:
                    self._scatter_err += 1
        with self._mu:
            self._last_fanout = {
                pid: {k: v for k, v in r.items() if k != "data"}
                for pid, r in out.items()
            }
        return out

    def federate(self, kind: str, local: Dict, params: Dict) -> Dict:
        """Merge the local pane with every live peer's ``scope=local``
        answer and stamp the ``peers`` health block on the envelope."""
        results = self.scatter(self.PATHS[kind], params)
        remotes = {
            pid: r.get("data") for pid, r in results.items() if "data" in r
        }
        if kind == "rollup":
            merged = merge_rollup(local, remotes)
        elif kind == "fabric":
            merged = merge_fabric(local, remotes)
        elif kind == "predict":
            merged = merge_predict(local, remotes)
        elif kind == "agents":
            merged = merge_agents(
                local, remotes, int(params.get("limit", 50) or 50),
                self_id=self.peers.self_id,
            )
        elif kind == "traces":
            merged = merge_traces(
                local, remotes, int(params.get("limit", 200) or 200)
            )
        else:
            merged = dict(local)
        merged["federated"] = True
        merged["peers"] = self.peers_block()
        merged["fanout"] = {
            pid: {k: v for k, v in r.items() if k != "data"}
            for pid, r in results.items()
        }
        return merged

    def federate_history(self, agent_id: str, local: Dict, params: Dict) -> Dict:
        """History is single-owner data: serve locally when the journal
        has the agent, otherwise ask the rendezvous owner (then any live
        peer) for its ``scope=local`` answer."""
        if local.get("total", 0) > 0:
            local = dict(local)
            local["peer"] = self.peers.self_id
            local["peers"] = self.peers_block()
            return local
        owner = self.peers.owner_of(agent_id)
        ranked = [owner] + [
            p for p in self.peers.live_others()
            if p.peer_id != owner.peer_id
        ]
        for peer in ranked:
            if peer.peer_id == self.peers.self_id:
                continue
            if not self.peers.is_reachable(peer.peer_id):
                continue
            try:
                data = self._fetch(
                    peer,
                    f"/v1/fleet/agents/{urllib.parse.quote(agent_id)}/history",
                    params,
                )
            except Exception:  # noqa: BLE001 — fall through to next peer
                continue
            if data.get("total", 0) > 0:
                data["peer"] = peer.peer_id
                data["peers"] = self.peers_block()
                return data
        local = dict(local)
        local["peer"] = self.peers.self_id
        local["peers"] = self.peers_block()
        return local

    # -- views -------------------------------------------------------------
    def peers_block(self) -> List[dict]:
        return self.peers.health_block(time.time())

    def peers_view(self) -> Dict:
        """``GET /v1/fleet/peers``: the peer map itself."""
        succ = self.peers.successor()
        pred = self.peers.predecessor()
        with self._mu:
            scatter = {
                "ok": self._scatter_ok,
                "errors": self._scatter_err,
                "adopts": self._adopts,
                "last_fanout": dict(self._last_fanout),
            }
        return {
            "federation": True,
            "instance_id": self.peers.self_id,
            "ring": list(self.peers.ring),
            "successor": succ.peer_id if succ else None,
            "predecessor": pred.peer_id if pred else None,
            "peers": self.peers_block(),
            "rendezvous": self.peers.cohort_counts(self.rollup.agent_ids()),
            "replication": (
                self.shipper.stats() if self.shipper is not None else None
            ),
            "replica": self.replica.stats(),
            "scatter": scatter,
        }

    def stats(self) -> Dict:
        """Flat numbers for the exposition layer (exposition.py)."""
        with self._mu:
            scatter_ok, scatter_err = self._scatter_ok, self._scatter_err
            adopts = self._adopts
        live = {p.peer_id for p in self.peers.live_others()}
        out = {
            "peers_total": len(self.peers.ring),
            "peers_live": len(live) + 1,  # self is always live
            "scatter_ok": scatter_ok,
            "scatter_errors": scatter_err,
            "adopts": adopts,
            "replica_accepted": self.replica.stats()["accepted"],
        }
        if self.shipper is not None:
            s = self.shipper.stats()
            out["replication_lag_rows"] = s["lag_rows"]
            out["replication_connected"] = 1 if s["connected"] else 0
        return out
