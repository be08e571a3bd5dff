"""Fleet rollup store: the manager-side aggregation layer; the port of
``gpud_tpu/manager/rollup.py``, the same journal, rollups and panes.

Every observability surface below this file is per-node (ledger,
remediation audit, trace ring, outbox). The manager ingests all of it
but — before this store — only kept a bounded in-memory record buffer
per agent, so it could not answer a single fleet-level question
("which nodes flapped this week", "fleet availability", "MTTR across
the pod"). PAPERS.md ("Host-Side Telemetry", "When GPUs Fail Quietly")
argues diagnosis lives at the aggregation layer: the signals that
matter are cross-node patterns invisible to any one agent.

Design:

- **Durable journal, derived rollups.** Every ingested outbox record
  lands in one append-only journal table via the ``BatchWriter``
  (``gpud_tpu_torch/storage/writer.py``)
  (group commit; ``INSERT OR IGNORE`` on ``UNIQUE(agent, dedupe_key)``
  makes replay after reconnect idempotent at the storage layer). The
  per-agent/per-component rollups (availability, MTTR/MTBF, flap
  counts, transition cadence, remediation outcomes, outbox lag) are
  *derived* state: incrementally updated in memory on ingest and
  rebuilt from the journal at construction — a SIGKILL can lose at
  most the writer's durability window and can never tear an aggregate,
  because aggregates are never persisted, only recomputed.
- **Lock-striped shards.** In-memory state is partitioned into
  ``shard_count`` stripes keyed by a stable crc32 slot hash of the
  agent id (``gpud_tpu_torch/manager/shard.py``). Each shard has its own
  lock, per-agent dedupe LRUs, and aggregates, so ingest for agent A
  never contends with ingest for agent B on another shard, and the
  fleet rollup walk takes one shard lock at a time instead of freezing
  the whole plane. The journal persists the *slot* (``shard`` column),
  not the shard index, so a restart with a different shard count still
  partitions the journal correctly and ``_rebuild()`` replays shards
  in parallel — per-agent ordering (the only ordering ingest relies
  on) is preserved because an agent lives in exactly one slot.
- **Read-your-own-writes.** Every read path runs the writer's
  ``flush()`` barrier before touching SQLite, so batching is invisible
  to operators.
- **TTL + generation cache.** Rollup/pagination responses are cached
  per query-shape. An entry is served only while its TTL holds AND no
  ingest has advanced the store generation — writes invalidate
  immediately (read-after-write), the TTL bounds entry lifetime when
  the fleet is quiet.
- **Correlation stitching.** Records whose payload carries a
  ``correlation_id`` (minted by the agent's check wrapper and stamped
  on its trace span) are indexed by it, so one id resolves to every
  fleet event the originating check produced.
"""

from __future__ import annotations

import math
import os
import threading
import time
from collections import Counter as _Counter
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Dict, Iterable, List, Optional, Tuple

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.manager.shard import (
    DEFAULT_SHARD_COUNT,
    SHARD_SLOTS,
    RollupShard,
    shard_slots,
    slot_of,
)
from gpud_tpu_torch.metrics.registry import counter, gauge, histogram
from gpud_tpu_torch.session import wire

logger = get_logger(__name__)

TABLE = "tpud_fleet_journal_v0_1"

# storage_lint contract: these methods route their hot-path persistence
# through the BatchWriter (sync DB fallback only under a writer guard)
HOT_WRITE_METHODS = ("ingest",)

DEFAULT_CACHE_TTL = 2.0          # seconds a cached read stays servable
DEFAULT_DEDUPE_KEYS = 8192       # per-agent in-memory replay suppression
DEFAULT_RECENT_TRANSITIONS = 64  # per-series window for flap/cadence
DEFAULT_FLAP_WINDOW = 3600.0     # seconds a transition counts as a flap
DEFAULT_MAX_JOURNAL_ROWS = 500_000

_INSERT_SQL = (
    f"INSERT OR IGNORE INTO {TABLE} "
    "(agent, seq, ts, ingested, kind, dedupe_key, correlation_id, payload, "
    "shard) VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)"
)

_c_records = counter(
    "tpud_fleet_ingest_records_total",
    "outbox records accepted into the fleet journal, by kind",
)
_c_duplicates = counter(
    "tpud_fleet_ingest_duplicates_total",
    "replayed outbox records suppressed by fleet ingest dedupe",
)
_g_ingest_lag = gauge(
    "tpud_fleet_ingest_lag_seconds",
    "age of the most recently ingested outbox record "
    "(manager wall clock minus record timestamp)",
)
_h_refresh = histogram(
    "tpud_fleet_rollup_refresh_seconds",
    "wall time to materialize one fleet rollup response (cache miss path)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0, 2.5),
)
_c_cache_hits = counter(
    "tpud_fleet_cache_hits_total",
    "fleet operator-API reads served from the TTL cache",
)
_c_cache_misses = counter(
    "tpud_fleet_cache_misses_total",
    "fleet operator-API reads that had to materialize (barrier + compute)",
)
_g_agents = gauge(
    "tpud_fleet_agents",
    "agents with at least one journaled record in the fleet rollup store",
)
_g_series = gauge(
    "tpud_fleet_agent_series",
    "distinct (agent, component) rollup series held in memory",
)
_g_predict_series = gauge(
    "tpud_fleet_predict_series",
    "distinct (agent, component) predictive rollup series held in memory",
)
_g_predict_unknown = gauge(
    "tpud_fleet_predict_unknown_schema_records",
    "journaled predict_score records whose payload schema is newer than "
    "this manager understands (counted per record, never dropped)",
)


class _SeriesRollup:
    """Incremental per-(agent, component) health rollup."""

    __slots__ = (
        "state", "since", "first_ts", "last_ts", "transitions",
        "healthy_seconds", "unhealthy_seconds",
        "repair_total", "repair_count",
        "tbf_total", "tbf_count", "last_failure_ts", "failures",
        "recent",
    )

    def __init__(self) -> None:
        self.state = ""
        self.since = 0.0
        self.first_ts = 0.0
        self.last_ts = 0.0
        self.transitions = 0
        self.healthy_seconds = 0.0
        self.unhealthy_seconds = 0.0
        self.repair_total = 0.0     # completed unhealthy-episode downtime
        self.repair_count = 0
        self.tbf_total = 0.0        # gaps between consecutive failures
        self.tbf_count = 0
        self.last_failure_ts = 0.0
        self.failures = 0
        self.recent: deque = deque(maxlen=DEFAULT_RECENT_TRANSITIONS)

    def apply(self, from_state: str, to_state: str, ts: float) -> None:
        if not self.first_ts:
            self.first_ts = ts
        # close the open interval in the previous state
        if self.state and ts > self.since:
            dt = ts - self.since
            if self.state == "Healthy":
                self.healthy_seconds += dt
            else:
                self.unhealthy_seconds += dt
        prev = self.state or from_state
        self.transitions += 1
        self.recent.append(ts)
        if to_state != "Healthy" and (not prev or prev == "Healthy"):
            self.failures += 1
            if self.last_failure_ts:
                self.tbf_total += ts - self.last_failure_ts
                self.tbf_count += 1
            self.last_failure_ts = ts
        if to_state == "Healthy" and prev and prev != "Healthy" and self.since:
            self.repair_total += max(0.0, ts - self.since)
            self.repair_count += 1
        self.state = to_state
        self.since = ts
        if ts > self.last_ts:
            self.last_ts = ts

    def snapshot(self, as_of: float) -> Dict:
        healthy = self.healthy_seconds
        unhealthy = self.unhealthy_seconds
        # count the open interval up to the newest timestamp we trust
        if self.state and as_of > self.since:
            if self.state == "Healthy":
                healthy += as_of - self.since
            else:
                unhealthy += as_of - self.since
        total = healthy + unhealthy
        flap_cutoff = as_of - DEFAULT_FLAP_WINDOW
        flaps = sum(1 for t in self.recent if t >= flap_cutoff)
        cadence = 0.0
        if len(self.recent) >= 2:
            span = self.recent[-1] - self.recent[0]
            if span > 0:
                cadence = span / (len(self.recent) - 1)
        return {
            "state": self.state,
            "since": self.since,
            "transitions": self.transitions,
            "availability": (healthy / total) if total > 0 else 1.0,
            "healthy_seconds": healthy,
            "unhealthy_seconds": unhealthy,
            "mttr_seconds": (
                self.repair_total / self.repair_count if self.repair_count else 0.0
            ),
            "mtbf_seconds": (
                self.tbf_total / self.tbf_count if self.tbf_count else 0.0
            ),
            "failures": self.failures,
            "flap_count": flaps,
            "transition_cadence_seconds": cadence,
        }


# worst-state ordering for fabric link aggregates (fabric plane states)
_LINK_STATE_RANK = {"up": 0, "": 0, "degraded": 1, "down": 2}

# per-agent cap on distinct link aggregates — a garbled agent shipping
# unbounded link names degrades to truncation accounting, not OOM
MAX_LINKS_PER_AGENT = 1024

# per-link bound on retained degraded-record timestamps: the windowed
# 1h/24h/7d counters saturate here instead of growing with history
MAX_LINK_WINDOW_SAMPLES = 512

# windowed degradation buckets served by /v1/fleet/fabric
LINK_WINDOWS = (("1h", 3600.0), ("24h", 86400.0), ("7d", 604800.0))


class _LinkRollup:
    """Per-(agent, fabric link) aggregate over shipped fabric sweep records.

    A link record of the port's agent is one NVLink port
    (``MeshLink.to_dict()`` in ``gpud_tpu_torch/fabric/mesh.py``): ``link``
    ``gpu{g}/nvlink{k}``, ``src_chip`` the GPU, ``dst_chip`` -1 (the
    switch side) and ``axis`` ``"nvlink"``, taken as the reference takes a
    torus link. ``apply`` keeps the reference's ``int(... or -1)``, which
    reports GPU 0 (and TPU chip 0) as -1 (ROADMAP C13)."""

    __slots__ = (
        "src_chip", "dst_chip", "axis", "last_state", "worst_state",
        "records", "deviations", "downs", "last_ts", "last_degraded_ts",
        "max_deviation", "degraded_recent",
    )

    def __init__(self) -> None:
        self.src_chip = -1
        self.dst_chip = -1
        self.axis = ""
        self.last_state = ""
        self.worst_state = ""
        self.records = 0
        self.deviations = 0       # records that arrived flagged degraded
        self.downs = 0            # records that arrived hard-down
        self.last_ts = 0.0
        self.last_degraded_ts = 0.0  # newest not-up record ts
        self.max_deviation = 0.0
        # bounded not-up record timestamps behind the windowed counters
        self.degraded_recent: deque = deque(maxlen=MAX_LINK_WINDOW_SAMPLES)

    def apply(self, body: Dict, ts: float) -> None:
        state = str(body.get("state", "") or "")
        self.src_chip = int(body.get("src_chip", self.src_chip) or -1)
        self.dst_chip = int(body.get("dst_chip", self.dst_chip) or -1)
        self.axis = str(body.get("axis", self.axis) or "")
        when = float(body.get("ts", ts) or ts)
        self.records += 1
        self.last_state = state
        if _LINK_STATE_RANK.get(state, 0) > _LINK_STATE_RANK.get(
            self.worst_state, 0
        ):
            self.worst_state = state
        if state == "degraded":
            self.deviations += 1
        elif state == "down":
            self.downs += 1
        if state in ("degraded", "down"):
            self.degraded_recent.append(when)
            if when > self.last_degraded_ts:
                self.last_degraded_ts = when
        if when > self.last_ts:
            self.last_ts = when
        try:
            dev = float(body.get("deviation", 0.0) or 0.0)
        except (TypeError, ValueError):
            dev = 0.0
        if dev > self.max_deviation:
            self.max_deviation = dev

    def snapshot(self, as_of: Optional[float] = None) -> Dict:
        """``as_of`` anchors the windowed counters; ``None`` falls back
        to the link's own newest record time, which makes the snapshot a
        pure function of the journal (rebuild-parity tests lean on it —
        wall-clock anchoring is the *caller's* choice)."""
        anchor = self.last_ts if as_of is None else as_of
        windows = {
            label: sum(
                1 for t in self.degraded_recent if t > anchor - span
            )
            for label, span in LINK_WINDOWS
        }
        return {
            "src_chip": self.src_chip,
            "dst_chip": self.dst_chip,
            "axis": self.axis,
            "state": self.last_state,
            "worst_state": self.worst_state,
            "records": self.records,
            "deviations": self.deviations,
            "downs": self.downs,
            "last_ts": self.last_ts,
            "last_degraded_ts": self.last_degraded_ts,
            "max_deviation": self.max_deviation,
            "degraded_windows": windows,
        }


# newest predict_score payload schema this manager understands: records
# with a higher schema are journaled + counted, never applied (a newer
# agent in a mixed fleet degrades to accounting, not silent data loss)
PREDICT_SCHEMA_MAX = 1

# per-agent cap on distinct predictive series (same OOM guard as links)
MAX_PREDICT_PER_AGENT = 512

# per-series bound on retained lead-time measurements (p50 source)
MAX_PREDICT_LEADS = 64

# default e-folding time for stale-score down-ranking in the fleet pane:
# an armed component republishes every publish-interval (60s default),
# so a score 15 minutes old is either a dead agent or a cleared story —
# rank it down smoothly rather than serving it as fresh
DEFAULT_PREDICT_DECAY = 900.0


class _PredictRollup:
    """Per-(agent, component) predictive aggregate over journaled
    ``predict_score`` outbox records (warn/clear/lead/snapshot).

    Pure function of the agent's record sequence — no wall-clock reads —
    so a journal replay rebuilds it byte-identically for any shard
    count. Staleness decay is applied at *read* time in
    :meth:`FleetRollupStore._compute_fleet_predict`."""

    __slots__ = (
        "component_class", "schema", "score", "armed", "warned_at",
        "threshold", "last_event", "last_ts", "features",
        "warn_count", "clear_count", "snapshot_count",
        "lead_count", "lead_total", "lead_min", "lead_max", "leads",
    )

    def __init__(self) -> None:
        self.component_class = ""
        self.schema = 0
        self.score = 0.0
        self.armed = False
        self.warned_at: Optional[float] = None
        self.threshold = 0.0
        self.last_event = ""
        self.last_ts = 0.0
        self.features: Dict[str, float] = {}
        self.warn_count = 0
        self.clear_count = 0
        self.snapshot_count = 0
        self.lead_count = 0
        self.lead_total = 0.0
        self.lead_min = 0.0
        self.lead_max = 0.0
        self.leads: deque = deque(maxlen=MAX_PREDICT_LEADS)

    def apply(self, body: Dict, ts: float) -> None:
        event = str(body.get("event", "") or "")
        when = float(body.get("ts", ts) or ts)
        try:
            score = float(body.get("score", 0.0) or 0.0)
        except (TypeError, ValueError):
            score = 0.0
        score = 0.0 if score < 0.0 else (1.0 if score > 1.0 else score)
        if when >= self.last_ts:
            # latest-wins fields follow record time: per-agent replay
            # order is (ts, seq), so this is deterministic on rebuild
            self.last_ts = when
            self.last_event = event
            self.score = score
            self.armed = bool(body.get("armed"))
            self.schema = int(body.get("schema", 0) or 0)
            self.component_class = str(
                body.get("component_class", self.component_class) or ""
            )
            wa = body.get("warned_at")
            self.warned_at = float(wa) if wa is not None else None
            try:
                self.threshold = float(body.get("threshold", 0.0) or 0.0)
            except (TypeError, ValueError):
                self.threshold = 0.0
            feats = body.get("features")
            if isinstance(feats, dict):
                clean: Dict[str, float] = {}
                for k, v in feats.items():
                    try:
                        clean[str(k)] = float(v)
                    except (TypeError, ValueError):
                        continue
                self.features = clean
        if event == "warn":
            self.warn_count += 1
        elif event == "clear":
            self.clear_count += 1
        elif event == "snapshot":
            self.snapshot_count += 1
        elif event == "lead":
            lead = body.get("lead_seconds")
            try:
                lead = None if lead is None else float(lead)
            except (TypeError, ValueError):
                lead = None
            if lead is not None and lead >= 0.0:
                self.lead_count += 1
                self.lead_total += lead
                if self.lead_count == 1 or lead < self.lead_min:
                    self.lead_min = lead
                if lead > self.lead_max:
                    self.lead_max = lead
                self.leads.append(lead)

    def risk(self, now: float, decay_tau: float) -> float:
        """Predicted-failure likelihood at ``now``: the noisy-OR of the
        last fused score, an armed bonus, and repeat-warning evidence,
        all down-ranked by exponential staleness decay. Bounded [0, 1],
        monotone in freshness — a node that stopped reporting sinks."""
        age = max(0.0, now - self.last_ts)
        decay = math.exp(-age / decay_tau) if decay_tau > 0 else 1.0
        armed_term = 0.25 if self.armed else 0.0
        warn_term = 0.15 * min(self.warn_count, 4) / 4.0
        base = 1.0 - (1.0 - self.score) * (1.0 - armed_term) * (
            1.0 - warn_term
        )
        r = base * decay
        return 0.0 if r < 0.0 else (1.0 if r > 1.0 else r)

    def snapshot(self, now: float, decay_tau: float) -> Dict:
        leads = sorted(self.leads)
        return {
            "component_class": self.component_class,
            "schema": self.schema,
            "score": self.score,
            "risk": self.risk(now, decay_tau),
            "age_seconds": max(0.0, now - self.last_ts),
            "armed": self.armed,
            "warned_at": self.warned_at,
            "threshold": self.threshold,
            "last_event": self.last_event,
            "last_ts": self.last_ts,
            "features": dict(self.features),
            "warn_count": self.warn_count,
            "clear_count": self.clear_count,
            "snapshot_count": self.snapshot_count,
            "lead": {
                "count": self.lead_count,
                "mean_seconds": (
                    self.lead_total / self.lead_count
                    if self.lead_count else 0.0
                ),
                "min_seconds": self.lead_min,
                "max_seconds": self.lead_max,
                "p50_seconds": (
                    leads[(len(leads) - 1) // 2] if leads else 0.0
                ),
            },
        }


class _AgentRollup:
    """Per-agent aggregate over everything that agent's outbox shipped."""

    __slots__ = (
        "records_by_kind", "last_seq", "last_ts", "last_ingest",
        "outbox_lag_seconds", "remediation_outcomes", "series",
        "links", "links_truncated",
        "predict", "predict_truncated", "predict_unknown_schema",
    )

    def __init__(self) -> None:
        self.records_by_kind: _Counter = _Counter()
        self.last_seq = 0
        self.last_ts = 0.0
        self.last_ingest = 0.0
        self.outbox_lag_seconds = 0.0
        self.remediation_outcomes: _Counter = _Counter()
        self.series: Dict[str, _SeriesRollup] = {}
        self.links: Dict[str, _LinkRollup] = {}
        self.links_truncated = 0
        self.predict: Dict[str, _PredictRollup] = {}
        self.predict_truncated = 0
        self.predict_unknown_schema = 0


class FleetRollupStore:
    """Manager-side fleet journal + materialized rollups (module docstring).

    Thread-safe: ``ingest`` may be called from any shard-executor worker
    (or reader thread when no executor is wired); reads run on the
    operator pool. In-memory state is striped across ``shard_count``
    locks keyed by a stable hash of the agent id; cache/generation
    bookkeeping sits under a separate meta lock; SQLite work happens
    outside all of them.
    """

    # _shards is a fixed list built in __init__ and only indexed after —
    # the per-shard state behind it is guarded by each shard's own lock
    # (RollupShard.GUARDED_BY), taken via `with shard.lock`
    GUARDED_BY = {
        "_generation": "_meta",
        "_cache": "_meta",
        "_cache_hits": "_meta",
        "_cache_misses": "_meta",
    }

    def __init__(
        self,
        db,
        writer=None,
        cache_ttl_seconds: float = DEFAULT_CACHE_TTL,
        dedupe_keys_max: int = DEFAULT_DEDUPE_KEYS,
        max_journal_rows: int = DEFAULT_MAX_JOURNAL_ROWS,
        shard_count: int = DEFAULT_SHARD_COUNT,
        rebuild_parallel: bool = True,
        predict_decay_seconds: float = DEFAULT_PREDICT_DECAY,
    ) -> None:
        self.db = db
        self.writer = writer
        self.cache_ttl = float(cache_ttl_seconds)
        self.dedupe_keys_max = int(dedupe_keys_max)
        self.max_journal_rows = int(max_journal_rows)
        self.predict_decay = float(predict_decay_seconds)
        self.shard_count = max(1, min(int(shard_count), SHARD_SLOTS))
        self.rebuild_parallel = bool(rebuild_parallel)
        self._shards: List[RollupShard] = [
            RollupShard(i) for i in range(self.shard_count)
        ]
        # meta lock: generation + response cache + cache counters only —
        # never held while a shard lock is held
        self._meta = threading.Lock()
        self._generation = 0
        # cache key -> (generation, monotonic deadline, value)
        self._cache: Dict[tuple, tuple] = {}
        self._cache_hits = 0
        self._cache_misses = 0
        self.last_rebuild_seconds = 0.0
        self._ensure_schema()
        self._rebuild()

    def _shard_for(self, agent_id: str) -> RollupShard:
        return self._shards[slot_of(agent_id) % self.shard_count]

    def shards(self) -> List[RollupShard]:
        return self._shards

    # -- schema / rebuild --------------------------------------------------
    def _ensure_schema(self) -> None:
        self.db.execute(
            f"""CREATE TABLE IF NOT EXISTS {TABLE} (
                agent          TEXT NOT NULL,
                seq            INTEGER NOT NULL,
                ts             REAL NOT NULL,
                ingested       REAL NOT NULL,
                kind           TEXT NOT NULL,
                dedupe_key     TEXT NOT NULL,
                correlation_id TEXT NOT NULL DEFAULT '',
                payload        BLOB,
                shard          INTEGER NOT NULL DEFAULT -1,
                UNIQUE (agent, dedupe_key)
            )"""
        )
        cols = {r[1] for r in self.db.query(f"PRAGMA table_info({TABLE})")}
        if "shard" not in cols:
            # pre-sharding journal: widen, then backfill below
            self.db.execute(
                f"ALTER TABLE {TABLE} "
                f"ADD COLUMN shard INTEGER NOT NULL DEFAULT -1"
            )
        # backfill the derived slot for legacy rows (one-time migration;
        # slot_of is a pure function of the agent id, so this is safe to
        # re-run and converges immediately)
        stale = self.db.query(
            f"SELECT DISTINCT agent FROM {TABLE} WHERE shard < 0"
        )
        if stale:
            self.db.executemany(
                f"UPDATE {TABLE} SET shard = ? WHERE agent = ? AND shard < 0",
                [(slot_of(agent), agent) for (agent,) in stale],
            )
        self.db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_fleet_agent_ts "
            f"ON {TABLE} (agent, ts)"
        )
        self.db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_fleet_correlation "
            f"ON {TABLE} (correlation_id) WHERE correlation_id != ''"
        )
        # covering order for per-shard replay: each rebuild worker walks
        # its slots in index order, no sort step
        self.db.execute(
            f"CREATE INDEX IF NOT EXISTS idx_fleet_shard "
            f"ON {TABLE} (shard, agent, ts, seq)"
        )

    def _rebuild(self) -> None:
        """Recompute every rollup from the journal (boot / crash recovery).

        The journal is the only durable state; aggregates are a pure
        function of it, so a SIGKILL between group commits can shorten
        the journal but never tear a rollup. Each shard replays only
        its own slots (the persisted ``shard`` column), so replay runs
        one worker per shard — per-agent ordering holds because an
        agent's rows all live in one slot.

        The fetch pool is capped at the host's usable core count: on a
        single-core host extra fetch threads only convoy on the GIL, so
        replay degrades to the plain serial loop there rather than
        paying thread overhead for no concurrency."""
        t0 = time.monotonic()
        try:
            cores = max(1, len(os.sched_getaffinity(0)))
        except AttributeError:
            cores = max(1, os.cpu_count() or 1)
        workers = min(self.shard_count, cores)
        if self.rebuild_parallel and workers > 1:
            # fetch/apply pipeline: one FETCH worker per shard (SQLite
            # index walk + msgpack unpack — the C-heavy part, which runs
            # with the GIL dropped during VDBE steps), while the calling
            # thread APPLIES each shard the moment its rows land. Running
            # the Python apply loops on N threads instead would convoy on
            # the GIL and come out *slower* than serial.
            counts = []
            with ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix="tpud-fleet-rebuild",
            ) as ex:
                futs = {
                    ex.submit(self._fetch_shard_rows, s): s
                    for s in self._shards
                }
                for fut in as_completed(futs):
                    counts.append(
                        self._apply_shard_rows(futs[fut], fut.result())
                    )
        else:
            counts = [
                self._apply_shard_rows(s, self._fetch_shard_rows(s))
                for s in self._shards
            ]
        with self._meta:
            self._generation += 1
            self._cache.clear()
        self._update_gauges()
        self.last_rebuild_seconds = time.monotonic() - t0
        total = sum(counts)
        if total:
            logger.info(
                "fleet rollup store rebuilt from journal: %d records, "
                "%d agents, %d shards, %.3fs (%s)",
                total, sum(len(s.agents) for s in self._shards),
                self.shard_count, self.last_rebuild_seconds,
                "parallel" if self.rebuild_parallel and workers > 1
                else "serial",
            )

    def _fetch_shard_rows(self, shard: RollupShard) -> list:
        """Pull + decode one shard's journal slice (no shard state touched,
        safe on any thread). Returns ``(agent, seq, ts, ingested, kind,
        key, body)`` rows in replay order."""
        slots = shard_slots(shard.index, self.shard_count)
        placeholders = ",".join("?" * len(slots))
        # ORDER BY walks idx_fleet_shard — per-slot, per-agent (ts, seq)
        # order with no sort pass; cross-agent order is irrelevant
        rows = self.db.query(
            f"SELECT agent, seq, ts, ingested, kind, dedupe_key, payload "
            f"FROM {TABLE} WHERE shard IN ({placeholders}) "
            f"ORDER BY shard, agent, ts, seq",
            tuple(slots),
        )
        unpack = wire.unpack_obj
        return [
            (agent, seq, ts, ingested, kind, key,
             unpack(payload) if payload is not None else {})
            for agent, seq, ts, ingested, kind, key, payload in rows
        ]

    def _apply_shard_rows(self, shard: RollupShard, rows: list) -> int:
        apply_one = self._apply_shard_locked
        keys_max = self.dedupe_keys_max
        with shard.lock:
            shard.agents.clear()
            shard.dedupe.clear()
            shard.records_total = 0
            shard.duplicates_total = 0
            shard.series_total = 0
            shard.predict_total = 0
            shard.predict_unknown_total = 0
            dedupe = shard.dedupe
            run_agent = None
            run_keys: List[str] = []
            for agent, seq, ts, ingested, kind, key, body in rows:
                if agent != run_agent:
                    # reseed the replay-suppression LRU: after a restart
                    # agents replay journaled-but-unacked records, and the
                    # DB's INSERT OR IGNORE alone would let them double-
                    # count the in-memory aggregates. Keys are UNIQUE per
                    # agent and arrive oldest-first, so "insert each,
                    # evict past the cap" reduces to keeping the newest
                    # `keys_max` in order — seeded per agent run below.
                    if run_agent is not None:
                        dedupe[run_agent] = OrderedDict.fromkeys(
                            run_keys[-keys_max:]
                        )
                    run_agent = agent
                    run_keys = []
                run_keys.append(key)
                apply_one(shard, agent, seq, ts, ingested, kind, key, body)
            if run_agent is not None:
                dedupe[run_agent] = OrderedDict.fromkeys(run_keys[-keys_max:])
            return shard.records_total

    # -- ingest ------------------------------------------------------------
    def ingest(
        self,
        agent_id: str,
        records: Iterable[Tuple[int, float, str, str, object]],
        now: Optional[float] = None,
    ) -> int:
        """Journal + roll up a batch of decoded outbox records.

        ``records`` is the decoder's output shape: ``(seq, ts, kind,
        dedupe_key, payload)`` tuples. Replays are suppressed twice —
        a bounded per-agent key LRU here (protects the in-memory
        aggregates) and ``INSERT OR IGNORE`` in the journal (protects
        durable state even past the LRU window). Returns the number of
        fresh records applied."""
        wall = time.time() if now is None else now
        slot = slot_of(agent_id)
        shard = self._shards[slot % self.shard_count]
        rows: List[tuple] = []
        fresh: List[tuple] = []
        dup = 0
        pack = wire.pack_obj
        with shard.lock:
            seen = shard.dedupe.get(agent_id)
            if seen is None:
                seen = shard.dedupe[agent_id] = OrderedDict()
            for seq, ts, kind, key, payload in records:
                key = key or f"seq:{seq}"
                if key in seen:
                    seen.move_to_end(key)
                    dup += 1
                    continue
                seen[key] = None
                while len(seen) > self.dedupe_keys_max:
                    seen.popitem(last=False)
                body = payload if isinstance(payload, dict) else {}
                cid = str(body.get("correlation_id", "") or "")
                rows.append(
                    (agent_id, seq, ts, wall, kind, key, cid,
                     pack(payload), slot)
                )
                fresh.append((seq, ts, kind, key, body))
            for seq, ts, kind, key, body in fresh:
                self._apply_shard_locked(
                    shard, agent_id, seq, ts, wall, kind, key, body
                )
            if dup:
                shard.duplicates_total += dup
            if fresh:
                shard.ingest_lag = max(0.0, wall - fresh[-1][1])
        if dup:
            _c_duplicates.inc(dup)
        if not rows:
            return 0
        # generation bumps before the journal submit, exactly as the
        # single-lock store did: readers invalidate immediately, the
        # barrier on the miss path makes the rows visible to SQL reads
        with self._meta:
            self._generation += 1
        self._update_gauges()
        if self.writer is not None:
            # every row goes into the writer before the caller acks: where
            # its bounded queue has no room, wait for a drain (the flush
            # barrier drives one) and hand over the rest. The reference
            # lets the queue drop the tail and acks it anyway, so the ack
            # covers records no journal holds (ROADMAP C12); waiting here
            # holds back this shard's worker, and through its bounded
            # queue the agents, instead
            unwritten = rows
            while unwritten:
                if self.writer.pending_ops() + len(unwritten) > self.writer.max_pending:
                    self.writer.flush()
                unwritten = unwritten[self.writer.submit_many("fleet", _INSERT_SQL, unwritten):]
        else:
            self.db.executemany(_INSERT_SQL, rows)
        kind_counts: Dict[str, int] = {}
        for _, _, kind, _, _ in fresh:
            kind_counts[kind] = kind_counts.get(kind, 0) + 1
        for kind, n in kind_counts.items():
            _c_records.inc(n, labels={"kind": kind})
        _g_ingest_lag.set(max(0.0, wall - fresh[-1][1]))
        return len(fresh)

    def _apply_shard_locked(
        self, shard: RollupShard, agent_id: str, seq: int, ts: float,
        ingested: float, kind: str, key: str, body: Dict,
    ) -> None:
        ar = shard.agents.get(agent_id)
        if ar is None:
            ar = shard.agents[agent_id] = _AgentRollup()
        ar.records_by_kind[kind] += 1
        shard.records_total += 1
        if seq > ar.last_seq:
            ar.last_seq = seq
        if ts >= ar.last_ts:
            # lag is anchored to the newest record by *record* time, so a
            # replayed old record can't make a caught-up agent look laggy
            ar.last_ts = ts
            ar.outbox_lag_seconds = max(0.0, ingested - ts)
        if ingested > ar.last_ingest:
            ar.last_ingest = ingested
        if kind == "transition":
            comp = str(body.get("component", "") or "_unknown")
            sr = ar.series.get(comp)
            if sr is None:
                sr = ar.series[comp] = _SeriesRollup()
                shard.series_total += 1
            sr.apply(
                str(body.get("from", "") or ""),
                str(body.get("to", "") or ""),
                float(body.get("ts", ts) or ts),
            )
        elif kind == "remediation_audit":
            ar.remediation_outcomes[str(body.get("outcome", "") or "unknown")] += 1
        elif kind == "ici_link":
            link = str(body.get("link", "") or "")
            if not link:
                return
            lr = ar.links.get(link)
            if lr is None:
                if len(ar.links) >= MAX_LINKS_PER_AGENT:
                    ar.links_truncated += 1
                    return
                lr = ar.links[link] = _LinkRollup()
            lr.apply(body, ts)
        elif kind == "predict_score":
            try:
                schema = int(body.get("schema", 0) or 0)
            except (TypeError, ValueError):
                schema = 0
            if schema > PREDICT_SCHEMA_MAX:
                # newer-agent record: already journaled above (a future
                # manager can replay it), counted here, never applied
                ar.predict_unknown_schema += 1
                shard.predict_unknown_total += 1
                return
            comp = str(body.get("component", "") or "_unknown")
            pr = ar.predict.get(comp)
            if pr is None:
                if len(ar.predict) >= MAX_PREDICT_PER_AGENT:
                    ar.predict_truncated += 1
                    return
                pr = ar.predict[comp] = _PredictRollup()
                shard.predict_total += 1
            pr.apply(body, ts)

    def _update_gauges(self) -> None:
        # per-shard counters are plain ints; summing without the shard
        # locks reads a consistent-enough snapshot for gauges
        _g_agents.set(sum(len(s.agents) for s in self._shards))
        _g_series.set(sum(s.series_total for s in self._shards))
        _g_predict_series.set(sum(s.predict_total for s in self._shards))
        _g_predict_unknown.set(
            sum(s.predict_unknown_total for s in self._shards)
        )

    # -- cache plumbing ----------------------------------------------------
    def _barrier(self) -> None:
        if self.writer is not None:
            self.writer.flush()

    def _cached(self, key: tuple, compute, sql: bool = True) -> object:
        now = time.monotonic()
        with self._meta:
            ent = self._cache.get(key)
            if ent is not None and ent[0] == self._generation and now < ent[1]:
                self._cache_hits += 1
                _c_cache_hits.inc()
                return ent[2]
            gen = self._generation
            self._cache_misses += 1
        _c_cache_misses.inc()
        # miss path: barrier first so SQLite-backed computations see every
        # record journaled before this read began. Pure in-memory computes
        # (``sql=False``) skip it — shard state is applied BEFORE the
        # journal submit, so memory is always at least as new as the DB,
        # and waiting out the write-behind backlog would put the whole
        # ingest burst in the operator's read latency for nothing.
        if sql:
            self._barrier()
        with _h_refresh.time():
            value = compute()
        with self._meta:
            # only cache what was computed against the still-current
            # generation — an ingest racing the compute wins
            if gen == self._generation:
                self._cache[key] = (gen, time.monotonic() + self.cache_ttl, value)
        return value

    def invalidate_cache(self) -> None:
        with self._meta:
            self._cache.clear()
            self._generation += 1

    def cache_stats(self) -> Dict:
        with self._meta:
            return {
                "hits": self._cache_hits,
                "misses": self._cache_misses,
                "entries": len(self._cache),
                "generation": self._generation,
            }

    # -- read paths --------------------------------------------------------
    def fleet_rollup(self) -> Dict:
        """Fleet-wide aggregates (``GET /v1/fleet/rollup``)."""
        return self._cached(("rollup",), self._compute_fleet_rollup, sql=False)

    def _compute_fleet_rollup(self) -> Dict:
        by_kind: _Counter = _Counter()
        remediation: _Counter = _Counter()
        agent_count = 0
        records_total = 0
        duplicates = 0
        max_lag = 0.0
        # one shard lock at a time: snapshot each stripe, then merge.
        # Accumulation runs over a globally sorted series list so the
        # float sums are identical for any shard count (byte-identical
        # rollups across N=1 / N=8 / rebuild-with-new-N).
        snaps: List[tuple] = []
        with self._meta:
            gen = self._generation
        for shard in self._shards:
            with shard.lock:
                records_total += shard.records_total
                duplicates += shard.duplicates_total
                agent_count += len(shard.agents)
                for aid, ar in shard.agents.items():
                    by_kind.update(ar.records_by_kind)
                    remediation.update(ar.remediation_outcomes)
                    if ar.outbox_lag_seconds > max_lag:
                        max_lag = ar.outbox_lag_seconds
                    as_of = ar.last_ts
                    for comp, sr in ar.series.items():
                        snaps.append((
                            aid, comp, sr.snapshot(as_of), sr.transitions,
                            sr.failures, sr.repair_total, sr.repair_count,
                            sr.tbf_total, sr.tbf_count,
                        ))
        snaps.sort(key=lambda s: (s[0], s[1]))
        transitions = 0
        failures = 0
        repair_total = 0.0
        repair_count = 0
        tbf_total = 0.0
        tbf_count = 0
        healthy = 0.0
        unhealthy = 0.0
        unhealthy_now = 0
        flapping: List[Dict] = []
        for aid, comp, snap, s_tr, s_fail, s_rt, s_rc, s_tt, s_tc in snaps:
            transitions += s_tr
            failures += s_fail
            repair_total += s_rt
            repair_count += s_rc
            tbf_total += s_tt
            tbf_count += s_tc
            healthy += snap["healthy_seconds"]
            unhealthy += snap["unhealthy_seconds"]
            if snap["state"] and snap["state"] != "Healthy":
                unhealthy_now += 1
            if snap["flap_count"] >= 3:
                flapping.append(
                    {"agent": aid, "component": comp,
                     "flap_count": snap["flap_count"]}
                )
        flapping.sort(key=lambda f: (-f["flap_count"], f["agent"], f["component"]))
        observed = healthy + unhealthy
        return {
            "generation": gen,
            "agents": agent_count,
            "series": len(snaps),
            "records_total": records_total,
            "records_by_kind": dict(sorted(by_kind.items())),
            "duplicates_suppressed": duplicates,
            "transitions_total": transitions,
            "failures_total": failures,
            "unhealthy_series": unhealthy_now,
            "availability": (healthy / observed) if observed > 0 else 1.0,
            "mttr_seconds": (repair_total / repair_count) if repair_count else 0.0,
            "mtbf_seconds": (tbf_total / tbf_count) if tbf_count else 0.0,
            "remediation_outcomes": dict(sorted(remediation.items())),
            "flapping": flapping[:32],
            "max_outbox_lag_seconds": max_lag,
        }

    def fleet_fabric(
        self, since: float = 0.0, now: Optional[float] = None
    ) -> Dict:
        """Fleet-wide fabric link matrix rollup (``GET /v1/fleet/fabric``):
        per-agent link aggregates from journaled ``ici_link`` fabric
        sweep records, answering "which links degraded since ts" — and,
        via the windowed 1h/24h/7d counters, "which links degraded this
        week" — across the whole fleet from one query. ``now`` anchors
        the window buckets; passing it explicitly (tests, parity
        comparisons) makes the response a pure function of the journal
        and bypasses the TTL cache."""
        since = float(since)
        if now is not None:
            return self._compute_fleet_fabric(since, float(now))
        return self._cached(
            ("fabric", since),
            lambda: self._compute_fleet_fabric(since, None),
            sql=False,
        )

    def _compute_fleet_fabric(
        self, since: float, now: Optional[float]
    ) -> Dict:
        with self._meta:
            gen = self._generation
        agents_with_links = 0
        links_total = 0
        truncated = 0
        by_state: _Counter = _Counter()
        degraded: List[Dict] = []
        for shard in self._shards:
            with shard.lock:
                for aid, ar in shard.agents.items():
                    if not ar.links:
                        continue
                    agents_with_links += 1
                    links_total += len(ar.links)
                    truncated += ar.links_truncated
                    for name, lr in ar.links.items():
                        by_state[lr.last_state or "unknown"] += 1
                        if (
                            lr.last_state in ("degraded", "down")
                            or (lr.last_degraded_ts > 0
                                and lr.last_degraded_ts >= since)
                        ):
                            row = lr.snapshot(as_of=now)
                            row["agent"] = aid
                            row["link"] = name
                            degraded.append(row)
        degraded.sort(
            key=lambda r: (
                -_LINK_STATE_RANK.get(r["state"], 0),
                -r["last_degraded_ts"],
                r["agent"],
                r["link"],
            )
        )
        return {
            "generation": gen,
            "since": since,
            "agents": agents_with_links,
            "links_total": links_total,
            "links_by_state": dict(sorted(by_state.items())),
            "degraded_count": len(degraded),
            "degraded": degraded[:256],
            "links_truncated": truncated,
        }

    def fleet_predict(
        self, top: int = 20, now: Optional[float] = None
    ) -> Dict:
        """Fleet-ranked prediction pane (``GET /v1/fleet/predict``):
        "which K of my N nodes fail next", from journaled
        ``predict_score`` records. Rows are (agent, component) predictive
        aggregates ranked by time-decayed risk — the last fused score
        plus armed/repeat-warning evidence, down-ranked exponentially as
        the score goes stale (``predict_decay_seconds`` e-folding).
        ``now`` anchors the decay; passing it explicitly (tests, parity
        comparisons) makes the response a pure function of the journal
        and bypasses the TTL cache."""
        top = max(1, min(500, int(top)))
        if now is not None:
            return self._compute_fleet_predict(top, float(now))
        return self._cached(
            ("predict", top),
            lambda: self._compute_fleet_predict(top, time.time()),
            sql=False,
        )

    def _compute_fleet_predict(self, top: int, now: float) -> Dict:
        with self._meta:
            gen = self._generation
        decay_tau = self.predict_decay
        agents_with_predict = 0
        unknown_schema = 0
        truncated = 0
        armed = 0
        warns_total = 0
        # (agent, component, snapshot) collected one shard lock at a
        # time, then globally sorted — identical output for any shard
        # count (the fleet lead-time aggregation below also walks the
        # sorted list so float sums are order-stable)
        rows: List[tuple] = []
        for shard in self._shards:
            with shard.lock:
                for aid, ar in shard.agents.items():
                    if not ar.predict and not ar.predict_unknown_schema:
                        continue
                    if ar.predict:
                        agents_with_predict += 1
                    unknown_schema += ar.predict_unknown_schema
                    truncated += ar.predict_truncated
                    for comp, pr in ar.predict.items():
                        snap = pr.snapshot(now, decay_tau)
                        if snap["armed"]:
                            armed += 1
                        warns_total += snap["warn_count"]
                        rows.append((aid, comp, snap))
        rows.sort(key=lambda r: (-r[2]["risk"], r[0], r[1]))
        lead_count = 0
        lead_total = 0.0
        lead_min = 0.0
        lead_max = 0.0
        for aid, comp, snap in sorted(rows, key=lambda r: (r[0], r[1])):
            lead = snap["lead"]
            if lead["count"]:
                if lead_count == 0 or lead["min_seconds"] < lead_min:
                    lead_min = lead["min_seconds"]
                if lead["max_seconds"] > lead_max:
                    lead_max = lead["max_seconds"]
                lead_count += lead["count"]
                lead_total += lead["mean_seconds"] * lead["count"]
        ranked = []
        for aid, comp, snap in rows[:top]:
            row = dict(snap)
            row["agent"] = aid
            row["component"] = comp
            ranked.append(row)
        buckets = {"low": 0, "moderate": 0, "elevated": 0, "critical": 0}
        for _aid, _comp, snap in rows:
            r = snap["risk"]
            if r < 0.25:
                buckets["low"] += 1
            elif r < 0.5:
                buckets["moderate"] += 1
            elif r < 0.75:
                buckets["elevated"] += 1
            else:
                buckets["critical"] += 1
        return {
            "generation": gen,
            "now": now,
            "decay_tau_seconds": decay_tau,
            "agents": agents_with_predict,
            "series": len(rows),
            "armed": armed,
            "warns_total": warns_total,
            "risk_buckets": buckets,
            "lead": {
                "count": lead_count,
                "mean_seconds": (
                    lead_total / lead_count if lead_count else 0.0
                ),
                "min_seconds": lead_min,
                "max_seconds": lead_max,
            },
            "unknown_schema_records": unknown_schema,
            "predict_truncated": truncated,
            "top_k": top,
            "top": ranked,
        }

    def agents_page(self, offset: int = 0, limit: int = 50) -> Dict:
        """One page of per-agent rollups (``GET /v1/fleet/agents``)."""
        offset = max(0, int(offset))
        limit = max(1, min(500, int(limit)))
        return self._cached(
            ("agents", offset, limit),
            lambda: self._compute_agents_page(offset, limit),
            sql=False,
        )

    def _compute_agents_page(self, offset: int, limit: int) -> Dict:
        ids = self.agent_ids()
        page_ids = ids[offset:offset + limit]
        rollups = []
        for aid in page_ids:
            shard = self._shard_for(aid)
            with shard.lock:
                ar = shard.agents.get(aid)
                if ar is None:
                    continue  # raced a rebuild; agents are never removed
                as_of = ar.last_ts
                # predict risk anchored at the agent's own newest record
                # time (a pure function of the journal — pagination stays
                # rebuild-deterministic); the wall-clock staleness decay
                # lives in the fleet_predict ranking pane
                predict = {
                    comp: pr.snapshot(as_of, self.predict_decay)
                    for comp, pr in sorted(ar.predict.items())
                }
                rollups.append({
                    "agent": aid,
                    "last_seq": ar.last_seq,
                    "last_record_ts": ar.last_ts,
                    "last_ingest": ar.last_ingest,
                    "outbox_lag_seconds": ar.outbox_lag_seconds,
                    "records_by_kind": dict(ar.records_by_kind),
                    "remediation_outcomes": dict(ar.remediation_outcomes),
                    "components": {
                        comp: sr.snapshot(as_of)
                        for comp, sr in sorted(ar.series.items())
                    },
                    "predict": predict,
                    "predict_risk": max(
                        (p["risk"] for p in predict.values()), default=0.0
                    ),
                    "predict_unknown_schema": ar.predict_unknown_schema,
                })
        total = len(ids)
        next_offset = offset + len(rollups)
        return {
            "agents": rollups,
            "total": total,
            "offset": offset,
            "limit": limit,
            "next_offset": next_offset if next_offset < total else None,
        }

    def agent_snapshot(self, agent_id: str) -> Optional[Dict]:
        """Uncached single-agent rollup (expectation checks, tests)."""
        shard = self._shard_for(agent_id)
        with shard.lock:
            ar = shard.agents.get(agent_id)
            if ar is None:
                return None
            as_of = ar.last_ts
            return {
                "agent": agent_id,
                "last_seq": ar.last_seq,
                "records_by_kind": dict(ar.records_by_kind),
                "remediation_outcomes": dict(ar.remediation_outcomes),
                "components": {
                    comp: sr.snapshot(as_of)
                    for comp, sr in sorted(ar.series.items())
                },
                "predict": {
                    comp: pr.snapshot(as_of, self.predict_decay)
                    for comp, pr in sorted(ar.predict.items())
                },
                "predict_unknown_schema": ar.predict_unknown_schema,
            }

    def dedupe_snapshot(self, agent_id: str) -> List[str]:
        """The agent's replay-suppression LRU keys, oldest first (tests)."""
        shard = self._shard_for(agent_id)
        with shard.lock:
            seen = shard.dedupe.get(agent_id)
            return list(seen) if seen else []

    def shard_stats(self) -> List[Dict]:
        """Per-shard occupancy/lag snapshot (metrics, chip_smoke.py)."""
        out = []
        for shard in self._shards:
            with shard.lock:
                out.append({
                    "index": shard.index,
                    "agents": len(shard.agents),
                    "series": shard.series_total,
                    "records_total": shard.records_total,
                    "duplicates_total": shard.duplicates_total,
                    "dedupe_keys": sum(len(d) for d in shard.dedupe.values()),
                    "ingest_lag_seconds": shard.ingest_lag,
                    "predict_series": shard.predict_total,
                    "predict_unknown_schema": shard.predict_unknown_total,
                })
        return out

    def history(
        self,
        agent_id: str,
        since: float = 0.0,
        limit: int = 100,
        offset: int = 0,
    ) -> Dict:
        """Journaled record timeline for one agent
        (``GET /v1/fleet/agents/{id}/history``), newest first."""
        since = float(since)
        limit = max(1, min(1000, int(limit)))
        offset = max(0, int(offset))
        return self._cached(
            ("history", agent_id, since, limit, offset),
            lambda: self._compute_history(agent_id, since, limit, offset),
        )

    def _compute_history(
        self, agent_id: str, since: float, limit: int, offset: int
    ) -> Dict:
        total_row = self.db.query_one(
            f"SELECT COUNT(*) FROM {TABLE} WHERE agent = ? AND ts >= ?",
            (agent_id, since),
        )
        rows = self.db.query(
            f"SELECT seq, ts, ingested, kind, dedupe_key, correlation_id, "
            f"payload FROM {TABLE} WHERE agent = ? AND ts >= ? "
            f"ORDER BY ts DESC, seq DESC LIMIT ? OFFSET ?",
            (agent_id, since, limit, offset),
        )
        records = [_record_dict(r) for r in rows]
        total = int(total_row[0]) if total_row else 0
        next_offset = offset + len(records)
        return {
            "agent": agent_id,
            "records": records,
            "total": total,
            "offset": offset,
            "limit": limit,
            "next_offset": next_offset if next_offset < total else None,
        }

    def traces(self, correlation_id: str, limit: int = 200) -> Dict:
        """Every journaled fleet record stitched to one agent-side check
        trace (``GET /v1/fleet/traces?correlation_id=``)."""
        correlation_id = str(correlation_id)
        limit = max(1, min(1000, int(limit)))
        return self._cached(
            ("traces", correlation_id, limit),
            lambda: self._compute_traces(correlation_id, limit),
        )

    def _compute_traces(self, correlation_id: str, limit: int) -> Dict:
        rows = self.db.query(
            f"SELECT agent, seq, ts, ingested, kind, dedupe_key, "
            f"correlation_id, payload FROM {TABLE} "
            f"WHERE correlation_id = ? ORDER BY ts, seq LIMIT ?",
            (correlation_id, limit),
        )
        records = []
        for r in rows:
            d = _record_dict(r[1:])
            d["agent"] = r[0]
            records.append(d)
        return {
            "correlation_id": correlation_id,
            "records": records,
            "count": len(records),
        }

    # -- maintenance -------------------------------------------------------
    def purge(self) -> int:
        """Bound the journal: delete the oldest rows past
        ``max_journal_rows``. Rollups are NOT rebuilt — they summarize
        all history ever ingested; the journal bound only caps what a
        rebuild can recover (documented in docs/fleet.md)."""
        self._barrier()
        row = self.db.query_one(f"SELECT COUNT(*) FROM {TABLE}")
        total = int(row[0]) if row else 0
        excess = total - self.max_journal_rows
        if excess <= 0:
            return 0
        self.db.execute(
            f"DELETE FROM {TABLE} WHERE rowid IN "
            f"(SELECT rowid FROM {TABLE} ORDER BY ts, seq LIMIT ?)",
            (excess,),
        )
        logger.info("fleet journal purged %d rows (cap %d)",
                    excess, self.max_journal_rows)
        return excess

    def journal_count(self) -> int:
        self._barrier()
        row = self.db.query_one(f"SELECT COUNT(*) FROM {TABLE}")
        return int(row[0]) if row else 0

    def records_total(self) -> int:
        return sum(s.records_total for s in self._shards)

    def duplicates_total(self) -> int:
        return sum(s.duplicates_total for s in self._shards)

    def agent_ids(self) -> List[str]:
        ids: List[str] = []
        for shard in self._shards:
            with shard.lock:
                ids.extend(shard.agents)
        ids.sort()
        return ids


def _record_dict(row) -> Dict:
    seq, ts, ingested, kind, key, cid, payload = row
    return {
        "seq": seq,
        "ts": ts,
        "ingested": ingested,
        "kind": kind,
        "dedupe_key": key,
        "correlation_id": cid,
        "payload": wire.unpack_obj(payload) if payload is not None else None,
    }
