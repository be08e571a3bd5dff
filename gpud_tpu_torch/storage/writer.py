"""Write-behind commit layer: one batched, group-commit SQLite writer; the
port of ``gpud_tpu/storage/writer.py``.

Before this layer every metric scrape row, event, health transition, and
remediation audit row was its own SQLite transaction (`DB.execute`
commits per call) — four stores × per-row commits is the dominant cost
of sustained ingest and the footprint papers' first complaint about
monitors (PAPERS.md: the monitor's own cost *is* the product). The
``BatchWriter`` turns that into:

- an in-memory append buffer any thread can ``submit()`` to, with
  per-store delta aggregation: append-only rows (events, transitions,
  audit, metric samples) accumulate; keyed ops (the ledger's last-state
  upsert, same-timestamp gauge samples) coalesce last-write-wins so an
  ingest storm commits one row per key per flush window instead of one
  per observation;
- one drain path that executes the whole buffer inside a SINGLE SQLite
  transaction (group commit: one WAL append — and, with ``fsync=True``,
  one fsync — per batch instead of per row), grouped by statement so
  ``executemany`` does the per-row work in C;
- a scheduler job (``storage-writer-flush``, reusing gpud_tpu_torch/scheduler/)
  draining every ``flush_interval_seconds``, poked early when the buffer
  crosses ``flush_threshold`` ops;
- a bounded queue: past ``max_pending`` ops, ``submit`` applies
  backpressure (bounded wait for a drain) and then drops with per-store
  accounting (``tpud_storage_dropped_total``) — ingest overload degrades
  telemetry, never daemon memory;
- an explicit ``flush()`` barrier: returns once every op submitted
  before the call is committed. Every read-after-write path (HTTP
  history queries, the remediation engine's cooldown/rate derivations,
  retention purges, eventstore dedupe finds) runs it first, so batching
  is invisible to readers — "read your own writes" holds at every API
  surface while the hot path stays append-only.

Durability window (docs/storage.md): a SIGKILL loses at most the ops
buffered since the last drain (≤ the flush interval, bounded tighter by
the threshold poke); a committed batch is atomic — SQLite's transaction
guarantees mean no torn rows, which ``tests/test_crash_consistency.py``
proves by killing a writer mid-stream.

The writer is optional everywhere: stores constructed without one (unit
tests, CLI tools reading a daemon's state file) keep the synchronous
per-call commit path unchanged.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, gauge, histogram

logger = get_logger(__name__)

DEFAULT_FLUSH_INTERVAL = 0.2      # seconds between scheduled drains
DEFAULT_MAX_PENDING = 100_000     # ops buffered before backpressure/drop
DEFAULT_FLUSH_THRESHOLD = 5_000   # buffered ops that poke an early drain
DEFAULT_BACKPRESSURE_SECONDS = 0.05  # bounded wait for room before dropping
_FLUSH_SAMPLES = 512              # ring of recent flush durations for stats()

FLUSH_JOB_NAME = "storage-writer-flush"

_g_queue_depth = gauge(
    "tpud_storage_queue_depth",
    "ops buffered in the write-behind layer awaiting the next group commit",
)
_g_batch_size = gauge(
    "tpud_storage_batch_size",
    "ops committed by the most recent storage batch (one transaction)",
)
_h_flush = histogram(
    "tpud_storage_flush_seconds",
    "wall time of one storage batch drain (swap + group commit)",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
             0.1, 0.25, 0.5, 1.0, 2.5),
)
_c_ops = counter(
    "tpud_storage_ops_total",
    "write ops accepted into the write-behind buffer, by store",
)
_c_coalesced = counter(
    "tpud_storage_coalesced_total",
    "keyed write ops absorbed by last-write-wins coalescing, by store",
)
_c_dropped = counter(
    "tpud_storage_dropped_total",
    "write ops dropped by the bounded queue (or a failed/crashed batch), "
    "by store",
)
_c_commits = counter(
    "tpud_storage_commits_total",
    "group commits executed by the write-behind writer",
)
_c_backpressure = counter(
    "tpud_storage_backpressure_waits_total",
    "submits that had to wait for queue room before being accepted",
)
_g_wal_bytes = gauge(
    "tpud_sqlite_wal_bytes",
    "size of the state DB's WAL file, sampled just before each periodic "
    "wal_checkpoint(TRUNCATE)",
)
_h_checkpoint = histogram(
    "tpud_storage_wal_checkpoint_seconds",
    "wall time of the periodic PRAGMA wal_checkpoint(TRUNCATE) pass",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
)


class BatchWriter:
    """The shared write-behind commit path (module docstring).

    Thread-safe: ``submit``/``submit_many`` may be called from any thread
    (component checks, the kmsg watcher, session dispatch, the manager's
    future fleet-ingest path). Drains are serialized on ``_drain_mu`` and
    may run on the scheduler pool or inline on a barrier caller's thread
    — ``DB`` keeps per-thread connections, so either is safe.
    """

    # _flush_samples is a bounded deque (GIL-atomic appends, stats() reads
    # a sorted snapshot); _job is written once under start()/close() and
    # only poked afterwards — both deliberately unguarded
    GUARDED_BY = {
        "_appends": "_cv",
        "_coalesce": "_cv",
        "_pending": "_cv",
        "_seq": "_cv",
        "_flushed_seq": "_cv",
        "_stopped": "_cv",
        "_commits": "_cv",
        "_committed_ops": "_cv",
        "_dropped": "_cv",
        "_last_batch": "_cv",
    }

    def __init__(
        self,
        db,
        flush_interval_seconds: float = DEFAULT_FLUSH_INTERVAL,
        max_pending: int = DEFAULT_MAX_PENDING,
        flush_threshold: int = DEFAULT_FLUSH_THRESHOLD,
        backpressure_seconds: float = DEFAULT_BACKPRESSURE_SECONDS,
        fsync: bool = False,
    ) -> None:
        self.db = db
        self.flush_interval = float(flush_interval_seconds)
        self.max_pending = int(max_pending)
        self.flush_threshold = max(1, int(flush_threshold))
        self.backpressure_seconds = float(backpressure_seconds)
        self.fsync = bool(fsync)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        # sql -> ordered params list (append-only rows); executemany per sql
        self._appends: Dict[str, List[tuple]] = {}
        # coalesce key -> [sql, params] (last-write-wins keyed ops)
        self._coalesce: Dict[tuple, list] = {}
        self._pending = 0
        self._seq = 0           # ops ever accepted (coalesced included)
        self._flushed_seq = 0   # highest seq durably committed (or dropped)
        self._stopped = False
        self._drain_mu = threading.Lock()
        self._flush_samples: deque = deque(maxlen=_FLUSH_SAMPLES)
        self._commits = 0
        self._committed_ops = 0
        self._dropped = 0
        self._last_batch = 0
        self._job = None

    # -- write path --------------------------------------------------------
    def submit(
        self,
        store: str,
        sql: str,
        params: tuple,
        key: Optional[tuple] = None,
    ) -> bool:
        """Buffer one write op. ``key`` ops coalesce last-write-wins
        (only the newest survives a flush window); ``key=None`` appends.
        Returns False only when the bounded queue dropped the op."""
        return self.submit_many(store, sql, (params,), key=key) == 1

    def submit_many(
        self,
        store: str,
        sql: str,
        params_seq: Iterable[tuple],
        key: Optional[tuple] = None,
        keys: Optional[List[tuple]] = None,
    ) -> int:
        """Buffer a batch of ops for one statement under one lock
        acquisition (the firehose path). ``keys`` gives a coalesce key per
        row; ``key`` applies one key to every row. Returns the number of
        ops accepted (appends + coalesce updates); the remainder was
        dropped by the bounded queue."""
        params_list = list(params_seq)
        if not params_list:
            return 0
        with self._cv:
            if self._stopped:
                # sync fallback: a writer that is closed (daemon shutdown,
                # tools) degrades to the classic one-commit-per-call path
                # so late writes are never silently lost
                pass
            else:
                return self._buffer_locked(store, sql, params_list, key, keys)
        # out of the lock: direct synchronous writes
        if len(params_list) == 1:
            self.db.execute(sql, params_list[0])
        else:
            self.db.executemany(sql, params_list)
        _c_ops.inc(len(params_list), {"store": store})
        return len(params_list)

    def _buffer_locked(
        self,
        store: str,
        sql: str,
        params_list: List[tuple],
        key: Optional[tuple],
        keys: Optional[List[tuple]],
    ) -> int:
        accepted = 0
        overflow = False
        for i, params in enumerate(params_list):
            k = keys[i] if keys is not None else key
            if k is not None:
                slot = self._coalesce.get(k)
                if slot is not None:
                    slot[0] = sql
                    slot[1] = params
                    self._seq += 1
                    accepted += 1
                    _c_coalesced.inc(labels={"store": store})
                    continue
            if self._pending >= self.max_pending:
                if not self._wait_for_room_locked():
                    overflow = True
                    dropped = len(params_list) - i
                    self._dropped += dropped
                    _c_dropped.inc(dropped, {"store": store})
                    break
            if k is not None:
                self._coalesce[k] = [sql, params]
            else:
                self._appends.setdefault(sql, []).append(params)
            self._pending += 1
            self._seq += 1
            accepted += 1
        _g_queue_depth.set(self._pending)
        if accepted:
            _c_ops.inc(accepted, {"store": store})
        if self._pending >= self.flush_threshold or overflow:
            self._wake_flusher_locked()
        return accepted

    def _wait_for_room_locked(self) -> bool:
        """Bounded backpressure: poke a drain and wait briefly for room.
        Returns True when there is room, False to drop."""
        _c_backpressure.inc()
        self._wake_flusher_locked()
        deadline = time.monotonic() + self.backpressure_seconds
        while self._pending >= self.max_pending:
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self._stopped:
                return False
            self._cv.wait(remaining)
        return True

    def _wake_flusher_locked(self) -> None:
        job = self._job
        if job is not None:
            job.poke()

    # -- drain / barrier ---------------------------------------------------
    def drain(self) -> int:
        """One swap + group commit; returns ops committed. Runs on the
        scheduler job, on barrier callers, and on close()."""
        with self._drain_mu:
            return self._drain_inner()

    def _drain_inner(self) -> int:
        t0 = time.monotonic()
        with self._cv:
            if not self._pending:
                return 0
            appends = self._appends
            coalesce = self._coalesce
            watermark = self._seq
            n = self._pending
            self._appends = {}
            self._coalesce = {}
            self._pending = 0
            _g_queue_depth.set(0)
            self._cv.notify_all()  # backpressure waiters: room exists
        groups: List[Tuple[str, List[tuple]]] = list(appends.items())
        by_sql: Dict[str, List[tuple]] = {}
        for sql, params in coalesce.values():
            by_sql.setdefault(sql, []).append(tuple(params))
        groups.extend(by_sql.items())
        committed = True
        try:
            self.db.run_batch(groups, fsync=self.fsync)
        except Exception:  # noqa: BLE001
            # a failed batch (disk full, I/O error) is dropped whole —
            # requeueing would reorder against newer ops and grow without
            # bound while the disk stays broken. The barrier still
            # advances: readers must never hang on storage that is down.
            logger.exception("storage batch commit failed; %d ops lost", n)
            committed = False
            _c_dropped.inc(n, {"store": "_commit_failed"})
        else:
            _c_commits.inc()
        dt = time.monotonic() - t0
        with self._cv:
            # counter updates ride the same acquisition as the watermark:
            # unlocked `self._dropped += n` here raced drop_pending() and
            # _buffer_locked() read-modify-writes (lost increments)
            if committed:
                self._commits += 1
                self._committed_ops += n
            else:
                self._dropped += n
            if self._flushed_seq < watermark:
                self._flushed_seq = watermark
            self._last_batch = n
            self._cv.notify_all()
        _g_batch_size.set(n)
        _h_flush.observe(dt)
        self._flush_samples.append(dt)
        return n

    def flush(self, timeout: float = 30.0) -> bool:
        """Barrier: returns once every op submitted before this call is
        committed (or dropped). The no-pending fast path is one lock
        acquisition, so read paths can call it unconditionally."""
        with self._cv:
            if self._flushed_seq >= self._seq:
                return True
            target = self._seq
        deadline = time.monotonic() + timeout
        while True:
            with self._cv:
                if self._flushed_seq >= target:
                    return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            # drive the drain from this thread instead of waiting on the
            # scheduler job — a barrier must make progress even when every
            # pool worker is blocked on this same barrier
            if self._drain_mu.acquire(timeout=min(remaining, 1.0)):
                try:
                    self._drain_inner()
                finally:
                    self._drain_mu.release()

    def drop_pending(self, reason: str = "crash") -> int:
        """Discard the whole in-memory buffer WITHOUT committing — the
        chaos ``storage_crash`` fault: exactly what a SIGKILL between
        drains loses. Barriers are released (the ops are gone; waiting
        for them would hang the daemon the drill is testing)."""
        with self._cv:
            n = self._pending
            self._appends = {}
            self._coalesce = {}
            self._pending = 0
            self._flushed_seq = self._seq
            self._dropped += n
            _g_queue_depth.set(0)
            self._cv.notify_all()
        if n:
            _c_dropped.inc(n, {"store": reason})
            logger.warning("storage writer dropped %d buffered ops (%s)", n, reason)
        return n

    # -- lifecycle ---------------------------------------------------------
    def start(self, scheduler=None) -> None:
        """Register the periodic drain job. Without a scheduler the writer
        still works: drains happen on threshold crossings and barriers."""
        if scheduler is None or self._job is not None:
            return
        self._job = scheduler.add_job(
            FLUSH_JOB_NAME,
            self.drain,
            interval=self.flush_interval,
            initial_delay=self.flush_interval,  # nothing to drain at boot
            jitter=False,  # the durability window is a contract, not a cadence
        )

    def close(self) -> None:
        """Final graceful-shutdown barrier: stop accepting buffered ops
        (submits fall back to synchronous writes) and commit everything
        still buffered."""
        with self._cv:
            if self._stopped:
                return
            self._stopped = True
            self._cv.notify_all()
        if self._job is not None:
            self._job.cancel()
            self._job = None
        self.drain()

    # -- introspection -----------------------------------------------------
    def pending_ops(self) -> int:
        with self._cv:
            return self._pending

    def stats(self) -> Dict:
        with self._cv:
            pending = self._pending
            commits = self._commits
            committed = self._committed_ops
            dropped = self._dropped
            last = self._last_batch
        samples = sorted(self._flush_samples)
        p50 = samples[len(samples) // 2] if samples else 0.0
        p95 = samples[int(0.95 * (len(samples) - 1))] if samples else 0.0
        return {
            "pending_ops": pending,
            "commits": commits,
            "committed_ops": committed,
            "dropped_ops": dropped,
            "last_batch_ops": last,
            "flush_p50_seconds": p50,
            "flush_p95_seconds": p95,
        }


def checkpoint_wal(db, writer: Optional[BatchWriter] = None) -> Dict:
    """One periodic WAL maintenance pass (scheduler job "wal-checkpoint"):
    barrier-flush the writer so the WAL holds everything buffered, sample
    the WAL size into ``tpud_sqlite_wal_bytes`` (its pre-truncate peak is
    the operator's signal), then ``PRAGMA wal_checkpoint(TRUNCATE)`` so
    the file stays bounded under sustained batched ingest."""
    if writer is not None:
        writer.flush()
    wal_bytes = db.wal_size_bytes()
    _g_wal_bytes.set(wal_bytes)
    t0 = time.monotonic()
    busy, log_pages, ckpt_pages = db.wal_checkpoint("TRUNCATE")
    dt = time.monotonic() - t0
    _h_checkpoint.observe(dt)
    return {
        "wal_bytes": wal_bytes,
        "busy": busy,
        "log_pages": log_pages,
        "checkpointed_pages": ckpt_pages,
        "seconds": dt,
    }
