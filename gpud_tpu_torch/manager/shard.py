"""Lock-striped sharding for the manager's fleet ingest plane; the port of
``gpud_tpu/manager/shard.py``.

One store lock around every ingest and every rollup walk, a journal
replayed single-threaded at boot, and decode + rollup ingest inline on
each session reader thread would let one hot agent (or one slow
BatchWriter flush) stall the whole plane. This module provides the two
primitives that avoid that:

- **Stable slot hashing.** Agents hash to one of ``SHARD_SLOTS`` virtual
  slots via crc32 (the same stable-hash idiom the scheduler uses for
  jitter). The *slot* — not the shard index — is what the journal's
  ``shard`` column records, so a restart with a different shard count
  still partitions the journal correctly: shard ``i`` of ``N`` owns
  every slot with ``slot % N == i``. Per-agent ordering (the only
  ordering ingest ever relied on) is preserved because an agent maps to
  exactly one slot and therefore exactly one shard. The slot is the
  reference's, bit for bit, so either package re-partitions the other's
  journal.
- **RollupShard.** The striped unit of in-memory state: its own lock,
  its own per-agent dedupe LRUs, its own aggregates. Rollup *logic*
  stays in ``FleetRollupStore``; the shard is deliberately dumb so the
  store's tuning knobs (``dedupe_keys_max`` etc.) keep working when
  mutated after construction.
- **ShardIngestExecutor.** A bounded per-shard worker pool that takes
  wire-decoded batches off the session reader threads. The reader only
  enqueues (O(µs), never blocks); decode of the delta stream, dedupe,
  journal submit, and the ack all happen on the shard worker, which
  keeps the ack-vs-durability contract (ack enqueued only after the
  shard journals) and per-agent FIFO ordering (same agent → same shard
  queue). A saturated shard *drops* the batch without acking —
  backpressure is accounted, and the agent's at-least-once outbox
  replays the un-acked frames later.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, gauge

logger = get_logger(__name__)

# Virtual slots decouple the journal's persisted partition key from the
# runtime shard count: 256 slots re-partition evenly for any shard
# count that divides into them, and "evenly enough" for any other.
SHARD_SLOTS = 256
DEFAULT_SHARD_COUNT = 8
DEFAULT_SHARD_QUEUE_MAX = 1024

_g_shard_records = gauge(
    "tpud_fleet_shard_records",
    "journaled records applied to each rollup shard's in-memory aggregates",
)
_g_shard_queue_depth = gauge(
    "tpud_fleet_shard_queue_depth",
    "decoded outbox batches waiting on each shard's ingest queue",
)
_g_shard_dedupe = gauge(
    "tpud_fleet_shard_dedupe_keys",
    "replay-suppression LRU keys held by each rollup shard",
)
_g_shard_ingest_lag = gauge(
    "tpud_fleet_shard_ingest_lag_seconds",
    "age of each shard's most recently ingested record "
    "(manager wall clock minus record timestamp)",
)
_c_shard_backpressure = counter(
    "tpud_fleet_shard_backpressure_total",
    "outbox batches dropped un-acked because a shard ingest queue was full "
    "(the agent's outbox replays them)",
)


def slot_of(agent_id: str) -> int:
    """Stable virtual slot for an agent — what the journal persists."""
    return zlib.crc32(agent_id.encode("utf-8", "replace")) % SHARD_SLOTS


def shard_index(agent_id: str, shard_count: int) -> int:
    """Which of ``shard_count`` shards owns this agent right now."""
    return slot_of(agent_id) % shard_count


def shard_slots(index: int, shard_count: int) -> List[int]:
    """The virtual slots shard ``index`` owns under ``shard_count``."""
    return list(range(index, SHARD_SLOTS, shard_count))


class RollupShard:
    """One stripe of the fleet rollup store's in-memory state.

    Pure data holder: ``FleetRollupStore`` owns all mutation logic and
    takes ``lock`` around it. Counters are plain ints read without the
    lock on cheap paths (``records_total()``) — torn reads are
    impossible for ints and staleness is acceptable there.
    """

    __slots__ = (
        "index", "lock", "agents", "dedupe",
        "records_total", "duplicates_total", "series_total", "ingest_lag",
        "predict_total", "predict_unknown_total",
    )

    # counters (records_total etc.) are deliberately unguarded: plain
    # ints, torn-read-free, read lock-free on observability paths
    GUARDED_BY = {"agents": "lock", "dedupe": "lock"}

    def __init__(self, index: int) -> None:
        self.index = index
        self.lock = threading.Lock()
        self.agents: Dict[str, object] = {}
        self.dedupe: Dict[str, OrderedDict] = {}
        self.records_total = 0
        self.duplicates_total = 0
        self.series_total = 0
        self.ingest_lag = 0.0
        self.predict_total = 0
        self.predict_unknown_total = 0

    def dedupe_keys(self) -> int:
        with self.lock:
            return sum(len(d) for d in self.dedupe.values())


class ShardIngestExecutor:
    """Bounded per-shard workers that run ingest off the reader threads.

    ``submit`` routes by the same stable hash the rollup store shards
    by, so all work for one agent lands on one queue and runs in FIFO
    order. The queue bound is the backpressure contract: a full shard
    rejects the batch (counted, dropped, *not* acked) instead of
    blocking the session reader — the agent's durable outbox replays
    un-acked frames, so a drop costs redelivery, never data.
    """

    # _errors / _submit_ns are GIL-atomic (int += races lose one count
    # at worst on an error path; the deque is bounded and append-only)
    GUARDED_BY = {
        "_queues": "_conds",
        "_busy": "_conds",
        "_accepted": "_conds",
        "_dropped": "_conds",
        "_stopped": "_conds",
    }
    _LOCK_FREE = {
        "queue_depths": "len() snapshot of a fixed-size deque list; "
                        "torn reads tolerated on the observability path",
        "stats": "unlocked counter snapshot for observability; values "
                 "may lag one increment, never corrupt",
    }

    def __init__(
        self,
        shard_count: int = DEFAULT_SHARD_COUNT,
        max_queue_per_shard: int = DEFAULT_SHARD_QUEUE_MAX,
    ) -> None:
        self.shard_count = max(1, min(int(shard_count), SHARD_SLOTS))
        self.max_queue = max(1, int(max_queue_per_shard))
        self._conds = [threading.Condition() for _ in range(self.shard_count)]
        self._queues: List[deque] = [deque() for _ in range(self.shard_count)]
        self._busy = [0] * self.shard_count
        self._accepted = [0] * self.shard_count
        self._dropped = [0] * self.shard_count
        self._errors = 0
        # reader-side enqueue latency ring: the "reader-thread stall"
        # signal chip_smoke.py reports — if enqueueing ever blocks, the
        # offload regressed to the inline behaviour it replaced
        self._submit_ns: deque = deque(maxlen=4096)
        self._stopped = False
        self._threads: List[threading.Thread] = []
        for i in range(self.shard_count):
            t = threading.Thread(
                target=self._worker, args=(i,),
                name=f"tpud-fleet-ingest-{i}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    # -- reader side -------------------------------------------------------
    def submit(self, agent_id: str, fn: Callable[[], None]) -> bool:
        """Enqueue one decoded batch's ingest; never blocks the caller.

        Returns False (and counts backpressure) if the shard queue is
        full or the executor is stopped — the caller must NOT ack."""
        t0 = time.monotonic_ns()
        i = shard_index(agent_id, self.shard_count)
        cond = self._conds[i]
        with cond:
            if self._stopped or len(self._queues[i]) >= self.max_queue:
                self._dropped[i] += 1
                accepted = False
            else:
                self._queues[i].append(fn)
                self._accepted[i] += 1
                accepted = True
                cond.notify()
        self._submit_ns.append(time.monotonic_ns() - t0)
        if not accepted:
            _c_shard_backpressure.inc(labels={"shard": str(i)})
        return accepted

    # -- worker side -------------------------------------------------------
    def _worker(self, i: int) -> None:
        cond = self._conds[i]
        while True:
            with cond:
                q = self._queues[i]
                while not q and not self._stopped:
                    cond.wait(timeout=0.5)
                if not q:
                    if self._stopped:
                        cond.notify_all()  # wake any flush() waiter
                        return
                    continue
                fn = q.popleft()
                self._busy[i] += 1
            try:
                fn()
            except Exception:
                self._errors += 1
                logger.exception("shard %d ingest task failed", i)
            finally:
                with cond:
                    self._busy[i] -= 1
                    if not self._queues[i] and not self._busy[i]:
                        cond.notify_all()  # flush() barrier

    # -- lifecycle / barriers ----------------------------------------------
    def flush(self, timeout: float = 10.0) -> bool:
        """Block until every shard queue is drained and idle."""
        deadline = time.monotonic() + timeout
        for i, cond in enumerate(self._conds):
            with cond:
                while self._queues[i] or self._busy[i]:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    cond.wait(timeout=min(remaining, 0.25))
        return True

    def stop(self, timeout: float = 5.0) -> None:
        """Drain queued work, then stop the workers."""
        self.flush(timeout=timeout)
        for cond in self._conds:
            with cond:
                self._stopped = True
                cond.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)

    # -- observability -----------------------------------------------------
    def queue_depths(self) -> List[int]:
        return [len(q) for q in self._queues]

    def submit_latency_p95_ms(self) -> float:
        lat = sorted(self._submit_ns)
        if not lat:
            return 0.0
        return lat[min(len(lat) - 1, int(len(lat) * 0.95))] / 1e6

    def stats(self) -> Dict:
        return {
            "shards": self.shard_count,
            "max_queue_per_shard": self.max_queue,
            "queue_depths": self.queue_depths(),
            "accepted": list(self._accepted),
            "dropped": list(self._dropped),
            "errors": self._errors,
            "submit_p95_ms": self.submit_latency_p95_ms(),
        }


def update_shard_gauges(store, executor: Optional[ShardIngestExecutor] = None) -> None:
    """Refresh the ``tpud_fleet_shard_*`` gauges at scrape time.

    Cardinality is bounded by the shard count (≤ SHARD_SLOTS, 8 by
    default), never by fleet size — the per-agent detail stays behind
    the paginated operator API, matching the federation contract in
    docs/fleet.md."""
    depths = executor.queue_depths() if executor is not None else None
    for shard in store.shards():
        lbl = {"shard": str(shard.index)}
        _g_shard_records.set(float(shard.records_total), labels=lbl)
        _g_shard_dedupe.set(float(shard.dedupe_keys()), labels=lbl)
        _g_shard_ingest_lag.set(float(shard.ingest_lag), labels=lbl)
        if depths is not None and shard.index < len(depths):
            _g_shard_queue_depth.set(float(depths[shard.index]), labels=lbl)
