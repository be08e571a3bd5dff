"""Deadline-heap scheduler + bounded worker pool; the port of
``gpud_tpu/scheduler/core.py``.

One scheduler thread owns a min-heap of (due, job) deadlines for every
periodic job in the daemon — component polls, the metrics scraper and
recorder, retention purges, the remediation scan, the update watcher —
and dispatches due jobs to a small fixed pool of worker threads (default
4). This replaces the one-thread-per-poller shape the Go reference gets
for free from goroutines: in CPython each poller thread costs a stack
plus periodic GIL wakeups, and the count grows linearly with every new
component (BENCH_r05 measured ~26 steady-state threads).

Semantics preserved from the per-thread pollers:

- ``poke(name)`` jumps a job to the front of the heap (or re-runs it
  immediately after the in-flight run finishes);
- the job's interval callable is re-read after EVERY run, so adaptive
  cadences (the NVLink component's fast-poll-on-suspicion window) keep
  working;
- first runs happen on the pool, never on the caller of ``start()`` — a
  hung data source cannot wedge daemon startup, and first checks run in
  parallel across the pool instead of 26 sequential-ish thread spawns;
- a job never overlaps itself: the next deadline is computed only after
  the current run returns.

New capabilities per-thread pollers could not have:

- deterministic ±jitter per cadence (keyed on the job name, stable
  across restarts) de-synchronizes the 60s thundering herd;
- a watchdog: a job running past its hang budget fires ``on_hang`` (the
  component marks itself Degraded-stale), the wedged worker thread is
  abandoned as a sacrificial thread, and a replacement worker is spawned
  so the pool keeps draining at full capacity;
- scheduler self-metrics: ready-queue depth, dispatch-lag histogram,
  pool saturation, watchdog fires, startup readiness
  (``tpud_scheduler_*``, docs/observability.md).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional

from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metrics.registry import counter, gauge, histogram

logger = get_logger(__name__)

DEFAULT_WORKERS = 4
DEFAULT_HANG_TIMEOUT = 120.0   # a 60s-cadence check running 2 min is wedged
DEFAULT_JITTER_FRACTION = 0.05  # ±5% of the interval
_LAG_SAMPLES = 512              # ring of recent dispatch lags for stats()

_g_jobs = gauge(
    "tpud_scheduler_jobs", "periodic jobs currently registered"
)
_g_queue_depth = gauge(
    "tpud_scheduler_ready_queue_depth",
    "jobs dispatched and waiting for a free worker",
)
_g_workers = gauge(
    "tpud_scheduler_workers", "worker threads in the pool (grows by one "
    "per sacrificial thread while a hung job is in flight)"
)
_g_workers_busy = gauge(
    "tpud_scheduler_workers_busy", "worker threads currently running a job"
)
_g_startup_ready = gauge(
    "tpud_scheduler_startup_ready_seconds",
    "time from scheduler start to every initial job's first completed run",
)
_h_dispatch_lag = histogram(
    "tpud_scheduler_dispatch_lag_seconds",
    "delay between a job's deadline and a worker picking it up",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
)
_c_runs = counter(
    "tpud_scheduler_job_runs_total", "completed job runs, by job"
)
_c_failures = counter(
    "tpud_scheduler_job_failures_total",
    "job runs that raised, by job (the run is rescheduled regardless)",
)
_c_watchdog = counter(
    "tpud_scheduler_watchdog_fires_total",
    "watchdog fires (job exceeded its hang budget), by job",
)
_c_saturation = counter(
    "tpud_scheduler_pool_saturation_total",
    "dispatches that found every worker busy (job had to queue)",
)


class Job:
    """One periodic (or one-shot) unit of scheduled work.

    ``interval_fn`` is consulted after every completed run, so adaptive
    cadences take effect on the very next deadline. ``hang_timeout``
    seconds of a single run elapsing fires ``on_hang(elapsed)`` once and
    sacrifices the worker; 0 disables the watchdog for this job.
    """

    __slots__ = (
        "name", "fn", "interval_fn", "on_hang", "hang_timeout", "one_shot",
        "jitter_fraction",
        # scheduler-owned state (all mutated under the scheduler lock,
        # except run_started/runs reads for stats which tolerate tearing)
        "gen", "due", "queued", "running", "run_started", "runs", "failures",
        "poked", "cancelled", "hang_fired", "worker", "startup", "_sched",
    )

    def __init__(
        self,
        name: str,
        fn: Callable[[], None],
        interval_fn: Callable[[], float],
        on_hang: Optional[Callable[[float], None]] = None,
        hang_timeout: float = DEFAULT_HANG_TIMEOUT,
        one_shot: bool = False,
        jitter_fraction: Optional[float] = None,
    ) -> None:
        self.name = name
        self.fn = fn
        self.interval_fn = interval_fn
        self.on_hang = on_hang
        self.hang_timeout = hang_timeout
        self.one_shot = one_shot
        self.jitter_fraction = jitter_fraction
        self.gen = 0
        self.due = 0.0
        self.queued = False
        self.running = False
        self.run_started = 0.0
        self.runs = 0
        self.failures = 0
        self.poked = False
        self.cancelled = False
        self.hang_fired = False
        self.startup = False  # counts toward startup readiness (see add_job)
        self.worker: Optional[threading.Thread] = None
        self._sched: Optional["Scheduler"] = None

    def cancel(self) -> None:
        if self._sched is not None:
            self._sched.cancel(self.name)

    def poke(self) -> None:
        if self._sched is not None:
            self._sched.poke(self.name)


class Scheduler:
    """The deadline-heap scheduler (see module docstring).

    Lifecycle: construct → ``add_job`` (any time) → ``start`` → ``close``.
    Jobs added before ``start`` form the startup-readiness set: once each
    has completed its first run, ``startup_ready_seconds`` is recorded and
    ``wait_first_runs`` returns. All public methods are thread-safe.
    """

    # _cv wraps _mu (RLock), so `with self._cv` IS the mutex; _thread is
    # written once under start() and joined in close() after _stopped
    # flips — deliberately unguarded, as are the itertools counters
    # (_seq/_worker_seq are internally thread-safe)
    GUARDED_BY = {
        "_heap": "_cv",
        "_jobs": "_cv",
        "_ready": "_cv",
        "_workers": "_cv",
        "_abandoned": "_cv",
        "_busy": "_cv",
        "_stopped": "_cv",
        "_started": "_cv",
        "_startup_pending": "_cv",
        "_startup_t0": "_cv",
        "_startup_ready_seconds": "_cv",
        "_lag_samples": "_cv",
    }
    _LOCK_FREE = {
        "_push": "internal heap insert; every caller (add_job, submit, "
                 "poke, _run) already holds _cv",
        "_startup_discard": "internal readiness bookkeeping; callers "
                            "cancel()/_run hold _cv",
        "_check_watchdogs": "called only from _run's scan, under _cv",
    }

    def __init__(
        self,
        workers: int = DEFAULT_WORKERS,
        hang_timeout: float = DEFAULT_HANG_TIMEOUT,
        jitter_fraction: float = DEFAULT_JITTER_FRACTION,
    ) -> None:
        self.default_hang_timeout = float(hang_timeout)
        self.jitter_fraction = float(jitter_fraction)
        self._target_workers = max(1, int(workers))
        self._mu = threading.RLock()
        self._cv = threading.Condition(self._mu)
        self._heap: List[tuple] = []  # (due, seq, gen, job)
        self._seq = itertools.count()
        self._jobs: Dict[str, Job] = {}
        self._ready: deque = deque()
        self._workers: List[threading.Thread] = []
        self._abandoned: set = set()
        self._busy = 0
        self._stopped = False
        self._started = False
        self._thread: Optional[threading.Thread] = None
        self._worker_seq = itertools.count()
        self._lag_samples: deque = deque(maxlen=_LAG_SAMPLES)
        self._startup_pending: Optional[set] = None
        self._startup_t0 = 0.0
        self._startup_ready_seconds: Optional[float] = None
        self.time_fn: Callable[[], float] = time.monotonic

    # -- job management ----------------------------------------------------
    def add_job(
        self,
        name: str,
        fn: Callable[[], None],
        interval: Optional[float] = None,
        interval_fn: Optional[Callable[[], float]] = None,
        initial_delay: float = 0.0,
        on_hang: Optional[Callable[[float], None]] = None,
        hang_timeout: Optional[float] = None,
        jitter: bool = True,
    ) -> Job:
        """Register a periodic job. Exactly one of ``interval`` /
        ``interval_fn`` must be given; the callable form is re-read after
        every run (adaptive cadences). ``initial_delay=0`` puts the first
        run at the front of the heap immediately — the startup-readiness
        path."""
        if (interval is None) == (interval_fn is None):
            raise ValueError(f"job {name}: give interval OR interval_fn")
        ifn = interval_fn if interval_fn is not None else (lambda: float(interval))
        job = Job(
            name,
            fn,
            ifn,
            on_hang=on_hang,
            hang_timeout=(
                self.default_hang_timeout if hang_timeout is None
                else float(hang_timeout)
            ),
            jitter_fraction=None if jitter else 0.0,
        )
        # only jobs whose first run is immediate belong to the startup
        # readiness set — a deferred first run (initial_delay=interval,
        # e.g. the metrics scraper skipping the noisy boot sample) is a
        # deliberate "not needed for readiness" statement
        job.startup = initial_delay <= 0.0
        with self._cv:
            if name in self._jobs:
                raise ValueError(f"job already scheduled: {name}")
            job._sched = self
            self._jobs[name] = job
            self._push(job, self.time_fn() + max(0.0, initial_delay))
            _g_jobs.set(len(self._jobs))
            self._cv.notify_all()
        return job

    def submit(
        self,
        name: str,
        fn: Callable[[], None],
        hang_timeout: Optional[float] = None,
    ) -> Optional[Job]:
        """One-shot: run ``fn`` on the pool as soon as a worker frees up.
        Used for event-triggered async work (session gossip/diagnostic
        collection) so ad-hoc daemon threads stop accumulating. Returns
        None (work refused) after close(). A name collision with a live
        job gets a unique suffix — one-shots are fire-and-forget."""
        with self._cv:
            if self._stopped:
                return None
            if name in self._jobs:
                name = f"{name}#{next(self._seq)}"
            job = Job(
                name,
                fn,
                lambda: 0.0,
                hang_timeout=(
                    self.default_hang_timeout if hang_timeout is None
                    else float(hang_timeout)
                ),
                one_shot=True,
            )
            job._sched = self
            self._jobs[name] = job
            self._push(job, self.time_fn())
            _g_jobs.set(len(self._jobs))
            self._cv.notify_all()
        return job

    def cancel(self, name: str) -> bool:
        with self._cv:
            job = self._jobs.pop(name, None)
            if job is None:
                return False
            job.cancelled = True
            if job.queued:
                try:
                    self._ready.remove(job)
                except ValueError:
                    pass
                job.queued = False
                _g_queue_depth.set(len(self._ready))
            self._startup_discard(job)
            _g_jobs.set(len(self._jobs))
            self._cv.notify_all()
        return True

    def poke(self, name: str) -> bool:
        """Jump a job to the front: run it now if idle, or immediately
        again after the in-flight run finishes."""
        with self._cv:
            job = self._jobs.get(name)
            if job is None:
                return False
            if job.running or job.queued:
                job.poked = True
            else:
                self._push(job, self.time_fn())
            self._cv.notify_all()
        return True

    def get_job(self, name: str) -> Optional[Job]:
        with self._cv:
            return self._jobs.get(name)

    def job_names(self) -> List[str]:
        with self._cv:
            return sorted(self._jobs)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        with self._cv:
            if self._started or self._stopped:
                return
            self._started = True
            self._startup_t0 = self.time_fn()
            self._startup_pending = {
                j.name for j in self._jobs.values()
                if j.startup and j.runs == 0
            }
            if not self._startup_pending:
                self._startup_done_locked()
            for _ in range(self._target_workers):
                self._spawn_worker_locked()
            self._thread = threading.Thread(
                target=self._run, name="tpud-scheduler", daemon=True
            )
            self._thread.start()

    def close(self) -> None:
        with self._cv:
            if self._stopped:
                return
            self._stopped = True
            self._cv.notify_all()
            workers = list(self._workers)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        for w in workers:
            if w is not threading.current_thread():
                w.join(timeout=2.0)  # wedged sacrificial threads are daemons

    # -- readiness ---------------------------------------------------------
    def wait_first_runs(self, timeout: float = 30.0) -> Optional[float]:
        """Block until every job registered before ``start()`` has
        completed its first run; returns the elapsed startup-readiness
        seconds, or None on timeout/close."""
        with self._cv:
            self._cv.wait_for(
                lambda: self._startup_ready_seconds is not None or self._stopped,
                timeout,
            )
            return self._startup_ready_seconds

    @property
    def startup_ready_seconds(self) -> Optional[float]:
        with self._cv:
            return self._startup_ready_seconds

    # -- introspection -----------------------------------------------------
    def stats(self) -> Dict:
        with self._cv:
            lags = sorted(self._lag_samples)
            p95 = lags[int(0.95 * (len(lags) - 1))] if lags else 0.0
            return {
                "jobs": len(self._jobs),
                "ready_queue_depth": len(self._ready),
                "workers": len(self._workers),
                "workers_busy": self._busy,
                "dispatch_lag_p95_seconds": p95,
                "startup_ready_seconds": self._startup_ready_seconds,
                "running": sorted(
                    j.name for j in self._jobs.values() if j.running
                ),
            }

    # -- internals (all called under self._cv unless noted) ----------------
    def _push(self, job: Job, due: float) -> None:
        job.gen += 1
        job.due = due
        heapq.heappush(self._heap, (due, next(self._seq), job.gen, job))

    def _jittered(self, job: Job, interval: float) -> float:
        """Deterministic per-job cadence offset: crc32 of the name maps to
        a stable fraction in [-1, 1], scaled by the jitter fraction — the
        fleet's 60s pollers spread out instead of herding, identically
        across restarts (no RNG: a flappy cadence would defeat dashboards
        that align on scrape phase)."""
        frac = job.jitter_fraction
        if frac is None:
            frac = self.jitter_fraction
        if interval <= 0 or frac <= 0:
            return max(0.0, interval)
        unit = (zlib.crc32(job.name.encode()) % 2001 - 1000) / 1000.0
        return max(0.0, interval * (1.0 + frac * unit))

    def _startup_discard(self, job: Job) -> None:
        if self._startup_pending is None:
            return
        self._startup_pending.discard(job.name)
        if not self._startup_pending:
            self._startup_done_locked()

    def _startup_done_locked(self) -> None:
        if self._startup_ready_seconds is None:
            self._startup_pending = set()
            self._startup_ready_seconds = max(
                0.0, self.time_fn() - self._startup_t0
            )
            _g_startup_ready.set(self._startup_ready_seconds)
            self._cv.notify_all()

    def _spawn_worker_locked(self) -> None:
        t = threading.Thread(
            target=self._worker,
            name=f"tpud-sched-worker-{next(self._worker_seq)}",
            daemon=True,
        )
        self._workers.append(t)
        _g_workers.set(len(self._workers))
        t.start()

    # -- scheduler thread --------------------------------------------------
    def _run(self) -> None:
        while True:
            hang_cbs = []
            with self._cv:
                if self._stopped:
                    return
                now = self.time_fn()
                next_wd = self._check_watchdogs(now, hang_cbs)
                while self._heap and self._heap[0][0] <= now:
                    _due, _seq, gen, job = heapq.heappop(self._heap)
                    if (
                        job.cancelled or gen != job.gen
                        or job.queued or job.running
                    ):
                        continue  # stale heap entry (poked/cancelled/rescheduled)
                    job.queued = True
                    # saturation = this job cannot start immediately: every
                    # worker is either busy or spoken for by jobs already
                    # queued ahead of it (at dispatch time workers may not
                    # have woken yet, so _busy alone undercounts)
                    if self._busy + len(self._ready) >= len(self._workers):
                        _c_saturation.inc()
                    self._ready.append(job)
                    _g_queue_depth.set(len(self._ready))
                    self._cv.notify_all()
                timeout = None
                if self._heap:
                    timeout = self._heap[0][0] - now
                if next_wd is not None:
                    wd_in = next_wd - now
                    timeout = wd_in if timeout is None else min(timeout, wd_in)
                if timeout is None:
                    timeout = 5.0
                # cap: a poke/add lands via notify, but a clamped wait
                # bounds the damage of any missed-wakeup bug; 5s keeps the
                # idle wakeup cost negligible (vs 26 threads × cadence).
                # Skip the wait entirely when a watchdog just fired — its
                # callback must run NOW, not after the next wakeup.
                if not hang_cbs:
                    self._cv.wait(min(max(timeout, 0.0), 5.0))
            for cb, name, elapsed in hang_cbs:
                try:
                    cb(elapsed)
                except Exception:  # noqa: BLE001 — a stale-marker bug must
                    logger.exception("on_hang for %s failed", name)  # not kill the loop

    def _check_watchdogs(self, now: float, hang_cbs: list) -> Optional[float]:
        """Fire due watchdogs; returns the next watchdog deadline."""
        next_wd = None
        for job in self._jobs.values():
            if not job.running or job.hang_fired or job.hang_timeout <= 0:
                continue
            deadline = job.run_started + job.hang_timeout
            if deadline <= now:
                job.hang_fired = True
                elapsed = now - job.run_started
                _c_watchdog.inc(labels={"job": job.name})
                logger.warning(
                    "watchdog: job %s running %.1fs (budget %.1fs); "
                    "sacrificing its worker and reclaiming the slot",
                    job.name, elapsed, job.hang_timeout,
                )
                if job.worker is not None:
                    self._abandoned.add(job.worker)
                    self._spawn_worker_locked()
                if job.on_hang is not None:
                    hang_cbs.append((job.on_hang, job.name, elapsed))
            elif next_wd is None or deadline < next_wd:
                next_wd = deadline
        return next_wd

    # -- worker threads ----------------------------------------------------
    def _worker(self) -> None:
        me = threading.current_thread()
        while True:
            with self._cv:
                while not self._ready and not self._stopped:
                    if me in self._abandoned:
                        break
                    self._cv.wait()
                if self._stopped or (me in self._abandoned and not self._ready):
                    self._retire_locked(me)
                    return
                job = self._ready.popleft()
                _g_queue_depth.set(len(self._ready))
                job.queued = False
                job.running = True
                job.hang_fired = False
                job.worker = me
                job.run_started = self.time_fn()
                if job.hang_timeout > 0:
                    # the scheduler may be mid-wait with no watchdog armed;
                    # wake it so it recomputes its sleep against this run's
                    # hang deadline (else a short budget fires only at the
                    # next periodic wakeup)
                    self._cv.notify_all()
                lag = max(0.0, job.run_started - job.due)
                _h_dispatch_lag.observe(lag)
                self._lag_samples.append(lag)
                self._busy += 1
                _g_workers_busy.set(self._busy)
            try:
                job.fn()
            except Exception:  # noqa: BLE001 — a failing job is rescheduled
                job.failures += 1
                _c_failures.inc(labels={"job": job.name})
                logger.exception("scheduled job %s failed", job.name)
            _c_runs.inc(labels={"job": job.name})
            with self._cv:
                self._finish_locked(job)
                if me in self._abandoned:
                    # sacrificial thread: the pool already got a
                    # replacement the moment the watchdog fired; this
                    # thread's only remaining duty was to reschedule the
                    # formerly-hung job, done above
                    self._retire_locked(me)
                    return
                if self._stopped:
                    self._retire_locked(me)
                    return

    def _retire_locked(self, me: threading.Thread) -> None:
        self._abandoned.discard(me)
        try:
            self._workers.remove(me)
        except ValueError:
            pass
        _g_workers.set(len(self._workers))

    def _finish_locked(self, job: Job) -> None:
        job.running = False
        job.worker = None
        job.runs += 1
        self._busy -= 1
        _g_workers_busy.set(self._busy)
        self._startup_discard(job)
        if job.one_shot or job.cancelled:
            if self._jobs.get(job.name) is job:
                del self._jobs[job.name]
            _g_jobs.set(len(self._jobs))
            self._cv.notify_all()
            return
        now = self.time_fn()
        if job.poked:
            job.poked = False
            due = now
        else:
            try:
                interval = float(job.interval_fn())  # re-read: adaptive
            except Exception:  # noqa: BLE001
                logger.exception("interval_fn for %s failed", job.name)
                interval = 60.0
            due = now + self._jittered(job, interval)
        self._push(job, due)
        self._cv.notify_all()
