"""Shared retention-purge loop.

One pattern for every SQLite-backed store that ages out rows (eventstore,
health-transition ledger, …): a daemon thread that calls a purge callback
at ``retention/5`` cadence (reference: pkg/eventstore/database.go:85-90),
stoppable via ``close()`` so daemon shutdown never leaves a purger running
against a closed DB.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

MIN_INTERVAL = 60.0


class RetentionPurger:
    """Run ``purge_fn`` every ``interval_seconds`` (floored at 60 s).

    With a scheduler (the daemon path), ``start(scheduler)`` registers a
    heap job on the shared pool — no thread. Without one, a named daemon
    thread is spawned (stores opened standalone by the CLI/tests).
    ``start`` is idempotent; ``close`` stops and joins/cancels. A purge
    callback that raises is logged and retried next tick — a transient DB
    error must not end retention for the process's life. (The daemon
    itself goes one step further and consolidates all its purgers into a
    single ``retention-purge`` scheduler job — see server.Server.)"""

    def __init__(
        self, name: str, interval_seconds: float, purge_fn: Callable[[], None]
    ) -> None:
        self.name = name
        self.interval = max(MIN_INTERVAL, float(interval_seconds))
        self._purge_fn = purge_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._job = None

    def purge_once(self) -> None:
        """One purge pass now (what each tick runs) — public so a
        consolidated scheduler job can drive several purgers on one
        cadence without each costing a thread or a job."""
        self._purge_fn()

    def start(self, scheduler=None) -> None:
        if scheduler is not None:
            if self._job is None and self._thread is None:
                # the scheduler traps + counts exceptions itself, matching
                # the legacy loop's log-and-retry contract
                self._job = scheduler.add_job(
                    self.name,
                    self._purge_fn,
                    interval=self.interval,
                    initial_delay=self.interval,
                )
            return
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name=self.name, daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._purge_fn()
            except Exception:  # noqa: BLE001 — retention must outlive one bad tick
                logger.exception("%s purge failed", self.name)

    def close(self) -> None:
        if self._job is not None:
            self._job.cancel()
            self._job = None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
