"""The daemon's core, composed without its server.

The port of the persistence, scheduling and check wiring of
``gpud_tpu/server/server.py``: what ``Server.__init__`` builds (:58-130,
:183-199, :280-340), what ``Server.start`` registers before the scheduler
starts (:557-655) and the order in which ``Server.stop`` closes it
(:718-770). One state DB, one ``BatchWriter`` shared by the event store,
the health ledger, the metrics store and the remediation audit, the checks
as scheduler jobs, the shared kmsg watcher, the metrics syncer and the
self-metrics recorder, the remediation engine, and the consolidated
retention and WAL-checkpoint jobs.

The reference's server also builds an HTTP listener, the session and its
outbox, and the predict, fabric, chaos, package and update planes; those are
not ported yet, and the port's server will wrap this class. Nothing here
imports torch: the anomaly check scores with numpy unless the process
already holds a CUDA context.
"""

from __future__ import annotations

from typing import Optional

from gpud_tpu_torch import host as pkghost
from gpud_tpu_torch import sdnotify
from gpud_tpu_torch.components.all import all_components
from gpud_tpu_torch.components.base import FailureInjector, Registry, TpudInstance
from gpud_tpu_torch.components.cpu import match_cpu_lockup
from gpud_tpu_torch.components.disk import match_disk_error
from gpud_tpu_torch.components.gpu.error_kmsg import GPUErrorKmsgComponent
from gpud_tpu_torch.components.memory import match_oom
from gpud_tpu_torch.components.os_comp import match_kernel_panic
from gpud_tpu_torch.config import Config, default_config
from gpud_tpu_torch.eventstore import EventStore
from gpud_tpu_torch.gpu.instance import new_instance
from gpud_tpu_torch.health_history import HealthLedger
from gpud_tpu_torch.kmsg.syncer import SharedWatcher, Syncer
from gpud_tpu_torch.kmsg.watcher import kmsg_path
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metadata import Metadata
from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY
from gpud_tpu_torch.metrics.store import MetricsStore, SelfMetricsRecorder
from gpud_tpu_torch.metrics.store import Syncer as MetricsSyncer
from gpud_tpu_torch.remediation.engine import RemediationEngine
from gpud_tpu_torch.remediation.policy import Policy as RemediationPolicy
from gpud_tpu_torch.scheduler import Scheduler
from gpud_tpu_torch.sqlite import open_rw_ro
from gpud_tpu_torch.storage import BatchWriter, checkpoint_wal

logger = get_logger(__name__)


class Daemon:
    """Lifecycle: construct → ``start`` → ``stop``, as the reference's
    ``Server`` (without ``serve``). Every check whose component is
    supported on this host becomes a scheduler job at ``start``."""

    def __init__(
        self,
        config: Optional[Config] = None,
        failure_injector: Optional[FailureInjector] = None,
        metrics_registry=None,
    ) -> None:
        self.config = config or default_config()
        err = self.config.validate()
        if err:
            raise ValueError(err)
        cfg = self.config

        self.db_rw, self.db_ro = open_rw_ro(cfg.state_file())
        self.metadata = Metadata(self.db_rw)
        # one group-commit path for every store, built before any store
        self.storage_writer: Optional[BatchWriter] = None
        if cfg.storage_batch_enabled:
            self.storage_writer = BatchWriter(
                self.db_rw,
                flush_interval_seconds=cfg.storage_batch_flush_interval_seconds,
                max_pending=cfg.storage_batch_max_pending,
                flush_threshold=cfg.storage_batch_flush_threshold,
                backpressure_seconds=cfg.storage_batch_backpressure_seconds,
                fsync=cfg.storage_batch_fsync,
            )
        self.event_store = EventStore(
            self.db_rw,
            retention_seconds=cfg.events_retention_seconds,
            writer=self.storage_writer,
        )
        self.reboot_event_store = pkghost.RebootEventStore(self.event_store)
        self.reboot_event_store.record_reboot()
        self.health_ledger = HealthLedger(
            self.db_rw,
            event_store=self.event_store,
            retention_seconds=cfg.events_retention_seconds,
            flap_threshold=cfg.health_flap_threshold,
            flap_window_seconds=cfg.health_flap_window_seconds,
            availability_window_seconds=cfg.health_availability_window_seconds,
            writer=self.storage_writer,
        )
        self.machine_id = (
            cfg.machine_id or self.metadata.machine_id() or pkghost.machine_id()
        )
        self.remediation: Optional[RemediationEngine] = None
        if cfg.remediation_enabled:
            self.remediation = RemediationEngine(
                registry=None,  # attached below once the registry exists
                db=self.db_rw,
                policy=RemediationPolicy(
                    enforce_actions=list(cfg.remediation_enforce_actions),
                    cooldown_seconds=float(cfg.remediation_cooldown_seconds),
                    rate_capacity=cfg.remediation_rate_capacity,
                    rate_refill_seconds=float(cfg.remediation_rate_refill_seconds),
                    max_reboots=cfg.remediation_max_reboots,
                    reboot_window_seconds=float(cfg.remediation_reboot_window_seconds),
                    escalation_threshold=cfg.remediation_escalation_threshold,
                    escalation_window_seconds=float(
                        cfg.remediation_escalation_window_seconds
                    ),
                ),
                event_store=self.event_store,
                reboot_event_store=self.reboot_event_store,
                interval_seconds=float(cfg.remediation_interval_seconds),
                audit_retention_seconds=cfg.events_retention_seconds,
                runtime_unit=cfg.remediation_runtime_unit,
                writer=self.storage_writer,
            )

        self.metrics_registry = metrics_registry or DEFAULT_REGISTRY
        self.metrics_store = MetricsStore(
            self.db_rw,
            retention_seconds=cfg.metrics_retention_seconds,
            writer=self.storage_writer,
        )
        self.metrics_syncer = MetricsSyncer(
            self.metrics_registry,
            self.metrics_store,
            interval_seconds=cfg.scrape_interval_seconds,
        )
        self.self_metrics = SelfMetricsRecorder(self.metrics_registry, self.db_rw)

        self.kmsg_path = kmsg_path(cfg.kmsg_path)
        self.gpu_instance = new_instance(
            failure_injector=failure_injector,
            accelerator_type=cfg.accelerator_type_override,
        )
        self.scheduler = Scheduler(
            workers=cfg.scheduler_workers,
            hang_timeout=float(cfg.scheduler_watchdog_seconds),
            jitter_fraction=cfg.scheduler_jitter_fraction,
        )
        self.instance = TpudInstance(
            machine_id=self.machine_id,
            gpu_instance=self.gpu_instance,
            db_rw=self.db_rw,
            db_ro=self.db_ro,
            event_store=self.event_store,
            reboot_event_store=self.reboot_event_store,
            mount_points=list(cfg.mount_points),
            mount_targets=list(cfg.mount_targets),
            kernel_modules_to_check=list(cfg.kernel_modules_to_check),
            kmsg_path=self.kmsg_path,
            failure_injector=failure_injector,
            config=cfg,
            health_ledger=self.health_ledger,
            scheduler=self.scheduler,
        )
        self.registry = Registry(self.instance)
        enabled = set(cfg.components_enabled)
        disabled = set(cfg.components_disabled)
        for init_func in all_components():
            name = getattr(init_func, "NAME", "")
            if enabled and name not in enabled:
                continue
            if name in disabled:
                continue
            self.registry.must_register(init_func)
        if self.remediation is not None:
            # the engine scans (and its soft executors act through) the
            # fully-populated registry
            self.remediation.registry = self.registry
            self.remediation.executors.registry = self.registry

        # one kmsg reader feeding every kmsg-consuming component
        self.kmsg_watcher = SharedWatcher(path=self.kmsg_path, from_now=True)
        self._wire_kmsg_syncers()
        self.supported_names = {
            c.name() for c in self.registry.all() if c.is_supported()
        }
        self._retention_targets = []
        self._started = False

    def _wire_kmsg_syncers(self) -> None:
        for comp_name, match_fn in (
            ("cpu", match_cpu_lockup),
            ("disk", match_disk_error),
            ("memory", match_oom),
            ("os", match_kernel_panic),
        ):
            self.kmsg_watcher.register(
                Syncer(match_fn, self.event_store.bucket(comp_name))
            )
        err_comp = self.registry.get(GPUErrorKmsgComponent.NAME)
        if err_comp is not None and err_comp.syncer is not None:
            self.kmsg_watcher.register(err_comp.syncer)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Register every periodic job, then start the scheduler: jobs known
        at start form the startup-readiness set, and their first runs go to
        the pool in parallel. Idempotent."""
        if self._started:
            return
        self._started = True
        for comp in self.registry.all():
            if comp.name() in self.supported_names:
                comp.start()
        self.kmsg_watcher.start()
        # one retention job over every store; each store's pass is
        # independent, so one failing table does not starve the others
        self._retention_targets = [
            ("events", self.event_store.purge_once),
            ("health", self.health_ledger.purge_once),
        ]
        if self.remediation is not None:
            self._retention_targets.append(
                ("remediation-audit", self.remediation.audit.purge_once)
            )
        retention_interval = max(60.0, self.config.events_retention_seconds / 5.0)
        self.scheduler.add_job(
            "retention-purge",
            self._purge_retention,
            interval=retention_interval,
            initial_delay=retention_interval,
        )
        if self.storage_writer is not None:
            self.storage_writer.start(self.scheduler)
            if (
                not self.config.db_in_memory
                and self.config.storage_wal_checkpoint_seconds > 0
            ):
                interval = float(self.config.storage_wal_checkpoint_seconds)
                self.scheduler.add_job(
                    "wal-checkpoint",
                    lambda: checkpoint_wal(self.db_rw, self.storage_writer),
                    interval=interval,
                    initial_delay=interval,
                )
        if self.remediation is not None:
            self.remediation.start(self.scheduler)
        self.metrics_syncer.start(self.scheduler)
        self.self_metrics.start(self.scheduler)
        self.scheduler.start()
        sdnotify.ready()

    def _purge_retention(self) -> None:
        for name, purge in self._retention_targets:
            try:
                purge()
            except Exception:  # noqa: BLE001 — one table must not starve the rest
                logger.exception("retention purge failed for %s", name)

    def stop(self) -> None:
        """The reference's shutdown order, then the DB handles: the writer
        commits last of all, since every closer above may emit final rows."""
        sdnotify.stopping()
        self.metrics_syncer.close()
        self.self_metrics.close()
        self.kmsg_watcher.close()
        for comp in self.registry.all():
            try:
                comp.close()
            except Exception:  # noqa: BLE001
                logger.exception("component %s close failed", comp.name())
        if self.remediation is not None:
            self.remediation.close()
        self.scheduler.close()
        self.health_ledger.close()
        self.event_store.close()
        if self.storage_writer is not None:
            self.storage_writer.close()
        self.db_ro.close()
        self.db_rw.close()
