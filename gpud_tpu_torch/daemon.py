"""The daemon's core, composed without its server.

The port of the persistence, scheduling, check and plane wiring of
``gpud_tpu/server/server.py``: what ``Server.__init__`` builds (:58-333),
how it wires the outbox's producers (:429-538), what ``Server.start``
registers before the scheduler starts (:557-655) and the order in which
``Server.stop`` closes it (:718-770). One state DB, one ``BatchWriter``
shared by the event store, the health ledger, the metrics store, the
remediation audit, the fabric matrix and the outbox journal; the checks as
scheduler jobs, the shared kmsg watcher, the metrics syncer and the
self-metrics recorder, the remediation engine, the predict engine, the
fabric sweep over the GPUs' NVLink ports, the wire codec, the circuit
breaker and the durable outbox, and the consolidated retention and
WAL-checkpoint jobs.

The reference's server also builds an HTTP listener, the session transport
that the outbox replays into, and the chaos, package and update planes;
those are not ported yet, and the port's server will wrap this class.
Until the session is, ``self.session`` stays ``None`` and the replay tick
hands nothing over, as the reference's does with no session. Nothing here
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
from gpud_tpu_torch.fabric import FabricPlane
from gpud_tpu_torch.gpu.instance import new_instance
from gpud_tpu_torch.health_history import HealthLedger
from gpud_tpu_torch.kmsg.syncer import SharedWatcher, Syncer
from gpud_tpu_torch.kmsg.watcher import kmsg_path
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.metadata import Metadata
from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY
from gpud_tpu_torch.metrics.store import MetricsStore, SelfMetricsRecorder
from gpud_tpu_torch.metrics.store import Syncer as MetricsSyncer
from gpud_tpu_torch.predict import PredictEngine
from gpud_tpu_torch.remediation.engine import RemediationEngine
from gpud_tpu_torch.remediation.policy import Policy as RemediationPolicy
from gpud_tpu_torch.scheduler import Scheduler
from gpud_tpu_torch.session import wire as session_wire
from gpud_tpu_torch.session.outbox import CircuitBreaker, SessionOutbox
from gpud_tpu_torch.sqlite import open_rw_ro
from gpud_tpu_torch.storage import BatchWriter, checkpoint_wal
from gpud_tpu_torch.tracing import current_correlation_id

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

        # predictive health: advisory only — warnings annotate states,
        # write dry-run audit rows and publish to the outbox; nothing runs
        self.predictor: Optional[PredictEngine] = None
        if cfg.predict_enabled:
            self.predictor = PredictEngine(
                registry=None,  # attached below once the registry exists
                ledger=self.health_ledger,
                event_store=self.event_store,
                remediation=self.remediation,
                interval_seconds=float(cfg.predict_interval_seconds),
                threshold=float(cfg.predict_threshold),
                hysteresis=float(cfg.predict_hysteresis),
                arm_ticks=cfg.predict_arm_ticks,
                clear_ticks=cfg.predict_clear_ticks,
                window_seconds=float(cfg.predict_window_seconds),
                history_limit=cfg.predict_history_limit,
                warn_cooldown_seconds=float(cfg.predict_warn_cooldown_seconds),
                publish_interval_seconds=float(cfg.predict_publish_interval_seconds),
                calibrate_enabled=bool(cfg.predict_calibrate_enabled),
                calibrate_interval_seconds=float(cfg.predict_calibrate_interval_seconds),
                calibrate_min_history=cfg.predict_calibrate_min_history,
                calibrate_min_threshold=float(cfg.predict_calibrate_min_threshold),
                calibrate_margin=float(cfg.predict_calibrate_margin),
                calibrate_horizon_seconds=float(cfg.predict_calibrate_horizon_seconds),
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

        # the fabric sweep over the GPUs' NVLink ports; built before the
        # outbox so the ici_link producer below can hook it
        self.fabric: Optional[FabricPlane] = None
        if cfg.fabric_sweep_enabled:
            self.fabric = FabricPlane(
                self.db_rw,
                gpu=self.gpu_instance,
                writer=self.storage_writer,
                interval_seconds=float(cfg.fabric_sweep_interval_seconds),
                latency_threshold_z=float(cfg.fabric_sweep_latency_threshold_z),
                ewma_alpha=float(cfg.fabric_sweep_ewma_alpha),
                warmup_sweeps=int(cfg.fabric_sweep_warmup_sweeps),
                retention_seconds=float(cfg.fabric_sweep_retention_seconds),
            )

        # the durable outbox and the control-plane circuit breaker:
        # producers journal here; a replay job drains everything above the
        # manager-acked watermark into the session as batched frames
        self.session = None  # the transport, not ported yet
        self.outbox: Optional[SessionOutbox] = None
        session_wire.configure(compress_min_bytes=cfg.session_wire_compress_min_bytes)
        self.session_circuit = CircuitBreaker(
            failure_threshold=cfg.session_circuit_failure_threshold,
            open_seconds=float(cfg.session_circuit_open_seconds),
        )
        if cfg.outbox_enabled:
            self.outbox = SessionOutbox(
                self.db_rw,
                writer=self.storage_writer,
                max_rows=cfg.outbox_max_rows,
                max_age_seconds=float(cfg.outbox_max_age_seconds),
                replay_batch=cfg.outbox_replay_batch,
                keyframe_interval=cfg.session_wire_keyframe_interval,
                redeliver_after_seconds=float(cfg.outbox_redeliver_seconds),
            )
            self._wire_outbox_producers()

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
        if self.predictor is not None:
            self.predictor.registry = self.registry
            # fabric deviations corroborate the NVLink component's score
            if self.fabric is not None:
                self.predictor.fabric = self.fabric

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

    # -- the outbox's producers ------------------------------------------------
    def _wire_outbox_producers(self) -> None:
        """Journal every producer the manager reads: events, health
        transitions, remediation audit rows, predict scores and fabric
        links, with the reference's kinds and dedupe keys (each record's
        natural identity, so the manager collapses redeliveries). Event
        and transition hooks fire on the check's thread, so its
        correlation id rides the record."""
        outbox = self.outbox

        def on_event(component: str, ev) -> None:
            body = {
                "component": component,
                "time": ev.time,
                "name": ev.name,
                "type": ev.type,
                "message": ev.message,
            }
            cid = current_correlation_id()
            if cid:
                body["correlation_id"] = cid
            outbox.publish("event", body, dedupe_key=f"event:{component}:{ev.time}:{ev.name}")

        def on_transition(component: str, from_state: str, to_state: str,
                          ts: float, reason: str) -> None:
            body = {"component": component, "from": from_state, "to": to_state,
                    "ts": ts, "reason": reason}
            cid = current_correlation_id()
            if cid:
                body["correlation_id"] = cid
            outbox.publish("transition", body,
                           dedupe_key=f"transition:{component}:{ts}:{to_state}")

        def on_audit(row: dict) -> None:
            outbox.publish(
                "remediation_audit", row,
                dedupe_key=f"audit:{row.get('component')}:{row.get('ts')}:{row.get('action')}",
            )

        def on_predict(body: dict) -> None:
            outbox.publish(
                "predict_score", body,
                dedupe_key=f"predict:{body.get('component')}:{body.get('event')}:{body.get('ts')}",
            )

        def on_ici_link(body: dict) -> None:
            outbox.publish("ici_link", body,
                           dedupe_key=f"ici_link:{body.get('link')}:{body.get('ts')}")

        self.event_store.on_insert = on_event
        self.health_ledger.on_transition = on_transition
        if self.remediation is not None:
            self.remediation.audit.on_record = on_audit
        if self.predictor is not None:
            self.predictor.on_publish = on_predict
        if self.fabric is not None:
            self.fabric.on_publish = on_ici_link

    def _outbox_replay_tick(self) -> int:
        """Job "session-outbox-replay": one batch of unacked records into
        the session; 0 while there is none, disconnected or caught up."""
        if self.outbox is None:
            return 0
        return self.outbox.replay_once(self.session)

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
        if self.outbox is not None:
            self._retention_targets.append(("session-outbox", self.outbox.purge_once))
        if self.fabric is not None:
            self._retention_targets.append(("fabric-matrix", self.fabric.purge_once))
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
        if self.outbox is not None:
            interval = float(self.config.outbox_replay_interval_seconds)
            self.scheduler.add_job(
                "session-outbox-replay",
                self._outbox_replay_tick,
                interval=interval,
                initial_delay=interval,
            )
        if self.remediation is not None:
            self.remediation.start(self.scheduler)
        if self.predictor is not None:
            self.predictor.start(self.scheduler)
        if self.fabric is not None:
            self.fabric.start(self.scheduler)
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
        if self.predictor is not None:
            self.predictor.close()
        if self.fabric is not None:
            self.fabric.close()
        self.scheduler.close()
        self.health_ledger.close()
        self.event_store.close()
        if self.storage_writer is not None:
            self.storage_writer.close()
        self.db_ro.close()
        self.db_rw.close()
