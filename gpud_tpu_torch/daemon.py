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

Since the session transport was ported, it also builds what the
reference's ``Server`` builds around its session: the custom plugins
(:340-366), the package manager (:368-370), the update watcher (:372-379),
the session state (:381-390); at ``start`` it re-applies the persisted
config overrides (:788-792), opens the control-plane session when an
endpoint and a token are known (:799-977, with the dispatcher, the
credential pairing, the circuit breaker's peers and the outbox's replay on
every connect) and watches the token FIFO (:1025-1193); ``stop`` closes
the session under its lock (:723-738). It builds the chaos campaign
runner when ``chaos_enabled`` is set (:209-221), publishes each campaign's
result through the outbox (:491-501, :524-525) and closes it on ``stop``
before the scheduler drains (:758-761). ``gpud_tpu_torch.server.server.
Server`` adds the HTTP listener (:683-716).
Nothing here imports torch: the anomaly check scores with numpy unless the
process already holds a CUDA context.
"""

from __future__ import annotations

import os
import stat
import threading
import time
from typing import Optional

# The daemon's numpy scores one host's window (8 GPUs x 180 samples x 7
# features); OpenBLAS's pool of a thread per core buys it nothing and costs
# each thread's stack and buffer on every host (12.7 MB of VmRSS on the
# H100 machine's 8 cores, ROADMAP C3). Set before numpy loads; a process
# that chose its own count, or loaded numpy first, keeps what it has.
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

from gpud_tpu_torch import host as pkghost  # noqa: E402 — after the BLAS default
from gpud_tpu_torch import metadata as md
from gpud_tpu_torch import sdnotify
from gpud_tpu_torch.api.v1.types import Event, EventType
from gpud_tpu_torch.chaos import ChaosManager
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
from gpud_tpu_torch.fault_injector import Injector
from gpud_tpu_torch.gpu.instance import new_instance
from gpud_tpu_torch.health_history import HealthLedger
from gpud_tpu_torch.kmsg.syncer import SharedWatcher, Syncer
from gpud_tpu_torch.kmsg.watcher import kmsg_path
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.manager.packages import PackageManager
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
from gpud_tpu_torch.tracing import DEFAULT_TRACER, current_correlation_id
from gpud_tpu_torch.update import VersionFileWatcher
from gpud_tpu_torch.version import __version__

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
        self.version = __version__
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

        self.tracer = DEFAULT_TRACER
        self.kmsg_path = kmsg_path(cfg.kmsg_path)
        # the session's injectFault writes through this (server.py:203)
        self.fault_injector = Injector(kmsg_path=self.kmsg_path)
        self.gpu_instance = new_instance(
            failure_injector=failure_injector,
            accelerator_type=cfg.accelerator_type_override,
        )

        # the chaos campaign runner (docs/chaos.md): loads declarative
        # scenarios and runs them against this live daemon; running one
        # always takes an explicit API, session or CLI call
        self.chaos: Optional[ChaosManager] = None
        if cfg.chaos_enabled:
            self.chaos = ChaosManager(
                self,
                history_limit=cfg.chaos_history_limit,
                max_campaign_seconds=float(cfg.chaos_max_campaign_seconds),
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
        self._load_plugins()

        # the package manager and the auto-update watcher
        self.package_manager = PackageManager(cfg.packages_dir())
        self.update_watcher = (
            VersionFileWatcher(cfg.target_version_file())
            if cfg.enable_auto_update
            else None
        )

        # the control-plane session: built at start once an endpoint and a
        # token are known (_maybe_start_session)
        self.session = None
        self.dispatcher = None
        self.last_gossip = None
        # None until the first connect (the status route omits it then)
        self.last_replay_jitter_seconds = None
        self._outbox_replay_job = None
        self._session_mu = threading.Lock()
        # serializes credential-pair metadata writes (rotations vs the
        # success-gated on_connected persist) WITHOUT touching
        # _session_mu — on_connected runs on the session's keepalive
        # thread, which session.stop() joins while _session_mu is held
        self._cred_mu = threading.Lock()
        self._closed = False
        self._fifo_stop: Optional[threading.Event] = None
        self._fifo_thread: Optional[threading.Thread] = None

        self.supported_names = {
            c.name() for c in self.registry.all() if c.is_supported()
        }
        self._retention_targets = []
        self._assembled = False

    def _load_plugins(self) -> None:
        """Custom plugins from the specs file (server.py:340-366): init
        plugins run once and fail the boot when unhealthy; component
        plugins join the registry, a name clash with a built-in skipped and
        logged. A spec that does not validate is skipped, as is the whole
        file on a host without the ``yaml`` package."""
        self.plugin_specs = []
        specs_file = self.config.resolved_plugin_specs_file()
        if not os.path.isfile(specs_file):
            return
        from gpud_tpu_torch.plugins.component import build_components, run_init_plugins
        from gpud_tpu_torch.plugins.spec import load_specs

        try:
            self.plugin_specs = load_specs(specs_file, on_invalid="skip")
        except ImportError as e:
            logger.error("skipping plugin specs file %s: %s", specs_file, e)
            return
        init_err = run_init_plugins(self.instance, self.plugin_specs)
        if init_err:
            raise RuntimeError(init_err)
        for comp in build_components(self.instance, self.plugin_specs):
            _, reg_err = self.registry.register(lambda _inst, c=comp: c)
            if reg_err is not None:
                logger.error("skipping plugin %r: %s", comp.name(), reg_err)

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
        transitions, remediation audit rows, chaos campaign results,
        predict scores and fabric links, with the reference's kinds and dedupe keys (each record's
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

        def on_chaos_result(result: dict) -> None:
            outbox.publish(
                "chaos_result",
                {
                    "id": result.get("id"),
                    "scenario": result.get("scenario"),
                    "passed": result.get("passed"),
                    "error": result.get("error", ""),
                },
                dedupe_key=f"chaos:{result.get('scenario')}:{result.get('id')}",
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
        if self.chaos is not None:
            self.chaos.on_result = on_chaos_result
        if self.predictor is not None:
            self.predictor.on_publish = on_predict
        if self.fabric is not None:
            self.fabric.on_publish = on_ici_link

    def _outbox_replay_tick(self) -> int:
        """Job "session-outbox-replay": one batch of unacked records into
        the session; 0 while there is none, disconnected, auth-parked or
        caught up."""
        if self.outbox is None:
            return 0
        return self.outbox.replay_once(self.session)

    def _session_frame_drop_event(self, direction: str, detail: str) -> None:
        """Warning event for a dropped session frame (the session rate-
        limits the calls), so an overflow shows in the event timeline."""
        self.event_store.bucket("session").insert(
            Event(
                component="session",
                time=time.time(),
                name="session_frame_dropped",
                type=EventType.WARNING,
                message=f"{direction} channel overflow: {detail}",
            )
        )

    # -- config overrides and the control-plane session --------------------
    def _reapply_config_overrides(self) -> None:
        """Control-plane config overrides survive restarts (reference:
        persistMetadataOverrides in cmd/gpud/run). Best-effort: a corrupt
        row must never abort boot (systemd would crash-loop us)."""
        try:
            import json as _json

            raw = self.metadata.get(md.KEY_CONFIG_OVERRIDES)
            if not raw:
                return
            cfgs = _json.loads(raw)
            if not isinstance(cfgs, dict):
                logger.warning("ignoring malformed persisted overrides: %r", cfgs)
                return
            from gpud_tpu_torch.session.dispatch import Dispatcher

            updated, _applied, errors = Dispatcher(self).apply_config_overrides(cfgs)
            if updated:
                logger.info("re-applied persisted config overrides: %s", updated)
            if errors:
                logger.warning("persisted override errors: %s", errors)
        except Exception:  # noqa: BLE001
            logger.exception("re-applying persisted overrides failed; continuing boot")

    # -- session wiring ----------------------------------------------------
    def _maybe_start_session(self) -> None:
        """Create the control-plane session when an endpoint + token exist
        (reference: server.updateToken → session.NewSession, server.go:590;
        the reference package: server.py:799-977)."""
        with self._session_mu:
            if self._closed:
                return
            # credentials must stay PAIRED with the endpoint they were
            # issued for. Rotations (login/FIFO/updateToken) persist the
            # endpoint+token pair to metadata together, so:
            #   1. a complete --endpoint/--token flag pair wins ONLY when
            #      it points at a DIFFERENT control plane than the
            #      enrollment — that's an operator re-point. Flags aimed
            #      at the SAME endpoint (the systemd unit re-supplying
            #      bootstrap args every restart) defer to the metadata
            #      pair, whose token is the freshest credential for that
            #      endpoint — otherwise every restart would resurrect the
            #      revoked bootstrap token;
            #   2. else a complete metadata pair wins as a unit;
            #   3. else piecewise fallback.
            # raw reads captured ONCE: they drive both the credential
            # decision and the rotation-staleness snapshot below — a
            # second read for the snapshot would open a window where a
            # concurrent rotation lands between the two and the snapshot
            # wrongly matches it
            raw_md_endpoint = self.metadata.get(md.KEY_ENDPOINT)
            md_token = self.metadata.get(md.KEY_TOKEN)
            md_endpoint = md.normalize_endpoint(raw_md_endpoint)
            cfg_endpoint = md.normalize_endpoint(self.config.endpoint)
            if md_token and not md_endpoint and cfg_endpoint:
                # migration: older rotation code persisted only KEY_TOKEN,
                # so which endpoint that token belongs to is unrecorded.
                # Assume the flag endpoint (the control plane the daemon
                # was enrolled with) — otherwise the first restart after
                # upgrade would resurrect the revoked bootstrap flag
                # token. The guess is NOT persisted here: pairs are only
                # recorded on a successful connect (on_connected), and if
                # the guess is wrong auth fails and the flag-credential
                # fallback below recovers.
                md_endpoint = cfg_endpoint
            if (
                cfg_endpoint
                and self.config.token
                and (not (md_endpoint and md_token) or cfg_endpoint != md_endpoint)
            ):
                endpoint, token = cfg_endpoint, self.config.token
                if md_endpoint and md_endpoint != cfg_endpoint:
                    logger.warning(
                        "boot flags re-point the daemon: enrolled %s -> %s",
                        md_endpoint, cfg_endpoint,
                    )
            elif md_endpoint and md_token:
                if self.config.token and self.config.token != md_token:
                    # same-endpoint flag token loses to the rotated
                    # credential; say so, or an operator pushing a fresh
                    # token via the unit file has no trail to follow. (If
                    # the rotated credential is the dead one, the auth
                    # fallback below promotes the flag token.)
                    logger.warning(
                        "--token flag for %s deferred to the rotated "
                        "metadata credential (auth-failure fallback will "
                        "promote the flag token if the rotation is stale)",
                        md_endpoint,
                    )
                if cfg_endpoint and cfg_endpoint != md_endpoint:
                    logger.warning(
                        "enrolled metadata endpoint %s overrides --endpoint "
                        "%s (no --token given; supply both flags to "
                        "re-point)", md_endpoint, cfg_endpoint,
                    )
                endpoint, token = md_endpoint, md_token
            else:
                endpoint = cfg_endpoint or md_endpoint
                token = md_token or self.config.token
            if not endpoint or not token:
                return
            from gpud_tpu_torch.session.dispatch import Dispatcher
            from gpud_tpu_torch.session.session import Session

            self.dispatcher = Dispatcher(self)
            self.session = Session(
                endpoint=endpoint,
                machine_id=self.machine_id,
                token=token,
                machine_proof=self.metadata.get(md.KEY_MACHINE_PROOF),
                dispatch_fn=self.dispatcher,
            )
            session = self.session
            # pairs are persisted only once the control plane ACCEPTS the
            # credential — a guessed or stale pair can then never become
            # durable state that outranks fresh boot flags. The persist is
            # skipped if a rotation changed metadata since this session
            # was decided (the rotation is newer and owns the pair).
            snapshot = (raw_md_endpoint, md_token)

            def persist_on_connect() -> None:
                nonlocal snapshot
                with self._cred_mu:
                    pair = (
                        md.normalize_endpoint(session.endpoint),
                        session.token,
                    )
                    cur = (
                        self.metadata.get(md.KEY_ENDPOINT),
                        self.metadata.get(md.KEY_TOKEN),
                    )
                    if cur == pair:
                        snapshot = pair  # already recorded; reconnects no-op
                        return
                    if cur != snapshot:
                        return  # superseded by a rotation; don't clobber
                    self.metadata.set_credential_pair(*pair)
                    # refresh: a credential promoted LATER in this
                    # session's life (mid-stream revocation + flag
                    # fallback) must still be persistable
                    snapshot = pair

            def on_connected() -> None:
                persist_on_connect()
                # reconnect: in-flight frames from the old connection may
                # be lost and the manager's delta decoder is fresh — fall
                # back to the durable watermark, keyframe-anchored
                if self.outbox is not None:
                    self.outbox.reset_delivery()
                # drain the outbox backlog immediately instead of waiting
                # out the replay interval — reconnect is exactly when the
                # store-and-forward journal has work. EXCEPT straight
                # after a circuit-breaker recovery: then every agent in
                # the fleet is reconnecting at once (the manager was
                # down), and a synchronized replay burst would DDoS it —
                # stagger the poke by a random jitter instead
                job = self._outbox_replay_job
                if job is None:
                    return
                jitter_cap = float(self.config.outbox_replay_jitter_seconds)
                age = self.session_circuit.recovery_age()
                recovering = age is not None and age <= max(
                    5.0, 2.0 * jitter_cap
                )
                if recovering and jitter_cap > 0:
                    import random

                    jitter = random.uniform(0.1 * jitter_cap, jitter_cap)
                    self.last_replay_jitter_seconds = jitter
                    t = threading.Timer(jitter, job.poke)
                    t.daemon = True
                    t.start()
                else:
                    self.last_replay_jitter_seconds = 0.0
                    job.poke()

            # HA manager tier (docs/session.md "Peer failover"): the
            # breaker owns failover order — the endpoint we enrolled
            # with first, then the configured standby peers (minus any
            # duplicate spelling of the primary). Set before start();
            # with no session_peers the list stays empty and the breaker
            # behaves exactly as before
            peer_specs = [
                p.strip() for p in (self.config.session_peers or [])
                if p and p.strip()
            ]
            if peer_specs:
                def _spec_endpoint(spec: str) -> str:
                    return md.normalize_endpoint(
                        spec.split("=", 1)[-1].split("|", 1)[0]
                    )

                self.session_circuit.peers = [endpoint] + [
                    p for p in peer_specs if _spec_endpoint(p) != endpoint
                ]
            session.circuit = self.session_circuit
            session.on_frame_dropped = self._session_frame_drop_event
            session.on_connected = on_connected
            self.session.on_auth_failure = self._make_auth_failure_handler(
                session
            )
            self.session.start()
            logger.info("control-plane session started to %s", endpoint)

    def persist_credential_pair(self, endpoint: str, token: str) -> None:
        """Rotation writers (FIFO, updateToken) record the pair through
        here so they serialize with the success-gated connect persist."""
        with self._cred_mu:
            self.metadata.set_credential_pair(endpoint, token)

    def persist_token(self, token: str) -> None:
        """Token-only rotation (no live session to name the endpoint) —
        still serialized under _cred_mu so a dying session's late
        persist_on_connect can't interleave and clobber the rotation."""
        with self._cred_mu:
            self.metadata.set(md.KEY_TOKEN, token)

    def _make_auth_failure_handler(self, session):
        """Persist auth failures so operators can distinguish "control
        plane revoked us" from network flakiness across restarts; and if
        the boot flags carry a DIFFERENT token for the endpoint the
        session is talking to, promote it once — the metadata credential
        just proved dead, and the flag pair is the operator's standing
        instruction (recovery path for a stale rotation or a re-point
        attempted while only a token-only migration pair existed)."""
        def on_auth_failure(reason: str) -> None:
            self.metadata.set(
                md.KEY_LAST_AUTH_FAILURE, f"{int(time.time())}|{reason[:200]}"
            )
            cfg_endpoint = md.normalize_endpoint(self.config.endpoint)
            if (
                self.config.token
                and self.config.token != session.token
                and (not cfg_endpoint or cfg_endpoint == session.endpoint)
                and not session.flag_token_tried
            ):
                session.flag_token_tried = True  # one shot: no ping-pong
                logger.warning(
                    "auth failed with the stored credential; retrying with "
                    "the --token flag credential"
                )
                # un-parks the session's auth wait (it watches .token)
                session.token = self.config.token

        return on_auth_failure

    def _start_token_fifo(self) -> None:
        """FIFO so `tpud up`'s login can hand a fresh token to a running
        daemon (reference: server.go:638-713 gpud.fifo + WriteToken
        727-756; the reference package: server.py:1025-1193)."""
        if self.config.db_in_memory:
            return
        fifo_path = self.config.fifo_file()
        try:
            if os.path.exists(fifo_path):
                # a leftover regular file would make open() return instantly
                # and the watch loop busy-spin — recreate it as a FIFO
                if not stat.S_ISFIFO(os.stat(fifo_path).st_mode):
                    logger.warning(
                        "token fifo path %s is not a FIFO; recreating", fifo_path
                    )
                    os.remove(fifo_path)
                    os.mkfifo(fifo_path)
            else:
                os.mkfifo(fifo_path)
        except OSError as e:
            logger.warning("token fifo unavailable: %s", e)
            return

        def watch():
            import select as _select

            def apply(token: str) -> None:
                # persist the PAIR: the rotated token belongs to the
                # endpoint the session is (about to be) talking to, and
                # the pair must survive a process restart that re-supplies
                # stale boot flags
                with self._session_mu:
                    active = (
                        self.session.endpoint
                        if self.session is not None
                        else md.normalize_endpoint(self.config.endpoint)
                        or md.normalize_endpoint(
                            self.metadata.get(md.KEY_ENDPOINT)
                        )
                    )
                if active:
                    self.persist_credential_pair(active, token)
                else:
                    self.persist_token(token)
                logger.info("received new token via fifo; (re)starting session")
                with self._session_mu:
                    if self.session is not None:
                        self.session.stop()
                        self.session = None
                self._maybe_start_session()

            # the watcher holds the FIFO open O_RDWR for the daemon's
            # whole life: a reader always exists, so write_token never
            # ENXIOs after boot AND — unlike an open/EOF/close loop — an
            # ACKED write can never be discarded in the window where the
            # last reader closes (Linux drops FIFO buffers at zero
            # readers). A transient open failure (fd pressure) retries —
            # one bad moment at boot must not disable rotation for the
            # daemon's whole life.
            fd = -1
            while fd < 0:
                try:
                    fd = os.open(fifo_path, os.O_RDWR)
                except OSError as e:
                    logger.warning("token fifo unavailable: %s; retrying", e)
                    if self._fifo_stop.wait(1.0):
                        return
            poller = _select.poll()  # no FD_SETSIZE limit, unlike select()
            poller.register(fd, _select.POLLIN)
            buf = b""
            try:
                while not self._fifo_stop.is_set():
                    if buf and b"\n" not in buf:
                        # a writer sent bytes with no newline (raw
                        # `printf > fifo` rotation). The old EOF-framed
                        # reader accepted those; emulate it: if the
                        # writer goes quiet, the buffer IS the delivery.
                        # (A write arriving inside the window doesn't
                        # merge either — the read path below frames a
                        # surviving raw partial before appending.)
                        # 1s quiet window: a writer pausing mid-token
                        # >250ms could get its token torn in two; real
                        # tokens arrive in one atomic pipe write, so the
                        # longer window only delays the raw-printf path.
                        if not poller.poll(1000):
                            if len(buf) >= 1024:
                                # same bound as the pre-append framing
                                # below: a kilobyte+ newline-less blob is
                                # not a credential token — persisting it
                                # would evict a valid stored credential
                                logger.warning(
                                    "discarding %d-byte newline-less fifo "
                                    "delivery (exceeds token bound)",
                                    len(buf),
                                )
                                buf = b""
                                continue
                            token = buf.decode("utf-8", "replace").strip()
                            buf = b""
                            if token:
                                apply(token)
                            continue
                    try:
                        chunk = os.read(fd, 4096)  # blocks until a write
                    except OSError:
                        if self._fifo_stop.wait(1.0):
                            return
                        continue
                    if self._fifo_stop.is_set():
                        return
                    if buf and b"\n" not in buf:
                        # the previous read left a newline-less raw
                        # delivery (tokens fit one atomic pipe write, so
                        # a small survivor is complete, not a fragment):
                        # frame it BEFORE appending, or a tooling write
                        # arriving in the quiet window would merge with
                        # it. An over-bound survivor is garbage — discard
                        # it here too, or it would merge with this chunk
                        # and ride through the split below as one huge
                        # "delivery" (bypassing the quiet-window bound).
                        if len(buf) < 1024:
                            token = buf.decode("utf-8", "replace").strip()
                            if token:
                                apply(token)
                        else:
                            logger.warning(
                                "discarding %d-byte newline-less fifo "
                                "delivery (exceeds token bound)", len(buf),
                            )
                        buf = b""
                    buf += chunk
                    if b"\n" not in buf:
                        continue  # partial delivery; newline or quiet next
                    *lines, buf = buf.split(b"\n")  # tail = pending partial
                    # rapid successive write_token calls coalesce into ONE
                    # read; each newline-delimited line is a separate
                    # delivery and the LATEST rotation wins — joining them
                    # would persist a corrupt multi-line token that then
                    # rides an Authorization header. The same 1024-byte
                    # token bound applies per line: a newline-terminated
                    # blob must not become the credential either.
                    deliveries = []
                    for ln in lines:
                        if len(ln) >= 1024:
                            logger.warning(
                                "discarding %d-byte fifo line (exceeds "
                                "token bound)", len(ln),
                            )
                            continue
                        d = ln.decode("utf-8", "replace").strip()
                        if d:
                            deliveries.append(d)
                    if deliveries:
                        apply(deliveries[-1])
            finally:
                try:
                    os.close(fd)
                except OSError:
                    pass

        self._fifo_stop = threading.Event()
        self._fifo_thread = threading.Thread(
            target=watch, name="tpud-token-fifo", daemon=True
        )
        self._fifo_thread.start()

    @staticmethod
    def write_token(token: str, fifo_path: str) -> Optional[str]:
        """Reference: server.WriteToken (server.go:727-756)."""
        try:
            fd = os.open(fifo_path, os.O_WRONLY | os.O_NONBLOCK)
            try:
                os.write(fd, (token + "\n").encode())
            finally:
                os.close(fd)
            return None
        except OSError as e:
            return str(e)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Register every periodic job, then start the scheduler: jobs known
        at start form the startup-readiness set, and their first runs go to
        the pool in parallel. Idempotent."""
        self._assemble()
        sdnotify.ready()

    def _assemble(self) -> None:
        """What ``start`` builds, once (server.py:569-655); the server calls
        it before its listener and tells systemd it is ready after."""
        if self._assembled:
            return
        self._assembled = True
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
            # on_connected pokes this job for an immediate drain
            interval = float(self.config.outbox_replay_interval_seconds)
            self._outbox_replay_job = self.scheduler.add_job(
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
        self.package_manager.start()
        if self.update_watcher is not None:
            self.update_watcher.start(self.scheduler)
        self.scheduler.start()
        self._reapply_config_overrides()
        self._maybe_start_session()
        self._start_token_fifo()

    def _close_listener(self) -> None:
        """Where the reference stops its serve loop in ``stop``
        (server.py:739-742); the daemon has no listener."""

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
        with self._session_mu:
            self._closed = True  # bars the fifo watcher from new sessions
        if self._fifo_stop is not None:
            self._fifo_stop.set()
            # unblock the fifo reader's read
            self.write_token("", self.config.fifo_file())
            if self._fifo_thread is not None:
                self._fifo_thread.join(timeout=3.0)
        with self._session_mu:
            if self.session is not None:
                self.session.stop()
                self.session = None
        self.package_manager.close()
        if self.update_watcher is not None:
            self.update_watcher.close()
        self._close_listener()
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
        if self.chaos is not None:
            # aborts an in-flight campaign's sleeps before the pool the
            # campaign runs on is drained
            self.chaos.close()
        self.scheduler.close()
        self.health_ledger.close()
        self.event_store.close()
        if self.storage_writer is not None:
            self.storage_writer.close()
        self.db_ro.close()
        self.db_rw.close()
