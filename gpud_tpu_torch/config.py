"""Daemon configuration; the port of ``gpud_tpu/config.py``.

Mirrors the reference's config surface (reference: pkg/config/config.go:17-130,
pkg/config/default.go:15-34,137-157): defaults of port 15132 (we keep the same
port so tooling carries over), data dir /var/lib/tpud (or ~/.tpud when not
root), metrics retention 3h, events retention 14d, compact disabled.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

DEFAULT_PORT = 15132                     # reference: pkg/config/default.go
DEFAULT_METRICS_RETENTION = 3 * 3600     # 3h  (reference: default.go:26)
DEFAULT_EVENTS_RETENTION = 14 * 86400    # 14d (reference: default.go:28)
DEFAULT_POLL_INTERVAL = 60               # 1m component cadence
DEFAULT_SCRAPE_INTERVAL = 60             # 1m metrics syncer
DEFAULT_RECORDER_INTERVAL = 15 * 60      # 15m self-metrics recorder
DEFAULT_SESSION_PIPE_INTERVAL = 3        # 3s (reference: server.go:616)
DEFAULT_HEALTH_FLAP_THRESHOLD = 5        # transitions within the flap window
DEFAULT_HEALTH_FLAP_WINDOW = 600         # 10m flap-detection window
DEFAULT_HEALTH_AVAILABILITY_WINDOW = 3600  # 1h rolling availability window
DEFAULT_REMEDIATION_INTERVAL = 30        # remediation scan cadence
DEFAULT_REMEDIATION_COOLDOWN = 300       # per-component attempt cooldown
DEFAULT_REMEDIATION_RATE_CAPACITY = 6    # token-bucket burst
DEFAULT_REMEDIATION_RATE_REFILL = 600    # one token back per 10m
DEFAULT_REMEDIATION_MAX_REBOOTS = 2      # reboots allowed inside the window
DEFAULT_REMEDIATION_REBOOT_WINDOW = 3600
DEFAULT_REMEDIATION_ESCALATION_THRESHOLD = 3  # failed soft repairs => escalate
DEFAULT_REMEDIATION_ESCALATION_WINDOW = 3600
# predictive health: online precursor scoring (docs/predict.md)
DEFAULT_PREDICT_INTERVAL = 15.0          # predict-scan cadence
DEFAULT_PREDICT_THRESHOLD = 0.6          # fused score that arms a warning
DEFAULT_PREDICT_HYSTERESIS = 0.15        # clear band below the threshold
DEFAULT_PREDICT_ARM_TICKS = 2            # consecutive ticks above to warn
DEFAULT_PREDICT_CLEAR_TICKS = 3          # consecutive ticks below to clear
DEFAULT_PREDICT_WINDOW = 600.0           # feature lookback window (s)
DEFAULT_PREDICT_HISTORY_LIMIT = 256      # in-memory score points / component
DEFAULT_PREDICT_WARN_COOLDOWN = 300.0    # predicted-warning audit-row cooldown
DEFAULT_PREDICT_PUBLISH_INTERVAL = 60.0  # armed-score outbox snapshot cadence
# threshold calibration: per-component-class thresholds/weights fitted
# by replaying the node's own ledger history (docs/predict.md)
DEFAULT_PREDICT_CALIBRATE_INTERVAL = 3600.0  # re-fit cadence (s)
DEFAULT_PREDICT_CALIBRATE_MIN_HISTORY = 8    # class samples below => defaults
DEFAULT_PREDICT_CALIBRATE_MIN_THRESHOLD = 0.35  # fitted-threshold floor
DEFAULT_PREDICT_CALIBRATE_MARGIN = 0.05      # gap above the benign maximum
DEFAULT_PREDICT_CALIBRATE_HORIZON = 900.0    # post-sample failure horizon (s)
# fabric observability plane (docs/fabric.md): mesh-wide all-links sweep
DEFAULT_FABRIC_SWEEP_INTERVAL = 60.0     # all-links sweep cadence (s)
DEFAULT_FABRIC_SWEEP_THRESHOLD_Z = 4.0   # EWMA z that flags Degraded
DEFAULT_FABRIC_SWEEP_EWMA_ALPHA = 0.3    # per-link baseline smoothing
DEFAULT_FABRIC_SWEEP_WARMUP = 3          # sweeps before deviation flags
DEFAULT_FABRIC_SWEEP_RETENTION = 7 * 86400.0  # matrix history window (s)
# unified check scheduler (docs/scheduler.md): bounded worker pool +
# deadline heap replacing per-component poller threads
DEFAULT_SCHEDULER_WORKERS = 4
DEFAULT_SCHEDULER_WATCHDOG = 120         # hang budget per check run (s)
DEFAULT_SCHEDULER_JITTER = 0.05          # ±5% deterministic cadence jitter
# chaos campaign runner (docs/chaos.md)
DEFAULT_CHAOS_MAX_CAMPAIGN_SECONDS = 300
DEFAULT_CHAOS_HISTORY_LIMIT = 32
# session-path fault injection rate limit (injectFault token bucket)
DEFAULT_INJECT_RATE_CAPACITY = 10
DEFAULT_INJECT_RATE_REFILL = 6.0         # one injection token back per 6s
# write-behind storage commit layer (docs/storage.md)
DEFAULT_STORAGE_BATCH_FLUSH_INTERVAL = 0.2   # group-commit cadence (s)
DEFAULT_STORAGE_BATCH_MAX_PENDING = 100_000  # buffered ops before backpressure
DEFAULT_STORAGE_BATCH_FLUSH_THRESHOLD = 5_000  # buffered ops that poke a drain
DEFAULT_STORAGE_BATCH_BACKPRESSURE = 0.05    # bounded wait for room (s)
DEFAULT_STORAGE_WAL_CHECKPOINT = 300         # wal_checkpoint(TRUNCATE) cadence (s)
# durable session outbox (docs/session.md): store-and-forward journal
# between producers and the control-plane session
DEFAULT_OUTBOX_MAX_ROWS = 100_000            # journal hard cap (rows)
DEFAULT_OUTBOX_MAX_AGE = 7 * 86400           # journal age cap: a week of partition
DEFAULT_OUTBOX_REPLAY_BATCH = 500            # frames per replay drain
DEFAULT_OUTBOX_REPLAY_INTERVAL = 1.0         # replay job cadence (s)
# control-plane circuit breaker (docs/session.md)
DEFAULT_SESSION_CIRCUIT_THRESHOLD = 5        # consecutive failures before open
DEFAULT_SESSION_CIRCUIT_OPEN_SECONDS = 30.0  # open-state cooldown before probe
# session wire path (docs/session.md wire format): batched delta-encoded
# delivery frames with cumulative acks, rev-3 payload compression
DEFAULT_WIRE_KEYFRAME_INTERVAL = 64          # full payload every K records/stream
DEFAULT_WIRE_COMPRESS_MIN_BYTES = 512        # zlib floor for rev-3 payloads
DEFAULT_OUTBOX_REDELIVER_SECONDS = 30.0      # ack-stall window before redelivery
DEFAULT_OUTBOX_REPLAY_JITTER = 2.0           # post-recovery replay stagger cap (s)

STATE_FILE = "tpud.state"                # reference: default.go:137-157 (gpud.state)
FIFO_FILE = "tpud.fifo"
PACKAGES_DIR = "packages"
TARGET_VERSION_FILE = "target_version"
PLUGIN_SPECS_FILE = "plugins.yaml"
LOG_FILE = "tpud.log"
AUDIT_LOG_FILE = "tpud.audit.log"


def resolve_data_dir(data_dir: str = "") -> str:
    """Reference: pkg/config ResolveDataDir — /var/lib/gpud for root,
    ~/.gpud otherwise."""
    if data_dir:
        return data_dir
    if os.environ.get("TPUD_DATA_DIR"):
        return os.environ["TPUD_DATA_DIR"]
    if hasattr(os, "geteuid") and os.geteuid() == 0:
        return "/var/lib/tpud"
    return os.path.expanduser("~/.tpud")


@dataclass
class Config:
    port: int = DEFAULT_PORT
    data_dir: str = ""
    db_in_memory: bool = False           # reference: pkg/server/server.go:132-154
    metrics_retention_seconds: int = DEFAULT_METRICS_RETENTION
    events_retention_seconds: int = DEFAULT_EVENTS_RETENTION
    # health-transition ledger tuning (docs/observability.md)
    health_flap_threshold: int = DEFAULT_HEALTH_FLAP_THRESHOLD
    health_flap_window_seconds: int = DEFAULT_HEALTH_FLAP_WINDOW
    health_availability_window_seconds: int = DEFAULT_HEALTH_AVAILABILITY_WINDOW
    # remediation engine (docs/remediation.md). Enabled by default but
    # deny-by-default: with an empty enforce list every suggested action is
    # decided dry_run and nothing mutates the host.
    remediation_enabled: bool = True
    remediation_interval_seconds: int = DEFAULT_REMEDIATION_INTERVAL
    remediation_enforce_actions: List[str] = field(default_factory=list)
    remediation_cooldown_seconds: int = DEFAULT_REMEDIATION_COOLDOWN
    remediation_rate_capacity: int = DEFAULT_REMEDIATION_RATE_CAPACITY
    remediation_rate_refill_seconds: int = DEFAULT_REMEDIATION_RATE_REFILL
    remediation_max_reboots: int = DEFAULT_REMEDIATION_MAX_REBOOTS
    remediation_reboot_window_seconds: int = DEFAULT_REMEDIATION_REBOOT_WINDOW
    remediation_escalation_threshold: int = (
        DEFAULT_REMEDIATION_ESCALATION_THRESHOLD
    )
    remediation_escalation_window_seconds: int = (
        DEFAULT_REMEDIATION_ESCALATION_WINDOW
    )
    remediation_runtime_unit: str = ""   # empty = nvidia-fabricmanager.service
    # predictive health (docs/predict.md): precursor scoring over
    # check-latency drift, transition cadence, state trajectory, and kmsg
    # error-class novelty. Warnings are advisory — annotation + dry-run
    # audit row + outbox publish — never an executed action.
    predict_enabled: bool = True
    predict_interval_seconds: float = DEFAULT_PREDICT_INTERVAL
    predict_threshold: float = DEFAULT_PREDICT_THRESHOLD
    predict_hysteresis: float = DEFAULT_PREDICT_HYSTERESIS
    predict_arm_ticks: int = DEFAULT_PREDICT_ARM_TICKS
    predict_clear_ticks: int = DEFAULT_PREDICT_CLEAR_TICKS
    predict_window_seconds: float = DEFAULT_PREDICT_WINDOW
    predict_history_limit: int = DEFAULT_PREDICT_HISTORY_LIMIT
    predict_warn_cooldown_seconds: float = DEFAULT_PREDICT_WARN_COOLDOWN
    predict_publish_interval_seconds: float = DEFAULT_PREDICT_PUBLISH_INTERVAL
    # ledger-history threshold calibration (docs/predict.md)
    predict_calibrate_enabled: bool = True
    predict_calibrate_interval_seconds: float = (
        DEFAULT_PREDICT_CALIBRATE_INTERVAL
    )
    predict_calibrate_min_history: int = DEFAULT_PREDICT_CALIBRATE_MIN_HISTORY
    predict_calibrate_min_threshold: float = (
        DEFAULT_PREDICT_CALIBRATE_MIN_THRESHOLD
    )
    predict_calibrate_margin: float = DEFAULT_PREDICT_CALIBRATE_MARGIN
    predict_calibrate_horizon_seconds: float = (
        DEFAULT_PREDICT_CALIBRATE_HORIZON
    )
    # fabric observability (docs/fabric.md): logical-mesh discovery + the
    # all-links sweep with per-link EWMA latency baselines. Hermetic by
    # construction: with no JAX devices and no ICI inventory the mesh
    # degrades to 1x1 and the sweep observes zero links.
    fabric_sweep_enabled: bool = True
    fabric_sweep_interval_seconds: float = DEFAULT_FABRIC_SWEEP_INTERVAL
    fabric_sweep_latency_threshold_z: float = DEFAULT_FABRIC_SWEEP_THRESHOLD_Z
    fabric_sweep_ewma_alpha: float = DEFAULT_FABRIC_SWEEP_EWMA_ALPHA
    fabric_sweep_warmup_sweeps: int = DEFAULT_FABRIC_SWEEP_WARMUP
    fabric_sweep_retention_seconds: float = DEFAULT_FABRIC_SWEEP_RETENTION
    # chaos campaign runner (docs/chaos.md): enabled by default — running
    # a campaign still takes an explicit API/CLI call, and every fault is
    # software-injected and undone on campaign exit
    chaos_enabled: bool = True
    chaos_max_campaign_seconds: int = DEFAULT_CHAOS_MAX_CAMPAIGN_SECONDS
    chaos_history_limit: int = DEFAULT_CHAOS_HISTORY_LIMIT
    # token bucket on the session injectFault path (a hostile/buggy
    # control plane must not be able to spam kmsg writes)
    inject_rate_capacity: int = DEFAULT_INJECT_RATE_CAPACITY
    inject_rate_refill_seconds: float = DEFAULT_INJECT_RATE_REFILL
    # write-behind storage commit layer (docs/storage.md): all four stores
    # buffer hot-path writes and group-commit on one scheduler job. Off =
    # the classic one-transaction-per-row synchronous path everywhere.
    storage_batch_enabled: bool = True
    storage_batch_flush_interval_seconds: float = (
        DEFAULT_STORAGE_BATCH_FLUSH_INTERVAL
    )
    storage_batch_max_pending: int = DEFAULT_STORAGE_BATCH_MAX_PENDING
    storage_batch_flush_threshold: int = DEFAULT_STORAGE_BATCH_FLUSH_THRESHOLD
    storage_batch_backpressure_seconds: float = DEFAULT_STORAGE_BATCH_BACKPRESSURE
    storage_batch_fsync: bool = False    # one fsync per group commit when True
    storage_wal_checkpoint_seconds: int = DEFAULT_STORAGE_WAL_CHECKPOINT
    # durable session outbox (docs/session.md): at-least-once delivery of
    # events/transitions/audit/chaos results across partitions + restarts.
    # Off = the classic fire-and-forget in-memory channels only.
    outbox_enabled: bool = True
    outbox_max_rows: int = DEFAULT_OUTBOX_MAX_ROWS
    outbox_max_age_seconds: int = DEFAULT_OUTBOX_MAX_AGE
    outbox_replay_batch: int = DEFAULT_OUTBOX_REPLAY_BATCH
    outbox_replay_interval_seconds: float = DEFAULT_OUTBOX_REPLAY_INTERVAL
    # session wire path (docs/session.md wire format): per-stream delta
    # keyframe cadence, rev-3 compression floor, ack-stall redelivery
    # window, and the post-recovery replay jitter cap that staggers a
    # reconnecting fleet's replay storm
    session_wire_keyframe_interval: int = DEFAULT_WIRE_KEYFRAME_INTERVAL
    session_wire_compress_min_bytes: int = DEFAULT_WIRE_COMPRESS_MIN_BYTES
    outbox_redeliver_seconds: float = DEFAULT_OUTBOX_REDELIVER_SECONDS
    outbox_replay_jitter_seconds: float = DEFAULT_OUTBOX_REPLAY_JITTER
    # control-plane circuit breaker: closed → open after N consecutive
    # connect failures → half-open probe after the cooldown
    session_circuit_failure_threshold: int = DEFAULT_SESSION_CIRCUIT_THRESHOLD
    session_circuit_open_seconds: float = DEFAULT_SESSION_CIRCUIT_OPEN_SECONDS
    # HA manager tier (docs/session.md "Peer failover"): standby manager
    # specs ("endpoint", "endpoint|grpc_target", or the full
    # "peer_id=endpoint[|grpc_target]" form) tried in order when the
    # breaker trips on the primary. Empty = classic single-manager
    # parking behavior
    session_peers: List[str] = field(default_factory=list)
    # manager-side federation knobs (the reference's gpud_tpu/manager/federation.py),
    # consumed by `tpud manager serve`: journal-replication tick cadence,
    # peer health probe cadence, per-peer scatter-gather budget, probes
    # before a peer is declared dead, and whether the ring successor
    # auto-adopts a dead peer's replicated cohort
    federation_replication_interval_seconds: float = 1.0
    federation_probe_interval_seconds: float = 5.0
    federation_fanout_timeout_seconds: float = 2.0
    federation_dead_after_probes: int = 3
    federation_auto_adopt: bool = True
    # unified check scheduler (docs/scheduler.md)
    scheduler_workers: int = DEFAULT_SCHEDULER_WORKERS
    scheduler_watchdog_seconds: int = DEFAULT_SCHEDULER_WATCHDOG
    scheduler_jitter_fraction: float = DEFAULT_SCHEDULER_JITTER
    poll_interval_seconds: int = DEFAULT_POLL_INTERVAL
    scrape_interval_seconds: int = DEFAULT_SCRAPE_INTERVAL
    compact_period_seconds: int = 0      # 0 = disabled (reference default)
    enable_auto_update: bool = True
    endpoint: str = ""                   # control-plane endpoint (or TPUD_ENDPOINT)
    token: str = ""                      # join/session token (or TPUD_TOKEN)
    machine_id: str = ""
    components_enabled: List[str] = field(default_factory=list)   # empty = all
    components_disabled: List[str] = field(default_factory=list)
    kernel_modules_to_check: List[str] = field(default_factory=list)
    nfs_group_dirs: List[str] = field(default_factory=list)
    mount_points: List[str] = field(default_factory=list)
    mount_targets: List[str] = field(default_factory=list)
    expected_gpu_count: int = 0          # 0 = derive from accelerator type
    accelerator_type_override: str = ""
    kmsg_path: str = ""                  # empty = /dev/kmsg (or TPUD_KMSG_FILE_PATH)
    plugin_specs_file: str = ""
    pprof: bool = False
    log_level: str = "info"
    log_file: str = ""
    audit_log_file: str = ""
    tls: bool = True
    # failure injection (hidden flags in the reference, command.go:345-410)
    inject: Dict[str, str] = field(default_factory=dict)

    def resolved_data_dir(self) -> str:
        return resolve_data_dir(self.data_dir)

    def state_file(self) -> str:
        if self.db_in_memory:
            return ":memory:"
        return os.path.join(self.resolved_data_dir(), STATE_FILE)

    def fifo_file(self) -> str:
        return os.path.join(self.resolved_data_dir(), FIFO_FILE)

    def packages_dir(self) -> str:
        return os.path.join(self.resolved_data_dir(), PACKAGES_DIR)

    def target_version_file(self) -> str:
        return os.path.join(self.resolved_data_dir(), TARGET_VERSION_FILE)

    def resolved_plugin_specs_file(self) -> str:
        return self.plugin_specs_file or os.path.join(
            self.resolved_data_dir(), PLUGIN_SPECS_FILE
        )

    def validate(self) -> Optional[str]:
        # port 0 = ephemeral (tests)
        if not (0 <= self.port < 65536):
            return f"invalid port {self.port}"
        if self.metrics_retention_seconds < 60:
            return "metrics retention must be >= 60s"
        if self.events_retention_seconds < 60:
            return "events retention must be >= 60s"
        if self.health_flap_threshold < 2:
            return "health flap threshold must be >= 2"
        if self.health_flap_window_seconds < 60:
            return "health flap window must be >= 60s"
        if self.health_availability_window_seconds < 60:
            return "health availability window must be >= 60s"
        if self.remediation_interval_seconds < 1:
            return "remediation interval must be >= 1s"
        if self.remediation_cooldown_seconds < 0:
            return "remediation cooldown must be >= 0s"
        if self.remediation_rate_capacity < 1:
            return "remediation rate capacity must be >= 1"
        if self.remediation_rate_refill_seconds < 1:
            return "remediation rate refill must be >= 1s"
        if self.remediation_max_reboots < 1:
            return "remediation max reboots must be >= 1"
        if self.remediation_reboot_window_seconds < 60:
            return "remediation reboot window must be >= 60s"
        if self.remediation_escalation_threshold < 1:
            return "remediation escalation threshold must be >= 1"
        if self.remediation_escalation_window_seconds < 60:
            return "remediation escalation window must be >= 60s"
        if self.predict_interval_seconds <= 0:
            return "predict interval must be > 0s"
        if not 0.0 < self.predict_threshold <= 1.0:
            return "predict threshold must be in (0, 1]"
        if not 0.0 <= self.predict_hysteresis < self.predict_threshold:
            return "predict hysteresis must be in [0, threshold)"
        if self.predict_arm_ticks < 1:
            return "predict arm ticks must be >= 1"
        if self.predict_clear_ticks < 1:
            return "predict clear ticks must be >= 1"
        if self.predict_window_seconds < 1:
            return "predict window must be >= 1s"
        if self.predict_history_limit < 1:
            return "predict history limit must be >= 1"
        if self.predict_warn_cooldown_seconds < 0:
            return "predict warn cooldown must be >= 0s"
        if self.predict_publish_interval_seconds < 0:
            return "predict publish interval must be >= 0s"
        if self.predict_calibrate_interval_seconds <= 0:
            return "predict calibrate interval must be > 0s"
        if self.predict_calibrate_min_history < 1:
            return "predict calibrate min history must be >= 1"
        if not 0.0 < self.predict_calibrate_min_threshold <= 1.0:
            return "predict calibrate min threshold must be in (0, 1]"
        if not 0.0 <= self.predict_calibrate_margin < 0.5:
            return "predict calibrate margin must be in [0, 0.5)"
        if self.predict_calibrate_horizon_seconds < 1:
            return "predict calibrate horizon must be >= 1s"
        if self.fabric_sweep_interval_seconds <= 0:
            return "fabric sweep interval must be > 0s"
        if self.fabric_sweep_latency_threshold_z <= 0:
            return "fabric sweep latency threshold z must be > 0"
        if not 0.0 < self.fabric_sweep_ewma_alpha <= 1.0:
            return "fabric sweep ewma alpha must be in (0, 1]"
        if self.fabric_sweep_warmup_sweeps < 1:
            return "fabric sweep warmup sweeps must be >= 1"
        if self.fabric_sweep_retention_seconds < 60:
            return "fabric sweep retention must be >= 60s"
        if self.chaos_max_campaign_seconds < 1:
            return "chaos max campaign seconds must be >= 1"
        if self.chaos_history_limit < 1:
            return "chaos history limit must be >= 1"
        if self.inject_rate_capacity < 1:
            return "inject rate capacity must be >= 1"
        if self.inject_rate_refill_seconds <= 0:
            return "inject rate refill must be > 0s"
        if self.storage_batch_flush_interval_seconds <= 0:
            return "storage batch flush interval must be > 0s"
        if self.storage_batch_max_pending < 1000:
            return "storage batch max pending must be >= 1000"
        if self.storage_batch_flush_threshold < 1:
            return "storage batch flush threshold must be >= 1"
        if self.storage_batch_flush_threshold > self.storage_batch_max_pending:
            return "storage batch flush threshold must be <= max pending"
        if self.storage_batch_backpressure_seconds < 0:
            return "storage batch backpressure must be >= 0s"
        if self.storage_wal_checkpoint_seconds < 0:
            return "storage wal checkpoint cadence must be >= 0s (0 disables)"
        if self.outbox_max_rows < 1000:
            return "outbox max rows must be >= 1000"
        if self.outbox_max_age_seconds < 60:
            return "outbox max age must be >= 60s"
        if self.outbox_replay_batch < 1:
            return "outbox replay batch must be >= 1"
        if self.outbox_replay_interval_seconds <= 0:
            return "outbox replay interval must be > 0s"
        if self.session_circuit_failure_threshold < 1:
            return "session circuit failure threshold must be >= 1"
        if self.session_circuit_open_seconds <= 0:
            return "session circuit open seconds must be > 0s"
        for spec in self.session_peers:
            s = (spec or "").strip()
            if not s or "://" not in s:
                return (
                    f"session peer {spec!r} must be an http(s) endpoint "
                    "spec (endpoint, endpoint|grpc, or id=endpoint|grpc)"
                )
        if self.federation_replication_interval_seconds <= 0:
            return "federation replication interval must be > 0s"
        if self.federation_probe_interval_seconds <= 0:
            return "federation probe interval must be > 0s"
        if self.federation_fanout_timeout_seconds <= 0:
            return "federation fanout timeout must be > 0s"
        if self.federation_dead_after_probes < 1:
            return "federation dead-after-probes must be >= 1"
        if self.session_wire_keyframe_interval < 1:
            return "session wire keyframe interval must be >= 1"
        if self.session_wire_compress_min_bytes < 0:
            return "session wire compress min bytes must be >= 0"
        if self.outbox_redeliver_seconds <= 0:
            return "outbox redeliver window must be > 0s"
        if self.outbox_replay_jitter_seconds < 0:
            return "outbox replay jitter must be >= 0s"
        if self.scheduler_workers < 1:
            return "scheduler workers must be >= 1"
        if self.scheduler_watchdog_seconds < 0:
            return "scheduler watchdog must be >= 0s (0 disables)"
        if not (0.0 <= self.scheduler_jitter_fraction <= 0.5):
            return "scheduler jitter fraction must be in [0, 0.5]"
        if self.poll_interval_seconds < 1:
            return "poll interval must be >= 1s"
        if self.scrape_interval_seconds < 1:
            return "scrape interval must be >= 1s"
        if self.compact_period_seconds < 0:
            return "compact period must be >= 0s (0 disables)"
        if self.expected_gpu_count < 0:
            return "expected chip count must be >= 0 (0 = derive)"
        from gpud_tpu_torch.remediation.policy import EXECUTABLE_ACTIONS

        unknown = sorted(
            set(self.remediation_enforce_actions) - set(EXECUTABLE_ACTIONS)
        )
        if unknown:
            return (
                f"unknown remediation enforce action(s) {unknown}; "
                f"known: {list(EXECUTABLE_ACTIONS)}"
            )
        return None


def default_config(**overrides) -> Config:
    cfg = Config()
    # env-based enrollment for containerized deploys (the Helm chart
    # injects TPUD_TOKEN from a Secret and TPUD_ENDPOINT from values)
    cfg.endpoint = os.environ.get("TPUD_ENDPOINT", "")
    cfg.token = os.environ.get("TPUD_TOKEN", "")
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise AttributeError(f"unknown config field: {k}")
        setattr(cfg, k, v)
    return cfg
