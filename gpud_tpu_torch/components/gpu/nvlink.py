"""NVLink fabric component.

Reference: components/accelerator/nvidia/infiniband (SURVEY §2.4, "most
complex check"): its own SQLite time-series of per-port snapshots; Scan
marks drops/flaps; *sticky* unhealthy until ``set-healthy`` or an opt-in
flap auto-clear window (flap_auto_clear_window.go); expected port counts by
product (threshold_default.go); tombstone on admin action.

The port of ``gpud_tpu/components/tpu/ici.py``: ports are each GPU's
NVLink links; expected counts come from the product table (H100 SXM: 18
links per GPU; a PCIe card: none); states and counters come from NVML
(``gpu/nvml.py``). A link NVML reports inactive is down; a link whose state
NVML does not support is not reported, so a card with no NVLink state at all
is "not supported" here.
"""

from __future__ import annotations

import time
from typing import List, Optional

from gpud_tpu_torch.api.v1.types import (
    Event,
    EventType,
    HealthStateType,
    RepairActionType,
    SuggestedActions,
)
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.components.gpu.nvlink_store import NVLinkStore, ScanResult
from gpud_tpu_torch.metadata import KEY_NVLINK_MAX_LINKS_SEEN, Metadata
from gpud_tpu_torch.components.gpu.shared import sampler_for
from gpud_tpu_torch.metrics.registry import gauge

NAME = "accelerator-gpu-nvlink"

_g_links_up = gauge("tpud_gpu_nvlink_links_up", "NVLink links currently up")
_g_links_expected = gauge("tpud_gpu_nvlink_links_expected", "expected NVLink links")
_g_link_state = gauge("tpud_gpu_nvlink_link_state", "per-link state (1=up)")
_g_crc = gauge("tpud_gpu_nvlink_link_crc_errors_total", "per-link CRC errors")

LABELS = {"component": NAME}

DEFAULT_SCAN_WINDOW = 3600.0        # 1h drop/flap window
DEFAULT_FLAP_THRESHOLD = 3          # flaps in window before Degraded
DEFAULT_CRC_DELTA_DEGRADED = 100    # CRC-errors delta in window before Degraded
# opt-in: clear sticky flap state after this much clean uptime; 0 = sticky
# until set-healthy (reference: flap_auto_clear_window.go)
DEFAULT_AUTO_CLEAR_WINDOW = 0.0
# Adaptive fast-poll: on suspicion (a fabric-class kmsg match arriving via
# the ~ms inotify path, or a sample delta — state change / counter step /
# link-set change) the poller drops to FAST_POLL_INTERVAL for
# SUSPICION_WINDOW seconds, then decays back to the 60s cadence. Beats the
# reference's fixed 60s IB poll (SURVEY §6) without raising steady-state
# CPU: a healthy host never enters the window.
DEFAULT_FAST_POLL_INTERVAL = 1.0
DEFAULT_SUSPICION_WINDOW = 60.0
# a counter-step trigger re-arms only after this cooldown — a continuously
# rising CRC counter (Degraded-class, non-urgent) must not hold ~50% fast
# duty by re-opening a window at every steady poll
DEFAULT_COUNTER_RETRIGGER_COOLDOWN = 600.0


class GPUNVLinkComponent(PollingComponent):
    NAME = NAME
    TAGS = ["accelerator", "gpu", "nvlink", "fabric"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.gpu = instance.gpu_instance
        self.sampler = sampler_for(self.gpu)
        self.store: Optional[NVLinkStore] = (
            NVLinkStore(instance.db_rw) if instance.db_rw is not None else None
        )
        self._event_bucket = (
            instance.event_store.bucket(NAME) if instance.event_store else None
        )
        self.scan_window = DEFAULT_SCAN_WINDOW
        self.flap_threshold = DEFAULT_FLAP_THRESHOLD
        self.crc_delta_degraded = DEFAULT_CRC_DELTA_DEGRADED
        self.auto_clear_window = DEFAULT_AUTO_CLEAR_WINDOW
        self.time_now_fn = time.time
        self._last_purge = 0.0
        # adaptive fast-poll state
        self.fast_poll_interval = DEFAULT_FAST_POLL_INTERVAL
        self.suspicion_window = DEFAULT_SUSPICION_WINDOW
        self.counter_retrigger_cooldown = DEFAULT_COUNTER_RETRIGGER_COOLDOWN
        self._suspicion_until = 0.0
        self._counter_trigger_armed_at = 0.0
        self._prev_sample: dict = {}
        self._last_store_ts = 0.0
        self._cached_scan: Optional[ScanResult] = None
        instance.fabric_suspicion_listeners.append(self._on_fabric_kmsg)
        # explicit expected-link-count override (pushed via updateConfig);
        # 0 = derive from topology / observed high-water mark
        self.expected_links = 0
        # high-water mark persists in metadata: a daemon restart on a host
        # with partial driver exposure must not forget that more links were
        # once visible (a vanished link still alarms after restart)
        self._metadata = None
        self._max_links_seen = 0
        if instance.db_rw is not None:
            self._metadata = Metadata(instance.db_rw)
            try:
                self._max_links_seen = int(
                    self._metadata.get(KEY_NVLINK_MAX_LINKS_SEEN) or 0
                )
            except ValueError:
                self._max_links_seen = 0

    def is_supported(self) -> bool:
        return (
            self.gpu is not None
            and self.gpu.gpu_lib_exists()
            and self.gpu.nvlink_supported()
        )

    # -- adaptive fast-poll ------------------------------------------------
    def poll_interval(self) -> float:
        if self.time_now_fn() < self._suspicion_until:
            return self.fast_poll_interval
        return self.POLL_INTERVAL

    def raise_suspicion(self, reason: str = "") -> None:
        """Open (or extend) the fast-poll window and wake the poller."""
        self._suspicion_until = self.time_now_fn() + self.suspicion_window
        self.poke()

    def _on_fabric_kmsg(self, error_name: str) -> None:
        # driver saw a fabric problem; confirm through NVML immediately
        # instead of waiting out the 60s cadence
        if error_name.startswith("gpu_nvlink"):
            self.raise_suspicion(error_name)

    def _delta_kind(self, links) -> Optional[str]:
        """Classify the change vs the previous sample: "state" (state or
        link-set change) outranks "counter" (error-counter step)."""
        cur = {
            ln.name: (
                ln.state,
                ln.tx_errors + ln.rx_errors + ln.crc_errors + ln.replays,
            )
            for ln in links
        }
        prev, self._prev_sample = self._prev_sample, cur
        if not prev:
            return None
        if set(prev) != set(cur):
            return "state"
        kind = None
        for name, (state, errs) in cur.items():
            p_state, p_errs = prev[name]
            if state != p_state:
                return "state"
            if errs > p_errs:
                kind = "counter"
        return kind

    def _expected_links(self, reported: int) -> int:
        """Expected link count. NVML's exposure can be partial (a link whose
        state is not supported is not reported), so when the backend stably
        reports fewer links than the product table, the baseline is the
        most links ever observed — a link *vanishing* from a
        previously-larger set still alarms, but a consistently partial
        report doesn't page operators forever."""
        if self.expected_links > 0:
            # operator/control-plane pinned the expectation (e.g. after a
            # legitimately smaller re-deployment) — overrides both the
            # topology estimate and the observed high-water mark
            return self.expected_links
        topo = self.gpu.topology() if self.gpu else None
        if topo is None:
            return 0
        topo_expected = len(self.gpu.devices()) * topo.nvlink_links_per_gpu
        if reported > self._max_links_seen:
            self._max_links_seen = reported
            if self._metadata is not None:
                self._metadata.set(
                    KEY_NVLINK_MAX_LINKS_SEEN, str(self._max_links_seen)
                )
        if self._max_links_seen >= topo_expected:
            return topo_expected
        return self._max_links_seen

    def _record_event(self, name: str, ev_type: str, message: str) -> None:
        if self._event_bucket is None:
            return
        ev = Event(component=NAME, name=name, type=ev_type, message=message)
        # dedupe identical message within the last scan window — but only
        # back to the latest SetHealthy marker, so a recurrence after an
        # operator clear is a fresh incident with its own event
        recent = self._event_bucket.get(self.time_now_fn() - self.scan_window)
        for e in recent:  # newest first
            if e.name == "SetHealthy":
                break
            if e.name == name and e.message == message:
                return
        self._event_bucket.insert(ev)

    def check_once(self) -> CheckResult:
        if not self.is_supported():
            return CheckResult(
                self.NAME,
                health=HealthStateType.HEALTHY,
                reason="no NVLink fabric on this host",
            )
        links = self.sampler.nvlink_links()
        now = self.time_now_fn()
        delta = self._delta_kind(links)
        if delta == "state":
            # link state/set moved: hold the fast cadence until the window
            # expires with no further state changes
            self._suspicion_until = now + self.suspicion_window
        elif (
            delta == "counter"
            and now >= self._suspicion_until
            and now >= self._counter_trigger_armed_at
        ):
            # a counter step opens ONE window per cooldown — a steadily-
            # rising CRC counter is a Degraded-class condition that must
            # not pin the poller at (or near) 1 Hz forever
            self._suspicion_until = now + self.suspicion_window
            self._counter_trigger_armed_at = now + self.counter_retrigger_cooldown

        up = 0
        for ln in links:
            labels = {"component": NAME, "link": ln.name}
            _g_link_state.set(1.0 if ln.state == "up" else 0.0, labels)
            _g_crc.set(ln.crc_errors, labels)
            if ln.state == "up":
                up += 1
        expected = self._expected_links(len(links))
        _g_links_up.set(up, LABELS)
        _g_links_expected.set(expected, LABELS)

        scan: Optional[ScanResult] = None
        if self.store is not None:
            # fast polls detect down-links directly from the sample; the
            # history store keeps its steady 60s granularity (plus an
            # immediate row on any delta so the transition is recorded) —
            # a 1 Hz insert + 1h-window scan would be sustained disk/CPU
            # load and ~60x row growth during every suspicion window
            # counter deltas recur on every fast poll of a noisy link —
            # only STATE transitions warrant an off-cadence row
            if delta == "state" or now - self._last_store_ts >= self.POLL_INTERVAL:
                self.store.insert_snapshot(links, ts=now)
                self._last_store_ts = now
                # purge at retention/5 cadence, not per poll (matches the
                # eventstore purger; a per-poll DELETE would walk the table)
                if now - self._last_purge >= self.store.retention_seconds / 5.0:
                    self.store.purge()
                    self._last_purge = now
                self._cached_scan = self.store.scan(self.scan_window)
            scan = self._cached_scan

        # where link states come from (reference exposes its port-state
        # source explicitly, infiniband/class/class.go:14-34): "nvml", or ""
        # for fixtures; the key keeps the reference's name
        source = self.gpu.nvlink_source()
        extra = {
            "links_up": str(up),
            "links_expected": str(expected),
            "poll_mode": "fast" if now < self._suspicion_until else "steady",
            "ici_source": source,
        }

        # 1. links currently down → Unhealthy (sticky by construction: the
        #    condition persists until the link recovers, and history keeps
        #    the drop visible via events)
        down_now = sorted(ln.name for ln in links if ln.state != "up")
        if down_now or (expected and up < expected):
            missing = down_now or [f"{expected - up} link(s) unreported"]
            for name in down_now:
                self._record_event(
                    "ici_link_down", EventType.CRITICAL, f"NVLink link {name} down"
                )
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"NVLink link(s) down: {', '.join(missing)} ({up}/{expected} up)",
                suggested_actions=SuggestedActions(
                    description="NVLink link down — reboot may retrain; persistent loss needs hardware inspection",
                    repair_actions=[
                        RepairActionType.REBOOT_SYSTEM,
                        RepairActionType.HARDWARE_INSPECTION,
                    ],
                ),
                extra_info=extra,
            )

        # 2. sticky history: drops/flaps in the window keep the component
        #    not-healthy even after recovery, until set-healthy tombstones
        #    the history or the auto-clear window elapses
        if scan is not None:
            flapped = [
                s
                for s in scan.links.values()
                if s.drops > 0 or s.flaps > 0
            ]
            if flapped and self.auto_clear_window > 0:
                # opt-in: clear sticky state once every link has been clean
                # for the auto-clear window (reference: flap_auto_clear_window.go)
                if self._all_clean_since(self.auto_clear_window):
                    flapped = []
            if flapped:
                heavy = [
                    s.link
                    for s in flapped
                    if s.flaps >= self.flap_threshold or s.drops >= self.flap_threshold
                ]
                names = sorted(s.link for s in flapped)
                for s in flapped:
                    self._record_event(
                        "ici_link_flap",
                        EventType.WARNING,
                        f"NVLink link {s.link} dropped {s.drops}x / recovered {s.flaps}x in window",
                    )
                health = (
                    HealthStateType.UNHEALTHY if heavy else HealthStateType.DEGRADED
                )
                return CheckResult(
                    self.NAME,
                    health=health,
                    reason=(
                        f"NVLink link(s) flapped in last {int(self.scan_window / 60)}m: "
                        f"{', '.join(names)} (sticky until set-healthy)"
                    ),
                    suggested_actions=SuggestedActions(
                        description="NVLink links unstable — check cabling/seating",
                        repair_actions=[RepairActionType.HARDWARE_INSPECTION],
                    ),
                    extra_info=extra,
                )

            # 3. counter health: CRC deltas in window
            noisy = [
                s.link
                for s in scan.links.values()
                if s.crc_delta >= self.crc_delta_degraded
            ]
            if noisy:
                return CheckResult(
                    self.NAME,
                    health=HealthStateType.DEGRADED,
                    reason=f"NVLink CRC errors rising on: {', '.join(sorted(noisy))}",
                    suggested_actions=SuggestedActions(
                        description="NVLink CRC errors — cable/connector suspect",
                        repair_actions=[RepairActionType.HARDWARE_INSPECTION],
                    ),
                    extra_info=extra,
                )

        return CheckResult(
            self.NAME,
            reason=f"all {up}/{expected} NVLink links up",
            extra_info=extra,
        )

    def _all_clean_since(self, window: float) -> bool:
        """True when no drop/flap transition occurred within ``window``."""
        if self.store is None:
            return False
        recent = self.store.scan(window)
        return not any(
            s.drops > 0 or s.flaps > 0 or s.currently_down
            for s in recent.links.values()
        )

    def close(self) -> None:
        # a discarded/deregistered component must not keep receiving
        # fabric-suspicion callbacks through the long-lived TpudInstance
        try:
            self.instance.fabric_suspicion_listeners.remove(self._on_fabric_kmsg)
        except ValueError:
            pass
        super().close()

    def events(self, since: float):
        if self._event_bucket is None:
            return []
        return self._event_bucket.get(since)

    def set_healthy(self) -> None:
        """Tombstone all link history so the scan starts fresh
        (reference: IB tombstone on admin action). Deliberately does NOT
        touch the expected-links baseline: clearing a flap alarm must not
        silently accept a vanished link as the new normal — a smaller
        topology is accepted explicitly via the ``expected_links``
        updateConfig override."""
        if self.store is not None:
            self.store.set_tombstone("*", ts=self.time_now_fn())
            # the cached window scan predates the tombstone — drop it and
            # force a fresh insert+scan so the re-check reflects the clear
            self._cached_scan = None
            self._last_store_ts = 0.0
        if self._event_bucket is not None:
            self._event_bucket.insert(
                Event(
                    component=NAME,
                    name="SetHealthy",
                    type=EventType.INFO,
                    message="operator set-healthy; NVLink history tombstoned",
                )
            )
        self.check()
