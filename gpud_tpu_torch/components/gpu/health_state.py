"""Event-sourced health evaluation for GPU errors.

The port of ``gpud_tpu/components/tpu/health_state.py``, the *shape* of the
reference's subtlest logic
(reference: components/accelerator/nvidia/xid/health_state.go:56-80 and
component.go:400-650): walk the merged stream of error events, reboot
events and set-healthy events oldest→newest and evolve the health state:

- a critical error's first occurrence ⇒ Unhealthy, suggest REBOOT_SYSTEM;
- if the same error recurs after ``reboot_threshold`` reboots, escalate the
  suggestion to HARDWARE_INSPECTION (rebooting didn't fix it);
- a SetHealthy event clears the slate (reference: xid/set_healthy.go,
  component.go:636-650 trims history);
- non-critical errors never push past Degraded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from gpud_tpu_torch.api.v1.types import (
    Event,
    HealthStateType,
    RepairActionType,
    SuggestedActions,
)
from gpud_tpu_torch.components.gpu.catalog import CatalogEntry, extract_gpu, lookup

EVENT_NAME_REBOOT = "reboot"
EVENT_NAME_SET_HEALTHY = "SetHealthy"


def _event_gpu(ev: Event) -> Optional[int]:
    """GPU attribution for an error event: explicit extra_info first (the
    matcher resolved the line's PCI address there), then a ``gpu=N`` /
    ``gpuN`` token in the message (the reference tracks per-DeviceUUID the
    same way; xid events carry the device in their payload)."""
    raw = ev.extra_info.get("gpu") if ev.extra_info else None
    if raw is not None:
        try:
            return int(raw)
        except (TypeError, ValueError):
            pass
    return extract_gpu(ev.message or "")


@dataclass
class _ErrorTrack:
    entry: CatalogEntry
    gpu_id: Optional[int] = None
    occurrences: int = 0
    reboots_since_first: int = 0
    recurred_after_reboot: bool = False
    last_event: Optional[Event] = None
    pending_reboot_seen: bool = False  # a reboot happened after the last occurrence

    @property
    def display(self) -> str:
        return (
            f"{self.entry.name}(GPU {self.gpu_id})"
            if self.gpu_id is not None
            else self.entry.name
        )


@dataclass
class EvaluatedHealth:
    health: str = HealthStateType.HEALTHY
    reason: str = ""
    suggested_actions: Optional[SuggestedActions] = None
    active_errors: Dict[str, int] = field(default_factory=dict)


def evolve_health(
    merged_events: List[Event],
    threshold_overrides: Optional[Dict[str, int]] = None,
) -> EvaluatedHealth:
    """``merged_events`` may arrive in any order; they are sorted
    oldest→newest here (reference: health_state.go:60+ walks merged reboot
    + xid events the same way). Error events must carry the catalog name in
    ``Event.name``.

    Tracks are keyed by (error name, GPU index): a recurring error on GPU 3
    and a first occurrence on GPU 5 escalate independently, the way the
    reference keys on DeviceUUID (xid events carry the device)."""
    events = sorted(merged_events, key=lambda e: e.time)
    tracks: Dict[Tuple[str, Optional[int]], _ErrorTrack] = {}

    for ev in events:
        if ev.name == EVENT_NAME_SET_HEALTHY:
            # operator cleared the slate: drop all accumulated state
            tracks.clear()
            continue
        if ev.name == EVENT_NAME_REBOOT:
            for tr in tracks.values():
                tr.reboots_since_first += 1
                tr.pending_reboot_seen = True
            continue
        entry = lookup(ev.name)
        if entry is None:
            continue
        key = (ev.name, _event_gpu(ev))
        tr = tracks.get(key)
        if tr is None:
            tr = _ErrorTrack(entry=entry, gpu_id=key[1])
            tracks[key] = tr
        tr.occurrences += 1
        tr.last_event = ev
        if tr.pending_reboot_seen:
            # the error came back after a reboot — reboot didn't fix it
            tr.recurred_after_reboot = True
            tr.pending_reboot_seen = False

    if not tracks:
        return EvaluatedHealth(reason="no GPU errors observed")

    # Resolution semantics: an error with a reboot after its last occurrence
    # and no recurrence is considered addressed (reference merges reboot
    # events so a clean reboot clears the suggestion path).
    active: Dict[Tuple[str, Optional[int]], _ErrorTrack] = {}
    for key, tr in tracks.items():
        if tr.pending_reboot_seen and not tr.recurred_after_reboot:
            continue  # rebooted, hasn't recurred → resolved
        active[key] = tr

    if not active:
        return EvaluatedHealth(
            reason="previous GPU errors cleared by reboot",
        )

    worst = HealthStateType.DEGRADED
    reasons: List[str] = []
    repair: List[str] = []
    descs: List[str] = []
    counts: Dict[str, int] = {}
    any_escalated = False
    for _key, tr in sorted(
        active.items(), key=lambda kv: (-kv[1].entry.code, kv[0][1] is None, kv[0][1])
    ):
        counts[tr.display] = tr.occurrences
        if tr.entry.critical:
            worst = HealthStateType.UNHEALTHY
        # control-plane-pushed per-error-name thresholds win over the
        # catalog default (reference: XID thresholds via updateConfig,
        # session.go:222-227)
        thr = (threshold_overrides or {}).get(
            tr.entry.name, tr.entry.reboot_threshold
        )
        escalate = (
            thr > 0
            and tr.recurred_after_reboot
            and tr.reboots_since_first >= thr
        )
        if escalate:
            any_escalated = True
            reasons.append(
                f"{tr.display} recurred after {tr.reboots_since_first} reboot(s) "
                f"(x{tr.occurrences})"
            )
            if RepairActionType.HARDWARE_INSPECTION not in repair:
                repair.append(RepairActionType.HARDWARE_INSPECTION)
        else:
            reasons.append(f"{tr.display} (x{tr.occurrences})")
            for act in tr.entry.repair_actions:
                if act not in repair:
                    repair.append(act)
        if tr.entry.description not in descs:
            descs.append(tr.entry.description)

    # once an error escalated, rebooting is known not to help: replace the
    # reboot suggestion with inspection (reference: health_state.go
    # escalation replaces reboot with inspection)
    if any_escalated:
        repair = [a for a in repair if a != RepairActionType.REBOOT_SYSTEM]
        if RepairActionType.HARDWARE_INSPECTION not in repair:
            repair.append(RepairActionType.HARDWARE_INSPECTION)

    sa = None
    if repair and repair != [RepairActionType.IGNORE_NO_ACTION_REQUIRED]:
        sa = SuggestedActions(description="; ".join(descs), repair_actions=repair)
    return EvaluatedHealth(
        health=worst,
        reason="; ".join(reasons),
        suggested_actions=sa,
        active_errors=counts,
    )
