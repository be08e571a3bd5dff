"""Wire types for the tpud API (v1), on NVIDIA GPU hosts.

These are the core data types exchanged between components, the local HTTP
API, the client SDK, and the control-plane session. They mirror the semantic
surface of the reference daemon's API types (reference: api/v1/types.go:17-259).
This module holds health states, repair actions, suggested actions, events,
metrics and the component wrappers; the machine and GPU inventory types come
with the device-free daemon.

Everything is a plain dataclass with explicit ``to_dict``/``from_dict`` so
the JSON wire format is stable and dependency-free.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


# ---------------------------------------------------------------------------
# Health states (reference: api/v1/types.go:18-25)
# ---------------------------------------------------------------------------

class HealthStateType:
    HEALTHY = "Healthy"
    UNHEALTHY = "Unhealthy"
    DEGRADED = "Degraded"
    INITIALIZING = "Initializing"


class ComponentType:
    CUSTOM_PLUGIN = "custom-plugin"


class RunModeType:
    AUTO = "auto"
    MANUAL = "manual"


# ---------------------------------------------------------------------------
# Suggested actions (reference: api/v1/types.go:183-221)
# ---------------------------------------------------------------------------

class RepairActionType:
    IGNORE_NO_ACTION_REQUIRED = "IGNORE_NO_ACTION_REQUIRED"
    REBOOT_SYSTEM = "REBOOT_SYSTEM"
    HARDWARE_INSPECTION = "HARDWARE_INSPECTION"
    CHECK_USER_APP_AND_GPU = "CHECK_USER_APP_AND_GPU"
    # minted by the predict engine ahead of a hard
    # fault; advisory only — map_suggested_action never resolves it to an
    # executable action, so it can never leave dry-run
    PREDICTED_DEGRADATION = "PREDICTED_DEGRADATION"


@dataclass
class SuggestedActions:
    description: str = ""
    repair_actions: List[str] = field(default_factory=list)

    def describe_actions(self) -> str:
        return ", ".join(self.repair_actions)

    def to_dict(self) -> Dict[str, Any]:
        return {"description": self.description, "repair_actions": list(self.repair_actions)}

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["SuggestedActions"]:
        if not d:
            return None
        return cls(
            description=d.get("description", ""),
            repair_actions=list(d.get("repair_actions", []) or []),
        )


# ---------------------------------------------------------------------------
# Event types (reference: api/v1/types.go:222-259)
# ---------------------------------------------------------------------------

class EventType:
    UNKNOWN = "Unknown"
    INFO = "Info"          # informative, no action needed
    WARNING = "Warning"    # may impact workloads, automatic recovery expected
    CRITICAL = "Critical"  # impacting workloads, action required, not hardware
    FATAL = "Fatal"        # hardware/system-wide, may require reboot/repair

    _ALL = ("Info", "Warning", "Critical", "Fatal")

    @staticmethod
    def from_string(s: str) -> str:
        return s if s in EventType._ALL else EventType.UNKNOWN


# ---------------------------------------------------------------------------
# HealthState (reference: api/v1/types.go:46-100)
# ---------------------------------------------------------------------------

@dataclass
class HealthState:
    time: float = 0.0  # unix seconds
    component: str = ""
    component_type: str = ""
    name: str = ""
    run_mode: str = ""
    health: str = HealthStateType.HEALTHY
    reason: str = ""
    error: str = ""
    suggested_actions: Optional[SuggestedActions] = None
    extra_info: Dict[str, str] = field(default_factory=dict)
    raw_output: str = ""

    MAX_RAW_OUTPUT = 4096

    def __post_init__(self) -> None:
        if not self.time:
            self.time = _time.time()
        if len(self.raw_output) > self.MAX_RAW_OUTPUT:
            self.raw_output = self.raw_output[: self.MAX_RAW_OUTPUT]

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"time": self.time, "health": self.health}
        for k in ("component", "component_type", "name", "run_mode", "reason", "error", "raw_output"):
            v = getattr(self, k)
            if v:
                d[k] = v
        if self.suggested_actions is not None:
            d["suggested_actions"] = self.suggested_actions.to_dict()
        if self.extra_info:
            d["extra_info"] = dict(self.extra_info)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HealthState":
        return cls(
            time=float(d.get("time", 0.0)),
            component=d.get("component", ""),
            component_type=d.get("component_type", ""),
            name=d.get("name", ""),
            run_mode=d.get("run_mode", ""),
            health=d.get("health", HealthStateType.HEALTHY),
            reason=d.get("reason", ""),
            error=d.get("error", ""),
            suggested_actions=SuggestedActions.from_dict(d.get("suggested_actions")),
            extra_info=dict(d.get("extra_info", {}) or {}),
            raw_output=d.get("raw_output", ""),
        )


# ---------------------------------------------------------------------------
# Event (reference: api/v1/types.go:102-136)
# ---------------------------------------------------------------------------

@dataclass
class Event:
    component: str = ""
    time: float = 0.0
    name: str = ""
    type: str = EventType.INFO
    message: str = ""
    # structured payload carried alongside the event, e.g. the raw GPU error
    # detail the way xid events carry their payload in ExtraInfo
    # (reference: xid/component.go:545-570)
    extra_info: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.time:
            self.time = _time.time()

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "component": self.component,
            "time": self.time,
            "name": self.name,
            "type": self.type,
            "message": self.message,
        }
        if self.extra_info:
            d["extra_info"] = dict(self.extra_info)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Event":
        return cls(
            component=d.get("component", ""),
            time=float(d.get("time", 0.0)),
            name=d.get("name", ""),
            type=d.get("type", EventType.INFO),
            message=d.get("message", ""),
            extra_info=dict(d.get("extra_info", {}) or {}),
        )


# ---------------------------------------------------------------------------
# Metric (reference: api/v1/types.go:138-150)
# ---------------------------------------------------------------------------

@dataclass
class Metric:
    unix_seconds: int = 0
    name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    value: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "unix_seconds": self.unix_seconds,
            "name": self.name,
            "value": self.value,
        }
        if self.labels:
            d["labels"] = dict(self.labels)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Metric":
        return cls(
            unix_seconds=int(d.get("unix_seconds", 0)),
            name=d.get("name", ""),
            labels=dict(d.get("labels", {}) or {}),
            value=float(d.get("value", 0.0)),
        )


# ---------------------------------------------------------------------------
# Aggregate wire envelopes (reference: api/v1/types.go:97-176)
# ---------------------------------------------------------------------------

@dataclass
class ComponentHealthStates:
    component: str = ""
    states: List[HealthState] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"component": self.component, "states": [s.to_dict() for s in self.states]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ComponentHealthStates":
        return cls(
            component=d.get("component", ""),
            states=[HealthState.from_dict(x) for x in d.get("states", []) or []],
        )


@dataclass
class ComponentEvents:
    component: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    events: List[Event] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "component": self.component,
            "startTime": self.start_time,
            "endTime": self.end_time,
            "events": [e.to_dict() for e in self.events],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ComponentEvents":
        return cls(
            component=d.get("component", ""),
            start_time=float(d.get("startTime", 0.0)),
            end_time=float(d.get("endTime", 0.0)),
            events=[Event.from_dict(x) for x in d.get("events", []) or []],
        )


@dataclass
class ComponentMetrics:
    component: str = ""
    metrics: List[Metric] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"component": self.component, "metrics": [m.to_dict() for m in self.metrics]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ComponentMetrics":
        return cls(
            component=d.get("component", ""),
            metrics=[Metric.from_dict(x) for x in d.get("metrics", []) or []],
        )


@dataclass
class ComponentInfo:
    component: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    states: List[HealthState] = field(default_factory=list)
    events: List[Event] = field(default_factory=list)
    metrics: List[Metric] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "component": self.component,
            "startTime": self.start_time,
            "endTime": self.end_time,
            "info": {
                "states": [s.to_dict() for s in self.states],
                "events": [e.to_dict() for e in self.events],
                "metrics": [m.to_dict() for m in self.metrics],
            },
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ComponentInfo":
        info = d.get("info", {}) or {}
        return cls(
            component=d.get("component", ""),
            start_time=float(d.get("startTime", 0.0)),
            end_time=float(d.get("endTime", 0.0)),
            states=[HealthState.from_dict(x) for x in info.get("states", []) or []],
            events=[Event.from_dict(x) for x in info.get("events", []) or []],
            metrics=[Metric.from_dict(x) for x in info.get("metrics", []) or []],
        )
