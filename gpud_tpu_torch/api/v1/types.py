"""Wire types for the tpud API (v1), on NVIDIA GPU hosts.

These are the core data types exchanged between components, the local HTTP
API, the client SDK, and the control-plane session. They mirror the semantic
surface of the reference daemon's API types (reference: api/v1/types.go:17-259).
This module holds health states, repair actions, suggested actions, events,
metrics, the component wrappers, the block-device tree the disk check
reads, the package status, the machine and GPU inventory (``MachineInfo``
with ``GPUInfo`` where the reference package has ``TPUInfo``), the login
request and response and the gossip request.

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


# ---------------------------------------------------------------------------
# Block-device tree (reference package: gpud_tpu/api/v1/types.py)
# ---------------------------------------------------------------------------

@dataclass
class BlockDeviceInfo:
    """One node of the block-device tree (reference:
    pkg/machine-info/machine_info.go:45-434 builds the lsblk-style
    disk tree; here it is read from /sys/block directly)."""

    name: str = ""
    type: str = "disk"          # disk | part
    size_bytes: int = 0
    model: str = ""
    rotational: bool = False
    removable: bool = False
    mount_point: str = ""
    fstype: str = ""
    used_bytes: int = 0
    children: List["BlockDeviceInfo"] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "type": self.type,
            "size_bytes": self.size_bytes,
            "model": self.model,
            "rotational": self.rotational,
            "removable": self.removable,
            "mount_point": self.mount_point,
            "fstype": self.fstype,
            "used_bytes": self.used_bytes,
        }
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BlockDeviceInfo":
        return cls(
            name=d.get("name", ""),
            type=d.get("type", "disk"),
            size_bytes=int(d.get("size_bytes", 0)),
            model=d.get("model", ""),
            rotational=bool(d.get("rotational", False)),
            removable=bool(d.get("removable", False)),
            mount_point=d.get("mount_point", ""),
            fstype=d.get("fstype", ""),
            used_bytes=int(d.get("used_bytes", 0)),
            children=[
                cls.from_dict(c) for c in d.get("children", []) or []
            ],
        )


# ---------------------------------------------------------------------------
# Package status (reference: api/v1/types.go:167-181)
# ---------------------------------------------------------------------------

class PackagePhase:
    INSTALLED = "Installed"
    INSTALLING = "Installing"
    UNKNOWN = "Unknown"
    SKIPPED = "Skipped"


@dataclass
class PackageStatus:
    name: str = ""
    phase: str = PackagePhase.UNKNOWN
    status: str = ""
    current_version: str = ""
    target_version: str = ""
    progress: int = 0
    is_installed: bool = False
    installing: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "phase": self.phase,
            "status": self.status,
            "current_version": self.current_version,
            "target_version": self.target_version,
            "progress": self.progress,
            "is_installed": self.is_installed,
            "installing": self.installing,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PackageStatus":
        return cls(
            name=d.get("name", ""),
            phase=d.get("phase", PackagePhase.UNKNOWN),
            status=d.get("status", ""),
            current_version=d.get("current_version", ""),
            target_version=d.get("target_version", ""),
            progress=int(d.get("progress", 0)),
            is_installed=bool(d.get("is_installed", False)),
            installing=bool(d.get("installing", False)),
        )


# ---------------------------------------------------------------------------
# Machine info tree (reference package: gpud_tpu/api/v1/types.py, TPUInfo
# and TPUChipInfo; reference: api/v1/types.go MachineGPUInfo and
# MachineGPUInstance) — GPU edition
# ---------------------------------------------------------------------------

@dataclass
class GPUDeviceInfo:
    """One GPU of the host (reference: api/v1/types.go MachineGPUInstance):
    its UUID, serial number, minor number (``/dev/nvidia<minor>``) and PCI
    bus id."""

    uuid: str = ""
    serial: str = ""
    minor_number: int = -1
    pci_bus_id: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "uuid": self.uuid,
            "serial": self.serial,
            "minor_number": self.minor_number,
            "pci_bus_id": self.pci_bus_id,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GPUDeviceInfo":
        return cls(
            uuid=d.get("uuid", ""),
            serial=d.get("serial", ""),
            minor_number=int(d.get("minor_number", -1)),
            pci_bus_id=d.get("pci_bus_id", ""),
        )


@dataclass
class GPUInfo:
    """The host's GPUs, reported in MachineInfo where the reference package
    reports ``TPUInfo`` (reference: api/v1/types.go MachineGPUInfo, with the
    driver and CUDA versions beside it)."""

    product: str = ""             # e.g. "NVIDIA H100 80GB HBM3"
    manufacturer: str = ""        # "NVIDIA"
    architecture: str = ""        # e.g. "hopper"
    driver_version: str = ""
    cuda_version: str = ""        # the CUDA version the driver supports
    memory_total_bytes: int = 0   # per GPU
    gpus: List[GPUDeviceInfo] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "product": self.product,
            "manufacturer": self.manufacturer,
            "architecture": self.architecture,
            "driver_version": self.driver_version,
            "cuda_version": self.cuda_version,
            "memory_total_bytes": self.memory_total_bytes,
            "gpus": [g.to_dict() for g in self.gpus],
        }

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> Optional["GPUInfo"]:
        if not d:
            return None
        return cls(
            product=d.get("product", ""),
            manufacturer=d.get("manufacturer", ""),
            architecture=d.get("architecture", ""),
            driver_version=d.get("driver_version", ""),
            cuda_version=d.get("cuda_version", ""),
            memory_total_bytes=int(d.get("memory_total_bytes", 0)),
            gpus=[GPUDeviceInfo.from_dict(g) for g in d.get("gpus", []) or []],
        )


@dataclass
class DiskInfo:
    device: str = ""
    mount_point: str = ""
    fstype: str = ""
    total_bytes: int = 0
    used_bytes: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "device": self.device,
            "mount_point": self.mount_point,
            "fstype": self.fstype,
            "total_bytes": self.total_bytes,
            "used_bytes": self.used_bytes,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DiskInfo":
        return cls(
            device=d.get("device", ""),
            mount_point=d.get("mount_point", ""),
            fstype=d.get("fstype", ""),
            total_bytes=int(d.get("total_bytes", 0)),
            used_bytes=int(d.get("used_bytes", 0)),
        )


@dataclass
class NICInfo:
    name: str = ""
    mac: str = ""
    addresses: List[str] = field(default_factory=list)
    mtu: int = 0
    speed_mbps: int = 0
    driver: str = ""       # kernel driver bound to the device (gve, virtio_net, ...)
    virtual: bool = False  # no backing device in /sys/class/net/<nic>/device

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "mac": self.mac,
            "addresses": list(self.addresses),
            "mtu": self.mtu,
            "speed_mbps": self.speed_mbps,
            "driver": self.driver,
            "virtual": self.virtual,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NICInfo":
        return cls(
            name=d.get("name", ""),
            mac=d.get("mac", ""),
            addresses=list(d.get("addresses", []) or []),
            mtu=int(d.get("mtu", 0)),
            speed_mbps=int(d.get("speed_mbps", 0)),
            driver=d.get("driver", ""),
            virtual=bool(d.get("virtual", False)),
        )


@dataclass
class MachineInfo:
    """Host description sent in the login/gossip requests
    (reference: api/v1/types.go:261-361)."""

    machine_id: str = ""
    hostname: str = ""
    os: str = ""
    kernel_version: str = ""
    boot_id: str = ""
    uptime_seconds: int = 0
    cpu_model: str = ""
    cpu_logical_cores: int = 0
    memory_total_bytes: int = 0
    provider: str = ""
    region: str = ""
    instance_type: str = ""
    public_ip: str = ""
    private_ip: str = ""
    tpud_version: str = ""
    containerized: bool = False
    gpu_info: Optional[GPUInfo] = None
    disks: List[DiskInfo] = field(default_factory=list)
    nics: List[NICInfo] = field(default_factory=list)
    block_devices: List[BlockDeviceInfo] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "machine_id": self.machine_id,
            "hostname": self.hostname,
            "os": self.os,
            "kernel_version": self.kernel_version,
            "boot_id": self.boot_id,
            "uptime_seconds": self.uptime_seconds,
            "cpu_model": self.cpu_model,
            "cpu_logical_cores": self.cpu_logical_cores,
            "memory_total_bytes": self.memory_total_bytes,
            "provider": self.provider,
            "region": self.region,
            "instance_type": self.instance_type,
            "public_ip": self.public_ip,
            "private_ip": self.private_ip,
            "tpud_version": self.tpud_version,
            "containerized": self.containerized,
            "disks": [x.to_dict() for x in self.disks],
            "nics": [x.to_dict() for x in self.nics],
            "block_devices": [x.to_dict() for x in self.block_devices],
        }
        if self.gpu_info is not None:
            d["gpu_info"] = self.gpu_info.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MachineInfo":
        return cls(
            machine_id=d.get("machine_id", ""),
            hostname=d.get("hostname", ""),
            os=d.get("os", ""),
            kernel_version=d.get("kernel_version", ""),
            boot_id=d.get("boot_id", ""),
            uptime_seconds=int(d.get("uptime_seconds", 0)),
            cpu_model=d.get("cpu_model", ""),
            cpu_logical_cores=int(d.get("cpu_logical_cores", 0)),
            memory_total_bytes=int(d.get("memory_total_bytes", 0)),
            provider=d.get("provider", ""),
            region=d.get("region", ""),
            instance_type=d.get("instance_type", ""),
            public_ip=d.get("public_ip", ""),
            private_ip=d.get("private_ip", ""),
            tpud_version=d.get("tpud_version", ""),
            containerized=bool(d.get("containerized", False)),
            gpu_info=GPUInfo.from_dict(d.get("gpu_info")),
            disks=[DiskInfo.from_dict(x) for x in d.get("disks", []) or []],
            nics=[NICInfo.from_dict(x) for x in d.get("nics", []) or []],
            block_devices=[
                BlockDeviceInfo.from_dict(x)
                for x in d.get("block_devices", []) or []
            ],
        )


# ---------------------------------------------------------------------------
# Login / gossip (reference: api/v1/login.go:6-80, api/v1/gossip.go:3-13)
# ---------------------------------------------------------------------------

@dataclass
class LoginRequest:
    token: str = ""
    machine_id: str = ""
    network: Dict[str, str] = field(default_factory=dict)
    machine_info: Optional[MachineInfo] = None
    node_labels: Dict[str, str] = field(default_factory=dict)
    provider: str = ""
    region: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "token": self.token,
            "machine_id": self.machine_id,
            "network": dict(self.network),
            "node_labels": dict(self.node_labels),
            "provider": self.provider,
            "region": self.region,
        }
        if self.machine_info is not None:
            d["machine_info"] = self.machine_info.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LoginRequest":
        # the manager side decodes what the agent encodes (the reference
        # only ships the agent; our runnable control plane needs both
        # directions of the login wire type)
        return cls(
            token=d.get("token", ""),
            machine_id=d.get("machine_id", ""),
            network=dict(d.get("network", {}) or {}),
            machine_info=(
                MachineInfo.from_dict(d["machine_info"])
                if d.get("machine_info")
                else None
            ),
            node_labels=dict(d.get("node_labels", {}) or {}),
            provider=d.get("provider", ""),
            region=d.get("region", ""),
        )


@dataclass
class LoginResponse:
    machine_id: str = ""
    token: str = ""
    machine_proof: str = ""
    error: str = ""
    status: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "machine_id": self.machine_id,
            "token": self.token,
            "machine_proof": self.machine_proof,
            "error": self.error,
            "status": self.status,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "LoginResponse":
        return cls(
            machine_id=d.get("machine_id", ""),
            token=d.get("token", ""),
            machine_proof=d.get("machine_proof", ""),
            error=d.get("error", ""),
            status=d.get("status", ""),
        )


@dataclass
class GossipRequest:
    machine_id: str = ""
    machine_info: Optional[MachineInfo] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"machine_id": self.machine_id}
        if self.machine_info is not None:
            d["machine_info"] = self.machine_info.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GossipRequest":
        return cls(
            machine_id=d.get("machine_id", ""),
            machine_info=(
                MachineInfo.from_dict(d["machine_info"])
                if d.get("machine_info")
                else None
            ),
        )
