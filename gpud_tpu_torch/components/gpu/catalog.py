"""NVIDIA GPU kernel-error catalog: Xid and SXid codes, and host-wide lines.

The port's counterpart of ``gpud_tpu/components/tpu/catalog.py`` (reference:
components/accelerator/nvidia/xid/catalog_generated.go and the NVSwitch SXid
catalog). Three groups:

- **Xid** lines, which the NVIDIA driver prints per GPU as
  ``NVRM: Xid (PCI:0000:18:00): 79, pid=..., GPU has fallen off the bus.``
  Which codes are listed, and the kind of fault each one reports
  (application, GPU memory ECC, row remapping, NVLink, the bus, the GPU
  System Processor), follow NVIDIA's Xid catalog,
  https://docs.nvidia.com/deploy/xid-errors/index.html. A code not in the
  table matches nothing.
- **SXid** lines, which the NVSwitch driver prints as
  ``nvidia-nvswitchN: SXid (PCI:...): <code>, <Fatal|Non-fatal>, ...``.
  They are attributed to no GPU, and classed by the severity word the
  driver printed: no SXid code has an entry of its own.
- **Host-wide** kernel formats carried over from the reference package
  (EDAC, MCE, thermal, power, PCIe AER/DPC, IOMMU, vfio), with the TPU
  driver's tokens replaced by the NVIDIA driver's (``nvidia``, ``NVRM``).

``code`` is the Xid number for an Xid entry; the two SXid severity classes
take 10000 and 10001, and a host-wide entry takes 1000 plus its code in the
reference package. The daemon's own injection format, ``GPU-ERR: <name>
gpu=<N>``, matches every entry, so injected and organic faults share one
detection path.

Each entry carries the reboot threshold that drives the reboot →
HARDWARE_INSPECTION escalation (reference: xid/threshold.go +
health_state.go:56-80). For the Xid and SXid entries, the event type, the
repair actions, the threshold and whether the fault is critical are the
port's choice, not NVIDIA's: each kind of fault takes those of the
reference package's entry for the same kind of fault on a TPU, named where
the kind is defined below (tests/test_torch_xid_catalog.py holds them
equal). Row remapping is the exception: like the reference GPUd, which
leaves Xid 63 and 64 to its remapped-rows check (xid/component.go:285-295),
these lines carry no action, and the GPU memory check reads the pending
remap from NVML.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Pattern, Tuple

from gpud_tpu_torch.api.v1.types import EventType, RepairActionType
from gpud_tpu_torch import native as _native


@dataclass(frozen=True)
class CatalogEntry:
    code: int
    name: str
    pattern: Pattern
    event_type: str
    description: str
    repair_actions: tuple = ()
    # after this many reboots with the error recurring, escalate to
    # HARDWARE_INSPECTION (reference: xid/threshold.go). 0 = never escalate.
    reboot_threshold: int = 1
    # does this error impact workloads (drives Unhealthy vs informational)?
    critical: bool = True
    # lines matching this are NOT this error (e.g. AER lines from known
    # non-GPU drivers); keeps host-wide kernel formats device-scoped
    exclude: Optional[Pattern] = None


def _e(
    code: int,
    name: str,
    regex: str,
    event_type: str,
    description: str,
    repair: tuple,
    reboot_threshold: int = 1,
    critical: bool = True,
    exclude: str = "",
) -> CatalogEntry:
    return CatalogEntry(
        code=code,
        name=name,
        # every entry also matches its own injection line
        pattern=re.compile(rf"{regex}|GPU-ERR: {name}\b", re.IGNORECASE),
        event_type=event_type,
        description=description,
        repair_actions=repair,
        reboot_threshold=reboot_threshold,
        critical=critical,
        exclude=re.compile(exclude, re.IGNORECASE) if exclude else None,
    )


def _xid(code: int) -> str:
    """The driver's Xid line for one code: ``NVRM: Xid (PCI:0000:18:00): 79,``."""
    return rf"NVRM: Xid \((?:PCI:)?[0-9a-f:.]+\): {code}\b"


def _sxid(severity: str) -> str:
    """The NVSwitch driver's SXid line that carries the severity word (the
    lines that follow it with the same code carry ``Severity N`` or
    ``Data``, and would count one error twice)."""
    return rf"SXid \((?:PCI:)?[0-9a-f:.]+\): \d+, {severity}\b"


# AER/PCIe kernel formats are host-wide; lines clearly attributed to common
# non-GPU device drivers must not be classified as GPU errors
_NON_GPU_DRIVERS = r"\b(nvme|ahci|e1000\w*|mlx\d\w*|ixgbe|igb|r8169|virtio|xhci|usb)\b"


_REBOOT = (RepairActionType.REBOOT_SYSTEM,)
_HW = (RepairActionType.HARDWARE_INSPECTION,)
_REBOOT_HW = (RepairActionType.REBOOT_SYSTEM, RepairActionType.HARDWARE_INSPECTION)
_NONE = (RepairActionType.IGNORE_NO_ACTION_REQUIRED,)
_APP = (RepairActionType.CHECK_USER_APP_AND_GPU,)

SXID_NONFATAL, SXID_FATAL = 10000, 10001

# The classification of each kind of Xid/SXid fault: the reference
# package's entry for the same kind of fault on a TPU
# (gpud_tpu/components/tpu/catalog.py), by name
_LIKE_HBM_OOM = dict(  # tpu_hbm_oom: the application's fault
    event_type=EventType.WARNING, repair=_APP, reboot_threshold=0, critical=False)
_LIKE_HBM_ECC_UE = dict(  # tpu_hbm_ecc_uncorrectable
    event_type=EventType.FATAL, repair=_REBOOT_HW, reboot_threshold=1)
_LIKE_ICI_LINK_DOWN = dict(  # tpu_ici_link_down
    event_type=EventType.CRITICAL, repair=_REBOOT_HW, reboot_threshold=2)
_LIKE_CHIP_LOST = dict(  # tpu_chip_lost
    event_type=EventType.FATAL, repair=_REBOOT_HW, reboot_threshold=2)
_LIKE_DRIVER_TIMEOUT = dict(  # tpu_driver_timeout
    event_type=EventType.CRITICAL, repair=_REBOOT, reboot_threshold=2)
_LIKE_DRIVER_CRASH = dict(  # tpu_driver_crash: the driver or its firmware
    event_type=EventType.FATAL, repair=_REBOOT_HW, reboot_threshold=2)
_LIKE_ICI_PORT_ERROR = dict(  # tpu_ici_port_error
    event_type=EventType.CRITICAL, repair=_REBOOT_HW, reboot_threshold=2)
_LIKE_ICI_LINK_FLAP = dict(  # tpu_ici_link_flap: the fabric rode it out
    event_type=EventType.WARNING, repair=_NONE, reboot_threshold=3, critical=False)
# row remapping: left to the GPU memory check (the reference GPUd's rule)
_LEFT_TO_MEMORY_CHECK = dict(
    event_type=EventType.WARNING, repair=_NONE, reboot_threshold=0, critical=False)

# NOTE: match() is first-hit-wins, so entries are ordered most-specific-first:
# the Xid and SXid entries (anchored on the driver's own line) before the
# host-wide formats, and within each section as in the reference package.
CATALOG: List[CatalogEntry] = [
    # --- Xid: the application's fault ---------------------------------------
    _e(13, "gpu_app_xid13", _xid(13), description="Xid 13: application fault",
       **_LIKE_HBM_OOM),
    _e(31, "gpu_app_xid31", _xid(31), description="Xid 31: application fault",
       **_LIKE_HBM_OOM),
    _e(43, "gpu_app_xid43", _xid(43), description="Xid 43: application fault",
       **_LIKE_HBM_OOM),
    _e(45, "gpu_app_xid45", _xid(45), description="Xid 45: application fault",
       **_LIKE_HBM_OOM),
    # --- Xid: GPU memory ECC --------------------------------------------------
    _e(48, "gpu_ecc_xid48", _xid(48), description="Xid 48: GPU memory ECC error",
       **_LIKE_HBM_ECC_UE),
    _e(94, "gpu_ecc_xid94", _xid(94), description="Xid 94: GPU memory ECC error",
       **_LIKE_HBM_ECC_UE),
    _e(95, "gpu_ecc_xid95", _xid(95), description="Xid 95: GPU memory ECC error",
       **_LIKE_HBM_ECC_UE),
    _e(140, "gpu_ecc_xid140", _xid(140), description="Xid 140: GPU memory ECC error",
       **_LIKE_HBM_ECC_UE),
    _e(63, "gpu_row_remap_xid63", _xid(63),
       description="Xid 63: GPU memory row remapping (the GPU memory check reads the "
                   "pending remap)",
       **_LEFT_TO_MEMORY_CHECK),
    _e(64, "gpu_row_remap_xid64", _xid(64),
       description="Xid 64: GPU memory row remapping (the GPU memory check reads the "
                   "pending remap)",
       **_LEFT_TO_MEMORY_CHECK),
    # --- Xid: bus, NVLink, GSP ----------------------------------------------------
    _e(79, "gpu_fallen_off_bus", _xid(79), description="Xid 79: GPU has fallen off the bus",
       **_LIKE_CHIP_LOST),
    _e(74, "gpu_nvlink_error", _xid(74), description="Xid 74: NVLink error",
       **_LIKE_ICI_LINK_DOWN),
    _e(119, "gpu_gsp_xid119", _xid(119),
       description="Xid 119: GSP (GPU System Processor) timeout", **_LIKE_DRIVER_TIMEOUT),
    _e(120, "gpu_gsp_xid120", _xid(120),
       description="Xid 120: GSP (GPU System Processor) error", **_LIKE_DRIVER_CRASH),
    # --- SXid (NVSwitch), by the severity word the driver printed -------------------
    _e(SXID_FATAL, "gpu_nvswitch_fatal", _sxid("fatal"),
       description="fatal NVSwitch error (SXid)", **_LIKE_ICI_PORT_ERROR),
    _e(SXID_NONFATAL, "gpu_nvswitch_nonfatal", _sxid("non-fatal"),
       description="non-fatal NVSwitch error (SXid)", **_LIKE_ICI_LINK_FLAP),
    # --- host-wide: memory (EDAC, MCE) ------------------------------------
    _e(1018, "gpu_edac_uncorrectable",
       r"EDAC.*(\bUE\b|[Uu]ncorrect)",
       EventType.FATAL,
       "EDAC uncorrectable memory error",
       _REBOOT_HW, reboot_threshold=1),
    _e(1019, "gpu_edac_correctable",
       r"EDAC.*(\bCE\b|correct)",
       EventType.WARNING,
       "EDAC correctable memory error (tracked for trends)",
       _NONE, reboot_threshold=0, critical=False),
    # memory-anchored only: "mce: [Hardware Error]: Machine check events
    # logged" replays at every boot on any host with MCE history and must
    # not alarm
    _e(1017, "gpu_host_mce_memory",
       r"Machine [Cc]heck.*memory|mce:.*memory (read|write|scrub)\w* error",
       EventType.FATAL,
       "machine-check memory error (host memory path)",
       _REBOOT_HW, reboot_threshold=1),
    # --- host-wide: thermal / power ---------------------------------------
    _e(1031, "gpu_power_fault",
       r"(NVRM|nvidia).*(power (fault|brownout|supply failure))",
       EventType.FATAL,
       "GPU power delivery fault",
       _HW, reboot_threshold=1),
    _e(1034, "gpu_vrm_fault",
       r"(VRM|voltage regulator).*(fault|overcurrent|failure)",
       EventType.FATAL,
       "voltage-regulator fault on the GPU power path",
       _HW, reboot_threshold=1),
    _e(1030, "gpu_thermal_trip",
       r"(NVRM|nvidia).*(thermal (trip|shutdown|throttl)|overtemp)",
       EventType.CRITICAL,
       "GPU thermal trip/throttle",
       _HW, reboot_threshold=2),
    _e(1033, "gpu_power_throttle",
       r"(NVRM|nvidia).*power.*throttl|power (cap|limit).*(throttl|engaged)",
       EventType.WARNING,
       "GPU power throttling engaged",
       _NONE, reboot_threshold=0, critical=False),
    # GPU-attributed lines only — generic ACPI thermal_zone trips fire on
    # CPU/board zones of healthy hosts
    _e(1032, "gpu_thermal_warning",
       r"(NVRM|nvidia).*temperature.*(above|exceed|warning)",
       EventType.WARNING,
       "GPU temperature above warning threshold",
       _NONE, reboot_threshold=0, critical=False),
    # --- host-wide: PCIe --------------------------------------------------
    # A vfio-pci-bound function on a GPU host is a GPU passed through to a
    # guest, so a vfio-pci-attributed AER line is GPU-scoped. Ordering:
    # recovery-failed (most severe) before the generic vfio-AER entries;
    # corrected before uncorrected so a benign corrected burst never
    # escalates (\bcorrected\b does not match inside "Uncorrected").
    # Kernel format: drivers/pci/pcie/err.c pcie_do_recovery
    _e(1046, "gpu_pcie_recovery_failed",
       r"(pcieport|vfio-pci).*(AER: )?device recovery failed",
       EventType.FATAL,
       "PCIe error recovery failed — device needs reset/replacement",
       _REBOOT_HW, reboot_threshold=1, exclude=_NON_GPU_DRIVERS),
    # Kernel format: drivers/pci/pcie/aer.c aer_print_error
    _e(1063, "gpu_vfio_aer_correctable",
       r"vfio-pci [0-9a-f:.]+.*(severity=Corrected|Corrected error received)",
       EventType.WARNING,
       "corrected PCIe AER error on a vfio-bound GPU function",
       _NONE, reboot_threshold=0, critical=False),
    _e(1045, "gpu_vfio_aer",
       r"vfio-pci [0-9a-f:.]+.*(AER|PCIe Bus Error)",
       EventType.CRITICAL,
       "uncorrected PCIe AER error on a vfio-bound GPU function",
       _REBOOT_HW, reboot_threshold=2,
       exclude=r"\bcorrected\b"),
    _e(1040, "gpu_pcie_uncorrectable",
       r"pcieport.*AER.*(uncorrect|fatal)",
       EventType.CRITICAL,
       "PCIe uncorrectable error on the GPU path",
       _REBOOT_HW, reboot_threshold=2),
    # Kernel format: drivers/pci/hotplug/pciehp_ctrl.c ("Slot(%s): Link Down")
    _e(1047, "gpu_pcie_slot_link_down",
       r"pciehp .*Slot\([^)]*\): (Link Down|Card not present)",
       EventType.FATAL,
       "hotplug slot link down — device dropped off the bus",
       _REBOOT_HW, reboot_threshold=1, exclude=_NON_GPU_DRIVERS),
    _e(1043, "gpu_pcie_surprise_down",
       r"pcie\w*.*[Ss]urprise ([Ll]ink )?[Dd]own",
       EventType.FATAL,
       "PCIe surprise link down — device dropped off the bus",
       _REBOOT_HW, reboot_threshold=1, exclude=_NON_GPU_DRIVERS),
    _e(1044, "gpu_pcie_completion_timeout",
       r"(pcie\w*|AER).*[Cc]ompletion [Tt]imeout",
       EventType.CRITICAL,
       "PCIe completion timeout on the GPU path",
       _REBOOT, reboot_threshold=2, exclude=_NON_GPU_DRIVERS),
    # Kernel format: drivers/pci/pcie/dpc.c. The line names only the root
    # port, never the child device, so it stays informational: if the
    # contained device was a GPU, gpu-counts flips health when it detaches.
    _e(1064, "gpu_pcie_dpc_containment",
       r"pcieport .*DPC: (containment event|unmasked uncorrectable error detected)",
       EventType.WARNING,
       "PCIe downstream port containment (root-port attributed; correlate with GPU loss)",
       _NONE, reboot_threshold=0, critical=False),
    # second arm: drivers/pci/pci.c pcie_report_downtraining, anchored to
    # the GPU's bound driver only (the bare "pci" print fires for every
    # downtrained device at enumeration)
    _e(1042, "gpu_pcie_link_downgrade",
       r"pcie.*(link.*(downgrad|degrad)|speed dropped|downtrain)"
       r"|(vfio-pci|nvidia) [0-9a-f:.]+:.*available PCIe bandwidth, limited by",
       EventType.WARNING,
       "PCIe link trained below expected speed/width",
       _HW, reboot_threshold=2, critical=False,
       exclude=_NON_GPU_DRIVERS),
    _e(1041, "gpu_pcie_correctable",
       r"pcieport.*AER.*correct",
       EventType.WARNING,
       "PCIe correctable errors on the GPU path",
       _NONE, reboot_threshold=0, critical=False),
    # --- host-wide: driver binding (vfio) ---------------------------------
    # Kernel format: drivers/vfio/pci/vfio_pci_core.c vfio_pci_core_request
    _e(1048, "gpu_dev_unbind_requested",
       r"vfio-pci [0-9a-f:.]+.*Relaying device request to user|(NVRM|nvidia).*(unbind|unregister)",
       EventType.WARNING,
       "device unbind requested while the GPU is in use",
       _APP, reboot_threshold=0, critical=False),
    # Kernel format: drivers/vfio/pci/vfio_pci_core.c vfio_bar_restore
    _e(1049, "gpu_vfio_reset_recovery",
       r"vfio-pci [0-9a-f:.]+.*reset recovery - restoring BARs",
       EventType.CRITICAL,
       "GPU function reset behind its user (BARs restored)",
       _REBOOT, reboot_threshold=2),
    # --- host-wide: IOMMU -------------------------------------------------
    # device-attributed formats only (the generic "DMAR: DRHD: handling
    # fault status" line appears on healthy hosts); informational
    _e(1056, "gpu_iommu_fault",
       r"DMAR: \[DMA (Read|Write)[^\]]*\].*Request device|AMD-Vi.*IO_PAGE_FAULT"
       r"|iommu.*page fault.*(nvidia|NVRM)",
       EventType.WARNING,
       "IOMMU DMA fault (device attribution best-effort; correlate BDF with the GPU)",
       _NONE, reboot_threshold=0, critical=False,
       exclude=_NON_GPU_DRIVERS),
    # --- host-wide: the rest ----------------------------------------------
    # Kernel format: drivers/acpi/apei/ghes.c / CPER decode — host DIMM path
    _e(1058, "gpu_host_mem_ghes",
       r"\{\d+\}\[Hardware Error\]:.*memory error|ghes.*memory error",
       EventType.WARNING,
       "APEI/GHES host memory error (DIMM path, not GPU memory)",
       _NONE, reboot_threshold=0, critical=False),
    # Kernel format: drivers/pci/pci.c pci_dev_wait ("not ready %dms after
    # %s; giving up"), with the GPU's bound-driver prefix
    _e(1065, "gpu_pcie_not_ready",
       r"(vfio-pci|nvidia) [0-9a-f:.]+:.*not ready \d+ms after (FLR|bus reset|resume|PM D3hot->D0); giving up",
       EventType.FATAL,
       "GPU did not come back after reset/resume — device lost until reboot",
       _REBOOT_HW, reboot_threshold=1, exclude=_NON_GPU_DRIVERS),
    # Kernel format: drivers/pci/pci.c pcie_flr
    _e(1066, "gpu_pcie_flr_timeout",
       r"(vfio-pci|nvidia) [0-9a-f:.]+:.*timed out waiting for pending transaction",
       EventType.WARNING,
       "pending DMA did not drain before the GPU's function-level reset",
       _NONE, reboot_threshold=0, critical=False,
       exclude=_NON_GPU_DRIVERS),
    # Kernel format: drivers/thermal/thermal_core.c thermal_zone_device_critical
    _e(1067, "gpu_host_thermal_critical",
       r"thermal thermal_zone\d+: .*critical temperature reached.*shutting down"
       r"|critical temperature reached \(\d+ C\), shutting down",
       EventType.CRITICAL,
       "host thermal-critical shutdown imminent (takes the GPUs down)",
       _HW, reboot_threshold=0, critical=False),
]

_BY_NAME = {c.name: c for c in CATALOG}
_BY_CODE = {c.code: c for c in CATALOG}


def lookup(name: str) -> Optional[CatalogEntry]:
    return _BY_NAME.get(name)


def lookup_code(code: int) -> Optional[CatalogEntry]:
    return _BY_CODE.get(code)


# (domain, bus, device) of a PCI address, in NVRM's form (0000:18:00) or
# NVML's (00000000:18:00.0)
_PCI_RE = re.compile(
    r"\b([0-9a-f]{4,8}):([0-9a-f]{2}):([0-9a-f]{2})(?:\.[0-7])?\b", re.IGNORECASE
)
_GPU_RE = re.compile(r"\bgpu ?=? ?(\d+)\b", re.IGNORECASE)

PCIKey = Tuple[int, int, int]


def pci_key(address: str) -> Optional[PCIKey]:
    """``(domain, bus, device)`` of the first PCI address in ``address``;
    the function number is left out, as NVRM leaves it out."""
    m = _PCI_RE.search(address or "")
    if m is None:
        return None
    return int(m.group(1), 16), int(m.group(2), 16), int(m.group(3), 16)


def bdf_map(devices) -> Dict[PCIKey, int]:
    """GPU index by PCI address, from the adapter's ``{index: GPU}``; a GPU
    whose PCI address NVML did not give is left out."""
    out: Dict[PCIKey, int] = {}
    for gid, dev in devices.items():
        key = pci_key(dev.pci_address)
        if key is not None:
            out[key] = gid
    return out


def extract_gpu(line: str, bdf_to_index: Optional[Dict[PCIKey, int]] = None) -> Optional[int]:
    """Best-effort GPU attribution from a kmsg line: a PCI address that is
    one of the host's GPUs (``Xid (PCI:0000:18:00)``, ``nvidia
    0000:18:00.0:``), else a ``gpu=3`` / ``gpu3`` / ``GPU 3`` token; None
    when the line names no GPU of this host."""
    if bdf_to_index:
        for m in _PCI_RE.finditer(line):
            key = (int(m.group(1), 16), int(m.group(2), 16), int(m.group(3), 16))
            if key in bdf_to_index:
                return bdf_to_index[key]
    m = _GPU_RE.search(line)
    return int(m.group(1)) if m else None


@dataclass
class MatchedError:
    entry: CatalogEntry
    gpu_id: Optional[int]
    raw: str


# Hot-loop prefilter: the matcher runs on EVERY kernel log line (reference
# hot loop #2, SURVEY §3.1), and a healthy host's lines match nothing — a
# single coarse-token scan rejects them without walking every pattern.
# Every catalog pattern's alternatives are anchored by at least one of
# these tokens; tests assert the invariant over the organic-line corpus.
# The scan itself runs in the native library when it is loaded
# (native/tpud_native.cpp tpud_prefilter_match — a case-folded substring
# sweep, no regex engine per line); the regex below is the fallback and
# the parity oracle.
PREFILTER_TOKENS = [
    "xid", "nvrm", "nvidia", "gpu-err", "edac", "mce", "machine", "pcie",
    "aer", "dmar", "amd-vi", "iommu", "vrm", "voltage", "power", "memory",
    "vfio",
    # anchors thermal_zone_device_critical only — routine trip-point
    # lines carry no "critical temperature" and stay prefilter-rejected
    "critical temperature",
]
_PREFILTER = re.compile(
    "|".join(re.escape(t) for t in PREFILTER_TOKENS), re.IGNORECASE
)

# the native fast path, armed on the first match when the library loads
# (importing opens no library; absence is fine). Arming replaces the C
# side's token set, so it happens once, under the lock.
_NATIVE_PREFILTER: Optional[bool] = None
_ARM_LOCK = threading.Lock()


def _prefilter_hit(line: str) -> bool:
    global _NATIVE_PREFILTER
    if _NATIVE_PREFILTER is None:
        with _ARM_LOCK:
            if _NATIVE_PREFILTER is None:
                _NATIVE_PREFILTER = _native.prefilter_init(PREFILTER_TOKENS)
    if _NATIVE_PREFILTER:
        hit = _native.prefilter_match(line)
        if hit is not None:
            return hit
    return _PREFILTER.search(line) is not None


def match(line: str, bdf_to_index: Optional[Dict[PCIKey, int]] = None) -> Optional[MatchedError]:
    """Match one kmsg line against the catalog (first hit wins; catalog is
    ordered most-specific-first within each class)."""
    if not _prefilter_hit(line):
        return None
    for entry in CATALOG:
        if entry.pattern.search(line):
            if entry.exclude is not None and entry.exclude.search(line):
                continue
            return MatchedError(entry=entry, gpu_id=extract_gpu(line, bdf_to_index), raw=line)
    return None


def injection_line(name: str, gpu_id: int = 0, detail: str = "") -> str:
    """Canonical injection format understood by ``match`` — what the fault
    injector writes (reference: pkg/fault-injector
    xid.GetMessageToInject analog)."""
    if name not in _BY_NAME:
        raise KeyError(f"unknown GPU error name: {name!r}")
    suffix = f" {detail}" if detail else ""
    return f"GPU-ERR: {name} gpu={gpu_id}{suffix}"
