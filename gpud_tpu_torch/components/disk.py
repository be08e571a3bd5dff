"""Disk component: usage, mount liveness, block-device tree, and kernel
I/O-error detection.

Reference: components/disk (1306 LoC — lsblk/findmnt device tree, mount
tracking, usage) plus the reference's kmsg-matcher discipline from the
cpu/memory components. Enumeration reads the kernel surfaces directly
(gpud_tpu_torch/blockdev.py — /sys/block + /proc/mounts, no lsblk exec). The
failure path the reference lacks per-line but a dying boot disk needs
(the reference package's VERDICT r3 #2): blk_update_request / Buffer I/O / EXT4-XFS error /
device-offline kmsg lines flip this component unhealthy, sticky until
set-healthy. Note the reference's TPU kmsg catalog deliberately
*excludes* nvme/ahci lines (components/tpu/catalog.py _NON_TPU_DRIVERS) so
storage faults are never classified as accelerator faults — they are
classified here instead.

The port of ``gpud_tpu/components/disk.py``: the mount table and usage come
from ``/proc`` and ``statvfs`` where the reference reads psutil
(gpud_tpu_torch/procfs.py).
"""

from __future__ import annotations

import os
import re
import time
from typing import Dict, List, Optional

from gpud_tpu_torch.api.v1.types import (
    Event,
    EventType,
    HealthStateType,
    RepairActionType,
    SuggestedActions,
)
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.metrics.registry import gauge
from gpud_tpu_torch import procfs

NAME = "disk"

_g_total = gauge("tpud_disk_total_bytes", "filesystem size")
_g_used = gauge("tpud_disk_used_bytes", "filesystem used")
_g_used_pct = gauge("tpud_disk_used_percent", "filesystem used percent")
_g_io_errors = gauge(
    "tpud_disk_io_error_events_total", "disk I/O error events in lookback window"
)

DEFAULT_USED_PCT_DEGRADED = 95.0
# Deliberate 3h window (NOT derived from event-store retention, which is
# 14d): long enough that a flapping disk can't look healthy between
# bursts, short enough that one transient I/O error doesn't degrade the
# node for days. Fatal conditions stay sticky until set-healthy anyway
# via recurrence — the window only ages out *isolated* events.
DEFAULT_EVENT_LOOKBACK_SECONDS = 3.0 * 3600

_EPHEMERAL_FS = {"tmpfs", "devtmpfs", "overlay", "squashfs", "proc", "sysfs", "ramfs"}

# --- kernel storage-error lines (kernel printk formats, most-specific
# first; each cites the emitting kernel site) ------------------------------

# block/blk-core.c blk_update_request / older print_req_error: the
# definitive "the device returned an error for a bio" line
_IO_ERROR_RE = re.compile(
    r"(blk_update_request: (?:critical )?(?:medium|target|I/O) error"
    r"|print_req_error: I/O error"
    r"|Buffer I/O error on dev)",
    re.IGNORECASE,
)
# fs/ext4/super.c ext4_handle_error + fs/xfs/xfs_fsops.c shutdown paths
_FS_ERROR_RE = re.compile(
    r"(EXT4-fs error \(device"
    r"|EXT4-fs \([^)]+\): .*(aborted journal|journal has aborted)"
    r"|XFS \([^)]+\): .*(Corruption|shutting down|Internal error)"
    r"|JBD2: .*(detected IO errors|aborting))",
    re.IGNORECASE,
)
# ext4/xfs remount-ro on error (errors=remount-ro) — the boot disk is now
# read-only; the node will limp until writes matter
_REMOUNT_RO_RE = re.compile(
    r"(Remounting filesystem read-only|EXT4-fs \([^)]+\): re-mounted.*read-only)",
    re.IGNORECASE,
)
# scsi/sd.c offline rejection + nvme/host/core.c controller death
_OFFLINE_RE = re.compile(
    r"(rejecting I/O to offline device"
    r"|nvme\s?\S*: (controller is down|Disabling device|Removing after probe failure)"
    r"|nvme\s?\S*: I/O \d+ QID \d+ timeout)",
    re.IGNORECASE,
)

# "(device sda1)" / "on dev sda1" / "nvme0n1: I/O error" — best-effort
# device extraction for the event message
_DEV_RE = re.compile(
    r"(?:device |dev )((?:sd[a-z]+|nvme\d+n\d+|vd[a-z]+|xvd[a-z]+|hd[a-z]+|mmcblk\d+)p?\d*)",
    re.IGNORECASE,
)


def match_disk_error(line: str) -> Optional[tuple]:
    """Kmsg matcher (wired in server._wire_kmsg_syncers, same seam as
    cpu-lockup/OOM): storage I/O, filesystem and device-offline errors
    → disk events. Returns (name, type, message[, extra])."""
    if _REMOUNT_RO_RE.search(line):
        return ("disk_remount_ro", EventType.FATAL, line.strip(), _dev_extra(line))
    if _FS_ERROR_RE.search(line):
        return ("disk_fs_error", EventType.FATAL, line.strip(), _dev_extra(line))
    if _OFFLINE_RE.search(line):
        return ("disk_device_offline", EventType.FATAL, line.strip(), _dev_extra(line))
    if _IO_ERROR_RE.search(line):
        return ("disk_io_error", EventType.CRITICAL, line.strip(), _dev_extra(line))
    return None


def _dev_extra(line: str) -> Dict[str, str]:
    m = _DEV_RE.search(line)
    return {"device": m.group(1)} if m else {}


_FATAL_DISK_EVENTS = {"disk_remount_ro", "disk_fs_error", "disk_device_offline"}


class DiskComponent(PollingComponent):
    NAME = NAME
    TAGS = ["host", "disk"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.mount_points: List[str] = list(instance.mount_points)
        self.mount_targets: List[str] = list(instance.mount_targets)
        self.get_partitions_fn = procfs.disk_partitions
        self.get_usage_fn = procfs.disk_usage
        self.event_lookback_seconds = DEFAULT_EVENT_LOOKBACK_SECONDS
        self.time_now_fn = time.time
        self.proc_mounts_path = ""   # fixture override
        self._event_bucket = (
            instance.event_store.bucket(NAME) if instance.event_store else None
        )

    def _watched_mounts(self) -> Dict[str, str]:
        """mount point → device; always includes '/', plus configured ones."""
        mounts: Dict[str, str] = {}
        try:
            for p in self.get_partitions_fn(all=False):
                if p.fstype in _EPHEMERAL_FS:
                    continue
                mounts[p.mountpoint] = p.device
        except OSError:
            pass
        if "/" not in mounts:
            mounts["/"] = "rootfs"
        return mounts

    def _read_only_mounts(self) -> List[str]:
        """Filesystems that *tripped* to read-only — the steady-state
        signature of an errors=remount-ro trip (catches remounts from
        before the daemon started, which kmsg can't). Requires BOTH
        ``ro`` and ``errors=remount-ro`` in the options: a deliberately
        ro-mounted volume shows plain ``ro,relatime`` (no errors= policy
        — it is meaningless on a ro mount), while a tripped ext4 keeps
        its fstab error policy alongside the new ro. Scans the whole
        /dev/*-backed table (via blockdev.read_mount_table, which honors
        TPUD_HOST_ROOT): in a container the watched set sees the
        overlay namespace and would hide a tripped host boot disk."""
        from gpud_tpu_torch.blockdev import read_mount_table

        return sorted(
            e.mount_point
            for e in read_mount_table(proc_mounts=self.proc_mounts_path)
            if "ro" in e.options and "errors=remount-ro" in e.options
        )

    def _recent_disk_events(self) -> List[Event]:
        """Disk events in the lookback window, cut at the latest
        SetHealthy marker (operator clear starts a fresh slate)."""
        if self._event_bucket is None:
            return []
        recent = self._event_bucket.get(
            self.time_now_fn() - self.event_lookback_seconds
        )
        out: List[Event] = []
        for e in recent:  # newest first
            if e.name == "SetHealthy":
                break
            out.append(e)
        return out

    def _block_tree_extra(self, extra: Dict[str, str]) -> None:
        """Disk→partition inventory from /sys/block (the lsblk analog)."""
        from gpud_tpu_torch.blockdev import read_block_tree

        try:
            tree = read_block_tree()
        except Exception:  # noqa: BLE001 — inventory is best-effort
            return
        for d in tree:
            parts = ",".join(p.name for p in d.children) or "-"
            extra[f"blockdev:{d.name}"] = (
                f"{d.size_bytes >> 30}GiB parts={parts}"
                + (f" mount={d.mount_point}" if d.mount_point else "")
            )

    def check_once(self) -> CheckResult:
        missing = [p for p in self.mount_points if not os.path.isdir(p)]
        missing += [p for p in self.mount_targets if not os.path.isdir(p)]

        worst_pct = 0.0
        extra: Dict[str, str] = {}
        for mp in sorted(self._watched_mounts()):
            try:
                u = self.get_usage_fn(mp)
            except OSError:
                continue
            labels = {"component": NAME, "mount_point": mp}
            _g_total.set(u.total, labels)
            _g_used.set(u.used, labels)
            _g_used_pct.set(u.percent, labels)
            extra[f"used_percent:{mp}"] = f"{u.percent:.1f}"
            worst_pct = max(worst_pct, u.percent)
        self._block_tree_extra(extra)

        events = self._recent_disk_events()
        _g_io_errors.set(float(len(events)), {"component": NAME})

        if missing:
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"mount point(s) missing: {', '.join(missing)}",
                extra_info=extra,
            )

        ro = self._read_only_mounts()
        fatal = [e for e in events if e.name in _FATAL_DISK_EVENTS]
        if ro or fatal:
            bits = []
            if ro:
                bits.append(f"read-only filesystem(s): {', '.join(ro)}")
            if fatal:
                devs = sorted(
                    {e.extra_info.get("device", "?") for e in fatal if e.extra_info}
                ) or ["?"]
                bits.append(
                    f"{len(fatal)} fatal storage event(s) on {', '.join(devs)} "
                    f"(latest: {fatal[0].name})"
                )
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason="; ".join(bits),
                suggested_actions=SuggestedActions(
                    description=(
                        "storage failure — check the disk; fsck/replace, "
                        "then set-healthy to clear"
                    ),
                    repair_actions=[
                        RepairActionType.REBOOT_SYSTEM,
                        RepairActionType.HARDWARE_INSPECTION,
                    ],
                ),
                extra_info=extra,
            )

        if events:  # CRITICAL-but-not-fatal I/O errors: degraded
            devs = sorted(
                {e.extra_info.get("device", "?") for e in events if e.extra_info}
            ) or ["?"]
            return CheckResult(
                self.NAME,
                health=HealthStateType.DEGRADED,
                reason=(
                    f"{len(events)} disk I/O error event(s) on {', '.join(devs)} "
                    f"in last {int(self.event_lookback_seconds / 3600)}h"
                ),
                suggested_actions=SuggestedActions(
                    description="disk I/O errors — SMART/media suspect",
                    repair_actions=[RepairActionType.HARDWARE_INSPECTION],
                ),
                extra_info=extra,
            )

        health = HealthStateType.HEALTHY
        reason = f"max filesystem usage {worst_pct:.1f}%"
        if worst_pct >= DEFAULT_USED_PCT_DEGRADED:
            health = HealthStateType.DEGRADED
            reason = f"filesystem nearly full: {worst_pct:.1f}% used"
        return CheckResult(self.NAME, health=health, reason=reason, extra_info=extra)

    def events(self, since: float):
        if self._event_bucket is None:
            return []
        return self._event_bucket.get(since)

    def set_healthy(self) -> None:
        """Operator clear after disk replacement/fsck (reference pattern:
        components/memory/set_healthy.go)."""
        if self._event_bucket is not None:
            self._event_bucket.insert(
                Event(component=NAME, name="SetHealthy", type=EventType.INFO,
                      message="operator set-healthy")
            )
