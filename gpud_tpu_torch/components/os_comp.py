"""OS component (reference: components/os — uname, /proc fd counts
(file_descriptors.go), reboot events, kernel panic detection via pstore,
too-many-open-files thresholds). The port of
``gpud_tpu/components/os_comp.py``."""

from __future__ import annotations

import os
import re
from typing import Optional

from gpud_tpu_torch import host as pkghost
from gpud_tpu_torch.api.v1.types import EventType, HealthStateType
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.metrics.registry import gauge

NAME = "os"

_g_fds_alloc = gauge("tpud_os_file_descriptors_allocated", "system-wide allocated fds")
_g_fds_limit = gauge("tpud_os_file_descriptors_limit", "system-wide fd limit")
_g_uptime = gauge("tpud_os_uptime_seconds", "seconds since boot")

LABELS = {"component": NAME}

DEFAULT_FD_USAGE_DEGRADED = 0.90

PANIC_RE = re.compile(
    r"(Kernel panic|kernel BUG at|Oops:|general protection fault|unable to handle kernel)",
    re.IGNORECASE,
)


def match_kernel_panic(line: str) -> Optional[tuple]:
    if PANIC_RE.search(line):
        return ("kernel_panic", EventType.FATAL, line.strip())
    return None


def _read_file_nr() -> tuple:
    """(allocated, limit) from /proc/sys/fs/file-nr."""
    try:
        with open("/proc/sys/fs/file-nr", "r", encoding="ascii") as f:
            parts = f.read().split()
        return int(parts[0]), int(parts[2])
    except (OSError, IndexError, ValueError):
        return 0, 0


class OSComponent(PollingComponent):
    NAME = NAME
    TAGS = ["host", "os"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.get_file_nr_fn = _read_file_nr
        self.get_uptime_fn = pkghost.uptime_seconds
        self._event_bucket = (
            instance.event_store.bucket(NAME) if instance.event_store else None
        )
        # pstore crash attribution: a dump appearing after a reboot means
        # the reboot was a kernel panic (reference: components/os + pkg/pstore)
        self._pstore_history = None
        if instance.db_rw is not None:
            from gpud_tpu_torch.pstore import PstoreHistory

            self._pstore_history = PstoreHistory(instance.db_rw)

    def _check_pstore(self) -> None:
        if self._pstore_history is None or self._event_bucket is None:
            return
        from gpud_tpu_torch.api.v1.types import Event, EventType
        from gpud_tpu_torch.pstore import read_crash_files

        fresh = self._pstore_history.record_new(read_crash_files())
        for rec in fresh:
            self._event_bucket.insert(
                Event(
                    component=NAME,
                    time=rec.mtime,
                    name="kernel_crash_dump",
                    type=EventType.FATAL,
                    message=f"pstore {rec.kind} dump {rec.path}: {rec.excerpt[:300]}",
                )
            )

    def check_once(self) -> CheckResult:
        try:
            self._check_pstore()
        except Exception:  # noqa: BLE001 — crash attribution is a side
            # feature; it must never take down fd/uptime monitoring
            import logging

            logging.getLogger("tpud.components.os").exception("pstore check failed")
        alloc, limit = self.get_file_nr_fn()
        up = self.get_uptime_fn()
        _g_fds_alloc.set(alloc, LABELS)
        _g_fds_limit.set(limit, LABELS)
        _g_uptime.set(up, LABELS)

        health = HealthStateType.HEALTHY
        reason = (
            f"kernel {pkghost.kernel_version()}, up {up / 3600:.1f}h, "
            f"fds {alloc}/{limit or '?'}"
        )
        if limit and alloc / limit >= DEFAULT_FD_USAGE_DEGRADED:
            health = HealthStateType.DEGRADED
            reason = f"too many open files: {alloc}/{limit}"
        return CheckResult(
            self.NAME,
            health=health,
            reason=reason,
            extra_info={
                "kernel_version": pkghost.kernel_version(),
                "os_name": pkghost.os_name(),
                "boot_id": pkghost.boot_id(),
                "machine_id": pkghost.machine_id(),
                "uptime_seconds": f"{up:.0f}",
                "fds_allocated": str(alloc),
                "fds_limit": str(limit),
            },
        )

    def events(self, since: float):
        # reboot events live in the os bucket (reference: pkg/host/event.go)
        if self._event_bucket is None:
            return []
        return self._event_bucket.get(since)
