"""Host identity and lifecycle (the part of ``gpud_tpu/host.py`` that the
port's components need).

Reference: pkg/host — machine-id/boot-id readers, uptime helpers and
``RebootEventStore`` (records boot-time-derived reboot events,
pkg/host/event.go:44-85).
"""

from __future__ import annotations

import time
import uuid as _uuid
from typing import List

from gpud_tpu_torch.api.v1.types import Event, EventType
from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

REBOOT_COMPONENT = "os"
EVENT_NAME_REBOOT = "reboot"


def _read_first_line(path: str) -> str:
    try:
        with open(path, "r", encoding="ascii") as f:
            return f.read().strip()
    except OSError:
        return ""


def machine_id() -> str:
    """Stable machine identity (reference: pkg/host machine-id reader)."""
    for p in ("/etc/machine-id", "/var/lib/dbus/machine-id"):
        v = _read_first_line(p)
        if v:
            return v
    # last resort: stable-ish ID derived from the MAC
    return f"{_uuid.getnode():012x}"


def boot_id() -> str:
    return _read_first_line("/proc/sys/kernel/random/boot_id")


def uptime_seconds() -> float:
    v = _read_first_line("/proc/uptime")
    try:
        return float(v.split()[0])
    except (ValueError, IndexError):
        return 0.0


def boot_time() -> float:
    return time.time() - uptime_seconds()


class RebootEventStore:
    """Persists reboot events derived from boot time so event-sourced health
    can merge them with error events (reference: pkg/host/event.go:44-85).
    ``event_store`` is the port's ``eventstore.EventStore``.
    """

    def __init__(self, event_store) -> None:
        self._bucket = event_store.bucket(REBOOT_COMPONENT)
        self.time_now_fn = time.time

    def record_reboot(self) -> None:
        """Called once at daemon boot: if the current boot isn't recorded
        yet, insert a reboot event stamped at boot time
        (reference: pkg/server/server.go:203-221 RecordReboot)."""
        bt = boot_time()
        ev = Event(
            component=REBOOT_COMPONENT,
            time=round(bt, 0),  # second resolution: boot_time jitters between reads
            name=EVENT_NAME_REBOOT,
            type=EventType.WARNING,
            message=f"system boot detected (boot_id={boot_id()})",
        )
        # dedupe across daemon restarts within the same boot
        for existing in self._bucket.get(bt - 120):
            if existing.name == EVENT_NAME_REBOOT and abs(existing.time - ev.time) < 120:
                return
        self._bucket.insert(ev)
        logger.info("recorded reboot event at %s", ev.time)

    def get_reboot_events(self, since: float) -> List[Event]:
        return [e for e in self._bucket.get(since) if e.name == EVENT_NAME_REBOOT]
