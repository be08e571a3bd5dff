"""Host identity and lifecycle (the port of ``gpud_tpu/host.py``).

Reference: pkg/host — machine-id/boot-id readers, virtualization detection,
``RebootEventStore`` (records boot-time-derived reboot events,
pkg/host/event.go:44-85), ``Reboot()`` via systemctl/shutdown
(pkg/host/reboot.go:46+), uptime helpers.
"""

from __future__ import annotations

import time
import uuid as _uuid
from typing import List, Optional

from gpud_tpu_torch.api.v1.types import Event, EventType
from gpud_tpu_torch.log import audit, get_logger
from gpud_tpu_torch.process import run_command

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


def kernel_version() -> str:
    return _read_first_line("/proc/sys/kernel/osrelease")


def os_name() -> str:
    try:
        with open("/etc/os-release", "r", encoding="utf-8") as f:
            for ln in f:
                if ln.startswith("PRETTY_NAME="):
                    return ln.split("=", 1)[1].strip().strip('"')
    except OSError:
        pass
    return _read_first_line("/proc/sys/kernel/ostype")


def virtualization() -> str:
    """Best-effort virtualization detection (reference: pkg/host virt detect)."""
    r = run_command(["systemd-detect-virt"], timeout=5.0)
    if r.exit_code == 0:
        return r.output.strip()
    product = _read_first_line("/sys/class/dmi/id/product_name").lower()
    if "google" in product:
        return "gce"
    if product:
        return product
    return "unknown" if r.error else "none"


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


def reboot(use_systemctl: bool = True, dry_run: bool = False) -> Optional[str]:
    """Reboot the machine (reference: pkg/host/reboot.go:46+). Returns error
    string or None. Audited — this is a privileged remediation action."""
    audit("reboot", dry_run=dry_run)
    if dry_run:
        return None
    cmds = (["systemctl", "reboot"], ["shutdown", "-r", "now"], ["reboot"])
    if not use_systemctl:
        cmds = (["shutdown", "-r", "now"], ["reboot"])
    last_err = ""
    for argv in cmds:
        r = run_command(list(argv), timeout=10.0)
        if r.exit_code == 0:
            return None
        last_err = r.error or r.output.strip() or f"exit {r.exit_code}"
    return f"all reboot commands failed: {last_err}"


def stop_daemon_systemd(unit: str = "tpud.service") -> Optional[str]:
    r = run_command(["systemctl", "stop", unit], timeout=30.0)
    return None if r.exit_code == 0 else (r.error or r.output.strip())
