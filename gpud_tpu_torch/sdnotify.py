"""systemd readiness notification (sd_notify protocol); the port of
``gpud_tpu/sdnotify.py``.

Reference: the daemon runs as Type=notify with sd_notify READY/STOPPING
calls (pkg/gpud-manager/systemd/gpud.service:1-37, cmd/gpud/run —
pkgsystemd.NotifyReady / server HandleSignals). The protocol is a single
datagram to the unix socket in ``NOTIFY_SOCKET``; a leading '@' means a
Linux abstract socket. No-op when systemd isn't supervising us.
"""

from __future__ import annotations

import os
import socket

from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)


def notify(state: str) -> bool:
    """Send one sd_notify state string; returns True when delivered."""
    addr = os.environ.get("NOTIFY_SOCKET", "")
    if not addr:
        return False
    if addr.startswith("@"):
        addr = "\0" + addr[1:]
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM) as s:
            s.connect(addr)
            s.send(state.encode())
        return True
    except OSError as e:
        logger.warning("sd_notify(%s) failed: %s", state, e)
        return False


def ready() -> bool:
    return notify("READY=1")


def stopping() -> bool:
    return notify("STOPPING=1")


def status(text: str) -> bool:
    return notify(f"STATUS={text}")
