"""Host identity (the part of ``gpud_tpu/host.py`` that ``scan`` needs).

Reference: pkg/host machine-id reader.
"""

from __future__ import annotations

import uuid as _uuid


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
