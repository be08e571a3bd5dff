"""Logging for tpud.

Mirrors the reference's zap + lumberjack + audit logger setup
(reference: pkg/log/log.go:27-70) with stdlib logging: a rotating file
handler when a log file is configured, and a separate append-only audit
logger for privileged actions (reboot, bootstrap script exec, fault
injection — reference: pkg/log/audit*).
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import threading
import time
from typing import Any, Dict, Optional

_configured = False
_audit_logger: Optional["AuditLogger"] = None
_mu = threading.Lock()


def setup(level: str = "info", log_file: str = "") -> None:
    """Configure the root tpud logger. Safe to call multiple times."""
    global _configured
    with _mu:
        lvl = getattr(logging, level.upper(), logging.INFO)
        root = logging.getLogger("tpud")
        root.setLevel(lvl)
        if _configured:
            return
        fmt = logging.Formatter(
            "%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s",
            datefmt="%Y-%m-%dT%H:%M:%S",
        )
        handler: logging.Handler
        if log_file:
            os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
            # lumberjack-style rotation (reference: pkg/log/log.go)
            handler = logging.handlers.RotatingFileHandler(
                log_file, maxBytes=100 * 1024 * 1024, backupCount=3
            )
        else:
            handler = logging.StreamHandler()
        handler.setFormatter(fmt)
        root.addHandler(handler)
        _configured = True


def get_logger(name: str) -> logging.Logger:
    short = name.replace("gpud_tpu_torch.", "")
    return logging.getLogger(f"tpud.{short}")


class AuditLogger:
    """Append-only JSONL audit records of privileged actions
    (reference: pkg/log/audit*, wired at cmd/gpud/run/command.go:366-370).

    A nop instance (no path) swallows records.
    """

    def __init__(self, path: str = "") -> None:
        self.path = path
        self._mu = threading.Lock()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, action: str, **fields: Any) -> None:
        if not self.path:
            return
        rec: Dict[str, Any] = {"ts": time.time(), "action": action}
        rec.update(fields)
        line = json.dumps(rec, sort_keys=True)
        try:
            with self._mu:
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
        except OSError as e:
            # an unwritable audit file (perms, ENOSPC) must degrade to
            # unaudited — never crash the privileged action being audited
            logging.getLogger("tpud.audit").warning(
                "audit write failed (%s); record dropped: %s", e, line
            )


def set_audit_logger(a: AuditLogger) -> None:
    global _audit_logger
    _audit_logger = a


def audit(action: str, **fields: Any) -> None:
    if _audit_logger is not None:
        _audit_logger.log(action, **fields)
