"""Kmsg writer — the fault-injection mechanism.

Reference: pkg/kmsg/writer/kmsg.go:35,69 — writes ``<prio>message`` records
into /dev/kmsg (or the override file), which then flow through the normal
watcher → syncer → eventstore detection path. This makes fault injection a
product feature that doubles as the e2e test harness (SURVEY §4.7).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from gpud_tpu_torch.kmsg.watcher import ENV_KMSG_PATH, DEFAULT_KMSG_PATH, boot_time
from gpud_tpu_torch.log import audit, get_logger

logger = get_logger(__name__)

MAX_PRINTK_RECORD = 1024 - 48  # kernel printk record size limit (reference: writer/kmsg.go)


class KmsgWriter:
    def __init__(self, path: str = "") -> None:
        self.path = path or os.environ.get(ENV_KMSG_PATH, "") or DEFAULT_KMSG_PATH
        self._seq = 0

    def write(self, message: str, priority: int = 3) -> Optional[str]:
        """Write one record. Returns an error string or None.

        Writing to the real /dev/kmsg takes just ``<prio>msg``; the kernel
        stamps seq/time. When the target is a regular file (fixture mode) we
        emit a fully-formed record line so the watcher can parse it back.
        """
        if len(message) > MAX_PRINTK_RECORD:
            message = message[:MAX_PRINTK_RECORD]
        message = message.replace("\n", " ")
        try:
            import stat as _stat

            is_dev = False
            try:
                is_dev = _stat.S_ISCHR(os.stat(self.path).st_mode)
            except FileNotFoundError:
                pass
            if is_dev:
                payload = f"<{priority}>{message}\n".encode()
                fd = os.open(self.path, os.O_WRONLY)
                try:
                    os.write(fd, payload)
                finally:
                    os.close(fd)
            else:
                bt = boot_time()
                ts_us = int((time.time() - bt) * 1e6) if bt else int(time.time() * 1e6)
                self._seq += 1
                line = f"{priority},{self._seq},{ts_us},-;{message}\n"
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
            audit("kmsg_write", path=self.path, priority=priority, message=message)
            return None
        except OSError as e:
            logger.warning("kmsg write failed: %s", e)
            return str(e)
