"""Shared inotify wrapper (ctypes; Linux-only); the port of
``gpud_tpu/inotify.py``.

Event-driven wakeups for file tails (kmsg fixture mode) and directory
informers (package manager) — no busy polling, near-zero
change-to-wakeup latency. Absence (non-Linux, restricted sandbox) is
fine: every consumer has a polling fallback.
"""

from __future__ import annotations

import errno
import os
import select
import time
from typing import Optional


class InotifyWatch:
    """Minimal inotify wrapper (ctypes; Linux-only) for event-driven file
    tails and directory informers — no busy polling, near-zero
    change-to-wakeup latency. Also consumed by the package manager's file
    informer (gpud_tpu_torch/manager/packages.py)."""

    IN_MODIFY = 0x00000002
    # directory-informer mask: create/modify/delete/move inside a dir
    TREE_MASK = 0x00000002 | 0x00000100 | 0x00000200 | 0x00000040 | 0x00000080

    def __init__(self, ifd: int, libc, mask: int) -> None:
        self.ifd = ifd
        self._libc = libc
        self._mask = mask
        self._closed = False
        self._poller = select.poll()
        self._poller.register(ifd, select.POLLIN)

    @classmethod
    def create(cls, path: str, mask: int = IN_MODIFY) -> Optional["InotifyWatch"]:
        try:
            import ctypes

            libc = ctypes.CDLL(None, use_errno=True)
            # CLOEXEC so spawned subprocesses don't inherit (and pin) the
            # inotify instance; on Linux IN_NONBLOCK/IN_CLOEXEC share the
            # O_* flag values
            ifd = libc.inotify_init1(os.O_NONBLOCK | os.O_CLOEXEC)
            if ifd < 0:
                return None
            wd = libc.inotify_add_watch(ifd, path.encode(), mask)
            if wd < 0:
                os.close(ifd)
                return None
            return cls(ifd, libc, mask)
        except Exception:  # noqa: BLE001 — non-Linux / restricted sandbox
            return None

    def add_path(self, path: str) -> bool:
        """Watch an additional path on the same instance (informer trees)."""
        if self._closed:
            return False
        try:
            return self._libc.inotify_add_watch(self.ifd, path.encode(), self._mask) >= 0
        except Exception:  # noqa: BLE001
            return False

    def wait(self, timeout_ms: int) -> bool:
        """Block until the file is modified (or timeout); drains the event
        queue. Returns True when an event arrived.

        Threading contract: ``close()`` must be called from the thread
        that waits (both consumers — the kmsg tail and the package
        informer — do exactly that). The ``_closed`` guard below is a
        misuse backstop, NOT cross-thread synchronization: a truly
        concurrent close-mid-wait cannot be made safe at this layer (the
        kernel may recycle the fd number between check and read). The
        backstop sleeps out the timeout so a violated contract degrades
        to latency, never to an EBADF crash or a 100% busy-spin of the
        consumer loop."""
        if self._closed:
            time.sleep(timeout_ms / 1000.0)
            return False
        events = self._poller.poll(timeout_ms)
        if not events:
            return False
        if self._closed:
            time.sleep(timeout_ms / 1000.0)
            return False
        try:
            while True:
                if not os.read(self.ifd, 4096):
                    break
        except OSError as e:
            if e.errno == errno.EBADF:
                self._closed = True  # fd gone: every later wait sleeps
                return False
            if e.errno not in (errno.EAGAIN, errno.EWOULDBLOCK):
                raise
        return True

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            os.close(self.ifd)
        except OSError:
            pass


