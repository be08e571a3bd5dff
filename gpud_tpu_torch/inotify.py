"""Inotify wrapper (ctypes; Linux-only); the port of ``gpud_tpu/inotify.py``.

Event-driven wakeups for file tails (kmsg fixture mode) — no busy polling,
near-zero change-to-wakeup latency. Absence (non-Linux, restricted
sandbox) is fine: the kmsg watcher has a polling fallback. The reference's
directory-informer part (``add_path``) waits for its one consumer, the
package manager.
"""

from __future__ import annotations

import errno
import os
import select
import time
from typing import Optional


class InotifyWatch:
    """Minimal inotify wrapper (ctypes; Linux-only) for event-driven file
    tails — no busy polling, near-zero change-to-wakeup latency."""

    IN_MODIFY = 0x00000002

    def __init__(self, ifd: int) -> None:
        self.ifd = ifd
        self._closed = False
        self._poller = select.poll()
        self._poller.register(ifd, select.POLLIN)

    @classmethod
    def create(cls, path: str) -> Optional["InotifyWatch"]:
        try:
            import ctypes

            libc = ctypes.CDLL(None, use_errno=True)
            # CLOEXEC so spawned subprocesses don't inherit (and pin) the
            # inotify instance; on Linux IN_NONBLOCK/IN_CLOEXEC share the
            # O_* flag values
            ifd = libc.inotify_init1(os.O_NONBLOCK | os.O_CLOEXEC)
            if ifd < 0:
                return None
            wd = libc.inotify_add_watch(ifd, path.encode(), cls.IN_MODIFY)
            if wd < 0:
                os.close(ifd)
                return None
            return cls(ifd)
        except Exception:  # noqa: BLE001 — non-Linux / restricted sandbox
            return None

    def wait(self, timeout_ms: int) -> bool:
        """Block until the file is modified (or timeout); drains the event
        queue. Returns True when an event arrived.

        Threading contract: ``close()`` must be called from the thread
        that waits (the kmsg tail does exactly that). The ``_closed`` guard below is a
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


