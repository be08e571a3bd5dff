"""Kernel message (/dev/kmsg) reader; the port of ``gpud_tpu/kmsg/watcher.py``.

Reference: pkg/kmsg/watcher.go — ``ReadAll`` non-follow mode (86-187),
``NewWatcher`` follow mode (190-290), line parser extracting priority/
sequence/µs-from-boot (292-332), env override ``KMSG_FILE_PATH``
(watcher.go:46; here ``TPUD_KMSG_FILE_PATH``).

The /dev/kmsg record format is::

    <priority>,<seq>,<usec_from_boot>,<flags>[,...];<message>
     KEY=value   (continuation lines, ignored here)

Follow mode uses non-blocking reads + poll so the watcher thread can stop
promptly, and works both on the real char device and on regular fixture
files (tail -f semantics) so tests and fault injection run without root
(SURVEY §4.4 fixture-directory pattern).
"""

from __future__ import annotations

import errno
import os
import select
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from gpud_tpu_torch import native
from gpud_tpu_torch.inotify import InotifyWatch as _InotifyWatch
from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

# native fast path, resolved on the first parse (importing opens no library):
# native.parse_kmsg when the library loads (native.build() makes it), else None
_UNRESOLVED = object()
_native_parse = _UNRESOLVED


def _native_parser():
    global _native_parse
    if _native_parse is _UNRESOLVED:
        _native_parse = native.parse_kmsg if native.available() else None
    return _native_parse

DEFAULT_KMSG_PATH = "/dev/kmsg"
ENV_KMSG_PATH = "TPUD_KMSG_FILE_PATH"


def kmsg_path(override: str = "") -> str:
    return override or os.environ.get(ENV_KMSG_PATH, "") or DEFAULT_KMSG_PATH


def boot_time() -> float:
    """Unix seconds at boot (0.0 when /proc/uptime is unreadable — callers
    branch on >0). Delegates to the host package's uptime reader."""
    from gpud_tpu_torch import host as pkghost

    up = pkghost.uptime_seconds()
    return time.time() - up if up > 0 else 0.0


@dataclass
class Message:
    """One parsed kmsg record (reference: watcher.go:292-332)."""

    priority: int = 0          # syslog priority (0-7), prefix & 7
    facility: int = 0          # prefix >> 3
    sequence: int = 0
    timestamp_us: int = 0      # microseconds since boot
    message: str = ""
    time: float = 0.0          # absolute unix seconds (derived)
    raw: str = field(default="", repr=False)

    @property
    def priority_name(self) -> str:
        names = ("emerg", "alert", "crit", "err", "warning", "notice", "info", "debug")
        return names[self.priority] if 0 <= self.priority < 8 else str(self.priority)


def parse_line(line: str, boot_unix: float = 0.0) -> Optional[Message]:
    """Parse one /dev/kmsg record line; None for continuation/garbage lines.

    Uses the native C++ parser when it is loaded (native/tpud_native.cpp,
    through gpud_tpu_torch.native); the Python path below is the parity
    oracle and the fallback. As in the reference, the native parser clamps
    a field above 2^63 - 1 where the Python one does not. Unlike the
    reference, the record's trailing newline (every /dev/kmsg read ends in
    one) is stripped before either parser, so the native message equals
    the Python one.
    """
    parser = _native_parser()
    if parser is not None:
        line = line.rstrip("\n")
        parsed = parser(line)
        if parsed is None:
            return None
        prio, fac, seq, ts_us, msg = parsed
        m = Message(
            priority=prio, facility=fac, sequence=seq,
            timestamp_us=ts_us, message=msg, raw=line,
        )
        m.time = boot_unix + ts_us / 1e6 if boot_unix > 0 else time.time()
        return m
    if not line or line.startswith(" "):
        return None
    line = line.rstrip("\n")
    head, sep, msg = line.partition(";")
    if not sep:
        return None
    parts = head.split(",")
    if len(parts) < 3:
        return None
    try:
        prefix = int(parts[0])
        seq = int(parts[1])
        ts_us = int(parts[2])
    except ValueError:
        return None
    m = Message(
        priority=prefix & 7,
        facility=prefix >> 3,
        sequence=seq,
        timestamp_us=ts_us,
        message=msg,
        raw=line,
    )
    if boot_unix > 0:
        m.time = boot_unix + ts_us / 1e6
    else:
        m.time = time.time()
    return m


def read_all(path: str = "", limit: int = 0) -> List[Message]:
    """Non-follow read of the whole ring buffer / fixture file
    (reference: watcher.go:86-187 ReadAll). Used by scan mode."""
    p = kmsg_path(path)
    out: List[Message] = []
    bt = boot_time()
    try:
        fd = os.open(p, os.O_RDONLY | os.O_NONBLOCK)
    except OSError as e:
        logger.warning("kmsg open %s failed: %s", p, e)
        return out
    try:
        st = os.fstat(fd)
        if not _is_char_device(st):
            # regular fixture file: read lines directly
            data = b""
            while True:
                chunk = os.read(fd, 1 << 16)
                if not chunk:
                    break
                data += chunk
            for ln in data.decode("utf-8", "replace").splitlines():
                m = parse_line(ln, bt)
                if m is not None:
                    out.append(m)
                    if limit and len(out) >= limit:
                        break
            return out
        # char device: each read() returns exactly one record;
        # EAGAIN means end of ring buffer in non-blocking mode
        while True:
            try:
                rec = os.read(fd, 8192)
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    break
                if e.errno == errno.EPIPE:  # overwritten record, skip
                    continue
                raise
            if not rec:
                break
            m = parse_line(rec.decode("utf-8", "replace"), bt)
            if m is not None:
                out.append(m)
                if limit and len(out) >= limit:
                    break
        return out
    finally:
        os.close(fd)


def _is_char_device(st: os.stat_result) -> bool:
    import stat as _stat

    return _stat.S_ISCHR(st.st_mode)


class Watcher:
    """Follow-mode kmsg watcher (reference: watcher.go:190-290).

    Spawns one reader thread delivering parsed ``Message``s to ``callback``.
    ``from_now=True`` seeks to the end first (daemon mode: only new lines);
    ``False`` replays the existing buffer first (scan/bootstrap mode).

    ``start`` opens the source and seeks on the caller's thread, so every
    line written once it has returned is delivered. The reference opens on
    the reader thread: a line written before that thread has sought to the
    end is skipped (ROADMAP C6).
    """

    def __init__(
        self,
        callback: Callable[[Message], None],
        path: str = "",
        from_now: bool = True,
        poll_timeout_ms: int = 500,
    ) -> None:
        self.path = kmsg_path(path)
        self.callback = callback
        self.from_now = from_now
        self.poll_timeout_ms = poll_timeout_ms
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.boot_unix = boot_time()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        fd = self._open()
        self._thread = threading.Thread(
            target=self._run, args=(fd,), name="tpud-kmsg-watcher", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=3.0)
            self._thread = None

    # -- internals ---------------------------------------------------------
    def _run(self, fd: Optional[int] = None) -> None:
        while not self._stop.is_set():
            try:
                self._follow_once(fd)
            except Exception:  # noqa: BLE001 — watcher must survive
                logger.exception("kmsg follow error; retrying in 1s")
            fd = None
            if self._stop.wait(1.0):
                return
        if fd is not None:  # closed before the first follow
            os.close(fd)

    def _open(self) -> Optional[int]:
        """Open the source, at its end when ``from_now``; None on failure."""
        try:
            fd = os.open(self.path, os.O_RDONLY | os.O_NONBLOCK)
        except OSError as e:
            logger.warning("kmsg open %s failed: %s", self.path, e)
            return None
        if self.from_now:
            try:
                os.lseek(fd, 0, os.SEEK_END)
            except OSError as e:
                os.close(fd)
                logger.warning("kmsg seek %s failed: %s", self.path, e)
                return None
        return fd

    def _follow_once(self, fd: Optional[int] = None) -> None:
        if fd is None:
            fd = self._open()
        if fd is None:
            self._stop.wait(5.0)
            return
        try:
            st = os.fstat(fd)
            if _is_char_device(st):
                self._follow_device(fd)
            else:
                self._follow_file(fd)
        finally:
            os.close(fd)

    def _follow_device(self, fd: int) -> None:
        poller = select.poll()
        poller.register(fd, select.POLLIN)
        while not self._stop.is_set():
            events = poller.poll(self.poll_timeout_ms)
            if not events:
                continue
            while True:
                try:
                    rec = os.read(fd, 8192)
                except OSError as e:
                    if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                        break
                    if e.errno == errno.EPIPE:
                        continue
                    raise
                if not rec:
                    break
                self._deliver(rec.decode("utf-8", "replace"))

    def _follow_file(self, fd: int) -> None:
        """tail -f over a regular fixture file so fault-injection tests can
        append lines and see them flow through the same code path. A
        regular file has no poll() wakeup, so appends are watched via
        inotify (event-driven, same near-zero latency as the char device);
        where inotify is unavailable the loop falls back to a short sleep,
        which then floors fixture-mode detection latency."""
        buf = b""
        sleep_s = min(self.poll_timeout_ms, 50) / 1000.0
        ino = _InotifyWatch.create(self.path)
        try:
            while not self._stop.is_set():
                chunk = b""
                try:
                    chunk = os.read(fd, 1 << 16)
                except OSError as e:
                    if e.errno not in (errno.EAGAIN, errno.EWOULDBLOCK):
                        raise
                if chunk:
                    buf += chunk
                    while b"\n" in buf:
                        ln, buf = buf.split(b"\n", 1)
                        self._deliver(ln.decode("utf-8", "replace"))
                else:
                    if ino is not None:
                        # block until the file is modified; capped so the
                        # stop event is honored within ~200ms regardless of
                        # the configured poll timeout
                        ino.wait(min(self.poll_timeout_ms, 200))
                        if self._stop.is_set():
                            return
                    elif self._stop.wait(sleep_s):
                        return
                    # handle truncation/rotation
                    pos = os.lseek(fd, 0, os.SEEK_CUR)
                    size = os.fstat(fd).st_size
                    if size < pos:
                        os.lseek(fd, 0, os.SEEK_SET)
        finally:
            if ino is not None:
                ino.close()

    def _deliver(self, line: str) -> None:
        m = parse_line(line, self.boot_unix)
        if m is None:
            return
        try:
            self.callback(m)
        except Exception:  # noqa: BLE001
            logger.exception("kmsg callback failed")


