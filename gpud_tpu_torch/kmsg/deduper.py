"""Dedup cache for kmsg-derived events (reference: pkg/kmsg/deduper.go);
the port of ``gpud_tpu/kmsg/deduper.py``.

When the daemon re-reads the ring buffer (restart, scan after daemon) the
same line must not produce duplicate events; the cache remembers seen
(message, timestamp-bucket) keys with a TTL.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable

DEFAULT_TTL = 15 * 60.0  # seconds
DEFAULT_MAX_ENTRIES = 4096


class Deduper:
    backend = "python"

    def __init__(
        self,
        ttl_seconds: float = DEFAULT_TTL,
        max_entries: int = DEFAULT_MAX_ENTRIES,
        time_now_fn: Callable[[], float] = time.time,
    ) -> None:
        self.ttl = ttl_seconds
        self.max_entries = max_entries
        self.time_now_fn = time_now_fn
        self._mu = threading.Lock()
        self._seen: "OrderedDict[str, float]" = OrderedDict()

    def _key(self, message: str, ts: float) -> str:
        # bucket timestamps to the second: kmsg µs timestamps of the same
        # record differ between ring re-reads only below this resolution
        return f"{int(ts)}|{message}"

    def seen_before(self, message: str, ts: float) -> bool:
        """Mark-and-test: returns True if this (message, second) was already
        observed within the TTL."""
        now = self.time_now_fn()
        k = self._key(message, ts)
        with self._mu:
            self._evict(now)
            if k in self._seen and self._seen[k] > now:
                return True
            self._seen[k] = now + self.ttl
            self._seen.move_to_end(k)
            while len(self._seen) > self.max_entries:
                self._seen.popitem(last=False)
            return False

    def _evict(self, now: float) -> None:
        while self._seen:
            k, exp = next(iter(self._seen.items()))
            if exp <= now or len(self._seen) > self.max_entries:
                self._seen.popitem(last=False)
            else:
                break
        while len(self._seen) > self.max_entries:
            self._seen.popitem(last=False)

    def __len__(self) -> int:
        with self._mu:
            return len(self._seen)


class NativeBackedDeduper:
    """Same ``seen_before`` contract over the C++ TTL cache
    (native/tpud_native.cpp) — the product fast path; parity with the
    Python Deduper is asserted in tests (incl. lockstep LRU eviction)."""

    backend = "native"

    def __init__(
        self,
        ttl_seconds: float = DEFAULT_TTL,
        max_entries: int = DEFAULT_MAX_ENTRIES,
        time_now_fn: Callable[[], float] = time.time,
    ) -> None:
        from gpud_tpu_torch import native

        self._nd = native.NativeDeduper(ttl_seconds, max_entries)
        self.time_now_fn = time_now_fn
        self._mu = threading.Lock()  # the C++ cache is not thread-safe

    def seen_before(self, message: str, ts: float) -> bool:
        with self._mu:
            return self._nd.seen(f"{int(ts)}|{message}", self.time_now_fn())

    def __len__(self) -> int:
        with self._mu:
            return len(self._nd)


def default_deduper():
    """The native cache when the library is loaded, else the Python one."""
    from gpud_tpu_torch import native

    if native.available():
        return NativeBackedDeduper()
    return Deduper()
