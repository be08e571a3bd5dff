"""In-process trace ring: why was that check/request/query slow?

A dependency-free tracer for the daemon's own hot paths. Spans carry a
monotonic-clock duration plus a wall-clock start, nest via a per-thread
stack (a sqlite query inside a component check becomes a child span), and
land in a bounded ring buffer — fixed memory, newest-wins, no I/O on the
hot path. ``GET /v1/debug/traces`` serves the ring; ``/v1/info`` carries a
summary. The design follows the host-side-telemetry argument (arxiv
2510.16946) that the monitor's own latency must be observable after the
fact, and eACGM's (arxiv 2506.02007) non-instrusive in-process collection:
no external collector, no sampling daemon, bounded overhead.

Async code (the aiohttp handlers) records flat spans via ``Tracer.record``
instead of the context manager: every request shares the loop thread, so a
thread-local parent stack would mis-attribute concurrent requests.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

DEFAULT_RING_CAPACITY = 2048

STATUS_OK = "ok"
STATUS_ERROR = "error"


class Span:
    """One finished (or in-flight) operation. Plain attributes + to_dict —
    mirrors the repo's dataclass-with-to_dict idiom without paying dataclass
    overhead on the hot path."""

    __slots__ = (
        "span_id", "parent_id", "name", "component", "start_unix",
        "duration_seconds", "status", "error", "attrs", "thread",
    )

    def __init__(
        self,
        span_id: int,
        parent_id: int,
        name: str,
        component: str,
        start_unix: float,
        thread: str = "",
    ) -> None:
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.component = component
        self.start_unix = start_unix
        self.duration_seconds = 0.0
        self.status = STATUS_OK
        self.error = ""
        self.attrs: Dict[str, str] = {}
        self.thread = thread

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = str(value)

    def to_dict(self) -> Dict:
        d: Dict = {
            "span_id": self.span_id,
            "name": self.name,
            "start_unix": self.start_unix,
            "duration_seconds": self.duration_seconds,
            "status": self.status,
        }
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.component:
            d["component"] = self.component
        if self.error:
            d["error"] = self.error
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.thread:
            d["thread"] = self.thread
        return d


class Tracer:
    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY) -> None:
        if capacity <= 0:
            raise ValueError("tracer capacity must be positive")
        self.capacity = capacity
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._recorded = 0
        self._dropped = 0
        self.time_now_fn = time.time

    # -- recording ---------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, component: str = "", attrs: Optional[Dict] = None):
        """Nested span over a sync code block. Exceptions mark the span
        ``error`` and re-raise; the span is recorded either way."""
        st = self._stack()
        sp = Span(
            span_id=next(self._ids),
            parent_id=st[-1].span_id if st else 0,
            name=name,
            component=component,
            start_unix=self.time_now_fn(),
            thread=threading.current_thread().name,
        )
        if attrs:
            for k, v in attrs.items():
                sp.set_attr(k, v)
        st.append(sp)
        t0 = time.monotonic()
        try:
            yield sp
        except BaseException as e:
            sp.status = STATUS_ERROR
            sp.error = f"{type(e).__name__}: {e}"[:500]
            raise
        finally:
            sp.duration_seconds = time.monotonic() - t0
            st.pop()
            self._append(sp)

    def record(
        self,
        name: str,
        duration_seconds: float,
        component: str = "",
        start_unix: Optional[float] = None,
        status: str = STATUS_OK,
        error: str = "",
        attrs: Optional[Dict] = None,
        parent_required: bool = False,
    ) -> Optional[Span]:
        """Flat recording for already-measured operations. With
        ``parent_required`` the span is only kept when a span is active on
        this thread — used for high-frequency leaves (sqlite ops) that are
        only interesting as children of a slow check/dispatch."""
        st = self._stack()
        if parent_required and not st:
            return None
        sp = Span(
            span_id=next(self._ids),
            parent_id=st[-1].span_id if st else 0,
            name=name,
            component=component,
            start_unix=(
                start_unix
                if start_unix is not None
                else self.time_now_fn() - duration_seconds
            ),
            thread=threading.current_thread().name,
        )
        sp.duration_seconds = float(duration_seconds)
        sp.status = status
        sp.error = error[:500]
        if attrs:
            for k, v in attrs.items():
                sp.set_attr(k, v)
        self._append(sp)
        return sp

    def _append(self, sp: Span) -> None:
        with self._mu:
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(sp)
            self._recorded += 1

    # -- reading -----------------------------------------------------------
    def snapshot(
        self,
        component: Optional[str] = None,
        limit: int = 0,
        since: float = 0.0,
        correlation_id: Optional[str] = None,
    ) -> List[Dict]:
        """Newest-first span dicts, optionally filtered by component, a
        unix-timestamp floor on span start, and/or the ``correlation_id``
        attribute the check wrapper stamps on its root span."""
        with self._mu:
            spans = list(self._ring)
        spans.reverse()
        out = []
        for sp in spans:
            if component and sp.component != component:
                continue
            if since and sp.start_unix < since:
                continue
            if correlation_id and sp.attrs.get("correlation_id") != correlation_id:
                continue
            out.append(sp.to_dict())
            if limit and len(out) >= limit:
                break
        return out

    def stats(self) -> Dict:
        with self._mu:
            size = len(self._ring)
            recorded = self._recorded
            dropped = self._dropped
            slowest: Optional[Span] = None
            for sp in self._ring:
                if slowest is None or sp.duration_seconds > slowest.duration_seconds:
                    slowest = sp
        out = {
            "capacity": self.capacity,
            "size": size,
            "recorded_total": recorded,
            "dropped_total": dropped,
        }
        if slowest is not None:
            out["slowest"] = slowest.to_dict()
        return out

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()


# package-global tracer, mirroring metrics.registry.DEFAULT_REGISTRY
DEFAULT_TRACER = Tracer()


def span(name: str, component: str = "", attrs: Optional[Dict] = None):
    return DEFAULT_TRACER.span(name, component=component, attrs=attrs)


# -- cross-node correlation --------------------------------------------------
# The check wrapper (components/base.py) mints one id per check run,
# stamps it on the root span, and holds it in this thread-local for the
# whole run — including the ledger observe() that fires transition hooks
# AFTER the span closes. The server's outbox producers read it to stamp
# outgoing fleet records, so the manager can stitch a fleet event back
# to the exact agent-side trace that produced it (docs/fleet.md).

_correlation = threading.local()
_cid_counter = itertools.count(1)
# per-process random component: timestamp+counter alone collide when two
# agents boot in the same millisecond, and the fleet correlation index
# would stitch their unrelated records together
_cid_nonce = os.urandom(4).hex()


def new_correlation_id() -> str:
    """Fleet-unique, cheap, and grep-able: ``c<nonce>-<unix-ms>-<seq>``."""
    return f"c{_cid_nonce}-{int(time.time() * 1000):x}-{next(_cid_counter):x}"


def set_correlation_id(cid: str) -> None:
    _correlation.cid = cid


def current_correlation_id() -> str:
    return getattr(_correlation, "cid", "")


def clear_correlation_id() -> None:
    _correlation.cid = ""
