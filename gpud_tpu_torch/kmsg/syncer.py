"""Kmsg → event-store pump.

Reference: pkg/kmsg/syncer.go:26-100 — a Syncer owns a Watcher, applies a
component-supplied match function to each kernel line, and inserts matching
lines as events into the component's bucket (deduped).

Multiple components share one underlying watcher through ``SharedWatcher``
to keep the steady-state cost at one reader for the whole daemon
(footprint discipline, SURVEY §7 hard parts).
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from gpud_tpu_torch.api.v1.types import Event
from gpud_tpu_torch.eventstore import Bucket
from gpud_tpu_torch.kmsg.deduper import default_deduper
from gpud_tpu_torch.kmsg.watcher import Message, Watcher
from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

# a match function returns (event_name, event_type, message) or
# (event_name, event_type, message, extra_info_dict) or None
MatchFunc = Callable[[str], Optional[tuple]]


class Syncer:
    """One component's kmsg subscription (reference: syncer.go:26-100)."""

    def __init__(
        self,
        match_fn: MatchFunc,
        bucket: Bucket,
        deduper=None,  # any object with the seen_before contract
        on_event: Optional[Callable[[Event], None]] = None,
    ) -> None:
        self.match_fn = match_fn
        self.bucket = bucket
        self.deduper = deduper or default_deduper()
        self.on_event = on_event

    def process(self, msg: Message) -> Optional[Event]:
        matched = self.match_fn(msg.message)
        if matched is None:
            return None
        name, ev_type, text = matched[:3]
        extra = dict(matched[3]) if len(matched) > 3 and matched[3] else {}
        if self.deduper.seen_before(msg.message, msg.time):
            return None
        extra.update({"kmsg": msg.message, "priority": msg.priority_name})
        # stable error taxonomy stamped at ingest: downstream featurizers
        # (predict n-gram novelty) read this instead of re-regexing raw
        # lines; a match_fn-supplied class wins
        extra.setdefault("error_class", name)
        ev = Event(
            component=self.bucket.name(),
            time=msg.time,
            name=name,
            type=ev_type,
            message=text,
            extra_info=extra,
        )
        # event-level dedupe against the store as well (restart safety;
        # reference: xid/component.go:545-570 Find-before-Insert)
        if self.bucket.find(ev) is None:
            self.bucket.insert(ev)
        if self.on_event is not None:
            try:
                self.on_event(ev)
            except Exception:  # noqa: BLE001
                logger.exception("on_event callback failed")
        return ev


class SharedWatcher:
    """Fan-out of one kmsg Watcher to many Syncers."""

    def __init__(self, path: str = "", from_now: bool = True) -> None:
        self._mu = threading.Lock()
        self._syncers: List[Syncer] = []
        self._watcher = Watcher(self._dispatch, path=path, from_now=from_now)
        self._started = False

    def register(self, syncer: Syncer) -> None:
        with self._mu:
            self._syncers.append(syncer)

    def start(self) -> None:
        with self._mu:
            if not self._started:
                self._watcher.start()
                self._started = True

    def close(self) -> None:
        with self._mu:
            if self._started:
                self._watcher.close()
                self._started = False

    def _dispatch(self, msg: Message) -> None:
        with self._mu:
            syncers = list(self._syncers)
        for s in syncers:
            try:
                s.process(msg)
            except Exception:  # noqa: BLE001
                logger.exception("syncer process failed")
