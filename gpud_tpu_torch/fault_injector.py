"""Fault injector; the port of ``gpud_tpu/fault_injector.py``.

Reference: pkg/fault-injector/fault_injector.go:12-69 — an ``Injector``
wrapping the KmsgWriter; requests carry either a catalogued error name
(an Xid/SXid entry of the GPU catalog) or a raw kernel message. Injected lines flow through
the real watcher→syncer→eventstore detection path, making injection both a
product feature and the e2e test harness (SURVEY §4.7).

Beyond the reference's one-shot write, a request may carry a burst/flap
pattern (``repeat`` writes spaced ``interval_seconds`` apart) so chaos
campaigns can model link flaps and error storms with a
single request, and ``inject`` returns a structured :class:`InjectResult`
(line written, catalog entry, timestamp, write count) instead of a bare
error-or-None.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from gpud_tpu_torch.components.gpu import catalog
from gpud_tpu_torch.kmsg.writer import KmsgWriter
from gpud_tpu_torch.log import audit, get_logger

logger = get_logger(__name__)

DEFAULT_PRIORITY = 2  # crit

# burst-pattern guardrails: injection is a product feature reachable from
# the control plane, so a single request must never be able to spin a
# worker for minutes or flood kmsg unbounded
MAX_REPEAT = 100
MAX_INTERVAL_SECONDS = 5.0
MAX_BURST_SECONDS = 30.0


@dataclass
class Request:
    """Either ``gpu_error_name`` (catalogued) or ``kernel_message``
    (reference: Request{XID|KernelMessage}). ``repeat``/``interval_seconds``
    turn the one-shot into a burst (flap storms, cascading link loss)."""

    gpu_error_name: str = ""
    gpu_id: int = 0
    detail: str = ""
    kernel_message: str = ""
    priority: int = DEFAULT_PRIORITY
    repeat: int = 1
    interval_seconds: float = 0.0

    def validate(self) -> Optional[str]:
        if not self.gpu_error_name and not self.kernel_message:
            return "one of gpu_error_name or kernel_message is required"
        if self.gpu_error_name and catalog.lookup(self.gpu_error_name) is None:
            known = ", ".join(sorted(e.name for e in catalog.CATALOG))
            return f"unknown gpu_error_name {self.gpu_error_name!r}; known: {known}"
        if not (1 <= self.repeat <= MAX_REPEAT):
            return f"repeat must be in [1, {MAX_REPEAT}]"
        if not (0.0 <= self.interval_seconds <= MAX_INTERVAL_SECONDS):
            return f"interval_seconds must be in [0, {MAX_INTERVAL_SECONDS:g}]"
        if (self.repeat - 1) * self.interval_seconds > MAX_BURST_SECONDS:
            return (
                f"burst too long: {(self.repeat - 1) * self.interval_seconds:g}s "
                f"(max {MAX_BURST_SECONDS:g}s)"
            )
        return None

    @classmethod
    def from_dict(cls, d: dict) -> "Request":
        return cls(
            gpu_error_name=d.get("gpu_error_name", "") or d.get("name", ""),
            gpu_id=int(d.get("gpu_id", 0)),
            detail=d.get("detail", ""),
            kernel_message=d.get("kernel_message", ""),
            priority=int(d.get("priority", DEFAULT_PRIORITY)),
            repeat=int(d.get("repeat", 1)),
            interval_seconds=float(d.get("interval_seconds", 0.0)),
        )


@dataclass
class InjectResult:
    """What one ``inject`` call actually did: the kmsg line written, the
    catalog entry it maps to (empty for raw kernel messages), when, and
    how many burst writes landed. ``ok`` is False with ``error`` set on
    validation or writer failure."""

    ok: bool
    error: str = ""
    line: str = ""
    entry: str = ""
    code: int = 0
    timestamp: float = field(default=0.0)
    writes: int = 0

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "error": self.error,
            "line": self.line,
            "entry": self.entry,
            "code": self.code,
            "timestamp": self.timestamp,
            "writes": self.writes,
        }


class Injector:
    def __init__(self, writer: Optional[KmsgWriter] = None, kmsg_path: str = "") -> None:
        self.writer = writer or KmsgWriter(path=kmsg_path)
        # injectable for burst tests: no real sleeping under a fake clock
        self.sleep_fn = time.sleep
        self.time_now_fn = time.time

    def inject(self, req: Request) -> InjectResult:
        """Write the fault line (``repeat`` times, ``interval_seconds``
        apart) and return a structured :class:`InjectResult`."""
        err = req.validate()
        if err:
            return InjectResult(ok=False, error=err)
        entry_name, code = "", 0
        if req.gpu_error_name:
            line = catalog.injection_line(req.gpu_error_name, req.gpu_id, req.detail)
            entry = catalog.lookup(req.gpu_error_name)
            if entry is not None:
                entry_name, code = entry.name, entry.code
        else:
            line = req.kernel_message
        audit("inject_fault", line=line, repeat=req.repeat)
        logger.info("injecting fault (x%d): %s", req.repeat, line)
        writes = 0
        ts = self.time_now_fn()
        for i in range(req.repeat):
            if i > 0 and req.interval_seconds > 0:
                self.sleep_fn(req.interval_seconds)
            werr = self.writer.write(line, priority=req.priority)
            if werr:
                return InjectResult(
                    ok=False,
                    error=werr,
                    line=line,
                    entry=entry_name,
                    code=code,
                    timestamp=ts,
                    writes=writes,
                )
            writes += 1
        return InjectResult(
            ok=True,
            line=line,
            entry=entry_name,
            code=code,
            timestamp=ts,
            writes=writes,
        )
