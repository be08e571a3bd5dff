"""Unified check scheduler (the port of ``gpud_tpu/scheduler/``): one deadline-min-heap thread + a bounded
worker pool owning every periodic job in the daemon (docs/scheduler.md)."""

from gpud_tpu_torch.scheduler.core import Job, Scheduler

__all__ = ["Job", "Scheduler"]
