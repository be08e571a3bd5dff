"""Milliseconds per sweep in the loader's pack: truncation and the
``[L, T]`` arrays from the per-link lists (the ``fleet_scan.pack``
span)."""

from fleetbench.program_spans import mean, newest


def read(run):
    s = mean([sp["duration_seconds"] for sp in newest(run, "fleet_scan.pack")])
    return None if s is None else s * 1e3
