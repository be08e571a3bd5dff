"""Milliseconds per sweep in ``fleet_scan.load_fleet_history``."""

from fleetbench.trace import mean_s


def read(run):
    s = mean_s(run.spans, "load_fleet_history")
    return None if s is None else s * 1e3
