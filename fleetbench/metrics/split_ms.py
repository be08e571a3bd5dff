"""Milliseconds per sweep in ``fleet_scan._classify_split``: pad, copy,
scan, classes and the gather back to the host."""

from fleetbench.trace import mean_s


def read(run):
    s = mean_s(run.spans, "_classify_split")
    return None if s is None else s * 1e3
