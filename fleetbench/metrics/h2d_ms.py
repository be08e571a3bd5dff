"""Milliseconds per sweep in ``ops.packed_scan.packed_from_numpy``, the
host-to-device copy, closed after a device synchronise."""

from fleetbench.trace import mean_s


def read(run):
    s = mean_s(run.spans, "packed_from_numpy")
    return None if s is None else s * 1e3
