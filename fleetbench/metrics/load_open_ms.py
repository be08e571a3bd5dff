"""Milliseconds per sweep that the loader spends opening the host DBs and
reading their tombstones, summed over the DBs: the ``fleet_scan.load``
span's ``open_s``, as the program counts it."""

from fleetbench.program_spans import attr, mean, newest


def read(run):
    s = mean([attr(sp, "open_s") for sp in newest(run, "fleet_scan.load")])
    return None if s is None else s * 1e3
