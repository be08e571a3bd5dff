"""Milliseconds per sweep inside SQLite's cursor: the loader's query and
its batched fetch calls, summed over the DBs (the ``fleet_scan.load``
span's ``fetch_s``)."""

from fleetbench.program_spans import attr, mean, newest


def read(run):
    s = mean([attr(sp, "fetch_s") for sp in newest(run, "fleet_scan.load")])
    return None if s is None else s * 1e3
