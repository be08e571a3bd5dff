"""Milliseconds per sweep that the sweeping thread spends blocked on the
loader's worker threads, waiting for the next DB's read in DB order: the
``fleet_scan.load`` span's ``wait_s``, as the program counts it. 0 where
the loader reads inline; a program without the counter leaves it out."""

from fleetbench.program_spans import attr, mean, newest


def read(run):
    s = mean([attr(sp, "wait_s") for sp in newest(run, "fleet_scan.load")
              if "wait_s" in sp.get("attrs", {})])
    return None if s is None else s * 1e3
