"""Milliseconds per sweep in ``fleet_scan.fleet_scan`` outside its loader
and its split: the labels dict and the summary."""

from fleetbench.trace import mean_s


def read(run):
    parts = [mean_s(run.spans, n) for n in ("fleet_scan", "load_fleet_history", "_classify_split")]
    if None in parts:
        return None
    entry, load, split = parts
    return (entry - load - split) * 1e3
