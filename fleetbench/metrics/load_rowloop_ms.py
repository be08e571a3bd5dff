"""Milliseconds per sweep of the loader outside the opens, SQLite's
fetches and the pack: the Python loop over the fetched rows (tombstone
filter, names, appends). The ``fleet_scan.load`` span less its ``open_s``,
its ``fetch_s`` and its ``fleet_scan.pack`` child."""

from fleetbench.program_spans import attr, mean, newest


def read(run):
    loads = newest(run, "fleet_scan.load")
    packs = {sp.get("parent_id"): sp["duration_seconds"] for sp in newest(run, "fleet_scan.pack")}
    s = mean([sp["duration_seconds"] - attr(sp, "open_s") - attr(sp, "fetch_s")
              - packs[sp["span_id"]] for sp in loads if sp["span_id"] in packs])
    return None if s is None else s * 1e3
