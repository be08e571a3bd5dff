"""Nanoseconds of SQLite's fetch per row fetched, both counted by the
program (the ``fleet_scan.load`` span's ``fetch_s`` and
``rows_fetched``)."""

from fleetbench.program_spans import attr, newest


def read(run):
    spans = newest(run, "fleet_scan.load")
    rows = sum(attr(sp, "rows_fetched") for sp in spans)
    return sum(attr(sp, "fetch_s") for sp in spans) / rows * 1e9 if rows else None
