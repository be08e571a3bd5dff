"""Nanoseconds of ``load_fleet_history`` per row at or after the window's
start, the rows its query reads; the rows are counted from the generated
data, not from the program."""

from fleetbench.trace import mean_s


def read(run):
    s = mean_s(run.spans, "load_fleet_history")
    return None if s is None or not run.fleet.rows_window else s / run.fleet.rows_window * 1e9
