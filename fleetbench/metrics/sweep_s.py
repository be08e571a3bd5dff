"""Seconds per sweep: the window's length over the sweeps in it."""


def read(run):
    return run.window_s / run.sweeps if run.sweeps else None
