"""Seconds per sweep, as ``sweep_s`` reads them: the window's length over
the sweeps in it. Per layer, in the cells where the host's drift spreads
``sweep_s`` past any bound the benchmark may set."""


def read(run):
    return run.window_s / run.sweeps if run.sweeps else None
