"""Share of the traced window in which no kernel, copy or memset ran on
the device, in %: 100 less the union of their intervals over the window."""


def read(run):
    if run.trace is None or not run.trace.ops or not run.trace.window_s():
        return None
    return (1 - run.trace.busy_s() / run.trace.window_s()) * 100
