"""CPU seconds of the sweeping thread per sweep: beside ``sweep_s``, it
tells work the sweep does from time it waits, or loses to other tenants
of the host's cores."""


def read(run):
    return run.window_cpu_s / run.sweeps if run.sweeps else None
