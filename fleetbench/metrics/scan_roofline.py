"""Share of its roofline that the packed scan reaches, in %.

The device time is that of the kernels launched inside the span around
``ops.packed_scan.scan_links_packed`` (the device synchronised on both
sides), per call, from the profiler's trace. The least time is the work's
bytes (``peaks.scan_work_bytes``: the rows the scan needs and its results,
not the layout) at the card's HBM rate; the traced run evicts the scan's
inputs from the L2 cache before each call (``trace.FLUSHED``), so they come
from HBM.
"""

from fleetbench.peaks import scan_bound_s


def read(run):
    if run.trace is None:
        return None
    calls = len(run.trace.notes.get("scan_links_packed", []))
    kernels = run.trace.kernels_in("scan_links_packed")
    if not calls or not kernels:
        return None
    per_call_s = sum(b - a for _n, a, b in kernels) / 1e6 / calls
    return scan_bound_s(run.fleet.rows_scanned, run.fleet.links_total) / per_call_s * 100
