"""The readers of the program's own spans on the CPU at a few hosts: each
finds its number after a run, reads the window's sweeps and not the warm
one, and the loader's four parts add up to its span."""

import pytest

from conftest import cpu_run, small_cell

from fleetbench import harness
from fleetbench.program_spans import newest

LOADER_PARTS = ("load_open_ms", "load_fetch_ms", "load_rowloop_ms", "load_pack_ms")
PROGRAM_METRICS = set(LOADER_PARTS) | {"load_fetch_ns_per_row"}


@pytest.mark.parametrize("traced", [False, True])
def test_readers_find_the_program_spans(cpu_program, tmp_path, traced):
    cell = small_cell("su-shift")  # the cell that reports the loader's metrics
    out = cpu_run(cell, tmp_path, traced=traced)
    run = out["run"]
    got = harness.read_metrics(cell.per_layer, run)
    assert PROGRAM_METRICS <= set(got)
    assert all(got[m]["value"] > 0 for m in PROGRAM_METRICS)

    loads = newest(run, "fleet_scan.load")
    assert len(loads) == run.sweeps >= 1
    load_ms = sum(sp["duration_seconds"] for sp in loads) / len(loads) * 1e3
    assert sum(got[m]["value"] for m in LOADER_PARTS) == pytest.approx(load_ms, rel=1e-9)
    # the program counts the rows its query fetches: the generator's window
    assert {sp["attrs"]["rows_fetched"] for sp in loads} == {str(run.fleet.rows_window)}
    fetch_ns = got["load_fetch_ns_per_row"]["value"]
    assert fetch_ns == pytest.approx(got["load_fetch_ms"]["value"] * 1e6 / run.fleet.rows_window)
    if traced:  # the harness's span around the loader holds the program's
        assert load_ms <= got["load_ms"]["value"]


def test_readers_are_silent_without_program_spans(cpu_program, tmp_path):
    from gpud_tpu_torch.tracing import DEFAULT_TRACER

    cell = small_cell("su-shift", hosts=3)
    run = cpu_run(cell, tmp_path)["run"]
    DEFAULT_TRACER.clear()  # as a program that records no span leaves it
    got = harness.read_metrics(cell.per_layer, run)
    assert not PROGRAM_METRICS & set(got)
