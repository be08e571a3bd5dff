"""Helpers for the benchmark's CPU tests: the program's scan on the CPU,
and cells cut to a few hosts."""

import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))


@pytest.fixture
def cpu_program(monkeypatch):
    """``fleet_scan`` with its default device on the CPU: the tests skip the
    harness's look for a card and drive the rest of a run."""
    import torch

    import gpud_tpu_torch.fleet_scan as fs

    monkeypatch.setattr(fs, "_scan_devices", lambda _device: [torch.device("cpu")])
    return fs


def small_cell(name="su-hour", hosts=4, spec=None, checkout=CHECKOUT):
    from fleetbench import harness

    spec = spec or harness.load_json(checkout / "BENCHMARK.json")
    cell = harness.find_cell(spec, name, checkout, checkout / "fleetbench")
    if hosts:
        cell.config = dict(cell.config, hosts=hosts)
    return cell


def cpu_run(cell, tmp_path, seed=2**31 + 3, seconds=0.3, traced=False):
    import time

    from fleetbench import harness

    return harness.run_cell(cell, seed, seconds, traced, time.perf_counter(), str(tmp_path),
                            lambda: {"platform": "cpu"}, expect_devices=1)
