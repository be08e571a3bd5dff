"""The harness on the CPU at a few hosts: a run is correct against the
reference, readers find their numbers, dropped-in files are taken up, and
the last line has the contract's keys."""

import io
import json
import shutil
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from conftest import CHECKOUT, cpu_run, small_cell

from fleetbench import harness

HOST_METRICS = {"assemble_ms", "load_ms", "load_ns_per_row", "split_ms", "h2d_ms"}


@pytest.mark.parametrize("traced", [False, True])
def test_run_is_correct_on_cpu(cpu_program, tmp_path, traced):
    cell = small_cell("su-shift")  # the cell that reports every metric below
    out = cpu_run(cell, tmp_path, traced=traced)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert all(c["value"] == 0 == c["limit"] for c in out["checks"].values())
    run = out["run"]
    got = harness.read_metrics(cell.end_to_end + cell.per_layer, run)
    assert {"sweep_s", "sweep_rss_mb", "setup_s"} <= set(got)
    # sweep_rss_mb is a difference inside a process that earlier tests have
    # grown; test_sweeps_add_resident_memory holds its sign in a fresh one
    assert all(v["value"] > 0 for k, v in got.items() if k not in ("assemble_ms", "sweep_rss_mb"))
    # the host spans exist only when traced; the device metrics need the card
    assert (HOST_METRICS <= set(got)) == traced
    assert not {"scan_roofline"} & set(got)
    assert run.info["launches_per_sweep"] == 0  # the CPU runs the plain scan


def test_dropped_in_files_are_taken_up(cpu_program, tmp_path):
    """A new configuration, traffic mix, cell and metric are files and
    entries only: nothing that exists is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(CHECKOUT / "fleetbench", root / "fleetbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "fleetbench/configs/hgx-h100-su.json").read_text())
    (root / "fleetbench/configs/tiny.json").write_text(json.dumps(dict(cfg, hosts=3)))
    mix = json.loads((root / "fleetbench/workloads/fleet_faults-hour.json").read_text())
    (root / "fleetbench/workloads/half-hour.json").write_text(
        json.dumps(dict(mix, window_seconds=1800)))
    (root / "fleetbench/metrics/sweeps_done.py").write_text(
        "def read(run):\n    return run.sweeps\n")
    (root / "fleetbench/metrics/never_read.py").write_text(
        "def read(run):\n    return None\n")
    spec["configs"].append({"name": "tiny", "source": "test", "file": "fleetbench/configs/tiny.json",
                            "reduced": ["hosts"], "why": "test"})
    spec["workloads"].append({"name": "tiny-half", "config": "tiny", "traffic": "half-hour",
                              "chips": 1, "why": "test"})
    spec["per_layer"] += [
        {"name": "sweeps_done", "unit": "sweeps", "better": "higher", "source": "host_clock",
         "layer": "test", "moves": "sweep_rss_mb"},
        {"name": "never_read", "unit": "s", "better": "lower", "source": "host_clock",
         "layer": "test", "moves": "sweep_rss_mb"}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.find_cell(spec, "tiny-half", root, root / "fleetbench")
    assert cell.config["hosts"] == 3 and cell.traffic["window_seconds"] == 1800
    # every cell that reports the end-to-end metric a new metric moves takes
    # it up; one whose reader finds nothing is left out
    assert [m["name"] for m in harness.find_cell(spec, "su-hour", root, root / "fleetbench")
            .per_layer][-2:] == ["sweeps_done", "never_read"]
    out = cpu_run(cell, tmp_path)
    assert out["correct"] and out["run"].fleet.links_total == 3 * 144
    got = harness.read_metrics(cell.per_layer, out["run"], root / "fleetbench")
    assert got["sweeps_done"] == {"value": out["attempted"], "unit": "sweeps"}
    assert "never_read" not in got


@pytest.mark.parametrize("name", [w["name"] for w in harness.load_json(
    CHECKOUT / "BENCHMARK.json")["workloads"]])
def test_each_cell_reports_what_its_metrics_name(name):
    """A cell reports setup_s, another end-to-end metric and a per-layer one;
    each per-layer metric it reports moves an end-to-end metric it reports,
    and a metric that lists cells is reported in those alone."""
    spec = harness.load_json(CHECKOUT / "BENCHMARK.json")
    cell = harness.find_cell(spec, name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            assert (m in cell.end_to_end + cell.per_layer) == (name in m["workloads"])


def test_sweeps_add_resident_memory(tmp_path):
    """In a fresh interpreter, as on the card: the window's highest resident
    memory lies above the reading taken before the first sweep."""
    code = f"""
import sys, torch
sys.path.insert(0, {str(CHECKOUT)!r})
sys.path.insert(0, {str(CHECKOUT / 'fleetbench' / 'tests')!r})
import gpud_tpu_torch.fleet_scan as fs
fs._scan_devices = lambda _d: [torch.device("cpu")]
from conftest import cpu_run, small_cell
from fleetbench import harness
cell = small_cell()
got = harness.read_metrics(cell.end_to_end, cpu_run(cell, {str(tmp_path)!r})["run"])
print(got["sweep_rss_mb"]["value"])
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert float(proc.stdout.split()[-1]) > 0


def _fake_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_a: "test card")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *_a: 1)


# what each kind of cell reports: su-shift every metric, the cells whose
# sweep_s the host's drift spreads past any bound the rest
REPORTED = {("su-shift", 0): ({"sweep_s", "sweep_rss_mb", "setup_s"}, set()),
            ("su-shift", 1): ({"load_ms", "split_ms"}, {"sweep_s.unbounded"}),
            ("su-hour", 0): ({"sweep_rss_mb", "setup_s"}, {"sweep_s"}),
            ("su-hour", 1): ({"sweep_s.unbounded"}, {"load_ms", "split_ms"})}


@pytest.mark.parametrize("workload", ["su-shift", "su-hour"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(cpu_program, monkeypatch, trace, workload):
    from fleetbench import run as run_py

    _fake_card(monkeypatch)
    real = harness.find_cell

    def small(spec, name, *a):
        cell = real(spec, name, *a)
        cell.config = dict(cell.config, hosts=3)
        return cell

    monkeypatch.setattr(harness, "find_cell", small)
    stdout, stderr = io.StringIO(), io.StringIO()
    with redirect_stdout(stdout), redirect_stderr(stderr):
        rc = run_py.main(["--workload", workload, "--seed", str(2**33 + 1), "--seconds", "0.2",
                          "--trace", str(trace)])
    assert rc == 0
    line = json.loads(stdout.getvalue().strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else [])
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    wanted, unwanted = REPORTED[workload, trace]
    assert wanted <= set(line["metrics"]) and not unwanted & set(line["metrics"])
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # every number compared, beside its limit, as the last lines on stderr
    tail = stderr.getvalue().strip().splitlines()[-len(line["checks"]):]
    assert tail == [f"check {k} = {c['value']} (limit {c['limit']})"
                    for k, c in line["checks"].items()]


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "fleetbench/run.py", "--workload", "su-hour",
                           "--seed", "1", "--seconds", "1", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    return any(ln.startswith("{") for ln in stdout.splitlines())


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card exit is not reachable here")
    proc = _run_py(CHECKOUT)
    assert proc.returncode == 2 and not _has_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(CHECKOUT / "fleetbench", tmp_path / "fleetbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0 and not _has_result(proc.stdout)


def test_forbidden_names_compared_whole(monkeypatch):
    for name in ("jax.numpy", "gpud_tpu.fleet_scan", "flax", "gpud_tpu_torch_x", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    bad = harness.forbidden_modules()
    assert {"jax.numpy", "gpud_tpu.fleet_scan", "flax"} <= set(bad)
    assert not {"gpud_tpu_torch_x", "jaxtyping", "gpud_tpu_torch"} & set(bad)


def test_the_scan_s_inputs_leave_the_l2_before_its_span():
    from types import SimpleNamespace

    from fleetbench import trace as tr

    events = []
    program = SimpleNamespace(packed_from_numpy=lambda: events.append("copy"),
                              scan_links_packed=lambda: events.append("scan"))
    names = tr.install(program, tr.Spans(), lambda: events.append("sync"),
                       lambda: events.append("flush"))
    program.packed_from_numpy()
    program.scan_links_packed()
    assert events == ["copy", "sync", "flush", "sync", "scan", "sync"]
    tr.uninstall(program, names)
    assert program.scan_links_packed.__name__ == "<lambda>"
