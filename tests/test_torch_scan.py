"""The port's one-shot scan (gpud_tpu_torch/scan.py, ``python -m gpud_tpu_torch
scan``) on its mock backend, against the reference's ``scan()`` on its own.

Both run their 22 components: the 13 host checks and the accelerator checks,
matched through ``COMPONENTS`` in tests/torch_parity.py. Both packages'
network probes, provider detection and subprocesses are stubbed alike
(``stub_host_probes``), and their host figures fixed alike
(``stub_host_readers``), so that nothing goes over the network and the two
tables can be compared line by line after the noun table."""

import io
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

import gpud_tpu.providers.detect as ref_detect
import gpud_tpu.scan as ref_scan_mod
from gpud_tpu.components.all import all_components as ref_all_components
from gpud_tpu.components.tpu.anomaly import TPUAnomalyComponent
from gpud_tpu.components.tpu.chip_counts import TPUChipCountsComponent
from gpud_tpu.components.tpu.error_kmsg import TPUErrorKmsgComponent
from gpud_tpu.components.tpu.hbm import TPUHbmComponent
from gpud_tpu.components.tpu.ici import TPUICIComponent
from gpud_tpu.components.tpu.power import TPUPowerComponent
from gpud_tpu.components.tpu.runtime import TPUProcessesComponent, TPURuntimeComponent
from gpud_tpu.components.tpu.temperature import TPUTemperatureComponent

import gpud_tpu_torch.providers.detect as port_detect
from gpud_tpu_torch.cli import main
from gpud_tpu_torch.components.all import all_components
from gpud_tpu_torch.components.gpu.anomaly import GPUAnomalyComponent
from gpud_tpu_torch.scan import scan

from torch_parity import (
    COMPONENTS,
    HOST_COMPONENTS,
    actions,
    injectors,
    nouns,
    stub_host_probes,
    stub_host_readers,
)

REPO = Path(__file__).resolve().parent.parent
REF_ACCELERATOR = [TPUChipCountsComponent, TPUTemperatureComponent, TPUHbmComponent,
                   TPUPowerComponent, TPUICIComponent, TPURuntimeComponent,
                   TPUProcessesComponent, TPUErrorKmsgComponent, TPUAnomalyComponent]
ACCELERATOR = {COMPONENTS[c.NAME] for c in REF_ACCELERATOR}


@pytest.fixture(autouse=True)
def _mocks(monkeypatch, tmp_path):
    # scan mode reads the whole kmsg ring: an empty file, for both packages
    (tmp_path / "kmsg").write_text("")
    monkeypatch.setenv("TPUD_KMSG_FILE_PATH", str(tmp_path / "kmsg"))
    # and the anomaly check samples a burst of telemetry: no pause between
    for cls in (TPUAnomalyComponent, GPUAnomalyComponent):
        def init(self, instance, _init=cls.__init__):
            _init(self, instance)
            self.burst_interval_seconds = 0.0
        monkeypatch.setattr(cls, "__init__", init)
    monkeypatch.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "1")
    monkeypatch.setenv("TPUD_TPU_MOCK_ALL_SUCCESS", "1")
    for env in ("TPUD_GPU_USE_TORCH", "TPUD_GPU_MOCK_ACCELERATOR_TYPE",
                "TPUD_GPU_INJECT_MEMORY_ECC_PENDING", "TPUD_GPU_INJECT_THERMAL_SLOWDOWN",
                "TPUD_GPU_INJECT_NVLINK_LINK_DOWN", "TPUD_TPU_ACCELERATOR_TYPE",
                "TPUD_HOST_ROOT", "TPUD_PSTORE_DIR"):
        monkeypatch.delenv(env, raising=False)
    stub_host_probes(monkeypatch)
    stub_host_readers(monkeypatch)


@pytest.fixture
def ref_scan():
    return ref_scan_mod.scan


ROW = re.compile(r"^  (\S+)\s+(\S)(.*)$")


def table(text: str, ref: bool):
    """(header lines, {component: (glyph, summary, [suggested lines])}, total
    line) of a scan's output; the reference's after the noun table."""
    head, rows, total, last = [], {}, "", None
    for line in text.splitlines():
        m = ROW.match(line)
        if line.strip().startswith("↳ suggested:"):
            rows[last][2].append(line.strip())
        elif m:
            name = COMPONENTS[m.group(1)] if ref else m.group(1)
            rest = m.group(3).strip()
            rows[name] = (m.group(2), nouns(rest) if ref else rest, [])
            last = name
        elif re.match(r"^\d+ checks, ", line):
            total = line
        elif line.strip():
            head.append(line)
    return head, rows, total


def test_components_are_the_reference_22_in_order():
    names = [c.NAME for c in all_components()]
    assert names == [COMPONENTS[c.NAME] for c in ref_all_components()]
    assert len(names) == 22 and names[:13] == HOST_COMPONENTS


def test_components_are_the_reference_accelerator_components_in_order():
    names = [c.NAME for c in all_components()]
    assert names[13:] == [COMPONENTS[c.NAME] for c in REF_ACCELERATOR]


def test_scan_on_the_mock_is_all_healthy():
    out = io.StringIO()
    results = scan(out=out)
    names = [r.component_name() for r in results]
    assert names == sorted(names) and ACCELERATOR <= set(names)
    assert {"os", "cpu", "memory", "disk", "network-latency", "pci"} <= set(names)
    assert all(r.health_state_type() == "Healthy" for r in results), \
        [(r.component_name(), r.summary()) for r in results]
    text = out.getvalue()
    assert "gpu        : present (NVIDIA H100-SXM, h100-sxm-8, 8 GPUs" in text
    assert "all 144/144 NVLink links up" in text
    assert "8 cpus, 64 GiB ram" in text and "provider" not in text
    assert f"{len(results)} checks, {len(results)} healthy, 0 not healthy" in text
    for name in set(COMPONENTS.values()) - set(names):
        assert re.search(rf"^  {name}\s+-  not supported on this host$", text, re.M)


FAULTS = {
    "none": {},
    "lost chip 0": {"chip_ids_lost": [0]},
    "reset chip 1": {"chip_ids_requires_reset": [1]},
    "ECC pending chip 2": {"chip_ids_hbm_ecc_pending": [2]},
    "thermal chip 3": {"chip_ids_thermal_slowdown": [3]},
    "link chip1/ici2 down": {"ici_links_down": ["chip1/ici2"]},
    "enumeration error": {"tpu_enumeration_error": True},
    "product override": {"product_name_override": "TPU v6e"},
    "several": {"chip_ids_lost": [5], "chip_ids_thermal_slowdown": [6],
                "ici_links_down": ["chip0/ici0", "chip7/ici3"]},
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_scan_matches_the_reference_scan(ref_scan, fault):
    ref_inj, port_inj = injectors(**FAULTS[fault])
    ref_out, port_out = io.StringIO(), io.StringIO()
    ref = {COMPONENTS[r.component_name()]: r
           for r in ref_scan(failure_injector=ref_inj if FAULTS[fault] else None, out=ref_out)}
    got = {r.component_name(): r
           for r in scan(failure_injector=port_inj if FAULTS[fault] else None, out=port_out)}
    assert set(got) == set(ref)
    for name, r in ref.items():
        p = got[name]
        assert p.health_state_type() == r.health_state_type(), (name, r.reason, p.reason)
        want = r.suggested_actions.repair_actions if r.suggested_actions else []
        assert (p.suggested_actions.repair_actions if p.suggested_actions else []) == \
            actions(want)
    # the tables, line by line: the same rows in the same (sorted) order; a
    # host row equal, an accelerator row with the same glyph and suggestions
    # (its figures are each mock's: eight H100s against a v5e-8)
    ref_head, ref_rows, ref_total = table(ref_out.getvalue(), ref=True)
    head, rows, total = table(port_out.getvalue(), ref=False)
    assert list(rows) == sorted(rows) == sorted(ref_rows)
    for name, (glyph, summary, suggested) in ref_rows.items():
        want = [nouns(ln) for ln in suggested]
        if name in ACCELERATOR:
            assert (rows[name][0], rows[name][2]) == (glyph, want), name
        else:
            assert rows[name] == (glyph, summary, want), name
    assert total == ref_total
    # header: machine id and host line equal; the accelerator line names the GPUs
    assert head[:2] == ref_head[:2] and head[1].startswith("host       : ")
    assert head[2].startswith("gpu        : ") and ref_head[2].startswith("tpu        : ")
    assert len(head) == len(ref_head) == 3


def test_scan_runs_the_checks_of_the_host(ref_scan):
    port_out = io.StringIO()
    got = {r.component_name(): r for r in scan(out=port_out)}
    # the host checks that read no outside service report on any host
    for name in ("os", "cpu", "memory", "disk", "kernel-module", "network-latency", "pci"):
        assert name in got, port_out.getvalue()
    assert got["cpu"].summary() == "usage 12.5%, load1 0.50 (8 cores)"
    assert got["memory"].summary() == "used 25.0% of 64 GiB"
    assert got["disk"].summary() == "max filesystem usage 40.0%"
    assert got["network-latency"].summary() == "worst RTT 4.2ms across 3 targets"
    assert "skipped" in got["pci"].summary()  # no lspci, or a virtual machine
    assert got["os"].extra_info["fds_allocated"] == "2048"


@pytest.mark.parametrize("rtts, health", [
    ({"gcp-metadata": None, "google-dns": None, "cloudflare-dns": None}, "Degraded"),
    ({"gcp-metadata": None, "google-dns": 300.0, "cloudflare-dns": 3.0}, "Degraded"),
], ids=["no-egress", "slow-edge"])
def test_network_latency_in_the_scan_as_the_reference(monkeypatch, ref_scan, rtts, health):
    stub_host_probes(monkeypatch, rtts=rtts)
    ref = {r.component_name(): r for r in ref_scan(out=io.StringIO())}["network-latency"]
    got = {r.component_name(): r for r in scan(out=io.StringIO())}["network-latency"]
    assert (got.health_state_type(), got.summary(), got.extra_info) == \
        (ref.health_state_type(), ref.summary(), ref.extra_info)
    assert got.health_state_type() == health


def test_scan_prints_the_provider_line_as_the_reference(monkeypatch, ref_scan):
    for mod in (ref_detect, port_detect):
        monkeypatch.setattr(mod, "detect", lambda timeout=5.0, mod=mod: mod.DetectResult(
            provider="gcp", region="us-east5", instance_type="a3-highgpu-8g"))
    ref_out, port_out = io.StringIO(), io.StringIO()
    ref_scan(out=ref_out)
    scan(out=port_out)
    want = "provider   : gcp us-east5 a3-highgpu-8g"
    assert want in ref_out.getvalue().splitlines() and want in port_out.getvalue().splitlines()


def test_scan_without_meminfo_leaves_out_the_host_line(monkeypatch):
    from gpud_tpu_torch import procfs

    def unreadable(path=procfs.PROC_MEMINFO):
        raise OSError(2, "No such file or directory", path)

    monkeypatch.setattr(procfs, "virtual_memory", unreadable)
    out = io.StringIO()
    scan(out=out)
    assert "host       :" not in out.getvalue() and "gpu        : present" in out.getvalue()


def test_scan_survives_a_failing_provider_detection(monkeypatch):
    def broken(timeout=5.0):
        raise RuntimeError("can't start new thread")

    monkeypatch.setattr(port_detect, "detect", broken)
    out = io.StringIO()
    assert scan(out=out) and "provider" not in out.getvalue()


def test_cli_scan_table(capsys):
    assert main(["scan"]) == 0
    out = capsys.readouterr().out
    assert "accelerator-gpu-nvlink" in out and "network-latency" in out
    n = len(re.findall(r"^  \S+\s+✔", out, re.M))
    assert n >= 16 and f"{n} checks, {n} healthy" in out


def test_cli_scan_json_and_strict(capsys, monkeypatch):
    assert main(["scan", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert ACCELERATOR | {"os", "cpu", "memory", "disk"} <= {r["component"] for r in rows}
    assert {r["component"] for r in rows} <= set(COMPONENTS.values())
    assert all(r["health"] == "Healthy" and r["repair_actions"] == [] for r in rows)
    monkeypatch.setenv("TPUD_GPU_INJECT_THERMAL_SLOWDOWN", "2")
    assert main(["scan", "--json"]) == 0  # not strict: 0 whatever the health
    rows = {r["component"]: r for r in json.loads(capsys.readouterr().out)}
    assert rows["accelerator-gpu-temperature"]["health"] == "Unhealthy"
    assert rows["accelerator-gpu-temperature"]["repair_actions"] == ["HARDWARE_INSPECTION"]
    assert main(["scan", "--strict"]) == 1
    assert "thermal slowdown on GPU(s) [2]" in capsys.readouterr().out


def test_cli_scan_accelerator_type(capsys):
    assert main(["scan", "--json", "--accelerator-type", "h100-sxm-4"]) == 0
    rows = {r["component"]: r for r in json.loads(capsys.readouterr().out)}
    assert rows["accelerator-gpu-counts"]["extra_info"]["expected"] == "4"


# ``python -m gpud_tpu_torch scan --strict`` with the outside probes stubbed
ENTRY_POINT = ("import runpy, sys; sys.path.insert(0, 'tests'); import torch_fakes; "
               "torch_fakes.stub_port_probes(); sys.argv = ['gpud_tpu_torch', 'scan', '--strict']; "
               "runpy.run_module('gpud_tpu_torch', run_name='__main__', alter_sys=True)")


def test_module_entry_point_scan(tmp_path):
    (tmp_path / "kmsg").write_text("")
    proc = subprocess.run([sys.executable, "-c", ENTRY_POINT],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                               "TPUD_GPU_MOCK_ALL_SUCCESS": "1",
                               "TPUD_KMSG_FILE_PATH": str(tmp_path / "kmsg"),
                               "TPUD_GPU_INJECT_NVLINK_LINK_DOWN": "gpu2/nvlink5"})
    assert proc.returncode == 1, proc.stderr
    assert "NVLink link(s) down: gpu2/nvlink5 (143/144 up)" in proc.stdout
    assert re.search(r"^  network-latency\s+✔  worst RTT 4.2ms across 3 targets$",
                     proc.stdout, re.M)


def test_scan_without_nvml_reports_absence(monkeypatch):
    def no_lib(*a, **k):
        raise OSError("libnvidia-ml.so.1: cannot open shared object file")

    monkeypatch.delenv("TPUD_GPU_MOCK_ALL_SUCCESS")
    monkeypatch.setattr("ctypes.CDLL", no_lib)
    out = io.StringIO()
    results = [r for r in scan(out=out) if r.component_name() in ACCELERATOR]
    # the kmsg check reads the ring on any host; the rest need the library
    assert [r.component_name() for r in results] == ["accelerator-gpu-counts",
                                                     "accelerator-gpu-error-kmsg"]
    assert results[0].health_state_type() == "Unhealthy"
    assert "cannot open shared object file" in results[0].reason
    assert results[1].health_state_type() == "Healthy"
    unsupported = re.findall(r"^  (\S+)\s+-  not supported on this host$", out.getvalue(), re.M)
    assert len(set(unsupported) & ACCELERATOR) == 7 and "library" in unsupported
