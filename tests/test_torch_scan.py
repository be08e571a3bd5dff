"""The port's one-shot scan (gpud_tpu_torch/scan.py, ``python -m gpud_tpu_torch
scan``) on its mock backend, against the reference's ``scan()`` on its own.

The reference also registers host components, which wait for the device-free
daemon's slice, so totals are not compared; it runs here with only its
accelerator components registered and provider detection stubbed, so that
it sends nothing over the network. For each accelerator component, matched
through ``COMPONENTS`` in tests/torch_parity.py, the health and the repair
actions must be equal under the same injected faults."""

import io
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import gpud_tpu.providers.detect as ref_detect
import gpud_tpu.scan as ref_scan_mod
from gpud_tpu.components.tpu.anomaly import TPUAnomalyComponent
from gpud_tpu.components.tpu.chip_counts import TPUChipCountsComponent
from gpud_tpu.components.tpu.error_kmsg import TPUErrorKmsgComponent
from gpud_tpu.components.tpu.hbm import TPUHbmComponent
from gpud_tpu.components.tpu.ici import TPUICIComponent
from gpud_tpu.components.tpu.power import TPUPowerComponent
from gpud_tpu.components.tpu.runtime import TPUProcessesComponent, TPURuntimeComponent
from gpud_tpu.components.tpu.temperature import TPUTemperatureComponent

from gpud_tpu_torch.cli import main
from gpud_tpu_torch.components.all import all_components
from gpud_tpu_torch.components.gpu.anomaly import GPUAnomalyComponent
from gpud_tpu_torch.scan import scan

from torch_parity import COMPONENTS, injectors

REPO = Path(__file__).resolve().parent.parent
REF_ACCELERATOR = [TPUChipCountsComponent, TPUTemperatureComponent, TPUHbmComponent,
                   TPUPowerComponent, TPUICIComponent, TPURuntimeComponent,
                   TPUProcessesComponent, TPUErrorKmsgComponent, TPUAnomalyComponent]


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
                "TPUD_GPU_INJECT_NVLINK_LINK_DOWN", "TPUD_TPU_ACCELERATOR_TYPE"):
        monkeypatch.delenv(env, raising=False)


@pytest.fixture
def ref_scan(monkeypatch):
    monkeypatch.setattr(ref_scan_mod, "all_components", lambda: list(REF_ACCELERATOR))
    monkeypatch.setattr(ref_detect, "detect",
                        lambda timeout=2.0: SimpleNamespace(provider="unknown"))
    return ref_scan_mod.scan


def test_components_are_the_reference_accelerator_components_in_order():
    names = [c.NAME for c in all_components()]
    assert names == [COMPONENTS[c.NAME] for c in REF_ACCELERATOR]


def test_scan_on_the_mock_is_all_healthy():
    out = io.StringIO()
    results = scan(out=out)
    assert [r.component_name() for r in results] == sorted(COMPONENTS.values())
    assert all(r.health_state_type() == "Healthy" for r in results)
    text = out.getvalue()
    assert "gpu        : present (NVIDIA H100-SXM, h100-sxm-8, 8 GPUs" in text
    assert "all 144/144 NVLink links up" in text
    assert "9 checks, 9 healthy, 0 not healthy" in text


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
        assert (p.suggested_actions.repair_actions if p.suggested_actions else []) == want
    unsupported = [ln.split()[0] for ln in ref_out.getvalue().splitlines()
                   if "not supported on this host" in ln]
    assert [ln.split()[0] for ln in port_out.getvalue().splitlines()
            if "not supported on this host" in ln] == [COMPONENTS[n] for n in unsupported]


def test_cli_scan_table(capsys):
    assert main(["scan"]) == 0
    out = capsys.readouterr().out
    assert "accelerator-gpu-nvlink" in out and "9 checks, 9 healthy" in out


def test_cli_scan_json_and_strict(capsys, monkeypatch):
    assert main(["scan", "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert {r["component"] for r in rows} == set(COMPONENTS.values())
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


def test_module_entry_point_scan():
    proc = subprocess.run([sys.executable, "-m", "gpud_tpu_torch", "scan", "--strict"],
                          cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                               "TPUD_GPU_MOCK_ALL_SUCCESS": "1",
                               "TPUD_GPU_INJECT_NVLINK_LINK_DOWN": "gpu2/nvlink5"})
    assert proc.returncode == 1, proc.stderr
    assert "NVLink link(s) down: gpu2/nvlink5 (143/144 up)" in proc.stdout


def test_scan_without_nvml_reports_absence(monkeypatch):
    def no_lib(*a, **k):
        raise OSError("libnvidia-ml.so.1: cannot open shared object file")

    monkeypatch.delenv("TPUD_GPU_MOCK_ALL_SUCCESS")
    monkeypatch.setattr("ctypes.CDLL", no_lib)
    out = io.StringIO()
    results = scan(out=out)
    # the kmsg check reads the ring on any host; the rest need the library
    assert [r.component_name() for r in results] == ["accelerator-gpu-counts",
                                                     "accelerator-gpu-error-kmsg"]
    assert results[0].health_state_type() == "Unhealthy"
    assert "cannot open shared object file" in results[0].reason
    assert results[1].health_state_type() == "Healthy"
    assert out.getvalue().count("not supported on this host") == 7
