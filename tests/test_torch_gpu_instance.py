"""The port's device adapter (gpud_tpu_torch/gpu/instance.py, gpu/topology.py):
the counterpart of tests/test_tpu_instance.py and test_instance_backends.py.
MockBackend, its injection envs, InjectedInstance over every FailureInjector
knob, the opt-in TorchBackend (with a scripted torch.cuda) and the
new_instance ladder, whose every rung reports absence rather than moving on."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest

from gpud_tpu_torch.components.base import FailureInjector
from gpud_tpu_torch.gpu.instance import (
    GPUInstance,
    InjectedInstance,
    LinkState,
    MockBackend,
    NVMLBackend,
    TorchBackend,
    new_instance,
)
from gpud_tpu_torch.gpu.topology import (
    expected_local_gpus,
    normalize_generation,
    parse_accelerator_type,
)

REPO = Path(__file__).resolve().parent.parent
GPU_ENVS = ("TPUD_GPU_MOCK_ALL_SUCCESS", "TPUD_GPU_USE_TORCH", "TPUD_GPU_MOCK_ACCELERATOR_TYPE",
            "TPUD_GPU_INJECT_MEMORY_ECC_PENDING", "TPUD_GPU_INJECT_THERMAL_SLOWDOWN",
            "TPUD_GPU_INJECT_NVLINK_LINK_DOWN")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for env in GPU_ENVS:
        monkeypatch.delenv(env, raising=False)


# -- topology ----------------------------------------------------------------

@pytest.mark.parametrize("accel, gpus, hosts, per_host, links, mem_gb", [
    ("h100-sxm-8", 8, 1, 8, 18, 80),
    ("h100-sxm-256", 256, 32, 8, 18, 80),
    ("h100-sxm-4", 4, 1, 4, 18, 80),
    ("h100-pcie-2", 2, 1, 2, 0, 80),
    ("h200-sxm-16", 16, 2, 8, 18, 141),
    ("a100-sxm-8", 8, 1, 8, 12, 80),
    ("H100-SXM-8", 8, 1, 8, 18, 80),
])
def test_parse_accelerator_types(accel, gpus, hosts, per_host, links, mem_gb):
    t = parse_accelerator_type(accel)
    assert (t.total_gpus, t.hosts, t.gpus_per_host, t.nvlink_links_per_gpu) == \
        (gpus, hosts, per_host, links)
    assert t.memory_bytes_per_gpu == mem_gb * 1000**3
    assert t.multi_host == (hosts > 1)


@pytest.mark.parametrize("accel", ["", "v5e-8", "h100-8", "l4-1", "h100-sxm", "h100-sxm-x"])
def test_unknown_accelerator_types(accel):
    assert parse_accelerator_type(accel) is None
    assert expected_local_gpus(accel) == 0


@pytest.mark.parametrize("name, gen", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA H100 PCIe", "h100-pcie"),
    ("NVIDIA H200", "h200-sxm"),
    ("NVIDIA A100-SXM4-80GB", "a100-sxm"),
    ("h100-sxm", "h100-sxm"),
    ("NVIDIA H100-SXM", "h100-sxm"),
    ("NVIDIA L4", "l4"),
])
def test_normalize_generation(name, gen):
    assert normalize_generation(name) == gen


@pytest.mark.parametrize("accel, n", [("h100-sxm-8", 8), ("h100-sxm-4", 4),
                                      ("h100-sxm-256", 8), ("h100-pcie-2", 2)])
def test_expected_local_gpus(accel, n):
    assert expected_local_gpus(accel) == n


# -- MockBackend -----------------------------------------------------------------

def test_mock_backend_h100_sxm_8():
    b = MockBackend()
    assert b.accelerator_type() == "h100-sxm-8"
    assert b.gpu_lib_exists() and b.is_mock()
    assert len(b.devices()) == 8
    assert b.telemetry_supported() and b.nvlink_supported()
    tel = b.telemetry()
    assert len(tel) == 8 and 30 < tel[0].temperature_c < 60
    assert tel[0].memory_total_bytes == 80 * 1000**3
    links = b.nvlink_links()
    assert len(links) == 8 * 18
    assert all(ln.state == LinkState.UP for ln in links)
    assert links[0].name == "gpu0/nvlink0" and links[-1].name == "gpu7/nvlink17"


def test_mock_backend_pcie_host_has_no_links():
    b = MockBackend(accelerator_type="h100-pcie-4")
    assert len(b.devices()) == 4 and b.nvlink_links() == []


def test_mock_backend_multi_host_is_a_per_host_view():
    b = MockBackend(accelerator_type="h100-sxm-256")
    assert len(b.devices()) == 8 and len(b.nvlink_links()) == 8 * 18


def test_mock_backend_type_from_env(monkeypatch):
    monkeypatch.setenv("TPUD_GPU_MOCK_ACCELERATOR_TYPE", "h200-sxm-8")
    assert MockBackend().generation() == "h200-sxm"


def test_mock_backend_rejects_unknown_type():
    with pytest.raises(ValueError, match="unknown accelerator type"):
        MockBackend(accelerator_type="v5e-8")


def test_mock_telemetry_is_the_reference_wobble():
    """Same sinusoid over the same fake clock as gpud_tpu's MockBackend."""
    from gpud_tpu.tpu.instance import MockBackend as RefMock

    ref, port = RefMock(accelerator_type="v5e-8"), MockBackend()
    ref.time_now_fn = port.time_now_fn = lambda: 12_345.0
    rt, pt = ref.telemetry(), port.telemetry()
    for cid in range(8):
        assert pt[cid].temperature_c == rt[cid].temperature_c
        assert pt[cid].memory_temperature_c == rt[cid].hbm_temperature_c
        assert pt[cid].power_w == rt[cid].power_w
        assert pt[cid].duty_cycle_pct == rt[cid].duty_cycle_pct
        assert pt[cid].memory_util_pct == rt[cid].tensorcore_util_pct


def test_mock_env_injections(monkeypatch):
    monkeypatch.setenv("TPUD_GPU_INJECT_MEMORY_ECC_PENDING", "1,2")
    monkeypatch.setenv("TPUD_GPU_INJECT_THERMAL_SLOWDOWN", "5")
    monkeypatch.setenv("TPUD_GPU_INJECT_NVLINK_LINK_DOWN", "gpu0/nvlink1,gpu3/nvlink17")
    b = MockBackend()
    tel = b.telemetry()
    assert tel[1].memory_ecc_pending and tel[2].memory_ecc_pending
    assert tel[1].memory_ecc_uncorrectable == 1 and not tel[0].memory_ecc_pending
    assert tel[5].thermal_slowdown and tel[5].temperature_c == 95.0
    down = [ln.name for ln in b.nvlink_links() if ln.state == LinkState.DOWN]
    assert down == ["gpu0/nvlink1", "gpu3/nvlink17"]


def test_mock_backend_full_surface():
    b = MockBackend()
    assert set(b.telemetry()) == set(b.devices())
    assert b.topology() is not None and b.generation() == "h100-sxm"
    assert b.driver_version() and b.runtime_version() and b.worker_id() == 0
    assert b.telemetry_source() == "mock" and b.nvlink_source() == "mock"
    assert b.init_error() == "" and b.shutdown() is None


def test_abstract_interface_raises():
    g = GPUInstance()
    for call in (g.gpu_lib_exists, g.devices, g.product_name, g.accelerator_type):
        with pytest.raises(NotImplementedError):
            call()
    assert g.telemetry() == {} and g.nvlink_links() == []
    assert not g.telemetry_supported() and not g.nvlink_supported()


# -- InjectedInstance over every knob ------------------------------------------------

def _injected(**knobs):
    return InjectedInstance(MockBackend(), FailureInjector(**knobs))


def test_injector_gpu_lost():
    b = _injected(gpu_ids_lost=[0])
    devs = b.devices()
    assert devs[0].lost and not devs[1].lost
    assert 0 not in b.telemetry()  # a lost GPU drops out of telemetry


def test_injector_requires_reset():
    devs = _injected(gpu_ids_requires_reset=[2, 3]).devices()
    assert [g for g, d in devs.items() if d.requires_reset] == [2, 3]


def test_injector_memory_ecc_pending():
    tel = _injected(gpu_ids_memory_ecc_pending=[4]).telemetry()
    assert tel[4].memory_ecc_pending and tel[4].memory_ecc_uncorrectable == 1
    assert not tel[3].memory_ecc_pending


def test_injector_thermal_slowdown():
    tel = _injected(gpu_ids_thermal_slowdown=[1]).telemetry()
    assert tel[1].thermal_slowdown and tel[1].temperature_c >= 95.0


def test_injector_links_down():
    b = _injected(nvlink_links_down=["gpu2/nvlink0", "gpu7/nvlink17"])
    down = [ln.name for ln in b.nvlink_links() if ln.state == LinkState.DOWN]
    assert down == ["gpu2/nvlink0", "gpu7/nvlink17"]


def test_injector_product_name_override():
    b = _injected(product_name_override="NVIDIA H200")
    assert b.product_name() == "NVIDIA H200"
    assert b.accelerator_type() == "h100-sxm-8"


def test_injector_enumeration_error():
    b = _injected(gpu_enumeration_error=True)
    assert not b.gpu_lib_exists() and b.devices() == {}
    assert "injected" in b.init_error()


def test_injector_passes_the_rest_through():
    b = _injected(gpu_ids_lost=[1])
    assert b.is_mock() and b.telemetry_supported() and b.nvlink_supported()
    assert b.telemetry_source() == "mock" and b.nvlink_source() == "mock"
    assert b.driver_version() == "mock-driver-1.0" and b.runtime_version() == "mock-cuda-0.1"
    assert b.worker_id() == 0 and b.shutdown() is None


@pytest.mark.parametrize("knobs, empty", [
    ({}, True), ({"gpu_ids_lost": [0]}, False), ({"gpu_ids_requires_reset": [0]}, False),
    ({"gpu_ids_memory_ecc_pending": [0]}, False), ({"gpu_ids_thermal_slowdown": [0]}, False),
    ({"nvlink_links_down": ["gpu0/nvlink0"]}, False), ({"gpu_enumeration_error": True}, False),
    ({"product_name_override": "x"}, False),
])
def test_injector_empty(knobs, empty):
    assert FailureInjector(**knobs).empty() is empty


# -- TorchBackend (opt-in), with a scripted torch.cuda -------------------------------------

def _fake_cuda(monkeypatch, names, free=10 << 30):
    import torch

    props = [SimpleNamespace(name=n, total_memory=80 << 30, uuid=f"uuid-{i}")
             for i, n in enumerate(names)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: bool(names))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(names))
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props[i])
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (free, 80 << 30))


def test_torch_backend_enumerates(monkeypatch):
    _fake_cuda(monkeypatch, ["NVIDIA H100 80GB HBM3"] * 2)
    b = TorchBackend()
    assert b.gpu_lib_exists() and b.init_error() == ""
    assert b.accelerator_type() == "h100-sxm-2"
    assert b.product_name() == "NVIDIA H100 80GB HBM3"
    assert [d.uuid for d in b.devices().values()] == ["GPU-uuid-0", "GPU-uuid-1"]
    tel = b.telemetry()
    assert tel[1].memory_total_bytes == 80 << 30
    assert tel[1].memory_used_bytes == (80 << 30) - (10 << 30)
    assert b.telemetry_source() == "torch" and not b.nvlink_supported()


def test_torch_backend_without_a_card_reports_absence():
    b = TorchBackend()  # this box has no CUDA device
    assert not b.gpu_lib_exists()
    assert "no CUDA device" in b.init_error()
    assert b.devices() == {} and b.telemetry() == {}


def test_torch_backend_explicit_type_wins(monkeypatch):
    _fake_cuda(monkeypatch, ["NVIDIA H100 80GB HBM3"])
    assert TorchBackend(accelerator_type="h100-sxm-8").accelerator_type() == "h100-sxm-8"


def test_torch_is_imported_by_the_torch_backend_only():
    code = textwrap.dedent("""
        import json, sys
        import gpud_tpu_torch.gpu.instance as gi
        gi.MockBackend().telemetry()
        gi.new_instance()
        before = "torch" in sys.modules
        gi.TorchBackend()
        print(json.dumps([before, "torch" in sys.modules]))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == [False, True]


# -- the new_instance ladder -------------------------------------------------------------

def test_factory_mock_env(monkeypatch):
    monkeypatch.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "1")
    assert isinstance(new_instance(), MockBackend)
    assert isinstance(new_instance(FailureInjector(gpu_ids_lost=[0])), InjectedInstance)
    assert isinstance(new_instance(FailureInjector()), MockBackend)  # empty: no wrapper
    assert new_instance(accelerator_type="h100-sxm-4").accelerator_type() == "h100-sxm-4"


def test_factory_mock_wins_over_torch(monkeypatch):
    monkeypatch.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "true")
    monkeypatch.setenv("TPUD_GPU_USE_TORCH", "1")
    assert isinstance(new_instance(), MockBackend)


def test_factory_torch_opt_in(monkeypatch):
    monkeypatch.setenv("TPUD_GPU_USE_TORCH", "yes")
    _fake_cuda(monkeypatch, ["NVIDIA H100 80GB HBM3"])
    b = new_instance()
    assert isinstance(b, TorchBackend) and b.gpu_lib_exists()


def test_factory_torch_opt_in_without_a_card_stays_torch(monkeypatch):
    monkeypatch.setenv("TPUD_GPU_USE_TORCH", "1")
    b = new_instance()
    assert isinstance(b, TorchBackend)
    assert not b.gpu_lib_exists() and b.init_error()


@pytest.mark.parametrize("value", ["", "0", "false", "no"])
def test_factory_defaults_to_nvml(monkeypatch, value):
    monkeypatch.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", value)
    monkeypatch.setenv("TPUD_GPU_USE_TORCH", value)
    b = new_instance()
    assert isinstance(b, NVMLBackend)


def test_factory_nvml_absent_is_reported_not_replaced(monkeypatch):
    def no_lib(*a, **k):
        raise OSError("libnvidia-ml.so.1: cannot open shared object file")

    monkeypatch.setattr("ctypes.CDLL", no_lib)
    b = new_instance(FailureInjector(gpu_ids_lost=[0]))
    assert isinstance(b, InjectedInstance) and isinstance(b.inner, NVMLBackend)
    assert not b.gpu_lib_exists() and "cannot open" in b.init_error()


def test_factory_nvml_over_a_fake_library(monkeypatch):
    from torch_fakes import FakeGPU, FakeNVML

    fake = FakeNVML([FakeGPU() for _ in range(8)])
    monkeypatch.setattr("ctypes.CDLL", lambda path: fake)
    b = new_instance()
    assert isinstance(b, NVMLBackend) and b.gpu_lib_exists()
    assert b.accelerator_type() == "h100-sxm-8" and len(b.devices()) == 8
    assert len(b.nvlink_links()) == 144 and b.nvlink_supported()
