"""The port's NVML binding (gpud_tpu_torch/gpu/nvml.py) and NVMLBackend
against a fake NVML written in Python (tests/torch_fakes.py): units, the
mapping of each NVML error into the adapter's vocabulary, the link walk,
and no symbol looked up before first use. No libnvidia-ml is needed."""

import ctypes
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from gpud_tpu_torch.gpu import nvml as N
from gpud_tpu_torch.gpu.instance import LinkState, NVMLBackend

from torch_fakes import FakeGPU, FakeNVML

REPO = Path(__file__).resolve().parent.parent


def backend(*gpus, **kw):
    fake = FakeNVML(list(gpus) if gpus else None, **kw)
    return NVMLBackend(lib=fake), fake


# -- loading ---------------------------------------------------------------

def test_import_opens_no_library_and_looks_up_no_symbol():
    code = textwrap.dedent("""
        import ctypes, json
        opened = []
        real = ctypes.CDLL
        ctypes.CDLL = lambda *a, **k: opened.append(a) or real(*a, **k)
        import gpud_tpu_torch.gpu.nvml, gpud_tpu_torch.gpu.instance
        import gpud_tpu_torch.components.all, gpud_tpu_torch.scan
        print(json.dumps(opened))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_binding_looks_up_each_symbol_on_first_use_only():
    fake = FakeNVML()
    nvml = N.NVML(fake)
    assert fake.looked_up == []
    assert nvml.init() == ""
    assert fake.looked_up == ["nvmlInit_v2"]
    h = nvml.handle(0)
    nvml.temperature_c(h)
    nvml.temperature_c(h)
    assert fake.looked_up == ["nvmlInit_v2", "nvmlDeviceGetHandleByIndex_v2",
                              "nvmlDeviceGetTemperature"]


def test_every_bound_function_gets_its_signature():
    fake = FakeNVML()
    b = NVMLBackend(lib=fake)
    b.telemetry(), b.nvlink_links(), b.shutdown()
    fns = N.NVML(fake)
    for name in set(fake.looked_up) - {"nvmlErrorString"}:
        fn = fns._fn(name)
        assert fn.argtypes == N.SIGNATURES[name] and fn.restype is ctypes.c_int


def test_missing_library_is_an_init_error_not_an_exception():
    nvml = N.NVML(path="libnvidia-ml-not-here.so.1")
    msg = nvml.init()
    assert "NVML error 12" in msg and "libnvidia-ml-not-here.so.1" in msg


def test_backend_without_the_library_reports_absence(monkeypatch):
    def no_lib(*a, **k):
        raise OSError("libnvidia-ml.so.1: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", no_lib)
    b = NVMLBackend()
    assert not b.gpu_lib_exists()
    assert "cannot open shared object file" in b.init_error()
    assert b.devices() == {} and b.telemetry() == {} and b.nvlink_links() == []
    assert not b.nvlink_supported() and not b.telemetry_supported()
    b.shutdown()  # nothing was initialised: no call


@pytest.mark.parametrize("rc", [N.NVML_ERROR_DRIVER_NOT_LOADED, N.NVML_ERROR_NO_PERMISSION,
                                N.NVML_ERROR_UNKNOWN])
def test_failed_init_is_an_init_error(rc):
    b, fake = backend(init_rc=rc)
    assert not b.gpu_lib_exists()
    assert f"NVML error {rc}" in b.init_error() and f"fake error {rc}" in b.init_error()
    assert fake.looked_up == ["nvmlInit_v2", "nvmlErrorString"]
    b.shutdown()
    assert not fake.shut_down


def test_shutdown_calls_nvml_shutdown():
    b, fake = backend()
    b.shutdown()
    assert fake.shut_down


# -- units -----------------------------------------------------------------

def test_identity_and_versions():
    b, _ = backend(FakeGPU(), FakeGPU(uuid="GPU-b", bus_id="00000000:2A:00.0"))
    assert b.gpu_lib_exists() and b.init_error() == ""
    assert b.driver_version() == "580.159.03"
    assert b.runtime_version() == "12.8"
    assert b.product_name() == "NVIDIA H100 80GB HBM3"
    devs = b.devices()
    assert [d.uuid for d in devs.values()] == ["GPU-00000000-1111-2222-3333-444444444444",
                                              "GPU-b"]
    assert devs[1].pci_address == "00000000:2A:00.0"
    assert devs[0].generation == "h100-sxm" and devs[0].driver == "nvidia"
    assert devs[0].memory_total_bytes == 85_520_809_984
    assert b.telemetry_source() == "nvml" and b.nvlink_source() == "nvml"


@pytest.mark.parametrize("cuda, text", [(12080, "12.8"), (13000, "13.0"), (11040, "11.4")])
def test_cuda_driver_version_format(cuda, text):
    assert backend(cuda=cuda)[0].runtime_version() == text


def test_telemetry_units():
    b, fake = backend(FakeGPU(power_mw=123_456, power_limit_mw=699_990, ecc=(7, 2),
                              remapped=(3, 1, 1, 0), utilization=(88, 41)))
    t = b.telemetry()[0]
    assert t.temperature_c == 36.0
    assert t.memory_temperature_c == 43.0
    assert t.power_w == pytest.approx(123.456)  # mW -> W
    assert t.power_limit_w == pytest.approx(699.99)
    assert t.clock_mhz == 1980.0
    assert (t.duty_cycle_pct, t.memory_util_pct) == (88.0, 41.0)
    assert (t.memory_total_bytes, t.memory_used_bytes) == (85_520_809_984, 503_316_480)
    assert (t.memory_ecc_correctable, t.memory_ecc_uncorrectable) == (7, 2)
    assert (t.remapped_rows_correctable, t.remapped_rows_uncorrectable) == (3, 1)
    assert t.memory_ecc_pending and not t.remapping_failed
    assert t.unsupported == [] and t.errors == {}
    # volatile counts of both error types, never the aggregate ones
    ecc = [c[2:4] for c in fake.calls if c[0] == "nvmlDeviceGetTotalEccErrors"]
    assert ecc == [(N.NVML_MEMORY_ERROR_TYPE_CORRECTED, N.NVML_VOLATILE_ECC),
                   (N.NVML_MEMORY_ERROR_TYPE_UNCORRECTED, N.NVML_VOLATILE_ECC)]


@pytest.mark.parametrize("vtype, value", [
    (N.NVML_VALUE_TYPE_DOUBLE, 43.5),
    (N.NVML_VALUE_TYPE_UNSIGNED_INT, 43),
    (N.NVML_VALUE_TYPE_UNSIGNED_LONG, 43),
    (N.NVML_VALUE_TYPE_UNSIGNED_LONG_LONG, 43),
    (N.NVML_VALUE_TYPE_SIGNED_LONG_LONG, 43),
    (N.NVML_VALUE_TYPE_SIGNED_INT, -3),
])
def test_memory_temperature_from_field_values(vtype, value):
    t = backend(FakeGPU(memory_temperature=(vtype, value)))[0].telemetry()[0]
    assert t.memory_temperature_c == float(value)


def test_memory_temperature_field_not_supported():
    t = backend(FakeGPU(memory_temperature=(None, 0)))[0].telemetry()[0]
    assert t.memory_temperature_c == 0.0
    assert t.unsupported == ["memory_temperature"]


@pytest.mark.parametrize("reasons, slowdown", [
    (0x1, False), (0x4, False), (0x8, False), (0x20, True), (0x40, True), (0x61, True),
], ids=["idle", "sw power cap", "hw slowdown", "sw thermal", "hw thermal", "both + idle"])
def test_thermal_slowdown_is_the_thermal_reason_bits(reasons, slowdown):
    t = backend(FakeGPU(reasons=reasons))[0].telemetry()[0]
    assert t.clock_event_reasons == reasons and t.thermal_slowdown is slowdown


def test_clock_event_reasons_under_the_older_name():
    b, fake = backend(FakeGPU(reasons=0x40), event_reasons_symbol=False)
    assert b.telemetry()[0].thermal_slowdown
    assert "nvmlDeviceGetCurrentClocksThrottleReasons" in fake.looked_up
    assert "nvmlDeviceGetCurrentClocksEventReasons" not in fake.looked_up


# -- error mapping -----------------------------------------------------------

FIELD_FUNCTIONS = {
    "temperature": "nvmlDeviceGetTemperature",
    "power": "nvmlDeviceGetPowerUsage",
    "power_limit": "nvmlDeviceGetEnforcedPowerLimit",
    "sm_clock": "nvmlDeviceGetClockInfo",
    "utilization": "nvmlDeviceGetUtilizationRates",
    "ecc_volatile": "nvmlDeviceGetTotalEccErrors",
    "remapped_rows": "nvmlDeviceGetRemappedRows",
    "memory_temperature": "nvmlDeviceGetFieldValues",
}


@pytest.mark.parametrize("field", sorted(FIELD_FUNCTIONS))
def test_not_supported_is_absent_and_listed(field):
    b, _ = backend(FakeGPU(errors={FIELD_FUNCTIONS[field]: N.NVML_ERROR_NOT_SUPPORTED},
                           ecc=(9, 9), remapped=(1, 1, 1, 1)))
    t = b.telemetry()[0]
    assert t.unsupported == [field] and t.errors == {}
    if field == "ecc_volatile":
        assert (t.memory_ecc_correctable, t.memory_ecc_uncorrectable) == (0, 0)
    if field == "remapped_rows":
        assert not t.memory_ecc_pending and t.remapped_rows_uncorrectable == 0
    if field == "power":
        assert t.power_w == 0.0


@pytest.mark.parametrize("rc", [N.NVML_ERROR_NO_PERMISSION, N.NVML_ERROR_UNKNOWN,
                                N.NVML_ERROR_UNINITIALIZED])
def test_other_errors_are_absent_with_their_reason(rc):
    b, _ = backend(FakeGPU(errors={"nvmlDeviceGetRemappedRows": rc}, remapped=(0, 0, 1, 0)))
    t = b.telemetry()[0]
    assert not t.memory_ecc_pending and t.unsupported == []
    assert list(t.errors) == ["remapped_rows"]
    assert f"NVML error {rc}" in t.errors["remapped_rows"]
    assert "nvmlDeviceGetRemappedRows" in t.errors["remapped_rows"]


def test_gpu_lost_mid_sample_marks_it_lost_and_drops_its_telemetry():
    lost = FakeGPU(errors={"nvmlDeviceGetPowerUsage": N.NVML_ERROR_GPU_IS_LOST})
    b, fake = backend(FakeGPU(), lost)
    tel = b.telemetry()
    assert set(tel) == {0}
    assert b.devices()[1].lost and not b.devices()[0].lost
    # nothing more is read from the lost GPU after the failing call
    read = [c[0] for c in fake.calls if getattr(c[1] if len(c) > 1 else None, "value", 0) == 2]
    assert "nvmlDeviceGetPowerUsage" in read
    assert "nvmlDeviceGetEnforcedPowerLimit" not in read


def test_gpu_lost_at_its_handle():
    gone = FakeGPU()
    b, _ = backend(FakeGPU(), gone)
    gone.errors["nvmlDeviceGetHandleByIndex_v2"] = N.NVML_ERROR_GPU_IS_LOST
    devs = b.devices()
    assert devs[1].lost and set(b.telemetry()) == {0}
    assert [ln.gpu_id for ln in b.nvlink_links()] == [0] * 18


def test_gpu_lost_at_enumeration():
    b, _ = backend(FakeGPU(), FakeGPU(errors={"nvmlDeviceGetHandleByIndex_v2":
                                              N.NVML_ERROR_GPU_IS_LOST}))
    assert b.devices()[1].lost and b.devices()[1].uuid == ""
    assert b.gpu_lib_exists()


def test_reset_required_marks_the_gpu():
    b, _ = backend(FakeGPU(errors={"nvmlDeviceGetTemperature": N.NVML_ERROR_RESET_REQUIRED}))
    t = b.telemetry()[0]
    assert "temperature" in t.errors
    assert b.devices()[0].requires_reset


def test_identity_read_errors_are_kept():
    b, _ = backend(FakeGPU(errors={"nvmlDeviceGetPciInfo_v3": N.NVML_ERROR_NOT_SUPPORTED,
                                   "nvmlDeviceGetUUID": N.NVML_ERROR_NO_PERMISSION}))
    g = b.devices()[0]
    assert g.pci_address == "" and g.unsupported == ["pci_bus_id"]
    assert g.uuid == "" and "NVML error 4" in g.errors["uuid"]


# -- the link walk -------------------------------------------------------------

def test_link_walk_stops_at_the_first_invalid_index():
    b, fake = backend(FakeGPU(links=[1, 1, 0, 1]))
    links = b.nvlink_links()
    assert [(ln.name, ln.state) for ln in links] == [
        ("gpu0/nvlink0", "up"), ("gpu0/nvlink1", "up"), ("gpu0/nvlink2", "down"),
        ("gpu0/nvlink3", "up")]
    asked = [c[2] for c in fake.calls if c[0] == "nvmlDeviceGetNvLinkState"]
    assert asked == [0, 1, 2, 3, 4]


def test_link_walk_stops_at_nvml_max_links():
    b, fake = backend(FakeGPU(links=[1] * 24))
    assert len(b.nvlink_links()) == N.NVML_NVLINK_MAX_LINKS == 18
    assert max(c[2] for c in fake.calls if c[0] == "nvmlDeviceGetNvLinkState") == 17


def test_link_not_supported_is_not_reported_and_the_walk_goes_on():
    b, _ = backend(FakeGPU(links=[None, 1, None, 0]))
    assert [(ln.link_id, ln.state) for ln in b.nvlink_links()] == [(1, "up"), (3, "down")]
    assert b.nvlink_supported()


def test_no_link_state_at_all_is_not_supported():
    b, _ = backend(FakeGPU(links=[None] * 18), FakeGPU(links=[]))
    assert b.nvlink_links() == []
    assert not b.nvlink_supported()


def test_all_links_inactive_are_reported_down():
    """A single-GPU VM of an HGX host may show every link inactive."""
    b, _ = backend(FakeGPU(links=[0] * 18))
    links = b.nvlink_links()
    assert len(links) == 18 and all(ln.state == LinkState.DOWN for ln in links)
    assert all(ln.speed_gbps == 0.0 for ln in links)
    assert b.nvlink_supported()


def test_link_counters_map_to_the_snapshot():
    counters = {(0, N.NVML_FI_DEV_NVLINK_ERROR_DL_REPLAY): 3,
                (0, N.NVML_FI_DEV_NVLINK_ERROR_DL_RECOVERY): 2,
                (0, N.NVML_FI_DEV_NVLINK_ERROR_DL_CRC): 15,
                (0, N.NVML_FI_DEV_NVLINK_ECC_DATA_ERROR_COUNT_L0): 7}
    b, _ = backend(FakeGPU(links=[1, 1], link_counters=counters))
    first, second = b.nvlink_links()
    assert (first.replays, first.tx_errors, first.crc_errors, first.rx_errors) == (3, 2, 15, 7)
    assert (second.replays, second.tx_errors, second.crc_errors, second.rx_errors) == (0, 0, 0, 0)
    assert first.speed_gbps == 200.0 and first.tx_bytes == first.rx_bytes == 0


def test_link_state_errors_skip_the_link():
    b, _ = backend(FakeGPU(links=[1, 1], errors={"nvmlDeviceGetNvLinkState":
                                                 N.NVML_ERROR_NO_PERMISSION}))
    assert b.nvlink_links() == [] and not b.nvlink_supported()


def test_gpu_lost_during_the_link_walk():
    b, _ = backend(FakeGPU(), FakeGPU(errors={"nvmlDeviceGetNvLinkState":
                                              N.NVML_ERROR_GPU_IS_LOST}))
    assert {ln.gpu_id for ln in b.nvlink_links()} == {0}
    assert b.devices()[1].lost


# -- accelerator type ---------------------------------------------------------------

@pytest.mark.parametrize("names, accel", [
    (["NVIDIA H100 80GB HBM3"] * 8, "h100-sxm-8"),
    (["NVIDIA H100 80GB HBM3"], "h100-sxm-1"),
    (["NVIDIA H100 PCIe"] * 2, "h100-pcie-2"),
    (["NVIDIA H200"] * 8, "h200-sxm-8"),
    (["NVIDIA A100-SXM4-80GB"] * 4, "a100-sxm-4"),
    (["NVIDIA L4"], ""),
])
def test_accelerator_type_from_the_enumerated_gpus(names, accel):
    b, _ = backend(*(FakeGPU(name=n) for n in names))
    assert b.accelerator_type() == accel


def test_explicit_accelerator_type_wins():
    b = NVMLBackend(accelerator_type="h100-sxm-16", lib=FakeNVML())
    assert b.accelerator_type() == "h100-sxm-16"
    assert b.topology().hosts == 2

