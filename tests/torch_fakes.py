"""A fake NVML library in Python, for the port's tests of ``gpud_tpu_torch.gpu``,
and stubs of the port's host probes.

``FakeNVML`` has NVML's functions as attributes. The binding calls them with
the same ctypes arguments it passes the real ``libnvidia-ml.so.1`` (pointers
made by ``ctypes.pointer``, string buffers, arrays of field values), and each
returns an NVML status. Every function name looked up is recorded in
``looked_up``.

``stub_port_probes`` replaces what the host checks and ``scan()`` reach
outside the process: the edge RTTs, cloud provider detection and
subprocesses. It imports nothing of the reference package, so a fresh
interpreter can call it before it runs the port's ``scan``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from gpud_tpu_torch.gpu import nvml as N

# edge -> RTT in ms that the stubbed network-latency check measures
EDGE_RTTS_MS = {"gcp-metadata": 0.9, "google-dns": 4.2, "cloudflare-dns": 3.1}


@dataclass
class FakeGPU:
    name: str = "NVIDIA H100 80GB HBM3"
    uuid: str = "GPU-00000000-1111-2222-3333-444444444444"
    bus_id: str = "00000000:19:00.0"
    serial: str = "1654922012345"
    minor: int = 0
    temperature_c: int = 36
    memory_temperature: Tuple[int, object] = (N.NVML_VALUE_TYPE_UNSIGNED_INT, 43)
    power_mw: int = 71_234
    power_limit_mw: int = 700_000
    sm_clock_mhz: int = 1980
    utilization: Tuple[int, int] = (37, 12)
    memory: Tuple[int, int, int] = (85_520_809_984, 85_017_493_504, 503_316_480)
    ecc: Tuple[int, int] = (5, 0)  # volatile corrected, uncorrected
    remapped: Tuple[int, int, int, int] = (0, 0, 0, 0)
    reasons: int = 0x1
    # per link: 1 active, 0 inactive, None not supported; the walk past the
    # last entry returns NVML_ERROR_INVALID_ARGUMENT
    links: List[Optional[int]] = field(default_factory=lambda: [1] * 18)
    # (link, field id) -> value of a link-scoped field value; a missing one
    # is NOT_SUPPORTED
    link_counters: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # (scope id, field id) -> the NVML status of that one field value entry
    field_status: Dict[Tuple[int, int], int] = field(default_factory=dict)
    # function name -> NVML status to return instead of success
    errors: Dict[str, int] = field(default_factory=dict)


class _Fn:
    """A callable that accepts ``argtypes``/``restype`` like a ctypes one."""

    def __init__(self, fn):
        self.fn = fn
        self.argtypes = None
        self.restype = None

    def __call__(self, *args):
        return self.fn(*args)


class FakeNVML:
    def __init__(self, gpus: Optional[List[FakeGPU]] = None, init_rc: int = N.NVML_SUCCESS,
                 driver: str = "580.159.03", cuda: int = 12080,
                 event_reasons_symbol: bool = True) -> None:
        self.gpus = [FakeGPU()] if gpus is None else gpus
        self.init_rc = init_rc
        self.driver = driver
        self.cuda = cuda
        self.event_reasons_symbol = event_reasons_symbol
        self.looked_up: List[str] = []
        self.calls: List[Tuple] = []
        self.shut_down = False

    def __getattr__(self, name):
        if not name.startswith("nvml"):
            raise AttributeError(name)
        if name == "nvmlDeviceGetCurrentClocksEventReasons" and not self.event_reasons_symbol:
            raise AttributeError(name)
        impl = getattr(type(self), "_" + name, None)
        if impl is None:
            raise AttributeError(name)
        self.looked_up.append(name)

        def call(*args):
            self.calls.append((name,) + args)
            return impl(self, *args)

        return _Fn(call)

    # -- helpers -----------------------------------------------------------
    def _gpu(self, handle, fn: str):
        gpu = self.gpus[handle.value - 1]
        return gpu, gpu.errors.get(fn, N.NVML_SUCCESS)

    # -- functions ---------------------------------------------------------
    def _nvmlErrorString(self, rc):
        return f"fake error {rc}".encode()

    def _nvmlInit_v2(self):
        return self.init_rc

    def _nvmlShutdown(self):
        self.shut_down = True
        return N.NVML_SUCCESS

    def _nvmlSystemGetDriverVersion(self, buf, size):
        buf.value = self.driver.encode()
        return N.NVML_SUCCESS

    def _nvmlSystemGetCudaDriverVersion_v2(self, p):
        p.contents.value = self.cuda
        return N.NVML_SUCCESS

    def _nvmlDeviceGetCount_v2(self, p):
        p.contents.value = len(self.gpus)
        return N.NVML_SUCCESS

    def _nvmlDeviceGetHandleByIndex_v2(self, index, p):
        rc = self.gpus[index].errors.get("nvmlDeviceGetHandleByIndex_v2", N.NVML_SUCCESS)
        if rc == N.NVML_SUCCESS:
            p.contents.value = index + 1
        return rc

    def _string(self, fn, handle, buf, attr):
        gpu, rc = self._gpu(handle, fn)
        if rc == N.NVML_SUCCESS:
            buf.value = getattr(gpu, attr).encode()
        return rc

    def _nvmlDeviceGetUUID(self, handle, buf, size):
        return self._string("nvmlDeviceGetUUID", handle, buf, "uuid")

    def _nvmlDeviceGetSerial(self, handle, buf, size):
        return self._string("nvmlDeviceGetSerial", handle, buf, "serial")

    def _nvmlDeviceGetMinorNumber(self, handle, p):
        gpu, rc = self._gpu(handle, "nvmlDeviceGetMinorNumber")
        if rc == N.NVML_SUCCESS:
            p.contents.value = gpu.minor
        return rc

    def _nvmlDeviceGetName(self, handle, buf, size):
        return self._string("nvmlDeviceGetName", handle, buf, "name")

    def _nvmlDeviceGetPciInfo_v3(self, handle, p):
        gpu, rc = self._gpu(handle, "nvmlDeviceGetPciInfo_v3")
        if rc == N.NVML_SUCCESS:
            p.contents.busId = gpu.bus_id.encode()
        return rc

    def _uint(self, fn, handle, p, value):
        gpu, rc = self._gpu(handle, fn)
        if rc == N.NVML_SUCCESS:
            p.contents.value = value(gpu)
        return rc

    def _nvmlDeviceGetTemperature(self, handle, sensor, p):
        assert sensor == N.NVML_TEMPERATURE_GPU
        return self._uint("nvmlDeviceGetTemperature", handle, p, lambda g: g.temperature_c)

    def _nvmlDeviceGetFieldValues(self, handle, count, p):
        """Fills each entry of the array (or the one pointed to) with its own
        status: the memory temperature, or a link's counter by scope id."""
        gpu, rc = self._gpu(handle, "nvmlDeviceGetFieldValues")
        if rc != N.NVML_SUCCESS:
            return rc
        for i in range(count):
            fv = p[i]
            if fv.fieldId == N.NVML_FI_DEV_MEMORY_TEMP:
                vtype, value = gpu.memory_temperature
            else:
                value = gpu.link_counters.get((fv.scopeId, fv.fieldId))
                vtype = None if value is None else N.NVML_VALUE_TYPE_UNSIGNED_LONG_LONG
            status = gpu.field_status.get((fv.scopeId, fv.fieldId))
            if status is not None:
                fv.nvmlReturn = status
                continue
            if vtype is None:  # the field itself is not supported
                fv.nvmlReturn = N.NVML_ERROR_NOT_SUPPORTED
                continue
            fv.nvmlReturn = N.NVML_SUCCESS
            fv.valueType = vtype
            member = {N.NVML_VALUE_TYPE_DOUBLE: "dVal", N.NVML_VALUE_TYPE_UNSIGNED_INT: "uiVal",
                      N.NVML_VALUE_TYPE_UNSIGNED_LONG: "ulVal",
                      N.NVML_VALUE_TYPE_UNSIGNED_LONG_LONG: "ullVal",
                      N.NVML_VALUE_TYPE_SIGNED_LONG_LONG: "sllVal",
                      N.NVML_VALUE_TYPE_SIGNED_INT: "siVal"}[vtype]
            setattr(fv.value, member, value)
        return N.NVML_SUCCESS

    def _nvmlDeviceGetPowerUsage(self, handle, p):
        return self._uint("nvmlDeviceGetPowerUsage", handle, p, lambda g: g.power_mw)

    def _nvmlDeviceGetEnforcedPowerLimit(self, handle, p):
        return self._uint("nvmlDeviceGetEnforcedPowerLimit", handle, p,
                          lambda g: g.power_limit_mw)

    def _nvmlDeviceGetClockInfo(self, handle, kind, p):
        assert kind == N.NVML_CLOCK_SM
        return self._uint("nvmlDeviceGetClockInfo", handle, p, lambda g: g.sm_clock_mhz)

    def _nvmlDeviceGetUtilizationRates(self, handle, p):
        gpu, rc = self._gpu(handle, "nvmlDeviceGetUtilizationRates")
        if rc == N.NVML_SUCCESS:
            p.contents.gpu, p.contents.memory = gpu.utilization
        return rc

    def _nvmlDeviceGetMemoryInfo(self, handle, p):
        gpu, rc = self._gpu(handle, "nvmlDeviceGetMemoryInfo")
        if rc == N.NVML_SUCCESS:
            p.contents.total, p.contents.free, p.contents.used = gpu.memory
        return rc

    def _nvmlDeviceGetTotalEccErrors(self, handle, error_type, counter_type, p):
        assert counter_type == N.NVML_VOLATILE_ECC
        return self._uint("nvmlDeviceGetTotalEccErrors", handle, p,
                          lambda g: g.ecc[error_type])

    def _nvmlDeviceGetRemappedRows(self, handle, *ptrs):
        gpu, rc = self._gpu(handle, "nvmlDeviceGetRemappedRows")
        if rc == N.NVML_SUCCESS:
            for p, v in zip(ptrs, gpu.remapped):
                p.contents.value = v
        return rc

    def _nvmlDeviceGetCurrentClocksEventReasons(self, handle, p):
        return self._uint("nvmlDeviceGetCurrentClocksEventReasons", handle, p,
                          lambda g: g.reasons)

    def _nvmlDeviceGetCurrentClocksThrottleReasons(self, handle, p):
        return self._uint("nvmlDeviceGetCurrentClocksThrottleReasons", handle, p,
                          lambda g: g.reasons)

    def _nvmlDeviceGetNvLinkState(self, handle, link, p):
        gpu, rc = self._gpu(handle, "nvmlDeviceGetNvLinkState")
        if rc != N.NVML_SUCCESS:
            return rc
        if link >= len(gpu.links):
            return N.NVML_ERROR_INVALID_ARGUMENT
        if gpu.links[link] is None:
            return N.NVML_ERROR_NOT_SUPPORTED
        p.contents.value = gpu.links[link]
        return N.NVML_SUCCESS


def no_binary(argv, timeout=None, env=None):
    """``run_command`` for a host without the binary: what ``which``,
    ``systemd-detect-virt`` and ``lspci`` give on a bare container."""
    from gpud_tpu_torch.process import RunResult

    return RunResult(exit_code=-1, error=f"[Errno 2] No such file or directory: {argv[0]!r}")


def probe_stubs(netutil, detect, host, host_extra, rtts=None):
    """(module, attribute, stub) for one package's outside probes."""
    rtts = dict(EDGE_RTTS_MS if rtts is None else rtts)
    return [
        (netutil, "measure_edges", lambda edges=None, timeout=2.0: dict(rtts)),
        (detect, "detect", lambda timeout=5.0: detect.DetectResult(provider="unknown")),
        (host, "run_command", no_binary),
        (host_extra, "run_command", no_binary),
    ]


def stub_port_probes(rtts=None) -> None:
    """Stub the port's probes for the rest of the process."""
    from gpud_tpu_torch import host, netutil
    from gpud_tpu_torch.components import host_extra
    from gpud_tpu_torch.providers import detect

    for module, name, stub in probe_stubs(netutil, detect, host, host_extra, rtts):
        setattr(module, name, stub)
