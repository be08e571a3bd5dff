"""The GPU adapter: the daemon's one interface to the accelerator.

The port's counterpart of ``gpud_tpu/tpu/instance.py`` and the analog of
``nvml.Instance`` (reference: pkg/nvidia/nvml/instance.go:43-97), with
interchangeable backends behind it:

- ``MockBackend``: an all-success fixture of eight H100 SXM GPUs, enabled
  with ``TPUD_GPU_MOCK_ALL_SUCCESS`` so the whole daemon runs "with GPUs" on
  a CPU-only box (reference: GPUD_NVML_MOCK_ALL_SUCCESS); targeted
  injection envs ``TPUD_GPU_INJECT_*`` mirror the reference's.
- ``NVMLBackend``: the real card, through NVML (``gpu/nvml.py``), a
  side-band API that opens no CUDA context.
- ``TorchBackend``: enumerates through ``torch.cuda``; opt-in with
  ``TPUD_GPU_USE_TORCH=1``, because a CUDA context reserves device memory
  beside the training job that owns the card.
- ``InjectedInstance`` wraps any backend to simulate GPU-lost /
  requires-reset / enumeration failure / product override (reference:
  nvml.NewWithFailureInjector, instance.go:18-38,115).

No module here imports torch when it is imported.
"""

from __future__ import annotations

import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from gpud_tpu_torch.components.base import FailureInjector
from gpud_tpu_torch.gpu import nvml as nvml_mod
from gpud_tpu_torch.gpu.topology import (
    GENERATIONS,
    HostTopology,
    normalize_generation,
    parse_accelerator_type,
)
from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

ENV_MOCK_ALL_SUCCESS = "TPUD_GPU_MOCK_ALL_SUCCESS"
ENV_MOCK_ACCEL_TYPE = "TPUD_GPU_MOCK_ACCELERATOR_TYPE"
ENV_USE_TORCH = "TPUD_GPU_USE_TORCH"
ENV_INJECT_MEMORY_ECC_PENDING = "TPUD_GPU_INJECT_MEMORY_ECC_PENDING"
ENV_INJECT_THERMAL_SLOWDOWN = "TPUD_GPU_INJECT_THERMAL_SLOWDOWN"
ENV_INJECT_NVLINK_LINK_DOWN = "TPUD_GPU_INJECT_NVLINK_LINK_DOWN"


class LinkState:
    UP = "up"
    DOWN = "down"
    UNKNOWN = "unknown"


@dataclass
class NVLinkSnapshot:
    """One NVLink link's state and counters at a point in time (reference:
    components/accelerator/nvidia/infiniband/class/class.go:14-34).

    From NVML: ``replays`` is the data-link replay count, ``crc_errors`` the
    CRC flit and CRC data errors, ``tx_errors`` the link recoveries and
    ``rx_errors`` the ECC data errors. NVML gives no byte counters for a
    link, so ``tx_bytes`` and ``rx_bytes`` stay 0."""

    gpu_id: int
    link_id: int
    state: str = LinkState.UP
    tx_bytes: int = 0
    rx_bytes: int = 0
    tx_errors: int = 0
    rx_errors: int = 0
    crc_errors: int = 0
    replays: int = 0
    speed_gbps: float = 0.0

    @property
    def name(self) -> str:
        return f"gpu{self.gpu_id}/nvlink{self.link_id}"


@dataclass
class GPUTelemetry:
    gpu_id: int
    temperature_c: float = 0.0
    memory_temperature_c: float = 0.0
    power_w: float = 0.0
    memory_used_bytes: int = 0
    memory_total_bytes: int = 0
    duty_cycle_pct: float = 0.0  # utilization rate: time a kernel ran
    memory_util_pct: float = 0.0  # utilization rate of the memory controller
    memory_ecc_correctable: int = 0  # volatile corrected ECC errors
    # volatile uncorrected ECC errors: the aggregate count is lifetime and
    # would mark a card that once had one unhealthy for good
    memory_ecc_uncorrectable: int = 0
    memory_ecc_pending: bool = False  # remapped rows pending (a reset remaps)
    thermal_slowdown: bool = False  # HW or SW thermal slowdown reason bit
    clock_mhz: float = 0.0  # SM clock
    power_limit_w: float = 0.0  # enforced power limit
    remapped_rows_correctable: int = 0
    remapped_rows_uncorrectable: int = 0
    remapping_failed: bool = False
    clock_event_reasons: int = 0
    # fields the card does not support (value left 0) and fields whose
    # read failed, with why
    unsupported: List[str] = field(default_factory=list)
    errors: Dict[str, str] = field(default_factory=dict)


@dataclass
class GPU:
    gpu_id: int
    device_path: str = ""
    pci_address: str = ""
    uuid: str = ""
    name: str = ""
    generation: str = ""
    memory_total_bytes: int = 0
    lost: bool = False
    requires_reset: bool = False
    driver: str = ""
    # identity fields the card does not support, and those whose read failed
    unsupported: List[str] = field(default_factory=list)
    errors: Dict[str, str] = field(default_factory=dict)


class GPUInstance:
    """Top interface (reference: pkg/nvidia/nvml/instance.go:43-97)."""

    # -- presence ----------------------------------------------------------
    def gpu_lib_exists(self) -> bool:
        raise NotImplementedError

    def is_mock(self) -> bool:
        """True when this is the CI fixture backend."""
        return False

    def init_error(self) -> str:
        return ""

    # -- identity ----------------------------------------------------------
    def product_name(self) -> str:
        raise NotImplementedError

    def accelerator_type(self) -> str:
        raise NotImplementedError

    def topology(self) -> Optional[HostTopology]:
        return parse_accelerator_type(self.accelerator_type())

    def generation(self) -> str:
        t = self.topology()
        return t.generation if t else ""

    def driver_version(self) -> str:
        return ""

    def runtime_version(self) -> str:
        """The CUDA version the driver supports."""
        return ""

    def worker_id(self) -> int:
        return 0

    # -- devices -----------------------------------------------------------
    def devices(self) -> Dict[int, GPU]:
        raise NotImplementedError

    def telemetry(self) -> Dict[int, GPUTelemetry]:
        return {}

    def nvlink_links(self) -> List[NVLinkSnapshot]:
        return []

    # -- capabilities (reference: FabricStateSupported etc.,
    #    nvml/instance.go:77-81) ------------------------------------------
    def telemetry_supported(self) -> bool:
        return False

    def telemetry_source(self) -> str:
        """Where telemetry numbers come from, surfaced in the telemetry
        components' extra_info: "nvml", "torch", "mock", or "" (none)."""
        return ""

    def nvlink_supported(self) -> bool:
        return False

    def nvlink_source(self) -> str:
        """Where link states come from: "nvml", "mock", or "" (none)."""
        return ""

    def shutdown(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Mock backend
# ---------------------------------------------------------------------------

class MockBackend(GPUInstance):
    """All-success fixture backend (reference:
    pkg/nvidia/nvml/lib/mock_fixtures.go:12-149 allSuccessInterface).

    Telemetry is deterministic-but-wobbling (sinusoid over a fake clock) so
    metric pipelines see changing values; the fake clock is injectable.
    """

    def __init__(self, accelerator_type: str = "", worker_id: int = 0) -> None:
        self._accel_type = (
            accelerator_type
            or os.environ.get(ENV_MOCK_ACCEL_TYPE, "")
            or "h100-sxm-8"
        )
        topo = parse_accelerator_type(self._accel_type)
        if topo is None:
            raise ValueError(f"unknown accelerator type {self._accel_type!r}")
        self._topo = topo
        self._worker_id = worker_id
        self.time_now_fn = time.time
        self._gpus = {
            i: GPU(
                gpu_id=i,
                device_path=f"/dev/nvidia{i}",
                pci_address=f"00000000:{0x10 + i:02X}:00.0",
                uuid=f"GPU-mock-{self._topo.generation}-{worker_id}-{i}",
                name=self.product_name(),
                generation=self._topo.generation,
                memory_total_bytes=self._topo.memory_bytes_per_gpu,
                driver="nvidia",
            )
            for i in range(self._topo.gpus_per_host)
        }
        # env-based targeted injections (reference: default.go:33-50)
        self._ecc_pending_gpus = _int_set(os.environ.get(ENV_INJECT_MEMORY_ECC_PENDING, ""))
        self._thermal_gpus = _int_set(os.environ.get(ENV_INJECT_THERMAL_SLOWDOWN, ""))
        self._down_links = set(
            x for x in os.environ.get(ENV_INJECT_NVLINK_LINK_DOWN, "").split(",") if x
        )

    def gpu_lib_exists(self) -> bool:
        return True

    def is_mock(self) -> bool:
        return True

    def product_name(self) -> str:
        return f"NVIDIA {self._topo.generation.upper()}"

    def accelerator_type(self) -> str:
        return self._accel_type

    def driver_version(self) -> str:
        return "mock-driver-1.0"

    def runtime_version(self) -> str:
        return "mock-cuda-0.1"

    def worker_id(self) -> int:
        return self._worker_id

    def devices(self) -> Dict[int, GPU]:
        return dict(self._gpus)

    def telemetry_supported(self) -> bool:
        return True

    def telemetry_source(self) -> str:
        return "mock"

    def nvlink_supported(self) -> bool:
        return True

    def nvlink_source(self) -> str:
        return "mock"

    def telemetry(self) -> Dict[int, GPUTelemetry]:
        t = self.time_now_fn()
        out: Dict[int, GPUTelemetry] = {}
        for gid, gpu in self._gpus.items():
            wobble = math.sin(t / 60.0 + gid)
            tel = GPUTelemetry(
                gpu_id=gid,
                temperature_c=45.0 + 5.0 * wobble,
                memory_temperature_c=52.0 + 6.0 * wobble,
                power_w=120.0 + 30.0 * wobble,
                memory_used_bytes=int(gpu.memory_total_bytes * (0.3 + 0.1 * (wobble + 1) / 2)),
                memory_total_bytes=gpu.memory_total_bytes,
                duty_cycle_pct=50.0 + 40.0 * (wobble + 1) / 2,
                memory_util_pct=40.0 + 30.0 * (wobble + 1) / 2,
                clock_mhz=1980.0,
                power_limit_w=700.0,
            )
            if gid in self._ecc_pending_gpus:
                tel.memory_ecc_uncorrectable = 1
                tel.memory_ecc_pending = True
            if gid in self._thermal_gpus:
                tel.temperature_c = 95.0
                tel.thermal_slowdown = True
            out[gid] = tel
        return out

    def nvlink_links(self) -> List[NVLinkSnapshot]:
        t = self.time_now_fn()
        links: List[NVLinkSnapshot] = []
        spec = GENERATIONS[self._topo.generation]
        for gid in self._gpus:
            for lid in range(self._topo.nvlink_links_per_gpu):
                name = f"gpu{gid}/nvlink{lid}"
                down = name in self._down_links
                links.append(
                    NVLinkSnapshot(
                        gpu_id=gid,
                        link_id=lid,
                        state=LinkState.DOWN if down else LinkState.UP,
                        tx_bytes=int(t * 1e6) + gid * 1000 + lid,
                        rx_bytes=int(t * 1e6) + gid * 1000 + lid + 7,
                        speed_gbps=spec.nvlink_gbps_per_link,
                    )
                )
        return links


def _int_set(spec: str) -> set:
    out = set()
    for part in spec.split(","):
        part = part.strip()
        if part.isdigit():
            out.add(int(part))
    return out


# ---------------------------------------------------------------------------
# NVML backend (the real card, side-band)
# ---------------------------------------------------------------------------

class NVMLBackend(GPUInstance):
    """Reads the host's GPUs through NVML. A missing library or a failed
    ``nvmlInit`` is reported by ``gpu_lib_exists()`` (false) and
    ``init_error()``; it never raises. ``lib`` replaces
    ``libnvidia-ml.so.1`` (the tests pass a fake)."""

    def __init__(self, accelerator_type: str = "", worker_id: int = 0, lib=None) -> None:
        self._worker_id = worker_id
        self._lock = threading.Lock()
        self.nvml = nvml_mod.NVML(lib)
        self._init_error = self.nvml.init()
        self._gpus: Dict[int, GPU] = {}
        self._driver = self._cuda = ""
        self._accel_type = accelerator_type
        if self._init_error:
            return
        try:
            self._driver = self.nvml.driver_version()
            self._cuda = self.nvml.cuda_driver_version()
            count = self.nvml.device_count()
        except nvml_mod.NVMLError as e:
            self._init_error = str(e)
            return
        for i in range(count):
            self._gpus[i] = self._enumerate(i)
        if not self._accel_type and self._gpus:
            # single-host type from the enumerated count, as the reference's
            # JAX backend derives one from jax.devices()
            gen = next((g.generation for g in self._gpus.values() if g.generation), "")
            if gen in GENERATIONS:
                self._accel_type = f"{gen}-{len(self._gpus)}"

    def _enumerate(self, index: int) -> GPU:
        gpu = GPU(gpu_id=index, device_path=f"nvml:{index}", driver="nvidia")
        try:
            handle = self.nvml.handle(index)
        except nvml_mod.NVMLError as e:
            gpu.lost = e.code == nvml_mod.NVML_ERROR_GPU_IS_LOST
            gpu.requires_reset = e.code == nvml_mod.NVML_ERROR_RESET_REQUIRED
            return gpu
        r = nvml_mod.DeviceReader(self.nvml, handle)
        gpu.uuid = r.read("uuid", self.nvml.uuid, default="")
        gpu.name = r.read("name", self.nvml.name, default="")
        gpu.pci_address = r.read("pci_bus_id", self.nvml.pci_bus_id, default="")
        gpu.memory_total_bytes = r.read("memory", self.nvml.memory_info, default=(0, 0, 0))[0]
        gpu.generation = normalize_generation(gpu.name) if gpu.name else ""
        gpu.lost, gpu.requires_reset = r.lost, r.requires_reset
        gpu.unsupported, gpu.errors = r.unsupported, r.errors
        return gpu

    def _handles(self):
        """(GPU, handle or None) for every enumerated GPU; a GPU whose
        handle NVML now refuses is marked lost or reset-required."""
        out = []
        for gid, gpu in sorted(self._gpus.items()):
            try:
                out.append((gpu, self.nvml.handle(gid)))
            except nvml_mod.NVMLError as e:
                if e.code == nvml_mod.NVML_ERROR_GPU_IS_LOST:
                    gpu.lost = True
                elif e.code == nvml_mod.NVML_ERROR_RESET_REQUIRED:
                    gpu.requires_reset = True
                out.append((gpu, None))
        return out

    def gpu_lib_exists(self) -> bool:
        return not self._init_error and bool(self._gpus)

    def init_error(self) -> str:
        return self._init_error

    def product_name(self) -> str:
        names = [g.name for g in self._gpus.values() if g.name]
        return names[0] if names else "NVIDIA GPU"

    def accelerator_type(self) -> str:
        return self._accel_type

    def driver_version(self) -> str:
        return self._driver

    def runtime_version(self) -> str:
        return self._cuda

    def worker_id(self) -> int:
        return self._worker_id

    def devices(self) -> Dict[int, GPU]:
        if not self.gpu_lib_exists():
            return {}
        with self._lock:
            self._handles()
            return {gid: GPU(**gpu.__dict__) for gid, gpu in self._gpus.items()}

    def telemetry_supported(self) -> bool:
        return self.gpu_lib_exists()

    def telemetry_source(self) -> str:
        return "nvml"

    def telemetry(self) -> Dict[int, GPUTelemetry]:
        out: Dict[int, GPUTelemetry] = {}
        if not self.gpu_lib_exists():
            return out
        n = self.nvml
        with self._lock:
            for gpu, handle in self._handles():
                if handle is None or gpu.lost:
                    continue
                r = nvml_mod.DeviceReader(n, handle)
                tel = GPUTelemetry(gpu_id=gpu.gpu_id)
                tel.temperature_c = float(r.read("temperature", n.temperature_c))
                tel.memory_temperature_c = r.read("memory_temperature", n.memory_temperature_c,
                                                  default=0.0)
                tel.power_w = r.read("power", n.power_w, default=0.0)
                tel.power_limit_w = r.read("power_limit", n.enforced_power_limit_w, default=0.0)
                tel.clock_mhz = float(r.read("sm_clock", n.sm_clock_mhz))
                gpu_util, mem_util = r.read("utilization", n.utilization, default=(0, 0))
                tel.duty_cycle_pct, tel.memory_util_pct = float(gpu_util), float(mem_util)
                total, _free, used = r.read("memory", n.memory_info, default=(0, 0, 0))
                tel.memory_total_bytes, tel.memory_used_bytes = total, used
                (tel.memory_ecc_correctable,
                 tel.memory_ecc_uncorrectable) = r.read("ecc_volatile", n.volatile_ecc,
                                                        default=(0, 0))
                (tel.remapped_rows_correctable, tel.remapped_rows_uncorrectable,
                 tel.memory_ecc_pending, tel.remapping_failed) = r.read(
                    "remapped_rows", n.remapped_rows, default=(0, 0, False, False))
                tel.clock_event_reasons = r.read("clock_event_reasons", n.clock_event_reasons)
                tel.thermal_slowdown = bool(tel.clock_event_reasons
                                            & nvml_mod.THERMAL_SLOWDOWN_MASK)
                tel.unsupported, tel.errors = r.unsupported, r.errors
                gpu.requires_reset = gpu.requires_reset or r.requires_reset
                if r.lost:
                    gpu.lost = True
                    continue
                out[gpu.gpu_id] = tel
        return out

    def _walk_links(self):
        """[(GPU, [LinkSample])] for every GPU that is not lost."""
        out = []
        for gpu, handle in self._handles():
            if handle is None or gpu.lost:
                continue
            r = nvml_mod.DeviceReader(self.nvml, handle)
            samples = r.links()
            if r.lost:
                gpu.lost = True
                continue
            out.append((gpu, samples))
        return out

    def nvlink_supported(self) -> bool:
        """True when at least one link of one GPU reports a state."""
        if not self.gpu_lib_exists():
            return False
        with self._lock:
            return any(samples for _gpu, samples in self._walk_links())

    def nvlink_source(self) -> str:
        return "nvml" if self.gpu_lib_exists() else ""

    def nvlink_links(self) -> List[NVLinkSnapshot]:
        """Every link that reports a state: an active link is up, an inactive
        one (NVML_FEATURE_DISABLED) down."""
        if not self.gpu_lib_exists():
            return []
        topo = self.topology()
        spec = GENERATIONS.get(topo.generation) if topo else None
        speed = spec.nvlink_gbps_per_link if spec else 0.0
        links: List[NVLinkSnapshot] = []
        with self._lock:
            for gpu, samples in self._walk_links():
                for s in samples:
                    links.append(NVLinkSnapshot(
                        gpu_id=gpu.gpu_id,
                        link_id=s.link_id,
                        state=LinkState.UP if s.active else LinkState.DOWN,
                        tx_errors=s.recoveries,
                        rx_errors=s.ecc_errors,
                        crc_errors=s.crc_errors,
                        replays=s.replays,
                        speed_gbps=speed if s.active else 0.0,
                    ))
        return links

    def shutdown(self) -> None:
        if not self._init_error:
            self.nvml.shutdown()


# ---------------------------------------------------------------------------
# torch backend (opt-in: a CUDA context reserves device memory)
# ---------------------------------------------------------------------------

class TorchBackend(GPUInstance):
    """Enumerates GPUs and samples memory use through ``torch.cuda``.
    Opt-in (TPUD_GPU_USE_TORCH=1): a CUDA context takes device memory on
    every card it touches, so this backend runs only where tpud owns the
    cards (e.g. dedicated health probes), never side-band under a training
    job. torch is imported here, in the constructor, and nowhere else."""

    def __init__(self, accelerator_type: str = "") -> None:
        self._init_error = ""
        self._accel_type = accelerator_type
        self._devices: Dict[int, GPU] = {}
        self._lock = threading.Lock()
        self._cuda = None
        try:
            import torch

            self._cuda = torch.cuda
            if not torch.cuda.is_available():
                raise RuntimeError("torch.cuda finds no CUDA device")
            for i in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(i)
                self._devices[i] = GPU(
                    gpu_id=i,
                    device_path=f"cuda:{i}",
                    uuid=f"GPU-{props.uuid}" if getattr(props, "uuid", None) else "",
                    name=props.name,
                    generation=normalize_generation(props.name),
                    memory_total_bytes=int(props.total_memory),
                )
            if not self._accel_type and self._devices:
                gen = self._devices[0].generation
                if gen in GENERATIONS:
                    self._accel_type = f"{gen}-{len(self._devices)}"
        except Exception as e:  # noqa: BLE001 — absence is reported, not raised
            self._init_error = str(e)

    def gpu_lib_exists(self) -> bool:
        return bool(self._devices)

    def init_error(self) -> str:
        return self._init_error

    def product_name(self) -> str:
        if self._devices:
            return self._devices[0].name
        return "NVIDIA GPU"

    def accelerator_type(self) -> str:
        return self._accel_type

    def devices(self) -> Dict[int, GPU]:
        return dict(self._devices)

    def telemetry_supported(self) -> bool:
        return bool(self._devices)

    def telemetry_source(self) -> str:
        return "torch"

    def telemetry(self) -> Dict[int, GPUTelemetry]:
        out: Dict[int, GPUTelemetry] = {}
        with self._lock:
            for gid in self._devices:
                tel = GPUTelemetry(gpu_id=gid)
                free, total = self._cuda.mem_get_info(gid)
                tel.memory_total_bytes, tel.memory_used_bytes = int(total), int(total - free)
                out[gid] = tel
        return out


# ---------------------------------------------------------------------------
# Failure-injector wrapper + factory
# ---------------------------------------------------------------------------

class InjectedInstance(GPUInstance):
    """Wraps a real/mock backend and overlays simulated failures
    (reference: nvml.NewWithFailureInjector, instance.go:18-38,115)."""

    def __init__(self, inner: GPUInstance, injector: FailureInjector) -> None:
        self.inner = inner
        self.injector = injector

    def gpu_lib_exists(self) -> bool:
        if self.injector.gpu_enumeration_error:
            return False
        return self.inner.gpu_lib_exists()

    def is_mock(self) -> bool:
        return self.inner.is_mock()

    def init_error(self) -> str:
        if self.injector.gpu_enumeration_error:
            return "injected: GPU enumeration failure"
        return self.inner.init_error()

    def product_name(self) -> str:
        return self.injector.product_name_override or self.inner.product_name()

    def accelerator_type(self) -> str:
        return self.inner.accelerator_type()

    def driver_version(self) -> str:
        return self.inner.driver_version()

    def runtime_version(self) -> str:
        return self.inner.runtime_version()

    def worker_id(self) -> int:
        return self.inner.worker_id()

    def devices(self) -> Dict[int, GPU]:
        if self.injector.gpu_enumeration_error:
            return {}
        devs = self.inner.devices()
        out: Dict[int, GPU] = {}
        for gid, gpu in devs.items():
            if gid in self.injector.gpu_ids_lost:
                gpu = GPU(**{**gpu.__dict__, "lost": True})
            if gid in self.injector.gpu_ids_requires_reset:
                gpu = GPU(**{**gpu.__dict__, "requires_reset": True})
            out[gid] = gpu
        return out

    def telemetry_supported(self) -> bool:
        return self.inner.telemetry_supported()

    def telemetry_source(self) -> str:
        return self.inner.telemetry_source()

    def nvlink_source(self) -> str:
        return self.inner.nvlink_source()

    def nvlink_supported(self) -> bool:
        return self.inner.nvlink_supported()

    def telemetry(self) -> Dict[int, GPUTelemetry]:
        tel = self.inner.telemetry()
        for gid in self.injector.gpu_ids_memory_ecc_pending:
            if gid in tel:
                tel[gid].memory_ecc_uncorrectable += 1
                tel[gid].memory_ecc_pending = True
        for gid in self.injector.gpu_ids_thermal_slowdown:
            if gid in tel:
                tel[gid].temperature_c = max(tel[gid].temperature_c, 95.0)
                tel[gid].thermal_slowdown = True
        for gid in self.injector.gpu_ids_lost:
            tel.pop(gid, None)
        return tel

    def nvlink_links(self) -> List[NVLinkSnapshot]:
        links = self.inner.nvlink_links()
        down = set(self.injector.nvlink_links_down)
        for ln in links:
            if ln.name in down:
                ln.state = LinkState.DOWN
        return links

    def shutdown(self) -> None:
        self.inner.shutdown()


def _env_on(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes")


def new_instance(
    failure_injector: Optional[FailureInjector] = None,
    accelerator_type: str = "",
    worker_id: int = 0,
) -> GPUInstance:
    """Factory (reference: nvml.New / NewWithFailureInjector).

    Order: mock env → torch (opt-in) → NVML. The returned instance is always
    usable; absence of GPUs is reported through ``gpu_lib_exists()`` and
    ``init_error()``, never by a switch to another backend.
    """
    inst: GPUInstance
    if _env_on(ENV_MOCK_ALL_SUCCESS):
        inst = MockBackend(accelerator_type=accelerator_type, worker_id=worker_id)
    elif _env_on(ENV_USE_TORCH):
        inst = TorchBackend(accelerator_type=accelerator_type)
    else:
        inst = NVMLBackend(accelerator_type=accelerator_type, worker_id=worker_id)
    if failure_injector is not None and not failure_injector.empty():
        inst = InjectedInstance(inst, failure_injector)
    return inst
