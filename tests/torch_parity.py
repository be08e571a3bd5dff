"""Parity helpers for the port's GPU components against the reference's TPU ones.

The reference (``gpud_tpu``) and the port (``gpud_tpu_torch``) name the same
things with different nouns. Every substitution between them is listed once,
here, and the parity tests apply these tables to the reference's output
before they compare it with the port's:

- ``NOUNS``: reasons, descriptions and event messages;
- ``TELEMETRY_FIELDS``, ``DEVICE_FIELDS``: the adapter's dataclass fields;
- ``GAUGES``: metric names (the label ``chip`` becomes ``gpu``);
- ``COMPONENTS``: component names;
- ``KNOBS``: the failure injector's knobs;
- ``extra_key``: extra-info keys (``chip{N}_`` becomes ``gpu{N}_``);
- ``link_name``: ``chip{N}/ici{L}`` becomes ``gpu{N}/nvlink{L}``.

Health states, repair actions, event names and types, gauge values and
extra-info values must be equal as they are.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from gpud_tpu.components.base import FailureInjector as RefInjector
from gpud_tpu.metrics.registry import DEFAULT_REGISTRY as REF_REGISTRY
from gpud_tpu.tpu.instance import (
    ICILinkSnapshot,
    MockBackend as RefMock,
    TPUChipTelemetry,
    TPUInstance,
)
from gpud_tpu.tpu.topology import parse_accelerator_type as ref_topology

from gpud_tpu_torch.components.base import FailureInjector
from gpud_tpu_torch.gpu.instance import GPU, GPUInstance, GPUTelemetry, NVLinkSnapshot
from gpud_tpu_torch.gpu.topology import HostTopology
from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY as PORT_REGISTRY

_LINK = re.compile(r"chip(\d+)/ici(\d+)")

# (reference, port), applied in order
NOUNS = [
    ("TPU chips", "GPUs"),
    ("TPU chip", "GPU"),
    ("HBM", "GPU memory"),
    ("TPUs", "GPUs"),
    ("TPU", "GPU"),
    ("ICI", "NVLink"),
    ("chips", "GPUs"),
    ("chip", "GPU"),
]

TELEMETRY_FIELDS = {
    "chip_id": "gpu_id",
    "temperature_c": "temperature_c",
    "hbm_temperature_c": "memory_temperature_c",
    "power_w": "power_w",
    "hbm_used_bytes": "memory_used_bytes",
    "hbm_total_bytes": "memory_total_bytes",
    "duty_cycle_pct": "duty_cycle_pct",
    "tensorcore_util_pct": "memory_util_pct",
    "hbm_ecc_correctable": "memory_ecc_correctable",
    "hbm_ecc_uncorrectable": "memory_ecc_uncorrectable",
    "hbm_ecc_pending": "memory_ecc_pending",
    "thermal_slowdown": "thermal_slowdown",
    "clock_mhz": "clock_mhz",
}
LINK_FIELDS = {"chip_id": "gpu_id", **{f: f for f in (
    "link_id", "state", "tx_bytes", "rx_bytes", "tx_errors", "rx_errors",
    "crc_errors", "replays", "speed_gbps")}}
DEVICE_FIELDS = {"chip_id": "gpu_id", "pci_address": "pci_address",
                 "hbm_total_bytes": "memory_total_bytes", "lost": "lost",
                 "requires_reset": "requires_reset"}

GAUGES = {
    "tpud_tpu_temperature_celsius": "tpud_gpu_temperature_celsius",
    "tpud_tpu_hbm_temperature_celsius": "tpud_gpu_memory_temperature_celsius",
    "tpud_tpu_power_watts": "tpud_gpu_power_watts",
    "tpud_tpu_duty_cycle_percent": "tpud_gpu_duty_cycle_percent",
    "tpud_tpu_tensorcore_util_percent": "tpud_gpu_memory_util_percent",
    "tpud_tpu_clock_mhz": "tpud_gpu_clock_mhz",
    "tpud_tpu_duty_cycle_avg_percent": "tpud_gpu_duty_cycle_avg_percent",
    "tpud_tpu_hbm_used_bytes": "tpud_gpu_memory_used_bytes",
    "tpud_tpu_hbm_total_bytes": "tpud_gpu_memory_total_bytes",
    "tpud_tpu_hbm_ecc_correctable_total": "tpud_gpu_memory_ecc_correctable_total",
    "tpud_tpu_hbm_ecc_uncorrectable_total": "tpud_gpu_memory_ecc_uncorrectable_total",
    "tpud_tpu_chip_count": "tpud_gpu_count",
    "tpud_tpu_chip_count_expected": "tpud_gpu_count_expected",
    "tpud_tpu_ici_links_up": "tpud_gpu_nvlink_links_up",
    "tpud_tpu_ici_links_expected": "tpud_gpu_nvlink_links_expected",
    "tpud_tpu_ici_link_state": "tpud_gpu_nvlink_link_state",
    "tpud_tpu_ici_link_crc_errors_total": "tpud_gpu_nvlink_link_crc_errors_total",
}

COMPONENTS = {
    "accelerator-tpu-temperature": "accelerator-gpu-temperature",
    "accelerator-tpu-power": "accelerator-gpu-power",
    "accelerator-tpu-hbm": "accelerator-gpu-memory",
    "accelerator-tpu-chip-counts": "accelerator-gpu-counts",
    "accelerator-tpu-ici": "accelerator-gpu-nvlink",
}

KNOBS = {
    "chip_ids_lost": "gpu_ids_lost",
    "chip_ids_requires_reset": "gpu_ids_requires_reset",
    "chip_ids_hbm_ecc_pending": "gpu_ids_memory_ecc_pending",
    "chip_ids_thermal_slowdown": "gpu_ids_thermal_slowdown",
    "ici_links_down": "nvlink_links_down",
    "tpu_enumeration_error": "gpu_enumeration_error",
    "product_name_override": "product_name_override",
}

# the kmsg error names that open the fast-poll window
KMSG = {"tpu_ici_link_down": "gpu_nvlink_link_down",
        "tpu_hbm_ecc_uncorrectable": "gpu_memory_ecc_uncorrectable"}


def link_name(name: str) -> str:
    return _LINK.sub(r"gpu\1/nvlink\2", name)


def nouns(text: str) -> str:
    text = link_name(text)
    for a, b in NOUNS:
        text = text.replace(a, b)
    return text


def extra_key(key: str) -> str:
    return re.sub(r"^chip(\d+)_", r"gpu\1_", key)


def injectors(**ref_knobs):
    """The same faults for both packages: (reference injector, port injector)."""
    port = {KNOBS[k]: (list(map(link_name, v)) if k == "ici_links_down" else v)
            for k, v in ref_knobs.items()}
    return RefInjector(**ref_knobs), FailureInjector(**port)


def port_telemetry(t: TPUChipTelemetry) -> GPUTelemetry:
    return GPUTelemetry(**{p: getattr(t, r) for r, p in TELEMETRY_FIELDS.items()})


def port_link(ln: ICILinkSnapshot) -> NVLinkSnapshot:
    return NVLinkSnapshot(**{p: getattr(ln, r) for r, p in LINK_FIELDS.items()})


class MirrorInstance(GPUInstance):
    """A port instance that reports, field by field through the tables
    above, what a reference instance reports: the same GPUs, telemetry and
    links. ``accelerator_type`` is the port's name for the same host size,
    and the topology keeps the reference's links per chip."""

    def __init__(self, ref: TPUInstance, accelerator_type: str) -> None:
        self.ref = ref
        self._accel = accelerator_type

    def gpu_lib_exists(self) -> bool:
        return self.ref.tpu_lib_exists()

    def is_mock(self) -> bool:
        return True

    def init_error(self) -> str:
        return self.ref.init_error()

    def product_name(self) -> str:
        return nouns(self.ref.product_name())

    def accelerator_type(self) -> str:
        return self._accel

    def topology(self) -> Optional[HostTopology]:
        t = ref_topology(self.ref.accelerator_type())
        if t is None:
            return None
        return HostTopology(self._accel, "mirror", t.total_chips, t.hosts, t.chips_per_host,
                            t.ici_links_per_chip, t.hbm_bytes_per_chip)

    def devices(self) -> Dict[int, GPU]:
        return {cid: GPU(**{p: getattr(c, r) for r, p in DEVICE_FIELDS.items()})
                for cid, c in self.ref.devices().items()}

    def telemetry(self) -> Dict[int, GPUTelemetry]:
        return {cid: port_telemetry(t) for cid, t in self.ref.telemetry().items()}

    def nvlink_links(self) -> List[NVLinkSnapshot]:
        return [port_link(ln) for ln in self.ref.ici_links()]

    def telemetry_supported(self) -> bool:
        return self.ref.telemetry_supported()

    def telemetry_source(self) -> str:
        return self.ref.telemetry_source()

    def nvlink_supported(self) -> bool:
        return self.ref.ici_supported()


# accelerator types of the same host size (GPUs on this host): reference -> port
ACCEL = {"v5e-8": "h100-sxm-8", "v5e-4": "h100-sxm-4", "v5p-256": "h100-sxm-4"}


def mirrored_mocks(accel: str = "v5e-8", clock=None):
    """(reference MockBackend, port MirrorInstance over another MockBackend
    of the same type); both read ``clock`` when given."""
    ref, src = RefMock(accelerator_type=accel), RefMock(accelerator_type=accel)
    if clock is not None:
        ref.time_now_fn = src.time_now_fn = lambda: clock[0]
    return ref, MirrorInstance(src, ACCEL[accel])


def gauges(registry, component: str, chips=None, links=None) -> Dict:
    """{(name, labels...): value} of one component's series. Series are
    process-wide, so a series of a GPU or link outside ``chips`` / ``links``
    (port names), left by another test, is left out."""
    out = {}
    for _ts, name, labels, value in registry.gather(0):
        if labels.get("component") != component or (
                name not in GAUGES and name not in GAUGES.values()):
            continue  # the component model's own series are not the check's
        chip = labels.get("chip", labels.get("gpu"))
        if chips is not None and chip is not None and int(chip) not in chips:
            continue
        link = labels.get("link")
        if links is not None and link is not None and link_name(link) not in links:
            continue
        out[(name, tuple(sorted(labels.items())))] = value
    return out


def mapped_ref_gauges(component: str, chips=None, links=None) -> Dict:
    out = {}
    for (name, labels), value in gauges(REF_REGISTRY, component, chips, links).items():
        new = []
        for k, v in labels:
            if k == "component":
                v = COMPONENTS[v]
            elif k == "chip":
                k = "gpu"
            elif k == "link":
                v = link_name(v)
            new.append((k, v))
        out[(GAUGES[name], tuple(sorted(new)))] = value
    return out


def assert_result_parity(ref_cr, port_cr, ref_accel: str = "", port_accel: str = ""):
    """One reference check result against the port's."""
    assert port_cr.component_name() == COMPONENTS[ref_cr.component_name()]
    assert port_cr.health == ref_cr.health, (ref_cr.reason, port_cr.reason)
    assert port_cr.reason == nouns(ref_cr.reason)
    assert port_cr.error == ref_cr.error
    if ref_cr.suggested_actions is None:
        assert port_cr.suggested_actions is None
    else:
        assert port_cr.suggested_actions.repair_actions == ref_cr.suggested_actions.repair_actions
        assert port_cr.suggested_actions.description == nouns(ref_cr.suggested_actions.description)
    want = {extra_key(k): v for k, v in ref_cr.extra_info.items()}
    if "accelerator_type" in want:
        assert want["accelerator_type"] == ref_accel
        want["accelerator_type"] = port_accel
    assert port_cr.extra_info == want


def assert_events_parity(ref_events, port_events):
    assert [(e.name, e.type, nouns(e.message)) for e in ref_events] == \
        [(e.name, e.type, e.message) for e in port_events]


def assert_gauges_parity(ref_component: str, chips=None, links=None):
    """The component's gauges in both registries; ``links`` in port names."""
    port = gauges(PORT_REGISTRY, COMPONENTS[ref_component], chips, links)
    ref = mapped_ref_gauges(ref_component, chips, links)
    assert port == ref
    return port
