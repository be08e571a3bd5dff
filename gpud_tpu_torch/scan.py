"""One-shot diagnostic scan.

The port of ``gpud_tpu/scan.py``. Reference: pkg/scan/scan.go:33-118 —
builds the accelerator instance and a GPUdInstance *without* an event store,
runs Check() on every supported component and prints result tables.
Check() implementations take their "read everything now" path when no event
store is present (e.g. the error component reads the whole kmsg ring
buffer). The host summary reads ``/proc`` where the reference reads psutil.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, TextIO

from gpud_tpu_torch.components.all import all_components
from gpud_tpu_torch.components.base import (
    CheckResult,
    FailureInjector,
    Registry,
    TpudInstance,
)
from gpud_tpu_torch import host as pkghost
from gpud_tpu_torch import procfs
from gpud_tpu_torch.api.v1.types import HealthStateType
from gpud_tpu_torch.gpu.instance import new_instance
from gpud_tpu_torch.providers import detect as provider_detect


_HEALTH_GLYPH = {
    HealthStateType.HEALTHY: "✔",
    HealthStateType.DEGRADED: "◐",
    HealthStateType.UNHEALTHY: "✘",
    HealthStateType.INITIALIZING: "…",
}


def scan(
    accelerator_type: str = "",
    failure_injector: Optional[FailureInjector] = None,
    out: TextIO = sys.stdout,
    availability: Optional[Dict[str, Dict]] = None,
) -> List[CheckResult]:
    """Run every supported component's check once and print a table.
    ``availability`` (component -> availability dict from the health
    ledger) adds a rolling-availability column when the host has a state
    DB with history. Returns the check results (for tests / the CLI exit
    code)."""
    gpu = new_instance(
        failure_injector=failure_injector, accelerator_type=accelerator_type
    )
    inst = TpudInstance(
        machine_id=pkghost.machine_id(),
        gpu_instance=gpu,
        event_store=None,  # scan mode: no persistence (reference: scan.go:83-100)
        failure_injector=failure_injector,
    )
    registry = Registry(inst)
    for init_func in all_components():
        registry.must_register(init_func)

    out.write(f"machine-id : {inst.machine_id}\n")
    # machine summary + provider detect (reference: scan.go:62-73)
    try:
        vm = procfs.virtual_memory()
        out.write(
            f"host       : {pkghost.os_name()}, kernel {pkghost.kernel_version()}, "
            f"{procfs.cpu_count()} cpus, {vm.total >> 30} GiB ram\n"
        )
    except (OSError, KeyError, ValueError):
        pass  # no /proc/meminfo: no summary line, as the reference without psutil
    try:
        prov = provider_detect.detect(timeout=2.0)
        if prov.provider != "unknown":
            out.write(
                f"provider   : {prov.provider} {prov.region} "
                f"{prov.instance_type}".rstrip() + "\n"
            )
    except Exception:  # noqa: BLE001 — a detector thread or fallback bug
        pass  # must not cost the check table
    out.write(f"gpu        : {'present' if gpu.gpu_lib_exists() else 'absent'}")
    if gpu.gpu_lib_exists():
        out.write(
            f" ({gpu.product_name()}, {gpu.accelerator_type() or 'type unknown'}, "
            f"{len(gpu.devices())} GPUs, driver {gpu.driver_version()}, "
            f"CUDA {gpu.runtime_version()})"
        )
    elif gpu.init_error():
        out.write(f" ({gpu.init_error()})")
    out.write("\n\n")

    results: List[CheckResult] = []
    name_w = max(len(c.name()) for c in registry.all())
    for comp in registry.all():
        if not comp.is_supported():
            out.write(f"  {comp.name():<{name_w}}  -  not supported on this host\n")
            continue
        cr = comp.check()
        results.append(cr)
        glyph = _HEALTH_GLYPH.get(cr.health_state_type(), "?")
        av = (availability or {}).get(comp.name())
        av_col = f"  [avail {av['ratio'] * 100:5.1f}%]" if av else ""
        out.write(f"  {comp.name():<{name_w}}  {glyph}{av_col}  {cr.summary()}\n")
        for st in cr.health_states():
            if st.suggested_actions:
                out.write(
                    f"  {'':<{name_w}}     ↳ suggested: "
                    f"{st.suggested_actions.describe_actions()}\n"
                )
    out.write("\n")
    unhealthy = [
        r for r in results if r.health_state_type() != HealthStateType.HEALTHY
    ]
    out.write(
        f"{len(results)} checks, {len(results) - len(unhealthy)} healthy, "
        f"{len(unhealthy)} not healthy\n"
    )
    return results
