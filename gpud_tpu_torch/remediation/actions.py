"""Remediation action executors; the port of ``gpud_tpu/remediation/actions.py``.

Soft tier first, hard tier last — the same ladder an operator walks by
hand: re-run the check (the fault may have cleared), clear a sticky state,
restart the GPU runtime unit, and only then reboot the host. Every
executor returns ``(ok, detail)`` and never raises: the engine records the
outcome in the audit ledger either way, and one misbehaving executor must
not kill the scan loop.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from gpud_tpu_torch import host as pkghost
from gpud_tpu_torch.api.v1.types import HealthStateType
from gpud_tpu_torch.log import get_logger
from gpud_tpu_torch.process import run_command

logger = get_logger(__name__)

# default systemd unit the restart_runtime executor bounces; mirrors the
# runtime component's unit list: the first of components/gpu/runtime.py's
# RUNTIME_UNITS (the reference bounces tpu-runtime.service)
DEFAULT_RUNTIME_UNIT = "nvidia-fabricmanager.service"

RESTART_TIMEOUT = 60.0


class Executors:
    """Executor set with injectable process/reboot functions (tests swap
    ``run_command_fn``/``reboot_fn`` exactly like the dispatcher's
    ``reboot_fn``)."""

    def __init__(
        self,
        registry=None,
        runtime_unit: str = "",
        run_command_fn: Optional[Callable] = None,
        reboot_fn: Optional[Callable] = None,
    ) -> None:
        self.registry = registry
        self.runtime_unit = runtime_unit or DEFAULT_RUNTIME_UNIT
        self.run_command_fn = run_command_fn or run_command
        # the same privileged path the session's reboot dispatch uses
        self.reboot_fn = reboot_fn or pkghost.reboot

    # -- soft tier ---------------------------------------------------------
    def retrigger_check(self, component: str) -> Tuple[bool, str]:
        """Re-run the component's check; success = it came back Healthy."""
        comp = self.registry.get(component) if self.registry else None
        if comp is None:
            return False, f"component {component!r} not found"
        try:
            cr = comp.check()
        except Exception as e:  # noqa: BLE001 — executor must not raise
            return False, f"check raised: {e}"
        health = cr.health_state_type()
        ok = health == HealthStateType.HEALTHY
        return ok, f"re-check came back {health}"

    def set_healthy(self, component: str) -> Tuple[bool, str]:
        """Clear a sticky state (only components exposing set_healthy)."""
        comp = self.registry.get(component) if self.registry else None
        if comp is None:
            return False, f"component {component!r} not found"
        fn = getattr(comp, "set_healthy", None)
        if fn is None:
            return False, f"component {component!r} is not health-settable"
        try:
            fn()
        except Exception as e:  # noqa: BLE001
            return False, f"set_healthy raised: {e}"
        return True, "sticky state cleared"

    def restart_runtime(self, component: str) -> Tuple[bool, str]:
        """Bounce the GPU runtime systemd unit via the process runner."""
        unit = self.runtime_unit
        r = self.run_command_fn(
            ["systemctl", "restart", unit], timeout=RESTART_TIMEOUT
        )
        if r.exit_code == 0 and not r.error:
            return True, f"restarted {unit}"
        detail = r.error or r.output.strip() or f"exit {r.exit_code}"
        return False, f"systemctl restart {unit} failed: {detail}"

    # -- hard tier ---------------------------------------------------------
    def reboot_system(self, component: str) -> Tuple[bool, str]:
        """Guarded host reboot (the engine applies the reboot-window guard
        before this runs)."""
        try:
            err = self.reboot_fn()
        except Exception as e:  # noqa: BLE001
            return False, f"reboot raised: {e}"
        if err:
            return False, err
        return True, "reboot initiated"
