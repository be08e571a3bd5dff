"""GPU runtime services and device holders.

The port of ``gpud_tpu/components/tpu/runtime.py``. Reference:
components/accelerator/nvidia/fabric-manager — nvidia-fabricmanager.service
activeness (an NVSwitch system's GPUs cannot join the fabric without it) —
and the persistence daemon, nvidia-persistenced.service, which keeps the
driver loaded between jobs; both health-checked by systemd activeness. A
unit that is absent is fine: a PCIe part runs no fabric manager, and a
container image runs neither.

Also covers components/accelerator/nvidia/processes: which processes hold
the GPU device nodes (a crashed job can leave a process wedged in the
driver, holding /dev/nvidiaN and blocking the next job). Holders come from
the /proc fd tables, as in the reference package.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List

from gpud_tpu_torch.api.v1.types import (
    HealthStateType,
    RepairActionType,
    SuggestedActions,
)
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.metrics.registry import gauge
from gpud_tpu_torch.process import run_command

RUNTIME_NAME = "accelerator-gpu-runtime"
PROCESSES_NAME = "accelerator-gpu-processes"

_g_holders = gauge("tpud_gpu_device_holder_processes", "processes holding GPU devices")

# services probed when present; absence is fine (PCIe parts, containers)
RUNTIME_UNITS = ("nvidia-fabricmanager.service", "nvidia-persistenced.service")

# one GPU's device node (/dev/nvidia0, ...) or a vfio group; /dev/nvidiactl,
# /dev/nvidia-uvm and /dev/nvidia-modeset belong to no one GPU
_HOLDER = re.compile(r"^/dev/(nvidia\d|vfio)")


class GPURuntimeComponent(PollingComponent):
    NAME = RUNTIME_NAME
    TAGS = ["accelerator", "gpu", "fabric"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.gpu = instance.gpu_instance
        self.units = list(RUNTIME_UNITS)
        self.is_active_fn = self._systemd_is_active
        # chaos hook: while time_now_fn() < chaos_fail_until the component
        # reports its unit failed, even on mock backends (runtime-crash-
        # mid-remediation campaigns race this against the engine's scan)
        self.chaos_fail_until = 0.0

    def is_supported(self) -> bool:
        return self.gpu is not None and self.gpu.gpu_lib_exists()

    @staticmethod
    def _systemd_is_active(unit: str) -> str:
        """'active' | 'inactive' | 'failed' | 'absent' (or whatever else
        systemctl printed, as the reference package takes it)."""
        r = run_command(["systemctl", "is-active", unit], timeout=10)
        out = r.output.strip()
        if r.exit_code == 0:
            return "active"
        if "could not be found" in out or "not-found" in out or r.error:
            return "absent"
        # systemctl in a container whose init is not systemd: no unit there
        if "has not been booted with systemd" in out:
            return "absent"
        return out or "inactive"

    def check_once(self) -> CheckResult:
        if self.time_now_fn() < self.chaos_fail_until:
            failed = list(self.units[:1])
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"GPU runtime unit(s) failed: {failed} (chaos)",
                suggested_actions=SuggestedActions(
                    description="GPU runtime service failed — restart/reboot",
                    repair_actions=[RepairActionType.REBOOT_SYSTEM],
                ),
                extra_info={u: "failed" for u in failed},
            )
        if self.gpu is not None and self.gpu.is_mock():
            return CheckResult(self.NAME, reason="mock backend; runtime assumed healthy")
        statuses: Dict[str, str] = {u: self.is_active_fn(u) for u in self.units}
        failed = [u for u, s in statuses.items() if s == "failed"]
        present = {u: s for u, s in statuses.items() if s != "absent"}
        if failed:
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"GPU runtime unit(s) failed: {failed}",
                suggested_actions=SuggestedActions(
                    description="GPU runtime service failed — restart/reboot",
                    repair_actions=[RepairActionType.REBOOT_SYSTEM],
                ),
                extra_info=statuses,
            )
        if not present:
            return CheckResult(
                self.NAME,
                reason="no GPU runtime services on this image (direct driver mode)",
                extra_info=statuses,
            )
        return CheckResult(
            self.NAME,
            reason=f"runtime units healthy: {sorted(present)}",
            extra_info=statuses,
        )


class GPUProcessesComponent(PollingComponent):
    NAME = PROCESSES_NAME
    TAGS = ["accelerator", "gpu"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.gpu = instance.gpu_instance
        self.proc_root = "/proc"
        self._stuck_last_check: set = set()

    def is_supported(self) -> bool:
        return self.gpu is not None and self.gpu.gpu_lib_exists()

    def _device_holders(self) -> Dict[int, List[str]]:
        """pid → GPU device paths held, from /proc/*/fd symlinks."""
        holders: Dict[int, List[str]] = {}
        for fd_dir in glob.iglob(os.path.join(self.proc_root, "[0-9]*", "fd")):
            pid_s = fd_dir.split(os.sep)[-2]
            try:
                pid = int(pid_s)
                for fd in os.listdir(fd_dir):
                    try:
                        target = os.readlink(os.path.join(fd_dir, fd))
                    except OSError:
                        continue
                    if _HOLDER.match(target):
                        holders.setdefault(pid, []).append(target)
            except (OSError, ValueError):
                continue
        return holders

    def _proc_state(self, pid: int) -> str:
        try:
            path = os.path.join(self.proc_root, str(pid), "stat")
            # comm may contain ') ' AND non-ASCII (prctl PR_SET_NAME is
            # arbitrary bytes) — read raw and split at the LAST ')' per
            # the stat contract: state is the first field after it
            with open(path, "rb") as f:
                return f.read().rsplit(b")", 1)[1].split()[0].decode("ascii")
        except (OSError, IndexError, UnicodeDecodeError):
            return "?"

    def check_once(self) -> CheckResult:
        if self.gpu is not None and self.gpu.is_mock():
            return CheckResult(self.NAME, reason="mock backend; no device holders")
        holders = self._device_holders()
        _g_holders.set(len(holders), {"component": self.NAME})
        # a defunct process has no open fds (the kernel closes them in
        # do_exit before the Z state), so the stuck-device signal is a
        # holder in uninterruptible sleep ('D') — typically wedged in a
        # driver ioctl; escalate if it stays stuck across checks
        stuck = sorted(p for p in holders if self._proc_state(p) == "D")
        persistent = [p for p in stuck if p in self._stuck_last_check]
        self._stuck_last_check = set(stuck)
        extra = {
            str(pid): ",".join(sorted(set(devs))) for pid, devs in holders.items()
        }
        if persistent:
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=(
                    f"process(es) stuck in uninterruptible sleep holding GPU "
                    f"devices across checks: {persistent}"
                ),
                suggested_actions=SuggestedActions(
                    description="process wedged in GPU driver — check app; reboot frees the device",
                    repair_actions=[RepairActionType.CHECK_USER_APP_AND_GPU,
                                    RepairActionType.REBOOT_SYSTEM],
                ),
                extra_info=extra,
            )
        if stuck:
            return CheckResult(
                self.NAME,
                health=HealthStateType.DEGRADED,
                reason=f"process(es) in uninterruptible sleep holding GPU devices: {stuck}",
                extra_info=extra,
            )
        return CheckResult(
            self.NAME,
            reason=f"{len(holders)} process(es) holding GPU devices",
            extra_info=extra,
        )
