"""Remaining host components (reference: SURVEY §2.3); the port of
``gpud_tpu/components/host_extra.py``.

- fuse            — /sys/fs/fuse/connections congestion (reference:
                    components/fuse, pkg/fuse/fuse.go:18)
- kernel-module   — /proc/modules asserts configured modules loaded
                    (reference: components/kernel-module)
- library         — expected shared libraries present (reference:
                    components/library; libnvidia-ml, GPUd's own default,
                    where the reference package looks for libtpu)
- network-latency — RTT to configured edge targets (reference:
                    components/network/latency; DERP map replaced by
                    configurable TCP-connect targets)
- docker          — docker daemon reachable + container listing
                    (reference: components/docker)
- containerd      — socket presence with consecutive-miss threshold
                    (reference: components/containerd,
                    components/registry.go:99-103)
- kubelet         — read-only port 10255 /pods (reference:
                    components/kubelet; healthy-if-absent)
- pci             — ACS check on baremetal via lspci (reference:
                    components/pci/component.go:156-161 skips VMs)
- nfs             — group NFS checker (reference: components/nfs)
"""

from __future__ import annotations

import glob
import json
import os
import socket
from typing import List, Optional

from gpud_tpu_torch.api.v1.types import HealthStateType
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.metrics.registry import gauge
from gpud_tpu_torch.nfs_checker import GroupConfig, NFSChecker
from gpud_tpu_torch.process import run_command


# ---------------------------------------------------------------------------
class FuseComponent(PollingComponent):
    NAME = "fuse"
    TAGS = ["host", "fuse"]

    CONGESTED_PCT_DEGRADED = 90.0

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.connections_dir = "/sys/fs/fuse/connections"

    def is_supported(self) -> bool:
        return os.path.isdir(self.connections_dir)

    def check_once(self) -> CheckResult:
        congested = []
        n = 0
        for conn in glob.glob(os.path.join(self.connections_dir, "*")):
            n += 1
            try:
                with open(os.path.join(conn, "waiting"), "r") as f:
                    waiting = int(f.read().strip())
                with open(os.path.join(conn, "max_background"), "r") as f:
                    max_bg = int(f.read().strip())
                if max_bg and 100.0 * waiting / max_bg >= self.CONGESTED_PCT_DEGRADED:
                    congested.append(os.path.basename(conn))
            except (OSError, ValueError):
                continue
        if congested:
            return CheckResult(
                self.NAME,
                health=HealthStateType.DEGRADED,
                reason=f"fuse connection(s) congested: {congested}",
            )
        return CheckResult(self.NAME, reason=f"{n} fuse connections ok")


# ---------------------------------------------------------------------------
class KernelModuleComponent(PollingComponent):
    NAME = "kernel-module"
    TAGS = ["host", "kernel"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.modules_to_check: List[str] = list(instance.kernel_modules_to_check)

    def _loaded_modules(self) -> set:
        out = set()
        try:
            with open("/proc/modules", "r", encoding="ascii") as f:
                for ln in f:
                    out.add(ln.split()[0])
        except OSError:
            pass
        return out

    def check_once(self) -> CheckResult:
        if not self.modules_to_check:
            return CheckResult(self.NAME, reason="no modules configured to check")
        loaded = self._loaded_modules()
        missing = [m for m in self.modules_to_check if m not in loaded]
        if missing:
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"kernel module(s) not loaded: {missing}",
            )
        return CheckResult(
            self.NAME, reason=f"all {len(self.modules_to_check)} modules loaded"
        )


# ---------------------------------------------------------------------------
class LibraryComponent(PollingComponent):
    NAME = "library"
    TAGS = ["host", "library"]

    DEFAULT_SEARCH_DIRS = ["/usr/lib", "/usr/lib64", "/usr/local/lib", "/lib"]
    # GPUd's default (reference: components/library/component.go:30-35)
    DEFAULT_LIBRARIES = ["libnvidia-ml.so"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.search_dirs = list(self.DEFAULT_SEARCH_DIRS)
        self.libraries = list(self.DEFAULT_LIBRARIES)
        self.gpu = instance.gpu_instance

    def is_supported(self) -> bool:
        # only meaningful on real GPU machines (reference: per GPU machine);
        # the mock backend has no on-disk libnvidia-ml to find
        return (
            self.gpu is not None
            and self.gpu.gpu_lib_exists()
            and not self.gpu.is_mock()
        )

    def _find(self, name: str) -> Optional[str]:
        # iglob short-circuits on the first hit — a full recursive glob of
        # /usr/lib trees would materialize 100k+ entries per poll
        for d in self.search_dirs:
            for hit in glob.iglob(os.path.join(d, "**", name + "*"), recursive=True):
                return hit
        return None

    def check_once(self) -> CheckResult:
        missing = [lib for lib in self.libraries if self._find(lib) is None]
        if missing:
            return CheckResult(
                self.NAME,
                health=HealthStateType.DEGRADED,
                reason=f"expected librar{'y' if len(missing) == 1 else 'ies'} not found: {missing}",
            )
        return CheckResult(self.NAME, reason=f"all {len(self.libraries)} libraries present")


# ---------------------------------------------------------------------------
# base units on the wire (metrics_lint enforces this): seconds, not ms
_g_latency = gauge("tpud_network_latency_seconds", "RTT to edge targets")


class NetworkLatencyComponent(PollingComponent):
    NAME = "network-latency"
    TAGS = ["host", "network"]

    DEGRADED_MS = 250.0

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        from gpud_tpu_torch import netutil

        self.edges = list(netutil.DEFAULT_EDGES)
        self.measure_fn = lambda: netutil.measure_edges(self.edges)

    def check_once(self) -> CheckResult:
        rtts = {}
        for name, rtt in self.measure_fn().items():
            if rtt is not None:
                rtts[name] = rtt
                _g_latency.set(rtt / 1000.0, {"component": self.NAME, "target": name})
        if not rtts:
            return CheckResult(
                self.NAME,
                health=HealthStateType.DEGRADED,
                reason="no edge target reachable (egress blocked or offline)",
            )
        worst = max(rtts.values())
        extra = {k: f"{v:.1f}" for k, v in rtts.items()}
        if worst >= self.DEGRADED_MS:
            return CheckResult(
                self.NAME,
                health=HealthStateType.DEGRADED,
                reason=f"high network latency: {worst:.0f}ms",
                extra_info=extra,
            )
        return CheckResult(
            self.NAME, reason=f"worst RTT {worst:.1f}ms across {len(rtts)} targets",
            extra_info=extra,
        )


# ---------------------------------------------------------------------------
class DockerComponent(PollingComponent):
    NAME = "docker"
    TAGS = ["host", "container"]

    SOCKET = "/var/run/docker.sock"

    def is_supported(self) -> bool:
        return os.path.exists(self.SOCKET) or run_command(
            ["which", "docker"], timeout=5
        ).exit_code == 0

    def check_once(self) -> CheckResult:
        r = run_command(["docker", "ps", "--format", "{{.Names}}"], timeout=20)
        if r.exit_code != 0:
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"docker daemon not responding: {(r.error or r.output)[:200]}",
            )
        names = [ln for ln in r.output.strip().splitlines() if ln]
        return CheckResult(self.NAME, reason=f"{len(names)} containers running")


# ---------------------------------------------------------------------------
class ContainerdComponent(PollingComponent):
    NAME = "containerd"
    TAGS = ["host", "container"]

    SOCKET = "/run/containerd/containerd.sock"
    # consecutive-miss threshold before unhealthy
    # (reference: components/registry.go:99-103)
    SOCKET_MISS_THRESHOLD = 3

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self._consecutive_misses = 0
        self._cri_misses = 0
        self._cri_client = None  # persistent: keeps channel + learned API version
        self.socket_path = self.SOCKET
        self.cri_target = ""  # tests point this at a fake CRI server

    def is_supported(self) -> bool:
        return os.path.exists(self.socket_path) or run_command(
            ["which", "containerd"], timeout=5
        ).exit_code == 0

    def check_once(self) -> CheckResult:
        if os.path.exists(self.socket_path):
            self._consecutive_misses = 0
            return self._check_cri()
        # socket gone: CRI strikes are no longer consecutive — a restarted
        # containerd gets a fresh damping window
        self._cri_misses = 0
        self._drop_cri_client()
        self._consecutive_misses += 1
        if self._consecutive_misses < self.SOCKET_MISS_THRESHOLD:
            return CheckResult(
                self.NAME,
                reason=(
                    f"containerd socket missing "
                    f"({self._consecutive_misses}/{self.SOCKET_MISS_THRESHOLD} strikes)"
                ),
            )
        return CheckResult(
            self.NAME,
            health=HealthStateType.UNHEALTHY,
            reason=f"containerd socket missing {self._consecutive_misses} consecutive checks",
        )

    def _drop_cri_client(self) -> None:
        if self._cri_client is not None:
            try:
                self._cri_client.close()
            except Exception:  # noqa: BLE001
                pass
            self._cri_client = None

    def close(self) -> None:
        self._drop_cri_client()
        super().close()

    def _check_cri(self) -> CheckResult:
        """Socket exists: list pods/containers over CRI gRPC (reference:
        components/containerd CRI ListContainers via k8s.io/cri-api).
        An unresponsive runtime behind a live socket is Degraded — the
        socket file alone proves nothing about the daemon — but only after
        consecutive failures (same damping as the socket-missing path: a
        single slow ListContainers during image GC must not page)."""
        from gpud_tpu_torch import cri

        if not cri.grpc_available():
            # grpcio is an optional extra; without it this check keeps the
            # pre-CRI socket-presence semantics rather than false-alarming
            return CheckResult(
                self.NAME,
                reason="containerd socket present (CRI client unavailable: no grpcio)",
            )
        if self._cri_client is None:
            self._cri_client = cri.CRIClient(
                self.socket_path, target=self.cri_target
            )
        try:
            result = self._cri_client.snapshot()
        except cri.CRIUnservedError:
            # CRI plugin disabled (containerd as Docker's backend etc.) —
            # a configuration, not a failure; keep socket-presence health
            self._cri_misses = 0
            return CheckResult(
                self.NAME,
                reason="containerd socket present (CRI not served)",
            )
        except Exception:  # noqa: BLE001 — any transport failure is a miss
            result = None
            self._drop_cri_client()  # channel may be poisoned
        if result is None:
            self._cri_misses += 1
            if self._cri_misses < self.SOCKET_MISS_THRESHOLD:
                return CheckResult(
                    self.NAME,
                    reason=(
                        f"containerd socket present but CRI unresponsive "
                        f"({self._cri_misses}/{self.SOCKET_MISS_THRESHOLD} strikes)"
                    ),
                )
            return CheckResult(
                self.NAME,
                health=HealthStateType.DEGRADED,
                reason=(
                    f"containerd socket present but CRI unresponsive "
                    f"{self._cri_misses} consecutive checks"
                ),
            )
        self._cri_misses = 0
        containers = result["containers"]
        running = sum(1 for c in containers if c["state"] == "running")
        ver = result["version"].get("runtime_version", "")
        return CheckResult(
            self.NAME,
            reason=(
                f"containerd {ver or 'up'}: {running}/{len(containers)} "
                f"containers running, {len(result['sandboxes'])} pods"
            ),
            extra_info={
                "containers_total": str(len(containers)),
                "containers_running": str(running),
                "pods": str(len(result["sandboxes"])),
                "runtime_version": ver,
            },
        )


# ---------------------------------------------------------------------------
class KubeletComponent(PollingComponent):
    NAME = "kubelet"
    TAGS = ["host", "kubernetes"]

    READONLY_PORT = 10255  # reference: components/kubelet/component.go:37-57

    def is_supported(self) -> bool:
        # healthy-if-absent semantics: only check when the port is open
        try:
            with socket.create_connection(("127.0.0.1", self.READONLY_PORT), timeout=1):
                return True
        except OSError:
            return False

    def check_once(self) -> CheckResult:
        try:
            import urllib.request

            with urllib.request.urlopen(
                f"http://127.0.0.1:{self.READONLY_PORT}/pods", timeout=5
            ) as resp:
                pods = json.loads(resp.read()).get("items", [])
            node = ""
            if pods:
                node = pods[0].get("spec", {}).get("nodeName", "")
            return CheckResult(
                self.NAME,
                reason=f"kubelet ok, {len(pods)} pods",
                extra_info={"node_name": node, "pods": str(len(pods))},
            )
        except Exception as e:  # noqa: BLE001
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason=f"kubelet read-only API failed: {e}",
            )


# ---------------------------------------------------------------------------
class PCIComponent(PollingComponent):
    NAME = "pci"
    TAGS = ["host", "pci"]

    def check_once(self) -> CheckResult:
        from gpud_tpu_torch import host as pkghost

        virt = pkghost.virtualization()
        if virt not in ("none", "", "unknown"):
            # ACS only matters on baremetal (reference:
            # components/pci/component.go:156-161 skips KVM)
            return CheckResult(
                self.NAME, reason=f"virtualized ({virt}); ACS check skipped"
            )
        r = run_command(["lspci", "-vvv"], timeout=30)
        if r.exit_code != 0:
            return CheckResult(self.NAME, reason="lspci unavailable; skipped")
        acs_enabled = "ACSCtl:" in r.output and "SrcValid+" in r.output
        if acs_enabled:
            return CheckResult(
                self.NAME,
                health=HealthStateType.DEGRADED,
                reason="PCI ACS enabled on baremetal — disable for P2P performance",
            )
        return CheckResult(self.NAME, reason="ACS disabled or not applicable")


# ---------------------------------------------------------------------------
class NFSComponent(PollingComponent):
    NAME = "nfs"
    TAGS = ["host", "nfs"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.group_configs: List[GroupConfig] = []
        cfg = instance.config
        for d in getattr(cfg, "nfs_group_dirs", []) if cfg else []:
            self.group_configs.append(GroupConfig(dir=d))
        self.machine_id = instance.machine_id or "unknown"

    def is_supported(self) -> bool:
        return bool(self.group_configs)

    def check_once(self) -> CheckResult:
        checker = NFSChecker(self.machine_id, self.group_configs)
        reports = checker.check_all()
        problems = []
        extra = {}
        for d, rep in reports.items():
            extra[f"{d}:members_fresh"] = str(rep.fresh_members)
            if not rep.write_ok:
                problems.append(f"{d}: write failed ({rep.write_error})")
            cfg = next(c for c in self.group_configs if c.dir == d)
            if cfg.expected_members and rep.fresh_members < cfg.expected_members:
                problems.append(
                    f"{d}: {rep.fresh_members}/{cfg.expected_members} members fresh"
                )
        if problems:
            return CheckResult(
                self.NAME,
                health=HealthStateType.UNHEALTHY,
                reason="; ".join(problems),
                extra_info=extra,
            )
        return CheckResult(
            self.NAME,
            reason=f"{len(reports)} NFS group(s) healthy",
            extra_info=extra,
        )
