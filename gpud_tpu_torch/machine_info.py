"""MachineInfo assembly; the port of ``gpud_tpu/machine_info.py``.

Reference: pkg/machine-info/machine_info.go:45-434 — builds the
apiv1.MachineInfo tree (CPU/mem/NIC/disk/accelerator) for login/gossip and
the /machine-info endpoint. ``gpu_info`` is read from the GPU adapter
(NVML on a GPU host) where the reference package reports ``tpu_info``.
The memory, disk and NIC figures come from ``procfs.py`` (``/proc``,
``statvfs``, libc's ``getifaddrs`` and ``/sys/class/net``) and equal
psutil's, which the reference package reads.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

from gpud_tpu_torch import host as pkghost
from gpud_tpu_torch import procfs
from gpud_tpu_torch.api.v1.types import (
    DiskInfo,
    GPUDeviceInfo,
    GPUInfo,
    MachineInfo,
    NICInfo,
)
from gpud_tpu_torch.blockdev import detect_containerized, read_block_tree
from gpud_tpu_torch.gpu.instance import GPUInstance
from gpud_tpu_torch.gpu.topology import normalize_generation
from gpud_tpu_torch.version import __version__

# GPU architecture by product family (NVIDIA's data sheets)
ARCHITECTURES = {"h100": "hopper", "h200": "hopper", "a100": "ampere"}


def _nic_driver(name: str, sys_class_net: str = "/sys/class/net") -> tuple:
    """(driver, virtual): driver symlink basename; virtual when the NIC
    has no backing device (veth/bridge/tun)."""
    dev = os.path.join(sys_class_net, name, "device")
    if not os.path.exists(dev):
        return "", True
    try:
        return os.path.basename(os.readlink(os.path.join(dev, "driver"))), False
    except OSError:
        return "", False


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo", "r", encoding="utf-8") as f:
            for ln in f:
                if ln.lower().startswith("model name"):
                    return ln.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def get_gpu_info(gpu: Optional[GPUInstance]) -> Optional[GPUInfo]:
    if gpu is None or not gpu.gpu_lib_exists():
        return None
    devices = sorted(gpu.devices().values(), key=lambda g: g.gpu_id)
    gpus = []
    for g in devices:
        serial, minor = gpu.board_identity(g.gpu_id)
        gpus.append(GPUDeviceInfo(
            uuid=g.uuid, serial=serial, minor_number=minor, pci_bus_id=g.pci_address,
        ))
    product = gpu.product_name()
    generation = gpu.generation() or normalize_generation(product)
    return GPUInfo(
        product=product,
        manufacturer="NVIDIA",
        architecture=ARCHITECTURES.get(generation.split("-")[0], ""),
        driver_version=gpu.driver_version(),
        cuda_version=gpu.runtime_version(),
        memory_total_bytes=devices[0].memory_total_bytes if devices else 0,
        gpus=gpus,
    )


def get_machine_info(
    gpu: Optional[GPUInstance] = None,
    machine_id: str = "",
    provider: str = "",
    region: str = "",
    public_ip: str = "",
    private_ip: str = "",
) -> MachineInfo:
    vm = procfs.virtual_memory()
    disks = []
    try:
        for p in procfs.disk_partitions(all=False):
            try:
                u = procfs.disk_usage(p.mountpoint)
            except OSError:
                continue
            disks.append(
                DiskInfo(
                    device=p.device,
                    mount_point=p.mountpoint,
                    fstype=p.fstype,
                    total_bytes=u.total,
                    used_bytes=u.used,
                )
            )
    except OSError:
        pass
    nics = []
    try:
        stats = procfs.net_if_stats()
        for name, addrs in procfs.net_if_addrs().items():
            if name == "lo":
                continue
            mac = ""
            ips = []
            for a in addrs:
                if a.family == procfs.AF_LINK:
                    mac = a.address
                elif a.family in (socket.AF_INET, socket.AF_INET6):
                    ips.append(a.address)
            st = stats.get(name)
            driver, virtual = _nic_driver(name)
            nics.append(
                NICInfo(
                    name=name,
                    mac=mac,
                    addresses=ips,
                    mtu=st.mtu if st else 0,
                    speed_mbps=st.speed if st else 0,
                    driver=driver,
                    virtual=virtual,
                )
            )
    except OSError:
        pass

    return MachineInfo(
        machine_id=machine_id or pkghost.machine_id(),
        hostname=socket.gethostname(),
        os=pkghost.os_name(),
        kernel_version=pkghost.kernel_version(),
        boot_id=pkghost.boot_id(),
        uptime_seconds=int(pkghost.uptime_seconds()),
        cpu_model=_cpu_model(),
        cpu_logical_cores=procfs.cpu_count() or 0,
        memory_total_bytes=vm.total,
        provider=provider,
        region=region,
        public_ip=public_ip,
        private_ip=private_ip,
        tpud_version=__version__,
        containerized=detect_containerized(),
        gpu_info=get_gpu_info(gpu),
        disks=disks,
        nics=nics,
        block_devices=read_block_tree(),
    )
