"""Parity of the port's machine info (gpud_tpu_torch/machine_info.py, the
GPU part from the adapter, disks and NICs from procfs.py) with gpud_tpu's
(psutil, the TPU adapter), and of the api types it fills (MachineInfo,
GPUInfo, DiskInfo, NICInfo, PackageStatus, LoginRequest, LoginResponse),
on the cases of tests/test_machine_info_depth.py and
tests/test_wire_roundtrips.py.

The whole dict equals the reference's on this host except ``gpu_info``,
which the reference reports as ``tpu_info``; the figures that move between
two reads (uptime, each file system's usage, the used bytes of each mount
in the block-device tree) are read once, through one function both
packages call. The NIC and disk readers equal psutil's. The
GPU part is read on the fake NVML of tests/torch_fakes.py and on the mock."""

import os
import socket

import numpy as np
import psutil
import pytest

import gpud_tpu.machine_info as ref_mi
from gpud_tpu.api.v1 import types as ref_types
from gpud_tpu.tpu.instance import MockBackend as RefMock

import gpud_tpu_torch.machine_info as port_mi
from gpud_tpu_torch import procfs
from gpud_tpu_torch.api.v1 import types as port_types
from gpud_tpu_torch.gpu import instance as gpu_instance
from gpud_tpu_torch.gpu import nvml as N
from gpud_tpu_torch.gpu.instance import MockBackend, NVMLBackend

from torch_fakes import FakeGPU, FakeNVML

SEED = 11


def test_the_nic_readers_equal_psutil():
    ours = {k: [(int(a.family), a.address) for a in v] for k, v in procfs.net_if_addrs().items()}
    theirs = {k: [(int(a.family), a.address) for a in v] for k, v in psutil.net_if_addrs().items()}
    assert ours == theirs and list(ours) == list(theirs)
    stats = {k: (v.mtu, v.speed) for k, v in psutil.net_if_stats().items()}
    assert {k: (v.mtu, v.speed) for k, v in procfs.net_if_stats().items()} == stats


def test_the_disk_readers_equal_psutil():
    parts = [tuple(p) for p in procfs.disk_partitions(all=False)]
    assert parts == [tuple(p)[:4] for p in psutil.disk_partitions(all=False)]
    for _dev, mount, _fs, _opts in parts:
        # a concurrent writer may move the figures between two reads: read
        # each pair again until it is one moment's
        for _ in range(5):
            a, b = procfs.disk_usage(mount), psutil.disk_usage(mount)
            if (a.total, a.used) == (b.total, b.used):
                break
        assert (a.total, a.used) == (b.total, b.used), mount


@pytest.fixture()
def still_host(monkeypatch):
    """Uptime and file-system usage read once per path, for both packages:
    the usage of the partitions and that of the block-device tree's mounts
    (``blockdev._statvfs_used``), which a test writing files on another
    worker moves between the two packages' reads."""
    import gpud_tpu.blockdev as ref_blockdev
    import gpud_tpu.host as ref_host
    from gpud_tpu_torch import blockdev as port_blockdev
    from gpud_tpu_torch import host as port_host

    up = ref_host.uptime_seconds()
    monkeypatch.setattr(ref_host, "uptime_seconds", lambda: up)
    monkeypatch.setattr(port_host, "uptime_seconds", lambda: up)
    seen = {}
    read = psutil.disk_usage

    def usage(path):
        if path not in seen:
            seen[path] = read(path)
        return seen[path]

    monkeypatch.setattr(ref_mi.psutil, "disk_usage", usage)
    monkeypatch.setattr(procfs, "disk_usage", usage)
    used = {}
    read_used = ref_blockdev._statvfs_used

    def statvfs_used(path):
        if path not in used:
            used[path] = read_used(path)
        return used[path]

    monkeypatch.setattr(ref_blockdev, "_statvfs_used", statvfs_used)
    monkeypatch.setattr(port_blockdev, "_statvfs_used", statvfs_used)


def test_machine_info_is_the_reference_s_but_the_accelerator(still_host):
    port = port_mi.get_machine_info(gpu=None, machine_id="m-1", provider="p", region="r",
                                    public_ip="1.2.3.4", private_ip="10.0.0.1").to_dict()
    ref = ref_mi.get_machine_info(tpu=None, machine_id="m-1", provider="p", region="r",
                                  public_ip="1.2.3.4", private_ip="10.0.0.1").to_dict()
    assert "gpu_info" not in port and "tpu_info" not in ref
    assert port == ref
    assert port["cpu_logical_cores"] == psutil.cpu_count(logical=True)
    assert port["memory_total_bytes"] == psutil.virtual_memory().total


def test_machine_info_with_accelerators_differs_only_in_gpu_info(still_host, monkeypatch):
    monkeypatch.delenv(gpu_instance.ENV_MOCK_ACCEL_TYPE, raising=False)
    port = port_mi.get_machine_info(gpu=MockBackend(), machine_id="m-2").to_dict()
    ref = ref_mi.get_machine_info(tpu=RefMock(), machine_id="m-2").to_dict()
    g, t = port.pop("gpu_info"), ref.pop("tpu_info")
    assert port == ref
    assert set(g) == {"product", "manufacturer", "architecture", "driver_version",
                      "cuda_version", "memory_total_bytes", "gpus"}
    assert len(g["gpus"]) == 8 and t["chips"]


def fake_gpus(seed):
    rng = np.random.default_rng(seed)
    gpus = []
    for i in range(int(rng.integers(1, 9))):
        gpus.append(FakeGPU(uuid=f"GPU-{rng.integers(1 << 40):012x}-{i}",
                            bus_id=f"00000000:{0x18 + 0x10 * i:02X}:00.0",
                            serial=str(int(rng.integers(10 ** 12, 10 ** 13))), minor=i))
    return gpus


@pytest.mark.parametrize("seed", [SEED, SEED + 1, SEED + 2])
def test_gpu_info_reads_nvml(seed):
    gpus = fake_gpus(seed)
    inst = NVMLBackend(lib=FakeNVML(gpus=gpus, driver="580.159.03", cuda=12080))
    info = port_mi.get_gpu_info(inst)
    assert info.to_dict() == {
        "product": "NVIDIA H100 80GB HBM3", "manufacturer": "NVIDIA", "architecture": "hopper",
        "driver_version": "580.159.03", "cuda_version": "12.8",
        "memory_total_bytes": 85_520_809_984,
        "gpus": [{"uuid": g.uuid, "serial": g.serial, "minor_number": g.minor,
                  "pci_bus_id": g.bus_id} for g in gpus]}
    assert port_types.GPUInfo.from_dict(info.to_dict()) == info


def test_gpu_info_leaves_out_what_nvml_refuses():
    gpu = FakeGPU(errors={"nvmlDeviceGetSerial": N.NVML_ERROR_NOT_SUPPORTED,
                          "nvmlDeviceGetMinorNumber": N.NVML_ERROR_UNKNOWN})
    info = port_mi.get_gpu_info(NVMLBackend(lib=FakeNVML(gpus=[gpu])))
    assert [(g.serial, g.minor_number) for g in info.gpus] == [("", -1)]
    absent = NVMLBackend(lib=FakeNVML(init_rc=N.NVML_ERROR_DRIVER_NOT_LOADED))
    assert port_mi.get_gpu_info(absent) is None and port_mi.get_gpu_info(None) is None


def test_gpu_info_on_the_mock(monkeypatch):
    monkeypatch.delenv(gpu_instance.ENV_MOCK_ACCEL_TYPE, raising=False)
    info = port_mi.get_gpu_info(MockBackend())
    assert (info.product, info.architecture, len(info.gpus)) == ("NVIDIA H100-SXM", "hopper", 8)
    assert [(g.serial, g.minor_number, g.pci_bus_id) for g in info.gpus][:2] == [
        ("mock-serial-0-0", 0, "00000000:10:00.0"), ("mock-serial-0-1", 1, "00000000:11:00.0")]


def test_the_nic_driver_reads_as_the_reference(tmp_path):
    net = tmp_path / "net"
    (net / "eth0" / "device").mkdir(parents=True)
    os.symlink("../../../bus/pci/drivers/gve", str(net / "eth0" / "device" / "driver"))
    (net / "docker0").mkdir(parents=True)
    (net / "ib0" / "device").mkdir(parents=True)  # a device with no driver link
    for nic in ("eth0", "docker0", "ib0", "absent"):
        assert port_mi._nic_driver(nic, str(net)) == ref_mi._nic_driver(nic, str(net))


# -- the api types -------------------------------------------------------------------

def samples(T, seed):
    rng = np.random.default_rng(seed)
    disk = T.DiskInfo(device="/dev/nvme0n1p1", mount_point="/", fstype="ext4",
                      total_bytes=int(rng.integers(1 << 40)), used_bytes=int(rng.integers(1 << 30)))
    nic = T.NICInfo(name="eth0", mac="02:fc:00:00:00:01", addresses=["192.0.2.2", "fe80::1%eth0"],
                    mtu=int(rng.integers(1000, 9000)), speed_mbps=400000, driver="mlx5_core")
    pkg = T.PackageStatus(name="dcgm", phase=T.PackagePhase.INSTALLING, status="running",
                          current_version="1", target_version="2",
                          progress=int(rng.integers(0, 100)), is_installed=False, installing=True)
    mi = T.MachineInfo(machine_id="m", hostname=socket.gethostname(), cpu_logical_cores=8,
                       memory_total_bytes=int(rng.integers(1 << 36)), tpud_version="0.1.0",
                       disks=[disk], nics=[nic],
                       block_devices=[T.BlockDeviceInfo(name="sda", size_bytes=10)])
    login = T.LoginRequest(token="t", machine_id="m", network={"public_ip": "1.2.3.4"},
                           machine_info=mi, node_labels={"user.node.tpud.dev/a": "b"},
                           provider="p", region="r")
    resp = T.LoginResponse(machine_id="m", token="t2", machine_proof="proof", status="ok")
    return [disk, nic, pkg, mi, login, resp]


@pytest.mark.parametrize("index", range(6))
def test_the_api_types_are_the_reference_s(index):
    ref, port = samples(ref_types, SEED)[index], samples(port_types, SEED)[index]
    assert port.to_dict() == ref.to_dict()
    assert type(port).from_dict(port.to_dict()) == port
    assert type(port).from_dict(ref.to_dict()).to_dict() == ref.to_dict()
    assert port_types.PackagePhase.__dict__.keys() == ref_types.PackagePhase.__dict__.keys()


def test_machine_info_carries_gpu_info_where_the_reference_carries_tpu_info():
    mi = port_types.MachineInfo(gpu_info=port_types.GPUInfo(
        product="NVIDIA H100 80GB HBM3", gpus=[port_types.GPUDeviceInfo(uuid="GPU-1", serial="7",
                                                                        minor_number=0)]))
    d = mi.to_dict()
    assert d["gpu_info"]["gpus"] == [{"uuid": "GPU-1", "serial": "7", "minor_number": 0,
                                      "pci_bus_id": ""}]
    assert port_types.MachineInfo.from_dict(d) == mi
    assert "gpu_info" not in port_types.MachineInfo().to_dict()
