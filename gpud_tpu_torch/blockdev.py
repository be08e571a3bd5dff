"""Block-device tree from /sys/block (the reference's lsblk analog).

Reference: pkg/machine-info/machine_info.go:45-434 builds a per-disk
filesystem tree by exec'ing lsblk/findmnt (pkg/disk); here the same tree
is read from the kernel's own surface — /sys/block/<dev>/ for geometry
and /proc/self/mounts for filesystem placement — with no subprocesses.
Roots are parameterized so checked-in fixture trees drive tests, and
``host_root`` supports containerized deployments where the host's /sys
and /proc are mounted under a prefix (reference: nsenter-prefix
overrides, components/registry.go:46-64). The port of
``gpud_tpu/blockdev.py``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

from gpud_tpu_torch.api.v1.types import BlockDeviceInfo
from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

# loop/ram/zram and device-mapper internals are noise for fleet health
_SKIP_PREFIXES = ("loop", "ram", "zram", "fd")

ENV_HOST_ROOT = "TPUD_HOST_ROOT"


def _read(path: str) -> str:
    try:
        with open(path, "r", encoding="ascii", errors="replace") as f:
            return f.read().strip()
    except OSError:
        return ""


def _read_int(path: str) -> int:
    v = _read(path)
    try:
        return int(v)
    except ValueError:
        return 0


_OCTAL_ESCAPE = re.compile(r"\\([0-7]{3})")


def _unescape_mount(s: str) -> str:
    """Expand fstab(5) octal escapes (\\040 = space) ONLY — a blanket
    unicode_escape pass would mojibake non-ASCII mount points (UTF-8
    reinterpreted as latin-1)."""
    return _OCTAL_ESCAPE.sub(lambda m: chr(int(m.group(1), 8)), s)


class MountEntry:
    """One /proc/mounts row (octal escapes expanded)."""

    __slots__ = ("device", "mount_point", "fstype", "options")

    def __init__(self, device: str, mount_point: str, fstype: str,
                 options: List[str]) -> None:
        self.device = device
        self.mount_point = mount_point
        self.fstype = fstype
        self.options = options


def read_mount_table(
    proc_mounts: str = "", host_root: Optional[str] = None
) -> List[MountEntry]:
    """All /dev/*-backed rows of the mount table, options included.

    ``host_root`` (default: the TPUD_HOST_ROOT env; pass "" to suppress)
    redirects to the host's table in containerized deployments — the
    container's own /proc/self/mounts shows an overlay root, not the
    node's disks."""
    if host_root is None:
        host_root = os.environ.get(ENV_HOST_ROOT, "")
    path = proc_mounts or (
        os.path.join(host_root, "proc", "mounts")
        if host_root
        else "/proc/self/mounts"
    )
    out: List[MountEntry] = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 4 or not parts[0].startswith("/dev/"):
                    continue
                out.append(MountEntry(
                    device=parts[0],
                    mount_point=_unescape_mount(parts[1]),
                    fstype=parts[2],
                    options=parts[3].split(","),
                ))
    except OSError:
        pass
    return out


def read_mounts(proc_mounts: str = "") -> Dict[str, Tuple[str, str]]:
    """device path → (mount_point, fstype) from /proc/self/mounts.
    First mount of a device wins (matches lsblk's MOUNTPOINT)."""
    out: Dict[str, Tuple[str, str]] = {}
    # host_root="": callers (read_block_tree) already resolved any host
    # prefix into proc_mounts — applying the env again would double it
    for e in read_mount_table(proc_mounts, host_root=""):
        dev = os.path.basename(e.device)
        if dev not in out:
            out[dev] = (e.mount_point, e.fstype)
    return out


def _statvfs_used(mount_point: str) -> int:
    try:
        st = os.statvfs(mount_point)
        return (st.f_blocks - st.f_bfree) * st.f_frsize
    except OSError:
        return 0


def read_block_tree(
    sys_block_root: str = "",
    proc_mounts: str = "",
    host_root: str = "",
) -> List[BlockDeviceInfo]:
    """Disk → partition tree with mounts and usage attached.

    ``host_root`` (or the TPUD_HOST_ROOT env) prefixes the default /sys
    and /proc paths for containerized deployments that bind-mount the
    host's trees under e.g. /host.
    """
    host_root = host_root or os.environ.get(ENV_HOST_ROOT, "")
    root = sys_block_root or os.path.join(host_root or "/", "sys", "block")
    mounts_path = proc_mounts or (
        os.path.join(host_root, "proc", "mounts") if host_root else ""
    )
    mounts = read_mounts(mounts_path)
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    out: List[BlockDeviceInfo] = []
    for name in names:
        if name.startswith(_SKIP_PREFIXES):
            continue
        dev_dir = os.path.join(root, name)
        disk = BlockDeviceInfo(
            name=name,
            type="disk",
            size_bytes=_read_int(os.path.join(dev_dir, "size")) * 512,
            model=_read(os.path.join(dev_dir, "device", "model")),
            rotational=_read(os.path.join(dev_dir, "queue", "rotational")) == "1",
            removable=_read(os.path.join(dev_dir, "removable")) == "1",
        )
        _attach_mount(disk, mounts, host_root)
        # partitions are subdirectories whose name extends the disk's
        # (sda → sda1; nvme0n1 → nvme0n1p1) and carry a `partition` file
        try:
            entries = sorted(os.listdir(dev_dir))
        except OSError:
            entries = []
        for sub in entries:
            sub_dir = os.path.join(dev_dir, sub)
            if not sub.startswith(name):
                continue
            if not os.path.isfile(os.path.join(sub_dir, "partition")):
                continue
            part = BlockDeviceInfo(
                name=sub,
                type="part",
                size_bytes=_read_int(os.path.join(sub_dir, "size")) * 512,
                rotational=disk.rotational,
            )
            _attach_mount(part, mounts, host_root)
            disk.children.append(part)
        out.append(disk)
    return out


def _attach_mount(
    node: BlockDeviceInfo,
    mounts: Dict[str, Tuple[str, str]],
    host_root: str = "",
) -> None:
    m = mounts.get(node.name)
    if m is None:
        return
    node.mount_point, node.fstype = m
    # stat the host's filesystem, not the container's own namespace: with
    # a host_root bind-mount the host path is visible under the prefix
    stat_path = (
        os.path.join(host_root, node.mount_point.lstrip("/"))
        if host_root
        else node.mount_point
    )
    node.used_bytes = _statvfs_used(stat_path)


def detect_containerized(host_root: str = "/") -> bool:
    """Best-effort container detection: a /.dockerenv marker or a
    non-root cgroup for PID 1 (docker/containerd/kubepods slices)."""
    if os.path.exists(os.path.join(host_root, ".dockerenv")):
        return True
    cg = _read("/proc/1/cgroup")
    return any(tok in cg for tok in ("docker", "containerd", "kubepods"))


__all__ = [
    "MountEntry",
    "read_block_tree",
    "read_mount_table",
    "read_mounts",
    "detect_containerized",
    "ENV_HOST_ROOT",
]
