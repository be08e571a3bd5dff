"""The host's CPU, memory and file-system figures, read from ``/proc`` and
``statvfs`` without psutil.

The reference package reads them through psutil (``components/cpu.py``,
``memory.py``, ``disk.py`` and ``scan.py``); GPUd reads the same kernel
files through gopsutil. The port reads them itself, so that its host checks
load on a host without psutil, and computes each figure as psutil 7 does on
Linux:

- CPU usage: the busy share of the ``/proc/stat`` ticks since the last
  reading (busy = total - idle - iowait, guest time counted once);
- the logical CPU count: ``sysconf(SC_NPROCESSORS_ONLN)``;
- memory: ``/proc/meminfo``, used = total - available (``free``'s columns);
- partitions: the mount table's rows with a device and a file-system type
  that ``/proc/filesystems`` lists without ``nodev``;
- usage: ``statvfs``, with the percent of the space open to users.

Each reader takes its file's path, so tests can feed fixtures.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Tuple

from gpud_tpu_torch.blockdev import _unescape_mount

PROC_STAT = "/proc/stat"
PROC_MEMINFO = "/proc/meminfo"
PROC_FILESYSTEMS = "/proc/filesystems"


def _percent(part: float, whole: float) -> float:
    try:
        return round(part / whole * 100.0, 1)
    except ZeroDivisionError:
        return 0.0


# -- CPU ----------------------------------------------------------------------

def cpu_times(path: str = PROC_STAT) -> Tuple[int, ...]:
    """The ``cpu`` line of ``/proc/stat``: user, nice, system, idle, iowait,
    irq, softirq, steal, guest, guest_nice, in clock ticks (absent fields
    are 0)."""
    with open(path, "r", encoding="ascii") as f:
        fields = f.readline().split()
    if not fields or fields[0] != "cpu":
        raise ValueError(f"{path}: no cpu line")
    ticks = [int(v) for v in fields[1:11]]
    return tuple(ticks + [0] * (10 - len(ticks)))


def _total_and_busy(t: Tuple[int, ...]) -> Tuple[int, int]:
    total = sum(t) - t[8] - t[9]  # guest time is already in user and nice
    return total, total - t[3] - t[4]


class CPUUsage:
    """psutil's ``cpu_percent(interval=0)``: each call returns the busy
    percent since the previous call (the first compares with construction)."""

    def __init__(self, path: str = PROC_STAT) -> None:
        self.path = path
        self._last = cpu_times(path)

    def percent(self) -> float:
        now = cpu_times(self.path)
        deltas = tuple(max(0, b - a) for a, b in zip(self._last, now))
        self._last = now
        total, busy = _total_and_busy(deltas)
        return _percent(busy, total) if total > 0 else 0.0


def cpu_count() -> int:
    """Logical CPUs online (psutil's ``cpu_count(logical=True)``)."""
    try:
        return int(os.sysconf("SC_NPROCESSORS_ONLN"))
    except (ValueError, OSError):
        return os.cpu_count() or 1


# -- memory --------------------------------------------------------------------

class VirtualMemory(NamedTuple):
    total: int
    available: int
    percent: float
    used: int
    free: int


def virtual_memory(path: str = PROC_MEMINFO) -> VirtualMemory:
    mems = {}
    with open(path, "r", encoding="ascii") as f:
        for line in f:
            fields = line.split()
            if len(fields) >= 2:
                mems[fields[0]] = int(fields[1]) * 1024
    total, free = mems["MemTotal:"], mems["MemFree:"]
    avail = mems.get("MemAvailable:", 0)
    if avail == 0:
        # no MemAvailable (kernels before 3.14): free + cached, psutil's
        # estimate when it cannot read /proc/zoneinfo's watermarks
        avail = free + mems.get("Cached:", 0)
    if avail < 0:
        avail = 0
    elif avail > total:
        avail = free
    return VirtualMemory(total=total, available=avail, percent=_percent(total - avail, total),
                         used=total - avail, free=free)


# -- file systems ----------------------------------------------------------------

class Partition(NamedTuple):
    device: str
    mountpoint: str
    fstype: str
    opts: str


class DiskUsage(NamedTuple):
    total: int
    used: int
    free: int
    percent: float


def _disk_fstypes(path: str) -> set:
    out = set()
    with open(path, "r", encoding="ascii") as f:
        for line in f:
            line = line.strip()
            if not line.startswith("nodev"):
                out.add(line)
            elif line.split("\t")[-1] == "zfs":
                out.add("zfs")
    return out


def _mounts_path() -> str:
    if os.path.isfile("/etc/mtab"):
        return os.path.realpath("/etc/mtab")
    return os.path.realpath("/proc/self/mounts")


def disk_partitions(all: bool = False, mounts_path: Optional[str] = None,  # noqa: A002
                    filesystems_path: str = PROC_FILESYSTEMS) -> List[Partition]:
    """Mounted file systems (psutil's ``disk_partitions``): with
    ``all=False`` only rows with a device and an on-disk file-system type."""
    fstypes = _disk_fstypes(filesystems_path) if not all else set()
    out: List[Partition] = []
    with open(mounts_path or _mounts_path(), "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            device = "" if parts[0] == "none" else _unescape_mount(parts[0])
            if not all and (not device or parts[2] not in fstypes):
                continue
            out.append(Partition(device, _unescape_mount(parts[1]), parts[2], parts[3]))
    return out


def disk_usage(path: str) -> DiskUsage:
    """``statvfs`` of ``path``: total and used as the file system counts
    them, free and percent as a user sees them (psutil's ``disk_usage``)."""
    st = os.statvfs(path)
    total = st.f_blocks * st.f_frsize
    used = total - st.f_bfree * st.f_frsize
    avail = st.f_bavail * st.f_frsize
    return DiskUsage(total=total, used=used, free=avail, percent=_percent(used, used + avail))
