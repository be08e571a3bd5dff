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
- usage: ``statvfs``, with the percent of the space open to users;
- network interfaces: their addresses from libc's ``getifaddrs`` (through
  ctypes: the call psutil's C extension makes, so secondary IPv4 and every
  IPv6 address come in its order), their MTU and link speed from
  ``/sys/class/net/<nic>/{mtu,speed}`` (the ioctls' figures).

Each reader takes its file's path, so tests can feed fixtures.
"""

from __future__ import annotations

import ctypes
import os
import socket
from typing import Dict, List, NamedTuple, Optional, Tuple

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


# -- network interfaces ----------------------------------------------------------

SYS_CLASS_NET = "/sys/class/net"
AF_LINK = getattr(socket, "AF_PACKET", 17)


class NicAddr(NamedTuple):
    family: int
    address: str


class NicStats(NamedTuple):
    mtu: int
    speed: int  # Mb/s; 0 when the link does not say


class _SockAddr(ctypes.Structure):
    _fields_ = [("family", ctypes.c_ushort)]


class _IfAddrs(ctypes.Structure):
    pass


_IfAddrs._fields_ = [
    ("next", ctypes.POINTER(_IfAddrs)),
    ("name", ctypes.c_char_p),
    ("flags", ctypes.c_uint),
    ("addr", ctypes.POINTER(_SockAddr)),
    ("netmask", ctypes.POINTER(_SockAddr)),
    ("ifu", ctypes.POINTER(_SockAddr)),
    ("data", ctypes.c_void_p),
]


def _format_addr(sa) -> Optional[str]:
    """A sockaddr's address as psutil prints it: dotted IPv4; IPv6 with the
    link-local scope's interface name after ``%`` (``getnameinfo``'s
    numeric form); a MAC as lower-case hex pairs. None for other families
    and for a link address of no bytes. Reads only the bytes of the
    family's own struct."""
    base = ctypes.addressof(sa.contents)
    family = sa.contents.family
    if family == socket.AF_INET:
        return socket.inet_ntop(socket.AF_INET, ctypes.string_at(base + 4, 4))
    if family == socket.AF_INET6:
        raw = ctypes.string_at(base + 8, 16)
        text = socket.inet_ntop(socket.AF_INET6, raw)
        scope = int.from_bytes(ctypes.string_at(base + 24, 4), "little")
        link_local = raw[0] == 0xFE and raw[1] & 0xC0 == 0x80
        mc_link_local = raw[0] == 0xFF and raw[1] & 0x0F == 0x02
        if scope and (link_local or mc_link_local):
            try:
                text += "%" + socket.if_indextoname(scope)
            except OSError:
                text += f"%{scope}"
        return text
    if family == AF_LINK:
        halen = ctypes.string_at(base + 11, 1)[0]
        if halen == 0:
            return None
        return ":".join(f"{b:02x}" for b in ctypes.string_at(base + 12, halen))
    return None


def net_if_addrs() -> Dict[str, List[NicAddr]]:
    """Each interface's addresses (psutil's ``net_if_addrs``): IPv4, then
    IPv6, then the link address, each family in ``getifaddrs`` order; the
    interfaces in the order of their first address so sorted. Raises
    OSError when ``getifaddrs`` fails."""
    libc = ctypes.CDLL(None, use_errno=True)
    head = ctypes.POINTER(_IfAddrs)()
    if libc.getifaddrs(ctypes.byref(head)) != 0:
        err = ctypes.get_errno()
        raise OSError(err, os.strerror(err))
    raw: List[Tuple[str, int, str]] = []
    try:
        node = head
        while node:
            ifa = node.contents
            if ifa.addr:
                addr = _format_addr(ifa.addr)
                if addr is not None:
                    raw.append((ifa.name.decode(errors="replace"),
                                ifa.addr.contents.family, addr))
            node = ifa.next
    finally:
        libc.freeifaddrs(head)
    raw.sort(key=lambda r: r[1])  # by family, stable: psutil's order
    out: Dict[str, List[NicAddr]] = {}
    for name, family, addr in raw:
        if family == AF_LINK:
            while addr.count(":") < 5:
                addr += ":00"
        out.setdefault(name, []).append(NicAddr(family, addr))
    return out


def _sys_int(path: str) -> Optional[int]:
    try:
        with open(path, "r", encoding="ascii") as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def net_if_stats(sys_class_net: str = SYS_CLASS_NET) -> Dict[str, NicStats]:
    """MTU and speed of each interface the kernel lists (psutil's
    ``net_if_stats``, which asks the same figures by ioctl): a speed the
    driver does not report, or reports as unknown (-1), reads 0."""
    out: Dict[str, NicStats] = {}
    try:
        names = sorted(os.listdir(sys_class_net))
    except OSError:
        return out
    for name in names:
        base = os.path.join(sys_class_net, name)
        mtu = _sys_int(os.path.join(base, "mtu"))
        if mtu is None:
            continue
        speed = _sys_int(os.path.join(base, "speed"))
        out[name] = NicStats(mtu=mtu, speed=speed if speed and speed > 0 else 0)
    return out
