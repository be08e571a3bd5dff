"""The port's 13 host checks (gpud_tpu_torch/components/cpu.py, memory.py,
disk.py, os_comp.py, host_extra.py) against the reference's.

Each case of tests/test_components_host.py, test_host_extra_scenarios.py and
test_disk_failures.py runs on both packages with the same injected readers
and fixtures, and every check must give the same health, reason (after the
noun table of tests/torch_parity.py), repair actions, extra info, events and
gauges. The four kmsg matchers must return the same tuples on the same lines.
No case sleeps, starts a daemon, spawns a process or opens a public socket.
"""

import json
import os
import time
import urllib.request
from types import SimpleNamespace

import pytest

import gpud_tpu.components.cpu as r_cpu
import gpud_tpu.cri as r_cri
import gpud_tpu.components.disk as r_disk
import gpud_tpu.components.host_extra as r_extra
import gpud_tpu.components.memory as r_memory
import gpud_tpu.components.os_comp as r_os
import gpud_tpu.host as r_host
from gpud_tpu.components.base import TpudInstance as RefTpud
from gpud_tpu.eventstore import EventStore as RefEventStore
from gpud_tpu.kmsg.syncer import Syncer as RefSyncer
from gpud_tpu.kmsg.watcher import Message as RefMessage
from gpud_tpu.metrics.registry import DEFAULT_REGISTRY as REF_REGISTRY
from gpud_tpu.process import RunResult as RefRunResult
from gpud_tpu.sqlite import DB as RefDB
from gpud_tpu.tpu.instance import MockBackend as RefMock

import gpud_tpu_torch.components.cpu as p_cpu
import gpud_tpu_torch.cri as p_cri
import gpud_tpu_torch.components.disk as p_disk
import gpud_tpu_torch.components.host_extra as p_extra
import gpud_tpu_torch.components.memory as p_memory
import gpud_tpu_torch.components.os_comp as p_os
import gpud_tpu_torch.host as p_host
from gpud_tpu_torch.components.base import TpudInstance
from gpud_tpu_torch.eventstore import EventStore
from gpud_tpu_torch.gpu.instance import MockBackend
from gpud_tpu_torch.kmsg.syncer import Syncer
from gpud_tpu_torch.kmsg.watcher import Message
from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY as PORT_REGISTRY
from gpud_tpu_torch.process import RunResult
from gpud_tpu_torch.sqlite import DB

from torch_parity import HOST_GAUGES, assert_events_parity, assert_result_parity, nouns

REF = SimpleNamespace(
    name="ref", cpu=r_cpu, cri=r_cri, memory=r_memory, disk=r_disk, os=r_os, extra=r_extra, host=r_host,
    inst=lambda accel=None, **kw: RefTpud(tpu_instance=accel, **kw), mock=RefMock,
    EventStore=RefEventStore, DB=RefDB, Syncer=RefSyncer, Message=RefMessage,
    RunResult=RefRunResult, library="libtpu.so", registry=REF_REGISTRY)
PORT = SimpleNamespace(
    name="port", cpu=p_cpu, cri=p_cri, memory=p_memory, disk=p_disk, os=p_os, extra=p_extra, host=p_host,
    inst=lambda accel=None, **kw: TpudInstance(gpu_instance=accel, **kw), mock=MockBackend,
    EventStore=EventStore, DB=DB, Syncer=Syncer, Message=Message,
    RunResult=RunResult, library="libnvidia-ml.so", registry=PORT_REGISTRY)

H, D, U = "Healthy", "Degraded", "Unhealthy"
NOW = float(int(time.time()))  # an operator's set-healthy is stamped now


def both(scenario, *args):
    """``scenario(pkg, *args)`` on each package: (reference's, port's)."""
    return scenario(REF, *args), scenario(PORT, *args)


def assert_same(ref_results, port_results):
    assert len(ref_results) == len(port_results)
    for r, p in zip(ref_results, port_results):
        assert_result_parity(r, p)
    return port_results


def series(pkg, component, **only):
    """{(name, labels): value} of one component's gauges, restricted to the
    label values in ``only`` (label -> allowed values)."""
    out = {}
    for _ts, name, labels, value in pkg.registry.gather(0):
        if labels.get("component") != component or name not in HOST_GAUGES:
            continue
        if any(k in labels and labels[k] not in v for k, v in only.items()):
            continue
        out[(name, tuple(sorted(labels.items())))] = value
    return out


def assert_gauges_same(component, **only):
    ref, port = series(REF, component, **only), series(PORT, component, **only)
    assert port == ref and port
    return port


# -- cpu ------------------------------------------------------------------------

CPU_CASES = {"healthy": (12.5, (0.5, 0.4, 0.3), 8),
             "degraded on load": (99.0, (50.0, 40.0, 30.0), 4),
             "at the load edge": (40.0, (16.0, 16.0, 16.0), 4),
             "just past it": (40.0, (16.0, 16.01, 16.0), 4)}


@pytest.mark.parametrize("case", sorted(CPU_CASES))
def test_cpu_check(case):
    usage, load, cores = CPU_CASES[case]

    def run(pkg):
        c = pkg.cpu.CPUComponent(pkg.inst())
        c.get_usage_fn = lambda: usage
        c.get_load_fn = lambda: load
        c.get_core_count_fn = lambda: cores
        return [c.check()]

    (got,) = assert_same(*both(run))
    assert got.health == (D if load[1] > cores * 4 else H)
    assert_gauges_same("cpu")


LOCKUP_LINES = [
    "watchdog: BUG: soft lockup - CPU#2 stuck for 23s! [python:1234]",
    "NMI watchdog: Watchdog detected hard LOCKUP on cpu 7",
    "INFO: task jbd2/sda1-8:312 blocked for more than 120 seconds.",
    "khungtaskd: hung_task detected",
    "normal boot line",
    "  soft lockup with padding  ",
]


@pytest.mark.parametrize("line", LOCKUP_LINES)
def test_cpu_lockup_matcher(line):
    assert p_cpu.match_cpu_lockup(line) == r_cpu.match_cpu_lockup(line)


def test_cpu_default_readers_are_the_proc_readers():
    c = p_cpu.CPUComponent(TpudInstance())
    assert 0.0 <= c.get_usage_fn() <= 100.0
    assert c.get_core_count_fn() == r_cpu.psutil.cpu_count(logical=True)
    assert len(c.get_load_fn()) == 3


# -- memory -----------------------------------------------------------------------

@pytest.mark.parametrize("percent", [50.0, 94.9, 95.0, 97.0])
def test_memory_check(percent):
    vm = SimpleNamespace(total=16 << 30, used=8 << 30, available=8 << 30, percent=percent)

    def run(pkg):
        c = pkg.memory.MemoryComponent(pkg.inst())
        c.get_vm_fn = lambda: vm
        return [c.check()]

    (got,) = assert_same(*both(run))
    assert got.health == (D if percent >= 95.0 else H)
    assert_gauges_same("memory")


OOM_LINES = [
    "Out of memory: Killed process 1234 (python) total-vm:1kB",
    "python invoked oom-killer: gfp_mask=0x100cca(GFP_HIGHUSER_MOVABLE), order=0",
    "Memory cgroup out of memory: Killed process 99 (java)",
    "oom_reaper: reaped process 1234 (python), now anon-rss:0kB",
    "plenty of memory",
]


@pytest.mark.parametrize("line", OOM_LINES)
def test_oom_matcher(line):
    assert p_memory.match_oom(line) == r_memory.match_oom(line)


def test_memory_set_healthy_records_the_marker(tmp_path):
    def run(pkg):
        db = pkg.DB(str(tmp_path / f"{pkg.name}.db"))
        c = pkg.memory.MemoryComponent(pkg.inst(db_rw=db, event_store=pkg.EventStore(db)))
        c.set_healthy()
        evs = c.events(0)
        db.close()
        return evs

    ref, port = both(run)
    assert_events_parity(ref, port)
    assert [e.name for e in port] == ["SetHealthy"]


# -- disk --------------------------------------------------------------------------

Part = SimpleNamespace


def fixed_disk(c, mounts=(("/dev/vda1", "/", "ext4"),), percent=40.0):
    parts = [Part(device=d, mountpoint=m, fstype=f) for d, m, f in mounts]
    c.get_partitions_fn = lambda all=False: parts
    c.get_usage_fn = lambda mp: Part(total=100 << 30, used=int(percent) << 30, percent=percent)


def disk_pair(pkg, tmp_path, mount_points=(), **kw):
    db = pkg.DB(str(tmp_path / f"{pkg.name}.db"))
    c = pkg.disk.DiskComponent(pkg.inst(db_rw=db, event_store=pkg.EventStore(db),
                                        mount_points=list(mount_points)))
    c.time_now_fn = lambda: NOW
    fixed_disk(c, **kw)
    return c, db


def pump(pkg, c, lines, t=NOW - 60.0):
    """Lines through the package's kmsg Syncer into the disk bucket."""
    s = pkg.Syncer(pkg.disk.match_disk_error, c._event_bucket)
    for i, ln in enumerate(lines):
        s.process(pkg.Message(time=t + i * 0.001, message=ln, priority=3))


IO_ERROR_LINES = [
    "blk_update_request: I/O error, dev sda, sector 12345 op 0x0:(READ)",
    "blk_update_request: critical medium error, dev nvme0n1, sector 99",
    "print_req_error: I/O error, dev sdb, sector 2048",
    "Buffer I/O error on dev sda1, logical block 2, lost async page write",
]
FATAL_LINES = [
    "EXT4-fs error (device sda1): ext4_find_entry:1455: inode #2: comm ls: reading directory lblock 0",
    "EXT4-fs (sda1): Remounting filesystem read-only",
    "XFS (nvme0n1p1): Corruption detected. Unmount and run xfs_repair",
    "JBD2: Error -5 detected when updating journal superblock for sda1-8. aborting",
    "sd 0:0:0:0: rejecting I/O to offline device",
    "nvme nvme0: controller is down; will reset: CSTS=0x3",
    "nvme nvme0: I/O 22 QID 3 timeout, aborting",
    "nvme nvme0: Removing after probe failure status: -19",
    "EXT4-fs (sda1): re-mounted. Opts: errors=remount-ro read-only",
]
NORMAL_LINES = [
    "EXT4-fs (sda1): mounted filesystem with ordered data mode",
    "systemd[1]: Started Daily apt download activities.",
    "nvme nvme0: 8/0/0 default/read/poll queues",
    "accel0: device lost",
    "NVRM: Xid (PCI:0000:18:00): 79, pid=1, GPU has fallen off the bus.",
]


@pytest.mark.parametrize("line", IO_ERROR_LINES + FATAL_LINES + NORMAL_LINES)
def test_disk_error_matcher(line):
    assert p_disk.match_disk_error(line) == r_disk.match_disk_error(line)


DISK_SCENARIOS = {
    "clean": [],
    "fs error": ["EXT4-fs error (device sda1): ext4_journal_check_start: Detected aborted journal"],
    "io errors": IO_ERROR_LINES[:2],
    "offline": ["sd 0:0:0:0: rejecting I/O to offline device"],
    "controller down": ["nvme nvme0: controller is down; will reset: CSTS=0x3"],
    "all": IO_ERROR_LINES + FATAL_LINES,
}


@pytest.mark.parametrize("name", sorted(DISK_SCENARIOS))
def test_disk_kmsg_scenarios(tmp_path, name):
    def run(pkg):
        c, db = disk_pair(pkg, tmp_path)
        pump(pkg, c, DISK_SCENARIOS[name])
        out = [c.check_once()]
        c.set_healthy()
        out.append(c.check_once())
        out.append((c.events(0)))
        db.close()
        return out

    ref, port = both(run)
    assert_same(ref[:2], port[:2])
    assert_events_parity(ref[2], port[2])
    assert [e.extra_info for e in port[2]] == [e.extra_info for e in ref[2]]
    assert port[1].health == H
    assert_gauges_same("disk", mount_point={"/"})


def test_disk_event_recurrence_after_set_healthy_realarms(tmp_path):
    def run(pkg):
        c, db = disk_pair(pkg, tmp_path)
        pump(pkg, c, ["nvme nvme0: controller is down; will reset: CSTS=0x3"], t=NOW - 120)
        out = [c.check()]
        c.set_healthy()
        out.append(c.check())
        # the fault recurs after the operator's clear
        pump(pkg, c, ["nvme nvme0: Removing after probe failure status: -19"], t=time.time() + 1)
        out.append(c.check())
        db.close()
        return out

    ref, port = both(run)
    assert [r.health for r in assert_same(ref, port)] == [U, H, U]


def test_disk_lookback_window_expires_events(tmp_path):
    def run(pkg):
        c, db = disk_pair(pkg, tmp_path)
        pump(pkg, c, ["EXT4-fs error (device sda1): whatever"], t=NOW - 4 * 3600)
        out = [c.check()]
        db.close()
        return out

    (got,) = assert_same(*both(run))
    assert got.health == H


@pytest.mark.parametrize("mounts, health", [
    ("/dev/sda1 / ext4 ro,relatime,errors=remount-ro 0 0\ntmpfs /run tmpfs rw,nosuid 0 0\n", U),
    ("/dev/sda1 / ext4 rw,relatime,errors=remount-ro 0 0\n", H),
    ("/dev/vdb / ext4 ro,relatime 0 0\n", H),
    ("/dev/sda1 /data\\040disk ext4 ro,errors=remount-ro 0 0\n", U),
], ids=["tripped-ro", "rw", "deliberate-ro", "escaped-mount"])
def test_disk_read_only_mounts(tmp_path, mounts, health):
    (tmp_path / "mounts").write_text(mounts)

    def run(pkg):
        c, db = disk_pair(pkg, tmp_path)
        c.proc_mounts_path = str(tmp_path / "mounts")
        out = [c.check()]
        db.close()
        return out

    (got,) = assert_same(*both(run))
    assert got.health == health


@pytest.mark.parametrize("percent, mounts", [
    (40.0, (("/dev/vda1", "/", "ext4"),)),
    (96.0, (("/dev/vda1", "/", "ext4"),)),
    (40.0, (("/dev/vda1", "/", "ext4"), ("tmpfs", "/run", "tmpfs"), ("/dev/vdb", "/data", "xfs"))),
    (40.0, (("/dev/vdb", "/data", "xfs"),)),
], ids=["root", "nearly-full", "ephemeral-skipped", "root-added"])
def test_disk_usage_and_watched_mounts(tmp_path, percent, mounts):
    def run(pkg):
        c, db = disk_pair(pkg, tmp_path, mounts=mounts, percent=percent)
        out = [c.check()]
        db.close()
        return out

    (got,) = assert_same(*both(run))
    assert got.health == (D if percent >= 95.0 else H)
    assert_gauges_same("disk", mount_point={m for _d, m, _f in mounts} | {"/"})


def test_disk_missing_mount_point(tmp_path):
    def run(pkg):
        c, db = disk_pair(pkg, tmp_path, mount_points=["/definitely/not/here"])
        out = [c.check()]
        db.close()
        return out

    (got,) = assert_same(*both(run))
    assert got.health == U and "missing" in got.reason


def test_disk_unreadable_partitions_and_usage(tmp_path):
    def run(pkg):
        c, db = disk_pair(pkg, tmp_path)

        def boom(*a, **k):
            raise OSError("EIO")

        c.get_partitions_fn = boom
        c.get_usage_fn = boom
        out = [c.check()]
        db.close()
        return out

    (got,) = assert_same(*both(run))
    assert got.reason == "max filesystem usage 0.0%"


def test_disk_default_readers_see_the_psutil_view():
    c = p_disk.DiskComponent(TpudInstance())
    ref = r_disk.DiskComponent(RefTpud())
    assert c._watched_mounts() == ref._watched_mounts()
    assert c._read_only_mounts() == ref._read_only_mounts()


# -- os ------------------------------------------------------------------------------

PANIC_LINES = ["Kernel panic - not syncing: Fatal exception", "kernel BUG at mm/slub.c:123!",
               "Oops: 0002 [#1] PREEMPT SMP", "general protection fault: 0000 [#1] SMP",
               "BUG: unable to handle kernel NULL pointer dereference", "all quiet"]


@pytest.mark.parametrize("line", PANIC_LINES)
def test_kernel_panic_matcher(line):
    assert p_os.match_kernel_panic(line) == r_os.match_kernel_panic(line)


@pytest.mark.parametrize("file_nr", [(95, 100), (89, 100), (0, 0), (5000, 1 << 20)])
def test_os_check_and_fd_threshold(file_nr):
    def run(pkg):
        c = pkg.os.OSComponent(pkg.inst())
        c.get_file_nr_fn = lambda: file_nr
        c.get_uptime_fn = lambda: 5400.0
        return [c.check()]

    (got,) = assert_same(*both(run))
    alloc, limit = file_nr
    assert got.health == (D if limit and alloc / limit >= 0.9 else H)
    assert got.extra_info["kernel_version"]
    assert_gauges_same("os")


def test_os_file_nr_reader_matches_the_reference():
    # the limit is fixed; the allocated count moves between two reads
    (alloc, limit), (ref_alloc, ref_limit) = p_os._read_file_nr(), r_os._read_file_nr()
    assert limit == ref_limit and abs(alloc - ref_alloc) < 4096


PANIC_DUMP = "<0>[ 245.1] Kernel panic - not syncing: Fatal exception in interrupt\n"
OOPS_DUMP = "<4>[ 881.0] BUG: unable to handle page fault\n<4>[ 881.1] Oops: 0002 [#1]\n"


def test_os_pstore_attribution(tmp_path, monkeypatch):
    pstore = tmp_path / "pstore"
    pstore.mkdir()
    for name, body, mtime in (("dmesg-efi-1", PANIC_DUMP, 1000), ("dmesg-efi-2", OOPS_DUMP, 2000),
                              ("notes.txt", "operator notes", 3000)):
        (pstore / name).write_text(body)
        os.utime(pstore / name, (mtime, mtime))
    monkeypatch.setenv("TPUD_PSTORE_DIR", str(pstore))

    def run(pkg):
        db = pkg.DB(str(tmp_path / f"{pkg.name}.db"))
        c = pkg.os.OSComponent(pkg.inst(db_rw=db, event_store=pkg.EventStore(db)))
        c.get_file_nr_fn = lambda: (10, 100)
        c.get_uptime_fn = lambda: 60.0
        c.check()
        c.check()  # a dump is reported once
        # a restart over the same DB reports nothing new
        pkg.os.OSComponent(pkg.inst(db_rw=db, event_store=pkg.EventStore(db))).check()
        evs = c.events(0)
        rows = db.query("SELECT path, mtime, kind, excerpt FROM tpud_pstore_v0_1 ORDER BY mtime")
        db.close()
        return evs, rows

    (ref_evs, ref_rows), (port_evs, port_rows) = both(run)
    assert_events_parity(ref_evs, port_evs)
    assert [e.time for e in port_evs] == [e.time for e in ref_evs]
    assert [tuple(r) for r in port_rows] == [tuple(r) for r in ref_rows]
    assert [e.name for e in port_evs] == ["kernel_crash_dump"] * 2


def test_os_pstore_failure_never_takes_the_check_down(tmp_path, monkeypatch):
    import gpud_tpu.pstore as r_pstore
    import gpud_tpu_torch.pstore as p_pstore

    def boom(*a, **k):
        raise RuntimeError("corrupt pstore")

    for mod in (r_pstore, p_pstore):
        monkeypatch.setattr(mod, "read_crash_files", boom)

    def run(pkg):
        db = pkg.DB(str(tmp_path / f"{pkg.name}.db"))
        c = pkg.os.OSComponent(pkg.inst(db_rw=db, event_store=pkg.EventStore(db)))
        c.get_file_nr_fn = lambda: (10, 100)
        c.get_uptime_fn = lambda: 60.0
        out = [c.check()]
        db.close()
        return out

    (got,) = assert_same(*both(run))
    assert got.health == H


# -- fuse ------------------------------------------------------------------------------

def fuse_conn(root, name, waiting, max_bg):
    d = root / name
    d.mkdir(parents=True)
    (d / "waiting").write_text(f"{waiting}\n")
    if max_bg is not None:
        (d / "max_background").write_text(f"{max_bg}\n")


FUSE_CASES = {
    "healthy": [("38", 0, 12), ("44", 2, 12)],
    "congested": [("38", 0, 12), ("44", 2, 12), ("51", 11, 12)],
    "unparseable skipped": [("99", "not-a-number", 12), ("40", 0, 12)],
    "no max_background file": [("99", 3, None)],
    "zero max_background": [("40", 5, 0)],
    "none": [],
}


@pytest.mark.parametrize("case", sorted(FUSE_CASES))
def test_fuse(tmp_path, case):
    for conn in FUSE_CASES[case]:
        fuse_conn(tmp_path, *conn)

    def run(pkg):
        c = pkg.extra.FuseComponent(pkg.inst())
        c.connections_dir = str(tmp_path)
        assert c.is_supported()
        return [c.check_once()]

    (got,) = assert_same(*both(run))
    assert got.health == (D if case == "congested" else H)


def test_fuse_unsupported_without_the_directory(tmp_path):
    for pkg in (REF, PORT):
        c = pkg.extra.FuseComponent(pkg.inst())
        c.connections_dir = str(tmp_path / "absent")
        assert not c.is_supported()


# -- kernel-module ------------------------------------------------------------------------

@pytest.mark.parametrize("wanted, loaded", [
    (["gasket", "overlay"], {"overlay", "ext4"}),
    (["a", "b"], {"a", "b", "c"}),
    ([], {"a"}),
    (["nvidia", "nvidia_uvm", "nvidia_peermem"], {"nvidia"}),
], ids=["missing", "all-loaded", "none-configured", "nvidia-stack"])
def test_kernel_module(monkeypatch, wanted, loaded):
    def run(pkg):
        c = pkg.extra.KernelModuleComponent(pkg.inst(kernel_modules_to_check=wanted))
        monkeypatch.setattr(c, "_loaded_modules", lambda: loaded)
        return [c.check_once()]

    (got,) = assert_same(*both(run))
    assert got.health == (U if set(wanted) - loaded else H)


def test_kernel_module_reads_proc_modules_as_the_reference():
    assert p_extra.KernelModuleComponent(TpudInstance())._loaded_modules() == \
        r_extra.KernelModuleComponent(RefTpud())._loaded_modules()


# -- library -------------------------------------------------------------------------------

class Realish:
    """A non-mock accelerator instance whose library is present."""

    def tpu_lib_exists(self):
        return True

    gpu_lib_exists = tpu_lib_exists

    def is_mock(self):
        return False


@pytest.mark.parametrize("layout", ["nested", "flat", "versioned", "missing"])
def test_library(tmp_path, layout):
    def run(pkg):
        root = tmp_path / pkg.name
        where = {"nested": root / "python3.10" / "site-packages" / "lib", "flat": root,
                 "versioned": root / "x86_64-linux-gnu", "missing": None}[layout]
        root.mkdir()
        if where is not None:
            where.mkdir(parents=True, exist_ok=True)
            suffix = ".1" if layout == "versioned" else ""
            (where / (pkg.library + suffix)).write_text("")
        c = pkg.extra.LibraryComponent(pkg.inst(Realish()))
        c.search_dirs = [str(root)]
        assert c.is_supported()
        return [c.check_once()]

    (got,) = assert_same(*both(run))
    assert got.health == (D if layout == "missing" else H)
    if layout == "missing":
        assert "libnvidia-ml.so" in got.reason


def test_library_looks_for_nvml():
    assert p_extra.LibraryComponent.DEFAULT_LIBRARIES == ["libnvidia-ml.so"]
    assert p_extra.LibraryComponent.DEFAULT_SEARCH_DIRS == \
        r_extra.LibraryComponent.DEFAULT_SEARCH_DIRS


def test_library_unsupported_on_mock_backend_and_without_an_instance():
    assert not p_extra.LibraryComponent(TpudInstance(gpu_instance=MockBackend())).is_supported()
    assert not r_extra.LibraryComponent(RefTpud(tpu_instance=RefMock())).is_supported()
    assert not p_extra.LibraryComponent(TpudInstance()).is_supported()


# -- network-latency ---------------------------------------------------------------------

LATENCY_CASES = {
    "healthy": {"gcp-metadata": 0.8, "google-dns": 4.2, "cloudflare-dns": 3.1},
    "slow edge": {"gcp-metadata": None, "google-dns": 251.0, "cloudflare-dns": 3.0},
    "at the threshold": {"google-dns": 250.0},
    "no egress": {"gcp-metadata": None, "google-dns": None, "cloudflare-dns": None},
    "nothing measured": {},
}


@pytest.mark.parametrize("case", sorted(LATENCY_CASES))
def test_network_latency(case):
    rtts = LATENCY_CASES[case]

    def run(pkg):
        c = pkg.extra.NetworkLatencyComponent(pkg.inst())
        c.measure_fn = lambda: dict(rtts)
        return [c.check_once()]

    (got,) = assert_same(*both(run))
    reachable = [v for v in rtts.values() if v is not None]
    assert got.health == (H if reachable and max(reachable) < 250.0 else D)
    if reachable:
        assert_gauges_same("network-latency", target={k for k, v in rtts.items() if v is not None})


def test_network_latency_edges_are_the_references():
    c = p_extra.NetworkLatencyComponent(TpudInstance())
    assert c.edges == r_extra.NetworkLatencyComponent(RefTpud()).edges
    assert c.DEGRADED_MS == r_extra.NetworkLatencyComponent.DEGRADED_MS


# -- docker ----------------------------------------------------------------------------------

@pytest.mark.parametrize("rc, output, error", [
    (0, "web\ndb\nworker\n", ""),
    (0, "", ""),
    (1, "", "Cannot connect to the Docker daemon"),
    (-1, "partial", "timed out after 20s"),
], ids=["three", "none", "daemon-down", "timeout"])
def test_docker(monkeypatch, rc, output, error):
    def run(pkg):
        monkeypatch.setattr(pkg.extra, "run_command",
                            lambda *a, **k: pkg.RunResult(exit_code=rc, output=output, error=error))
        return [pkg.extra.DockerComponent(pkg.inst()).check_once()]

    (got,) = assert_same(*both(run))
    assert got.health == (H if rc == 0 else U)


@pytest.mark.parametrize("socket, which", [(True, 1), (False, 0), (False, 1)])
def test_docker_and_containerd_supported(monkeypatch, tmp_path, socket, which):
    sock = tmp_path / "docker.sock"
    if socket:
        sock.write_text("")
    for pkg in (REF, PORT):
        monkeypatch.setattr(pkg.extra, "run_command",
                            lambda *a, pkg=pkg, **k: pkg.RunResult(exit_code=0 if which == 0 else 1))
    got = []
    for pkg in (REF, PORT):
        d = pkg.extra.DockerComponent(pkg.inst())
        monkeypatch.setattr(d, "SOCKET", str(sock))
        c = pkg.extra.ContainerdComponent(pkg.inst())
        c.socket_path = str(sock)
        got.append((d.is_supported(), c.is_supported()))
    assert got[0] == got[1] == ((socket or which == 0),) * 2


# -- containerd ----------------------------------------------------------------------------

def test_containerd_socket_miss_damping(tmp_path, monkeypatch):
    def run(pkg):
        sock = tmp_path / f"{pkg.name}.sock"
        c = pkg.extra.ContainerdComponent(pkg.inst())
        c.socket_path = str(sock)  # absent
        out = [c.check_once() for _ in range(4)]
        sock.write_text("")
        with monkeypatch.context() as m:
            m.setattr(pkg.cri, "grpc_available", lambda: False)
            out.append(c.check_once())  # present: socket semantics without grpcio
        os.unlink(sock)
        out.append(c.check_once())  # a fresh damping window
        return out

    ref, port = both(run)
    got = assert_same(ref, port)
    assert [r.health for r in got] == [H, H, U, U, H, H]
    assert "1/3 strikes" in got[-1].reason and "CRI client unavailable" in got[4].reason


# -- kubelet --------------------------------------------------------------------------------

class FakeResp:
    def __init__(self, payload: bytes):
        self._p = payload

    def read(self):
        return self._p

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("payload", [
    {"items": [{"spec": {"nodeName": "gpu-node-3"}}, {"spec": {}}]},
    {"items": []},
    {},
], ids=["two-pods", "no-pods", "no-items"])
def test_kubelet_pods_and_node_name(monkeypatch, payload):
    monkeypatch.setattr(urllib.request, "urlopen",
                        lambda *a, **k: FakeResp(json.dumps(payload).encode()))
    (got,) = assert_same(*both(lambda pkg: [pkg.extra.KubeletComponent(pkg.inst()).check_once()]))
    assert got.health == H and got.extra_info["pods"] == str(len(payload.get("items", [])))


@pytest.mark.parametrize("exc", [OSError("connection reset"), ValueError("bad json")])
def test_kubelet_api_failure_unhealthy(monkeypatch, exc):
    def boom(*a, **k):
        raise exc

    monkeypatch.setattr(urllib.request, "urlopen", boom)
    (got,) = assert_same(*both(lambda pkg: [pkg.extra.KubeletComponent(pkg.inst()).check_once()]))
    assert got.health == U and str(exc) in got.reason


def test_kubelet_port_is_the_references():
    assert p_extra.KubeletComponent.READONLY_PORT == r_extra.KubeletComponent.READONLY_PORT == 10255


# -- pci ---------------------------------------------------------------------------------------

@pytest.mark.parametrize("virt, rc, output", [
    ("none", 0, "Capabilities: ACSCtl: SrcValid+ TransBlk-"),
    ("none", 0, "Capabilities: ACSCtl: SrcValid- TransBlk-"),
    ("", 0, "no capabilities at all"),
    ("unknown", 127, ""),
    ("kvm", 0, "ACSCtl: SrcValid+"),
    ("poweredge xe9680", 0, "ACSCtl: SrcValid+"),
], ids=["acs-on", "acs-off", "no-acs", "no-lspci", "kvm", "dmi-product"])
def test_pci(monkeypatch, virt, rc, output):
    def run(pkg):
        monkeypatch.setattr(pkg.host, "virtualization", lambda: virt)
        monkeypatch.setattr(pkg.extra, "run_command",
                            lambda *a, **k: pkg.RunResult(exit_code=rc, output=output,
                                                          error="" if rc == 0 else "not found"))
        return [pkg.extra.PCIComponent(pkg.inst()).check_once()]

    (got,) = assert_same(*both(run))
    assert got.health == (D if virt in ("none", "") and "SrcValid+" in output and rc == 0 else H)


# -- nfs -----------------------------------------------------------------------------------------

def test_nfs_group_of_two(tmp_path):
    """Two hosts share a group directory (tests/test_multihost_nfs_e2e.py,
    without daemons): both see 2 fresh members; with the membership pinned
    at 2, a host whose peer's file is gone reads 1/2 unhealthy."""
    def run(pkg):
        group = tmp_path / pkg.name / "shared-nfs"
        cfg = SimpleNamespace(nfs_group_dirs=[str(group)])
        a = pkg.extra.NFSComponent(pkg.inst(config=cfg, machine_id="host-a"))
        b = pkg.extra.NFSComponent(pkg.inst(config=cfg, machine_id="host-b"))
        assert a.is_supported() and b.is_supported()
        out = [a.check_once(), b.check_once()]
        for c in (a, b):
            c.group_configs[0].expected_members = 2
        out.append(b.check_once())
        (group / "host-a").unlink()
        out.append(b.check_once())
        for r in out:  # each package's own group directory, named G
            r.reason = r.reason.replace(str(group), "G")
            r.extra_info = {k.replace(str(group), "G"): v for k, v in r.extra_info.items()}
        return out

    ref, port = both(run)
    got = assert_same(ref, port)
    assert [r.health for r in got] == [H, H, H, U]
    assert got[1].extra_info["G:members_fresh"] == "2" and "1/2 members fresh" in got[3].reason


def test_nfs_unwritable_group(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")

    def run(pkg):
        cfg = SimpleNamespace(nfs_group_dirs=[str(blocker / "group")])
        return [pkg.extra.NFSComponent(pkg.inst(config=cfg, machine_id="m")).check_once()]

    (got,) = assert_same(*both(run))
    assert got.health == U and "write failed" in got.reason


def test_nfs_unsupported_without_groups():
    assert not p_extra.NFSComponent(TpudInstance()).is_supported()
    assert p_extra.NFSComponent(TpudInstance()).machine_id == "unknown"


# -- registration ---------------------------------------------------------------------------------

def test_host_component_names_and_tags_are_the_references():
    from gpud_tpu.components.all import all_components as ref_all
    from gpud_tpu_torch.components.all import all_components

    for r, p in zip(ref_all()[:13], all_components()[:13]):
        assert (p.NAME, p.TAGS) == (r.NAME, r.TAGS)
        assert p.__name__ == r.__name__


def test_nouns_map_the_library_name():
    assert nouns("expected library not found: ['libtpu.so']") == \
        "expected library not found: ['libnvidia-ml.so']"
