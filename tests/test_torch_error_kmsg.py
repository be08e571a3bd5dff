"""The port's Xid/SXid kmsg component (gpud_tpu_torch/components/gpu/error_kmsg.py)
end to end, and its fault injector (gpud_tpu_torch/fault_injector.py).

A temp file stands in for /dev/kmsg. Its records flow through the port's
``Watcher`` (driven in the test's own thread) into the component's
``Syncer``, the SQLite event store and ``evolve_health``, with a reboot
recorded between an error and its recurrence. Fake clocks, no sleeps."""

import pytest

import gpud_tpu.fault_injector as ref_fi

import gpud_tpu_torch.fault_injector as fi
import gpud_tpu_torch.host as host
import gpud_tpu_torch.kmsg.watcher as watcher
from gpud_tpu_torch.api.v1.types import EventType, HealthStateType, RepairActionType
from gpud_tpu_torch.components.base import TpudInstance
from gpud_tpu_torch.components.gpu import catalog
from gpud_tpu_torch.components.gpu.error_kmsg import (
    NAME,
    GPUErrorKmsgComponent,
    _c_errors,
    kmsg_match,
)
from gpud_tpu_torch.components.gpu.nvlink import GPUNVLinkComponent
from gpud_tpu_torch.eventstore import EventStore
from gpud_tpu_torch.gpu.instance import MockBackend
from gpud_tpu_torch.kmsg.writer import KmsgWriter
from gpud_tpu_torch.sqlite import DB

BOOT = 1_700_000_000.0
NOW = BOOT + 10_000.0


def record(seq, seconds, message, priority=3):
    return f"{priority},{seq},{int(seconds * 1e6)},-;{message}\n"


# the mock's GPU N sits at PCI bus 0x10 + N (NVML's 00000000:1N:00.0)
XID_79_GPU2 = "NVRM: Xid (PCI:0000:12:00): 79, pid='<unknown>', name=<unknown>, GPU has fallen off the bus."
XID_74_GPU3 = "NVRM: Xid (PCI:0000:13:00): 74, pid=1, name=x, NVLink: fatal error detected on link 4"
NOISE = [
    "NVRM: loading NVIDIA UNIX x86_64 Kernel Module  580.159.03",
    "nvme 0000:c1:00.0: AER: Corrected error received: 0000:c1:00.0",
    "EXT4-fs (sda1): mounted filesystem with ordered data mode",
]


@pytest.fixture()
def host_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "1")
    monkeypatch.setattr(watcher, "boot_time", lambda: BOOT)
    db = DB(str(tmp_path / "state.db"))
    es = EventStore(db)
    reboots = host.RebootEventStore(es)
    inst = TpudInstance(gpu_instance=MockBackend(accelerator_type="h100-sxm-8"),
                        event_store=es, reboot_event_store=reboots)
    nvlink = GPUNVLinkComponent(inst)
    comp = GPUErrorKmsgComponent(inst)
    comp.time_now_fn = nvlink.time_now_fn = lambda: NOW
    kmsg = tmp_path / "kmsg"
    kmsg.write_text("")
    yield {"db": db, "inst": inst, "comp": comp, "nvlink": nvlink, "kmsg": kmsg,
           "reboots": reboots}
    db.close()


def follow(env, records):
    """Append ``records`` to the kmsg file and run a watcher over the whole
    file into the component's syncer, in this thread, until it has
    delivered every record of the file."""
    with open(env["kmsg"], "a") as f:
        f.writelines(records)
    total = len(watcher.read_all(str(env["kmsg"])))
    seen = []
    w = watcher.Watcher(None, path=str(env["kmsg"]), from_now=False)

    def deliver(msg):
        env["comp"].syncer.process(msg)
        seen.append(msg)
        if len(seen) == total:
            w._stop.set()

    w.callback = deliver
    w._follow_once()
    return env["comp"].check()


def test_the_pci_map_is_the_adapters(host_env):
    comp = host_env["comp"]
    assert comp.bdf_to_index == {(0, 0x10 + g, 0): g for g in range(8)}


def test_xid_lines_to_health_with_reboot_escalation_and_set_healthy(host_env, monkeypatch):
    comp, nvlink = host_env["comp"], host_env["nvlink"]
    before = dict(_c_errors.labels_values())
    cr = follow(host_env, [record(1, 100, NOISE[0], 6), record(2, 200, XID_79_GPU2),
                           record(3, 201, NOISE[1], 4), record(4, 202, XID_74_GPU3),
                           record(5, 203, NOISE[2], 6)])
    assert cr.health == HealthStateType.UNHEALTHY
    assert cr.reason == "gpu_fallen_off_bus(GPU 2) (x1); gpu_nvlink_error(GPU 3) (x1)"
    assert cr.suggested_actions.repair_actions == [
        RepairActionType.REBOOT_SYSTEM, RepairActionType.HARDWARE_INSPECTION]
    assert cr.extra_info == {"gpu_fallen_off_bus(GPU 2)": "1", "gpu_nvlink_error(GPU 3)": "1"}
    evs = sorted(comp.events(0), key=lambda e: e.time)
    assert [(e.name, e.type, e.time, e.extra_info["gpu"]) for e in evs] == [
        ("gpu_fallen_off_bus", EventType.FATAL, BOOT + 200, "2"),
        ("gpu_nvlink_error", EventType.CRITICAL, BOOT + 202, "3")]
    assert evs[0].extra_info["kmsg"] == XID_79_GPU2 and evs[0].extra_info["priority"] == "err"
    after = dict(_c_errors.labels_values())
    key = (("component", NAME), ("error", "gpu_nvlink_error"))
    assert after[key] == before.get(key, 0) + 1
    # the Xid 74 line opened the NVLink component's fast-poll window
    assert nvlink.poll_interval() == nvlink.fast_poll_interval < nvlink.POLL_INTERVAL

    # a reboot with no recurrence resolves both tracks
    monkeypatch.setattr(host, "boot_time", lambda: BOOT + 1000)
    host_env["reboots"].record_reboot()
    host_env["reboots"].record_reboot()  # the same boot is recorded once
    assert len(host_env["reboots"].get_reboot_events(0)) == 1
    cr = comp.check()
    assert cr.health == HealthStateType.HEALTHY
    assert cr.reason == "previous GPU errors cleared by reboot"

    # the same Xid on the same GPU after the reboot: below Xid 79's
    # threshold of 2 reboots, the suggestion is still a reboot
    cr = follow(host_env, [record(6, 1500, XID_79_GPU2)])
    assert cr.health == HealthStateType.UNHEALTHY
    assert cr.reason == "gpu_fallen_off_bus(GPU 2) (x2)"
    assert cr.suggested_actions.repair_actions == [
        RepairActionType.REBOOT_SYSTEM, RepairActionType.HARDWARE_INSPECTION]

    # and again after a second reboot: the threshold escalates
    monkeypatch.setattr(host, "boot_time", lambda: BOOT + 2000)
    host_env["reboots"].record_reboot()
    cr = follow(host_env, [record(7, 2500, XID_79_GPU2)])
    assert cr.health == HealthStateType.UNHEALTHY
    assert cr.reason == "gpu_fallen_off_bus(GPU 2) recurred after 2 reboot(s) (x3)"
    assert cr.suggested_actions.repair_actions == [RepairActionType.HARDWARE_INSPECTION]

    # a re-read of the ring (restart) adds nothing: dedupe and the store's find
    assert follow(host_env, []).reason == cr.reason
    assert len(comp.events(0)) == 4

    comp.set_healthy()
    cr = comp.check()
    assert cr.health == HealthStateType.HEALTHY and cr.reason == "no GPU errors observed"


def test_sxid_lines_are_host_wide_and_leave_the_nvlink_window_shut(host_env):
    nvlink = host_env["nvlink"]
    assert nvlink.poll_interval() == nvlink.POLL_INTERVAL
    cr = follow(host_env, [
        record(1, 10, "nvidia-nvswitch0: SXid (PCI:0000:05:00.0): 12028, Non-fatal, "
                      "Link 32 egress non-posted PRIV error (First)", 4)])
    assert cr.health == HealthStateType.DEGRADED and cr.suggested_actions is None
    cr = follow(host_env, [
        record(2, 20, "nvidia-nvswitch2: SXid (PCI:0000:07:00.0): 20034, Fatal, Link 28 "
                      "LTSSM Fault Up", 2),
        record(3, 21, "nvidia-nvswitch2: SXid (PCI:0000:07:00.0): 20034, Severity 1 "
                      "Engine instance 28 Sub-engine instance 00", 2)])
    assert cr.health == HealthStateType.UNHEALTHY
    assert cr.reason == "gpu_nvswitch_fatal (x1); gpu_nvswitch_nonfatal (x1)"
    # no SXid entry is an NVLink entry (gpu_nvlink*): the window stays shut
    assert nvlink.poll_interval() == nvlink.POLL_INTERVAL


def test_a_listener_that_raises_does_not_break_recording(host_env):
    host_env["inst"].fabric_suspicion_listeners.insert(0, lambda name: 1 / 0)
    cr = follow(host_env, [record(1, 5, XID_74_GPU3)])
    assert cr.health == HealthStateType.UNHEALTHY
    assert host_env["nvlink"].poll_interval() == host_env["nvlink"].fast_poll_interval


def test_reboot_threshold_overrides(host_env, monkeypatch):
    comp = host_env["comp"]
    follow(host_env, [record(1, 5, XID_74_GPU3)])
    monkeypatch.setattr(host, "boot_time", lambda: BOOT + 50)
    host_env["reboots"].record_reboot()
    cr = follow(host_env, [record(2, 60, XID_74_GPU3)])
    assert "recurred" not in cr.reason  # Xid 74 escalates after 2 reboots
    comp.reboot_threshold_overrides = {"gpu_nvlink_error": 1}
    assert comp.check().reason == "gpu_nvlink_error(GPU 3) recurred after 1 reboot(s) (x2)"


def test_kmsg_match_uses_the_map_it_was_built_over():
    line = XID_79_GPU2
    assert kmsg_match({(0, 0x12, 0): 6})(line) == (
        "gpu_fallen_off_bus", EventType.FATAL, line, {"gpu": "6"})
    assert kmsg_match({})(line) == ("gpu_fallen_off_bus", EventType.FATAL, line, None)
    assert kmsg_match()("EXT4-fs (sda1): mounted") is None


def test_an_adapter_without_pci_info_leaves_xids_host_wide(tmp_path, monkeypatch):
    monkeypatch.setattr(watcher, "boot_time", lambda: BOOT)
    mock = MockBackend(accelerator_type="h100-sxm-8")
    devs = mock.devices()
    for d in devs.values():
        d.pci_address = ""  # as NVML on a card that refuses its PCI info
    monkeypatch.setattr(mock, "devices", lambda: devs)
    db = DB(str(tmp_path / "s.db"))
    try:
        comp = GPUErrorKmsgComponent(TpudInstance(gpu_instance=mock, event_store=EventStore(db)))
        comp.time_now_fn = lambda: NOW
        assert comp.bdf_to_index == {}
        ev = comp.syncer.process(watcher.parse_line(record(1, 5, XID_79_GPU2), BOOT))
        assert "gpu" not in ev.extra_info
        assert comp.check().reason == "gpu_fallen_off_bus (x1)"
    finally:
        db.close()


def test_scan_mode_reads_the_whole_ring(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "1")
    kmsg = tmp_path / "kmsg"
    kmsg.write_text("".join([record(1, 1, NOISE[0], 6), record(2, 2, XID_79_GPU2),
                             record(3, 3, "GPU-ERR: gpu_ecc_xid48 gpu=5")]))
    monkeypatch.setenv("TPUD_KMSG_FILE_PATH", str(kmsg))
    comp = GPUErrorKmsgComponent(TpudInstance(gpu_instance=MockBackend(accelerator_type="h100-sxm-8")))
    assert comp.syncer is None and comp.is_supported()
    cr = comp.check()
    assert cr.health == HealthStateType.UNHEALTHY
    assert cr.reason == "gpu_fallen_off_bus(GPU 2) (x1); gpu_ecc_xid48(GPU 5) (x1)"
    assert comp.events(0) == []
    kmsg.write_text(record(1, 1, NOISE[2], 6))
    assert comp.check().reason == "no GPU errors observed"


def test_ticker_runs_on_the_scheduler_when_there_is_one(host_env):
    jobs = []

    class Job:
        def cancel(self):
            jobs.append("cancelled")

    class Scheduler:
        def add_job(self, name, fn, interval):
            jobs.append((name, fn, interval))
            return Job()

    comp = host_env["comp"]
    comp.instance.scheduler = Scheduler()
    comp.start()
    comp.start()
    comp.close()
    assert jobs == [(f"component:{NAME}", comp.check, 30.0), "cancelled"]


# -- the fault injector ---------------------------------------------------------


def test_guard_rails_are_the_references():
    assert (fi.MAX_REPEAT, fi.MAX_INTERVAL_SECONDS, fi.MAX_BURST_SECONDS, fi.DEFAULT_PRIORITY) \
        == (ref_fi.MAX_REPEAT, ref_fi.MAX_INTERVAL_SECONDS, ref_fi.MAX_BURST_SECONDS,
            ref_fi.DEFAULT_PRIORITY)


@pytest.mark.parametrize("kw", [
    {}, {"kernel_message": "x", "repeat": 0}, {"kernel_message": "x", "repeat": 101},
    {"kernel_message": "x", "interval_seconds": -1.0},
    {"kernel_message": "x", "interval_seconds": 5.5},
    {"kernel_message": "x", "repeat": 10, "interval_seconds": 4.0},
    {"kernel_message": "x", "repeat": 100, "interval_seconds": 0.3},
    {"kernel_message": "x", "repeat": 7, "interval_seconds": 5.0},
], ids=["empty", "repeat-0", "repeat-101", "interval-neg", "interval-big", "burst-36s",
        "burst-29.7s", "burst-30s"])
def test_raw_message_validation_matches_the_reference(kw):
    port_err = fi.Request(**kw).validate()
    ref_err = ref_fi.Request(**kw).validate()
    assert (port_err or "").replace("gpu_error_name", "tpu_error_name") == (ref_err or "")


def test_catalogued_names_are_validated_against_the_gpu_catalog():
    assert fi.Request(gpu_error_name="gpu_fallen_off_bus").validate() is None
    err = fi.Request(gpu_error_name="tpu_chip_lost").validate()
    assert err.startswith("unknown gpu_error_name 'tpu_chip_lost'; known: ")
    assert "gpu_nvlink_error" in err


def test_request_from_dict():
    r = fi.Request.from_dict({"name": "gpu_ecc_xid48", "gpu_id": "3", "repeat": "2",
                              "interval_seconds": "0.5", "priority": 1})
    assert (r.gpu_error_name, r.gpu_id, r.repeat, r.interval_seconds, r.priority) == (
        "gpu_ecc_xid48", 3, 2, 0.5, 1)
    assert fi.Request.from_dict({"kernel_message": "raw"}).kernel_message == "raw"


def test_burst_injection_flows_to_detection(host_env):
    inj = fi.Injector(writer=KmsgWriter(str(host_env["kmsg"])))
    sleeps = []
    inj.sleep_fn = sleeps.append
    inj.time_now_fn = lambda: 123.0
    res = inj.inject(fi.Request(gpu_error_name="gpu_nvlink_error", gpu_id=4, repeat=3,
                                interval_seconds=0.5, detail="link 2"))
    assert res.to_dict() == {"ok": True, "error": "", "line": "GPU-ERR: gpu_nvlink_error gpu=4 link 2",
                             "entry": "gpu_nvlink_error", "code": 74, "timestamp": 123.0,
                             "writes": 3}
    assert sleeps == [0.5, 0.5]
    msgs = watcher.read_all(str(host_env["kmsg"]))
    assert [(m.priority, m.message) for m in msgs] == [(2, res.line)] * 3
    cr = follow(host_env, [])
    assert cr.health == HealthStateType.UNHEALTHY
    assert cr.reason.startswith("gpu_nvlink_error(GPU 4) (x")
    assert host_env["nvlink"].poll_interval() == host_env["nvlink"].fast_poll_interval


def test_raw_kernel_message_and_failures(tmp_path):
    inj = fi.Injector(kmsg_path=str(tmp_path / "k"))
    res = inj.inject(fi.Request(kernel_message=XID_79_GPU2, priority=3))
    assert res.ok and res.entry == "" and res.code == 0 and res.writes == 1
    assert catalog.match(watcher.read_all(str(tmp_path / "k"))[0].message).entry.name == \
        "gpu_fallen_off_bus"
    bad = fi.Injector(kmsg_path=str(tmp_path / "no" / "dir" / "k")).inject(
        fi.Request(kernel_message="x"))
    assert not bad.ok and bad.error and bad.writes == 0
    assert not inj.inject(fi.Request()).ok
