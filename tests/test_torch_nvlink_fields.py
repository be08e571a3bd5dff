"""The NVLink error counters read through NVML field values
(gpud_tpu_torch/gpu/nvml.py ``DeviceReader.links`` and ``link_counters``).

One ``nvmlDeviceGetFieldValues`` call per GPU carries every (counter, link)
entry, each with the link in ``scopeId``; each entry's own status is mapped
as a call's is, so one refused field hides no other. The fake NVML
(tests/torch_fakes.py) answers each entry by (scope id, field id). Counters
that move reach the NVLink check's counter step and the store's columns as
the reference's ICI counters do on the same scenario."""

import pytest

from gpud_tpu.components.base import TpudInstance as RefTpud
from gpud_tpu.components.tpu.ici import DEFAULT_FAST_POLL_INTERVAL, TPUICIComponent
from gpud_tpu.eventstore import EventStore as RefEventStore
from gpud_tpu.sqlite import DB as RefDB
from gpud_tpu.tpu.instance import ICILinkSnapshot, LinkState as RefLinkState, MockBackend

from gpud_tpu_torch.components.base import TpudInstance
from gpud_tpu_torch.components.gpu.nvlink import GPUNVLinkComponent
from gpud_tpu_torch.eventstore import EventStore
from gpud_tpu_torch.gpu import nvml as N
from gpud_tpu_torch.gpu.instance import NVMLBackend
from gpud_tpu_torch.sqlite import DB

from torch_fakes import FakeGPU, FakeNVML
from torch_parity import link_name, nouns

REPLAY, RECOVERY, CRC = (N.NVML_FI_DEV_NVLINK_ERROR_DL_REPLAY,
                         N.NVML_FI_DEV_NVLINK_ERROR_DL_RECOVERY,
                         N.NVML_FI_DEV_NVLINK_ERROR_DL_CRC)


def ecc(link):
    return N.NVML_FI_DEV_NVLINK_ECC_DATA_ERROR_COUNT_L0 + link


def reader(*gpus, index=0):
    fake = FakeNVML(list(gpus))
    nvml = N.NVML(fake)
    assert nvml.init() == ""
    return N.DeviceReader(nvml, nvml.handle(index)), fake


def every_counter(links, value=1):
    out = {}
    for k in range(links):
        out.update({(k, REPLAY): value, (k, RECOVERY): value, (k, CRC): value})
        if k <= 11:
            out[(k, ecc(k))] = value
    return out


def field_calls(fake):
    return [c for c in fake.calls if c[0] == "nvmlDeviceGetFieldValues"]


def test_the_field_ids_are_the_headers_and_the_ecc_fields_end_at_link_11():
    # nvml.h: 161-163 are link-scoped for any link; ECC data has L0 = 148
    # ... L11 = 159 and no field past link 11 (chip_smoke.py holds these)
    assert (REPLAY, RECOVERY, CRC) == (161, 162, 163)
    assert (ecc(0), ecc(11)) == (148, N.NVML_FI_DEV_NVLINK_ECC_DATA_ERROR_COUNT_L11) == (148, 159)
    assert [c for c, _f in N.LINK_COUNTER_FIELDS] == ["replay", "recovery", "crc"]


def test_one_field_values_call_per_gpu_with_every_link_in_scope():
    r, fake = reader(FakeGPU(links=[1] * 18, link_counters=every_counter(18, 4)))
    samples = r.links()
    assert len(samples) == 18
    (call,) = field_calls(fake)
    _name, _handle, count, arr = call
    assert count == 18 * 3 + 12
    asked = sorted((arr[i].scopeId, arr[i].fieldId) for i in range(count))
    assert asked == sorted(every_counter(18))
    assert not any(c[0] == "nvmlDeviceGetNvLinkErrorCounter" for c in fake.calls)
    assert all((s.replays, s.recoveries, s.crc_errors) == (4, 4, 4) for s in samples)
    assert [s.ecc_errors for s in samples] == [4] * 12 + [0] * 6
    assert r.unsupported == [f"nvlink{k}_ecc_data" for k in range(12, 18)]
    assert r.errors == {} and not r.lost and not r.requires_reset


def test_only_the_links_that_report_a_state_are_asked():
    r, fake = reader(FakeGPU(links=[None, 1, 0], link_counters=every_counter(3, 2)))
    assert [(s.link_id, s.active, s.crc_errors) for s in r.links()] == [(1, True, 2),
                                                                        (2, False, 2)]
    _name, _handle, count, arr = field_calls(fake)[0]
    assert sorted({arr[i].scopeId for i in range(count)}) == [1, 2]


def test_no_link_no_field_values_call():
    r, fake = reader(FakeGPU(links=[None] * 18))
    assert r.links() == [] and field_calls(fake) == []


def test_a_field_refused_on_one_link_hides_no_other():
    gpu = FakeGPU(links=[1] * 4, link_counters=every_counter(4, 9))
    gpu.field_status[(2, CRC)] = N.NVML_ERROR_NOT_SUPPORTED
    r, _ = reader(gpu)
    samples = r.links()
    assert [s.crc_errors for s in samples] == [9, 9, 0, 9]
    assert (samples[2].replays, samples[2].recoveries, samples[2].ecc_errors) == (9, 9, 9)
    assert r.unsupported == ["nvlink2_crc"] and r.errors == {}


def test_every_field_refused_is_the_card_as_found():
    # the containerised H100 of PERF.md refuses all of them: counters read 0,
    # each (link, counter) is listed as unsupported, the links still report
    r, _ = reader(FakeGPU(links=[1] * 18))
    samples = r.links()
    assert len(samples) == 18 and all(s.active for s in samples)
    assert all((s.replays, s.recoveries, s.crc_errors, s.ecc_errors) == (0, 0, 0, 0)
               for s in samples)
    want = [f"nvlink{k}_{c}" for k in range(18) for c in ("replay", "recovery", "crc")]
    want += [f"nvlink{k}_ecc_data" for k in range(18)]
    assert sorted(r.unsupported) == sorted(want) and r.errors == {}


def test_the_whole_call_refused_lists_every_field():
    r, _ = reader(FakeGPU(links=[1, 1], errors={
        "nvmlDeviceGetFieldValues": N.NVML_ERROR_NOT_SUPPORTED}))
    samples = r.links()
    assert len(samples) == 2 and all(s.crc_errors == 0 for s in samples)
    assert sorted(r.unsupported) == sorted(
        f"nvlink{k}_{c}" for k in range(2) for c in ("replay", "recovery", "crc", "ecc_data"))


@pytest.mark.parametrize("rc", [N.NVML_ERROR_NO_PERMISSION, N.NVML_ERROR_UNKNOWN])
def test_other_entry_errors_keep_their_reason(rc):
    gpu = FakeGPU(links=[1, 1], link_counters=every_counter(2, 3))
    gpu.field_status[(1, REPLAY)] = rc
    r, _ = reader(gpu)
    samples = r.links()
    assert samples[1].replays == 0 and samples[1].crc_errors == 3 and samples[0].replays == 3
    assert list(r.errors) == ["nvlink1_replay"] and f"NVML error {rc}" in r.errors["nvlink1_replay"]
    assert f"fake error {rc}" in r.errors["nvlink1_replay"]
    assert r.unsupported == [] and not r.requires_reset


def test_reset_required_in_one_entry():
    gpu = FakeGPU(links=[1, 1], link_counters=every_counter(2, 3))
    gpu.field_status[(0, CRC)] = N.NVML_ERROR_RESET_REQUIRED
    r, _ = reader(gpu)
    samples = r.links()
    assert r.requires_reset and list(r.errors) == ["nvlink0_crc"]
    assert samples[0].crc_errors == 0 and samples[1].crc_errors == 3


@pytest.mark.parametrize("where", ["entry", "call"])
def test_gpu_lost_in_the_field_values_drops_its_links(where):
    lost = FakeGPU(links=[1, 1], link_counters=every_counter(2))
    if where == "entry":
        lost.field_status[(1, RECOVERY)] = N.NVML_ERROR_GPU_IS_LOST
    else:
        lost.errors["nvmlDeviceGetFieldValues"] = N.NVML_ERROR_GPU_IS_LOST
    b = NVMLBackend(lib=FakeNVML([FakeGPU(links=[1, 1], link_counters=every_counter(2, 5)), lost]))
    links = b.nvlink_links()
    assert {ln.gpu_id for ln in links} == {0} and all(ln.crc_errors == 5 for ln in links)
    assert b.devices()[1].lost and not b.devices()[0].lost


# -- the counter step, against the reference's ICI counters ----------------------

STEPS = [  # (seconds since the last check, {link: (replay, recovery, crc, ecc)})
    (0.0, {}),
    (60.0, {0: (0, 0, 5, 0)}),                    # CRC step on link 0
    (60.0, {0: (0, 0, 5, 0)}),                    # quiet
    (700.0, {0: (0, 0, 5, 0), 1: (2, 0, 0, 0)}),  # replay step on link 1, past
    (700.0, {0: (0, 0, 5, 0), 1: (2, 1, 0, 3)}),  # the cooldown; then recovery
    (700.0, {0: (0, 0, 5, 0), 1: (2, 1, 0, 3)}),  # + ECC on link 1; quiet
]


def test_counters_that_move_reach_the_counter_step_and_the_store(tmp_path):
    now = [10_000.0]
    gpu = FakeGPU(links=[1] * 4)
    port_db, ref_db = DB(str(tmp_path / "port.db")), RefDB(str(tmp_path / "ref.db"))
    port = GPUNVLinkComponent(TpudInstance(gpu_instance=NVMLBackend(lib=FakeNVML([gpu])),
                                           db_rw=port_db, event_store=EventStore(port_db)))
    ref = TPUICIComponent(RefTpud(tpu_instance=MockBackend(accelerator_type="v5e-4"),
                                  db_rw=ref_db, event_store=RefEventStore(ref_db)))
    counters = {}
    ref.sampler.ici_links = lambda: [
        ICILinkSnapshot(chip_id=0, link_id=k, state=RefLinkState.UP,
                        replays=counters.get(k, (0,) * 4)[0],
                        tx_errors=counters.get(k, (0,) * 4)[1],
                        crc_errors=counters.get(k, (0,) * 4)[2],
                        rx_errors=counters.get(k, (0,) * 4)[3]) for k in range(4)]
    for c in (port, ref):
        c.sampler.ttl = 0.0
        c.time_now_fn = c.store.time_now_fn = lambda: now[0]
        c.expected_links = 4
    intervals = []
    try:
        for seconds, step in STEPS:
            now[0] += seconds
            counters.clear()
            counters.update(step)
            gpu.link_counters = {}
            for k, (rp, rc, crc, ec) in step.items():
                gpu.link_counters.update({(k, REPLAY): rp, (k, RECOVERY): rc, (k, CRC): crc,
                                          (k, ecc(k)): ec})
            r, p = ref.check_once(), port.check_once()
            assert (p.health, p.reason) == (r.health, nouns(r.reason))
            assert port.poll_interval() == ref.poll_interval()
            intervals.append(port.poll_interval())
        assert [i == DEFAULT_FAST_POLL_INTERVAL for i in intervals] == [
            False, True, False, True, True, False]
        cols = "SELECT ts, link, state, tx_errors, rx_errors, crc_errors, replays " \
               "FROM tpud_ici_snapshots_v0_1"
        want = sorted((row[0], link_name(row[1])) + tuple(row[2:]) for row in ref_db.query(cols))
        got = sorted(tuple(row) for row in port_db.query(cols))
        assert got == want
        assert max(row[5] for row in got) == 5 and max(row[6] for row in got) == 2
        assert max(row[3] for row in got) == 1 and max(row[4] for row in got) == 3
        assert port.store.scan(3600.0).links["gpu0/nvlink0"].crc_delta == \
            ref.store.scan(3600.0).links["chip0/ici0"].crc_delta == 5
    finally:
        port.close()
        ref.close()
        port_db.close()
        ref_db.close()
