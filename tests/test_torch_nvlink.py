"""The port's NVLink component (gpud_tpu_torch/components/gpu/nvlink.py)
against the reference's ICI component (gpud_tpu/components/tpu/ici.py).

Each case of tests/test_ici.py, test_ici_sticky_scenarios.py and
test_ici_adaptive.py runs through both components on a fake clock with the
same link sequence: the reference over its MockBackend, the port over a
MirrorInstance of another (tests/torch_parity.py). Every check must give the
same health, repair actions, extra info and events (reasons and messages
after the noun table), the same poll interval, and the two stores the same
rows. No case sleeps or starts a poller thread.
"""

import pytest

from gpud_tpu.components.base import TpudInstance as RefTpud
from gpud_tpu.components.tpu.ici import (
    DEFAULT_FAST_POLL_INTERVAL,
    DEFAULT_SUSPICION_WINDOW,
    TPUICIComponent,
)
from gpud_tpu.eventstore import EventStore as RefEventStore
from gpud_tpu.sqlite import DB as RefDB
from gpud_tpu.tpu.instance import ICILinkSnapshot, InjectedInstance as RefInjected, LinkState

from gpud_tpu_torch.api.v1.types import HealthStateType
from gpud_tpu_torch.components.base import TpudInstance
from gpud_tpu_torch.components.gpu import nvlink as port_nvlink
from gpud_tpu_torch.components.gpu.nvlink import GPUNVLinkComponent
from gpud_tpu_torch.eventstore import EventStore
from gpud_tpu_torch.gpu.instance import InjectedInstance
from gpud_tpu_torch.sqlite import DB

from torch_parity import (
    ACCEL,
    KMSG,
    assert_events_parity,
    assert_gauges_parity,
    assert_result_parity,
    injectors,
    link_name,
    mirrored_mocks,
    nouns,
    port_link,
)

H = HealthStateType.HEALTHY
D = HealthStateType.DEGRADED
U = HealthStateType.UNHEALTHY
TABLE = "tpud_ici_snapshots_v0_1"
ROW = f"SELECT ts, link, state, tx_bytes, rx_bytes, tx_errors, rx_errors, crc_errors, replays FROM {TABLE}"


class Pair:
    """The reference ICI component and the port's NVLink component, each over
    its own DB, on one fake clock, with the same injected link faults."""

    def __init__(self, tmp_path, accel="v5e-8", auto_clear=0.0, start=10_000.0):
        self.now = [start]
        ref_mock, mirror = mirrored_mocks(accel, self.now)
        self.ref_inj, self.port_inj = injectors()
        self.ref_db = RefDB(str(tmp_path / "ref.db"))
        self.port_db = DB(str(tmp_path / "port.db"))
        self.ref_inst = RefTpud(tpu_instance=RefInjected(ref_mock, self.ref_inj),
                                db_rw=self.ref_db, event_store=RefEventStore(self.ref_db))
        self.port_inst = TpudInstance(gpu_instance=InjectedInstance(mirror, self.port_inj),
                                      db_rw=self.port_db, event_store=EventStore(self.port_db))
        self.ref = TPUICIComponent(self.ref_inst)
        self.port = GPUNVLinkComponent(self.port_inst)
        for c in (self.ref, self.port):
            c.sampler.ttl = 0.0  # no caching inside scenario steps
            c.time_now_fn = lambda: self.now[0]
            c.store.time_now_fn = lambda: self.now[0]
            c.auto_clear_window = auto_clear
        self.accel = (accel, ACCEL[accel])

    def both(self, fn):
        """Apply ``fn(component)`` to both sides."""
        fn(self.ref)
        fn(self.port)

    def down(self, names=()):
        self.ref_inj.ici_links_down[:] = list(names)
        self.port_inj.nvlink_links_down[:] = [link_name(n) for n in names]

    def check(self, once=False):
        r = self.ref.check_once() if once else self.ref.check()
        p = self.port.check_once() if once else self.port.check()
        assert_result_parity(r, p, *self.accel)
        assert_events_parity(self.ref.events(0), self.port.events(0))
        assert self.port.poll_interval() == self.ref.poll_interval()
        return p

    def tick(self, seconds=60.0, down=(), once=False):
        self.down(down)
        self.now[0] += seconds
        return self.check(once)

    def health(self, seconds=60.0, down=()):
        return self.tick(seconds, down).health_state_type()

    def set_healthy(self):
        self.ref.set_healthy()
        self.port.set_healthy()
        r, p = self.ref.last_health_states()[0], self.port.last_health_states()[0]
        assert (p.health, p.reason) == (r.health, nouns(r.reason))
        assert_events_parity(self.ref.events(0), self.port.events(0))

    def snap(self, crc_by_link, ts):
        """The same hand-made snapshot into both stores (2 chips x 4 links)."""
        links = [ICILinkSnapshot(chip_id=c, link_id=k, state=LinkState.UP,
                                 crc_errors=crc_by_link.get(f"chip{c}/ici{k}", 0))
                 for c in range(2) for k in range(4)]
        self.ref.store.insert_snapshot(links, ts=ts)
        self.port.store.insert_snapshot([port_link(ln) for ln in links], ts=ts)

    def tombstone(self, link, ts):
        self.ref.store.set_tombstone(link, ts=ts)
        self.port.store.set_tombstone(link_name(link), ts=ts)

    def assert_rows_equal(self):
        ref = sorted((r[0], link_name(r[1])) + tuple(r[2:]) for r in self.ref_db.query(ROW))
        port = sorted(tuple(r) for r in self.port_db.query(ROW))
        assert port == ref
        tomb = "SELECT link, ts FROM tpud_ici_tombstones_v0_1"
        assert sorted((link_name(a), b) for a, b in self.ref_db.query(tomb)) == \
            sorted(tuple(r) for r in self.port_db.query(tomb))

    def close(self):
        for c in (self.ref, self.port):
            c.close()
        self.ref_db.close()
        self.port_db.close()


@pytest.fixture
def pair(tmp_path):
    made = []

    def make(**kw):
        sub = tmp_path / f"pair{len(made)}"
        sub.mkdir()
        made.append(Pair(sub, **kw))
        return made[-1]

    yield make
    for p in made:
        p.assert_rows_equal()
        p.close()


# -- tests/test_ici.py, component level ------------------------------------------

def test_all_links_up_healthy(pair):
    p = pair()
    cr = p.check()
    assert cr.health_state_type() == H
    assert "32/32" in cr.summary() and "NVLink" in cr.summary()
    assert_gauges_parity("accelerator-tpu-ici", links={link_name(f"chip{c}/ici{k}")
                                                       for c in range(8) for k in range(4)})


def test_link_down_unhealthy_with_events(pair):
    p = pair()
    p.down(["chip1/ici2"])
    cr = p.check()
    assert cr.health_state_type() == U and "gpu1/nvlink2" in cr.summary()
    assert any(e.name == "ici_link_down" for e in p.port.events(0))
    p.check()  # repeat: the event is deduped
    assert sum(1 for e in p.port.events(0) if e.name == "ici_link_down") == 1


def test_sticky_after_recovery_until_set_healthy(pair):
    p = pair()
    assert p.health(1, down=["chip0/ici0"]) == U
    cr = p.tick(1)  # the link recovers
    assert cr.health_state_type() in (D, U) and "sticky" in cr.summary()
    p.set_healthy()
    assert p.port.last_health_states()[0].health == H
    assert p.health(1) == H


def test_auto_clear_window(pair):
    p = pair(auto_clear=300.0)
    p.down(["chip0/ici0"])
    p.check()
    assert p.health(60) != H
    for _ in range(5):
        p.tick(100)
    assert p.check().health_state_type() == H


def test_heavy_flapping_unhealthy(pair):
    p = pair()
    for _ in range(3):
        p.tick(10, down=["chip0/ici0"])
        p.tick(10)
    cr = p.check()
    assert cr.health_state_type() == U and "flapped" in cr.summary()


def test_crc_degraded(pair):
    p = pair()
    p.now[0] = 1000.0
    p.snap({}, ts=900.0)
    p.snap({"chip0/ici0": 500}, ts=950.0)
    cr = p.check()
    assert cr.health_state_type() == D and "CRC" in cr.summary()


def test_v5p_host_expected_link_count(pair):
    p = pair(accel="v5p-256")
    assert p.check().extra_info["links_expected"] == "24"  # 4 GPUs x 6 links


def test_measured_links_carry_no_inventory_suffix(pair):
    assert "inventory-derived" not in pair().check().summary()


def test_expected_links_override_and_high_water_mark(pair):
    p = pair()
    p.check()
    p.both(lambda c: setattr(c, "expected_links", 40))
    cr = p.check()
    assert cr.health_state_type() == U and "8 link(s) unreported" in cr.summary()
    p.both(lambda c: setattr(c, "expected_links", 0))
    assert p.check().health_state_type() == H
    assert p.port._metadata.get("nvlink_max_links_seen") == "32"


# -- tests/test_ici_sticky_scenarios.py -----------------------------------------------

def test_full_lifecycle_redrop_is_fresh_incident(pair):
    p = pair()
    assert p.health() == H
    assert p.health(down=["chip0/ici0"]) == U
    assert p.health() != H
    p.set_healthy()
    assert p.health() == H
    assert p.health(down=["chip0/ici0"]) == U
    assert len([e for e in p.port.events(0) if e.name == "ici_link_down"]) == 2


def test_set_healthy_while_still_down_keeps_alarming(pair):
    p = pair()
    assert p.health(down=["chip0/ici1"]) == U
    p.set_healthy()
    assert p.health(down=["chip0/ici1"]) == U


def test_multiple_set_healthy_cycles(pair):
    p = pair()
    for _ in range(3):
        assert p.health(down=["chip1/ici2"]) == U
        assert p.health() != H
        p.set_healthy()
        assert p.health() == H


def test_auto_clear_reset_by_new_flap(pair):
    p = pair(auto_clear=300.0)
    p.health(10, down=["chip0/ici0"])
    p.health(10)
    assert p.health(100) != H
    p.health(10, down=["chip0/ici0"])
    p.health(10)
    assert p.health(100) != H
    assert p.health(100) != H
    assert p.health(150) == H


def test_auto_clear_does_not_clear_current_down(pair):
    p = pair(auto_clear=60.0)
    p.health(down=["chip0/ici0"])
    for _ in range(10):
        assert p.health(down=["chip0/ici0"]) == U


def test_sticky_forever_when_auto_clear_disabled(pair):
    p = pair()
    p.health(down=["chip0/ici0"])
    p.health()
    for _ in range(20):
        assert p.health(120) != H


def test_drop_ages_out_of_scan_window(pair):
    p = pair()
    p.both(lambda c: setattr(c, "scan_window", 600.0))
    p.health(down=["chip0/ici0"])
    p.health()
    assert p.health() != H
    for _ in range(8):
        p.health(120)
    assert p.health() == H


def test_counter_reset_across_reboot_no_false_alarm(pair):
    p = pair()
    p.snap({"chip0/ici0": 5000}, p.now[0] - 300)
    p.snap({"chip0/ici0": 5010}, p.now[0] - 200)
    p.snap({"chip0/ici0": 3}, p.now[0] - 100)
    assert p.port.store.scan(600.0).links["gpu0/nvlink0"].crc_delta == 10
    assert p.health() == H


def test_counter_reset_then_real_burst_still_alarms(pair):
    p = pair()
    p.both(lambda c: setattr(c, "crc_delta_degraded", 100))
    p.snap({"chip0/ici0": 9000}, p.now[0] - 300)
    p.snap({"chip0/ici0": 0}, p.now[0] - 200)
    p.snap({"chip0/ici0": 500}, p.now[0] - 100)
    cr = p.tick()
    assert cr.health_state_type() == D and "CRC" in cr.reason


def test_tombstoned_link_not_reported_as_down_forever(pair):
    p = pair()
    p.health(down=["chip0/ici0"])
    p.tombstone("chip0/ici0", ts=p.now[0] + 1)
    res = p.port.store.scan(600.0)
    assert "gpu0/nvlink0" not in res.links and "gpu0/nvlink1" in res.links


def test_per_link_tombstone_leaves_others_sticky(pair):
    p = pair()
    p.health(down=["chip0/ici0", "chip1/ici1"])
    p.health()
    p.tombstone("chip0/ici0", ts=p.now[0] + 1)
    cr = p.tick()
    assert cr.health_state_type() != H
    assert "gpu1/nvlink1" in cr.reason and "gpu0/nvlink0" not in cr.reason


def test_heavy_flapper_dominates_light_flapper(pair):
    p = pair()
    for _ in range(3):
        p.health(10, down=["chip0/ici0"])
        p.health(10)
    p.health(10, down=["chip1/ici3"])
    p.health(10)
    cr = p.tick(10)
    assert cr.health_state_type() == U
    assert "gpu0/nvlink0" in cr.reason and "gpu1/nvlink3" in cr.reason


def test_light_flappers_only_degraded(pair):
    p = pair()
    p.health(10, down=["chip0/ici2"])
    p.health(10)
    assert p.health(10) == D


# -- tests/test_ici_adaptive.py ----------------------------------------------------------

def test_fast_poll_constants_are_the_reference_constants():
    assert port_nvlink.DEFAULT_FAST_POLL_INTERVAL == DEFAULT_FAST_POLL_INTERVAL
    assert port_nvlink.DEFAULT_SUSPICION_WINDOW == DEFAULT_SUSPICION_WINDOW
    assert GPUNVLinkComponent.POLL_INTERVAL == TPUICIComponent.POLL_INTERVAL == 60.0


def test_steady_state_uses_production_cadence(pair):
    p = pair(accel="v5e-4", start=1000.0)
    assert p.port.poll_interval() == p.ref.poll_interval() == 60.0


def test_suspicion_opens_fast_window_and_decays(pair):
    p = pair(accel="v5e-4", start=1000.0)
    p.ref.raise_suspicion("tpu_ici_link_down")
    p.port.raise_suspicion(KMSG["tpu_ici_link_down"])
    assert p.port.poll_interval() == p.ref.poll_interval() == DEFAULT_FAST_POLL_INTERVAL
    p.now[0] += DEFAULT_SUSPICION_WINDOW - 1
    assert p.port.poll_interval() == DEFAULT_FAST_POLL_INTERVAL
    p.now[0] += 2
    assert p.port.poll_interval() == p.ref.poll_interval() == 60.0


def test_sample_delta_extends_window(pair):
    p = pair(accel="v5e-4", start=1000.0)
    p.check(once=True)
    assert p.port.poll_interval() == 60.0
    r = p.tick(60, down=["chip1/ici2"], once=True)
    assert r.health == U and r.extra_info["poll_mode"] == "fast"
    assert p.port.poll_interval() == DEFAULT_FAST_POLL_INTERVAL
    r2 = p.tick(DEFAULT_SUSPICION_WINDOW + 1, down=["chip1/ici2"], once=True)
    assert r2.health == U and p.port.poll_interval() == 60.0


def _one_link(p, crc):
    p.ref.sampler.ici_links = lambda: [
        ICILinkSnapshot(chip_id=0, link_id=0, state=LinkState.UP, crc_errors=crc[0])]
    p.port.sampler.nvlink_links = lambda: [port_link(ln) for ln in p.ref.sampler.ici_links()]


def test_counter_step_is_suspicious(pair):
    p = pair(accel="v5e-4", start=1000.0)
    crc = [0]
    _one_link(p, crc)
    p.check(once=True)
    assert p.port.poll_interval() == 60.0
    crc[0] += 5
    p.tick(60, once=True)
    assert p.port.poll_interval() == DEFAULT_FAST_POLL_INTERVAL


def test_fabric_kmsg_listener_wiring(pair):
    p = pair(accel="v5e-4", start=1000.0)
    assert p.port._on_fabric_kmsg in p.port_inst.fabric_suspicion_listeners
    for listener in p.port_inst.fabric_suspicion_listeners:
        listener(KMSG["tpu_ici_link_down"])
    for listener in p.ref_inst.fabric_suspicion_listeners:
        listener("tpu_ici_link_down")
    assert p.port.poll_interval() == p.ref.poll_interval() == DEFAULT_FAST_POLL_INTERVAL


def test_non_fabric_kmsg_does_not_trigger(pair):
    p = pair(accel="v5e-4", start=1000.0)
    for listener in p.port_inst.fabric_suspicion_listeners:
        listener(KMSG["tpu_hbm_ecc_uncorrectable"])
    assert p.port.poll_interval() == 60.0


def test_counter_step_retrigger_respects_cooldown(pair):
    p = pair(accel="v5e-4", start=1000.0)
    crc = [0]
    _one_link(p, crc)
    p.check(once=True)
    crc[0] += 1
    p.tick(60, once=True)
    assert p.port.poll_interval() == DEFAULT_FAST_POLL_INTERVAL
    crc[0] += 1
    p.tick(DEFAULT_SUSPICION_WINDOW + 1, once=True)
    assert p.port.poll_interval() == 60.0
    crc[0] += 1
    p.tick(p.port.counter_retrigger_cooldown + 1, once=True)
    assert p.port.poll_interval() == DEFAULT_FAST_POLL_INTERVAL


def _rows(db):
    return db.query(f"SELECT COUNT(*) FROM {TABLE}")[0][0]


def test_fast_polls_throttle_store_writes(pair):
    p = pair(accel="v5e-4", start=1000.0)
    p.check(once=True)
    p.ref.raise_suspicion("tpu_ici_link_down")
    p.port.raise_suspicion(KMSG["tpu_ici_link_down"])
    rows0 = _rows(p.port_db)
    for _ in range(10):
        p.tick(1, once=True)
    assert _rows(p.port_db) == rows0
    p.tick(60, once=True)
    assert _rows(p.port_db) > rows0


def test_noisy_counter_fast_polls_do_not_write_per_poll(pair):
    p = pair(accel="v5e-4", start=1000.0)
    crc = [0]
    _one_link(p, crc)
    p.check(once=True)
    crc[0] += 1
    p.tick(60, once=True)
    rows0 = _rows(p.port_db)
    for _ in range(10):
        crc[0] += 1
        p.tick(1, once=True)
    assert _rows(p.port_db) == rows0


def test_set_healthy_invalidates_cached_scan(pair):
    p = pair(accel="v5e-4", start=1000.0)
    p.check(once=True)
    p.tick(60, down=["chip0/ici0"], once=True)
    assert p.tick(60, once=True).health != H
    p.set_healthy()
    assert p.port.last_health_states()[0].health == H


def test_close_removes_fabric_listener(pair):
    p = pair(accel="v5e-4", start=1000.0)
    assert p.port._on_fabric_kmsg in p.port_inst.fabric_suspicion_listeners
    p.port.close()
    assert p.port._on_fabric_kmsg not in p.port_inst.fabric_suspicion_listeners


def test_raise_suspicion_wakes_the_poller():
    """raise_suspicion pokes the poller (no thread is started here: the
    poke event is what a sleeping poller waits on)."""
    c = GPUNVLinkComponent(TpudInstance(gpu_instance=mirrored_mocks()[1]))
    assert not c._poke_event.is_set()
    c.raise_suspicion(KMSG["tpu_ici_link_down"])
    assert c._poke_event.is_set()
