"""Parity of the port's GPU components (gpud_tpu_torch/components/gpu/) with
the reference's TPU ones (gpud_tpu/components/tpu/).

Both packages' components run on the same telemetry and devices under the
same faults: the reference's on its ``MockBackend`` (or a stubbed sampler),
the port's on a ``MirrorInstance`` that reports the same values through the
field table in ``tests/torch_parity.py``. Health, repair actions, event names
and types, gauge values and extra-info values must be equal; reasons,
descriptions and event messages must be equal after the noun table
(``NOUNS`` there). The cases are those of ``tests/test_components_tpu.py``
and ``tests/test_tpu_threshold_matrix.py``, each run through both packages.
"""

import pytest

from gpud_tpu.components.base import TpudInstance as RefTpud
from gpud_tpu.components.tpu.chip_counts import TPUChipCountsComponent
from gpud_tpu.components.tpu.hbm import TPUHbmComponent
from gpud_tpu.components.tpu.power import TPUPowerComponent
from gpud_tpu.components.tpu.temperature import (
    DEFAULT_DEGRADED_C,
    DEFAULT_UNHEALTHY_C,
    TPUTemperatureComponent,
)
from gpud_tpu.eventstore import EventStore as RefEventStore
from gpud_tpu.sqlite import DB as RefDB
from gpud_tpu.tpu.instance import InjectedInstance as RefInjected
from gpud_tpu.tpu.instance import TPUChipTelemetry

from gpud_tpu_torch.api.v1.types import HealthStateType, RepairActionType
from gpud_tpu_torch.components.base import TpudInstance
from gpud_tpu_torch.components.gpu import temperature as port_temperature
from gpud_tpu_torch.components.gpu.gpu_counts import GPUCountsComponent
from gpud_tpu_torch.components.gpu.memory import GPUMemoryComponent
from gpud_tpu_torch.components.gpu.power import GPUPowerComponent
from gpud_tpu_torch.components.gpu.temperature import GPUTemperatureComponent
from gpud_tpu_torch.eventstore import EventStore
from gpud_tpu_torch.gpu.instance import InjectedInstance
from gpud_tpu_torch.sqlite import DB

from torch_parity import (
    ACCEL,
    assert_events_parity,
    assert_gauges_parity,
    assert_result_parity,
    injectors,
    mirrored_mocks,
    port_telemetry,
)

PAIRS = {
    "temperature": (TPUTemperatureComponent, GPUTemperatureComponent),
    "power": (TPUPowerComponent, GPUPowerComponent),
    "memory": (TPUHbmComponent, GPUMemoryComponent),
    "counts": (TPUChipCountsComponent, GPUCountsComponent),
}
CLOCK = 1_000_000.0


class Pair:
    """One reference component and its port over the same host."""

    def __init__(self, kind, tmp_path=None, accel="v5e-8", faults=None, clock=None):
        self.clock = clock or [CLOCK]
        ref_cls, port_cls = PAIRS[kind]
        ref_tpu, port_gpu = mirrored_mocks(accel, self.clock)
        self.ref_inj, self.port_inj = injectors(**(faults or {}))
        if faults:
            ref_tpu = RefInjected(ref_tpu, self.ref_inj)
            port_gpu = InjectedInstance(port_gpu, self.port_inj)
        self.dbs = []
        ref_es = port_es = None
        if tmp_path is not None:
            self.dbs = [RefDB(str(tmp_path / "ref.db")), DB(str(tmp_path / "port.db"))]
            ref_es, port_es = RefEventStore(self.dbs[0]), EventStore(self.dbs[1])
        self.ref = ref_cls(RefTpud(tpu_instance=ref_tpu, event_store=ref_es,
                                   failure_injector=self.ref_inj))
        self.port = port_cls(TpudInstance(gpu_instance=port_gpu, event_store=port_es,
                                          failure_injector=self.port_inj))
        for c in (self.ref, self.port):
            c.time_now_fn = lambda: self.clock[0]
            if getattr(c, "sampler", None) is not None:
                c.sampler.time_now_fn = lambda: self.clock[0]
        self.accel = (accel, ACCEL[accel])

    def stub_telemetry(self, tel):
        """Both components read ``tel`` (reference telemetry objects)."""
        self.ref.sampler.telemetry = lambda: tel
        self.port.sampler.telemetry = lambda: {c: port_telemetry(t) for c, t in tel.items()}

    def check(self, once=False):
        r = self.ref.check_once() if once else self.ref.check()
        p = self.port.check_once() if once else self.port.check()
        assert_result_parity(r, p, *self.accel)
        assert_events_parity(self.ref.events(0), self.port.events(0))
        return r, p

    def close(self):
        for db in self.dbs:
            db.close()


@pytest.fixture
def pairs(tmp_path):
    """Makes ``Pair``s; ``db=True`` gives each side an event store."""
    made = []

    def make(kind, db=False, **kw):
        sub = None
        if db:
            sub = tmp_path / f"pair{len(made)}"
            sub.mkdir()
        made.append(Pair(kind, sub, **kw))
        return made[-1]

    yield make
    for p in made:
        p.close()


FAULTS = {
    "none": {},
    "thermal chip 2": {"chip_ids_thermal_slowdown": [2]},
    "ECC pending chip 0": {"chip_ids_hbm_ecc_pending": [0]},
    "ECC pending chips 1, 5": {"chip_ids_hbm_ecc_pending": [1, 5]},
    "lost chip 3": {"chip_ids_lost": [3]},
    "reset chip 1": {"chip_ids_requires_reset": [1]},
    "enumeration error": {"tpu_enumeration_error": True},
    "product override": {"product_name_override": "TPU v6e"},
    "lost, thermal and ECC together": {"chip_ids_lost": [4], "chip_ids_thermal_slowdown": [6],
                                       "chip_ids_hbm_ecc_pending": [7]},
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_component_parity_under_each_fault(pairs, kind, fault):
    p = pairs(kind, faults=FAULTS[fault], db=True)
    assert p.ref.is_supported() == p.port.is_supported()
    if not p.ref.is_supported():
        return
    r, _ = p.check()
    p.clock[0] += 60.0
    p.check()  # a second poll: dedupe, duty history
    chips = set(p.ref.tpu.devices()) if p.ref.tpu.tpu_lib_exists() else set()
    assert_gauges_parity(r.component_name(), chips)


@pytest.mark.parametrize("accel", ["v5e-8", "v5e-4", "v5p-256"])
@pytest.mark.parametrize("kind", sorted(PAIRS))
def test_component_parity_across_host_sizes(pairs, kind, accel):
    p = pairs(kind, accel=accel)
    r, _ = p.check()
    assert_gauges_parity(r.component_name(), set(p.ref.tpu.devices()))


# -- tests/test_components_tpu.py, through both packages ----------------------

def test_temperature_healthy(pairs):
    p = pairs("temperature")
    assert p.port.is_supported()
    _, cr = p.check()
    assert cr.health_state_type() == HealthStateType.HEALTHY
    assert "max temp" in cr.summary()


def test_temperature_thermal_slowdown(pairs):
    p = pairs("temperature", faults={"chip_ids_thermal_slowdown": [2]})
    _, cr = p.check()
    assert cr.health_state_type() == HealthStateType.UNHEALTHY
    assert "GPU(s) [2]" in cr.summary()
    assert RepairActionType.HARDWARE_INSPECTION in cr.suggested_actions.repair_actions


def test_memory_healthy_and_ecc(pairs):
    p = pairs("memory", db=True)
    assert p.check()[1].health_state_type() == HealthStateType.HEALTHY
    p2 = pairs("memory", faults={"chip_ids_hbm_ecc_pending": [0]}, db=True)
    _, cr = p2.check()
    assert cr.health_state_type() == HealthStateType.UNHEALTHY
    assert RepairActionType.REBOOT_SYSTEM in cr.suggested_actions.repair_actions
    assert any(e.name == "hbm_ecc_uncorrectable" for e in p2.port.events(0))


def test_power_metrics(pairs):
    p = pairs("power")
    _, cr = p.check()
    assert cr.health_state_type() == HealthStateType.HEALTHY
    assert "total draw" in cr.summary()
    assert_gauges_parity("accelerator-tpu-power", set(range(8)))


def test_counts_all_present(pairs):
    _, cr = pairs("counts").check()
    assert cr.health_state_type() == HealthStateType.HEALTHY
    assert cr.extra_info["found"] == "8" and cr.extra_info["expected"] == "8"


def test_counts_lost_gpu(pairs):
    _, cr = pairs("counts", faults={"chip_ids_lost": [3]}).check()
    assert cr.health_state_type() == HealthStateType.UNHEALTHY
    assert "lost GPU(s) [3]" in cr.summary()


def test_counts_requires_reset(pairs):
    _, cr = pairs("counts", faults={"chip_ids_requires_reset": [1]}).check()
    assert cr.health_state_type() == HealthStateType.UNHEALTHY
    assert "require reset" in cr.summary()


def test_counts_enumeration_error(pairs):
    _, cr = pairs("counts", faults={"tpu_enumeration_error": True}).check()
    assert cr.health_state_type() == HealthStateType.UNHEALTHY
    assert "injected" in cr.summary()


def test_counts_expected_from_config(pairs):
    """The updateConfig expectation: a host expected to hold 9."""

    class Cfg:
        expected_chip_count = 9
        expected_gpu_count = 9

    p = pairs("counts")
    for c in (p.ref, p.port):
        c.expected_count = Cfg.expected_chip_count
    _, cr = p.check()
    assert cr.health_state_type() == HealthStateType.UNHEALTHY
    assert "found 8/9 GPUs" in cr.summary()


def test_power_duty_cycle_sampled_average(pairs):
    """Duty cycle averaged over a time-based window: triggered checks inside
    the sampler TTL add no duplicate sample, and samples age out."""
    p = pairs("power")
    duties = {"ref": iter([10.0, 20.0, 30.0, 40.0, 99.0]),
              "port": iter([10.0, 20.0, 30.0, 40.0, 99.0])}
    for side, c in (("ref", p.ref), ("port", p.port)):
        c.sampler.ttl = 10.0
        c.sampling_window_seconds = 150.0
        real = c.sampler.instance.telemetry

        def fake(real=real, it=duties[side]):
            d = next(it)
            tel = real()
            for t in tel.values():
                t.duty_cycle_pct = d
            return tel

        c.sampler.instance.telemetry = fake
    for _ in range(3):
        p.check()
        p.clock[0] += 60.0
    p.clock[0] -= 55.0  # a triggered check 5 s after the third poll
    p.check()
    for c in (p.ref, p.port):
        assert [v for _ts, v in c._duty_hist[0]] == [10.0, 20.0, 30.0]
    p.clock[0] += 55.0
    p.check()
    for c in (p.ref, p.port):
        assert [v for _ts, v in c._duty_hist[0]] == [20.0, 30.0, 40.0]
    g = assert_gauges_parity("accelerator-tpu-power", set(range(8)))
    avg = [v for (n, labels), v in g.items()
           if n == "tpud_gpu_duty_cycle_avg_percent" and ("gpu", "0") in labels]
    assert avg and abs(avg[0] - 30.0) < 1e-6


# -- tests/test_tpu_threshold_matrix.py, through both packages -----------------

def _tel(per_chip):
    out = {}
    for cid, fields in per_chip.items():
        t = TPUChipTelemetry(chip_id=cid, hbm_total_bytes=16 << 30)
        for k, v in fields.items():
            setattr(t, k, v)
        out[cid] = t
    return out


TEMP_MATRIX = [
    (45.0, False, HealthStateType.HEALTHY),
    (DEFAULT_DEGRADED_C - 0.1, False, HealthStateType.HEALTHY),
    (DEFAULT_DEGRADED_C, False, HealthStateType.DEGRADED),
    (DEFAULT_UNHEALTHY_C - 0.1, False, HealthStateType.DEGRADED),
    (DEFAULT_UNHEALTHY_C, False, HealthStateType.UNHEALTHY),
    (60.0, True, HealthStateType.UNHEALTHY),
]


def test_thresholds_are_the_reference_thresholds():
    assert port_temperature.DEFAULT_DEGRADED_C == DEFAULT_DEGRADED_C
    assert port_temperature.DEFAULT_UNHEALTHY_C == DEFAULT_UNHEALTHY_C


@pytest.mark.parametrize("worst,slowdown,expected", TEMP_MATRIX)
def test_temperature_threshold_matrix(pairs, worst, slowdown, expected):
    p = pairs("temperature")
    p.stub_telemetry(_tel({0: {"temperature_c": 40.0},
                           1: {"temperature_c": worst, "thermal_slowdown": slowdown}}))
    _, r = p.check(once=True)
    assert r.health == expected, (worst, slowdown, r.reason)
    if expected == HealthStateType.UNHEALTHY:
        assert "1" in r.reason
        assert RepairActionType.HARDWARE_INSPECTION in r.suggested_actions.repair_actions
    assert_gauges_parity("accelerator-tpu-temperature", {0, 1})


def test_temperature_threshold_overrides(pairs):
    p = pairs("temperature")
    p.stub_telemetry(_tel({0: {"temperature_c": 70.0}}))
    for c in (p.ref, p.port):
        c.degraded_c, c.unhealthy_c = 60.0, 69.0
    assert p.check(once=True)[1].health == HealthStateType.UNHEALTHY


def test_temperature_extra_info_per_gpu(pairs):
    p = pairs("temperature")
    p.stub_telemetry(_tel({0: {"temperature_c": 41.5}, 3: {"temperature_c": 44.25}}))
    _, r = p.check(once=True)
    assert r.extra_info["gpu0_temp_c"] == "41.5"
    assert r.extra_info["gpu3_temp_c"] == "44.2"


@pytest.mark.parametrize("fields, health", [
    ({0: {"hbm_ecc_pending": True}}, HealthStateType.UNHEALTHY),
    ({2: {"hbm_ecc_uncorrectable": 1}}, HealthStateType.UNHEALTHY),
    ({0: {"hbm_ecc_correctable": 500}}, HealthStateType.HEALTHY),
    ({0: {"hbm_used_bytes": 8 << 30}}, HealthStateType.HEALTHY),
], ids=["pending flag alone", "uncorrectable count alone", "correctable only", "usage"])
def test_memory_matrix(pairs, fields, health):
    p = pairs("memory")
    p.stub_telemetry(_tel(fields))
    _, r = p.check(once=True)
    assert r.health == health
    if health == HealthStateType.UNHEALTHY:
        assert RepairActionType.REBOOT_SYSTEM in r.suggested_actions.repair_actions
        assert str(next(iter(fields))) in r.reason
    assert_gauges_parity("accelerator-tpu-hbm", set(fields))


def test_memory_usage_pct_reported(pairs):
    p = pairs("memory")
    p.stub_telemetry(_tel({0: {"hbm_used_bytes": 8 << 30}}))
    assert p.check(once=True)[1].extra_info["gpu0_hbm_used_pct"] == "50.0"


def test_memory_event_recorded_once_while_pending(pairs):
    p = pairs("memory", db=True)
    p.stub_telemetry(_tel({1: {"hbm_ecc_pending": True}}))
    p.check(once=True)
    p.check(once=True)
    evs = [e for e in p.port.events(0) if e.name == "hbm_ecc_uncorrectable"]
    assert len(evs) == 1
    assert "GPU(s) [1]" in evs[0].message


def test_memory_zero_total_no_division(pairs):
    p = pairs("memory")
    p.stub_telemetry({0: TPUChipTelemetry(chip_id=0, hbm_total_bytes=0, hbm_used_bytes=0)})
    _, r = p.check(once=True)
    assert r.health == HealthStateType.HEALTHY
    assert "gpu0_hbm_used_pct" not in r.extra_info
