"""The port's event-sourced health (gpud_tpu_torch/components/gpu/health_state.py)
against the reference's (gpud_tpu/components/tpu/health_state.py).

Both ``evolve_health``s read one shared synthetic catalog, monkeypatched
into each package's ``lookup``: entries with neutral names that carry the
reference entries' codes, thresholds, criticality, repair actions and
descriptions, so the two catalogs' different contents do not enter. Every
scenario of tests/test_health_state.py and tests/test_health_state_scenarios.py
runs through both; health, reason after the noun table, repair actions and
active-error counts must be equal."""

import dataclasses
import re

import pytest

import gpud_tpu.components.tpu.health_state as ref_hs
from gpud_tpu.api.v1.types import Event as RefEvent
from gpud_tpu.components.tpu import catalog as ref_catalog

import gpud_tpu_torch.components.gpu.health_state as hs
from gpud_tpu_torch.api.v1.types import Event, HealthStateType, RepairActionType
from gpud_tpu_torch.components.gpu.catalog import CatalogEntry

from torch_parity import actions, nouns

# neutral name of each reference entry the scenarios use
SYNTHETIC = {
    "tpu_driver_timeout": "err_reboot_2",
    "tpu_hbm_ecc_uncorrectable": "err_reboot_hw_1",
    "tpu_hbm_ecc_correctable": "warn_ignore",
    "tpu_ici_link_down": "err_reboot_hw_2",
    "tpu_ici_cable_fault": "err_hw_0",
    "tpu_chip_lost": "err_lost_2",
    "tpu_power_fault": "err_hw_1",
    "tpu_chip_reset_required": "err_reboot_3",
    "tpu_runtime_fatal": "err_app_2",
}


@pytest.fixture(autouse=True)
def synthetic_catalog(monkeypatch):
    ref_entries, port_entries = {}, {}
    for ref_name, name in SYNTHETIC.items():
        e = ref_catalog.lookup(ref_name)
        ref_entries[name] = dataclasses.replace(e, name=name)
        port_entries[name] = CatalogEntry(
            code=e.code, name=name, pattern=e.pattern, event_type=e.event_type,
            description=nouns(e.description), repair_actions=tuple(actions(e.repair_actions)),
            reboot_threshold=e.reboot_threshold, critical=e.critical)
    monkeypatch.setattr(ref_hs, "lookup", ref_entries.get)
    monkeypatch.setattr(hs, "lookup", port_entries.get)


def _port_event(ev: RefEvent) -> Event:
    extra = {("gpu" if k == "chip" else k): v for k, v in (ev.extra_info or {}).items()}
    return Event(component=ev.component, time=ev.time, name=ev.name, type=ev.type,
                 message=re.sub(r"accel(\d+)", r"gpu\1", ev.message or ""), extra_info=extra)


def both(events, overrides=None):
    """Both packages' verdicts on the same history; returns the port's."""
    ref = ref_hs.evolve_health(events, overrides)
    port = hs.evolve_health([_port_event(e) for e in events], overrides)
    assert port.health == ref.health
    assert port.reason == nouns(ref.reason)
    if ref.suggested_actions is None:
        assert port.suggested_actions is None
    else:
        assert port.suggested_actions.repair_actions == actions(ref.suggested_actions.repair_actions)
        assert port.suggested_actions.description == nouns(ref.suggested_actions.description)
    assert port.active_errors == {nouns(k): v for k, v in ref.active_errors.items()}
    return port


def _err(t, name, chip=None, extra=True):
    name = SYNTHETIC.get(name, name)
    if chip is None:
        return RefEvent(time=t, name=name, type="Fatal", message=name)
    return RefEvent(time=t, name=name, type="Fatal", message=f"accel{chip}: {name}",
                    extra_info={"chip": str(chip)} if extra else {})


def _warn(t, name):
    return RefEvent(time=t, name=SYNTHETIC[name], type="Warning")


def _reboot(t):
    return RefEvent(time=t, name="reboot", type="Warning", message="boot")


def _sh(t):
    return RefEvent(time=t, name="SetHealthy", type="Info", message="op")


def _flapping():
    events, t = [], 0
    for _ in range(3):
        events.append(_err(t, "tpu_chip_lost"))
        t += 10
        events.append(_reboot(t))
        t += 10
    return events + [_err(t, "tpu_chip_lost")]


HD = "tpu_driver_timeout"
ECC = "tpu_hbm_ecc_uncorrectable"

SCENARIOS = {
    # tests/test_health_state.py
    "no events": [],
    "first occurrence": [_err(10, HD)],
    "reboot clears": [_err(10, HD), _reboot(20)],
    "recurrence below threshold": [_err(10, HD), _reboot(20), _err(30, HD)],
    "escalation after threshold": [_err(10, HD), _reboot(20), _err(30, HD), _reboot(40),
                                   _err(50, HD)],
    "threshold-1 escalates after one reboot": [_err(10, ECC), _reboot(20), _err(30, ECC)],
    "set healthy clears": [_err(10, ECC), _reboot(20), _err(30, ECC), _sh(40)],
    "new error after set healthy": [_err(10, ECC), _reboot(20), _err(30, ECC), _sh(40),
                                    _err(50, ECC)],
    "non-critical is degraded only": [_warn(10, "tpu_hbm_ecc_correctable")],
    "multiple errors merge": [_err(10, "tpu_ici_link_down"), _err(20, ECC)],
    "unknown names ignored": [RefEvent(time=10, name="not-in-catalog", type="Fatal")],
    "out of order sorted": [_err(50, HD), _reboot(40), _err(30, HD), _reboot(20),
                            _err(10, HD)],
    # tests/test_health_state_scenarios.py
    "one cleared, one recurring": [_err(10, HD), _err(20, ECC), _reboot(30), _err(40, ECC)],
    "double reboot without recurrence": [_err(10, "tpu_chip_lost"), _reboot(20),
                                         _reboot(30)],
    "flapping over many reboots": _flapping(),
    "set healthy midstream": [_err(10, ECC), _reboot(20), _err(30, ECC), _sh(40),
                              _err(50, ECC)],
    "non-critical and critical mix": [_warn(10, "tpu_hbm_ecc_correctable"),
                                      _err(20, "tpu_ici_cable_fault"),
                                      _warn(30, "tpu_hbm_ecc_correctable")],
    "burst of one error": [_err(10 + i, HD) for i in range(20)],
    "burst then reboot": [_err(10 + i, HD) for i in range(20)] + [_reboot(100)],
    "reboot before any error": [_reboot(5), _err(10, "tpu_power_fault")],
    "simultaneous timestamps": [_err(10.0, "tpu_ici_link_down"), _reboot(10.0),
                                _err(10.0, "tpu_ici_link_down")],
    "attribution from extra_info beats message": [
        RefEvent(time=100, name=SYNTHETIC["tpu_chip_lost"], type="Fatal",
                 message="accel7: device lost", extra_info={"chip": "2"})],
    "attribution from the message": [_err(100, "tpu_chip_lost", chip=7, extra=False)],
    "mixed chipless and chipped": [_err(100, HD, chip=0), _err(110, HD), _reboot(200),
                                   _err(300, HD, chip=0)],
    "set healthy resets per-chip escalation": [
        _err(100, "tpu_chip_lost", 3), _reboot(200), _err(300, "tpu_chip_lost", 3),
        _reboot(400), _err(500, "tpu_chip_lost", 3), _sh(600), _err(700, "tpu_chip_lost", 3)],
    # tests/test_catalog_organic.py (per-chip tracks)
    "two chips escalate independently": [
        _err(100, "tpu_chip_lost", 0), _reboot(200), _err(300, "tpu_chip_lost", 0),
        _reboot(400), _err(500, "tpu_chip_lost", 0), _err(550, "tpu_chip_lost", 1)],
    "reboot resolves only the non-recurring chip": [
        _err(100, "tpu_chip_lost", 0), _err(110, "tpu_chip_lost", 1), _reboot(200),
        _err(300, "tpu_chip_lost", 0)],
    "chipless events share one track": [_err(100, "tpu_runtime_fatal"),
                                        _err(200, "tpu_runtime_fatal")],
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_matches_the_reference(scenario):
    both(SCENARIOS[scenario])


OVERRIDES = {
    "tightened threshold": ([_err(100, "tpu_chip_reset_required"), _reboot(200),
                             _err(300, "tpu_chip_reset_required")],
                            {"err_reboot_3": 1}),
    "threshold zero disables escalation": ([_err(100, ECC), _reboot(200), _err(300, ECC),
                                            _reboot(400), _err(500, ECC)],
                                           {"err_reboot_hw_1": 0}),
}


@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_threshold_overrides_match_the_reference(case):
    events, overrides = OVERRIDES[case]
    both(events)
    both(events, overrides)


def test_the_port_names_gpus_in_its_reasons():
    out = both(SCENARIOS["two chips escalate independently"])
    assert "err_lost_2(GPU 0) recurred after 2 reboot(s)" in out.reason
    assert out.active_errors == {"err_lost_2(GPU 0)": 3, "err_lost_2(GPU 1)": 1}
    assert out.suggested_actions.repair_actions == [RepairActionType.HARDWARE_INSPECTION]
    assert both([]).reason == "no GPU errors observed"
    assert both(SCENARIOS["reboot clears"]).reason == "previous GPU errors cleared by reboot"


def test_the_app_action_is_the_gpus():
    out = both([_err(100, "tpu_runtime_fatal")])
    assert out.health == HealthStateType.UNHEALTHY
    assert out.suggested_actions.repair_actions == [RepairActionType.CHECK_USER_APP_AND_GPU]


def test_attribution_reads_gpu_tokens_and_extra_info():
    assert hs._event_gpu(Event(name="x", message="GPU-ERR: x gpu=5")) == 5
    assert hs._event_gpu(Event(name="x", message="gpu3: fault")) == 3
    assert hs._event_gpu(Event(name="x", message="m", extra_info={"gpu": "6"})) == 6
    assert hs._event_gpu(Event(name="x", message="m", extra_info={"gpu": "bad"})) is None
    # an Xid line's PCI address needs the host's map, which the matcher applied
    assert hs._event_gpu(Event(name="x", message="NVRM: Xid (PCI:0000:18:00): 79,")) is None
