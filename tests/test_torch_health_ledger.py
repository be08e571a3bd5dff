"""Parity of the port's health ledger (gpud_tpu_torch/health_history.py) with
gpud_tpu's: both tables' schemas; the rows of both after the same
observations; history, availability, MTTR/MTBF, flapping and its warning
events, the summary and event correlation; the boot reconcile after a
reopen; the purger. With and without the write-behind writer, on an
injected clock (``observe(now=...)``, ``time_now_fn``). The cases of the
reference's tests/test_health_ledger.py, then seeded observation streams."""

import numpy as np
import pytest

from torch_daemon_parity import PKGS, REF, PORT, Clock, rows, schema

H, D, U, I = "Healthy", "Degraded", "Unhealthy", "Initializing"
TABLES = ("tpud_health_transitions_v0_1", "tpud_health_last_state_v0_1")


def ledger(pkg, db, clock, writer=None, **kw):
    es = pkg.eventstore.EventStore(db, writer=writer)
    led = pkg.health_history.HealthLedger(db, event_store=es, writer=writer, **kw)
    led.time_now_fn = clock
    return led, es


def dump(led, es, db, components, now):
    """Everything a reader can get out of a ledger, after the barrier."""
    led.flush()
    out = {
        "tables": [rows(db, t) for t in TABLES],
        "history": led.history(),
        "history_c0_limit2": led.history(component=components[0], limit=2),
        "availability": {c: led.availability(c, now=now) for c in components},
        "availability_all": led.availability_all(now=now),
        "mttr_mtbf": {c: led.mttr_mtbf(c) for c in components},
        "flapping": led.flapping_components(now=now),
        "summary": led.summary(now=now),
        "components": led.components(),
        "recent": {c: led.recent_transitions(c) for c in components},
        "last_state": {c: led.last_state(c) for c in components},
        "flap_events": sorted(
            (e.component, e.time, e.name, e.type, e.message, tuple(sorted(e.extra_info.items())))
            for c in components for e in es.bucket(c).get(0) if e.name == "health_flapping"),
    }
    return out


def run_both(tmp_path, scenario, with_writer):
    got = {}
    for pkg in PKGS:
        db = pkg.sqlite.DB(str(tmp_path / f"{pkg.name}.state"))
        w = pkg.writer.BatchWriter(db) if with_writer else None
        try:
            got[pkg.name] = scenario(pkg, db, w)
        finally:
            if w is not None:
                w.close()
            db.close()
    assert got["port"] == got["ref"]
    return got["port"]


WRITER = pytest.mark.parametrize("with_writer", [False, True], ids=["sync", "writer"])


def test_both_tables_are_the_reference_s(tmp_path):
    got = {}
    for pkg in PKGS:
        db = pkg.sqlite.DB(str(tmp_path / f"{pkg.name}.state"))
        pkg.health_history.HealthLedger(db)
        got[pkg.name] = {k: v for k, v in schema(db).items() if "health" in k}
        db.close()
    assert got["port"] == got["ref"]
    assert set(TABLES) <= set(got["port"])


@WRITER
def test_transitions_and_their_reasons(tmp_path, with_writer):
    def run(pkg, db, w):
        clock = Clock()
        led, es = ledger(pkg, db, clock, w)
        anns = [led.observe("c1", H, "ok")]
        for state, reason in ((H, "ok"), (U, "memory ecc"), (U, "still"), (H, "cleared"), (D, "")):
            clock.advance(60)
            anns.append(led.observe("c1", state, reason))
        anns.append(led.observe("c2", "", "empty means healthy", now=clock() + 1))
        return anns, dump(led, es, db, ["c1", "c2"], clock())
    anns, out = run_both(tmp_path, run, with_writer)
    assert [(t["from"], t["to"]) for t in out["history"]] == [(H, D), (U, H), (H, U)]


@WRITER
def test_restart_into_the_same_state_continues_the_episode(tmp_path, with_writer):
    def run(pkg, db, w):
        clock = Clock()
        led, es = ledger(pkg, db, clock, w)
        led.observe("c1", H)
        clock.advance(60)
        led.observe("c1", U, "down")
        led.flush()
        clock.advance(300)
        led2, es2 = ledger(pkg, db, clock, w)  # the restart
        led2.observe("c1", U, "still down")
        return dump(led2, es2, db, ["c1"], clock())
    out = run_both(tmp_path, run, with_writer)
    assert len(out["history"]) == 1 and out["last_state"]["c1"]["since"] == 1060.0


@WRITER
def test_restart_into_another_state_mints_exactly_one_transition(tmp_path, with_writer):
    def run(pkg, db, w):
        clock = Clock()
        led, es = ledger(pkg, db, clock, w)
        led.observe("c1", H)
        clock.advance(60)
        led.observe("c1", U, "down")
        led.flush()
        clock.advance(300)
        led2, es2 = ledger(pkg, db, clock, w)
        led2.observe("c1", H, "repaired while we were away")
        led2.observe("never-seen", D, "fresh")
        return dump(led2, es2, db, ["c1", "never-seen"], clock())
    out = run_both(tmp_path, run, with_writer)
    assert [(t["from"], t["to"]) for t in out["history"]] == [(U, H), (H, U)]


@WRITER
def test_flap_detection_and_its_rate_limited_warning(tmp_path, with_writer):
    def run(pkg, db, w):
        clock = Clock()
        led, es = ledger(pkg, db, clock, w, flap_threshold=3, flap_window_seconds=600.0,
                         flap_event_cooldown=600.0)
        anns = [led.observe("c1", H)]
        for i in range(1, 5):
            clock.advance(30)
            anns.append(led.observe("c1", (H, U)[i % 2]))
        clock.advance(601)
        for _ in range(3):
            clock.advance(10)
            anns.append(led.observe("c1", H))
            anns.append(led.observe("c1", U))
        flapping_now = led.is_flapping("c1")
        return anns, flapping_now, dump(led, es, db, ["c1"], clock())
    anns, flapping_now, out = run_both(tmp_path, run, with_writer)
    assert anns[3] == {"flapping": "true", "transitions_in_window": "3"}
    assert flapping_now and len(out["flap_events"]) == 2


@WRITER
def test_a_restart_mid_flap_still_detects_it(tmp_path, with_writer):
    def run(pkg, db, w):
        clock = Clock()
        led, _ = ledger(pkg, db, clock, w, flap_threshold=3)
        led.observe("c1", H)
        for s in (U, H):
            clock.advance(20)
            led.observe("c1", s)
        led.flush()
        clock.advance(20)
        led2, es2 = ledger(pkg, db, clock, w, flap_threshold=3)
        ann = led2.observe("c1", U)
        return ann, dump(led2, es2, db, ["c1"], clock())
    ann, _ = run_both(tmp_path, run, with_writer)
    assert ann["flapping"] == "true"


@WRITER
def test_availability_mttr_and_mtbf(tmp_path, with_writer):
    def run(pkg, db, w):
        clock = Clock(0.0)
        led, es = ledger(pkg, db, clock, w)
        for t, s in ((0, H), (100, U), (200, H), (500, U), (800, H), (900, D), (950, H)):
            clock.now = float(t)
            led.observe("c1", s)
        clock.now = 1000.0
        windows = [led.availability("c1", window_seconds=ws) for ws in (50.0, 450.0, 500.0, 1e4)]
        return windows, dump(led, es, db, ["c1"], clock())
    windows, out = run_both(tmp_path, run, with_writer)
    assert out["mttr_mtbf"]["c1"] == (200.0, 400.0)
    assert windows[3]["ratio"] == pytest.approx(550.0 / 1000.0)


@WRITER
def test_purge_drops_old_transitions_and_stale_last_rows(tmp_path, with_writer):
    def run(pkg, db, w):
        clock = Clock(0.0)
        led, es = ledger(pkg, db, clock, w, retention_seconds=1000)
        led.observe("old", H)
        clock.now = 10.0
        led.observe("old", U)
        clock.now = 5000.0
        led.observe("fresh", H)
        clock.advance(10)
        led.observe("fresh", U)
        led.purge_once()
        return dump(led, es, db, ["fresh"], clock())
    out = run_both(tmp_path, run, with_writer)
    assert out["components"] == ["fresh"] and len(out["history"]) == 1


@WRITER
def test_event_correlation_around_a_transition(tmp_path, with_writer):
    def run(pkg, db, w):
        clock = Clock()
        led, es = ledger(pkg, db, clock, w, correlation_window_seconds=60.0)
        led.observe("c1", H)
        clock.now = 1200.0
        for t, name in ((1190.0, "gpu_thermal_warning"), (500.0, "unrelated"), (1255.0, "after")):
            es.bucket("c1").insert(pkg.types.Event(
                component="c1", time=t, name=name, type="Warning", message=name))
        led.observe("c1", U, "overheated")
        return led.annotate_with_events(led.history()), \
            led.annotate_with_events(led.history(), window=-1.0)
    near, off = run_both(tmp_path, run, with_writer)
    assert [e["name"] for e in near[0]["events"]] == ["after", "gpu_thermal_warning"]
    assert off[0]["events"] == []


def test_annotations_ride_every_observe():
    for pkg in PKGS:
        db = pkg.sqlite.DB(":memory:")
        led, _ = ledger(pkg, db, Clock(), flap_threshold=2)
        led.set_annotation("c1", "predicted", "true")
        assert led.observe("c1", H) == {"predicted": "true"}
        led.clear_annotation("c1", "predicted")
        assert led.observe("c1", H) == {}


def test_the_ledger_s_metrics_have_the_reference_s_names():
    for attr in ("_g_state", "_c_transitions", "_c_state_seconds", "_g_availability",
                 "_g_mttr", "_g_mtbf", "_g_flapping", "_c_purged"):
        r, p = getattr(REF.health_history, attr), getattr(PORT.health_history, attr)
        assert (p.name, p.help_text) == (r.name, r.help_text), attr
    assert PORT.health_history.STATE_CODES == REF.health_history.STATE_CODES


@pytest.mark.parametrize("with_writer", [False, True], ids=["sync", "writer"])
@pytest.mark.parametrize("seed", range(6))
def test_a_seeded_observation_stream_gives_the_same_ledger(tmp_path, seed, with_writer):
    """Five components, 400 observations at seeded times, two restarts of
    the ledger over the same DB: every read and both tables equal."""
    rng = np.random.default_rng(seed)
    comps = [f"comp-{i}" for i in range(5)]
    steps = []
    t = 1_700_000_000.0
    for i in range(400):
        t += float(rng.exponential(40.0))
        c = comps[int(rng.integers(0, 5))]
        s = [H, H, H, U, D, I, ""][int(rng.integers(0, 7))]
        steps.append((c, s, f"r{int(rng.integers(0, 4))}", t, i in (150, 300)))

    def run(pkg, db, w):
        clock = Clock(t)
        led, es = ledger(pkg, db, clock, w, flap_threshold=3, flap_window_seconds=300.0)
        anns = []
        for c, s, reason, ts, restart in steps:
            if restart:
                led.flush()
                led, es = ledger(pkg, db, clock, w, flap_threshold=3, flap_window_seconds=300.0)
            anns.append(led.observe(c, s, reason, now=ts))
        return anns, dump(led, es, db, comps, t + 10.0)
    anns, out = run_both(tmp_path, run, with_writer)
    assert out["history"] and any(a.get("flapping") for a in anns)
