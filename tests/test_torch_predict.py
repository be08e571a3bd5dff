"""Parity of the port's predict plane (gpud_tpu_torch/predict/: features and
engine) with gpud_tpu's, on the cases of the reference's tests/test_predict.py.

Each case runs on both packages with the same inputs on an injected clock:
the feature extractors (EWMA + CUSUM changepoint, cadence, trajectory,
n-gram novelty), the noisy-OR fusion, the engine's hysteresis, its
warn/clear lifecycle, lead time and the predicted-action dry-run rows. Each
keeps the reference test's assertions and returns what it saw; the port's
observations must equal the reference's. Scores, EWMAs, CUSUMs and weights
are the same float arithmetic in both, so they are compared with ``==``."""

import math

import pytest

from torch_plane_parity import IDS, PKGS, Clock, both

W = ("latency", "cadence", "trajectory", "ngram", "fabric", "cooccur")


# -- fusion ------------------------------------------------------------------


def fuse_bounds(P):
    F = P.features
    assert F.fuse({}) == 0.0
    assert F.fuse({k: 0.0 for k in F.FEATURE_WEIGHTS}) == 0.0
    full = F.fuse({k: 1.0 for k in F.FEATURE_WEIGHTS})
    assert 0.0 < full < 1.0
    alone = {}
    for name, w in F.FEATURE_WEIGHTS.items():
        alone[name] = F.fuse({name: 1.0})
        assert alone[name] == pytest.approx(w)
    assert F.fuse({"latency": 1.0}) < 0.6
    return F.FEATURE_WEIGHTS, full, alone


def fuse_monotone(P):
    F = P.features
    base = {"latency": 0.3, "cadence": 0.4, "trajectory": 0.2, "ngram": 0.1}
    seen = [F.fuse(base)]
    for step in (0.5, 0.8, 1.0):
        seen.append(F.fuse({**base, "cadence": step}))
        assert seen[-1] >= seen[-2]
    assert F.fuse({"cadence": float("nan")}) == 0.0
    assert F.fuse({"cadence": 7.0}) == F.fuse({"cadence": 1.0})
    assert F.fuse({"cadence": -3.0}) == 0.0
    assert F.clamp01(float("nan")) == 0.0
    weighted = F.fuse(base, {"cadence": 0.1, "ngram": None})
    return seen, weighted, F.fuse({"unknown": 1.0})


# -- EWMA + latency changepoint ---------------------------------------------


def ewma_replay(P):
    series = [0.1, 0.12, 0.11, 0.13, 0.1, 0.5, 0.52]
    a, b = P.features.Ewma(alpha=0.3), P.features.Ewma(alpha=0.3)
    trace = []
    for x in series:
        a.update(x)
        b.update(x)
        trace.append((a.mean, a.var, a.n, a.z(0.2)))
    assert a.mean == b.mean and a.var == b.var
    assert a.z(0.11) < a.z(5.0)
    assert P.features.Ewma().z(99.0) == 0.0
    return trace


def latency_changepoint(P):
    d = P.features.LatencyDrift(warmup=5)
    total_sum, total_count = 0.0, 0
    for _ in range(12):
        total_sum += 0.010
        total_count += 1
        assert d.update(total_sum, total_count) == 0.0
    scores = []
    for _ in range(10):
        total_sum += 0.100
        total_count += 1
        scores.append(d.update(total_sum, total_count))
    assert scores[-1] > 0.5
    assert scores == sorted(scores)
    return scores, d.cusum, d.ewma.mean, d.ewma.var


def latency_holds_and_resets(P):
    d = P.features.LatencyDrift(warmup=2)
    total_sum, total_count = 0.0, 0
    for _ in range(8):
        total_sum += 0.010
        total_count += 1
        d.update(total_sum, total_count)
    for _ in range(6):
        total_sum += 0.200
        total_count += 1
        last = d.update(total_sum, total_count)
    assert last > 0.0
    assert d.update(total_sum, total_count) == last
    assert d.update(0.0, 0) == last
    assert d.update(total_sum - 1.0, total_count + 1) == 0.0
    return last


def latency_spike_forgiven(P):
    d = P.features.LatencyDrift(warmup=5)
    total_sum, total_count = 0.0, 0
    for _ in range(10):
        total_sum += 0.010
        total_count += 1
        d.update(total_sum, total_count)
    total_sum += 0.500
    total_count += 1
    spike = d.update(total_sum, total_count)
    calm = []
    for _ in range(6):
        total_sum += 0.010
        total_count += 1
        calm.append(d.update(total_sum, total_count))
    assert calm[-1] <= spike
    return spike, calm


# -- cadence / trajectory ----------------------------------------------------


def cadence(P):
    cs = P.features.cadence_score
    now, window = 1000.0, 600.0
    assert cs([], now, window, saturation=5) == 0.0
    assert cs([100.0], now, window, saturation=5) == 0.0
    old = cs([500.0, 550.0, 600.0], now, window, saturation=5)
    fresh = cs([900.0, 950.0, 990.0], now, window, saturation=5)
    assert old == pytest.approx(0.6) and fresh == pytest.approx(0.8)
    full = cs([now - i for i in range(20)], now, window)
    assert full == 1.0
    return old, fresh, full, cs([950.0], now, window, saturation=2)


def trajectory(P):
    ts = P.features.trajectory_score
    H = P.types.HealthStateType
    now, window = 1000.0, 600.0
    assert ts(H.DEGRADED, [], now, window) == 0.0
    assert ts(H.DEGRADED, [(100.0, H.HEALTHY, H.DEGRADED)], now, window) == 0.0
    assert ts(H.DEGRADED, [(950.0, H.HEALTHY, H.DEGRADED)], now, window) == 1.0
    s = ts(H.HEALTHY, [(950.0, H.HEALTHY, H.DEGRADED)], now, window)
    assert 0.0 < s <= 0.6
    assert s == pytest.approx(0.6 * math.exp(-50.0 / 150.0))
    assert ts(H.HEALTHY, [(990.0, H.DEGRADED, H.HEALTHY)], now, window) == 0.0
    return s, ts(H.UNHEALTHY, [(999.0, H.HEALTHY, H.UNHEALTHY)], now, window)


# -- n-gram novelty ----------------------------------------------------------


def ngram_watermark_and_decay(P):
    ng = P.features.NgramNovelty(hold_decay=0.5)
    first = ng.update([(10.0, "gpu_nvlink_down")])
    assert first > 0.0
    second = ng.update([(10.0, "gpu_nvlink_down")])
    assert second < first
    third = ng.update([(10.0, "gpu_nvlink_down"), (20.0, "gpu_memory_ecc_error")])
    assert third > second
    tail = [ng.update([]) for _ in range(30)]
    assert tail[-1] == 0.0
    return first, second, third, tail


def ngram_known_below_novel(P):
    a = P.features.NgramNovelty()
    a.update([(1.0, "x"), (2.0, "y")])
    for _ in range(40):
        a.update([])
    known = a.update([(100.0, "x"), (101.0, "y")])
    novel = P.features.NgramNovelty().update([(100.0, "x"), (101.0, "y")])
    assert known < novel
    return known, novel


def cooccurrence(P):
    F = P.features
    scores = {"a-1": 0.8, "a-2": 0.5, "b": 0.0}
    dev = {"l1": 0.9, "l2": 0.4, "l3": 0.7, "l4": 0.0}
    adj = {"l1": ["l2", "l3"], "l2": ["l1"], "l3": ["l1", "l4"], "l4": ["l3"]}
    return (F.peer_corroboration("a-1", scores, ["a-2", "b"]),
            F.neighbor_cooccurrence(dev, adj), F.neighbor_cooccurrence(dev, {}),
            F.neighbor_cooccurrence({"l1": 0.9}, {"l1": ["l9"]}))


FEATURE_CASES = {
    "fuse_bounds": fuse_bounds,
    "fuse_monotone": fuse_monotone,
    "ewma_replay": ewma_replay,
    "latency_changepoint": latency_changepoint,
    "latency_holds_and_resets": latency_holds_and_resets,
    "latency_spike_forgiven": latency_spike_forgiven,
    "cadence": cadence,
    "trajectory": trajectory,
    "ngram_watermark_and_decay": ngram_watermark_and_decay,
    "ngram_known_below_novel": ngram_known_below_novel,
    "cooccurrence": cooccurrence,
}


@pytest.mark.parametrize("case", FEATURE_CASES)
def test_features_are_the_reference_s(case):
    ref, port = both(FEATURE_CASES[case])
    assert port == ref


def test_the_weights_and_defaults_are_the_reference_s():
    from torch_plane_parity import PORT, REF
    assert PORT.features.FEATURE_WEIGHTS == REF.features.FEATURE_WEIGHTS
    assert set(PORT.features.FEATURE_WEIGHTS) == set(W)
    for name in ("DEFAULT_INTERVAL", "DEFAULT_THRESHOLD", "DEFAULT_HYSTERESIS",
                 "DEFAULT_ARM_TICKS", "DEFAULT_CLEAR_TICKS", "DEFAULT_WINDOW",
                 "DEFAULT_HISTORY_LIMIT", "DEFAULT_WARN_COOLDOWN",
                 "DEFAULT_PUBLISH_INTERVAL", "EVENT_NAME_PREDICTED"):
        assert getattr(PORT.engine, name) == getattr(REF.engine, name)


# -- engine: stubs -----------------------------------------------------------


class StubRegistry:
    def __init__(self, *names):
        self._names = list(names)

    def names(self):
        return list(self._names)


class StubLedger:
    flap_threshold = 5

    def __init__(self):
        self.transitions = []
        self.state = None
        self.annotations = {}

    def recent_transitions(self, component, limit=0):
        rows = list(self.transitions)
        return rows[-limit:] if limit else rows

    def last_state(self, component):
        return {"state": self.state, "since": 0.0, "last_seen": 0.0} if self.state else None

    def set_annotation(self, component, key, value):
        self.annotations.setdefault(component, {})[key] = value

    def clear_annotation(self, component, key):
        self.annotations.get(component, {}).pop(key, None)


class StubBucket:
    def __init__(self):
        self.events = []

    def get(self, since):
        return [e for e in self.events if e.time >= since]

    def insert(self, ev):
        self.events.append(ev)


class StubEventStore:
    def __init__(self):
        self.buckets = {}

    def bucket(self, name):
        return self.buckets.setdefault(name, StubBucket())


class StubRemediation:
    def __init__(self, audit):
        self.audit = audit


def engine(P, clock, scripted=None, monkeypatch=None, **kw):
    """An engine over stub collaborators; ``scripted`` replaces the fusion
    with a score sequence to drive the hysteresis directly."""
    kw.setdefault("registry", StubRegistry("c0"))
    kw.setdefault("ledger", StubLedger())
    kw.setdefault("event_store", StubEventStore())
    kw.setdefault("arm_ticks", 2)
    kw.setdefault("clear_ticks", 3)
    kw.setdefault("threshold", 0.6)
    kw.setdefault("hysteresis", 0.15)
    eng = P.predict.PredictEngine(**kw)
    eng.time_now_fn = clock
    if scripted is not None:
        it = iter(scripted)
        monkeypatch.setattr(P.engine, "fuse", lambda features, weights=None: next(it))
    return eng


def ticks(eng, clock, n):
    for _ in range(n):
        eng.tick_once()
        clock.advance(1.0)


def snap(eng):
    return eng.scores(history_limit=64)["components"].get("c0")


# -- engine: hysteresis no-flap property ------------------------------------


def dead_band(P, mp, tmp):
    clock = Clock()
    script = ([0.55, 0.50, 0.58, 0.46, 0.59, 0.55] + [0.70, 0.70]
              + [0.50, 0.46, 0.58, 0.55, 0.50, 0.59] + [0.30, 0.30, 0.30])
    eng = engine(P, clock, script, mp)
    events = []
    eng.on_publish = lambda body: events.append(body)
    ticks(eng, clock, 6)
    assert snap(eng)["armed"] is False
    ticks(eng, clock, 2)
    assert snap(eng)["armed"] is True
    ticks(eng, clock, 6)
    assert snap(eng)["armed"] is True
    ticks(eng, clock, 3)
    s = snap(eng)
    assert s["armed"] is False and s["warnings"] == 1
    kinds = [b["event"] for b in events]
    assert kinds.count("warn") == 1 and kinds.count("clear") == 1
    return s, events


def single_spike(P, mp, tmp):
    clock = Clock()
    eng = engine(P, clock, [0.2, 0.9, 0.2, 0.9, 0.2, 0.9], mp)
    ticks(eng, clock, 6)
    s = snap(eng)
    assert s["armed"] is False and s["warnings"] == 0
    return s


# -- engine: warn/clear lifecycle -------------------------------------------


def warn_lifecycle(P, mp, tmp):
    clock = Clock()
    ledger, store = StubLedger(), StubEventStore()
    eng = engine(P, clock, [0.8, 0.8, 0.8, 0.1, 0.1, 0.1], mp, ledger=ledger, event_store=store)
    bodies = []
    eng.on_publish = bodies.append
    ticks(eng, clock, 2)
    assert ledger.annotations["c0"]["predicted"] == "true"
    predicted = [e for e in store.bucket("c0").events if e.name == P.engine.EVENT_NAME_PREDICTED]
    assert len(predicted) == 1 and predicted[0].type == P.types.EventType.WARNING
    assert float(predicted[0].extra_info["score"]) >= 0.6
    assert bodies[0]["event"] == "warn" and bodies[0]["component"] == "c0" and bodies[0]["armed"]
    ticks(eng, clock, 1)
    assert "predicted_score" in ledger.annotations["c0"]
    annotated = dict(ledger.annotations["c0"])
    ticks(eng, clock, 3)
    assert ledger.annotations["c0"] == {}
    assert bodies[-1]["event"] == "clear"
    ev = predicted[0]
    return (annotated, bodies, (ev.component, ev.time, ev.name, ev.type, ev.message, ev.extra_info),
            eng.status())


def reset(P, mp, tmp):
    clock = Clock()
    ledger = StubLedger()
    eng = engine(P, clock, [0.8, 0.8], mp, ledger=ledger)
    ticks(eng, clock, 2)
    assert snap(eng)["armed"] is True
    eng.reset(component="c0")
    assert "c0" not in eng.scores()["components"]
    assert ledger.annotations.get("c0", {}) == {}
    return eng.status()


def lead_once(P, mp, tmp):
    clock = Clock()
    ledger = StubLedger()
    eng = engine(P, clock, [0.8] * 6, mp, ledger=ledger)
    leads = []
    eng.on_publish = lambda b: leads.append(b) if b["event"] == "lead" else None
    ticks(eng, clock, 2)
    warned_at = snap(eng)["warned_at"]
    assert warned_at is not None
    H = P.types.HealthStateType
    ledger.transitions = [{"component": "c0", "time": warned_at + 5.0, "from": H.DEGRADED,
                           "to": H.UNHEALTHY, "reason": "hard fault"}]
    clock.set(warned_at + 6.0)
    eng.tick_once()
    assert snap(eng)["lead_seconds"] == pytest.approx(5.0)
    assert len(leads) == 1
    eng.tick_once()
    assert len(leads) == 1
    return snap(eng), leads


def lead_by_flap_threshold(P, mp, tmp):
    # the flap window reaching the reactive threshold also closes the lead
    clock = Clock()
    ledger = StubLedger()
    eng = engine(P, clock, [0.8] * 4, mp, ledger=ledger)
    ticks(eng, clock, 2)
    warned_at = snap(eng)["warned_at"]
    H = P.types.HealthStateType
    ledger.transitions = [{"component": "c0", "time": warned_at - 3.0 + i, "from": H.HEALTHY,
                           "to": H.DEGRADED, "reason": "flap"} for i in range(5)]
    eng.tick_once()
    return snap(eng)


def no_lead_before_warning(P, mp, tmp):
    clock = Clock()
    ledger = StubLedger()
    H = P.types.HealthStateType
    ledger.transitions = [{"component": "c0", "time": clock() - 10.0, "from": H.HEALTHY,
                           "to": H.UNHEALTHY, "reason": "old fault"}]
    eng = engine(P, clock, [0.8] * 4, mp, ledger=ledger)
    ticks(eng, clock, 4)
    assert snap(eng)["lead_seconds"] is None
    return snap(eng)


# -- predicted-action dry-run invariant -------------------------------------


def audit_rows(audit, comp="c0"):
    return [{k: v for k, v in r.items() if k != "id"} for r in audit.read(component=comp)]


def dry_run_only(P, mp, tmp):
    clock = Clock()
    db = P.sqlite.DB(str(tmp / f"{P.name}.db"))
    try:
        audit = P.audit.AuditStore(db)
        audit.time_now_fn = clock
        eng = engine(P, clock, [0.8] * 2, mp, remediation=StubRemediation(audit),
                     warn_cooldown_seconds=300.0)
        ticks(eng, clock, 2)
        rows = audit_rows(audit)
        assert len(rows) == 1
        row = rows[0]
        assert row["action"] == P.policy.ACTION_PREDICTED
        assert row["suggested"] == P.types.RepairActionType.PREDICTED_DEGRADATION
        assert row["decision"] == P.policy.DECISION_DRY_RUN
        assert row["outcome"] == P.policy.OUTCOME_DRY_RUN
        assert P.policy.map_suggested_action(
            P.types.RepairActionType.PREDICTED_DEGRADATION, None) is None
        assert audit.last_attempt_time("c0", action=P.policy.ACTION_PREDICTED) is not None
        assert audit.last_attempt_time("c0", exclude_action=P.policy.ACTION_PREDICTED) is None
        return rows
    finally:
        db.close()


def warn_cooldown(P, mp, tmp):
    clock = Clock()
    db = P.sqlite.DB(str(tmp / f"{P.name}.db"))
    try:
        audit = P.audit.AuditStore(db)
        audit.time_now_fn = clock
        script = [0.8, 0.8, 0.1, 0.1, 0.1, 0.8, 0.8, 0.1, 0.1, 0.1, 0.8, 0.8]
        eng = engine(P, clock, script, mp, remediation=StubRemediation(audit),
                     warn_cooldown_seconds=300.0)
        ticks(eng, clock, 10)
        assert len(audit.read(component="c0")) == 1
        assert snap(eng)["warnings"] == 2
        clock.advance(400.0)
        ticks(eng, clock, 2)
        rows = audit_rows(audit)
        assert len(rows) == 2
        return rows, snap(eng)
    finally:
        db.close()


# -- engine robustness -------------------------------------------------------


def one_failure(P, mp, tmp):
    class ExplodingLedger(StubLedger):
        def recent_transitions(self, component, limit=0):
            if component == "bad":
                raise RuntimeError("boom")
            return super().recent_transitions(component, limit)

    clock = Clock()
    eng = engine(P, clock, registry=StubRegistry("bad", "good"), ledger=ExplodingLedger())
    out = eng.tick_once()
    assert "good" in out and "bad" not in out
    assert eng.status()["ticks"] == 1
    return out


def disabled(P, mp, tmp):
    eng = P.predict.PredictEngine(enabled=False, registry=StubRegistry("c0"))
    eng.time_now_fn = Clock()
    assert eng.tick_once() == {}
    eng.poke()
    assert eng.status()["ticks"] == 0
    return eng.status(), eng.scores(), eng.calibration()


def views(P, mp, tmp):
    clock = Clock()
    eng = engine(P, clock, [0.3, 0.3], mp)
    ticks(eng, clock, 2)
    comp = eng.scores(history_limit=8)["components"]["c0"]
    assert set(comp) >= {"score", "features", "armed", "warned_at", "lead_seconds",
                         "warnings", "history"}
    assert [h["score"] for h in comp["history"]] == [0.3, 0.3]
    assert eng.scores(component="nope")["components"] == {}
    st = eng.status()
    assert st["components_tracked"] == 1 and st["armed"] == []
    assert st["feature_weights"] == P.features.FEATURE_WEIGHTS
    return comp, st, eng.scores(component="c0")


def real_features(P, mp, tmp):
    # the unscripted fusion over a ledger with a fresh excursion and kmsg
    # events in the window: every feature the engine extracts, tick by tick
    clock = Clock(5000.0)
    ledger, store = StubLedger(), StubEventStore()
    H = P.types.HealthStateType
    ledger.state = H.UNHEALTHY
    ledger.transitions = [{"component": "c0", "time": 4900.0 + 20 * i, "from": H.HEALTHY,
                           "to": H.DEGRADED if i % 2 else H.UNHEALTHY, "reason": "r"}
                          for i in range(4)]
    for i, cls in enumerate(("xid_79", "xid_48", "xid_79")):
        store.bucket("c0").insert(P.types.Event(
            component="c0", time=4950.0 + i, name=cls, type=P.types.EventType.CRITICAL,
            message="m", extra_info={"kmsg": "line", "error_class": cls}))
    store.bucket("c0").insert(P.types.Event(component="c0", time=4960.0, name="own",
                                            type=P.types.EventType.WARNING, message="m"))
    eng = engine(P, clock, ledger=ledger, event_store=store, registry=StubRegistry("c0", "c1"))
    bodies = []
    eng.on_publish = bodies.append
    seen = []
    for _ in range(5):
        seen.append(eng.tick_once())
        clock.advance(15.0)
    ledger.state = H.HEALTHY
    for _ in range(4):
        seen.append(eng.tick_once())
        clock.advance(200.0)
    return seen, bodies, eng.scores(history_limit=16), ledger.annotations


ENGINE_CASES = {
    "dead_band": dead_band,
    "single_spike": single_spike,
    "warn_lifecycle": warn_lifecycle,
    "reset": reset,
    "lead_once": lead_once,
    "lead_by_flap_threshold": lead_by_flap_threshold,
    "no_lead_before_warning": no_lead_before_warning,
    "dry_run_only": dry_run_only,
    "warn_cooldown": warn_cooldown,
    "one_failure": one_failure,
    "disabled": disabled,
    "views": views,
    "real_features": real_features,
}


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_the_engine_is_the_reference_s(case, monkeypatch, tmp_path):
    ref, port = both(ENGINE_CASES[case], monkeypatch, tmp_path)
    assert port == ref


@pytest.mark.parametrize("P", PKGS, ids=IDS)
def test_the_engine_registers_its_two_jobs(P):
    eng = P.predict.PredictEngine(registry=StubRegistry("c0"), interval_seconds=5.0)
    sched = P.scheduler.Scheduler()
    try:
        eng.start(sched)
        eng.start(sched)  # idempotent
        assert sorted(sched.job_names()) == ["predict-calibrate", "predict-scan"]
        eng.close()
        assert sched.job_names() == []
    finally:
        eng.close()
        sched.close()
