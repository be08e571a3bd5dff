"""Parity of the port's threshold calibration (gpud_tpu_torch/predict/
calibrate.py and the engine's use of it) with gpud_tpu's, on the cases of
the reference's tests/test_predict_calibrate.py.

Each case runs on both packages over the same synthetic ledger; the
reference's accelerator names (``accelerator-tpu-N``) become the port's
(``accelerator-gpu-N``), and the fitted classes, thresholds, weights,
sample counts, views and publishes must be equal with that one noun mapped.
Scores and thresholds are the same float arithmetic, compared with ``==``."""

import pytest

from torch_plane_parity import IDS, PKGS, REF, both


def acc(P):
    """The accelerator class as ``P`` names it."""
    return "accelerator-tpu" if P is REF else "accelerator-gpu"


def mapped(obj):
    """The reference's observation with its accelerator noun as the port's."""
    if isinstance(obj, dict):
        return {mapped(k): mapped(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(mapped(v) for v in obj)
    if isinstance(obj, str):
        return obj.replace("accelerator-tpu", "accelerator-gpu")
    return obj


# -- component_class ------------------------------------------------------


@pytest.mark.parametrize("name, cls", [
    ("accelerator-tpu-3", "accelerator-tpu"),
    ("accelerator-gpu-3", "accelerator-gpu"),
    ("accelerator-gpu-temperature", "accelerator-gpu-temperature"),
    ("accelerator-gpu-nvlink", "accelerator-gpu-nvlink"),
    ("accelerator-gpu-error-kmsg", "accelerator-gpu-error-kmsg"),
    ("tpu-hbm", "tpu-hbm"),
    ("disk0", "disk"),
    ("cpu", "cpu"),
    ("c0", "c"),
    ("nvlink_7", "nvlink"),
    ("42", "42"),
])
@pytest.mark.parametrize("P", PKGS, ids=IDS)
def test_component_class(P, name, cls):
    assert P.calibrate.component_class(name) == cls


def test_the_calibration_defaults_are_the_reference_s():
    ref, port = both(lambda P: {k: getattr(P.calibrate, k) for k in (
        "PREDICT_SCHEMA", "DEFAULT_MIN_HISTORY", "DEFAULT_MIN_THRESHOLD", "DEFAULT_MARGIN",
        "DEFAULT_HORIZON", "DEFAULT_CALIBRATE_INTERVAL", "MIN_WEIGHT_FRACTION",
        "REPLAYED_FEATURES")})
    assert port == ref


# -- synthetic ledgers ----------------------------------------------------


class Ledger:
    flap_threshold = 5

    def __init__(self, rows):
        self._rows = sorted(rows, key=lambda r: r["time"])

    def history(self):
        return list(reversed(self._rows))  # newest-first, like the real one


def row(comp, t, frm, to):
    return {"component": comp, "time": t, "from": frm, "to": to, "reason": "r"}


def benign(comp, t0=1_000_000.0, blips=12):
    return [row(comp, t0 + d * 7200.0, "Initializing", "Healthy") for d in range(blips)]


def ramp(comp, t0=2_000_000.0):
    rows, t = [], t0
    for gap in (200.0, 120.0, 80.0, 60.0, 45.0, 35.0, 25.0, 20.0):
        rows.append(row(comp, t, "Healthy", "Initializing"))
        t += gap
    rows.append(row(comp, t, "Initializing", "Unhealthy"))
    return rows, t


def fit(P, rows, now=3_000_000.0, **kw):
    return {cls: c.as_dict() for cls, c in
            P.calibrate.ThresholdCalibrator(Ledger(rows), **kw).calibrate(now=now).items()}


def first_warn(P, rows, threshold, weights, window=600.0, saturation=5):
    F = P.features
    times = [r["time"] for r in rows]
    seen = [(r["time"], r["from"], r["to"]) for r in rows]
    for i, r in enumerate(rows):
        feats = {
            "cadence": F.cadence_score(times[:i + 1], r["time"], window, saturation=saturation),
            "trajectory": F.trajectory_score(r["to"], seen[:i + 1], r["time"], window),
        }
        if F.fuse(feats, weights) >= threshold:
            return r["time"]
    return None


# -- fitting --------------------------------------------------------------


def thin_history(P):
    cal = P.calibrate.ThresholdCalibrator(
        Ledger(benign(acc(P) + "-1", blips=(P.calibrate.DEFAULT_MIN_HISTORY - 1) // 2))
    ).calibrate(now=3_000_000.0)[acc(P)]
    assert cal.source == "default" and cal.threshold == 0.6
    assert cal.weights == P.features.FEATURE_WEIGHTS
    assert cal.samples < P.calibrate.DEFAULT_MIN_HISTORY
    return cal.as_dict()


def zero_historical_fps(P):
    c = acc(P) + "-1"
    cal = P.calibrate.ThresholdCalibrator(Ledger(benign(c) + ramp(c)[0])).calibrate(
        now=3_000_000.0)[acc(P)]
    assert cal.source == "calibrated"
    assert cal.threshold <= 0.6 and cal.threshold > cal.benign_max and cal.benign_samples > 0
    return cal.threshold, cal.weights, cal.benign_max, cal.precursor_min, cal.as_dict()


def empty_ledgers(P):
    assert P.calibrate.ThresholdCalibrator(None).calibrate(now=0.0) == {}
    assert P.calibrate.ThresholdCalibrator(Ledger([])).calibrate(now=0.0) == {}
    return True


def components_filter(P):
    rows = benign(acc(P) + "-1") + benign("cpu")
    cal = P.calibrate.ThresholdCalibrator(Ledger(rows)).calibrate(
        now=3_000_000.0, components=[acc(P) + "-1"])
    assert set(cal) == {acc(P)}
    return fit(P, rows)


def class_pools(P):
    rows = benign(acc(P) + "-1", blips=4) + benign(acc(P) + "-2", t0=1_500_000.0, blips=4)
    cal = fit(P, rows)[acc(P)]
    assert cal["components"] == 2 and cal["samples"] == 8 and cal["source"] == "calibrated"
    return cal


def warns_earlier(P):
    c = acc(P) + "-1"
    rw, fail_ts = ramp(c)
    rows = sorted(benign(c) + rw, key=lambda r: r["time"])
    cal = P.calibrate.ThresholdCalibrator(Ledger(rows)).calibrate(now=3_000_000.0)[acc(P)]
    assert cal.threshold < 0.6
    warn_default = first_warn(P, rows, 0.6, None)
    warn_cal = first_warn(P, rows, cal.threshold, cal.weights)
    assert warn_cal is not None and warn_cal < fail_ts
    assert warn_default is None or warn_cal < warn_default
    assert first_warn(P, benign(c), cal.threshold, cal.weights) is None
    return warn_default, warn_cal, cal.threshold


def noisy_weights(P):
    rows, t = [], 1_000_000.0
    for _ in range(10):
        rows.append(row("noisy-1", t, "Healthy", "Degraded"))
        rows.append(row("noisy-1", t + 5.0, "Degraded", "Healthy"))
        t += 40.0
    cal = P.calibrate.ThresholdCalibrator(Ledger(rows)).calibrate(now=2_000_000.0)["noisy"]
    assert cal.source == "calibrated" and cal.threshold == 0.6
    for f in ("cadence", "trajectory"):
        assert cal.weights[f] < P.features.FEATURE_WEIGHTS[f]
        assert cal.weights[f] >= P.features.FEATURE_WEIGHTS[f] * P.calibrate.MIN_WEIGHT_FRACTION
    return cal.weights, cal.benign_max


def knobs(P):
    # the same history under other knobs: horizon, margin, floor, history
    c = acc(P) + "-1"
    rows = benign(c) + ramp(c)[0]
    return [fit(P, rows, **kw) for kw in (
        dict(horizon_seconds=60.0), dict(margin=0.2), dict(min_threshold=0.5),
        dict(min_history=100), dict(default_threshold=0.4), dict(window_seconds=60.0))]


def as_dict_round(P):
    d = P.calibrate.ClassCalibration(0.5, {"cadence": 0.6}).as_dict()
    assert d["threshold"] == 0.5 and d["source"] == "default" and d["precursor_min"] is None
    return d


FIT_CASES = {
    "thin_history": thin_history,
    "zero_historical_fps": zero_historical_fps,
    "empty_ledgers": empty_ledgers,
    "components_filter": components_filter,
    "class_pools": class_pools,
    "warns_earlier": warns_earlier,
    "noisy_weights": noisy_weights,
    "knobs": knobs,
    "as_dict_round": as_dict_round,
}


@pytest.mark.parametrize("case", FIT_CASES)
def test_the_fit_is_the_reference_s(case):
    ref, port = both(FIT_CASES[case])
    assert port == mapped(ref)


# -- engine integration ---------------------------------------------------


class StubRegistry:
    def __init__(self, *names):
        self._names = list(names)

    def names(self):
        return list(self._names)


class EngineLedger:
    flap_threshold = 5

    def __init__(self):
        self.rows = []
        self.live = {}
        self.annotations = {}

    def history(self):
        return list(reversed(sorted(self.rows, key=lambda r: r["time"])))

    def recent_transitions(self, component, limit=0):
        return list(self.live.get(component, (None, []))[1])

    def last_state(self, component):
        state = self.live.get(component, (None, []))[0]
        return {"state": state, "since": 0.0} if state else None

    def set_annotation(self, component, key, value):
        self.annotations.setdefault(component, {})[key] = value

    def clear_annotation(self, component, key):
        self.annotations.get(component, {}).pop(key, None)


NOW = 1_800_000_000.0


def mk_engine(P, *names, **kw):
    led = EngineLedger()
    kw.setdefault("registry", StubRegistry(*names))
    eng = P.predict.PredictEngine(ledger=led, **kw)
    eng.time_now_fn = lambda: NOW
    return eng, led


def calibrate_now_swaps(P):
    eng, led = mk_engine(P)
    c = acc(P) + "-1"
    led.rows = benign(c) + ramp(c)[0]
    out = eng.calibrate_now()
    assert out["calibrated"] >= 1
    view = eng.calibration()
    assert view["schema"] == P.calibrate.PREDICT_SCHEMA
    cls = view["classes"][acc(P)]
    assert cls["source"] == "calibrated" and cls["threshold"] < 0.6
    assert eng._threshold_for(c) == pytest.approx(cls["threshold"], abs=1e-4)
    assert eng._threshold_for("cpu") == eng.threshold
    return out, view, eng._threshold_for(c), eng._weights_for(c)


def thin_keeps_default(P):
    eng, led = mk_engine(P)
    led.rows = benign(acc(P) + "-1", blips=2)
    eng.calibrate_now()
    view = eng.calibration()
    assert view["classes"][acc(P)]["source"] == "default"
    assert eng._threshold_for(acc(P) + "-1") == eng.threshold
    return view


def status_and_scores(P):
    c = acc(P) + "-1"
    eng, led = mk_engine(P, c)
    led.rows = benign(c) + ramp(c)[0]
    eng.calibrate_now()
    st = eng.status()
    assert st["schema"] == P.calibrate.PREDICT_SCHEMA
    assert st["calibrate_enabled"] is True and st["classes_calibrated"] >= 1
    led.live[c] = ("Degraded", [{"time": NOW - 30.0, "from": "Healthy", "to": "Degraded"}])
    eng.tick_once()
    sc = eng.scores()["components"][c]
    assert sc["component_class"] == acc(P)
    assert sc["threshold"] == pytest.approx(eng._threshold_for(c), abs=1e-6)
    return st, sc


def versioned_publish(P):
    c = acc(P) + "-1"
    eng, led = mk_engine(P, c, arm_ticks=1, warn_cooldown_seconds=0.0)
    got = []
    eng.on_publish = got.append
    led.live[c] = ("Degraded", [{"time": NOW - 50 + i * 10, "from": "Healthy", "to": "Degraded"}
                                for i in range(6)])
    eng.tick_once()
    p = got[-1]
    assert p["schema"] == P.calibrate.PREDICT_SCHEMA and p["component"] == c
    assert p["component_class"] == acc(P) and p["event"] == "warn" and p["armed"] is True
    assert "threshold" in p and "features" in p and "score" in p
    return got


def calibration_failure(P):
    class Broken(EngineLedger):
        def history(self):
            raise RuntimeError("db gone")

    eng = P.predict.PredictEngine(ledger=Broken())
    return eng.calibrate_now(), P.predict.PredictEngine().calibrate_now()


def cooccur_peers(P):
    a1, a2 = acc(P) + "-1", acc(P) + "-2"
    peers = P.engine.PredictEngine._cooccur_peers(
        a1, {a1: 0.5, a2: 0.4, "cpu": 0.9, "fabric": 0.3}, "fabric")
    assert set(peers) == {a2, "fabric"}
    fab = P.engine.PredictEngine._cooccur_peers("fabric", {a1: 0.5, "cpu": 0.9, "fabric": 0.3},
                                                "fabric")
    assert set(fab) == {a1}
    scores = {"a-1": 0.8, "a-2": 0.5, "b": 0.0}
    pc = P.features.peer_corroboration
    assert pc("a-1", scores, ["a-2", "b"]) == 0.5 and pc("a-1", scores, ["b"]) == 0.0
    assert pc("b", scores, ["a-1"]) == 0.0 and pc("a-1", scores, ["a-1"]) == 0.0
    base = {"cadence": 0.5}
    assert P.features.fuse({**base, "cooccur": 0.5}) > P.features.fuse(base)
    return peers, fab, P.engine.PredictEngine._cooccur_peers(a1, {a1: 0.5}, None)


ENGINE_CASES = {
    "calibrate_now_swaps": calibrate_now_swaps,
    "thin_keeps_default": thin_keeps_default,
    "status_and_scores": status_and_scores,
    "versioned_publish": versioned_publish,
    "calibration_failure": calibration_failure,
    "cooccur_peers": cooccur_peers,
}


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_the_engine_s_calibration_is_the_reference_s(case):
    ref, port = both(ENGINE_CASES[case])
    assert port == mapped(ref)


@pytest.mark.parametrize("enabled, jobs", [(True, ["predict-calibrate", "predict-scan"]),
                                           (False, ["predict-scan"])])
@pytest.mark.parametrize("P", PKGS, ids=IDS)
def test_the_calibrate_job_follows_its_switch(P, enabled, jobs):
    eng, _ = mk_engine(P, calibrate_enabled=enabled)
    sched = P.scheduler.Scheduler()
    try:
        eng.start(sched)
        assert sorted(sched.job_names()) == jobs
    finally:
        eng.close()
        sched.close()


def test_a_live_score_under_a_fitted_class():
    """The fitted weights reach the live fusion: a tick after a calibration
    scores with the class's weights in both packages."""
    def scenario(P):
        c = acc(P) + "-1"
        eng, led = mk_engine(P, c)
        led.rows = benign(c) + ramp(c)[0]
        eng.calibrate_now()
        led.live[c] = ("Degraded", [{"time": NOW - 30.0 - 40 * i, "from": "Healthy",
                                     "to": "Degraded"} for i in range(3)])
        return eng.tick_once(), eng.scores()
    ref, port = both(scenario)
    assert port == mapped(ref)
