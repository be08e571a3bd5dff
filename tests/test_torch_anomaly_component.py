"""The port's anomaly component (gpud_tpu_torch/components/gpu/anomaly.py)
and its metrics store against the reference's
(gpud_tpu/components/tpu/anomaly.py, gpud_tpu/metrics/store.py).

Every case of tests/test_anomaly_component.py runs on two mirrored metrics
stores, the same rows under each package's gauge names (``GAUGES`` in
tests/torch_parity.py). With the numpy backend the windows and the scores
are exactly equal, and health, reasons, events, extra-info keys and gauges
equal after the noun table. The torch backend on the CPU stays within
rtol = atol = 1e-4 of JAX's ``robust_scores``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gpud_tpu.components.tpu.anomaly as ref_anomaly
from gpud_tpu.components.base import TpudInstance as RefInstance
from gpud_tpu.eventstore import EventStore as RefEventStore
from gpud_tpu.metrics.store import MetricsStore as RefMetricsStore
from gpud_tpu.models.anomaly import robust_scores as jax_robust_scores
from gpud_tpu.sqlite import DB as RefDB

import gpud_tpu_torch.components.gpu.anomaly as anomaly
import gpud_tpu_torch.metrics.store as store_mod
from gpud_tpu_torch.api.v1.types import HealthStateType
from gpud_tpu_torch.components.base import TpudInstance
from gpud_tpu_torch.eventstore import EventStore
from gpud_tpu_torch.metrics.store import MetricsStore
from gpud_tpu_torch.sqlite import DB

from torch_parity import (
    GAUGES,
    assert_events_parity,
    assert_gauges_parity,
    assert_result_parity,
    mirrored_mocks,
)

NOW = 1_700_000_000


def test_feature_metrics_are_the_references_through_the_gauge_table():
    assert anomaly.FEATURE_METRICS == [GAUGES[m] for m in ref_anomaly.FEATURE_METRICS]
    assert (anomaly.MIN_SAMPLES, anomaly.MAX_WINDOW_SAMPLES, anomaly.DEFAULT_LOOKBACK,
            anomaly.DEFAULT_SCORE_DEGRADED) == (
        ref_anomaly.MIN_SAMPLES, ref_anomaly.MAX_WINDOW_SAMPLES,
        ref_anomaly.DEFAULT_LOOKBACK, ref_anomaly.DEFAULT_SCORE_DEGRADED)


def _telemetry_rows(n_chips=4, n_sweeps=32, drift_chip=None):
    """The reference test's synthetic sweeps (same seed), in the
    reference's names: one per minute; one chip's temperature may ramp
    away over the last quarter."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n_sweeps):
        ts = NOW - (n_sweeps - i) * 60
        for chip in range(n_chips):
            for name in ref_anomaly.FEATURE_METRICS:
                v = 50.0 + rng.normal(0, 0.5)
                if (drift_chip is not None and chip == drift_chip
                        and name == "tpud_tpu_temperature_celsius"
                        and i >= 3 * n_sweeps // 4):
                    v += 40.0 * (i - 3 * n_sweeps // 4) / (n_sweeps // 4)
                rows.append((ts, name, {"component": "x", "chip": str(chip)}, v))
    return rows


def _port_rows(rows):
    return [(ts, GAUGES[name], {"component": labels["component"], "gpu": labels["chip"]}, v)
            for ts, name, labels, v in rows]


class Pair:
    """The reference's component and the port's on mirrored stores."""

    def __init__(self, tmp_path, rows, backend="numpy"):
        tmp_path.mkdir()
        self.ref_db = RefDB(str(tmp_path / "ref.db"))
        self.port_db = DB(str(tmp_path / "port.db"))
        RefMetricsStore(self.ref_db).record(rows)
        MetricsStore(self.port_db).record(_port_rows(rows))
        ref_mock, port_mock = mirrored_mocks()
        self.ref = ref_anomaly.TPUAnomalyComponent(RefInstance(
            tpu_instance=ref_mock, db_rw=self.ref_db, event_store=RefEventStore(self.ref_db)))
        self.port = anomaly.GPUAnomalyComponent(TpudInstance(
            gpu_instance=port_mock, db_rw=self.port_db, event_store=EventStore(self.port_db)))
        self.ref.backend, self.port.backend = "numpy", backend
        self.port.device = "cpu"
        self.ref.time_now_fn = self.port.time_now_fn = lambda: float(NOW)

    def check(self):
        ref_cr, port_cr = self.ref.check(), self.port.check()
        assert_result_parity(ref_cr, port_cr)
        assert_events_parity(self.ref.events(0), self.port.events(0))
        return ref_cr, port_cr

    def windows(self):
        ref_chips, ref_w = self.ref._build_windows(float(NOW))
        chips, w = self.port._build_windows(float(NOW))
        assert chips == ref_chips
        np.testing.assert_array_equal(w, ref_w)
        return chips, w

    def close(self):
        self.ref_db.close()
        self.port_db.close()


@pytest.fixture()
def pair(tmp_path):
    made = []

    def make(rows, backend="numpy"):
        p = Pair(tmp_path / str(len(made)), rows, backend)
        made.append(p)
        return p

    yield make
    for p in made:
        p.close()


def _gappy(rows):
    return [r for r in rows if not (
        r[2]["chip"] == "3" and r[1] == "tpud_tpu_temperature_celsius"
        and (int(r[0]) // 60) % 2 == 0)]


def _missing_feature(rows):
    return [r for r in rows if not (r[2]["chip"] == "0" and r[1] == "tpud_tpu_power_watts")]


def _late_series(rows):
    return [r for r in rows if not (
        r[2]["chip"] == "1" and r[1] == "tpud_tpu_duty_cycle_percent"
        and r[0] < NOW - 20 * 60)]


CASES = {
    "nominal": (lambda: _telemetry_rows(), HealthStateType.HEALTHY),
    "drifting chip 2": (lambda: _telemetry_rows(drift_chip=2), HealthStateType.DEGRADED),
    "intermittent gauge gaps": (lambda: _gappy(_telemetry_rows(drift_chip=2)),
                                HealthStateType.DEGRADED),
    "chip missing a whole feature": (lambda: _missing_feature(_telemetry_rows(drift_chip=1)),
                                     HealthStateType.DEGRADED),
    "forward fill of a late series": (lambda: _late_series(_telemetry_rows()),
                                      HealthStateType.HEALTHY),
    "warming up": (lambda: _telemetry_rows(n_sweeps=4), HealthStateType.HEALTHY),
    "eight GPUs, drift on 7": (lambda: _telemetry_rows(n_chips=8, drift_chip=7),
                               HealthStateType.DEGRADED),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_component_matches_the_reference(pair, case):
    make_rows, health = CASES[case]
    p = pair(make_rows())
    ref_cr, port_cr = p.check()
    assert port_cr.health == health
    if case != "warming up":
        chips, w = p.windows()
        scores, used = anomaly._score_windows(w, "numpy")
        ref_scores, ref_used = ref_anomaly._score_windows(w, "numpy")
        assert (used, ref_used) == ("numpy", "numpy")
        np.testing.assert_array_equal(scores, ref_scores)
        assert_gauges_parity("accelerator-tpu-anomaly", chips=[int(c) for c in chips])
    # the event is deduplicated across repeated checks inside the window
    p.check()
    assert len(p.port.events(0)) == (1 if health == HealthStateType.DEGRADED else 0)


def test_drifting_gpu_event_names_the_gpu(pair):
    p = pair(_telemetry_rows(drift_chip=2))
    _ref_cr, port_cr = p.check()
    assert "GPU 2" in port_cr.reason and port_cr.extra_info["backend"] == "numpy"
    (ev,) = p.port.events(0)
    assert ev.name == anomaly.EVENT_NAME == "tpu_telemetry_anomaly"
    assert ev.extra_info["gpu"] == "2"


def test_gappy_and_missing_series_shape_the_windows_alike(pair):
    chips, w = pair(_gappy(_telemetry_rows(drift_chip=2))).windows()
    assert "3" in chips and w.shape[0] == 4 and w.shape[1] >= anomaly.MIN_SAMPLES
    chips, _w = pair(_missing_feature(_telemetry_rows(drift_chip=1))).windows()
    assert chips == ["1", "2", "3"]


class _ClockStop:
    """Stands in for the poller's stop event: each wait moves the shared
    fake clock a minute, so the mock's telemetry wobbles over the burst."""

    def __init__(self, clock):
        self.clock = clock

    def wait(self, _seconds):
        self.clock[0] += 60.0
        return False


@pytest.mark.parametrize("accel", ["v5e-8", "v5e-4"])
def test_burst_path_matches_the_reference(accel):
    clock = [float(NOW)]
    ref_mock, port_mock = mirrored_mocks(accel, clock=clock)
    ref = ref_anomaly.TPUAnomalyComponent(RefInstance(tpu_instance=ref_mock))
    port = anomaly.GPUAnomalyComponent(TpudInstance(gpu_instance=port_mock))
    ref.backend = port.backend = "numpy"
    windows, results = [], []
    for c in (ref, port):
        c._stop_event = _ClockStop(clock)
        clock[0] = float(NOW)
        windows.append(c._burst_windows())
        clock[0] = float(NOW)
        results.append(c.check())
    assert windows[1][0] == windows[0][0]
    # the seven features, in order, through the telemetry field table
    np.testing.assert_array_equal(windows[1][1], windows[0][1])
    assert windows[1][1].shape == (len(windows[1][0]), anomaly.MIN_SAMPLES, 7)
    assert np.ptp(windows[1][1], axis=1).max() > 0  # the clock moved the mock
    assert_result_parity(*results)
    assert results[1].health == HealthStateType.HEALTHY
    assert "nominal" in results[1].reason
    assert results[1].extra_info["samples"] == str(anomaly.MIN_SAMPLES)


def test_torch_backend_on_the_cpu_matches_jax(pair):
    rows = _telemetry_rows(drift_chip=1)
    p = pair(rows, backend="torch")
    p.ref.backend = "jax"
    ref_cr, port_cr = p.ref.check(), p.port.check()
    assert port_cr.health == ref_cr.health == HealthStateType.DEGRADED
    assert port_cr.extra_info["backend"] == "torch" and ref_cr.extra_info["backend"] == "jax"
    _chips, w = p.windows()
    scores, used = anomaly._score_windows(w, "torch", "cpu")
    assert used == "torch" and scores.dtype == np.float32
    np.testing.assert_allclose(scores, np.asarray(jax_robust_scores(jnp.asarray(w))),
                               rtol=1e-4, atol=1e-4)


def test_scorer_parity_on_the_reference_windows():
    rng = np.random.default_rng(1)
    windows = rng.normal(50.0, 0.5, size=(4, 64, 8)).astype(np.float32)
    windows[2, 48:, 0] += np.linspace(0, 40, 16)
    torch_scores, _ = anomaly._score_windows(windows, "torch", "cpu")
    np_scores, _ = anomaly._score_windows(windows, "numpy")
    ref_np, _ = ref_anomaly._score_windows(windows, "numpy")
    np.testing.assert_array_equal(np_scores, ref_np)
    np.testing.assert_allclose(torch_scores, np.asarray(jax_robust_scores(jnp.asarray(windows))),
                               rtol=1e-4, atol=1e-4)
    assert np.argmax(torch_scores) == 2


# memory temperatures of a settled, idle H100 in 8-sample bursts 0.25 s
# apart, as NVML read them (whole degrees); the other six features held
# at that card's idle values
IDLE_BURSTS = {
    "tick in the last sample": [38, 38, 38, 38, 38, 38, 38, 39],
    "tick in the one before": [38, 38, 38, 38, 38, 39, 38, 38],
    "two-degree tick": [38, 38, 38, 38, 38, 40, 38, 39],
    "wandering": [40, 38, 38, 39, 39, 39, 39, 38],
    "two ticks": [38, 40, 38, 38, 38, 40, 38, 38],
    "ten-degree jump": [38, 38, 38, 38, 38, 38, 48, 48],
}
IDLE = (38.0, 38.0, 119.7, 0.0, 0.0, 1980.0, 2062352384.0)


def _idle_burst(mem_temps):
    w = np.tile(np.asarray(IDLE, np.float32), (1, 8, 1))
    w[0, :, 1] = mem_temps
    w[0, :, 2] += np.random.default_rng(0).normal(0, 0.02, 8).astype(np.float32)
    return w


@pytest.mark.parametrize("burst", sorted(IDLE_BURSTS))
def test_integer_series_score_as_the_reference_scores_them(burst):
    """NVML's whole-number gauges: the port computes the reference's
    function on them too. There the reference reads a single one-degree
    tick of an idle card as drift, and the port mirrors that (ROADMAP §C)."""
    w = _idle_burst(IDLE_BURSTS[burst])
    ref, _ = ref_anomaly._score_windows(w, "numpy")
    got, _ = anomaly._score_windows(w, "numpy")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(anomaly._score_windows(w, "torch", "cpu")[0],
                               np.asarray(jax_robust_scores(jnp.asarray(w))),
                               rtol=1e-4, atol=1e-4)
    assert float(got[0]) >= anomaly.DEFAULT_SCORE_DEGRADED


def test_auto_is_numpy_while_cuda_is_not_initialised(pair):
    assert not torch.cuda.is_initialized()
    p = pair(_telemetry_rows(drift_chip=2), backend="auto")
    assert p.port.check().extra_info["backend"] == "numpy"
    _, w = p.windows()
    assert anomaly._score_windows(w, "auto")[1] == "numpy"


def test_auto_is_torch_once_cuda_is_initialised(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    w = np.random.default_rng(2).normal(size=(2, 16, 7)).astype(np.float32)
    scores, used = anomaly._score_windows(w, "auto", "cpu")
    assert used == "torch"
    np.testing.assert_allclose(scores, anomaly._score_windows(w, "numpy")[0], rtol=1e-4, atol=1e-4)


def test_torch_backend_without_a_card_raises_and_never_scores_with_numpy(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = pair(_telemetry_rows(drift_chip=2), backend="torch")
    p.port.device = None  # the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.port.check_once()
    cr = p.port.check()
    assert cr.health == HealthStateType.UNHEALTHY
    assert "no CUDA device" in cr.reason and "backend" not in cr.extra_info
    called = []
    monkeypatch.setattr("gpud_tpu_torch.models.anomaly_np.robust_scores_np",
                        lambda *a: called.append(a))
    with pytest.raises(RuntimeError):
        anomaly._score_windows(p.windows()[1], "torch")
    assert called == []


def test_unsupported_without_telemetry():
    ref = ref_anomaly.TPUAnomalyComponent(RefInstance())
    port = anomaly.GPUAnomalyComponent(TpudInstance())
    assert not port.is_supported() and not ref.is_supported()
    assert_result_parity(ref.check(), port.check())


# -- the metrics store -----------------------------------------------------------


def test_metrics_store_constants_are_the_references():
    import gpud_tpu.metrics.store as ref_store

    assert (store_mod.TABLE, store_mod.DEFAULT_RETENTION, store_mod.COMPONENT_LABEL) == (
        ref_store.TABLE, ref_store.DEFAULT_RETENTION, ref_store.COMPONENT_LABEL)


def test_metrics_store_record_read_purge_match_the_reference(tmp_path):
    rows = [
        (100, "a", {"component": "c1", "gpu": "0"}, 1.5),
        (100, "b", {}, 2.0),
        (160, "a", {"component": "c2", "gpu": "1"}, 3.0),
        (220, "a", '{"component": "c1"}', 4.0),  # pre-encoded labels
        (280, "b", {"component": "c1"}, 5.0),
    ]
    ref_db, db = RefDB(str(tmp_path / "ref.db")), DB(str(tmp_path / "port.db"))
    try:
        ref, port = RefMetricsStore(ref_db), MetricsStore(db)
        assert port.writer is None and port.retention_seconds == ref.retention_seconds
        ref.record(rows)
        port.record(rows)
        port.record([])
        for since, name, comps in [(0, "", None), (150, "", None), (0, "a", None),
                                   (0, "", ["c1"]), (0, "a", ["c2", "c1"])]:
            assert [m.to_dict() for m in port.read(since, name, comps)] == \
                [m.to_dict() for m in ref.read(since, name, comps)]
        assert port.purge(200) == ref.purge(200) == 3
        assert [m.to_dict() for m in port.read(0)] == [m.to_dict() for m in ref.read(0)]
        assert db.query(f"SELECT * FROM {store_mod.TABLE} ORDER BY rowid") == \
            ref_db.query(f"SELECT * FROM {store_mod.TABLE} ORDER BY rowid")
    finally:
        ref_db.close()
        db.close()


def test_metrics_store_with_a_writer_buffers_and_flushes(tmp_path):
    class Writer:
        def __init__(self):
            self.calls, self.flushes = [], 0

        def submit_many(self, group, sql, rows, keys):
            self.calls.append((group, rows, keys))

        def flush(self):
            self.flushes += 1

    db = DB(str(tmp_path / "w.db"))
    try:
        w = Writer()
        store = MetricsStore(db, writer=w)
        store.record([(10, "a", {"gpu": "0"}, 1.0)])
        assert w.calls == [("metrics", [(10, "a", '{"gpu": "0"}', 1.0)],
                            [("m", 10, "a", '{"gpu": "0"}')])]
        assert store.read(0) == [] and store.purge(100) == 0
        assert w.flushes == 2
    finally:
        db.close()
