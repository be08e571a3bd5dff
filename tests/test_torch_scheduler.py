"""Parity of the port's deadline-heap scheduler (gpud_tpu_torch/scheduler/)
with gpud_tpu's: the same jitter offsets, and the same dispatch behaviour
(first runs on the pool and startup readiness, one-shots, cancel, poke to
the front and during a run, the interval re-read after every run, failures,
saturation, the watchdog and its replacement worker, stats).

The scheduler reads time through ``Scheduler.time_fn``: every case runs on
an injected clock, advanced by the test, and waits on events with a bound.
No case sleeps. The cases of the reference's tests/test_scheduler.py."""

import threading
import zlib

import numpy as np
import pytest

from torch_daemon_parity import IDS, PKGS, PORT, REF, Clock

WAIT = 10.0  # bound of every wait on a worker thread


def nudge(sched) -> None:
    """Wake the scheduler thread so it re-reads the injected clock."""
    with sched._cv:
        sched._cv.notify_all()


def wait_until(sched, pred, what: str) -> None:
    with sched._cv:
        ok = sched._cv.wait_for(pred, WAIT)
    assert ok, what


def make(pkg, clock, **kw):
    s = pkg.scheduler.Scheduler(**kw)
    s.time_fn = clock
    return s


# -- jitter ----------------------------------------------------------------------

def _names(n=1000, seed=7):
    rng = np.random.default_rng(seed)
    fixed = ["component:cpu", "component:accelerator-gpu-nvlink", "metrics-syncer",
             "storage-writer-flush", "remediation-scan", "", "ünïcode-job"]
    return fixed + [f"job-{int(x)}-{i}" for i, x in enumerate(rng.integers(0, 2**31, n - len(fixed)))]


@pytest.mark.parametrize("fraction", [0.0, 0.05, 0.5])
@pytest.mark.parametrize("interval", [0.0, 2.0, 60.0])
def test_jitter_offsets_of_1000_job_names_are_the_reference_s(fraction, interval):
    rs, ps = REF.scheduler.Scheduler(jitter_fraction=fraction), PORT.scheduler.Scheduler(jitter_fraction=fraction)
    for name in _names():
        r = rs._jittered(REF.scheduler.Job(name, lambda: None, lambda: interval), interval)
        p = ps._jittered(PORT.scheduler.Job(name, lambda: None, lambda: interval), interval)
        assert p == r, name
        # crc32 of the name, scaled into [-1, 1] (core.py:412-424)
        unit = (zlib.crc32(name.encode()) % 2001 - 1000) / 1000.0
        assert p == max(0.0, interval * (1.0 + fraction * unit)) if interval > 0 and fraction > 0 \
            else p == interval


def test_jitter_off_pins_the_cadence():
    for pkg in PKGS:
        s = pkg.scheduler.Scheduler(jitter_fraction=0.05)
        assert s._jittered(pkg.scheduler.Job("exact", lambda: None, lambda: 60.0,
                                             jitter_fraction=0.0), 60.0) == 60.0


# -- dispatch ----------------------------------------------------------------------

def scenario_first_runs(pkg):
    clock = Clock()
    s = make(pkg, clock, workers=2, hang_timeout=60.0)
    ran = threading.Event()
    s.add_job("a", ran.set, interval=3600.0)
    s.add_job("deferred", lambda: None, interval=3600.0, initial_delay=3600.0)
    try:
        s.start()
        assert ran.wait(WAIT)
        ready = s.wait_first_runs(timeout=WAIT)
        return (ready, s.startup_ready_seconds, s.job_names(), s.get_job("deferred").runs)
    finally:
        s.close()


def scenario_one_shot(pkg):
    clock = Clock()
    s = make(pkg, clock, workers=2)
    done = threading.Event()
    hits = []
    try:
        s.start()
        a = s.submit("oneshot", lambda: (hits.append(1), done.set()))
        assert done.wait(WAIT)
        wait_until(s, lambda: "oneshot" not in s._jobs, "one-shot unregistered")
        return (a.name, hits, s.job_names())
    finally:
        s.close()
        assert s.submit("late", lambda: None) is None


def scenario_cancel(pkg):
    clock = Clock()
    s = make(pkg, clock, workers=2)
    runs = []
    first = threading.Event()
    probe = threading.Event()
    job = s.add_job("c", lambda: (runs.append(clock()), first.set()), interval=10.0, jitter=False)
    try:
        s.start()
        assert first.wait(WAIT)
        wait_until(s, lambda: not job.running, "first run finished")
        assert job.cancel() is None and s.cancel("c") is False
        clock.advance(100.0)  # the cancelled deadline is long past
        s.add_job("probe", probe.set, interval=3600.0)
        assert probe.wait(WAIT)
        return (runs, s.job_names(), job.cancelled)
    finally:
        s.close()


def scenario_poke(pkg):
    clock = Clock()
    s = make(pkg, clock, workers=2)
    runs = []
    evs = [threading.Event() for _ in range(3)]
    s.add_job("poked", lambda: (runs.append(clock()), evs[len(runs) - 1].set()), interval=3600.0)
    try:
        s.start()
        assert evs[0].wait(WAIT)
        wait_until(s, lambda: not s.get_job("poked").running, "idle")
        clock.advance(5.0)
        assert s.poke("poked") and not s.poke("missing")
        assert evs[1].wait(WAIT)
        return runs
    finally:
        s.close()


def scenario_poke_during_run(pkg):
    clock = Clock()
    s = make(pkg, clock, workers=2)
    gate, started, second = threading.Event(), threading.Event(), threading.Event()
    runs = []

    def fn():
        runs.append(clock())
        if len(runs) == 1:
            started.set()
            gate.wait(WAIT)
        else:
            second.set()

    job = s.add_job("busy", fn, interval=3600.0)
    try:
        s.start()
        assert started.wait(WAIT)
        job.poke()  # lands while the first run is in flight
        poked = job.poked
        gate.set()
        assert second.wait(WAIT)
        return (poked, runs)
    finally:
        s.close()


def scenario_adaptive(pkg):
    clock = Clock()
    s = make(pkg, clock, workers=2)
    interval = [3600.0]
    runs = []
    evs = [threading.Event() for _ in range(4)]
    s.add_job("adaptive", lambda: (runs.append(clock()), evs[min(len(runs), 4) - 1].set()),
              interval_fn=lambda: interval[0], jitter=False)
    try:
        s.start()
        assert evs[0].wait(WAIT)
        wait_until(s, lambda: not s.get_job("adaptive").running, "idle")
        due_long = s.get_job("adaptive").due
        interval[0] = 2.0  # the fast-poll window opens: re-read after the next run
        s.poke("adaptive")
        assert evs[1].wait(WAIT)
        wait_until(s, lambda: s.get_job("adaptive").runs == 2, "second run done")
        due_short = s.get_job("adaptive").due
        clock.advance(2.0)
        nudge(s)
        assert evs[2].wait(WAIT)
        return (due_long, due_short, runs)
    finally:
        s.close()


def scenario_failures(pkg):
    clock = Clock()
    s = make(pkg, clock, workers=2)
    evs = [threading.Event() for _ in range(3)]
    runs = []

    def fn():
        runs.append(1)
        evs[len(runs) - 1].set()
        raise RuntimeError("boom")

    job = s.add_job("crashy", fn, interval=1.0, jitter=False)
    try:
        s.start()
        for i in range(3):
            assert evs[i].wait(WAIT)
            wait_until(s, lambda: job.runs == i + 1, "run finished")
            clock.advance(1.0)
            nudge(s)
        return (job.failures, job.runs)
    finally:
        s.close()


def scenario_saturation(pkg):
    clock = Clock()
    sat = pkg.scheduler._c_saturation
    before = sat.get()
    s = make(pkg, clock, workers=1, hang_timeout=60.0)
    gate = threading.Event()
    done = []
    for i in range(3):
        s.add_job(f"slow-{i}", lambda i=i: (gate.wait(WAIT), done.append(i)), interval=3600.0)
    try:
        s.start()
        wait_until(s, lambda: len(s._ready) + s._busy == 3 or sat.get() >= before + 2,
                   "three due jobs on one worker")
        saturated = sat.get() - before
        gate.set()
        assert s.wait_first_runs(timeout=WAIT) is not None
        return (saturated >= 2, sorted(done))
    finally:
        s.close()


def scenario_watchdog(pkg):
    clock = Clock()
    s = make(pkg, clock, workers=1, hang_timeout=30.0)
    release, entered, hung = threading.Event(), threading.Event(), threading.Event()
    hangs, fast = [], threading.Event()
    s.add_job("wedged", lambda: (entered.set(), release.wait(WAIT)), interval=3600.0,
              on_hang=lambda e: (hangs.append(e), hung.set()))
    before = pkg.scheduler._c_watchdog.get(labels={"job": "wedged"})
    try:
        s.start()
        assert entered.wait(WAIT)
        clock.advance(31.0)  # past the hang budget of 30 s
        nudge(s)
        assert hung.wait(WAIT)
        workers_during = s.stats()["workers"]
        s.add_job("fast", fast.set, interval=3600.0)  # runs on the replacement
        assert fast.wait(WAIT)
        release.set()
        wait_until(s, lambda: len(s._workers) == 1, "sacrificial worker retired")
        fires = pkg.scheduler._c_watchdog.get(labels={"job": "wedged"}) - before
        return (hangs, workers_during, s.stats()["workers"], s.get_job("wedged").runs, fires)
    finally:
        s.close()


def scenario_stats(pkg):
    clock = Clock()
    s = make(pkg, clock, workers=3)
    ran = threading.Event()
    s.add_job("x", ran.set, interval=60.0)
    try:
        s.start()
        assert ran.wait(WAIT)
        assert s.wait_first_runs(timeout=WAIT) == 0.0
        wait_until(s, lambda: s._busy == 0, "idle")
        return s.stats()
    finally:
        s.close()


SCENARIOS = {
    "first_runs": scenario_first_runs,
    "one_shot": scenario_one_shot,
    "cancel": scenario_cancel,
    "poke": scenario_poke,
    "poke_during_run": scenario_poke_during_run,
    "adaptive_interval": scenario_adaptive,
    "failures": scenario_failures,
    "saturation": scenario_saturation,
    "watchdog": scenario_watchdog,
    "stats": scenario_stats,
}

EXPECTED = {
    "first_runs": (0.0, 0.0, ["a", "deferred"], 0),
    "one_shot": ("oneshot", [1], []),
    "cancel": ([1000.0], ["probe"], True),
    "poke": [1000.0, 1005.0],
    "poke_during_run": (True, [1000.0, 1000.0]),
    "adaptive_interval": (4600.0, 1002.0, [1000.0, 1000.0, 1002.0]),
    "failures": (3, 3),
    "saturation": (True, [0, 1, 2]),
    "watchdog": ([31.0], 2, 1, 1, 1),
    "stats": {"jobs": 1, "ready_queue_depth": 0, "workers": 3, "workers_busy": 0,
              "dispatch_lag_p95_seconds": 0.0, "startup_ready_seconds": 0.0, "running": []},
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_dispatch_is_the_reference_s(name):
    ref = SCENARIOS[name](REF)
    port = SCENARIOS[name](PORT)
    assert port == ref == EXPECTED[name]


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_hung_component_is_marked_degraded_stale(pkg):
    clock = Clock()

    class Wedged(pkg.base.PollingComponent):
        NAME = "wedged-comp"

        def __init__(self, inst):
            super().__init__(inst)
            self.release, self.entered = threading.Event(), threading.Event()

        def check_once(self):
            self.entered.set()
            self.release.wait(WAIT)
            return pkg.base.CheckResult(self.NAME, reason="finally fine")

    s = make(pkg, clock, workers=2, hang_timeout=30.0)
    comp = Wedged(pkg.base.TpudInstance(scheduler=s))
    marked = threading.Event()
    mark = comp._mark_check_stale
    comp._mark_check_stale = lambda elapsed: (mark(elapsed), marked.set())
    try:
        comp.start()
        assert comp._job is not None and comp._thread is None
        s.start()
        assert comp.entered.wait(WAIT)
        clock.advance(31.0)
        nudge(s)
        assert marked.wait(WAIT)
        assert comp.last_health_states()[0].health == "Degraded"
        stale = comp.last_health_states()[0].reason
        comp.release.set()
        wait_until(s, lambda: comp.last_health_states()[0].health == "Healthy", "real result")
    finally:
        comp.close()
        s.close()
    assert "check stale" in stale


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_close_without_start_and_twice_is_safe(pkg):
    s = pkg.scheduler.Scheduler()
    s.close()
    s.close()
    assert s.wait_first_runs(timeout=0.0) is None


def test_add_job_rejects_what_the_reference_rejects():
    for pkg in PKGS:
        s = pkg.scheduler.Scheduler()
        with pytest.raises(ValueError, match="give interval OR interval_fn"):
            s.add_job("x", lambda: None)
        s.add_job("x", lambda: None, interval=1.0)
        with pytest.raises(ValueError, match="job already scheduled: x"):
            s.add_job("x", lambda: None, interval=1.0)
        s.close()


def test_the_scheduler_s_metrics_have_the_reference_s_names():
    for attr in ("_g_jobs", "_g_queue_depth", "_g_workers", "_g_workers_busy",
                 "_g_startup_ready", "_h_dispatch_lag", "_c_runs", "_c_failures",
                 "_c_watchdog", "_c_saturation"):
        r, p = getattr(REF.scheduler, attr), getattr(PORT.scheduler, attr)
        assert (p.name, p.help_text) == (r.name, r.help_text), attr
