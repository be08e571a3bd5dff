"""Parity of the port's remediation plane (gpud_tpu_torch/remediation/:
audit, actions, engine) with gpud_tpu's.

Each case drives an engine of each package over fake components on an
injected clock (``RemediationEngine.time_now_fn``), with stub executors, and
compares what the scans return, the audit table and the engine's status:
dry_run, executed, failed, blocked_rate_limit, blocked_reboot_window,
escalated and manual, and the cooldown. Names that differ by design are
mapped first (tests/torch_parity.py: the runtime check's name, its unit and
CHECK_USER_APP_AND_TPU). The cases of the reference's
tests/test_remediation.py. Durations are wall times and are left out."""

import pytest

from torch_daemon_parity import PKGS, PORT, REF, Clock, rows, schema
from torch_parity import ACTIONS, COMPONENTS, unit_names

REBOOT, INSPECT, RETRIGGER = "REBOOT_SYSTEM", "HARDWARE_INSPECTION", "CHECK_USER_APP_AND_TPU"
IGNORE = "IGNORE_NO_ACTION_REQUIRED"
RUNTIME = "accelerator-tpu-runtime"


def port_name(pkg, s):
    """A reference noun as ``pkg`` spells it."""
    if pkg is REF or not isinstance(s, str):
        return s
    return ACTIONS.get(s, COMPONENTS.get(s, unit_names(s)))


def mapped(obj):
    """The reference's output with its nouns as the port spells them."""
    if isinstance(obj, dict):
        return {mapped(k): mapped(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(mapped(v) for v in obj)
    return port_name(PORT, obj)


def fake_comp_class(pkg):
    T = pkg.types

    class FakeComp:
        def __init__(self, name, health="Unhealthy", actions=(REBOOT,), reason="broken"):
            self._name = port_name(pkg, name)
            self.checked = self.healthy_set = 0
            self.check_recovers = False
            self.set_state(health, actions, reason)

        def set_state(self, health, actions=(), reason=""):
            acts = [port_name(pkg, a) for a in actions]
            sa = T.SuggestedActions(description=reason, repair_actions=acts) if acts else None
            self.states = [T.HealthState(component=self._name, health=health, reason=reason,
                                         suggested_actions=sa)]

        def name(self):
            return self._name

        def last_health_states(self):
            return list(self.states)

        def check(self):
            self.checked += 1
            if self.check_recovers:
                self.set_state("Healthy", (), "recovered")
                return pkg.base.CheckResult(self._name, health="Healthy")
            return pkg.base.CheckResult(self._name, health="Unhealthy", reason="still broken")

        def set_healthy(self):
            self.healthy_set += 1
            self.set_state("Healthy", (), "cleared")

    return FakeComp


class FakeRegistry:
    def __init__(self, comps):
        self.comps = list(comps)

    def all(self):
        return list(self.comps)

    def get(self, name):
        return next((c for c in self.comps if c.name() == name), None)


class FakeRebootStore:
    def __init__(self, events):
        self.events = list(events)

    def get_reboot_events(self, since):
        return [t for t in self.events if t >= since]


class World:
    """One package's engine over fake components, stub executors and a
    fake clock, built from the reference's nouns."""

    def __init__(self, pkg, db, comps, soft_repairs=(), reboot_events=None, run_ok=True,
                 reboot_ok=True, **policy):
        self.pkg, self.clock = pkg, Clock()
        FakeComp = fake_comp_class(pkg)
        self.comps = {name: FakeComp(name, *args) for name, *args in comps}
        self.calls = {"run": [], "reboot": 0}

        def run_command_fn(argv, timeout=0, env=None):
            self.calls["run"].append(list(argv))
            return pkg.RunResult(exit_code=0, output="ok") if run_ok else \
                pkg.RunResult(exit_code=1, output="unit failed to restart")

        def reboot_fn():
            self.calls["reboot"] += 1
            return None if reboot_ok else "reboot command failed"

        if "enforce_actions" in policy:
            policy["enforce_actions"] = list(policy["enforce_actions"])
        self.engine = pkg.engine.RemediationEngine(
            registry=FakeRegistry(self.comps.values()), db=db,
            policy=pkg.policy.Policy(**policy),
            reboot_event_store=None if reboot_events is None else FakeRebootStore(
                [self.clock() + t for t in reboot_events]),
            soft_repairs=None if soft_repairs is None else {
                port_name(pkg, k): v for k, v in dict(soft_repairs).items()},
            run_command_fn=run_command_fn, reboot_fn=reboot_fn)
        self.engine.time_now_fn = self.clock
        self.engine.audit.time_now_fn = self.clock

    def scan(self):
        return [{k: v for k, v in r.items() if k != "duration_seconds"}
                for r in self.engine.scan_once()]

    def comp(self, name):
        return self.comps[name]

    def outcome(self):
        audit = [{k: v for k, v in r.items() if k != "duration_seconds"}
                 for r in self.engine.audit.read()]
        return audit, self.engine.status(), dict(self.calls)


def s_dry_run(w):
    return [w.scan()]


def s_cooldown(w):
    out = [w.scan()]
    w.clock.advance(30)
    out.append(w.scan())
    w.clock.advance(300)
    out.append(w.scan())
    return out


def s_retrigger(w):
    out = [w.scan(), w.comp("c1").checked]
    w.comp("c1").check_recovers = True
    w.clock.advance(400)
    return out + [w.scan()]


def s_set_healthy(w):
    return [w.scan(), w.comp("sticky").healthy_set]


def s_reboot_window(w):
    out = [w.scan()]
    w.clock.advance(120)
    out.append(w.scan())
    w.clock.advance(3700)
    return out + [w.scan()]


def s_escalate(w):
    out = []
    for _ in range(3):
        out.append(w.scan())
        w.clock.advance(120)
    out += [w.scan()]
    w.clock.advance(600)
    return out + [w.scan()]


def s_escalation_clears(w):
    out = [w.scan()]
    w.comp(RUNTIME).set_state("Healthy", (), "recovered")
    out.append(w.scan())
    w.comp(RUNTIME).set_state("Unhealthy", (REBOOT,), "again")
    w.clock.advance(7200)
    return out + [w.scan()]


SOFT = {RUNTIME: "restart_runtime"}
CASES = {
    # name: (components, engine options, scenario)
    "default_dry_run": ([("c1",)], {}, s_dry_run),
    "healthy_and_ignored": ([("ok", "Healthy", ()), ("ign", "Unhealthy", (IGNORE,)),
                             ("pred", "Degraded", ("PREDICTED_DEGRADATION",))], {}, s_dry_run),
    "inspection_is_manual": ([("c1", "Unhealthy", (INSPECT,))], {}, s_dry_run),
    "cooldown": ([("c1",)], {"cooldown_seconds": 300.0}, s_cooldown),
    "cooldown_per_component": ([("a",), ("b",), ("c", "Degraded", (INSPECT, REBOOT))],
                               {"cooldown_seconds": 300.0}, s_cooldown),
    "reboot_executes": ([("c1",)], {"enforce_actions": ["reboot_system"]}, s_dry_run),
    "reboot_fails": ([("c1",)], {"enforce_actions": ["reboot_system"], "reboot_ok": False}, s_dry_run),
    "restart_runtime": ([(RUNTIME,)], {"soft_repairs": SOFT,
                                       "enforce_actions": ["restart_runtime"]}, s_dry_run),
    "default_soft_repair": ([(RUNTIME,)], {"soft_repairs": None,
                                           "enforce_actions": ["restart_runtime"]}, s_dry_run),
    "retrigger_check": ([("c1", "Unhealthy", (RETRIGGER,))],
                        {"enforce_actions": ["retrigger_check"]}, s_retrigger),
    "set_healthy": ([("sticky",)], {"soft_repairs": {"sticky": "set_healthy"},
                                    "enforce_actions": ["set_healthy"]}, s_set_healthy),
    "rate_limit": ([("a",), ("b",)], {"enforce_actions": ["reboot_system"], "rate_capacity": 1,
                                      "rate_refill_seconds": 600.0, "max_reboots": 10}, s_dry_run),
    "dry_run_takes_no_tokens": ([(f"c{i}",) for i in range(4)], {"rate_capacity": 1}, s_dry_run),
    "reboot_window": ([("c1",)], {"enforce_actions": ["reboot_system"], "max_reboots": 1,
                                  "reboot_window_seconds": 3600.0, "cooldown_seconds": 60.0,
                                  "rate_capacity": 10}, s_reboot_window),
    "completed_reboots_count": ([("c1",)], {"reboot_events": [-60.0], "max_reboots": 1,
                                            "enforce_actions": ["reboot_system"]}, s_dry_run),
    "escalation": ([(RUNTIME,)], {"run_ok": False, "soft_repairs": SOFT,
                                  "enforce_actions": ["restart_runtime"], "escalation_threshold": 3,
                                  "escalation_window_seconds": 3600.0, "cooldown_seconds": 60.0,
                                  "rate_capacity": 100}, s_escalate),
    "escalation_clears": ([(RUNTIME,)], {"run_ok": False, "soft_repairs": SOFT,
                                         "enforce_actions": ["restart_runtime"],
                                         "escalation_threshold": 1, "cooldown_seconds": 60.0},
                          s_escalation_clears),
}

OUTCOMES = {
    "default_dry_run": ["dry_run"], "inspection_is_manual": ["manual"],
    "reboot_executes": ["executed"], "reboot_fails": ["failed"],
    "restart_runtime": ["executed"], "default_soft_repair": ["executed"],
    "retrigger_check": ["executed", "failed"], "set_healthy": ["executed"],
    "rate_limit": ["blocked_rate_limit", "executed"],
    "dry_run_takes_no_tokens": ["dry_run"] * 4,
    "reboot_window": ["executed", "blocked_reboot_window", "executed"],
    "completed_reboots_count": ["blocked_reboot_window"],
    "escalation": ["escalated", "failed", "failed"],
    "escalation_clears": ["escalated", "escalated"],
    "healthy_and_ignored": [], "cooldown": ["dry_run", "dry_run"],
    "cooldown_per_component": ["manual", "dry_run", "dry_run"] * 2,
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_engine_decides_as_the_reference(tmp_path, case):
    comps, opts, scenario = CASES[case]
    got = {}
    for pkg in PKGS:
        db = pkg.sqlite.DB(str(tmp_path / f"{pkg.name}.state"))
        try:
            w = World(pkg, db, comps, **opts)
            got[pkg.name] = (scenario(w), w.outcome(), rows(db, "tpud_remediation_audit_v0_1"))
        finally:
            db.close()
    ref, port = got["ref"], got["port"]
    assert port[0] == mapped(ref[0])
    assert port[1] == mapped(ref[1])
    # the audit table row for row, but for the measured durations
    assert [r[:-1] for r in port[2]] == mapped([r[:-1] for r in ref[2]])
    assert [a["outcome"] for a in port[1][0]] == OUTCOMES[case]


def test_the_audit_table_is_the_reference_s(tmp_path):
    got = {}
    for pkg in PKGS:
        db = pkg.sqlite.DB(str(tmp_path / f"{pkg.name}.state"))
        pkg.audit.AuditStore(db)
        got[pkg.name] = schema(db)
        db.close()
    assert got["port"] == got["ref"] and "tpud_remediation_audit_v0_1" in got["port"]


@pytest.mark.parametrize("with_writer", [False, True], ids=["sync", "writer"])
def test_audit_reads_filters_and_retention(tmp_path, with_writer):
    got = {}
    for pkg in PKGS:
        db = pkg.sqlite.DB(str(tmp_path / f"{pkg.name}.state"))
        w = pkg.writer.BatchWriter(db) if with_writer else None
        clock = Clock()
        store = pkg.audit.AuditStore(db, retention_seconds=3600, writer=w)
        store.time_now_fn = clock
        hooked = []
        store.on_record = hooked.append
        for i, outcome in enumerate(["dry_run", "executed", "failed", "manual", "dry_run"]):
            store.record(component=f"c{i % 2}", action=["reboot_system", "set_healthy"][i % 2],
                         suggested="REBOOT_SYSTEM", trigger_health="Unhealthy",
                         trigger_reason="r", decision="d", outcome=outcome, ts=clock() + i)
        reads = [store.read(), store.read(component="c0"), store.read(outcome="executed"),
                 store.read(action="set_healthy", limit=1), store.read(since=1003.0)]
        counts = [store.count(outcomes=["failed", "executed"]), store.count(component="c1"),
                  store.count(action="reboot_system", since=1001.0)]
        anchors = [store.last_attempt_time("c0"), store.last_attempt_time("c0", action="set_healthy"),
                   store.last_attempt_time("c1", exclude_action="set_healthy"),
                   store.last_attempt_time("none")]
        summary = store.summary()
        clock.advance(7200)
        store.purge_once()
        got[pkg.name] = (hooked, reads, counts, anchors, summary, store.read())
        if w is not None:
            w.close()
        db.close()
    assert got["port"] == got["ref"]
    assert got["port"][4] == {"attempts_total": 5,
                              "by_outcome": {"dry_run": 2, "executed": 1, "failed": 1, "manual": 1}}


def test_audit_rows_survive_a_restart(tmp_path):
    got = {}
    for pkg in PKGS:
        path = tmp_path / f"{pkg.name}.state"
        db = pkg.sqlite.DB(str(path))
        World(pkg, db, [("c1",)]).scan()
        db.close()
        db2 = pkg.sqlite.DB(str(path))
        store = pkg.audit.AuditStore(db2)
        got[pkg.name] = ([{k: v for k, v in r.items() if k != "duration_seconds"}
                          for r in store.read()], store.summary())
        db2.close()
    assert got["port"] == got["ref"]


def test_the_renamed_defaults_are_the_reference_s_mapped():
    assert PORT.engine.DEFAULT_SOFT_REPAIRS == mapped(REF.engine.DEFAULT_SOFT_REPAIRS) == {
        "accelerator-gpu-runtime": "restart_runtime"}
    assert PORT.actions.DEFAULT_RUNTIME_UNIT == unit_names(REF.actions.DEFAULT_RUNTIME_UNIT) \
        == "nvidia-fabricmanager.service"
    from gpud_tpu_torch.components.gpu import runtime

    assert PORT.actions.DEFAULT_RUNTIME_UNIT == runtime.RUNTIME_UNITS[0]
    assert runtime.RUNTIME_NAME in PORT.engine.DEFAULT_SOFT_REPAIRS


@pytest.mark.parametrize("unit", ["", "custom.service"])
def test_the_runtime_unit_executor(unit):
    got = {}
    for pkg in PKGS:
        calls = []
        ex = pkg.actions.Executors(runtime_unit=unit, run_command_fn=lambda argv, timeout=0: (
            calls.append((argv, timeout)) or pkg.RunResult(exit_code=1, error="denied")))
        got[pkg.name] = (ex.restart_runtime("c"), calls, ex.reboot_system.__name__)
    assert got["port"] == mapped(got["ref"])


def test_executors_never_raise():
    for pkg in PKGS:
        class Boom:
            def name(self):
                return "boom"

            def check(self):
                raise RuntimeError("no")

            def set_healthy(self):
                raise RuntimeError("no")

        def bad_reboot():
            raise OSError("denied")

        ex = pkg.actions.Executors(registry=FakeRegistry([Boom()]), reboot_fn=bad_reboot)
        assert ex.retrigger_check("boom") == (False, "check raised: no")
        assert ex.set_healthy("boom") == (False, "set_healthy raised: no")
        assert ex.retrigger_check("nope") == (False, "component 'nope' not found")
        assert ex.reboot_system("boom") == (False, "reboot raised: denied")


def test_a_failing_component_becomes_a_scan_warning(tmp_path):
    got = {}
    for pkg in PKGS:
        db = pkg.sqlite.DB(str(tmp_path / f"{pkg.name}.state"))
        es = pkg.eventstore.EventStore(db)

        class Gone:
            def name(self):
                return "gone"

            def last_health_states(self):
                raise KeyError("deregistered")

        eng = pkg.engine.RemediationEngine(registry=FakeRegistry([Gone()]), db=db, event_store=es)
        eng.time_now_fn = Clock()
        got[pkg.name] = (eng.scan_once(), [e.to_dict() for e in es.bucket("gone").get(0)])
        db.close()
    assert got["port"] == got["ref"] and got["port"][1][0]["name"] == "remediation_scan_error"


@pytest.mark.parametrize("pkg", PKGS, ids=["ref", "port"])
def test_the_scan_runs_as_a_scheduler_job(pkg, tmp_path):
    db = pkg.sqlite.DB(str(tmp_path / "s.state"))
    s = pkg.scheduler.Scheduler()
    s.time_fn = Clock()
    eng = pkg.engine.RemediationEngine(registry=FakeRegistry([]), db=db, interval_seconds=2.0)
    eng.start(s)
    eng.start(s)
    job = s.get_job("remediation-scan")
    assert job is not None and job.due == 1002.0 and not job.startup
    eng.close()
    assert s.job_names() == []
    db.close()
