"""Both packages' chaos harnesses side by side, for the campaign parity
tests (tests/test_torch_chaos_parity*.py, tests/test_torch_chaos_long*.py).

``daemons(names)`` (a module fixture's body) boots each named package's
``Server`` on its mock accelerator (eight TPU chips, eight H100s) with a
fake control plane of its own package (the reference's on aiohttp, the
port's on its standard-library listener), its fleet rollup attached, and
the reference's tightened circuit and replay knobs (``KNOBS``, bench.py
bench_chaos): the harness of the reference's ``python bench.py --chaos``.
Each plane binds 127.0.0.1:0; the outside probes are stubbed and
network-latency is off. ``run(srv, name)`` runs one shipped campaign and
returns its result with the steps it ran per action (the
``tpud_chaos_steps_injected_total`` delta), ``verdict(res)`` what two
packages' runs must share: passed, error, and per phase its name, steps,
step errors and the ordered (kind, ok) of its expectations.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import pytest

from torch_parity import stub_host_probes

WAIT = 30.0
TOKEN = "chaos-bench-token"
# bench.py:409-419: the outbox-replay and reconnect-storm walks fit their
# expectation windows only with these
KNOBS = dict(
    session_circuit_failure_threshold=3,
    session_circuit_open_seconds=6.0,
    outbox_replay_interval_seconds=0.5,
    outbox_replay_jitter_seconds=0.5,
)
# the nine campaigns that take under 4 s each on a CPU test box, and the
# four that wait out a partition or a failover
SHORT = ("flap-storm-retention", "fleet-predict-ramp", "fleet-rollup-storm", "ici-link-degrade",
         "ingest-storm-crash", "manager-kill-rebuild", "runtime-crash-mid-remediation",
         "session-disconnect-storm", "thermal-ici-cascade")
LONG = ("manager-failover", "precursor-ramp", "session-outbox-replay", "session-reconnect-storm")


def _modules(pkg: str):
    if pkg == "ref":
        from gpud_tpu.chaos.fake_plane import FakeControlPlane
        from gpud_tpu.config import default_config
        from gpud_tpu.server.server import Server
    else:
        from gpud_tpu_torch.chaos.fake_plane import FakeControlPlane
        from gpud_tpu_torch.config import default_config
        from gpud_tpu_torch.server.server import Server
    return FakeControlPlane, default_config, Server


def daemons(tmp_path_factory, pkgs=("ref", "port")) -> Iterator[Dict[str, tuple]]:
    """(server, plane) per package; everything stopped after."""
    mp = pytest.MonkeyPatch()
    stub_host_probes(mp)
    mp.setenv("TPUD_TPU_MOCK_ALL_SUCCESS", "1")
    mp.setenv("TPUD_GPU_MOCK_ALL_SUCCESS", "1")
    mp.setenv("TPUD_LISTEN_HOST", "127.0.0.1")
    built: Dict[str, tuple] = {}
    try:
        for pkg in pkgs:
            plane_cls, default_config, server_cls = _modules(pkg)
            tmp = tmp_path_factory.mktemp(f"chaos-{pkg}")
            kmsg = tmp / "kmsg"
            kmsg.write_text("")
            cp = plane_cls()
            cp.attach_rollup()
            cp.start()
            built[pkg] = (None, cp)
            cfg = default_config(
                data_dir=str(tmp / "data"), port=0, tls=False, kmsg_path=str(kmsg),
                endpoint=f"http://127.0.0.1:{cp.port}", token=TOKEN,
                machine_id=f"chaos-{pkg}", components_disabled=["network-latency"], **KNOBS)
            srv = server_cls(config=cfg)
            built[pkg] = (srv, cp)
            srv.start()
            assert cp.connected.wait(WAIT), f"{pkg}: the session never reached its plane"
            assert srv.scheduler.wait_first_runs(timeout=WAIT) is not None
            srv.chaos.plane = cp
        yield built
    finally:
        for srv, cp in built.values():
            if srv is not None:
                srv.stop()
            cp.stop()
        mp.undo()


def _steps(registry, scenario: str) -> Dict[str, float]:
    for m in registry.all_metrics():
        if m.name == "tpud_chaos_steps_injected_total":
            out = {}
            for key, v in m.labels_values():
                labels = dict(key)
                if labels.get("scenario") == scenario:
                    out[labels["action"]] = v
            return out
    return {}


def run(srv, name: str) -> Tuple[dict, Dict[str, float]]:
    before = _steps(srv.metrics_registry, name)
    res, err = srv.chaos.run_campaign(name, wait=True)
    assert err is None, err
    after = _steps(srv.metrics_registry, name)
    return res, {a: n - before.get(a, 0.0) for a, n in after.items() if n - before.get(a, 0.0)}


def verdict(res: dict) -> tuple:
    return (res["passed"], res["error"], [
        (p["name"], p["steps_executed"], len(p["step_errors"]),
         [(e["kind"], e["ok"]) for e in p["expectations"]])
        for p in res["phases"]])


def failures(res: dict) -> list:
    return [(p["name"], e["kind"], e["detail"]) for p in res["phases"]
            for e in p["expectations"] if not e["ok"]] + \
        [(p["name"], "step", s) for p in res["phases"] for s in p["step_errors"]]


def latencies_within_bounds(sc, res: dict) -> None:
    """Every measured latency (detect, fabric) lies within its phase's
    longest wait: the scenario's detect timeout or an expectation's
    ``within``."""
    for phase, got in zip(sc.phases, res["phases"]):
        bound = max([sc.detect_timeout] + [
            float(spec.get("within", 0.0)) for spec in phase.expect.values()
            if isinstance(spec, dict)])
        for e in got["expectations"]:
            lat = e.get("latency_seconds")
            if lat is not None:
                assert 0.0 <= lat <= bound, (phase.name, e)


def journaled(srv, kind: str) -> list:
    """(dedupe_key, payload) of the daemon's outbox records of ``kind``."""
    pkg = type(srv).__module__.split(".")[0]
    wire = __import__(f"{pkg}.session.wire", fromlist=["unpack_obj"])
    table = __import__(f"{pkg}.session.outbox", fromlist=["TABLE"]).TABLE
    srv.outbox.flush()
    rows = srv.outbox.db.query(
        f"SELECT dedupe_key, payload FROM {table} WHERE kind = ? ORDER BY seq", (kind,))
    return [(k, wire.unpack_obj(p)) for k, p in rows]



def expanded_steps(sc) -> Dict[str, float]:
    """Occurrences per action of a scenario's expanded timeline: what a
    run's step counter must show."""
    from gpud_tpu_torch.chaos.scenario import expand_steps

    out: Dict[str, float] = {}
    for p in sc.phases:
        for o in expand_steps(p.steps, key_prefix=f"{sc.name}:{p.name}"):
            out[o.action] = out.get(o.action, 0.0) + 1.0
    return out


def check_campaign(pair, name: str) -> None:
    """``name`` on both packages of ``pair``: the same verdicts, the
    port's a pass, the same steps per action (its expanded timeline's),
    every latency within its bound."""
    from gpud_tpu.chaos import scenario as ref_scenario
    from gpud_tpu_torch.chaos import scenario as port_scenario

    got = {pkg: run(pair[pkg][0], name) for pkg in ("ref", "port")}
    (ref, ref_steps), (port, port_steps) = got["ref"], got["port"]
    assert verdict(port) == verdict(ref), (failures(ref), failures(port))
    assert port["passed"], failures(port)
    assert port_steps == ref_steps == expanded_steps(port_scenario.load_scenario(name))
    latencies_within_bounds(ref_scenario.load_scenario(name), ref)
    latencies_within_bounds(port_scenario.load_scenario(name), port)


def check_on_port(built, name: str) -> None:
    """``name`` on the port alone: every expectation passed, its expanded
    timeline's steps per action, every latency within its bound."""
    from gpud_tpu_torch.chaos.scenario import load_scenario

    res, steps = run(built["port"][0], name)
    assert res["passed"], failures(res)
    sc = load_scenario(name)
    assert steps == expanded_steps(sc)
    latencies_within_bounds(sc, res)
