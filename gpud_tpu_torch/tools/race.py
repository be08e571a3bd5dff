"""Race harness: the chaos campaigns under lock-order instrumentation.

The closest Python gets to running the campaigns under ``go test -race``
(the reference daemon's CI): the daemon (``Server``) and the fake control
plane are built with every lock tracked by :class:`LockOrderDetector`, the
interpreter's switch interval is shrunk to 10 µs so thread interleavings
are as hostile as they get, the campaigns run one after another through the
daemon's ``ChaosManager``, and non-daemon threads and VmRSS are audited
after each one. The counterpart of the reference's race bench.

Gates (all must hold): every campaign completes without a runner error, the
global lock-order graph is acyclic, no thread blocked on a lock it already
held, and no non-daemon thread outlived the run. Chaos expectations are
reported, not gated: timing windows are not the property under test.

Run (the mock's GPUs anywhere, NVML on a GPU host)::

    TPUD_GPU_MOCK_ALL_SUCCESS=1 python -m gpud_tpu_torch.tools.race
    python -m gpud_tpu_torch.tools.race --campaigns ici-link-degrade,flap-storm-retention

It prints one ``{"race": {...}}`` line and exits 1 when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence

from gpud_tpu_torch.tools.lockcheck import LockOrderDetector

# the harness's knobs (as the chaos gate's): the outbox-replay and
# reconnect-storm walks fit their windows only with these
KNOBS = {
    "session_circuit_failure_threshold": 3,
    "session_circuit_open_seconds": 6.0,
    "outbox_replay_interval_seconds": 0.5,
    "outbox_replay_jitter_seconds": 0.5,
}
GIL_SWITCH_INTERVAL_S = 1e-5
CONNECT_WAIT_S = 15.0
LEAK_GRACE_S = 5.0


def _nondaemon_threads(baseline: set) -> List[threading.Thread]:
    """Live non-daemon threads beyond ``baseline`` (thread idents): every
    worker of the daemon is a daemon thread, so a survivor is a leak."""
    return [
        t for t in threading.enumerate()
        if t.is_alive() and not t.daemon
        and t is not threading.main_thread() and t.ident not in baseline
    ]


def _vmrss_mb() -> float:
    with open("/proc/self/status", encoding="utf-8") as f:
        for ln in f:
            if ln.startswith("VmRSS:"):
                return int(ln.split()[1]) / 1024.0
    return 0.0


def _wrap_module_locks(det: LockOrderDetector) -> None:
    """The module-global locks predate ``install()``: wrap them so their
    nestings show up in the graph."""
    import gpud_tpu_torch.log as logmod
    import gpud_tpu_torch.sqlite as sqlmod
    from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY

    det.wrap_attr(sqlmod, "_stats_mu", "sqlite._stats_mu")
    det.wrap_attr(logmod, "_mu", "log._mu")
    det.wrap_attr(DEFAULT_REGISTRY, "_mu", "metrics.Registry._mu")
    for metric in list(DEFAULT_REGISTRY._metrics.values()):
        det.wrap_attr(metric, "_mu", f"metric[{metric.name}]._mu")


def run_race(campaigns: Optional[Sequence[str]] = None,
             workdir: Optional[str] = None) -> Dict:
    """Run ``campaigns`` (default: every shipped one, in name order) against
    the daemon and its fake plane under the detector; returns the record,
    with ``ok`` set when every gate holds."""
    from gpud_tpu_torch.chaos.fake_plane import FakeControlPlane
    from gpud_tpu_torch.config import default_config

    det = LockOrderDetector()
    # collect, don't raise: a DeadlockError inside a daemon worker would
    # kill that thread and turn a report into a hung campaign
    det.raise_on_self_deadlock = False
    _wrap_module_locks(det)

    own_dir = workdir is None
    tmp = tempfile.mkdtemp(prefix="tpud-race-") if own_dir else workdir
    kmsg = os.path.join(tmp, "kmsg")
    open(kmsg, "a").close()

    baseline = {t.ident for t in threading.enumerate() if not t.daemon}
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(GIL_SWITCH_INTERVAL_S)  # GIL-preemption amplifier
    results: List[Dict] = []
    leaked: List[str] = []
    rss: List[float] = [_vmrss_mb()]
    t0 = time.monotonic()
    det.install()
    try:
        # everything below (fake plane, Server, session, outbox, shards)
        # creates its locks under instrumentation
        from gpud_tpu_torch.server.server import Server

        cp = FakeControlPlane()
        cp.attach_rollup()
        cp.start()
        cfg = default_config(
            data_dir=os.path.join(tmp, "data"), port=0, tls=False, kmsg_path=kmsg,
            endpoint=f"http://127.0.0.1:{cp.port}", token="race-token",
            machine_id="race-1", components_disabled=["network-latency"], **KNOBS,
        )
        srv = Server(config=cfg)
        try:
            srv.start()
            if not cp.connected.wait(CONNECT_WAIT_S):
                print("[race] the session never connected; plane expectations "
                      "will fail (not gated)", file=sys.stderr)
            srv.chaos.plane = cp
            names = list(campaigns) if campaigns else sorted(srv.chaos.list_scenarios())
            for name in names:
                t1 = time.monotonic()
                res, err = srv.chaos.run_campaign(name, wait=True)
                exps = [e for ph in (res or {}).get("phases", [])
                        for e in ph.get("expectations", [])]
                row = {"scenario": name, "error": err, "s": time.monotonic() - t1,
                       "passed": bool(res and res.get("passed")),
                       "expectations": [sum(bool(e.get("ok")) for e in exps), len(exps)]}
                results.append(row)
                stray = _nondaemon_threads(baseline)
                leaked.extend(f"{name}: {t.name}" for t in stray)
                rss.append(_vmrss_mb())
                print(f"[race] {name}: {'ok' if not err else 'ERROR ' + str(err)} "
                      f"in {row['s']:.1f} s, edges={len(det.edges)} "
                      f"self_deadlocks={len(det.self_deadlocks)} "
                      f"nondaemon_leaks={len(stray)} VmRSS={rss[-1]:.1f} MB",
                      file=sys.stderr, flush=True)
        finally:
            srv.stop()
            cp.stop()
    finally:
        det.uninstall()
        det.unwrap_all()
        sys.setswitchinterval(old_interval)
    wall = time.monotonic() - t0

    # give workers a joining grace; a non-daemon thread still alive leaked
    deadline = time.monotonic() + LEAK_GRACE_S
    while _nondaemon_threads(baseline) and time.monotonic() < deadline:
        time.sleep(0.05)
    leaked.extend(f"post-stop: {t.name}" for t in _nondaemon_threads(baseline))
    if own_dir:
        shutil.rmtree(tmp, ignore_errors=True)

    cycles = det.cycles()
    completed = [r for r in results if not r["error"]]
    rec = {
        "campaigns": len(results),
        "completed": len(completed),
        "expectations": [sum(r["expectations"][i] for r in results) for i in (0, 1)],
        "edges": len(det.edges),
        "cycles": cycles,
        "self_deadlocks": list(det.self_deadlocks),
        "leaked_nondaemon_threads": leaked,
        "wall_seconds": wall,
        "vmrss_mb": {"start": rss[0], "end": rss[-1], "max": max(rss)},
        "per_campaign": results,
    }
    rec["ok"] = bool(results) and len(completed) == len(results) and not cycles \
        and not det.self_deadlocks and not leaked
    if cycles or det.self_deadlocks:
        print(det.report(), file=sys.stderr)
    return rec


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--campaigns", default="",
                    help="comma-separated campaign names (default: all shipped)")
    ap.add_argument("--workdir", default=None,
                    help="directory for the daemon's data (default: a temporary one)")
    args = ap.parse_args(argv)
    names = [n for n in args.campaigns.split(",") if n]
    rec = run_race(names or None, args.workdir)
    print(json.dumps({"race": rec}), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
