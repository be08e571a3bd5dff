"""Chaos fault actions: what a scenario step does to the live daemon; the
port of ``gpud_tpu/chaos/faults.py``.

Every action is ``fn(server, step, ctx) -> Optional[str]`` (error string
or None). ``ctx`` is the runner's campaign context: it carries the
injectable clock (``ctx.time_fn``), the optional fake control plane
handle (``ctx.plane``) and a ``ctx.cleanups`` list — every action that
mutates daemon state MUST register an undo there so a campaign always
leaves the daemon as it found it, pass or fail.

Fault classes beyond the classic one-shot kmsg write:

  - ``inject``       — kmsg write, with burst/flap via ``repeat`` +
                       ``interval_seconds`` (fault_injector.Request)
  - ``metric_ramp``  — slow-ramp telemetry fault through the
                       ``telemetry_fn`` override hook on the GPU memory /
                       temperature components (gradual temperature climb)
  - ``runtime_crash``— the runtime component reports its unit failed for
                       ``duration`` seconds (kill/restart race against
                       the remediation engine)
  - ``clock_skew``   — shifts a component's (or the remediation
                       engine's) injectable clock by ``offset`` seconds
  - ``plane_disconnect`` — drops control-plane sessions on the fake
                       plane harness (disconnect/reconnect storms)
  - ``fabric_latency_ramp`` — slow-ramp ONE mesh link's probe latency
                       through the fabric plane's ``telemetry_fn`` hook
                       (quiet NVLink degradation)
  - ``fabric_link_down`` — hard-down one physical NVLink port (a
                       ``links_fn`` snapshot rewrite over the adapter's
                       port walk, NVML or mock)

plus campaign helpers: ``trigger`` (poke a check), ``set_healthy``,
``remediation_scan`` (poke the engine), ``predict_scan`` (synchronous
precursor-scoring tick), ``fabric_sweep`` (one all-links sweep now),
``purge`` (retention pass now).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

from gpud_tpu_torch.fault_injector import Request as InjectRequest
from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)


def _component(server, step: Dict):
    name = step.get("component", "")
    comp = server.registry.get(name)
    if comp is None:
        return None, f"component {name!r} not registered"
    return comp, None


def act_inject(server, step: Dict, ctx) -> Optional[str]:
    req = InjectRequest(
        gpu_error_name=step.get("name", ""),
        gpu_id=int(step.get("gpu_id", 0)),
        detail=str(step.get("detail", "")),
        kernel_message=step.get("kernel_message", ""),
        repeat=int(step.get("repeat", 1)),
        interval_seconds=float(step.get("interval_seconds", 0.0)),
    )
    res = server.fault_injector.inject(req)
    return None if res.ok else res.error


def act_metric_ramp(server, step: Dict, ctx) -> Optional[str]:
    """Gradual metric climb: wraps the component's ``telemetry_fn`` hook
    so every GPU's ``field`` reads as a start→end interpolation over
    ``ramp_seconds`` (then holds at ``end`` until cleared). Telemetry
    objects are copied per call — the sampler's cache is never mutated."""
    comp, err = _component(server, step)
    if err:
        return err
    if not hasattr(comp, "telemetry_fn"):
        return f"component {step.get('component')!r} has no telemetry hook"
    prev_fn = comp.telemetry_fn  # may be None = "read the live sampler"
    base_fn = prev_fn or comp.sampler.telemetry
    fld = step.get("field", "temperature_c")
    start = float(step.get("start", 0.0))
    end = float(step.get("end", 0.0))
    ramp = float(step.get("ramp_seconds", 0.0))
    gpu = step.get("gpu_id")  # None = every GPU
    t0 = ctx.time_fn()
    time_fn = ctx.time_fn

    def ramped():
        tel = base_fn()
        frac = 1.0 if ramp <= 0 else min(1.0, (time_fn() - t0) / ramp)
        val = start + (end - start) * frac
        out = {}
        for gid, t in tel.items():
            if gpu is None or gid == int(gpu):
                if not hasattr(t, fld):
                    out[gid] = t
                    continue
                out[gid] = dataclasses.replace(t, **{fld: val})
            else:
                out[gid] = t
        return out

    comp.telemetry_fn = ramped
    ctx.cleanups.append(lambda: setattr(comp, "telemetry_fn", prev_fn))
    _poke(comp, server)
    return None


def act_metric_clear(server, step: Dict, ctx) -> Optional[str]:
    comp, err = _component(server, step)
    if err:
        return err
    if not hasattr(comp, "telemetry_fn"):
        return f"component {step.get('component')!r} has no telemetry hook"
    comp.telemetry_fn = None  # back to the live sampler read
    _poke(comp, server)
    return None


def act_runtime_crash(server, step: Dict, ctx) -> Optional[str]:
    """The runtime component reports its unit failed until ``duration``
    elapses — the mid-remediation race: the engine's scan sees the
    failure, decides (dry-run by default) a restart, and the 'crash'
    clears underneath it."""
    name = step.get("component", "accelerator-gpu-runtime")
    comp = server.registry.get(name)
    if comp is None:
        return f"component {name!r} not registered"
    if not hasattr(comp, "chaos_fail_until"):
        return f"component {name!r} has no crash hook"
    duration = float(step.get("duration", 2.0))
    prev = comp.chaos_fail_until
    comp.chaos_fail_until = ctx.time_fn() + duration
    ctx.cleanups.append(lambda: setattr(comp, "chaos_fail_until", prev))
    _poke(comp, server)
    return None


def act_clock_skew(server, step: Dict, ctx) -> Optional[str]:
    """Shift an injectable clock by ``offset`` seconds. ``target`` is a
    component name or ``remediation``. The daemon must keep its cadence
    and never crash under skew — that is what the invariants assert."""
    offset = float(step.get("offset", 0.0))
    target = step.get("target", "") or step.get("component", "")
    if target == "remediation":
        eng = server.remediation
        if eng is None:
            return "remediation engine disabled"
        holder = eng
    else:
        holder = server.registry.get(target)
        if holder is None:
            return f"clock_skew target {target!r} not found"
    base: Callable[[], float] = getattr(holder, "time_now_fn", None)
    if base is None:
        return f"clock_skew target {target!r} has no injectable clock"
    holder.time_now_fn = lambda: base() + offset
    ctx.cleanups.append(lambda: setattr(holder, "time_now_fn", base))
    return None


def act_plane_disconnect(server, step: Dict, ctx) -> Optional[str]:
    """Drop every live control-plane session on the fake plane harness
    (the agent's session loop must reconnect). Requires the campaign to
    be driven with a ``FakeControlPlane`` handle (bench --chaos or the
    e2e tests); a daemon with no plane attached reports the gap."""
    plane = ctx.plane
    if plane is None:
        return "no fake control plane attached to this campaign"
    dropped = plane.drop_all()
    logger.info("chaos: dropped %d control-plane session(s)", dropped)
    return None


def act_plane_refuse(server, step: Dict, ctx) -> Optional[str]:
    """Hard-down manager: the fake plane 503s every session connect for
    ``duration`` seconds (0 = until phase cleanup), then live sessions
    are dropped so the agent actually re-enters its connect loop and the
    circuit breaker sees consecutive failures. Cleanup always un-refuses."""
    plane = ctx.plane
    if plane is None:
        return "no fake control plane attached to this campaign"
    if not hasattr(plane, "refuse_connects"):
        return "attached control plane has no refuse_connects knob"
    if step.get("resume"):
        # scripted recovery mid-campaign (cleanups only run at the end)
        plane.refuse_connects = False
        logger.info("chaos: control plane accepting connects again")
        return None
    duration = float(step.get("duration", 0.0))
    plane.refuse_connects = True
    plane.drop_all()

    def _recover() -> None:
        plane.refuse_connects = False

    ctx.cleanups.append(_recover)
    if duration > 0:
        timer = threading.Timer(duration, _recover)
        timer.daemon = True
        timer.start()
        ctx.cleanups.append(timer.cancel)
    logger.info("chaos: control plane refusing connects (duration=%gs)", duration)
    return None


def _fabric_plane(server):
    plane = getattr(server, "fabric", None)
    if plane is None:
        return None, "fabric plane disabled (fabric_sweep_enabled)"
    return plane, None


def act_fabric_latency_ramp(server, step: Dict, ctx) -> Optional[str]:
    """Quiet NVLink degradation: wraps the fabric plane's ``telemetry_fn``
    probe so ``link``'s latency reads as a start→end interpolation over
    ``ramp_seconds`` (then holds at ``end``) while every other link keeps
    its base reading — the EWMA baseline must flag exactly that link."""
    plane, err = _fabric_plane(server)
    if err:
        return err
    target = str(step.get("link", ""))
    if not target:
        return "fabric_latency_ramp needs a `link` (e.g. gpu0/nvlink0)"
    prev_fn = plane.telemetry_fn  # may be None = synthetic probe
    base_fn = prev_fn or plane.synthetic_latency
    start = float(step.get("start", 0.0))
    end = float(step.get("end", 0.0))
    ramp = float(step.get("ramp_seconds", 0.0))
    t0 = ctx.time_fn()
    time_fn = ctx.time_fn

    def ramped(link):
        if link.name != target:
            return base_fn(link)
        frac = 1.0 if ramp <= 0 else min(1.0, (time_fn() - t0) / ramp)
        return start + (end - start) * frac

    plane.telemetry_fn = ramped
    ctx.cleanups.append(lambda: setattr(plane, "telemetry_fn", prev_fn))
    return None


def act_fabric_link_down(server, step: Dict, ctx) -> Optional[str]:
    """Hard-down one physical NVLink port (``port: gpuN/nvlinkL``): the
    plane's ``links_fn`` is wrapped to report that one snapshot down over
    the adapter's port walk (NVML or mock), so the sweep sees the port lost
    as it would see it on the card. A GPU's NVLink port is its mesh link
    too, so the link of the same name reads Down. Cleanup restores the
    previous ``links_fn``."""
    plane, err = _fabric_plane(server)
    if err:
        return err
    port = str(step.get("port", ""))
    if not port or "/" not in port:
        return "fabric_link_down needs a `port` (e.g. gpu0/nvlink1)"
    from gpud_tpu_torch.gpu.instance import LinkState

    prev_fn = plane.links_fn  # may be None = adapter port walk
    base_fn = prev_fn or plane.default_links

    def downed():
        out = []
        for snap in base_fn():
            if snap.name == port:
                snap = dataclasses.replace(snap, state=LinkState.DOWN)
            out.append(snap)
        return out

    plane.links_fn = downed
    ctx.cleanups.append(lambda: setattr(plane, "links_fn", prev_fn))
    return None


def act_fabric_sweep(server, step: Dict, ctx) -> Optional[str]:
    """Run one all-links fabric sweep now: campaigns pin the sweep
    timeline to the fault timeline instead of racing the cadence."""
    plane, err = _fabric_plane(server)
    if err:
        return err
    plane.sweep_once()
    return None


def act_trigger(server, step: Dict, ctx) -> Optional[str]:
    comp, err = _component(server, step)
    if err:
        return err
    _poke(comp, server, block=bool(step.get("block", False)))
    return None


def act_set_healthy(server, step: Dict, ctx) -> Optional[str]:
    comp, err = _component(server, step)
    if err:
        return err
    fn = getattr(comp, "set_healthy", None)
    if fn is None:
        return f"component {step.get('component')!r} has no set_healthy"
    fn()
    _poke(comp, server)
    return None


def act_remediation_scan(server, step: Dict, ctx) -> Optional[str]:
    eng = server.remediation
    if eng is None:
        return "remediation engine disabled"
    eng.poke()
    return None


def act_predict_scan(server, step: Dict, ctx) -> Optional[str]:
    """Run a precursor-scoring tick now: campaigns pin the scan timeline
    to the fault timeline instead of racing the configured cadence."""
    eng = getattr(server, "predictor", None)
    if eng is None:
        return "predict engine disabled"
    eng.tick_once()
    return None


def act_predict_reset(server, step: Dict, ctx) -> Optional[str]:
    """Drop the predictor's in-memory scorer state for ``component`` (or
    all components): campaign isolation — a drill must not inherit armed
    warnings from faults an earlier campaign injected."""
    eng = getattr(server, "predictor", None)
    if eng is None:
        return "predict engine disabled"
    eng.reset(component=str(step.get("component", "")))
    return None


def act_purge(server, step: Dict, ctx) -> Optional[str]:
    fn = getattr(server, "_purge_retention", None)
    if fn is None:
        return "server has no retention purge"
    scheduler = getattr(server, "scheduler", None)
    if scheduler is not None and scheduler.submit("chaos:purge", fn):
        return None
    fn()
    return None


def act_ingest_burst(server, step: Dict, ctx) -> Optional[str]:
    """Observation firehose against the live daemon's stores: ``events``
    events into ``component``'s bucket (default name ``chaos_ingest``)
    plus one metric row per event — the storm half of the
    ingest-storm-crash drill. (``count`` is taken by the step-timeline
    expansion, hence the ``events`` spelling.) Rows ride the write-behind
    layer when enabled; no cleanup is registered (retention purges them
    like any other telemetry)."""
    from gpud_tpu_torch.api.v1.types import Event, EventType

    component = step.get("component", "chaos-ingest")
    name = step.get("name", "chaos_ingest")
    count = int(step.get("events", 100))
    bucket = server.event_store.bucket(component)
    now = ctx.time_fn()
    for i in range(count):
        bucket.insert(Event(
            component=component, time=now, name=name,
            type=EventType.INFO, message=f"chaos ingest burst {i}",
        ))
        server.metrics_store.record([
            (int(now), "tpud_chaos_ingest", {"component": component}, float(i))
        ])
    return None


def act_storage_flush(server, step: Dict, ctx) -> Optional[str]:
    """Drive the write-behind flush barrier: everything buffered is
    committed before the step returns (the pre-crash durability line)."""
    writer = getattr(server, "storage_writer", None)
    if writer is None:
        return "storage batching disabled (no write-behind writer)"
    if not writer.flush(timeout=10.0):
        return "storage flush barrier timed out"
    return None


def act_storage_crash(server, step: Dict, ctx) -> Optional[str]:
    """Simulated SIGKILL mid-batch: discard the writer's in-memory buffer
    WITHOUT committing — exactly the loss window a process kill between
    group commits costs (the commits themselves are atomic; torn rows are
    impossible, which tests/test_crash_consistency.py proves with a real
    SIGKILL). The daemon keeps running so post-crash expectations can
    assert the stores stay consistent and ingest keeps working."""
    writer = getattr(server, "storage_writer", None)
    if writer is None:
        return "storage batching disabled (no write-behind writer)"
    n = writer.drop_pending(reason="chaos_crash")
    logger.info("chaos: storage_crash discarded %d buffered ops", n)
    return None


def act_manager_kill_rebuild(server, step: Dict, ctx) -> Optional[str]:
    """SIGKILL-style manager restart mid-ingest: throw away every
    in-memory rollup aggregate and dedupe LRU, then rebuild a fresh
    ``FleetRollupStore`` from the *same* journal DB via the parallel
    per-shard replay — exactly what a manager restart against the same
    ``--data-dir`` does. ``shards: N`` on the step restarts with a
    different shard count (the journal's stable crc32 slot column makes
    that safe; this is the re-partitioning oracle).

    The swap holds the fake plane's ``ingest_lock``, which every outbox
    ingest holds too — so it is atomic with respect to ingest (no record
    can land in the dying store after the rebuild snapshotted the
    journal), and the lock held for the rebuild's duration IS the
    manager's dead window: deliveries wait on their write streams and
    ingest resumes against the rebuilt store, deduped by the reseeded
    LRUs + the journal's unique index."""
    from gpud_tpu_torch.manager.rollup import FleetRollupStore

    plane = ctx.plane
    if plane is None:
        return "no fake control plane attached to this campaign"
    rollup = getattr(plane, "rollup", None)
    if rollup is None:
        return "no fleet rollup store attached (plane.attach_rollup())"
    lock = getattr(plane, "ingest_lock", None)
    if lock is None or not getattr(plane, "running", False):
        return "fake control plane not running"
    shards = int(step.get("shards", 0)) or rollup.shard_count
    try:
        with lock:
            old = plane.rollup
            writer = getattr(old, "writer", None)
            if writer is not None:
                # the kill window: buffered-but-uncommitted rows die with
                # the process (same loss model as act_storage_crash)
                writer.drop_pending(reason="chaos_manager_kill")
            plane.rollup = FleetRollupStore(
                old.db, writer,
                cache_ttl_seconds=old.cache_ttl,
                dedupe_keys_max=old.dedupe_keys_max,
                max_journal_rows=old.max_journal_rows,
                shard_count=shards,
            )
            recovered = plane.rollup.records_total()
    except Exception as e:  # noqa: BLE001 — the failure is the finding
        return f"manager kill/rebuild failed: {e}"
    logger.info(
        "chaos: manager killed and rebuilt from journal — %d records "
        "recovered across %d shard(s)", recovered, shards,
    )
    return None


def act_peer_plane_boot(server, step: Dict, ctx) -> Optional[str]:
    """HA manager tier stand-in: boot a SECOND fake control plane that
    shares the primary's delivery ledgers (outbox keys/frames/acks,
    rollup store, connected event) — two managers over one logical
    journal, like a real peer that replicated the primary's journal —
    and hand the agent's circuit breaker a ``peers`` list so its next
    trip to OPEN rotates to the peer with an immediate probe
    (docs/session.md "Peer failover"). A later ``plane_refuse`` on the
    primary then IS the manager SIGKILL: the agent must fail over to
    the surviving peer inside the breaker cooldown, and ``zero_loss`` /
    ``fleet`` expectations hold across both planes because the ledgers
    are one. Cleanup retargets the session at the primary, restores the
    breaker's peer list, and stops the peer plane."""
    from gpud_tpu_torch.chaos.fake_plane import FakeControlPlane

    plane = ctx.plane
    if plane is None:
        return "no fake control plane attached to this campaign"
    cb = getattr(server, "session_circuit", None)
    session = getattr(server, "session", None)
    if cb is None or session is None:
        return "peer failover needs a live session + circuit breaker"
    if getattr(ctx, "peer_plane", None) is not None:
        return "peer plane already booted"

    peer = FakeControlPlane()
    # one logical manager tier: the peer serves the same ledgers, so a
    # record delivered to EITHER plane counts once, dedupes once, and
    # lands in the same rollup — the chaos analogue of the replicated
    # journal a real surviving peer rebuilds from
    peer.outbox_keys = plane.outbox_keys
    peer.outbox_frames = plane.outbox_frames
    peer.outbox_acked = plane.outbox_acked
    peer.rollup = plane.rollup
    peer.connected = plane.connected
    # one ingest lock across both: the shared dedupe set's check-then-add
    # and the rollup swap stay atomic whichever plane a delivery reaches
    peer.ingest_lock = plane.ingest_lock
    peer.start()
    ctx.peer_plane = peer
    peer_endpoint = f"http://127.0.0.1:{peer.port}"

    primary_endpoint = session.endpoint
    old_peers = list(cb.peers)
    cb.peers = [primary_endpoint, peer_endpoint]

    def _undo() -> None:
        with cb._mu:  # noqa: SLF001 — chaos harness resets breaker state
            cb.peers = old_peers
            cb._peer_index = 0
            cb._failover_probe = False
            cb._sweep = 0
        session._apply_peer(primary_endpoint)  # noqa: SLF001
        ctx.peer_plane = None
        peer.stop()

    ctx.cleanups.append(_undo)
    logger.info(
        "chaos: peer manager up at %s (primary %s); breaker owns failover",
        peer_endpoint, primary_endpoint,
    )
    return None


def _poke(comp, server, block: bool = False) -> None:
    """Run the component's check now: poked to the front of the heap when
    scheduler-driven, else a direct (or one-shot) check."""
    job = getattr(comp, "_job", None)
    if job is not None and not block:
        job.poke()
        return
    if block:
        try:
            comp.check()
        except Exception:  # noqa: BLE001 — a failing check is the campaign's finding
            logger.exception("chaos trigger check failed for %s", comp.name())
        return
    scheduler = getattr(server, "scheduler", None)
    if scheduler is not None and scheduler.submit(f"chaos:check:{comp.name()}", comp.check):
        return
    try:
        comp.check()
    except Exception:  # noqa: BLE001
        logger.exception("chaos trigger check failed for %s", comp.name())


ACTIONS: Dict[str, Callable] = {
    "inject": act_inject,
    "metric_ramp": act_metric_ramp,
    "metric_clear": act_metric_clear,
    "runtime_crash": act_runtime_crash,
    "clock_skew": act_clock_skew,
    "plane_disconnect": act_plane_disconnect,
    "plane_refuse": act_plane_refuse,
    "fabric_latency_ramp": act_fabric_latency_ramp,
    "fabric_link_down": act_fabric_link_down,
    "fabric_sweep": act_fabric_sweep,
    "trigger": act_trigger,
    "set_healthy": act_set_healthy,
    "remediation_scan": act_remediation_scan,
    "predict_scan": act_predict_scan,
    "predict_reset": act_predict_reset,
    "purge": act_purge,
    "ingest_burst": act_ingest_burst,
    "storage_flush": act_storage_flush,
    "storage_crash": act_storage_crash,
    "manager_kill_rebuild": act_manager_kill_rebuild,
    "peer_plane_boot": act_peer_plane_boot,
}
