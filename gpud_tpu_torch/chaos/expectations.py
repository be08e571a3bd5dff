"""Per-phase chaos expectations: did the whole chain actually hold? The
port of ``gpud_tpu/chaos/expectations.py``.

After a phase's timeline drains, the runner evaluates the phase's
``expect`` block against the live daemon. Each kind asserts one link of
the detect→ledger→remediate→audit chain, plus the graceful-degradation
invariants that hold the daemon itself to account:

  detect:       an event (eventstore) or a ledger transition appears
                within the latency bound — detection latency is measured
                from the phase's first fault step and histogrammed
  ledger:       health_history.py recorded the expected transitions
  remediation:  the engine's policy decided as expected and the audit
                ledger has the rows to prove it
  events:       eventstore contents (name/message/count)
  plane:        the agent's control-plane session reconnected
  outbox:       store-and-forward delivery held — zero loss across the
                partition, circuit-breaker transitions in order, connect
                attempts flat while the breaker is open
  fleet:        the manager-side rollup store (manager/rollup.py) agrees
                with the plane's ingest ledger — one row per accepted
                record, redeliveries deduped, per-kind counts matching
  fabric:       the fabric plane's mesh matrix blames exactly the
                faulted NVLink links (Degraded on latency deviation, Down
                on port loss) and leaves every other link Healthy
  predict:      the predict engine warned before the reactive hard
                signal (ordering + lead-time floor), and stayed silent
                on un-faulted components
  predict_lead: the manager-side fleet pane reflects the prediction —
                the faulted component ranks in the top-K of
                ``fleet_predict`` by decayed risk, warn/lead records
                survived ingest, and the fleet lead distribution
                clears its floor
  invariants:   zero unhandled worker exceptions (scheduler failure +
                watchdog counters flat), un-faulted job cadence within
                slack, thread-count and RSS gates

Everything polls on the campaign context's injectable clock
(``ctx.time_fn`` / ``ctx.sleep_fn``) so the evaluation logic itself is
unit-testable under a fake clock (tests/test_chaos.py).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from gpud_tpu_torch.log import get_logger

logger = get_logger(__name__)

POLL_INTERVAL = 0.02

# how far before the phase start the evidence queries reach: kmsg event
# times are reconstructed from boot-relative stamps (writer and watcher
# each read /proc/uptime at centisecond resolution), so an event for a
# phase-offset-0 fault can carry a timestamp a few tens of ms before the
# runner's phase_start
SINCE_SLACK = 0.25


@dataclass
class ExpectationResult:
    kind: str
    ok: bool
    detail: str = ""
    latency_seconds: Optional[float] = None
    timed_out: bool = False

    def to_dict(self) -> Dict:
        out = {"kind": self.kind, "ok": self.ok, "detail": self.detail}
        if self.latency_seconds is not None:
            out["latency_seconds"] = round(self.latency_seconds, 6)
        if self.timed_out:
            out["timed_out"] = True
        return out


def _poll(pred, deadline: float, ctx):
    """Run ``pred`` until it returns a truthy value or ``deadline``
    passes; returns the value or None."""
    while True:
        got = pred()
        if got:
            return got
        if ctx.time_fn() >= deadline:
            return None
        ctx.sleep_fn(POLL_INTERVAL)


def counter_total(registry, name: str) -> float:
    """Sum of a counter across all label sets (0.0 when unregistered)."""
    for m in registry.all_metrics():
        if m.name == name:
            return sum(v for _k, v in m.labels_values())
    return 0.0


def rss_mb() -> Optional[float]:
    try:
        with open("/proc/self/status", encoding="ascii", errors="replace") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return None


def _eval_detect(server, spec: Dict, ctx) -> ExpectationResult:
    component = spec.get("component", "")
    want_event = spec.get("event", "")
    want_state = spec.get("to", "")
    contains = spec.get("contains", "")
    within = float(spec.get("within", ctx.detect_timeout))
    since = ctx.phase_start - SINCE_SLACK
    ref = ctx.fault_t0 if ctx.fault_t0 is not None else ctx.phase_start
    deadline = ref + within

    def find():
        if want_event:
            bucket = server.event_store.bucket(component)
            for e in bucket.get(since):
                if e.name == want_event and (not contains or contains in e.message):
                    return e.time or ctx.time_fn()
        if want_state:
            for t in server.health_ledger.history(component=component, since=since):
                if t["to"] == want_state:
                    return t["time"] or ctx.time_fn()
        return None

    hit = _poll(find, deadline, ctx)
    what = want_event or f"transition→{want_state}"
    if hit is None:
        return ExpectationResult(
            "detect", False, timed_out=True,
            detail=f"{component}: {what} not detected within {within:g}s",
        )
    latency = max(0.0, float(hit) - ref)
    return ExpectationResult(
        "detect", True, latency_seconds=latency,
        detail=f"{component}: {what} detected in {latency * 1000.0:.1f}ms",
    )


def _eval_ledger(server, specs: List[Dict], ctx) -> List[ExpectationResult]:
    out = []
    since = ctx.phase_start - SINCE_SLACK
    for spec in specs:
        component = spec.get("component", "")
        to = spec.get("to", "")
        frm = spec.get("from", "")
        min_count = int(spec.get("min_count", 1))
        deadline = ctx.time_fn() + float(spec.get("within", ctx.detect_timeout))

        def matches(spec_c=component, spec_to=to, spec_from=frm, n=min_count):
            rows = [
                t
                for t in server.health_ledger.history(component=spec_c, since=since)
                if (not spec_to or t["to"] == spec_to)
                and (not spec_from or t["from"] == spec_from)
            ]
            return rows if len(rows) >= n else None

        rows = _poll(matches, deadline, ctx)
        desc = f"{component}: {frm or '*'}→{to or '*'} x{min_count}"
        if rows is None:
            out.append(ExpectationResult(
                "ledger", False, timed_out=True,
                detail=f"{desc} — not recorded",
            ))
        else:
            out.append(ExpectationResult(
                "ledger", True, detail=f"{desc} — {len(rows)} recorded",
            ))
    return out


def _eval_remediation(server, specs: List[Dict], ctx) -> List[ExpectationResult]:
    eng = server.remediation
    if eng is None:
        return [ExpectationResult(
            "remediation", False, detail="remediation engine disabled",
        )]
    eng.poke()  # the scan cadence (30s default) must not gate a campaign
    out = []
    since = ctx.phase_start - SINCE_SLACK
    for spec in specs:
        component = spec.get("component", "")
        decision = spec.get("decision", "")
        outcome = spec.get("outcome", "")
        action = spec.get("action", "")
        min_count = int(spec.get("min_count", 1))
        deadline = ctx.time_fn() + float(spec.get("within", ctx.detect_timeout))

        def matches(c=component, d=decision, o=outcome, a=action, n=min_count):
            rows = [
                r
                for r in eng.audit.read(component=c or None, since=since)
                if (not d or r["decision"] == d)
                and (not o or r["outcome"] == o)
                and (not a or r["action"] == a)
            ]
            return rows if len(rows) >= n else None

        rows = _poll(matches, deadline, ctx)
        desc = (
            f"{component or '*'}: decision={decision or '*'} "
            f"outcome={outcome or '*'} action={action or '*'} x{min_count}"
        )
        if rows is None:
            out.append(ExpectationResult(
                "remediation", False, timed_out=True,
                detail=f"{desc} — no matching audit row",
            ))
        else:
            out.append(ExpectationResult(
                "remediation", True,
                detail=f"{desc} — {len(rows)} audit row(s)",
            ))
    return out


def _eval_events(server, specs: List[Dict], ctx) -> List[ExpectationResult]:
    out = []
    since = ctx.phase_start - SINCE_SLACK
    for spec in specs:
        component = spec.get("component", "")
        name = spec.get("name", "")
        contains = spec.get("contains", "")
        count_min = int(spec.get("count_min", 1))
        deadline = ctx.time_fn() + float(spec.get("within", ctx.detect_timeout))

        def matches(c=component, nm=name, sub=contains, n=count_min):
            evs = [
                e
                for e in server.event_store.bucket(c).get(since)
                if (not nm or e.name == nm) and (not sub or sub in e.message)
            ]
            return evs if len(evs) >= n else None

        evs = _poll(matches, deadline, ctx)
        desc = f"{component} events name={name or '*'} >= {count_min}"
        if evs is None:
            out.append(ExpectationResult(
                "events", False, timed_out=True, detail=f"{desc} — absent",
            ))
        else:
            out.append(ExpectationResult(
                "events", True, detail=f"{desc} — {len(evs)} present",
            ))
    return out


def _eval_plane(server, spec: Dict, ctx) -> ExpectationResult:
    if ctx.plane is None:
        return ExpectationResult(
            "plane", False, detail="no fake control plane attached",
        )
    within = float(spec.get("within", ctx.detect_timeout))
    deadline = ctx.time_fn() + within
    if spec.get("reconnected", True):
        ok = _poll(lambda: ctx.plane.connected.is_set() or None, deadline, ctx)
        if ok is None:
            return ExpectationResult(
                "plane", False, timed_out=True,
                detail=f"session did not reconnect within {within:g}s",
            )
        return ExpectationResult("plane", True, detail="session reconnected")
    return ExpectationResult("plane", True, detail="no plane assertion")


def _eval_outbox(server, spec: Dict, ctx) -> List[ExpectationResult]:
    """Store-and-forward delivery assertions (session/outbox.py):

      zero_loss:       every record journaled since the campaign started
                       is observable at the fake control plane (dedupe
                       keys ⊆ plane.outbox_keys) and the backlog drains
                       to the acked watermark
      circuit_states:  ordered-subsequence check against the breaker's
                       transition history (e.g. [open, half_open, closed])
      connects_flat_while_open: while the circuit reads open, the plane's
                       connect/refusal counters must not move — the
                       breaker provably suppresses attempts
      replay_paced:    after a circuit recovery, the server applied a
                       non-zero replay jitter before poking the outbox
                       drain (server.last_replay_jitter_seconds > 0) —
                       the reconnect-storm stagger provably engaged
      max_total_connects: ceiling on total connect attempts that reached
                       the plane (accepted + refused) across the whole
                       campaign — an unpaced reconnect/replay storm
                       blows through it
    """
    out: List[ExpectationResult] = []
    outbox = getattr(server, "outbox", None)
    if outbox is None:
        return [ExpectationResult(
            "outbox", False, detail="outbox disabled (outbox_enabled)",
        )]
    within = float(spec.get("within", ctx.detect_timeout))

    if spec.get("zero_loss", False):
        if ctx.plane is None or not hasattr(ctx.plane, "outbox_keys"):
            out.append(ExpectationResult(
                "outbox", False,
                detail="zero_loss needs an outbox-aware fake control plane",
            ))
        else:
            from gpud_tpu_torch.session.outbox import TABLE as OUTBOX_TABLE

            since = getattr(ctx, "campaign_start", ctx.phase_start) - SINCE_SLACK
            deadline = ctx.time_fn() + within

            def journaled_keys():
                outbox.flush()
                rows = outbox.db.query(
                    f"SELECT dedupe_key FROM {OUTBOX_TABLE} WHERE ts >= ?",
                    (since,),
                )
                return {r[0] for r in rows}

            def drained():
                keys = journaled_keys()
                missing = keys - ctx.plane.outbox_keys
                if missing or outbox.backlog() > 0:
                    return None
                return (len(keys),)

            got = _poll(drained, deadline, ctx)
            if got is None:
                keys = journaled_keys()
                missing = keys - ctx.plane.outbox_keys
                out.append(ExpectationResult(
                    "outbox", False, timed_out=True,
                    detail=(
                        f"zero_loss: {len(missing)} of {len(keys)} journaled "
                        f"record(s) undelivered, backlog={outbox.backlog()} "
                        f"after {within:g}s"
                    ),
                ))
            else:
                out.append(ExpectationResult(
                    "outbox", True,
                    detail=(
                        f"zero_loss: all {got[0]} journaled record(s) "
                        "delivered, backlog drained"
                    ),
                ))

    want_states = spec.get("circuit_states")
    if want_states:
        circuit = getattr(server, "session_circuit", None)
        if circuit is None:
            out.append(ExpectationResult(
                "outbox", False, detail="no session circuit breaker",
            ))
        else:
            deadline = ctx.time_fn() + within

            def seen_in_order():
                seen = circuit.states_seen()
                i = 0
                for s in seen:
                    if i < len(want_states) and s == want_states[i]:
                        i += 1
                return (seen,) if i >= len(want_states) else None

            got = _poll(seen_in_order, deadline, ctx)
            desc = "circuit " + "→".join(want_states)
            if got is None:
                out.append(ExpectationResult(
                    "outbox", False, timed_out=True,
                    detail=f"{desc} not observed (saw: "
                           f"{'→'.join(circuit.states_seen())})",
                ))
            else:
                out.append(ExpectationResult("outbox", True, detail=desc))

    flat_seconds = float(spec.get("connects_flat_while_open", 0.0))
    if flat_seconds > 0:
        circuit = getattr(server, "session_circuit", None)
        if circuit is None or ctx.plane is None:
            out.append(ExpectationResult(
                "outbox", False,
                detail="connects_flat_while_open needs a circuit + plane",
            ))
        else:
            # wait for the breaker to open WITH enough cooldown left to
            # fit the whole sampling window, then hold it: attempts
            # reaching the plane (accepted OR refused) must stay flat
            # while it reads open. Anchoring to seconds_until_probe
            # keeps the legitimate half-open probe out of the window —
            # a probe firing mid-sample is recovery, not a leak
            def window_ready():
                if circuit.state != "open":
                    return None
                if circuit.seconds_until_probe() < flat_seconds + 0.25:
                    return None
                return (True,)

            opened = _poll(window_ready, ctx.time_fn() + within, ctx)
            if opened is None:
                out.append(ExpectationResult(
                    "outbox", False, timed_out=True,
                    detail=(
                        f"circuit never held an open window >= "
                        f"{flat_seconds:g}s within {within:g}s "
                        f"(state now: {circuit.state})"
                    ),
                ))
            else:
                def attempts():
                    return (
                        int(getattr(ctx.plane, "connects", 0))
                        + int(getattr(ctx.plane, "refused", 0))
                    )

                before = attempts()
                end = ctx.time_fn() + flat_seconds
                moved = 0
                while ctx.time_fn() < end and circuit.state == "open":
                    moved = attempts() - before
                    if moved:
                        break
                    ctx.sleep_fn(POLL_INTERVAL)
                ok = moved == 0
                out.append(ExpectationResult(
                    "outbox", ok,
                    detail=(
                        f"connect attempts flat for {flat_seconds:g}s while open"
                        if ok
                        else f"{moved} connect attempt(s) leaked while circuit open"
                    ),
                ))
    if spec.get("replay_paced", False):
        deadline = ctx.time_fn() + within

        def paced():
            j = getattr(server, "last_replay_jitter_seconds", None)
            return (j,) if j is not None and j > 0 else None

        got = _poll(paced, deadline, ctx)
        if got is None:
            j = getattr(server, "last_replay_jitter_seconds", None)
            out.append(ExpectationResult(
                "outbox", False, timed_out=True,
                detail=(
                    f"replay_paced: no post-recovery jitter within "
                    f"{within:g}s (last jitter: {j})"
                ),
            ))
        else:
            out.append(ExpectationResult(
                "outbox", True,
                detail=f"replay paced: {got[0] * 1000.0:.0f}ms jitter "
                       "applied after circuit recovery",
            ))

    max_connects = spec.get("max_total_connects")
    if max_connects is not None:
        if ctx.plane is None:
            out.append(ExpectationResult(
                "outbox", False,
                detail="max_total_connects needs a fake control plane",
            ))
        else:
            total = (
                int(getattr(ctx.plane, "connects", 0))
                + int(getattr(ctx.plane, "refused", 0))
                - int(ctx.baseline.get("plane_attempts", 0.0))
            )
            ok = total <= int(max_connects)
            out.append(ExpectationResult(
                "outbox", ok,
                detail=(
                    f"{total} connect attempt(s) reached the plane this "
                    f"campaign (ceiling {int(max_connects)})"
                ),
            ))

    if not out:
        out.append(ExpectationResult(
            "outbox", True, detail="no outbox assertion",
        ))
    return out


def _eval_fleet(server, spec: Dict, ctx) -> List[ExpectationResult]:
    """Fleet rollup consistency (manager/rollup.py) against the fake
    control plane's ingest ledger:

      consistent:  the rollup journal holds exactly one row per deduped
                   record the plane accepted (``plane.outbox_keys``) —
                   redeliveries across a disconnect storm must not
                   double-count, and nothing the plane accepted may be
                   missing from the rollup. Cumulative across campaigns
                   sharing the plane, like the plane's own dedupe set.
      kinds_match: per-kind record counts in the rollup equal a recount
                   over the plane's accepted frames — no torn aggregates.
    """
    out: List[ExpectationResult] = []
    plane = ctx.plane
    rollup = getattr(plane, "rollup", None) if plane is not None else None
    if rollup is None:
        return [ExpectationResult(
            "fleet", False,
            detail="no fleet rollup store attached to the fake control plane",
        )]
    within = float(spec.get("within", ctx.detect_timeout))

    if spec.get("consistent", True):
        deadline = ctx.time_fn() + within

        def agree():
            delivered = len(plane.outbox_keys)
            journaled = rollup.journal_count()
            if delivered and journaled == delivered == rollup.records_total():
                return (delivered,)
            return None

        got = _poll(agree, deadline, ctx)
        if got is None:
            out.append(ExpectationResult(
                "fleet", False, timed_out=True,
                detail=(
                    f"rollup/plane divergence after {within:g}s: plane "
                    f"accepted {len(plane.outbox_keys)} record(s), rollup "
                    f"journaled {rollup.journal_count()}, applied "
                    f"{rollup.records_total()}"
                ),
            ))
        else:
            out.append(ExpectationResult(
                "fleet", True,
                detail=(
                    f"rollup consistent: {got[0]} record(s) journaled == "
                    "accepted == applied, redeliveries deduped"
                ),
            ))

    if spec.get("kinds_match", False):
        from collections import Counter

        want = Counter(f.get("kind") or "" for f in plane.outbox_frames)
        have: Counter = Counter()
        for agent_id in rollup.agent_ids():
            snap = rollup.agent_snapshot(agent_id)
            have.update(snap["records_by_kind"])
        ok = have == want
        out.append(ExpectationResult(
            "fleet", ok,
            detail=(
                f"per-kind counts match across {len(want)} kind(s)"
                if ok
                else f"per-kind mismatch: plane={dict(want)} rollup={dict(have)}"
            ),
        ))

    if not out:
        out.append(ExpectationResult("fleet", True, detail="no fleet assertion"))
    return out


def _eval_fabric(server, spec: Dict, ctx) -> List[ExpectationResult]:
    """Mesh matrix assertions (fabric/plane.py, docs/fabric.md):

      degraded:       link names that must read Degraded (EWMA latency
                      deviation) in the current matrix
      down:           link names that must read Down (endpoint port down)
      others_healthy: true — every OTHER swept link must read Up; the
                      matrix blames exactly the faulted links, nothing
                      adjacent (blast-radius containment)

    The plane is swept once per poll so the configured sweep cadence
    never gates a campaign; fault-to-matrix latency is measured from the
    phase's first fault step."""
    plane = getattr(server, "fabric", None)
    if plane is None:
        return [ExpectationResult(
            "fabric", False, detail="fabric plane disabled (fabric_sweep_enabled)",
        )]
    from gpud_tpu_torch.fabric.plane import STATE_DEGRADED, STATE_DOWN, STATE_UP

    want_degraded = set(spec.get("degraded") or [])
    want_down = set(spec.get("down") or [])
    others = bool(spec.get("others_healthy", False))
    within = float(spec.get("within", ctx.detect_timeout))
    ref = ctx.fault_t0 if ctx.fault_t0 is not None else ctx.phase_start
    deadline = ctx.time_fn() + within

    def states_now() -> Dict[str, str]:
        plane.sweep_once()  # the sweep cadence must never gate a campaign
        return {r["link"]: r["state"] for r in plane.matrix()}

    def settled():
        states = states_now()
        degraded = {n for n, s in states.items() if s == STATE_DEGRADED}
        down = {n for n, s in states.items() if s == STATE_DOWN}
        if not want_degraded <= degraded or not want_down <= down:
            return None
        if others and (degraded - want_degraded or down - want_down):
            return None
        return (states,)

    got = _poll(settled, deadline, ctx)
    if got is None:
        states = states_now()
        by_state: Dict[str, List[str]] = {}
        for name, s in sorted(states.items()):
            by_state.setdefault(s or "unswept", []).append(name)
        return [ExpectationResult(
            "fabric", False, timed_out=True,
            detail=(
                f"matrix never settled within {within:g}s — wanted "
                f"degraded={sorted(want_degraded)} down={sorted(want_down)} "
                f"others_healthy={others}; matrix now: "
                + "; ".join(f"{s}={v}" for s, v in sorted(by_state.items()))
            ),
        )]
    states = got[0]
    latency = max(0.0, ctx.time_fn() - ref)
    healthy = sum(1 for s in states.values() if s == STATE_UP)
    out = [ExpectationResult(
        "fabric", True, latency_seconds=latency,
        detail=(
            f"matrix blames exactly the faulted links in "
            f"{latency * 1000.0:.0f}ms: {len(want_degraded)} degraded, "
            f"{len(want_down)} down, {healthy} healthy of {len(states)}"
        ),
    )]
    return out


def _eval_predict(server, specs: List[Dict], ctx) -> List[ExpectationResult]:
    """Predictive-health assertions (gpud_tpu_torch/predict/, docs/predict.md):

      warned: true   a ``predicted_degraded`` warning for the component
                     appears within the bound (the engine is poked each
                     poll so the scan cadence never gates a campaign)
      before:        state name (e.g. Unhealthy) — the warning's event
                     timestamp must precede the phase's first ledger
                     transition INTO that state (warning-before-fault
                     ordering, the subsystem's reason to exist)
      before_event:  event name (e.g. health_flapping) — same ordering
                     against the reactive detector's own event
      before_flap:   true — the warning must precede the IN-PHASE
                     transition that carries the ledger past the
                     reactive flap threshold (transition records have no
                     emission cooldown, so this ordering stays valid
                     when an earlier campaign already tripped the
                     flap event's cooldown)
      lead_min:      floor on the engine's measured lead time (seconds
                     from warning to the first reactive hard signal)
      warned: false  NO predictive warning for the component since the
                     campaign started — the zero-false-positive gate
    """
    eng = getattr(server, "predictor", None)
    if eng is None:
        return [ExpectationResult(
            "predict", False, detail="predict engine disabled",
        )]
    from gpud_tpu_torch.predict.engine import EVENT_NAME_PREDICTED

    out: List[ExpectationResult] = []
    since = ctx.phase_start - SINCE_SLACK
    campaign_since = getattr(ctx, "campaign_start", ctx.phase_start) - SINCE_SLACK

    def first_warn_ts(component: str, lookback: float) -> Optional[float]:
        ts = None
        for e in server.event_store.bucket(component).get(lookback):
            if e.name == EVENT_NAME_PREDICTED:
                ts = e.time if ts is None else min(ts, e.time)
        return ts

    for spec in specs:
        component = spec.get("component", "")
        within = float(spec.get("within", ctx.detect_timeout))

        if not spec.get("warned", True):
            # negative gate, evaluated after the phase timeline drained:
            # one extra synchronous scan, then zero tolerance
            eng.poke()
            ts = first_warn_ts(component, campaign_since)
            ok = ts is None
            out.append(ExpectationResult(
                "predict", ok,
                detail=(
                    f"{component}: no predictive warning (un-faulted)"
                    if ok
                    else f"{component}: unexpected predictive warning at {ts:.3f}"
                ),
            ))
            continue

        deadline = ctx.time_fn() + within

        def warned(c=component):
            eng.poke()  # scan cadence must never gate a campaign
            ts = first_warn_ts(c, since)
            return (ts,) if ts is not None else None

        got = _poll(warned, deadline, ctx)
        if got is None:
            out.append(ExpectationResult(
                "predict", False, timed_out=True,
                detail=f"{component}: no predictive warning within {within:g}s",
            ))
            continue
        warn_ts = got[0]
        out.append(ExpectationResult(
            "predict", True,
            detail=f"{component}: predictive warning at +"
                   f"{max(0.0, warn_ts - ctx.phase_start):.3f}s",
        ))

        before_state = spec.get("before", "")
        if before_state:
            def hard_fault(c=component, st=before_state):
                rows = [
                    t["time"]
                    for t in server.health_ledger.history(
                        component=c, since=since
                    )
                    if t["to"] == st
                ]
                return (min(rows),) if rows else None

            hit = _poll(hard_fault, deadline, ctx)
            if hit is None:
                out.append(ExpectationResult(
                    "predict", False, timed_out=True,
                    detail=(
                        f"{component}: no transition→{before_state} to "
                        f"order the warning against"
                    ),
                ))
            else:
                ok = warn_ts <= hit[0]
                out.append(ExpectationResult(
                    "predict", ok,
                    detail=(
                        f"{component}: warning preceded {before_state} by "
                        f"{hit[0] - warn_ts:.3f}s"
                        if ok
                        else f"{component}: warning came {warn_ts - hit[0]:.3f}s "
                             f"AFTER {before_state}"
                    ),
                ))

        before_event = spec.get("before_event", "")
        if before_event:
            def reactive_event(c=component, nm=before_event):
                rows = [
                    e.time
                    for e in server.event_store.bucket(c).get(since)
                    if e.name == nm
                ]
                return (min(rows),) if rows else None

            hit = _poll(reactive_event, deadline, ctx)
            if hit is None:
                out.append(ExpectationResult(
                    "predict", False, timed_out=True,
                    detail=f"{component}: reactive event {before_event} absent",
                ))
            else:
                ok = warn_ts <= hit[0]
                out.append(ExpectationResult(
                    "predict", ok,
                    detail=(
                        f"{component}: warning preceded {before_event} by "
                        f"{hit[0] - warn_ts:.3f}s"
                        if ok
                        else f"{component}: warning came {warn_ts - hit[0]:.3f}s "
                             f"AFTER {before_event}"
                    ),
                ))

        if spec.get("before_flap", False):
            thr = int(server.health_ledger.flap_threshold)

            def flap_crossing(c=component, n=thr):
                rows = sorted(
                    t["time"]
                    for t in server.health_ledger.history(
                        component=c, since=since
                    )
                )
                return (rows[n - 1],) if len(rows) >= n else None

            hit = _poll(flap_crossing, deadline, ctx)
            if hit is None:
                out.append(ExpectationResult(
                    "predict", False, timed_out=True,
                    detail=(
                        f"{component}: fewer than {thr} in-phase "
                        f"transitions — flap threshold never crossed"
                    ),
                ))
            else:
                ok = warn_ts <= hit[0]
                out.append(ExpectationResult(
                    "predict", ok,
                    detail=(
                        f"{component}: warning preceded the flap-threshold "
                        f"crossing by {hit[0] - warn_ts:.3f}s"
                        if ok
                        else f"{component}: warning came "
                             f"{warn_ts - hit[0]:.3f}s AFTER the "
                             f"flap-threshold crossing"
                    ),
                ))

        lead_min = spec.get("lead_min")
        if lead_min is not None:
            def measured(c=component):
                eng.poke()
                d = eng.scores(component=c)["components"].get(c) or {}
                lead = d.get("lead_seconds")
                return (lead,) if lead is not None else None

            hit = _poll(measured, deadline, ctx)
            if hit is None:
                out.append(ExpectationResult(
                    "predict", False, timed_out=True,
                    detail=(
                        f"{component}: lead time never measured within "
                        f"{within:g}s"
                    ),
                ))
            else:
                ok = hit[0] >= float(lead_min)
                out.append(ExpectationResult(
                    "predict", ok,
                    detail=(
                        f"{component}: lead {hit[0]:.3f}s "
                        f"(floor {float(lead_min):g}s)"
                    ),
                ))
    return out


def _eval_invariants(server, spec: Dict, ctx) -> List[ExpectationResult]:
    out = []
    reg = server.metrics_registry
    if spec.get("no_worker_exceptions", True):
        failures = counter_total(reg, "tpud_scheduler_job_failures_total")
        watchdog = counter_total(reg, "tpud_scheduler_watchdog_fires_total")
        df = failures - ctx.baseline.get("failures", 0.0)
        dw = watchdog - ctx.baseline.get("watchdog", 0.0)
        ok = df <= 0 and dw <= 0
        out.append(ExpectationResult(
            "invariants", ok,
            detail=(
                "no unhandled worker exceptions"
                if ok
                else f"{df:g} job failure(s), {dw:g} watchdog fire(s) during campaign"
            ),
        ))
    # un-faulted periodic jobs must still be keeping cadence: a job whose
    # deadline is further in the past than the slack means the scheduler
    # fell over or the pool starved — graceful degradation failed
    if spec.get("cadence", True):
        scheduler = getattr(server, "scheduler", None)
        late = []
        if scheduler is not None:
            now = scheduler.time_fn()
            for jname in scheduler.job_names():
                if jname.startswith("chaos"):
                    continue
                job = scheduler.get_job(jname)
                if job is None or job.one_shot or job.running:
                    continue
                try:
                    interval = float(job.interval_fn())
                except Exception:  # noqa: BLE001
                    continue
                if interval <= 0:
                    continue
                slack = float(
                    spec.get("cadence_slack_seconds", max(2.0, interval))
                )
                if now - job.due > slack:
                    late.append(f"{jname} ({now - job.due:.1f}s late)")
        out.append(ExpectationResult(
            "invariants", not late,
            detail=(
                "un-faulted job cadence within slack"
                if not late
                else "cadence broken: " + ", ".join(late)
            ),
        ))
    max_threads = spec.get("max_threads")
    if max_threads is not None:
        n = threading.active_count()
        out.append(ExpectationResult(
            "invariants", n <= int(max_threads),
            detail=f"threads {n} (gate <= {int(max_threads)})",
        ))
    max_rss = spec.get("max_rss_mb")
    if max_rss is not None:
        mb = rss_mb()
        if mb is None:
            out.append(ExpectationResult(
                "invariants", True, detail="RSS unreadable; gate skipped",
            ))
        else:
            out.append(ExpectationResult(
                "invariants", mb <= float(max_rss),
                detail=f"RSS {mb:.1f}MB (gate <= {float(max_rss):g}MB)",
            ))
    return out


def _eval_predict_lead(server, spec: Dict, ctx) -> List[ExpectationResult]:
    """Fleet-level predictive assertions against the manager-side rollup
    (manager/rollup.py ``fleet_predict``), closing the predict→fleet
    loop end-to-end: the agent's ``predict_score`` outbox records must
    survive ingest and surface in the ranked pane:

      component:      the faulted component name
      in_top:         K — the component must rank within the top-K rows
                      by decayed risk (default 1: it must LEAD the pane)
      warns_min:      floor on fleet-wide journaled warn records (>=1)
      lead_count_min: floor on journaled lead records fleet-wide
      lead_min:       floor on the fleet's minimum measured lead time —
                      the pane must agree the warning landed BEFORE the
                      reactive hard signal, from the manager's view
      within:         poll bound (defaults to the detect timeout)
    """
    plane = ctx.plane
    rollup = getattr(plane, "rollup", None) if plane is not None else None
    if rollup is None:
        return [ExpectationResult(
            "predict_lead", False,
            detail="no fleet rollup store attached to the fake control plane",
        )]
    component = spec.get("component", "")
    in_top = int(spec.get("in_top", 1))
    warns_min = int(spec.get("warns_min", 1))
    lead_count_min = int(spec.get("lead_count_min", 0))
    lead_min = spec.get("lead_min")
    within = float(spec.get("within", ctx.detect_timeout))
    deadline = ctx.time_fn() + within

    def pane_ready():
        # explicit now bypasses the pane's TTL cache so each poll sees
        # the freshest ingested records (and decay at the poll instant)
        pane = rollup.fleet_predict(top=max(in_top, 5), now=ctx.time_fn())
        if pane["warns_total"] < warns_min:
            return None
        if pane["lead"]["count"] < lead_count_min:
            return None
        rank = None
        for i, row in enumerate(pane["top"]):
            if row["component"] == component:
                rank = i
                break
        if rank is None or rank >= in_top:
            return None
        return (pane, rank)

    got = _poll(pane_ready, deadline, ctx)
    if got is None:
        pane = rollup.fleet_predict(top=max(in_top, 5), now=ctx.time_fn())
        ranked = [
            f'{r["agent"]}/{r["component"]}@{r["risk"]:.3f}'
            for r in pane["top"]
        ]
        return [ExpectationResult(
            "predict_lead", False, timed_out=True,
            detail=(
                f"{component}: never ranked in the fleet pane top-{in_top} "
                f"within {within:g}s (warns={pane['warns_total']}, "
                f"leads={pane['lead']['count']}, top={ranked})"
            ),
        )]
    pane, rank = got
    out = [ExpectationResult(
        "predict_lead", True,
        detail=(
            f"{component}: rank #{rank + 1} in the fleet pane "
            f"(risk={pane['top'][rank]['risk']:.3f}, "
            f"warns={pane['warns_total']}, leads={pane['lead']['count']})"
        ),
    )]
    if lead_min is not None:
        have = pane["lead"]["min_seconds"]
        ok = pane["lead"]["count"] > 0 and have >= float(lead_min)
        out.append(ExpectationResult(
            "predict_lead", ok,
            detail=(
                f"fleet lead floor: min={have:g}s over "
                f"{pane['lead']['count']} lead record(s) "
                f"(gate >= {float(lead_min):g}s)"
                if pane["lead"]["count"]
                else "fleet lead floor: no lead records journaled"
            ),
        ))
    return out


def evaluate_phase(server, expect: Dict, ctx) -> List[ExpectationResult]:
    """Evaluate a phase's full expectation block, in chain order."""
    results: List[ExpectationResult] = []
    if "detect" in expect:
        results.append(_eval_detect(server, expect["detect"] or {}, ctx))
    if "ledger" in expect:
        results.extend(_eval_ledger(server, expect["ledger"] or [], ctx))
    if "remediation" in expect:
        results.extend(_eval_remediation(server, expect["remediation"] or [], ctx))
    if "events" in expect:
        results.extend(_eval_events(server, expect["events"] or [], ctx))
    if "plane" in expect:
        results.append(_eval_plane(server, expect["plane"] or {}, ctx))
    if "outbox" in expect:
        results.extend(_eval_outbox(server, expect["outbox"] or {}, ctx))
    if "fleet" in expect:
        results.extend(_eval_fleet(server, expect["fleet"] or {}, ctx))
    if "fabric" in expect:
        results.extend(_eval_fabric(server, expect["fabric"] or {}, ctx))
    if "predict" in expect:
        results.extend(_eval_predict(server, expect["predict"] or [], ctx))
    if "predict_lead" in expect:
        results.extend(
            _eval_predict_lead(server, expect["predict_lead"] or {}, ctx)
        )
    if "invariants" in expect:
        results.extend(_eval_invariants(server, expect["invariants"] or {}, ctx))
    return results
