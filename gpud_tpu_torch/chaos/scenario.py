"""Chaos scenario model: declarative campaign files and their timeline; the
port of ``gpud_tpu/chaos/scenario.py``.

A scenario is YAML (or JSON — YAML is a superset) with this shape::

    name: thermal-ici-cascade
    description: cascading NVLink errors during a thermal excursion
    defaults:
      detect_timeout: 8.0        # per-phase expectation wait ceiling
    phases:
      - name: thermal-ramp
        steps:
          - at: 0.0              # seconds from phase start
            action: metric_ramp
            component: accelerator-gpu-temperature
            field: temperature_c
            start: 80.0
            end: 98.0
            ramp_seconds: 1.5
          - at: 0.2
            every: 0.4           # repeat spacing …
            count: 5             # … this many occurrences
            jitter: 0.1          # ± fraction of `every`, deterministic
            action: trigger
            component: accelerator-gpu-temperature
        expect:
          ledger:
            - component: accelerator-gpu-temperature
              to: Unhealthy
          invariants:
            no_worker_exceptions: true

The ``every``+``count``+``jitter`` expansion is resolved *before* the
campaign runs (:func:`expand_steps`), with the same crc32-keyed
deterministic jitter the scheduler uses for cadence spreading: the same
scenario expands to the same timeline on every host and every run, so a
failing campaign replays exactly.
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SCENARIOS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenarios")

# actions the runner knows how to execute (gpud_tpu_torch/chaos/faults.py)
KNOWN_ACTIONS = (
    "inject",          # kmsg fault write (burst via repeat/interval_seconds)
    "metric_ramp",     # slow-ramp telemetry override (memory/temperature hook)
    "metric_clear",    # remove a component's telemetry override
    "runtime_crash",   # runtime unit reported failed for `duration` seconds
    "clock_skew",      # shift a component's / the engine's clock by `offset`
    "plane_disconnect",  # drop control-plane sessions (fake_plane harness)
    "plane_refuse",    # hard-down manager: 503 every connect for `duration`
    "fabric_latency_ramp",  # slow-ramp one mesh link's probe latency
    "fabric_link_down",     # hard-down one physical NVLink port
    "fabric_sweep",    # run one all-links fabric sweep now
    "trigger",         # poke a component check to the front of the heap
    "set_healthy",     # clear a component's sticky state
    "remediation_scan",  # poke the remediation engine's scan job
    "predict_scan",    # run a synchronous precursor-scoring tick now
    "predict_reset",   # drop predictor scorer state (campaign isolation)
    "purge",           # run the consolidated retention purge now
    "ingest_burst",    # observation firehose: `count` events + metric rows
    "storage_flush",   # write-behind flush barrier (pre-crash durability line)
    "storage_crash",   # discard the write-behind buffer uncommitted (SIGKILL sim)
    "manager_kill_rebuild",  # SIGKILL the manager: rebuild rollups from journal
    "peer_plane_boot",  # HA tier: boot a peer manager + breaker failover list
)

# expectation kinds evaluated after each phase (gpud_tpu_torch/chaos/expectations.py)
KNOWN_EXPECTATIONS = (
    "detect", "ledger", "remediation", "events", "invariants", "plane",
    "outbox", "fleet", "fabric", "predict", "predict_lead",
)

MAX_STEP_OCCURRENCES = 1000  # per phase — runaway `count` backstop

DEFAULT_DETECT_TIMEOUT = 10.0


class ScenarioError(ValueError):
    """Raised for a scenario file the runner refuses to execute."""


@dataclass
class StepOccurrence:
    """One resolved point on a phase's timeline."""

    offset: float          # seconds from phase start (jitter applied)
    step: Dict             # the raw step mapping (shared across occurrences)
    step_index: int        # position of the step in the phase
    occurrence: int        # 0..count-1 within the step's expansion

    @property
    def action(self) -> str:
        return self.step.get("action", "")


@dataclass
class Phase:
    name: str
    steps: List[Dict] = field(default_factory=list)
    expect: Dict = field(default_factory=dict)
    # extra settle time after the last step before expectations run
    settle_seconds: float = 0.0


@dataclass
class Scenario:
    name: str
    description: str = ""
    phases: List[Phase] = field(default_factory=list)
    detect_timeout: float = DEFAULT_DETECT_TIMEOUT
    source: str = ""  # file path when loaded from disk

    def validate(self) -> Optional[str]:
        """Returns an error string, or None when executable."""
        if not self.name:
            return "scenario needs a name"
        if not self.phases:
            return "scenario needs at least one phase"
        if self.detect_timeout <= 0:
            return "defaults.detect_timeout must be > 0"
        for p in self.phases:
            if not p.name:
                return "every phase needs a name"
            for i, s in enumerate(p.steps):
                action = s.get("action", "")
                if action not in KNOWN_ACTIONS:
                    return (
                        f"phase {p.name!r} step {i}: unknown action "
                        f"{action!r}; known: {', '.join(KNOWN_ACTIONS)}"
                    )
                if float(s.get("at", 0.0)) < 0:
                    return f"phase {p.name!r} step {i}: negative `at`"
                every = float(s.get("every", 0.0))
                count = int(s.get("count", 1))
                if every < 0 or count < 1:
                    return (
                        f"phase {p.name!r} step {i}: `every` must be >= 0 "
                        "and `count` >= 1"
                    )
                if count > 1 and every <= 0:
                    return (
                        f"phase {p.name!r} step {i}: `count` > 1 needs "
                        "`every` > 0"
                    )
                if not (0.0 <= float(s.get("jitter", 0.0)) <= 1.0):
                    return f"phase {p.name!r} step {i}: jitter must be in [0, 1]"
            for kind in p.expect:
                if kind not in KNOWN_EXPECTATIONS:
                    return (
                        f"phase {p.name!r}: unknown expectation {kind!r}; "
                        f"known: {', '.join(KNOWN_EXPECTATIONS)}"
                    )
        try:
            if self.duration_estimate() > 24 * 3600:
                return "scenario timeline exceeds 24h"
        except ScenarioError as e:
            return str(e)
        return None

    def duration_estimate(self) -> float:
        """Upper-bound step-timeline length (expectation waits excluded)."""
        total = 0.0
        for p in self.phases:
            occ = expand_steps(p.steps, key_prefix=f"{self.name}:{p.name}")
            total += (occ[-1].offset if occ else 0.0) + p.settle_seconds
        return total

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "description": self.description,
            "detect_timeout": self.detect_timeout,
            "phases": [
                {
                    "name": p.name,
                    "steps": p.steps,
                    "expect": p.expect,
                    "settle_seconds": p.settle_seconds,
                }
                for p in self.phases
            ],
        }


def _jitter_unit(key: str) -> float:
    """Deterministic fraction in [-1, 1] — same crc32 mapping the
    scheduler's cadence jitter uses (scheduler/core.py:_jittered), so a
    scenario's spread is stable across runs and hosts."""
    return (zlib.crc32(key.encode()) % 2001 - 1000) / 1000.0


def expand_steps(
    steps: List[Dict], key_prefix: str = ""
) -> List[StepOccurrence]:
    """Resolve ``at``/``every``/``count``/``jitter`` into a sorted
    timeline of occurrences. Jitter displaces each *repeat* occurrence by
    up to ``jitter * every`` (the first occurrence of a step keeps its
    exact ``at`` so phase-relative ordering intent survives)."""
    out: List[StepOccurrence] = []
    for i, s in enumerate(steps):
        at = float(s.get("at", 0.0))
        every = float(s.get("every", 0.0))
        count = int(s.get("count", 1))
        frac = float(s.get("jitter", 0.0))
        for k in range(count):
            offset = at + k * every
            if k > 0 and frac > 0 and every > 0:
                offset += every * frac * _jitter_unit(f"{key_prefix}:{i}:{k}")
            out.append(
                StepOccurrence(
                    offset=max(0.0, offset),
                    step=s,
                    step_index=i,
                    occurrence=k,
                )
            )
    if len(out) > MAX_STEP_OCCURRENCES:
        raise ScenarioError(
            f"phase expands to {len(out)} step occurrences "
            f"(max {MAX_STEP_OCCURRENCES})"
        )
    out.sort(key=lambda o: (o.offset, o.step_index, o.occurrence))
    return out


def _parse(data: Dict, source: str = "") -> Scenario:
    if not isinstance(data, dict):
        raise ScenarioError("scenario must be a mapping")
    defaults = data.get("defaults") or {}
    phases = []
    for p in data.get("phases") or []:
        if not isinstance(p, dict):
            raise ScenarioError("every phase must be a mapping")
        phases.append(
            Phase(
                name=str(p.get("name", "")),
                steps=list(p.get("steps") or []),
                expect=dict(p.get("expect") or {}),
                settle_seconds=float(p.get("settle_seconds", 0.0)),
            )
        )
    sc = Scenario(
        name=str(data.get("name", "")),
        description=str(data.get("description", "")),
        phases=phases,
        detect_timeout=float(
            defaults.get("detect_timeout", DEFAULT_DETECT_TIMEOUT)
        ),
        source=source,
    )
    err = sc.validate()
    if err:
        raise ScenarioError(f"{source or sc.name or 'scenario'}: {err}")
    return sc


def load_scenario(spec, extra_dirs: Optional[List[str]] = None) -> Scenario:
    """Load a scenario from an inline mapping, a file path, or a shipped
    scenario name (resolved under ``gpud_tpu_torch/chaos/scenarios/`` and any
    ``extra_dirs``)."""
    if isinstance(spec, dict):
        return _parse(spec)
    if not isinstance(spec, str) or not spec:
        raise ScenarioError(f"bad scenario spec: {spec!r}")
    path = spec
    if not os.path.isfile(path):
        for d in list(extra_dirs or []) + [SCENARIOS_DIR]:
            for ext in ("", ".yaml", ".yml", ".json"):
                cand = os.path.join(d, spec + ext)
                if os.path.isfile(cand):
                    path = cand
                    break
            else:
                continue
            break
    if not os.path.isfile(path):
        known = ", ".join(sorted(shipped_scenarios()))
        raise ScenarioError(
            f"scenario {spec!r} not found (shipped: {known})"
        )
    with open(path, encoding="utf-8") as f:
        raw = f.read()
    if path.endswith(".json"):
        data = json.loads(raw)
    else:
        import yaml

        data = yaml.safe_load(raw)
    return _parse(data, source=path)


def shipped_scenarios() -> Dict[str, str]:
    """name → path of every scenario shipped with the package."""
    out: Dict[str, str] = {}
    if not os.path.isdir(SCENARIOS_DIR):
        return out
    for fn in sorted(os.listdir(SCENARIOS_DIR)):
        base, ext = os.path.splitext(fn)
        if ext in (".yaml", ".yml", ".json"):
            out[base] = os.path.join(SCENARIOS_DIR, fn)
    return out


def first_fault_offset(occurrences: List[StepOccurrence]) -> Optional[Tuple[float, str]]:
    """(offset, action) of the first fault-class step in a phase — the
    reference point detection latency is measured from."""
    for o in occurrences:
        if o.action in ("inject", "metric_ramp", "runtime_crash",
                        "plane_disconnect", "fabric_latency_ramp",
                        "fabric_link_down"):
            return o.offset, o.action
    return None
