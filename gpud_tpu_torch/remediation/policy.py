"""Remediation policy: what may run, how often, and when to give up (the
port of ``gpud_tpu/remediation/policy.py``).

The policy is deliberately *deny-by-default*: with an empty
``enforce_actions`` allowlist every suggested action is decided ``dry_run``
— the full detect → decide → audit pipeline runs, nothing mutates the
host. Operators graduate one action type at a time by allowlisting it
(``POST /v1/remediation/policy``), watching the audit ledger the whole
way (docs/remediation.md).

Guardrails the engine enforces on top of the allowlist:

- per-component cooldown — one attempt per component per window;
- global token bucket — a burst of simultaneous diagnoses cannot fan out
  into a burst of repairs;
- max-reboots-per-window — counts completed reboots (the reboot event
  store) plus reboots this engine executed (the audit ledger), so a
  repair loop can never reboot-cycle a node;
- escalation — N failed soft repairs inside a window escalate
  REBOOT_SYSTEM → HARDWARE_INSPECTION and stop retrying.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

# internal action vocabulary: these land in audit rows and metric labels
ACTION_RETRIGGER_CHECK = "retrigger_check"
ACTION_SET_HEALTHY = "set_healthy"
ACTION_RESTART_RUNTIME = "restart_runtime"
ACTION_REBOOT = "reboot_system"
ACTION_INSPECTION = "hardware_inspection"
# advisory marker written by the predict engine's early warnings; never
# executable, and deliberately its own cooldown lane — a prediction must
# never defer the reactive repair of the fault it predicted
ACTION_PREDICTED = "predicted_warning"

# actions an operator can allowlist; INSPECTION is a manual marker and
# never executes, so allowlisting it would be meaningless
EXECUTABLE_ACTIONS = (
    ACTION_RETRIGGER_CHECK,
    ACTION_SET_HEALTHY,
    ACTION_RESTART_RUNTIME,
    ACTION_REBOOT,
)

# policy decisions / audit outcomes
DECISION_DRY_RUN = "dry_run"
DECISION_EXECUTE = "execute"
DECISION_BLOCKED_RATE_LIMIT = "blocked_rate_limit"
DECISION_BLOCKED_REBOOT_WINDOW = "blocked_reboot_window"
DECISION_ESCALATE = "escalate"
DECISION_MANUAL = "manual"

OUTCOME_DRY_RUN = "dry_run"
OUTCOME_EXECUTED = "executed"
OUTCOME_FAILED = "failed"
OUTCOME_BLOCKED_RATE_LIMIT = "blocked_rate_limit"
OUTCOME_BLOCKED_REBOOT_WINDOW = "blocked_reboot_window"
OUTCOME_ESCALATED = "escalated"
OUTCOME_MANUAL = "manual"

DEFAULT_COOLDOWN = 300.0
DEFAULT_RATE_CAPACITY = 6
DEFAULT_RATE_REFILL_SECONDS = 600.0  # one token back per 10 minutes
DEFAULT_MAX_REBOOTS = 2
DEFAULT_REBOOT_WINDOW = 3600.0
DEFAULT_ESCALATION_THRESHOLD = 3
DEFAULT_ESCALATION_WINDOW = 3600.0


@dataclass
class Policy:
    """Runtime-updatable policy knobs. ``update`` applies a partial dict
    key-by-key (one invalid value must not block the rest — the
    updateConfig contract) and returns (updated_keys, errors)."""

    enforce_actions: List[str] = field(default_factory=list)
    cooldown_seconds: float = DEFAULT_COOLDOWN
    rate_capacity: int = DEFAULT_RATE_CAPACITY
    rate_refill_seconds: float = DEFAULT_RATE_REFILL_SECONDS
    max_reboots: int = DEFAULT_MAX_REBOOTS
    reboot_window_seconds: float = DEFAULT_REBOOT_WINDOW
    escalation_threshold: int = DEFAULT_ESCALATION_THRESHOLD
    escalation_window_seconds: float = DEFAULT_ESCALATION_WINDOW

    def is_enforced(self, action: str) -> bool:
        return action in self.enforce_actions

    def to_dict(self) -> Dict:
        return {
            "enforce_actions": sorted(self.enforce_actions),
            "cooldown_seconds": self.cooldown_seconds,
            "rate_capacity": self.rate_capacity,
            "rate_refill_seconds": self.rate_refill_seconds,
            "max_reboots": self.max_reboots,
            "reboot_window_seconds": self.reboot_window_seconds,
            "escalation_threshold": self.escalation_threshold,
            "escalation_window_seconds": self.escalation_window_seconds,
        }

    # (attr, coerce, floor) — `not >= floor` also rejects NaN, which
    # json.loads happily produces from a bare NaN token
    _NUMERIC: Tuple = (
        ("cooldown_seconds", float, 0.0),
        ("rate_capacity", int, 1),
        ("rate_refill_seconds", float, 1.0),
        ("max_reboots", int, 1),
        ("reboot_window_seconds", float, 60.0),
        ("escalation_threshold", int, 1),
        ("escalation_window_seconds", float, 60.0),
    )

    def update(self, cfg: Dict) -> Tuple[List[str], List[str]]:
        updated: List[str] = []
        errors: List[str] = []
        if not isinstance(cfg, dict):
            return updated, ["policy update must be an object"]
        if "enforce_actions" in cfg:
            v = cfg["enforce_actions"]
            if not isinstance(v, list) or any(
                not isinstance(a, str) for a in v
            ):
                errors.append("enforce_actions: must be a list of action names")
            else:
                unknown = sorted(set(v) - set(EXECUTABLE_ACTIONS))
                if unknown:
                    errors.append(
                        f"enforce_actions: unknown action(s) {unknown}; "
                        f"known: {list(EXECUTABLE_ACTIONS)}"
                    )
                else:
                    self.enforce_actions = sorted(set(v))
                    updated.append("enforce_actions")
        for key, coerce, floor in self._NUMERIC:
            if key not in cfg:
                continue
            try:
                val = coerce(cfg[key])
                if not val >= floor:
                    raise ValueError(f"must be >= {floor}")
            except (TypeError, ValueError) as e:
                errors.append(f"{key}: {e}")
                continue
            setattr(self, key, val)
            updated.append(key)
        return updated, errors


class TokenBucket:
    """Global repair rate limit. Reads capacity/refill from the policy on
    every ``take`` so runtime policy pushes apply without a rebuild."""

    def __init__(self, policy: Policy) -> None:
        self.policy = policy
        self._tokens = float(policy.rate_capacity)
        self._last: Optional[float] = None

    def _refill(self, now: float) -> None:
        cap = float(self.policy.rate_capacity)
        if self._last is not None and now > self._last:
            self._tokens += (now - self._last) / self.policy.rate_refill_seconds
        self._tokens = min(cap, self._tokens)
        self._last = now

    def take(self, now: float) -> bool:
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def available(self, now: float) -> float:
        self._refill(now)
        return self._tokens


def map_suggested_action(
    repair_action: str, soft_repair: Optional[str]
) -> Optional[str]:
    """Map a wire ``RepairActionType`` to the engine's action vocabulary.

    ``soft_repair`` is the component's configured soft alternative for a
    REBOOT_SYSTEM suggestion (e.g. restart the runtime unit first); the
    escalation guard is what eventually stops a soft repair that never
    sticks. Returns None for IGNORE / unknown actions."""
    from gpud_tpu_torch.api.v1.types import RepairActionType

    if repair_action == RepairActionType.IGNORE_NO_ACTION_REQUIRED:
        return None
    if repair_action == RepairActionType.PREDICTED_DEGRADATION:
        # the predict engine's own warning path audits these as dry_run;
        # a component echoing the suggestion must still never execute
        return None
    if repair_action == RepairActionType.CHECK_USER_APP_AND_GPU:
        return ACTION_RETRIGGER_CHECK
    if repair_action == RepairActionType.REBOOT_SYSTEM:
        return soft_repair or ACTION_REBOOT
    if repair_action == RepairActionType.HARDWARE_INSPECTION:
        return ACTION_INSPECTION
    return None
