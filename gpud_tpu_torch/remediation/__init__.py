"""Remediation: policy-gated auto-repair of suggested actions (the port of
``gpud_tpu/remediation/``).

The daemon's components *diagnose* — checks emit
``HealthState.suggested_actions`` (REBOOT_SYSTEM, HARDWARE_INSPECTION, …)
and the health ledger records every flip — but nothing local *acts* on a
diagnosis. This package closes the detect → repair loop on-node:

- ``policy``  — what is allowed to run (allowlist, cooldowns, rate limit,
  reboot-window guard, escalation thresholds); default: everything dry-run.
- ``audit``   — every attempt persisted to SQLite (action, trigger state,
  policy decision, outcome, duration), retention via ``RetentionPurger``.
- ``actions`` — the executors: soft tier (re-trigger check, set-healthy,
  restart the GPU runtime unit) and hard tier (guarded host reboot).
- ``engine``  — the scan loop tying them together.

See docs/remediation.md for the operator-facing contract.
"""

from gpud_tpu_torch.remediation.audit import AuditStore
from gpud_tpu_torch.remediation.engine import RemediationEngine
from gpud_tpu_torch.remediation.policy import Policy

__all__ = ["AuditStore", "Policy", "RemediationEngine"]
