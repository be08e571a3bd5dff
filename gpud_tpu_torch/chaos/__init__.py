"""Chaos campaign harness (docs/chaos.md); the port of ``gpud_tpu/chaos/``.

A campaign is a declarative scenario file — a timeline of timed fault
steps grouped into phases, each phase closed by an expectation block —
executed against a *live* daemon through the unified scheduler. The fault
injector has always been both product feature and test harness (SURVEY
§4.7); this package extends that stance from one-shot kmsg writes to
compound failure storms: bursts/flaps, slow-ramp metric faults, runtime
crashes mid-remediation, clock skew, and control-plane disconnect storms.

Surface:
  - :mod:`gpud_tpu_torch.chaos.scenario` — schema, loading, timeline expansion
  - :mod:`gpud_tpu_torch.chaos.faults` — the injectable fault actions
  - :mod:`gpud_tpu_torch.chaos.expectations` — per-phase assertion evaluation
  - :mod:`gpud_tpu_torch.chaos.runner` — CampaignRunner + ChaosManager (wired
    into the daemon, HTTP, session, SDK, CLI)
  - :mod:`gpud_tpu_torch.chaos.fake_plane` — reusable fake control plane
  - ``gpud_tpu_torch/chaos/scenarios/`` — the shipped campaigns, in the
    port's nouns (GPU components, Xid names, NVLink ports)
"""

from gpud_tpu_torch.chaos.runner import CampaignRunner, ChaosManager  # noqa: F401
from gpud_tpu_torch.chaos.scenario import (  # noqa: F401
    Scenario,
    expand_steps,
    load_scenario,
    shipped_scenarios,
)
