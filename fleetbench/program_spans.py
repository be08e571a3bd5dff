"""The program's own spans: each sweep of ``gpud_tpu_torch.fleet_scan``
records ``fleet_scan.*`` spans, with the loader's counters as attributes,
in the port's trace ring (``gpud_tpu_torch.tracing.DEFAULT_TRACER``,
component ``"fleet_scan"``). A program that records none leaves the
metrics that read them silent."""

from __future__ import annotations

from typing import Dict, List, Optional

COMPONENT = "fleet_scan"


def newest(run, name: str) -> List[Dict]:
    """The newest ``run.sweeps`` spans called ``name``, newest first: the
    window's sweeps, not the warm sweep before them."""
    from gpud_tpu_torch.tracing import DEFAULT_TRACER

    spans = [s for s in DEFAULT_TRACER.snapshot(component=COMPONENT) if s["name"] == name]
    return spans[:run.sweeps]


def attr(span: Dict, key: str) -> float:
    return float(span.get("attrs", {})[key])


def mean(values: List[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None
