"""Federated Prometheus exposition for the manager's ``/metrics``; the
port of ``gpud_tpu/manager/exposition.py`` (the same families, help text,
label order and 0.0.4 text).

One scrape of the manager covers the pod: the global registry's own
series (tpud_fleet_*, tpud_storage_*, session counters) plus hand-
rendered per-agent series derived from the fleet rollup store. The
per-agent block is the only place an ``agent`` label exists, and its
cardinality is bounded twice:

- at most ``max_agents`` agents are rendered (sorted ids, so the set
  is stable between scrapes); the remainder is surfaced as one
  ``tpud_fleet_exposition_truncated_agents`` gauge instead of being
  silently dropped;
- a fixed, small family set per agent (availability, flap count,
  outbox lag, transitions, unhealthy series) — per-(agent, component)
  series are deliberately NOT exposed; that cross-product is what
  blows up federation (docs/fleet.md).
"""

from __future__ import annotations

import time
from typing import List

from gpud_tpu_torch.metrics.registry import (
    DEFAULT_REGISTRY,
    gauge,
    histogram,
)

DEFAULT_MAX_AGENTS = 1000

_h_scrape = histogram(
    "tpud_fleet_scrape_seconds",
    "wall time to render the manager's federated /metrics response",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
)
_g_exposed_series = gauge(
    "tpud_fleet_exposition_series",
    "per-agent series rendered in the last federated /metrics response",
)
_g_truncated = gauge(
    "tpud_fleet_exposition_truncated_agents",
    "agents omitted from the last federated /metrics response by the "
    "cardinality cap",
)

# the fixed per-agent family set: (suffix-free name, help, value extractor)
_AGENT_FAMILIES = (
    ("tpud_fleet_agent_availability_ratio",
     "healthy share of observed time across the agent's components",
     "availability"),
    ("tpud_fleet_agent_flap_count",
     "state transitions across the agent's components in the flap window",
     "flap_count"),
    ("tpud_fleet_agent_outbox_lag_seconds",
     "manager ingest wall clock minus the agent's newest record timestamp",
     "outbox_lag_seconds"),
    ("tpud_fleet_agent_transitions",
     "health-state transitions journaled for the agent, all components",
     "transitions"),
    ("tpud_fleet_agent_unhealthy_series",
     "the agent's components currently in a non-Healthy state",
     "unhealthy_series"),
    ("tpud_fleet_agent_predict_risk",
     "worst predicted-failure risk across the agent's components "
     "(decay anchored at the agent's newest record time)",
     "predict_risk"),
)

# fleet-level predictive gauges refreshed from the ranked pane at scrape
# time — fixed cardinality regardless of fleet size (docs/fleet.md)
_g_predict_armed = gauge(
    "tpud_fleet_predict_armed_series",
    "(agent, component) predictive series currently armed fleet-wide",
)
_g_predict_warns = gauge(
    "tpud_fleet_predict_warns",
    "predictive warnings journaled fleet-wide, all time",
)
_g_predict_risk_max = gauge(
    "tpud_fleet_predict_risk_max",
    "highest time-decayed predicted-failure risk in the fleet right now",
)
_g_predict_lead_mean = gauge(
    "tpud_fleet_predict_lead_mean_seconds",
    "mean measured lead time (predictive warning to reactive hard "
    "signal) across all journaled lead records",
)


# peer-federation gauges (fixed cardinality: one number each, refreshed
# from FederationPlane.stats() at scrape time; docs/fleet.md)
_g_peers_total = gauge(
    "tpud_fleet_peers",
    "managers in this manager's peer set (0 when not federated)",
)
_g_peers_live = gauge(
    "tpud_fleet_peers_live",
    "peers currently believed reachable, including self",
)
_g_replication_lag = gauge(
    "tpud_fleet_replication_lag_rows",
    "journal rows appended locally but not yet acked by the successor",
)
_g_replication_connected = gauge(
    "tpud_fleet_replication_connected",
    "1 when the replication stream to the successor is connected",
)
_g_adopts = gauge(
    "tpud_fleet_peer_adopts",
    "dead-peer cohorts this manager has adopted from its replica",
)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def render_fleet_metrics(
    rollup_store,
    max_agents: int = DEFAULT_MAX_AGENTS,
    ingest_executor=None,
    federation=None,
) -> str:
    """The manager's full /metrics body: global registry + bounded
    per-agent federation block."""
    t0 = time.monotonic()
    if federation is not None:
        fs = federation.stats()
        _g_peers_total.set(fs["peers_total"])
        _g_peers_live.set(fs["peers_live"])
        _g_adopts.set(fs["adopts"])
        _g_replication_lag.set(fs.get("replication_lag_rows", 0))
        _g_replication_connected.set(fs.get("replication_connected", 0))
    else:
        _g_peers_total.set(0)
        _g_peers_live.set(0)
    # refresh the per-shard gauges (cardinality bounded by shard count,
    # not fleet size) before the registry renders them
    from gpud_tpu_torch.manager.shard import update_shard_gauges

    update_shard_gauges(rollup_store, ingest_executor)
    # fleet-level predictive rollup: one cached pane read feeds four
    # fixed-cardinality gauges (the ranked per-node detail stays behind
    # the paginated operator API, like everything agent-labelled)
    pane = rollup_store.fleet_predict(top=1)
    _g_predict_armed.set(pane["armed"])
    _g_predict_warns.set(pane["warns_total"])
    _g_predict_risk_max.set(
        pane["top"][0]["risk"] if pane["top"] else 0.0
    )
    _g_predict_lead_mean.set(pane["lead"]["mean_seconds"])
    parts: List[str] = [DEFAULT_REGISTRY.render_prometheus()]
    # walk the paginated view (cached + flush-barriered like any other
    # operator read) instead of a private fast path
    rows = []
    offset = 0
    total = None
    while len(rows) < max_agents:
        page = rollup_store.agents_page(
            offset, min(500, max_agents - len(rows))
        )
        total = page["total"]
        for a in page["agents"]:
            comps = list(a["components"].values())
            rows.append({
                "agent": a["agent"],
                "availability": (
                    sum(c["availability"] for c in comps) / len(comps)
                    if comps else 1.0
                ),
                "flap_count": sum(c["flap_count"] for c in comps),
                "outbox_lag_seconds": a["outbox_lag_seconds"],
                "transitions": sum(c["transitions"] for c in comps),
                "unhealthy_series": sum(
                    1 for c in comps if c["state"] and c["state"] != "Healthy"
                ),
                "predict_risk": a.get("predict_risk", 0.0),
            })
        if page["next_offset"] is None:
            break
        offset = page["next_offset"]
    _g_truncated.set(max(0, (total or 0) - len(rows)))
    series = 0
    if rows:
        for name, help_text, field in _AGENT_FAMILIES:
            lines = [f"# HELP {name} {help_text}", f"# TYPE {name} gauge"]
            for row in rows:
                lines.append(
                    f'{name}{{agent="{_escape(row["agent"])}"}} '
                    f'{_fmt(row[field])}'
                )
                series += 1
            parts.append("\n".join(lines) + "\n")
    _g_exposed_series.set(series)
    _h_scrape.observe(time.monotonic() - t0)
    return "".join(parts)


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)
