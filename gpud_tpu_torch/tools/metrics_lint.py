"""Metric-registry lint: naming, unit, label, and help-text discipline.

Every metric the daemon registers must (a) carry the ``tpud_`` namespace
prefix — fleet Prometheus setups scrape many exporters into one TSDB, and
an unprefixed name collides or becomes unattributable — and (b) carry
non-empty help text, because `/metrics` is the operator's first (often
only) documentation of what a series means. On top of that, Prometheus
unit conventions are enforced: counters end ``_total``; time-valued
histograms and gauges use base seconds (no ``_ms``/``_us``/... suffixes);
histogram names carry a base unit (``_seconds``/``_bytes``); and no
metric may mint a label the exposition format reserves (``le``,
``quantile``, ``__*``). The lint runs in CI via
``tests/test_torch_metrics_lint.py`` so new instrumentation cannot silently ship
unnamed or undocumented metrics, and is runnable standalone:

    python -m gpud_tpu_torch.tools.metrics_lint
"""

from __future__ import annotations

import sys
from typing import List

METRIC_NAME_PREFIX = "tpud_"

# non-base time units: Prometheus wants base seconds so dashboards never
# have to guess the scale of a duration series
_BAD_UNIT_SUFFIXES = (
    "_ms", "_milliseconds", "_us", "_microseconds",
    "_ns", "_nanoseconds", "_minutes", "_hours",
)

# base units a histogram may be denominated in
_HISTOGRAM_UNIT_SUFFIXES = ("_seconds", "_bytes")

# label names the exposition format itself mints (histogram buckets,
# summary quantiles) or reserves (double-underscore internals)
_RESERVED_LABELS = ("le", "quantile")

# modules whose import (or cheap construction) registers every metric the
# daemon can expose — keep in sync with new instrumentation sites
_METRIC_MODULES = (
    "gpud_tpu_torch.chaos.runner",
    "gpud_tpu_torch.components.all",
    "gpud_tpu_torch.components.base",
    "gpud_tpu_torch.eventstore",
    "gpud_tpu_torch.fabric.plane",
    "gpud_tpu_torch.health_history",
    "gpud_tpu_torch.manager.exposition",
    "gpud_tpu_torch.manager.rollup",
    "gpud_tpu_torch.manager.shard",
    "gpud_tpu_torch.predict.engine",
    "gpud_tpu_torch.scheduler.core",
    "gpud_tpu_torch.server.app",
    "gpud_tpu_torch.session.dispatch",
    "gpud_tpu_torch.session.outbox",
    "gpud_tpu_torch.session.session",
    "gpud_tpu_torch.session.wire",
    "gpud_tpu_torch.sqlite",
    "gpud_tpu_torch.storage.writer",
)


def _counter_base_name(name: str) -> str:
    """Counter unit checks apply to the name minus the ``_total`` suffix."""
    return name[: -len("_total")] if name.endswith("_total") else name


def lint_registry(registry) -> List[str]:
    """Return one problem string per violation; empty list = clean."""
    problems: List[str] = []
    for m in registry.all_metrics():
        if not m.name.startswith(METRIC_NAME_PREFIX):
            problems.append(
                f"{m.name}: missing {METRIC_NAME_PREFIX!r} name prefix"
            )
        if not m.help_text.strip():
            problems.append(f"{m.name}: empty help text")
        kind = getattr(m, "TYPE", "")
        if kind == "counter" and not m.name.endswith("_total"):
            problems.append(f"{m.name}: counter must end in '_total'")
        if kind == "histogram" and not m.name.endswith(_HISTOGRAM_UNIT_SUFFIXES):
            problems.append(
                f"{m.name}: histogram must carry a base unit suffix "
                f"({'|'.join(_HISTOGRAM_UNIT_SUFFIXES)})"
            )
        unit_name = _counter_base_name(m.name) if kind == "counter" else m.name
        for suffix in _BAD_UNIT_SUFFIXES:
            if unit_name.endswith(suffix):
                problems.append(
                    f"{m.name}: non-base time unit {suffix!r} "
                    "(use base seconds: '_seconds')"
                )
                break
        # labels_values() is the scalar view: for histograms it excludes
        # the self-minted per-bucket 'le', so anything reserved here was
        # supplied by instrumentation code
        seen: set = set()
        for key, _value in m.labels_values():
            for lname, _lval in key:
                if lname in seen:
                    continue
                seen.add(lname)
                if lname in _RESERVED_LABELS or lname.startswith("__"):
                    problems.append(
                        f"{m.name}: label {lname!r} collides with a "
                        "reserved Prometheus label name"
                    )
    return problems


def populate_default_registry() -> None:
    """Import every metric-defining module so module-level registrations
    land in the default registry, then construct the recorder (its metrics
    register at construction, not import)."""
    import importlib

    for mod in _METRIC_MODULES:
        importlib.import_module(mod)

    from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY
    from gpud_tpu_torch.metrics.store import SelfMetricsRecorder
    from gpud_tpu_torch.sqlite import DB

    db = DB(":memory:")
    try:
        SelfMetricsRecorder(DEFAULT_REGISTRY, db)
    finally:
        db.close()


def main() -> int:
    populate_default_registry()
    from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY

    problems = lint_registry(DEFAULT_REGISTRY)
    for p in problems:
        print(f"metrics-lint: {p}", file=sys.stderr)
    n = len(DEFAULT_REGISTRY.all_metrics())
    if problems:
        print(f"metrics-lint: {len(problems)} problem(s) in {n} metrics",
              file=sys.stderr)
        return 1
    print(f"metrics-lint: {n} metrics clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
