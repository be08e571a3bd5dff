"""CI gate over the metric registry: every registered metric carries the
``tpud_`` prefix, non-empty help text, Prometheus unit conventions
(counters end ``_total``, durations in base seconds, histograms carry a
base unit), and no reserved label names
(gpud_tpu_torch/tools/metrics_lint.py, as tests/test_metrics_lint.py holds
the reference's). New instrumentation that forgets any of
these fails here, not in production."""

from gpud_tpu_torch.metrics.registry import DEFAULT_REGISTRY, Registry
from gpud_tpu_torch.tools import metrics_lint


def test_lint_flags_bad_names_and_missing_help():
    r = Registry()
    r.gauge("unprefixed_metric", "has help")
    r.counter("tpud_ok_total", "")
    r.histogram("tpud_fine_seconds", "documented")
    problems = metrics_lint.lint_registry(r)
    assert sorted(problems) == [
        "tpud_ok_total: empty help text",
        "unprefixed_metric: missing 'tpud_' name prefix",
    ]


def test_lint_clean_registry_is_silent():
    r = Registry()
    r.gauge("tpud_a", "a")
    r.histogram("tpud_b_seconds", "b")
    assert metrics_lint.lint_registry(r) == []


def test_every_daemon_metric_passes_lint():
    """The real check: import every instrumentation site and lint the full
    default registry. A new metric without prefix/help fails THIS test."""
    metrics_lint.populate_default_registry()
    assert len(DEFAULT_REGISTRY.all_metrics()) >= 30  # the daemon is instrumented
    assert metrics_lint.lint_registry(DEFAULT_REGISTRY) == []


def test_lint_cli_exit_code():
    assert metrics_lint.main() == 0


def test_lint_counter_must_end_total():
    r = Registry()
    r.counter("tpud_things", "counted things")
    assert metrics_lint.lint_registry(r) == [
        "tpud_things: counter must end in '_total'"
    ]


def test_lint_histogram_must_carry_base_unit():
    r = Registry()
    r.histogram("tpud_request_latency", "no unit in the name")
    problems = metrics_lint.lint_registry(r)
    assert len(problems) == 1
    assert "base unit suffix" in problems[0]
    clean = Registry()
    clean.histogram("tpud_latency_seconds", "time")
    clean.histogram("tpud_payload_bytes", "size")
    assert metrics_lint.lint_registry(clean) == []


def test_lint_rejects_non_base_time_units():
    r = Registry()
    r.gauge("tpud_rtt_ms", "milliseconds are not a base unit")
    r.counter("tpud_wait_minutes_total", "neither are minutes")
    problems = sorted(metrics_lint.lint_registry(r))
    assert len(problems) == 2
    assert "'_ms'" in problems[0]
    assert "'_minutes'" in problems[1]
    # gauges that merely END in _total (cumulative-seconds mirrors) pass
    clean = Registry()
    clean.gauge("tpud_sqlite_select_seconds_total", "cumulative seconds")
    assert metrics_lint.lint_registry(clean) == []


def test_lint_rejects_reserved_label_names():
    r = Registry()
    g = r.gauge("tpud_bad_labels", "uses reserved labels")
    g.set(1.0, {"le": "0.5"})
    g.set(2.0, {"__internal": "x"})
    problems = sorted(metrics_lint.lint_registry(r))
    assert len(problems) == 2
    assert "'__internal'" in problems[0]
    assert "'le'" in problems[1]
    # a histogram's self-minted per-bucket 'le' must NOT trip the rule
    clean = Registry()
    h = clean.histogram("tpud_ok_seconds", "fine")
    h.observe(0.1, {"component": "c"})
    assert metrics_lint.lint_registry(clean) == []


def test_the_metric_modules_are_the_ports_and_each_registers_into_the_default_registry():
    import importlib

    assert all(m.startswith("gpud_tpu_torch.") for m in metrics_lint._METRIC_MODULES)
    # the reference's list, module for module, in the port's package
    from gpud_tpu.tools import metrics_lint as ref

    assert metrics_lint._METRIC_MODULES == tuple(
        m.replace("gpud_tpu.", "gpud_tpu_torch.", 1) for m in ref._METRIC_MODULES)
    for m in metrics_lint._METRIC_MODULES:
        importlib.import_module(m)
