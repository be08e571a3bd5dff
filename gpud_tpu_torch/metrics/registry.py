"""Metrics registry: Gauges/Counters all components register into.

Reference: pkg/metrics/registry.go:5-23 — a package-global Prometheus
registry. Here a small dependency-free implementation that renders the
Prometheus text exposition format for the /metrics endpoint and feeds the
scraper → SQLite pipeline.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple, Type, TypeVar

LabelKey = Tuple[Tuple[str, str], ...]
Sample = Tuple[str, LabelKey, float]  # (exposition name, labels, value)


def _label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _render_labels(key: LabelKey) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Metric:
    TYPE = "gauge"

    # Gauge and Counter inherit this map (guard_lint merges base-class
    # GUARDED_BY down through in-module subclasses)
    GUARDED_BY = {"_values": "_mu"}

    def __init__(
        self, name: str, help_text: str, registry: Optional["Registry"] = None
    ) -> None:
        self.name = name
        self.help_text = help_text
        self._mu = threading.Lock()
        self._values: Dict[LabelKey, float] = {}
        # registry=None lets Registry construct the metric while already
        # holding its own lock (atomic get-or-create) without re-entry
        if registry is not None:
            registry._register(self)

    def labels_values(self) -> List[Tuple[LabelKey, float]]:
        with self._mu:
            return list(self._values.items())

    def samples(self) -> List[Sample]:
        """Exposition/gather view: one sample per labelset, sorted for
        deterministic output. Histograms expand to multiple series here."""
        return [(self.name, key, value) for key, value in sorted(self.labels_values())]

    def clear(self) -> None:
        with self._mu:
            self._values.clear()

    def remove(self, labels: Optional[Dict[str, str]] = None) -> None:
        with self._mu:
            self._values.pop(_label_key(labels), None)


class Gauge(_Metric):
    TYPE = "gauge"

    def set(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        with self._mu:
            self._values[_label_key(labels)] = float(value)

    def get(self, labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        with self._mu:
            return self._values.get(_label_key(labels))


class Counter(_Metric):
    TYPE = "counter"

    def inc(self, amount: float = 1.0, labels: Optional[Dict[str, str]] = None) -> None:
        k = _label_key(labels)
        with self._mu:
            self._values[k] = self._values.get(k, 0.0) + amount

    def get(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._mu:
            return self._values.get(_label_key(labels), 0.0)


# latency-oriented default buckets: the daemon's hot paths (checks, HTTP
# handlers, sqlite queries, dispatch) live between ~1ms and the 60s poll
# cadence (reference: prometheus client_golang DefBuckets, widened upward)
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class _HistogramTimer:
    """``with h.time(labels):`` — observes wall duration on exit, including
    the exception path (failure latency is still latency)."""

    __slots__ = ("_hist", "_labels", "_t0")

    def __init__(self, hist: "Histogram", labels: Optional[Dict[str, str]]) -> None:
        self._hist = hist
        self._labels = labels

    def __enter__(self) -> "_HistogramTimer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._hist.observe(time.monotonic() - self._t0, self._labels)


class Histogram(_Metric):
    """Cumulative-bucket histogram with the standard Prometheus exposition
    (``name_bucket{le=...}``/``name_sum``/``name_count``). Bucket bounds are
    fixed at creation; per-labelset state is (per-bucket counts, sum, count).
    """

    TYPE = "histogram"

    GUARDED_BY = {"_series": "_mu"}  # plus _Metric's inherited _values

    def __init__(
        self,
        name: str,
        help_text: str,
        registry: Optional["Registry"] = None,
        buckets: Optional[Iterable[float]] = None,
    ) -> None:
        bounds = sorted(
            {float(b) for b in (DEFAULT_BUCKETS if buckets is None else buckets)}
        )
        # the +Inf bucket is implicit (it always equals _count)
        bounds = [b for b in bounds if not math.isinf(b)]
        if not bounds or any(math.isnan(b) for b in bounds):
            raise ValueError(f"histogram {name}: invalid buckets {bounds!r}")
        self.buckets: Tuple[float, ...] = tuple(bounds)
        # bucket bounds never change after creation: render the ``le``
        # label values once here instead of per-sample on every scrape
        # (the exposition path runs while check threads are observing)
        self._le_strs: Tuple[str, ...] = tuple(
            _format_value(b) for b in self.buckets
        )
        super().__init__(name, help_text, registry)
        # LabelKey -> [bucket_counts, sum, count]
        self._series: Dict[LabelKey, list] = {}

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None) -> None:
        v = float(value)
        k = _label_key(labels)
        with self._mu:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = [[0] * len(self.buckets), 0.0, 0]
            for i, b in enumerate(self.buckets):
                if v <= b:
                    s[0][i] += 1
                    break
            s[1] += v
            s[2] += 1

    def time(self, labels: Optional[Dict[str, str]] = None) -> _HistogramTimer:
        return _HistogramTimer(self, labels)

    def get_count(self, labels: Optional[Dict[str, str]] = None) -> int:
        with self._mu:
            s = self._series.get(_label_key(labels))
            return s[2] if s else 0

    def get_sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._mu:
            s = self._series.get(_label_key(labels))
            return s[1] if s else 0.0

    def labels_values(self) -> List[Tuple[LabelKey, float]]:
        """Observation count per labelset (the scalar view of a histogram)."""
        with self._mu:
            return [(k, float(s[2])) for k, s in self._series.items()]

    def samples(self) -> List[Sample]:
        # hold the lock ONLY for the raw state copy; sorting and series
        # expansion run outside it so observe() on the check/HTTP hot
        # paths is never blocked behind exposition formatting
        with self._mu:
            snap = [
                (k, list(s[0]), s[1], s[2]) for k, s in self._series.items()
            ]
        snap.sort(key=lambda item: item[0])
        out: List[Sample] = []
        for key, counts, total, n in snap:
            cum = 0
            for le, c in zip(self._le_strs, counts):
                cum += c
                out.append(
                    (self.name + "_bucket", key + (("le", le),), float(cum))
                )
            out.append((self.name + "_bucket", key + (("le", "+Inf"),), float(n)))
            out.append((self.name + "_sum", key, float(total)))
            out.append((self.name + "_count", key, float(n)))
        return out

    def clear(self) -> None:
        with self._mu:
            self._series.clear()

    def remove(self, labels: Optional[Dict[str, str]] = None) -> None:
        with self._mu:
            self._series.pop(_label_key(labels), None)


MetricT = TypeVar("MetricT", bound=_Metric)


class Registry:
    GUARDED_BY = {"_metrics": "_mu"}

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, m: _Metric) -> None:
        with self._mu:
            if m.name in self._metrics:
                raise ValueError(f"metric already registered: {m.name}")
            self._metrics[m.name] = m

    def _get_or_create(
        self, name: str, cls: Type[MetricT], help_text: str, **kwargs
    ) -> MetricT:
        """Atomic check-then-create: two threads racing on the same name
        must both get the one metric, never a 'metric already registered'
        ValueError. The metric is constructed unregistered (registry=None)
        and inserted under the same lock acquisition as the lookup."""
        with self._mu:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise TypeError(f"{name} is not a {cls.TYPE}: {existing.TYPE}")
                return existing
            m = cls(name, help_text, None, **kwargs)
            self._metrics[name] = m
            return m

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help_text)

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(name, Counter, help_text)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        buckets: Optional[Iterable[float]] = None,
    ) -> Histogram:
        """Get-or-create; an existing histogram keeps its original buckets
        (bucket bounds are part of the series' identity once scraped)."""
        return self._get_or_create(name, Histogram, help_text, buckets=buckets)

    def unregister(self, name: str) -> None:
        with self._mu:
            self._metrics.pop(name, None)

    def all_metrics(self) -> List[_Metric]:
        with self._mu:
            return [self._metrics[k] for k in sorted(self._metrics)]

    # -- exposition --------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text format for /metrics
        (reference: pkg/server/server.go:415-418)."""
        lines: List[str] = []
        for m in self.all_metrics():
            if m.help_text:
                # exposition format: HELP text escapes backslash + newline
                escaped = m.help_text.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {m.name} {escaped}")
            lines.append(f"# TYPE {m.name} {m.TYPE}")
            for name, key, value in m.samples():
                lines.append(f"{name}{_render_labels(key)} {_format_value(value)}")
        return "\n".join(lines) + "\n"

    def gather(self, now: Optional[float] = None) -> List[Tuple[int, str, Dict[str, str], float]]:
        """Snapshot for the scraper: (unix_seconds, name, labels, value).
        Histograms flow through as their bucket/sum/count series (the ``le``
        bound rides in the labels), so the SQLite store needs no schema
        change to hold them."""
        ts = int(now if now is not None else time.time())
        out = []
        for m in self.all_metrics():
            for name, key, value in m.samples():
                out.append((ts, name, dict(key), value))
        return out


def _format_value(v: float) -> str:
    # non-finite values per the exposition format — one inf/NaN gauge
    # (e.g. a stray division) must not 500 the whole /metrics endpoint
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


# package-global default registry (reference: pkg/metrics/registry.go:5)
DEFAULT_REGISTRY = Registry()


def gauge(name: str, help_text: str = "") -> Gauge:
    return DEFAULT_REGISTRY.gauge(name, help_text)


def counter(name: str, help_text: str = "") -> Counter:
    return DEFAULT_REGISTRY.counter(name, help_text)


def histogram(
    name: str, help_text: str = "", buckets: Optional[Iterable[float]] = None
) -> Histogram:
    return DEFAULT_REGISTRY.histogram(name, help_text, buckets=buckets)
