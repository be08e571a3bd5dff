"""Precursor feature extractors: the non-numeric early-warning signals; the
port of ``gpud_tpu/predict/features.py``.

"When GPUs Fail Quietly" (arxiv 2509.19575) and eACGM (PAPERS.md) argue
that accelerator failures announce themselves in *system-level* traces —
check-latency drift, health-transition cadence, kernel-log error
sequences — before any telemetry threshold trips. Each extractor here
turns one of those already-persisted traces into a bounded [0, 1]
evidence score; :func:`fuse` combines them with a weighted noisy-OR so
no single weak signal can cross the warning threshold alone, but two
agreeing signals (or one strong state signal) can.

Everything is deterministic and injectable-clock friendly: no wall-clock
reads, no randomness — the seeded unit tests replay the same input
stream and assert bit-identical score trajectories.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

from gpud_tpu_torch.api.v1.types import HealthStateType

# fusion weights: each feature's maximum contribution to the noisy-OR.
# Latency drift alone is deliberately capped BELOW the default warning
# threshold (0.6) so scheduler jitter on an otherwise healthy component
# can never fire a warning without corroboration from a second signal —
# the bench's zero-false-positive gate leans on this structurally.
WEIGHT_LATENCY = 0.5
WEIGHT_CADENCE = 0.7
WEIGHT_TRAJECTORY = 0.75
WEIGHT_NGRAM = 0.6
# fabric neighbor co-occurrence: correlated latency deviations on
# adjacent NVLink ports (gpud_tpu_torch/fabric). Capped below the warning
# threshold for the same no-single-signal reason as latency drift — one
# deviating link pair corroborates, it doesn't convict.
WEIGHT_FABRIC = 0.55
# cross-component co-occurrence: a peer component in the same class (or
# a coupled fabric neighbor) scoring high at the same tick. Capped below
# the threshold — corroboration only, never a conviction on its own.
WEIGHT_COOCCUR = 0.5

FEATURE_WEIGHTS: Dict[str, float] = {
    "latency": WEIGHT_LATENCY,
    "cadence": WEIGHT_CADENCE,
    "trajectory": WEIGHT_TRAJECTORY,
    "ngram": WEIGHT_NGRAM,
    "fabric": WEIGHT_FABRIC,
    "cooccur": WEIGHT_COOCCUR,
}


def clamp01(x: float) -> float:
    if x != x:  # NaN guard: a poisoned feature must not poison the score
        return 0.0
    return 0.0 if x < 0.0 else (1.0 if x > 1.0 else x)


def fuse(
    features: Dict[str, float],
    weights: Optional[Dict[str, float]] = None,
) -> float:
    """Weighted noisy-OR over per-feature evidence scores.

    ``1 - prod(1 - w_i * s_i)`` — monotone in every input, bounded [0, 1],
    and saturating: independent weak evidence accumulates, redundant
    strong evidence doesn't overshoot. ``weights`` overrides individual
    defaults (the calibrator fits per-component-class weights; absent
    keys fall back to :data:`FEATURE_WEIGHTS`).
    """
    acc = 1.0
    for name, s in features.items():
        w = None if weights is None else weights.get(name)
        if w is None:
            w = FEATURE_WEIGHTS.get(name, 0.5)
        acc *= 1.0 - clamp01(w) * clamp01(s)
    return clamp01(1.0 - acc)


def peer_corroboration(
    name: str, scores: Dict[str, float], peers: Iterable[str]
) -> float:
    """Cross-component co-occurrence evidence: the strongest *pair*
    formed by this component and one adjacent peer, scored by the weaker
    member — the same min-of-pair rule as :func:`neighbor_cooccurrence`,
    lifted from links to components. One elevated component scores
    nothing; two coupled components elevating together (the correlated-
    precursor pattern across a shared fabric) score as the weaker of the
    two. Inputs are [0, 1] base scores; output is [0, 1]."""
    own = scores.get(name, 0.0)
    if own <= 0.0:
        return 0.0
    best = 0.0
    for peer in peers:
        if peer == name:
            continue
        pair = min(own, scores.get(peer, 0.0))
        if pair > best:
            best = pair
    return clamp01(best)


def neighbor_cooccurrence(
    deviations: Dict[str, float], adjacency: Dict[str, Iterable[str]]
) -> float:
    """Co-occurrence evidence over a link graph: the strongest *pair* of
    adjacent deviations, scored by the weaker member (min), so one noisy
    link scores nothing but two neighbors deviating together — the
    correlated-precursor pattern "When GPUs Fail Quietly" reports for
    NVLink — scores as high as the weaker of the two. Inputs are [0, 1]
    per-link deviation scores; output is [0, 1]."""
    best = 0.0
    for name, score in deviations.items():
        if score <= best:
            continue
        for peer in adjacency.get(name, ()):
            pair = min(score, deviations.get(peer, 0.0))
            if pair > best:
                best = pair
    return clamp01(best)


class Ewma:
    """Exponentially-weighted mean + variance (West's incremental form)."""

    __slots__ = ("alpha", "mean", "var", "n")

    def __init__(self, alpha: float = 0.3) -> None:
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.var = 0.0
        self.n = 0

    def update(self, x: float) -> None:
        self.n += 1
        if self.mean is None:
            self.mean = x
            self.var = 0.0
            return
        d = x - self.mean
        incr = self.alpha * d
        self.mean += incr
        self.var = (1.0 - self.alpha) * (self.var + d * incr)

    def z(self, x: float, floor: float = 1e-9) -> float:
        """|z|-score of x against the current baseline (0 before any
        history). The scale floor is relative to the mean's magnitude so a
        near-constant series doesn't turn LSB jitter into huge z-scores
        (same trick as models/anomaly_np.py)."""
        if self.mean is None or self.n < 2:
            return 0.0
        scale = math.sqrt(self.var) + floor + 1e-3 * abs(self.mean)
        return abs(x - self.mean) / scale


class LatencyDrift:
    """EWMA + CUSUM changepoint over per-tick mean check latency.

    Fed the cumulative (sum, count) of the component's
    ``tpud_component_check_duration_seconds`` series each tick; the delta
    gives the mean latency of checks that landed since the last tick with
    zero extra instrumentation on the check path. A one-sided CUSUM over
    the |z| stream accumulates *persistent* drift and forgives single
    spikes — the changepoint score is the normalized CUSUM statistic.
    """

    def __init__(
        self,
        alpha: float = 0.3,
        warmup: int = 5,
        cusum_drift: float = 1.0,
        cusum_limit: float = 8.0,
    ) -> None:
        self.ewma = Ewma(alpha)
        self.warmup = warmup
        self.cusum_drift = cusum_drift
        self.cusum_limit = cusum_limit
        self.cusum = 0.0
        self._last_sum = 0.0
        self._last_count = 0
        self.score = 0.0

    def update(self, total_sum: float, total_count: int) -> float:
        new = total_count - self._last_count
        if new <= 0:
            return self.score  # no checks landed this tick: hold
        x = (total_sum - self._last_sum) / new
        self._last_sum = total_sum
        self._last_count = total_count
        if x < 0:  # counter reset (registry cleared in tests)
            self.ewma = Ewma(self.ewma.alpha)
            self.cusum = 0.0
            self.score = 0.0
            return self.score
        if self.ewma.n < self.warmup:
            # warmup: train the baseline, never score — a component's
            # very first checks (cold caches, lazy imports) are not drift
            self.ewma.update(x)
            self.score = 0.0
            return self.score
        z = self.ewma.z(x)
        self.cusum = max(0.0, self.cusum + z - self.cusum_drift)
        self.cusum = min(self.cusum, 2.0 * self.cusum_limit)
        self.ewma.update(x)
        self.score = clamp01(self.cusum / self.cusum_limit)
        return self.score


def cadence_score(
    transition_times: Iterable[float],
    now: float,
    window_seconds: float,
    saturation: int = 5,
) -> float:
    """Transition-cadence evidence from the ledger's recent-transition
    window: how close the component is to the reactive flap detector's
    threshold, plus an acceleration term when the cadence is *rising*
    (more transitions in the recent half-window than the older half) —
    that ordering is exactly what lets the score cross before the
    reactive detector trips."""
    cutoff = now - window_seconds
    recent = [t for t in transition_times if t > cutoff]
    n = len(recent)
    if n == 0:
        return 0.0
    base = n / float(max(1, saturation))
    half = now - window_seconds / 2.0
    newer = sum(1 for t in recent if t > half)
    older = n - newer
    accel = 0.2 if newer > older and n >= 2 else 0.0
    return clamp01(base + accel)


def trajectory_score(
    state: Optional[str],
    transitions: List[Tuple[float, str, str]],
    now: float,
    window_seconds: float,
) -> float:
    """State-trajectory evidence: being (or very recently having been)
    in a degraded band is itself a precursor — a slow telemetry ramp
    walks Healthy → Degraded → Unhealthy, and the Degraded shoulder is
    the early-warning window the reactive detector ignores until the
    hard threshold. The evidence is *deterioration*, so it requires a
    recent in-window transition into a bad state: a component that has
    sat Degraded since boot (a chronically flaky NFS mount, a
    misconfigured probe) is the reactive detector's settled business,
    not news. ``transitions`` is (ts, from, to), any order."""
    newest = 0.0
    for ts, _from_state, to_state in transitions:
        if to_state in (HealthStateType.DEGRADED, HealthStateType.UNHEALTHY):
            newest = max(newest, ts)
    if newest <= 0.0 or newest <= now - window_seconds:
        return 0.0
    if state in (HealthStateType.UNHEALTHY, HealthStateType.DEGRADED):
        return 1.0
    # healthy now: decayed evidence from the newest excursion in-window
    tau = max(1.0, window_seconds / 4.0)
    return clamp01(0.6 * math.exp(-(now - newest) / tau))


class NgramNovelty:
    """Error-class bigram novelty over the component's kmsg event stream.

    The stable ``error_class`` stamped at ingest (kmsg/syncer.py) forms a
    sequence per component; consecutive pairs (bigrams) that have never
    been seen on this host before are the "new failure shape" signal the
    quiet-failure literature calls out. Volume rides along weakly: a
    burst of even *known* error classes is mild evidence. The seen-set is
    bounded and the instantaneous score decays through an exponential
    hold so a one-tick novelty spike survives hysteresis.
    """

    def __init__(
        self,
        max_seen: int = 4096,
        volume_saturation: int = 10,
        hold_decay: float = 0.85,
    ) -> None:
        self.seen: set = set()
        self.max_seen = max_seen
        self.volume_saturation = volume_saturation
        self.hold_decay = hold_decay
        self.score = 0.0
        self._last_ts = 0.0

    def update(self, classes_oldest_first: List[Tuple[float, str]]) -> float:
        """``classes_oldest_first``: (ts, error_class) within the feature
        window, oldest first. Only events newer than the last processed
        timestamp mint novelty (replay-safe across ticks)."""
        seq = [c for _ts, c in classes_oldest_first]
        fresh = [
            (ts, c) for ts, c in classes_oldest_first if ts > self._last_ts
        ]
        if fresh:
            self._last_ts = max(ts for ts, _c in fresh)
        new_bigrams = 0
        for i in range(1, len(seq)):
            bg = (seq[i - 1], seq[i])
            if bg not in self.seen:
                new_bigrams += 1
                if len(self.seen) < self.max_seen:
                    self.seen.add(bg)
        # unigram novelty: the very first event of a class counts too
        # (a single never-seen error class needs no pair to be news)
        for ts, c in fresh:
            if ("", c) not in self.seen:
                new_bigrams += 1
                if len(self.seen) < self.max_seen:
                    self.seen.add(("", c))
        volume = min(
            1.0, len(fresh) / float(max(1, self.volume_saturation))
        )
        instant = clamp01(
            (0.5 * min(new_bigrams, 4) / 2.0 if new_bigrams else 0.0)
            + 0.3 * volume
        )
        self.score = max(instant, self.score * self.hold_decay)
        if self.score < 1e-3:
            self.score = 0.0
        return self.score
