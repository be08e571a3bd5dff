"""Threshold calibration: fit per-component-class warning thresholds and
feature weights by replaying the node's own health-ledger history; the port
of ``gpud_tpu/predict/calibrate.py``.

The global ``predict_threshold`` default (0.6) is a fleet-wide
compromise: it must sit above the benign score noise of the *noisiest*
component class anywhere, which leaves quiet classes with headroom a
lower threshold could convert into earlier warnings. The calibrator
closes that gap per node, per class, with a zero-false-positive
guarantee against the node's own recorded past:

1. Replay the component class's full persisted transition timeline
   (:meth:`HealthLedger.history` — the durable twin of the in-memory
   deques the live scorer reads) and score every transition instant with
   the same cadence + trajectory extractors the engine runs online.
2. Label each sample *benign* unless the component transitions into
   Unhealthy within ``horizon_seconds`` after it; samples that precede a
   failure are the precursor shoulder the threshold must stay below.
3. The calibrated threshold is the benign score quantile-max plus a
   margin, clamped to ``[min_threshold, global default]`` — it only ever
   *lowers* the bar, and never below any benign sample, so replaying the
   same history through the calibrated threshold arms zero times on
   benign samples by construction.
4. Feature weights are fitted the same way: a feature whose benign
   replay maximum is historically noisy gets its weight scaled down so
   that feature alone can never cross the calibrated threshold — the
   per-class restatement of the "no single weak signal convicts"
   structural rule in features.py.

Thin history (< ``min_history`` transitions for the class) falls back to
the global defaults: a node that has never misbehaved has nothing to
calibrate against, and a freshly imaged node must not inherit a
hair-trigger threshold from noise.

Deterministic and clock-injectable like everything else in this package:
the replay is a pure function of the ledger rows and the knobs.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from gpud_tpu_torch.api.v1.types import HealthStateType
from gpud_tpu_torch.predict.features import (
    FEATURE_WEIGHTS,
    cadence_score,
    clamp01,
    fuse,
    trajectory_score,
)

# outbox payload schema for ``predict_score`` records: bump when the
# payload shape changes incompatibly. The manager ingests any schema it
# knows (<= this) and counts-but-never-drops newer ones (docs/fleet.md).
PREDICT_SCHEMA = 1

DEFAULT_MIN_HISTORY = 8
DEFAULT_MIN_THRESHOLD = 0.35
DEFAULT_MARGIN = 0.05
DEFAULT_HORIZON = 900.0
DEFAULT_CALIBRATE_INTERVAL = 3600.0

# fitted weights never drop below this fraction of their default: a
# weight scaled to ~0 would silently delete a feature from the fusion,
# which is a config decision, not a calibration outcome
MIN_WEIGHT_FRACTION = 0.3

# the replayed feature subset: cadence + trajectory are pure functions
# of the transition timeline the ledger persists. Latency/ngram state
# lives in unlogged online extractors and cannot be replayed from the
# ledger, so their weights are never fitted here.
REPLAYED_FEATURES = ("cadence", "trajectory")


def component_class(name: str) -> str:
    """Map a component name to its class: the name with any trailing
    instance index stripped (``accelerator-gpu-3`` → ``accelerator-gpu``;
    un-indexed names are their own class). Calibration and the fleet
    pane both group by this."""
    base = str(name).rstrip("0123456789")
    base = base.rstrip("-_.")
    return base or str(name)


def _replay_samples(
    rows: List[Dict],
    window_seconds: float,
    saturation: int,
    horizon_seconds: float,
) -> List[Tuple[Dict[str, float], bool]]:
    """Score every transition instant of one component's ascending
    timeline. Returns ``(features, benign)`` per sample; a sample is
    benign iff no later transition lands in Unhealthy within the
    horizon."""
    times = [r["time"] for r in rows]
    unhealthy_ts = [
        r["time"] for r in rows if r["to"] == HealthStateType.UNHEALTHY
    ]
    out: List[Tuple[Dict[str, float], bool]] = []
    for i, row in enumerate(rows):
        now = row["time"]
        seen = [
            (r["time"], r["from"], r["to"]) for r in rows[: i + 1]
        ]
        feats = {
            "cadence": cadence_score(
                times[: i + 1], now, window_seconds, saturation=saturation
            ),
            "trajectory": trajectory_score(row["to"], seen, now,
                                           window_seconds),
        }
        # the failure instant itself is ground truth, not benign noise —
        # a threshold firing AT the Unhealthy transition is the reactive
        # signal, never a false positive to calibrate above
        benign = row["to"] != HealthStateType.UNHEALTHY and not any(
            now < ts <= now + horizon_seconds for ts in unhealthy_ts
        )
        out.append((feats, benign))
    return out


class ClassCalibration:
    """One class's fitted threshold + weights and its provenance."""

    __slots__ = (
        "threshold", "weights", "source", "samples", "benign_samples",
        "benign_max", "precursor_min", "components", "fitted_at",
    )

    def __init__(self, threshold: float, weights: Dict[str, float]) -> None:
        self.threshold = threshold
        self.weights = weights
        self.source = "default"
        self.samples = 0
        self.benign_samples = 0
        self.benign_max = 0.0
        self.precursor_min: Optional[float] = None
        self.components = 0
        self.fitted_at = 0.0

    def as_dict(self) -> Dict:
        return {
            "threshold": round(self.threshold, 4),
            "weights": {
                k: round(v, 4) for k, v in sorted(self.weights.items())
            },
            "source": self.source,
            "samples": self.samples,
            "benign_samples": self.benign_samples,
            "benign_max": round(self.benign_max, 4),
            "precursor_min": (
                None if self.precursor_min is None
                else round(self.precursor_min, 4)
            ),
            "components": self.components,
            "fitted_at": self.fitted_at,
        }


class ThresholdCalibrator:
    """Fit per-class thresholds/weights from one ledger's history.

    Stateless between :meth:`calibrate` calls — the engine owns the
    fitted map and swaps it atomically under its own lock."""

    def __init__(
        self,
        ledger=None,
        default_threshold: float = 0.6,
        window_seconds: float = 600.0,
        min_history: int = DEFAULT_MIN_HISTORY,
        min_threshold: float = DEFAULT_MIN_THRESHOLD,
        margin: float = DEFAULT_MARGIN,
        horizon_seconds: float = DEFAULT_HORIZON,
    ) -> None:
        self.ledger = ledger
        self.default_threshold = float(default_threshold)
        self.window = float(window_seconds)
        self.min_history = max(1, int(min_history))
        self.min_threshold = float(min_threshold)
        self.margin = float(margin)
        self.horizon = float(horizon_seconds)

    # -- fitting -----------------------------------------------------------
    def calibrate(
        self, now: float, components: Optional[Iterable[str]] = None
    ) -> Dict[str, ClassCalibration]:
        """Fit every class present in the ledger history (optionally
        restricted to ``components``). Returns {class: ClassCalibration};
        classes with thin history get a default-sourced entry so views
        can show *why* a class is uncalibrated."""
        if self.ledger is None:
            return {}
        rows = self.ledger.history()
        rows.reverse()  # history() is newest-first; replay wants ascending
        wanted = None if components is None else {
            component_class(c) for c in components
        }
        by_comp: Dict[str, List[Dict]] = {}
        for r in rows:
            by_comp.setdefault(r["component"], []).append(r)
        by_class: Dict[str, List[Tuple[str, List[Dict]]]] = {}
        for comp, comp_rows in sorted(by_comp.items()):
            cls = component_class(comp)
            if wanted is not None and cls not in wanted:
                continue
            by_class.setdefault(cls, []).append((comp, comp_rows))
        saturation = 5
        if self.ledger is not None:
            saturation = max(2, int(getattr(self.ledger, "flap_threshold", 5)))
        out: Dict[str, ClassCalibration] = {}
        for cls, members in sorted(by_class.items()):
            out[cls] = self._fit_class(cls, members, saturation, now)
        return out

    def _fit_class(
        self,
        cls: str,
        members: List[Tuple[str, List[Dict]]],
        saturation: int,
        now: float,
    ) -> ClassCalibration:
        cal = ClassCalibration(self.default_threshold, dict(FEATURE_WEIGHTS))
        cal.components = len(members)
        cal.fitted_at = now
        samples: List[Tuple[Dict[str, float], bool]] = []
        for _comp, comp_rows in members:
            samples.extend(
                _replay_samples(comp_rows, self.window, saturation,
                                self.horizon)
            )
        cal.samples = len(samples)
        if cal.samples < self.min_history:
            return cal  # thin history: global defaults, source="default"
        benign_scores: List[float] = []
        benign_feat_max: Dict[str, float] = {f: 0.0 for f in REPLAYED_FEATURES}
        precursor_scores: List[float] = []
        for feats, benign in samples:
            score = fuse(feats)
            if benign:
                benign_scores.append(score)
                for f in REPLAYED_FEATURES:
                    if feats[f] > benign_feat_max[f]:
                        benign_feat_max[f] = feats[f]
            else:
                precursor_scores.append(score)
        cal.benign_samples = len(benign_scores)
        cal.benign_max = max(benign_scores) if benign_scores else 0.0
        cal.precursor_min = (
            min(precursor_scores) if precursor_scores else None
        )
        # threshold: one margin above the benign maximum (the 100th
        # benign quantile — zero historical false positives by
        # construction), clamped so calibration only ever lowers the
        # global bar, never raises it, and never below the floor
        fitted = clamp01(cal.benign_max + self.margin)
        cal.threshold = min(
            self.default_threshold, max(self.min_threshold, fitted)
        )
        # weights: scale down any replayed feature whose benign maximum
        # could alone cross the fitted threshold (w * benign_max must
        # stay below threshold - margin), floored so no feature is
        # silently deleted from the fusion
        for f in REPLAYED_FEATURES:
            default_w = FEATURE_WEIGHTS[f]
            peak = benign_feat_max[f]
            if peak <= 0.0:
                continue
            cap = (cal.threshold - self.margin) / peak
            floor = default_w * MIN_WEIGHT_FRACTION
            cal.weights[f] = min(default_w, max(floor, cap))
        cal.source = "calibrated"
        return cal
