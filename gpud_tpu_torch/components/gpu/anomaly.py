"""GPU telemetry anomaly component — the daemon's analytics check.

The port of ``gpud_tpu/components/tpu/anomaly.py``. No direct reference
analog (the reference stops at threshold checks): it feeds recent per-GPU
telemetry windows from the metrics store (the 3-stage pipeline of SURVEY
§5.5, reference: pkg/metrics/syncer/syncer.go:22-50) through the robust
EWMA/MAD scorer and surfaces per-GPU drift — "GPU 3 is running away from
its own recent behavior" — as Degraded with events, before a hard threshold
(thermal slowdown, memory ECC) trips.

Backend selection (``TPUD_ANALYTICS_BACKEND`` = auto|numpy|torch):
- ``numpy`` — the torch-free twin (models/anomaly_np.py); the default
  product path, keeps daemon RSS under the footprint target.
- ``torch`` — models/anomaly.robust_scores on the component's ``device``
  (``None``: the card, and an error without one; never the CPU by itself).
- ``auto``  — torch only if this process already holds a CUDA context
  (cost already paid): creating one reserves device memory beside the
  training job, as the opt-in ``TorchBackend`` notes (gpu/instance.py).

Importing this module loads no torch; the torch branch imports it.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from gpud_tpu_torch.api.v1.types import Event, EventType, HealthStateType
from gpud_tpu_torch.components.base import CheckResult, PollingComponent, TpudInstance
from gpud_tpu_torch.metrics.registry import gauge
from gpud_tpu_torch.metrics.store import MetricsStore

NAME = "accelerator-gpu-anomaly"

_g_score = gauge("tpud_gpu_anomaly_score", "per-GPU telemetry anomaly score")

# metric-name → feature column; all are per-GPU gauges recorded by the
# temperature/power/memory components into the shared metrics pipeline
FEATURE_METRICS: List[str] = [
    "tpud_gpu_temperature_celsius",
    "tpud_gpu_memory_temperature_celsius",
    "tpud_gpu_power_watts",
    "tpud_gpu_duty_cycle_percent",
    "tpud_gpu_memory_util_percent",
    "tpud_gpu_clock_mhz",
    "tpud_gpu_memory_used_bytes",
]

MIN_SAMPLES = 8          # scrape sweeps needed before scoring (warm-up)
MAX_WINDOW_SAMPLES = 180 # cap at 3h of 1-minute sweeps (metrics retention)
DEFAULT_LOOKBACK = 3 * 3600.0
DEFAULT_SCORE_DEGRADED = 6.0  # well above the ~1-2 nominal band (see tests)

# the event keeps the reference's name (the port's parity rule)
EVENT_NAME = "tpu_telemetry_anomaly"


def _torch_cuda_initialized() -> bool:
    """True only when this process already holds a CUDA context.

    Importable is not enough, and neither is an imported torch: the first
    CUDA call would create the context, which reserves device memory next
    to the training job a side-band daemon must never contend with."""
    torch = sys.modules.get("torch")
    return torch is not None and bool(torch.cuda.is_initialized())


def _score_windows(
    windows: np.ndarray, backend: str, device=None
) -> Tuple[np.ndarray, str]:
    """Returns (scores, resolved backend name actually used)."""
    if backend == "auto":
        backend = "torch" if _torch_cuda_initialized() else "numpy"
    if backend == "torch":
        import torch

        from gpud_tpu_torch.device import resolve_device
        from gpud_tpu_torch.models.anomaly import robust_scores

        x = torch.from_numpy(windows).to(resolve_device(device))
        # one copy back for every GPU's score: a Python scalar read per GPU
        # would wait for the device once each
        return robust_scores(x).cpu().numpy(), "torch"
    from gpud_tpu_torch.models.anomaly_np import robust_scores_np

    return robust_scores_np(windows), "numpy"


class GPUAnomalyComponent(PollingComponent):
    NAME = NAME
    TAGS = ["accelerator", "gpu", "analytics"]

    def __init__(self, instance: TpudInstance) -> None:
        super().__init__(instance)
        self.gpu = instance.gpu_instance
        self.metrics_store: Optional[MetricsStore] = (
            MetricsStore(instance.db_rw) if instance.db_rw is not None else None
        )
        self._event_bucket = (
            instance.event_store.bucket(NAME) if instance.event_store else None
        )
        self.backend = os.environ.get("TPUD_ANALYTICS_BACKEND", "auto")
        # where the torch backend scores: None is the card
        self.device = None
        self.lookback_seconds = DEFAULT_LOOKBACK
        self.score_degraded = DEFAULT_SCORE_DEGRADED
        self.min_samples = MIN_SAMPLES
        self.burst_interval_seconds = 0.25  # scan-mode burst sampling cadence

    def is_supported(self) -> bool:
        return (
            self.gpu is not None
            and self.gpu.gpu_lib_exists()
            and self.gpu.telemetry_supported()
        )

    # -- scan-mode burst sampling -----------------------------------------
    def _burst_windows(self) -> Tuple[List[str], np.ndarray]:
        """Scan mode has no metrics history (EventStore/DB are nil there,
        reference: pkg/scan/scan.go:83-100), so take a short burst of live
        telemetry samples instead — the 'read everything now' scan-mode
        path, like the Xid check reading the whole kmsg ring (SURVEY §3.2)."""
        frames: List[Dict[str, List[float]]] = []
        for i in range(self.min_samples):
            if i:
                self._stop_event.wait(self.burst_interval_seconds)
            tel = self.gpu.telemetry()
            frame: Dict[str, List[float]] = {}
            for gid, t in sorted(tel.items()):
                frame[str(gid)] = [
                    t.temperature_c,
                    t.memory_temperature_c,
                    t.power_w,
                    t.duty_cycle_pct,
                    t.memory_util_pct,
                    t.clock_mhz,
                    float(t.memory_used_bytes),
                ]
            frames.append(frame)
        # keep only frames matching the most complete GPU set seen, so the
        # array stays rectangular even if a GPU vanishes (or appears late)
        # mid-burst — GPU loss alarms via gpu-counts, not here
        if not frames:
            return [], np.zeros((0, 0, 0), dtype=np.float32)
        full = max((set(f) for f in frames), key=len)
        gpus = sorted(full, key=lambda g: (len(g), g))
        frames = [f for f in frames if set(f) == full]
        if not gpus or len(frames) < 2:
            return [], np.zeros((0, 0, 0), dtype=np.float32)
        windows = np.asarray(
            [[f[g] for f in frames] for g in gpus], dtype=np.float32
        )
        return gpus, windows

    # -- window assembly ---------------------------------------------------
    def _build_windows(self, now: float) -> Tuple[List[str], np.ndarray]:
        """Read recent telemetry from the metrics store into [G, T, F].

        Timeline = the union of observed timestamps; each (GPU, feature)
        series is aligned onto it with forward-fill (leading gaps repeat
        the first sample). Intersecting timestamps across all pairs
        instead would let ONE flaky gauge on ONE GPU shrink the common
        set below min_samples and silently disable drift scoring
        fleet-wide. A GPU that never reported some feature in-window is
        skipped alone; GPU loss alarms via gpu-counts, not here.
        """
        assert self.metrics_store is not None
        by: Dict[str, Dict[str, Dict[int, float]]] = {}
        # one name-filtered read per feature so the (name, ts) index prunes
        # the scan instead of walking every component's metrics
        for name in FEATURE_METRICS:
            for m in self.metrics_store.read(now - self.lookback_seconds, name=name):
                gid = m.labels.get("gpu")
                if gid is None:
                    continue
                by.setdefault(gid, {}).setdefault(name, {})[m.unix_seconds] = m.value
        if not by:
            return [], np.zeros((0, 0, 0), dtype=np.float32)

        union: set = set()
        for feats in by.values():
            for series in feats.values():
                union |= set(series)
        ts_sorted = sorted(union)[-MAX_WINDOW_SAMPLES:]
        if len(ts_sorted) < self.min_samples:
            return [], np.zeros((0, 0, 0), dtype=np.float32)
        timeline = np.asarray(ts_sorted, dtype=np.float64)

        gpus: List[str] = []
        rows: List[np.ndarray] = []
        for gid in sorted(by, key=lambda g: (len(g), g)):  # numeric-ish order
            feats = by[gid]
            if any(not feats.get(name) for name in FEATURE_METRICS):
                continue  # no data at all for a feature → skip this GPU only
            per_feature = []
            for name in FEATURE_METRICS:
                series = feats[name]
                s_ts = np.asarray(sorted(series), dtype=np.float64)
                s_val = np.asarray(
                    [series[t] for t in sorted(series)], dtype=np.float32
                )
                idx = np.searchsorted(s_ts, timeline, side="right") - 1
                idx = np.clip(idx, 0, len(s_ts) - 1)
                per_feature.append(s_val[idx])
            rows.append(np.stack(per_feature, axis=1))  # [T, F]
            gpus.append(gid)
        if not gpus:
            return [], np.zeros((0, 0, 0), dtype=np.float32)
        return gpus, np.stack(rows, axis=0)

    def _record_event(self, gid: str, score: float, now: float) -> None:
        if self._event_bucket is None:
            return
        message = f"GPU {gid} telemetry drifting (anomaly score {score:.1f})"
        # dedupe: one event per GPU per lookback window
        for e in self._event_bucket.get(now - self.lookback_seconds):
            if e.name == EVENT_NAME and e.extra_info.get("gpu") == gid:
                return
        self._event_bucket.insert(
            Event(
                component=NAME,
                name=EVENT_NAME,
                type=EventType.WARNING,
                message=message,
                extra_info={"gpu": gid, "score": f"{score:.2f}"},
            )
        )

    def check_once(self) -> CheckResult:
        if not self.is_supported():
            return CheckResult(
                self.NAME,
                health=HealthStateType.HEALTHY,
                reason="no GPU telemetry on this host",
            )
        now = self.time_now_fn()
        if self.metrics_store is not None:
            gpus, windows = self._build_windows(now)
        else:
            gpus, windows = self._burst_windows()
        if not gpus:
            return CheckResult(
                self.NAME,
                health=HealthStateType.HEALTHY,
                reason=f"warming up: <{self.min_samples} telemetry sweeps recorded",
            )

        scores, used_backend = _score_windows(windows, self.backend, self.device)
        extra = {"samples": str(windows.shape[1]), "backend": used_backend}
        drifting: List[Tuple[str, float]] = []
        for gid, score in zip(gpus, scores):
            s = float(score)
            _g_score.set(s, {"component": NAME, "gpu": gid})
            extra[f"gpu{gid}_score"] = f"{s:.2f}"
            if s >= self.score_degraded:
                drifting.append((gid, s))

        if drifting:
            for gid, s in drifting:
                self._record_event(gid, s, now)
            names = ", ".join(
                f"GPU {g} (score {s:.1f})" for g, s in sorted(drifting)
            )
            return CheckResult(
                self.NAME,
                health=HealthStateType.DEGRADED,
                reason=f"telemetry anomaly: {names}",
                extra_info=extra,
            )
        return CheckResult(
            self.NAME,
            reason=(
                f"telemetry nominal across {len(gpus)} GPUs "
                f"(max score {float(scores.max()):.1f})"
            ),
            extra_info=extra,
        )

    def events(self, since: float):
        if self._event_bucket is None:
            return []
        return self._event_bucket.get(since)
