"""NumPy twin of :func:`gpud_tpu_torch.models.anomaly.robust_scores`.

The port's own copy of the reference package's numpy scorer (the port
imports nothing of that package). It is the plain, sequential statement of
the scorer: a float32 EWMA stepped one sample at a time, median/MAD
normalization, and the mean of the top-k residual steps. The torch scorer
computes the same function with a log-depth scan and sorts; tests and
``chip_smoke.py`` hold the two to rtol = atol = 1e-4.
"""

from __future__ import annotations

import numpy as np


def robust_scores_np(windows, alpha: float = 0.3) -> np.ndarray:
    """Per-chip anomaly score from telemetry windows.

    Args:
      windows: [C, T, F] float — per-chip, per-step feature matrix.
    Returns:
      [C] float32 — 0 ≈ nominal; >3 ≈ a feature is running away from its
      own recent behavior.
    """
    x = np.asarray(windows, dtype=np.float32)
    if x.ndim != 3:
        raise ValueError(f"windows must be [C, T, F], got shape {x.shape}")
    _, T, _ = x.shape
    if T < 2:
        return np.zeros((x.shape[0],), dtype=np.float32)

    # EWMA one-step forecast along time, initialized at the first sample
    ewma = np.empty_like(x)
    ewma[:, 0, :] = x[:, 0, :]
    for t in range(1, T):
        ewma[:, t, :] = (1.0 - alpha) * ewma[:, t - 1, :] + alpha * x[:, t, :]
    resid = x[:, 1:, :] - ewma[:, :-1, :]

    # robust scale per chip/feature: median absolute deviation, floored
    # relative to the signal magnitude so near-constant features (fixed
    # clock, HBM total) don't turn LSB jitter into huge z-scores
    med = np.median(resid, axis=1, keepdims=True)
    mad = np.median(np.abs(resid - med), axis=1, keepdims=True)
    xmag = np.median(np.abs(x), axis=1, keepdims=True)
    scale = 1.4826 * mad + 1e-3 * (1.0 + xmag)
    z = np.abs(resid - med) / scale

    # score: mean of the top-k residual steps per chip (persistent
    # deviation, not single spikes)
    k = max(1, resid.shape[1] // 8)
    worst = z.max(axis=2)  # [C, T-1]
    top = np.sort(worst, axis=1)[:, -k:]
    return top.mean(axis=1).astype(np.float32)
