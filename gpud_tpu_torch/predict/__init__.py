"""Predictive health: online precursor scoring; the port of
``gpud_tpu/predict/``."""

from gpud_tpu_torch.predict.engine import PredictEngine

__all__ = ["PredictEngine"]
