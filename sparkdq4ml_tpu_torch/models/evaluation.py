"""Evaluators: the MLlib ``ml.evaluation`` surface that the model-selection
path needs (port of the regression half of
``sparkdq4ml_tpu/models/evaluation.py``). Metrics are float64 on the host,
over the frame's valid rows."""

from __future__ import annotations

import numpy as np

from ..frame.frame import Frame


class Evaluator:
    def evaluate(self, frame: Frame) -> float:  # pragma: no cover
        raise NotImplementedError

    def is_larger_better(self) -> bool:
        return True

    isLargerBetter = is_larger_better


class RegressionEvaluator(Evaluator):
    """Metrics: rmse (default), mse, mae, r2, var."""

    def __init__(self, metric_name: str = "rmse", label_col: str = "label",
                 prediction_col: str = "prediction"):
        if metric_name not in ("rmse", "mse", "mae", "r2", "var"):
            raise ValueError(f"unknown metric {metric_name!r}")
        self.metric_name = metric_name
        self.label_col = label_col
        self.prediction_col = prediction_col

    def set_metric_name(self, v: str) -> "RegressionEvaluator":
        self.metric_name = v
        return self

    setMetricName = set_metric_name

    def is_larger_better(self) -> bool:
        return self.metric_name in ("r2", "var")

    isLargerBetter = is_larger_better

    def evaluate(self, frame: Frame) -> float:
        d = frame.to_pydict()
        return self.compute(d[self.label_col].astype(np.float64),
                            d[self.prediction_col].astype(np.float64))

    def compute(self, y: np.ndarray, p: np.ndarray) -> float:
        if self.metric_name == "rmse":
            return float(np.sqrt(np.mean((y - p) ** 2)))
        if self.metric_name == "mse":
            return float(np.mean((y - p) ** 2))
        if self.metric_name == "mae":
            return float(np.mean(np.abs(y - p)))
        if self.metric_name == "var":
            # Spark RegressionMetrics.explainedVariance: mean((p - ȳ)²)
            return float(np.mean((p - y.mean()) ** 2))
        ss_res = float(np.sum((y - p) ** 2))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        return float("nan") if ss_tot == 0 else 1.0 - ss_res / ss_tot
