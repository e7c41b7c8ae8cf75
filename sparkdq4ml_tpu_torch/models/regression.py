"""``LinearRegression``, its model and its training summary (subset of
``sparkdq4ml_tpu/models/regression.py``): the MLlib surface the reference
app uses.

``fit`` packs the frame's valid rows into one design, takes its Gramian
through the ``packed_gram`` kernel and runs the solver on the device; the
model keeps host copies of the coefficients. MLlib's defaults hold:
``maxIter=100``, ``regParam=0``, ``elasticNetParam=0``, ``tol=1e-6``,
``fitIntercept=True``, ``standardization=True``, ``solver="auto"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import float_dtype
from ..frame.frame import Frame
from .base import Estimator, Model
from .solvers import FitResult, resolve_solver


def _extract_xy(frame: Frame, features_col: str, label_col: str):
    X = frame._column_values(features_col).to(float_dtype())
    if X.ndim == 1:
        X = X[:, None]
    y = frame._column_values(label_col).to(float_dtype())
    return X, y, frame.mask


class LinearRegression(Estimator):
    """Elastic-net linear regression, MLlib numeric convention."""

    def __init__(self, max_iter: int = 100, reg_param: float = 0.0,
                 elastic_net_param: float = 0.0, tol: float = 1e-6,
                 fit_intercept: bool = True, standardization: bool = True,
                 solver: str = "auto", features_col: str = "features",
                 label_col: str = "label",
                 prediction_col: str = "prediction"):
        self.max_iter = max_iter
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.standardization = standardization
        self.solver = solver
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col

    # The setters the reference app (camelCase) and the README (snake_case)
    # call; every other parameter is a constructor argument.
    def set_max_iter(self, v: int):
        self.max_iter = int(v); return self

    def set_reg_param(self, v: float):
        self.reg_param = float(v); return self

    def set_elastic_net_param(self, v: float):
        self.elastic_net_param = float(v); return self

    setMaxIter = set_max_iter
    setRegParam = set_reg_param
    setElasticNetParam = set_elastic_net_param

    def _params_dict(self) -> dict:
        return {k: getattr(self, k) for k in (
            "max_iter", "reg_param", "elastic_net_param", "tol",
            "fit_intercept", "standardization", "solver", "features_col",
            "label_col", "prediction_col")}

    def fit(self, frame: Frame) -> "LinearRegressionModel":
        """Fit on the frame's valid rows: one Gramian pass, then the solver
        loop on the device of the frame."""
        from ..parallel.distributed import (fused_linear_fit_packed,
                                            pack_design, unpack_fit_result)

        X, y, mask = _extract_xy(frame, self.features_col, self.label_col)
        fit_fn = fused_linear_fit_packed(
            resolve_solver(self.solver, self.reg_param,
                           self.elastic_net_param),
            self.max_iter, self.tol, self.fit_intercept,
            self.standardization)
        flat = fit_fn(pack_design(X, y, mask), self.reg_param,
                      self.elastic_net_param)
        result = unpack_fit_result(flat, X.shape[1])
        model = LinearRegressionModel(result.coefficients,
                                      float(result.intercept),
                                      self._params_dict())
        model._summary_source = (frame, result)
        return model


class LinearRegressionModel(Model):
    def __init__(self, coefficients, intercept: float,
                 params: Optional[dict] = None):
        self.coefficients = np.array(coefficients)
        self.intercept = float(intercept)
        self._params = dict(params or {})
        self._training_summary = None
        self._summary_source = None  # (frame, FitResult) until first access

    def get_reg_param(self): return self._params.get("reg_param", 0.0)
    def get_tol(self): return self._params.get("tol", 1e-6)

    getRegParam = get_reg_param
    getTol = get_tol

    @property
    def features_col(self):
        return self._params.get("features_col", "features")

    @property
    def prediction_col(self):
        return self._params.get("prediction_col", "prediction")

    @property
    def label_col(self):
        return self._params.get("label_col", "label")

    def transform(self, frame: Frame) -> Frame:
        """Append the prediction column (one matrix-vector product on the
        frame's device)."""
        X = frame._column_values(self.features_col).to(float_dtype())
        if X.ndim == 1:
            X = X[:, None]
        coef = torch.as_tensor(self.coefficients, dtype=X.dtype,
                               device=X.device)
        return frame.with_column(self.prediction_col,
                                 X @ coef + self.intercept)

    def predict(self, features) -> float:
        """Single-point inference on the host, like MLlib's driver-local
        predict."""
        v = np.asarray(features, dtype=np.float64).reshape(-1)
        return float(v @ self.coefficients.astype(np.float64)
                     + self.intercept)

    @property
    def summary(self) -> "LinearRegressionTrainingSummary":
        if self._training_summary is None:
            if self._summary_source is None:
                raise RuntimeError("model was not fit with a summary")
            frame, result = self._summary_source
            self._training_summary = LinearRegressionTrainingSummary(
                self, frame, result)
        return self._training_summary

    def evaluate(self, frame: Frame) -> "LinearRegressionSummary":
        return LinearRegressionSummary(self, frame)


class LinearRegressionSummary:
    """Evaluation metrics over a frame's valid rows, in float64 on the
    host."""

    def __init__(self, model: LinearRegressionModel, frame: Frame):
        self._model = model
        pred_frame = model.transform(frame)
        d = pred_frame.to_pydict()
        self._label = d[model.label_col].astype(np.float64)
        self._pred = d[model.prediction_col].astype(np.float64)
        self._device = pred_frame.device

    @property
    def residuals(self) -> Frame:
        return Frame({"residuals": self._label - self._pred},
                     device=self._device)

    @property
    def mean_squared_error(self) -> float:
        return float(np.mean((self._label - self._pred) ** 2))

    meanSquaredError = mean_squared_error

    @property
    def root_mean_squared_error(self) -> float:
        return float(np.sqrt(self.mean_squared_error))

    rootMeanSquaredError = root_mean_squared_error

    @property
    def r2(self) -> float:
        ss_res = float(np.sum((self._label - self._pred) ** 2))
        ss_tot = float(np.sum((self._label - np.mean(self._label)) ** 2))
        if ss_tot == 0.0:  # constant label: undefined, like MLlib's 0/0
            return float("nan")
        return 1.0 - ss_res / ss_tot


class LinearRegressionTrainingSummary(LinearRegressionSummary):
    """Evaluation metrics plus the solver trajectory."""

    def __init__(self, model: LinearRegressionModel, frame: Frame,
                 result: FitResult):
        super().__init__(model, frame)
        self._iterations = int(result.iterations)
        hist = np.asarray(result.objective_history, dtype=np.float64)
        # history[0] is the initial objective; keep entries up to the end.
        self._objective_history = hist[: self._iterations + 1]

    @property
    def total_iterations(self) -> int:
        return self._iterations

    totalIterations = total_iterations

    @property
    def objective_history(self) -> np.ndarray:
        return self._objective_history

    objectiveHistory = objective_history
