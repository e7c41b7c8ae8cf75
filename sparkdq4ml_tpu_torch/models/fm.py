"""Factorization machines of the port (port of
``sparkdq4ml_tpu/models/fm.py``, single device): ``FMRegressor`` (squared
loss) and ``FMClassifier`` (logistic loss on 0/1 labels), with their models
and persistence in the JAX package's format.

Model: ``ŷ(x) = b + xᵀw + ½ Σ_f [(xᵀV_f)² − (x²)ᵀ(V_f²)]``, three matrix
products over all rows (``fm_forward``). The fit is full-batch Adam
(``solvers.adam_scan``) on the mean loss plus an L2 penalty on every
parameter group, its gradient from ``torch.autograd``, as a Python loop of
device steps with no host read inside; ``V`` starts from JAX's normal draw
(``utils/prng.py``) scaled by ``init_std``. A fit reads the host once for
its checks and once for its result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import float_dtype
from ..frame.frame import Frame
from ..utils import prng
from .base import Estimator, Model, feature_matrix, no_mesh, persistable
from .solvers import adam_scan, psum_value_and_grad


def fm_forward(X, b, w, V):
    """Batched FM score: three matrix products (the O(nkd) identity)."""
    s = X @ V                                     # (n, k)
    s2 = (X * X) @ (V * V)                        # (n, k)
    return b + X @ w + 0.5 * torch.sum(s * s - s2, dim=1)


def fm_fit(X, y, mask, *, factor_size: int, loss: str, reg_param: float,
           max_iter: int, lr: float, init_std: float, seed: int,
           fit_intercept: bool, fit_linear: bool):
    """(intercept, linear, factors, loss history) on the device of ``X``;
    ``X`` and ``y`` hold zeros in the rows ``mask`` drops."""
    dt, dev = X.dtype, X.device
    d = X.shape[1]
    wm = mask.to(dt)
    Xm = X * wm[:, None]
    ym = y * wm
    n = wm.sum()
    zero = torch.zeros((), dtype=dt, device=dev)

    def objective(params):
        b, w, V = params
        pred = fm_forward(Xm, b, w, V)
        if loss == "squared":
            per_row = (pred - ym) ** 2
        else:   # logistic: labels 0/1, stable softplus form
            z = (2.0 * ym - wm) * pred
            per_row = torch.logaddexp(zero, -z)
        data_loss = torch.sum(torch.where(mask, per_row, zero)) / n
        # L2 on every parameter group (MLlib's regParam)
        return data_loss + reg_param * (
            torch.sum(w * w) + torch.sum(V * V) + b * b)

    V0 = init_std * prng.normal(prng.PRNGKey(seed, dev), (d, factor_size),
                                dt)
    params0 = (zero.clone(), torch.zeros((d,), dtype=dt, device=dev), V0)

    def grad_mask(g):
        if not fit_intercept:
            g = (torch.zeros_like(g[0]),) + tuple(g[1:])
        if not fit_linear:
            g = (g[0], torch.zeros_like(g[1]), g[2])
        return g

    (b, w, V), history = adam_scan(psum_value_and_grad(objective), params0,
                                   max_iter, lr, grad_mask=grad_mask)
    return b, w, V, history


class _FMBase(Estimator):
    _persist_attrs = ('factor_size', 'reg_param', 'max_iter', 'step_size',
                      'init_std', 'fit_intercept', 'fit_linear', 'seed',
                      'features_col', 'label_col', 'prediction_col')

    def __init__(self, factor_size: int = 8, reg_param: float = 0.0,
                 max_iter: int = 100, step_size: float = 0.05,
                 init_std: float = 0.01, fit_intercept: bool = True,
                 fit_linear: bool = True, seed: int = 0,
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction"):
        if factor_size < 1:
            raise ValueError("factor_size must be >= 1")
        self.factor_size = int(factor_size)
        self.reg_param = float(reg_param)
        self.max_iter = int(max_iter)
        self.step_size = float(step_size)
        self.init_std = float(init_std)
        self.fit_intercept = bool(fit_intercept)
        self.fit_linear = bool(fit_linear)
        self.seed = int(seed)
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col

    def set_factor_size(self, v):
        if v < 1:
            raise ValueError("factor_size must be >= 1")
        self.factor_size = int(v)
        return self

    def set_reg_param(self, v):
        self.reg_param = float(v)
        return self

    def set_max_iter(self, v):
        self.max_iter = int(v)
        return self

    def set_step_size(self, v):
        self.step_size = float(v)
        return self

    def set_init_std(self, v):
        self.init_std = float(v)
        return self

    def set_fit_intercept(self, v):
        self.fit_intercept = bool(v)
        return self

    def set_fit_linear(self, v):
        self.fit_linear = bool(v)
        return self

    def set_seed(self, v):
        self.seed = int(v)
        return self

    def set_features_col(self, v):
        self.features_col = v
        return self

    def set_label_col(self, v):
        self.label_col = v
        return self

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    setFactorSize = set_factor_size
    setRegParam = set_reg_param
    setMaxIter = set_max_iter
    setStepSize = set_step_size
    setInitStd = set_init_std
    setFitIntercept = set_fit_intercept
    setFitLinear = set_fit_linear
    setSeed = set_seed
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col
    setPredictionCol = set_prediction_col

    _loss = "squared"
    _binary = False

    def _fit_arrays(self, frame: Frame, mesh):
        no_mesh(mesh, type(self).__name__)
        X = feature_matrix(frame, self.features_col)
        y = frame._column_values(self.label_col).to(torch.float64)
        mask = frame.mask
        z = torch.zeros((), dtype=X.dtype, device=X.device)
        checks = torch.stack([
            mask.sum(),
            (~torch.isfinite(X) & mask[:, None]).sum(),
            (~torch.isfinite(y) & mask).sum(),
            (((y != 0) & (y != 1)) & mask).sum()]).cpu().tolist()
        if checks[0] == 0:
            raise ValueError(f"{type(self).__name__}: no valid rows")
        if checks[1]:
            raise ValueError("feature matrix has NaN/inf in valid rows")
        if checks[2]:
            raise ValueError("label column has NaN/inf in valid rows")
        if self._binary and checks[3]:
            raise ValueError("FMClassifier requires binary 0/1 labels")
        Xh = torch.where(mask[:, None], X, z)
        yh = torch.where(mask, y, torch.zeros_like(y)).to(X.dtype)
        b, w, V, hist = fm_fit(
            Xh, yh, mask, factor_size=self.factor_size, loss=self._loss,
            reg_param=self.reg_param, max_iter=self.max_iter,
            lr=self.step_size, init_std=self.init_std, seed=self.seed,
            fit_intercept=self.fit_intercept, fit_linear=self.fit_linear)
        d = w.shape[0]
        flat = torch.cat([b.reshape(1), w, V.reshape(-1), hist]).to(
            torch.float64).cpu().numpy()
        return (float(flat[0]), flat[1:1 + d],
                flat[1 + d:1 + d + V.numel()].reshape(V.shape),
                flat[1 + d + V.numel():].tolist())

    def _params_dict(self):
        return {k: getattr(self, k) for k in self._persist_attrs}


@persistable
class FMRegressor(_FMBase):
    """MLlib ``FMRegressor``: squared loss."""

    def fit(self, frame: Frame, mesh=None) -> "FMRegressionModel":
        b, w, V, hist = self._fit_arrays(frame, mesh)
        return FMRegressionModel(b, w, V, self._params_dict(), hist)


@persistable
class FMClassifier(_FMBase):
    """MLlib ``FMClassifier``: binary 0/1 labels, logistic loss."""

    _loss = "logistic"
    _binary = True
    _persist_attrs = _FMBase._persist_attrs + ('probability_col',
                                               'raw_prediction_col')

    def __init__(self, probability_col: str = "probability",
                 raw_prediction_col: str = "rawPrediction", **kw):
        super().__init__(**kw)
        self.probability_col = probability_col
        self.raw_prediction_col = raw_prediction_col

    def fit(self, frame: Frame, mesh=None) -> "FMClassificationModel":
        b, w, V, hist = self._fit_arrays(frame, mesh)
        return FMClassificationModel(b, w, V, self._params_dict(), hist)


class _FMModelBase(Model):
    _persist_attrs = ('intercept', 'linear', 'factors', '_params',
                      'loss_history')

    def __init__(self, intercept, linear, factors, params=None,
                 loss_history=None):
        self.intercept = float(intercept)
        self.linear = np.asarray(linear, np.float64)
        self.factors = np.asarray(factors, np.float64)
        self._params = dict(params or {})
        self.loss_history = list(loss_history or [])

    def _p(self, k, default=None):
        return self._params.get(k, default)

    @property
    def factor_size(self):
        return int(self.factors.shape[1])

    factorSize = factor_size

    def _score(self, X):
        X = X.to(float_dtype())
        if X.ndim == 1:
            X = X[:, None]
        dt, dev = X.dtype, X.device
        return fm_forward(
            X, torch.as_tensor(self.intercept, dtype=dt, device=dev),
            torch.as_tensor(self.linear, device=dev).to(dt),
            torch.as_tensor(self.factors, device=dev).to(dt))

    def _score_one(self, features) -> float:
        x = torch.as_tensor(np.asarray(features, np.float64).reshape(1, -1))
        return float(self._score(x)[0])


@persistable
class FMRegressionModel(_FMModelBase):
    def transform(self, frame: Frame) -> Frame:
        pred = self._score(frame._column_values(
            self._p("features_col", "features")))
        return frame.with_column(self._p("prediction_col", "prediction"),
                                 pred)

    def predict(self, features) -> float:
        return self._score_one(features)


@persistable
class FMClassificationModel(_FMModelBase):
    def transform(self, frame: Frame) -> Frame:
        p = self._params
        F = self._score(frame._column_values(
            p.get("features_col", "features")))
        prob1 = torch.sigmoid(F)
        out = frame.with_column(p.get("raw_prediction_col", "rawPrediction"),
                                torch.stack([-F, F], dim=1))
        out = out.with_column(p.get("probability_col", "probability"),
                              torch.stack([1.0 - prob1, prob1], dim=1))
        return out.with_column(p.get("prediction_col", "prediction"),
                               (F > 0).to(float_dtype()))

    def predict(self, features) -> float:
        return float(self._score_one(features) > 0)
