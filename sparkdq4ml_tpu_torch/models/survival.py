"""``AFTSurvivalRegression`` of the port (port of
``sparkdq4ml_tpu/models/survival.py``, single device): the Weibull
accelerated-failure-time model ``log t = β₀ + xᵀβ + σ·ε``, ε Gumbel;
censored rows (censor 0) contribute the survival term of the likelihood,
events (censor 1) the density term.

The fit is full-batch Adam (``solvers.adam_scan``) on (β, β₀, log σ) over
the mean negative log-likelihood of the standardized features, its
gradient from ``torch.autograd``: a Python loop of device steps with no
host read inside. A row the mask drops contributes exactly 0 (each term is
gated by ``torch.where``: its ε is 0 and e⁰ would leak). A fit reads the
host once for its checks and once for its result.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import float_dtype
from ..frame.frame import Frame
from .base import Estimator, Model, feature_matrix, no_mesh, persistable
from .classification import _feature_stats
from .solvers import adam_scan, psum_value_and_grad


def aft_fit(X, logt, censor, mask, max_iter: int, lr: float):
    """(β on the raw features, β₀, σ, loss history) on the device of
    ``X``; ``X``, ``logt`` and ``censor`` hold zeros in the rows ``mask``
    drops. With ε = (log t − β₀ − xᵀβ)/σ and δ the event indicator the
    mean of ``e^ε − δ·(ε − log σ)`` is minimized."""
    dt, dev = X.dtype, X.device
    d = X.shape[1]
    n, std = _feature_stats(X, logt, mask)
    zero = torch.zeros((), dtype=dt, device=dev)
    valid = std > 0
    sx = torch.where(valid, std, torch.ones((), dtype=dt, device=dev))
    wm = mask.to(dt)
    Xs = (X / sx) * wm[:, None]
    lt = logt * wm
    dl = censor * wm

    def neg_ll(params):
        beta, b0, logsig = params[:d], params[d], params[d + 1]
        sig = torch.exp(logsig)
        eps = (lt - b0 * wm - Xs @ beta) / sig
        # masked rows: wm = 0 gives eps = 0, and e^0 = 1 would leak
        term = torch.where(mask, torch.exp(eps) - dl * (eps - logsig), zero)
        return torch.sum(term) / n

    # β₀ starts at the mean log t (near the σ = 1, β = 0 stationary point)
    p0 = torch.cat([torch.zeros((d,), dtype=dt, device=dev),
                    (torch.sum(lt) / n).reshape(1), zero.reshape(1)])
    p, history = adam_scan(psum_value_and_grad(neg_ll), p0, max_iter, lr)
    beta = torch.where(valid, p[:d] / sx, torch.zeros_like(sx))
    return beta, p[d], torch.exp(p[d + 1]), history


@persistable
class AFTSurvivalRegression(Estimator):
    """MLlib ``AFTSurvivalRegression`` setter surface: setMaxIter/
    setFeaturesCol/setLabelCol/setCensorCol/setPredictionCol/
    setQuantileProbabilities/setQuantilesCol (+ a ``step_size`` knob for
    the Adam loop)."""

    _persist_attrs = ('max_iter', 'step_size', 'features_col', 'label_col',
                      'censor_col', 'prediction_col',
                      'quantile_probabilities', 'quantiles_col')

    def __init__(self, max_iter: int = 300, step_size: float = 0.1,
                 features_col: str = "features", label_col: str = "label",
                 censor_col: str = "censor",
                 prediction_col: str = "prediction",
                 quantile_probabilities=(0.01, 0.05, 0.1, 0.25, 0.5, 0.75,
                                         0.9, 0.95, 0.99),
                 quantiles_col: Optional[str] = None):
        self.max_iter = int(max_iter)
        self.step_size = float(step_size)
        self.features_col = features_col
        self.label_col = label_col
        self.censor_col = censor_col
        self.prediction_col = prediction_col
        self.quantile_probabilities = self._check_probs(
            quantile_probabilities)
        self.quantiles_col = quantiles_col

    @staticmethod
    def _check_probs(v):
        probs = tuple(float(q) for q in v)
        if not probs:
            raise ValueError("quantile probabilities must be non-empty")
        if any(not 0.0 < q < 1.0 for q in probs):
            raise ValueError("quantile probabilities must be in (0, 1)")
        return probs

    def set_max_iter(self, v):
        self.max_iter = int(v)
        return self

    def set_censor_col(self, v):
        self.censor_col = v
        return self

    def set_features_col(self, v):
        self.features_col = v
        return self

    def set_label_col(self, v):
        self.label_col = v
        return self

    def set_quantile_probabilities(self, v):
        self.quantile_probabilities = self._check_probs(v)
        return self

    def set_quantiles_col(self, v):
        self.quantiles_col = v
        return self

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    setMaxIter = set_max_iter
    setCensorCol = set_censor_col
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col
    setQuantileProbabilities = set_quantile_probabilities
    setQuantilesCol = set_quantiles_col
    setPredictionCol = set_prediction_col

    def fit(self, frame: Frame, mesh=None) -> "AFTSurvivalRegressionModel":
        no_mesh(mesh, "AFTSurvivalRegression")
        X = feature_matrix(frame, self.features_col)
        dt = X.dtype
        t = frame._column_values(self.label_col).to(torch.float64)
        c = frame._column_values(self.censor_col).to(torch.float64)
        mask = frame.mask
        checks = torch.stack([
            mask.sum(),
            ((~torch.isfinite(t) | (t <= 0)) & mask).sum(),
            (((c != 0) & (c != 1)) & mask).sum(),
            (~torch.isfinite(X) & mask[:, None]).sum()]).cpu().tolist()
        if checks[0] == 0:
            raise ValueError("AFTSurvivalRegression: no valid rows")
        if checks[1]:
            raise ValueError("survival times must be finite and > 0")
        if checks[2]:
            raise ValueError("censor column must be 0.0 or 1.0")
        if checks[3]:
            raise ValueError("feature matrix has NaN/inf in valid rows")
        # masked slots: zero features and log t (0 * NaN would poison)
        zero64 = torch.zeros_like(t)
        Xh = torch.where(mask[:, None], X,
                         torch.zeros((), dtype=dt, device=X.device))
        logt = torch.where(mask, torch.log(torch.where(mask, t,
                                                       torch.ones_like(t))),
                           zero64).to(dt)
        ch = torch.where(mask, c, zero64).to(dt)
        beta, b0, scale, hist = aft_fit(Xh, logt, ch, mask, self.max_iter,
                                        self.step_size)
        d = beta.shape[0]
        flat = torch.cat([beta, b0.reshape(1), scale.reshape(1), hist]).to(
            torch.float64).cpu().numpy()
        return AFTSurvivalRegressionModel(
            flat[:d], float(flat[d]), float(flat[d + 1]),
            self._params_dict(), flat[d + 2:].tolist())

    def _params_dict(self):
        return {k: getattr(self, k) for k in self._persist_attrs}


@persistable
class AFTSurvivalRegressionModel(Model):
    """Fitted Weibull AFT: ``predict`` = exp(β₀ + xᵀβ) (MLlib's point
    prediction), ``predict_quantiles`` = exp(μ)·(−log(1−q))^σ."""

    _persist_attrs = ('coefficients', 'intercept', 'scale', '_params',
                      'loss_history')

    def __init__(self, coefficients, intercept, scale, params=None,
                 loss_history=None):
        self.coefficients = np.asarray(coefficients, np.float64)
        self.intercept = float(intercept)
        self.scale = float(scale)
        self._params = dict(params or {})
        self.loss_history = list(loss_history or [])

    def _p(self, k, default=None):
        return self._params.get(k, default)

    def _mu(self, X):
        X = X.to(float_dtype())
        if X.ndim == 1:
            X = X[:, None]
        return X @ torch.as_tensor(self.coefficients, device=X.device).to(
            X.dtype) + self.intercept

    def transform(self, frame: Frame) -> Frame:
        mu = self._mu(frame._column_values(
            self._p("features_col", "features")))
        out = frame.with_column(self._p("prediction_col", "prediction"),
                                torch.exp(mu))
        qcol = self._p("quantiles_col")
        if qcol:
            qs = torch.as_tensor(np.asarray(self._p(
                "quantile_probabilities", (0.5,)), np.float64),
                device=mu.device).to(mu.dtype)
            q = torch.exp(mu)[:, None] * \
                (-torch.log1p(-qs))[None, :] ** self.scale
            out = out.with_column(qcol, q)
        return out

    def _mu_one(self, features) -> float:
        x = torch.as_tensor(np.asarray(features, np.float64).reshape(1, -1))
        return float(self._mu(x)[0])

    def predict(self, features) -> float:
        return float(np.exp(self._mu_one(features)))

    def predict_quantiles(self, features) -> np.ndarray:
        mu = self._mu_one(features)
        qs = np.asarray(self._p("quantile_probabilities", (0.5,)))
        return np.exp(mu) * (-np.log1p(-qs)) ** self.scale

    predictQuantiles = predict_quantiles
