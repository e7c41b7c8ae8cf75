"""``LinearRegression``, its model and its summaries, and
``IsotonicRegression`` (port of ``sparkdq4ml_tpu/models/regression.py``).

A squared-error ``fit`` packs the frame's valid rows into one design, takes
its Gramian through the ``packed_gram`` kernel and runs the solver (FISTA,
the normal equations or OWL-QN) on the device. ``loss="huber"`` runs the
robust fit of ``solvers.huber_fit``, whose warm start is one
``masked_gram``. A ``weight_col`` scales each packed row by ``sqrt(w)``.
The model keeps host copies of the coefficients and saves in the JAX
package's format (``metadata.json`` + ``coefficients.npy``). MLlib's
defaults hold: ``maxIter=100``, ``regParam=0``, ``elasticNetParam=0``,
``tol=1e-6``, ``fitIntercept=True``, ``standardization=True``,
``solver="auto"``.

``IsotonicRegression`` sorts the valid points by feature (stable) on the
device in float64 under either policy, finds the distinct feature values
and sums (w, w·y) over each with one ``sorted_segment_sum`` call of two
columns; it reads the aggregated points to the host once and pools the
adjacent violators there (a sequential stack over at most that many
points, a host step in the JAX package too). Its model interpolates on the
device (``torch.searchsorted``), constant beyond the boundaries.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import float_dtype
from ..frame.frame import Frame
from .base import Estimator, Model, persistable, read_json, write_json
from .solvers import FitResult, resolve_solver


def _extract_xy(frame: Frame, features_col: str, label_col: str):
    X = frame._column_values(features_col).to(float_dtype())
    if X.ndim == 1:
        X = X[:, None]
    y = frame._column_values(label_col).to(float_dtype())
    return X, y, frame.mask


def _model_from_flat(flat, d: int, params: dict, frame: Frame,
                     scale: float = 1.0) -> "LinearRegressionModel":
    """A model (with its summary source) from a packed device result, read
    to the host once."""
    from ..parallel.distributed import unpack_fit_result

    result = unpack_fit_result(flat, d)
    model = LinearRegressionModel(result.coefficients,
                                  float(result.intercept), params,
                                  scale=scale)
    model._summary_source = (frame, result)
    return model


@persistable
class LinearRegression(Estimator):
    """Elastic-net (or Huber) linear regression, MLlib numeric convention."""

    _persist_attrs = ("max_iter", "reg_param", "elastic_net_param", "tol",
                      "fit_intercept", "standardization", "solver",
                      "features_col", "label_col", "prediction_col",
                      "weight_col", "aggregation_depth", "loss", "epsilon")

    # Class-level defaults: stages saved before these params existed load
    # through setattr and still resolve them.
    weight_col = None
    loss = "squaredError"
    epsilon = 1.35

    def __init__(self, max_iter: int = 100, reg_param: float = 0.0,
                 elastic_net_param: float = 0.0, tol: float = 1e-6,
                 fit_intercept: bool = True, standardization: bool = True,
                 solver: str = "auto", features_col: str = "features",
                 label_col: str = "label",
                 prediction_col: str = "prediction",
                 weight_col: Optional[str] = None,
                 aggregation_depth: int = 2, loss: str = "squaredError",
                 epsilon: float = 1.35):
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
        self.weight_col = weight_col
        # MLlib's treeAggregate depth: one device sums every row, so it has
        # no effect. Accepted for API parity.
        self.aggregation_depth = aggregation_depth
        if loss not in ("squaredError", "huber"):
            raise ValueError(f"unknown loss {loss!r} "
                             "(squaredError or huber)")
        self.loss = loss
        self.epsilon = float(epsilon)

    # -- MLlib-style fluent setters and getters -----------------------------
    def set_max_iter(self, v: int):
        self.max_iter = int(v); return self

    def set_reg_param(self, v: float):
        self.reg_param = float(v); return self

    def set_elastic_net_param(self, v: float):
        self.elastic_net_param = float(v); return self

    def set_tol(self, v: float):
        self.tol = float(v); return self

    def set_fit_intercept(self, v: bool):
        self.fit_intercept = bool(v); return self

    def set_standardization(self, v: bool):
        self.standardization = bool(v); return self

    def set_solver(self, v: str):
        self.solver = v; return self

    def set_features_col(self, v: str):
        self.features_col = v; return self

    def set_label_col(self, v: str):
        self.label_col = v; return self

    def set_prediction_col(self, v: str):
        self.prediction_col = v; return self

    def set_weight_col(self, v):
        self.weight_col = v; return self

    def set_aggregation_depth(self, v: int):
        self.aggregation_depth = int(v); return self

    setMaxIter = set_max_iter
    setRegParam = set_reg_param
    setElasticNetParam = set_elastic_net_param
    setTol = set_tol
    setFitIntercept = set_fit_intercept
    setStandardization = set_standardization
    setSolver = set_solver
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col
    setPredictionCol = set_prediction_col
    setWeightCol = set_weight_col
    setAggregationDepth = set_aggregation_depth

    def get_max_iter(self): return self.max_iter
    def get_reg_param(self): return self.reg_param
    def get_elastic_net_param(self): return self.elastic_net_param
    def get_tol(self): return self.tol
    def get_fit_intercept(self): return self.fit_intercept
    def get_standardization(self): return self.standardization
    def get_solver(self): return self.solver

    getMaxIter = get_max_iter
    getRegParam = get_reg_param
    getElasticNetParam = get_elastic_net_param
    getTol = get_tol
    getFitIntercept = get_fit_intercept
    getStandardization = get_standardization
    getSolver = get_solver

    def _params_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._persist_attrs}

    # -- fit ----------------------------------------------------------------
    def fit(self, frame: Frame) -> "LinearRegressionModel":
        """Fit on the frame's valid rows, on the device of the frame."""
        from ..parallel.distributed import fused_linear_fit_packed, pack_design

        X, y, mask = _extract_xy(frame, self.features_col, self.label_col)
        if self.weight_col is not None:
            # Instance weights (MLlib weightCol): scaling packed rows by
            # sqrt(w) makes the Gramian Σ w·zzᵀ, so every moment the solver
            # unpacks takes its weighted form. Only valid rows are checked
            # (one host read), and masked rows' weights never reach sqrt.
            w = frame._column_values(self.weight_col).to(float_dtype())
            if not bool(((w >= 0) | ~mask).all()):
                raise ValueError("weights must be nonnegative")
            mask = mask.to(X.dtype) * torch.sqrt(
                torch.where(mask, w, X.new_zeros(())))
        if self.loss == "huber":
            return self._fit_huber(frame, X, y, mask)
        fit_fn = fused_linear_fit_packed(
            resolve_solver(self.solver, self.reg_param,
                           self.elastic_net_param),
            self.max_iter, self.tol, self.fit_intercept,
            self.standardization)
        flat = fit_fn(pack_design(X, y, mask), self.reg_param,
                      self.elastic_net_param)
        return _model_from_flat(flat, X.shape[1], self._params_dict(), frame)

    def _fit_huber(self, frame, X, y, mask) -> "LinearRegressionModel":
        """MLlib ``loss="huber"`` (see ``solvers.huber_fit``): L2 only, as
        in MLlib; the scale estimate is ``model.scale``."""
        from .solvers import huber_fit

        if self.elastic_net_param not in (0, 0.0):
            raise ValueError("huber loss supports only L2 regularization "
                             "(elasticNetParam must be 0), as in MLlib")
        b, c, sigma, iters, obj = huber_fit(
            X, y, mask, epsilon=self.epsilon, reg_param=self.reg_param,
            fit_intercept=self.fit_intercept, max_iter=self.max_iter,
            tol=self.tol, standardization=self.standardization)
        dt = b.dtype
        host = torch.cat([b, torch.stack([c, sigma, iters.to(dt),
                                          obj.to(dt)])]).cpu().numpy()
        d = X.shape[1]
        iterations = int(host[d + 2])
        result = FitResult(coefficients=host[:d], intercept=host[d],
                           iterations=np.int32(iterations),
                           objective_history=host[d + 3:d + 4],
                           converged=iterations < self.max_iter)
        model = LinearRegressionModel(host[:d], float(host[d]),
                                      self._params_dict(),
                                      scale=float(host[d + 1]))
        model._summary_source = (frame, result)
        return model

    def fit_from_gram(self, A: torch.Tensor,
                      frame: Frame) -> "LinearRegressionModel":
        """Fit from a precomputed augmented Gramian: no data pass."""
        from ..parallel.distributed import pack_fit_result
        from .solvers import solve

        result = solve(A, self.reg_param, self.elastic_net_param,
                       max_iter=self.max_iter, tol=self.tol,
                       fit_intercept=self.fit_intercept,
                       standardization=self.standardization,
                       solver=self.solver)
        return _model_from_flat(pack_fit_result(result), A.shape[-1] - 2,
                                self._params_dict(), frame)


@persistable
class LinearRegressionModel(Model):
    def __init__(self, coefficients, intercept: float,
                 params: Optional[dict] = None, scale: float = 1.0):
        self.coefficients = np.array(coefficients)
        self.intercept = float(intercept)
        # MLlib: 1.0 for squared-error fits; the fitted sigma for huber
        self.scale = float(scale)
        self._params = dict(params or {})
        self._training_summary = None
        self._summary_source = None  # (frame, FitResult) until first access

    def get_reg_param(self): return self._params.get("reg_param", 0.0)
    def get_tol(self): return self._params.get("tol", 1e-6)
    def get_max_iter(self): return self._params.get("max_iter", 100)

    def get_elastic_net_param(self):
        return self._params.get("elastic_net_param", 0.0)

    getRegParam = get_reg_param
    getTol = get_tol
    getMaxIter = get_max_iter
    getElasticNetParam = get_elastic_net_param

    @property
    def features_col(self):
        return self._params.get("features_col", "features")

    @property
    def prediction_col(self):
        return self._params.get("prediction_col", "prediction")

    @property
    def label_col(self):
        return self._params.get("label_col", "label")

    @property
    def num_features(self) -> int:
        return int(self.coefficients.shape[0])

    numFeatures = num_features

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
                raise RuntimeError("model was not fit with a summary "
                                   "(loaded model?)")
            frame, result = self._summary_source
            self._training_summary = LinearRegressionTrainingSummary(
                self, frame, result)
        return self._training_summary

    @property
    def has_summary(self) -> bool:
        return (self._training_summary is not None
                or self._summary_source is not None)

    hasSummary = has_summary

    def evaluate(self, frame: Frame) -> "LinearRegressionSummary":
        return LinearRegressionSummary(self, frame)

    # -- persistence (the JAX package's format) -----------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        write_json(os.path.join(path, "metadata.json"), {
            "class": "LinearRegressionModel",
            "intercept": self.intercept,
            "scale": self.scale,
            "params": self._params,
        })
        np.save(os.path.join(path, "coefficients.npy"), self.coefficients)

    @classmethod
    def load(cls, path: str) -> "LinearRegressionModel":
        meta = read_json(os.path.join(path, "metadata.json"))
        if meta.get("class") != "LinearRegressionModel":
            raise ValueError(f"not a LinearRegressionModel checkpoint: {path}")
        coef = np.load(os.path.join(path, "coefficients.npy"))
        return cls(coef, meta["intercept"], meta.get("params"),
                   scale=meta.get("scale", 1.0))

    # Pipeline persistence (base.save_stage/load_stage dispatch here).
    def _save_to_dir(self, path: str) -> None:
        self.save(path)

    @classmethod
    def _load_from_dir(cls, path: str, meta: dict):
        return cls.load(path)


class LinearRegressionSummary:
    """Evaluation metrics over a frame's valid rows, in float64 on the
    host."""

    def __init__(self, model: LinearRegressionModel, frame: Frame):
        self._model = model
        self._frame = frame
        pred_frame = model.transform(frame)
        d = pred_frame.to_pydict()
        self._label = d[model.label_col].astype(np.float64)
        self._pred = d[model.prediction_col].astype(np.float64)
        self._predictions_frame = pred_frame
        self._inference_cache = None

    @property
    def predictions(self) -> Frame:
        return self._predictions_frame

    @property
    def num_instances(self) -> int:
        return int(self._label.shape[0])

    numInstances = num_instances

    @property
    def residuals(self) -> Frame:
        return Frame({"residuals": self._label - self._pred},
                     device=self._frame.device)

    @property
    def mean_squared_error(self) -> float:
        return float(np.mean((self._label - self._pred) ** 2))

    meanSquaredError = mean_squared_error

    @property
    def root_mean_squared_error(self) -> float:
        return float(np.sqrt(self.mean_squared_error))

    rootMeanSquaredError = root_mean_squared_error

    @property
    def mean_absolute_error(self) -> float:
        return float(np.mean(np.abs(self._label - self._pred)))

    meanAbsoluteError = mean_absolute_error

    @property
    def explained_variance(self) -> float:
        return float(np.var(self._pred))

    explainedVariance = explained_variance

    @property
    def r2(self) -> float:
        ss_res = float(np.sum((self._label - self._pred) ** 2))
        ss_tot = float(np.sum((self._label - np.mean(self._label)) ** 2))
        if ss_tot == 0.0:  # constant label: undefined, like MLlib's 0/0
            return float("nan")
        return 1.0 - ss_res / ss_tot

    @property
    def r2adj(self) -> float:
        n = self.num_instances
        d = self._model.num_features
        return 1.0 - (1.0 - self.r2) * (n - 1) / (n - d - 1)

    @property
    def degrees_of_freedom(self) -> int:
        extra = 1 if self._model._params.get("fit_intercept", True) else 0
        return self.num_instances - self._model.num_features - extra

    degreesOfFreedom = degrees_of_freedom

    # -- inference statistics (MLlib: the solver="normal" surface) ---------
    def _inference(self):
        """(std_errors, t_values, p_values), intercept last (MLlib's
        layout): the classical OLS covariance ``σ̂²(XᵀX)⁻¹``, exact only
        for unpenalized, unweighted training fits, so anything else raises
        as MLlib does."""
        if self._inference_cache is not None:
            return self._inference_cache
        params = self._model._params or {}
        if float(params.get("reg_param", 0.0)) > 0.0:
            raise ValueError(
                "standard errors / t-values / p-values are available only "
                "for unpenalized fits (MLlib: solver='normal' without "
                "regularization); this model has regParam > 0")
        if params.get("weight_col") is not None:
            raise ValueError("standard errors for weighted fits are not "
                             "computed here")
        if not isinstance(self, LinearRegressionTrainingSummary):
            raise ValueError(
                "inference statistics exist only on the training summary "
                "(MLlib: evaluate() summaries throw)")
        from scipy import stats

        Xd, _, mask = _extract_xy(self._frame, self._model.features_col,
                                  self._model.label_col)
        X = Xd.cpu().numpy().astype(np.float64)[mask.cpu().numpy()]
        fit_intercept = bool(params.get("fit_intercept", True))
        A = (np.concatenate([X, np.ones((len(X), 1))], axis=1)
             if fit_intercept else X)
        dof = self.degrees_of_freedom
        if dof <= 0:
            raise ValueError("non-positive degrees of freedom")
        G = A.T @ A
        if np.linalg.matrix_rank(G) < A.shape[1]:
            raise ValueError(
                "design matrix is rank-deficient (collinear features); "
                "standard errors are not identifiable")
        resid = self._label - self._pred
        sigma2 = float(resid @ resid) / dof
        se = np.sqrt(np.diag(sigma2 * np.linalg.pinv(G)))
        coef = np.asarray(self._model.coefficients, np.float64)
        beta = (np.concatenate([coef, [self._model.intercept]])
                if fit_intercept else coef)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = beta / se
        p = 2.0 * stats.t.sf(np.abs(t), dof)
        self._inference_cache = (se, t, p)
        return self._inference_cache

    @property
    def coefficient_standard_errors(self) -> np.ndarray:
        return self._inference()[0]

    coefficientStandardErrors = coefficient_standard_errors

    @property
    def t_values(self) -> np.ndarray:
        return self._inference()[1]

    tValues = t_values

    @property
    def p_values(self) -> np.ndarray:
        return self._inference()[2]

    pValues = p_values


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


# ---------------------------------------------------------------------------
# IsotonicRegression (MLlib org.apache.spark.ml.regression.IsotonicRegression)
# ---------------------------------------------------------------------------

def _pava(bx, by, bw):
    """Weighted pool-adjacent-violators over points sorted by ``bx``, the
    classic stack: (pool lows, pool highs, pooled values)."""
    vals: list = []
    wts: list = []
    xs_lo: list = []
    xs_hi: list = []
    for xi, yi, wi in zip(bx, by, bw):
        vals.append(yi)
        wts.append(wi)
        xs_lo.append(xi)
        xs_hi.append(xi)
        while len(vals) > 1 and vals[-2] > vals[-1]:
            y2, w2 = vals.pop(), wts.pop()
            hi2 = xs_hi.pop()          # merged pool spans (lo1, hi2)
            xs_lo.pop()
            y1, w1 = vals.pop(), wts.pop()
            xs_hi.pop()
            lo1 = xs_lo.pop()
            vals.append((y1 * w1 + y2 * w2) / (w1 + w2))
            wts.append(w1 + w2)
            xs_lo.append(lo1)
            xs_hi.append(hi2)
    return xs_lo, xs_hi, vals


def isotonic_points(x, y, w):
    """The distinct values of ``x`` (float64 tensors of the valid points)
    ascending with their weight sums and weighted label sums, on the host:
    a stable sort and one ``sorted_segment_sum`` of (w, w·y) on the
    device, then one read."""
    from ..ops.segments import _seg_sum

    xs, order = torch.sort(x, stable=True)
    ys, ws = y.index_select(0, order), w.index_select(0, order)
    first = torch.ones_like(xs, dtype=torch.bool)
    first[1:] = xs[1:] != xs[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    uniq = xs[first]
    sums = _seg_sum(torch.stack([ws, ws * ys], dim=1), seg, uniq.shape[0],
                    contiguous=True)
    host = torch.cat([uniq[:, None], sums], dim=1).cpu().numpy()
    return host[:, 0], host[:, 1], host[:, 2]


@persistable
class IsotonicRegression(Estimator):
    """MLlib ``IsotonicRegression``: weighted isotonic (or antitonic) fit of
    label vs ONE feature, via pool-adjacent-violators. Points with equal
    feature values aggregate to their weighted-mean label first;
    prediction linearly interpolates between boundaries and is constant
    beyond them; ``isotonic=False`` fits the antitonic (decreasing)
    function."""

    _persist_attrs = ("isotonic", "features_col", "label_col",
                      "prediction_col", "weight_col", "feature_index")

    def __init__(self, isotonic: bool = True, features_col: str = "features",
                 label_col: str = "label", prediction_col: str = "prediction",
                 weight_col: Optional[str] = None, feature_index: int = 0):
        self.isotonic = bool(isotonic)
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.weight_col = weight_col
        self.feature_index = int(feature_index)

    def set_isotonic(self, v):
        self.isotonic = bool(v)
        return self

    def set_feature_index(self, v):
        self.feature_index = int(v)
        return self

    def set_weight_col(self, v):
        self.weight_col = v
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

    setIsotonic = set_isotonic
    setFeatureIndex = set_feature_index
    setWeightCol = set_weight_col
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col
    setPredictionCol = set_prediction_col

    def fit(self, frame: Frame) -> "IsotonicRegressionModel":
        X = frame._column_values(self.features_col).to(torch.float64)
        if X.ndim > 1:
            X = X[:, self.feature_index]
        y = frame._column_values(self.label_col).to(torch.float64)
        w = (torch.ones_like(y) if self.weight_col is None else
             frame._column_values(self.weight_col).to(torch.float64))
        mask = frame.mask
        checks = torch.stack([
            mask.sum(),
            ((~torch.isfinite(X) | ~torch.isfinite(y)) & mask).sum(),
            ((w < 0) & mask).sum()]).cpu().tolist()
        if checks[0] == 0:
            raise ValueError("IsotonicRegression: no valid rows")
        if checks[1]:
            raise ValueError("IsotonicRegression: non-finite feature/label "
                             "in valid rows")
        if checks[2]:
            raise ValueError("weights must be nonnegative")
        sign = 1.0 if self.isotonic else -1.0
        ux, wsum, ysum = isotonic_points(X[mask], sign * y[mask], w[mask])
        keep = wsum > 0
        bx, bw = ux[keep], wsum[keep]
        by = ysum[keep] / bw
        xs_lo, xs_hi, vals = _pava(bx, by, bw)
        # MLlib keeps each pool's boundary pair (lo, hi) with the pooled
        # value at both ends, then interpolates linearly between pools
        boundaries: list = []
        predictions: list = []
        for lo, hi, v in zip(xs_lo, xs_hi, vals):
            boundaries.append(lo)
            predictions.append(v)
            if hi != lo:
                boundaries.append(hi)
                predictions.append(v)
        return IsotonicRegressionModel(
            np.asarray(boundaries, np.float64),
            sign * np.asarray(predictions, np.float64),
            {"features_col": self.features_col,
             "prediction_col": self.prediction_col,
             "feature_index": self.feature_index,
             "isotonic": self.isotonic})


def interpolate(x, bx, by):
    """``np.interp(x, bx, by)`` on the device of ``x`` (float64; ``bx``
    strictly increasing): linear between the boundaries, constant beyond
    them, a boundary's own value at a boundary."""
    m = bx.shape[0]
    if m == 1:
        return torch.where(torch.isnan(x), x, by[0].expand_as(x))
    j = torch.clamp(torch.searchsorted(bx, x, right=True) - 1, 0, m - 2)
    x0, x1 = bx.index_select(0, j), bx.index_select(0, j + 1)
    y0, y1 = by.index_select(0, j), by.index_select(0, j + 1)
    slope = (y1 - y0) / (x1 - x0)
    inner = torch.where(x == x0, y0, slope * (x - x0) + y0)
    return torch.where(x < bx[0], by[0], torch.where(x >= bx[-1], by[-1],
                                                     inner))


@persistable
class IsotonicRegressionModel(Model):
    """Fitted piecewise-linear function: ``boundaries`` (ascending) and
    ``predictions``; transform interpolates on the device with constant
    extrapolation (``np.interp``'s contract, MLlib's predictionForX)."""

    _persist_attrs = ("boundaries", "predictions", "_params")

    def __init__(self, boundaries, predictions, params=None):
        self.boundaries = np.asarray(boundaries, np.float64)
        self.predictions = np.asarray(predictions, np.float64)
        self._params = dict(params or {})

    def _p(self, k, default=None):
        return self._params.get(k, default)

    def _predict(self, x: torch.Tensor) -> torch.Tensor:
        dev = x.device
        return interpolate(x.to(torch.float64),
                           torch.as_tensor(self.boundaries, device=dev),
                           torch.as_tensor(self.predictions, device=dev))

    def transform(self, frame: Frame) -> Frame:
        X = frame._column_values(self._p("features_col", "features"))
        if X.ndim > 1:
            X = X[:, self._p("feature_index", 0)]
        return frame.with_column(self._p("prediction_col", "prediction"),
                                 self._predict(X).to(float_dtype()))

    def predict(self, feature: float) -> float:
        return float(self._predict(torch.tensor([float(feature)],
                                                dtype=torch.float64))[0])
