"""Model selection: ParamGridBuilder, CrossValidator, TrainValidationSplit
(port of ``sparkdq4ml_tpu/models/tuning.py``, single device).

For a squared-error ``LinearRegression`` graded by rmse, mse or r2, every
(fold × param) fit is a small solve on sufficient statistics, so the whole
cross-validation runs as

1. one ``masked_gram`` launch per fold, ``A_f = masked_gram(X, y,
   valid & (fold == f))``, and ``A_all`` as the sum of the fold Gramians
   (for 0/1 weights the same function as the reference's ``(Z·w_f)ᵀZ``);
2. train Gramians by subtraction, ``A_train = A_all − A_f`` (the Gramian is
   additive, so k-fold CV needs no second data pass; the kernel is
   bit-stable, and ``A_all`` is a sum with ``A_f`` among its terms, so the
   count and the diagonal stay non-negative);
3. one batched FISTA loop over the flattened (param × fold) cells (the
   reference vmaps them);
4. held-out metrics from the fold Gramians, the winner, and the refit of
   the winning params on ``A_all`` with each solver the grid resolves to,
   all on the device and read to the host once.

Other estimators, evaluators or grids take the generic fit-per-cell path.
Fold and split assignments are numpy draws with the reference's seeds, so
they equal the JAX package's.
"""

from __future__ import annotations

import copy
import functools
import itertools
import re
from typing import Optional, Sequence

import numpy as np
import torch

from ..frame.frame import Frame
from .base import Estimator, Model
from .evaluation import Evaluator, RegressionEvaluator
from .regression import LinearRegression, LinearRegressionModel, _extract_xy
from .solvers import (_dot, _matvec, fista_solve, resolve_solver,
                      run_solver)

_FAST_METRICS = ("rmse", "mse", "r2")


def _snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


class ParamGridBuilder:
    """``addGrid(param, values)`` builder; params are attribute names
    (snake_case or MLlib camelCase)."""

    def __init__(self):
        self._grids: dict[str, Sequence] = {}

    def add_grid(self, param: str, values: Sequence) -> "ParamGridBuilder":
        self._grids[_snake(param)] = list(values)
        return self

    addGrid = add_grid

    def base_on(self, params: dict) -> "ParamGridBuilder":
        for k, v in params.items():
            self._grids[_snake(k)] = [v]
        return self

    baseOn = base_on

    def build(self) -> list[dict]:
        names = list(self._grids)
        return [dict(zip(names, combo)) for combo in itertools.product(
            *(self._grids[n] for n in names))] or [{}]


def _apply_params(estimator: Estimator, params: dict) -> Estimator:
    est = copy.copy(estimator)
    for k, v in params.items():
        if not hasattr(est, k):
            raise AttributeError(f"{type(est).__name__} has no param {k!r}")
        setattr(est, k, v)
    return est


def _best_index(metrics: np.ndarray, larger_better: bool) -> int:
    if np.all(np.isnan(metrics)):
        raise ValueError(
            "all cross-validation metrics are NaN: typically an empty fold; "
            "use more data, fewer folds, or a different seed")
    return int(np.nanargmax(metrics) if larger_better
               else np.nanargmin(metrics))


def _fold_ids(n_slots: int, num_folds: int, seed: int) -> np.ndarray:
    """The fold of every row slot: the reference's numpy draw."""
    return np.random.default_rng(seed).integers(0, num_folds, size=n_slots)


@functools.lru_cache(maxsize=8)
def _fold_ids_device(n_slots: int, num_folds: int, seed: int,
                     device: torch.device) -> torch.Tensor:
    """``_fold_ids`` on ``device``, kept: the draw is a pure function of
    its arguments, so a repeated ``fit`` pays neither the draw nor the copy
    again. Bounded, since each entry holds an (n,) tensor on the device."""
    return torch.as_tensor(_fold_ids(n_slots, num_folds, seed),
                           device=device)


# --- fast path: linear regression on per-fold Gramians ----------------------

def _holdout_metric_from_gram(A, coef, intercept, metric: str):
    """rmse/mse/r2 of raw-space models on folds, from the folds' Gramians
    (leading batch axes allowed)."""
    d = A.shape[-1] - 2
    XtX = A[..., :d, :d]
    Xty = A[..., :d, d]
    sum_x = A[..., :d, d + 1]
    sum_y = A[..., d, d + 1]
    yy = A[..., d, d]
    n = A[..., d + 1, d + 1]
    sse = (yy - 2.0 * _dot(coef, Xty) - 2.0 * intercept * sum_y
           + 2.0 * intercept * _dot(coef, sum_x)
           + _dot(_matvec(XtX, coef), coef)
           + n * intercept * intercept)
    mse = sse / n
    if metric == "mse":
        return mse
    if metric == "rmse":
        return torch.sqrt(torch.clamp(mse, min=0.0))
    ss_tot = yy - n * (sum_y / n) ** 2
    return 1.0 - sse / ss_tot


def _refit_solvers(estimator, param_maps: list[dict]) -> tuple:
    """The refit solver of every grid point (the grid varies only
    reg_param and elastic_net_param, so MLlib's ``auto`` resolves per
    point)."""
    out = []
    for p in param_maps:
        est = _apply_params(estimator, p)
        out.append(resolve_solver(est.solver, est.reg_param,
                                  est.elastic_net_param))
    return tuple(out)


def _cv_flat_layout(n_params: int, d: int, max_iter: int, refit: tuple):
    """(offset, history_len) per distinct solver in the packed CV output
    ``[metrics(m) | best | per solver: coef(d), intercept, iters,
    converged, history]``."""
    distinct = tuple(dict.fromkeys(refit))
    off = n_params + 1
    layout = {}
    for s in distinct:
        hlen = 1 if s == "normal" else max_iter + 1
        layout[s] = (off, hlen)
        off += d + 3 + hlen
    return distinct, layout, off


def fold_grams(X, y, mask, fold, num_folds: int) -> torch.Tensor:
    """(k, d+2, d+2): the Gramian of each fold's valid rows, one
    ``masked_gram`` each."""
    from .solvers import augmented_gram

    return torch.stack([augmented_gram(X, y, mask & (fold == f))
                        for f in range(num_folds)])


def cv_device_program(frame: Frame, estimator: LinearRegression,
                      param_maps: list[dict], metric: str, num_folds: int,
                      seed: int, larger_better: bool):
    """The fused cross-validation on the frame's device, up to the one
    packed result. Returns ``(flat, refit, d)``; nothing is read to the
    host."""
    from ..parallel.distributed import pack_fit_result

    X, y, mask = _extract_xy(frame, estimator.features_col,
                             estimator.label_col)
    dev, dt = X.device, X.dtype
    d, k, m = X.shape[1], num_folds, len(param_maps)
    fold = _fold_ids_device(X.shape[0], k, seed, dev)
    regs = torch.tensor([p.get("reg_param", estimator.reg_param)
                         for p in param_maps], dtype=dt, device=dev)
    alphas = torch.tensor([p.get("elastic_net_param",
                                 estimator.elastic_net_param)
                           for p in param_maps], dtype=dt, device=dev)
    refit = _refit_solvers(estimator, param_maps)
    kw = dict(max_iter=estimator.max_iter, tol=estimator.tol,
              fit_intercept=estimator.fit_intercept,
              standardization=estimator.standardization)

    A_folds = fold_grams(X, y, mask, fold, k)              # (k, D, D)
    A_all = A_folds.sum(0)
    A_train = A_all[None] - A_folds
    # Flatten (param × fold), param-major; every cell solves at once.
    cells = fista_solve(A_train.repeat(m, 1, 1), regs.repeat_interleave(k),
                        alphas.repeat_interleave(k), record_history=False,
                        **kw)
    A_hold = A_folds.repeat(m, 1, 1)
    metrics = _holdout_metric_from_gram(
        A_hold, cells.coefficients, cells.intercept, metric).reshape(
            m, k).mean(1)
    # NaN-safe winner (as _best_index): one degenerate fold of one param
    # does not poison the grid.
    guarded = torch.where(torch.isnan(metrics),
                          metrics.new_full((), -torch.inf if larger_better
                                           else torch.inf), metrics)
    best = torch.argmax(guarded) if larger_better else torch.argmin(guarded)

    parts = [metrics, best.to(dt).reshape(1)]
    distinct, _, _ = _cv_flat_layout(m, d, estimator.max_iter, refit)
    for s in distinct:
        parts.append(pack_fit_result(run_solver(s, A_all, regs[best],
                                                alphas[best], **kw)))
    return torch.cat(parts), refit, d


def _linear_cv_fast(frame: Frame, estimator: LinearRegression,
                    param_maps: list[dict], metric: str, num_folds: int,
                    seed: int, larger_better: bool):
    """Run the fused CV: one host read. Returns (metrics[num_params],
    best_index, best FitResult)."""
    from ..parallel.distributed import unpack_fit_result

    flat, refit, d = cv_device_program(frame, estimator, param_maps, metric,
                                       num_folds, seed, larger_better)
    flat = flat.cpu().numpy()                      # the one host read
    m = len(param_maps)
    metrics = flat[:m]
    if np.all(np.isnan(metrics)):
        _best_index(metrics, larger_better)        # raise the shared error
    best = int(flat[m])
    _, layout, _ = _cv_flat_layout(m, d, estimator.max_iter, refit)
    off, hlen = layout[refit[best]]
    return metrics, best, unpack_fit_result(flat[off:off + d + 3 + hlen], d)


# --- public API --------------------------------------------------------------

class CrossValidatorModel(Model):
    def __init__(self, best_model: Model, avg_metrics, best_index: int,
                 sub_models=None):
        self.best_model = best_model
        self.avg_metrics = np.asarray(avg_metrics)
        self.best_index = int(best_index)
        self.sub_models = sub_models

    bestModel = property(lambda self: self.best_model)
    avgMetrics = property(lambda self: self.avg_metrics)

    def transform(self, frame: Frame) -> Frame:
        return self.best_model.transform(frame)


class CrossValidator(Estimator):
    def __init__(self, estimator: Optional[Estimator] = None,
                 estimator_param_maps: Optional[list[dict]] = None,
                 evaluator: Optional[Evaluator] = None,
                 num_folds: int = 3, seed: int = 0,
                 collect_sub_models: bool = False,
                 parallelism: int = 1):
        self.estimator = estimator
        self.estimator_param_maps = estimator_param_maps or [{}]
        self.evaluator = evaluator or RegressionEvaluator()
        self.num_folds = num_folds
        self.seed = seed
        self.collect_sub_models = collect_sub_models
        # MLlib's thread-pool width; the fast path solves every cell at
        # once. Accepted for API parity.
        self.parallelism = parallelism

    def set_estimator(self, e): self.estimator = e; return self
    def set_estimator_param_maps(self, m): self.estimator_param_maps = m; return self
    def set_evaluator(self, e): self.evaluator = e; return self
    def set_num_folds(self, k): self.num_folds = int(k); return self
    def set_seed(self, s): self.seed = int(s); return self

    setEstimator = set_estimator
    setEstimatorParamMaps = set_estimator_param_maps
    setEvaluator = set_evaluator
    setNumFolds = set_num_folds
    setSeed = set_seed

    def _use_fast_path(self) -> bool:
        if not isinstance(self.estimator, LinearRegression):
            return False
        if getattr(self.estimator, "loss", "squaredError") != "squaredError":
            return False  # huber has no Gramian statistic
        if getattr(self.estimator, "weight_col", None):
            return False  # weighted fits take the generic path
        if self.collect_sub_models:
            return False  # per-fold models exist only on the generic path
        if not isinstance(self.evaluator, RegressionEvaluator):
            return False
        if self.evaluator.metric_name not in _FAST_METRICS:
            return False
        try:
            for p in self.estimator_param_maps:
                est = _apply_params(self.estimator, p)
                resolve_solver(est.solver, est.reg_param,
                               est.elastic_net_param)
        except (ValueError, AttributeError):
            return False
        # the grid may only vary what the batched solver takes per cell
        varied = {k for p in self.estimator_param_maps for k in p}
        return varied <= {"reg_param", "elastic_net_param"}

    def fit(self, frame: Frame) -> CrossValidatorModel:
        if self.estimator is None:
            raise ValueError("CrossValidator: estimator not set")
        larger_better = self.evaluator.is_larger_better()
        if self._use_fast_path():
            metrics, best, result = _linear_cv_fast(
                frame, self.estimator, self.estimator_param_maps,
                self.evaluator.metric_name, self.num_folds, self.seed,
                larger_better)
            best_est = _apply_params(self.estimator,
                                     self.estimator_param_maps[best])
            # refit on the all-data Gramian inside the fused program
            best_model = LinearRegressionModel(
                result.coefficients, float(result.intercept),
                best_est._params_dict())
            best_model._summary_source = (frame, result)
            return CrossValidatorModel(best_model, metrics, best)

        # generic path: fit and evaluate each (param, fold) cell
        fold = _fold_ids_device(frame.num_slots, self.num_folds, self.seed,
                                frame.device)
        metrics = np.zeros(len(self.estimator_param_maps))
        sub_models = [] if self.collect_sub_models else None
        for pi, params in enumerate(self.estimator_param_maps):
            est = _apply_params(self.estimator, params)
            scores = []
            for f in range(self.num_folds):
                model = est.fit(frame.filter(fold != f))
                scores.append(self.evaluator.evaluate(
                    model.transform(frame.filter(fold == f))))
                if sub_models is not None:
                    sub_models.append(model)
            metrics[pi] = float(np.mean(scores))
        best = _best_index(metrics, larger_better)
        best_model = _apply_params(
            self.estimator, self.estimator_param_maps[best]).fit(frame)
        return CrossValidatorModel(best_model, metrics, best, sub_models)


class TrainValidationSplitModel(CrossValidatorModel):
    @property
    def validation_metrics(self):
        return self.avg_metrics

    validationMetrics = validation_metrics


class TrainValidationSplit(CrossValidator):
    """One random train/validation split (MLlib TrainValidationSplit)."""

    def __init__(self, estimator=None, estimator_param_maps=None,
                 evaluator=None, train_ratio: float = 0.75, seed: int = 0):
        super().__init__(estimator, estimator_param_maps, evaluator,
                         num_folds=2, seed=seed)
        self.train_ratio = train_ratio

    def set_train_ratio(self, r): self.train_ratio = float(r); return self

    setTrainRatio = set_train_ratio

    def fit(self, frame: Frame) -> TrainValidationSplitModel:
        rng = np.random.default_rng(self.seed)
        is_val = torch.as_tensor(rng.random(frame.num_slots)
                                 >= self.train_ratio, device=frame.device)
        train, val = frame.filter(~is_val), frame.filter(is_val)
        metrics = np.zeros(len(self.estimator_param_maps))
        for pi, params in enumerate(self.estimator_param_maps):
            model = _apply_params(self.estimator, params).fit(train)
            metrics[pi] = self.evaluator.evaluate(model.transform(val))
        best = _best_index(metrics, self.evaluator.is_larger_better())
        best_model = _apply_params(
            self.estimator, self.estimator_param_maps[best]).fit(frame)
        return TrainValidationSplitModel(best_model, metrics, best)
