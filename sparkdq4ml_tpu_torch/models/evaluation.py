"""Evaluators: the MLlib ``ml.evaluation`` surface of the port (port of
``sparkdq4ml_tpu/models/evaluation.py``).

The classification metrics run where the scores live. The threshold
sweep behind every ROC and PR curve is one stable descending sort and
float64 cumulative sums on the scores' device; a boundary mask then pulls
only the points at distinct scores to the host (39 points for 10⁷ rows
scored from one integer feature), where the trapezoid runs in float64.
The multiclass counts are integer counts on the device, read once.
Regression metrics are float64 on the host, over the frame's valid rows.
The silhouette is float64 on the frame's device, its per-cluster sums
through the fixed-order segment sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame.frame import Frame
from ..utils.profiling import counters


def _pair(labels, scores):
    """Labels and scores as tensors on one device: a tensor keeps its
    device, a numpy array joins it (on the CPU when both are numpy)."""
    dev = next((v.device for v in (labels, scores)
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    return tuple(v.to(dev) if isinstance(v, torch.Tensor)
                 else torch.as_tensor(np.asarray(v), device=dev)
                 for v in (labels, scores))


def threshold_sweep(labels, scores):
    """Cumulative (thresholds desc, tp, fp) at each DISTINCT score, as
    float64 numpy arrays: at threshold t every row scoring >= t is
    predicted positive, so the last index of each tied run counts. NaN
    scores sort last, each a run of its own, as in numpy."""
    y, s = _pair(labels, scores)
    if s.ndim != 1 or y.shape != s.shape:
        raise ValueError("threshold_sweep: labels and scores must be "
                         "1-D of one length (one score a row)")
    if s.numel() == 0:
        return np.empty(0), np.empty(0), np.empty(0)
    order = torch.sort(-s, stable=True).indices     # numpy's mergesort
    s = s[order]
    pos = (y[order] == 1.0).to(torch.float64)
    tp = torch.cumsum(pos, 0)
    fp = torch.cumsum(1.0 - pos, 0)
    boundary = torch.ones_like(pos, dtype=torch.bool)
    boundary[:-1] = s[1:] != s[:-1]
    host = torch.stack([s.to(torch.float64), tp, fp])[:, boundary]
    counters.increment("frame.host_sync")    # one batched, counted pull
    host = host.cpu().numpy()
    return host[0], host[1], host[2]


def _pr(thr, tp, fp):
    npos = max(float(tp[-1]) if len(tp) else 0.0, 1.0)
    return thr, tp / np.maximum(tp + fp, 1.0), tp / npos


def _roc(tp, fp):
    npos = max(tp[-1], 1.0) if len(tp) else 1.0
    nneg = max(fp[-1], 1.0) if len(fp) else 1.0
    return np.r_[0.0, fp / nneg], np.r_[0.0, tp / npos]


def _one_class(tp, fp) -> bool:
    """True when the rows hold no positive or no negative label."""
    return len(tp) == 0 or tp[-1] == 0 or fp[-1] == 0


def pr_points(labels, scores):
    """(thresholds desc, precision, recall) at each distinct score."""
    return _pr(*threshold_sweep(labels, scores))


def roc_points(labels, scores):
    """(FPR, TPR) arrays over descending score thresholds."""
    _, tp, fp = threshold_sweep(labels, scores)
    return _roc(tp, fp)


def area_under_roc(labels, scores) -> float:
    """Exact AUC (rank statistic with tie handling): the trapezoid over
    the ROC boundary points; NaN when only one class is present."""
    _, tp, fp = threshold_sweep(labels, scores)
    if _one_class(tp, fp):
        return float("nan")
    fpr, tpr = _roc(tp, fp)
    return float(np.trapezoid(tpr, fpr))


def area_under_pr(labels, scores) -> float:
    """Precision-recall AUC over the threshold boundaries; NaN when only
    one class is present."""
    thr, tp, fp = threshold_sweep(labels, scores)
    if _one_class(tp, fp):
        return float("nan")
    _, precision, recall = _pr(thr, tp, fp)
    return float(np.trapezoid(np.r_[1.0, precision], np.r_[0.0, recall]))


def _valid(frame: Frame, name: str) -> torch.Tensor:
    """A column's valid rows, on the frame's device."""
    return frame._column_values(name)[frame.mask]


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


class BinaryClassificationEvaluator(Evaluator):
    """Metrics: areaUnderROC (default), areaUnderPR. Reads the
    rawPrediction column, or the probability column when the frame has no
    rawPrediction; the scores must be one value a row."""

    def __init__(self, metric_name: str = "areaUnderROC",
                 label_col: str = "label",
                 raw_prediction_col: str = "rawPrediction"):
        if metric_name not in ("areaUnderROC", "areaUnderPR"):
            raise ValueError(f"unknown metric {metric_name!r}")
        self.metric_name = metric_name
        self.label_col = label_col
        self.raw_prediction_col = raw_prediction_col

    def set_metric_name(self, v: str) -> "BinaryClassificationEvaluator":
        self.metric_name = v
        return self

    setMetricName = set_metric_name

    def evaluate(self, frame: Frame) -> float:
        score_col = self.raw_prediction_col
        if score_col not in frame.columns and "probability" in frame.columns:
            score_col = "probability"
        return self.compute(_valid(frame, self.label_col),
                            _valid(frame, score_col))

    def compute(self, y, s) -> float:
        if self.metric_name == "areaUnderROC":
            return area_under_roc(y, s)
        return area_under_pr(y, s)


def _share(count: int, n: int) -> float:
    return count / n if n else float("nan")


class MulticlassClassificationEvaluator(Evaluator):
    """MLlib metrics: ``f1`` (the Spark default), ``accuracy``,
    ``weightedPrecision``, ``weightedRecall`` (per-class one-vs-rest scores
    weighted by true-class frequency) and ``hammingLoss``."""

    _METRICS = ("f1", "accuracy", "weightedPrecision", "weightedRecall",
                "hammingLoss")

    def __init__(self, metric_name: str = "f1", label_col: str = "label",
                 prediction_col: str = "prediction"):
        if metric_name not in self._METRICS:
            raise ValueError(f"unknown metric {metric_name!r} "
                             f"(supported: {self._METRICS})")
        self.metric_name = metric_name
        self.label_col = label_col
        self.prediction_col = prediction_col

    def is_larger_better(self) -> bool:
        return self.metric_name != "hammingLoss"

    isLargerBetter = is_larger_better

    def evaluate(self, frame: Frame) -> float:
        return self.compute(_valid(frame, self.label_col),
                            _valid(frame, self.prediction_col))

    def compute(self, y, p) -> float:
        y, p = _pair(y, p)
        y, p = y.to(torch.float64), p.to(torch.float64)
        n = y.shape[0]
        if self.metric_name in ("accuracy", "hammingLoss"):
            same = int((y == p).sum())
            return _share(same if self.metric_name == "accuracy"
                          else n - same, n)
        # per true class: (tp, predicted, true) counts, read once
        classes = torch.unique(y)
        k = classes.numel()
        yi = torch.searchsorted(classes, y)
        pi = torch.searchsorted(classes, p).clamp(max=max(k - 1, 0))
        p_in = classes[pi] == p                # a prediction of a class
        counts = torch.stack([
            torch.bincount(yi[p_in & (pi == yi)], minlength=k)[:k],
            torch.bincount(pi[p_in], minlength=k)[:k],
            torch.bincount(yi, minlength=k)[:k]]).cpu().numpy()
        tp, pred_c, true_c = counts.astype(np.float64)
        prec = tp / np.maximum(pred_c, 1.0)
        rec = tp / np.maximum(true_c, 1.0)
        if self.metric_name == "weightedPrecision":
            scores = prec
        elif self.metric_name == "weightedRecall":
            scores = rec
        else:
            with np.errstate(invalid="ignore"):
                scores = np.where(prec + rec == 0, 0.0,
                                  2 * prec * rec / (prec + rec))
        return float(np.average(scores, weights=true_c / n))


class ClusteringEvaluator(Evaluator):
    """MLlib ``ClusteringEvaluator``: the mean silhouette coefficient with
    squared-Euclidean distance, over the frame's valid rows, in float64 on
    the frame's device whatever the policy (the reference computes it in
    float64 on the host). Per-cluster means and squared norms make each
    point's mean distance to a cluster one (n, k) product, Spark's
    optimization for this metric; the per-cluster sums go through the
    fixed-order segment sum."""

    def __init__(self, features_col: str = "features",
                 prediction_col: str = "prediction",
                 metric_name: str = "silhouette"):
        if metric_name != "silhouette":
            raise ValueError(f"unknown metric {metric_name!r}")
        self.features_col = features_col
        self.prediction_col = prediction_col
        self.metric_name = metric_name

    def set_features_col(self, v):
        self.features_col = v
        return self

    setFeaturesCol = set_features_col

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    setPredictionCol = set_prediction_col

    def evaluate(self, frame: Frame) -> float:
        from ..ops.segments import _seg_sum

        X = _valid(frame, self.features_col).to(torch.float64)
        if X.ndim == 1:
            X = X[:, None]
        # float64, then truncated toward zero (numpy's astype(int))
        labels = _valid(frame, self.prediction_col).to(torch.float64) \
            .to(torch.int64)
        uniq = torch.unique(labels)
        k = uniq.numel()
        if k < 2:
            return float("nan")
        lab = torch.searchsorted(uniq, labels)
        n = lab.shape[0]
        x_sq = torch.sum(X * X, dim=1)
        table = _seg_sum(torch.cat([X, x_sq[:, None],
                                    torch.ones_like(x_sq)[:, None]], dim=1),
                         lab, k)
        d = X.shape[1]
        sums, sq_sums, counts = table[:, :d], table[:, d], table[:, d + 1]
        means = sums / counts[:, None]
        # mean squared distance from point i to all of cluster c:
        #   E_c‖x_i − y‖² = ‖x_i‖² − 2·x_i·mean_c + E_c‖y‖²
        msd = x_sq[:, None] - 2.0 * (X @ means.T) + (sq_sums / counts)[None, :]
        rows = torch.arange(n, device=X.device)
        c_own = counts[lab]
        own = msd[rows, lab]
        zero = torch.zeros((), dtype=X.dtype, device=X.device)
        # a(i): mean distance to the own cluster, self excluded
        a = torch.where(c_own > 1, own * c_own / torch.clamp(c_own - 1,
                                                             min=1), zero)
        msd[rows, lab] = float("inf")
        b = torch.min(msd, dim=1).values              # nearest other cluster
        s = torch.where(c_own > 1, (b - a) / torch.clamp(
            torch.maximum(a, b), min=1e-300), zero)
        return float(torch.mean(s))
