"""Tree ensembles: DecisionTree / RandomForest / GBT, classifier and
regressor (port of ``sparkdq4ml_tpu/models/tree.py``, single device).

* **Histogram trees, level by level.** Features are quantile-binned once on
  the host (``bin_features``, numpy, the JAX package's edges). A tree grows
  breadth-first: at each level the per-(feature, node, bin) sufficient
  statistics are one fixed-order segment sum (``_level_histogram``), row
  ``i`` of feature ``f`` in slot ``(f·m + node)·B + bin``, through
  ``ops/segments.py:_seg_sum``: the ``dense_segment_sum`` kernel while the
  table fits its shared memory, else the ``sorted_segment_sum`` kernel
  after a stable sort of the slots. Rows parked in a leaf go to slot 0
  with zeroed targets, as in the reference. Split scoring is a cumulative
  sum over bins and a first-maximum ``argmax`` per node.
* **Static heap.** A tree is a dense heap of ``2^(depth+1) − 1`` node
  slots (feature, threshold, is-leaf, payload, gain); prediction is
  ``max_depth`` gathers over the rows.
* **A forest is a loop.** The reference vmaps its trees into one program;
  here each tree is built in turn, one histogram call per tree and level,
  from the same numpy draws in the same order (the Poisson bootstrap, then
  the feature-mask scores, then GBT's per-round subsample), so the
  bootstrap weights and masks match bit for bit.
* **GBT** keeps ``F``, the gradients and the Hessians in float64 on the
  frame's device (float64 on the host in the reference), and casts each
  round's stat rows to the policy's dtype.
* **Masked rows never vote**: the row weight folds the frame's mask.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import float_dtype
from ..frame.frame import Frame
from ..ops.segments import _seg_sum
from .base import Estimator, Model, feature_matrix, no_mesh, persistable

_NEG = -1e30


# ---------------------------------------------------------------------------
# binning (host, once: the MLlib findSplits analogue)
# ---------------------------------------------------------------------------

def bin_features(X: np.ndarray, mask: np.ndarray, max_bins: int):
    """Quantile bin edges per feature and the binned matrix, on the host.

    Returns (edges (d, max_bins-1) float64, ascending, +inf padded on the
    right; binned (n, d) int32 in [0, max_bins)). Bin b holds values in
    (edges[b-1], edges[b]]; a split "at bin b" sends bins <= b left with
    threshold edges[b].
    """
    n, d = X.shape
    edges = np.full((d, max_bins - 1), np.inf, np.float64)
    valid = X[mask] if mask is not None else X
    for j in range(d):
        col = valid[:, j]
        col = col[~np.isnan(col)]
        if len(col) == 0:
            continue
        qs = np.quantile(col, np.linspace(0, 1, max_bins + 1)[1:-1])
        uniq = np.unique(qs)
        edges[j, :len(uniq)] = uniq
    binned = np.empty((n, d), np.int32)
    for j in range(d):
        binned[:, j] = np.searchsorted(edges[j], X[:, j], side="left")
    return edges, binned


# ---------------------------------------------------------------------------
# level builder
# ---------------------------------------------------------------------------

def _level_histogram(binned, node_pos, targets, n_nodes: int, B: int):
    """(d, n_nodes, B, s) sufficient statistics of one level, as one
    fixed-order segment sum over ``d·n_nodes·B`` slots.

    ``binned`` (n, d) int64; ``node_pos`` (n,) the row's node within the
    level (``n_nodes`` marks parked rows, which go to slot 0 with zeroed
    targets); ``targets`` (n, s) the weighted stat rows."""
    n, d = binned.shape
    s = targets.shape[1]
    oob = node_pos >= n_nodes
    node = torch.where(oob, torch.zeros_like(node_pos), node_pos)
    feat = torch.arange(d, device=binned.device)
    slot = (feat[:, None] * n_nodes + node[None, :]) * B + binned.T
    slot = torch.where(oob[None, :], torch.zeros_like(slot), slot)
    t = torch.where(oob[:, None], torch.zeros_like(targets), targets)
    if d > 1:
        t = t.repeat(d, 1)
    hist = _seg_sum(t, slot.reshape(-1), d * n_nodes * B)
    return hist.reshape(d, n_nodes, B, s)


def _impurity_sse(agg):
    """Variance-scaled impurity (SSE) from [w, wy, wy²] stats."""
    w = torch.clamp(agg[..., 0], min=1e-12)
    return agg[..., 2] - agg[..., 1] ** 2 / w


def _impurity_gini(agg):
    """Weighted gini from per-class counts: w − Σc²/w."""
    w = torch.clamp(torch.sum(agg, dim=-1), min=1e-12)
    return w - torch.sum(agg * agg, dim=-1) / w


def _impurity_entropy(agg):
    w = torch.clamp(torch.sum(agg, dim=-1), min=1e-12)
    p = agg / w[..., None]
    terms = torch.where(p > 0, p * torch.log2(torch.clamp(p, min=1e-12)),
                        torch.zeros_like(p))
    return -w * torch.sum(terms, dim=-1)


_IMPURITY = {"variance": _impurity_sse, "gini": _impurity_gini,
             "entropy": _impurity_entropy}


def _split_gains(hist, edges, impurity, min_instances, feat_mask=None):
    """(m, d·(B-1)) gains of every candidate split of one level's nodes,
    feature-major, from its histograms ``hist`` (d, m, B, s) and ``edges``
    (d, B-1); ``_NEG`` where a candidate is not allowed."""
    imp_fn = _IMPURITY[impurity]
    left = torch.cumsum(hist, dim=2)[:, :, :-1, :]           # (d, m, B-1, s)
    total = torch.sum(hist, dim=2)                           # (d, m, s)
    right = total[:, :, None, :] - left
    gain = imp_fn(total)[:, :, None] - imp_fn(left) - imp_fn(right)

    def weight(a):
        return a[..., 0] if impurity == "variance" else torch.sum(a, dim=-1)

    ok = (weight(left) >= min_instances) & (weight(right) >= min_instances)
    ok = ok & torch.isfinite(edges)[:, None, :]
    neg = torch.full((), _NEG, dtype=gain.dtype, device=gain.device)
    gain = torch.where(ok, gain, neg)
    if feat_mask is not None:                                # (m, d)
        gain = torch.where(feat_mask.T[:, :, None], gain, neg)
    d, m, bm1 = gain.shape
    return gain.permute(1, 0, 2).reshape(m, d * bm1)


def _find_splits(hist, edges, impurity, min_instances, min_info_gain,
                 feat_mask=None):
    """Best (feature, bin, threshold, split flag, gain) per node from one
    level's histograms ``hist`` (d, m, B, s) and ``edges`` (d, B-1). The
    first maximum wins a tie (``torch.argmax``, as ``jnp.argmax``)."""
    flat = _split_gains(hist, edges, impurity, min_instances, feat_mask)
    bm1 = edges.shape[1]
    best = torch.argmax(flat, dim=1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    best_feat = best // bm1
    best_bin = best % bm1
    thr = edges[best_feat, best_bin]
    split = best_gain > max(min_info_gain, 1e-12)
    return best_feat, best_bin, thr, split, best_gain


class TreeArrays(NamedTuple):
    """Dense heap tree: node i's children are 2i+1 / 2i+2."""
    feature: object       # (N,) int32
    threshold: object     # (N,)
    is_leaf: object       # (N,) bool
    value: object         # (N, v) leaf payload (stat sums or class counts)
    gain: object          # (N,) split gain (0 for leaves)


def build_tree(binned, edges, targets, max_depth, max_bins, impurity,
               min_instances, min_info_gain, feat_masks=None) -> TreeArrays:
    """Level-wise histogram tree build on ``targets``' device: a Python
    loop over levels, one histogram call each, no host read.

    ``binned`` (n, d) int64; ``edges`` (d, B-1) in the targets' dtype;
    ``targets`` (n, s) weighted stat rows; ``feat_masks`` an optional
    (N, d) boolean per-heap-node feature mask."""
    n, d = binned.shape
    N = 2 ** (max_depth + 1) - 1
    s = targets.shape[1]
    dt, dev = targets.dtype, targets.device

    feature = torch.zeros(N, dtype=torch.int32, device=dev)
    threshold = torch.zeros(N, dtype=dt, device=dev)
    is_leaf = torch.ones(N, dtype=torch.bool, device=dev)
    value = torch.zeros((N, s), dtype=dt, device=dev)
    gains = torch.zeros(N, dtype=dt, device=dev)

    heap = torch.zeros(n, dtype=torch.int64, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(max_depth + 1):
        m = 2 ** depth
        base = m - 1
        node_pos = torch.where(alive, heap - base,
                               torch.full_like(heap, m))
        hist = _level_histogram(binned, node_pos, targets, m, max_bins)
        # every feature's bins partition the same rows: feature 0's
        # histogram summed over bins is the node total
        value[base:base + m] = torch.sum(hist[0], dim=1)
        if depth == max_depth:
            break
        fm = None if feat_masks is None else feat_masks[base:base + m]
        feat, split_bin, thr, split, gain = _find_splits(
            hist, edges, impurity, min_instances, min_info_gain, fm)
        feature[base:base + m] = feat.to(torch.int32)
        threshold[base:base + m] = thr
        is_leaf[base:base + m] = ~split
        gains[base:base + m] = torch.where(split, gain,
                                           torch.zeros_like(gain))
        # descend: rows of split nodes go to a child (bins <= split_bin
        # left, the same as value <= threshold); rows of leaves park
        pos = torch.clamp(node_pos, 0, m - 1)
        row_split = split[pos] & alive
        row_bin = binned.gather(1, feat[pos][:, None])[:, 0]
        go_left = row_bin <= split_bin[pos]
        child = torch.where(go_left, 2 * heap + 1, 2 * heap + 2)
        heap = torch.where(row_split, child, heap)
        alive = row_split
    return TreeArrays(feature, threshold, is_leaf, value, gains)


def predict_heap(X, feature, threshold, is_leaf, max_depth: int):
    """(n,) leaf heap ids of raw feature rows: ``max_depth`` gathers."""
    node = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    feature = feature.to(torch.int64)
    for _ in range(max_depth):
        xv = X.gather(1, feature[node][:, None])[:, 0]
        child = torch.where(xv <= threshold[node], 2 * node + 1,
                            2 * node + 2)
        node = torch.where(is_leaf[node], node, child)
    return node


def feature_importances(trees: TreeArrays, d: int) -> np.ndarray:
    """Gain-summed importances over all trees and nodes, normalized."""
    feat = np.asarray(trees.feature).reshape(-1)
    gain = np.asarray(trees.gain, np.float64).reshape(-1)
    imp = np.zeros((d,), np.float64)
    np.add.at(imp, feat, np.maximum(gain, 0.0))
    total = imp.sum()
    return imp / total if total > 0 else imp


def _host_trees(trees) -> TreeArrays:
    return TreeArrays(*(t.cpu().numpy() for t in trees))


def _stack(trees: list) -> TreeArrays:
    return TreeArrays(*[np.stack([getattr(t, f) for t in trees])
                        for f in TreeArrays._fields])


# ---------------------------------------------------------------------------
# estimator/model surface
# ---------------------------------------------------------------------------

class _TreeParams:
    """Shared builder surface for the MLlib tree params."""

    def set_max_depth(self, v):
        self.max_depth = int(v)
        return self

    setMaxDepth = set_max_depth

    def set_max_bins(self, v):
        self.max_bins = int(v)
        return self

    setMaxBins = set_max_bins

    def set_min_instances_per_node(self, v):
        self.min_instances_per_node = int(v)
        return self

    setMinInstancesPerNode = set_min_instances_per_node

    def set_min_info_gain(self, v):
        self.min_info_gain = float(v)
        return self

    setMinInfoGain = set_min_info_gain

    def set_features_col(self, v):
        self.features_col = v
        return self

    setFeaturesCol = set_features_col

    def set_label_col(self, v):
        self.label_col = v
        return self

    setLabelCol = set_label_col

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    setPredictionCol = set_prediction_col

    def set_seed(self, v):
        self.seed = int(v)
        return self

    setSeed = set_seed

    def _extract(self, frame):
        """(X on the device in the policy dtype, X on the host, y float64
        on the device with masked slots zeroed, the mask on the device and
        on the host). The label and feature checks read one flag each."""
        X = feature_matrix(frame, self.features_col)
        y = frame._column_values(self.label_col).to(torch.float64)
        mask = frame.mask
        if not bool(mask.any()):
            raise ValueError(f"{type(self).__name__}: no valid rows")
        if not bool(torch.isfinite(y[mask]).all()):
            raise ValueError(f"{type(self).__name__}: label column has "
                             "NaN/inf in valid rows")
        if not bool(torch.isfinite(X[mask]).all()):
            raise ValueError(f"{type(self).__name__}: feature matrix has "
                             "NaN/inf in valid rows")
        y = torch.where(mask, y, torch.zeros_like(y))
        return X, X.cpu().numpy(), y, mask, frame._host_mask()


def _n_subset_features(strategy, d, is_classification, n_trees=1):
    """Spark's featureSubsetStrategy table: 'auto' = all for a single tree,
    sqrt(d) for classification forests, d/3 for regression forests; also
    'n' (an integer count) and '0.x' (a fraction)."""
    if strategy == "all":
        return d
    if strategy == "auto":
        if n_trees <= 1:
            return d
        return max(1, int(np.sqrt(d))) if is_classification \
            else max(1, d // 3)
    if strategy == "sqrt":
        return max(1, int(np.sqrt(d)))
    if strategy == "onethird":
        return max(1, d // 3)
    if strategy == "log2":
        return max(1, int(np.log2(d)))
    try:
        if isinstance(strategy, str) and strategy.isdigit():
            return min(d, max(1, int(strategy)))
        frac = float(strategy)
        if not 0.0 < frac <= 1.0:
            raise ValueError
        return max(1, int(round(frac * d)))
    except (TypeError, ValueError):
        raise ValueError(f"unknown featureSubsetStrategy {strategy!r}") \
            from None


def _fit_forest(binned, edges, y, w, *, n_trees, max_depth, max_bins,
                impurity, min_instances, min_info_gain, n_classes,
                subsample, n_feat, seed) -> TreeArrays:
    """Build ``n_trees`` trees, one after the other, on ``y``'s device;
    returns the stacked host arrays.

    Regression (``n_classes=0``): targets [w, wy, wy²]; classification:
    per-class weighted one-hots. ``binned`` (n, d) int64 and ``y``, ``w``
    float64 on the device; ``edges`` float64 numpy."""
    n, d = binned.shape
    dev = y.device
    dt = float_dtype()
    rng = np.random.default_rng(seed)
    N = 2 ** (max_depth + 1) - 1

    boot = None
    if n_trees > 1:   # Poisson(subsample) bootstrap, Spark's sampling model
        boot = rng.poisson(subsample, size=(n_trees, n))
    if n_classes:
        yi = torch.clamp(y.to(torch.int64), 0, n_classes - 1)
        stats = torch.eye(n_classes, dtype=torch.float64, device=dev)[yi]
    else:
        stats = torch.stack([torch.ones_like(y), y, y * y], dim=1)
    feat_masks = None
    if n_feat < d:
        scores = rng.random(size=(n_trees, N, d))
        kth = np.partition(scores, n_feat - 1, axis=2)[:, :, n_feat - 1]
        feat_masks = scores <= kth[:, :, None]

    edges_d = torch.as_tensor(edges, dtype=dt, device=dev)
    trees = []
    for t in range(n_trees):
        wt = w if boot is None else \
            torch.as_tensor(boot[t], device=dev).to(torch.float64) * w
        targets = (wt[:, None] * stats).to(dt)
        fm = None if feat_masks is None else \
            torch.as_tensor(feat_masks[t], device=dev)
        trees.append(_host_trees(build_tree(
            binned, edges_d, targets, max_depth, max_bins, impurity,
            min_instances, min_info_gain, fm)))
    return _stack(trees)


class _TreeModelBase(Model):
    """Shared prediction over a stacked (T, N) heap forest."""

    def _leaf_values(self, X):
        """(T, n, s) leaf payloads for every tree, on ``X``'s device."""
        out = []
        dev = X.device
        for t in range(np.asarray(self.feature).shape[0]):
            thr = torch.as_tensor(np.asarray(self.threshold)[t],
                                  device=dev).to(X.dtype)
            node = predict_heap(
                X, torch.as_tensor(np.asarray(self.feature)[t], device=dev),
                thr, torch.as_tensor(np.asarray(self.is_leaf)[t],
                                     device=dev), self.max_depth)
            value = torch.as_tensor(np.asarray(self.value)[t], device=dev)
            out.append(value[node])
        return torch.stack(out)

    @property
    def feature_importances(self):
        return feature_importances(
            TreeArrays(self.feature, self.threshold, self.is_leaf,
                       self.value, self.gain), self.num_features)

    featureImportances = feature_importances

    @property
    def num_features(self):
        return int(self._num_features)

    numFeatures = num_features

    def _frame_X(self, frame):
        return feature_matrix(frame, self._params.get("features_col",
                                                      "features"))

    @staticmethod
    def _row(features):
        return torch.as_tensor(np.asarray(features, np.float64)
                               .reshape(1, -1), dtype=float_dtype())


def _fit_tree_estimator(est, frame, n_classes):
    """Binning on the host, then ``_fit_forest`` on the frame's device."""
    X, Xh, y, mask, mh = est._extract(frame)
    edges, binned = bin_features(Xh, mh, est.max_bins)
    binned_d = torch.as_tensor(binned, device=X.device).to(torch.int64)
    w = mask.to(torch.float64)
    impurity = getattr(est, "impurity", "variance")
    return _fit_forest(
        binned_d, edges, y, w, n_trees=est._n_trees,
        max_depth=est.max_depth, max_bins=est.max_bins, impurity=impurity,
        min_instances=est.min_instances_per_node,
        min_info_gain=est.min_info_gain, n_classes=n_classes,
        subsample=est._subsample,
        n_feat=_n_subset_features(est._feature_subset, X.shape[1],
                                  bool(n_classes), est._n_trees),
        seed=est.seed), X.shape[1]


@persistable
class DecisionTreeRegressor(Estimator, _TreeParams):
    """MLlib ``DecisionTreeRegressor`` (variance impurity)."""

    _persist_attrs = ('max_depth', 'max_bins', 'min_instances_per_node',
                      'min_info_gain', 'features_col', 'label_col',
                      'prediction_col', 'seed')

    def __init__(self, max_depth: int = 5, max_bins: int = 32,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction", seed: int = 0):
        self.max_depth = int(max_depth)
        self.max_bins = int(max_bins)
        self.min_instances_per_node = int(min_instances_per_node)
        self.min_info_gain = float(min_info_gain)
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.seed = int(seed)

    _n_trees = 1
    _subsample = 1.0
    _feature_subset = "all"
    _model_class = None

    def fit(self, frame: Frame, mesh=None) -> "DecisionTreeRegressionModel":
        no_mesh(mesh, type(self).__name__)
        trees, d = _fit_tree_estimator(self, frame, 0)
        cls = self._model_class or DecisionTreeRegressionModel
        return cls(trees.feature, trees.threshold, trees.is_leaf,
                   trees.value, trees.gain, d, self.max_depth,
                   {"features_col": self.features_col,
                    "prediction_col": self.prediction_col})


@persistable
class DecisionTreeRegressionModel(_TreeModelBase):
    _persist_attrs = ('feature', 'threshold', 'is_leaf', 'value', 'gain',
                      '_num_features', 'max_depth', '_params')

    def __init__(self, feature, threshold, is_leaf, value, gain,
                 num_features, max_depth, params=None):
        self.feature = np.asarray(feature)
        self.threshold = np.asarray(threshold)
        self.is_leaf = np.asarray(is_leaf)
        self.value = np.asarray(value)
        self.gain = np.asarray(gain)
        self._num_features = int(num_features)
        self.max_depth = int(max_depth)
        self._params = dict(params or {})

    def _predict_array(self, X):
        vals = self._leaf_values(X)                  # (T, n, 3): [w, wy, wy²]
        # MLlib averages per-tree leaf predictions with equal tree weight
        per_tree = vals[:, :, 1] / torch.clamp(vals[:, :, 0], min=1e-12)
        return torch.mean(per_tree, dim=0)

    def transform(self, frame: Frame) -> Frame:
        pred = self._predict_array(self._frame_X(frame))
        return frame.with_column(
            self._params.get("prediction_col", "prediction"),
            pred.to(float_dtype()))

    def predict(self, features) -> float:
        return float(self._predict_array(self._row(features))[0])


@persistable
class RandomForestRegressor(DecisionTreeRegressor):
    """MLlib ``RandomForestRegressor``: Poisson bootstrap and per-node
    random feature subsets."""

    _persist_attrs = DecisionTreeRegressor._persist_attrs + (
        'num_trees', 'subsampling_rate', 'feature_subset_strategy')

    def __init__(self, num_trees: int = 20, subsampling_rate: float = 1.0,
                 feature_subset_strategy: str = "auto", **kw):
        super().__init__(**kw)
        self.num_trees = int(num_trees)
        self.subsampling_rate = float(subsampling_rate)
        self.feature_subset_strategy = feature_subset_strategy

    def set_num_trees(self, v):
        self.num_trees = int(v)
        return self

    setNumTrees = set_num_trees

    def set_subsampling_rate(self, v):
        self.subsampling_rate = float(v)
        return self

    setSubsamplingRate = set_subsampling_rate

    def set_feature_subset_strategy(self, v):
        self.feature_subset_strategy = v
        return self

    setFeatureSubsetStrategy = set_feature_subset_strategy

    @property
    def _n_trees(self):
        return self.num_trees

    @property
    def _subsample(self):
        return self.subsampling_rate

    @property
    def _feature_subset(self):
        return self.feature_subset_strategy

    @property
    def _model_class(self):
        return RandomForestRegressionModel


@persistable
class RandomForestRegressionModel(DecisionTreeRegressionModel):
    @property
    def num_trees(self):
        return int(np.asarray(self.feature).shape[0])

    getNumTrees = num_trees


@persistable
class DecisionTreeClassifier(Estimator, _TreeParams):
    """MLlib ``DecisionTreeClassifier`` (gini default / entropy)."""

    _persist_attrs = ('max_depth', 'max_bins', 'min_instances_per_node',
                      'min_info_gain', 'impurity', 'features_col',
                      'label_col', 'prediction_col', 'probability_col',
                      'raw_prediction_col', 'seed')

    def __init__(self, max_depth: int = 5, max_bins: int = 32,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 impurity: str = "gini", features_col: str = "features",
                 label_col: str = "label", prediction_col: str = "prediction",
                 probability_col: str = "probability",
                 raw_prediction_col: str = "rawPrediction", seed: int = 0):
        if impurity not in ("gini", "entropy"):
            raise ValueError(f"impurity={impurity!r} (gini|entropy)")
        self.max_depth = int(max_depth)
        self.max_bins = int(max_bins)
        self.min_instances_per_node = int(min_instances_per_node)
        self.min_info_gain = float(min_info_gain)
        self.impurity = impurity
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.probability_col = probability_col
        self.raw_prediction_col = raw_prediction_col
        self.seed = int(seed)

    def set_impurity(self, v):
        if v not in ("gini", "entropy"):
            raise ValueError(f"impurity={v!r}")
        self.impurity = v
        return self

    setImpurity = set_impurity

    _n_trees = 1
    _subsample = 1.0
    _feature_subset = "all"
    _model_class = None

    def fit(self, frame: Frame, mesh=None) \
            -> "DecisionTreeClassificationModel":
        no_mesh(mesh, type(self).__name__)
        y = frame._column_values(self.label_col).to(torch.float64)
        yv = y[frame.mask]
        if bool(((yv < 0) | (yv != torch.floor(yv))).any()):
            raise ValueError("labels must be nonnegative integers 0..k-1")
        k = int(yv.max()) + 1 if yv.numel() else 1
        trees, d = _fit_tree_estimator(self, frame, k)
        cls = self._model_class or DecisionTreeClassificationModel
        return cls(trees.feature, trees.threshold, trees.is_leaf,
                   trees.value, trees.gain, d, self.max_depth, k,
                   self._params_for_model())

    def _params_for_model(self):
        return {"features_col": self.features_col,
                "prediction_col": self.prediction_col,
                "probability_col": self.probability_col,
                "raw_prediction_col": self.raw_prediction_col}


@persistable
class DecisionTreeClassificationModel(_TreeModelBase):
    _persist_attrs = ('feature', 'threshold', 'is_leaf', 'value', 'gain',
                      '_num_features', 'max_depth', 'num_classes', '_params')

    def __init__(self, feature, threshold, is_leaf, value, gain,
                 num_features, max_depth, num_classes, params=None):
        self.feature = np.asarray(feature)
        self.threshold = np.asarray(threshold)
        self.is_leaf = np.asarray(is_leaf)
        self.value = np.asarray(value)
        self.gain = np.asarray(gain)
        self._num_features = int(num_features)
        self.max_depth = int(max_depth)
        self.num_classes = int(num_classes)
        self._params = dict(params or {})

    numClasses = property(lambda self: self.num_classes)

    def _counts_and_proba(self, X):
        vals = self._leaf_values(X)                  # (T, n, k) class counts
        per_tree = vals / torch.clamp(torch.sum(vals, dim=2, keepdim=True),
                                      min=1e-12)
        if vals.shape[0] == 1:
            # single tree (MLlib): rawPrediction = the leaf's class counts
            return vals[0], per_tree[0]
        # forest: rawPrediction = summed per-tree probability votes
        raw = torch.sum(per_tree, dim=0)
        return raw, raw / vals.shape[0]

    def transform(self, frame: Frame) -> Frame:
        p = self._params
        raw, prob = self._counts_and_proba(self._frame_X(frame))
        pred = torch.argmax(prob, dim=1).to(float_dtype())
        out = frame.with_column(p.get("raw_prediction_col", "rawPrediction"),
                                raw)
        out = out.with_column(p.get("probability_col", "probability"), prob)
        return out.with_column(p.get("prediction_col", "prediction"), pred)

    def predict(self, features) -> float:
        prob = self._counts_and_proba(self._row(features))[1]
        return float(torch.argmax(prob, dim=1)[0])

    def predict_probability(self, features):
        return self._counts_and_proba(self._row(features))[1][0].numpy()

    predictProbability = predict_probability


@persistable
class RandomForestClassifier(DecisionTreeClassifier):
    """MLlib ``RandomForestClassifier``: bootstrap and sqrt feature subsets
    ("auto"), soft-vote probabilities."""

    _persist_attrs = DecisionTreeClassifier._persist_attrs + (
        'num_trees', 'subsampling_rate', 'feature_subset_strategy')

    def __init__(self, num_trees: int = 20, subsampling_rate: float = 1.0,
                 feature_subset_strategy: str = "auto", **kw):
        super().__init__(**kw)
        self.num_trees = int(num_trees)
        self.subsampling_rate = float(subsampling_rate)
        self.feature_subset_strategy = feature_subset_strategy

    set_num_trees = RandomForestRegressor.set_num_trees
    setNumTrees = set_num_trees
    set_subsampling_rate = RandomForestRegressor.set_subsampling_rate
    setSubsamplingRate = set_subsampling_rate
    set_feature_subset_strategy = \
        RandomForestRegressor.set_feature_subset_strategy
    setFeatureSubsetStrategy = set_feature_subset_strategy

    _n_trees = RandomForestRegressor._n_trees
    _subsample = RandomForestRegressor._subsample
    _feature_subset = RandomForestRegressor._feature_subset

    @property
    def _model_class(self):
        return RandomForestClassificationModel


@persistable
class RandomForestClassificationModel(DecisionTreeClassificationModel):
    @property
    def num_trees(self):
        return int(np.asarray(self.feature).shape[0])

    getNumTrees = num_trees


# ---------------------------------------------------------------------------
# Gradient-boosted trees: sequential Newton boosting over the same builder
# ---------------------------------------------------------------------------

def _gbt_fit(X, Xh, y, w, mh, *, loss, max_iter, step, max_depth,
             max_bins, min_instances, min_info_gain, subsample, seed,
             valid_w=None, validation_tol=0.01):
    """Returns (F0, stacked host TreeArrays). Stat rows per tree:
    [w, w·g, w·g², w·h]: variance-of-gradient splits, Newton leaf values
    Σg/Σh. ``X`` (n, d) in the policy dtype, ``y``, ``w`` and ``valid_w``
    float64, all on one device; ``Xh`` and ``mh`` the host copies of ``X``
    and of the training rows (``w > 0``) for the binning.

    ``valid_w``: held-out row weights (MLlib ``validationIndicatorCol``).
    After each round the validation loss is read; boosting stops once its
    relative improvement over the best so far drops below
    ``validation_tol``, and the ensemble is truncated at the best round
    (one tree at least)."""
    dt = float_dtype()
    dev = X.device
    edges, binned = bin_features(Xh, mh, max_bins)
    binned_d = torch.as_tensor(binned, device=dev).to(torch.int64)
    edges_d = torch.as_tensor(edges, dtype=dt, device=dev)
    rng = np.random.default_rng(seed)
    n = y.shape[0]

    wsum = max(float(w.sum()), 1e-12)
    if loss == "squared":
        F0 = float(torch.sum(w * y)) / wsum
    else:   # logistic: F0 = log-odds of the weighted base rate
        p0 = min(max(float(torch.sum(w * y)) / wsum, 1e-6), 1 - 1e-6)
        F0 = float(np.log(p0 / (1 - p0)))

    def val_loss(F_now):
        vs = max(float(valid_w.sum()), 1e-12)
        if loss == "squared":
            return float(torch.sum(valid_w * (y - F_now) ** 2)) / vs
        z = torch.where(y > 0.5, F_now, -F_now)
        zero = torch.zeros((), dtype=z.dtype, device=dev)
        return float(torch.sum(valid_w * torch.logaddexp(zero, -z))) / vs

    F = torch.full((n,), F0, dtype=torch.float64, device=dev)
    all_trees = []
    best_loss = val_loss(F) if valid_w is not None else None
    best_k = 0
    for _ in range(max_iter):
        if loss == "squared":
            g = y - F
            h = torch.ones_like(y)
        else:
            p = 1.0 / (1.0 + torch.exp(-F))
            g = y - p
            h = torch.clamp(p * (1 - p), min=1e-12)
        ww = w
        if subsample < 1.0:
            keep = rng.random(n) < subsample
            ww = w * torch.as_tensor(keep, device=dev).to(torch.float64)
        targets = torch.stack([ww, ww * g, ww * g * g, ww * h],
                              dim=1).to(dt)
        tree = build_tree(binned_d, edges_d, targets, max_depth, max_bins,
                          "variance", min_instances, min_info_gain)
        all_trees.append(_host_trees(tree))
        node = predict_heap(X, tree.feature, tree.threshold, tree.is_leaf,
                            max_depth)
        v = tree.value[node]
        leaf = v[:, 1] / torch.clamp(v[:, 3], min=1e-12)
        F = F + step * leaf.to(torch.float64)
        if valid_w is not None:
            cur = val_loss(F)
            if cur < best_loss - validation_tol * max(abs(best_loss), 1e-12):
                best_loss = cur
                best_k = len(all_trees)
            else:
                break
    if valid_w is not None:
        all_trees = all_trees[:max(best_k, 1)]
    return F0, _stack(all_trees)


class _GbtBase(Estimator, _TreeParams):
    validation_indicator_col = None
    validation_tol = 0.01

    def __init__(self, max_iter: int = 20, step_size: float = 0.1,
                 max_depth: int = 5, max_bins: int = 32,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 subsampling_rate: float = 1.0,
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction", seed: int = 0,
                 validation_indicator_col=None, validation_tol: float = 0.01):
        self.max_iter = int(max_iter)
        self.step_size = float(step_size)
        self.max_depth = int(max_depth)
        self.max_bins = int(max_bins)
        self.min_instances_per_node = int(min_instances_per_node)
        self.min_info_gain = float(min_info_gain)
        self.subsampling_rate = float(subsampling_rate)
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.seed = int(seed)
        self.validation_indicator_col = validation_indicator_col
        self.validation_tol = float(validation_tol)

    def _split_weights(self, frame, mask):
        """(training weights, validation weights or None), mask-aware."""
        w = mask.to(torch.float64)
        if self.validation_indicator_col is None:
            return w, None
        v = frame._column_values(self.validation_indicator_col) > 0
        return w * (~v), w * v

    def set_max_iter(self, v):
        self.max_iter = int(v)
        return self

    setMaxIter = set_max_iter

    def set_validation_indicator_col(self, v):
        self.validation_indicator_col = v
        return self

    setValidationIndicatorCol = set_validation_indicator_col

    def set_validation_tol(self, v):
        self.validation_tol = float(v)
        return self

    setValidationTol = set_validation_tol

    def set_step_size(self, v):
        self.step_size = float(v)
        return self

    setStepSize = set_step_size

    def set_subsampling_rate(self, v):
        self.subsampling_rate = float(v)
        return self

    setSubsamplingRate = set_subsampling_rate

    def _fit_gbt(self, frame, loss, mesh):
        no_mesh(mesh, type(self).__name__)
        X, Xh, y, mask, _ = self._extract(frame)
        w_train, w_val = self._split_weights(frame, mask)
        return _gbt_fit(
            X, Xh, y, w_train, (w_train > 0).cpu().numpy(), loss=loss,
            max_iter=self.max_iter, step=self.step_size,
            max_depth=self.max_depth, max_bins=self.max_bins,
            min_instances=self.min_instances_per_node,
            min_info_gain=self.min_info_gain,
            subsample=self.subsampling_rate, seed=self.seed,
            valid_w=w_val, validation_tol=self.validation_tol), X.shape[1]


@persistable
class GBTRegressor(_GbtBase):
    """MLlib ``GBTRegressor`` (squared loss)."""

    _persist_attrs = ('max_iter', 'step_size', 'max_depth', 'max_bins',
                      'min_instances_per_node', 'min_info_gain',
                      'subsampling_rate', 'features_col', 'label_col',
                      'prediction_col', 'seed',
                      'validation_indicator_col', 'validation_tol')

    def fit(self, frame: Frame, mesh=None) -> "GBTRegressionModel":
        (F0, trees), d = self._fit_gbt(frame, "squared", mesh)
        return GBTRegressionModel(
            trees.feature, trees.threshold, trees.is_leaf, trees.value,
            trees.gain, d, self.max_depth, F0, self.step_size,
            {"features_col": self.features_col,
             "prediction_col": self.prediction_col})


class _GbtModelBase(_TreeModelBase):
    def _score(self, X):
        vals = self._leaf_values(X)                  # (T, n, 4)
        leaf = vals[:, :, 1] / torch.clamp(vals[:, :, 3], min=1e-12)
        return self.f0 + self.step_size * torch.sum(leaf, dim=0)

    @property
    def num_trees(self):
        return int(np.asarray(self.feature).shape[0])

    getNumTrees = num_trees


@persistable
class GBTRegressionModel(_GbtModelBase):
    _persist_attrs = ('feature', 'threshold', 'is_leaf', 'value', 'gain',
                      '_num_features', 'max_depth', 'f0', 'step_size',
                      '_params')

    def __init__(self, feature, threshold, is_leaf, value, gain,
                 num_features, max_depth, f0, step_size, params=None):
        self.feature = np.asarray(feature)
        self.threshold = np.asarray(threshold)
        self.is_leaf = np.asarray(is_leaf)
        self.value = np.asarray(value)
        self.gain = np.asarray(gain)
        self._num_features = int(num_features)
        self.max_depth = int(max_depth)
        self.f0 = float(f0)
        self.step_size = float(step_size)
        self._params = dict(params or {})

    def transform(self, frame: Frame) -> Frame:
        pred = self._score(self._frame_X(frame))
        return frame.with_column(
            self._params.get("prediction_col", "prediction"),
            pred.to(float_dtype()))

    def predict(self, features) -> float:
        return float(self._score(self._row(features))[0])


@persistable
class GBTClassifier(_GbtBase):
    """MLlib ``GBTClassifier`` (binary, logistic loss, Newton leaves)."""

    _persist_attrs = GBTRegressor._persist_attrs + (
        'probability_col', 'raw_prediction_col')

    def __init__(self, probability_col: str = "probability",
                 raw_prediction_col: str = "rawPrediction", **kw):
        super().__init__(**kw)
        self.probability_col = probability_col
        self.raw_prediction_col = raw_prediction_col

    def fit(self, frame: Frame, mesh=None) -> "GBTClassificationModel":
        y = frame._column_values(self.label_col).to(torch.float64)
        yv = y[frame.mask]
        if not bool(((yv == 0) | (yv == 1)).all()):
            raise ValueError("GBTClassifier requires binary 0/1 labels")
        (F0, trees), d = self._fit_gbt(frame, "logistic", mesh)
        return GBTClassificationModel(
            trees.feature, trees.threshold, trees.is_leaf, trees.value,
            trees.gain, d, self.max_depth, F0, self.step_size,
            {"features_col": self.features_col,
             "prediction_col": self.prediction_col,
             "probability_col": self.probability_col,
             "raw_prediction_col": self.raw_prediction_col})


@persistable
class GBTClassificationModel(_GbtModelBase):
    _persist_attrs = GBTRegressionModel._persist_attrs

    __init__ = GBTRegressionModel.__init__

    def transform(self, frame: Frame) -> Frame:
        p = self._params
        F = self._score(self._frame_X(frame))
        prob1 = torch.sigmoid(F)
        prob = torch.stack([1.0 - prob1, prob1], dim=1)
        raw = torch.stack([-F, F], dim=1)
        pred = (F > 0).to(float_dtype())
        out = frame.with_column(p.get("raw_prediction_col", "rawPrediction"),
                                raw)
        out = out.with_column(p.get("probability_col", "probability"), prob)
        return out.with_column(p.get("prediction_col", "prediction"), pred)

    def predict(self, features) -> float:
        return float(float(self._score(self._row(features))[0]) > 0)
