"""Clustering: KMeans, GaussianMixture, BisectingKMeans and
PowerIterationClustering (port of ``sparkdq4ml_tpu/models/clustering.py``,
single device).

* **Lloyd's step.** Squared distances use ‖x−c‖² = ‖x‖² − 2·x·cᵀ + ‖c‖²,
  one (n, k) ``torch.matmul`` an iteration (the reference computes it
  without Pallas), then the first-minimum ``argmin``. The per-cluster
  coordinate sums, weights and cost are one fixed-order segment sum over
  ``k`` slots (``ops/segments.py:_seg_sum``: the ``dense_segment_sum``
  kernel on the card), where the reference multiplies by a one-hot matrix:
  these sums decide convergence, so they add in a fixed order.
* **The loops are Python loops** over device steps that read their latch
  once an iteration, the port's rule for the reference's
  ``lax.while_loop``.
* **Seeding on the host** with numpy's ``default_rng(seed)``, the
  reference's draws: ``k-means||`` and ``k-means++`` both mean the greedy
  k-means++ seeding, ``random`` distinct valid rows.
* **Masked rows never vote**; empty clusters keep their previous center.

GaussianMixture's E-step is Cholesky log-densities and ``resp.T @ X``
products (``torch.matmul``); BisectingKMeans reuses the masked 2-means on
the full rows with per-cluster weights; PowerIterationClustering power-
iterates a dense (n, n) affinity matrix whose duplicate edges add in a
fixed order through the segment sum. The mesh branches are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import float_dtype
from ..frame.frame import Frame
from ..ops.segments import _seg_sum
from ..utils import prng
from ..utils.prng import uniform_like_jax  # noqa: F401 - PIC's start draw
from .base import Estimator, Model, feature_matrix, no_mesh, persistable


def _masked_rows(frame: Frame, name: str):
    """(X with masked slots zeroed, the 0/1 weight) on the frame's device:
    masked slots may hold NaN, and 0·NaN would poison the sums."""
    X = feature_matrix(frame, name)
    w = frame.mask.to(X.dtype)
    return torch.where(w[:, None] > 0, X, torch.zeros_like(X)), w


def _sq_distances(X, centers):
    """(n, k) ‖x‖² − 2·x·cᵀ + ‖c‖²."""
    x_sq = torch.sum(X * X, dim=1, keepdim=True)
    c_sq = torch.sum(centers * centers, dim=1)
    return x_sq - 2.0 * (X @ centers.T) + c_sq[None, :]


def _lloyd_step(X, w, centers):
    """One Lloyd iteration's sufficient statistics: per-cluster weighted
    coordinate sums (k, d), weights (k,) and the weighted SSE, from one
    fixed-order segment sum over k slots."""
    d2 = _sq_distances(X, centers)
    assign = torch.argmin(d2, dim=1)        # the first minimum
    best = d2.gather(1, assign[:, None])[:, 0]
    cost = torch.clamp(best, min=0.0) * w
    table = _seg_sum(torch.cat([X * w[:, None], w[:, None], cost[:, None]],
                               dim=1), assign, centers.shape[0])
    d = X.shape[1]
    return table[:, :d], table[:, d], torch.sum(table[:, d + 1])


def lloyd(X, w, centers0, max_iter: int, tol: float):
    """KMeans' Lloyd loop: ``(centers, cost, iterations, counts)`` with the
    cost and counts of one last pass at the final centers."""
    centers = centers0
    it, shift = 0, math.inf
    while it < max_iter and shift > tol * tol:
        sums, counts, _ = _lloyd_step(X, w, centers)
        safe = torch.clamp(counts, min=1e-12)[:, None]
        new = torch.where(counts[:, None] > 0, sums / safe, centers)
        step = torch.max(torch.sum((new - centers) ** 2, dim=1))
        centers, it = new, it + 1
        shift = float(step)
    _, counts, cost = _lloyd_step(X, w, centers)
    return centers, cost, it, counts


def _kmeans_pp_init(X, w, k, rng):
    """Greedy k-means++ seeding on the host: the first center uniform over
    the valid rows, each next one drawn ∝ the current squared distance."""
    valid = np.flatnonzero(w > 0)
    if len(valid) < k:
        raise ValueError(f"k={k} exceeds the {len(valid)} valid rows")
    centers = [X[rng.choice(valid)]]
    d2 = None
    for _ in range(k - 1):
        diff = X[valid] - centers[-1]
        nd2 = np.sum(diff * diff, axis=1)
        d2 = nd2 if d2 is None else np.minimum(d2, nd2)
        total = d2.sum()
        if total <= 0:          # all remaining mass at existing centers
            extra = rng.choice(valid, size=k - len(centers), replace=False)
            centers.extend(X[i] for i in extra)
            break
        centers.append(X[valid[rng.choice(len(valid), p=d2 / total)]])
    return np.stack(centers[:k])


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@persistable
class KMeans(Estimator):
    """MLlib ``KMeans`` surface: ``setK/setMaxIter/setTol/setSeed/
    setInitMode/setFeaturesCol/setPredictionCol`` + ``fit(frame)``."""

    _persist_attrs = ('k', 'max_iter', 'tol', 'seed', 'init_mode',
                      'features_col', 'prediction_col')

    def __init__(self, k: int = 2, max_iter: int = 20, tol: float = 1e-4,
                 seed: int = 0, init_mode: str = "k-means||",
                 features_col: str = "features",
                 prediction_col: str = "prediction"):
        if k < 1:
            raise ValueError("k must be >= 1")
        if init_mode not in ("k-means||", "k-means++", "random"):
            raise ValueError(f"init_mode={init_mode!r}")
        self.k = int(k)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.seed = int(seed)
        self.init_mode = init_mode
        self.features_col = features_col
        self.prediction_col = prediction_col

    def set_k(self, v):
        if v < 1:
            raise ValueError("k must be >= 1")
        self.k = int(v)
        return self

    setK = set_k

    def set_max_iter(self, v):
        self.max_iter = int(v)
        return self

    setMaxIter = set_max_iter

    def set_tol(self, v):
        self.tol = float(v)
        return self

    setTol = set_tol

    def set_seed(self, v):
        self.seed = int(v)
        return self

    setSeed = set_seed

    def set_init_mode(self, v):
        if v not in ("k-means||", "k-means++", "random"):
            raise ValueError(f"init_mode={v!r}")
        self.init_mode = v
        return self

    setInitMode = set_init_mode

    def set_features_col(self, v):
        self.features_col = v
        return self

    setFeaturesCol = set_features_col

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    setPredictionCol = set_prediction_col

    def get_k(self):
        return self.k

    getK = get_k

    def fit(self, frame: Frame, mesh=None) -> "KMeansModel":
        no_mesh(mesh, "KMeans")
        X, w = _masked_rows(frame, self.features_col)
        Xh, wh = _host(X), _host(w)
        rng = np.random.default_rng(self.seed)
        if self.init_mode == "random":
            valid = np.flatnonzero(wh > 0)
            if len(valid) < self.k:
                raise ValueError(
                    f"k={self.k} exceeds the {len(valid)} valid rows")
            centers0 = Xh[rng.choice(valid, size=self.k, replace=False)]
        else:   # k-means|| / k-means++: greedy k-means++ seeding
            centers0 = _kmeans_pp_init(Xh, wh, self.k, rng)
        centers, cost, iters, counts = lloyd(
            X, w, torch.as_tensor(centers0, device=X.device), self.max_iter,
            self.tol)
        return KMeansModel(_host(centers), self.features_col,
                           self.prediction_col, float(cost), int(iters),
                           _host(counts).astype(np.int64).tolist())


@persistable
class KMeansModel(Model):
    """Fitted centers and the MLlib model surface: ``transform`` (nearest
    center as the prediction column), ``clusterCenters``, ``summary``,
    ``predict`` and ``compute_cost``."""

    _persist_attrs = ('centers', 'features_col', 'prediction_col',
                      'training_cost', 'num_iters', 'cluster_sizes')

    def __init__(self, centers, features_col, prediction_col,
                 training_cost=float("nan"), num_iters=0,
                 cluster_sizes=None):
        self.centers = np.asarray(centers)
        self.features_col = features_col
        self.prediction_col = prediction_col
        self.training_cost = training_cost
        self.num_iters = num_iters
        self.cluster_sizes = cluster_sizes or []

    def cluster_centers(self):
        return [c for c in self.centers]

    clusterCenters = cluster_centers

    @property
    def k(self):
        return self.centers.shape[0]

    def _distances(self, X):
        C = torch.as_tensor(self.centers, device=X.device).to(X.dtype)
        return _sq_distances(X, C)

    def transform(self, frame: Frame) -> Frame:
        X = feature_matrix(frame, self.features_col)
        pred = torch.argmin(self._distances(X), dim=1).to(float_dtype())
        return frame.with_column(self.prediction_col, pred)

    def predict(self, features) -> int:
        x = torch.as_tensor(np.asarray(features).reshape(1, -1),
                            dtype=float_dtype())
        return int(torch.argmin(self._distances(x)))

    def compute_cost(self, frame: Frame) -> float:
        """Weighted SSE to the nearest center over the valid rows."""
        X = feature_matrix(frame, self.features_col)
        w = frame.mask.to(X.dtype)
        best = torch.min(self._distances(X), dim=1).values
        return float(torch.sum(torch.clamp(best, min=0.0) * w))

    computeCost = compute_cost

    @property
    def summary(self):
        return KMeansSummary(self)

    @property
    def has_summary(self):
        return True

    hasSummary = has_summary


class KMeansSummary:
    """MLlib ``KMeansSummary``: k, cluster sizes, training cost, iterations."""

    def __init__(self, model):
        self._model = model

    @property
    def k(self):
        return self._model.k

    @property
    def cluster_sizes(self):
        return list(self._model.cluster_sizes)

    clusterSizes = cluster_sizes

    @property
    def training_cost(self):
        return self._model.training_cost

    trainingCost = training_cost

    @property
    def num_iter(self):
        return self._model.num_iters

    numIter = num_iter


# ---------------------------------------------------------------------------
# GaussianMixture
# ---------------------------------------------------------------------------

def _gmm_log_prob(X, means, chols):
    """(n, k) log N(x | mean_j, cov_j) from per-component lower Cholesky
    factors ``chols`` (k, d, d)."""
    d = X.shape[1]
    log2pi = math.log(2.0 * math.pi)
    cols = []
    for mean, chol in zip(means, chols):
        diff = (X - mean[None, :]).T                       # (d, n)
        z = torch.linalg.solve_triangular(chol, diff, upper=False)
        maha = torch.sum(z * z, dim=0)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        cols.append(-0.5 * (d * log2pi + logdet + maha))
    return torch.stack(cols, dim=1)


def _gmm_estep(X, w, weights, means, chols):
    """E-step sufficient statistics: Nk (k,), Sk (k, d), the raw scatters
    Ck (k, d, d) = Σ r·x·xᵀ and the weighted log-likelihood."""
    logp = _gmm_log_prob(X, means, chols) + torch.log(weights)[None, :]
    lse = torch.logsumexp(logp, dim=1)
    resp = torch.exp(logp - lse[:, None]) * w[:, None]
    Nk = torch.sum(resp, dim=0)
    Sk = resp.T @ X
    Ck = torch.stack([(X * r[:, None]).T @ X for r in resp.T])
    ll = torch.sum(lse * w)
    return Nk, Sk, Ck, ll


def _cholesky(covs, reg: float):
    d = covs.shape[-1]
    eye = torch.eye(d, dtype=covs.dtype, device=covs.device)
    return torch.linalg.cholesky(covs + reg * eye[None])


def gmm_em(X, w, n, weights, means, covs, max_iter: int, tol: float,
           reg: float):
    """The EM loop: one host read of |Δll| an iteration."""
    ll = torch.full((), -math.inf, dtype=X.dtype, device=X.device)
    it, delta = 0, math.inf
    while it < max_iter and delta > tol:
        Nk, Sk, Ck, new_ll = _gmm_estep(X, w, weights, means,
                                        _cholesky(covs, reg))
        safe = torch.clamp(Nk, min=1e-12)
        means = Sk / safe[:, None]
        covs = Ck / safe[:, None, None] - means[:, :, None] * means[:, None, :]
        weights = Nk / n
        step = torch.abs(new_ll - ll)
        ll, it = new_ll, it + 1
        delta = float(step)
    return weights, means, covs, ll, it


@persistable
class GaussianMixture(Estimator):
    """MLlib ``GaussianMixture``: full-covariance GMM fit by EM."""

    _persist_attrs = ('k', 'max_iter', 'tol', 'seed', 'reg',
                      'features_col', 'prediction_col', 'probability_col')

    def __init__(self, k: int = 2, max_iter: int = 100, tol: float = 0.01,
                 seed: int = 0, reg: float = 1e-6,
                 features_col: str = "features",
                 prediction_col: str = "prediction",
                 probability_col: str = "probability"):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = int(k)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.seed = int(seed)
        self.reg = float(reg)
        self.features_col = features_col
        self.prediction_col = prediction_col
        self.probability_col = probability_col

    def set_k(self, v):
        if v < 1:
            raise ValueError("k must be >= 1")
        self.k = int(v)
        return self

    setK = set_k

    def set_max_iter(self, v):
        self.max_iter = int(v)
        return self

    setMaxIter = set_max_iter

    def set_tol(self, v):
        self.tol = float(v)
        return self

    setTol = set_tol

    def set_seed(self, v):
        self.seed = int(v)
        return self

    setSeed = set_seed

    def set_features_col(self, v):
        self.features_col = v
        return self

    setFeaturesCol = set_features_col

    def fit(self, frame: Frame, mesh=None) -> "GaussianMixtureModel":
        no_mesh(mesh, "GaussianMixture")
        X, w = _masked_rows(frame, self.features_col)
        Xh, wh = _host(X), _host(w)
        n_valid = float(wh.sum())
        if n_valid < self.k:
            raise ValueError(
                f"k={self.k} exceeds the {int(n_valid)} valid rows")
        # init (the reference's, on the host): k-means++ means, the data's
        # shared diagonal covariance, uniform weights
        dt = Xh.dtype
        rng = np.random.default_rng(self.seed)
        means0 = _kmeans_pp_init(Xh, wh, self.k, rng).astype(dt)
        mu = (wh @ Xh) / n_valid
        var = (wh @ (Xh * Xh)) / n_valid - mu * mu
        covs0 = np.tile(np.diag(np.maximum(var, 1e-6)).astype(dt),
                        (self.k, 1, 1))
        weights0 = np.full((self.k,), 1.0 / self.k, dt)
        dev = X.device
        weights, means, covs, ll, iters = gmm_em(
            X, w, torch.tensor(n_valid, dtype=X.dtype, device=dev),
            torch.as_tensor(weights0, device=dev),
            torch.as_tensor(means0, device=dev),
            torch.as_tensor(covs0, device=dev), self.max_iter, self.tol,
            self.reg)
        f64 = lambda t: _host(t.to(torch.float64))
        return GaussianMixtureModel(
            f64(weights), f64(means), f64(covs), self._params_dict(),
            log_likelihood=float(ll), num_iters=int(iters))

    def _params_dict(self):
        return {k: getattr(self, k) for k in (
            "k", "max_iter", "tol", "seed", "reg", "features_col",
            "prediction_col", "probability_col")}


@persistable
class GaussianMixtureModel(Model):
    """Fitted mixture: ``weights`` (k,), per-component ``gaussians``
    (mean, cov); ``transform`` appends the posterior probability vector
    and the argmax prediction."""

    _persist_attrs = ('weights', 'means', 'covs', '_params',
                      'log_likelihood', 'num_iters')

    def __init__(self, weights, means, covs, params=None,
                 log_likelihood=float("nan"), num_iters=0):
        self.weights = np.asarray(weights)
        self.means = np.asarray(means)
        self.covs = np.asarray(covs)
        self._params = dict(params or {})
        self.log_likelihood = log_likelihood
        self.num_iters = num_iters

    @property
    def k(self):
        return int(self.weights.shape[0])

    getK = k

    @property
    def gaussians(self):
        return [{"mean": self.means[j], "cov": self.covs[j]}
                for j in range(self.k)]

    @property
    def gaussians_df(self) -> Frame:
        """MLlib's ``gaussiansDF``: one row per component, its cells host
        arrays (so the frame, mask included, lives on the CPU)."""
        def cells(arrays):
            out = np.empty(len(arrays), dtype=object)
            out[:] = list(arrays)
            return out

        return Frame({"mean": cells(self.means), "cov": cells(self.covs)},
                     device="cpu")

    gaussiansDF = gaussians_df

    def _posterior(self, X):
        dt, dev = X.dtype, X.device
        reg = self._params.get("reg", 1e-6)
        on = lambda a: torch.as_tensor(a, device=dev).to(dt)
        chols = _cholesky(on(self.covs), reg)
        logp = _gmm_log_prob(X, on(self.means), chols) \
            + torch.log(on(self.weights))[None, :]
        return torch.softmax(logp, dim=1)

    def transform(self, frame: Frame) -> Frame:
        p = self._params
        X = feature_matrix(frame, p.get("features_col", "features"))
        post = self._posterior(X)
        pred = torch.argmax(post, dim=1).to(float_dtype())
        out = frame.with_column(p.get("probability_col", "probability"),
                                post)
        return out.with_column(p.get("prediction_col", "prediction"), pred)

    def _row(self, features):
        return torch.as_tensor(np.asarray(features, np.float64)
                               .reshape(1, -1), dtype=float_dtype())

    def predict(self, features) -> int:
        return int(torch.argmax(self._posterior(self._row(features)),
                                dim=1)[0])

    def predict_probability(self, features) -> np.ndarray:
        return self._posterior(self._row(features))[0].numpy()

    predictProbability = predict_probability

    @property
    def summary(self):
        return GaussianMixtureSummary(self)

    @property
    def has_summary(self):
        return True

    hasSummary = has_summary


class GaussianMixtureSummary:
    """MLlib ``GaussianMixtureSummary``: logLikelihood and iterations."""

    def __init__(self, model: GaussianMixtureModel):
        self._model = model

    @property
    def log_likelihood(self):
        return self._model.log_likelihood

    logLikelihood = log_likelihood

    @property
    def num_iter(self):
        return self._model.num_iters

    numIter = num_iter

    @property
    def k(self):
        return self._model.k


# ---------------------------------------------------------------------------
# BisectingKMeans
# ---------------------------------------------------------------------------

@persistable
class BisectingKMeans(Estimator):
    """MLlib ``BisectingKMeans``: divisive hierarchical clustering, the
    largest divisible cluster bisected first by a 2-means run until there
    are ``k`` leaves. Every bisection runs the masked 2-means (``lloyd``)
    on the full rows with the cluster's weight vector; the split loop
    itself is on the host."""

    _persist_attrs = ('k', 'max_iter', 'tol', 'seed',
                      'min_divisible_cluster_size', 'features_col',
                      'prediction_col')

    def __init__(self, k: int = 4, max_iter: int = 20, tol: float = 1e-4,
                 seed: int = 0, min_divisible_cluster_size: float = 1.0,
                 features_col: str = "features",
                 prediction_col: str = "prediction"):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = int(k)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.seed = int(seed)
        self.min_divisible_cluster_size = float(min_divisible_cluster_size)
        self.features_col = features_col
        self.prediction_col = prediction_col

    def set_k(self, v):
        if v < 1:
            raise ValueError("k must be >= 1")
        self.k = int(v)
        return self

    setK = set_k

    def set_max_iter(self, v):
        self.max_iter = int(v)
        return self

    setMaxIter = set_max_iter

    def set_seed(self, v):
        self.seed = int(v)
        return self

    setSeed = set_seed

    def set_min_divisible_cluster_size(self, v):
        self.min_divisible_cluster_size = float(v)
        return self

    setMinDivisibleClusterSize = set_min_divisible_cluster_size

    def set_features_col(self, v):
        self.features_col = v
        return self

    setFeaturesCol = set_features_col

    def fit(self, frame: Frame, mesh=None) -> "BisectingKMeansModel":
        no_mesh(mesh, "BisectingKMeans")
        X, w = _masked_rows(frame, self.features_col)
        Xh, wh = _host(X), _host(w)
        n_valid = int(wh.sum())
        if n_valid < self.k:
            raise ValueError(f"k={self.k} exceeds the {n_valid} valid rows")
        rng = np.random.default_rng(self.seed)
        dev, dt = X.device, X.dtype

        centers = [(wh @ Xh) / max(wh.sum(), 1e-12)]
        left, right = [-1], [-1]
        assign = torch.zeros(X.shape[0], dtype=torch.int64, device=dev)
        assign_h = np.zeros(X.shape[0], np.int64)
        leaf_sizes = {0: n_valid}
        min_size = self.min_divisible_cluster_size
        if min_size <= 1.0:
            min_size = min_size * n_valid if min_size < 1.0 else 1.0
        undivisible: set[int] = set()

        while len(leaf_sizes) < self.k:
            divisible = [(sz, nid) for nid, sz in leaf_sizes.items()
                         if nid not in undivisible and sz >= max(min_size, 2)]
            if not divisible:
                break
            _, nid = max(divisible)                    # largest first
            sel_h = (assign_h == nid) & (wh > 0)
            wc_h = np.where(sel_h, wh, 0.0).astype(Xh.dtype)
            try:
                c0 = _kmeans_pp_init(Xh, wc_h, 2, rng)
            except ValueError:
                undivisible.add(nid)
                continue
            sel = (assign == nid) & (w > 0)
            wc = torch.where(sel, w, torch.zeros_like(w))
            c, _, _, counts = lloyd(X, wc, torch.as_tensor(c0, device=dev),
                                    self.max_iter, self.tol)
            if float(counts.min()) < 1:                # degenerate split
                undivisible.add(nid)
                continue
            # the children of this cluster's rows, nearer center first
            d2 = torch.stack([torch.sum((X - c[j]) ** 2, dim=1)
                              for j in range(2)], dim=1)
            to_left = torch.argmin(d2, dim=1) == 0
            lid, rid = len(centers), len(centers) + 1
            ch = _host(c)
            centers.extend([ch[0], ch[1]])
            left.extend([-1, -1])
            right.extend([-1, -1])
            left[nid], right[nid] = lid, rid
            assign = torch.where(sel, torch.where(to_left, lid, rid), assign)
            assign_h = _host(assign)
            del leaf_sizes[nid]
            n_left = int((sel & to_left).sum())
            leaf_sizes[lid] = n_left
            leaf_sizes[rid] = int(sel_h.sum()) - n_left

        model = BisectingKMeansModel(
            np.stack(centers), np.asarray(left, np.int64),
            np.asarray(right, np.int64), self.features_col,
            self.prediction_col)
        # training cost: SSE of the valid rows to their leaf center
        leaf_center = torch.as_tensor(np.stack(centers), device=dev
                                      ).to(dt)[assign]
        model.training_cost = float(
            torch.sum(torch.sum((X - leaf_center) ** 2, dim=1) * w))
        model.cluster_sizes = [leaf_sizes[nid] for nid in sorted(leaf_sizes)]
        return model


@persistable
class BisectingKMeansModel(Model):
    """Binary cluster tree: prediction walks from the root to a leaf,
    taking the nearer child center at each internal node."""

    _persist_attrs = ('node_centers', 'left', 'right', 'features_col',
                      'prediction_col', 'training_cost', 'cluster_sizes')

    def __init__(self, node_centers, left, right, features_col="features",
                 prediction_col="prediction", training_cost=float("nan"),
                 cluster_sizes=None):
        self.node_centers = np.asarray(node_centers)
        self.left = np.asarray(left, np.int64)
        self.right = np.asarray(right, np.int64)
        self.features_col = features_col
        self.prediction_col = prediction_col
        self.training_cost = training_cost
        self.cluster_sizes = list(cluster_sizes or [])
        self.num_iters = 0
        self._post_load()

    def _post_load(self):
        """Rebuild the leaf index (derived state) after ``load_stage``."""
        self.left = np.asarray(self.left, np.int64)
        self.right = np.asarray(self.right, np.int64)
        self.node_centers = np.asarray(self.node_centers)
        if not hasattr(self, "num_iters"):
            self.num_iters = 0
        self._leaves = np.flatnonzero(self.left < 0)
        self._leaf_index = np.full(len(self.left), -1, np.int64)
        self._leaf_index[self._leaves] = np.arange(len(self._leaves))
        depth = np.zeros(len(self.left), np.int64)
        for nid in range(len(self.left) - 1, -1, -1):   # children have
            if self.left[nid] >= 0:                     # larger ids
                depth[nid] = 1 + max(depth[self.left[nid]],
                                     depth[self.right[nid]])
        self._depth = int(depth[0]) if len(depth) else 0

    @property
    def k(self):
        return len(self._leaves)

    def cluster_centers(self):
        return [self.node_centers[i] for i in self._leaves]

    clusterCenters = cluster_centers

    def _predict_nodes(self, X):
        """(n,) leaf node id per row: at most ``_depth`` descent steps."""
        dev = X.device
        C = torch.as_tensor(self.node_centers, device=dev).to(X.dtype)
        L = torch.as_tensor(self.left, device=dev)
        R = torch.as_tensor(self.right, device=dev)
        node = torch.zeros(X.shape[0], dtype=torch.int64, device=dev)
        for _ in range(self._depth):
            lft, rgt = L[node], R[node]
            dl = torch.sum((X - C[torch.clamp(lft, min=0)]) ** 2, dim=1)
            dr = torch.sum((X - C[torch.clamp(rgt, min=0)]) ** 2, dim=1)
            nxt = torch.where(dl <= dr, lft, rgt)
            node = torch.where(lft < 0, node, nxt)
        return node

    def transform(self, frame: Frame) -> Frame:
        X = feature_matrix(frame, self.features_col)
        index = torch.as_tensor(self._leaf_index, device=X.device)
        pred = index[self._predict_nodes(X)].to(float_dtype())
        return frame.with_column(self.prediction_col, pred)

    def predict(self, features) -> int:
        x = torch.as_tensor(np.asarray(features, np.float64).reshape(1, -1),
                            dtype=float_dtype())
        return int(self._leaf_index[int(self._predict_nodes(x)[0])])

    def compute_cost(self, frame: Frame) -> float:
        X = feature_matrix(frame, self.features_col)
        w = frame.mask.to(X.dtype)
        C = torch.as_tensor(self.node_centers, device=X.device).to(X.dtype)
        nodes = self._predict_nodes(X)
        return float(torch.sum(torch.sum((X - C[nodes]) ** 2, dim=1) * w))

    computeCost = compute_cost

    @property
    def summary(self):
        return KMeansSummary(self)

    @property
    def has_summary(self):
        return True

    hasSummary = has_summary


# ---------------------------------------------------------------------------
# PowerIterationClustering
# ---------------------------------------------------------------------------

@persistable
class PowerIterationClustering(Estimator):
    """MLlib ``PowerIterationClustering``: cluster the nodes of a weighted
    similarity graph by power-iterating the degree-normalized affinity
    matrix to a 1-D embedding, then running k-means on it (Lin & Cohen).

    The affinity matrix is dense (n, n) on the device; its duplicate and
    reverse entries add in a fixed order (one segment sum over n² slots),
    and each power step is one matvec. ``assign_clusters(frame)`` returns
    ``Frame(id, cluster)`` over the ``src``/``dst``/``weight`` columns,
    ids ascending; ``init_mode`` is ``"random"`` (JAX's uniform draw,
    ``utils/prng.py``) or ``"degree"``."""

    _persist_attrs = ('k', 'max_iter', 'init_mode', 'src_col', 'dst_col',
                      'weight_col', 'seed')

    def __init__(self, k: int = 2, max_iter: int = 20,
                 init_mode: str = "random", src_col: str = "src",
                 dst_col: str = "dst", weight_col: str = "weight",
                 seed: int = 0):
        if k < 2:
            raise ValueError("k must be >= 2")
        if init_mode not in ("random", "degree"):
            raise ValueError(f"init_mode must be random or degree, "
                             f"got {init_mode!r}")
        self.k = int(k)
        self.max_iter = int(max_iter)
        self.init_mode = init_mode
        self.src_col = src_col
        self.dst_col = dst_col
        self.weight_col = weight_col
        self.seed = int(seed)

    def set_k(self, v):
        if v < 2:
            raise ValueError("k must be >= 2")
        self.k = int(v)
        return self

    setK = set_k

    def set_max_iter(self, v):
        self.max_iter = int(v)
        return self

    setMaxIter = set_max_iter

    def set_init_mode(self, v):
        if v not in ("random", "degree"):
            raise ValueError(f"init_mode must be random or degree, got {v!r}")
        self.init_mode = v
        return self

    setInitMode = set_init_mode

    def set_src_col(self, v):
        self.src_col = v
        return self

    setSrcCol = set_src_col

    def set_dst_col(self, v):
        self.dst_col = v
        return self

    setDstCol = set_dst_col

    def set_weight_col(self, v):
        self.weight_col = v
        return self

    setWeightCol = set_weight_col

    def set_seed(self, v):
        self.seed = int(v)
        return self

    setSeed = set_seed

    def affinity_entries(self, frame: Frame):
        """(ids, values, slots) of the affinity's one segment sum, on the
        frame's device: each edge's weight at ``src·n + dst`` and again at
        ``dst·n + src`` (zero for a self-loop), in the reference's order."""
        dt, dev = float_dtype(), frame.device
        d = frame.to_pydict()
        src = np.asarray(d[self.src_col], np.int64)
        dst = np.asarray(d[self.dst_col], np.int64)
        w = (np.asarray(d[self.weight_col], np.float64)
             if self.weight_col in frame.columns
             else np.ones(len(src), np.float64))
        if np.any(w < 0):
            raise ValueError("similarity weights must be nonnegative")
        ids = np.unique(np.concatenate([src, dst]))
        n = len(ids)
        if n < self.k:
            raise ValueError(f"k={self.k} exceeds node count {n}")
        si = np.searchsorted(ids, src)
        di = np.searchsorted(ids, dst)
        wd = torch.as_tensor(w, device=dev).to(dt)
        vals = torch.cat([wd, torch.where(
            torch.as_tensor(si == di, device=dev), torch.zeros_like(wd), wd)])
        slots = torch.as_tensor(np.concatenate([si * n + di, di * n + si]),
                                device=dev)
        return ids, vals, slots

    def affinity(self, frame: Frame):
        """(ids, dense symmetric affinity W (n, n), on the frame's
        device): duplicate and reverse entries add (self-loops once), in
        the reference's order, through one fixed-order segment sum."""
        ids, vals, slots = self.affinity_entries(frame)
        n = len(ids)
        return ids, _seg_sum(vals, slots, n * n).reshape(n, n)

    def assign_clusters(self, frame: Frame, mesh=None) -> Frame:
        no_mesh(mesh, "PowerIterationClustering")
        dt = float_dtype()
        ids, W = self.affinity(frame)
        n = len(ids)
        deg = torch.sum(W, dim=1)
        one = torch.ones((), dtype=dt, device=W.device)
        zero = torch.zeros((), dtype=dt, device=W.device)
        inv_deg = torch.where(deg > 0, 1.0 / torch.where(deg > 0, deg, one),
                              zero)
        vol = torch.sum(deg)
        if self.init_mode == "degree":
            v = deg / torch.where(vol > 0, vol, one)
        else:
            u = prng.uniform(prng.PRNGKey(self.seed, W.device), (n,), dt)
            v = u / torch.clamp(torch.sum(torch.abs(u)), min=1e-30)
        for _ in range(self.max_iter):
            nv = inv_deg * (W @ v)
            v = nv / torch.clamp(torch.sum(torch.abs(nv)), min=1e-30)
        km = KMeans(k=self.k, max_iter=30, seed=self.seed,
                    init_mode="k-means++", features_col="features",
                    prediction_col="cluster")
        emb = Frame({"features": v.reshape(n, 1)}, device=W.device)
        model = km.fit(emb)
        cluster = model.transform(emb)._column_values("cluster")
        return Frame({"id": ids, "cluster": _host(cluster).astype(np.int64)},
                     device=W.device)

    assignClusters = assign_clusters
