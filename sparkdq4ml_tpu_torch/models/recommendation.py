"""ALS collaborative filtering of the port (port of
``sparkdq4ml_tpu/models/recommendation.py``, single device): explicit
ratings (ALS-WR, λ scaled by each entity's rating count) and implicit
feedback (Hu–Koren–Volinsky: preference ``p = [r > 0]``, confidence
``c = 1 + α·|r|``, the shared ``YᵀY`` one (k, k) product), with
``ALSModel``'s cold-start strategies, factor frames, recommendations and
persistence in the JAX package's format.

A half-step solves every entity of one side at once: the normal matrices
``Σ v vᵀ`` and right-hand sides ``Σ r·v`` are fixed-order segment sums
(``ops/segments.py:_seg_sum``, the sorted kernel on the card) over the
ratings' outer products flattened to (nnz, k²), and the solves one batched
``torch.linalg.solve_ex`` (no host read). A fit sorts each side's ratings
by that side's id once (``_by_side``) and builds the gathered factors, the
outer products and the right-hand sides directly in that order, so no
half-step sorts or copies the ratings again; the counts are integer
``bincount``s. The alternation is a Python loop of device steps with no
host read inside; the loss history is read once at the end. The id maps
are ``torch.unique`` of the ids (the JAX package's ``np.unique``: the same
sorted ids and inverse), the initial factors the JAX package's numpy draws
from ``default_rng(seed)``.

``recommendForAllUsers``/``Items`` score ``U @ Vᵀ`` in chunks of rows and
keep ``jax.lax.top_k``'s order: scores descending, and among equal scores
the lower index first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import float_dtype, numpy_dtype, resolve_device
from ..frame.frame import Frame
from ..ops.segments import _seg_sum
from .base import Estimator, Model, no_mesh, persistable

# recommend scores at most this many (row, item) pairs at once: 2^28
# float32 scores (1 GiB) and their int64 keys
RECOMMEND_CHUNK = 1 << 28


class _Side(NamedTuple):
    """One side's view of the ratings, sorted by that side's id (stable):
    ``seg`` the solving side's ids (nondecreasing), ``other`` the other
    side's id of each rating, ``ratings`` and weights ``w`` (None: all
    one) in that order, ``cnt`` the weight an entity (float) and ``size``
    the side's entities."""
    seg: torch.Tensor
    other: torch.Tensor
    ratings: torch.Tensor
    w: Optional[torch.Tensor]
    cnt: torch.Tensor
    size: int


def _by_side(idx_self, idx_other, ratings, n_self: int, w=None) -> _Side:
    order = torch.sort(idx_self.to(torch.int64), stable=True)
    seg = order.values
    pick = order.indices
    ww = None if w is None else w.index_select(0, pick)
    if ww is None:
        cnt = torch.bincount(seg, minlength=n_self).to(ratings.dtype)
    else:
        cnt = _seg_sum(ww, seg, n_self, contiguous=True)
    return _Side(seg, idx_other.to(torch.int64).index_select(0, pick),
                 ratings.index_select(0, pick), ww, cnt, n_self)


def _no_axis(psum_axis) -> None:
    if psum_axis is not None:
        raise NotImplementedError("ALS: reductions over a mesh axis are "
                                  "not ported; the port fits on one device")


def _outer_sums(V, side: _Side, weight):
    """The (size, k, k) sums of ``weight·v vᵀ`` over each entity's
    ratings (``weight`` None: one), as one segment sum of the outer
    products flattened to (nnz, k²)."""
    n, k = V.shape
    outer = V[:, :, None] * V[:, None, :]
    if weight is not None:
        outer.mul_(weight[:, None, None])
    A = _seg_sum(outer.reshape(n, k * k), side.seg, side.size,
                 contiguous=True)
    del outer
    return A.reshape(side.size, k, k)


def _solve(A, b, cnt):
    x = torch.linalg.solve_ex(A, b[:, :, None]).result[:, :, 0]
    return torch.where(cnt[:, None] > 0, x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _explicit_step(factors_other, side: _Side, rank: int, reg: float):
    """The explicit half-step on a sorted side: for every entity e
    ``(Σ v vᵀ + λ·n_e·I) x_e = Σ r·v``; entities without ratings get 0."""
    V = factors_other.index_select(0, side.other)          # (nnz, k)
    r = side.ratings if side.w is None else side.ratings * side.w
    A = _outer_sums(V, side, side.w)
    b = _seg_sum(V * r[:, None], side.seg, side.size, contiguous=True)
    del V
    eye = torch.eye(rank, dtype=A.dtype, device=A.device)
    lam = reg * torch.clamp(side.cnt, min=1.0)
    return _solve(A + lam[:, None, None] * eye, b, side.cnt)


def _implicit_step(factors_other, side: _Side, rank: int, reg: float,
                   alpha: float):
    """The implicit half-step on a sorted side: for every entity e
    ``(YᵀY + Σ (c−1)·v vᵀ + λI) x_e = Σ c·p·v``."""
    YtY = factors_other.T @ factors_other                  # (k, k), shared
    V = factors_other.index_select(0, side.other)
    r = side.ratings
    c1 = alpha * torch.abs(r)                              # c − 1
    p = (r > 0).to(V.dtype)
    scale = c1 if side.w is None else c1 * side.w
    A_extra = _outer_sums(V, side, scale)
    rhs = (1.0 + c1) * p
    if side.w is not None:
        rhs = rhs * side.w
    b = _seg_sum(V * rhs[:, None], side.seg, side.size, contiguous=True)
    del V
    eye = torch.eye(rank, dtype=A_extra.dtype, device=A_extra.device)
    return _solve(YtY[None, :, :] + A_extra + reg * eye, b, side.cnt)


def _als_half_step(factors_other, idx_self, idx_other, ratings, n_self,
                   rank, reg, w=None, psum_axis=None):
    """Solve all of one side's factors given the other side's (the JAX
    package's ``_als_half_step``): ``w`` (nnz,) weights let a rating drop
    out of every statistic."""
    _no_axis(psum_axis)
    return _explicit_step(factors_other,
                          _by_side(idx_self, idx_other, ratings, n_self, w),
                          rank, reg)


def _implicit_half_step(factors_other, idx_self, idx_other, ratings,
                        n_self, rank, reg, alpha, w=None, psum_axis=None):
    """The HKV implicit half-step (the JAX package's
    ``_implicit_half_step``)."""
    _no_axis(psum_axis)
    return _implicit_step(factors_other,
                          _by_side(idx_self, idx_other, ratings, n_self, w),
                          rank, reg, alpha)


def _mean(num, den):
    """``num / max(den, 1)``, ``num`` a fixed-order sum of the rows."""
    total = _seg_sum(num, None, 1)[0]
    return total / torch.clamp(den, min=1.0)


def als_fit(u_idx, i_idx, ratings, U0, V0, n_users: int, n_items: int,
            rank: int, max_iter: int, reg: float, implicit: bool = False,
            alpha: float = 1.0):
    """The alternation on the device of ``U0``: ``max_iter`` pairs of
    half-steps (users, then items) and the loss after each pair, the
    masked squared error (explicit) or the confidence-weighted preference
    loss over the observed entries (implicit). Returns (U, V, loss
    history), all on the device."""
    by_user = _by_side(u_idx, i_idx, ratings, n_users)
    by_item = _by_side(i_idx, u_idx, ratings, n_items)
    r = by_user.ratings
    den = torch.as_tensor(float(r.shape[0]), dtype=r.dtype, device=r.device)
    if implicit:
        p = (r > 0).to(r.dtype)
        c = 1.0 + alpha * torch.abs(r)
    U, V = U0, V0
    history = []
    for _ in range(max_iter):
        if implicit:
            U = _implicit_step(V, by_user, rank, reg, alpha)
            V = _implicit_step(U, by_item, rank, reg, alpha)
        else:
            U = _explicit_step(V, by_user, rank, reg)
            V = _explicit_step(U, by_item, rank, reg)
        pred = torch.sum(U.index_select(0, by_user.seg)
                         * V.index_select(0, by_user.other), dim=1)
        err = (p - pred) ** 2 * c if implicit else (r - pred) ** 2
        history.append(_mean(err, den))
    hist = (torch.stack(history) if history
            else torch.zeros((0,), dtype=r.dtype, device=r.device))
    return U, V, hist


@persistable
class ALS(Estimator):
    """MLlib ``ALS`` and its setters: setRank/setMaxIter/setRegParam/
    setUserCol/setItemCol/setRatingCol/setColdStartStrategy/setSeed."""

    _persist_attrs = ('rank', 'max_iter', 'reg_param', 'user_col',
                      'item_col', 'rating_col', 'prediction_col',
                      'cold_start_strategy', 'implicit_prefs', 'alpha',
                      'seed')

    def __init__(self, rank: int = 10, max_iter: int = 10,
                 reg_param: float = 0.1, user_col: str = "user",
                 item_col: str = "item", rating_col: str = "rating",
                 prediction_col: str = "prediction",
                 cold_start_strategy: str = "nan",
                 implicit_prefs: bool = False, alpha: float = 1.0,
                 seed: int = 0):
        if alpha < 0:
            raise ValueError("alpha must be >= 0")
        if rank < 1:
            raise ValueError("rank must be >= 1")
        if cold_start_strategy not in ("nan", "drop"):
            raise ValueError(f"cold_start_strategy={cold_start_strategy!r}")
        self.rank = int(rank)
        self.max_iter = int(max_iter)
        self.reg_param = float(reg_param)
        self.user_col = user_col
        self.item_col = item_col
        self.rating_col = rating_col
        self.prediction_col = prediction_col
        self.cold_start_strategy = cold_start_strategy
        self.implicit_prefs = bool(implicit_prefs)
        self.alpha = float(alpha)
        self.seed = int(seed)

    def set_implicit_prefs(self, v):
        self.implicit_prefs = bool(v)
        return self

    setImplicitPrefs = set_implicit_prefs

    def set_alpha(self, v):
        if v < 0:
            raise ValueError("alpha must be >= 0")
        self.alpha = float(v)
        return self

    setAlpha = set_alpha

    def set_rank(self, v):
        if v < 1:
            raise ValueError("rank must be >= 1")
        self.rank = int(v)
        return self

    setRank = set_rank

    def set_max_iter(self, v):
        self.max_iter = int(v)
        return self

    setMaxIter = set_max_iter

    def set_reg_param(self, v):
        self.reg_param = float(v)
        return self

    setRegParam = set_reg_param

    def set_user_col(self, v):
        self.user_col = v
        return self

    setUserCol = set_user_col

    def set_item_col(self, v):
        self.item_col = v
        return self

    setItemCol = set_item_col

    def set_rating_col(self, v):
        self.rating_col = v
        return self

    setRatingCol = set_rating_col

    def set_cold_start_strategy(self, v):
        if v not in ("nan", "drop"):
            raise ValueError(f"cold_start_strategy={v!r}")
        self.cold_start_strategy = v
        return self

    setColdStartStrategy = set_cold_start_strategy

    def set_seed(self, v):
        self.seed = int(v)
        return self

    setSeed = set_seed

    def fit(self, frame: Frame, mesh=None) -> "ALSModel":
        no_mesh(mesh, "ALS")
        dt = float_dtype()
        mask = frame.mask
        r_all = frame._column_values(self.rating_col).to(dt)
        valid, bad = torch.stack([
            mask.sum(), (~torch.isfinite(r_all) & mask).sum()]).tolist()
        if valid == 0:
            raise ValueError("ALS: no valid rows")
        if bad:
            raise ValueError("ALS: rating column has NaN/inf in valid rows")
        users = frame._column_values(self.user_col).to(torch.int64)[mask]
        items = frame._column_values(self.item_col).to(torch.int64)[mask]
        ratings = r_all[mask]
        # dense id maps (np.unique's sorted ids and inverse)
        u_ids, u_idx = torch.unique(users, sorted=True, return_inverse=True)
        i_ids, i_idx = torch.unique(items, sorted=True, return_inverse=True)
        n_users, n_items = len(u_ids), len(i_ids)

        ndt = numpy_dtype(dt)
        rng = np.random.default_rng(self.seed)
        # the JAX package's start: N(0,1)/sqrt(k) (Spark: scaled |N(0,1)|)
        U0 = (rng.normal(size=(n_users, self.rank)) / np.sqrt(self.rank)) \
            .astype(ndt)
        V0 = (rng.normal(size=(n_items, self.rank)) / np.sqrt(self.rank)) \
            .astype(ndt)
        dev = frame.device
        U, V, history = als_fit(
            u_idx, i_idx, ratings, torch.as_tensor(U0, device=dev),
            torch.as_tensor(V0, device=dev), n_users, n_items, self.rank,
            self.max_iter, self.reg_param, self.implicit_prefs, self.alpha)
        return ALSModel(U.cpu().numpy(), V.cpu().numpy(),
                        u_ids.cpu().tolist(), i_ids.cpu().tolist(),
                        self._params_dict(),
                        history.to(torch.float64).cpu().tolist(),
                        device=dev)

    def _params_dict(self):
        return {k: getattr(self, k) for k in self._persist_attrs}


def _lookup(ids: np.ndarray):
    """(sorted ids, their rows): ``searchsorted`` finds an id's row as a
    dictionary of ``ids`` would (the last of equal ids)."""
    order = np.argsort(ids, kind="stable")
    return ids[order], order


def top_k_rows(scores: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the ``k`` largest scores of each row in
    ``jax.lax.top_k``'s order: descending, equal scores by the lower
    index. ``torch.topk`` finds the k-th score; the picks are every score
    above it and the lowest-indexed of those equal to it; a stable sort
    of the k picks (taken in index order) orders them."""
    n, m = scores.shape
    scores = scores + 0.0                       # -0.0 → +0.0, as a compare
    kth = torch.topk(scores, k, dim=1).values[:, k - 1:k]
    above = scores > kth
    tied = scores == kth
    room = k - above.sum(1, keepdim=True)
    pick = above | (tied & (torch.cumsum(tied, 1) <= room))
    pos = torch.arange(m, 0, -1, device=scores.device)    # lower index first
    idx = torch.topk(torch.where(pick, pos, 0), k, dim=1).indices
    vals = torch.gather(scores, 1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


@persistable
class ALSModel(Model):
    """User/item factor matrices + the MLlib surface: ``transform`` (rating
    prediction per (user, item) row), ``recommendForAllUsers/Items`` (U @ Vᵀ
    and a top-k in chunks of rows), ``userFactors``/``itemFactors`` frames.
    Computes on ``device``: the one its fit ran on, else the one
    ``config.resolve_device`` gives at each call (the active session's, or
    the card), as after a load; ``transform`` on the frame's. ``predict``
    is one host dot product, as in the JAX package."""

    _persist_attrs = ('user_factors_arr', 'item_factors_arr', 'user_ids',
                      'item_ids', '_params', 'loss_history')

    def __init__(self, user_factors, item_factors, user_ids, item_ids,
                 params=None, loss_history=None, device=None):
        self.user_factors_arr = np.asarray(user_factors)
        self.item_factors_arr = np.asarray(item_factors)
        self.user_ids = list(user_ids)
        self.item_ids = list(item_ids)
        self._params = dict(params or {})
        self.loss_history = list(loss_history or [])
        self._device = None if device is None else torch.device(device)
        self._build_index()

    def _post_load(self):
        self.user_ids = list(self.user_ids)
        self.item_ids = list(self.item_ids)
        self._device = None
        self._build_index()

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def _build_index(self):
        self._u_sorted = _lookup(np.asarray(self.user_ids, np.int64))
        self._i_sorted = _lookup(np.asarray(self.item_ids, np.int64))

    @property
    def rank(self):
        return int(self.user_factors_arr.shape[1])

    def _p(self, key, default=None):
        return self._params.get(key, default)

    def _factors(self, arr, device) -> torch.Tensor:
        return torch.tensor(arr, device=device).to(float_dtype())

    @property
    def user_factors(self) -> Frame:
        dev = self.device
        return Frame({"id": np.asarray(self.user_ids, np.int64),
                      "features": self._factors(self.user_factors_arr, dev)},
                     device=dev)

    userFactors = user_factors

    @property
    def item_factors(self) -> Frame:
        dev = self.device
        return Frame({"id": np.asarray(self.item_ids, np.int64),
                      "features": self._factors(self.item_factors_arr, dev)},
                     device=dev)

    itemFactors = item_factors

    @staticmethod
    def _positions(table, ids: torch.Tensor) -> torch.Tensor:
        """Each id's row in the factor table, -1 for an id the fit never
        saw."""
        sorted_ids, order = (torch.as_tensor(a, device=ids.device)
                             for a in table)
        if sorted_ids.numel() == 0:
            return torch.full_like(ids, -1)
        at = torch.searchsorted(sorted_ids, ids, right=True) - 1
        safe = at.clamp(min=0)
        hit = (at >= 0) & (sorted_ids.index_select(0, safe) == ids)
        return torch.where(hit, order.index_select(0, safe), -1)

    def transform(self, frame: Frame) -> Frame:
        dev = frame.device
        users = frame._column_values(self._p("user_col", "user")).to(
            torch.int64)
        items = frame._column_values(self._p("item_col", "item")).to(
            torch.int64)
        u_pos = self._positions(self._u_sorted, users)
        i_pos = self._positions(self._i_sorted, items)
        known = (u_pos >= 0) & (i_pos >= 0)
        U = self._factors(self.user_factors_arr, dev)
        V = self._factors(self.item_factors_arr, dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        pred = torch.sum(U.index_select(0, torch.where(known, u_pos, zero))
                         * V.index_select(0, torch.where(known, i_pos, zero)),
                         dim=1)
        pred = torch.where(known, pred, torch.full((), float("nan"),
                                                   dtype=pred.dtype,
                                                   device=dev))
        out = frame.with_column(self._p("prediction_col", "prediction"),
                                pred)
        if self._p("cold_start_strategy", "nan") == "drop":
            out = out.filter(known)
        return out

    def predict(self, user: int, item: int) -> float:
        u, v = (int(self._positions(table, torch.tensor([int(key)]))[0])
                for table, key in ((self._u_sorted, user),
                                   (self._i_sorted, item)))
        if u < 0 or v < 0:
            return float("nan")
        return float(self.user_factors_arr[u] @ self.item_factors_arr[v])

    def _top_k(self, F_for, F_items, num: int) -> tuple:
        """(scores, item rows) of the ``num`` best items of each row of
        ``F_for`` (at most all of them), on the model's device: ``U @ Vᵀ``
        and ``top_k_rows`` over chunks of rows."""
        dev = self.device
        A = self._factors(F_for, dev)
        B = self._factors(F_items, dev)
        n, m = A.shape[0], B.shape[0]
        k = min(num, m)
        vals = torch.zeros((n, k), dtype=A.dtype, device=dev)
        idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
        if k > 0:
            step = max(1, RECOMMEND_CHUNK // max(m, 1))
            for s in range(0, n, step):
                vals[s:s + step], idx[s:s + step] = top_k_rows(
                    A[s:s + step] @ B.T, k)
        return vals, idx

    def _recommend(self, F_for, F_items, ids_for, ids_items, num: int,
                   col_for: str, col_items: str) -> Frame:
        vals, idx = self._top_k(F_for, F_items, num)
        n = vals.shape[0]
        top_ids = np.asarray(ids_items, np.int64)[idx.cpu().numpy()].tolist()
        top_scores = vals.cpu().numpy().tolist()
        recs = np.empty(n, dtype=object)
        for i in range(n):
            recs[i] = list(zip(top_ids[i], top_scores[i]))
        return Frame({col_for: np.asarray(ids_for, np.int64),
                      "recommendations": recs}, device=vals.device)

    def recommend_for_all_users(self, num_items: int) -> Frame:
        """Top ``num_items`` items per user."""
        return self._recommend(self.user_factors_arr, self.item_factors_arr,
                               self.user_ids, self.item_ids, num_items,
                               self._p("user_col", "user"), "item")

    recommendForAllUsers = recommend_for_all_users

    def recommend_for_all_items(self, num_users: int) -> Frame:
        return self._recommend(self.item_factors_arr, self.user_factors_arr,
                               self.item_ids, self.user_ids, num_users,
                               self._p("item_col", "item"), "user")

    recommendForAllItems = recommend_for_all_items
