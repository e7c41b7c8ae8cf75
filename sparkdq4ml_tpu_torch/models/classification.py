"""The classification family of the port (port of
``sparkdq4ml_tpu/models/classification.py``, single device):
``LogisticRegression`` (binomial and multinomial, FISTA for elastic-net
penalties, damped Newton for L1-free ones), ``LinearSVC`` (squared hinge on
FISTA), ``NaiveBayes`` (multinomial and bernoulli) and ``OneVsRest``, with
their models, summaries and persistence in the JAX package's format.

Numeric convention (MLlib's): features scaled by their sample std without
centering; the intercept fit unpenalized; mean log-loss (softmax
cross-entropy, squared hinge) objective with ``effectiveRegParam =
regParam``; with ``standardization=False`` the penalty lands on the raw
coefficients (L1 weight 1/σ, L2 weight 1/σ²).

Every fit packs the frame's valid rows into one design on the frame's
device (``Z = [X, y, 1]·mask``, or ``[X, y, w]·mask`` when weighted) and
runs its solver there; the result comes back as one flat tensor, read to
the host once. The reference runs each solver as one ``lax.while_loop``
that stops at convergence. Here the loop is a Python loop over device
steps that reads its latch back to the host: every Newton iteration, and
every ``FISTA_CHECK_EVERY`` FISTA steps, with the steps in between frozen
by ``torch.where`` once the latch closes. So a fit stops paying for data
passes soon after it converges, and ``iterations``, ``converged`` and
``objective_history`` (length ``max_iter + 1``, the tail pinned to the last
objective) equal the reference's contract. A fit makes one host read to
check its labels, one per Newton iteration or one per
``FISTA_CHECK_EVERY`` FISTA steps after the first, and one for its result.

The binomial Newton Hessian ``Σ w·p(1−p)·za zaᵀ`` is the masked Gramian's
contract ``Σ s² z zᵀ`` with ``s = √(w·p(1−p))``: it runs through the
``masked_gram`` kernel on the card (``ops/kernels.py``), one launch per
iteration. Fits over a mesh raise ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import inspect
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import float_dtype
from ..frame.frame import Frame
from ..ops import kernels
from .base import (Estimator, Model, host_fetch, persistable, read_json,
                   write_json)
from .base import no_mesh as _no_mesh
from .evaluation import _share, _valid, pr_points, roc_points
from .evaluation import area_under_roc as _area_under_roc
from .regression import _extract_xy
from .solvers import _soft

# FISTA reads its convergence latch back to the host once every this many
# steps; the steps in between freeze once it closes, so the results equal
# a loop that stops at once.
FISTA_CHECK_EVERY = 10
# Newton is chosen for L1-free penalties while the system it solves has at
# most this many unknowns (d + 1 binomial, K·(d + 1) multinomial).
NEWTON_MAX_UNKNOWNS = 256
# The softmax Newton Hessian is summed over chunks of rows, each holding at
# most this many values of its weights (K² a row) and products (1 + d)².
HESSIAN_CHUNK_ELEMENTS = 1 << 25


class LogisticFitResult(NamedTuple):
    coefficients: object
    intercept: object
    iterations: object
    objective_history: object
    converged: object


class SoftmaxFitResult(NamedTuple):
    coefficient_matrix: object     # (K, d)
    intercept_vector: object       # (K,)
    iterations: object
    objective_history: object
    converged: object


def _rows_matvec(A, v):
    """``Aᵀv`` for ``A`` (n, d) and ``v`` (n,), as a sum over the rows of
    ``A·v``: the product is no larger than ``A``, and the sum is a tree.
    A float32 BLAS matvec may add the rows in order instead: on the CPU
    ``w @ (X*X)`` over 10⁶ rows of guests was 7e-4 off, and a float32 FISTA
    fit of 300 rows ended three times farther from the reference than the
    reference moves when its rows are reordered. The K-class contractions
    stay matrix products."""
    return (A * v[:, None]).sum(0)


def _feature_stats(X, y, mask):
    """Masked (or weighted) n and feature sample std, one pass."""
    w = mask.to(X.dtype)
    n = w.sum()
    mean = _rows_matvec(X, w) / n
    var = _rows_matvec(X * X, w) / n - mean * mean
    denom = torch.clamp(n - 1.0, min=1.0)
    std = torch.sqrt(torch.clamp(var * n / denom, min=0.0))
    return n, std


def _max0(v: torch.Tensor) -> torch.Tensor:
    """``max(v)`` and 0, the larger (``jnp.max(v, initial=0.0)``)."""
    return torch.clamp(v.max(), min=0.0) if v.numel() else v.new_zeros(())


def _scaling(X, mask, std, reg_param, alpha, standardization, weights):
    """What every core starts from: validity, the std divisor, the
    standardized masked rows, the 0/1 mask, the row weights and the
    per-feature L1 and L2 penalties."""
    dt = X.dtype
    valid = std > 0
    sx = torch.where(valid, std, torch.ones((), dtype=dt, device=X.device))
    wm = mask.to(dt)
    Xs = (X / sx) * wm[:, None]
    wv = wm if weights is None else weights.to(dt)
    u1 = (torch.ones_like(std) if standardization
          else torch.where(valid, 1.0 / sx, torch.zeros_like(sx)))
    lam1 = alpha * reg_param * u1
    lam2 = (1.0 - alpha) * reg_param * (u1 if standardization else u1 * u1)
    return valid, sx, wm, Xs, wv, lam1, lam2


def _softplus_neg(z: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(-z))``, stable (``jnp.logaddexp(0, -z)``)."""
    return torch.logaddexp(torch.zeros((), dtype=z.dtype, device=z.device),
                           -z)


def _one_hot(y, K: int, dt):
    """Rows of ``K`` columns, 1 at the label's class (zeros out of range)."""
    return (y.to(torch.int64)[:, None]
            == torch.arange(K, device=y.device)[None, :]).to(dt)


def _unscale(wb, valid, sx, d: int):
    return torch.where(valid, wb[:d] / sx, torch.zeros_like(sx)), wb[d]


# ---------------------------------------------------------------------------
# The two drivers
# ---------------------------------------------------------------------------

def _fista_drive(loss_grad, objective, prox, step, M: int, dt, device,
                 max_iter: int, tol: float):
    """Shared Nesterov/FISTA driver of the binary, softmax and SVC cores.

    ``loss_grad(wb, grad) -> (loss, grad or None)`` is the smooth pass;
    ``objective(wb, loss)`` adds the nonsmooth and ridge terms; ``prox``
    applies the proximal map and the validity masking. The latch is read
    every ``FISTA_CHECK_EVERY`` steps; steps after it closes are frozen.
    Returns ``(wb, converged, iterations, history)`` with ``history`` of
    length ``max_iter + 1`` (entry 0 = objective at zero)."""
    wb = torch.zeros(M, dtype=dt, device=device)
    wb_prev = wb
    obj0 = objective(wb, loss_grad(wb, False)[0])
    t = torch.ones((), dtype=dt, device=device)
    done = torch.zeros((), dtype=torch.bool, device=device)
    iters = torch.zeros((), dtype=torch.int32, device=device)
    last_obj, hist = obj0, [obj0]
    for i in range(max_iter):
        if i and i % FISTA_CHECK_EVERY == 0 and bool(done):
            break
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        v = wb + ((t - 1.0) / tn) * (wb - wb_prev)
        wb_new = prox(v - step * loss_grad(v, True)[1])
        obj = objective(wb_new, loss_grad(wb_new, False)[0])
        rel = torch.abs(obj - last_obj) / torch.clamp(torch.abs(last_obj),
                                                      min=1e-12)
        wb, wb_prev = (torch.where(done, wb, wb_new),
                       torch.where(done, wb_prev, wb))
        t = torch.where(done, t, tn)
        last_obj = torch.where(done, last_obj, obj)
        iters = iters + (~done).to(torch.int32)
        hist.append(last_obj)
        done = done | (rel < tol)
    hist += [last_obj] * (max_iter + 1 - len(hist))
    return wb, done, iters, torch.stack(hist)


def _newton_drive(stats, batched_objective, M: int, valid_full, dt, device,
                  max_iter: int, tol: float):
    """Shared damped-Newton driver of the binary and softmax cores:
    jittered Hessian solve, a line search over {1, ½, ¼, ⅛}·δ in one
    batched pass, convergence latch read back every iteration.

    ``stats(wb) -> (g, H)`` is the regularized gradient and Hessian pass;
    ``batched_objective(C)`` the objectives of a (c, M) candidate stack.
    Returns ``(wb, converged, iterations, history)`` as ``_fista_drive``."""
    wb = torch.zeros(M, dtype=dt, device=device)
    last_obj = batched_objective(wb[None, :])[0]
    hist = [last_obj]
    steps = 0.5 ** torch.arange(4, dtype=dt, device=device)   # 1, ½, ¼, ⅛
    eye = torch.eye(M, dtype=dt, device=device)
    inf = torch.full((), float("inf"), dtype=dt, device=device)
    zero = torch.zeros((), dtype=dt, device=device)
    eps = torch.finfo(dt).eps
    ok = torch.zeros((), dtype=torch.bool, device=device)
    for _ in range(max_iter):
        g, H = stats(wb)
        # Scaled jitter keeps the solve usable when H is near-singular
        # (separable data, the softmax shift degeneracy); an absolute one
        # would sit below a float32 diagonal's half-ulp. solve_ex leaves
        # a singular system's error unchecked: no host read.
        jitter = 100.0 * eps * (1.0 + torch.diagonal(H).abs().max())
        delta = torch.linalg.solve_ex(H + jitter * eye, g)[0]
        delta = torch.where(valid_full, delta, zero)
        C = wb[None, :] - steps[:, None] * delta[None, :]
        objs = batched_objective(C)
        objs = torch.where(torch.isfinite(objs), objs, inf)
        improving = objs < last_obj
        any_improving = improving.any()
        # the first improving candidate (largest step), else stay put
        # (index_select: a 0-d tensor index would read it to the host)
        idx = torch.argmax(improving.to(torch.int32)).reshape(1)
        wb = torch.where(any_improving, C.index_select(0, idx)[0], wb)
        obj = torch.where(any_improving, objs.index_select(0, idx)[0],
                          last_obj)
        rel = torch.abs(obj - last_obj) / torch.clamp(torch.abs(last_obj),
                                                      min=1e-12)
        # Converged: an accepted step with a relative decrease under tol,
        # or a stalled line search at the optimum (gradient about 0); a
        # stall with a large gradient is a failure and not converged.
        grad_small = g.abs().max() < 1e-4 * torch.clamp(torch.abs(last_obj),
                                                        min=1.0)
        ok = ((rel < tol) & any_improving) | (~any_improving & grad_small)
        last_obj = obj
        hist.append(obj)
        if bool(ok | ~any_improving):
            break
    iters = torch.full((), len(hist) - 1, dtype=torch.int32, device=device)
    hist += [last_obj] * (max_iter + 1 - len(hist))
    return wb, ok, iters, torch.stack(hist)


# ---------------------------------------------------------------------------
# Binomial, softmax and SVC cores
# ---------------------------------------------------------------------------

def _logistic_core(X, y, mask, reg_param, alpha, n, std, max_iter, tol,
                   fit_intercept, standardization, weights=None):
    """FISTA on the mean log-loss, elastic net. ``weights``: per-row
    instance weights (MLlib weightCol), default the 0/1 mask; margins use
    the boolean mask and weights enter the loss, gradient and ``n``."""
    dt, d = X.dtype, X.shape[1]
    valid, sx, wm, Xs, wv, lam1, lam2 = _scaling(
        X, mask, std, reg_param, alpha, standardization, weights)
    yv = y.to(dt) * wm
    sign = 2.0 * yv - wm
    # Lipschitz bound: λmax(XᵀWX/n)/4 <= ‖√w·Xs‖_F²/(4n)
    L = (wv[:, None] * Xs * Xs).sum() / (4.0 * n) + _max0(lam2) + 1e-12
    step = 1.0 / L

    def loss_grad(wb, grad):
        margin = Xs @ wb[:d] + wb[d] * wm
        loss = (wv * _softplus_neg(sign * margin)).sum() / n
        if not grad:
            return loss, None
        resid = (torch.sigmoid(margin) - yv) * wv
        g = torch.cat([_rows_matvec(Xs, resid), resid.sum()[None]]) / n
        g[:d] += lam2 * wb[:d]      # the ridge term is in the smooth part
        if not fit_intercept:
            g[d] = 0.0
        return loss, g

    def objective(wb, loss):
        w = wb[:d]
        return loss + (lam1 * w.abs()).sum() + 0.5 * (lam2 * w * w).sum()

    def prox(cand):
        w = torch.where(valid, _soft(cand[:d], step * lam1),
                        torch.zeros_like(cand[:d]))
        b = cand[d:] if fit_intercept else torch.zeros_like(cand[d:])
        return torch.cat([w, b])

    wb, done, iters, hist = _fista_drive(loss_grad, objective, prox, step,
                                         d + 1, dt, X.device, max_iter, tol)
    coef, intercept = _unscale(wb, valid, sx, d)
    return LogisticFitResult(coef, intercept, iters, hist, done)


def _logistic_newton_core(X, y, mask, reg_param, alpha, n, std, max_iter,
                          tol, fit_intercept, standardization, weights=None):
    """Damped Newton (IRLS) on the mean log-loss, the L1-free path
    (``alpha`` is 0 by the router's choice and ignored). Each iteration is
    one pass for the gradient (a matvec) and the Hessian (one
    ``masked_gram`` of ``Xs`` with weight ``√(w·p(1−p))``, whose rows and
    columns ``[0..d−1, d+1]`` are ``Za = [Xs, 1]``'s), then a jittered
    solve and a line search over four steps in one batched pass."""
    del alpha
    dt, d, dev = X.dtype, X.shape[1], X.device
    valid, sx, wm, Xs, wv, _, lam2 = _scaling(
        X, mask, std, reg_param, 0.0, standardization, weights)
    yv = y.to(dt) * wm
    sign = 2.0 * yv - wm
    Za = torch.cat([Xs, wm[:, None]], dim=1)         # intercept column
    lam2_full = torch.cat([lam2, lam2.new_zeros(1)])
    valid_full = torch.cat([valid, torch.full((1,), bool(fit_intercept),
                                              device=dev)])
    pair = valid_full[:, None] & valid_full[None, :]
    eye = torch.eye(d + 1, dtype=dt, device=dev)
    za_of_a = torch.cat([torch.arange(d, device=dev),
                         torch.full((1,), d + 1, device=dev)])

    def stats(wb):
        p = torch.sigmoid(Za @ wb)
        resid = (p - yv) * wv
        g = _rows_matvec(Za, resid) / n + lam2_full * wb
        A = kernels.masked_gram(Xs, yv, torch.sqrt(wv * p * (1.0 - p)))
        H = A[za_of_a][:, za_of_a] / n + torch.diag(lam2_full)
        return (torch.where(valid_full, g, torch.zeros_like(g)),
                torch.where(pair, H, eye))

    def batched_objective(C):
        z = sign[:, None] * (Za @ C.T)                 # (n, c)
        ll = (wv[:, None] * _softplus_neg(z)).sum(0) / n
        return ll + 0.5 * (lam2_full[None, :] * C * C).sum(1)

    wb, ok, iters, hist = _newton_drive(stats, batched_objective, d + 1,
                                        valid_full, dt, dev, max_iter, tol)
    coef, intercept = _unscale(wb, valid, sx, d)
    return LogisticFitResult(coef, intercept, iters, hist, ok)


def _softmax_core(X, y, mask, reg_param, alpha, n, std, num_classes,
                  max_iter, tol, fit_intercept, standardization,
                  weights=None):
    """FISTA on the mean softmax cross-entropy (MLlib
    ``family="multinomial"``): the (K, d) coefficients penalized
    elementwise with the binary path's elastic-net weights, the K
    intercepts unpenalized. ``wb`` is ``[W.ravel() | b]``."""
    dt, d, K = X.dtype, X.shape[1], num_classes
    valid, sx, wm, Xs, wv, lam1, lam2 = _scaling(
        X, mask, std, reg_param, alpha, standardization, weights)
    Y1 = _one_hot(y, K, dt) * wm[:, None]
    # Softmax Hessian in the margins is diag(p) − ppᵀ <= ½·I:
    # L <= ½‖Xs‖_F²/n
    L = 0.5 * (wv[:, None] * Xs * Xs).sum() / n + _max0(lam2) + 1e-12
    step = 1.0 / L
    m = K * d
    zero = torch.zeros((), dtype=dt, device=X.device)

    def loss_grad(wb, grad):
        W = wb[:m].reshape(K, d)
        margin = Xs @ W.T + wb[m:][None, :] * wm[:, None]   # (n, K)
        lse = torch.logsumexp(margin, dim=1)
        ll = wv * torch.where(mask, lse - (margin * Y1).sum(1), zero)
        loss = ll.sum() / n
        if not grad:
            return loss, None
        resid = (torch.softmax(margin, dim=1) - Y1) * wv[:, None]
        g = torch.cat([(resid.T @ Xs).reshape(-1),
                       resid.sum(0)]) / n
        g[:m] += (lam2[None, :] * W).reshape(-1)
        if not fit_intercept:
            g[m:] = 0.0
        return loss, g

    def objective(wb, loss):
        W = wb[:m].reshape(K, d)
        return (loss + (lam1[None, :] * W.abs()).sum()
                + 0.5 * (lam2[None, :] * W * W).sum())

    lam1_full = torch.cat([lam1.repeat(K), lam1.new_zeros(K)])
    valid_full = torch.cat([valid.repeat(K),
                            torch.full((K,), bool(fit_intercept),
                                       device=X.device)])

    def prox(cand):
        return torch.where(valid_full, _soft(cand, step * lam1_full), zero)

    wb, done, iters, hist = _fista_drive(loss_grad, objective, prox, step,
                                         m + K, dt, X.device, max_iter, tol)
    W = torch.where(valid[None, :], wb[:m].reshape(K, d) / sx[None, :],
                    zero)
    return SoftmaxFitResult(W, wb[m:], iters, hist, done)


def _softmax_newton_core(X, y, mask, reg_param, alpha, n, std, num_classes,
                         max_iter, tol, fit_intercept, standardization,
                         weights=None):
    """Damped Newton (IRLS) on the mean softmax cross-entropy, the L1-free
    multinomial path. Block (k, l) of the Hessian is ``Σ_n s_nkl·za za ᵀ``
    with ``s_nkl = w_n (p_nk δ_kl − p_nk p_nl)``: one matrix product,
    ``S (n, K²)ᵀ @ (za ⊗ za) (n, (d+1)²)``, over chunks of rows that hold
    at most ``HESSIAN_CHUNK_ELEMENTS`` values of the two. The off-diagonal
    weights are negative, so this is no masked Gramian. The shift
    degeneracy of an unpenalized fit is met by the driver's jitter and the
    caller's identifiability pivot. ``wb`` is ``(K, d+1)`` ravelled."""
    del alpha
    dt, d, K, dev = X.dtype, X.shape[1], num_classes, X.device
    valid, sx, wm, Xs, wv, _, lam2 = _scaling(
        X, mask, std, reg_param, 0.0, standardization, weights)
    Y1 = _one_hot(y, K, dt) * wm[:, None]
    Za = torch.cat([Xs, wm[:, None]], dim=1)           # (n, d+1)
    m1 = d + 1
    M = K * m1
    lam2_full = torch.cat([lam2, lam2.new_zeros(1)]).repeat(K)
    valid_full = torch.cat([valid, torch.full((1,), bool(fit_intercept),
                                              device=dev)]).repeat(K)
    pair = valid_full[:, None] & valid_full[None, :]
    eye = torch.eye(M, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    rows = max(1, HESSIAN_CHUNK_ELEMENTS // (K * K + m1 * m1))

    def stats(wb):
        p = torch.softmax(Za @ wb.reshape(K, m1).T, dim=1)   # (n, K)
        resid = (p - Y1) * wv[:, None]
        g = (resid.T @ Za).reshape(-1) / n + lam2_full * wb
        H = Za.new_zeros(K * K, m1 * m1)
        for lo in range(0, Za.shape[0], rows):
            pc, zc = p[lo:lo + rows], Za[lo:lo + rows]
            S = wv[lo:lo + rows, None, None] * (
                torch.diag_embed(pc) - pc[:, :, None] * pc[:, None, :])
            zz = (zc[:, :, None] * zc[:, None, :]).reshape(-1, m1 * m1)
            H += S.reshape(-1, K * K).T @ zz
        H = H.reshape(K, K, m1, m1).permute(0, 2, 1, 3).reshape(M, M) / n
        H = H + torch.diag(lam2_full)
        return torch.where(valid_full, g, zero), torch.where(pair, H, eye)

    def batched_objective(C):
        c = C.shape[0]
        margins = (Za @ C.reshape(c * K, m1).T).reshape(-1, c, K)
        lse = torch.logsumexp(margins, dim=2)              # (n, c)
        fitted = (margins * Y1[:, None, :]).sum(2)
        ll = (wv[:, None] * torch.where(mask[:, None], lse - fitted,
                                        zero)).sum(0) / n
        return ll + 0.5 * (lam2_full[None, :] * C * C).sum(1)

    wb, ok, iters, hist = _newton_drive(stats, batched_objective, M,
                                        valid_full, dt, dev, max_iter, tol)
    Wb = wb.reshape(K, m1)
    W = torch.where(valid[None, :], Wb[:, :d] / sx[None, :], zero)
    return SoftmaxFitResult(W, Wb[:, d], iters, hist, ok)


def _svc_core(X, y, mask, reg_param, n, std, max_iter, tol, fit_intercept,
              standardization):
    """Accelerated gradient on the mean SQUARED hinge + L2, the MLlib
    ``LinearSVC`` role (MLlib minimizes the hinge itself with OWL-QN; the
    squared hinge is its smooth relative, sklearn's default), on the
    shared FISTA driver; std scaling without centering, unpenalized
    intercept, 1/σ² penalty weights without standardization."""
    dt, d = X.dtype, X.shape[1]
    valid, sx, wm, Xs, _, _, lam2 = _scaling(
        X, mask, std, reg_param, 0.0, standardization, None)
    z = (2.0 * y.to(dt) - 1.0) * wm                    # ±1 labels, masked
    # squared-hinge curvature <= 2: L <= 2‖Xs‖_F²/n + max λ₂
    L = 2.0 * (Xs * Xs).sum() / n + _max0(lam2) + 1e-12
    step = 1.0 / L

    def loss_grad(wb, grad):
        margin = Xs @ wb[:d] + wb[d] * wm
        slack = torch.clamp(wm - z * margin, min=0.0)  # masked rows: 0 − 0
        loss = (slack * slack).sum() / n
        if not grad:
            return loss, None
        resid = -z * slack
        g = torch.cat([_rows_matvec(Xs, resid), resid.sum()[None]]) \
            * (2.0 / n)
        g[:d] += lam2 * wb[:d]
        if not fit_intercept:
            g[d] = 0.0
        return loss, g

    def objective(wb, loss):
        return loss + 0.5 * (lam2 * wb[:d] * wb[:d]).sum()

    def prox(cand):
        w = torch.where(valid, cand[:d], torch.zeros_like(cand[:d]))
        b = cand[d:] if fit_intercept else torch.zeros_like(cand[d:])
        return torch.cat([w, b])

    wb, done, iters, hist = _fista_drive(loss_grad, objective, prox, step,
                                         d + 1, dt, X.device, max_iter, tol)
    coef, intercept = _unscale(wb, valid, sx, d)
    return LogisticFitResult(coef, intercept, iters, hist, done)


# ---------------------------------------------------------------------------
# Packed fits: one design in, one flat result out
# ---------------------------------------------------------------------------

def _unpack_z(Z):
    """Split ``Z = [X, y, 1]·mask`` (``pack_design``): X, y, mask."""
    d = Z.shape[1] - 2
    return Z[:, :d], Z[:, d], Z[:, d + 1] > 0


def _unpack_zw(Z):
    """Split ``Z = [X, y, w]·mask`` (``pack_design_weighted``): the last
    column carries the instance weights (zero on masked rows), so the mask
    is ``w > 0``. Returns X, y, mask, w."""
    d = Z.shape[1] - 2
    w = Z[:, d + 1]
    return Z[:, :d], Z[:, d], w > 0, w


def _split(Z, weighted: bool):
    if weighted:
        return _unpack_zw(Z)
    return (*_unpack_z(Z), None)


def _pack_logistic_result(r: LogisticFitResult) -> torch.Tensor:
    """``[coef(d) | intercept | iterations | converged | history]``, the
    linear path's layout (decode with ``distributed.unpack_fit_result``)."""
    dt = r.coefficients.dtype
    scalars = torch.stack([r.intercept.to(dt), r.iterations.to(dt),
                           r.converged.to(dt)])
    return torch.cat([r.coefficients, scalars, r.objective_history.to(dt)])


def fused_logistic_fit_packed(max_iter: int, tol: float,
                              fit_intercept: bool, standardization: bool,
                              weighted: bool = False,
                              solver: str = "fista"):
    """The binomial fit as ``fit(Z, reg_param, elastic_net_param) ->
    flat`` with ``Z = pack_design(X, y, mask)``, or
    ``pack_design_weighted(X, y, mask, w)`` with ``weighted=True``.
    ``solver``: "fista" (elastic net) or "newton" (L1-free penalties)."""
    core = {"fista": _logistic_core, "newton": _logistic_newton_core}[solver]

    def fit(Z, reg_param, elastic_net_param):
        X, y, mask, w = _split(Z, weighted)
        n, std = _feature_stats(X, y, mask if w is None else w)
        return _pack_logistic_result(core(
            X, y, mask, float(reg_param), float(elastic_net_param), n, std,
            max_iter, tol, fit_intercept, standardization, weights=w))

    return fit


def fused_svc_fit_packed(max_iter: int, tol: float, fit_intercept: bool,
                         standardization: bool):
    """``LinearSVC``'s fit as ``fit(Z, reg_param) -> flat`` (the
    logistic layout), ``Z = pack_design(X, y, mask)``."""

    def fit(Z, reg_param):
        X, y, mask = _unpack_z(Z)
        n, std = _feature_stats(X, y, mask)
        return _pack_logistic_result(_svc_core(
            X, y, mask, float(reg_param), n, std, max_iter, tol,
            fit_intercept, standardization))

    return fit


def _pack_softmax_result(r: SoftmaxFitResult) -> torch.Tensor:
    """``[W.ravel() | b | iterations | converged | history]``."""
    dt = r.coefficient_matrix.dtype
    scalars = torch.stack([r.iterations.to(dt), r.converged.to(dt)])
    return torch.cat([r.coefficient_matrix.reshape(-1),
                      r.intercept_vector.to(dt), scalars,
                      r.objective_history.to(dt)])


def unpack_softmax_result(flat, num_classes: int, d: int
                          ) -> SoftmaxFitResult:
    """Decode the packed softmax fit on the host (one device read)."""
    flat = flat.cpu().numpy() if isinstance(flat, torch.Tensor) \
        else np.asarray(flat)
    m = num_classes * d
    return SoftmaxFitResult(
        coefficient_matrix=flat[:m].reshape(num_classes, d),
        intercept_vector=flat[m: m + num_classes],
        iterations=np.int32(flat[m + num_classes]),
        objective_history=flat[m + num_classes + 2:],
        converged=bool(flat[m + num_classes + 1]))


def fused_softmax_fit_packed(num_classes: int, max_iter: int, tol: float,
                             fit_intercept: bool, standardization: bool,
                             weighted: bool = False,
                             solver: str = "fista"):
    """The multinomial analogue of ``fused_logistic_fit_packed``
    ("newton" is the block-Hessian IRLS)."""
    core = {"fista": _softmax_core, "newton": _softmax_newton_core}[solver]

    def fit(Z, reg_param, elastic_net_param):
        X, y, mask, w = _split(Z, weighted)
        n, std = _feature_stats(X, y, mask if w is None else w)
        return _pack_softmax_result(core(
            X, y, mask, float(reg_param), float(elastic_net_param), n, std,
            num_classes, max_iter, tol, fit_intercept, standardization,
            weights=w))

    return fit


def _check_rows(y, mask, what: str, binary: bool = False, extra=()):
    """The label checks of a fit, in one host read over the valid rows:
    raises if there is none or a label is not a class id (0 or 1 with
    ``binary``); returns the number of classes and each flag of ``extra``
    (boolean tensors, any-reduced)."""
    if binary:
        bad = ~((y == 0) | (y == 1))
    else:
        bad = (y < 0) | (y != torch.floor(y))       # NaN fails as well
    top = (torch.where(mask, y, torch.full_like(y, float("-inf"))).max()
           if y.numel() else y.new_zeros(()))
    flags = torch.stack([mask.sum().to(torch.float64),
                         (bad & mask).any().to(torch.float64),
                         top.to(torch.float64),
                         *(e.any().to(torch.float64) for e in extra)])
    count, bad, top, *more = flags.cpu().tolist()
    if count == 0:
        raise ValueError(f"{what}: no valid rows")
    if bad:
        raise ValueError("LinearSVC requires binary 0/1 labels" if binary
                         else "labels must be nonnegative integers 0..k-1")
    return int(top) + 1, [bool(v) for v in more]


def _bad_weights(w, mask):
    """Valid rows whose weight is negative or NaN."""
    return ~(w >= 0) & mask


# ---------------------------------------------------------------------------
# LogisticRegression
# ---------------------------------------------------------------------------

@persistable
class LogisticRegression(Estimator):
    """Binary or multinomial logistic regression with elastic-net
    regularization (MLlib ``family``: auto / binomial / multinomial)."""

    weight_col = None    # default for saves that predate weightCol

    _persist_attrs = ("max_iter", "reg_param", "elastic_net_param", "tol",
                      "fit_intercept", "standardization", "threshold",
                      "family", "features_col", "label_col", "prediction_col",
                      "probability_col", "raw_prediction_col", "weight_col")

    def __init__(self, max_iter: int = 100, reg_param: float = 0.0,
                 elastic_net_param: float = 0.0, tol: float = 1e-6,
                 fit_intercept: bool = True, standardization: bool = True,
                 threshold: float = 0.5, family: str = "auto",
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction",
                 probability_col: str = "probability",
                 raw_prediction_col: str = "rawPrediction",
                 weight_col: Optional[str] = None):
        if family not in ("auto", "binomial", "multinomial"):
            raise ValueError(f"unknown family {family!r}")
        self.max_iter = max_iter
        self.reg_param = reg_param
        self.elastic_net_param = elastic_net_param
        self.tol = tol
        self.fit_intercept = fit_intercept
        self.standardization = standardization
        self.threshold = threshold
        self.family = family
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.probability_col = probability_col
        self.raw_prediction_col = raw_prediction_col
        self.weight_col = weight_col

    def set_max_iter(self, v): self.max_iter = int(v); return self
    def set_reg_param(self, v): self.reg_param = float(v); return self
    def set_elastic_net_param(self, v): self.elastic_net_param = float(v); return self
    def set_tol(self, v): self.tol = float(v); return self
    def set_fit_intercept(self, v): self.fit_intercept = bool(v); return self
    def set_standardization(self, v): self.standardization = bool(v); return self
    def set_threshold(self, v): self.threshold = float(v); return self
    def set_features_col(self, v): self.features_col = v; return self
    def set_label_col(self, v): self.label_col = v; return self
    def set_weight_col(self, v): self.weight_col = v; return self

    def set_family(self, v):
        if v not in ("auto", "binomial", "multinomial"):
            raise ValueError(f"unknown family {v!r}")
        self.family = v
        return self

    setFamily = set_family
    setMaxIter = set_max_iter
    setRegParam = set_reg_param
    setElasticNetParam = set_elastic_net_param
    setTol = set_tol
    setFitIntercept = set_fit_intercept
    setStandardization = set_standardization
    setThreshold = set_threshold
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col
    setWeightCol = set_weight_col

    def get_reg_param(self): return self.reg_param
    def get_tol(self): return self.tol
    def get_threshold(self): return self.threshold

    getRegParam = get_reg_param
    getTol = get_tol
    getThreshold = get_threshold

    def _params_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._persist_attrs}

    def fit(self, frame: Frame, mesh=None) -> "LogisticRegressionModel":
        """Fit on the frame's valid rows, on the device of the frame."""
        from ..parallel.distributed import (pack_design,
                                            pack_design_weighted,
                                            unpack_fit_result)

        _no_mesh(mesh, "LogisticRegression")
        X, y, mask = _extract_xy(frame, self.features_col, self.label_col)
        weighted = self.weight_col is not None
        if weighted:
            w = frame._column_values(self.weight_col).to(float_dtype())
        num_classes, bad_w = _check_rows(
            y, mask, "LogisticRegression",
            extra=[_bad_weights(w, mask)] if weighted else ())
        family = self.family
        if family == "auto":
            family = "binomial" if num_classes <= 2 else "multinomial"
        if family == "binomial" and num_classes > 2:
            raise ValueError(
                f"binomial family requires binary labels, found "
                f"{num_classes} classes; use family='multinomial'")
        if weighted:
            # masked rows' weights never take part: zeroed before packing
            if bad_w[0]:
                raise ValueError("weights must be nonnegative")
            Z = pack_design_weighted(X, y, mask,
                                     torch.where(mask, w, w.new_zeros(())))
        else:
            Z = pack_design(X, y, mask)
        d = X.shape[1]
        # L1-free penalties (elasticNetParam == 0 or regParam == 0, MLlib's
        # defaults included) take damped Newton while its system is small
        l1_free = self.elastic_net_param == 0.0 or self.reg_param == 0.0

        if family == "multinomial":
            K = max(num_classes, 2)
            solver = ("newton" if l1_free and K * (d + 1)
                      <= NEWTON_MAX_UNKNOWNS else "fista")
            fit_fn = fused_softmax_fit_packed(
                K, self.max_iter, self.tol, self.fit_intercept,
                self.standardization, weighted=weighted, solver=solver)
            result = unpack_softmax_result(
                fit_fn(Z, self.reg_param, self.elastic_net_param), K, d)
            W = np.asarray(result.coefficient_matrix, np.float64)
            b = np.asarray(result.intercept_vector, np.float64)
            # Identifiability pivot (MLlib): the softmax loss is invariant
            # to a per-feature shift across classes; intercepts are never
            # penalized and always centered, coefficients only when the
            # fit was unpenalized.
            if self.fit_intercept:
                b = b - b.mean()
            if self.reg_param == 0.0:
                W = W - W.mean(axis=0, keepdims=True)
            result = result._replace(coefficient_matrix=W,
                                     intercept_vector=b)
            model = LogisticRegressionModel(
                coefficient_matrix=W, intercept_vector=b,
                params=self._params_dict())
            model._summary_source = (frame, result)
            return model

        solver = ("newton" if l1_free and d + 1 <= NEWTON_MAX_UNKNOWNS
                  else "fista")
        fit_fn = fused_logistic_fit_packed(
            self.max_iter, self.tol, self.fit_intercept,
            self.standardization, weighted=weighted, solver=solver)
        result = LogisticFitResult(*unpack_fit_result(
            fit_fn(Z, self.reg_param, self.elastic_net_param), d))
        model = LogisticRegressionModel(
            coefficients=np.asarray(result.coefficients),
            intercept=float(result.intercept), params=self._params_dict())
        model._summary_source = (frame, result)
        return model


def _features(frame: Frame, params: dict) -> torch.Tensor:
    X = frame._column_values(params.get("features_col",
                                        "features")).to(float_dtype())
    return X[:, None] if X.ndim == 1 else X


def _on(values, X: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values), dtype=X.dtype,
                           device=X.device)


@persistable
class LogisticRegressionModel(Model):
    """Fitted logistic model. Binary fits expose ``coefficients`` /
    ``intercept``; multinomial fits ``coefficient_matrix`` (K, d) /
    ``intercept_vector`` (K,), and their vector accessors raise, as in
    MLlib."""

    def __init__(self, coefficients: Optional[np.ndarray] = None,
                 intercept: float = 0.0, params: Optional[dict] = None,
                 coefficient_matrix: Optional[np.ndarray] = None,
                 intercept_vector: Optional[np.ndarray] = None):
        if coefficient_matrix is not None:
            self._matrix = np.asarray(coefficient_matrix)
            self._intercepts = np.asarray(intercept_vector, np.float64)
            self._binary = False
        else:
            self._matrix = None
            self._intercepts = None
            self._binary = True
            self._coefficients = np.asarray(coefficients)
            self._intercept = float(intercept)
        self._params = dict(params or {})
        self._training_summary = None
        self._summary_source = None

    @property
    def is_multinomial(self) -> bool:
        return not self._binary

    @property
    def coefficients(self) -> np.ndarray:
        if not self._binary:
            raise RuntimeError(
                "coefficients is undefined for a multinomial model; "
                "use coefficient_matrix")
        return self._coefficients

    @property
    def intercept(self) -> float:
        if not self._binary:
            raise RuntimeError(
                "intercept is undefined for a multinomial model; "
                "use intercept_vector")
        return self._intercept

    @property
    def coefficient_matrix(self) -> np.ndarray:
        if self._binary:
            return self._coefficients[None, :]
        return self._matrix

    coefficientMatrix = coefficient_matrix

    @property
    def intercept_vector(self) -> np.ndarray:
        if self._binary:
            return np.asarray([self._intercept])
        return self._intercepts

    interceptVector = intercept_vector

    @property
    def num_classes(self) -> int:
        return 2 if self._binary else int(self._matrix.shape[0])

    numClasses = num_classes

    @property
    def num_features(self) -> int:
        return int(self.coefficient_matrix.shape[1])

    @property
    def threshold(self) -> float:
        return self._params.get("threshold", 0.5)

    def transform(self, frame: Frame) -> Frame:
        """Append rawPrediction (margin), probability and prediction
        columns, computed on the frame's device."""
        p = self._params
        X = _features(frame, p)
        if not self._binary:
            raw = X @ _on(self._matrix, X).T + _on(self._intercepts, X)
            prob = torch.softmax(raw, dim=1)
            pred = torch.argmax(raw, dim=1).to(float_dtype())
        else:
            raw = X @ _on(self._coefficients, X) + self._intercept
            prob = torch.sigmoid(raw)
            pred = (prob > self.threshold).to(float_dtype())
        out = frame.with_column(p.get("raw_prediction_col", "rawPrediction"),
                                raw)
        out = out.with_column(p.get("probability_col", "probability"), prob)
        return out.with_column(p.get("prediction_col", "prediction"), pred)

    def predict_raw(self, features):
        v = np.asarray(features, np.float64).reshape(-1)
        if not self._binary:
            return self._matrix.astype(np.float64) @ v + self._intercepts
        return float(v @ self._coefficients.astype(np.float64)
                     + self._intercept)

    predictRaw = predict_raw

    def predict_probability(self, features):
        raw = self.predict_raw(features)
        if not self._binary:
            e = np.exp(raw - raw.max())
            return e / e.sum()
        return float(1.0 / (1.0 + np.exp(-raw)))

    predictProbability = predict_probability

    def predict(self, features) -> float:
        if not self._binary:
            return float(np.argmax(self.predict_raw(features)))
        return (1.0 if self.predict_probability(features) > self.threshold
                else 0.0)

    @property
    def summary(self):
        if self._training_summary is None:
            if self._summary_source is None:
                raise RuntimeError("model was not fit with summary "
                                   "(loaded model?)")
            frame, result = self._summary_source
            cls = (BinaryLogisticRegressionTrainingSummary if self._binary
                   else LogisticRegressionTrainingSummary)
            self._training_summary = cls(self, frame, result)
        return self._training_summary

    @property
    def has_summary(self) -> bool:
        return (self._training_summary is not None
                or self._summary_source is not None)

    hasSummary = has_summary

    def evaluate(self, frame: Frame):
        if not self._binary:
            return LogisticRegressionSummary(self, frame)
        return BinaryLogisticRegressionSummary(self, frame)

    # -- persistence (the JAX package's format) -----------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        write_json(os.path.join(path, "metadata.json"), {
            "class": "LogisticRegressionModel",
            "multinomial": not self._binary,
            "intercept": (self._intercept if self._binary
                          else self._intercepts.tolist()),
            "params": self._params,
        })
        np.save(os.path.join(path, "coefficients.npy"),
                self._coefficients if self._binary else self._matrix)

    @classmethod
    def load(cls, path: str) -> "LogisticRegressionModel":
        meta = read_json(os.path.join(path, "metadata.json"))
        if meta.get("class") != "LogisticRegressionModel":
            raise ValueError(
                f"not a LogisticRegressionModel checkpoint: {path}")
        coef = np.load(os.path.join(path, "coefficients.npy"))
        if meta.get("multinomial"):
            return cls(coefficient_matrix=coef,
                       intercept_vector=np.asarray(meta["intercept"]),
                       params=meta.get("params"))
        return cls(coef, meta["intercept"], meta.get("params"))

    # Pipeline persistence (base.save_stage/load_stage dispatch here).
    def _save_to_dir(self, path: str) -> None:
        self.save(path)

    @classmethod
    def _load_from_dir(cls, path: str, meta: dict):
        return cls.load(path)


class BinaryLogisticRegressionSummary:
    """Evaluation over a frame's valid rows: accuracy, ROC and PR curves,
    areaUnderROC, the by-threshold frames. The columns stay on the frame's
    device, and the curves come from one device threshold sweep each."""

    def __init__(self, model: LogisticRegressionModel, frame: Frame):
        self._model = model
        pred_frame = model.transform(frame)
        p = model._params
        self._label = _valid(pred_frame, p.get("label_col", "label"))
        self._prob = _valid(pred_frame,
                            p.get("probability_col", "probability"))
        self._pred = _valid(pred_frame, p.get("prediction_col", "prediction"))
        self._predictions_frame = pred_frame
        self._device = frame.device

    @property
    def predictions(self) -> Frame:
        return self._predictions_frame

    @property
    def accuracy(self) -> float:
        same = (self._pred.to(torch.float64)
                == self._label.to(torch.float64)).sum()
        return _share(int(same), self._label.shape[0])

    @property
    def area_under_roc(self) -> float:
        return _area_under_roc(self._label, self._prob)

    areaUnderROC = area_under_roc

    @property
    def roc(self) -> Frame:
        """(FPR, TPR) curve frame, MLlib's ``summary.roc()``."""
        fpr, tpr = roc_points(self._label, self._prob)
        return Frame({"FPR": fpr, "TPR": tpr}, device=self._device)

    @property
    def pr(self) -> Frame:
        """(recall, precision) curve, MLlib's ``summary.pr()``."""
        _, precision, recall = pr_points(self._label, self._prob)
        return Frame({"recall": np.r_[0.0, recall],
                      "precision": np.r_[1.0, precision]},
                     device=self._device)

    def _by_threshold(self, metric: str) -> Frame:
        thr, precision, recall = pr_points(self._label, self._prob)
        if metric == "precision":
            vals = precision
        elif metric == "recall":
            vals = recall
        else:
            denom = np.maximum(precision + recall, 1e-30)
            vals = 2.0 * precision * recall / denom
        return Frame({"threshold": thr, metric: vals}, device=self._device)

    @property
    def precision_by_threshold(self) -> Frame:
        return self._by_threshold("precision")

    precisionByThreshold = precision_by_threshold

    @property
    def recall_by_threshold(self) -> Frame:
        return self._by_threshold("recall")

    recallByThreshold = recall_by_threshold

    @property
    def f_measure_by_threshold(self) -> Frame:
        return self._by_threshold("F-Measure")

    fMeasureByThreshold = f_measure_by_threshold


class _Trajectory:
    """``total_iterations`` and ``objective_history`` of a fit result."""

    def _keep(self, result) -> None:
        self._iterations = int(result.iterations)
        hist = np.asarray(result.objective_history, np.float64)
        self._objective_history = hist[: self._iterations + 1]

    @property
    def total_iterations(self) -> int:
        return self._iterations

    totalIterations = total_iterations

    @property
    def objective_history(self) -> np.ndarray:
        return self._objective_history

    objectiveHistory = objective_history


class BinaryLogisticRegressionTrainingSummary(
        _Trajectory, BinaryLogisticRegressionSummary):
    def __init__(self, model, frame, result: LogisticFitResult):
        super().__init__(model, frame)
        self._keep(result)


class LogisticRegressionSummary:
    """Multiclass evaluation over a frame's valid rows, MLlib's
    ``LogisticRegressionSummary``: accuracy, per-label precision, recall
    and F, their weighted averages; the counts are taken on the device."""

    def __init__(self, model: LogisticRegressionModel, frame: Frame):
        self._model = model
        pred_frame = model.transform(frame)
        p = model._params
        self._label = _valid(pred_frame, p.get("label_col", "label"))
        self._pred = _valid(pred_frame, p.get("prediction_col", "prediction"))
        self._predictions_frame = pred_frame
        self._k = model.num_classes
        self._confusion_cache = None

    @property
    def predictions(self) -> Frame:
        return self._predictions_frame

    @property
    def labels(self) -> np.ndarray:
        return np.arange(self._k, dtype=np.float64)

    @property
    def accuracy(self) -> float:
        same = (self._pred.to(torch.float64)
                == self._label.to(torch.float64)).sum()
        return _share(int(same), self._label.shape[0])

    def _confusion(self):
        """(tp, predicted, true) counts a label, read once."""
        if self._confusion_cache is None:
            k = self._k
            pred_i = self._pred.to(torch.int64)
            true_i = self._label.to(torch.int64)
            counts = torch.stack([
                torch.bincount(pred_i[pred_i == true_i], minlength=k)[:k],
                torch.bincount(pred_i, minlength=k)[:k],
                torch.bincount(true_i, minlength=k)[:k]]).cpu().numpy()
            self._confusion_cache = tuple(counts.astype(np.float64))
        return self._confusion_cache

    @property
    def precision_by_label(self) -> np.ndarray:
        tp, pred_c, _ = self._confusion()
        return np.where(pred_c > 0, tp / np.maximum(pred_c, 1), 0.0)

    precisionByLabel = precision_by_label

    @property
    def recall_by_label(self) -> np.ndarray:
        tp, _, true_c = self._confusion()
        return np.where(true_c > 0, tp / np.maximum(true_c, 1), 0.0)

    recallByLabel = recall_by_label

    @property
    def f_measure_by_label(self) -> np.ndarray:
        p, r = self.precision_by_label, self.recall_by_label
        return np.where(p + r > 0, 2 * p * r / np.maximum(p + r, 1e-300),
                        0.0)

    fMeasureByLabel = f_measure_by_label

    def _weights(self):
        _, _, true_c = self._confusion()
        return true_c / max(true_c.sum(), 1.0)

    @property
    def weighted_precision(self) -> float:
        return float(self._weights() @ self.precision_by_label)

    weightedPrecision = weighted_precision

    @property
    def weighted_recall(self) -> float:
        return float(self._weights() @ self.recall_by_label)

    weightedRecall = weighted_recall

    @property
    def weighted_f_measure(self) -> float:
        return float(self._weights() @ self.f_measure_by_label)

    weightedFMeasure = weighted_f_measure


class LogisticRegressionTrainingSummary(_Trajectory,
                                        LogisticRegressionSummary):
    def __init__(self, model, frame, result: SoftmaxFitResult):
        super().__init__(model, frame)
        self._keep(result)


# ---------------------------------------------------------------------------
# LinearSVC (MLlib org.apache.spark.ml.classification.LinearSVC)
# ---------------------------------------------------------------------------

@persistable
class LinearSVC(Estimator):
    """MLlib ``LinearSVC``: linear support-vector classifier, L2 penalty,
    binary 0/1 labels, squared-hinge objective (see :func:`_svc_core`)."""

    _persist_attrs = ("max_iter", "reg_param", "tol", "fit_intercept",
                      "standardization", "threshold", "features_col",
                      "label_col", "prediction_col", "raw_prediction_col")

    def __init__(self, max_iter: int = 100, reg_param: float = 0.0,
                 tol: float = 1e-6, fit_intercept: bool = True,
                 standardization: bool = True, threshold: float = 0.0,
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction",
                 raw_prediction_col: str = "rawPrediction"):
        self.max_iter = int(max_iter)
        self.reg_param = float(reg_param)
        self.tol = float(tol)
        self.fit_intercept = bool(fit_intercept)
        self.standardization = bool(standardization)
        self.threshold = float(threshold)
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.raw_prediction_col = raw_prediction_col

    def set_max_iter(self, v): self.max_iter = int(v); return self
    def set_reg_param(self, v): self.reg_param = float(v); return self
    def set_tol(self, v): self.tol = float(v); return self
    def set_fit_intercept(self, v): self.fit_intercept = bool(v); return self
    def set_standardization(self, v): self.standardization = bool(v); return self
    def set_threshold(self, v): self.threshold = float(v); return self
    def set_features_col(self, v): self.features_col = v; return self
    def set_label_col(self, v): self.label_col = v; return self

    setMaxIter = set_max_iter
    setRegParam = set_reg_param
    setTol = set_tol
    setFitIntercept = set_fit_intercept
    setStandardization = set_standardization
    setThreshold = set_threshold
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col

    def _params_dict(self):
        return {k: getattr(self, k) for k in self._persist_attrs}

    def fit(self, frame: Frame, mesh=None) -> "LinearSVCModel":
        from ..parallel.distributed import pack_design, unpack_fit_result

        _no_mesh(mesh, "LinearSVC")
        X, y, mask = _extract_xy(frame, self.features_col, self.label_col)
        _check_rows(y, mask, "LinearSVC", binary=True)
        fit_fn = fused_svc_fit_packed(self.max_iter, self.tol,
                                      self.fit_intercept,
                                      self.standardization)
        r = unpack_fit_result(fit_fn(pack_design(X, y, mask),
                                     self.reg_param), X.shape[1])
        iters = int(r.iterations)
        # the history up to the last iteration, as the summaries keep it
        history = np.asarray(r.objective_history,
                             np.float64)[: iters + 1].tolist()
        return LinearSVCModel(np.asarray(r.coefficients),
                              float(r.intercept), self._params_dict(),
                              objective_history=history, iterations=iters)


@persistable
class LinearSVCModel(Model):
    """Fitted linear SVC: ``rawPrediction`` = [−margin, margin];
    ``prediction`` thresholds the margin at ``threshold`` (MLlib)."""

    _persist_attrs = ("coefficients", "intercept", "_params",
                      "objective_history", "iterations")

    def __init__(self, coefficients, intercept, params=None,
                 objective_history=None, iterations=0):
        self.coefficients = np.asarray(coefficients)
        self.intercept = float(intercept)
        self._params = dict(params or {})
        self.objective_history = list(objective_history or [])
        self.iterations = int(iterations)

    def _p(self, k, default=None):
        return self._params.get(k, default)

    @property
    def num_features(self):
        return int(self.coefficients.shape[0])

    numFeatures = num_features

    def get_threshold(self):
        return self._p("threshold", 0.0)

    getThreshold = get_threshold

    def _margin(self, X: torch.Tensor) -> torch.Tensor:
        return X @ _on(self.coefficients, X) + self.intercept

    def transform(self, frame: Frame) -> Frame:
        m = self._margin(_features(frame, self._params))
        pred = (m > self._p("threshold", 0.0)).to(float_dtype())
        out = frame.with_column(
            self._p("raw_prediction_col", "rawPrediction"),
            torch.stack([-m, m], dim=1))
        return out.with_column(self._p("prediction_col", "prediction"),
                               pred)

    def predict(self, features) -> float:
        x = torch.as_tensor(np.asarray(features, np.float64).reshape(1, -1),
                            dtype=float_dtype())
        return float(self._margin(x)[0] > self._p("threshold", 0.0))


# ---------------------------------------------------------------------------
# NaiveBayes (MLlib org.apache.spark.ml.classification.NaiveBayes)
# ---------------------------------------------------------------------------

def _nb_sufficient_stats(X, y, w, num_classes: int):
    """Per-class weighted label counts (k,) and feature sums (k, d): one
    masked one-hot matmul, the whole NaiveBayes fit pass."""
    onehot = _one_hot(y, num_classes, X.dtype) * w[:, None]
    return onehot.sum(0), onehot.T @ X


@persistable
class NaiveBayes(Estimator):
    """MLlib ``NaiveBayes``: multinomial (default) or bernoulli model with
    Laplace ``smoothing`` (default 1.0). Labels must be 0..k-1;
    multinomial requires nonnegative features, bernoulli 0/1 features,
    both checked like Spark. The fit is one one-hot matmul on the device;
    prediction is ``pi + X @ thetaᵀ``."""

    weight_col = None    # default for saves that predate weightCol

    _persist_attrs = ("smoothing", "model_type", "features_col", "label_col",
                      "prediction_col", "probability_col",
                      "raw_prediction_col", "weight_col")

    def __init__(self, smoothing: float = 1.0,
                 model_type: str = "multinomial",
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction",
                 probability_col: str = "probability",
                 raw_prediction_col: str = "rawPrediction",
                 weight_col: Optional[str] = None):
        if model_type not in ("multinomial", "bernoulli"):
            raise ValueError(f"model_type={model_type!r}")
        if smoothing < 0:
            raise ValueError("smoothing must be >= 0")
        self.smoothing = float(smoothing)
        self.model_type = model_type
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.probability_col = probability_col
        self.raw_prediction_col = raw_prediction_col
        self.weight_col = weight_col

    def set_smoothing(self, v):
        if v < 0:
            raise ValueError("smoothing must be >= 0")
        self.smoothing = float(v)
        return self

    def set_model_type(self, v):
        if v not in ("multinomial", "bernoulli"):
            raise ValueError(f"model_type={v!r}")
        self.model_type = v
        return self

    def set_features_col(self, v): self.features_col = v; return self
    def set_label_col(self, v): self.label_col = v; return self
    def set_weight_col(self, v): self.weight_col = v; return self

    setSmoothing = set_smoothing
    setModelType = set_model_type
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col
    setWeightCol = set_weight_col

    def _params_dict(self):
        return {k: getattr(self, k) for k in self._persist_attrs}

    def fit(self, frame: Frame, mesh=None) -> "NaiveBayesModel":
        _no_mesh(mesh, "NaiveBayes")
        dt = float_dtype()
        X = _features(frame, {"features_col": self.features_col})
        y = frame._column_values(self.label_col).to(dt)
        mask = frame.mask
        multinomial = self.model_type == "multinomial"
        # NaN fails >= and == too, as Spark rejects it
        bad_x = (~(X >= 0) if multinomial else ~((X == 0) | (X == 1)))
        checks = [bad_x.any(1) & mask]
        if self.weight_col is not None:
            w = frame._column_values(self.weight_col).to(dt)
            checks.append(_bad_weights(w, mask))
        num_classes, flags = _check_rows(y, mask, "NaiveBayes",
                                         extra=checks)
        if flags[0]:
            raise ValueError("multinomial NaiveBayes requires nonnegative "
                             "features" if multinomial else
                             "bernoulli NaiveBayes requires 0/1 features")
        if self.weight_col is not None and flags[1]:
            raise ValueError("weights must be nonnegative")
        zero = X.new_zeros(())
        Xh = X if multinomial else (X > 0).to(dt)
        # masked slots may hold NaN (0 × NaN would poison the matmul)
        Xh = torch.where(mask[:, None], Xh, zero)
        yh = torch.where(mask, y, zero)
        row_w = (mask.to(dt) if self.weight_col is None
                 else torch.where(mask, w, zero))
        class_count, feat_sum = _nb_sufficient_stats(Xh, yh, row_w,
                                                     num_classes)
        host = torch.cat([class_count[:, None], feat_sum], dim=1)
        host = host.cpu().numpy().astype(np.float64)
        class_count, feat_sum = host[:, 0], host[:, 1:]
        lam = self.smoothing
        n = class_count.sum()
        pi = np.log(class_count + lam) - np.log(n + num_classes * lam)
        if multinomial:
            # log P(feature j | class c), normalized over the features
            row_tot = feat_sum.sum(axis=1, keepdims=True)
            theta = np.log(feat_sum + lam) - np.log(row_tot
                                                    + lam * X.shape[1])
        else:
            # log P(x_j = 1 | class c); the complement enters at predict
            theta = np.log(feat_sum + lam) \
                - np.log(class_count[:, None] + 2.0 * lam)
        return NaiveBayesModel(pi, theta, self.model_type,
                               self._params_dict())


@persistable
class NaiveBayesModel(Model):
    """``pi`` (k,) log class priors, ``theta`` (k, d) log feature
    likelihoods. Prediction is one matmul; bernoulli adds the complement
    term as MLlib's BernoulliNB does."""

    _persist_attrs = ("pi", "theta", "model_type", "_params")

    def __init__(self, pi, theta, model_type, params=None):
        self.pi = np.asarray(pi)
        self.theta = np.asarray(theta)
        self.model_type = model_type
        self._params = dict(params or {})

    @property
    def num_classes(self):
        return int(self.pi.shape[0])

    numClasses = num_classes

    @property
    def num_features(self):
        return int(self.theta.shape[1])

    numFeatures = num_features

    def _raw(self, X: torch.Tensor) -> torch.Tensor:
        pi, theta = _on(self.pi, X), _on(self.theta, X)
        if self.model_type == "multinomial":
            return pi + X @ theta.T
        Xb = (X > 0).to(X.dtype)
        neg = torch.log1p(-torch.exp(torch.clamp(theta, max=-1e-7)))
        return pi + neg.sum(1) + Xb @ (theta - neg).T

    def transform(self, frame: Frame) -> Frame:
        p = self._params
        raw = self._raw(_features(frame, p))
        out = frame.with_column(p.get("raw_prediction_col", "rawPrediction"),
                                raw)
        out = out.with_column(p.get("probability_col", "probability"),
                              torch.softmax(raw, dim=1))
        return out.with_column(p.get("prediction_col", "prediction"),
                               torch.argmax(raw, dim=1).to(float_dtype()))

    def predict(self, features) -> float:
        x = torch.as_tensor(np.asarray(features, np.float64).reshape(1, -1),
                            dtype=float_dtype())
        return float(host_fetch(torch.argmax(self._raw(x), dim=1))[0])


# ---------------------------------------------------------------------------
# OneVsRest (MLlib org.apache.spark.ml.classification.OneVsRest)
# ---------------------------------------------------------------------------

@persistable
class OneVsRest(Estimator):
    """MLlib ``OneVsRest``: multiclass as k binary fits of any binary
    classifier, each on the same frame with a 0/1 label column."""

    def __init__(self, classifier=None, features_col: str = "features",
                 label_col: str = "label",
                 prediction_col: str = "prediction"):
        self.classifier = classifier
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col

    def set_classifier(self, v):
        self.classifier = v
        return self

    setClassifier = set_classifier

    # composite persistence: the inner classifier is a stage of its own
    def _save_to_dir(self, path: str) -> None:
        from .base import save_stage

        write_json(os.path.join(path, "metadata.json"),
                   {"class": "OneVsRest",
                    "features_col": self.features_col,
                    "label_col": self.label_col,
                    "prediction_col": self.prediction_col,
                    "has_classifier": self.classifier is not None})
        if self.classifier is not None:
            save_stage(self.classifier, os.path.join(path, "classifier"))

    @classmethod
    def _load_from_dir(cls, path: str, meta: dict) -> "OneVsRest":
        from .base import load_stage

        clf = (load_stage(os.path.join(path, "classifier"))
               if meta.get("has_classifier") else None)
        return cls(clf, meta["features_col"], meta["label_col"],
                   meta["prediction_col"])

    def fit(self, frame: Frame, mesh=None) -> "OneVsRestModel":
        if self.classifier is None:
            raise ValueError("OneVsRest: classifier not set")
        _no_mesh(mesh, "OneVsRest")
        y = frame._column_values(self.label_col)
        k, _ = _check_rows(y.to(torch.float64), frame.mask, "OneVsRest")
        models = []
        for c in range(k):
            binary = frame.with_column(self.label_col,
                                       (y == c).to(float_dtype()))
            est = copy.deepcopy(self.classifier)
            if hasattr(est, "set_features_col"):
                est.set_features_col(self.features_col)
            if hasattr(est, "set_label_col"):
                est.set_label_col(self.label_col)
            # a mesh goes only to estimators whose fit takes one
            if "mesh" in inspect.signature(est.fit).parameters:
                models.append(est.fit(binary, mesh=mesh))
            else:
                models.append(est.fit(binary))
        return OneVsRestModel(models, self.features_col,
                              self.prediction_col)


@persistable
class OneVsRestModel(Model):
    """k fitted binary models; the prediction is the argmax of their
    scores (the positive-class probability where a model has one, else its
    rawPrediction)."""

    def __init__(self, models, features_col="features",
                 prediction_col="prediction"):
        self.models = list(models)
        self.features_col = features_col
        self.prediction_col = prediction_col

    @property
    def num_classes(self):
        return len(self.models)

    numClasses = num_classes

    def _scores(self, frame: Frame) -> torch.Tensor:
        cols = []
        for m in self.models:
            out = m.transform(frame)
            p = getattr(m, "_params", {})
            prob_col = p.get("probability_col", "probability")
            name = (prob_col if prob_col in out.columns
                    else p.get("raw_prediction_col", "rawPrediction"))
            v = out._column_values(name)
            cols.append(v[:, -1] if v.ndim == 2 else v)
        return torch.stack(cols, dim=1)

    def transform(self, frame: Frame) -> Frame:
        pred = torch.argmax(self._scores(frame), dim=1).to(float_dtype())
        return frame.with_column(self.prediction_col, pred)

    def _save_to_dir(self, path: str) -> None:
        from .base import save_stage

        write_json(os.path.join(path, "metadata.json"),
                   {"class": "OneVsRestModel", "n": len(self.models),
                    "features_col": self.features_col,
                    "prediction_col": self.prediction_col})
        for i, m in enumerate(self.models):
            save_stage(m, os.path.join(path, f"model_{i}"))

    @classmethod
    def _load_from_dir(cls, path: str, meta: dict) -> "OneVsRestModel":
        from .base import load_stage

        models = [load_stage(os.path.join(path, f"model_{i}"))
                  for i in range(meta["n"])]
        return cls(models, meta["features_col"], meta["prediction_col"])
