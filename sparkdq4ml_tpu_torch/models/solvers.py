"""Elastic-net linear solvers on sufficient statistics (subset of
``sparkdq4ml_tpu/models/solvers.py``).

A fit touches the data once, for the augmented Gramian ``A = ZᵀZ`` with
``Z = [X, y, 1]·mask``. Counts, means, sample stds, the standardized Gram
matrix ``G``, the correlation vector ``b`` and the label energy all unpack
from ``A``, and the solver loop then runs on the ``(d×d)`` statistics on
the device of ``A``, with no host round trip inside the loop.

Numeric convention (MLlib's): sample std (n−1 denominator); the solve runs
in standardized space with ``effectiveRegParam = regParam/σ_y``; with
``standardization=False`` the penalty lands on the raw coefficients;
unscale ``w_j = ŵ_j σ_y/σ_xj`` and ``intercept = ȳ − w·x̄``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Moments(NamedTuple):
    """Unpacked sufficient statistics (tensors on the device of ``A``)."""
    n: torch.Tensor           # valid-row count
    mean_x: torch.Tensor      # (d,)
    mean_y: torch.Tensor      # ()
    std_x: torch.Tensor       # (d,) sample std
    std_y: torch.Tensor       # ()
    G: torch.Tensor           # (d,d) standardized (centered) Gram / n
    b: torch.Tensor           # (d,)  standardized X'y / n
    yy: torch.Tensor          # ()    standardized y'y / n
    valid: torch.Tensor       # (d,) bool: the feature has nonzero variance


class FitResult(NamedTuple):
    coefficients: object      # (d,) original scale
    intercept: object         # ()
    iterations: object        # () int32: solver iterations run
    objective_history: object  # (max_iter+1,) scaled-objective trace
    converged: object         # () bool


def unpack_moments(A: torch.Tensor, fit_intercept: bool = True) -> Moments:
    """A -> means, stds and the standardized Gram, in the reference's
    algebra and order (centered moments as ``A − n·mean²``)."""
    d = A.shape[0] - 2
    n = A[d + 1, d + 1]
    mean_x = A[:d, d + 1] / n
    mean_y = A[d, d + 1] / n
    Cxx = A[:d, :d] - n * torch.outer(mean_x, mean_x)
    Cxy = A[:d, d] - n * mean_x * mean_y
    Cyy = A[d, d] - n * mean_y * mean_y
    denom = torch.clamp(n - 1.0, min=1.0)
    var_x = torch.clamp(torch.diagonal(Cxx), min=0.0) / denom
    var_y = torch.clamp(Cyy, min=0.0) / denom
    std_x = torch.sqrt(var_x)
    std_y = torch.sqrt(var_y)
    valid = std_x > 0
    one = A.new_ones(())
    sx = torch.where(valid, std_x, one)
    sy = torch.where(std_y > 0, std_y, one)
    if not fit_intercept:
        # MLlib without intercept: no centering in the objective (the stds
        # above still come from centered moments).
        Cxx, Cxy, Cyy = A[:d, :d], A[:d, d], A[d, d]
    G = Cxx / (n * torch.outer(sx, sx))
    b = torch.where(valid, Cxy / (n * sx * sy), A.new_zeros(()))
    yy = Cyy / (n * sy * sy)
    # Invalid (constant) features never move off 0.
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    G = torch.where(torch.outer(valid, valid), G, eye)
    return Moments(n, mean_x, mean_y, std_x, std_y, G, b, yy, valid)


def _penalty_weights(m: Moments, standardization: bool):
    """Per-feature multipliers (u1 for L1, u2 for L2) in standardized
    space; with ``standardization=False``: u1 = 1/σ, u2 = 1/σ²."""
    if standardization:
        ones = torch.ones_like(m.std_x)
        return ones, ones
    one = m.std_x.new_ones(())
    sx = torch.where(m.valid, m.std_x, one)
    u1 = torch.where(m.valid, 1.0 / sx, m.std_x.new_zeros(()))
    return u1, u1 * u1


def _objective(w, m: Moments, lam1, lam2):
    f = 0.5 * (m.yy - 2.0 * torch.dot(m.b, w) + w @ m.G @ w)
    return f + torch.sum(lam1 * torch.abs(w)) + 0.5 * torch.sum(lam2 * w * w)


def _soft(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def _unscale(w, m: Moments, fit_intercept: bool):
    one = m.std_x.new_ones(())
    sx = torch.where(m.valid, m.std_x, one)
    sy = torch.where(m.std_y > 0, m.std_y, one)
    coef = torch.where(m.valid, w * sy / sx, m.std_x.new_zeros(()))
    intercept = (m.mean_y - torch.dot(coef, m.mean_x) if fit_intercept
                 else m.std_x.new_zeros(()))
    return coef, intercept


def fista_solve(A: torch.Tensor, reg_param: float, elastic_net_param: float,
                max_iter: int = 100, tol: float = 1e-6,
                fit_intercept: bool = True,
                standardization: bool = True) -> FitResult:
    """Accelerated proximal gradient (FISTA) on the standardized objective.

    The reference's ``lax.scan`` becomes a fixed loop of ``max_iter``
    steps; the ``done`` flag freezes the state with tensor ``where``s, so
    the loop never reads a value back to the host and ``iterations`` and
    ``objective_history`` match the reference. ``objective_history[0]`` is
    the objective at w = 0."""
    m = unpack_moments(A, fit_intercept=fit_intercept)
    dt = A.dtype
    d = m.b.shape[0]
    eff = reg_param / torch.where(m.std_y > 0, m.std_y, A.new_ones(()))
    alpha = float(elastic_net_param)
    u1, u2 = _penalty_weights(m, standardization)
    lam1 = alpha * eff * u1
    lam2 = (1.0 - alpha) * eff * u2
    # Lipschitz bound: ‖G‖₂ ≤ ‖G‖_F for PSD G; + the largest ridge term.
    L = (torch.linalg.norm(m.G) + torch.clamp(lam2.max(), min=0.0)
         + 1e-12)
    step = 1.0 / L

    w = torch.zeros(d, dtype=dt, device=A.device)
    w_prev = w
    t = A.new_ones(())
    done = torch.zeros((), dtype=torch.bool, device=A.device)
    iters = torch.zeros((), dtype=torch.int32, device=A.device)
    obj0 = _objective(w, m, lam1, lam2)
    last_obj = obj0
    hist = [obj0]
    for _ in range(max_iter):
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        v = w + ((t - 1.0) / tn) * (w - w_prev)
        grad = m.G @ v - m.b + lam2 * v
        w_new = _soft(v - step * grad, step * lam1)
        w_new = torch.where(m.valid, w_new, A.new_zeros(()))
        obj = _objective(w_new, m, lam1, lam2)
        # MLlib-style relative-improvement convergence test
        rel = torch.abs(obj - last_obj) / torch.clamp(torch.abs(last_obj),
                                                       min=1e-12)
        now_done = done | (rel < tol)
        w, w_prev = torch.where(done, w, w_new), torch.where(done, w_prev, w)
        t = torch.where(done, t, tn)
        last_obj = torch.where(done, last_obj, obj)
        iters = iters + (~done).to(torch.int32)
        hist.append(last_obj)
        done = now_done

    coef, intercept = _unscale(w, m, fit_intercept)
    return FitResult(coef, intercept, iters, torch.stack(hist), done)


def normal_solve(A: torch.Tensor, reg_param: float,
                 elastic_net_param: float = 0.0, fit_intercept: bool = True,
                 standardization: bool = True) -> FitResult:
    """Closed form (normal equations), MLlib's ``solver="normal"``: valid
    when there is no L1 term. One small linear solve on the device."""
    m = unpack_moments(A, fit_intercept=fit_intercept)
    eff = reg_param / torch.where(m.std_y > 0, m.std_y, A.new_ones(()))
    lam2 = ((1.0 - float(elastic_net_param)) * eff
            * _penalty_weights(m, standardization)[1])
    w = torch.linalg.solve(m.G + torch.diag(lam2), m.b)
    w = torch.where(m.valid, w, A.new_zeros(()))
    coef, intercept = _unscale(w, m, fit_intercept)
    return FitResult(coef, intercept,
                     torch.zeros((), dtype=torch.int32, device=A.device),
                     A.new_zeros(1),
                     torch.ones((), dtype=torch.bool, device=A.device))


def resolve_solver(solver: str, reg_param: float,
                   elastic_net_param: float) -> str:
    """MLlib's ``solver`` param -> a concrete solver: ``auto`` means the
    normal equations when no L1 term is active, else the proximal path."""
    has_l1 = (reg_param > 0.0) and (elastic_net_param > 0.0)
    if solver == "normal" or (solver == "auto" and not has_l1):
        if has_l1:
            raise ValueError("solver='normal' cannot apply an L1 penalty")
        return "normal"
    if solver in ("auto", "fista", "proximal"):
        return "fista"
    if solver in ("owlqn", "l-bfgs", "lbfgs"):
        return "owlqn"
    raise ValueError(f"unknown solver {solver!r}")
