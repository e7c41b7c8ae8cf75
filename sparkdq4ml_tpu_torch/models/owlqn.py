"""Orthant-Wise Limited-memory Quasi-Newton (OWL-QN), MLlib's L1 solver
(breeze ``OWLQN`` behind ``LinearRegression.fit``), on sufficient
statistics (port of ``sparkdq4ml_tpu/models/owlqn.py``).

The smooth part is the standardized quadratic ``f(w) = ½wᵀGw − bᵀw
(+ ridge)`` of :mod:`.solvers`, so gradients are matvecs on the ``(d,d)``
statistics: no data pass and no host read inside the loop. The L-BFGS
two-loop recursion uses a fixed rolling history of ``HISTORY`` pairs; the
orthant machinery is:

* pseudo-gradient: the steepest valid subgradient,
* direction projection: components whose sign disagrees with the
  steepest-descent direction are zeroed,
* orthant projection in the line search: iterates may not cross their
  orthant.

The reference's ``lax.scan`` over ``max_iter`` becomes a fixed loop whose
``done`` flag freezes the state. Its line search, a scan of ``LS_STEPS``
halvings that keeps the first step passing the Armijo test, is here one
batched evaluation of all ``LS_STEPS`` candidate steps (the halvings are
exact powers of two) followed by picking the first that passes: the same
step, in one set of launches instead of twenty.
"""

from __future__ import annotations

import torch

from .solvers import (FitResult, _dot, _matvec, _objective, _penalties,
                      _unscale, unpack_moments)

HISTORY = 10          # L-BFGS memory (breeze's default for OWLQN)
LS_STEPS = 20         # backtracking halvings per iteration


def _pseudo_gradient(w, g, lam1):
    """Steepest valid subgradient of f + λ1‖w‖₁."""
    zero = w.new_zeros(())
    pg_nonzero = g + lam1 * torch.sign(w)
    down = g + lam1   # right derivative at 0
    up = g - lam1     # left derivative at 0
    pg_zero = torch.where(down < 0.0, down,
                          torch.where(up > 0.0, up, zero))
    return torch.where(w == 0.0, pg_zero, pg_nonzero)


def _two_loop(pg, S, Y, rho, k):
    """L-BFGS two-loop recursion on the rolling (S, Y) history.

    Logical pair j lives in slot j % HISTORY; the live pairs are
    j = k−1 … max(0, k−HISTORY). The backward pass visits them newest to
    oldest and the forward pass oldest to newest."""
    order = torch.arange(HISTORY, device=pg.device)       # 0 = newest
    slots = (k - 1 - order) % HISTORY
    valid = order < torch.clamp(k, max=HISTORY)
    S_o, Y_o, rho_o = S[slots], Y[slots], rho[slots]
    zero = pg.new_zeros(())
    q = pg
    alphas = []
    for i in range(HISTORY):
        a = torch.where(valid[i], rho_o[i] * torch.dot(S_o[i], q), zero)
        q = q - a * Y_o[i]
        alphas.append(a)
    # Initial Hessian scaling γ = sᵀy/yᵀy of the newest pair
    newest = (k - 1) % HISTORY
    sy = torch.dot(S[newest], Y[newest])
    yy = torch.dot(Y[newest], Y[newest])
    gamma = torch.where((k > 0) & (yy > 0),
                        sy / torch.clamp(yy, min=1e-30), pg.new_ones(()))
    r = gamma * q
    for i in reversed(range(HISTORY)):
        beta = torch.where(valid[i], rho_o[i] * torch.dot(Y_o[i], r), zero)
        r = r + valid[i].to(r.dtype) * (alphas[i] - beta) * S_o[i]
    return r


def owlqn_solve(A: torch.Tensor, reg_param, elastic_net_param,
                max_iter: int = 100, tol: float = 1e-6,
                fit_intercept: bool = True,
                standardization: bool = True) -> FitResult:
    """OWL-QN on one Gramian ``A`` (D, D). ``objective_history`` has
    ``max_iter + 1`` entries, the first at w = 0."""
    m = unpack_moments(A, fit_intercept=fit_intercept)
    dt, dev = A.dtype, A.device
    d = m.b.shape[0]
    lam1, lam2 = _penalties(A, m, reg_param, elastic_net_param,
                            standardization)
    zero = A.new_zeros(())

    def smooth_grad(w):
        return _matvec(m.G, w) - m.b + lam2 * w

    halvings = 0.5 ** torch.arange(LS_STEPS, dtype=dt, device=dev)
    slot_ids = torch.arange(HISTORY, device=dev)

    w = torch.zeros(d, dtype=dt, device=dev)
    g = smooth_grad(w)
    fval = _objective(w, m, lam1, lam2)
    f0 = fval
    S = torch.zeros((HISTORY, d), dtype=dt, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros(HISTORY, dtype=dt, device=dev)
    k = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    hist = [f0]
    for _ in range(max_iter):
        pg = _pseudo_gradient(w, g, lam1)
        direction = -_two_loop(pg, S, Y, rho, k)
        # Project: the direction must agree with −pg componentwise
        direction = torch.where(direction * pg < 0.0, direction, zero)
        # Orthant of the line search: sign(w), or sign(−pg) where w == 0
        xi = torch.where(w != 0.0, torch.sign(w), torch.sign(-pg))
        deriv = torch.dot(pg, direction)

        init_step = torch.where(
            k == 0, 1.0 / torch.clamp(torch.linalg.vector_norm(direction),
                                      min=1e-12), A.new_ones(()))
        steps = init_step * halvings                       # (LS_STEPS,)
        cand = w + steps[:, None] * direction
        cand = torch.where(cand * xi < 0.0, zero, cand)     # orthant
        fc = _objective(cand, m, lam1, lam2)
        ok = fc <= fval + 1e-4 * steps * deriv
        found = ok.any()
        first = torch.argmax(ok.to(torch.int8))            # first True
        w_new = torch.where(found, cand[first], w)
        f_new = torch.where(found, fc[first], fval)

        g_new = smooth_grad(w_new)
        s = w_new - w
        yv = g_new - g
        sy = _dot(s, yv)
        keep = found & (sy > 1e-30)
        put = keep & (slot_ids == k % HISTORY)             # (HISTORY,)
        S2 = torch.where(put[:, None], s, S)
        Y2 = torch.where(put[:, None], yv, Y)
        rho2 = torch.where(put, 1.0 / torch.clamp(sy, min=1e-30), rho)
        k2 = k + keep.to(k.dtype)

        rel = torch.abs(f_new - fval) / torch.clamp(torch.abs(fval),
                                                     min=1e-12)
        now_done = done | (rel < tol) | ~found
        w = torch.where(done, w, w_new)
        g = torch.where(done, g, g_new)
        fval = torch.where(done, fval, f_new)
        S = torch.where(done, S, S2)
        Y = torch.where(done, Y, Y2)
        rho = torch.where(done, rho, rho2)
        k = torch.where(done, k, k2)
        iters = iters + (~done).to(torch.int32)
        hist.append(fval)
        done = now_done

    w = torch.where(m.valid, w, zero)
    coef, intercept = _unscale(w, m, fit_intercept)
    return FitResult(coef, intercept, iters, torch.stack(hist), done)
