"""Elastic-net and Huber linear solvers on sufficient statistics (port of
``sparkdq4ml_tpu/models/solvers.py``).

A squared-error fit touches the data once, for the augmented Gramian
``A = ZᵀZ`` with ``Z = [X, y, 1]·mask``. Counts, means, sample stds, the
standardized Gram matrix ``G``, the correlation vector ``b`` and the label
energy all unpack from ``A``, and the solver loop then runs on the
``(d×d)`` statistics on the device of ``A``, with no host round trip inside
the loop.

Every solver here takes a Gramian with leading batch axes, ``(..., D, D)``,
with ``reg_param`` and ``elastic_net_param`` as floats or as tensors of
the batch shape: the cross-validation grid solves all its (param × fold)
cells in one loop, where the JAX package vmaps them.

Numeric convention (MLlib's): sample std (n−1 denominator); the solve runs
in standardized space with ``effectiveRegParam = regParam/σ_y``; with
``standardization=False`` the penalty lands on the raw coefficients;
unscale ``w_j = ŵ_j σ_y/σ_xj`` and ``intercept = ȳ − w·x̄``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops import kernels

# The Huber loop reads its stop flag back to the host once every this many
# steps; the steps in between freeze once the flag drops, so the results
# equal a loop that checks every step.
HUBER_CHECK_EVERY = 10


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


def _c(t: torch.Tensor) -> torch.Tensor:
    """A batch of scalars as a column, to broadcast against vectors."""
    return t[..., None]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def augmented_gram(X: torch.Tensor, y: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """One-pass masked statistics: ``A = (Z·w)ᵀ(Z·w)``, ``Z = [X, y, 1]``,
    ``w`` the mask (boolean, or a float weight such as ``sqrt(w)``), shape
    ``(d+2, d+2)``. Runs the ``masked_gram`` kernel on a CUDA tensor and
    its plain version on a CPU tensor."""
    if mask.dtype != torch.bool:
        mask = mask.to(X.dtype)
    return kernels.masked_gram(X, y.to(X.dtype), mask)


def unpack_moments(A: torch.Tensor, fit_intercept: bool = True) -> Moments:
    """A -> means, stds and the standardized Gram, in the reference's
    algebra and order (centered moments as ``A − n·mean²``)."""
    d = A.shape[-1] - 2
    n = A[..., d + 1, d + 1]
    mean_x = A[..., :d, d + 1] / _c(n)
    mean_y = A[..., d, d + 1] / n
    Cxx = A[..., :d, :d] - _c(_c(n)) * (_c(mean_x) * mean_x[..., None, :])
    Cxy = A[..., :d, d] - _c(n) * mean_x * _c(mean_y)
    Cyy = A[..., d, d] - n * mean_y * mean_y
    denom = torch.clamp(n - 1.0, min=1.0)
    var_x = torch.clamp(torch.diagonal(Cxx, dim1=-2, dim2=-1),
                        min=0.0) / _c(denom)
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
        Cxx, Cxy, Cyy = A[..., :d, :d], A[..., :d, d], A[..., d, d]
    G = Cxx / (_c(_c(n)) * (_c(sx) * sx[..., None, :]))
    b = torch.where(valid, Cxy / (_c(n) * sx * _c(sy)), A.new_zeros(()))
    yy = Cyy / (n * sy * sy)
    # Invalid (constant) features never move off 0.
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    G = torch.where(_c(valid) & valid[..., None, :], G, eye)
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


def _penalties(A: torch.Tensor, m: Moments, reg_param, elastic_net_param,
               standardization: bool):
    """``(lam1, lam2)`` per feature: the L1 and L2 weights of the
    standardized objective."""
    dt = A.dtype
    reg = torch.as_tensor(reg_param, dtype=dt, device=A.device)
    alpha = torch.as_tensor(elastic_net_param, dtype=dt, device=A.device)
    eff = reg / torch.where(m.std_y > 0, m.std_y, A.new_ones(()))
    u1, u2 = _penalty_weights(m, standardization)
    return _c(alpha * eff) * u1, _c((1.0 - alpha) * eff) * u2


def _objective(w, m: Moments, lam1, lam2):
    f = 0.5 * (m.yy - 2.0 * _dot(m.b, w) + _dot(_matvec(m.G, w), w))
    return f + (lam1 * torch.abs(w)).sum(-1) + 0.5 * (lam2 * w * w).sum(-1)


def _soft(x, t):
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def _unscale(w, m: Moments, fit_intercept: bool):
    one = m.std_x.new_ones(())
    sx = torch.where(m.valid, m.std_x, one)
    sy = torch.where(m.std_y > 0, m.std_y, one)
    coef = torch.where(m.valid, w * _c(sy) / sx, m.std_x.new_zeros(()))
    intercept = (m.mean_y - _dot(coef, m.mean_x) if fit_intercept
                 else torch.zeros_like(m.mean_y))
    return coef, intercept


def fista_solve(A: torch.Tensor, reg_param, elastic_net_param,
                max_iter: int = 100, tol: float = 1e-6,
                fit_intercept: bool = True, standardization: bool = True,
                record_history: bool = True) -> FitResult:
    """Accelerated proximal gradient (FISTA) on the standardized objective.

    The reference's ``lax.scan`` becomes a fixed loop of ``max_iter``
    steps; the ``done`` flag freezes the state with tensor ``where``s, so
    the loop never reads a value back to the host and ``iterations`` and
    ``objective_history`` match the reference. ``objective_history[0]`` is
    the objective at w = 0; ``record_history=False`` keeps only that entry
    (the cross-validation cells need no trace)."""
    m = unpack_moments(A, fit_intercept=fit_intercept)
    lam1, lam2 = _penalties(A, m, reg_param, elastic_net_param,
                            standardization)
    # Lipschitz bound: ‖G‖₂ ≤ ‖G‖_F for PSD G; + the largest ridge term.
    L = (torch.linalg.matrix_norm(m.G)
         + torch.clamp(lam2.amax(-1), min=0.0) + 1e-12)
    step = _c(1.0 / L)

    w = torch.zeros_like(m.b)
    w_prev = w
    t = torch.ones_like(m.yy)
    done = torch.zeros_like(m.yy, dtype=torch.bool)
    iters = torch.zeros_like(m.yy, dtype=torch.int32)
    obj0 = _objective(w, m, lam1, lam2)
    last_obj = obj0
    hist = [obj0]
    for _ in range(max_iter):
        tn = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        v = w + _c((t - 1.0) / tn) * (w - w_prev)
        grad = _matvec(m.G, v) - m.b + lam2 * v
        w_new = _soft(v - step * grad, step * lam1)
        w_new = torch.where(m.valid, w_new, A.new_zeros(()))
        obj = _objective(w_new, m, lam1, lam2)
        # MLlib-style relative-improvement convergence test
        rel = torch.abs(obj - last_obj) / torch.clamp(torch.abs(last_obj),
                                                       min=1e-12)
        now_done = done | (rel < tol)
        w, w_prev = (torch.where(_c(done), w, w_new),
                     torch.where(_c(done), w_prev, w))
        t = torch.where(done, t, tn)
        last_obj = torch.where(done, last_obj, obj)
        iters = iters + (~done).to(torch.int32)
        if record_history:
            hist.append(last_obj)
        done = now_done

    coef, intercept = _unscale(w, m, fit_intercept)
    return FitResult(coef, intercept, iters, torch.stack(hist, dim=-1), done)


def normal_solve(A: torch.Tensor, reg_param, elastic_net_param=0.0,
                 fit_intercept: bool = True,
                 standardization: bool = True) -> FitResult:
    """Closed form (normal equations), MLlib's ``solver="normal"``: valid
    when there is no L1 term. One small linear solve on the device."""
    m = unpack_moments(A, fit_intercept=fit_intercept)
    _, lam2 = _penalties(A, m, reg_param, elastic_net_param, standardization)
    w = torch.linalg.solve(m.G + torch.diag_embed(lam2), m.b)
    w = torch.where(m.valid, w, A.new_zeros(()))
    coef, intercept = _unscale(w, m, fit_intercept)
    return FitResult(coef, intercept,
                     torch.zeros_like(m.yy, dtype=torch.int32),
                     A.new_zeros(m.yy.shape + (1,)),
                     torch.ones_like(m.yy, dtype=torch.bool))


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


def downgrade_solver(solver_name: str, reg_param: float,
                     elastic_net_param: float) -> Optional[str]:
    """The closed-form solver an iterative one (``owlqn``/``fista``) could
    give way to: ``normal``, but only when no L1 term is active (the normal
    equations cannot express the L1 penalty, MLlib's restriction); ``None``
    when there is none. ``LinearRegression.fit``'s ``fit_packed`` ladder
    takes it as its last rung."""
    has_l1 = (reg_param > 0.0) and (elastic_net_param > 0.0)
    if solver_name in ("owlqn", "fista") and not has_l1:
        return "normal"
    return None


def run_solver(name: str, A: torch.Tensor, reg_param, elastic_net_param,
               max_iter: int, tol: float, fit_intercept: bool,
               standardization: bool) -> FitResult:
    """Run the resolved solver ``name`` (``normal``, ``fista`` or
    ``owlqn``) on ``A``; the params may be device scalars."""
    if name == "normal":
        return normal_solve(A, reg_param, elastic_net_param,
                            fit_intercept=fit_intercept,
                            standardization=standardization)
    if name == "fista":
        iterative = fista_solve
    elif name == "owlqn":
        from .owlqn import owlqn_solve as iterative
    else:
        raise ValueError(f"unknown solver {name!r}")
    return iterative(A, reg_param, elastic_net_param, max_iter=max_iter,
                     tol=tol, fit_intercept=fit_intercept,
                     standardization=standardization)


def solve(A: torch.Tensor, reg_param: float, elastic_net_param: float,
          max_iter: int, tol: float, fit_intercept: bool,
          standardization: bool, solver: str = "auto") -> FitResult:
    """Solver dispatch on a precomputed Gramian (see
    :func:`resolve_solver`). The ``solver`` fault site: a due device error
    raises before the solve, a due NaN poisons its result."""
    from ..utils import faults as _faults

    _faults.inject("solver")
    result = run_solver(resolve_solver(solver, reg_param, elastic_net_param),
                        A, reg_param, elastic_net_param, max_iter, tol,
                        fit_intercept, standardization)
    return _faults.corrupt("solver", result)


def huber_fit(X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
              epsilon: float = 1.35, reg_param: float = 0.0,
              fit_intercept: bool = True, max_iter: int = 500,
              tol: float = 1e-8, standardization: bool = True):
    """MLlib's ``loss="huber"`` robust regression: joint minimization of
    Huber's concomitant-scale objective (Owen 2007)

        L(beta, sigma) = sum_i m_i (sigma + H_eps(r_i / sigma) * sigma)
                         + reg_param * n/2 * ||beta * s||^2,
        r_i = y_i - x_i.beta - c

    over (beta, intercept, log sigma) with full-batch Adam, from the OLS
    solution (one ``augmented_gram``). The robust loss has no Gramian
    statistic, so every step reads the rows again.

    The objective and gradient are the reference's in closed form. With
    ``z = r/sigma`` and ``zc = clamp(z, -eps, eps)``: ``H(z) = zc(2z − zc)``
    (z² inside, 2·eps·|z| − eps² outside), ``H'(z) = 2·zc`` (the branch
    ``jnp.where`` differentiates, so no tie at 0 arises) and
    ``H − z·H' = −zc²``. A step is then about a dozen passes over the rows
    instead of one per elementwise term of the reference's form, and Adam
    runs on one flat vector ``[beta, intercept, log sigma]``.

    The objective, and so the stop test ``|Δobj| ≤ tol·(1 + |obj|)``, is
    summed in float64 whatever the input dtype: on a 10⁷-row table the
    reference's stop rule meets its threshold within a few units of an
    objective of about 10⁷, which a float32 sum does not resolve, and a
    stop one step off moves the fit by about Adam's step (≈1e-3 relative).

    The reference's ``while_loop`` becomes blocks of ``HUBER_CHECK_EVERY``
    steps in which a step whose stop test fails changes nothing, with one
    host read of the stop flag after each block: the same parameters,
    iteration count and final objective as a loop that tests every step,
    at one device read per block instead of one per step.
    Returns (coefficients, intercept, sigma, iterations, objective), all
    tensors on the device of ``X``."""
    fdt = X.dtype
    y = y.to(fdt)
    # The mask is in the Gramian's convention (bool, or sqrt(w) for a
    # weighted fit); the robust objective weights rows linearly.
    mf = mask.to(fdt)
    m = mf * mf
    n = torch.clamp(m.sum(), min=1.0)
    d = X.shape[1]

    A = augmented_gram(X, y, mask)
    moments = unpack_moments(A, fit_intercept)
    pen = (moments.std_x.to(fdt) if standardization
           else torch.ones(d, dtype=fdt, device=X.device))
    ols = normal_solve(A, 0.0, 0.0, fit_intercept=fit_intercept)
    b0, c0 = ols.coefficients, ols.intercept
    r0 = (y - X @ b0 - c0) * m
    s0 = torch.log(torch.clamp(torch.sqrt(torch.sum(r0 * r0) / n),
                               min=1e-6))
    eps = torch.as_tensor(epsilon, dtype=fdt, device=X.device)
    ridge = reg_param * n

    def objective_and_grad(theta):
        b, c, ls = theta[:d], theta[d], theta[d + 1]
        sigma = torch.exp(ls)
        z = (y - X @ b - (c if fit_intercept else 0.0)) / sigma
        zc = torch.clamp(z, -eps, eps)
        mzc = m * zc
        # m(1 − zc²) row by row before any sum: its total is near 0 at the
        # optimum, and a difference of two sums of about n would leave only
        # rounding there in float32.
        u = torch.addcmul(m, mzc, zc, value=-1.0)
        rows = torch.addcmul(u, mzc, z, value=2.0)       # m(1 + H(z))
        obj = (sigma.double() * rows.sum(dtype=torch.float64)
               + (ridge * 0.5 * torch.sum((b * pen) ** 2)).double())
        gc = -2.0 * mzc.sum() if fit_intercept else sigma.new_zeros(())
        grad = torch.cat([ridge * b * pen * pen - 2.0 * (X.T @ mzc),
                          torch.stack([gc, sigma * u.sum()])])
        return obj, grad

    theta = torch.cat([b0, torch.stack([c0, s0])])
    obj, grad = objective_and_grad(theta)
    mom = torch.zeros_like(theta)
    vel = mom
    prev = torch.full_like(obj, float("inf"))
    i = torch.zeros((), dtype=torch.int64, device=X.device)

    def running():
        return (i < max_iter) & (torch.abs(prev - obj)
                                 > tol * (1 + torch.abs(obj)))

    steps = 0
    while steps < max_iter:
        for _ in range(min(HUBER_CHECK_EVERY, max_iter - steps)):
            go = running()
            t = (i + 1).to(fdt)
            lr = 0.05 * torch.clamp(10.0 / t, max=1.0)
            mom_n = 0.9 * mom + 0.1 * grad
            vel_n = 0.999 * vel + 0.001 * grad * grad
            step = (lr * (mom_n / (1 - torch.pow(0.9, t)))
                    / (torch.sqrt(vel_n / (1 - torch.pow(0.999, t)))
                       + 1e-9))
            obj_n, grad_n = objective_and_grad(theta - step)
            theta = torch.where(go, theta - step, theta)
            mom = torch.where(go, mom_n, mom)
            vel = torch.where(go, vel_n, vel)
            grad = torch.where(go, grad_n, grad)
            prev, obj = torch.where(go, obj, prev), torch.where(go, obj_n,
                                                                obj)
            i = i + go.to(i.dtype)
            steps += 1
        if not bool(running()):         # the one host read of the block
            break
    intercept = theta[d] if fit_intercept else theta.new_zeros(())
    return (theta[:d], intercept, torch.exp(theta[d + 1]),
            i.to(torch.int32), obj.to(fdt))


def psum_value_and_grad(local_objective, axis=None):
    """``value_and_grad`` of ``local_objective`` through ``torch.autograd``
    (the JAX package's ``psum_value_and_grad`` with ``axis=None``): returns
    ``vg(params) -> (loss, grads)`` for a tensor or a tuple of tensors,
    ``grads`` of the same structure. A data axis to reduce over is not
    ported: the port fits on one device."""
    if axis is not None:
        raise NotImplementedError("psum_value_and_grad: reductions over a "
                                  "mesh axis are not ported")

    def vg(params):
        single = isinstance(params, torch.Tensor)
        leaves = [p.detach().requires_grad_(True)
                  for p in ((params,) if single else params)]
        with torch.enable_grad():
            loss = local_objective(leaves[0] if single else tuple(leaves))
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), (grads[0] if single else tuple(grads))
    return vg


def adam_scan(value_and_grad, params0, max_iter: int, lr: float,
              grad_mask=None, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8):
    """Full-batch Adam (bias-corrected) over a tensor or a tuple of
    tensors: the JAX package's ``lax.scan`` as a Python loop of device
    steps with no host read inside. ``value_and_grad(params) -> (loss,
    grads)``; ``grad_mask`` optionally transforms the gradients (zeroing
    frozen groups). The constants and the step count ``t`` are tensors in
    the parameters' dtype, so ``b1 ** t`` is a power in that dtype and
    every divisor a tensor (a divisor given as a Python number would run
    as a product with its reciprocal on the card). Returns (params, loss
    history), the history on the device."""
    single = isinstance(params0, torch.Tensor)
    p = [params0] if single else list(params0)
    dt, dev = p[0].dtype, p[0].device

    def c(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    cb1, cb2, c1b1, c1b2 = c(b1), c(b2), c(1 - b1), c(1 - b2)
    clr, ceps, one = c(lr), c(eps), c(1.0)
    t = torch.arange(max_iter, dtype=dt, device=dev) + one
    bc1 = one - torch.pow(cb1, t)
    bc2 = one - torch.pow(cb2, t)
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    history = []
    for i in range(max_iter):
        loss, g = value_and_grad(p[0] if single else tuple(p))
        if grad_mask is not None:
            g = grad_mask(g)
        g = [g] if single else list(g)
        m = [cb1 * a + c1b1 * b for a, b in zip(m, g)]
        v = [cb2 * a + c1b2 * b * b for a, b in zip(v, g)]
        p = [x - clr * (a / bc1[i]) / (torch.sqrt(b / bc2[i]) + ceps)
             for x, a, b in zip(p, m, v)]
        history.append(loss)
    hist = (torch.stack(history) if history
            else torch.zeros((0,), dtype=dt, device=dev))
    return (p[0] if single else tuple(p)), hist
