"""The packed linear fit on one device (single-device subset of
``sparkdq4ml_tpu/parallel/distributed.py``).

``pack_design`` folds ``(X, y, mask)`` into one pre-masked design
``Z = [X, y, 1]·mask``; the fit takes one Gramian of ``Z`` through the
``packed_gram`` kernel (``ops/kernels.py``), runs the solver on it, and
returns one flat tensor ``[coef | intercept | iterations | converged |
objective_history]``, decoded on the host by :func:`unpack_fit_result`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.solvers import FitResult, fista_solve, normal_solve
from ..ops import kernels


def pack_design(X: torch.Tensor, y: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """``Z = [X, y, 1]·mask`` on the device of ``X``: all-zero rows stand for
    masked rows and contribute nothing to ``ZᵀZ``."""
    if X.ndim == 1:
        X = X[:, None]
    y = y.to(X.dtype)
    w = mask.to(X.dtype)
    Z = torch.cat([X, y[:, None], torch.ones_like(y)[:, None]], dim=1)
    return Z * w[:, None]


def fused_linear_fit_packed(solver: str, max_iter: int, tol: float,
                            fit_intercept: bool, standardization: bool):
    """The packed fit as one function ``fit(Z, reg_param,
    elastic_net_param) -> flat``. The solver is ``"fista"`` or
    ``"normal"`` (``resolve_solver``); OWL-QN is not ported yet."""
    if solver == "fista":
        def solve_A(A, reg, alpha):
            return fista_solve(A, reg, alpha, max_iter=max_iter, tol=tol,
                               fit_intercept=fit_intercept,
                               standardization=standardization)
    elif solver == "normal":
        def solve_A(A, reg, alpha):
            return normal_solve(A, reg, alpha, fit_intercept=fit_intercept,
                                standardization=standardization)
    else:
        raise NotImplementedError(
            f"solver {solver!r} is not ported to the torch package yet")

    def fit(Z: torch.Tensor, reg_param: float,
            elastic_net_param: float) -> torch.Tensor:
        r = solve_A(kernels.packed_gram(Z), float(reg_param),
                    float(elastic_net_param))
        dt = r.coefficients.dtype
        scalars = torch.stack([r.intercept.to(dt), r.iterations.to(dt),
                               r.converged.to(dt)])
        return torch.cat([r.coefficients, scalars,
                          r.objective_history.to(dt)])

    return fit


def unpack_fit_result(flat, d: int) -> FitResult:
    """Decode the packed fit output on the host (one device read)."""
    flat = flat.cpu().numpy() if isinstance(flat, torch.Tensor) \
        else np.asarray(flat)
    return FitResult(
        coefficients=flat[:d],
        intercept=flat[d],
        iterations=np.int32(flat[d + 1]),
        objective_history=flat[d + 3:],
        converged=bool(flat[d + 2]))
