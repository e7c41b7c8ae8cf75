"""The packed linear fit on one device (single-device subset of
``sparkdq4ml_tpu/parallel/distributed.py``).

``pack_design`` folds ``(X, y, mask)`` into one pre-masked design
``Z = [X, y, 1]·mask``; the fit takes one Gramian of ``Z`` through the
``packed_gram`` kernel (``ops/kernels.py``), runs the solver on it, and
returns one flat tensor ``[coef | intercept | iterations | converged |
objective_history]``, decoded on the host by :func:`unpack_fit_result`
(the binomial logistic and SVC fits return the same layout).
``pack_design_weighted`` is the weighted classifiers' design, whose last
column carries the instance weights.
:func:`compute_gram` is the augmented Gramian of ``(X, y, mask)`` through
the ``masked_gram`` kernel. The mesh (sharded) halves of both wait for the
port of ``parallel/mesh.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.solvers import FitResult, augmented_gram, run_solver
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


def pack_design_weighted(X: torch.Tensor, y: torch.Tensor,
                         mask: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The packed design of weighted fits, ``Z = [X, y, w]·mask``: the
    mask zeroes invalid rows as in :func:`pack_design`, and the last column
    carries the real instance weights (the weighted logistic and softmax
    fits read them from there, ``classification._unpack_zw``)."""
    if X.ndim == 1:
        X = X[:, None]
    Z = torch.cat([X, y.to(X.dtype)[:, None], w.to(X.dtype)[:, None]],
                  dim=1)
    return Z * mask.to(X.dtype)[:, None]


def fused_linear_fit_packed(solver: str, max_iter: int, tol: float,
                            fit_intercept: bool, standardization: bool):
    """The packed fit as one function ``fit(Z, reg_param,
    elastic_net_param) -> flat``. The solver is ``"fista"``, ``"normal"``
    or ``"owlqn"`` (``resolve_solver``)."""
    if solver not in ("normal", "fista", "owlqn"):
        raise ValueError(f"unknown solver {solver!r}")

    def fit(Z: torch.Tensor, reg_param: float,
            elastic_net_param: float) -> torch.Tensor:
        return pack_fit_result(run_solver(
            solver, kernels.packed_gram(Z), float(reg_param),
            float(elastic_net_param), max_iter, tol, fit_intercept,
            standardization))

    return fit


def pack_fit_result(r: FitResult) -> torch.Tensor:
    """One flat tensor ``[coef | intercept | iterations | converged |
    objective_history]`` of a device ``FitResult``, for one host read."""
    dt = r.coefficients.dtype
    scalars = torch.stack([r.intercept.to(dt), r.iterations.to(dt),
                           r.converged.to(dt)])
    return torch.cat([r.coefficients, scalars, r.objective_history.to(dt)])


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


def compute_gram(X: torch.Tensor, y: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Augmented Gramian ``A`` of the valid rows, on the device of ``X``:
    one ``masked_gram`` launch on the card. The mask is read as a boolean,
    as the reference's single-device path does."""
    if X.ndim == 1:
        X = X[:, None]
    return augmented_gram(X, y, torch.as_tensor(mask).to(torch.bool))
