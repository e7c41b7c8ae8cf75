"""The torch port's solvers and packed fit (``models/solvers.py``,
``parallel/distributed.py``) held against the JAX package's on the same
Gramians, in float64: coefficients, intercept and objective history within
rtol 1e-9, iteration counts exactly."""

import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.models import solvers as jax_solvers
from sparkdq4ml_tpu.parallel import distributed as jax_dist
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.models import solvers
from sparkdq4ml_tpu_torch.parallel import distributed

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _float64():
    with float_policy(torch.float64):
        yield


def _data(n, d, seed, mask_frac=0.2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(
        size=d)
    y = X @ rng.normal(size=d) + 2.0 + rng.normal(scale=0.5, size=n)
    mask = rng.random(n) > mask_frac
    return X, y, mask


def _gram(seed, n=200, d=3):
    Z = np.asarray(jax_dist.pack_design(*_data(n, d, seed)))
    return Z.T @ Z


def _same_result(port, ref):
    np.testing.assert_allclose(port.coefficients.numpy(),
                               np.asarray(ref.coefficients), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(float(port.intercept), float(ref.intercept),
                               rtol=RTOL)
    assert int(port.iterations) == int(ref.iterations)
    assert bool(port.converged) == bool(ref.converged)
    np.testing.assert_allclose(port.objective_history.numpy(),
                               np.asarray(ref.objective_history), rtol=RTOL,
                               atol=1e-14)


@pytest.mark.parametrize("seed,d", [(0, 1), (1, 3)])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_unpack_moments(seed, d, fit_intercept):
    A = _gram(seed, d=d)
    ref = jax_solvers.unpack_moments(A, fit_intercept=fit_intercept)
    got = solvers.unpack_moments(torch.as_tensor(A),
                                 fit_intercept=fit_intercept)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("reg,alpha", [(1.0, 1.0), (0.3, 0.5), (0.05, 1.0),
                                       (0.0, 0.0)])
@pytest.mark.parametrize("standardization", [True, False])
@pytest.mark.parametrize("d", [1, 3])
def test_fista_solve(reg, alpha, standardization, d):
    A = _gram(seed=10 + d, d=d)
    kw = dict(max_iter=40, tol=1e-6, fit_intercept=True,
              standardization=standardization)
    ref = jax_solvers.fista_solve(A, reg, alpha, **kw)
    _same_result(solvers.fista_solve(torch.as_tensor(A), reg, alpha, **kw),
                 ref)


def test_fista_without_intercept_and_constant_feature():
    X, y, mask = _data(100, 3, seed=4)
    X[:, 1] = 2.5                       # zero variance: stays at 0
    A = np.asarray(jax_dist.pack_design(X, y, mask))
    A = A.T @ A
    kw = dict(max_iter=60, tol=1e-9, fit_intercept=False)
    ref = jax_solvers.fista_solve(A, 0.2, 0.7, **kw)
    got = solvers.fista_solve(torch.as_tensor(A), 0.2, 0.7, **kw)
    _same_result(got, ref)
    assert got.coefficients[1].item() == 0.0


@pytest.mark.parametrize("reg", [0.0, 0.5])
@pytest.mark.parametrize("standardization", [True, False])
def test_normal_solve(reg, standardization):
    A = _gram(seed=21, d=3)
    ref = jax_solvers.normal_solve(A, reg, 0.0,
                                   standardization=standardization)
    got = solvers.normal_solve(torch.as_tensor(A), reg, 0.0,
                               standardization=standardization)
    _same_result(got, ref)


@pytest.mark.parametrize("solver,reg,alpha", [
    ("auto", 1.0, 1.0), ("auto", 1.0, 0.0), ("auto", 0.0, 1.0),
    ("normal", 0.5, 0.0), ("fista", 0.0, 0.0), ("owlqn", 1.0, 1.0),
    ("l-bfgs", 1.0, 0.5)])
def test_resolve_solver(solver, reg, alpha):
    assert solvers.resolve_solver(solver, reg, alpha) == \
        jax_solvers.resolve_solver(solver, reg, alpha)


@pytest.mark.parametrize("solver,reg,alpha", [("normal", 1.0, 1.0),
                                              ("newton", 0.0, 0.0)])
def test_resolve_solver_errors(solver, reg, alpha):
    with pytest.raises(ValueError):
        solvers.resolve_solver(solver, reg, alpha)


def test_pack_design():
    X, y, mask = _data(50, 2, seed=7)
    ref = np.asarray(jax_dist.pack_design(X, y, mask))
    got = distributed.pack_design(torch.as_tensor(X), torch.as_tensor(y),
                                  torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("solver", ["fista", "normal"])
def test_fused_linear_fit_packed(solver):
    X, y, mask = _data(300, 2, seed=8)
    Z = np.asarray(jax_dist.pack_design(X, y, mask))
    reg, alpha = (1.0, 1.0) if solver == "fista" else (0.5, 0.0)
    ref_fit = jax_dist.fused_linear_fit_packed(None, solver, 40, 1e-6, True,
                                               True)
    ref = np.asarray(ref_fit(Z, np.asarray([reg, alpha])))
    fit = distributed.fused_linear_fit_packed(solver, 40, 1e-6, True, True)
    got = fit(torch.as_tensor(Z), reg, alpha).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-14)
    r = distributed.unpack_fit_result(torch.as_tensor(got), 2)
    e = jax_dist.unpack_fit_result(ref, 2)
    assert r.iterations == e.iterations and r.converged == e.converged
    np.testing.assert_allclose(r.objective_history, e.objective_history,
                               rtol=RTOL)


def test_owlqn_not_ported_yet():
    """OWL-QN is ported now: the packed fit takes it, as the reference's
    does, and gives the reference's flat result."""
    X, y, mask = _data(300, 2, seed=9)
    Z = np.asarray(jax_dist.pack_design(X, y, mask))
    ref_fit = jax_dist.fused_linear_fit_packed(None, "owlqn", 40, 1e-6,
                                               True, True)
    ref = np.asarray(ref_fit(Z, np.asarray([0.5, 1.0])))
    fit = distributed.fused_linear_fit_packed("owlqn", 40, 1e-6, True, True)
    got = fit(torch.as_tensor(Z), 0.5, 1.0).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-14)
    with pytest.raises(ValueError, match="unknown solver"):
        distributed.fused_linear_fit_packed("newton", 40, 1e-6, True, True)
