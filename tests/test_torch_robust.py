"""Robust and weighted fits and OWL-QN in the torch port
(``models/solvers.py:huber_fit``/``solve``/``downgrade_solver``,
``models/owlqn.py``, ``models/regression.py``) held against the JAX package
on the CPU in float64: Huber fits within rtol 1e-6 with equal iteration
counts, weighted fits weighted Huber included; OWL-QN and ``solve`` within
rtol 1e-9 with equal iteration counts; the training summary's fields; and
``chip_smoke.py``'s Huber golden constants against the JAX package's
output."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from conftest import dataset_path, prepare_features, run_dq_pipeline
from sparkdq4ml_tpu.frame.frame import Frame as JaxFrame
from sparkdq4ml_tpu.models import LinearRegression as JaxLR
from sparkdq4ml_tpu.models import owlqn as jax_owlqn
from sparkdq4ml_tpu.models import solvers as jax_solvers
from sparkdq4ml_tpu.parallel import distributed as jax_dist
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame
from sparkdq4ml_tpu_torch.models import LinearRegression, owlqn, solvers

RTOL = 1e-9
HUBER_RTOL = 1e-6
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _float64():
    with float_policy(torch.float64):
        yield


def _data(n, d, seed, outliers=True):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(
        size=d)
    y = X @ rng.normal(size=d) + 2.0 + rng.normal(scale=0.5, size=n)
    if outliers:
        y[::13] += rng.normal(scale=10.0, size=len(y[::13]))
    mask = rng.random(n) > 0.2
    w = rng.uniform(0.5, 2.0, n)
    return X, y, mask, w


def _frames(n=300, d=2, seed=0):
    X, y, mask, w = _data(n, d, seed)
    cols = {"features": X, "label": y, "w": w}
    return Frame(cols, mask=mask, device="cpu"), JaxFrame(cols, mask=mask)


def _gram(seed, n=250, d=3):
    X, y, mask, _ = _data(n, d, seed, outliers=False)
    Z = np.asarray(jax_dist.pack_design(X, y, mask))
    return Z.T @ Z


def _t(a):
    return torch.as_tensor(np.asarray(a))


# -- Huber -------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kw", [
    dict(), dict(standardization=False), dict(reg_param=0.2),
    dict(fit_intercept=False), dict(epsilon=2.0, max_iter=60),
    dict(tol=1e-6, max_iter=300)])
def test_huber_fit(weighted, kw):
    X, y, mask, w = _data(400, 2, seed=len(kw) + 3 * weighted)
    m = mask * np.sqrt(w) if weighted else mask
    kw = {"max_iter": 100, **kw}
    ref = jax_solvers.huber_fit(X, y, m, **kw)
    got = solvers.huber_fit(_t(X), _t(y), _t(m), **kw)
    assert int(got[3]) == int(ref[3])
    for g, r in zip((got[0], got[1], got[2], got[4]),
                    (ref[0], ref[1], ref[2], ref[4])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   rtol=HUBER_RTOL, atol=1e-12)


@pytest.mark.parametrize("every", [1, 3, 1000])
def test_huber_host_check_interval_changes_nothing(monkeypatch, every):
    X, y, mask, _ = _data(300, 2, seed=21, outliers=False)
    base = solvers.huber_fit(_t(X), _t(y), _t(mask), max_iter=300,
                             tol=1e-6)
    monkeypatch.setattr(solvers, "HUBER_CHECK_EVERY", every)
    got = solvers.huber_fit(_t(X), _t(y), _t(mask), max_iter=300, tol=1e-6)
    assert int(got[3]) == int(base[3]) < 300
    for g, b in zip(got, base):
        torch.testing.assert_close(g, b, rtol=0, atol=0)


def test_huber_on_dataset_full(session):
    from sparkdq4ml_tpu.models import LinearRegression as JLR

    jdf = prepare_features(run_dq_pipeline(session, dataset_path("full")))
    ref = JLR(loss="huber", max_iter=100).fit(jdf)
    cols = jdf.to_pydict()
    df = Frame({"features": cols["features"], "label": cols["label"]},
               device="cpu")
    got = LinearRegression(loss="huber", max_iter=100).fit(df)
    np.testing.assert_allclose(got.coefficients, ref.coefficients,
                               rtol=HUBER_RTOL)
    assert got.intercept == pytest.approx(ref.intercept, rel=HUBER_RTOL)
    assert got.scale == pytest.approx(ref.scale, rel=HUBER_RTOL)
    assert got.summary.totalIterations == ref.summary.totalIterations == 80
    assert got.summary.rootMeanSquaredError == pytest.approx(
        ref.summary.rootMeanSquaredError, rel=HUBER_RTOL)


@pytest.mark.parametrize("loss,solver,alpha", [
    ("squaredError", "auto", 0.0), ("squaredError", "auto", 1.0),
    ("squaredError", "normal", 0.0), ("squaredError", "l-bfgs", 0.5),
    ("huber", "auto", 0.0)])
def test_weighted_fit(loss, solver, alpha):
    df, jdf = _frames(seed=4)
    kw = dict(weight_col="w", loss=loss, max_iter=80, solver=solver,
              reg_param=0.1, elastic_net_param=alpha)
    got = LinearRegression(**kw).fit(df)
    ref = JaxLR(**kw).fit(jdf)
    tol = HUBER_RTOL if loss == "huber" else RTOL
    np.testing.assert_allclose(got.coefficients, ref.coefficients, rtol=tol)
    assert got.intercept == pytest.approx(ref.intercept, rel=tol)
    assert got.scale == pytest.approx(ref.scale, rel=tol)
    assert got.summary.totalIterations == ref.summary.totalIterations


def test_integer_weight_is_a_repeated_row():
    X, y, mask, _ = _data(120, 2, seed=8)
    w = np.where(np.arange(120) % 5 == 0, 3.0, 1.0)
    df = Frame({"features": X, "label": y, "w": w}, mask=mask, device="cpu")
    rep = np.repeat(np.arange(120), w.astype(int))
    dup = Frame({"features": X[rep], "label": y[rep]}, mask=mask[rep],
                device="cpu")
    a = LinearRegression(weight_col="w", solver="normal").fit(df)
    b = LinearRegression(solver="normal").fit(dup)
    np.testing.assert_allclose(a.coefficients, b.coefficients, rtol=1e-9)


@pytest.mark.parametrize("bad", [-1.0, np.nan])
def test_negative_or_nan_weight_on_a_valid_row_raises(bad):
    df, _ = _frames(n=50, seed=1)
    w = np.ones(50)
    w[np.flatnonzero(df.mask.numpy())[0]] = bad
    with pytest.raises(ValueError, match="nonnegative"):
        LinearRegression(weight_col="w").fit(df.with_column("w", w))
    # the same value on a masked row is never read
    w = np.ones(50)
    w[np.flatnonzero(~df.mask.numpy())[0]] = bad
    LinearRegression(weight_col="w").fit(df.with_column("w", w))


def test_huber_rejects_l1():
    df, _ = _frames(n=50)
    with pytest.raises(ValueError, match="L2"):
        LinearRegression(loss="huber", elastic_net_param=0.5).fit(df)
    with pytest.raises(ValueError, match="unknown loss"):
        LinearRegression(loss="absolute")


# -- OWL-QN, solve, downgrade_solver -----------------------------------------

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


@pytest.mark.parametrize("reg,alpha", [(1.0, 1.0), (0.3, 0.5), (0.05, 1.0),
                                       (0.01, 0.2), (0.0, 0.0)])
@pytest.mark.parametrize("standardization", [True, False])
@pytest.mark.parametrize("d", [1, 3, 12])
def test_owlqn_solve(reg, alpha, standardization, d):
    A = _gram(seed=30 + d, d=d, n=60 * d)
    kw = dict(max_iter=40, tol=1e-9, fit_intercept=True,
              standardization=standardization)
    ref = jax_owlqn.owlqn_solve(A, reg, alpha, **kw)
    _same_result(owlqn.owlqn_solve(torch.as_tensor(A), reg, alpha, **kw),
                 ref)


def test_owlqn_wraps_its_history_and_skips_constant_features():
    """Enough iterations to wrap the rolling history of 10 pairs, with a
    zero-variance feature and no intercept."""
    X, y, mask, _ = _data(300, 14, seed=6, outliers=False)
    X[:, 3] = 1.5
    Z = np.asarray(jax_dist.pack_design(X, y, mask))
    A = Z.T @ Z
    kw = dict(max_iter=60, tol=1e-14, fit_intercept=False)
    ref = jax_owlqn.owlqn_solve(A, 0.02, 0.3, **kw)
    got = owlqn.owlqn_solve(torch.as_tensor(A), 0.02, 0.3, **kw)
    assert int(ref.iterations) > owlqn.HISTORY
    _same_result(got, ref)
    assert got.coefficients[3].item() == 0.0


@pytest.mark.parametrize("solver,reg,alpha", [
    ("auto", 1.0, 1.0), ("auto", 0.5, 0.0), ("normal", 0.2, 0.0),
    ("fista", 0.3, 0.5), ("owlqn", 0.3, 0.5), ("l-bfgs", 1.0, 1.0)])
def test_solve(solver, reg, alpha):
    A = _gram(seed=40)
    args = (reg, alpha)
    kw = dict(max_iter=50, tol=1e-8, fit_intercept=True,
              standardization=True, solver=solver)
    ref = jax_solvers.solve(A, *args, **kw)
    _same_result(solvers.solve(torch.as_tensor(A), *args, **kw), ref)


@pytest.mark.parametrize("name", ["owlqn", "fista", "normal", "other"])
@pytest.mark.parametrize("reg,alpha", [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0),
                                       (1.0, 1.0), (0.5, 0.5)])
def test_downgrade_solver(name, reg, alpha):
    assert solvers.downgrade_solver(name, reg, alpha) == \
        jax_solvers.downgrade_solver(name, reg, alpha)


@pytest.mark.parametrize("solver", ["l-bfgs", "normal"])
def test_fit_from_gram(solver):
    df, jdf = _frames(seed=12)
    A = _gram(seed=12, d=2)
    kw = dict(solver=solver, max_iter=40, reg_param=0.3,
              elastic_net_param=1.0 if solver == "l-bfgs" else 0.0)
    got = LinearRegression(**kw).fit_from_gram(torch.as_tensor(A), df)
    ref = JaxLR(**kw).fit_from_gram(A, jdf)
    np.testing.assert_allclose(got.coefficients, ref.coefficients, rtol=RTOL)
    assert got.intercept == pytest.approx(ref.intercept, rel=RTOL)
    assert got.summary.totalIterations == ref.summary.totalIterations


def test_lbfgs_app_fit_matches_fista_and_the_reference(session):
    jdf = prepare_features(run_dq_pipeline(session, dataset_path("full")))
    cols = jdf.to_pydict()
    df = Frame({"features": cols["features"], "label": cols["label"]},
               device="cpu")
    kw = dict(max_iter=40, reg_param=1.0, elastic_net_param=1.0)
    got = LinearRegression(solver="l-bfgs", **kw).fit(df)
    ref = JaxLR(solver="l-bfgs", **kw).fit(jdf)
    fista = LinearRegression(**kw).fit(df)
    np.testing.assert_allclose(got.coefficients, ref.coefficients, rtol=RTOL)
    assert got.summary.totalIterations == ref.summary.totalIterations
    np.testing.assert_allclose(got.coefficients, fista.coefficients,
                               rtol=1e-3)


# -- estimator surface and summary -------------------------------------------

def test_setters_getters_and_params_match():
    kw = dict(max_iter=7, reg_param=0.1, elastic_net_param=0.4, tol=1e-5,
              fit_intercept=False, standardization=False, solver="l-bfgs",
              features_col="f", label_col="l", prediction_col="p",
              weight_col="w", aggregation_depth=3)
    got = LinearRegression()
    ref = JaxLR()
    for name, v in kw.items():
        setter = "set" + "".join(p.title() for p in name.split("_"))
        assert getattr(got, setter)(v) is got
        getattr(ref, setter)(v)
    assert got._params_dict() == ref._params_dict()
    for g in ("MaxIter", "RegParam", "ElasticNetParam", "Tol",
              "FitIntercept", "Standardization", "Solver"):
        assert getattr(got, "get" + g)() == getattr(ref, "get" + g)()


def test_training_summary_fields(session):
    jdf = prepare_features(run_dq_pipeline(session, dataset_path("full")))
    cols = jdf.to_pydict()
    df = Frame({"features": cols["features"], "label": cols["label"]},
               device="cpu")
    got = LinearRegression(solver="normal").fit(df)
    ref = JaxLR(solver="normal").fit(jdf)
    s, r = got.summary, ref.summary
    assert got.has_summary and got.hasSummary
    assert got.num_features == ref.num_features == 1
    assert s.num_instances == s.numInstances == r.num_instances == 1024
    assert s.degrees_of_freedom == s.degreesOfFreedom == \
        r.degrees_of_freedom
    for name in ("mean_absolute_error", "explained_variance", "r2adj",
                 "meanSquaredError"):
        assert getattr(s, name) == pytest.approx(getattr(r, name), rel=RTOL)
    for name in ("coefficient_standard_errors", "t_values", "p_values"):
        np.testing.assert_allclose(getattr(s, name), getattr(r, name),
                                   rtol=1e-7)
    np.testing.assert_array_equal(s.pValues, s.p_values)
    np.testing.assert_allclose(
        s.predictions.to_pydict()["prediction"],
        r.predictions.to_pydict()["prediction"], rtol=RTOL)
    with pytest.raises(ValueError, match="training summary"):
        got.evaluate(df).t_values
    penalized = LinearRegression(reg_param=0.5).fit(df)
    with pytest.raises(ValueError, match="unpenalized"):
        penalized.summary.p_values


def test_chip_smoke_huber_goldens_are_the_reference_output(session):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    jdf = prepare_features(run_dq_pipeline(session, dataset_path("full")))
    ref = JaxLR(loss="huber", max_iter=100).fit(jdf)
    golden = smoke.HUBER_GOLDEN
    assert golden["coef"] == pytest.approx(float(ref.coefficients[0]),
                                           rel=1e-6)
    assert golden["intercept"] == pytest.approx(ref.intercept, rel=1e-6)
    assert golden["scale"] == pytest.approx(ref.scale, rel=1e-6)
    assert golden["iterations"] == ref.summary.totalIterations
