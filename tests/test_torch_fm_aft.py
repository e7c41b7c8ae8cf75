"""Factorization machines (``models/fm.py``), the Weibull AFT model
(``models/survival.py``) and their optimizer (``solvers.adam_scan``) held
against the JAX package on the CPU in both float policies, on the cases of
``tests/test_fm.py`` (single device) and ``tests/test_survival.py``:
planted interactions, the XOR quadrants, ``fit_linear=False``, masked rows
holding NaN or poisoned labels, every ``ValueError``, quantiles, and
save/load round trips in both directions.

Tolerances: the two packages round the same steps apart where XLA fuses a
multiply-add or sums in another order, and Adam's step m/√v turns a
rounding in a gradient near zero into a step of its own, so parameters are
held against the largest of their group (``close_norm``). Under the
float64 policy FM's loss history, parameters and predictions within 1e-6
of their scale, AFT's within rtol 1e-9; under the float32 policy (the JAX
side with x64 off) FM's within 1e-2 of their scale after up to 600 Adam
steps (the planted fit's noise-level weights wander there), AFT's within
rtol 1e-4; the XOR classifier's predictions exact. The planted
interaction's 600 float32 steps within 3e-2 of their scale: there the JAX
package's own float32 and float64 predictions differ by 1.7%.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.models import base as jbase
from sparkdq4ml_tpu.models import fm as jfm
from sparkdq4ml_tpu.models import solvers as jsolvers
from sparkdq4ml_tpu.models import survival as jsv
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import fm as tfm
from sparkdq4ml_tpu_torch.models import solvers as tsolvers
from sparkdq4ml_tpu_torch.models import survival as tsv

POLICIES = {"float64": SimpleNamespace(name="float64", rtol=1e-9, atol=1e-12,
                                       scale=1e-6),
            "float32": SimpleNamespace(name="float32", rtol=1e-4, atol=1e-6,
                                       scale=1e-2)}


@pytest.fixture(params=sorted(POLICIES))
def policy(request):
    pol = POLICIES[request.param]
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, pol.name)
    jfm._fm_fit_fn.cache_clear()
    jsv._aft_fit_fn.cache_clear()
    try:
        with jax.enable_x64(pol.name == "float64"), \
                float_policy(getattr(torch, pol.name)):
            yield pol
    finally:
        jax_config.default_float_dtype = old
        jfm._fm_fit_fn.cache_clear()
        jsv._aft_fit_fn.cache_clear()


def close(got, want, pol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=pol.rtol,
                               atol=pol.atol, err_msg=what)


def close_norm(got, want, pol, what=""):
    """Within ``pol.scale`` of the largest magnitude in ``want`` (or 1)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= pol.scale * max(float(np.max(np.abs(want))), 1.0), \
        f"{what}: off by {err}"


def frames(cols, mask=None):
    return (JFrame(dict(cols), mask=mask),
            TFrame(dict(cols), mask=mask, device="cpu"))


def interaction_data(n=500, d=6, seed=0, noise=0.05):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = (1.0 + 0.5 * X[:, 2] + 2.0 * X[:, 0] * X[:, 1]
         + noise * rng.normal(size=n))
    return X, y


def aft_data(n=250, seed=0, censor_frac=0.3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    eps = np.log(rng.exponential(size=n))
    t = np.exp(1.2 + X @ np.asarray([0.8, -0.5]) + 0.5 * eps)
    censor = (rng.random(n) > censor_frac).astype(np.float64)
    t_obs = np.where(censor == 1.0, t, t * rng.uniform(0.3, 1.0, size=n))
    return X, t_obs, censor


def same_fm(a, b, pol):
    close_norm(b.intercept, a.intercept, pol, "intercept")
    close_norm(b.linear, a.linear, pol, "linear")
    close_norm(b.factors, a.factors, pol, "factors")
    close_norm(b.loss_history, a.loss_history, pol, "loss history")


@pytest.mark.parametrize("kw", [
    dict(factor_size=4, max_iter=600, step_size=0.05, seed=1),
    dict(factor_size=3, max_iter=200, seed=1, reg_param=0.01),
    dict(factor_size=3, max_iter=50, fit_linear=False, seed=1),
    dict(factor_size=2, max_iter=80, fit_intercept=False, seed=5),
])
def test_fm_regressor_matches_the_reference(policy, kw):
    if policy.name == "float32" and kw["max_iter"] >= 600:
        # the planted fit's 600 float32 steps: the JAX package's own
        # float32 and float64 predictions differ by 1.7% of their scale
        policy = SimpleNamespace(**{**vars(policy), "scale": 3e-2})
    X, y = interaction_data()
    j, t = frames({"features": X, "label": y})
    a = jfm.FMRegressor(**kw).fit(j)
    b = tfm.FMRegressor(**kw).fit(t)
    same_fm(a, b, policy)
    if not kw.get("fit_linear", True):
        np.testing.assert_array_equal(b.linear, 0.0)
    close_norm(b.transform(t).to_pydict()["prediction"],
               a.transform(j).to_pydict()["prediction"], policy,
               "predictions")
    close_norm(b.predict(X[3]), a.predict(X[3]), policy, "predict")
    assert b.factor_size == b.factorSize == kw["factor_size"]


def test_fm_classifier_xor_matches_the_reference(policy):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(600, 2))
    y = (X[:, 0] * X[:, 1] > 0).astype(np.float64)
    j, t = frames({"features": X, "label": y})
    kw = dict(factor_size=4, max_iter=600, step_size=0.05, seed=1)
    a = jfm.FMClassifier(**kw).fit(j)
    b = tfm.FMClassifier(**kw).fit(t)
    same_fm(a, b, policy)
    da, db = a.transform(j).to_pydict(), b.transform(t).to_pydict()
    np.testing.assert_array_equal(db["prediction"], da["prediction"])
    assert np.mean(np.asarray(db["prediction"]) == y) > 0.9
    for col in ("probability", "rawPrediction"):
        close_norm(db[col], da[col], policy, col)
    np.testing.assert_allclose(np.asarray(db["probability"]).sum(axis=1),
                               1.0, rtol=1e-5)
    assert b.predict(X[0]) == a.predict(X[0])


def test_fm_masked_rows_are_excluded(policy):
    X, y = interaction_data(n=160, seed=5)
    keep = np.ones(160, bool)
    keep[::4] = False
    yp, Xp = y.copy(), X.copy()
    yp[~keep] = 1e6
    Xp[1::8][~keep[1::8]] = np.nan
    Xp[0, 0] = np.nan                       # a masked row (keep[0] False)
    kw = dict(factor_size=3, max_iter=150, seed=1)
    j, t = frames({"features": Xp, "label": yp}, keep)
    a = jfm.FMRegressor(**kw).fit(j)
    b = tfm.FMRegressor(**kw).fit(t)
    same_fm(a, b, policy)
    clean = tfm.FMRegressor(**kw).fit(TFrame({"features": X[keep],
                                              "label": y[keep]},
                                             device="cpu"))
    close_norm(clean.factors, b.factors, policy, "masked vs dropped rows")


def test_fm_checks_raise_as_in_the_reference():
    X, y = interaction_data(n=50)
    for M, F in ((jfm, JFrame), (tfm, TFrame)):
        kw = {} if F is JFrame else {"device": "cpu"}
        with pytest.raises(ValueError, match="binary"):
            M.FMClassifier(max_iter=5).fit(F({"features": X, "label": y},
                                             **kw))
        with pytest.raises(ValueError, match="factor_size"):
            M.FMRegressor(factor_size=0)
        with pytest.raises(ValueError, match="no valid rows"):
            M.FMRegressor(max_iter=5).fit(F({"features": X, "label": y},
                                            mask=np.zeros(50, bool), **kw))
        bad = X.copy()
        bad[2, 1] = np.inf
        with pytest.raises(ValueError, match="NaN/inf"):
            M.FMRegressor(max_iter=5).fit(F({"features": bad, "label": y},
                                            **kw))
        yb = y.copy()
        yb[4] = np.nan
        with pytest.raises(ValueError, match="label column"):
            M.FMRegressor(max_iter=5).fit(F({"features": X, "label": yb},
                                            **kw))
    with pytest.raises(NotImplementedError):
        tfm.FMRegressor(max_iter=5).fit(
            TFrame({"features": X, "label": y}, device="cpu"), mesh=object())


@pytest.mark.parametrize("cls", ["FMRegressor", "FMClassifier"])
def test_fm_models_round_trip_both_ways(tmp_path, cls):
    rng = np.random.default_rng(8)
    X = rng.normal(size=(60, 2))
    y = (X[:, 0] > 0).astype(np.float64)
    with jax.enable_x64(True), float_policy(torch.float64):
        a = getattr(jfm, cls)(factor_size=2, max_iter=50, seed=1).fit(
            JFrame({"features": X, "label": y}))
        a.save(str(tmp_path / "jax"))
        b = tbase.load_stage(str(tmp_path / "jax"))
        assert type(b).__name__ == type(a).__name__
        assert b.predict(X[0]) == pytest.approx(a.predict(X[0]))
        b.save(str(tmp_path / "torch"))
        c = jbase.load_stage(str(tmp_path / "torch"))
        np.testing.assert_array_equal(c.factors, a.factors)
        assert c.loss_history == a.loss_history


@pytest.mark.parametrize("kw", [dict(max_iter=300),
                                dict(max_iter=150, step_size=0.05)])
def test_aft_matches_the_reference(policy, kw):
    X, t, c = aft_data()
    j, tt = frames({"features": X, "label": t, "censor": c})
    a = jsv.AFTSurvivalRegression(**kw).fit(j)
    b = tsv.AFTSurvivalRegression(**kw).fit(tt)
    close(b.coefficients, a.coefficients, policy, "coefficients")
    close(b.intercept, a.intercept, policy, "intercept")
    close(b.scale, a.scale, policy, "scale")
    close(b.loss_history, a.loss_history, policy, "loss history")
    close(b.predict(X[0]), a.predict(X[0]), policy, "predict")


def test_aft_quantiles_match_the_reference(policy):
    X, t, c = aft_data()
    j, tt = frames({"features": X, "label": t, "censor": c})
    kw = dict(max_iter=300, quantile_probabilities=(0.25, 0.5, 0.75),
              quantiles_col="q")
    a = jsv.AFTSurvivalRegression(**kw).fit(j)
    b = tsv.AFTSurvivalRegression(**kw).fit(tt)
    close(b.predict_quantiles(X[0]), a.predict_quantiles(X[0]), policy,
          "predict_quantiles")
    qs = b.predictQuantiles(X[0])
    expect = b.predict(X[0]) * (-np.log1p(-np.asarray(
        [0.25, 0.5, 0.75]))) ** b.scale
    np.testing.assert_allclose(qs, expect, rtol=1e-9)
    da, db = a.transform(j).to_pydict(), b.transform(tt).to_pydict()
    assert np.asarray(db["q"]).shape == (250, 3)
    close(db["q"], da["q"], policy, "quantiles column")
    close(db["prediction"], da["prediction"], policy, "prediction")


def test_aft_masked_rows_contribute_nothing(policy):
    X, t, c = aft_data(n=100, seed=9)
    keep = np.ones(100, bool)
    keep[::5] = False
    tp, Xp = t.copy(), X.copy()
    tp[~keep] = np.nan
    Xp[0] = np.nan
    kw = dict(max_iter=150, step_size=0.05)
    j, tt = frames({"features": Xp, "label": tp, "censor": c}, keep)
    a = jsv.AFTSurvivalRegression(**kw).fit(j)
    b = tsv.AFTSurvivalRegression(**kw).fit(tt)
    close(b.coefficients, a.coefficients, policy, "masked coefficients")
    clean = tsv.AFTSurvivalRegression(**kw).fit(TFrame(
        {"features": X[keep], "label": t[keep], "censor": c[keep]},
        device="cpu"))
    close(clean.coefficients, b.coefficients, policy, "masked vs dropped")
    close(clean.scale, b.scale, policy, "scale")


def test_aft_checks_raise_as_in_the_reference():
    X, t, c = aft_data(n=40)
    for M, F in ((jsv, JFrame), (tsv, TFrame)):
        kw = {} if F is JFrame else {"device": "cpu"}

        def fit(t_, c_, X_=X, mask=None):
            return M.AFTSurvivalRegression(max_iter=10).fit(
                F({"features": X_, "label": t_, "censor": c_}, mask=mask,
                  **kw))
        bad = t.copy()
        bad[3] = -1.0
        with pytest.raises(ValueError, match="> 0"):
            fit(bad, c)
        bad[3] = np.inf
        with pytest.raises(ValueError, match="finite"):
            fit(bad, c)
        cb = c.copy()
        cb[5] = 0.5
        with pytest.raises(ValueError, match="censor"):
            fit(t, cb)
        Xb = X.copy()
        Xb[1, 0] = np.nan
        with pytest.raises(ValueError, match="NaN/inf"):
            fit(t, c, Xb)
        with pytest.raises(ValueError, match="no valid rows"):
            fit(t, c, mask=np.zeros(40, bool))
        with pytest.raises(ValueError, match="quantile"):
            M.AFTSurvivalRegression(quantile_probabilities=(0.5, 1.0))
        with pytest.raises(ValueError, match="non-empty"):
            M.AFTSurvivalRegression(quantile_probabilities=())
        assert M.AFTSurvivalRegression().setPredictionCol(
            "p").prediction_col == "p"


def test_aft_model_round_trips_both_ways(tmp_path):
    X, t, c = aft_data(n=60)
    with jax.enable_x64(True), float_policy(torch.float64):
        a = jsv.AFTSurvivalRegression(max_iter=100).fit(
            JFrame({"features": X, "label": t, "censor": c}))
        a.save(str(tmp_path / "jax"))
        b = tbase.load_stage(str(tmp_path / "jax"))
        assert isinstance(b, tsv.AFTSurvivalRegressionModel)
        assert b.predict(X[0]) == pytest.approx(a.predict(X[0]), rel=1e-12)
        b.save(str(tmp_path / "torch"))
        c2 = jbase.load_stage(str(tmp_path / "torch"))
        assert c2.scale == a.scale
        np.testing.assert_array_equal(c2.coefficients, a.coefficients)


def quadratic(params):
    a, b = params
    return ((a - 3.0) ** 2).sum() + ((b + 1.0) ** 2).sum() * 2.0 \
        + (a * b[0]).sum()


@pytest.mark.parametrize("grad_mask", [False, True])
def test_adam_scan_matches_the_reference(policy, grad_mask):
    """One optimizer over a tuple of tensors, with and without a gradient
    mask, against ``jax.lax.scan``'s Adam on the same objective."""
    dt = getattr(np, policy.name)
    a0 = np.asarray([0.5, -2.0, 4.0], dt)
    b0 = np.asarray([1.5, 0.25], dt)
    jm = (lambda g: (jnp.zeros_like(g[0]), g[1])) if grad_mask else None
    tm = (lambda g: (torch.zeros_like(g[0]), g[1])) if grad_mask else None
    (ja, jb), jh = jsolvers.adam_scan(
        jax.value_and_grad(quadratic), (jnp.asarray(a0), jnp.asarray(b0)),
        120, 0.05, grad_mask=jm)
    (ta, tb), th = tsolvers.adam_scan(
        tsolvers.psum_value_and_grad(quadratic),
        (torch.as_tensor(a0), torch.as_tensor(b0)), 120, 0.05, grad_mask=tm)
    assert th.dtype == getattr(torch, policy.name)
    close(ta, ja, policy, "a")
    close(tb, jb, policy, "b")
    close(th, jh, policy, "history")
    if grad_mask:
        np.testing.assert_array_equal(ta.numpy(), a0)
    with pytest.raises(NotImplementedError):
        tsolvers.psum_value_and_grad(quadratic, axis="data")
