"""GeneralizedLinearRegression of the torch port (``models/glm.py``) held
against the JAX package on the CPU: every family x link the JAX package
accepts and the Tweedie powers, with weights, an offset, ``reg_param`` and
``fit_intercept=False``; every training-summary field and residual type;
the model's transform and predict; persistence both ways; the IRLS
normal equations read off one ``masked_gram`` (its plain version here).

Tolerances: under the float64 policy iterations and ``converged`` are exact and
every number agrees within rtol 1e-9; a column of values (predictions, linear
predictors, residuals, which cross zero) within rtol of its largest magnitude,
deviance residuals as the signed deviances they are the roots of, and p-values
as -log p. Under the float32 policy (the JAX side with x64 off) the same within
rtol 1e-5 and the iterations within one: the two packages sum the same rows in
other orders, and float32 IRLS stops an iteration sooner or later on that.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.models import base as jbase
from sparkdq4ml_tpu.models import glm as jg
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.interop import glm_model_from_numpy
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import glm as tg
from sparkdq4ml_tpu_torch.ops import kernels

POLICIES = {"float64": SimpleNamespace(name="float64", rtol=1e-9, iters=0),
            "float32": SimpleNamespace(name="float32", rtol=1e-5, iters=1)}


@pytest.fixture(params=sorted(POLICIES))
def policy(request):
    pol = POLICIES[request.param]
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, pol.name)
    try:
        with jax.enable_x64(pol.name == "float64"), \
                float_policy(getattr(torch, pol.name)):
            yield pol
    finally:
        jax_config.default_float_dtype = old


def data(family: str, n: int = 160, seed: int = 0, power: float = 0.0):
    """Seeded columns whose labels suit ``family``: three features, a
    positive weight, an offset, and about 8% of the rows masked out."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 0.5, size=(n, 3))
    eta = X @ np.array([0.4, -0.3, 0.2]) + 1.0
    if family == "binomial":
        y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(eta - 1.0)))) * 1.0
    elif family == "poisson" or (family == "tweedie" and 1.0 <= power < 2):
        y = rng.poisson(np.exp(eta)).astype(np.float64)
    elif family in ("gamma",) or family == "tweedie":
        y = rng.gamma(4.0, np.exp(eta) / 4.0)
    else:
        y = np.exp(eta) + rng.normal(0.0, 0.3, n)
    cols = {"features": X, "label": y,
            "w": rng.uniform(0.5, 2.0, n), "off": rng.normal(0.0, 0.1, n)}
    mask = rng.random(n) > 0.08
    return cols, mask


def frames(cols, mask):
    return (JFrame(dict(cols), mask=mask),
            TFrame(dict(cols), mask=mask, device="cpu"))


def close(got, want, rtol, what):
    """Within rtol, element by element, of the larger of each value and
    the column's largest magnitude (a column of linear predictors or
    residuals crosses zero)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def fit_both(policy, family, link=None, power=0.0, seed=0, **kw):
    cols, mask = data(family, seed=seed, power=power)
    j, t = frames(cols, mask)
    if family == "tweedie":
        kw.update(variance_power=power)
    a = jg.GeneralizedLinearRegression(family=family, link=link, **kw).fit(j)
    b = tg.GeneralizedLinearRegression(family=family, link=link, **kw).fit(t)
    return a, b, j, t


def same_fit(a, b, policy):
    close(b.coefficients, a.coefficients, policy.rtol, "coefficients")
    close(b.intercept, a.intercept, policy.rtol, "intercept")
    sa, sb = a.summary, b.summary
    assert abs(sb.num_iterations - sa.num_iterations) <= policy.iters
    if not policy.iters:
        assert sb.converged == sa.converged
    close(sb.deviance, sa.deviance, policy.rtol, "deviance")


FAMILY_LINKS = [(f, link) for f, links in jg._FAMILY_LINKS.items()
                for link in links]


@pytest.mark.parametrize("family,link", FAMILY_LINKS)
def test_every_family_and_link(policy, family, link):
    a, b, _, _ = fit_both(policy, family, link)
    same_fit(a, b, policy)


@pytest.mark.parametrize("power,link_power", [(0.0, None), (1.0, None),
                                              (1.5, None), (2.0, None),
                                              (3.0, None), (1.5, 0.0),
                                              (2.0, -1.0), (1.2, 0.5)])
def test_tweedie_powers(policy, power, link_power):
    a, b, _, _ = fit_both(policy, "tweedie", power=power,
                          link_power=link_power)
    assert b.summary.deviance == pytest.approx(a.summary.deviance,
                                               rel=policy.rtol)
    same_fit(a, b, policy)


VARIANTS = {
    "weights": dict(weight_col="w"),
    "offset": dict(offset_col="off"),
    "reg_param": dict(reg_param=0.3),
    "no_intercept": dict(fit_intercept=False),
    "all": dict(weight_col="w", offset_col="off", reg_param=0.05),
    "no_intercept_offset": dict(fit_intercept=False, offset_col="off"),
}


@pytest.mark.parametrize("family,link", [("gaussian", "identity"),
                                         ("poisson", "log"),
                                         ("gamma", "log"),
                                         ("binomial", "logit")])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_weights_offsets_penalty_and_no_intercept(policy, family, link,
                                                  variant):
    a, b, _, _ = fit_both(policy, family, link, **VARIANTS[variant])
    same_fit(a, b, policy)


SUMMARY_CASES = [("gaussian", "identity", {}), ("gamma", "log", {}),
                 ("poisson", "log", {"weight_col": "w"}),
                 ("binomial", "probit", {}),
                 ("gamma", "inverse", {"offset_col": "off"}),
                 ("poisson", "sqrt", {"weight_col": "w"}),
                 ("poisson", "log", {"fit_intercept": False}),
                 ("gaussian", "log", {"offset_col": "off",
                                      "fit_intercept": False})]


@pytest.mark.parametrize("family,link,kw", SUMMARY_CASES)
def test_every_summary_field_and_residual(policy, family, link, kw):
    a, b, _, _ = fit_both(policy, family, link, **kw)
    sa, sb = a.summary, b.summary
    assert sb.degrees_of_freedom == sa.degrees_of_freedom
    assert sb.residualDegreeOfFreedomNull == \
        sa.residual_degree_of_freedom_null
    for name in ("null_deviance", "dispersion", "aic",
                 "coefficient_standard_errors", "t_values"):
        close(getattr(sb, name), getattr(sa, name), policy.rtol, name)
    # a tail probability moves by about t² times the relative change of t:
    # the p-values are held as -log p, which moves as t does
    close(-np.log(sb.p_values), -np.log(sa.p_values), policy.rtol,
          "p_values")
    for kind in ("deviance", "pearson", "working", "response"):
        rb = sb.residuals(kind).to_pydict()
        ra = sa.residuals(kind).to_pydict()
        assert list(rb) == list(ra) == [f"{kind}Residuals"]
        got, want = rb[f"{kind}Residuals"], ra[f"{kind}Residuals"]
        if kind == "deviance":
            # a deviance residual is the signed root of a row's weighted
            # unit deviance: the root of a near-zero deviance magnifies
            # its rounding, so the signed deviance itself is held
            got, want = np.sign(got) * got ** 2, np.sign(want) * want ** 2
        close(got, want, policy.rtol, kind)


def test_summary_refusals_match(policy):
    a, b, _, _ = fit_both(policy, "gamma", "log", reg_param=0.1)
    for s in (a.summary, b.summary):
        with pytest.raises(ValueError, match="regularized"):
            s.coefficient_standard_errors
        with pytest.raises(ValueError, match="unknown residuals"):
            s.residuals("other")
    a, b, _, _ = fit_both(policy, "tweedie", power=1.5)
    for s in (a.summary, b.summary):
        with pytest.raises(ValueError, match="tweedie"):
            s.aic
    close(b.summary.dispersion, a.summary.dispersion, policy.rtol, "disp")


@pytest.mark.parametrize("family,link", [("gamma", "log"),
                                         ("binomial", "cloglog")])
def test_transform_predict_and_link_prediction(policy, family, link):
    a, b, j, t = fit_both(policy, family, link, offset_col="off",
                          link_prediction_col="eta")
    ga, gb = a.transform(j).to_pydict(), b.transform(t).to_pydict()
    for c in ("prediction", "eta"):
        close(gb[c], ga[c], policy.rtol, c)
    assert b.predict([0.1, 0.2, -0.3]) == pytest.approx(
        a.predict([0.1, 0.2, -0.3]), rel=policy.rtol)


def test_label_checks_and_bad_arguments_raise_as_in_jax():
    for mod, frame in ((jg, JFrame), (tg, None)):
        with pytest.raises(ValueError, match="unknown family"):
            mod.GeneralizedLinearRegression(family="nope")
        with pytest.raises(ValueError, match="not supported"):
            mod.GeneralizedLinearRegression(family="poisson", link="logit")
        with pytest.raises(ValueError, match="link_power"):
            mod.GeneralizedLinearRegression(family="tweedie", link="log")
        with pytest.raises(ValueError, match="variance_power"):
            mod.GeneralizedLinearRegression(family="tweedie",
                                            variance_power=0.5)
    cols, mask = data("gaussian")
    cols["label"] = cols["label"] - 10.0
    j, t = frames(cols, mask)
    for mod, f in ((jg, j), (tg, t)):
        with pytest.raises(ValueError, match="positive labels"):
            mod.GeneralizedLinearRegression(family="gamma").fit(f)
        with pytest.raises(ValueError, match="nonnegative"):
            mod.GeneralizedLinearRegression(family="poisson").fit(f)
    with pytest.raises(NotImplementedError, match="mesh"):
        tg.GeneralizedLinearRegression().fit(t, mesh=object())


def test_setters_revalidate_like_jax():
    a = jg.GeneralizedLinearRegression().set_family("poisson").setLink("sqrt")
    b = tg.GeneralizedLinearRegression().set_family("poisson").setLink("sqrt")
    assert (a.family, a.link) == (b.family, b.link) == ("poisson", "sqrt")
    a.set_variance_power(1.5)
    b.setVariancePower(1.5)
    assert a._params_dict() == b._params_dict()


def test_persistence_both_ways(policy, tmp_path):
    a, b, j, t = fit_both(policy, "poisson", "log", weight_col="w")
    tbase.save_stage(b, str(tmp_path / "port"))
    jbase.save_stage(a, str(tmp_path / "jax"))
    from_port = jbase.load_stage(str(tmp_path / "port"))
    from_jax = tbase.load_stage(str(tmp_path / "jax"))
    assert isinstance(from_jax, tg.GeneralizedLinearRegressionModel)
    close(from_jax.transform(t).to_pydict()["prediction"],
          from_port.transform(j).to_pydict()["prediction"], policy.rtol,
          "prediction")
    with pytest.raises(ValueError, match="summary"):
        from_jax.summary
    est = tg.GeneralizedLinearRegression(family="gamma", link="log",
                                         reg_param=0.2)
    est.save(str(tmp_path / "est"))
    back = jbase.load_stage(str(tmp_path / "est"))
    assert back._params_dict() == est._params_dict()
    assert os.path.exists(tmp_path / "est" / "stage.json")


def test_model_from_numpy_scores_like_the_jax_model(policy):
    a, _, j, t = fit_both(policy, "gamma", "inverse")
    m = glm_model_from_numpy(np.asarray(a.coefficients), a.intercept,
                             a._params)
    close(m.transform(t).to_pydict()["prediction"],
          a.transform(j).to_pydict()["prediction"], policy.rtol, "pred")


def test_normal_equations_come_from_one_masked_gram(monkeypatch):
    """Each IRLS iteration reads X1ᵀWX1 and X1ᵀWz off one masked_gram
    call, and the final pass is one more; the rows of A it keeps are the
    features and the ones column (the intercept last)."""
    calls = []
    real = kernels.masked_gram

    def spy(X, y, w):
        calls.append(X.shape)
        return real(X, y, w)

    monkeypatch.setattr(kernels, "masked_gram", spy)
    with float_policy(torch.float64):
        cols, mask = data("gamma")
        _, t = frames(cols, mask)
        m = tg.GeneralizedLinearRegression(family="gamma", link="log",
                                           weight_col="w").fit(t)
    assert len(calls) == m.summary.num_iterations + 1
    assert all(shape == (160, 3) for shape in calls)
    X = torch.as_tensor(cols["features"])
    w = torch.as_tensor(np.where(mask, cols["w"], 0.0))
    z = torch.as_tensor(cols["label"])
    A = kernels.masked_gram(X, z, torch.sqrt(w))
    X1 = torch.cat([X, torch.ones(160, 1, dtype=X.dtype)], dim=1)
    idx = [0, 1, 2, 4]
    torch.testing.assert_close(A[idx][:, idx], X1.T @ (X1 * w[:, None]))
    torch.testing.assert_close(A[idx, 3], (X1 * w[:, None]).T @ z)
