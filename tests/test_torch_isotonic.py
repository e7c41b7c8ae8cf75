"""``IsotonicRegression`` of the port (``models/regression.py``) held
against the JAX package on the CPU in both float policies, on the
isotonic cases of ``tests/test_svc_isotonic.py``: the smooth fit, the
antitonic fit, weights with duplicate feature values and zero weights,
constant extrapolation and interpolation at and between boundaries, a
feature index into a vector column, masked rows holding NaN, one row and
one distinct value, every ``ValueError`` and save/load both ways; the
aggregation goes through one ``sorted_segment_sum`` call of two columns.

Tolerances: boundaries exact (they are feature values); predictions and
pooled values within rtol 1e-12 (float64 on both sides: the sums by value
add in another order than ``np.add.reduceat``), the transform column in
the policy's dtype within one rounding of it (rtol 1e-12 under float64,
1e-6 under float32).
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
from sparkdq4ml_tpu.models import regression as jr
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import regression as tr
from sparkdq4ml_tpu_torch.ops import kernels

POLICIES = {"float64": SimpleNamespace(name="float64", column=1e-12),
            "float32": SimpleNamespace(name="float32", column=1e-6)}
RTOL = 1e-12


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


def frames(cols, mask=None):
    return (JFrame(dict(cols), mask=mask),
            TFrame(dict(cols), mask=mask, device="cpu"))


def same_model(a, b, j, t, policy, queries=()):
    np.testing.assert_array_equal(b.boundaries, a.boundaries)
    np.testing.assert_allclose(b.predictions, a.predictions, rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(b.transform(t).to_pydict()["prediction"], np.float64),
        np.asarray(a.transform(j).to_pydict()["prediction"], np.float64),
        rtol=policy.column, atol=policy.column)
    for q in queries:
        assert b.predict(q) == pytest.approx(a.predict(q), rel=RTOL,
                                             abs=1e-12)


def test_smooth_fit_matches_the_reference(policy):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, size=200)
    y = np.sqrt(x) + 0.3 * rng.normal(size=200)
    j, t = frames({"features": x, "label": y})
    a = jr.IsotonicRegression().fit(j)
    b = tr.IsotonicRegression().fit(t)
    same_model(a, b, j, t, policy, queries=(-1.0, 0.0, 3.3, x[5], 10.5))


def test_antitonic_matches_the_reference(policy):
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 5, size=100)
    y = -2 * x + 0.1 * rng.normal(size=100)
    j, t = frames({"features": x, "label": y})
    a = jr.IsotonicRegression(isotonic=False).fit(j)
    b = tr.IsotonicRegression(isotonic=False).fit(t)
    same_model(a, b, j, t, policy, queries=(0.1, 2.5, 7.0))
    pred = np.asarray(b.transform(t).to_pydict()["prediction"])
    assert np.all(np.diff(pred[np.argsort(x)]) <= 1e-6)


@pytest.mark.parametrize("isotonic", [True, False])
def test_weights_duplicates_and_zero_weights(policy, isotonic):
    x = np.asarray([1.0, 1.0, 2.0, 3.0, 3.0, 4.0, 5.0, 5.0])
    y = np.asarray([2.0, 4.0, 1.0, 5.0, 7.0, 6.0, 9.0, -3.0])
    w = np.asarray([1.0, 3.0, 2.0, 1.0, 1.0, 2.0, 0.0, 0.0])
    j, t = frames({"features": x, "label": y, "w": w})
    a = jr.IsotonicRegression(weight_col="w", isotonic=isotonic).fit(j)
    b = tr.IsotonicRegression(weight_col="w", isotonic=isotonic).fit(t)
    same_model(a, b, j, t, policy, queries=(0.5, 1.0, 2.5, 3.0, 10.0))


def test_extrapolation_and_interpolation(policy):
    j, t = frames({"features": np.asarray([1.0, 2.0, 3.0]),
                   "label": np.asarray([1.0, 2.0, 3.0])})
    a = jr.IsotonicRegression().fit(j)
    b = tr.IsotonicRegression().fit(t)
    same_model(a, b, j, t, policy, queries=(-5.0, 1.0, 1.5, 3.0, 99.0))
    assert b.predict(-5.0) == 1.0 and b.predict(99.0) == 3.0
    assert b.predict(1.5) == pytest.approx(1.5)


@pytest.mark.parametrize("x,y", [([2.0], [7.0]), ([3.0, 3.0, 3.0],
                                                   [1.0, 5.0, 0.0])])
def test_one_point(policy, x, y):
    j, t = frames({"features": np.asarray(x), "label": np.asarray(y)})
    a = jr.IsotonicRegression().fit(j)
    b = tr.IsotonicRegression().fit(t)
    same_model(a, b, j, t, policy, queries=(0.0, 3.0, 9.0))


def test_feature_index_and_masked_rows(policy):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 5, size=60)
    X = np.stack([rng.normal(size=60), x], axis=1)
    y = 2 * x + rng.normal(size=60)
    mask = rng.random(60) > 0.2
    y[~mask] = np.nan
    X[~mask, 1] = np.inf
    j, t = frames({"features": X, "label": y}, mask)
    a = jr.IsotonicRegression(feature_index=1).fit(j)
    b = tr.IsotonicRegression(feature_index=1).setFeatureIndex(1).fit(t)
    same_model(a, b, j, t, policy, queries=(2.0, 4.4))


def test_aggregation_is_one_sorted_segment_sum(monkeypatch):
    calls = []
    real = kernels.sorted_segment_sum

    def spy(x, seg, size):
        calls.append((tuple(x.shape), x.dtype, size))
        return real(x, seg, size)

    monkeypatch.setattr(kernels, "sorted_segment_sum", spy)
    x = np.asarray([3.0, 1.0, 2.0, 1.0, 3.0])
    tr.IsotonicRegression().fit(TFrame({"features": x,
                                        "label": x * 2}, device="cpu"))
    assert calls == [((5, 2), torch.float64, 3)]


def test_checks_raise_as_in_the_reference():
    x = np.asarray([1.0, 2.0, 3.0])
    for M, F in ((jr, JFrame), (tr, TFrame)):
        kw = {} if F is JFrame else {"device": "cpu"}
        with pytest.raises(ValueError, match="no valid rows"):
            M.IsotonicRegression().fit(F({"features": x, "label": x},
                                         mask=np.zeros(3, bool), **kw))
        with pytest.raises(ValueError, match="non-finite"):
            M.IsotonicRegression().fit(F({"features": x, "label": np.asarray(
                [1.0, np.nan, 2.0])}, **kw))
        with pytest.raises(ValueError, match="non-finite"):
            M.IsotonicRegression().fit(F({"features": np.asarray(
                [1.0, np.inf, 2.0]), "label": x}, **kw))
        with pytest.raises(ValueError, match="nonnegative"):
            M.IsotonicRegression(weight_col="w").fit(F({
                "features": x, "label": x,
                "w": np.asarray([1.0, -1.0, 1.0])}, **kw))


def test_model_round_trips_both_ways(tmp_path):
    x = np.asarray([1.0, 2.0, 3.0])
    y = np.asarray([3.0, 1.0, 5.0])
    a = jr.IsotonicRegression().fit(JFrame({"features": x, "label": y}))
    a.save(str(tmp_path / "jax"))
    b = tbase.load_stage(str(tmp_path / "jax"))
    assert isinstance(b, tr.IsotonicRegressionModel)
    assert b.predict(2.5) == a.predict(2.5)
    b.save(str(tmp_path / "torch"))
    c = jbase.load_stage(str(tmp_path / "torch"))
    np.testing.assert_array_equal(c.boundaries, a.boundaries)
    assert c.predict(2.5) == a.predict(2.5)
    est = tr.IsotonicRegression(isotonic=False, weight_col="w")
    est.save(str(tmp_path / "est"))
    back = jbase.load_stage(str(tmp_path / "est"))
    assert back.isotonic is False and back.weight_col == "w"
