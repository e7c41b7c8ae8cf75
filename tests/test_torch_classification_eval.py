"""The classification evaluators of the torch port (``models/evaluation.py``:
the threshold sweep, ROC and PR points, the areas under them,
``BinaryClassificationEvaluator`` and ``MulticlassClassificationEvaluator``)
held against the JAX package on the CPU, on seeded scores with ties and on
labels of one class.

Tolerances: under the float64 policy the curves and metrics agree within
1e-12 (the sweep's counts are exact; only the trapezoid rounds), the
thresholds and counts exactly; under the float32 policy, with the JAX side
under ``jax.enable_x64(False)``, within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JaxFrame
from sparkdq4ml_tpu.models import evaluation as jax_eval
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame
from sparkdq4ml_tpu_torch.models import evaluation

CURVE_TOL = 1e-12
TOL = {"float64": 1e-12, "float32": 1e-4}


@pytest.fixture(params=["float64", "float32"])
def policy(request):
    """Both packages under one float policy; yields the tolerance."""
    name = request.param
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, name)
    try:
        with jax.enable_x64(name == "float64"), \
                float_policy(getattr(torch, name)):
            yield TOL[name]
    finally:
        jax_config.default_float_dtype = old


def scores_with_ties(n=400, seed=0, levels=None):
    """Seeded 0/1 labels and scores related to them; ``levels`` rounds the
    scores to that many decimals, so that runs of equal scores mix both
    labels."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.float64)
    s = y * 0.8 + rng.normal(size=n)
    if levels is not None:
        s = np.round(s, levels)
    return y, s


CASES = {"distinct": (None, 0), "ties_1dp": (1, 1), "ties_0dp": (0, 2),
         "all_tied": ("all", 3)}


def case(name):
    levels, seed = CASES[name]
    y, s = scores_with_ties(seed=seed,
                            levels=None if levels == "all" else levels)
    if levels == "all":
        s = np.full_like(s, 0.25)
    return y, s


@pytest.mark.parametrize("name", sorted(CASES))
def test_threshold_sweep_matches_the_reference(name):
    y, s = case(name)
    got = evaluation.threshold_sweep(y, s)
    want = jax_eval.threshold_sweep(y, s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w, np.float64))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sweep_of_tensors_equals_the_numpy_sweep(name):
    """The device path (tensors, here on the CPU) gives the numpy path's
    points: the last index of each tied run counts, whatever the order."""
    y, s = case(name)
    perm = np.random.default_rng(9).permutation(len(y))
    got = evaluation.threshold_sweep(torch.as_tensor(y[perm]),
                                     torch.as_tensor(s[perm]))
    for g, w in zip(got, evaluation.threshold_sweep(y, s)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fn", ["pr_points", "roc_points"])
def test_curve_points_match_the_reference(name, fn):
    y, s = case(name)
    got = getattr(evaluation, fn)(y, s)
    want = getattr(jax_eval, fn)(y, s)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=CURVE_TOL, atol=CURVE_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fn", ["area_under_roc", "area_under_pr"])
def test_areas_match_the_reference(name, fn):
    y, s = case(name)
    got = getattr(evaluation, fn)(torch.as_tensor(y), torch.as_tensor(s))
    want = getattr(jax_eval, fn)(y, s)
    assert got == pytest.approx(want, rel=CURVE_TOL, abs=CURVE_TOL)


@pytest.mark.parametrize("label", [0.0, 1.0])
@pytest.mark.parametrize("fn", ["area_under_roc", "area_under_pr"])
def test_one_class_labels_give_nan_in_both(label, fn):
    _, s = scores_with_ties(n=50)
    y = np.full(50, label)
    assert np.isnan(getattr(evaluation, fn)(y, s))
    assert np.isnan(getattr(jax_eval, fn)(y, s))


def test_nan_scores_sort_last_as_in_numpy():
    y, s = scores_with_ties(n=60, seed=4, levels=1)
    s[::7] = np.nan
    got = evaluation.threshold_sweep(torch.as_tensor(y),
                                     torch.as_tensor(s))
    want = jax_eval.threshold_sweep(y, s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def _frames(cols, mask):
    return (Frame(cols, mask=mask, device="cpu"),
            JaxFrame(cols, mask=mask))


@pytest.mark.parametrize("metric", ["areaUnderROC", "areaUnderPR"])
@pytest.mark.parametrize("score_col", ["rawPrediction", "probability"])
def test_binary_evaluator_matches_the_reference(policy, metric, score_col):
    """Over the frame's valid rows; without a rawPrediction column it
    reads probability."""
    y, s = scores_with_ties(n=300, seed=5, levels=1)
    mask = np.random.default_rng(6).random(300) > 0.25
    df, jdf = _frames({"label": y, score_col: s}, mask)
    got = evaluation.BinaryClassificationEvaluator(metric).evaluate(df)
    want = jax_eval.BinaryClassificationEvaluator(metric).evaluate(jdf)
    assert got == pytest.approx(want, rel=policy, abs=policy)


def test_binary_evaluator_takes_one_score_a_row():
    """A two-column rawPrediction (a LinearSVC's) raises in both."""
    y, s = scores_with_ties(n=40)
    raw = np.stack([-s, s], axis=1)
    df, jdf = _frames({"label": y, "rawPrediction": raw},
                      np.ones(40, bool))
    with pytest.raises(ValueError):
        evaluation.BinaryClassificationEvaluator().evaluate(df)
    with pytest.raises(ValueError):
        jax_eval.BinaryClassificationEvaluator().evaluate(jdf)


def test_binary_evaluator_rejects_unknown_metrics():
    with pytest.raises(ValueError, match="unknown metric"):
        evaluation.BinaryClassificationEvaluator("accuracy")


METRICS = ("f1", "accuracy", "weightedPrecision", "weightedRecall",
           "hammingLoss")


def multiclass_columns(n=500, k=4, seed=0, extra_pred_class=True):
    """Seeded labels in 0..k-1 and predictions right about 60% of the
    time, some of them a class no label has."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n).astype(np.float64)
    wrong = rng.integers(0, k + int(extra_pred_class), n)
    p = np.where(rng.random(n) < 0.6, y, wrong).astype(np.float64)
    return y, p


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("seed", [0, 1])
def test_multiclass_evaluator_matches_the_reference(policy, metric, seed):
    y, p = multiclass_columns(seed=seed)
    mask = np.random.default_rng(seed + 10).random(len(y)) > 0.2
    df, jdf = _frames({"label": y, "prediction": p}, mask)
    got = evaluation.MulticlassClassificationEvaluator(metric).evaluate(df)
    want = jax_eval.MulticlassClassificationEvaluator(metric).evaluate(jdf)
    assert got == pytest.approx(want, rel=policy, abs=policy)


@pytest.mark.parametrize("metric", METRICS)
def test_multiclass_evaluator_is_exact_in_float64(metric):
    """Integer counts on the device, the reference's float64 algebra on
    the host: equal to the last bit."""
    y, p = multiclass_columns(n=333, k=3, seed=3)
    df, jdf = _frames({"label": y, "prediction": p}, np.ones(333, bool))
    got = evaluation.MulticlassClassificationEvaluator(metric).evaluate(df)
    want = jax_eval.MulticlassClassificationEvaluator(metric).evaluate(jdf)
    assert got == want


@pytest.mark.parametrize("metric", METRICS)
def test_multiclass_evaluator_on_one_class(metric):
    y = np.full(30, 2.0)
    p = np.where(np.arange(30) % 3 == 0, 1.0, 2.0)
    df, jdf = _frames({"label": y, "prediction": p}, np.ones(30, bool))
    got = evaluation.MulticlassClassificationEvaluator(metric).evaluate(df)
    want = jax_eval.MulticlassClassificationEvaluator(metric).evaluate(jdf)
    assert got == pytest.approx(want, rel=CURVE_TOL)


@pytest.mark.parametrize("metric", METRICS)
def test_larger_is_better_as_in_the_reference(metric):
    assert evaluation.MulticlassClassificationEvaluator(
        metric).is_larger_better() == \
        jax_eval.MulticlassClassificationEvaluator(metric).is_larger_better()


def test_multiclass_evaluator_rejects_unknown_metrics():
    with pytest.raises(ValueError, match="unknown metric"):
        evaluation.MulticlassClassificationEvaluator("areaUnderROC")
