"""Model selection in the torch port (``models/tuning.py``,
``models/evaluation.py``, ``Frame.random_split``) held against the JAX
package on the CPU in float64: fold and split assignments exactly,
``best_index`` exactly, ``avg_metrics`` and the refit model within rtol
1e-9, on ``dataset-full.csv`` (the tour of ``examples/ml_pipeline_tour.py``)
and on a seeded table, through both the fused fast path and the generic
fit-per-cell path. Also: ``chip_smoke.py``'s golden constants are the JAX
package's output."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from conftest import dataset_path, prepare_features, run_dq_pipeline
from sparkdq4ml_tpu.frame.frame import Frame as JaxFrame
from sparkdq4ml_tpu.models import evaluation as jax_eval
from sparkdq4ml_tpu.models import tuning as jax_tuning
from sparkdq4ml_tpu.models import LinearRegression as JaxLR
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame
from sparkdq4ml_tpu_torch.models import (CrossValidator, LinearRegression,
                                         ParamGridBuilder,
                                         RegressionEvaluator,
                                         TrainValidationSplit,
                                         VectorAssembler)
from sparkdq4ml_tpu_torch.models import tuning
from sparkdq4ml_tpu_torch.ops import kernels
from sparkdq4ml_tpu_torch.sql import default_catalog

RTOL = 1e-9
ROOT = pathlib.Path(__file__).resolve().parents[1]
TOUR_GRID = [{"reg_param": r, "elastic_net_param": a}
             for r in (0.01, 0.1, 1.0) for a in (0.0, 0.5, 1.0)]


@pytest.fixture(autouse=True)
def _float64():
    with float_policy(torch.float64):
        yield


@pytest.fixture
def port():
    s = (TorchSession.builder().app_name("test")
         .config("spark.torch.device", "cpu").get_or_create())
    yield s
    s.stop()
    default_catalog().clear()


def port_full(s):
    """dataset-full through the port's DQ chain, label and assembler."""
    import sparkdq4ml_tpu_torch as dq

    dq.register_builtin_rules()
    df = (s.read.format("csv").option("inferSchema", "true")
          .option("header", "false").load(dataset_path("full")))
    df = df.with_column_renamed("_c0", "guest").with_column_renamed(
        "_c1", "price")
    df = df.with_column("price_no_min",
                        dq.call_udf("minimumPriceRule", dq.col("price")))
    df.create_or_replace_temp_view("price")
    df = s.sql("SELECT cast(guest as int) guest, price_no_min AS price "
               "FROM price WHERE price_no_min > 0")
    df = df.with_column("price_correct_correl",
                        dq.call_udf("priceCorrelationRule", dq.col("price"),
                                    dq.col("guest")))
    df.create_or_replace_temp_view("price")
    df = s.sql("SELECT guest, price_correct_correl AS price "
               "FROM price WHERE price_correct_correl > 0")
    df = df.with_column("label", df.col("price"))
    return VectorAssembler(["guest"], "features").transform(df)


@pytest.fixture
def full(port, session):
    """The same DQ-clean, assembled dataset-full in both packages."""
    jdf = prepare_features(run_dq_pipeline(session, dataset_path("full")))
    return port_full(port), jdf


def seeded(n=400, d=3, seed=0):
    """A seeded table with a 20% mask, as numpy columns and both frames."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 3.0, d) + rng.normal(
        size=d)
    y = X @ rng.normal(size=d) + 2.0 + rng.normal(scale=0.7, size=n)
    mask = rng.random(n) > 0.2
    cols = {"features": X, "label": y}
    return (Frame(cols, mask=mask, device="cpu"), JaxFrame(cols, mask=mask))


def _same_cv(got, ref):
    assert got.best_index == ref.best_index
    np.testing.assert_allclose(got.avg_metrics, ref.avg_metrics, rtol=RTOL)
    np.testing.assert_allclose(got.best_model.coefficients,
                               ref.best_model.coefficients, rtol=RTOL)
    assert got.best_model.intercept == pytest.approx(
        ref.best_model.intercept, rel=RTOL)


def test_param_grid_builder_matches():
    def build(builder):
        return (builder().add_grid("regParam", [0.1, 1.0])
                .addGrid("elastic_net_param", [0.0, 0.5])
                .base_on({"maxIter": 7}).build())

    assert build(ParamGridBuilder) == build(jax_tuning.ParamGridBuilder)
    assert ParamGridBuilder().build() == [{}]


@pytest.mark.parametrize("n,k,seed", [(10, 3, 0), (1040, 3, 7), (999, 5, 1)])
def test_fold_ids_match(n, k, seed):
    np.testing.assert_array_equal(tuning._fold_ids(n, k, seed),
                                  jax_tuning._fold_ids(n, k, seed))


@pytest.mark.parametrize("metric", ["rmse", "mse", "r2"])
def test_holdout_metric_from_gram(metric):
    rng = np.random.default_rng(4)
    X = rng.normal(size=(200, 2))
    y = X @ [1.5, -2.0] + 3.0 + rng.normal(size=200)
    Z = np.concatenate([X, y[:, None], np.ones((200, 1))], axis=1)
    A = Z.T @ Z
    coef, c = np.array([1.4, -1.9]), 2.9
    ref = float(jax_tuning._holdout_metric_from_gram(A, coef, c, metric))
    got = tuning._holdout_metric_from_gram(torch.as_tensor(A),
                                           torch.as_tensor(coef),
                                           torch.tensor(c, dtype=torch.float64),
                                           metric)
    assert float(got) == pytest.approx(ref, rel=RTOL)
    # batched: one Gramian per row of coef
    As = torch.as_tensor(np.stack([A, A]))
    cs = torch.as_tensor(np.stack([coef, coef]))
    two = tuning._holdout_metric_from_gram(
        As, cs, torch.tensor([c, c], dtype=torch.float64), metric)
    np.testing.assert_allclose(two.numpy(), [ref, ref], rtol=RTOL)


def test_tour_cross_validator_fast_path(full):
    df, jdf = full
    cv = CrossValidator(LinearRegression(max_iter=40), TOUR_GRID,
                        RegressionEvaluator(metric_name="rmse"),
                        num_folds=3)
    assert cv._use_fast_path()
    ref = jax_tuning.CrossValidator(
        JaxLR(max_iter=40), TOUR_GRID,
        jax_eval.RegressionEvaluator(metric_name="rmse"), num_folds=3).fit(
            jdf)
    got = cv.fit(df)
    _same_cv(got, ref)
    s, js = got.best_model.summary, ref.best_model.summary
    assert s.totalIterations == js.totalIterations
    np.testing.assert_allclose(s.objectiveHistory, js.objectiveHistory,
                               rtol=RTOL)
    assert got.bestModel is got.best_model
    np.testing.assert_array_equal(got.avgMetrics, got.avg_metrics)


def test_fast_path_takes_one_masked_gram_per_fold(full, monkeypatch):
    df, _ = full
    calls = []
    real = kernels.masked_gram_reference
    monkeypatch.setattr(kernels, "masked_gram_reference",
                        lambda X, y, w: calls.append(int(w.sum()))
                        or real(X, y, w))
    CrossValidator(LinearRegression(max_iter=40), TOUR_GRID,
                   RegressionEvaluator(), num_folds=3).fit(df)
    assert len(calls) == 3 and sum(calls) == df.count() == 1024


@pytest.mark.parametrize("metric", ["rmse", "mse", "r2"])
@pytest.mark.parametrize("solver", ["auto", "l-bfgs", "normal"])
def test_fast_path_on_a_seeded_table(metric, solver):
    df, jdf = seeded()
    grid = ([{"reg_param": r} for r in (0.0, 0.1, 1.0)]
            if solver == "normal" else
            [{"reg_param": r, "elastic_net_param": a}
             for r in (0.0, 0.05, 0.5) for a in (0.0, 1.0)])
    est = dict(max_iter=60, solver=solver)
    got = CrossValidator(LinearRegression(**est), grid,
                         RegressionEvaluator(metric_name=metric),
                         num_folds=4, seed=3).fit(df)
    ref = jax_tuning.CrossValidator(
        JaxLR(**est), grid, jax_eval.RegressionEvaluator(metric_name=metric),
        num_folds=4, seed=3).fit(jdf)
    _same_cv(got, ref)


@pytest.mark.parametrize("case", ["mae", "sub_models", "huber", "weighted"])
def test_generic_path(case):
    df, jdf = seeded(n=240, d=2, seed=5)
    w = np.random.default_rng(9).uniform(0.5, 2.0, 240)
    df, jdf = df.with_column("w", w), jdf.with_column("w", w)
    metric = "mae" if case == "mae" else "rmse"
    est = {"max_iter": 30}
    grid = [{"reg_param": r, "elastic_net_param": a}
            for r in (0.01, 0.3) for a in (0.0, 1.0)]
    if case == "huber":
        est["loss"] = "huber"
        grid = [{"reg_param": r} for r in (0.0, 0.3)]
    if case == "weighted":
        est["weight_col"] = "w"
    kw = dict(num_folds=3, seed=11, collect_sub_models=case == "sub_models")
    cv = CrossValidator(LinearRegression(**est), grid,
                        RegressionEvaluator(metric_name=metric), **kw)
    assert not cv._use_fast_path()
    got = cv.fit(df)
    ref = jax_tuning.CrossValidator(
        JaxLR(**est), grid, jax_eval.RegressionEvaluator(metric_name=metric),
        **kw).fit(jdf)
    tol = 1e-6 if case == "huber" else RTOL
    assert got.best_index == ref.best_index
    np.testing.assert_allclose(got.avg_metrics, ref.avg_metrics, rtol=tol)
    np.testing.assert_allclose(got.best_model.coefficients,
                               ref.best_model.coefficients, rtol=tol)
    if case == "sub_models":
        assert len(got.sub_models) == len(grid) * 3
        for g, r in zip(got.sub_models, ref.sub_models):
            np.testing.assert_allclose(g.coefficients, r.coefficients,
                                       rtol=RTOL)
    else:
        assert got.sub_models is None


@pytest.mark.parametrize("table", ["full", "seeded"])
def test_train_validation_split(full, table):
    df, jdf = full if table == "full" else seeded(seed=2)
    grid = [{"reg_param": r, "elastic_net_param": 1.0}
            for r in (0.01, 0.5, 2.0)]
    got = TrainValidationSplit(
        LinearRegression(max_iter=40), grid,
        RegressionEvaluator(metric_name="r2"), train_ratio=0.7,
        seed=5).fit(df)
    ref = jax_tuning.TrainValidationSplit(
        JaxLR(max_iter=40), grid,
        jax_eval.RegressionEvaluator(metric_name="r2"), train_ratio=0.7,
        seed=5).fit(jdf)
    assert got.best_index == ref.best_index
    np.testing.assert_allclose(got.validation_metrics,
                               ref.validation_metrics, rtol=RTOL)
    np.testing.assert_allclose(got.validationMetrics, got.avg_metrics)
    np.testing.assert_allclose(got.best_model.coefficients,
                               ref.best_model.coefficients, rtol=RTOL)


def test_random_split_matches(full):
    df, jdf = full
    for got, ref in zip(df.random_split([0.8, 0.2], seed=7),
                        jdf.random_split([0.8, 0.2], seed=7)):
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    parts = df.randomSplit([1.0, 2.0, 1.0], seed=3)
    assert sum(p.count() for p in parts) == df.count()
    with pytest.raises(ValueError):
        df.random_split([0.0, 0.0])


@pytest.mark.parametrize("metric", ["rmse", "mse", "mae", "r2", "var"])
def test_regression_evaluator(metric):
    rng = np.random.default_rng(1)
    y, p = rng.normal(size=50), rng.normal(size=50)
    got = RegressionEvaluator(metric_name=metric)
    ref = jax_eval.RegressionEvaluator(metric_name=metric)
    assert got.compute(y, p) == ref.compute(y, p)
    assert got.is_larger_better() == ref.is_larger_better()
    frame = Frame({"label": y, "prediction": p}, device="cpu")
    assert got.evaluate(frame) == ref.compute(y, p)
    with pytest.raises(ValueError):
        RegressionEvaluator(metric_name="auc")


def test_tour_float32_policy_choice_is_optimal_within_tolerance(full):
    """Under the card's float32 policy the fold metrics of grid points 0-2
    differ by less than float32 resolves through the Gramian (their float64
    values agree to 6e-9): the float32 metrics stay within 1e-3 of float64
    and the chosen point is optimal within 1e-3, whatever its index."""
    df64, _ = full
    ref = CrossValidator(LinearRegression(max_iter=40), TOUR_GRID,
                         RegressionEvaluator(), num_folds=3).fit(df64)
    with float_policy(torch.float32):
        s = (TorchSession.builder().config("spark.torch.device", "cpu")
             .get_or_create())
        df32 = port_full(s)
        got = CrossValidator(LinearRegression(max_iter=40), TOUR_GRID,
                             RegressionEvaluator(), num_folds=3).fit(df32)
    np.testing.assert_allclose(got.avg_metrics, ref.avg_metrics, rtol=1e-3)
    assert ref.avg_metrics[got.best_index] <= \
        ref.avg_metrics.min() * (1 + 1e-3)
    np.testing.assert_allclose(got.best_model.coefficients,
                               ref.best_model.coefficients, rtol=1e-3)


def test_chip_smoke_cv_goldens_are_the_reference_output(full):
    """The CV constants ``chip_smoke.py`` holds the card to are the JAX
    package's float64 output on dataset-full."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    _, jdf = full
    ref = jax_tuning.CrossValidator(
        JaxLR(max_iter=40), TOUR_GRID,
        jax_eval.RegressionEvaluator(metric_name="rmse"), num_folds=3).fit(
            jdf)
    golden = smoke.CV_GOLDEN
    assert golden["grid"] == TOUR_GRID
    assert golden["best_index"] == ref.best_index
    np.testing.assert_allclose(golden["avg_metrics"], ref.avg_metrics,
                               rtol=1e-6)
    assert golden["coef"] == pytest.approx(
        float(ref.best_model.coefficients[0]), rel=1e-6)
    assert golden["intercept"] == pytest.approx(ref.best_model.intercept,
                                                rel=1e-6)
