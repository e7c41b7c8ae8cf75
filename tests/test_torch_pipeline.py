"""The reference app through the torch port's entry points on the CPU,
against the golden numbers of SURVEY.md section 2.3 and against the JAX
package's own run of the same app, in float64 (fit outputs within rtol
1e-9, row and iteration counts exactly)."""

import numpy as np
import pytest
import torch

from conftest import dataset_path, prepare_features, run_dq_pipeline
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.ops import kernels
from sparkdq4ml_tpu_torch.sql import default_catalog

ROW_COUNTS = {"abstract": (40, 34, 24), "small": (27, 24, 20),
              "full": (1040, 1034, 1024)}
GOLDEN = {  # coef, intercept, RMSE, r2, predict(40)
    "abstract": (4.923331, 21.010309, 2.809940, 0.996515, 217.9436),
    "small": (4.902938, 21.391522, 2.731280, 0.996407, 217.5090),
    "full": (4.878392, 23.964108, 1.805140, 0.998743, 219.0998),
}
RTOL = 1e-9


@pytest.fixture
def port():
    with float_policy(torch.float64):
        s = (TorchSession.builder().app_name("test")
             .config("spark.torch.device", "cpu").get_or_create())
        yield s
        s.stop()
        default_catalog().clear()


def port_app(s, name, counts=None):
    """The app through the port's public API, as a user writes it."""
    import sparkdq4ml_tpu_torch as dq
    from sparkdq4ml_tpu_torch.models import (LinearRegression,
                                             VectorAssembler, Vectors)

    dq.register_builtin_rules()
    df = (s.read.format("csv").option("inferSchema", "true")
          .option("header", "false").load(dataset_path(name)))
    df = df.with_column_renamed("_c0", "guest").with_column_renamed(
        "_c1", "price")
    counts = [] if counts is None else counts
    counts.append(df.count())
    df = df.with_column("price_no_min",
                        dq.call_udf("minimumPriceRule", dq.col("price")))
    df.create_or_replace_temp_view("price")
    df = s.sql("SELECT cast(guest as int) guest, price_no_min AS price "
               "FROM price WHERE price_no_min > 0")
    counts.append(df.count())
    df = df.with_column("price_correct_correl",
                        dq.call_udf("priceCorrelationRule", dq.col("price"),
                                    dq.col("guest")))
    df.create_or_replace_temp_view("price")
    df = s.sql("SELECT guest, price_correct_correl AS price "
               "FROM price WHERE price_correct_correl > 0")
    counts.append(df.count())
    df = df.with_column("label", df.col("price"))
    df = VectorAssembler(["guest"], "features").transform(df)
    model = (LinearRegression().set_max_iter(40).set_reg_param(1.0)
             .set_elastic_net_param(1.0)).fit(df)
    return df, model, model.predict(Vectors.dense(40.0))


@pytest.mark.parametrize("name", list(ROW_COUNTS))
def test_goldens(port, name):
    counts = []
    df, model, p40 = port_app(port, name, counts)
    assert tuple(counts) == ROW_COUNTS[name]
    assert df.columns == ["guest", "price", "label", "features"]
    coef, intercept, rmse, r2, pred = GOLDEN[name]
    s = model.summary
    assert model.coefficients[0] == pytest.approx(coef, abs=1e-5)
    assert model.intercept == pytest.approx(intercept, abs=1e-4)
    assert s.rootMeanSquaredError == pytest.approx(rmse, abs=1e-5)
    assert s.r2 == pytest.approx(r2, abs=1e-6)
    assert p40 == pytest.approx(pred, abs=1e-3)
    assert s.totalIterations >= 1
    assert len(s.objectiveHistory) == s.totalIterations + 1
    assert s.residuals.count() == ROW_COUNTS[name][2]
    assert model.getRegParam() == 1.0 and model.getTol() == 1e-6


@pytest.mark.parametrize("name", list(ROW_COUNTS))
def test_matches_jax_app(port, session, name):
    from sparkdq4ml_tpu.models import LinearRegression, Vectors

    jdf = prepare_features(run_dq_pipeline(session, dataset_path(name)))
    jmodel = (LinearRegression().set_max_iter(40).set_reg_param(1.0)
              .set_elastic_net_param(1.0)).fit(jdf)
    js = jmodel.summary
    df, model, p40 = port_app(port, name)
    s = model.summary
    assert df.count() == jdf.count()
    np.testing.assert_array_equal(df.mask.numpy(), np.asarray(jdf.mask))
    np.testing.assert_allclose(model.coefficients, jmodel.coefficients,
                               rtol=RTOL)
    assert model.intercept == pytest.approx(jmodel.intercept, rel=RTOL)
    assert s.totalIterations == js.totalIterations
    np.testing.assert_allclose(s.objectiveHistory, js.objectiveHistory,
                               rtol=RTOL)
    assert s.rootMeanSquaredError == pytest.approx(js.rootMeanSquaredError,
                                                   rel=RTOL)
    assert s.r2 == pytest.approx(js.r2, rel=RTOL)
    assert p40 == pytest.approx(jmodel.predict(Vectors.dense(40.0)),
                                rel=RTOL)
    np.testing.assert_allclose(
        s.residuals.to_pydict()["residuals"],
        js.residuals.to_pydict()["residuals"], rtol=1e-7, atol=1e-9)


def test_float32_policy_envelope():
    """The card's float32 policy, run on the CPU: goldens within 0.1%."""
    with float_policy(torch.float32):
        s = (TorchSession.builder().config("spark.torch.device", "cpu")
             .get_or_create())
        try:
            df, model, p40 = port_app(s, "abstract")
            assert df._column_values("price").dtype == torch.float32
            assert model.summary.rootMeanSquaredError == pytest.approx(
                2.809940, rel=1e-3)
            assert p40 == pytest.approx(217.9436, rel=1e-3)
        finally:
            s.stop()
            default_catalog().clear()


def test_fit_runs_packed_gram_plain_version_on_cpu(port, monkeypatch):
    calls = []
    real = kernels.packed_gram_reference
    monkeypatch.setattr(kernels, "packed_gram_reference",
                        lambda Z: calls.append(Z.shape) or real(Z))
    kernels.launches.reset()
    port_app(port, "abstract")
    assert calls == [(40, 3)]               # masked rows stay in Z as zeros
    assert kernels.launches.snapshot()["packed_gram"] == 0


def test_session_without_cuda_raises_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the error path needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession.builder().app_name("x").get_or_create()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSession.builder().config("spark.torch.device",
                                      "cuda:0").get_or_create()
    assert TorchSession.active() is None
    s = TorchSession.builder().config("spark.torch.device",
                                      "cpu").get_or_create()
    try:
        assert s.device == torch.device("cpu")
        with pytest.raises(ValueError, match="stop it"):
            TorchSession.builder().config("spark.torch.device",
                                          "cuda").get_or_create()
    finally:
        s.stop()


def test_frames_follow_the_session_device(port):
    f = port.createDataFrame({"a": np.arange(3.0)})
    assert f.device == torch.device("cpu")
    assert f._column_values("a").dtype == torch.float64
    g = port.createDataFrame([(1, 2.0), (3, 4.0)], ["i", "x"])
    assert g.dtypes() == [("i", "integer"), ("x", "double")]
