"""Persistence and pipelines of the torch port (``models/base.py``,
``LinearRegressionModel.save``/``load``, ``interop.py``): the on-disk format
is the JAX package's, so a pipeline, a model or an estimator saved by one
package loads in the other and predicts the same; and the tour's pipeline
(``examples/ml_pipeline_tour.py``: random split, ``Pipeline``,
``RegressionEvaluator``, save/load round trip) gives the JAX package's
numbers in float64."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import dataset_path, prepare_features, run_dq_pipeline
from sparkdq4ml_tpu.frame.frame import Frame as JaxFrame
from sparkdq4ml_tpu.models import base as jax_base
from sparkdq4ml_tpu.models import (LinearRegression as JaxLR,
                                   Pipeline as JaxPipeline,
                                   RegressionEvaluator as JaxEvaluator,
                                   VectorAssembler as JaxAssembler)
from sparkdq4ml_tpu.models.regression import (
    LinearRegressionModel as JaxLRModel)
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame
from sparkdq4ml_tpu_torch.interop import (cv_model_from_numpy,
                                          linear_model_from_numpy)
from sparkdq4ml_tpu_torch.models import (LinearRegression,
                                         LinearRegressionModel, Pipeline,
                                         PipelineModel, RegressionEvaluator,
                                         VectorAssembler, load_stage)

RTOL = 1e-9


@pytest.fixture(autouse=True)
def _float64():
    with float_policy(torch.float64):
        yield


def _cols(session):
    """dataset-full, DQ-clean, as numpy (guest, price, label) and mask."""
    jdf = run_dq_pipeline(session, dataset_path("full"))
    jdf = jdf.with_column("label", jdf.col("price"))
    d = {k: np.array(v) for k, v in jdf._data.items()
         if k in ("guest", "price", "label")}
    return d, np.array(jdf.mask)


def _both(session):
    cols, mask = _cols(session)
    return Frame(cols, mask=mask, device="cpu"), JaxFrame(cols, mask=mask)


def _pipeline(mod_assembler, mod_lr):
    return [mod_assembler(["guest"], "features"),
            mod_lr(max_iter=40, reg_param=1.0, elastic_net_param=1.0)]


def _predictions(frame):
    return frame.to_pydict()["prediction"]


def test_tour_pipeline_matches_the_reference(session, tmp_path):
    df, jdf = _both(session)
    train, test = df.random_split([0.8, 0.2], seed=7)
    jtrain, jtest = jdf.random_split([0.8, 0.2], seed=7)
    assert (train.count(), test.count()) == (jtrain.count(), jtest.count())
    model = Pipeline(_pipeline(VectorAssembler, LinearRegression)).fit(train)
    jmodel = JaxPipeline(_pipeline(JaxAssembler, JaxLR)).fit(jtrain)
    rmse = RegressionEvaluator(metric_name="rmse").evaluate(
        model.transform(test))
    jrmse = JaxEvaluator(metric_name="rmse").evaluate(jmodel.transform(jtest))
    assert rmse == pytest.approx(jrmse, rel=RTOL)
    path = str(tmp_path / "pipeline_model")
    model.save(path)
    restored = PipelineModel.load(path)
    r2 = RegressionEvaluator(metric_name="r2").evaluate(
        restored.transform(test))
    assert r2 == RegressionEvaluator(metric_name="r2").evaluate(
        model.transform(test))
    assert r2 > 0.99


def test_jax_saved_pipeline_predicts_the_same_in_the_port(session, tmp_path):
    df, jdf = _both(session)
    jmodel = JaxPipeline(_pipeline(JaxAssembler, JaxLR)).fit(jdf)
    path = str(tmp_path / "jax_pipeline")
    jmodel.save(path)
    model = PipelineModel.load(path)
    assert [type(s).__name__ for s in model.stages] == \
        ["VectorAssembler", "LinearRegressionModel"]
    np.testing.assert_array_equal(model.stages[1].coefficients,
                                  jmodel.stages[1].coefficients)
    np.testing.assert_allclose(_predictions(model.transform(df)),
                               _predictions(jmodel.transform(jdf)),
                               rtol=1e-15)
    assert isinstance(load_stage(path), PipelineModel)


def test_port_saved_pipeline_predicts_the_same_in_jax(session, tmp_path):
    df, jdf = _both(session)
    model = Pipeline(_pipeline(VectorAssembler, LinearRegression)).fit(df)
    path = str(tmp_path / "port_pipeline")
    model.write().overwrite().save(path)
    jmodel = jax_base.PipelineModel.load(path)
    np.testing.assert_array_equal(jmodel.stages[1].coefficients,
                                  model.stages[1].coefficients)
    np.testing.assert_allclose(_predictions(jmodel.transform(jdf)),
                               _predictions(model.transform(df)),
                               rtol=1e-15)


def test_huber_model_scale_round_trips_both_ways(session, tmp_path):
    df, jdf = _both(session)
    df = VectorAssembler(["guest"], "features").transform(df)
    jdf = prepare_features(jdf)
    model = LinearRegression(loss="huber", max_iter=100).fit(df)
    path = str(tmp_path / "huber")
    model.save(path)
    jmodel = JaxLRModel.load(path)
    assert jmodel.scale == model.scale != 1.0
    assert jmodel._params["loss"] == "huber"
    jref = JaxLR(loss="huber", max_iter=100).fit(jdf)
    jpath = str(tmp_path / "jax_huber")
    jref.save(jpath)
    back = LinearRegressionModel.load(jpath)
    assert back.scale == jref.scale
    assert back.scale == pytest.approx(model.scale, rel=1e-6)
    assert not back.has_summary
    with pytest.raises(RuntimeError, match="summary"):
        back.summary
    carried = linear_model_from_numpy(jref.coefficients, jref.intercept,
                                      dict(jref._params), scale=jref.scale)
    assert carried.scale == jref.scale
    assert carried.predict([40.0]) == jref.predict([40.0])
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    assert set(meta) == {"class", "intercept", "scale", "params"}


def test_estimators_and_stages_round_trip_both_ways(tmp_path):
    est = LinearRegression(max_iter=7, reg_param=0.3, loss="huber",
                           weight_col="w", epsilon=1.5)
    est.save(str(tmp_path / "port_est"))
    jest = jax_base.load_stage(str(tmp_path / "port_est"))
    assert jest._params_dict() == est._params_dict()
    jest.save(str(tmp_path / "jax_est"))
    back = LinearRegression.load(str(tmp_path / "jax_est"))
    assert back._params_dict() == est._params_dict()
    pipe = Pipeline([VectorAssembler(["a", "b"], "f"), est])
    pipe.save(str(tmp_path / "pipe"))
    jpipe = jax_base.Pipeline.load(str(tmp_path / "pipe"))
    assert [type(s).__name__ for s in jpipe.get_stages()] == \
        ["VectorAssembler", "LinearRegression"]
    again = load_stage(str(tmp_path / "pipe"))
    with pytest.raises(TypeError, match="not a PipelineModel"):
        PipelineModel.load(str(tmp_path / "pipe"))
    assert again.getStages()[0].input_cols == ["a", "b"]
    with pytest.raises(ValueError, match="not a LinearRegressionModel"):
        LinearRegressionModel.load(str(tmp_path / "pipe"))
    with pytest.raises(TypeError, match="not persistable"):
        Pipeline([object()]).save(str(tmp_path / "bad"))


def test_cv_model_carries_metrics_as_numpy():
    best = linear_model_from_numpy([2.0], 1.0)
    cv = cv_model_from_numpy(best, [0.5, 0.25, 0.75], 1)
    assert cv.best_index == 1 and cv.bestModel is best
    assert cv.avg_metrics.dtype == np.float64
    np.testing.assert_array_equal(cv.avgMetrics, [0.5, 0.25, 0.75])
    frame = Frame({"features": np.array([[1.0], [2.0]])}, device="cpu")
    np.testing.assert_array_equal(_predictions(cv.transform(frame)),
                                  [3.0, 5.0])
