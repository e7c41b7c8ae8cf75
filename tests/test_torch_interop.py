"""State carried between the JAX package and the torch port through numpy
(``sparkdq4ml_tpu_torch/interop.py``), and the port's independence: no
module of ``sparkdq4ml_tpu_torch`` and not ``chip_smoke.py`` imports JAX
or the JAX package."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from conftest import dataset_path, prepare_features, run_dq_pipeline
from sparkdq4ml_tpu.frame.frame import Frame as JaxFrame
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.interop import (frame_from_numpy,
                                          linear_model_from_numpy)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _float64():
    with float_policy(torch.float64):
        yield


def test_jax_fit_predicts_the_same_in_the_port(session):
    from sparkdq4ml_tpu.models import LinearRegression, Vectors

    jdf = prepare_features(run_dq_pipeline(session, dataset_path("full")))
    jmodel = (LinearRegression().setMaxIter(40).setRegParam(1)
              .setElasticNetParam(1)).fit(jdf)
    model = linear_model_from_numpy(np.asarray(jmodel.coefficients),
                                    np.asarray(jmodel.intercept),
                                    {"reg_param": 1.0})
    assert model.predict(Vectors.dense(40.0)) == \
        jmodel.predict(Vectors.dense(40.0))
    assert model.getRegParam() == 1.0
    cols = jdf.to_pydict()
    tdf = frame_from_numpy({"features": cols["features"],
                            "label": cols["label"]}, device="cpu")
    got = model.transform(tdf).to_pydict()["prediction"]
    want = jmodel.transform(jdf).to_pydict()["prediction"]
    np.testing.assert_array_equal(got, want)
    ev, jev = model.evaluate(tdf), jmodel.evaluate(jdf)
    assert ev.rootMeanSquaredError == jev.root_mean_squared_error
    assert ev.r2 == jev.r2


def test_same_seeded_data_feeds_both_frames():
    rng = np.random.default_rng(0)
    cols = {"guest": rng.integers(1, 40, 50).astype(np.int32),
            "price": np.round(rng.uniform(0, 130, 50), 2)}
    mask = rng.random(50) > 0.3
    t = frame_from_numpy(cols, mask=mask, device="cpu")
    j = JaxFrame(cols, mask=mask)
    assert t.count() == j.count() == int(mask.sum())
    assert t.dtypes() == j.dtypes()
    d, e = t.to_pydict(), j.to_pydict()
    for c in cols:
        np.testing.assert_array_equal(d[c], e[c])
    assert t.show_string(10) == j.show_string(10)


def _imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "sparkdq4ml_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "sparkdq4ml_tpu"), \
                f"{path.relative_to(ROOT)} imports {name}"
