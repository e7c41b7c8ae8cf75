"""MultilayerPerceptronClassifier of the port (``models/mlp.py``) held
against the JAX package on the CPU in both float policies: the forward
pass, the Glorot draws (bit for bit, at several layer stacks and seeds),
every single-device case of ``tests/test_mlp.py`` (XOR, sklearn quality,
three classes, the layer validations, the default layers, persistence),
masked rows holding NaN, the label and feature validations, ``mesh=``,
save/load in both directions and ``interop.mlp_model_from_numpy``.

Tolerances: initial weights, layer sizes and predictions are exact; the
forward pass within rtol 1e-12 (float64) and 1e-6 (float32); loss
histories within rtol 1e-9 (float64) and 1e-5 (float32); fitted weights
and probabilities within 1e-8 and 1e-4 of their largest magnitude. The
float64 cases run at one intra-op thread (``tests/torch_repro.py``).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.models import VectorAssembler as JVectorAssembler
from sparkdq4ml_tpu.models import base as jbase
from sparkdq4ml_tpu.models import mlp as jmlp
from sparkdq4ml_tpu_torch import interop
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.models import VectorAssembler as TVectorAssembler
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import mlp as tmlp
from sparkdq4ml_tpu_torch.session import TorchSession
from torch_repro import one_intra_op_thread

POLICIES = {"float64": SimpleNamespace(name="float64", fwd=1e-12,
                                       loss=1e-9, scale=1e-8),
            "float32": SimpleNamespace(name="float32", fwd=1e-6,
                                       loss=1e-5, scale=1e-4)}


@pytest.fixture(autouse=True)
def cpu_session():
    """A model that was not fitted here computes on the session's device:
    every case runs in a session on the CPU."""
    s = (TorchSession.builder().config("spark.torch.device", "cpu")
         .get_or_create())
    yield s
    s.stop()


@pytest.fixture(params=sorted(POLICIES))
def policy(request):
    pol = POLICIES[request.param]
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, pol.name)
    jmlp._mlp_fit_fn.cache_clear()
    try:
        with jax.enable_x64(pol.name == "float64"), \
                float_policy(getattr(torch, pol.name)), \
                one_intra_op_thread():
            yield pol
    finally:
        jax_config.default_float_dtype = old
        jmlp._mlp_fit_fn.cache_clear()


def close_norm(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * max(float(np.max(np.abs(want))), 1.0), \
        f"{what}: off by {err}"


def xor_cols(n=400, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 2))
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float64)
    return {"a": X[:, 0], "b": X[:, 1], "label": y}, X, y


def frames(cols, mask=None):
    j = JVectorAssembler(["a", "b"], "features").transform(
        JFrame(dict(cols), mask=mask))
    t = TVectorAssembler(["a", "b"], "features").transform(
        TFrame(dict(cols), mask=mask, device="cpu"))
    return j, t


def same_fit(a, b, pol, j, t):
    assert b.layers == a.layers
    np.testing.assert_allclose(b.loss_history, a.loss_history,
                               rtol=pol.loss, atol=0)
    for (Wa, ba), (Wb, bb) in zip(a.weights, b.weights):
        assert Wb.dtype == np.float64
        close_norm(Wb, Wa, pol.scale, "W")
        close_norm(bb, ba, pol.scale, "b")
    da, db = a.transform(j).to_pydict(), b.transform(t).to_pydict()
    np.testing.assert_array_equal(db["prediction"], da["prediction"])
    close_norm(np.stack(db["probability"]), np.stack(da["probability"]),
               pol.scale, "probability")
    close_norm(np.stack(db["rawPrediction"]), np.stack(da["rawPrediction"]),
               pol.scale, "logits")
    return db


@pytest.mark.parametrize("layers", [[2, 3], [4, 8, 3], [5, 7, 6, 2]])
def test_forward_matches_the_reference(policy, layers):
    rng = np.random.default_rng(len(layers))
    dt = np.dtype(policy.name)
    params = [(rng.normal(size=(i, o)).astype(dt),
               rng.normal(size=o).astype(dt))
              for i, o in zip(layers[:-1], layers[1:])]
    X = rng.normal(size=(33, layers[0])).astype(dt)
    a = jmlp._mlp_forward([(jnp.asarray(W), jnp.asarray(b))
                           for W, b in params], jnp.asarray(X))
    b = tmlp._mlp_forward([(torch.as_tensor(W), torch.as_tensor(b))
                           for W, b in params], torch.as_tensor(X))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=policy.fwd,
                               atol=policy.fwd)


@pytest.mark.parametrize("layers,seed", [([2, 8, 2], 1), ([2, 4, 2], 3),
                                         ([1024, 64, 32, 4], 7),
                                         ([3, 41, 19, 5], 0),
                                         ([20, 21, 24], 5)])
def test_glorot_draws_are_bit_identical(policy, layers, seed):
    """Fan sums 41 and 45 (the last stack) are two where a float32 root of
    the float32 quotient, JAX's limit with x64 off, differs from the
    float64 root rounded to float32."""
    dt = getattr(jnp, policy.name)
    key = jax.random.PRNGKey(seed)
    mine = tmlp.glorot_params(layers, seed, getattr(torch, policy.name),
                              "cpu")
    for (fan_in, fan_out), (W, b) in zip(zip(layers[:-1], layers[1:]),
                                         mine):
        key, k1 = jax.random.split(key)
        limit = jnp.sqrt(6.0 / (fan_in + fan_out)).astype(dt)
        want = np.asarray(jax.random.uniform(k1, (fan_in, fan_out), dt,
                                             -limit, limit))
        assert W.numpy().dtype == want.dtype
        np.testing.assert_array_equal(W.numpy(), want)
        np.testing.assert_array_equal(b.numpy(), 0.0)


def test_first_step_starts_from_the_draws(policy):
    """max_iter=0 keeps the initial weights: the JAX package's, exactly."""
    cols, X, _ = xor_cols(n=50)
    j, t = frames(cols)
    kw = dict(layers=[2, 5, 2], max_iter=0, seed=9)
    a = jmlp.MultilayerPerceptronClassifier(**kw).fit(j)
    b = tmlp.MultilayerPerceptronClassifier(**kw).fit(t)
    for (Wa, ba), (Wb, bb) in zip(a.weights, b.weights):
        np.testing.assert_array_equal(Wb, Wa)
        np.testing.assert_array_equal(bb, ba)
    assert b.loss_history == a.loss_history == []


@pytest.mark.parametrize("kw", [
    dict(layers=[2, 8, 2], max_iter=800, step_size=0.05, seed=1),
    dict(layers=[2, 4, 2], max_iter=120, step_size=0.05, seed=3),
    dict(layers=[2, 4, 2], max_iter=50, seed=1),
])
def test_xor_matches_the_reference(policy, kw):
    cols, X, y = xor_cols()
    j, t = frames(cols)
    a = jmlp.MultilayerPerceptronClassifier(**kw).fit(j)
    b = tmlp.MultilayerPerceptronClassifier(**kw).fit(t)
    db = same_fit(a, b, policy, j, t)
    assert b.predict(X[0]) == a.predict(X[0])
    if kw["max_iter"] == 800:
        assert np.mean(db["prediction"] == y) > 0.95
        np.testing.assert_allclose(np.stack(db["probability"]).sum(axis=1),
                                   1.0, rtol=1e-5)
        assert b.loss_history[-1] < b.loss_history[0] * 0.3


def test_sklearn_quality_parity():
    """As ``tests/test_mlp.py`` runs it: under the float64 policy (the
    float32 fit, in both packages, reaches 0.82 on this draw)."""
    pytest.importorskip("sklearn")
    from sklearn.neural_network import MLPClassifier as SkMLP

    cols, X, y = xor_cols(seed=3)
    with float_policy(torch.float64):
        _, t = frames(cols)
        ours = tmlp.MultilayerPerceptronClassifier(
            layers=[2, 8, 2], max_iter=800, step_size=0.05, seed=1).fit(t)
    acc = np.mean(ours.transform(t).to_pydict()["prediction"] == y)
    sk = SkMLP(hidden_layer_sizes=(8,), max_iter=2000,
               random_state=0).fit(X, y)
    assert acc >= sk.score(X, y) - 0.05


def test_multiclass_matches_the_reference(policy):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(450, 2))
    y = (np.arctan2(X[:, 1], X[:, 0]) // (2 * np.pi / 3) % 3).astype(
        np.float64)
    j, t = frames({"a": X[:, 0], "b": X[:, 1], "label": y})
    kw = dict(layers=[2, 16, 3], max_iter=800, step_size=0.05, seed=2)
    a = jmlp.MultilayerPerceptronClassifier(**kw).fit(j)
    b = tmlp.MultilayerPerceptronClassifier(**kw).fit(t)
    db = same_fit(a, b, policy, j, t)
    assert np.mean(db["prediction"] == y) > 0.9


def test_masked_rows_are_ignored(policy):
    cols, X, y = xor_cols(n=120, seed=4)
    keep = np.ones(120, bool)
    keep[::7] = False
    cols = dict(cols, a=np.where(keep, cols["a"], np.nan),
                label=np.where(keep, cols["label"], -3.0))
    j, t = frames(cols, mask=keep)
    kw = dict(layers=[2, 6, 2], max_iter=60, step_size=0.05, seed=2)
    a = jmlp.MultilayerPerceptronClassifier(**kw).fit(j)
    b = tmlp.MultilayerPerceptronClassifier(**kw).fit(t)
    same_fit(a, b, policy, j, t)


def test_default_layers_logistic_like(policy):
    cols, _, _ = xor_cols(n=60)
    j, t = frames(cols)
    a = jmlp.MultilayerPerceptronClassifier(max_iter=20).fit(j)
    b = tmlp.MultilayerPerceptronClassifier(max_iter=20).fit(t)
    assert b.layers == a.layers == [2, 2]
    same_fit(a, b, policy, j, t)


def test_validations():
    cols, _, _ = xor_cols(n=50)
    _, t = frames(cols)
    M = tmlp.MultilayerPerceptronClassifier
    with pytest.raises(ValueError, match="layers\\[0\\]"):
        M(layers=[5, 2], max_iter=5).fit(t)
    with pytest.raises(ValueError, match="observed classes"):
        M(layers=[2, 4, 1], max_iter=5).fit(t)
    with pytest.raises(ValueError, match="at least"):
        M(layers=[2], max_iter=5).fit(t)
    for bad in (-1.0, 0.5, np.nan):
        c = dict(cols, label=np.where(np.arange(50) == 3, bad,
                                      cols["label"]))
        with pytest.raises(ValueError, match="nonnegative integers"):
            M(max_iter=5).fit(frames(c)[1])
    c = dict(cols, b=np.where(np.arange(50) == 4, np.inf, cols["b"]))
    with pytest.raises(ValueError, match="NaN/inf"):
        M(max_iter=5).fit(frames(c)[1])
    with pytest.raises(ValueError, match="no valid rows"):
        M(max_iter=5).fit(frames(cols, mask=np.zeros(50, bool))[1])
    with pytest.raises(NotImplementedError, match="mesh"):
        M(max_iter=5).fit(t, mesh=object())
    est = (M().setLayers([2, 3, 2]).setMaxIter(7).setStepSize(0.1)
           .setSeed(4).setFeaturesCol("f").setLabelCol("l")
           .setPredictionCol("p"))
    assert (est.layers, est.max_iter, est.step_size, est.seed,
            est.features_col, est.label_col, est.prediction_col) == \
        ([2, 3, 2], 7, 0.1, 4, "f", "l", "p")


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_persistence_both_ways(tmp_path, direction):
    cols, X, _ = xor_cols(n=80)
    j, t = frames(cols)
    kw = dict(layers=[2, 4, 2], max_iter=50, seed=1)
    path = str(tmp_path / "mlp")
    if direction == "port_to_jax":
        src = tmlp.MultilayerPerceptronClassifier(**kw).fit(t)
        src.save(path)
        back = jbase.load_stage(path)
        out, src_out = back.transform(j), src.transform(t)
    else:
        src = jmlp.MultilayerPerceptronClassifier(**kw).fit(j)
        src.save(path)
        back = tbase.load_stage(path)
        assert isinstance(back,
                          tmlp.MultilayerPerceptronClassificationModel)
        out, src_out = back.transform(t), src.transform(j)
    assert back.predict(X[0]) == src.predict(X[0])
    assert back.num_features == back.numFeatures == 2
    np.testing.assert_allclose(np.stack(out.to_pydict()["probability"]),
                               np.stack(src_out.to_pydict()["probability"]),
                               rtol=1e-6)
    est = tmlp.MultilayerPerceptronClassifier(**kw)
    est.save(str(tmp_path / "est"))
    other = jbase.load_stage(str(tmp_path / "est"))
    assert {k: getattr(other, k) for k in est._persist_attrs} == \
        {k: getattr(est, k) for k in est._persist_attrs}


def test_interop_model_predicts_as_the_reference(policy):
    cols, X, _ = xor_cols(n=90, seed=6)
    j, t = frames(cols)
    a = jmlp.MultilayerPerceptronClassifier(layers=[2, 5, 2], max_iter=40,
                                            seed=2).fit(j)
    b = interop.mlp_model_from_numpy(a.layers, a.weights, a._params,
                                     a.loss_history)
    da, db = a.transform(j).to_pydict(), b.transform(t).to_pydict()
    np.testing.assert_array_equal(db["prediction"], da["prediction"])
    close_norm(np.stack(db["probability"]), np.stack(da["probability"]),
               policy.scale, "probability")
    assert [b.predict(x) for x in X[:10]] == [a.predict(x) for x in X[:10]]


def test_predict_computes_on_the_sessions_device(cpu_session):
    """``predict`` of one vector runs on the session's device; with no
    session it asks for the card, and refuses where there is none."""
    _, X, _ = xor_cols(n=40)
    m = interop.mlp_model_from_numpy(
        [2, 3, 2], [(np.ones((2, 3)), np.zeros(3)),
                    (np.asarray([[1.0, -1.0]] * 3), np.zeros(2))])
    assert m.predict(X[0]) == 0.0
    cpu_session.stop()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.predict(X[0])
