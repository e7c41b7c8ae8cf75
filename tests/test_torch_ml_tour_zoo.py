"""The ML tour's model zoo (``examples/ml_pipeline_tour.py:95-124``) on
dataset-full through both packages in one process: a gamma/log
GeneralizedLinearRegression (deviance, AIC, coefficient, intercept,
iterations), GBTRegressor(20, depth 3, step 0.2) graded by RMSE,
RandomForestClassifier(10 trees, depth 4) on guest > 25 graded by
accuracy, and KMeans(k=3, seed=7) graded by the silhouette, with its
cluster sizes; the JAX package's float32 output is ``chip_smoke.py``'s
``ZOO_TOUR_GOLDEN``, and the chip script's phase-13 code runs here on the
CPU at a small size.

Tolerances: under the float64 policy the GLM's iterations, the accuracy
and the sizes exact, the floats within rtol 1e-9; under the float32
policy (the JAX side with x64 off, the goldens' policy) the floats within
rtol 1e-5 and the GLM's iterations within one. The goldens are the JAX
package's float32 numbers to the last digit.
"""

import importlib.util
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dataset_path, prepare_features, run_dq_pipeline
from sparkdq4ml_tpu import session as jax_session
from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.models import clustering as jc
from sparkdq4ml_tpu.models import evaluation as je
from sparkdq4ml_tpu.models import glm as jg
from sparkdq4ml_tpu.models import tree as jt
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.sql import default_catalog

ROOT = pathlib.Path(__file__).resolve().parents[1]
POLICIES = {"float64": SimpleNamespace(name="float64", rtol=1e-9, iters=0),
            "float32": SimpleNamespace(name="float32", rtol=1e-5, iters=1)}


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


smoke = load_smoke()


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


def jax_zoo(session, monkeypatch) -> dict:
    """The tour's zoo section through the JAX package, as
    ``chip_smoke.zoo_tour`` returns it."""
    fdf = prepare_features(run_dq_pipeline(session, dataset_path("full")))
    ldf = fdf.with_column("label", (fdf.col("guest") > 25).cast("double"))
    # the fits on one device, as the tour runs them: the test session's
    # eight-device CPU mesh would shard them and sum in another order
    monkeypatch.setattr(jax_session, "_ACTIVE", None)
    glm = jg.GeneralizedLinearRegression(family="gamma", link="log").fit(fdf)
    gbt = jt.GBTRegressor(max_iter=20, max_depth=3, step_size=0.2).fit(fdf)
    gbt_rmse = je.RegressionEvaluator(metric_name="rmse").evaluate(
        gbt.transform(fdf))
    rf = jt.RandomForestClassifier(num_trees=10, max_depth=4).fit(ldf)
    out = rf.transform(ldf).to_pydict()
    km = jc.KMeans(k=3, seed=7, features_col="features").fit(fdf)
    sil = je.ClusteringEvaluator(features_col="features").evaluate(
        km.transform(fdf))
    return {"glm": {"deviance": float(glm.summary.deviance),
                    "aic": float(glm.summary.aic),
                    "coef": float(glm.coefficients[0]),
                    "intercept": float(glm.intercept),
                    "iterations": int(glm.summary.num_iterations)},
            "gbt_rmse": float(gbt_rmse),
            "rf_accuracy": float(np.mean(out["prediction"] == out["label"])),
            "silhouette": float(sil),
            "kmeans_sizes": sorted(km.summary.cluster_sizes)}


def same_zoo(got, want, policy):
    for k, v in want["glm"].items():
        if k == "iterations":
            assert abs(got["glm"][k] - v) <= policy.iters
        else:
            assert got["glm"][k] == pytest.approx(v, rel=policy.rtol), k
    for k in ("gbt_rmse", "silhouette"):
        assert got[k] == pytest.approx(want[k], rel=policy.rtol), k
    assert got["rf_accuracy"] == want["rf_accuracy"]
    assert got["kmeans_sizes"] == want["kmeans_sizes"]


def test_tour_zoo_matches_the_reference(policy, session, monkeypatch):
    want = jax_zoo(session, monkeypatch)
    try:
        got = smoke.zoo_tour("cpu")
    finally:
        default_catalog().clear()
    same_zoo(got, want, policy)


def test_chip_smoke_zoo_goldens_are_the_reference_output(session,
                                                        monkeypatch):
    """``ZOO_TOUR_GOLDEN`` is the JAX package's output under its default
    float32 policy (x64 off), and the port's float32 run meets it."""
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = jnp.float32
    try:
        with jax.enable_x64(False):
            want = jax_zoo(session, monkeypatch)
    finally:
        jax_config.default_float_dtype = old
    golden = smoke.ZOO_TOUR_GOLDEN
    assert golden["glm"]["iterations"] == want["glm"]["iterations"] == 8
    for k in ("deviance", "aic", "coef", "intercept"):
        assert golden["glm"][k] == pytest.approx(want["glm"][k],
                                                 rel=1e-12), k
    for k in ("gbt_rmse", "silhouette"):
        assert golden[k] == pytest.approx(want[k], rel=1e-12), k
    assert golden["rf_accuracy"] == want["rf_accuracy"]
    assert golden["kmeans_sizes"] == want["kmeans_sizes"]
    with float_policy(torch.float32):
        try:
            got = smoke.check_zoo_tour_golden("cpu")
        finally:
            default_catalog().clear()
    same_zoo(got, want, POLICIES["float32"])


def test_chip_smoke_zoo_steps_and_gates_run_on_the_cpu(monkeypatch):
    """Phase 13(b)-(c)'s fits, PIC graph and gates at 20,000 rows on the
    CPU: a float32 run against the float64 run through the script's own
    comparison (the launch counts are the card's and stay 0 here, so
    they are filled in as the card would count them)."""
    guest, price = smoke.full_table(20_000)
    fits = smoke.zoo_fits()
    graph, planted = smoke.pic_graph(nodes=300)
    runs = {}
    for name in ("float32", "float64"):
        with float_policy(getattr(torch, name)):
            spark, clean = smoke.clean_table("cpu", guest, price)
            fdf, ldf = smoke.zoo_frames(clean)
            runs[name] = {fit: fn(fdf, ldf) for fit, fn in fits}
            runs[name]["pic"] = {"assignments": smoke.pic_run("cpu", graph)}
            spark.stop()
    default_catalog().clear()
    card, cpu = runs["float32"], runs["float64"]
    assert smoke.same_results(card["gbt"], dict(card["gbt"])) == []
    assert card["glm"]["iterations"] > 2
    assert smoke.partition(card["pic"]["assignments"]).tolist() == \
        smoke.partition(planted).tolist()
    cpu["pic"]["planted"] = planted
    for name in ("gbt", "rf", "dt"):
        levels = int(np.log2(cpu[name]["feature"].shape[1] + 1)) - 1
        trees = cpu[name]["feature"].shape[0]
        # the float64 run's split margins as the recording wrapper keeps
        # them: here every split leads its runner-up clearly
        cpu[name]["margins"] = [np.array([[1.0, 0.0]] * 2 ** level)
                                for _ in range(trees)
                                for level in range(levels)]
    counts = dict.fromkeys(("dq_rules", "packed_gram", "masked_gram",
                            "dense_segment_sum", "sorted_segment_sum"), 0)
    launches = {name: dict(counts, dense_segment_sum=1, sorted_segment_sum=1)
                for name in ("gbt", "rf", "dt", "kmeans", "bisecting")}
    launches["glm"] = dict(counts,
                           masked_gram=card["glm"]["iterations"] + 1)
    smoke.check_zoo(card, cpu, launches)
    held, ties = smoke.split_gate(card["rf"], cpu["rf"], cpu["rf"]["margins"],
                                  False)
    assert held > 0 and all(t["card_gain"] <= smoke.ZOO_SPLIT_MARGIN *
                            abs(card["rf"]["gain"][t["tree"], 0])
                            for t in ties)
