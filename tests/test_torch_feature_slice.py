"""The sixteenth slice as a whole, on the CPU: ``chip_smoke.py`` phase 15's
feature pipeline (StringIndexer, OneHotEncoder, Imputer, Bucketizer,
QuantileDiscretizer, VectorAssembler, PolynomialExpansion, StandardScaler,
PCA, Correlation, Summarizer, ChiSquareTest, the two selectors, a binomial
LogisticRegression, and the SQLTransformer + RFormula pipeline saved and
loaded) at 10⁴ rows through the JAX package and through the port, in
both float policies; the phase's own gates and numpy checks on a small
table; and ``interop.feature_model_from_numpy``: each fitted feature model
of one package carried to the other through numpy, transforming the same
frame alike.

Tolerances: the pipeline's labels, sizes, surrogates, splits, bucket
counts, selections, degrees of freedom and RFormula's columns exact; its
floats under the float64 policy within rtol 1e-9 (atol 1e-12; PCA
components within 1e-9 where their eigen-gap exceeds 1e-2; the Newton
iterations exact), and under float32 within the card's own gates
(``chip_smoke.check_features``: moments 1e-4, correlations 1e-4, PCA 1e-3,
the classifier's coefficients 1e-3 of its largest, objective 1e-5,
iterations ±2). A carried model transforms within rtol 1e-12 (float64)
or 2e-6 (float32) of the model it came from. The float64 cases run at one
intra-op thread (``tests/torch_repro.py``).
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_feature_parity import (both, frames, policies, policy_fixture,
                                  same_frames, same_values)

from sparkdq4ml_tpu import models as jm
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.sql.catalog import default_catalog as jax_catalog
from sparkdq4ml_tpu_torch import models as tm
from sparkdq4ml_tpu_torch.interop import (FEATURE_MODELS,
                                          feature_model_from_numpy,
                                          feature_model_to_numpy)
from sparkdq4ml_tpu_torch.sql import default_catalog

ROOT = pathlib.Path(__file__).resolve().parents[1]
POLICIES = policies(1e-12, 1e-12, 2e-6, 1e-6)
policy = policy_fixture(POLICIES)


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


smoke = load_smoke()


def jax_table(cols, keep):
    df = JFrame({k: cols[k] for k in ("guest", "price", "price_holed",
                                      "tier")}, mask=jnp.asarray(keep))
    return smoke.feature_frame(df)


def leaves(res, path=""):
    """(path, value) of every number array and float of a step's
    results."""
    if isinstance(res, dict):
        for k, v in res.items():
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(res, (list, tuple)) and res and isinstance(
            res[0], (list, tuple, str)):
        return
    else:
        yield path, res


def test_phase15_pipeline_in_both_packages(policy, tmp_path):
    cols = smoke.feature_columns(*smoke.full_table(10_000, seed=3))
    spark, tdf = smoke.feature_tables("cpu", cols)
    keep = tdf._host_mask()
    try:
        got = smoke.run_features(tm, tdf, str(tmp_path / "port"))[0]
    finally:
        spark.stop()
        default_catalog().clear()
    try:
        want = smoke.run_features(jm, jax_table(cols, keep),
                                  str(tmp_path / "jax"))[0]
    finally:
        jax_catalog().clear()
    assert got["rformula_pipeline"]["loaded_same"]
    smoke.check_features(got, want)
    if policy.name == "float64":
        vals = np.sort(np.asarray(want["pca"]["explained_variance"]))[::-1]
        gaps = np.abs(np.diff(vals)) / vals[0]
        held = np.minimum(np.r_[np.inf, gaps], np.r_[gaps, np.inf]) > 1e-2
        for step in want:
            for path, w in leaves(want[step], step):
                g = dict(leaves(got[step], step))[path]
                if path == "pca.pc":
                    w, g = np.asarray(w)[:, held], np.asarray(g)[:, held]
                if path.startswith("correlation"):
                    w, g = np.nan_to_num(w), np.nan_to_num(g)
                np.testing.assert_allclose(
                    np.asarray(g, np.float64), np.asarray(w, np.float64),
                    rtol=1e-9, atol=1e-12, err_msg=path)


def test_phase15_gates_and_numpy_checks_on_the_cpu(tmp_path):
    """The phase's gates at 40,000 rows on the CPU: float32 over every
    row against numpy, its first 10,000 clean rows against the float64
    run, and two runs bit-identical."""
    from sparkdq4ml_tpu_torch.config import float_policy

    cols = smoke.feature_columns(*smoke.full_table(40_000))
    with float_policy(torch.float32):
        spark, df = smoke.feature_tables("cpu", cols)
        card = smoke.run_features(tm, df, str(tmp_path))[0]
        again = smoke.run_features(tm, df, str(tmp_path))[0]
        keep = df._host_mask()
        head = smoke.head_of(df, 10_000)
        head_card = smoke.run_features(tm, head, str(tmp_path))[0]
        spark.stop()
    assert all(smoke.same_canon(card[k], again[k]) for k in card)
    smoke.check_features_numpy(card, smoke.feature_numpy(cols, keep))
    end = head.num_slots
    with float_policy(torch.float64):
        spark, ref = smoke.feature_tables("cpu", {k: v[:end] for k, v in cols.items()},
                                keep[:end])
        want = smoke.run_features(tm, ref, str(tmp_path))[0]
        spark.stop()
    default_catalog().clear()
    errs = smoke.check_features(head_card, want)
    assert errs["pca.held"] == [0, 1, 2]
    bad = dict(card)
    bad["imputer"] = {"surrogates": [card["imputer"]["surrogates"][0] + 0.01]}
    with pytest.raises(AssertionError, match="surrogates"):
        smoke.check_features_numpy(bad, smoke.feature_numpy(cols, keep))
    bad = dict(head_card)
    bad["variance_selector"] = {"selected": [0]}
    with pytest.raises(AssertionError, match="variance_selector"):
        smoke.check_features(bad, want)


# ---------------------------------------------------------------------------
# interop.feature_model_from_numpy
# ---------------------------------------------------------------------------

def interop_cols(n=60, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    X[:, 2] = rng.integers(0, 3, n)
    a = rng.normal(5.0, 2.0, n)
    a[rng.random(n) < 0.2] = np.nan
    return {"features": X, "a": a,
            "c": list(rng.choice(["red", "green", "blue"], n)),
            "ci": rng.integers(0, 3, n).astype(np.float64),
            "k": rng.integers(0, 3, (n, 2)).astype(np.float64),
            "label": rng.integers(0, 2, n).astype(np.float64),
            "y": rng.normal(size=n)}


ESTIMATORS = [
    ("StandardScaler", dict(with_mean=True)),
    ("MinMaxScaler", dict()),
    ("MaxAbsScaler", dict()),
    ("RobustScaler", dict(with_centering=True)),
    ("StringIndexer", dict(input_col="c", output_col="c_idx")),
    ("OneHotEncoder", dict(input_col="ci", output_col="ci_vec")),
    ("QuantileDiscretizer", dict(num_buckets=4, input_col="a",
                                 output_col="a_q", handle_invalid="keep")),
    ("Imputer", dict(input_cols=["a"], strategy="mean")),
    ("PCA", dict(k=2)),
    ("VectorIndexer", dict(max_categories=3)),
    ("ChiSqSelector", dict(num_top_features=1, features_col="k")),
    ("VarianceThresholdSelector", dict(variance_threshold=0.5)),
    ("UnivariateFeatureSelector", dict(selection_threshold=2)),
    ("RFormula", dict(formula="y ~ c + a:ci")),
]


def build_jax(state: dict):
    """The JAX package's model of ``feature_model_to_numpy``'s dict, built
    as its ``load_stage`` builds one."""
    cls = getattr(jm, state["class"])
    obj = cls.__new__(cls)
    for k in cls._persist_attrs:
        setattr(obj, k, state[k])
    if hasattr(obj, "_post_load"):
        obj._post_load()
    return obj


def test_every_feature_model_kind_is_covered():
    cols = interop_cols()
    cols["a"] = np.nan_to_num(cols["a"])
    tf = frames(cols)[1]
    fitted = {type(getattr(tm, name)(**kw).fit(tf)).__name__
              for name, kw in ESTIMATORS}
    assert fitted == set(FEATURE_MODELS)


@pytest.mark.parametrize("name,kwargs", ESTIMATORS,
                         ids=[e[0] for e in ESTIMATORS])
def test_models_cross_through_numpy_both_ways(policy, name, kwargs):
    cols = interop_cols()
    if name == "RFormula":
        cols["a"] = np.nan_to_num(cols["a"])
    mask = np.arange(60) % 9 != 4
    jf, tf = frames(cols, mask)
    je, te = both(name, **kwargs)
    jmodel, tmodel = je.fit(jf), te.fit(tf)
    carried = feature_model_from_numpy(feature_model_to_numpy(jmodel))
    assert type(carried).__module__ == type(tmodel).__module__
    same_frames(jmodel.transform(jf), carried.transform(tf), policy)
    back = build_jax(feature_model_to_numpy(tmodel))
    same_frames(back.transform(jf), tmodel.transform(tf), policy)
    state = feature_model_to_numpy(carried)
    for k, v in feature_model_to_numpy(jmodel).items():
        if isinstance(v, (str, bool, type(None))):
            assert state[k] == v, k
        else:
            same_values(v, state[k], policy, k, exact=True)


def test_not_a_feature_model():
    with pytest.raises(TypeError, match="not a fitted feature model"):
        feature_model_to_numpy(tm.StandardScaler())
    with pytest.raises(TypeError, match="not a fitted feature model"):
        feature_model_from_numpy({"class": "LogisticRegressionModel"})
