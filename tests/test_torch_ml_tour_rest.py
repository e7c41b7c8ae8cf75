"""The ML tour's second half (``examples/ml_pipeline_tour.py:125-224``) on
dataset-full through both packages in one process: LinearSVC's accuracy,
FMClassifier on the XOR quadrants, IsotonicRegression guest → price,
AFTSurvivalRegression, FPGrowth, Word2Vec's synonyms, the LSH 3-NN, LDA,
PIC and PrefixSpan, in the tour's order and from its one numpy generator.
The JAX package's float32 output is ``chip_smoke.py``'s
``TOUR_REST_GOLDEN``; the chip script's phase-14(a) code
(``rest_tour``, ``check_rest_tour_golden``) runs here on the CPU.

Tolerances: accuracies, isotonic's boundary count, the itemsets and rules,
the top terms, the clusters and the sequences exact; isotonic's
predict(30) within 1e-9 (float64 on both sides); the top synonym equal;
the FM intercept, AFT's parameters, the LSH distances, the synonyms'
similarities and the log perplexity within 1e-9 (relative) under the
float64 policy and within ``REST_ATOL`` (1e-4) under float32, the goldens'
policy. The goldens are the JAX package's float32 numbers to the last
digit.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dataset_path, prepare_features, run_dq_pipeline
from sparkdq4ml_tpu import session as jax_session
from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.frame.frame import list_column as jlist
from sparkdq4ml_tpu.models import lda as jlda
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.sql import default_catalog

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


smoke = load_smoke()


def jax_rest(session, monkeypatch) -> dict:
    """The tour's second half through the JAX package, as
    ``chip_smoke.rest_tour`` returns it."""
    from sparkdq4ml_tpu.models import (LDA, AFTSurvivalRegression,
                                       BucketedRandomProjectionLSH,
                                       FMClassifier, FPGrowth,
                                       IsotonicRegression, LinearSVC,
                                       PowerIterationClustering, PrefixSpan,
                                       VectorAssembler, Word2Vec)

    for fn in (jlda._online_fit_fn, jlda._bound_fn, jlda._transform_fn):
        fn.cache_clear()
    fdf = prepare_features(run_dq_pipeline(session, dataset_path("full")))
    ldf = fdf.with_column("label", (fdf.col("guest") > 25).cast("double"))
    # the fits on one device, as the tour runs them
    monkeypatch.setattr(jax_session, "_ACTIVE", None)
    out = {}
    so = LinearSVC(max_iter=100, reg_param=0.01).fit(ldf).transform(
        ldf).to_pydict()
    out["svc_accuracy"] = float(np.mean(so["prediction"] == so["label"]))
    rng = np.random.default_rng(0)
    Xf = rng.normal(size=(400, 2))
    yf = (Xf[:, 0] * Xf[:, 1] > 0).astype(np.float64)
    fm_df = VectorAssembler(["a", "b"], "features").transform(
        JFrame({"a": Xf[:, 0], "b": Xf[:, 1], "label": yf}))
    fm = FMClassifier(factor_size=4, max_iter=400, step_size=0.05,
                      seed=1).fit(fm_df)
    out["fm_accuracy"] = float(np.mean(np.asarray(
        fm.transform(fm_df).to_pydict()["prediction"]) == yf))
    out["fm_intercept"] = fm.intercept
    d = fdf.to_pydict()
    iso = IsotonicRegression().fit(JFrame({
        "features": np.asarray(d["guest"], np.float64),
        "label": np.asarray(d["price"], np.float64)}))
    out["iso_predict_30"] = iso.predict(30.0)
    out["iso_boundaries"] = len(iso.boundaries)
    t = np.exp(1.0 + 0.3 * Xf[:, 0]
               + 0.4 * np.log(rng.exponential(size=400)))
    aft = AFTSurvivalRegression(max_iter=300).fit(
        VectorAssembler(["a"], "features").transform(JFrame({
            "a": Xf[:, 0], "label": t,
            "censor": (rng.random(400) > 0.2).astype(np.float64)})))
    out["aft"] = {"coef": float(aft.coefficients[0]),
                  "intercept": aft.intercept, "scale": aft.scale}
    fp = FPGrowth(min_support=0.4, min_confidence=0.7).fit(JFrame({
        "items": jlist([["wine", "cheese"], ["wine", "cheese", "bread"],
                        ["beer", "chips"], ["wine", "cheese", "grapes"],
                        ["beer", "chips", "salsa"]])}))
    rules = fp.association_rules.to_pydict()
    out["fpgrowth"] = {
        "itemsets": [[list(s), int(c)] for s, c in fp.itemsets],
        "antecedent": [list(a) for a in rules["antecedent"]],
        "consequent": [list(c) for c in rules["consequent"]],
        "confidence": [float(c) for c in rules["confidence"]]}
    docs = JFrame({"toks": jlist(
        [list(rng.choice(["wine", "cheese", "grapes"], 6))
         if rng.random() < 0.5 else
         list(rng.choice(["beer", "chips", "salsa"], 6))
         for _ in range(200)])})
    w2v = Word2Vec(vector_size=8, min_count=1, max_iter=8, window_size=3,
                   batch_size=256, seed=1, input_col="toks",
                   output_col="vec").fit(docs)
    syn = w2v.find_synonyms("wine", 2).to_pydict()
    out["synonyms"] = {"words": [str(w) for w in syn["word"]],
                       "similarity": [float(s) for s in syn["similarity"]]}
    lsh = BucketedRandomProjectionLSH(bucket_length=2.0, num_hash_tables=4,
                                      seed=3).fit(fm_df)
    nn = lsh.approx_nearest_neighbors(fm_df, Xf[0], 3)
    out["lsh_distances"] = [float(v) for v in np.sort(np.asarray(
        nn.to_pydict()["distCol"]))]
    topics = JFrame({"features": np.stack(
        [np.bincount(rng.integers(0, 6, 40), minlength=12).astype(np.float64)
         if rng.random() < 0.5 else
         np.bincount(rng.integers(6, 12, 40), minlength=12).astype(
             np.float64) for _ in range(60)])})
    lda = LDA(k=2, max_iter=25, optimizer="em", seed=1).fit(topics)
    out["lda_top_terms"] = [list(map(int, t)) for t in
                            lda.describe_topics(3).to_pydict()["termIndices"]]
    out["lda_log_perplexity"] = lda.log_perplexity(topics)
    ring = JFrame({
        "src": np.asarray([0, 1, 2, 3, 4, 5, 0, 3], np.int64),
        "dst": np.asarray([1, 2, 0, 4, 5, 3, 2, 5], np.int64),
        "weight": np.ones(8, np.float64)})
    out["pic_clusters"] = PowerIterationClustering(
        k=2, max_iter=20).assign_clusters(ring).to_pydict()["cluster"].tolist()
    visits = JFrame({"sequence": jlist(
        [[["home"], ["search"], ["cart"]],
         [["home"], ["search"], ["cart"], ["buy"]],
         [["home"], ["cart"]], [["search"], ["cart"]]])})
    ps = PrefixSpan(min_support=0.5).find_frequent_sequential_patterns(
        visits).to_pydict()
    out["prefixspan"] = {"sequences": [[list(i) for i in s]
                                       for s in ps["sequence"]],
                         "freq": [int(f) for f in ps["freq"]]}
    for fn in (jlda._online_fit_fn, jlda._bound_fn, jlda._transform_fn):
        fn.cache_clear()
    return out


def same_rest(got, want, rel, atol):
    for k in smoke.REST_EXACT:
        assert got[k] == want[k], k
    assert got["synonyms"]["words"][0] == want["synonyms"]["words"][0]
    assert abs(got["iso_predict_30"] - want["iso_predict_30"]) <= \
        smoke.REST_PREDICT_ATOL
    errs = smoke.rest_tour_errors(got, want)
    for name, a, b in (("fm_intercept", got["fm_intercept"],
                        want["fm_intercept"]),
                       ("lda", got["lda_log_perplexity"],
                        want["lda_log_perplexity"])):
        assert a == pytest.approx(b, rel=rel, abs=atol), name
    assert max(errs.values()) <= max(atol, rel * 10), errs


@pytest.mark.parametrize("name", ["float64", "float32"])
def test_tour_rest_matches_the_reference(session, monkeypatch, name):
    """Both packages under one policy; under float32 (x64 off, the tour's
    own) the JAX output is ``TOUR_REST_GOLDEN`` and the port's run passes
    the chip script's check."""
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, name)
    try:
        with jax.enable_x64(name == "float64"), \
                float_policy(getattr(torch, name)):
            want = jax_rest(session, monkeypatch)
            try:
                got = (smoke.rest_tour("cpu") if name == "float64"
                       else smoke.check_rest_tour_golden("cpu")["result"])
            finally:
                default_catalog().clear()
    finally:
        jax_config.default_float_dtype = old
    if name == "float64":
        same_rest(got, want, rel=1e-9, atol=1e-12)
        return
    golden = smoke.TOUR_REST_GOLDEN
    assert set(golden) == set(want)
    assert smoke.rest_tour_errors(want, golden) == {
        k: 0.0 for k in smoke.rest_tour_errors(want, golden)}
    for k in smoke.REST_EXACT + ("iso_predict_30", "synonyms"):
        assert want[k] == golden[k], k
    same_rest(got, want, rel=0.0, atol=smoke.REST_ATOL)
