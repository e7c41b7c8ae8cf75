"""``spark.ml.stat`` of the port (``sparkdq4ml_tpu_torch/models/stat.py``)
held against the JAX package on the CPU in both float policies, on the
single-device cases of ``tests/test_stat.py`` (``Correlation``,
``Summarizer`` and ``summary``, ``ChiSquareTest``,
``KolmogorovSmirnovTest``, the Summarizer's weight column), with masked
rows, NaN, constant and weighted columns added; the moment pass's
scatter read off one ``masked_gram`` (its plain version here) and its
sums off the dense segment sum's whole form; a mesh raises.

Tolerances: counts, degrees of freedom, selections and the KS test (a host
step in both packages) exact; correlations, moments, norms, χ²
statistics and p-values within rtol 1e-12 (atol 1e-12) under the float64
policy, where the port's fixed-order sums and XLA's reductions round apart
in the last bits, and within rtol 1e-5 (atol 1e-6) under float32 (a
float32 scatter of 60–500 rows summed in another order). Minima and
maxima are exact. The float64 cases run at one intra-op thread
(``tests/torch_repro.py``).
"""

import numpy as np
import pytest
import torch
from torch_feature_parity import (frames, policies, policy_fixture,
                                  raises_both, same_frames, same_values)

from sparkdq4ml_tpu.models import stat as js
from sparkdq4ml_tpu_torch.models import stat as ts
from sparkdq4ml_tpu_torch.ops import kernels

POLICIES = policies(1e-12, 1e-12, 1e-5, 1e-6)
policy = policy_fixture(POLICIES)


def xyz(n=60, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    y = 2.0 * x + rng.normal(scale=0.5, size=n)
    z = rng.normal(size=n)
    return {"features": np.stack([x, y, z], axis=1),
            "w": rng.uniform(0.0, 3.0, n)}


@pytest.mark.parametrize("method", ["pearson", "spearman"])
@pytest.mark.parametrize("masked", [False, True])
def test_correlation_matrix(policy, method, masked):
    cols = xyz()
    if method == "spearman":
        cols["features"][::4, 2] = 0.5          # ties
    mask = np.arange(60) % 5 != 0 if masked else None
    jf, tf = frames(cols, mask)
    want = js.Correlation.corr(jf, "features", method=method)
    got = ts.Correlation.corr(tf, "features", method=method)
    same_values(want, got, policy)


def test_correlation_constant_feature_and_nan(policy):
    jf, tf = frames({"features": np.asarray([[1.0, 1.0, 2.0], [1.0, 2.0, 1.0],
                                             [1.0, 3.0, np.nan]])})
    for method in ("pearson", "spearman"):
        want = js.Correlation.corr(jf, "features", method=method)
        got = ts.Correlation.corr(tf, "features", method=method)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        same_values(np.nan_to_num(want), np.nan_to_num(got), policy)


def test_correlation_rejects_unknown_method_and_mesh(policy):
    jf, tf = frames(xyz())
    raises_both(ValueError, "unknown correlation",
                lambda: js.Correlation.corr(jf, "features", "kendall"),
                lambda: ts.Correlation.corr(tf, "features", "kendall"))
    with pytest.raises(NotImplementedError, match="one device"):
        ts.Correlation.corr(tf, "features", mesh=object())


@pytest.mark.parametrize("masked", [False, True])
def test_summary_all_metrics(policy, masked):
    cols = xyz()
    cols["features"][::7, 1] = 0.0              # nonzero counts
    mask = np.arange(60) % 3 != 0 if masked else None
    jf, tf = frames(cols, mask)
    want, got = js.summary(jf, "features"), ts.summary(tf, "features")
    assert want["count"] == got["count"]
    for k in ("min", "max", "numNonZeros"):
        same_values(want[k], got[k], policy, k, exact=True)
    same_values(want, got, policy)


def test_summarizer_metric_selection(policy):
    jf, tf = frames(xyz())
    want = js.Summarizer.metrics("mean", "count").summary(jf, "features")
    got = ts.Summarizer.metrics("mean", "count").summary(tf, "features")
    assert set(got) == {"mean", "count"}
    same_values(want, got, policy)
    raises_both(ValueError, "unknown metrics",
                lambda: js.Summarizer.metrics("median"),
                lambda: ts.Summarizer.metrics("median"))


@pytest.mark.parametrize("masked", [False, True])
def test_summarizer_weight_col(policy, masked):
    cols = xyz()
    cols["w"][::6] = 0.0                        # skipped rows
    mask = np.arange(60) % 4 != 1 if masked else None
    jf, tf = frames(cols, mask)
    s_j = js.Summarizer(js.Summarizer.METRICS)
    s_t = ts.Summarizer(ts.Summarizer.METRICS)
    want = s_j.summary(jf, weight_col="w")
    got = s_t.summary(tf, weight_col="w")
    assert want["count"] == got["count"]
    same_values(want, got, policy)


def test_summarizer_weights_equal_repetition(policy):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(30, 4))
    w = rng.integers(1, 4, size=30).astype(np.float64)
    _, tw = frames({"features": X, "w": w})
    _, tr = frames({"features": X[np.repeat(np.arange(30), w.astype(int))]})
    s = ts.Summarizer(ts.Summarizer.METRICS)
    a, b = s.summary(tw, weight_col="w"), s.summary(tr)
    for k in ("mean", "variance", "normL1", "normL2", "min", "max"):
        np.testing.assert_allclose(a[k], b[k], rtol=max(policy.rtol, 1e-9))
    assert a["count"] == 30


@pytest.mark.parametrize("bad", [-2.0, np.nan])
def test_negative_or_nan_weight_rejected(policy, bad):
    jf, tf = frames({"features": np.asarray([[1.0], [2.0]]),
                     "w": np.asarray([1.0, bad])})
    raises_both(ValueError, "nonnegative",
                lambda: js.Summarizer(("mean",)).summary(jf, weight_col="w"),
                lambda: ts.Summarizer(("mean",)).summary(tf, weight_col="w"))


def test_moment_pass_through_the_kernels(policy, monkeypatch):
    """The scatter is one masked_gram of the centered rows with √w, and
    the sums go through the dense segment sum's whole form without ids."""
    calls = {"gram": 0, "whole": 0}
    gram, seg = kernels.masked_gram, kernels.dense_segment_sum

    def counted_gram(X, y, w):
        calls["gram"] += 1
        return gram(X, y, w)

    def counted_seg(x, s, size):
        calls["whole"] += s is None
        assert s is not None or x.shape[-1] <= kernels.SEGSUM_REG_COLS
        return seg(x, s, size)

    monkeypatch.setattr(kernels, "masked_gram", counted_gram)
    monkeypatch.setattr(kernels, "dense_segment_sum", counted_seg)
    cols = xyz()
    jf, tf = frames(cols)
    X = torch.as_tensor(cols["features"]).to(tf._column_values(
        "features").dtype)
    w = torch.as_tensor(cols["w"]).to(X.dtype)
    n, mean, C, *_ = ts._moment_stats(X, w)
    assert calls["gram"] == 1 and calls["whole"] == 5   # n, Σx, l1, l2, nnz
    Xc = (X - mean) * torch.sqrt(w)[:, None]
    np.testing.assert_allclose(C.numpy(), (Xc.T @ Xc).numpy(),
                               rtol=max(policy.rtol, 1e-12) * 10,
                               atol=policy.atol)
    want = js._moment_pass(jf._column_values("features"),
                           np.asarray(cols["w"]))
    same_values([np.asarray(v) for v in want], [v for v in (
        n, mean, C, *ts._moment_stats(X, w)[3:])], policy)


def chi_frame(n=500, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, size=n).astype(float)
    x0 = ((y + rng.integers(0, 2, size=n)) % 4).astype(float)
    x1 = rng.integers(0, 5, size=n).astype(float)
    x2 = np.where(rng.random(n) < 0.5, 0.0, 6.0)       # empty categories
    return {"features": np.stack([x0, x1, x2], axis=1), "label": y}


@pytest.mark.parametrize("masked", [False, True])
def test_chi_square_matches(policy, masked):
    mask = np.arange(500) % 3 != 0 if masked else None
    jf, tf = frames(chi_frame(), mask)
    want = js.ChiSquareTest.test(jf, "features", "label")
    got = ts.ChiSquareTest.test(tf, "features", "label")
    a, b = want.to_pydict(), got.to_pydict()
    assert list(a) == list(b)
    same_values(a["degreesOfFreedom"][0], b["degreesOfFreedom"][0], policy,
                exact=True)
    same_values(a["statistics"][0], b["statistics"][0], policy)
    same_values(a["pValues"][0], b["pValues"][0], policy)


def test_chi_square_single_category_and_checks(policy):
    jf, tf = frames({"features": np.asarray([[1.0, 0.0], [1.0, 1.0],
                                             [1.0, 0.0]]),
                     "label": np.asarray([0.0, 1.0, 1.0])})
    same_frames(js.ChiSquareTest.test(jf), ts.ChiSquareTest.test(tf), policy)
    for cols, msg in (({"features": np.asarray([[0.5], [1.2]]),
                        "label": np.asarray([0.0, 1.0])}, "categorical"),
                      ({"features": np.asarray([[0.0], [1.0]]),
                        "label": np.asarray([0.0, -1.0])}, "labels"),
                      ({"features": np.asarray([[np.nan], [1.0]]),
                        "label": np.asarray([0.0, 1.0])}, "categorical")):
        jf, tf = frames(cols)
        raises_both(ValueError, msg, lambda: js.ChiSquareTest.test(jf),
                    lambda: ts.ChiSquareTest.test(tf))
    jf, tf = frames(chi_frame(), np.zeros(500, bool))
    raises_both(ValueError, "no valid rows",
                lambda: js.ChiSquareTest.test(jf),
                lambda: ts.ChiSquareTest.test(tf))


@pytest.mark.parametrize("args", [("norm", 0.0, 1.0), ("norm",),
                                  ("norm", 1.0, 1.0), ("expon",),
                                  ("uniform", -3.0, 6.0)])
def test_kolmogorov_smirnov(policy, args):
    rng = np.random.default_rng(1)
    x = rng.normal(loc=0.3, size=300)
    x[::5] = 1e3
    jf, tf = frames({"x": x}, np.arange(300) % 5 != 0)
    same_frames(js.KolmogorovSmirnovTest.test(jf, "x", *args),
                ts.KolmogorovSmirnovTest.test(tf, "x", *args), policy,
                exact=("pValue", "statistic"))


def test_kolmogorov_smirnov_checks(policy):
    jf, tf = frames({"x": [1.0, 2.0]})
    raises_both(ValueError, "unknown distribution",
                lambda: js.KolmogorovSmirnovTest.test(jf, "x", "nope"),
                lambda: ts.KolmogorovSmirnovTest.test(tf, "x", "nope"))
    jf, tf = frames({"x": [1.0, 2.0]}, [False, False])
    raises_both(ValueError, "no valid rows",
                lambda: js.KolmogorovSmirnovTest.test(jf, "x"),
                lambda: ts.KolmogorovSmirnovTest.test(tf, "x"))
