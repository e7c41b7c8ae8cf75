"""The rest of the port's feature layer held against the JAX package on the
CPU in both float policies: the cases of ``tests/test_feature_extra.py``
(Imputer, Normalizer, Binarizer, PolynomialExpansion,
QuantileDiscretizer), ``tests/test_robust_vts.py`` (RobustScaler,
VarianceThresholdSelector) and the PCA half of
``tests/test_pca_naivebayes.py``, then the stages no JAX test file covers
alone (ElementwiseProduct, VectorSlicer, DCT, FeatureHasher,
UnivariateFeatureSelector, ``linalg.Matrices``), a save in one package and
a load in the other for every stage of the feature layer, and the numpy
order statistics the port computes on the device (``_order_quantiles``)
bit for bit against ``np.quantile`` and ``np.nanquantile``.

Tolerances: surrogates of median and mode, quantile splits, robust
centers and scales, bucket indices, selections and hashes exact (order
statistics of the same values, numpy's interpolation); the other floats
within rtol 1e-12 (atol 1e-12) under float64 (the Imputer's mean is a
fixed-order sum against numpy's pairwise one) and rtol 2e-6 (atol 1e-6)
under float32; PCA components within 1e-9 (float64) or 2e-4 (float32)
where the eigen-gap to their neighbours is over 1e-3 relative, and the
explained-variance ratios within the same tolerance. The float64 cases
run at one intra-op thread (``tests/torch_repro.py``).
"""

import numpy as np
import pytest
import torch
from torch_feature_parity import (both, fit_both, frames, policies,
                                  policy_fixture, raises_both, round_trip,
                                  same_frames, same_state, same_values,
                                  transform_both)

from sparkdq4ml_tpu_torch.models import feature as tfeat

POLICIES = policies(1e-12, 1e-12, 2e-6, 1e-6)
policy = policy_fixture(POLICIES)
nan = float("nan")


# ---------------------------------------------------------------------------
# tests/test_feature_extra.py
# ---------------------------------------------------------------------------

class TestImputer:
    def test_mean_imputation(self, policy):
        jm_, tm_, jf, tf = fit_both("Imputer", {"a": [1.0, nan, 3.0],
                                                "b": [10.0, 20.0, nan]},
                                    ["a", "b"])
        same_state(jm_, tm_, policy)
        transform_both(jm_, tm_, jf, tf, policy)

    @pytest.mark.parametrize("strategy", ["mean", "median", "mode"])
    def test_strategies_on_seeded_column(self, policy, strategy):
        rng = np.random.default_rng(4)
        a = np.round(rng.normal(50.0, 10.0, 301), 1)
        a[rng.random(301) < 0.15] = nan
        jm_, tm_, jf, tf = fit_both("Imputer", {"a": a}, ["a"],
                                    strategy=strategy,
                                    mask=rng.random(301) < 0.9)
        same_state(jm_, tm_, policy, exact=strategy != "mean")
        transform_both(jm_, tm_, jf, tf, policy)

    def test_median_and_mode(self, policy):
        jm_, tm_, _, _ = fit_both("Imputer", {"a": [1.0, 2.0, 100.0, nan]},
                                  ["a"], strategy="median")
        assert tm_.surrogates == jm_.surrogates == [2.0]
        jm_, tm_, _, _ = fit_both("Imputer", {"a": [5.0, 5.0, 7.0, 7.0, 3.0]},
                                  ["a"], strategy="mode")
        assert tm_.surrogates == jm_.surrogates == [5.0]

    def test_sentinel_missing_value(self, policy):
        jm_, tm_, jf, tf = fit_both("Imputer", {"a": [1.0, -1.0, 3.0]},
                                    ["a"], missing_value=-1.0)
        same_state(jm_, tm_, policy)
        transform_both(jm_, tm_, jf, tf, policy)

    def test_sentinel_still_imputes_nan(self, policy):
        jm_, tm_, jf, tf = fit_both("Imputer", {"a": [1.0, -1.0, nan, 3.0]},
                                    ["a"], missing_value=-1.0)
        transform_both(jm_, tm_, jf, tf, policy)

    def test_output_cols_and_masked_rows(self, policy):
        jm_, tm_, jf, tf = fit_both("Imputer", {"a": [1.0, nan, 99.0]},
                                    ["a"], ["a_imp"],
                                    mask=[True, True, False])
        assert tm_.surrogates == jm_.surrogates == [1.0]
        transform_both(jm_, tm_, jf, tf, policy)

    def test_surrogate_df(self, policy):
        jm_, tm_, _, _ = fit_both("Imputer", {"a": [2.0, 4.0]}, ["a"])
        same_frames(jm_.surrogate_df, tm_.surrogate_df, policy)

    def test_all_missing_raises(self, policy):
        jf, tf = frames({"a": [nan, nan]})
        js, ts = both("Imputer", ["a"])
        raises_both(ValueError, "no valid", lambda: js.fit(jf),
                    lambda: ts.fit(tf))


def vec_cols(X):
    return {"v": np.asarray(X, np.float64)}


class TestNormalizer:
    @pytest.mark.parametrize("p", [2.0, 1.0, float("inf"), 3.0])
    def test_rows(self, policy, p):
        rng = np.random.default_rng(1)
        X = rng.normal(size=(20, 3))
        X[3] = 0.0
        jf, tf = frames(vec_cols(X))
        transform_both(*both("Normalizer", "v", "nv", p=p), jf, tf, policy)

    def test_scalar_and_bad_p(self, policy):
        jf, tf = frames({"x": [3.0, 0.0, -2.0]})
        transform_both(*both("Normalizer", "x", "nx"), jf, tf, policy)
        from sparkdq4ml_tpu.models import Normalizer as J
        from sparkdq4ml_tpu_torch.models import Normalizer as T

        raises_both(ValueError, "p must be", lambda: J(p=0.5),
                    lambda: T(p=0.5))


class TestBinarizer:
    def test_threshold(self, policy):
        jf, tf = frames({"x": [0.1, 0.5, 0.9, nan]})
        transform_both(*both("Binarizer", 0.5, "x", "b"), jf, tf, policy,
                       exact=("b",))

    def test_vector_column(self, policy):
        jf, tf = frames(vec_cols([[0.1, 2.0], [-1.0, 0.0]]))
        transform_both(*both("Binarizer", 0.0, "v", "b"), jf, tf, policy,
                       exact=("b",))


class TestPolynomialExpansion:
    @pytest.mark.parametrize("degree,d", [(2, 2), (3, 2), (2, 4), (3, 1)])
    def test_expansion(self, policy, degree, d):
        rng = np.random.default_rng(degree * 10 + d)
        jf, tf = frames(vec_cols(rng.normal(size=(15, d))))
        transform_both(*both("PolynomialExpansion", degree, "v", "p"), jf,
                       tf, policy)

    def test_scalar_column(self, policy):
        jf, tf = frames({"x": [2.0, -1.5]})
        transform_both(*both("PolynomialExpansion", 3, "x", "p"), jf, tf,
                       policy)


class TestQuantileDiscretizer:
    @pytest.mark.parametrize("buckets", [2, 4, 10])
    def test_buckets(self, policy, buckets):
        jm_, tm_, jf, tf = fit_both("QuantileDiscretizer",
                                    {"x": [float(i) for i in range(100)]},
                                    buckets, "x", "q")
        assert tm_.splits == jm_.splits
        transform_both(jm_, tm_, jf, tf, policy, exact=("q",))

    def test_seeded_splits_exact(self, policy):
        rng = np.random.default_rng(9)
        x = rng.normal(100.0, 15.0, 997)
        x[rng.random(997) < 0.1] = nan
        jm_, tm_, jf, tf = fit_both("QuantileDiscretizer", {"x": x}, 10,
                                    "x", "q", handle_invalid="keep",
                                    mask=rng.random(997) < 0.8)
        assert tm_.splits == jm_.splits
        transform_both(jm_, tm_, jf, tf, policy, exact=("q",))

    def test_open_ends_cover_unseen_values(self, policy):
        jm_, tm_, _, _ = fit_both("QuantileDiscretizer",
                                  {"x": [1.0, 2.0, 3.0, 4.0]}, 2, "x", "q")
        jf, tf = frames({"x": [-1000.0, 1000.0]})
        transform_both(jm_, tm_, jf, tf, policy, exact=("q",))

    def test_duplicate_quantiles_collapse(self, policy):
        jm_, tm_, _, _ = fit_both("QuantileDiscretizer",
                                  {"x": [1.0] * 50 + [2.0]}, 4, "x", "q")
        assert tm_.splits == jm_.splits and len(tm_.splits) < 6

    def test_fit_ignores_masked_rows(self, policy):
        jm_, tm_, _, _ = fit_both("QuantileDiscretizer",
                                  {"x": [1.0, 2.0, 3.0, 1000.0]}, 2, "x", "q",
                                  mask=[True, True, True, False])
        assert tm_.splits == jm_.splits and tm_.splits[1] == 2.0

    def test_no_valid_rows(self, policy):
        jf, tf = frames({"x": [nan, nan]})
        js, ts = both("QuantileDiscretizer", 2, "x", "q")
        raises_both(ValueError, "no valid", lambda: js.fit(jf),
                    lambda: ts.fit(tf))


class TestPersistenceExtra:
    def test_imputer_model_roundtrip(self, policy, tmp_path):
        jm_, tm_, jf, tf = fit_both("Imputer", {"a": [1.0, nan, 3.0]}, ["a"])
        back = round_trip(tm_, tmp_path / "imp")
        same_frames(back.transform(jf), tm_.transform(tf), policy)

    def test_normalizer_roundtrip(self, policy, tmp_path):
        _, ts = both("Normalizer", "v", "nv", p=1.0)
        back = round_trip(ts, tmp_path / "norm")
        assert back.p == 1.0 and back.input_col == "v"


# ---------------------------------------------------------------------------
# tests/test_robust_vts.py
# ---------------------------------------------------------------------------

def feat(X, mask=None):
    return {"features": np.asarray(X, np.float64)}


class TestRobustScaler:
    @pytest.mark.parametrize("centering,lower,upper", [
        (True, 0.25, 0.75), (False, 0.25, 0.75), (True, 0.1, 0.9),
        (True, 0.0, 1.0)])
    def test_matches_reference(self, policy, centering, lower, upper):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(120, 3)) * np.asarray([1.0, 5.0, 0.1])
        jm_, tm_, jf, tf = fit_both("RobustScaler", feat(X),
                                    with_centering=centering, lower=lower,
                                    upper=upper)
        same_state(jm_, tm_, policy, exact=True)
        transform_both(jm_, tm_, jf, tf, policy)

    def test_large_column_takes_numpy_path(self, policy):
        # past 600 rows np.nanmedian leaves its masked-array path
        rng = np.random.default_rng(7)
        X = rng.normal(size=(1001, 2))
        X[rng.random(1001) < 0.05, 0] = nan
        jm_, tm_, _, _ = fit_both("RobustScaler", feat(X),
                                  with_centering=True)
        same_state(jm_, tm_, policy, exact=True)

    def test_masked_rows_excluded(self, policy):
        X = np.repeat(np.arange(20, dtype=np.float64)[:, None], 2, axis=1)
        X[10:] = 1e9
        jm_, tm_, _, _ = fit_both("RobustScaler", feat(X),
                                  with_centering=True,
                                  mask=np.arange(20) < 10)
        same_state(jm_, tm_, policy, exact=True)

    def test_constant_feature_maps_to_zero(self, policy):
        jm_, tm_, jf, tf = fit_both("RobustScaler",
                                    feat(np.ones((30, 2)) * 100.0))
        same_state(jm_, tm_, policy, exact=True)
        transform_both(jm_, tm_, jf, tf, policy)

    def test_nan_values_and_all_nan_column(self, policy):
        rng = np.random.default_rng(6)
        X = rng.normal(size=(80, 3))
        X[5, 0] = nan
        X[:, 2] = nan
        jm_, tm_, jf, tf = fit_both("RobustScaler", feat(X),
                                    with_centering=True)
        same_state(jm_, tm_, policy, exact=True)

    def test_invalid_bounds_rejected(self, policy):
        from sparkdq4ml_tpu.models import RobustScaler as J
        from sparkdq4ml_tpu_torch.models import RobustScaler as T

        raises_both(ValueError, "lower < upper",
                    lambda: J(lower=0.8, upper=0.2),
                    lambda: T(lower=0.8, upper=0.2))
        raises_both(ValueError, "lower < upper", lambda: J().setLower(0.9),
                    lambda: T().setLower(0.9))

    def test_roundtrip(self, policy, tmp_path):
        rng = np.random.default_rng(2)
        jm_, tm_, jf, tf = fit_both("RobustScaler",
                                    feat(rng.normal(size=(40, 2))),
                                    with_centering=True)
        back = round_trip(jm_, tmp_path / "rs")
        same_frames(jm_.transform(jf), back.transform(tf), policy)


class TestVarianceThresholdSelector:
    def test_matches_reference(self, policy):
        rng = np.random.default_rng(3)
        X = rng.normal(size=(100, 4))
        X[:, 1] *= 0.01
        X[:, 3] = 7.0
        jm_, tm_, jf, tf = fit_both("VarianceThresholdSelector", feat(X),
                                    variance_threshold=0.05)
        assert tm_.selected_features == jm_.selected_features == [0, 2]
        transform_both(jm_, tm_, jf, tf, policy,
                       exact=("selected_features",))

    def test_all_filtered_empty_selection(self, policy):
        jm_, tm_, jf, tf = fit_both("VarianceThresholdSelector",
                                    feat(np.ones((30, 2))),
                                    variance_threshold=1.0)
        assert tm_.selected_features == [] == jm_.selected_features
        assert tm_.transform(tf).to_pydict()["selected_features"].shape == \
            (30, 0)

    def test_roundtrip(self, policy, tmp_path):
        rng = np.random.default_rng(4)
        jm_, tm_, _, _ = fit_both("VarianceThresholdSelector",
                                  feat(rng.normal(size=(50, 3))))
        assert round_trip(tm_, tmp_path / "vts").selected_features == \
            jm_.selected_features


# ---------------------------------------------------------------------------
# PCA (tests/test_pca_naivebayes.py)
# ---------------------------------------------------------------------------

def correlated(n=200, seed=3):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=n)
    X = np.stack([t + 0.1 * rng.normal(size=n), 2 * t + 0.1 *
                  rng.normal(size=n), rng.normal(size=n) * 0.5], axis=1)
    return feat(X.astype(np.float32))


def eigen_gaps(values: np.ndarray) -> np.ndarray:
    """Each eigenvalue's smallest gap to a neighbour, relative to the
    largest eigenvalue."""
    v = np.sort(np.asarray(values, np.float64))[::-1]
    gaps = np.abs(np.diff(v)) / max(abs(v[0]), 1e-300)
    return np.minimum(np.r_[np.inf, gaps], np.r_[gaps, np.inf])


PCA_TOL = {"float64": 1e-9, "float32": 2e-4}


def same_pca(jm_, tm_, X, pol, mask=None):
    keep = np.ones(len(X), bool) if mask is None else np.asarray(mask)
    cov = np.cov(X[keep].astype(np.float64), rowvar=False)
    gaps = eigen_gaps(np.linalg.eigvalsh(cov))[: jm_.k]
    print(f"PCA eigen-gaps (relative): {gaps}")
    tol = PCA_TOL[pol.name]
    held = gaps > 1e-3
    np.testing.assert_allclose(tm_.pc[:, held], jm_.pc[:, held], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(tm_.explained_variance,
                               jm_.explained_variance, rtol=tol, atol=tol)
    return held


class TestPCA:
    @pytest.mark.parametrize("k", [1, 2, 3])
    def test_matches_reference(self, policy, k):
        cols = correlated()
        jm_, tm_, jf, tf = fit_both("PCA", cols, k=k)
        held = same_pca(jm_, tm_, cols["features"], policy)
        if held.all():
            same_values(jm_.transform(jf).to_pydict()["pca_features"],
                        tm_.transform(tf).to_pydict()["pca_features"],
                        type(policy)(rtol=PCA_TOL[policy.name],
                                     atol=PCA_TOL[policy.name]))

    def test_seeded_five_features(self, policy):
        rng = np.random.default_rng(8)
        A = rng.normal(size=(5, 5))
        X = rng.normal(size=(500, 5)) @ A
        mask = rng.random(500) < 0.9
        jm_, tm_, _, _ = fit_both("PCA", feat(X), k=4, mask=mask)
        assert same_pca(jm_, tm_, X, policy, mask).all()

    def test_masked_rows_excluded_from_fit(self, policy):
        X = np.asarray([[0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [1e6, -1e6]])
        jm_, tm_, _, _ = fit_both("PCA", feat(X), k=1,
                                  mask=[True, True, True, False])
        same_pca(jm_, tm_, X, policy, [True, True, True, False])

    def test_k_validation(self, policy):
        jf, tf = frames(correlated(n=10))
        for k in (7, None):
            js, ts = both("PCA", k=k)
            raises_both(ValueError, "k", lambda: js.fit(jf),
                        lambda: ts.fit(tf))

    def test_no_valid_rows_raises(self, policy):
        jf, tf = frames(correlated(n=10), mask=np.zeros(10, bool))
        js, ts = both("PCA", k=1)
        raises_both(ValueError, "no valid", lambda: js.fit(jf),
                    lambda: ts.fit(tf))

    def test_roundtrip(self, policy, tmp_path):
        jm_, tm_, jf, tf = fit_both("PCA", correlated(n=40), k=2)
        back = round_trip(jm_, tmp_path / "pca")
        same_frames(jm_.transform(jf), back.transform(tf), policy)


# ---------------------------------------------------------------------------
# The vector stages no JAX test file covers alone
# ---------------------------------------------------------------------------

class TestVectorStages:
    def test_elementwise_product(self, policy):
        rng = np.random.default_rng(1)
        jf, tf = frames(feat(rng.normal(size=(12, 3))))
        transform_both(*both("ElementwiseProduct", [2.0, -0.5, 0.1]), jf, tf,
                       policy)
        js, ts = both("ElementwiseProduct", [1.0, 2.0])
        raises_both(ValueError, "scaling_vec length",
                    lambda: js.transform(jf), lambda: ts.transform(tf))
        js, ts = both("ElementwiseProduct")
        raises_both(ValueError, "not set", lambda: js.transform(jf),
                    lambda: ts.transform(tf))

    def test_vector_slicer(self, policy):
        rng = np.random.default_rng(2)
        jf, tf = frames(feat(rng.normal(size=(12, 4))))
        transform_both(*both("VectorSlicer", [3, 0, 3]), jf, tf, policy,
                       exact=("sliced_features",))
        for idx, msg in (([4], "out of range"), ([], "not set")):
            js, ts = both("VectorSlicer", idx)
            raises_both(ValueError, msg, lambda: js.transform(jf),
                        lambda: ts.transform(tf))

    @pytest.mark.parametrize("inverse", [False, True])
    @pytest.mark.parametrize("d", [1, 4, 7])
    def test_dct(self, policy, inverse, d):
        rng = np.random.default_rng(d)
        X = rng.normal(size=(9, d))
        jf, tf = frames(feat(X) if d > 1 else {"features": X[:, 0]})
        transform_both(*both("DCT", inverse), jf, tf, policy)

    @pytest.mark.parametrize("num_features", [16, 1024])
    def test_feature_hasher(self, policy, num_features):
        from sparkdq4ml_tpu.models.text import _stable_hash as jh
        from sparkdq4ml_tpu_torch.models.text import _stable_hash as th

        rng = np.random.default_rng(5)
        words = np.asarray(rng.choice(["a", "b", "zz", "éclair"], 30),
                           object)
        words[rng.random(30) < 0.2] = None
        x = rng.normal(size=30)
        x[3] = nan
        x[4] = np.inf
        cols = {"w": words, "x": x, "k": rng.integers(0, 3, 30)}
        jf, tf = frames(cols)
        transform_both(*both("FeatureHasher", num_features,
                             ["w", "x", "k", "w"]), jf, tf, policy)
        assert [th(s, 97) for s in ("a", "w=b", "")] == \
            [jh(s, 97) for s in ("a", "w=b", "")]

    def test_matrices_dense_column_major(self, policy):
        from sparkdq4ml_tpu.models import Matrices as J
        from sparkdq4ml_tpu_torch.models import Matrices as T

        same_values(J.dense(2, 3, range(6)), T.dense(2, 3, range(6)), policy,
                    exact=True)
        raises_both(ValueError, "values for a", lambda: J.dense(2, 2, [1.0]),
                    lambda: T.dense(2, 2, [1.0]))


def selector_cols(n=400, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n).astype(np.float64)
    X = rng.normal(size=(n, 5))
    X[:, 1] += y
    X[:, 3] += 0.2 * y
    cat = np.stack([(y + rng.integers(0, 2, n)) % 4,
                    rng.integers(0, 3, n)], axis=1).astype(np.float64)
    return {"features": X, "cats": cat, "label": y,
            "target": X[:, 0] * 2.0 + X[:, 2] + rng.normal(size=n)}


class TestUnivariateFeatureSelector:
    @pytest.mark.parametrize("mode,thr", [
        ("numTopFeatures", 2), ("percentile", 0.4), ("fpr", 0.05),
        ("fdr", 0.05), ("fwe", 0.05), ("numTopFeatures", None)])
    @pytest.mark.parametrize("label_type", ["categorical", "continuous"])
    def test_continuous_features(self, policy, mode, thr, label_type):
        label = "label" if label_type == "categorical" else "target"
        jm_, tm_, jf, tf = fit_both(
            "UnivariateFeatureSelector", selector_cols(), "continuous",
            label_type, mode, thr, label_col=label,
            mask=np.arange(400) % 7 != 0)
        assert tm_.selected_features == jm_.selected_features
        transform_both(jm_, tm_, jf, tf, policy,
                       exact=("selected_features",))

    def test_p_values_match(self, policy):
        cols = selector_cols()
        X, y = cols["features"], cols["label"]
        for label_type, lab in (("categorical", y),
                                ("continuous", cols["target"])):
            js, ts = both("UnivariateFeatureSelector",
                          label_type=label_type)
            want = js._p_values(X, lab)
            got = ts._p_values(torch.as_tensor(X), torch.as_tensor(lab))
            np.testing.assert_allclose(-np.log(got), -np.log(want),
                                       rtol=1e-9)

    def test_categorical_features_chi2(self, policy):
        jm_, tm_, _, _ = fit_both(
            "UnivariateFeatureSelector", selector_cols(), "categorical",
            "categorical", "numTopFeatures", 1, features_col="cats")
        assert tm_.selected_features == jm_.selected_features == [0]

    def test_checks(self, policy):
        jf, tf = frames(selector_cols())
        js, ts = both("UnivariateFeatureSelector", "categorical",
                      "continuous")
        raises_both(ValueError, "categorical label", lambda: js.fit(jf),
                    lambda: ts.fit(tf))
        jf, tf = frames(selector_cols(), mask=np.zeros(400, bool))
        js, ts = both("UnivariateFeatureSelector")
        raises_both(ValueError, "no valid rows", lambda: js.fit(jf),
                    lambda: ts.fit(tf))
        from sparkdq4ml_tpu.models import UnivariateFeatureSelector as J
        from sparkdq4ml_tpu_torch.models import UnivariateFeatureSelector as T

        raises_both(ValueError, "selection_mode",
                    lambda: J(selection_mode="best"),
                    lambda: T(selection_mode="best"))


# ---------------------------------------------------------------------------
# Persistence of every stage, both ways
# ---------------------------------------------------------------------------

STAGES = [
    ("VectorSizeHint", dict(input_col="v", size=2)),
    ("StringIndexer", dict(input_col="c", output_col="ci")),
    ("IndexToString", dict(input_col="ci", output_col="c2",
                           labels=["x", "y"])),
    ("OneHotEncoder", dict(input_col="ci", output_col="cv")),
    ("Bucketizer", dict(splits=[-np.inf, 0.0, np.inf], input_col="a",
                        output_col="ab")),
    ("StandardScaler", dict(input_col="v", with_mean=True)),
    ("MinMaxScaler", dict(input_col="v", min=-2.0, max=3.0)),
    ("MaxAbsScaler", dict(input_col="v")),
    ("Imputer", dict(input_cols=["a"], strategy="median")),
    ("Normalizer", dict(input_col="v", p=3.0)),
    ("Binarizer", dict(threshold=0.2, input_col="a", output_col="ab")),
    ("PolynomialExpansion", dict(degree=3, input_col="v")),
    ("QuantileDiscretizer", dict(num_buckets=3, input_col="a",
                                 output_col="aq")),
    ("PCA", dict(k=1, input_col="v")),
    ("Interaction", dict(input_cols=["a", "v"])),
    ("SQLTransformer", dict(statement="SELECT a FROM __THIS__")),
    ("VectorIndexer", dict(max_categories=3, input_col="v")),
    ("ChiSqSelector", dict(num_top_features=1, features_col="k",
                           label_col="l")),
    ("RFormula", dict(formula="a ~ c + v")),
    ("ElementwiseProduct", dict(scaling_vec=[1.0, 2.0], input_col="v")),
    ("VectorSlicer", dict(indices=[1], input_col="v")),
    ("DCT", dict(inverse=True, input_col="v")),
    ("FeatureHasher", dict(num_features=8, input_cols=["c", "a"])),
    ("RobustScaler", dict(with_centering=True, input_col="v")),
    ("VarianceThresholdSelector", dict(features_col="v")),
    ("UnivariateFeatureSelector", dict(selection_threshold=1,
                                       features_col="v", label_col="l")),
]


def stage_cols():
    rng = np.random.default_rng(12)
    return {"v": np.round(rng.normal(size=(24, 2)), 0),
            "a": rng.normal(size=24),
            "c": list(rng.choice(["p", "q", "r"], 24)),
            "ci": rng.integers(0, 2, 24).astype(np.float64),
            "k": rng.integers(0, 3, (24, 2)).astype(np.float64),
            "l": rng.integers(0, 2, 24).astype(np.float64)}


EXACT_STATE = ("StringIndexer", "OneHotEncoder", "MinMaxScaler",
               "MaxAbsScaler", "Imputer", "QuantileDiscretizer",
               "VectorIndexer", "ChiSqSelector", "RFormula", "RobustScaler",
               "VarianceThresholdSelector", "UnivariateFeatureSelector")


@pytest.mark.parametrize("name,kwargs", STAGES, ids=[s[0] for s in STAGES])
def test_every_stage_round_trips_both_ways(policy, tmp_path, name, kwargs):
    """Each stage, and each fitted model, saved by one package and loaded
    by the other: the same state, and the loaded model transforms as the
    saved one."""
    jf, tf = frames(stage_cols())
    js, ts = both(name, **kwargs)
    for k, stage in enumerate((js, ts)):
        same_state(stage, round_trip(stage, tmp_path / f"stage{k}"), policy,
                   exact=True)
    if hasattr(js, "fit"):
        js, ts = js.fit(jf), ts.fit(tf)
        if name != "PCA":           # components: TestPCA, by eigen-gap
            same_state(js, ts, policy, exact=name in EXACT_STATE)
    same_frames(js.transform(jf),
                round_trip(js, tmp_path / "jax_model").transform(tf), policy)
    same_frames(round_trip(ts, tmp_path / "port_model").transform(jf),
                ts.transform(tf), policy)


# ---------------------------------------------------------------------------
# numpy's order statistics, from the device sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 10, 599, 601, 1000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_order_statistics_are_numpys(n, dtype):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * 1e3).astype(dtype)
    svals = torch.sort(torch.as_tensor(x)).values[:, None]
    qs = np.linspace(0, 1, 11)[1:-1]
    got = tfeat._order_quantiles(svals, [n], qs)[0]
    np.testing.assert_array_equal(got, np.quantile(x, qs))
    for q in (0.0, 0.25, 0.5, 0.75, 0.999, 1.0):
        got = tfeat._order_quantiles(svals, [n],
                                     np.asanyarray(q, dtype))[0]
        want = np.nanquantile(x[:, None], q, axis=0)[0]
        assert got.dtype == want.dtype and got == want, (q, got, want)
    got = tfeat._np_median(svals, [n], np.dtype(dtype))[0]
    assert got == np.nanmedian(x[:, None], axis=0)[0]
