"""The port's feature layer (``sparkdq4ml_tpu_torch/models/feature.py``)
held against the JAX package on the CPU in both float policies, on the
cases of ``tests/test_feature_transformers.py`` (Interaction,
SQLTransformer, VectorIndexer, ChiSqSelector, RFormula, VectorSizeHint,
the plural OneHotEncoder), ``tests/test_scalers.py`` (StandardScaler,
MinMaxScaler, MaxAbsScaler) and ``tests/test_categorical.py``
(StringIndexer, IndexToString, OneHotEncoder, Bucketizer): each case runs
the same seeded columns through the stage of each package and compares
the outputs and the fitted state, and each stage is saved by one package
and loaded by the other.

Tolerances: labels, indices, one-hot columns, bucket indices, category
maps, selected features, masks and row counts exact; floats within rtol
1e-12 (atol 1e-12) under the float64 policy, where the port's fixed-order
sums and XLA's reductions round apart in the last bits, and within rtol
2e-6 (atol 1e-6) under float32. The float64 cases run at one intra-op
thread (``tests/torch_repro.py``).
"""

import numpy as np
import pytest
from torch_feature_parity import (both, fit_both, frames, policies,
                                  policy_fixture, raises_both, round_trip,
                                  same_frames, same_state, same_values,
                                  transform_both)

from sparkdq4ml_tpu.models import base as jbase
from sparkdq4ml_tpu_torch.models import base as tbase

POLICIES = policies(1e-12, 1e-12, 2e-6, 1e-6)
policy = policy_fixture(POLICIES)


def xframe_cols(n=40, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(loc=5.0, scale=3.0, size=(n, 3))
    return {"features": X, "a": X[:, 0]}


def cats_cols():
    return {"city": ["oslo", "paris", "oslo", "rome", "paris", "oslo"],
            "y": [1.0, 2.0, 1.5, 3.0, 2.5, 0.5]}


# ---------------------------------------------------------------------------
# tests/test_feature_transformers.py
# ---------------------------------------------------------------------------

class TestInteraction:
    def test_scalar_product(self, policy):
        jf, tf = frames({"a": [2.0, 3.0], "b": [5.0, 7.0]})
        transform_both(*both("Interaction", ["a", "b"], "ab"), jf, tf,
                       policy)

    def test_vector_scalar_kron(self, policy):
        jf, tf = frames({"v": np.asarray([[1.0, 2.0], [3.0, 4.0]]),
                         "s": [10.0, 100.0]})
        transform_both(*both("Interaction", ["v", "s"], "vs"), jf, tf,
                       policy)

    def test_three_way(self, policy):
        jf, tf = frames({"a": [2.0], "v": np.asarray([[1.0, 3.0]]),
                         "b": [5.0]})
        transform_both(*both("Interaction", ["a", "v", "b"], "i"), jf, tf,
                       policy)

    def test_needs_two_columns(self, policy):
        jf, tf = frames({"a": [1.0]})
        js, ts = both("Interaction", ["a"])
        raises_both(ValueError, "two", lambda: js.transform(jf),
                    lambda: ts.transform(tf))

    def test_persistence(self, policy, tmp_path):
        js, ts = both("Interaction", ["a", "b"], "ab")
        back = round_trip(ts, tmp_path / "i")
        assert back.input_cols == ["a", "b"] and back.output_col == "ab"


class TestSQLTransformer:
    def test_select_expression(self, policy):
        jf, tf = frames({"v1": [1.0, 2.0], "v2": [3.0, 4.0]})
        transform_both(*both("SQLTransformer",
                             "SELECT *, v1 + v2 AS v3 FROM __THIS__"),
                       jf, tf, policy)

    def test_where_filters(self, policy):
        jf, tf = frames({"v1": [1.0, 5.0, 9.0]})
        js, ts = both("SQLTransformer", "SELECT v1 FROM __THIS__ WHERE v1 > 2")
        assert ts.transform(tf).count() == js.transform(jf).count() == 2

    def test_does_not_pollute_session_catalog(self, policy):
        from sparkdq4ml_tpu_torch.sql.catalog import default_catalog

        before = default_catalog().list_views()
        _, ts = both("SQLTransformer", "SELECT v1 FROM __THIS__")
        ts.transform(frames({"v1": [1.0]})[1])
        assert default_catalog().list_views() == before

    def test_persistence(self, policy, tmp_path):
        js, _ = both("SQLTransformer", "SELECT * FROM __THIS__")
        back = round_trip(js, tmp_path / "sqlt")
        assert back.statement == "SELECT * FROM __THIS__"
        assert back.transform(frames({"x": [1.0, 2.0]})[1]).count() == 2


def vi_cols():
    X = np.asarray([[0.13, 0.0], [1.7, 5.0], [2.9, 10.0], [3.3, 0.0],
                    [4.8, 5.0], [5.1, 10.0], [6.2, 0.0], [7.7, 5.0]])
    return {"features": X}


class TestVectorIndexer:
    def test_detects_and_reindexes_categorical(self, policy):
        jm_, tm_, jf, tf = fit_both("VectorIndexer", vi_cols(),
                                    max_categories=4)
        assert tm_.category_maps == jm_.category_maps == {1: [0.0, 5.0, 10.0]}
        same_state(jm_, tm_, policy, exact=True)
        transform_both(jm_, tm_, jf, tf, policy)

    def test_unseen_category_errors(self, policy):
        jm_, tm_, _, _ = fit_both("VectorIndexer", vi_cols(),
                                  max_categories=4)
        jf2, tf2 = frames({"features": np.asarray([[1.0, 7.0]])})
        raises_both(ValueError, "unseen", lambda: jm_.transform(jf2),
                    lambda: tm_.transform(tf2))

    def test_unseen_category_keep(self, policy):
        jm_, tm_, _, _ = fit_both("VectorIndexer", vi_cols(),
                                  max_categories=4, handle_invalid="keep")
        jf2, tf2 = frames({"features": np.asarray([[1.0, 7.0],
                                                   [2.0, np.nan]])})
        transform_both(jm_, tm_, jf2, tf2, policy)

    def test_all_continuous_passthrough(self, policy):
        jm_, tm_, jf, tf = fit_both("VectorIndexer", vi_cols(),
                                    max_categories=2)
        assert tm_.category_maps == {}
        transform_both(jm_, tm_, jf, tf, policy)

    def test_persistence(self, policy, tmp_path):
        jm_, tm_, jf, tf = fit_both("VectorIndexer", vi_cols(),
                                    max_categories=4)
        back = round_trip(tm_, tmp_path / "vi")
        assert back.category_maps == jm_.category_maps
        same_frames(back.transform(jf), tm_.transform(tf), policy)


def chi_cols(n=300, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, size=n).astype(float)
    x_dep = ((y + rng.integers(0, 2, size=n)) % 3).astype(float)
    x_noise1 = rng.integers(0, 4, size=n).astype(float)
    x_noise2 = rng.integers(0, 3, size=n).astype(float)
    return {"features": np.stack([x_noise1, x_dep, x_noise2], axis=1),
            "label": y}


class TestChiSqSelector:
    def test_top_features_picks_dependent(self, policy):
        jm_, tm_, jf, tf = fit_both("ChiSqSelector", chi_cols(),
                                    num_top_features=1)
        assert tm_.selected_features == jm_.selected_features == [1]
        transform_both(jm_, tm_, jf, tf, policy, exact=("selected",))

    def test_percentile(self, policy):
        jm_, tm_, _, _ = fit_both("ChiSqSelector", chi_cols(),
                                  selector_type="percentile",
                                  percentile=0.34)
        assert tm_.selected_features == jm_.selected_features

    def test_fpr(self, policy):
        jm_, tm_, _, _ = fit_both("ChiSqSelector", chi_cols(),
                                  selector_type="fpr", fpr=1e-4)
        assert tm_.selected_features == jm_.selected_features == [1]

    def test_selected_indices_sorted(self, policy):
        jm_, tm_, _, _ = fit_both("ChiSqSelector", chi_cols(),
                                  num_top_features=3)
        assert tm_.selected_features == jm_.selected_features == [0, 1, 2]

    def test_persistence(self, policy, tmp_path):
        jm_, tm_, _, _ = fit_both("ChiSqSelector", chi_cols(),
                                  num_top_features=2)
        assert round_trip(tm_, tmp_path / "cs").selected_features == \
            jm_.selected_features


def rf_cols():
    return {"y": [1.0, 2.0, 3.0, 4.0], "a": [0.5, 1.5, 2.5, 3.5],
            "b": [10.0, 20.0, 30.0, 40.0], "c": ["us", "eu", "us", "ap"]}


class TestRFormula:
    @pytest.mark.parametrize("formula", ["y ~ a + b", "y ~ . - c", "y ~ c",
                                         "y ~ a:b", "y ~ c:a + b",
                                         "y ~ . - a - b"])
    def test_formulas(self, policy, formula):
        jm_, tm_, jf, tf = fit_both("RFormula", rf_cols(), formula)
        assert tm_.encoders == jm_.encoders
        assert tm_.label_labels == jm_.label_labels
        transform_both(jm_, tm_, jf, tf, policy)

    def test_string_label_indexed(self, policy):
        jm_, tm_, jf, tf = fit_both(
            "RFormula", {"lab": ["no", "yes", "no"], "x": [1.0, 2.0, 3.0]},
            "lab ~ x")
        assert tm_.label_labels == jm_.label_labels == ["no", "yes"]
        transform_both(jm_, tm_, jf, tf, policy, exact=("label",))

    def test_fitted_on_one_frame_transforms_another(self, policy):
        jm_, tm_, _, _ = fit_both("RFormula", rf_cols(), "y ~ c")
        jf2, tf2 = frames({"y": [9.0], "a": [0.0], "b": [0.0],
                           "c": ["eu"]})
        transform_both(jm_, tm_, jf2, tf2, policy)
        jf3, tf3 = frames({"y": [9.0], "a": [0.0], "b": [0.0],
                           "c": ["xx"]})
        raises_both(ValueError, "unseen", lambda: jm_.transform(jf3),
                    lambda: tm_.transform(tf3))

    def test_feeds_linear_regression(self, policy):
        rng = np.random.default_rng(0)
        a = rng.normal(size=50)
        y = 3.0 * a + 2.0 + 0.01 * rng.normal(size=50)
        jm_, tm_, jf, tf = fit_both("RFormula", {"y": y, "a": a}, "y ~ a")
        from sparkdq4ml_tpu.models import LinearRegression as JLR
        from sparkdq4ml_tpu_torch.models import LinearRegression as TLR

        jc = JLR(max_iter=50).fit(jm_.transform(jf)).coefficients
        tc = TLR(max_iter=50).fit(tm_.transform(tf)).coefficients
        np.testing.assert_allclose(np.asarray(tc, np.float64),
                                   np.asarray(jc, np.float64),
                                   rtol=max(policy.rtol, 1e-9))

    def test_persistence(self, policy, tmp_path):
        jm_, tm_, jf, tf = fit_both("RFormula", rf_cols(), "y ~ a + c")
        back = round_trip(tm_, tmp_path / "rf")
        same_frames(back.transform(jf), tm_.transform(tf), policy)
        back = round_trip(jm_, tmp_path / "rf_j")
        same_frames(jm_.transform(jf), back.transform(tf), policy)

    def test_estimator_persistence(self, policy, tmp_path):
        _, ts = both("RFormula", "y ~ a + b", features_col="feats")
        back = round_trip(ts, tmp_path / "rfe")
        assert back.formula == "y ~ a + b" and back.features_col == "feats"

    def test_parse_matches(self, policy):
        from sparkdq4ml_tpu.models.feature import _parse_r_formula as jp
        from sparkdq4ml_tpu_torch.models.feature import _parse_r_formula as tp

        for f in ("y ~ a + b - c", "y ~ .", "y ~ a:b:c + d", " ~ a"):
            assert tp(f) == jp(f)
        for bad in ("y a", "y ~ a + :b"):
            raises_both(ValueError, "RFormula", lambda: jp(bad),
                        lambda: tp(bad))


class TestVectorSizeHint:
    def test_matching_size_passes_through(self, policy):
        jf, tf = frames({"v": np.asarray([[1.0, 2.0], [3.0, 4.0]])})
        transform_both(*both("VectorSizeHint", input_col="v", size=2), jf,
                       tf, policy, exact=("v",))

    def test_mismatch_errors(self, policy):
        jf, tf = frames({"v": np.asarray([[1.0, 2.0, 3.0]])})
        js, ts = both("VectorSizeHint", input_col="v", size=2)
        raises_both(ValueError, "size 3, expected 2", lambda: js.transform(jf),
                    lambda: ts.transform(tf))

    def test_scalar_column_counts_as_size_one(self, policy):
        jf, tf = frames({"x": [1.0, 2.0]})
        transform_both(*both("VectorSizeHint", input_col="x", size=1), jf,
                       tf, policy)
        js, ts = both("VectorSizeHint", input_col="x", size=4)
        raises_both(ValueError, "size 1, expected 4",
                    lambda: js.transform(jf), lambda: ts.transform(tf))

    def test_optimistic_skips_validation(self, policy):
        jf, tf = frames({"v": np.asarray([[1.0, 2.0, 3.0]])})
        transform_both(*both("VectorSizeHint", input_col="v", size=2,
                             handle_invalid="optimistic"), jf, tf, policy)

    def test_skip_drops_mismatching_rows(self, policy):
        jf, tf = frames({"v": np.asarray([[1.0, 2.0, 3.0],
                                          [4.0, 5.0, 6.0]])})
        for size in (2, 3):
            transform_both(*both("VectorSizeHint", input_col="v", size=size,
                                 handle_invalid="skip"), jf, tf, policy)

    def test_bad_handle_invalid_rejected(self, policy):
        from sparkdq4ml_tpu.models import VectorSizeHint as J
        from sparkdq4ml_tpu_torch.models import VectorSizeHint as T

        raises_both(ValueError, "handle_invalid",
                    lambda: J(input_col="v", size=2, handle_invalid="bogus"),
                    lambda: T(input_col="v", size=2, handle_invalid="bogus"))

    def test_unset_params_error(self, policy):
        jf, tf = frames({"x": [1.0]})
        js, ts = both("VectorSizeHint")
        raises_both(ValueError, "must be set", lambda: js.transform(jf),
                    lambda: ts.transform(tf))

    def test_in_pipeline_before_assembler(self, policy):
        from sparkdq4ml_tpu.models import Pipeline as JP
        from sparkdq4ml_tpu_torch.models import Pipeline as TP

        jf, tf = frames({"a": [1.0, 2.0], "b": [3.0, 4.0]})
        js = [both("VectorSizeHint", input_col="a", size=1),
              both("VectorAssembler", ["a", "b"], "features")]
        jout = JP([s[0] for s in js]).fit(jf).transform(jf)
        tout = TP([s[1] for s in js]).fit(tf).transform(tf)
        same_frames(jout, tout, policy)

    def test_persistence(self, policy, tmp_path):
        js, _ = both("VectorSizeHint", input_col="v", size=3,
                     handle_invalid="optimistic")
        back = round_trip(js, tmp_path / "vsh")
        assert (back.input_col, back.size, back.handle_invalid) == \
            ("v", 3, "optimistic")


class TestOneHotEncoderPlural:
    def test_multi_column_encode(self, policy):
        jm_, tm_, jf, tf = fit_both(
            "OneHotEncoder", {"a": np.asarray([0.0, 1.0, 2.0]),
                              "b": np.asarray([1.0, 0.0, 1.0])},
            input_cols=["a", "b"], output_cols=["av", "bv"])
        assert tm_.categorySizes == jm_.categorySizes == [3, 2]
        same_state(jm_, tm_, policy, exact=True)
        transform_both(jm_, tm_, jf, tf, policy, exact=("av", "bv"))

    def test_save_load_plural(self, policy, tmp_path):
        jm_, tm_, jf, tf = fit_both(
            "OneHotEncoder", {"a": np.asarray([0.0, 1.0]),
                              "b": np.asarray([0.0, 1.0])},
            input_cols=["a", "b"], output_cols=["av", "bv"],
            drop_last=False)
        back = round_trip(jm_, tmp_path / "ohe")
        same_frames(jm_.transform(jf), back.transform(tf), policy)

    def test_both_forms_rejected(self, policy):
        from sparkdq4ml_tpu.models import OneHotEncoder as J
        from sparkdq4ml_tpu_torch.models import OneHotEncoder as T

        raises_both(ValueError, "not both",
                    lambda: J(input_col="a", input_cols=["a"]),
                    lambda: T(input_col="a", input_cols=["a"]))

    def test_mismatched_outputs_rejected(self, policy):
        jf, tf = frames({"a": np.asarray([0.0])})
        js, ts = both("OneHotEncoder", input_cols=["a"], output_cols=[])
        raises_both(ValueError, "match", lambda: js.fit(jf),
                    lambda: ts.fit(tf))

    def test_single_col_back_compat(self, policy):
        jm_, tm_, jf, tf = fit_both(
            "OneHotEncoder", {"k": np.asarray([0.0, 1.0, 2.0, 1.0])},
            input_col="k", output_col="kv")
        same_state(jm_, tm_, policy, exact=True)
        transform_both(jm_, tm_, jf, tf, policy, exact=("kv",))

    def test_output_name_colliding_with_later_input(self, policy):
        jm_, tm_, jf, tf = fit_both(
            "OneHotEncoder", {"a": np.asarray([0.0, 1.0, 2.0]),
                              "b": np.asarray([1.0, 0.0, 1.0])},
            input_cols=["a", "b"], output_cols=["b", "c"])
        transform_both(jm_, tm_, jf, tf, policy, exact=("b", "c"))

    def test_empty_plural_rejected(self, policy):
        jf, tf = frames({"a": np.asarray([0.0])})
        js, ts = both("OneHotEncoder", input_cols=[], output_cols=[])
        raises_both(ValueError, "empty", lambda: js.fit(jf),
                    lambda: ts.fit(tf))

    def test_model_invariant_enforced(self, policy):
        from sparkdq4ml_tpu.models import OneHotEncoderModel as J
        from sparkdq4ml_tpu_torch.models import OneHotEncoderModel as T

        args = dict(category_sizes=[3, 2], input_cols=["a", "b"],
                    output_cols=["av"])
        raises_both(ValueError, "lengths", lambda: J(3, None, None, **args),
                    lambda: T(3, None, None, **args))

    def test_corrupted_save_rejected_on_load(self, policy, tmp_path):
        import json
        import os

        jm_, tm_, _, _ = fit_both(
            "OneHotEncoder", {"a": np.asarray([0.0, 1.0]),
                              "b": np.asarray([0.0, 1.0])},
            input_cols=["a", "b"], output_cols=["av", "bv"])
        path = str(tmp_path / "ohe")
        tm_.save(path)
        meta_path = os.path.join(path, "stage.json")
        meta = json.load(open(meta_path))
        meta["data"]["output_cols"] = meta["data"]["output_cols"][:1]
        json.dump(meta, open(meta_path, "w"))
        raises_both(ValueError, "lengths", lambda: jbase.load_stage(path),
                    lambda: tbase.load_stage(path))


# ---------------------------------------------------------------------------
# tests/test_scalers.py
# ---------------------------------------------------------------------------

class TestStandardScaler:
    @pytest.mark.parametrize("with_mean,with_std", [(False, True),
                                                    (True, True),
                                                    (True, False)])
    def test_matches_reference(self, policy, with_mean, with_std):
        jm_, tm_, jf, tf = fit_both("StandardScaler", xframe_cols(),
                                    with_mean=with_mean, with_std=with_std)
        same_state(jm_, tm_, policy)
        transform_both(jm_, tm_, jf, tf, policy)

    def test_zero_variance_feature_maps_to_zero(self, policy):
        jm_, tm_, jf, tf = fit_both(
            "StandardScaler",
            {"features": np.asarray([[2.0, 1.0], [2.0, 2.0], [2.0, 3.0]])})
        same_state(jm_, tm_, policy)
        out = tm_.transform(tf).to_pydict()["scaled_features"]
        assert np.all(out[:, 0] == 0.0) and np.all(np.isfinite(out))
        transform_both(jm_, tm_, jf, tf, policy)

    def test_mask_excluded_rows_do_not_shift_stats(self, policy):
        jm_, tm_, _, _ = fit_both(
            "StandardScaler", {"features": np.asarray([[1.0], [2.0], [3.0],
                                                       [1e6]])},
            mask=[True, True, True, False], with_mean=True)
        same_state(jm_, tm_, policy)
        np.testing.assert_allclose(tm_.mean, [2.0])
        np.testing.assert_allclose(tm_.std, [1.0])

    def test_scalar_column_input(self, policy):
        jm_, tm_, jf, tf = fit_both("StandardScaler", {"x": [1.0, 2.0, 3.0]},
                                    "x", "xs")
        assert tm_.transform(tf).to_pydict()["xs"].ndim == 1
        transform_both(jm_, tm_, jf, tf, policy)


class TestMinMaxScaler:
    @pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0)])
    def test_matches_reference(self, policy, lo, hi):
        jm_, tm_, jf, tf = fit_both("MinMaxScaler", xframe_cols(),
                                    min=lo, max=hi)
        same_state(jm_, tm_, policy, exact=True)
        transform_both(jm_, tm_, jf, tf, policy)

    def test_constant_feature_maps_to_midrange(self, policy):
        jm_, tm_, jf, tf = fit_both(
            "MinMaxScaler", {"features": np.asarray([[7.0, 0.0],
                                                     [7.0, 1.0]])})
        transform_both(jm_, tm_, jf, tf, policy)
        np.testing.assert_allclose(
            tm_.transform(tf).to_pydict()["scaled_features"][:, 0], 0.5)

    def test_model_exposes_original_range(self, policy):
        jm_, tm_, _, _ = fit_both("MinMaxScaler", xframe_cols(),
                                  mask=np.arange(40) % 4 != 0)
        same_values(jm_.originalMin, tm_.originalMin, policy, exact=True)
        same_values(jm_.originalMax, tm_.originalMax, policy, exact=True)


class TestMaxAbsScaler:
    def test_matches_reference(self, policy):
        jm_, tm_, jf, tf = fit_both("MaxAbsScaler", xframe_cols())
        same_state(jm_, tm_, policy, exact=True)
        transform_both(jm_, tm_, jf, tf, policy)

    def test_zero_feature_stays_zero(self, policy):
        jm_, tm_, jf, tf = fit_both(
            "MaxAbsScaler", {"features": np.asarray([[0.0, 2.0],
                                                     [0.0, -4.0]])})
        transform_both(jm_, tm_, jf, tf, policy)


class TestScalerPipeline:
    def test_assembler_scaler_regression_pipeline(self, policy):
        from sparkdq4ml_tpu.models import LinearRegression as JLR
        from sparkdq4ml_tpu.models import Pipeline as JP
        from sparkdq4ml_tpu_torch.models import LinearRegression as TLR
        from sparkdq4ml_tpu_torch.models import Pipeline as TP

        rng = np.random.default_rng(2)
        guest = rng.integers(1, 40, 60).astype(np.float64)
        price = 5.0 * guest + 20.0 + rng.normal(0, 3, 60)
        jf, tf = frames({"guest": guest, "label": price})
        va = both("VectorAssembler", ["guest"], "features")
        sc = both("StandardScaler", "features", "scaled", with_mean=True)
        jp = JP([va[0], sc[0], JLR(max_iter=50).set_features_col("scaled")])
        tp = TP([va[1], sc[1], TLR(max_iter=50).set_features_col("scaled")])
        same_frames(jp.fit(jf).transform(jf), tp.fit(tf).transform(tf),
                    policy)


# ---------------------------------------------------------------------------
# tests/test_categorical.py
# ---------------------------------------------------------------------------

class TestStringIndexer:
    def test_frequency_desc_order(self, policy):
        jm_, tm_, jf, tf = fit_both("StringIndexer", cats_cols(), "city",
                                    "city_idx")
        assert tm_.labels == jm_.labels == ["oslo", "paris", "rome"]
        transform_both(jm_, tm_, jf, tf, policy, exact=("city_idx",))

    def test_ties_break_alphabetically(self, policy):
        jm_, tm_, _, _ = fit_both("StringIndexer", {"c": ["b", "a", "b", "a"]},
                                  "c", "i")
        assert tm_.labels == jm_.labels == ["a", "b"]

    def test_masked_rows_and_nulls_do_not_count(self, policy):
        cols = cats_cols()
        cols["city"] = np.asarray(cols["city"][:-1] + [None], object)
        jm_, tm_, _, _ = fit_both("StringIndexer", cols, "city", "i",
                                  mask=[True, True, True, False, True, True])
        assert tm_.labels == jm_.labels == ["oslo", "paris"]

    def test_numeric_column(self, policy):
        jm_, tm_, jf, tf = fit_both(
            "StringIndexer", {"g": np.asarray([3.5, 1.0, 3.5, 2.0, 1.0, 3.5,
                                               0.1])}, "g", "gi")
        assert tm_.labels == jm_.labels
        transform_both(jm_, tm_, jf, tf, policy, exact=("gi",))

    def test_unseen_label_error(self, policy):
        jm_, tm_, _, _ = fit_both("StringIndexer", cats_cols(), "city", "i")
        jf2, tf2 = frames({"city": ["kyiv"], "y": [1.0]})
        raises_both(ValueError, "unseen labels", lambda: jm_.transform(jf2),
                    lambda: tm_.transform(tf2))

    def test_unseen_label_keep_and_skip(self, policy):
        jm_, tm_, _, _ = fit_both("StringIndexer", cats_cols(), "city", "i",
                                  handle_invalid="keep")
        jf2, tf2 = frames({"city": ["kyiv", "oslo"], "y": [1.0, 2.0]})
        transform_both(jm_, tm_, jf2, tf2, policy, exact=("i",))
        jm_.handle_invalid = tm_.handle_invalid = "skip"
        transform_both(jm_, tm_, jf2, tf2, policy, exact=("i",))

    def test_round_trip_index_to_string(self, policy):
        jm_, tm_, jf, tf = fit_both("StringIndexer", cats_cols(), "city", "i")
        ji, ti = both("IndexToString", "i", "city2", labels=tm_.labels)
        same_frames(ji.transform(jm_.transform(jf)),
                    ti.transform(tm_.transform(tf)), policy)
        jf2, tf2 = frames({"i": [0.0, 2.0, 3.0, -1.0, 1.7]})
        transform_both(ji, ti, jf2, tf2, policy)


class TestOneHotEncoder:
    @pytest.mark.parametrize("drop_last", [True, False])
    def test_encodes_indices(self, policy, drop_last):
        jm_, tm_, jf, tf = fit_both("StringIndexer", cats_cols(), "city", "i")
        ji, ti = jm_.transform(jf), tm_.transform(tf)
        je, te = both("OneHotEncoder", "i", "vec", drop_last=drop_last)
        jo, to = je.fit(ji), te.fit(ti)
        same_state(jo, to, policy, exact=True)
        same_frames(jo.transform(ji), to.transform(ti), policy,
                    exact=("vec",))

    def test_categorical_regression_pipeline(self, policy):
        from sparkdq4ml_tpu.models import LinearRegression as JLR
        from sparkdq4ml_tpu.models import Pipeline as JP
        from sparkdq4ml_tpu_torch.models import LinearRegression as TLR
        from sparkdq4ml_tpu_torch.models import Pipeline as TP

        jf, tf = frames(cats_cols())
        stages = [both("StringIndexer", "city", "ci"),
                  both("OneHotEncoder", "ci", "cv", drop_last=False),
                  both("VectorAssembler", ["cv"], "features")]
        jp = JP([s[0] for s in stages]
                + [JLR(max_iter=100).set_label_col("y")])
        tp = TP([s[1] for s in stages]
                + [TLR(max_iter=100).set_label_col("y")])
        jout, tout = jp.fit(jf).transform(jf), tp.fit(tf).transform(tf)
        same_values(jout.to_pydict()["prediction"],
                    tout.to_pydict()["prediction"], policy)


class TestBucketizer:
    def test_basic_buckets(self, policy):
        jf, tf = frames({"x": [-0.5, 0.2, 1.0, 1.5, 2.0]})
        transform_both(*both("Bucketizer", splits=[-1.0, 0.0, 1.0, 2.0],
                             input_col="x", output_col="b"), jf, tf, policy,
                       exact=("b",))

    def test_out_of_range_error_keep_skip(self, policy):
        jf, tf = frames({"x": [0.5, 9.0, float("nan"), -3.0]})
        js, ts = both("Bucketizer", splits=[0.0, 1.0, 2.0], input_col="x",
                      output_col="b")
        raises_both(ValueError, "outside splits", lambda: js.transform(jf),
                    lambda: ts.transform(tf))
        for mode in ("keep", "skip"):
            js.handle_invalid = ts.handle_invalid = mode
            transform_both(js, ts, jf, tf, policy, exact=("b",))

    def test_infinite_ends(self, policy):
        jf, tf = frames({"x": [-100.0, 0.5, 100.0, 0.0, 1.0]})
        transform_both(*both("Bucketizer",
                             splits=[-np.inf, 0.0, 1.0, np.inf],
                             input_col="x", output_col="b"), jf, tf, policy,
                       exact=("b",))

    def test_bad_splits_raise(self, policy):
        jf, tf = frames({"x": [1.0]})
        js, ts = both("Bucketizer", splits=[0.0, 0.0, 1.0], input_col="x",
                      output_col="b")
        raises_both(ValueError, "strictly increasing",
                    lambda: js.transform(jf), lambda: ts.transform(tf))
