"""The tree family of the torch port (``models/tree.py``) held against the
JAX package on the CPU: ``bin_features``; one level's histogram against
``jax.ops.segment_sum``; ``build_tree``'s heap arrays; the regressors'
predictions and importances (the bootstrap and GBT's subsample drawn in
the reference's order); a tie between split gains; the segment-sum route
when a level's table does not fit the dense kernel's shared memory; the
label checks; persistence and ``tree_model_from_numpy``. The classifiers,
the feature subsets and GBT's validation stop are in
``test_torch_tree_ensembles.py``.

Tolerances: the edges, the binned matrix and every tree's structure
(split features, thresholds, leaves) exact under both float policies;
payloads, gains, predictions and probabilities within rtol 1e-9 under
float64 and 1e-5 under float32 (the JAX side with x64 off), each column
within rtol of its largest magnitude. One float32 exception: GBT's
validation run meets a split between two candidates of equal float32
gain, which the two packages' summation orders break differently; it is
held up to that split and its tree count within one
(``test_torch_tree_ensembles.py::test_gbt_validation_stops_and_truncates``).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.models import base as jbase
from sparkdq4ml_tpu.models import tree as jt
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.interop import tree_model_from_numpy
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import tree as tt
from sparkdq4ml_tpu_torch.ops import kernels

POLICIES = {"float64": SimpleNamespace(name="float64", rtol=1e-9),
            "float32": SimpleNamespace(name="float32", rtol=1e-5)}


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


def table(n=300, d=5, seed=0):
    """Seeded features (two of them integer-valued, so bins tie), a
    regression label, a three-class label, a binary label, a validation
    flag, and about 10% of the rows masked out."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    X[:, 1] = rng.integers(0, 6, n)
    X[:, -1] = np.round(X[:, -1], 1)
    y = 2.0 * X[:, 0] + np.sin(X[:, 1]) + rng.normal(0.0, 0.2, n)
    yc = (X[:, 0] + X[:, 2] > 0) * 1.0 + (X[:, 3] > 1.0)
    cols = {"features": X, "label": y, "cls": yc,
            "bin": (X[:, 0] - X[:, 1] / 3 > 0) * 1.0,
            "val": (rng.random(n) < 0.25) * 1.0}
    return cols, rng.random(n) > 0.1


def frames(cols, mask):
    return (JFrame(dict(cols), mask=mask),
            TFrame(dict(cols), mask=mask, device="cpu"))


def close(got, want, rtol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = np.max(np.abs(want)) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def same_trees(b, a, rtol):
    """Port model ``b`` against JAX model ``a``: structure exact."""
    for f in ("feature", "is_leaf"):
        np.testing.assert_array_equal(b.feature if f == "feature"
                                      else b.is_leaf, np.asarray(getattr(
                                          a, f)), err_msg=f)
    np.testing.assert_array_equal(b.threshold, np.asarray(a.threshold))
    assert b.threshold.dtype == np.asarray(a.threshold).dtype
    close(b.value, a.value, rtol, "value")
    close(b.gain, a.gain, rtol, "gain")
    close(b.feature_importances, a.feature_importances, rtol, "imp")


# ---------------------------------------------------------------------------
# the builder's parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_bins", [4, 32])
def test_bin_features_exact(policy, max_bins):
    cols, mask = table()
    X = cols["features"].astype(np.dtype(policy.name))
    X[3, 2] = np.nan
    got = tt.bin_features(X, mask, max_bins)
    want = jt.bin_features(X, mask, max_bins)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("depth", [0, 2, 3])
def test_one_level_histogram_against_segment_sum(policy, depth):
    cols, mask = table()
    _, binned = jt.bin_features(cols["features"], mask, 8)
    rng = np.random.default_rng(1)
    m = 2 ** depth
    node = rng.integers(0, m + 1, len(mask))        # m: parked rows
    targets = rng.normal(size=(len(mask), 3)).astype(np.dtype(policy.name))
    want = jt._level_histogram(jnp.asarray(binned), jnp.asarray(node),
                               jnp.asarray(targets), m, 8)
    got = tt._level_histogram(torch.as_tensor(binned).long(),
                              torch.as_tensor(node), torch.as_tensor(
                                  targets), m, 8)
    assert tuple(got.shape) == want.shape
    close(got.numpy(), want, policy.rtol, "histogram")


@pytest.mark.parametrize("impurity,stats", [("variance", 3), ("gini", 3),
                                            ("entropy", 2)])
def test_build_tree_arrays(policy, impurity, stats):
    cols, mask = table()
    edges, binned = jt.bin_features(cols["features"], mask, 16)
    rng = np.random.default_rng(2)
    if impurity == "variance":
        y = cols["label"]
        targets = np.stack([np.ones_like(y), y, y * y], axis=1)
    else:
        targets = np.eye(stats)[rng.integers(0, stats, len(mask))]
    targets = (targets * mask[:, None]).astype(np.dtype(policy.name))
    fm = rng.random((2 ** 4 - 1, 5)) < 0.6
    dt = np.dtype(policy.name)
    want = jt.build_tree(jnp.asarray(binned), jnp.asarray(edges, dt),
                         jnp.asarray(targets), 3, 16, impurity, 2, 0.0,
                         jnp.asarray(fm))
    got = tt.build_tree(torch.as_tensor(binned).long(),
                        torch.as_tensor(edges).to(getattr(torch,
                                                          policy.name)),
                        torch.as_tensor(targets), 3, 16, impurity, 2, 0.0,
                        torch.as_tensor(fm))
    for f in ("feature", "is_leaf", "threshold"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    close(got.value.numpy(), want.value, policy.rtol, "value")
    close(got.gain.numpy(), want.gain, policy.rtol, "gain")


def test_tied_gains_take_the_first_maximum(policy):
    """Two features with identical histograms and, inside each, two bins
    of equal gain: both packages split on the first feature's first bin
    (``jnp.argmax`` and ``torch.argmax`` take the first maximum)."""
    dt = np.dtype(policy.name)
    one = np.array([[1, 0], [0, 1], [1, 0], [0, 1]], dt)   # per bin, gini
    hist = np.stack([np.stack([one, one])] * 2)             # (2, 2, 4, 2)
    hist[:, 1] = np.array([[2, 0], [0, 2], [0, 2], [2, 0]], dt)
    edges = np.array([[0.5, 1.5, 2.5], [0.5, 1.5, 2.5]])
    want = jt._find_splits(jnp.asarray(hist), jnp.asarray(edges, dt),
                           "gini", 1, 0.0)
    got = tt._find_splits(torch.as_tensor(hist), torch.as_tensor(edges).to(
        getattr(torch, policy.name)), "gini", 1, 0.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].tolist() == [0, 0] and got[1].tolist() == [0, 0]
    assert torch.argmax(torch.tensor([1.0, 3.0, 3.0, 2.0])) == 1


def test_a_table_past_shared_memory_takes_the_sorted_route(monkeypatch):
    """Depth 5 at 32 bins and 3 stats in float32 is 1,024 slots: more than
    the dense kernel's tables hold, so that level's sums take the sorted
    kernel after a stable sort, and the levels before it the dense one."""
    routes = []
    for name in ("dense_segment_sum", "sorted_segment_sum"):
        real = getattr(kernels, name)

        def spy(x, seg, size, real=real, name=name):
            routes.append((name, size, x.shape[1]))
            if name == "sorted_segment_sum":
                assert bool((seg[1:] >= seg[:-1]).all())
            return real(x, seg, size)

        monkeypatch.setattr(kernels, name, spy)
    assert not kernels.dense_segment_fits(1024, 3, 4)
    assert kernels.dense_segment_fits(512, 3, 4)
    cols, mask = table()
    cols["features"] = cols["features"][:, :1]
    with float_policy(torch.float32):
        _, t = frames(cols, mask)
        tt.DecisionTreeRegressor().fit(t)
    assert routes == [("dense_segment_sum", 32 * 2 ** k, 3)
                      for k in range(5)] + [("sorted_segment_sum", 1024, 3)]


# ---------------------------------------------------------------------------
# the estimators
# ---------------------------------------------------------------------------

REGRESSORS = {
    "tree": lambda M: M.DecisionTreeRegressor(max_depth=4, max_bins=16),
    "tree_min": lambda M: M.DecisionTreeRegressor(
        max_depth=3, min_instances_per_node=20, min_info_gain=0.01),
    "forest": lambda M: M.RandomForestRegressor(num_trees=4, max_depth=3,
                                                seed=5),
    "forest_all": lambda M: M.RandomForestRegressor(
        num_trees=3, max_depth=3, feature_subset_strategy="all",
        subsampling_rate=0.7),
    "gbt": lambda M: M.GBTRegressor(max_iter=6, max_depth=3, step_size=0.3),
    "gbt_subsample": lambda M: M.GBTRegressor(
        max_iter=5, max_depth=2, subsampling_rate=0.6, seed=11),
}


@pytest.mark.parametrize("name", sorted(REGRESSORS))
def test_regressors(policy, name):
    cols, mask = table()
    j, t = frames(cols, mask)
    a, b = REGRESSORS[name](jt).fit(j), REGRESSORS[name](tt).fit(t)
    same_trees(b, a, policy.rtol)
    close(b.transform(t).to_pydict()["prediction"],
          a.transform(j).to_pydict()["prediction"], policy.rtol, "pred")
    x = cols["features"][7]
    assert b.predict(x) == pytest.approx(a.predict(x), rel=policy.rtol)
    if hasattr(a, "f0"):
        assert b.f0 == pytest.approx(a.f0, rel=1e-12)
        assert b.num_trees == a.num_trees


def test_label_and_input_checks_raise_as_in_jax():
    cols, mask = table()
    cols["cls"] = cols["cls"] - 0.5
    cols["label"][0] = np.nan
    mask[0] = True
    j, t = frames(cols, mask)
    for M, f in ((jt, j), (tt, t)):
        with pytest.raises(ValueError, match="nonnegative integers"):
            M.DecisionTreeClassifier(label_col="cls").fit(f)
        with pytest.raises(ValueError, match="binary"):
            M.GBTClassifier(label_col="cls").fit(f)
        with pytest.raises(ValueError, match="NaN/inf"):
            M.DecisionTreeRegressor().fit(f)
        with pytest.raises(ValueError, match="featureSubsetStrategy"):
            M._n_subset_features("most", 4, True, 3)
    with pytest.raises(NotImplementedError, match="mesh"):
        tt.GBTRegressor().fit(t, mesh=object())


def test_persistence_both_ways(policy, tmp_path):
    cols, mask = table()
    j, t = frames(cols, mask)
    a = jt.RandomForestClassifier(num_trees=3, max_depth=3,
                                  label_col="cls").fit(j)
    b = tt.RandomForestClassifier(num_trees=3, max_depth=3,
                                  label_col="cls").fit(t)
    jbase.save_stage(a, str(tmp_path / "jax"))
    tbase.save_stage(b, str(tmp_path / "port"))
    from_jax = tbase.load_stage(str(tmp_path / "jax"))
    from_port = jbase.load_stage(str(tmp_path / "port"))
    assert type(from_jax) is tt.RandomForestClassificationModel
    assert from_jax.num_trees == 3
    close(from_jax.transform(t).to_pydict()["probability"],
          from_port.transform(j).to_pydict()["probability"], policy.rtol,
          "probability")
    gbt = tt.GBTRegressor(max_iter=3, max_depth=2, seed=4)
    gbt.save(str(tmp_path / "est"))
    back = jbase.load_stage(str(tmp_path / "est"))
    assert (back.max_iter, back.seed) == (3, 4)


@pytest.mark.parametrize("kind", ["DecisionTreeRegressionModel",
                                  "RandomForestClassificationModel",
                                  "GBTRegressionModel"])
def test_tree_model_from_numpy(policy, kind):
    cols, mask = table()
    j, t = frames(cols, mask)
    if kind == "DecisionTreeRegressionModel":
        a = jt.DecisionTreeRegressor(max_depth=3).fit(j)
        trees = jt.TreeArrays(*(np.asarray(getattr(a, f))[0]
                                for f in jt.TreeArrays._fields))
        m = tree_model_from_numpy(kind, trees, 5, 3, a._params)
    elif kind == "RandomForestClassificationModel":
        a = jt.RandomForestClassifier(num_trees=3, max_depth=3,
                                      label_col="cls").fit(j)
        m = tree_model_from_numpy(kind, a, 5, 3, a._params,
                                  num_classes=a.num_classes)
    else:
        a = jt.GBTRegressor(max_iter=4, max_depth=2).fit(j)
        m = tree_model_from_numpy(
            kind, tuple(np.asarray(getattr(a, f))
                        for f in jt.TreeArrays._fields), 5, 2, a._params,
            f0=a.f0, step_size=a.step_size)
    assert type(m).__name__ == kind
    close(m.transform(t).to_pydict()["prediction"],
          a.transform(j).to_pydict()["prediction"], policy.rtol, "pred")
