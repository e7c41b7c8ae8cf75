"""The tree ensembles and classifiers of the torch port
(``models/tree.py``) held against the JAX package on the CPU: the
classifiers' predictions, probabilities, raw predictions and importances,
the random forests' feature subsets at d >= 4 (the bootstrap and the
feature-mask scores drawn in the reference's order), and GBT's validation
stop and truncation. The tolerances are ``test_torch_trees.py``'s.
"""

import numpy as np
import pytest

from sparkdq4ml_tpu.models import tree as jt
from sparkdq4ml_tpu_torch.models import tree as tt
from test_torch_trees import (close, frames, policy,  # noqa: F401
                              same_trees, table)


CLASSIFIERS = {
    "tree_gini": lambda M: M.DecisionTreeClassifier(max_depth=4,
                                                    label_col="cls"),
    "tree_entropy": lambda M: M.DecisionTreeClassifier(
        max_depth=3, impurity="entropy", label_col="cls", max_bins=8),
    "forest": lambda M: M.RandomForestClassifier(num_trees=5, max_depth=3,
                                                 label_col="cls", seed=3),
    "forest_binary": lambda M: M.RandomForestClassifier(
        num_trees=4, max_depth=4, label_col="bin", subsampling_rate=0.8),
    "gbt": lambda M: M.GBTClassifier(max_iter=5, max_depth=2,
                                     label_col="bin"),
}


@pytest.mark.parametrize("name", sorted(CLASSIFIERS))
def test_classifiers(policy, name):
    cols, mask = table()
    j, t = frames(cols, mask)
    a, b = CLASSIFIERS[name](jt).fit(j), CLASSIFIERS[name](tt).fit(t)
    same_trees(b, a, policy.rtol)
    got, want = b.transform(t).to_pydict(), a.transform(j).to_pydict()
    for c in ("prediction", "probability", "rawPrediction"):
        close(got[c], want[c], policy.rtol, c)
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    x = cols["features"][11]
    assert b.predict(x) == a.predict(x)
    if hasattr(a, "predict_probability"):
        close(b.predictProbability(x), a.predict_probability(x),
              policy.rtol, "p")


@pytest.mark.parametrize("strategy", ["sqrt", "onethird", "log2", "3",
                                      "0.4", "auto"])
@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_feature_subsets(policy, strategy, kind):
    cols, mask = table(d=6)
    j, t = frames(cols, mask)
    kw = dict(num_trees=3, max_depth=3, feature_subset_strategy=strategy,
              seed=9)
    if kind == "regressor":
        a = jt.RandomForestRegressor(**kw).fit(j)
        b = tt.RandomForestRegressor(**kw).fit(t)
    else:
        a = jt.RandomForestClassifier(label_col="cls", **kw).fit(j)
        b = tt.RandomForestClassifier(label_col="cls", **kw).fit(t)
    same_trees(b, a, policy.rtol)
    assert tt._n_subset_features(strategy, 6, kind == "classifier", 3) < 6


@pytest.mark.parametrize("tol", [0.01, 0.2])
@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_gbt_validation_stops_and_truncates(policy, tol, loss):
    cols, mask = table()
    j, t = frames(cols, mask)
    kw = dict(max_iter=15, max_depth=2, step_size=0.5,
              validation_indicator_col="val", validation_tol=tol)
    if loss == "squared":
        a, b = jt.GBTRegressor(**kw).fit(j), tt.GBTRegressor(**kw).fit(t)
    else:
        a = jt.GBTClassifier(label_col="bin", **kw).fit(j)
        b = tt.GBTClassifier(label_col="bin", **kw).fit(t)
    if policy.name == "float64":
        assert b.num_trees == a.num_trees < 15
        same_trees(b, a, policy.rtol)
        return
    # float32: the histograms add the rows in other orders, so a split
    # between two candidates of equal float32 gain may flip, and with it
    # the validation loss of that round and the stop: the tree counts
    # agree within one, every tree before the first flip is held, and the
    # flipped node's gains agree
    assert abs(b.num_trees - a.num_trees) <= 1 and b.num_trees < 15
    fa, fb = np.asarray(a.feature), b.feature
    n = min(len(fa), len(fb))
    k = next((i for i in range(n) if not np.array_equal(fa[i], fb[i])), n)
    if k < n:
        node = int(np.flatnonzero(fa[k] != fb[k])[0])
        assert b.gain[k, node] == pytest.approx(
            np.asarray(a.gain)[k, node], rel=policy.rtol)
    for f in ("feature", "threshold", "is_leaf"):
        np.testing.assert_array_equal(getattr(b, f)[:k],
                                      np.asarray(getattr(a, f))[:k])
    close(b.value[:k], np.asarray(a.value)[:k], policy.rtol, "value")
