"""The torch port's ``df.stat`` (``frame/stat.py``: corr pearson and
spearman, cov, approxQuantile, crosstab, sampleBy, freqItems) and
``describe``, ``summary``, ``sample`` and ``randomSplit`` against the JAX
package's on the same seeded numpy columns, under both float policies.
The cases mirror the frame half of ``tests/test_stat.py``, the summary
and describe cases of ``tests/test_frame_extra.py`` and
``tests/test_frame_ops.py``, and the sampling cases of the latter.

Tolerance: quantiles, counts, crosstab and freqItems cells, masks,
sampled rows, dtypes and the describe/summary strings of counts, minima,
maxima and percentiles exact; corr and cov (one-pass sums in the policy's
dtype) rtol 1e-12 under float64 and 1e-5 under float32; the mean and
stddev strings of describe/summary exact where the data's sums are exact
(``test_describe_exact``), else parsed and held within the same rtol.
"""

import numpy as np
import pytest
import torch
from test_torch_aggregates_extra import (assert_frames, both,  # noqa: F401
                                         columns, policy)

from sparkdq4ml_tpu_torch.frame import stat as tstat


def xy(seed: int, n: int = 80):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    y = 2.0 * x + rng.normal(scale=0.5, size=n)
    r = np.round(rng.normal(size=n), 1)             # ties for spearman
    i = rng.integers(-3, 4, n).astype(np.int32)
    return {"x": x, "y": y, "r": r, "i": i}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pair", [("x", "y"), ("r", "i"), ("i", "x")])
@pytest.mark.parametrize("masked", [False, True])
def test_corr_and_cov(policy, seed, pair, masked):
    j, t = both(xy(seed), (lambda E: E.col("i") > -2) if masked else None)
    for method in ("pearson", "spearman"):
        np.testing.assert_allclose(t.stat.corr(*pair, method=method),
                                   j.stat.corr(*pair, method=method),
                                   rtol=policy)
    np.testing.assert_allclose(t.stat.cov(*pair), j.stat.cov(*pair),
                               rtol=policy)
    np.testing.assert_allclose(t.corr(*pair), j.corr(*pair), rtol=policy)
    np.testing.assert_allclose(t.cov(*pair), j.cov(*pair), rtol=policy)


@pytest.mark.parametrize("where", [None, "nan_masked", "all_masked"])
def test_corr_nan_rules(policy, where):
    """A NaN poisons pearson even in a masked row (the weights multiply
    it), and spearman through rankdata's propagate rule."""
    cols = xy(0, 20)
    cols["x"][3] = np.nan
    cond = {None: None,
            "nan_masked": lambda E: E.col("i") != int(cols["i"][3]),
            "all_masked": lambda E: E.col("i") > 99}[where]
    j, t = both(cols, cond)
    for method in ("pearson", "spearman"):
        np.testing.assert_array_equal(t.stat.corr("x", "y", method),
                                      j.stat.corr("x", "y", method))


def test_rank_is_scipys_average_rank():
    import scipy.stats

    x = torch.tensor([3.0, 1.0, 3.0, 2.0, 1.0, 3.0, 9.0], dtype=torch.float64)
    w = torch.tensor([1, 1, 1, 0, 1, 1, 1], dtype=torch.float64)
    got = tstat._rank(x, w).numpy()
    want = np.zeros(7)
    keep = w.numpy() > 0
    want[keep] = scipy.stats.rankdata(x.numpy()[keep])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("col", ["x", "r", "i"])
def test_approx_quantile(policy, seed, col):
    j, t = both(xy(seed), lambda E: E.col("i") < 3)
    ps = [0.0, 0.1, 0.25, 0.5, 0.75, 0.99, 1.0]
    assert t.stat.approx_quantile(col, ps, 0.0) == \
        j.stat.approx_quantile(col, ps, 0.0)
    assert t.stat.approxQuantile(col, 0.5) == j.stat.approxQuantile(col, 0.5)


def test_approx_quantile_of_no_row(policy):
    j, t = both(xy(0), lambda E: E.col("i") > 99)
    got = t.stat.approx_quantile("x", [0.5, 0.9])
    assert np.isnan(got).all() and len(got) == 2
    assert np.isnan(j.stat.approx_quantile("x", [0.5, 0.9])).all()


CROSS = {"a": np.asarray(["x", "x", "y", None, "None", "x"], dtype=object),
         "b": np.asarray(["1", "2", "1", "2", "1", "1"], dtype=object),
         "f": [-0.0, 0.0, 1.5, np.nan, 1.5, np.nan],
         "i": np.asarray([1, 2, 1, 10, 2, 1], np.int32),
         "t": [True, False, True, True, False, False]}


@pytest.mark.parametrize("pair", [("a", "b"), ("f", "i"), ("i", "a"),
                                  ("t", "f"), ("b", "t")])
def test_crosstab(policy, pair):
    """Keyed on str(value): "-0.0" apart from "0.0", one "nan", None as
    "None" (merged with the string "None")."""
    j, t = both(CROSS)
    assert_frames(t.stat.crosstab(*pair), j.stat.crosstab(*pair))
    jm, tm = both(CROSS, lambda E: E.col("i") < 10)
    assert_frames(tm.stat.crosstab(*pair), jm.stat.crosstab(*pair))


@pytest.mark.parametrize("support", [0.01, 0.3, 0.5])
def test_freq_items(policy, support):
    j, t = both(CROSS)
    cols = ["a", "f", "i", "t"]
    assert_frames(t.stat.freq_items(cols, support),
                  j.stat.freq_items(cols, support))
    assert_frames(t.stat.freqItems(["b"]), j.stat.freqItems(["b"]))


@pytest.mark.parametrize("col,fractions", [
    ("a", {"x": 0.5, "y": 1.0, None: 0.7}),
    ("i", {1: 0.6, 2.0: 1.0, 10: 0.0}),
    ("f", {1.5: 0.9, 0.0: 1.0}),
    ("t", {True: 0.4}),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_by(policy, col, fractions, seed):
    j, t = both(CROSS, lambda E: E.col("i") < 10)
    got = t.stat.sample_by(col, fractions, seed=seed)
    want = j.stat.sampleBy(col, fractions, seed=seed)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert_frames(got, want)
    with pytest.raises(ValueError, match="fraction"):
        t.stat.sample_by(col, {"x": 1.5})


def assert_strings(got, want, rtol: float, rows=("mean", "stddev"),
                   source=None):
    """describe/summary frames: every cell exact, but for the ``rows``
    statistics, parsed and held within ``rtol`` (within 1e-5 for a column
    of ``source`` that is not float64, which the JAX package averages in
    float32 under either policy)."""
    assert got.columns == want.columns and got.dtypes() == want.dtypes()
    dg, dw = got.to_pydict(), want.to_pydict()
    stats = list(dw["summary"])
    assert list(dg["summary"]) == stats
    for c in want.columns[1:]:
        for s, a, b in zip(stats, dg[c], dw[c]):
            if s in rows and a is not None and b is not None:
                tol = rtol if source is None or source._data[c].dtype == \
                    torch.float64 else max(rtol, 1e-5)
                np.testing.assert_allclose(float(a), float(b), rtol=tol,
                                           err_msg=f"{c}.{s}")
            else:
                assert a == b, (c, s, a, b)


EXACT = {"x": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 9.0, np.nan],
         "i": np.asarray([1, 2, 3, 4, 5, 6, 7, 9, 40], np.int32),
         "s": np.asarray(["b", "a", None, "c", "é", "a", "b", "z", "q"],
                         dtype=object),
         "t": [True, False, True, True, False, False, True, True, True]}


def test_describe_exact(policy):
    """Sums exact in both dtypes: every string equal, as str() of the
    same numpy scalar type."""
    j, t = both(EXACT, lambda E: E.col("i") < 40)
    assert_frames(t.describe(), j.describe())
    assert_frames(t.describe("x", "s"), j.describe("x", "s"))
    assert_frames(t.summary(), j.summary())
    assert_frames(t.summary("count", "min", "33%", "max", "mean"),
                  j.summary("count", "min", "33%", "max", "mean"))


@pytest.mark.parametrize("seed", range(2))
def test_describe_and_summary(policy, seed):
    # without the -0.0/0.0 column: the sign of a zero minimum or
    # percentile follows numpy's sort, which leaves it undefined
    j, t = both({c: v for c, v in columns(seed).items() if c != "z"},
                lambda E: E.col("i") < 4)
    assert_strings(t.describe(), j.describe(), policy, source=t)
    assert_strings(t.summary(), j.summary(), policy, source=t)
    stats = ("count", "1%", "50%", "99.5%", "variance", "max")
    assert_strings(t.summary(*stats), j.summary(*stats), policy,
                   ("variance",), source=t)


def test_describe_of_no_valid_row(policy):
    j, t = both(EXACT, lambda E: E.col("i") > 99)
    assert_frames(t.describe(), j.describe())
    assert_frames(t.summary(), j.summary())


@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.5, 1.0])
def test_sample_without_replacement(policy, seed, fraction):
    """The mask is numpy's draw, bit for bit."""
    j, t = both(columns(seed), lambda E: E.col("i") < 4)
    got = t.sample(fraction, seed=seed)
    want = j.sample(fraction, seed=seed)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert_frames(got, want)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("fraction", [0.5, 2.5])
def test_sample_with_replacement(policy, seed, fraction):
    j, t = both(columns(seed), lambda E: E.col("i") < 4)
    assert_frames(t.sample(fraction, seed=seed, with_replacement=True),
                  j.sample(fraction, seed=seed, with_replacement=True))


def test_sample_validation():
    _, t = both(xy(0))
    with pytest.raises(ValueError, match="fraction"):
        t.sample(1.5)
    with pytest.raises(ValueError, match="fraction"):
        t.sample(-0.5, with_replacement=True)


@pytest.mark.parametrize("weights", [[0.8, 0.2], [8, 2], [1, 1, 2]])
@pytest.mark.parametrize("seed", [0, 7])
def test_random_split(policy, weights, seed):
    j, t = both(columns(seed), lambda E: E.col("i") < 4)
    got, want = t.random_split(weights, seed), j.randomSplit(weights, seed)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
        assert_frames(a, b)
    assert sum(p.count() for p in got) == t.count()


def test_chip_smoke_dq_report_phase_runs_on_the_cpu():
    """The chip script's phase 11 at 20,000 rows on the CPU: the float32
    run held to the float64 run through its own comparison, its
    identities, its checks against numpy (steps 4 and 5 row by row), and
    its steps 2-3 bit-identical over two runs."""
    from test_torch_sql_core import smoke

    from sparkdq4ml_tpu_torch.config import float_policy
    from sparkdq4ml_tpu_torch.sql import default_catalog

    guest, price = smoke.full_table(20_000)
    cpu = smoke.report_reference(guest, price)
    with float_policy(torch.float32):
        spark, tables = smoke.report_tables("cpu", guest, price)
        outs = smoke.run_report(spark, tables, runs=2)
        first = smoke.first_runs(outs)
        card = smoke.summarize_report(first)
        again = smoke.summarize_report({k: outs[k][1]
                                        for k in smoke.REPORT_STABLE})
        assert smoke.bit_identical({k: card[k] for k in again}, again) == []
        kept = tables["clean"].count()
        ids = smoke.check_report_identities(first, tables["clean"], kept,
                                            20_000 - kept)
        checks = smoke.check_report_numpy(first, tables["clean"])
        rows = smoke.check_report_rows(first, tables)
        spark.stop()
    default_catalog().clear()
    assert 18_000 < kept < 20_000
    assert ids["correlated_rows"]["in_pairs"] == 0
    assert 0 < rows["correlated.exists_dear"] < kept
    assert rows["rejected.except_all"] == 20_000 - kept
    assert sum(checks["split_rows"]) == kept
    smoke.check_report(card, cpu)
