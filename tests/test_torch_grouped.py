"""The torch port's grouped engine (``ops/segments.py``) against the JAX
package's on the same seeded numpy columns: ``group_by().agg()`` over the
whole device aggregate family (dense and sorted programs), ``sort``,
``distinct``, ``drop_duplicates`` and global aggregates, under both float
policies. The float32 policy runs the JAX package with x64 off, as on a
TPU, where its accumulators are float32 like the port's.

Tolerance: column names, dtypes, row order, keys, counts, min/max/first/
last picks and integer results exact (the sign of a zero key included);
sums, averages and variances rtol 1e-9 under float64 and 1e-5 under
float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame import aggregates as JA
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import compiler as jax_compiler
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu.ops import segments as jax_segments
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame import aggregates as TA
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.ops import segments

RTOL = {"float64": 1e-9, "float32": 1e-5}
APPROX = ("sum", "avg", "stddev", "variance", "stddev_pop", "var_pop",
          "sum_distinct")


@pytest.fixture(params=["float64", "float32"])
def policy(request):
    """Both packages under one float policy; yields the rtol."""
    name = request.param
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, name)
    clear_jax_plans()
    try:
        with jax.enable_x64(name == "float64"), \
                float_policy(getattr(torch, name)):
            yield RTOL[name]
    finally:
        jax_config.default_float_dtype = old
        clear_jax_plans()


def clear_jax_plans():
    """The JAX package's plan caches key on the float policy, not on x64:
    drop them around a policy switch so no plan outlives its mode."""
    jax_segments.clear_cache()
    jax_compiler.clear_cache()


def both(cols, where=None):
    """The same columns as a JAX frame and a port frame on the CPU, with
    ``where(E)`` applied through each package's expressions."""
    j, t = JFrame(dict(cols)), TFrame(dict(cols), device="cpu")
    if where is not None:
        j, t = j.filter(where(JE)), t.filter(where(TE))
    return j, t


def assert_same(got, want, rtol, approx=()):
    """Port frame ``got`` against JAX frame ``want``."""
    assert got.columns == want.columns
    assert got.dtypes() == want.dtypes()
    dg, dw = got.to_pydict(), want.to_pydict()
    for c in want.columns:
        a, b = np.asarray(dg[c]), np.asarray(dw[c])
        assert a.shape == b.shape and a.dtype == b.dtype, c
        if c in approx:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0,
                                       equal_nan=True, err_msg=c)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)
            if a.dtype.kind == "f":
                np.testing.assert_array_equal(np.signbit(a), np.signbit(b),
                                              err_msg=c)


def agg_names(aggs):
    return [a.name for a in aggs if a.fn in APPROX]


def all_aggs(M, col):
    return [M.AggExpr("count", None), M.count(col), M.sum(col), M.avg(col),
            M.min(col), M.max(col), M.stddev(col), M.variance(col),
            M.stddev_pop(col), M.var_pop(col), M.first(col), M.last(col),
            M.first(col, ignorenulls=True), M.last(col, ignorenulls=True),
            M.count_distinct(col), M.sum_distinct(col)]


def mixed(seed, n=80, int_keys=True):
    rng = np.random.default_rng(seed)
    k = rng.integers(-3, 4, n).astype(np.float64)
    if not int_keys:
        k = k + rng.choice([0.0, 0.25, 0.5], n)
    k[rng.random(n) < 0.15] = np.nan
    v = rng.normal(0.0, 3.0, n) + rng.integers(-5, 12, n)
    v[rng.random(n) < 0.25] = np.nan
    i = rng.integers(-40, 90, n).astype(np.int32)
    b = rng.random(n) < 0.4
    return both({"k": k, "v": v, "i": i, "b": b},
                lambda E: E.col("i") < 75)


def agg_both(j, t, keys, make, rtol):
    jaggs, taggs = make(JA), make(TA)
    assert_same(t.group_by(*keys).agg(*taggs),
                j.group_by(*keys).agg(*jaggs), rtol, agg_names(taggs))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("int_keys", [True, False], ids=["dense", "sorted"])
def test_every_device_aggregate_float_column(policy, seed, int_keys):
    j, t = mixed(seed, int_keys=int_keys)
    agg_both(j, t, ["k"], lambda M: all_aggs(M, "v"), policy)


@pytest.mark.parametrize("seed", range(2))
def test_int_and_bool_value_columns(policy, seed):
    j, t = mixed(seed)

    def make(M):
        return [M.sum("i"), M.min("i"), M.max("i"), M.avg("i"),
                M.count("i"), M.first("i"), M.last("i"), M.sum("b"),
                M.min("b"), M.max("b"), M.count_distinct("i"),
                M.sum_distinct("i"), M.stddev("i")]
    agg_both(j, t, ["k"], make, policy)


@pytest.mark.parametrize("keys", [["k", "i"], ["b", "k"], ["i"], ["b"]])
def test_multi_int_and_bool_keys(policy, keys):
    j, t = mixed(4)
    agg_both(j, t, keys, lambda M: [M.count(), M.sum("v"), M.avg("v"),
                                    M.min("i"), M.max("b"), M.first("v")],
             policy)


def test_null_group_sorts_first_and_keys_keep_dtype(policy):
    j, t = both({"k": [3.0, np.nan, 1.0, np.nan, 3.0],
                 "g": np.array([2, 1, 2, 1, 0], np.int32),
                 "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    out = t.group_by("k").agg(TA.count(), TA.sum("v"))
    assert np.isnan(out.to_pydict()["k"][0])
    agg_both(j, t, ["k"], lambda M: [M.count(), M.sum("v")], policy)
    agg_both(j, t, ["g", "k"], lambda M: [M.count(), M.last("v")], policy)


@pytest.mark.parametrize("distinct", [False, True], ids=["dense", "sorted"])
def test_signed_zero_keys(policy, distinct):
    """-0.0 and 0.0 are one group; which row leads it (its key's sign and
    its first/last) follows the JAX package's float total order."""
    j, t = both({"k": [0.0, -0.0, 1.0, -0.0, 0.0, 2.5],
                 "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]})

    def make(M):
        out = [M.count(), M.first("v"), M.last("v"), M.sum("v")]
        return out + [M.count_distinct("v")] if distinct else out
    agg_both(j, t, ["k"], make, policy)
    jt = j.sort("k")
    assert_same(t.sort("k"), jt, 0.0)
    assert_same(t.distinct(), j.distinct(), 0.0)


def test_dense_miss_reroutes_huge_and_overflowing_ranges(policy):
    rng = np.random.default_rng(11)
    for k in (rng.integers(0, 2 ** 30, 50).astype(np.float64),
              np.array([0.0, 2.0 ** 25, 2.0 ** 25 + 1.0, -(2.0 ** 26)] * 5),
              np.array([1.5, 2.5, 1.5, np.nan])):
        j, t = both({"k": k, "v": rng.normal(size=k.size)})
        agg_both(j, t, ["k"], lambda M: [M.count(), M.sum("v"),
                                         M.first("v")], policy)


def test_dense_verdict_is_one_host_read(monkeypatch):
    """The dense program reads the fit verdict and the group count in one
    transfer; a miss adds the sorted program's one read."""
    reads = []
    real = torch.Tensor.tolist

    def counted(self):
        reads.append(tuple(self.shape))
        return real(self)
    monkeypatch.setattr(torch.Tensor, "tolist", counted)
    with float_policy(torch.float64):
        f = TFrame({"k": [1.0, 2.0, 1.0], "v": [1.0, 2.0, 3.0]},
                   device="cpu")
        f.group_by("k").agg(TA.count(), TA.avg("v"))
    assert reads == [(2,)]


@pytest.mark.parametrize("case", ["single_group", "all_masked", "empty",
                                  "one_row", "all_null_values",
                                  "all_null_keys"])
def test_degenerate_frames(policy, case):
    cols = {"single_group": {"k": [2.0] * 6, "v": [1.0, 2, 3, 4, 5, 6]},
            "all_masked": {"k": [1.0, 2.0], "v": [1.0, 2.0]},
            "empty": {"k": np.asarray([], np.float64),
                      "v": np.asarray([], np.float64)},
            "one_row": {"k": [5.0], "v": [3.5]},
            "all_null_values": {"k": [1.0, 1.0, 2.0],
                                "v": [np.nan, np.nan, 5.0]},
            "all_null_keys": {"k": [np.nan, np.nan], "v": [1.0, 2.0]}}[case]
    where = (lambda E: E.col("v") > 100) if case == "all_masked" else None
    j, t = both(cols, where)
    agg_both(j, t, ["k"], lambda M: all_aggs(M, "v"), policy)
    agg_both(j, t, ["k"], lambda M: [M.count(), M.avg("v"), M.stddev("v"),
                                     M.min("v")], policy)
    assert_same(t.sort("k"), j.sort("k"), 0.0)
    assert_same(t.distinct(), j.distinct(), 0.0)
    assert_same(t.drop_duplicates(["k"]), j.drop_duplicates(["k"]), 0.0)


@pytest.mark.parametrize("seed", range(3))
def test_sort_directions_and_null_placement(policy, seed):
    j, t = mixed(seed)
    for spec in (lambda M: ("k",), lambda M: ("k", "v"),
                 lambda M: (M.col("v").desc(), "i"),
                 lambda M: (M.col("k").asc_nulls_last(),
                            M.col("v").desc_nulls_first()),
                 lambda M: ("b", M.col("i").desc())):
        assert_same(t.sort(*spec(TE)), j.sort(*spec(JE)), 0.0)
    assert_same(t.sort("k", "v", ascending=[False, True]),
                j.sort("k", "v", ascending=[False, True]), 0.0)


def test_sort_gathers_a_string_payload_on_the_host():
    with float_policy(torch.float64):
        t = TFrame({"k": [3.0, 1.0, 2.0], "s": ["c", "a", "b"]},
                   device="cpu")
        assert t.sort("k").to_pydict()["s"].tolist() == ["a", "b", "c"]
        assert t.sort("s").to_pydict()["k"].tolist() == [1.0, 2.0, 3.0]
        with pytest.raises(ValueError, match="descending"):
            t.sort(TE.col("s").desc())


@pytest.mark.parametrize("seed", range(3))
def test_distinct_and_drop_duplicates(policy, seed):
    j, t = mixed(seed)
    assert_same(t.select("k", "b").distinct(), j.select("k", "b").distinct(),
                0.0)
    for subset in (["k"], ["b", "k"], ["i"]):
        assert_same(t.drop_duplicates(subset), j.drop_duplicates(subset),
                    0.0)
    assert_same(t.drop_duplicates(), j.drop_duplicates(), 0.0)


def test_distinct_first_occurrence_nan_fold_and_vectors(policy):
    j, t = both({"k": [3.0, np.nan, 3.0, 2.0, np.nan, 1.0],
                 "v": [1.0, 2.0, 1.0, 4.0, 2.0, 6.0]})
    assert_same(t.distinct(), j.distinct(), 0.0)
    assert t.distinct().to_pydict()["v"].tolist() == [1.0, 2.0, 4.0, 6.0]
    vec = np.asarray([[1.0, 2.0], [1.0, 2.0], [3.0, 4.0]])
    j, t = both({"vec": vec})
    assert_same(t.distinct(), j.distinct(), 0.0)


def test_global_aggregates(policy):
    j, t = mixed(2)

    def make(M):
        return [M.AggExpr("count", None), M.count("v"), M.sum("v"),
                M.avg("v"), M.min("v"), M.max("v"), M.stddev("v"),
                M.variance("v"), M.count("i"), M.sum("i"), M.min("i"),
                M.avg("i")]
    taggs = make(TA)
    assert_same(t.agg(*taggs), j.agg(*make(JA)), policy, agg_names(taggs))
    j, t = both({"v": [1.0, 2.0], "i": np.array([1, 2], np.int32)},
                lambda E: E.col("v") > 5)
    assert_same(t.agg(*make(TA)), j.agg(*make(JA)), policy,
                agg_names(taggs))


@pytest.mark.parametrize("masked", [False, True], ids=["rows", "no_rows"])
def test_global_host_valued_aggregates(policy, masked):
    """stddev_pop, var_pop, first, last and the DISTINCT aggregates without
    GROUP BY: the JAX package's host values and dtypes."""
    j, t = mixed(3)
    if masked:
        j, t = j.filter(JE.col("i") > 500), t.filter(TE.col("i") > 500)

    def make(M):
        return [M.stddev_pop("v"), M.var_pop("v"), M.first("v"), M.last("v"),
                M.first("v", ignorenulls=True), M.last("i"),
                M.count_distinct("v"), M.count_distinct("i"),
                M.sum_distinct("v"), M.sum_distinct("i"), M.first("b")]
    taggs = make(TA)
    assert_same(t.agg(*taggs), j.agg(*make(JA)), policy, agg_names(taggs))


def test_aggregate_over_an_expression(policy):
    j, t = mixed(1)
    got = t.group_by("k").agg(TA.sum(TE.col("v") * 2), TA.max(TE.col("i")))
    want = j.group_by("k").agg(JA.sum(JE.col("v") * 2), JA.max(JE.col("i")))
    assert_same(got, want, policy, ["sum((v * 2))"])


def test_outside_the_subset_raises():
    with float_policy(torch.float64):
        t = TFrame({"s": ["a", "b"], "v": [1.0, 2.0],
                    "x": np.ones((2, 2))}, device="cpu")
        with pytest.raises(NotImplementedError, match="string"):
            t.group_by("v").agg(TA.sum("s"))
        with pytest.raises(NotImplementedError, match=r"\(2, 2\)"):
            t.group_by("x").agg(TA.count())
        with pytest.raises(ValueError, match="unknown aggregate"):
            TA.AggExpr("percentile", "v")
        with pytest.raises(ValueError, match="two columns"):
            TA.AggExpr("corr", "v")


def test_grouped_columns_stay_on_the_frame_device():
    with float_policy(torch.float64):
        t = TFrame({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]}, device="cpu")
        out = t.group_by("k").agg(TA.sum("v"))
        assert out.device == torch.device("cpu")
        assert out.mask.all() and out.num_slots == 2
        assert segments.SEGMENT_FNS == jax_segments.DEVICE_AGG_FNS
        assert segments.DEVICE_AGG_FNS == set(JA._AGGS) - {"mean"}
