"""The torch port's remaining aggregates against the JAX package's on the
same seeded numpy columns: median, mode, percentile_approx, skewness,
kurtosis, corr, covar_samp, covar_pop, max_by, min_by, collect_list,
collect_set and approx_count_distinct, the aggregates over string columns
(count, min, max, first/last with and without ignorenulls, the distinct
count, mode), global, grouped (numeric, null and string keys, dense and
sorted programs) and through SQL (with HAVING, ORDER BY, arithmetic over
aggregates and the boolean aggregates), under both float policies. The
float32 policy runs the JAX side with x64 off, as on a TPU. The cases
mirror ``tests/test_aggregates_extra.py``.

Tolerance: column names, dtypes, group order, keys, counts, order
statistics, modes, picks, collections and strings exact (the sign of a
zero included); float64 sums and moments rtol 1e-12; float32 sums rtol
1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grouped import both  # noqa: F401

from sparkdq4ml_tpu import functions as JF
from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame import aggregates as JA
from sparkdq4ml_tpu.ops import compiler as jax_compiler
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu.ops import segments as jax_segments
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch import functions as TF
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame import aggregates as TA
from sparkdq4ml_tpu_torch.frame.window import Window as TWindow
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.sql import default_catalog

RTOL = {"float64": 1e-12, "float32": 1e-5}
# columns whose values are sums (float32 sums under that policy)
SUMS = ("sum", "avg", "stddev", "variance", "stddev_pop", "var_pop",
        "sum_distinct", "skewness", "kurtosis", "corr", "covar_samp",
        "covar_pop")


@pytest.fixture(params=["float64", "float32"])
def policy(request):
    """Both packages under one float policy; yields the sums' rtol."""
    name = request.param
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, name)
    jax_segments.clear_cache()
    jax_compiler.clear_cache()
    try:
        with jax.enable_x64(name == "float64"), \
                float_policy(getattr(torch, name)):
            yield RTOL[name]
    finally:
        jax_config.default_float_dtype = old
        jax_segments.clear_cache()
        jax_compiler.clear_cache()


@pytest.fixture
def sessions(policy, session):
    """``(jax session, port session, rtol)`` under one float policy."""
    port = (TorchSession.builder().app_name("test")
            .config("spark.torch.device", "cpu").get_or_create())
    yield session, port, policy
    port.stop()
    default_catalog().clear()


def _py(x):
    return x.item() if isinstance(x, np.generic) else x


def cells_equal(a, b, rtol: float) -> bool:
    """Two cells (or lists of cells) equal: the same Python type, NaN
    equal to NaN, a zero's sign kept, floats within ``rtol`` where it is
    not 0."""
    a, b = _py(a), _py(b)
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b)
                and all(cells_equal(x, y, rtol) for x, y in zip(a, b)))
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if a == b:
            return math.copysign(1.0, a) == math.copysign(1.0, b)
        return rtol > 0 and abs(a - b) <= rtol * max(abs(a), abs(b))
    return a == b


def assert_frames(got, want, rtol: float = 0.0, approx=()):
    """Port frame ``got`` against JAX frame ``want``: names, Spark types,
    numpy dtypes and shapes, then every cell (``approx`` columns within
    ``rtol``, the others exact)."""
    assert got.columns == want.columns
    assert got.dtypes() == want.dtypes()
    dg, dw = got.to_pydict(), want.to_pydict()
    for c in want.columns:
        a, b = np.asarray(dg[c]), np.asarray(dw[c])
        assert a.shape == b.shape and a.dtype == b.dtype, (c, a.dtype,
                                                           b.dtype)
        tol = rtol if c in approx else 0.0
        assert cells_equal(a.tolist(), b.tolist(), tol), (c, a, b)


def sums_of(aggs) -> list:
    return [a.name for a in aggs if a.fn in SUMS]


def columns(seed: int, n: int = 60) -> dict:
    """Null keys, ties, a skewed float column, an int, a bool, a string
    column with nulls, and ``z`` holding ``-0.0`` beside ``0.0`` (read by
    the collections only: numpy orders ``-0.0`` and ``0.0`` as it likes,
    so the sign of an order statistic's zero is not defined)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-2, 3, n).astype(np.float64)
    k[rng.random(n) < 0.15] = np.nan
    v = rng.integers(0, 6, n).astype(np.float64) * 0.5
    v[rng.random(n) < 0.2] = np.nan
    z = np.where(rng.random(n) < 0.5, -0.0, v)
    w = rng.gamma(2.0, 3.0, n)
    w[rng.random(n) < 0.1] = np.nan
    i = rng.integers(-5, 5, n).astype(np.int32)
    s = np.asarray(rng.choice(["a", "bb", "c", "é"], n), dtype=object)
    s[rng.random(n) < 0.2] = None
    b = rng.random(n) < 0.5
    return {"k": k, "v": v, "w": w, "i": i, "b": b, "s": s, "z": z}


def masked(seed: int):
    return both(columns(seed), lambda E: E.col("i") < 4)


CASES = {
    "order_stats": lambda M: [
        M.median("v"), M.mode("v"), M.percentile_approx("v", 0.0),
        M.percentile_approx("v", 0.3), M.percentile_approx("v", 0.5),
        M.percentile_approx("v", 1.0), M.median("i"), M.mode("i"),
        M.percentile_approx("w", 0.9), M.mode("b")],
    "moments": lambda M: [M.skewness("w"), M.kurtosis("w"),
                          M.skewness("i"), M.kurtosis("v")],
    "two_columns": lambda M: [
        M.corr("v", "w"), M.covar_samp("v", "w"), M.covar_pop("i", "w"),
        M.AggExpr("max_by", "i", column2="v"),
        M.AggExpr("min_by", "w", column2="v"),
        M.AggExpr("max_by", "s", column2="w"),
        M.AggExpr("min_by", "s", column2="i")],
    "collections": lambda M: [
        M.collect_list("z"), M.collect_set("z"), M.collect_list("s"),
        M.collect_set("s"), M.collect_set("b"), M.collect_list("i")],
    "strings": lambda M: [
        M.count("s"), M.min("s"), M.max("s"), M.first("s"), M.last("s"),
        M.first("s", ignorenulls=True), M.last("s", ignorenulls=True),
        M.count_distinct("s"), M.mode("s"),
        M.approx_count_distinct("s")],
    "mixed": lambda M: [
        M.AggExpr("count", None), M.sum("v"), M.avg("w"), M.min("i"),
        M.max("v"), M.stddev("w"), M.first("v", ignorenulls=True),
        M.sum_distinct("i"), M.median("w"), M.count("v")],
}


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", sorted(CASES))
def test_global(policy, seed, case):
    j, t = masked(seed)
    aggs = CASES[case](TA)
    assert_frames(t.agg(*aggs), j.agg(*CASES[case](JA)), policy,
                  sums_of(aggs))


@pytest.mark.parametrize("keys", [["k"], ["s"], ["k", "b"], ["i"]],
                         ids=["null_float_key", "string_key", "two_keys",
                              "int_key"])
@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped(policy, seed, case, keys):
    j, t = masked(seed)
    aggs = CASES[case](TA)
    assert_frames(t.group_by(*keys).agg(*aggs),
                  j.group_by(*keys).agg(*CASES[case](JA)), policy,
                  sums_of(aggs))


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_valid_row(policy, case):
    """Every row masked out, and a frame with no row slots."""
    j, t = both(columns(0), lambda E: E.col("i") > 99)
    aggs = CASES[case](TA)
    assert_frames(t.agg(*aggs), j.agg(*CASES[case](JA)))
    assert_frames(t.group_by("k").agg(*aggs),
                  j.group_by("k").agg(*CASES[case](JA)))
    empty = {c: v[:0] for c, v in columns(0).items()}
    je, te = both(empty)
    assert_frames(te.group_by("k").agg(*aggs),
                  je.group_by("k").agg(*CASES[case](JA)))


def test_mode_ties_go_to_the_smallest(policy):
    j, t = both({"k": np.asarray([0, 0, 0, 0, 1, 1, 1], np.int64),
                 "v": [3.0, 1.0, 3.0, 1.0, 5.0, 2.0, 2.0]})
    got = t.group_by("k").agg(TA.mode("v"), TA.median("v"))
    assert_frames(got, j.group_by("k").agg(JA.mode("v"), JA.median("v")))
    assert got.to_pydict()["mode(v)"].tolist() == [1.0, 2.0]


def test_skewness_kurtosis_scipy_parity(policy):
    v = np.random.default_rng(0).gamma(2.0, size=200)
    j, t = both({"v": v})
    aggs = [TA.skewness("v"), TA.kurtosis("v")]
    assert_frames(t.agg(*aggs), j.agg(JA.skewness("v"), JA.kurtosis("v")),
                  policy, sums_of(aggs))


def test_first_last_null_vs_ignorenulls(policy):
    j, t = both({"x": [np.nan, 2.0, np.nan]})

    def make(M):
        return [M.first("x"), M.first("x", ignorenulls=True), M.last("x"),
                M.last("x", ignorenulls=True)]
    assert_frames(t.agg(*make(TA)), j.agg(*make(JA)))


def test_string_first_last_global(policy):
    j, t = both({"s": np.asarray(["p", None, "r"], dtype=object)})

    def make(M):
        return [M.first("s"), M.last("s"), M.max("s"), M.min("s"),
                M.collect_set("s"), M.count("s")]
    assert_frames(t.agg(*make(TA)), j.agg(*make(JA)))


def test_grouped_strings_collect(policy):
    cols = {"k": [1, 1, 2], "s": np.asarray(["p", "q", "p"], dtype=object)}
    j, t = both(cols)
    assert_frames(t.group_by("k").agg(TA.collect_list("s")),
                  j.group_by("k").agg(JA.collect_list("s")))


def test_validation():
    with pytest.raises(ValueError, match="two columns"):
        TA.corr("x", None)
    with pytest.raises(ValueError, match="one column"):
        TA.AggExpr("avg", "x", column2="y")
    with pytest.raises(ValueError, match="not supported"):
        TA.collect_list("x").over(TWindow.partition_by("g"))
    with pytest.raises(ValueError, match="percentage"):
        TA.percentile_approx("v", 1.5)
    with pytest.raises(ValueError, match="rsd"):
        TA.approx_count_distinct("x", rsd=1.5)
    assert TA.approx_count_distinct("x").name == "approx_count_distinct(x)"
    assert TF.percentile_approx("x", 0.25).name == \
        "percentile_approx(x, 0.25)"


VIEW = {"g": np.asarray(["a", "a", "a", "b", "b", "b"], dtype=object),
        "x": [1.0, 2.0, 2.0, 4.0, np.nan, 6.0],
        "y": [2.0, 4.0, 5.0, 8.0, 10.0, 11.0],
        "k": [1.0, 1.0, 2.0, 2.0, 2.0, 1.0],
        "p": [2.0, 3.0, 10.0, 1.0, 9.0, 4.0],
        "name": np.asarray(["a", None, "c", "d", "e", "f"], dtype=object)}

SQL = [
    ("count_distinct", "SELECT g, COUNT(DISTINCT x) AS nx FROM t GROUP BY g",
     ()),
    ("sum_distinct", "SELECT SUM(DISTINCT x) AS s FROM t", ("s",)),
    ("corr", "SELECT CORR(x, y) AS c, COVAR_SAMP(x, y) AS cs, "
     "COVAR_POP(x, y) AS cp FROM t", ("c", "cs", "cp")),
    ("collect_and_moments", "SELECT COLLECT_SET(g) AS gs, SKEWNESS(y) AS sk "
     "FROM t", ("sk",)),
    ("first_last", "SELECT g, FIRST(y) AS fy, LAST(y) AS ly FROM t GROUP BY "
     "g", ()),
    ("having_corr", "SELECT g FROM t GROUP BY g HAVING CORR(x, y) > 0.5",
     ()),
    ("having_count_distinct", "SELECT g FROM t GROUP BY g HAVING "
     "COUNT(DISTINCT x) > 1", ()),
    ("median_mode_percentile", "SELECT k, MEDIAN(y) AS m, MODE(x) AS mo, "
     "STDDEV_POP(y) AS sp, PERCENTILE_APPROX(y, 0.9) AS p FROM t GROUP BY k",
     ("sp",)),
    ("sum_of_expression", "SELECT sum(p * y) AS s FROM t", ("s",)),
    ("grouped_avg_of_expression", "SELECT k, avg(p + y) AS a FROM t GROUP "
     "BY k ORDER BY k", ("a",)),
    ("count_if", "SELECT count_if(p > 2) AS c FROM t", ()),
    ("bool_aggregates", "SELECT any(p > 5) AS a, every(p > 1) AS e, "
     "bool_or(p > 99) AS o, bool_and(p > 1) AS b, some(p > 9) AS so FROM t",
     ()),
    ("max_by_min_by", "SELECT max_by(k, p) AS m, min_by(k, p) AS n FROM t",
     ()),
    ("max_by_strings", "SELECT g, max_by(name, p) AS m, min_by(name, y) AS "
     "n FROM t GROUP BY g", ()),
    ("approx_count_distinct", "SELECT approx_count_distinct(k) AS c, "
     "approx_count_distinct(k, 0.05) AS c2 FROM t", ()),
    ("bool_in_having", "SELECT k FROM t GROUP BY k HAVING count_if(p > 2) "
     "> 1", ()),
    ("bool_arithmetic", "SELECT count_if(p > 2) + 1 AS c FROM t", ()),
    ("bool_order_by", "SELECT k FROM t GROUP BY k ORDER BY count_if(p > 5) "
     "DESC", ()),
    ("expression_in_having", "SELECT k FROM t GROUP BY k HAVING sum(p * 2) "
     "> 14", ()),
    ("aggregate_arithmetic", "SELECT g, max(y) - median(y) AS d, "
     "percentile_approx(y, 0.5) * 2 AS p2 FROM t GROUP BY g", ("d",)),
    ("string_aggregates", "SELECT k, min(name) AS lo, max(name) AS hi, "
     "count(name) AS n, first(name) AS f FROM t GROUP BY k", ()),
    ("global_string_aggregates", "SELECT min(name) AS lo, max(g) AS hi, "
     "count(name) AS n, mode(g) AS m FROM t", ()),
    ("collect_list_where", "SELECT k, collect_list(y) AS ys FROM t WHERE "
     "p > 2 GROUP BY k", ()),
]


@pytest.mark.parametrize("name,sql,approx", SQL, ids=[s[0] for s in SQL])
def test_sql_forms(sessions, name, sql, approx):
    jax_session, port, rtol = sessions
    for s in (jax_session, port):
        s.createDataFrame(dict(VIEW)).create_or_replace_temp_view("t")
    assert_frames(port.sql(sql), jax_session.sql(sql), rtol, approx)


@pytest.mark.parametrize("sql,error,match", [
    ("SELECT AVG(DISTINCT x) FROM t", ValueError, "DISTINCT"),
    ("SELECT CORR(x) FROM t", ValueError, "two columns"),
    ("SELECT PERCENTILE_APPROX(x) FROM t", ValueError, "percentage"),
    ("SELECT PERCENTILE_APPROX(y, 0.5) OVER (PARTITION BY k) AS p FROM t",
     ValueError, "windowed percentile_approx"),
    ("SELECT count_if(p > 1, p > 2) FROM t", ValueError, "one argument"),
])
def test_sql_errors(sessions, sql, error, match):
    jax_session, port, _ = sessions
    for s in (jax_session, port):
        s.createDataFrame(dict(VIEW)).create_or_replace_temp_view("t")
        with pytest.raises(error, match=match):
            s.sql(sql)


@pytest.mark.parametrize("cols", [
    {"x": np.asarray([None, "a"], dtype=object), "y": [10.0, 1.0]},
    {"x": [np.nan, 5.0], "y": [10.0, 1.0]},
    {"x": [7.0, 5.0], "y": [np.nan, 1.0]},
    {"x": np.asarray(["a", "b"], dtype=object), "y": [np.nan, np.nan]},
], ids=["null_string_value", "null_numeric_value", "null_ordering",
        "all_orderings_null"])
def test_max_by_null_handling(sessions, cols):
    jax_session, port, _ = sessions
    sql = "SELECT max_by(x, y) AS m, min_by(x, y) AS n FROM mb"
    for s in (jax_session, port):
        s.createDataFrame(dict(cols)).create_or_replace_temp_view("mb")
    assert_frames(port.sql(sql), jax_session.sql(sql))


def test_dict_forms_and_expression_aggregates(policy):
    j, t = both({"k": [1.0, 1.0, 2.0], "v": [3.0, 5.0, 7.0],
                 "w": [1.0, 2.0, 3.0]})
    assert_frames(t.group_by("k").agg({"v": "median", "w": "collect_list"}),
                  j.group_by("k").agg({"v": "median", "w": "collect_list"}))
    assert_frames(t.agg(TF.sum(TE.col("v") * 2).alias("s"),
                        TF.median("w")),
                  j.agg(JF.sum(JE.col("v") * 2).alias("s"), JF.median("w")),
                  policy, ("s",))
