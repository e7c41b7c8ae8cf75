"""The torch port's pivot, rollup and cube (``frame/aggregates.py``,
``ops/segments.pivot_agg``) and SQL ``GROUP BY ROLLUP(...)``/``CUBE(...)``
against the JAX package's on the same seeded numpy columns, under both
float policies: discovered and given pivot values (strings, numbers,
mixed types, values that print alike), one and several aggregates,
count(*) against count(col) in empty cells, null group keys, masked rows,
every aggregate family in a pivot cell, subtotal levels with exact
integer keys. The cases mirror ``tests/test_pivot.py`` and the rollup and
cube cases of ``tests/test_aggregates_extra.py``.

Tolerance: column names and order, dtypes, keys, counts, order statistics
and collections exact; float64 sums rtol 1e-12, float32 sums rtol 1e-5.
"""

import numpy as np
import pytest
from test_torch_aggregates_extra import (  # noqa: F401
    assert_frames, both, columns, policy, sessions, sums_of)

from sparkdq4ml_tpu.frame import aggregates as JA
from sparkdq4ml_tpu_torch.frame import aggregates as TA

ORDERS = {"year": [2024, 2024, 2024, 2025, 2025, 2025],
          "quarter": np.asarray(["q1", "q2", "q1", "q1", "q1", "q3"],
                                dtype=object),
          "amount": [10.0, 20.0, 30.0, 5.0, 7.0, 9.0]}


def pivoted(frame, keys, pcol, values, aggs):
    return frame.group_by(*keys).pivot(pcol, values).agg(*aggs)


FORMS = {
    "sum_discovers_sorted_values": (ORDERS, ["year"], "quarter", None,
                                    lambda M: [M.sum("amount")]),
    "explicit_values_fix_columns": (ORDERS, ["year"], "quarter",
                                    ["q2", "q1", "q9"],
                                    lambda M: [M.sum("amount")]),
    "count_star_is_zero": (ORDERS, ["year"], "quarter", None,
                           lambda M: [M.AggExpr("count", None)]),
    "count_col_is_null": (ORDERS, ["year"], "quarter", None,
                          lambda M: [M.count("amount")]),
    "multiple_aggs_names": (ORDERS, ["year"], "quarter", ["q1"],
                            lambda M: [M.sum("amount"), M.avg("amount")]),
    "null_string_keys": ({"year": np.asarray(["a", None, None], dtype=object),
                          "quarter": np.asarray(["q1"] * 3, dtype=object),
                          "amount": [1.0, 2.0, 4.0]},
                         ["year"], "quarter", None,
                         lambda M: [M.sum("amount")]),
    "nan_float_keys": ({"k": [1.0, np.nan, np.nan],
                        "p": np.asarray(["x"] * 3, dtype=object),
                        "v": [1.0, 2.0, 4.0]}, ["k"], "p", None,
                       lambda M: [M.sum("v")]),
    "value_shadowing_key_name": ({"k": np.asarray(["a", "b"], dtype=object),
                                  "p": np.asarray(["k", "k"], dtype=object),
                                  "v": [1.0, 2.0]}, ["k"], "p", None,
                                 lambda M: [M.sum("v")]),
    "numeric_pivot_column": ({"k": np.asarray(["a", "a", "b"], dtype=object),
                              "p": [1, 2, 1], "v": [10.0, 20.0, 30.0]},
                             ["k"], "p", None, lambda M: [M.sum("v")]),
    "numeric_values_given_as_floats": (
        {"k": np.asarray(["a", "a", "b"], dtype=object), "p": [1, 2, 1],
         "v": [10.0, 20.0, 30.0]}, ["k"], "p", [1.0, 2, 3],
        lambda M: [M.sum("v"), M.max("p")]),
    "mixed_type_values_sort": ({"k": np.asarray(["a"] * 3, dtype=object),
                                "p": np.asarray([1, "z", 2], dtype=object),
                                "v": [10.0, 20.0, 30.0]}, ["k"], "p", None,
                               lambda M: [M.sum("v")]),
    "values_stringify_identically": (
        {"k": np.asarray(["a", "a"], dtype=object),
         "p": np.asarray([1, "1"], dtype=object), "v": [10.0, 20.0]},
        ["k"], "p", None, lambda M: [M.sum("v")]),
    "covar_on_the_diagonal": (
        {"g": np.asarray(["a", "a", "a", "b", "b", "b"], dtype=object),
         "x": [1.0, 2.0, 2.0, 4.0, np.nan, 6.0],
         "y": [2.0, 4.0, 5.0, 8.0, 10.0, 11.0]}, ["g"], "g", None,
        lambda M: [M.covar_pop("x", "y")]),
}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_pivot_forms(policy, name):
    cols, keys, pcol, values, make = FORMS[name]
    j, t = both(cols)
    aggs = make(TA)
    got = pivoted(t, keys, pcol, values, aggs)
    want = pivoted(j, keys, pcol, values, make(JA))
    names = [c for c in want.columns if any(c.endswith(n) or c == n
                                            for n in sums_of(aggs))]
    approx = [c for c in want.columns if c not in keys] if sums_of(aggs) \
        else names
    assert_frames(got, want, policy, approx)


CELL_AGGS = {
    "device_family": lambda M: [M.AggExpr("count", None), M.count("v"),
                                M.sum("w"), M.avg("v"), M.min("i"),
                                M.max("v"), M.stddev("w")],
    "order_stats": lambda M: [M.median("v"), M.mode("i"),
                              M.percentile_approx("w", 0.5)],
    "strings_and_collections": lambda M: [M.max("s"), M.first("s"),
                                          M.collect_list("i"),
                                          M.collect_set("s")],
    "two_columns": lambda M: [M.corr("v", "w"),
                              M.AggExpr("max_by", "s", column2="w")],
}
APPROX_FNS = ("sum", "avg", "stddev", "corr")


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("pcol", ["s", "b", "i"])
@pytest.mark.parametrize("case", sorted(CELL_AGGS))
def test_pivot_seeded(policy, seed, pcol, case):
    """Masked rows, null keys and every aggregate family in the cells."""
    j, t = both(columns(seed), lambda E: E.col("i") < 4)
    make = CELL_AGGS[case]
    got = t.group_by("k").pivot(pcol).agg(*make(TA))
    want = j.group_by("k").pivot(pcol).agg(*make(JA))
    approx = [c for c in want.columns
              if any(f"_{fn}(" in c for fn in APPROX_FNS)]
    assert_frames(got, want, policy, approx)


def test_pivot_of_no_valid_row(policy):
    j, t = both(ORDERS, lambda E: E.col("amount") > 99)
    assert_frames(pivoted(t, ["year"], "quarter", None, [TA.sum("amount")]),
                  pivoted(j, ["year"], "quarter", None, [JA.sum("amount")]))


SALES = {"region": np.asarray(["e", "e", "w", "w", None], dtype=object),
         "product": np.asarray(["p1", "p2", "p1", "p2", "p1"], dtype=object),
         "k": np.asarray([16777217, 16777217, 16777219, 3, 3], np.int64),
         "amount": [10.0, 20.0, 30.0, 40.0, np.nan]}


@pytest.mark.parametrize("kind", ["rollup", "cube"])
@pytest.mark.parametrize("keys", [["region", "product"], ["k"],
                                  ["region", "k"]],
                         ids=["strings", "exact_int", "string_int"])
@pytest.mark.parametrize("aggs", [
    lambda M: [M.sum("amount")],
    lambda M: [M.AggExpr("count", None), M.avg("amount"),
               M.median("amount"), M.collect_list("product")],
], ids=["sum", "mixed"])
def test_rollup_and_cube(policy, kind, keys, aggs):
    j, t = both(SALES)
    got = getattr(t, kind)(*keys).agg(*aggs(TA))
    want = getattr(j, kind)(*keys).agg(*aggs(JA))
    assert_frames(got, want, policy, ["sum(amount)", "avg(amount)"])


def test_rollup_shortcuts_and_validation(policy):
    j, t = both(SALES, lambda E: E.col("amount") > 15)
    assert_frames(t.rollup("region").count(), j.rollup("region").count())
    assert_frames(t.cube("product").sum("amount"),
                  j.cube("product").sum("amount"), policy, ["sum(amount)"])
    with pytest.raises(ValueError, match="at least one key"):
        t.rollup()
    with pytest.raises(ValueError, match="at least one aggregate"):
        t.cube("region").agg()
    assert TA.rollup_levels(["a", "b"]) == JA.rollup_levels(["a", "b"])
    assert TA.cube_levels(["a", "b", "c"]) == JA.cube_levels(["a", "b", "c"])


@pytest.mark.parametrize("sql", [
    "SELECT region, product, SUM(amount) AS s FROM sales GROUP BY "
    "ROLLUP(region, product)",
    "SELECT region, product, SUM(amount) AS s, COUNT(*) AS n FROM sales "
    "GROUP BY CUBE(region, product)",
    "SELECT region, AVG(amount) AS a, MEDIAN(amount) AS m FROM sales WHERE "
    "amount > 15 GROUP BY ROLLUP(region)",
    "SELECT t.region, SUM(t.amount) AS s FROM sales t GROUP BY "
    "ROLLUP(region) HAVING SUM(t.amount) > 25",
    "SELECT k, COUNT(*) AS n FROM sales GROUP BY CUBE(k)",
], ids=["rollup", "cube", "rollup_where", "rollup_qualified_having",
        "cube_exact_int"])
def test_sql_rollup_and_cube(sessions, sql):
    jax_session, port, rtol = sessions
    for s in (jax_session, port):
        s.createDataFrame(dict(SALES)).create_or_replace_temp_view("sales")
    assert_frames(port.sql(sql), jax_session.sql(sql), rtol, ("s", "a"))
