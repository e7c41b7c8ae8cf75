"""The torch port's set operations (``Frame.union_by_name``, ``intersect``,
``intersect_all``, ``except_all``, ``subtract`` and their camelCase
aliases; SQL ``UNION [ALL]``, ``INTERSECT`` and ``EXCEPT``) against the
JAX package's on the same seeded numpy columns, under both float
policies. The rows are keyed on the device (``ops/segments.row_keys``)
where the JAX package compares Python tuples, so each of its traps has a
case: every NaN one key and every ``None`` one key (null-safe),
``-0.0 == 0.0``, ``1 == 1.0 == True`` across int, float and bool columns,
masked rows taking no part, the left frame's first-appearance order, the
right side's budget spent on the earliest left occurrences, and the
types ``Frame.from_rows`` gives the result (an empty result's float
columns included). The cases mirror ``tests/test_frame_extra.py``,
``tests/test_dataframe_api_parity.py`` and the set-operation cases of
``tests/test_sql_subqueries.py`` and ``tests/test_sql_qualified.py``.

Tolerance: exact (rows, order, dtypes, the sign of a zero).
"""

import numpy as np
import pytest
from test_torch_aggregates_extra import (assert_frames, both,  # noqa: F401
                                         policy, sessions)

from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame

OPS = ("intersect", "intersect_all", "except_all", "subtract")


def pair(left: dict, right: dict, where=None):
    """(jax left, port left, jax right, port right)."""
    jl, tl = both(left, where)
    jr, tr = both(right)
    return jl, tl, jr, tr


def check(left, right, where=None, ops=OPS):
    jl, tl, jr, tr = pair(left, right, where)
    for op in ops:
        assert_frames(getattr(tl, op)(tr), getattr(jl, op)(jr))
        assert_frames(getattr(tr, op)(tl), getattr(jr, op)(jl))


def seeded(seed: int, n: int = 120) -> dict:
    """Few distinct rows, so duplicates and matches abound: NaN, ``None``,
    ``-0.0`` and ``0.0``, an int, a bool and a string column."""
    rng = np.random.default_rng(seed)
    f = rng.choice([0.0, -0.0, 1.0, 2.5, np.nan], n)
    i = rng.integers(0, 3, n).astype(np.int32)
    s = np.asarray(rng.choice(["a", "b", None], n), dtype=object)
    b = rng.random(n) < 0.5
    return {"f": f, "i": i, "s": s, "b": b}


@pytest.mark.parametrize("seed", range(4))
def test_seeded(policy, seed):
    check(seeded(seed), seeded(seed + 10, 60))


@pytest.mark.parametrize("seed", range(2))
def test_masked_rows_take_no_part(policy, seed):
    check(seeded(seed), seeded(seed + 10, 60), lambda E: E.col("i") < 2)


def test_null_safe(policy):
    nan = float("nan")
    check({"a": [1.0, nan, nan, 2.0]}, {"a": [nan, 2.0]})
    check({"s": np.asarray([None, "x", None], dtype=object)},
          {"s": np.asarray([None], dtype=object)})


def test_negative_zero_equals_zero(policy):
    check({"a": [-0.0, 0.0, 1.0, -0.0]}, {"a": [0.0]})
    check({"a": [0.0, 1.0]}, {"a": [-0.0, -0.0]})


def test_int_against_float_and_bool(policy):
    """Python's tuple equality: 1 == 1.0 == True."""
    check({"a": np.asarray([1, 2, 1, 3], np.int32)}, {"a": [1.0, 3.5]})
    check({"a": [1.0, 0.0, 2.0]}, {"a": [True, False, True]})
    check({"a": np.asarray([1, 0, 7], np.int64)}, {"a": [True]})


def test_string_never_equals_a_number(policy):
    check({"a": np.asarray(["1", None], dtype=object)}, {"a": [1.0, np.nan]})


def test_order_and_budget(policy):
    """The output keeps the left's first-appearance order; each right row
    cancels the earliest equal left row."""
    left = {"k": [3.0, 1.0, 3.0, 2.0, 1.0, 3.0, 1.0],
            "t": np.asarray(list("abcdefg"), dtype=object)}
    right = {"k": [3.0, 1.0, 1.0, 9.0],
             "t": np.asarray(["a", "b", "e", "z"], dtype=object)}
    check({"k": left["k"]}, {"k": right["k"]})
    check(left, right)


def test_vector_columns(policy):
    check({"v": np.asarray([[1.0, 2.0], [1.0, 2.0], [np.nan, 0.0]]),
           "k": [1.0, 1.0, 2.0]},
          {"v": np.asarray([[1.0, 2.0], [np.nan, -0.0]]), "k": [1.0, 2.0]})


@pytest.mark.parametrize("op", OPS)
def test_empty_results_and_frames(policy, op):
    left = {"a": [1.0, 2.0], "s": np.asarray(["x", "y"], dtype=object),
            "i": np.asarray([1, 2], np.int32)}
    jl, tl, jr, tr = pair(left, left)
    assert_frames(getattr(tl, op)(tr), getattr(jl, op)(jr))
    je = jl.filter(jl["a"] > 9)
    te = tl.filter(tl.col("a") > 9)
    assert_frames(getattr(te, op)(tr), getattr(je, op)(jr))
    assert_frames(getattr(tl, op)(te), getattr(jl, op)(je))


def test_aliases_and_column_checks(policy):
    jl, tl, jr, tr = pair(seeded(0), seeded(1))
    assert_frames(tl.exceptAll(tr), jl.exceptAll(jr))
    assert_frames(tl.intersectAll(tr), jl.intersectAll(jr))
    for op in OPS:
        with pytest.raises(ValueError, match="identical column lists"):
            getattr(tl, op)(TFrame({"z": [1.0]}, device="cpu"))


def test_intersect_all_preserves_duplicates(policy):
    check({"a": [1.0, 1.0, 1.0, 2.0]}, {"a": [1.0, 1.0, 3.0]},
          ops=("intersect_all",))


AB = {"a": [1.0, 2.0], "b": np.asarray(["x", "y"], dtype=object)}


@pytest.mark.parametrize("other,allow", [
    ({"b": np.asarray(["z"], dtype=object), "a": [3.0]}, False),
    ({"a": [3.0], "c": [9.0]}, True),
    ({"c": np.asarray(["q"], dtype=object), "b": np.asarray([None],
                                                            dtype=object)},
     True),
], ids=["reorders", "missing_float", "missing_string"])
def test_union_by_name(policy, other, allow):
    jl, tl, jr, tr = pair(AB, other)
    assert_frames(tl.union_by_name(tr, allow_missing_columns=allow),
                  jl.union_by_name(jr, allow_missing_columns=allow))
    assert_frames(tl.unionByName(tr, allow), jl.unionByName(jr, allow))


def test_union_by_name_mismatch_raises():
    t = TFrame(dict(AB), device="cpu")
    with pytest.raises(ValueError, match="column sets differ"):
        t.union_by_name(TFrame({"a": [1.0]}, device="cpu"))
    with pytest.raises(ValueError, match="column sets differ"):
        JFrame(dict(AB)).union_by_name(JFrame({"a": [1.0]}))


SA = {"x": [1.0, 2.0, 3.0, 2.0, np.nan, -0.0],
      "s": np.asarray(["p", "q", "r", "q", None, "p"], dtype=object)}
SB = {"x": [2.0, 3.0, 5.0, np.nan, 0.0],
      "s": np.asarray(["q", "z", "r", None, "p"], dtype=object)}


@pytest.mark.parametrize("sql", [
    "SELECT x FROM sa INTERSECT SELECT x FROM sb",
    "SELECT x FROM sa EXCEPT SELECT x FROM sb",
    "SELECT x FROM sa UNION SELECT x FROM sb",
    "SELECT x FROM sa UNION ALL SELECT x FROM sb",
    "SELECT x, s FROM sa INTERSECT SELECT x, s FROM sb",
    "SELECT x, s FROM sa EXCEPT SELECT x, s FROM sb",
    "SELECT x FROM sa UNION ALL SELECT x FROM sb EXCEPT SELECT x FROM sb",
    "SELECT x FROM sa INTERSECT SELECT x FROM sb UNION SELECT x FROM sa",
    "WITH w AS (SELECT x FROM sa UNION SELECT x FROM sb) SELECT x FROM w "
    "WHERE x > 1",
    "SELECT x FROM sa WHERE x IN (SELECT x FROM sb EXCEPT SELECT x FROM sa "
    "WHERE x > 2)",
    "SELECT x FROM (SELECT x FROM sa INTERSECT SELECT x FROM sb) d "
    "WHERE d.x > 2",
    "SELECT price FROM (SELECT x AS price FROM sa) INTERSECT SELECT x AS "
    "price FROM sb",
    "SELECT x FROM sa WHERE x > 1 EXCEPT SELECT x FROM sb WHERE x > 4",
], ids=["intersect", "except", "union", "union_all", "intersect_two",
        "except_two", "left_assoc", "left_assoc_union", "in_cte",
        "in_subquery", "in_derived", "unaliased_derived", "filtered"])
def test_sql_set_operations(sessions, sql):
    jax_session, port, _ = sessions
    for s in (jax_session, port):
        s.createDataFrame(dict(SA)).create_or_replace_temp_view("sa")
        s.createDataFrame(dict(SB)).create_or_replace_temp_view("sb")
    assert_frames(port.sql(sql), jax_session.sql(sql))
