"""String and array columns in the torch port against the JAX package on
the same seeded table (``interop.string_columns``): the frame carrying
them through its verbs, CAST between strings and numbers, ``concat``,
``concat_ws`` and ``split``, ``explode``/``explode_outer``, ``IN``,
``LIKE``, ``IS [NOT] NULL``, ``BETWEEN`` and ``CASE``, and string keys in
``group_by``, ``sort``, ``distinct``, ``drop_duplicates``, joins and
windows (the port runs the device programs on dictionary codes; the JAX
package takes its host paths), under both float policies.

Tolerance: names, dtypes, strings, masks, row counts, keys, orders and
picks exact; sums, averages and deviations rtol 1e-9 under float64 and
1e-5 under float32 (the JAX side then runs with x64 off).
"""

import numpy as np
import pytest
import torch
from test_torch_grouped import assert_same, policy  # noqa: F401

from sparkdq4ml_tpu import functions as JF
from sparkdq4ml_tpu.frame import aggregates as JA
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.frame.window import Window as JW
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu_torch import functions as TF
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame import aggregates as TA
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.frame.window import Window as TW
from sparkdq4ml_tpu_torch.interop import string_columns
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.ops import strings

PORT = (TE, TF, TA, TW)
JAX = (JE, JF, JA, JW)


def both(n=60, seed=0, keep=None):
    """The seeded table in both packages; ``keep(E)`` filters both."""
    cols = string_columns(n, seed)
    j, t = JFrame(dict(cols)), TFrame(dict(cols), device="cpu")
    if keep is not None:
        j, t = j.filter(keep(JE)), t.filter(keep(TE))
    return j, t


def run(fn, j, t, approx=(), rtol=1e-9):
    """``fn(frame, E, F, A, W)`` through both packages, compared."""
    assert_same(fn(t, *PORT), fn(j, *JAX), rtol, approx)


# ---------------------------------------------------------------------------
# The frame carries host columns
# ---------------------------------------------------------------------------

VERBS = {
    "select": lambda f, E, F, A, W: f.select("name", "v", E.col("k")),
    "filter": lambda f, E, F, A, W: f.filter(E.col("k") < 3),
    "limit": lambda f, E, F, A, W: f.filter(E.col("v") > 8).limit(7),
    "union": lambda f, E, F, A, W: f.union(f.filter(E.col("k") == 1)),
    "sort_numeric": lambda f, E, F, A, W: f.sort(E.col("v").desc(), "k"),
    "join_numeric": lambda f, E, F, A, W: f.select("k", "name").join(
        f.select("k", "tags", "v").filter(E.col("v") > 12), "k", "left"),
    "drop_na": lambda f, E, F, A, W: f.na.drop(),
    "fill_na": lambda f, E, F, A, W: f.na.fill("none"),
}


@pytest.mark.parametrize("verb", sorted(VERBS))
def test_frame_verbs_carry_string_and_array_columns(policy, verb):
    j, t = both(keep=lambda E: E.col("k") != 4)
    run(VERBS[verb], j, t)


def test_actions_and_show_text_match(policy):
    j, t = both(40, seed=2, keep=lambda E: E.col("k") < 4)
    # reprs: NaN cells compare equal, list cells by their words
    assert repr(t.take(5)) == repr(j.take(5))
    assert repr(t.collect()) == repr(j.collect())
    assert repr(t.first()) == repr(j.first())
    assert t.select("name", "k", "v").show_string(8) == \
        j.select("name", "k", "v").show_string(8)
    assert t.count() == j.count()


# ---------------------------------------------------------------------------
# Expressions over strings
# ---------------------------------------------------------------------------

def text_table():
    cols = {"s": np.asarray([" 12 ", "3.7", "x", None, "-4", "1_0", "9e1",
                             "b_a", "b%a", "bxa"], dtype=object),
            "i": np.arange(10).astype(np.int32),
            "x": np.asarray([1.5, np.nan, 23.24, -0.0, 7.0, 2.25, 1e20, 3.0,
                             4.0, 5.0])}
    return JFrame(dict(cols)), TFrame(dict(cols), device="cpu")


EXPRS = {
    "cast_str_int": lambda E: E.Cast(E.Col("s"), "int"),
    "cast_str_double": lambda E: E.Cast(E.Col("s"), "double"),
    "cast_int_str": lambda E: E.Cast(E.Col("i"), "string"),
    "cast_double_str": lambda E: E.Cast(E.Col("x"), "string"),
    "cast_exact_ints": lambda E: E.Cast(E.Cast(E.Col("i"), "string"),
                                        "int"),
    "concat": lambda E: E.Func("concat", [E.Col("s"), E.Lit("-"),
                                          E.Col("i")]),
    "concat_ws": lambda E: E.Func("concat_ws", [E.Lit(","), E.Col("i"),
                                                E.Col("x"), E.Col("s")]),
    "split": lambda E: E.Func("split", [E.Col("s"), E.Lit("[._%]")]),
    "in_strings": lambda E: E.Col("s").isin("x", "bxa", None),
    "not_in_with_null": lambda E: E.InList(E.Col("s"), [E.Lit("x"),
                                                        E.Lit(None)],
                                           negated=True),
    "not_in_numbers": lambda E: E.InList(E.Col("x"), [E.Lit(1.5),
                                                      E.Lit(3)],
                                         negated=True),
    "in_numbers": lambda E: E.Col("i").isin(1, 3, 2.0),
    "like_underscore": lambda E: E.Col("s").like("b_a"),
    "like_percent": lambda E: E.Col("s").like("%1%"),
    "like_number": lambda E: E.Col("x").like("2%"),
    "is_null_string": lambda E: E.Col("s").is_null(),
    "is_not_null_float": lambda E: E.Col("x").is_not_null(),
    "is_null_int": lambda E: E.Col("i").isNull(),
    "between": lambda E: E.Col("x").between(2, 7),
    "string_eq": lambda E: E.Col("s") == "x",
    "string_ne": lambda E: E.Col("s") != E.Lit("3.7"),
    "case_strings": lambda E: E.CaseWhen(
        [(E.Col("i") < 3, E.Lit("small")), (E.Col("i") < 6, E.Col("s"))],
        E.Lit("large")),
    "case_no_else": lambda E: E.CaseWhen([(E.Col("i") > 7, E.Lit("hi"))]),
    "case_numbers": lambda E: E.CaseWhen([(E.Col("i") < 4, E.Col("i")),
                                          (E.Col("x") > 3, E.Col("x"))]),
}


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_string_expressions_match_jax(policy, name):
    j, t = text_table()
    got = _host(EXPRS[name](TE).eval(t))
    want = _host(EXPRS[name](JE).eval(j))
    assert got.dtype == want.dtype, name
    if got.dtype == object:
        assert [None if c is None else (list(c) if isinstance(
            c, (list, np.ndarray)) else c) for c in got] == \
            [None if c is None else (list(c) if isinstance(
                c, (list, np.ndarray)) else c) for c in want]
    else:
        np.testing.assert_array_equal(got, want)


def test_functions_module_builds_the_same_expressions(policy):
    j, t = text_table()
    for mk in (lambda F: F.concat_ws("/", "s", "i"),
               lambda F: F.concat("s", "i"),
               lambda F: F.split("s", "[.]"),
               lambda F: F.isnull("s"),
               lambda F: F.when(F.col("i") > 4, "big").otherwise("small")):
        got, want = _host(mk(TF).eval(t)), _host(mk(JF).eval(j))
        assert [list(c) if isinstance(c, list) else c for c in got] == \
            [list(c) if isinstance(c, (list, np.ndarray)) else c
             for c in want]


def test_like_and_not_in_filter_the_same_rows():
    j, t = both(80, seed=5)
    for keep in (lambda E: E.col("name").like("b_a"),
                 lambda E: E.col("name").like("%e%"),
                 lambda E: ~E.col("name").like("_%"),
                 lambda E: E.InList(E.col("name"), [E.lit("fir"),
                                                    E.lit(None)], True),
                 lambda E: E.InList(E.col("name"), [E.lit("fir")], True)):
        assert t.filter(keep(TE)).mask.tolist() == \
            np.asarray(j.filter(keep(JE)).mask).tolist()
    assert t.filter(TE.InList(TE.col("name"), [TE.lit("fir"),
                                               TE.lit(None)], True)
                    ).count() == 0


# ---------------------------------------------------------------------------
# explode and explode_outer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("outer", [False, True])
def test_explode_array_cells(policy, outer):
    """Empty and null array cells: explode drops the row, explode_outer
    keeps one row with a null element."""
    j, t = both(50, seed=3, keep=lambda E: E.col("k") != 2)
    got = t.select("k", "name",
                   (TF.explode_outer if outer else TF.explode)("tags")
                   .alias("tag"))
    want = j.select("k", "name",
                    (JF.explode_outer if outer else JF.explode)("tags")
                    .alias("tag"))
    assert_same(got, want, 0.0)
    assert got.num_slots == got.count()
    nulls = sum(1 for c in t.to_pydict()["tags"] if not c)
    assert (None in got.to_pydict()["tag"].tolist()) == (outer and nulls > 0)


def test_explode_of_split_numbers_and_the_source_column():
    cols = {"g": np.asarray([3, 1, 2], np.int32),
            "p": np.asarray([23.24, 29.77, 29.91])}
    for policy_dtype in (torch.float64, torch.float32):
        with float_policy(policy_dtype):
            t = TFrame(dict(cols), device="cpu")
            pair = t.select_expr("g", "concat_ws(',', g, p) AS s")
            out = pair.select("g", "s", TF.explode(
                TF.split(TF.col("s"), ",")).alias("v"))
            assert out.count() == 6 and out.columns == ["g", "s", "v"]
            assert [float(v) for v in out.to_pydict()["v"]] == pytest.approx(
                [3, 23.24, 1, 29.77, 2, 29.91], rel=1e-6)
    j = JFrame(dict(cols))
    want = j.select_expr("g", "concat_ws(',', g, p) AS s").select(
        "g", JF.explode(JF.split(JF.col("s"), ",")).alias("v"))
    with float_policy(torch.float64):
        got = TFrame(dict(cols), device="cpu").select_expr(
            "g", "concat_ws(',', g, p) AS s").select(
            "g", TF.explode(TF.split(TF.col("s"), ",")).alias("v"))
        assert_same(got, want, 0.0)


def test_explode_rejects_a_plain_column_and_two_generators():
    _, t = both(5)
    with pytest.raises(ValueError, match="array column"):
        t.select(TF.explode("name"))
    with pytest.raises(ValueError, match="array column"):
        t.select(TF.explode("v"))
    with pytest.raises(ValueError, match="one explode"):
        t.select(TF.explode("tags"), TF.explode_outer("tags"))
    with pytest.raises(ValueError, match="generator"):
        TF.explode("tags").eval(t)


# ---------------------------------------------------------------------------
# String keys
# ---------------------------------------------------------------------------

def _aggs(A):
    return [A.count(), A.count("v"), A.sum("v"), A.avg("v"), A.min("v"),
            A.max("v"), A.stddev("v"), A.first("v"), A.last("k")]


@pytest.mark.parametrize("keys", [("name",), ("k", "name"), ("name", "k")])
def test_group_by_string_keys_nulls_first(policy, keys):
    j, t = both(120, seed=7, keep=lambda E: E.col("v") > 0)
    got = t.group_by(*keys).agg(*_aggs(TA))
    want = j.group_by(*keys).agg(*_aggs(JA))
    assert_same(got, want, policy, ("sum(v)", "avg(v)", "stddev(v)"))
    names = got.to_pydict()["name"].tolist()
    if keys == ("name",):
        assert names[0] is None and names[1:] == sorted(names[1:])


SORTS = {
    "asc": lambda E: ("name",),
    "asc_then_desc_number": lambda E: ("name", E.col("v").desc()),
    "nulls_last": lambda E: (E.col("name").asc_nulls_last(), "k"),
    "number_then_name": lambda E: ("k", "name"),
}


@pytest.mark.parametrize("how", sorted(SORTS))
def test_sort_by_string_keys(policy, how):
    j, t = both(70, seed=8, keep=lambda E: E.col("k") > 0)
    got, want = t.sort(*SORTS[how](TE)), j.sort(*SORTS[how](JE))
    assert_same(got, want, 0.0)
    if how == "nulls_last":
        names = got.to_pydict()["name"].tolist()
        assert names[-1] is None and names[0] is not None


def test_descending_string_sort_raises_in_both():
    j, t = both(5)
    with pytest.raises(ValueError, match="descending"):
        t.sort(TE.col("name").desc())
    with pytest.raises(ValueError, match="descending"):
        j.sort(JE.col("name").desc())


@pytest.mark.parametrize("subset", [None, ["name"], ["name", "k"]])
def test_distinct_and_drop_duplicates_on_strings(policy, subset):
    j, t = both(90, seed=9, keep=lambda E: E.col("k") < 3)
    j, t = j.select("name", "k"), t.select("name", "k")
    if subset is None:
        assert_same(t.distinct(), j.distinct(), 0.0)
    else:
        assert_same(t.drop_duplicates(subset), j.drop_duplicates(subset),
                    0.0)


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer",
                                 "left_semi", "left_anti"])
def test_join_on_string_keys_shares_one_dictionary(policy, how):
    """A null key meets a null key, as in the JAX package's dict plan."""
    j, t = both(40, seed=11, keep=lambda E: E.col("k") < 3)
    rj, rt = both(25, seed=12)
    got = t.select("name", "v").join(rt.select("name", "k"), "name", how)
    want = j.select("name", "v").join(rj.select("name", "k"), "name", how)
    assert_same(got, want, 0.0)


@pytest.mark.parametrize("fn", ["row_number", "rank", "dense_rank"])
def test_window_partitioned_by_a_string(policy, fn):
    j, t = both(80, seed=13, keep=lambda E: E.col("v") > 2)
    got = t.with_column("r", getattr(TF, fn)().over(
        TW.partition_by("name").order_by("v")))
    want = j.with_column("r", getattr(JF, fn)().over(
        JW.partition_by("name").order_by("v")))
    assert_same(got, want, 0.0)


def test_descending_string_window_order_raises():
    j, t = both(5)
    with pytest.raises(ValueError, match="descending"):
        t.with_column("r", TF.row_number().over(
            TW.partition_by("k").order_by(TE.col("name").desc())))
    with pytest.raises(ValueError, match="descending"):
        j.with_column("r", JF.row_number().over(
            JW.partition_by("k").order_by(JE.col("name").desc())))


EMPTY_VERBS = {
    "group_by": lambda f, E, F, A, W: f.group_by("name").agg(A.count(),
                                                             A.avg("v")),
    "distinct": lambda f, E, F, A, W: f.select("name", "k").distinct(),
    "drop_duplicates": lambda f, E, F, A, W: f.drop_duplicates(["name"]),
    "sort": lambda f, E, F, A, W: f.sort("name"),
    "join": lambda f, E, F, A, W: f.select("name", "v").join(
        f.select("name", "k"), "name", "left"),
    "explode": lambda f, E, F, A, W: f.select("k", F.explode("tags")),
    "window": lambda f, E, F, A, W: f.with_column(
        "r", F.row_number().over(W.partition_by("name").order_by("v"))),
}


@pytest.mark.parametrize("verb", sorted(EMPTY_VERBS))
@pytest.mark.parametrize("rows", [0, 12])
def test_empty_and_all_masked_frames(policy, verb, rows):
    """No row slot, or every slot masked out: the same columns and
    dtypes as the JAX package's answer (its host paths build float
    columns where they rebuild the frame from row lists)."""
    j, t = both(rows, seed=14, keep=lambda E: E.col("k") > 9)
    assert t.count() == 0
    run(EMPTY_VERBS[verb], j, t)


def test_dictionary_codes_follow_python_order():
    cells = np.asarray(["b", None, "B", "a", "é", "", "b"], dtype=object)
    codes, words = strings.codes(cells)
    assert words == sorted({"b", "B", "a", "é", ""})
    assert codes.dtype == np.int32
    assert codes.tolist() == [words.index("b"), strings.NULL_CODE,
                              words.index("B"), words.index("a"),
                              words.index("é"), words.index(""),
                              words.index("b")]
    assert strings.decode(torch.as_tensor(codes), words).tolist() == \
        cells.tolist()
    assert strings.codes(cells)[0] is codes          # encoded once
    other = np.asarray(["c", "a", None], dtype=object)
    (a, b), shared = strings.shared_codes(cells, other)
    assert shared == sorted(set(words) | {"c"})
    assert strings.decode(a, shared).tolist() == cells.tolist()
    assert strings.decode(b, shared).tolist() == other.tolist()
    with pytest.raises(NotImplementedError, match="string"):
        strings.codes(np.asarray([1.5, "a"], dtype=object))
    with pytest.raises(NotImplementedError, match="array cells"):
        strings.codes(np.asarray([["a"], None], dtype=object))
