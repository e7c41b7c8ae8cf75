"""The frame and SQL surface the torch port closed after its SQL slices,
held against the JAX package on the CPU under both float policies: CAST to
``long`` and ``boolean`` (numbers, strings and an applyInPandas schema);
windows over string value columns (``lag``/``lead``, the value functions,
``COUNT``); the Frame methods ``to_df``, ``with_columns_renamed``,
``transform``, ``replace``/``na.replace``, ``col_regex``, ``alias``,
``tail``, ``is_empty``, ``schema``, ``create_temp_view``, ``to_csv``,
``to_json``, ``foreach``, ``foreach_partition`` and the no-op verbs; the
Column methods ``rlike``, ``contains``, ``startswith``, ``endswith``,
``ilike``, ``eq_null_safe``, ``substr``, ``get_item`` and ``astype``; and
``Catalog.list_tables``. The data holds NaN, None, -0.0 and ties.

Tolerance: everything exact (names, dtypes, values, signs of zeros); the
JAX side runs with x64 off under the float32 policy.
"""

import numpy as np
import pytest
import torch
from test_torch_grouped import assert_same, policy  # noqa: F401

from sparkdq4ml_tpu import functions as JF
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.frame.window import Window as JW
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu.sql import catalog as jcat
from sparkdq4ml_tpu_torch import functions as TF
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.frame.window import Window as TW
from sparkdq4ml_tpu_torch.interop import string_columns
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.sql import catalog as tcat

PORT = (TE, TF, TW)
JAX = (JE, JF, JW)


def table(n=48, seed=3):
    """The seeded string table, with a float column ``x`` holding NaN,
    -0.0, 0.0, ties and values past the int32 range, and an int column."""
    cols = string_columns(n, seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.choice([np.nan, -0.0, 0.0, 1.5, -2.7, 2.0, 3e9, -3e9, 1e300,
                    7.0], n)
    cols["x"] = x
    cols["i"] = rng.integers(-3, 4, n).astype(np.int32)
    cols["s"] = np.asarray(rng.choice(np.asarray(
        ["true", "no", " 1 ", "y", "maybe", "0", None, "42", "-7", "3.9"],
        dtype=object), n), dtype=object)
    return cols


def both(keep=None, **kw):
    cols = table(**kw)
    j, t = JFrame(dict(cols)), TFrame(dict(cols), device="cpu")
    if keep is not None:
        j, t = j.filter(keep(JE)), t.filter(keep(TE))
    return j, t


def run(fn, keep=None):
    j, t = both(keep)
    assert_same(fn(t, *PORT), fn(j, *JAX), 0.0)


# ---------------------------------------------------------------------------
# CAST to long and boolean
# ---------------------------------------------------------------------------

CASTS = [(c, ty) for c in ("x", "i", "v", "k", "s", "name")
         for ty in ("long", "boolean")]


@pytest.mark.parametrize("column,type_name", CASTS)
def test_cast_to_long_and_boolean(policy, column, type_name):
    def fn(f, E, F, W):
        return f.select(E.col(column).cast(type_name).alias("c"))
    run(fn)


@pytest.mark.parametrize("type_name", ["long", "boolean", "int"])
def test_cast_in_sql_and_astype(policy, type_name):
    j, t = both()
    got = t.select_expr(f"CAST(x AS {type_name}) AS a",
                        f"cast(i as {type_name.upper()}) AS b")
    want = j.select_expr(f"CAST(x AS {type_name}) AS a",
                         f"cast(i as {type_name.upper()}) AS b")
    assert_same(got, want, 0.0)
    assert_same(t.select(TE.col("x").astype(type_name).alias("c")),
                j.select(JE.col("x").astype(type_name).alias("c")), 0.0)


@pytest.mark.parametrize("schema", ["k LONG, v DOUBLE, b BOOLEAN",
                                    "k long, v float, b boolean"])
def test_apply_in_pandas_schema_takes_long_and_boolean(policy, schema):
    def fn(pdf):
        out = pdf[["k", "v"]].copy()
        out["b"] = out["v"] > 10
        return out

    j, t = both(keep=lambda E: E.col("v").is_not_null())
    got = t.group_by("k").apply_in_pandas(fn, schema).sort("k", "v")
    want = j.group_by("k").apply_in_pandas(fn, schema).sort("k", "v")
    assert_same(got, want, 0.0)
    got = t.select("k", "v").map_in_pandas(
        lambda it: (fn(p) for p in it), schema)
    want = j.select("k", "v").map_in_pandas(
        lambda it: (fn(p) for p in it), schema)
    assert_same(got, want, 0.0)


# ---------------------------------------------------------------------------
# windows over string value columns
# ---------------------------------------------------------------------------

STRING_WINDOWS = {
    "lag": lambda F: F.lag("name"),
    "lag2_default": lambda F: F.lag("name", 2, "none"),
    "lead": lambda F: F.lead("name"),
    "lead0": lambda F: F.lead("name", 0),
    "first_value": lambda F: F.first_value("name"),
    "last_value": lambda F: F.last_value("name"),
    "nth_value": lambda F: F.nth_value("name", 2),
    "count": lambda F: F.count("name"),
}


# lag and lead need an ORDER BY (both packages raise without one)
WINDOW_CASES = [(name, ordered) for name in sorted(STRING_WINDOWS)
                for ordered in (True, False)
                if ordered or not name.startswith(("lag", "lead"))]


@pytest.mark.parametrize("name,ordered", WINDOW_CASES)
def test_window_over_a_string_value_column(policy, name, ordered):
    def fn(f, E, F, W):
        spec = W.partition_by("k")
        if ordered:
            spec = spec.order_by("v", "i")
        return f.with_column("w", STRING_WINDOWS[name](F).over(spec))
    run(fn, keep=lambda E: E.col("i") != 0)


def test_window_over_strings_with_a_frame_and_in_sql(policy):
    def fn(f, E, F, W):
        spec = W.partition_by("k").order_by("v").rows_between(-1, 1)
        return f.with_column("w", F.last_value("name").over(spec))
    run(fn)
    j, t = both()
    t.create_or_replace_temp_view("s")
    from sparkdq4ml_tpu.sql.catalog import default_catalog as jdefault
    from sparkdq4ml_tpu.sql.parser import execute as jexecute
    from sparkdq4ml_tpu_torch.sql import execute as texecute

    jdefault().register("s", j)
    q = ("SELECT k, name, LAG(name) OVER (PARTITION BY k ORDER BY v) AS p, "
         "COUNT(name) OVER (PARTITION BY k) AS c FROM s")
    try:
        assert_same(texecute(q), jexecute(q), 0.0)
    finally:
        tcat.default_catalog().clear()


def test_a_sum_over_strings_raises_in_both():
    j, t = both()
    for f, F, W in ((t, TF, TW), (j, JF, JW)):
        with pytest.raises(ValueError, match="string"):
            f.with_column("w", F.sum("name").over(
                W.partition_by("k").order_by("v")))


# ---------------------------------------------------------------------------
# Frame methods
# ---------------------------------------------------------------------------

FRAME_CALLS = {
    "to_df": lambda f, E, F, W: f.select("k", "v").to_df("a", "b"),
    "toDF": lambda f, E, F, W: f.select("x", "name").toDF("p", "q"),
    "renamed": lambda f, E, F, W: f.with_columns_renamed(
        {"k": "key", "v": "value", "absent": "zz"}),
    "renamed_swap": lambda f, E, F, W: f.withColumnsRenamed(
        {"k": "v", "v": "k"}),
    "transform": lambda f, E, F, W: f.transform(
        lambda g, c: g.filter(E.col(c) > 1), "v").transform(
            lambda g: g.select("k", "name")),
    "replace_num": lambda f, E, F, W: f.replace(0.0, 5.0, subset=["x"]),
    "replace_int_widens": lambda f, E, F, W: f.replace(2, 2.5, ["i", "k"]),
    "replace_int_keeps": lambda f, E, F, W: f.replace([1, 3], 9,
                                                      subset=["i"]),
    "replace_lists": lambda f, E, F, W: f.replace([1.5, 7.0], [-1.0, None],
                                                  subset=["x"]),
    "replace_null_widens": lambda f, E, F, W: f.replace({1: None},
                                                        subset=["i"]),
    "replace_strings": lambda f, E, F, W: f.replace(
        {"amber": "AMBER", "fir": None, 2: 20}, subset=["name", "s", "k"]),
    "na_replace": lambda f, E, F, W: f.na.replace("delta", "d", ["name"]),
    "col_regex": lambda f, E, F, W: f.select(f.col_regex("`[kv]`")),
    "colRegex": lambda f, E, F, W: f.select(f.colRegex("n.*"), "x"),
    "alias": lambda f, E, F, W: f.alias("t").select("k"),
    "noops": lambda f, E, F, W: f.cache().persist().unpersist()
    .repartition(4, "k").coalesce(1).hint("broadcast").checkpoint()
    .localCheckpoint(),
}


@pytest.mark.parametrize("name", sorted(FRAME_CALLS))
def test_frame_methods(policy, name):
    run(FRAME_CALLS[name], keep=lambda E: E.col("i") != -3)


def test_rename_collisions_and_to_df_checks_raise_in_both():
    j, t = both()
    for f in (t, j):
        with pytest.raises(ValueError, match="collides"):
            f.with_columns_renamed({"k": "v"})
        with pytest.raises(ValueError, match="toDF expects"):
            f.to_df("a")
        with pytest.raises(ValueError, match="unique"):
            f.select("k", "v").to_df("a", "a")
        with pytest.raises(TypeError, match="must return a Frame"):
            f.transform(lambda g: 1)


def test_actions(policy):
    j, t = both(keep=lambda E: E.col("k") > 1)
    assert t.tail(4) == j.tail(4) and t.tail(0) == j.tail(0) == []
    assert t.is_empty() is j.is_empty() is False
    assert t.isEmpty() is False
    empty = (t.filter(TE.col("k") > 99), j.filter(JE.col("k") > 99))
    assert empty[0].is_empty() is empty[1].is_empty() is True
    assert t.schema == j.schema
    assert t.select("k", "x", "name").to_json() == \
        j.select("k", "x", "name").to_json()
    assert t.toJSON()[:3] == j.toJSON()[:3]
    seen = {"t": [], "j": [], "tp": [], "jp": []}
    t.foreach(seen["t"].append)
    j.foreach(seen["j"].append)
    t.foreach_partition(lambda it: seen["tp"].extend(it))
    j.foreachPartition(lambda it: seen["jp"].extend(it))
    key = lambda rows: [repr(r) for r in rows]
    assert key(seen["t"]) == key(seen["j"]) == key(seen["tp"]) == \
        key(seen["jp"])
    assert t.alias("a")._alias == "a"


def test_to_csv_writes_the_same_file(policy, tmp_path):
    j, t = both(keep=lambda E: E.col("k") < 3)
    t.select("k", "v", "name").to_csv(str(tmp_path / "t"), header=True)
    j.select("k", "v", "name").to_csv(str(tmp_path / "j"), header=True)

    def read(d):
        return sorted((p.name, p.read_text()) for p in d.rglob("*")
                      if p.is_file())

    got, want = read(tmp_path / "t"), read(tmp_path / "j")
    assert [text for _, text in got] == [text for _, text in want]


def test_create_temp_view_and_list_tables():
    j, t = both()
    tc, jc = tcat.default_catalog(), jcat.default_catalog()
    tc.clear()
    try:
        t.create_temp_view("first_t")
        j.createTempView("first_t")
        for f in (t, j):
            with pytest.raises(ValueError, match="already exists"):
                f.create_temp_view("FIRST_T")
        t.createTempView("b_view")
        j.create_temp_view("b_view")
        assert tc.list_tables() == [tcat.Table("b_view", True),
                                    tcat.Table("first_t", True)]
        assert [tuple(x) for x in tc.listTables()] == \
            [tuple(x) for x in jc.list_tables()]
        assert [x.name for x in tc.list_tables()] == tc.list_views()
        assert all(x.isTemporary for x in tc.list_tables())
    finally:
        tc.clear()
        jc.clear()


# ---------------------------------------------------------------------------
# Column methods
# ---------------------------------------------------------------------------

COLUMN_CALLS = {
    "rlike": lambda E: E.col("name").rlike("^[a-d]"),
    "rlike_num": lambda E: E.col("x").rlike(r"\.5"),
    "contains": lambda E: E.col("name").contains("e"),
    "startswith": lambda E: E.col("name").startswith("b"),
    "endswith": lambda E: E.col("name").endswith("a"),
    "ilike": lambda E: E.col("name").ilike("B%"),
    "eq_null_safe_num": lambda E: E.col("x").eq_null_safe(E.col("v")),
    "eq_null_safe_lit": lambda E: E.col("x").eqNullSafe(0.0),
    "eq_null_safe_str": lambda E: E.col("name").eq_null_safe(E.col("s")),
    "substr": lambda E: E.col("name").substr(2, 3),
    "substr_cols": lambda E: E.col("name").substr(E.col("k"), E.col("i")),
    "get_item": lambda E: E.col("tags").get_item(1),
    "getItem": lambda E: E.col("tags").getItem(-1),
    "astype": lambda E: E.col("v").astype("int"),
}


@pytest.mark.parametrize("name", sorted(COLUMN_CALLS))
def test_column_methods(policy, name):
    run(lambda f, E, F, W: f.select(COLUMN_CALLS[name](E).alias("c")))


@pytest.mark.parametrize("name", ["rlike", "contains", "startswith",
                                  "endswith", "ilike"])
def test_string_predicates_filter_the_same_rows(policy, name):
    run(lambda f, E, F, W: f.filter(COLUMN_CALLS[name](E)))
    run(lambda f, E, F, W: f.filter(~COLUMN_CALLS[name](E)))
