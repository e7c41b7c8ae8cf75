"""The higher-order functions (``transform``, ``filter``, ``exists``,
``aggregate``) and the generators (``posexplode``, ``explode`` with
positions, ``json_tuple``) of the torch port against the JAX package's,
fluent and through SQL lambdas, under both float policies: outer columns
in a lambda body, null cells and null elements, string elements, a finish
lambda, exists' three-valued answer, and the scope frame that repeats only
the columns a body reads (numeric ones on the frame's device).

Tolerance: exact (host cells by type and value; numeric results by dtype
and bits).
"""

import numpy as np
import pytest
import torch
from test_torch_builtins_parity import assert_same_result, cells
from test_torch_grouped import policy  # noqa: F401

from sparkdq4ml_tpu import functions as JF
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu_torch import functions as TF
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import expressions as TE


def table():
    return {"k": np.arange(7, dtype=np.int32),
            "w": np.asarray([0.5, 2.0, np.nan, -1.0, 3.0, 1.0, 10.0]),
            "arr": cells([[1, 2, 3], [], None, [4, None, 6], [7], [1.5, -2.5],
                          [0, 0]]),
            "txt": cells([["a", "bb"], ["c"], [], None, ["dd", None],
                          ["e", "f", "g"], [""]]),
            "unused": cells([[9]] * 7)}


def both(cols=None):
    cols = table() if cols is None else cols
    return JFrame(dict(cols)), TFrame(dict(cols), device="cpu")


def assert_frames(got, want):
    assert got.columns == want.columns
    dg, dw = got.to_pydict(), want.to_pydict()
    for c in want.columns:
        assert_same_result(dg[c], dw[c], what=c)


FLUENT = {
    "transform_outer": lambda F: F.transform("arr", lambda x: x * F.col("w")
                                             + F.col("k")),
    "transform_strings": lambda F: F.transform("txt", lambda x: F.upper(x)),
    "filter_numbers": lambda F: F.filter("arr", lambda x: x > 1),
    "filter_strings": lambda F: F.filter("txt", lambda x: F.length(x) > 1),
    "exists": lambda F: F.exists("arr", lambda x: x > 5),
    "exists_isnull": lambda F: F.exists("arr", lambda x: x.isNull()),
    "exists_coalesce": lambda F: F.exists("arr",
                                          lambda x: F.coalesce(x, 0.0) > 5),
    "aggregate_sum": lambda F: F.aggregate("arr", 0, lambda a, x: a + x),
    "aggregate_finish": lambda F: F.aggregate(
        "arr", 0.0, lambda a, x: a + x * F.col("w"), lambda a: a / 2),
    "aggregate_strings": lambda F: F.aggregate(
        "txt", F.lit(""), lambda a, x: F.concat(a, x)),
    "aggregate_int_acc": lambda F: F.aggregate("arr", F.col("k"),
                                               lambda a, x: a + 1),
}


@pytest.mark.parametrize("form", sorted(FLUENT))
def test_fluent_higher_order_matches_jax(policy, form):
    j, t = both()
    assert_frames(t.select("k", FLUENT[form](TF).alias("out")),
                  j.select("k", FLUENT[form](JF).alias("out")))


SQL = {
    "transform": "SELECT k, transform(arr, x -> x + k) AS out FROM t",
    "filter": "SELECT k, filter(arr, x -> x % 2 = 0) AS out FROM t",
    "exists": "SELECT k, exists(arr, x -> x IS NULL) AS out FROM t",
    "aggregate": "SELECT k, aggregate(arr, 0, (acc, x) -> acc + x, acc -> "
                 "acc * 2) AS out FROM t",
    "nested": "SELECT k, transform(filter(arr, x -> x > 0), x -> x * w) AS "
              "out FROM t",
    "shadowing": "SELECT k, transform(arr, k -> k * 10) AS out FROM t",
}


@pytest.mark.parametrize("form", sorted(SQL))
def test_sql_lambdas_match_jax(policy, form, session):
    from sparkdq4ml_tpu_torch import TorchSession
    from sparkdq4ml_tpu_torch.sql import default_catalog

    port = TorchSession.builder().config("spark.torch.device",
                                         "cpu").get_or_create()
    try:
        j, t = both()
        j.create_or_replace_temp_view("t")
        t.create_or_replace_temp_view("t")
        assert_frames(port.sql(SQL[form]), session.sql(SQL[form]))
    finally:
        port.stop()
        default_catalog().clear()


def test_scope_frame_repeats_only_the_columns_the_body_reads(monkeypatch):
    seen = []
    real = TE._scope_frame

    def spy(parent, lens, bindings, needed=None):
        frame = real(parent, lens, bindings, needed)
        seen.append(frame)
        return frame

    monkeypatch.setattr(TE, "_scope_frame", spy)
    _, t = both()
    t.select(TF.transform("arr", lambda x: x * TF.col("w")).alias("o")
             ).collect()
    (scope,) = seen
    assert set(scope.columns) == {"w", scope.columns[-1]}
    assert isinstance(scope._column_values("w"), torch.Tensor)
    assert scope.num_slots == 11             # 3 + 0 + 0 + 3 + 1 + 2 + 2
    seen.clear()
    t.select(TF.transform("txt", lambda x: TF.upper(x)).alias("o")).collect()
    (scope,) = seen
    assert isinstance(scope._column_values(scope.columns[-1]), np.ndarray)


def test_lambda_arity_is_checked():
    lam = TE.Lambda(["a"], TE.col("a"))
    with pytest.raises(ValueError, match="parameter"):
        TE.HigherOrder("aggregate", "arr", lam)
    with pytest.raises(ValueError, match="unknown"):
        TE.HigherOrder("reduce", "arr", lam)


GENERATORS = {
    "posexplode": lambda F: F.posexplode("arr"),
    "posexplode_strings": lambda F: F.posexplode("txt"),
    "posexplode_split": lambda F: F.posexplode(F.split(F.lit("a,b,c"),
                                                       ",")),
    "explode_alias": lambda F: F.explode("arr").alias("v"),
    "explode_outer": lambda F: F.explode_outer("txt"),
}


@pytest.mark.parametrize("form", sorted(GENERATORS))
def test_generators_in_select_match_jax(policy, form):
    j, t = both()
    assert_frames(t.select("k", GENERATORS[form](TF)),
                  j.select("k", GENERATORS[form](JF)))


@pytest.mark.parametrize("keep_nulls", [False, True])
def test_explode_with_a_position_column(policy, keep_nulls):
    j, t = both()
    got = t.explode("txt", "v", keep_nulls=keep_nulls, position_col="p")
    want = j.explode("txt", "v", keep_nulls=keep_nulls, position_col="p")
    assert got.columns[-2:] == ["p", "v"]
    assert_frames(got, want)
    with pytest.raises(ValueError, match="collides"):
        t.explode("txt", "v", position_col="k")


def test_json_tuple_expands_in_place(policy):
    cols = {"k": np.arange(4, dtype=np.int32),
            "js": cells(['{"a": 1, "b": "x", "c": [1, 2]}', None, "bad",
                         '{"b": true}'])}
    j, t = both(cols)
    assert_frames(t.select("k", TF.json_tuple("js", "a", "b", "c"), "js"),
                  j.select("k", JF.json_tuple("js", "a", "b", "c"), "js"))
    with pytest.raises(ValueError, match="generator"):
        TF.json_tuple("js", "a").eval(t)
    with pytest.raises(ValueError, match="at least one"):
        TF.json_tuple("js")


def test_one_generator_a_select():
    _, t = both()
    with pytest.raises(ValueError, match="one explode"):
        t.select(TF.explode("arr"), TF.posexplode("txt"))
    with pytest.raises(ValueError, match="generator"):
        TF.posexplode("arr").eval(t)
