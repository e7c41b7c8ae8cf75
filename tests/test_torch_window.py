"""Window functions of the torch port (``frame/window.py``) against the
JAX package's on the same seeded numpy columns: every ranking, offset,
value and windowed-aggregate function, the default frames, ROWS and RANGE
frames, ties and NULLs in the order key, NULL partition keys and masked
rows, under both float policies (the float32 one with the JAX package's
x64 off, as on a TPU).

Tolerance: exact. Both packages plan and evaluate windows with the same
numpy code in float64 on the host and cast the result to the policy's
dtype, so names, dtypes and values must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu import functions as JF
from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame import window as JW
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import compiler as jax_compiler
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu.ops import segments as jax_segments
from sparkdq4ml_tpu_torch import functions as TF
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame import window as TW
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import expressions as TE

U = TW.Window.unbounded_preceding
UF = TW.Window.unbounded_following


@pytest.fixture(params=["float64", "float32"])
def policy(request):
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, request.param)
    clear_jax_plans()
    try:
        with jax.enable_x64(request.param == "float64"), \
                float_policy(getattr(torch, request.param)):
            yield
    finally:
        jax_config.default_float_dtype = old
        clear_jax_plans()


def clear_jax_plans():
    """The JAX package's plan caches key on the float policy, not on x64:
    drop them around a policy switch so no plan outlives its mode."""
    jax_segments.clear_cache()
    jax_compiler.clear_cache()


def frames(seed, n=60):
    """Partitions with a NULL key, an order key with ties and NULLs, an
    int value column and masked rows."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.float64)
    g[rng.random(n) < 0.1] = np.nan
    o = rng.integers(0, 6, n).astype(np.float64)
    o[rng.random(n) < 0.15] = np.nan
    v = rng.normal(size=n)
    v[rng.random(n) < 0.2] = np.nan
    cols = {"g": g, "o": o, "v": v,
            "i": rng.integers(-5, 5, n).astype(np.int32)}
    j, t = JFrame(cols), TFrame(cols, device="cpu")
    return j.filter(JE.col("i") > -4), t.filter(TE.col("i") > -4)


def assert_same(got, want):
    assert got.columns == want.columns
    assert got.dtypes() == want.dtypes()
    dg, dw = got.to_pydict(), want.to_pydict()
    for c in want.columns:
        a, b = np.asarray(dg[c]), np.asarray(dw[c])
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(a, b, err_msg=c)


FUNCS = {
    "row_number": lambda F: F.row_number(),
    "rank": lambda F: F.rank(),
    "dense_rank": lambda F: F.dense_rank(),
    "percent_rank": lambda F: F.percent_rank(),
    "cume_dist": lambda F: F.cume_dist(),
    "ntile": lambda F: F.ntile(3),
    "lag": lambda F: F.lag("v", 1),
    "lag2_default": lambda F: F.lag("i", 2, 0),
    "lead": lambda F: F.lead("v"),
    "first_value": lambda F: F.first_value("v"),
    "last_value": lambda F: F.last_value("v"),
    "nth_value": lambda F: F.nth_value("v", 2),
    "count": lambda F: F.count("v"),
    "count_star": lambda F: F.count(),
    "sum": lambda F: F.sum("v"),
    "avg": lambda F: F.avg("i"),
    "min": lambda F: F.min("v"),
    "max": lambda F: F.max("v"),
}
AGGS = ("count", "count_star", "sum", "avg", "min", "max")


def spec(W, order_desc=False):
    o = ("o", False) if order_desc else "o"
    return W.Window.partition_by("g").order_by(o, "i")


@pytest.mark.parametrize("fn", sorted(FUNCS))
@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
def test_every_function_default_frame(policy, fn, desc):
    j, t = frames(3)
    want = j.with_column("w", FUNCS[fn](JF).over(spec(JW, desc)))
    got = t.with_column("w", FUNCS[fn](TF).over(spec(TW, desc)))
    assert_same(got, want)


@pytest.mark.parametrize("fn", ["sum", "avg", "min", "max", "count",
                                "first_value", "last_value", "nth_value"])
@pytest.mark.parametrize("frame", [("rows", -2, 0), ("rows", -1, 1),
                                   ("rows", U, 0), ("rows", 0, UF),
                                   ("rows", 1, 3), ("range", U, 0),
                                   ("range", 0, UF), ("range", U, UF)])
def test_rows_and_range_frames(policy, fn, frame):
    j, t = frames(7)
    kind, lo, hi = frame

    def bound(W):
        s = spec(W)
        return (s.rows_between(lo, hi) if kind == "rows"
                else s.range_between(lo, hi))
    want = j.with_column("w", FUNCS[fn](JF).over(bound(JW)))
    got = t.with_column("w", FUNCS[fn](TF).over(bound(TW)))
    assert_same(got, want)


@pytest.mark.parametrize("fn", AGGS)
def test_unordered_partition_aggregates(policy, fn):
    j, t = frames(11)
    want = j.with_column("w", FUNCS[fn](JF).over(
        JW.Window.partition_by("g")))
    got = t.with_column("w", FUNCS[fn](TF).over(TW.Window.partition_by("g")))
    assert_same(got, want)


def test_sort_markers_and_names(policy):
    j, t = frames(2)
    want = j.select("g", "o", JF.rank().over(
        JW.Window.partition_by("g").order_by(JE.col("o").desc())))
    got = t.select("g", "o", TF.rank().over(
        TW.Window.partition_by("g").order_by(TE.col("o").desc())))
    assert_same(got, want)
    assert got.columns[-1] == "rank() OVER (PARTITION BY g ORDER BY o DESC)"


def test_window_column_lives_on_the_frame_device():
    with float_policy(torch.float64):
        _, t = frames(1)
        out = TF.dense_rank().over(spec(TW)).eval(t)
        assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
        assert out.shape == (t.num_slots,)


def test_one_plan_serves_a_spec_until_the_frame_changes(monkeypatch):
    """Window expressions over one frame and spec share one host lexsort;
    a new mask (a filter) or another spec plans again."""
    sorts = []
    real = np.lexsort
    monkeypatch.setattr(np, "lexsort", lambda keys: sorts.append(1) or
                        real(keys))
    with float_policy(torch.float64):
        _, t = frames(5)
        w = spec(TW)
        got = (t.with_column("a", TF.rank().over(w))
               .with_column("b", TF.lag("v").over(w)))
        assert len(sorts) == 1
        t.with_column("c", TF.rank().over(spec(TW, True)))
        assert len(sorts) == 2
        u = t.filter(TE.col("i") < 3)
        again = u.with_column("a", TF.rank().over(w))
        assert len(sorts) == 3
    j, _ = frames(5)
    want = j.filter(JE.col("i") < 3).with_column(
        "a", JF.rank().over(spec(JW)))
    assert_same(again, want)
    assert got.columns[-2:] == ["a", "b"]


def test_outside_the_subset_raises():
    with float_policy(torch.float64):
        t = TFrame({"s": ["a", "b"], "v": [1.0, 2.0]}, device="cpu")
        with pytest.raises(ValueError, match="string"):
            t.with_column("w", TF.sum("s").over(
                TW.Window.partition_by("v").order_by("v")))
        with pytest.raises(ValueError, match="descending"):
            t.with_column("w", TF.rank().over(
                TW.Window.partition_by("v").order_by(TE.col("s").desc())))
        with pytest.raises(ValueError, match="ORDER BY"):
            TF.rank().over(TW.Window.partition_by("v"))
