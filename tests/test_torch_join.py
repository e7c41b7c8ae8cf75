"""``Frame.join`` of the torch port against the JAX package's on the same
seeded numpy columns: every join type, empty left and right sides,
duplicate keys, one and two keys, int and float keys, the ``_right``
suffix, masked rows and NaN keys (which never match), under the float64
policy.

Tolerance: exact. A join moves values and fills NaN; it computes nothing,
so row order, column names, dtypes and every value must be identical.
"""

import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import expressions as TE

HOWS = ["inner", "left", "right", "outer", "full", "left_semi", "left_anti",
        "cross"]


@pytest.fixture(autouse=True)
def _float64():
    with float_policy(torch.float64):
        yield


def both(cols, where=None):
    j, t = JFrame(dict(cols)), TFrame(dict(cols), device="cpu")
    if where is not None:
        j, t = j.filter(where(JE)), t.filter(where(TE))
    return j, t


def assert_same(got, want):
    assert got.columns == want.columns
    assert got.dtypes() == want.dtypes()
    dg, dw = got.to_pydict(), want.to_pydict()
    for c in want.columns:
        a, b = np.asarray(dg[c]), np.asarray(dw[c])
        assert a.shape == b.shape and a.dtype == b.dtype, c
        np.testing.assert_array_equal(a, b, err_msg=c)


def sides(seed, nl=30, nr=12, float_keys=False):
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, 8, nl)
    rk = rng.integers(3, 11, nr)
    if float_keys:
        lk, rk = lk * 0.5, rk * 0.5
    left = {"k": lk.astype(np.float64 if float_keys else np.int32),
            "j": rng.integers(0, 2, nl).astype(np.int32),
            "x": rng.normal(size=nl), "v": rng.normal(size=nl)}
    right = {"k": rk.astype(np.float64 if float_keys else np.int32),
             "j": rng.integers(0, 2, nr).astype(np.int32),
             "v": rng.normal(size=nr), "c": rng.integers(0, 9, nr)}
    return (both(left, lambda E: E.col("x") > -1.0),
            both(right, lambda E: E.col("c") < 7))


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("seed", range(2))
def test_every_join_type_with_duplicates(how, seed):
    (jl, tl), (jr, tr) = sides(seed)
    on = None if how == "cross" else "k"
    assert_same(tl.join(tr, on, how), jl.join(jr, on, how))


@pytest.mark.parametrize("how", HOWS[:-1])
def test_two_keys_and_float_keys(how):
    (jl, tl), (jr, tr) = sides(5, float_keys=True)
    assert_same(tl.join(tr, ["k", "j"], how), jl.join(jr, ["k", "j"], how))
    assert_same(tl.join(tr, "k", how), jl.join(jr, "k", how))


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("empty", ["left", "right", "both"])
def test_empty_sides(how, empty):
    (jl, tl), (jr, tr) = sides(2)
    if empty in ("left", "both"):
        jl, tl = jl.filter(JE.col("x") > 99), tl.filter(TE.col("x") > 99)
    if empty in ("right", "both"):
        jr, tr = jr.filter(JE.col("c") > 99), tr.filter(TE.col("c") > 99)
    on = None if how == "cross" else "k"
    assert_same(tl.join(tr, on, how), jl.join(jr, on, how))


@pytest.mark.parametrize("how", HOWS[:-1])
def test_nan_keys_never_match(how):
    left = {"k": [1.0, np.nan, 2.0, np.nan, 3.0], "a": [1.0, 2, 3, 4, 5]}
    right = {"k": [np.nan, 2.0, np.nan, 1.0], "b": [10.0, 20, 30, 40]}
    jl, tl = both(left)
    jr, tr = both(right)
    got = tl.join(tr, "k", how)
    assert_same(got, jl.join(jr, "k", how))
    if how == "inner":
        assert got.to_pydict()["k"].tolist() == [1.0, 2.0]


def test_right_suffix_and_int_promotion_on_outer():
    jl, tl = both({"k": np.array([1, 2, 3], np.int32),
                   "v": np.array([5, 6, 7], np.int32)})
    jr, tr = both({"k": np.array([2, 4], np.int32),
                   "v": np.array([8, 9], np.int32)})
    got = tl.join(tr, "k", "outer")
    assert got.columns == ["k", "v", "v_right"]
    assert got.dtypes() == [("k", "double"), ("v", "double"),
                            ("v_right", "double")]
    assert_same(got, jl.join(jr, "k", "outer"))


def test_payload_gathers_stay_on_the_frame_device():
    (_, tl), (_, tr) = sides(1)
    out = tl.join(tr, "k", "left")
    assert out.device == torch.device("cpu") and out.mask.all()
    for c in out.columns:
        assert out._column_values(c).device == torch.device("cpu")


def test_outside_the_subset_raises():
    t = TFrame({"s": ["a", "b"], "v": [1.0, 2.0]}, device="cpu")
    with pytest.raises(NotImplementedError, match="1-D numeric"):
        t.join(t, "s")
    with pytest.raises(ValueError, match="unknown join type"):
        t.join(t, "v", "sideways")
