"""The traps of the builtin function library, each held against the JAX
package under both float policies (and against an independent answer
where one exists): ``sign`` of NaN and -0.0, ``cbrt`` of perfect cubes,
negatives, zeros and infinities, HALF_UP ``round`` at halfway values with
the product kept in the policy's float, float32 cells rendered as numpy
prints them, ``greatest``/``least`` promotion and null skipping,
``mod``/``pmod`` signs and zero divisors, 64-bit hashes under float32,
Spark's hash tail bytes, the once-per-distinct string paths, and a
host-computed numeric result placed on the frame's device.

Tolerance: exact.
"""

import numpy as np
import pytest
import torch
from test_torch_builtins_parity import RTOL as FN_RTOL
from test_torch_builtins_parity import assert_same_result, cells
from test_torch_grouped import policy  # noqa: F401

from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import cells as C
from sparkdq4ml_tpu_torch.ops import expressions as TE


def run(name, cols, *args, rtol=None):
    """``name`` over ``cols`` in both packages; ``args`` are column names
    or ('lit', value)."""
    j, t = JFrame(dict(cols)), TFrame(dict(cols), device="cpu")

    def make(E):
        return E.Func(name, [E.lit(a[1]) if isinstance(a, tuple)
                             else E.col(a) for a in args])

    got, want = make(TE).eval(t), make(JE).eval(j)
    assert_same_result(got, want, rtol, what=name)
    return got


def test_sign_keeps_nan_and_signed_zeros(policy):
    x = np.asarray([np.nan, -0.0, 0.0, -3.5, 2.0, -np.inf, np.inf])
    got = run("sign", {"x": x}, "x").numpy()
    assert np.isnan(got[0]) and np.signbit(got[1]) and not np.signbit(got[2])
    np.testing.assert_array_equal(got[3:], [-1, 1, -1, 1])


def test_cbrt_of_cubes_negatives_zeros_and_infinities(policy, request):
    """Exact on perfect cubes, where XLA's cbrt is 1 ulp off some (-1728
    in float32 gives -12.000001), so the JAX package is held within the
    parity test's transcendental tolerance; at 1e-300 XLA is 13 ulp off
    and the port gives math.cbrt's 1e-100."""
    fl = request.node.callspec.params["policy"]
    cubes = np.asarray([n ** 3 for n in range(-12, 13)], np.float64)
    x = np.concatenate([cubes, [np.nan, np.inf, -np.inf, -0.0, 2.0,
                                -0.001, 1e-30]])
    got = run("cbrt", {"x": x}, "x", rtol=FN_RTOL[fl]).numpy()
    np.testing.assert_array_equal(got[:25], np.arange(-12, 13))
    assert np.isnan(got[25]) and got[26] == np.inf and got[27] == -np.inf
    assert got[28] == 0 and np.signbit(got[28])
    if fl == "float64":
        t = TFrame({"x": np.asarray([1e-300, -8e-300])}, device="cpu")
        assert TE.Func("cbrt", [TE.col("x")]).eval(t).tolist() == [
            1e-100, -2e-100]


@pytest.mark.parametrize("digits", [0, 1, 2])
def test_round_half_up_and_bround_half_even(policy, digits):
    halves = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.25, 0.35, 2.675,
                         1.005, -1.005, 0.125, -0.125, 1e10 + 0.5, np.nan])
    up = run("round", {"x": halves}, "x", ("lit", digits))
    even = run("bround", {"x": halves}, "x", ("lit", digits))
    if digits == 0:
        np.testing.assert_array_equal(up.numpy()[:6], [1, 2, 3, -1, -2, -3])
        np.testing.assert_array_equal(even.numpy()[:6],
                                      [0, 2, 2, -0.0, -2, -2])


def test_float32_cells_render_as_numpy_prints_them():
    from sparkdq4ml_tpu_torch.config import float_policy

    with float_policy(torch.float32):
        t = TFrame({"x": np.asarray([0.1, 23.24, -0.0, np.nan, 1e-8])},
                   device="cpu")
        text = TE.Cast(TE.col("x"), "string").eval(t).tolist()
        assert text == ["0.1", "23.24", "-0.0", None, "1e-08"]
        lens = TE.Func("length", [TE.col("x")]).eval(t)
        assert lens.tolist()[:3] == [3.0, 5.0, 4.0] and lens.isnan()[3]
    # .item() of a float32 renders the widened double instead
    assert str(torch.tensor(0.1).item()) == "0.10000000149011612"


@pytest.mark.parametrize("fn", ["greatest", "least"])
def test_greatest_least_skip_nulls_and_promote_as_jnp(policy, fn):
    cols = {"i": np.asarray([1, 5, -2], np.int32),
            "j": np.asarray([3, 4, -7], np.int32),
            "x": np.asarray([np.nan, 4.5, np.nan]),
            "y": np.asarray([np.nan, np.nan, 1.0])}
    assert run(fn, cols, "i", "j").dtype == torch.int32
    run(fn, cols, "i", "x")
    run(fn, cols, "x", "y")
    run(fn, cols, "i", ("lit", 2.5))
    run(fn, cols, "x", ("lit", 3))
    got = run(fn, cols, "x", "y", "x")
    assert np.isnan(got.numpy()[0])


def test_mod_and_pmod_signs_and_zero_divisors(policy):
    cols = {"a": np.asarray([7.0, -7.0, 7.0, -7.0, 5.5, 0.0, 3.0, -0.0]),
            "b": np.asarray([3.0, 3.0, -3.0, -3.0, 0.0, 2.0, np.nan, 3.0])}
    mod = run("mod", cols, "a", "b").numpy()
    pmod = run("pmod", cols, "a", "b").numpy()
    np.testing.assert_array_equal(mod[:4], [1, -1, 1, -1])
    np.testing.assert_array_equal(pmod[:4], [1, 2, -2, -1])
    assert np.isnan(mod[4]) and np.isnan(pmod[4])


def test_64_bit_hashes_stay_exact_without_the_float64_policy(policy,
                                                             request):
    cols = {"s": cells(["", "a", "abcdefgh" * 5, None, "é€😀"]),
            "x": np.asarray([1.5, -0.0, np.nan, 2.0 ** 40, 0.1])}
    xh = run("xxhash64", cols, "s", "x")
    crc = run("crc32", cols, "s")
    wide = request.node.callspec.params["policy"] == "float64"
    assert isinstance(xh, torch.Tensor) == wide
    if not wide:
        assert all(isinstance(v, int) for v in xh)
        assert isinstance(crc, np.ndarray)
    assert run("hash", cols, "s", "x").dtype == torch.int32


def test_hash_tail_bytes_mix_as_signed_values():
    """Spark's hashUnsafeBytes: a multi-byte UTF-8 tail mixes each byte
    as a signed value, as the JAX package's copy of the JVM's does."""
    from sparkdq4ml_tpu_torch.ops import fn_hashes as H

    assert H._m3_hash_bytes("é".encode(), 42) != H._m3_hash_bytes(
        b"\x00\x00", 42)
    for text in ("", "a", "ab", "abc", "abcd", "abcde", "é", "日本"):
        from sparkdq4ml_tpu.ops import expressions as J

        assert H._m3_hash_bytes(text.encode(), 42) == \
            J._m3_hash_bytes(text.encode(), 42)
        assert H._xx_hash_bytes(text.encode() * 9, 42) == \
            J._xx_hash_bytes(text.encode() * 9, 42)


def test_distinct_row_paths_give_the_row_loops_cells():
    """``map_rows`` computes once per distinct row: the same cells as a
    row-by-row loop, a list result a cell of its own, a non-string cell
    falling back to the loop."""
    rng = np.random.default_rng(5)
    a = cells(rng.choice(["x", "yy", None, "", "x y"], 500).tolist())
    b = cells(rng.choice(["1", "22", None], 500).tolist())
    for fn, args in ((lambda s: None if s is None else s.split(" "), (a,)),
                     (lambda s, u: (s, u), (a, b)),
                     (lambda s: len(str(s)), (cells([1.5, "a", None]),))):
        got = C.map_rows(fn, *args)
        want = [fn(*row) for row in zip(*args)]
        assert got.shape == (len(want),) and list(got) == want


def test_string_cast_renders_once_per_distinct_bit_pattern():
    v = torch.tensor([0.0, -0.0, 1.5, float("nan"), 1.5, -0.0],
                     dtype=torch.float32)
    assert C.tensor_strings(v).tolist() == ["0.0", "-0.0", "1.5", None,
                                            "1.5", "-0.0"]
    assert C.tensor_strings(torch.tensor([3, -1, 3], dtype=torch.int32)
                            ).tolist() == ["3", "-1", "3"]
    assert C.tensor_strings(torch.tensor([True, False])).tolist() == [
        "True", "False"]


def test_host_results_land_on_the_frames_device():
    """A string parsed on the host (``to_date``) or a hash computed there
    becomes a tensor on the frame's device, named by ``Func.eval``."""
    t = TFrame({"s": cells(["2019-01-01", None])}, device="cpu")
    seen = []
    real = C.device_array

    def spy(values, dtype=None):
        seen.append(C.eval_device())
        return real(values, dtype)

    import sparkdq4ml_tpu_torch.ops.fn_dates as D

    orig = D.device_array
    D.device_array = spy
    try:
        out = TE.Func("to_date", [TE.col("s")]).eval(t)
    finally:
        D.device_array = orig
    assert seen == [torch.device("cpu")] and out.device.type == "cpu"
    assert C._DEVICE.get() is None           # restored after the call


def test_literal_arguments_are_read_on_the_device():
    t = TFrame({"x": np.arange(4.0)}, device="cpu")
    assert C._scalar_value(TE.lit(3).eval(t)) == 3
    with pytest.raises(ValueError, match="literal"):
        C._scalar_value(TE.col("x").eval(t))
    with pytest.raises(ValueError, match="literal"):
        C._scalar_value(TE.lit(float("nan")).eval(t))
