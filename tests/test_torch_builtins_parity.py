"""Every builtin of the JAX package's ``_BUILTIN_FNS`` (140 names) and its
row functions (``_ROW_FNS``) against the torch port's, on one seeded table
through each package's ``Func``, under both float policies (the float32
policy runs the JAX side with x64 off, as on a TPU).

The table (``builtin_table``) is made with numpy from a seed: floats with
NaN, signed zeros and halfway values, int32 extremes, epoch days before
1970 (1900-03-01, 1969-12-31) and after (2000-02-29, 2100-02-28), date and
timestamp strings (malformed ones and ``None`` among them), empty and
``None`` strings, JSON text, hex and digit text, and array columns with
``None`` cells, ``None`` elements and empty arrays. Each name has one or
more argument recipes (``RECIPES``).

Tolerance: exact (values, dtypes, NaN positions and the sign of zeros;
host cells by type and value) for everything but the transcendental
functions (``TRANSCENDENTAL``, ``sqrt`` among them), which are held
within rtol 4e-15 in float64 (18 ulp; the worst seen is 1.9e-15, XLA's
sinh and cosh near 123) and rtol 2e-6 in float32. Where the JAX package
raises, the port raises the same exception type.
"""

import datetime as dt

import numpy as np
import pytest
import torch
from test_torch_grouped import policy  # noqa: F401

from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.ops.cells import list_column as cells

ROWS = 16
# sqrt too: XLA's float64 sqrt on the CPU is 1 ulp off the rounded root
TRANSCENDENTAL = {"exp", "log", "log10", "pow", "power", "sin", "cos", "tan",
                  "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh",
                  "cbrt", "expm1", "log1p", "log2", "hypot", "sqrt"}
RTOL = {"float64": 4e-15, "float32": 2e-6}

_EPOCH = dt.date(1970, 1, 1)
DATES = ["1900-03-01", "1969-12-31", "1970-01-01", "2000-02-29",
         "2100-02-28", None, "2019-01-01", "2019-01-31", "2019-02-28",
         "2020-02-29", "0001-03-01", "2021-12-31", "1971-01-01",
         "1970-03-01"]


def _days(s):
    return np.nan if s is None else float(
        (dt.date.fromisoformat(s) - _EPOCH).days)


def builtin_table(seed: int = 0, n: int = ROWS) -> dict:
    """The seeded columns every recipe draws from (``n`` >= 16)."""
    rng = np.random.default_rng(seed)
    extra = n - 14

    def pad(head, draw):
        return list(head) + list(draw(extra))

    x = pad([2.5, -2.5, 0.125, -0.0, 0.0, np.nan, 1.05, 27.0, -8.0, 1e-3,
             123.456, -0.5, 0.5, 1.5], lambda k: rng.normal(0, 50, k))
    y = pad([2.0, 3.0, -1.0, 0.5, 0.0, 1.0, np.nan, 1 / 3, 2.0, -2.0, 0.25,
             3.0, 7.0, -3.0], lambda k: rng.normal(0, 5, k))
    u = pad([1.0, -1.0, 0.0, np.nan, 0.5, -0.25, 0.999, -0.75, 0.1, 0.3,
             -0.6, 0.8, -0.9, 0.45], lambda k: rng.uniform(-1, 1, k))
    i = pad([5, -7, 0, 1, 2, 3, -1, 255, -256, 17, 31, 2 ** 31 - 1,
             -2 ** 31, 100], lambda k: rng.integers(-1000, 1000, k))
    g = pad([1, 2, 3, 4, 5, 0, 1, 2, 3, 4, 5, 1, 2, 3],
            lambda k: rng.integers(0, 6, k))
    k_ = pad([0, 1, 5, 20, 21, -1, 2.5, np.nan, 3, 10, 12, 19, 7, 4],
             lambda k: rng.integers(0, 21, k).astype(float))
    d = pad([_days(s) for s in DATES], lambda k: rng.integers(-30000, 50000,
                                                               k))
    d2 = [np.nan if np.isnan(v) else v - int(rng.integers(-800, 800))
          for v in d]
    d2[3] = np.nan
    sec = pad([1.5e9, 1.5e9 + 3661.5, np.nan, 86399.0, 0.0, 1.7e9 + 45296,
               -1.0e9, 1e8, 2.0e9, 12.0, 1.23456789e9, 9.9e7, 1.6e9, 1.0e9],
              lambda k: rng.uniform(1e9, 2e9, k).round())
    words = ["hello world", "Apache Spark", "", None, "ÄÖü ß", "  padded  ",
             "a_b%c", "Robert", "Rupert", "Tymczak", "Pfister", "Honeyman",
             "123", "-42"]
    s = pad(words, lambda k: ["w" + "".join(rng.choice(list("abcxyz"), 3))
                              for _ in range(k)])
    t = pad(["hallo world", "spark", "", "x", None, "padded", "a%b_c",
             "Rob", "Rupert", "Tim", "", "Honey", "321", "42"],
            lambda k: ["v" + "".join(rng.choice(list("abc"), 2))
                       for _ in range(k)])
    ds = pad(["2019-01-31", "1900-03-01", "1969-12-31", "2000-02-29",
              "2100-02-28", None, "junk", "2019-1-5", "2019-02-30",
              "2020-02-29 13:45:10", "2019", "2019-07", "  2019-03-04  ",
              "1970-01-01T00:00:01"], lambda k: [
        f"20{int(a):02d}-{int(b):02d}-{int(c):02d}" for a, b, c in zip(
            rng.integers(0, 30, k), rng.integers(1, 13, k),
            rng.integers(1, 29, k))])
    fds = pad(["31/01/2019", "01/03/1900", None, "bad", "29/02/2000",
               "28/02/2100", "1/1/1970", "31/12/1969", "", "15/08/2019",
               "30/02/2019", "01/01/2001", "12/12/2012", "07/07/2007"],
              lambda k: ["02/02/2002"] * k)
    ts = pad(["2019-01-31 13:45:10", "1969-12-31 23:59:59", None,
              "2000-02-29 00:00:00", "junk", "2020-06-15 06:07:08",
              "1970-01-01 00:00:01", "2100-02-28 23:00:00",
              "2019-01-31", "2019-13-01 00:00:00", "2024-12-31 12:00:00",
              "1999-12-31 23:59:59", "2001-09-09 01:46:40",
              "2010-10-10 10:10:10"], lambda k: ["2015-05-05 05:05:05"] * k)
    hx = pad(["48656C6C6F", "zz", "", None, "0a", "ff00", "abc", "4A",
              "00", "7F", "C3A9", "31", "deadbeef", "1"],
             lambda k: ["41"] * k)
    num = pad(["255", "-1", "ff", "FF", "zz", "", None, "12a", "777",
               "100000000000000000000", " 42 ", "-ff", "0",
               "9223372036854775807"],
              lambda k: [str(v) for v in rng.integers(0, 10 ** 6, k)])
    js = pad(['{"a": 1, "b": {"c": [1, 2, {"d": "x"}]}, "e": true, '
              '"f": 1.5, "g": null}', '{"a": "str"}', "not json", None,
              "[1, 2]", '{"a": [1, {"z": 2}]}', '{"b": {"c": []}}', "{}",
              '{"a": 1e3}', '{"e": false, "f": -0.0}', '{"a": {"b": 1}}',
              '""', '{"f": 12345678901234567890}', '{"a": "x\\"y"}'],
             lambda k: ['{"a": %d}' % v for v in rng.integers(0, 9, k)])
    b64 = pad(["aGVsbG8=", "", None, "U3Bhcms=", "YQ==", "w4k=", "MTIz",
               "eA==", "YWJj", "ZGVm", "Z2hp", "amts", "bW5v", "cHFy"],
              lambda k: ["YQ=="] * k)
    a = pad([[1, 2, 2, None], [], None, [3.5, 1.0], [5], [2, 1], [None],
             [4, 4, 4], [1, 2, 3, 4, 5], [0, -1], [2], [7, None, 7], [9, 8],
             [1.5, 2.5]], lambda k: [list(rng.integers(0, 5, 3))
                                     for _ in range(k)])
    a = [None if c is None else [int(v) if isinstance(v, np.integer) else v
                                 for v in c] for c in a]
    b = pad([[2, 3], [1], [1], None, [], [2, 2, None], [None], [4],
             [5, 6], [-1], [3], [7], [8, 9], [2.5]],
            lambda k: [list(map(int, rng.integers(0, 5, 2)))
                       for _ in range(k)])
    sa = pad([["b", "a", None], [], None, ["x"], ["a", "a"], ["c", "b"],
              [None], ["x", "y", "z"], ["q"], ["a"], ["b", "b", "a"], [""],
              ["z", "a"], ["m", None]], lambda k: [["k", "j"]] * k)
    sb = pad([["a"], ["x"], ["y"], None, ["a", "c"], ["b"], [None], ["z"],
              [], ["a", "b"], ["b"], [""], ["a"], ["m"]],
             lambda k: [["j"]] * k)
    aa = pad([[[1, 2], [3]], [[], [4]], None, [[1], None], [[5]], [],
              [[1, 2], [2, 1]], [[None]], [[7], [8], [9]], [[0]], [[1]],
              [[2, 3]], [[4]], [[5, 6]]], lambda k: [[[1], [2]]] * k)
    floats = {"x": x, "y": y, "u": u, "k": k_, "d": d, "d2": d2, "sec": sec}
    out = {name: np.asarray(v, np.float64) for name, v in floats.items()}
    out["i"] = np.asarray(i, np.int64).astype(np.int32)
    out["g"] = np.asarray(g, np.int32)
    for name, v in {"s": s, "t": t, "ds": ds, "fds": fds, "ts": ts,
                    "hx": hx, "num": num, "js": js, "b64": b64, "a": a,
                    "b": b, "sa": sa, "sb": sb, "aa": aa}.items():
        out[name] = cells(v)
    return out


def _c(E, name):
    return E.col(name)


def _L(E, v):
    return E.lit(v)


def _cols(*names):
    return lambda E: [E.col(n) for n in names]


def _mixed(*items):
    """A recipe of column names and ``('lit', value)`` literals."""
    def make(E):
        return [E.lit(v[1]) if isinstance(v, tuple) else E.col(v)
                for v in items]
    return make


def L(v):
    return ("lit", v)


UNARY_NUMERIC = ("sqrt", "exp", "log", "log10", "floor", "ceil", "sign",
                 "signum", "isnan", "sin", "cos", "tan", "atan", "sinh",
                 "cosh", "tanh", "degrees", "radians", "cbrt", "expm1",
                 "log1p", "log2", "rint")
UNARY_STRING = ("upper", "lower", "trim", "ltrim", "rtrim", "initcap",
                "md5", "sha1", "base64", "soundex", "octet_length",
                "bit_length", "ascii", "crc32")
DATE_FIELDS = ("year", "month", "dayofmonth", "dayofweek", "dayofyear",
               "quarter", "weekofyear", "last_day")

RECIPES = {
    **{f: [_cols("x"), _cols("i")] for f in UNARY_NUMERIC},
    "abs": [_cols("x"), _cols("i")],
    "asin": [_cols("u")], "acos": [_cols("u")],
    "pow": [_cols("x", "y"), _mixed("i", L(2))],
    "power": [_cols("x", "y"), _mixed("x", L(0.5))],
    "atan2": [_cols("x", "y"), _cols("y", "x")],
    "hypot": [_cols("x", "y"), _mixed("i", L(3))],
    "mod": [_cols("x", "y"), _mixed("i", L(3)), _mixed("x", L(-2))],
    "pmod": [_cols("x", "y"), _mixed("i", L(7)), _mixed("x", L(-3))],
    "round": [_cols("x"), _mixed("x", L(1)), _mixed("x", L(2)),
              _mixed("x", L(-1)), _mixed("i", L(-1))],
    "bround": [_cols("x"), _mixed("x", L(1)), _mixed("x", L(2))],
    "greatest": [_cols("x", "y"), _mixed("i", L(3)), _mixed("x", "i",
                                                            L(0.5))],
    "least": [_cols("x", "y"), _mixed("i", L(3)), _mixed("x", "i", L(0.5))],
    "coalesce": [_cols("x", "y"), _mixed("x", L(0.0)), _cols("s", "t"),
                 _mixed("s", L("z")), _cols("x")],
    "ifnull": [_cols("x", "y"), _cols("s", "t")],
    "nvl": [_cols("x", "y"), _cols("s", "t")],
    "nanvl": [_cols("x", "y"), _mixed("x", L(0.0))],
    "nullif": [_cols("x", "y"), _mixed("i", L(3)), _mixed("s", L("x"))],
    "nvl2": [_mixed("x", "y", L(1.0)), _mixed("s", "t", L("n"))],
    "factorial": [_cols("k"), _cols("i")],
    "hex": [_cols("i"), _cols("x"), _cols("s")],
    "unhex": [_cols("hx")],
    "bin": [_cols("i"), _cols("x")],
    "conv": [_mixed("num", L(16), L(10)), _mixed("num", L(10), L(2)),
             _mixed("num", L(10), L(-16)), _mixed("num", L(36), L(16)),
             _mixed("num", L(1), L(10))],
    "shiftleft": [_mixed("i", L(3)), _mixed("x", L(33))],
    "shiftright": [_mixed("i", L(3)), _mixed("x", L(1))],
    "shiftrightunsigned": [_mixed("i", L(3)), _mixed("x", L(2))],
    "bitwise_not": [_cols("i"), _cols("x")],
    **{f: [_cols("s")] for f in UNARY_STRING},
    "unbase64": [_cols("b64")],
    "length": [_cols("s"), _cols("x"), _cols("i")],
    "concat": [_cols("s", "t"), _mixed("s", L("-"), "x"), _cols("s")],
    "concat_ws": [_mixed(L(","), "s", "t"), _mixed(L("|"), "s", "x")],
    "sha2": [_mixed("s", L(256)), _mixed("s", L(0)), _mixed("s", L(384)),
             _mixed("s", L(100))],
    "substring": [_mixed("s", L(2), L(3)), _mixed("s", L(0), L(2)),
                  _mixed("s", "g", L(2)), _mixed("s", L(-3), L(2))],
    "substr": [_mixed("s", L(2), L(3))],
    "split": [_mixed("s", L(" ")), _mixed("s", L("[aeiou]"))],
    "format_number": [_mixed("x", L(2)), _mixed("i", L(0))],
    "format_string": [_mixed(L("%s-%d"), "s", "i"), _mixed(L("%.3f"), "x")],
    "levenshtein": [_cols("s", "t"), _cols("s", "s")],
    "regexp_replace": [_mixed("s", L("[aeiou]"), L("#")),
                       _mixed("s", L(r"(\w+) (\w+)"), L(r"\2 \1"))],
    "regexp_extract": [_mixed("s", L(r"(\w)(\w+)"), L(2)),
                       _mixed("s", L(r"(\d+)"), L(1)),
                       _mixed("s", L("(x)?y"), L(1))],
    "instr": [_mixed("s", L("o")), _mixed("s", L(""))],
    "locate": [_mixed(L("o"), "s"), _mixed(L("o"), "s", L(6))],
    "lpad": [_mixed("s", L(8), L("*")), _mixed("s", L(3), L("ab")),
             _mixed("s", L(0), L("x")), _mixed("s", L(5), L(""))],
    "rpad": [_mixed("s", L(8), L("*")), _mixed("s", L(3), L("ab")),
             _mixed("s", L(0), L("x"))],
    "left": [_mixed("s", L(3)), _mixed("s", L(0))],
    "right": [_mixed("s", L(3)), _mixed("s", L(0))],
    "overlay": [_mixed("s", "t", L(2)), _mixed("s", "t", L(1), L(0))],
    "repeat": [_mixed("s", L(2)), _mixed("s", L(0))],
    "reverse": [_cols("s"), _cols("a"), _cols("sa")],
    "translate": [_mixed("s", L("lo"), L("01")),
                  _mixed("s", L("abc"), L("x"))],
    "substring_index": [_mixed("s", L(" "), L(1)), _mixed("s", L("a"), L(-1)),
                        _mixed("s", L(""), L(2)), _mixed("s", L("l"), L(0))],
    "encode": [_mixed("s", L("utf-8"))],
    "decode": [lambda E: [E.Func("encode", [E.col("s"), E.lit("utf-8")]),
                          E.lit("utf-8")]],
    "get_item": [_mixed("a", L(0)), _mixed("a", L(-1)), _mixed("sa", L(1))],
    "array_contains": [_mixed("a", L(2)), _mixed("sa", L("a"))],
    "element_at": [_mixed("a", L(1)), _mixed("a", L(-1)),
                   _mixed("sa", L(2)), _mixed("a", L(0))],
    "array": [_cols("x", "i"), _cols("s", "t")],
    "sort_array": [_cols("a"), _mixed("a", L(False)), _cols("sa")],
    "array_distinct": [_cols("a"), _cols("sa")],
    "array_join": [_mixed("sa", L(",")), _mixed("sa", L(","), L("NULL")),
                   _mixed("a", L("-"))],
    "slice": [_mixed("a", L(1), L(2)), _mixed("a", L(-2), L(5)),
              _mixed("a", L(-10), L(2)), _mixed("a", L(0), L(1))],
    "flatten": [_cols("aa"), _cols("a")],
    "size": [_cols("a"), _cols("sa"), _cols("s")],
    "array_position": [_mixed("a", L(2)), _mixed("sa", L("x"))],
    "array_remove": [_mixed("a", L(2)), _mixed("sa", L("a"))],
    "array_union": [_cols("a", "b"), _cols("sa", "sb")],
    "array_intersect": [_cols("a", "b"), _cols("sa", "sb")],
    "array_except": [_cols("a", "b"), _cols("sa", "sb")],
    "arrays_overlap": [_cols("a", "b"), _cols("sa", "sb")],
    "array_min": [_cols("a"), _cols("sa")],
    "array_max": [_cols("a"), _cols("sa")],
    "array_repeat": [_mixed("x", L(2)), _mixed("s", L(3)),
                     _mixed("i", L(-1))],
    "sequence": [_mixed(L(1), "g"), _mixed("g", L(1)),
                 _mixed(L(0), L(10), L(3)), _mixed(L(5), L(1), L(2))],
    "arrays_zip": [_cols("a", "b"), _cols("a", "sa")],
    "shuffle": [_mixed("a", L(7)), _mixed("sa", L(11))],
    "to_date": [_cols("ds"), _mixed("fds", L("dd/MM/yyyy")),
                _mixed("ds", L("yyyy-QQ"))],
    "unix_timestamp": [_cols("ts"), _mixed("ds", L("yyyy-MM-dd"))],
    "from_unixtime": [_cols("sec"), _mixed("sec", L("yyyy-MM-dd")),
                      _cols("d")],
    "date_format": [_mixed("d", L("yyyy-MM-dd")),
                    _mixed("ds", L("dd/MM/yy HH:mm")), _mixed("d", L("MM"))],
    "datediff": [_cols("d", "d2"), _cols("ds", "d"), _cols("sec", "d")],
    "date_add": [_mixed("d", L(30)), _mixed("ds", L(-1))],
    "date_sub": [_mixed("d", L(30)), _mixed("ds", L(-1))],
    **{f: [_cols("d"), _cols("ds"), _cols("sec"), _cols("i")]
       for f in DATE_FIELDS},
    **{f: [_cols("ts"), _cols("d"), _cols("sec")]
       for f in ("hour", "minute", "second")},
    "add_months": [_mixed("d", L(1)), _mixed("d", L(-13)),
                   _mixed("ds", L(12))],
    "months_between": [_cols("d", "d2"), _mixed("d", "d2", L(False)),
                       _cols("ds", "d")],
    "next_day": [_mixed("d", L("Mon")), _mixed("d", L("friday")),
                 _mixed("d", L("xx"))],
    "trunc": [_mixed("d", L("year")), _mixed("d", L("MM")),
              _mixed("d", L("week"))],
    "to_timestamp": [_cols("ts"), _cols("ds"),
                     _mixed("fds", L("dd/MM/yyyy"))],
    "date_trunc": [_mixed(L("hour"), "ts"), _mixed(L("week"), "sec"),
                   _mixed(L("quarter"), "ds"), _mixed(L("month"), "d"),
                   _mixed(L("bogus"), "ts")],
    "hash": [_cols("i"), _cols("x"), _cols("s"), _cols("i", "x", "s"),
             _cols("sec", "b64")],
    "xxhash64": [_cols("i"), _cols("x"), _cols("s"), _cols("i", "x", "s"),
                 _cols("js")],
    "get_json_object": [_mixed("js", L(p)) for p in (
        "$.a", "$.b.c[2].d", "$.b", "$.e", "$.f", "$.g", "$[0]", "a",
        "$.b.c[9]", "$..a", "$.a[1].z")],
}


def _kind(v) -> str:
    return type(v).__name__


def canon(x):
    """A host cell as comparable data: its type and value, NaN as a
    token, arrays element by element."""
    if x is None:
        return None
    if isinstance(x, (list, tuple, np.ndarray)):
        return ("array", tuple(canon(e) for e in x))
    if isinstance(x, (float, np.floating)):
        return (_kind(x), "nan" if np.isnan(x) else float(x),
                bool(np.signbit(x)))
    return (_kind(x), x)


def result_of(v):
    """A function's result as ("host", [cells]) or ("numeric", ndarray)."""
    if isinstance(v, torch.Tensor):
        return "numeric", v.cpu().numpy()
    arr = np.asarray(v)
    if arr.dtype == object:
        return "host", [canon(c) for c in v]
    return "numeric", arr


def assert_same_result(got, want, rtol=None, what=""):
    gk, g = result_of(got)
    wk, w = result_of(want)
    assert gk == wk, f"{what}: port gives a {gk} column, JAX a {wk} one"
    if gk == "host":
        assert g == w, what
        return
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, what
    if rtol is not None and g.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, equal_nan=True,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)
    if g.dtype.kind == "f":
        nz = ~np.isnan(w) & (w == 0)
        np.testing.assert_array_equal(np.signbit(g[nz]), np.signbit(w[nz]),
                                      err_msg=what)


def frames(seed: int = 0, n: int = ROWS):
    cols = builtin_table(seed, n)
    return JFrame(dict(cols)), TFrame(dict(cols), device="cpu")


def run_both(j, t, make_j, make_t):
    """(port result, JAX result), or the exception each raised."""
    out = []
    for make, frame in ((make_t, t), (make_j, j)):
        try:
            out.append(make().eval(frame))
        except Exception as e:      # compared by type below
            out.append(e)
    return out


def check(got, want, rtol, what):
    if isinstance(want, Exception) or isinstance(got, Exception):
        assert type(got) is type(want), (
            f"{what}: port {got!r}, JAX {want!r}")
        return
    assert_same_result(got, want, rtol, what)


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_builtin_matches_the_jax_package(policy, name, request):
    fl = request.node.callspec.params["policy"]
    rtol = RTOL[fl] if name in TRANSCENDENTAL else None
    j, t = frames()
    for k, recipe in enumerate(RECIPES[name]):
        got, want = run_both(j, t, lambda: JE.Func(name, recipe(JE)),
                             lambda: TE.Func(name, recipe(TE)))
        check(got, want, rtol, f"{name} recipe {k}")


def test_every_builtin_and_row_function_has_its_name():
    """The port answers exactly the JAX package's builtin and row-function
    names, and each builtin has a recipe above."""
    assert set(TE._BUILTIN_FNS) == set(JE._BUILTIN_FNS)
    assert len(TE._BUILTIN_FNS) == 140
    assert set(TE._ROW_FNS) == set(JE._ROW_FNS)
    assert set(RECIPES) == set(JE._BUILTIN_FNS)


def test_unknown_function_raises_the_jax_value_error():
    with pytest.raises(ValueError, match="unknown function"):
        JE.Func("no_such_fn", [])
    with pytest.raises(ValueError, match="unknown function"):
        TE.Func("no_such_fn", [])
    with pytest.raises(ValueError, match="unknown function"):
        TE.fn("no_such_fn", "x")


ROW_RECIPES = {
    "monotonically_increasing_id": [],
    "spark_partition_id": [],
    "rand": [42],
    "randn": [42],
}


@pytest.mark.parametrize("name", sorted(ROW_RECIPES))
@pytest.mark.parametrize("seed", [None, -5])
def test_row_functions_by_name_match(policy, name, seed):
    """``rand``/``randn`` with a seed (a negative one folded) draw numpy's
    stream bit for bit; the ids and the partition id are exact."""
    j, t = frames()
    args = ROW_RECIPES[name]
    if args and seed is not None:
        args = [seed]

    def make(E):
        # a negative seed as SQL parses it: a negated literal
        return E.UdfCall(name, [-E.lit(-a) if a < 0 else E.lit(a)
                                for a in args])

    got, want = run_both(j, t, lambda: make(JE), lambda: make(TE))
    check(got, want, None, name)


def test_uuid_and_typeof_by_name(policy):
    j, t = frames()
    u = TE.UdfCall("uuid", []).eval(t)
    assert u.dtype == object and len(set(u)) == ROWS
    assert all(len(x) == 36 and x.count("-") == 4 for x in u)
    for col in ("x", "i", "s"):
        got = TE.UdfCall("typeof", [TE.col(col)]).eval(t)
        want = JE.UdfCall("typeof", [JE.col(col)]).eval(j)
        assert list(got) == list(want)
    flag = TE.UdfCall("typeof", [TE.col("x") > 0]).eval(t)
    assert set(flag) == {"boolean"}
    with pytest.raises(ValueError):
        TE.UdfCall("uuid", [TE.lit(1)]).eval(t)


def test_shuffle_without_a_seed_keeps_each_cells_elements():
    _, t = frames()
    got = TE.fn("shuffle", TE.col("a")).eval(t)
    for cell, want in zip(got, builtin_table()["a"]):
        if want is None:
            assert cell is None
        else:
            assert sorted(map(repr, cell)) == sorted(map(repr, want))


def test_a_registered_udf_wins_over_a_builtin_of_its_name():
    from sparkdq4ml_tpu_torch.ops.udf import UDFRegistry

    reg = UDFRegistry()
    reg.register("upper", lambda v: v * 2)
    _, t = frames()
    got = TE.UdfCall("upper", [TE.col("x")], registry=reg).eval(t)
    torch.testing.assert_close(got, t._data["x"] * 2, equal_nan=True)
    assert list(TE.UdfCall("upper", [TE.col("s")]).eval(t))[:2] == [
        "HELLO WORLD", "APACHE SPARK"]
    with pytest.raises(KeyError):
        TE.UdfCall("no_such_fn", [TE.col("s")]).eval(t)
