"""Dates and timestamps in the torch port against the JAX package (and
Python's ``datetime`` where it answers too), under both float policies:
the int32 civil math at dates before and after 1970 (1900-03-01,
1969-12-31, 2000-02-29, 2100-02-28), floor division on negative days, the
month arithmetic's clamps, the timestamp family's float64 contract (under
float32 it raises the JAX package's ``ValueError``), and the port's once-
per-distinct-value parsing and formatting at sizes with many repeats.

Tolerance: exact (values, dtypes, NaN positions, strings).
"""

import datetime as dt

import numpy as np
import pytest
import torch
from test_torch_builtins_parity import assert_same_result
from test_torch_grouped import policy  # noqa: F401

from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.ops import fn_dates

EPOCH = dt.date(1970, 1, 1)
TRAPS = ["1900-03-01", "1969-12-31", "2000-02-29", "2100-02-28",
         "1900-02-28", "1970-01-01", "2000-12-31", "2024-01-31"]


def day(s):
    return float((dt.date.fromisoformat(s) - EPOCH).days)


def both(cols):
    return JFrame(dict(cols)), TFrame(dict(cols), device="cpu")


def same(name, args_of, j, t):
    got = TE.Func(name, args_of(TE)).eval(t)
    want = JE.Func(name, args_of(JE)).eval(j)
    assert_same_result(got, want, what=name)
    return got


FIELDS = {"year": lambda d: d.year, "month": lambda d: d.month,
          "dayofmonth": lambda d: d.day,
          "dayofweek": lambda d: d.isoweekday() % 7 + 1,
          "dayofyear": lambda d: d.timetuple().tm_yday,
          "quarter": lambda d: (d.month - 1) // 3 + 1,
          "weekofyear": lambda d: d.isocalendar()[1]}


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_fields_at_the_trap_dates(policy, field):
    j, t = both({"d": np.asarray([day(s) for s in TRAPS] + [np.nan])})
    got = same(field, lambda E: [E.col("d")], j, t).numpy()
    want = [FIELDS[field](dt.date.fromisoformat(s)) for s in TRAPS]
    np.testing.assert_array_equal(got[:-1], want)
    assert np.isnan(got[-1])


@pytest.mark.parametrize("fn,args", [
    ("last_day", ()), ("add_months", (1,)), ("add_months", (-1,)),
    ("add_months", (12,)), ("add_months", (-25,)), ("trunc", ("year",)),
    ("trunc", ("MM",)), ("next_day", ("Sun",)), ("next_day", ("Thu",)),
    ("date_add", (-1,)), ("date_sub", (365,))])
def test_day_arithmetic_at_the_trap_dates(policy, fn, args):
    j, t = both({"d": np.asarray([day(s) for s in TRAPS] + [np.nan]),
                 "s": np.asarray(TRAPS + [None], dtype=object)})
    for src in ("d", "s"):
        same(fn, lambda E: [E.col(src)] + [E.lit(a) for a in args], j, t)


def test_add_months_clamps_to_the_month_end(policy):
    _, t = both({"d": np.asarray([day("2024-01-31"), day("2100-01-31"),
                                  day("1900-01-31"), day("2000-03-31")])})
    got = TE.Func("add_months", [TE.col("d"), TE.lit(1)]).eval(t)
    want = ["2024-02-29", "2100-02-28", "1900-02-28", "2000-04-30"]
    assert got.tolist() == [day(s) for s in want]


def test_civil_math_round_trips_every_day_against_datetime(policy):
    """Every 37th day from 0001-03-01 to 9999-12-31: days -> civil ->
    days, the civil fields equal to datetime's, as the JAX package's."""
    lo, hi = day("0001-03-01"), day("9999-12-31")
    z = torch.arange(int(lo), int(hi), 37, dtype=torch.int32)
    y, m, d = fn_dates._civil_from_days(z)
    back = fn_dates._days_from_civil(y, m, d)
    assert torch.equal(back, z)
    for k in range(0, len(z), 997):
        date = EPOCH + dt.timedelta(days=int(z[k]))
        assert (int(y[k]), int(m[k]), int(d[k])) == (date.year, date.month,
                                                     date.day)
    import jax.numpy as jnp

    from sparkdq4ml_tpu.ops import expressions as J

    jy, jm, jd = J._civil_from_days(jnp.asarray(z.numpy()))
    for a, b in ((y, jy), (m, jm), (d, jd)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_floor_division_on_negative_days():
    """torch's ``//`` on int tensors floors, as jnp's does; the port writes
    it as ``torch.div(..., rounding_mode="floor")`` so no reader wonders."""
    z = torch.tensor([-1, -7, -8, -146097, 3], dtype=torch.int32)
    assert fn_dates._floordiv(z, 7).tolist() == [-1, -1, -2, -20871, 0]
    assert torch.remainder(z + 4, 7).tolist() == [3, 4, 3, 4, 0]


TIMESTAMP_FNS = {
    "to_timestamp": lambda E: [E.col("ts")],
    "unix_timestamp": lambda E: [E.col("ts")],
    "date_trunc": lambda E: [E.lit("hour"), E.col("ts")],
    "hour": lambda E: [E.col("sec")],
}


@pytest.mark.parametrize("fn", sorted(TIMESTAMP_FNS))
def test_timestamps_need_the_float64_policy(policy, fn, request):
    j, t = both({"ts": np.asarray(["2019-01-31 13:45:10", None, "junk"],
                                  dtype=object),
                 "sec": np.asarray([1.5e9, np.nan, 1.7e9 + 45296.0])})
    if request.node.callspec.params["policy"] == "float32":
        for E, f in ((TE, t), (JE, j)):
            with pytest.raises(ValueError, match="x64"):
                E.Func(fn, TIMESTAMP_FNS[fn](E)).eval(f)
    else:
        assert same(fn, TIMESTAMP_FNS[fn], j, t).dtype == torch.float64


def test_formatting_and_parsing_once_per_distinct_value(policy):
    """10,000 rows over 40 distinct days and 30 distinct strings (nulls
    and junk among them): the port formats and parses each once and
    gathers, with the JAX package's row-by-row cells."""
    rng = np.random.default_rng(3)
    days = rng.choice([day(s) for s in TRAPS] + list(
        rng.integers(-40000, 40000, 31).astype(float)) + [np.nan], 10_000)
    texts = np.asarray(rng.choice(
        TRAPS + ["junk", "2019-02-30", "2020-02-29 23:59:59"] * 3
        + [None] * 4, 10_000), dtype=object)
    secs = rng.choice([1.5e9, 1.6e9 + 17.0, 0.0, np.nan], 10_000)
    j, t = both({"d": days, "s": texts, "sec": secs})
    for name, args in (("date_format", lambda E: [E.col("d"),
                                                  E.lit("yyyy/MM/dd")]),
                       ("weekofyear", lambda E: [E.col("d")]),
                       ("weekofyear", lambda E: [E.col("s")]),
                       ("from_unixtime", lambda E: [E.col("sec")]),
                       ("to_date", lambda E: [E.col("s")]),
                       ("year", lambda E: [E.col("s")]),
                       ("date_format", lambda E: [E.col("s"),
                                                  E.lit("HH:mm")])):
        same(name, args, j, t)


def test_date_add_takes_a_literal_count_in_both_packages():
    """The JAX package reads the count with ``_scalar_int``: a per-row
    column raises there, so the port raises too."""
    j, t = both({"d": np.asarray([0.0, 1.0]), "n": np.asarray([1, 2],
                                                              np.int32)})
    for E, f in ((TE, t), (JE, j)):
        with pytest.raises(ValueError, match="literal"):
            E.Func("date_add", [E.col("d"), E.col("n")]).eval(f)


def test_current_date_and_timestamp_are_literals():
    today = float((dt.date.today() - EPOCH).days)
    assert TE.current_date().value in (today, today + 1)
    assert isinstance(TE.current_timestamp().value, float)
