"""The date and timestamp builtins (``sparkdq4ml_tpu/ops/expressions.py:
1965-2530``): ``to_date``, ``unix_timestamp``, ``from_unixtime``,
``date_format``, ``datediff``, ``date_add``/``date_sub``, the fields
(``year`` ... ``quarter``, ``weekofyear``, ``hour``/``minute``/
``second``), ``last_day``, ``add_months``, ``months_between``,
``next_day``, ``trunc``, ``to_timestamp`` and ``date_trunc``.

A date is a float column of days since 1970-01-01 with NaN for null; a
timestamp is a float64 column of epoch seconds, which needs the float64
policy (the JAX package's ``jax_enable_x64``): under float32 the
timestamp functions raise the JAX package's ``ValueError``. The civil
math (Hinnant's ``civil_from_days``/``days_from_civil``) is int32
tensor math on the column's device, with floor division written out
(``torch.div(..., rounding_mode="floor")``), so days before 1970 floor as
``//`` does in jnp. Strings parse on the host, and formatting is host
``strftime``; both run once per distinct value (a date column of 10^7
rows holds a few hundred days), then gather.
"""

from __future__ import annotations

import datetime as _dt
import re

import numpy as np
import torch

from ..config import float_dtype, wide_types
from . import strings
from .cells import (_scalar_int, _scalar_str, _scalar_value, as_float,
                    const, device_array, host_array, host_objects,
                    is_host_column, per_distinct, per_distinct_numbers,
                    wide_float)

_EPOCH_DATE = _dt.date(1970, 1, 1)
_EPOCH = _dt.datetime(1970, 1, 1)

# |v| >= 1e8 is epoch seconds, else epoch days (the JAX package's
# _SECONDS_CUTOFF: 1e8 s is 1973-03-03, 1e8 days is past year 275760)
_SECONDS_CUTOFF = 1e8

_JAVA_RUNS = {"yyyy": "%Y", "yy": "%y", "MM": "%m", "M": "%m",
              "dd": "%d", "d": "%d", "HH": "%H", "H": "%H",
              "mm": "%M", "m": "%M", "ss": "%S", "s": "%S"}

_DOW_NAMES = {"su": 1, "sun": 1, "sunday": 1, "mo": 2, "mon": 2,
              "monday": 2, "tu": 3, "tue": 3, "tuesday": 3, "we": 4,
              "wed": 4, "wednesday": 4, "th": 5, "thu": 5, "thursday": 5,
              "fr": 6, "fri": 6, "friday": 6, "sa": 7, "sat": 7,
              "saturday": 7}

_DATETIME_RE = re.compile(
    r"^(\d{4})(?:-(\d{1,2})(?:-(\d{1,2})"
    r"(?:[ T](\d{1,2}):(\d{2})(?::(\d{2})(?:\.\d+)?)?)?)?)?")


def _strptime_format(java_fmt: str) -> str:
    """A Spark/Java date pattern as a strptime one, run by run; a pattern
    letter outside the table raises."""
    out = []
    i = 0
    while i < len(java_fmt):
        c = java_fmt[i]
        if c.isalpha():
            j = i
            while j < len(java_fmt) and java_fmt[j] == c:
                j += 1
            run = java_fmt[i:j]
            if run not in _JAVA_RUNS:
                raise ValueError(
                    f"unsupported date-format token {run!r} in "
                    f"{java_fmt!r} (supported: {sorted(_JAVA_RUNS)})")
            out.append(_JAVA_RUNS[run])
            i = j
        else:
            out.append("%%" if c == "%" else c)
            i += 1
    return "".join(out)


def _require_x64(what: str):
    if not wide_types():
        raise ValueError(
            f"{what} requires jax_enable_x64: epoch seconds exceed "
            "float32's exact-integer range (use to_date/trunc for "
            "day-resolution work)")


def _per_string(s, fn) -> np.ndarray:
    """``fn(cell)`` of each cell of a host column as float64 (NaN for
    ``None`` or where ``fn`` gives None), run once per distinct string
    through the column's dictionary codes."""
    arr = host_objects(s)
    try:
        codes, words = strings.codes(arr)
    except NotImplementedError:         # a non-string cell: cell by cell
        return np.asarray([np.nan if (r := fn(x)) is None else r
                           for x in arr], np.float64)
    lut = np.empty(len(words) + 1, np.float64)
    for i, w in enumerate(words):
        r = fn(w)
        lut[i] = np.nan if r is None else r
    lut[-1] = np.nan                     # NULL_CODE picks the last entry
    return lut[codes]


def _parse_dates(s, fmt: str, unit_seconds: bool):
    """Host parse of a string column with a Java pattern: epoch days in
    the policy's float, or epoch seconds in float64 (float64 policy
    only); what does not parse is NaN."""
    py_fmt = _strptime_format(fmt)

    def one(x):
        try:
            t = _dt.datetime.strptime(str(x).strip(), py_fmt)
        except ValueError:
            return None
        delta = t - _EPOCH
        return delta.total_seconds() if unit_seconds else delta.days

    out = _per_string(s, lambda x: None if x is None else one(x))
    if unit_seconds:
        if not wide_types():
            raise ValueError(
                "unix_timestamp requires jax_enable_x64: epoch seconds "
                "exceed float32's exact-integer range (use to_date for "
                "day-resolution work)")
        return device_array(out, torch.float64)
    return device_array(out, float_dtype())


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z):
    """Days since the epoch -> (year, month, day), int32 device math."""
    z = z + 719468
    era = _floordiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floordiv(doe - _floordiv(doe, 1460) + _floordiv(doe, 36524)
                    - _floordiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floordiv(yoe, 4) - _floordiv(yoe, 100))
    mp = _floordiv(5 * doy + 2, 153)
    d = doy - _floordiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d


def _days_from_civil(y, m, d):
    """(year, month, day) -> days since the epoch, int32 device math."""
    y = y - (m <= 2).to(y.dtype)
    era = _floordiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _floordiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floordiv(yoe, 4) - _floordiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _parse_datetime_cell(x):
    """Spark's lenient string -> timestamp cast of one cell:
    ``yyyy[-M[-d]][ T hh:mm[:ss[.fff]]]``, anything after ignored; the
    missing fields default to 01 and midnight. A datetime or None."""
    if x is None:
        return None
    m = _DATETIME_RE.match(str(x).strip())
    if not m:
        return None
    y, mo, d, hh, mi, ss = m.groups()
    try:
        return _dt.datetime(int(y), int(mo or 1), int(d or 1),
                            int(hh or 0), int(mi or 0), int(ss or 0))
    except ValueError:
        return None


def _days_of(v):
    """The epoch-day view of a date operand: strings by the lenient cast
    (the time part dropped), numbers as epoch days, or epoch seconds
    floored to days past the magnitude cutoff."""
    if is_host_column(v):
        def days(x):
            t = _parse_datetime_cell(x)
            return None if t is None else (t.date() - _EPOCH_DATE).days
        return device_array(_per_string(v, days), float_dtype())
    arr = as_float(v)
    return torch.where(torch.abs(arr) >= _SECONDS_CUTOFF,
                       torch.floor(arr / const(arr, 86400.0)), arr)


def _split_days(days):
    """(null mask, int32 days with 0 at the nulls) of an epoch-day
    column."""
    null = torch.isnan(days)
    return null, torch.where(null, torch.zeros_like(days),
                             days).to(torch.int32)


def _or_null(null, out, like):
    return torch.where(null, torch.full((), float("nan"), dtype=like.dtype,
                                        device=like.device),
                       out.to(like.dtype))


def _fn_to_date(s, fmt=None):
    f = _scalar_str(fmt) if fmt is not None else "yyyy-MM-dd"
    return _parse_dates(s, f, unit_seconds=False)


def _fn_unix_timestamp(s, fmt=None):
    f = _scalar_str(fmt) if fmt is not None else "yyyy-MM-dd HH:mm:ss"
    return _parse_dates(s, f, unit_seconds=True)


def _date_field(which: str):
    def f(days):
        days = _days_of(days)
        null, z = _split_days(days)
        y, m, d = _civil_from_days(z)
        if which == "year":
            v = y
        elif which == "month":
            v = m
        elif which == "dayofmonth":
            v = d
        elif which == "quarter":
            v = _floordiv(m - 1, 3) + 1
        elif which == "dayofweek":
            # 1 = Sunday ... 7 = Saturday; epoch day 0 was a Thursday
            v = torch.remainder(z + 4, 7) + 1
        else:  # dayofyear
            one = torch.ones_like(y)
            v = z - _days_from_civil(y, one, one) + 1
        return _or_null(null, v, days)
    return f


def _fn_datediff(end, start):
    return _days_of(end) - _days_of(start)


def _fn_date_add(days, n):
    return _days_of(days) + _scalar_int(n)


def _fn_date_sub(days, n):
    return _days_of(days) - _scalar_int(n)


def _fn_date_format(days, fmt):
    """Strings are cast to timestamps (their time of day reaches HH, mm
    and ss); numbers are epoch days."""
    py_fmt = _strptime_format(_scalar_str(fmt))
    if is_host_column(days):
        return np.asarray(
            [None if (t := _parse_datetime_cell(x)) is None
             else t.strftime(py_fmt) for x in days], object)
    return per_distinct(as_tensor_f(days), lambda v: (
        _EPOCH_DATE + _dt.timedelta(days=int(v))).strftime(py_fmt))


def as_tensor_f(v) -> torch.Tensor:
    """A numeric column as a float tensor (its own width; host numbers on
    the evaluation device as float64)."""
    if isinstance(v, torch.Tensor):
        return v if v.is_floating_point() else v.to(torch.float64)
    return device_array(host_array(v).astype(np.float64), torch.float64)


def _fn_from_unixtime(secs, fmt=None):
    py_fmt = _strptime_format(
        _scalar_str(fmt) if fmt is not None else "yyyy-MM-dd HH:mm:ss")
    return per_distinct(as_tensor_f(secs), lambda v: (
        _EPOCH + _dt.timedelta(seconds=int(v))).strftime(py_fmt))


def _time_field(which: str):
    """hour / minute / second: of a string by the lenient cast; of epoch
    seconds on the device in float64 (the float64 policy; under float32 a
    seconds value raises); epoch days are midnight, so 0."""
    def f(v):
        if is_host_column(v):
            sel = {"hour": lambda t: t.hour, "minute": lambda t: t.minute,
                   "second": lambda t: t.second}[which]
            out = [None if (t := _parse_datetime_cell(x)) is None else sel(t)
                   for x in v]
            return device_array(np.asarray(
                [np.nan if x is None else float(x) for x in out],
                np.float64), float_dtype())
        t = as_tensor_f(v)
        if bool((torch.abs(torch.nan_to_num(t.to(torch.float64), nan=0.0))
                 >= _SECONDS_CUTOFF).any()):
            _require_x64(f"{which}() on epoch-second (timestamp) values")
        arr = t.to(wide_float())
        sod = torch.where(torch.abs(arr) >= _SECONDS_CUTOFF,
                          torch.remainder(arr, 86400.0),
                          torch.zeros_like(arr))
        if which == "hour":
            val = torch.div(sod, const(sod, 3600.0), rounding_mode="floor")
        elif which == "minute":
            val = torch.div(torch.remainder(sod, 3600.0), const(sod, 60.0),
                            rounding_mode="floor")
        else:
            val = torch.div(torch.remainder(sod, 60.0), const(sod, 1.0),
                            rounding_mode="floor")
        val = torch.where(torch.isnan(arr), arr, val)
        return val.to(float_dtype())
    return f


def _fn_weekofyear(v):
    """The ISO-8601 week (host calendar math, once per distinct day)."""
    return per_distinct_numbers(_days_of(v), lambda d: (
        _EPOCH_DATE + _dt.timedelta(days=int(d))).isocalendar()[1],
        float_dtype())


def _month_after(y, m):
    return torch.where(m == 12, y + 1, y), torch.where(
        m == 12, torch.ones_like(m), m + 1)


def _fn_last_day(v):
    """The last day of the date's month: the 1st of the next month less
    one day."""
    days = _days_of(v)
    null, z = _split_days(days)
    y, m, _ = _civil_from_days(z)
    ny, nm = _month_after(y, m)
    out = _days_from_civil(ny, nm, torch.ones_like(ny)) - 1
    return _or_null(null, out, days)


def _days_in_month(y, m):
    ny, nm = _month_after(y, m)
    one = torch.ones_like(y)
    return _days_from_civil(ny, nm, one) - _days_from_civil(y, m, one)


def _fn_add_months(v, n):
    """A calendar month shift, the day clamped to the month's end."""
    k = _scalar_int(n)
    days = _days_of(v)
    null, z = _split_days(days)
    y, m, d = _civil_from_days(z)
    total = y * 12 + (m - 1) + k
    ny = _floordiv(total, 12)
    nm = torch.remainder(total, 12) + 1
    nd = torch.minimum(d, _days_in_month(ny, nm))
    return _or_null(null, _days_from_civil(ny, nm, nd), days)


def _fn_months_between(end, start, *round_off):
    """Whole months when both dates share the day of month or both end
    their months, else the remainder over Spark's fixed 31; rounded to 8
    places unless ``roundOff`` is false. The arithmetic runs in the
    JAX package's float64, which is float32 without the float64 policy."""
    ro = bool(_scalar_value(round_off[0])) if round_off else True
    d1, d2 = _days_of(end), _days_of(start)
    null = torch.isnan(d1) | torch.isnan(d2)
    zero = torch.zeros_like(d1)
    z1 = torch.where(null, zero, d1).to(torch.int32)
    z2 = torch.where(null, zero, d2).to(torch.int32)
    y1, m1, dd1 = _civil_from_days(z1)
    y2, m2, dd2 = _civil_from_days(z2)
    f64 = wide_float()
    months = ((y1 - y2) * 12 + (m1 - m2)).to(f64)
    both_last = (dd1 == _days_in_month(y1, m1)) & \
        (dd2 == _days_in_month(y2, m2))
    whole = (dd1 == dd2) | both_last
    frac = (dd1 - dd2).to(f64) / const(months, 31.0)
    out = torch.where(whole, months, months + frac)
    if ro:
        out = torch.round(out * 1e8) / const(out, 1e8)
    return torch.where(null, torch.full((), float("nan"), dtype=float_dtype(),
                                        device=out.device),
                       out.to(float_dtype()))


def _fn_next_day(v, day_name):
    """The first named weekday strictly after the date; an unknown name
    gives NULL."""
    name = str(_scalar_value(day_name) or "").strip().lower()
    target = _DOW_NAMES.get(name)
    days = _days_of(v)
    null, z = _split_days(days)
    if target is None:
        return torch.full_like(days, float("nan"))
    dow = torch.remainder(z + 4, 7) + 1
    delta = torch.remainder(target - dow, 7)
    delta = torch.where(delta == 0, torch.full_like(delta, 7), delta)
    return _or_null(null, z + delta, days)


def _fn_trunc(v, fmt):
    """Truncation to the year or the month; another format gives NULL."""
    f = str(_scalar_str(fmt)).lower()
    days = _days_of(v)
    null, z = _split_days(days)
    y, m, _ = _civil_from_days(z)
    one = torch.ones_like(y)
    if f in ("year", "yyyy", "yy"):
        out = _days_from_civil(y, one, one)
    elif f in ("month", "mon", "mm"):
        out = _days_from_civil(y, m, one)
    else:
        return torch.full_like(days, float("nan"))
    return _or_null(null, out, days)


def _seconds_of(v) -> np.ndarray:
    """The epoch-seconds view, host float64: strings by the lenient cast,
    epoch seconds as they are, epoch days as their midnight."""
    if is_host_column(v):
        return _per_string(v, lambda x: None if (
            t := _parse_datetime_cell(x)) is None
            else (t - _EPOCH).total_seconds())
    arr = host_array(v).astype(np.float64)
    return np.where(np.abs(arr) >= _SECONDS_CUTOFF, arr, arr * 86400.0)


def _fn_to_timestamp(s, *fmt):
    """Epoch seconds (float64 policy only): with a format a strict parse,
    without one the lenient cast."""
    _require_x64("to_timestamp")
    if fmt:
        return _parse_dates(s, _scalar_str(fmt[0]), unit_seconds=True)
    return device_array(_seconds_of(s), torch.float64)


def _fn_date_trunc(fmt, v):
    """Truncated epoch seconds (float64 policy only); the format comes
    first, the reverse of ``trunc``."""
    _require_x64("date_trunc")
    f = str(_scalar_str(fmt)).lower()
    secs = device_array(_seconds_of(v), torch.float64)
    null = torch.isnan(secs)
    if f in ("second", "minute", "hour", "day", "week"):
        width = {"second": 1.0, "minute": 60.0, "hour": 3600.0,
                 "day": 86400.0, "week": 7 * 86400.0}[f]
        # epoch day 0 is a Thursday; ISO weeks start Monday (epoch day 4)
        shift = 4 * 86400.0 if f == "week" else 0.0
        out = torch.floor((secs - shift) / const(secs, width)) * width \
            + shift
    elif f in ("year", "yyyy", "yy", "month", "mon", "mm", "quarter"):
        z = torch.where(null, torch.zeros_like(secs),
                        torch.floor(secs / const(secs, 86400.0))
                        ).to(torch.int32)
        y, m, _ = _civil_from_days(z)
        one = torch.ones_like(y)
        tm = one if f in ("year", "yyyy", "yy") else (
            _floordiv(m - 1, 3) * 3 + 1 if f == "quarter" else m)
        out = _days_from_civil(y, tm, one).to(torch.float64) * 86400.0
    else:
        return torch.full_like(secs, float("nan"))
    return torch.where(null, secs, out)


DATE_FNS = {
    "to_date": _fn_to_date,
    "unix_timestamp": _fn_unix_timestamp,
    "from_unixtime": _fn_from_unixtime,
    "date_format": _fn_date_format,
    "datediff": _fn_datediff,
    "date_add": _fn_date_add,
    "date_sub": _fn_date_sub,
    "year": _date_field("year"),
    "month": _date_field("month"),
    "dayofmonth": _date_field("dayofmonth"),
    "dayofweek": _date_field("dayofweek"),
    "dayofyear": _date_field("dayofyear"),
    "quarter": _date_field("quarter"),
    "hour": _time_field("hour"),
    "minute": _time_field("minute"),
    "second": _time_field("second"),
    "weekofyear": _fn_weekofyear,
    "last_day": _fn_last_day,
    "add_months": _fn_add_months,
    "months_between": _fn_months_between,
    "next_day": _fn_next_day,
    "trunc": _fn_trunc,
    "to_timestamp": _fn_to_timestamp,
    "date_trunc": _fn_date_trunc,
}
