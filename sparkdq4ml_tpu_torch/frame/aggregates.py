"""Aggregations (``sparkdq4ml_tpu/frame/aggregates.py``): global
aggregates as mask-weighted reductions on the frame's device, grouped
aggregates through the grouped engine (``ops/segments.py``), pivots and
rollup/cube subtotals.

Every aggregate of the JAX package is here: count, sum, avg/mean, min,
max, the variances, first/last, the distinct aggregates, median, mode,
percentile_approx, skewness, kurtosis, the two-column family (corr,
covar_samp, covar_pop, max_by, min_by) and the collections (collect_list,
collect_set). The order statistics, moments and two-column aggregates
reduce on the device from one sort by (group, value); the collections,
and any aggregate over a string column, are host objects by nature and
are built on the host from the device's group order in one gather. Where
the JAX package answers on its host path, the result columns take that
path's types (``ops/segments.host_path_columns``).
"""

from __future__ import annotations

import itertools
from typing import Optional, Union

import numpy as np
import torch

from ..ops.expressions import Col, Expr, is_host_column
from ..utils.profiling import counters
from ..ops.segments import (SEGMENT_FNS, _seg_sum, global_values,
                            grouped_agg)

_AGGS = ("count", "sum", "avg", "mean", "min", "max", "stddev", "variance",
         "stddev_pop", "var_pop", "median", "mode", "percentile_approx",
         "count_distinct", "sum_distinct", "collect_list", "collect_set",
         "first", "last", "skewness", "kurtosis",
         "corr", "covar_samp", "covar_pop", "max_by", "min_by")
# two-column aggregates (Spark's F.corr(a, b), max_by(x, ord))
_TWO_COL = ("corr", "covar_samp", "covar_pop", "max_by", "min_by")
# windowed form exists only for the running aggregates (as in Spark <= 2.x)
_WINDOWABLE = ("count", "sum", "avg", "min", "max")
# the JAX package's device-reduced global aggregates; the rest of the
# device family it answers with one host value each (``_one_value``)
_GLOBAL_FNS = ("count", "sum", "avg", "min", "max", "stddev", "variance")
# ... of which these add floats: over the valid rows compacted in row order
# (``_valid_slots``), so that the order of the adds follows the rows and not
# the slots around them, as after adaptive execution's re-bucket
_ROW_ORDER_FNS = ("sum", "avg", "stddev", "variance")


def _valid_slots(mask: torch.Tensor) -> Optional[torch.Tensor]:
    """The valid slots of ``mask`` in order (one counted host read, for
    their count), or None when every slot is valid. A float sum over
    them takes the same input, and so the same order of adds, as the same
    sum over the frame that ``sql/adaptive.py:maybe_rebucket`` compacts to
    those rows: a global SUM/AVG/STDDEV is the same bits with adaptive
    execution on or off."""
    counters.increment("frame.host_sync")
    rows = torch.nonzero(mask).squeeze(1)
    return None if rows.shape[0] == mask.shape[0] else rows


def _check_fn(fn: str) -> str:
    fn = fn.lower()
    if fn not in _AGGS:
        raise ValueError(f"unknown aggregate {fn!r} (supported: {_AGGS})")
    return "avg" if fn == "mean" else fn


class AggExpr:
    """An aggregate over a column, e.g. ``F.avg("price")`` or SQL
    ``AVG(price)``; ``column=None`` is ``count(*)``, ``column2`` the second
    column of a two-column aggregate, ``param`` percentile_approx's
    percentage."""

    def __init__(self, fn: str, column: Optional[str],
                 alias: Optional[str] = None,
                 column2: Optional[str] = None,
                 ignore_nulls: bool = False, param=None):
        self.fn = _check_fn(fn)
        if self.fn in _TWO_COL:
            if column is None or column2 is None:
                raise ValueError(f"{self.fn}(col1, col2) takes two columns")
        elif column2 is not None:
            raise ValueError(f"{self.fn}() takes one column")
        self.column = column
        self.column2 = column2
        self.ignore_nulls = bool(ignore_nulls)   # first/last only
        self.param = param                       # percentile_approx only
        self._alias = alias

    def alias(self, name: str) -> "AggExpr":
        return AggExpr(self.fn, self.column, name, self.column2,
                       self.ignore_nulls, self.param)

    @property
    def name(self) -> str:
        if self._alias:
            return self._alias
        if self.fn == "count" and self.column is None:
            return "count"
        if self.fn in _TWO_COL:
            return f"{self.fn}({self.column}, {self.column2})"
        if self.fn in ("count_distinct", "sum_distinct"):
            return f"{self.fn.split('_')[0]}(DISTINCT {self.column})"
        if self.fn in ("first", "last") and self.ignore_nulls:
            return f"{self.fn}({self.column}, true)"
        if self.fn == "percentile_approx":
            return f"percentile_approx({self.column}, {self.param})"
        target = "1" if self.column is None else self.column
        return f"{self.fn}({target})"

    def __repr__(self):
        return self.name

    def over(self, spec) -> Expr:
        """Bind as a window aggregate: ``F.sum("x").over(w)``; ``first``
        and ``last`` map to ``first_value``/``last_value``."""
        from .window import window_agg

        if self.fn in ("first", "last"):
            if self.ignore_nulls:
                raise ValueError(f"windowed {self.fn}() does not support "
                                 "ignoreNulls")
            expr = window_agg(f"{self.fn}_value", self.column).over(spec)
        elif self.fn not in _WINDOWABLE:
            raise ValueError(f"windowed {self.fn}() is not supported")
        else:
            expr = window_agg(self.fn, self.column).over(spec)
        return expr.alias(self._alias) if self._alias else expr


class AggOfExpr(AggExpr):
    """An aggregate over an expression (``sum(price * qty)``): the
    expression becomes a temporary column just before aggregating."""

    def __init__(self, fn: str, expr, alias: Optional[str] = None):
        fn = _check_fn(fn)
        if fn in _TWO_COL:
            raise ValueError(
                f"aggregate {fn!r} does not take an expression argument")
        self.fn = fn
        self.expr = expr
        self.column = None
        self.column2 = None
        self.ignore_nulls = False
        self.param = None
        self._alias = alias

    def alias(self, name: str) -> "AggOfExpr":
        return AggOfExpr(self.fn, self.expr, name)

    @property
    def name(self) -> str:
        return self._alias if self._alias else f"{self.fn}({self.expr})"

    def over(self, spec):
        raise ValueError(
            "windowed aggregates over expressions are not supported — "
            "materialize the expression with withColumn first")


def materialize_agg_exprs(frame, aggs):
    """Expression-argument aggregates -> temp columns + plain AggExprs."""
    out = []
    for i, a in enumerate(aggs):
        if isinstance(a, AggOfExpr):
            tmp = f"__aggarg_{i}"
            frame = frame.with_column(tmp, a.expr)
            out.append(AggExpr(a.fn, tmp, alias=a.name))
        else:
            out.append(a)
    return frame, out


def _dict_aggs(d: dict) -> list:
    """PySpark's dict form ``agg({'col': 'fn'})``."""
    return [AggExpr(fn, None if col == "*" else col) for col, fn in d.items()]


# functions-module constructors; each takes a column name or expression
def _agg_or_expr(fn: str, col):
    if isinstance(col, Expr):
        if isinstance(col, Col):
            return AggExpr(fn, col.name)
        return AggOfExpr(fn, col)
    return AggExpr(fn, col)


def count(col=None) -> AggExpr:
    if isinstance(col, Expr):
        return _agg_or_expr("count", col)
    return AggExpr("count", None if col in (None, "*") else col)


def sum(col) -> AggExpr:       # noqa: A001 - mirrors Spark's name
    return _agg_or_expr("sum", col)


def avg(col) -> AggExpr:
    return _agg_or_expr("avg", col)


mean = avg


def min(col) -> AggExpr:       # noqa: A001
    return _agg_or_expr("min", col)


def max(col) -> AggExpr:       # noqa: A001
    return _agg_or_expr("max", col)


def stddev(col) -> AggExpr:
    return _agg_or_expr("stddev", col)


def variance(col) -> AggExpr:
    return _agg_or_expr("variance", col)


def stddev_pop(col: str) -> AggExpr:
    return AggExpr("stddev_pop", col)


def var_pop(col: str) -> AggExpr:
    return AggExpr("var_pop", col)


def count_distinct(col: str) -> AggExpr:
    return AggExpr("count_distinct", col)


countDistinct = count_distinct


def sum_distinct(col: str) -> AggExpr:
    return AggExpr("sum_distinct", col)


sumDistinct = sum_distinct


def first(col: str, ignorenulls: bool = False) -> AggExpr:
    return AggExpr("first", col, ignore_nulls=ignorenulls)


def last(col: str, ignorenulls: bool = False) -> AggExpr:
    return AggExpr("last", col, ignore_nulls=ignorenulls)


def median(col: str) -> AggExpr:
    return AggExpr("median", col)


def mode(col: str) -> AggExpr:
    return AggExpr("mode", col)


def percentile_approx(col: str, percentage: float,
                      accuracy: int = 10000) -> AggExpr:
    """Spark's approximate percentile, answered exactly: the nearest-rank
    order statistic (``accuracy`` is accepted for API compatibility)."""
    if not 0.0 <= float(percentage) <= 1.0:
        raise ValueError(f"percentage must be in [0, 1], got {percentage}")
    return AggExpr("percentile_approx", col, param=float(percentage))


def approx_count_distinct(col: str, rsd: float = 0.05) -> AggExpr:
    """Spark's HLL estimate, answered exactly (``rsd`` is accepted for API
    compatibility)."""
    if not 0.0 < rsd < 1.0:
        raise ValueError(f"rsd must be in (0, 1), got {rsd}")
    return AggExpr("count_distinct", col,
                   alias=f"approx_count_distinct({col})")


approxCountDistinct = approx_count_distinct


def collect_list(col: str) -> AggExpr:
    return AggExpr("collect_list", col)


def collect_set(col: str) -> AggExpr:
    return AggExpr("collect_set", col)


def skewness(col: str) -> AggExpr:
    return AggExpr("skewness", col)


def kurtosis(col: str) -> AggExpr:
    return AggExpr("kurtosis", col)


def corr(col1: str, col2: str) -> AggExpr:
    return AggExpr("corr", col1, column2=col2)


def covar_samp(col1: str, col2: str) -> AggExpr:
    return AggExpr("covar_samp", col1, column2=col2)


def covar_pop(col1: str, col2: str) -> AggExpr:
    return AggExpr("covar_pop", col1, column2=col2)


def _global_answer(agg, value, string: bool, has_rows: bool) -> np.ndarray:
    """The JAX package's global answer for an aggregate it computes on the
    host, from the device's one-group ``value``: a 1-element numpy array
    of the type its host value has (``np.asarray([res])``), or an object
    slot for collections and for string columns."""
    from .frame import list_column

    if isinstance(value, np.ndarray):                 # strings, lists
        cell = value[0]
        if agg.fn in ("first", "last") and not has_rows:
            cell = float("nan")
        if string and agg.fn in _GLOBAL_FNS:          # min / max
            return (np.asarray([cell], dtype=object) if isinstance(cell, str)
                    else np.asarray([cell]))
        return list_column([cell])
    if string:                                        # count, distinct
        cell = int(value[0])
        return (np.asarray([cell]) if agg.fn in _GLOBAL_FNS
                else list_column([cell]))
    if agg.fn == "mode":
        if not has_rows or (value.is_floating_point()
                            and bool(torch.isnan(value[0]))):
            return np.asarray([np.nan])
        return value.cpu().numpy()
    return np.asarray([float(value[0])])


def global_agg(frame, aggs: list):
    """Masked reductions over the whole frame on its device -> a 1-row
    frame; over zero valid rows sum/min/max/avg/stddev are NULL (one host
    read decides them all, as in the JAX package). stddev_pop, var_pop,
    first, last and the DISTINCT aggregates reduce on the device too and
    come back as one host value each, with the JAX package's dtypes; so
    do the order statistics, moments, two-column aggregates, collections
    and every aggregate over a string column, through the grouped
    engine's sorted program over one group (``global_values``)."""
    from ..config import int_dtype, wide_types
    from .frame import Frame

    mask = frame.mask
    dev = frame.device
    out: dict = {}
    deferred = []          # (name, non-null count, value, NULL result)
    hosted = []            # (agg, string column?) for global_values
    rows, have_rows = None, False      # _valid_slots(mask), once a call

    def fsum(x):
        """A float sum in the fixed order of the segment-sum kernels (the
        whole-table form: no id column)."""
        return _seg_sum(x, None, 1)[0]

    for agg in aggs:
        if agg.fn == "count" and agg.column is None:
            out[agg.name] = mask.sum(dtype=torch.int32)[None]
            continue
        v = frame._column_values(agg.column)
        if is_host_column(v) or agg.fn not in SEGMENT_FNS:
            out[agg.name] = None                  # keeps the column order
            hosted.append((agg, is_host_column(v)))
            continue
        if agg.fn not in _GLOBAL_FNS:
            out[agg.name] = _one_value(agg, v, mask)
            continue
        if agg.fn in ("count", "sum") and not v.is_floating_point():
            # exact integer arithmetic (Spark widens SUM to long); the JAX
            # package's host int64 result narrows without x64
            vals = torch.where(mask, v.to(torch.int64),
                               torch.zeros((), dtype=torch.int64, device=dev))
            res = (mask.sum(dtype=torch.int64) if agg.fn == "count"
                   else vals.sum())
            out[agg.name] = res.to(torch.int64 if wide_types()
                                   else int_dtype())[None]
            continue
        vf = v.to(torch.float64 if v.dtype == torch.float64
                  else torch.float32)
        m = mask
        if agg.fn in _ROW_ORDER_FNS:
            if not have_rows:
                rows, have_rows = _valid_slots(mask), True
            if rows is not None:
                vf, m = vf.index_select(0, rows), m.index_select(0, rows)
        null = torch.isnan(vf)
        valid = m & ~null
        wf = valid.to(vf.dtype)
        nv = fsum(wf)
        vf = torch.where(null, torch.zeros_like(vf), vf)
        nan = torch.full((1,), float("nan"), dtype=vf.dtype, device=dev)
        cnt = valid.sum(dtype=torch.int32)
        if agg.fn == "count":
            out[agg.name] = cnt[None]
        elif agg.fn == "avg":
            out[agg.name] = (fsum(vf * wf) / nv)[None]
        elif agg.fn == "sum":
            out[agg.name] = None                  # keeps the column order
            deferred.append((agg.name, cnt, fsum(vf * wf)[None], nan))
        elif agg.fn in ("min", "max"):
            fill = float("inf") if agg.fn == "min" else float("-inf")
            red = torch.amin if agg.fn == "min" else torch.amax
            out[agg.name] = None
            deferred.append((agg.name, cnt, red(torch.where(
                valid, vf, torch.full_like(vf, fill))).to(v.dtype)[None],
                nan))
        else:  # stddev / variance: sample (n - 1); NULL when n < 2
            mu = fsum(vf * wf) / nv
            ss = fsum(wf * (vf - mu) ** 2)
            var = torch.where(nv > 1.0, ss / torch.clamp(nv - 1.0, min=1.0),
                              nan[0])
            out[agg.name] = (var if agg.fn == "variance"
                             else torch.sqrt(var))[None]
    if deferred:
        # the one deferred device->host pull of an agg call, counted
        counters.increment("frame.host_sync")
        counts = torch.stack([c for _, c, _, _ in deferred]).tolist()
        for (name, _, val, nanv), c in zip(deferred, counts):
            out[name] = val if c > 0 else nanv
    if hosted:
        has_rows = bool(mask.any())
        values = global_values(frame, [a for a, _ in hosted])
        for (agg, string), value in zip(hosted, values):
            out[agg.name] = _global_answer(agg, value, string, has_rows)
    return Frame(out, device=dev)


def _one_value(agg, v, mask):
    """The JAX package's host answer for one aggregate (``_np_agg``),
    computed on the device: a 1-element numpy array whose dtype follows
    its (a numpy scalar of the column's dtype for first/last, int64 for
    counts and integer sums, float64 otherwise; NaN when no row
    qualifies)."""
    null = torch.isnan(v) if v.is_floating_point() else torch.zeros_like(
        mask)
    if agg.fn in ("first", "last"):
        rows = torch.nonzero(mask & ~null if agg.ignore_nulls else mask)
        if rows.numel() == 0:
            return np.asarray([np.nan])
        pick = rows[0 if agg.fn == "first" else -1]
        return v[pick].cpu().numpy()
    vals = v[mask & ~null]
    if agg.fn == "count_distinct":
        return np.asarray([torch.unique(vals).numel()])
    if vals.numel() == 0:
        return np.asarray([np.nan])
    if agg.fn == "sum_distinct":
        u = torch.unique(vals)
        return np.asarray([(u.double() if u.is_floating_point()
                            else u.long()).sum().item()])
    x = vals.double()
    var = ((x - x.mean()) ** 2).mean()
    return np.asarray([(var if agg.fn == "var_pop" else var.sqrt()).item()])


class _AggShortcuts:
    """``RelationalGroupedDataset`` terminal shortcuts, via ``self.agg``."""

    def count(self):
        return self.agg(AggExpr("count", None))

    def sum(self, *cols: str):
        return self.agg(*[AggExpr("sum", c) for c in cols])

    def avg(self, *cols: str):
        return self.agg(*[AggExpr("avg", c) for c in cols])

    mean = avg

    def min(self, *cols: str):
        return self.agg(*[AggExpr("min", c) for c in cols])

    def max(self, *cols: str):
        return self.agg(*[AggExpr("max", c) for c in cols])


class GroupedFrame(_AggShortcuts):
    """Result of ``Frame.group_by``."""

    def __init__(self, frame, keys: list):
        if not keys:
            raise ValueError("group_by requires at least one key column")
        self._frame = frame
        self._keys = keys
        for k in keys:
            frame._column_values(k)  # validate early

    def apply_in_pandas(self, func, schema):
        """Spark 3's ``groupBy(...).applyInPandas(fn, schema)``: each group
        (pandas ``groupby`` with ``sort=True, dropna=False``) goes through
        ``func`` as a pandas DataFrame on the host, and the results
        concatenate into one frame on the session's device, cast to the
        DDL ``schema``."""
        import pandas as pd

        from .csv import parse_ddl_schema
        from .frame import pandas_result

        fields = parse_ddl_schema(schema) if isinstance(schema, str) \
            else list(schema)
        pdf = self._frame.to_pandas()
        groups = [] if len(pdf) == 0 else [
            g.reset_index(drop=True)
            for _, g in pdf.groupby(self._keys, sort=True, dropna=False)]
        outs = []
        for g in groups:
            out = func(g)
            if not isinstance(out, pd.DataFrame):
                raise TypeError("applyInPandas function must return a "
                                f"pandas DataFrame, got {type(out).__name__}")
            outs.append(out)
        return pandas_result(outs, fields, self._frame.device,
                             "applyInPandas")

    applyInPandas = apply_in_pandas

    def agg(self, *aggs: Union[AggExpr, str]):
        if len(aggs) == 1 and isinstance(aggs[0], dict):
            aggs = tuple(_dict_aggs(aggs[0]))
        agg_list = [AggExpr(a, None) if isinstance(a, str) else a
                    for a in aggs]
        if not agg_list:
            raise ValueError("agg() needs at least one aggregate")
        frame, agg_list = materialize_agg_exprs(self._frame, agg_list)
        return grouped_agg(frame, self._keys, agg_list)


    def pivot(self, pivot_col: str, values=None) -> "PivotedFrame":
        """``groupBy(keys).pivot(col[, values]).agg(...)``: the distinct
        values of ``pivot_col`` (sorted, when not given) become output
        columns."""
        self._frame._column_values(pivot_col)
        return PivotedFrame(self._frame, self._keys, pivot_col, values)


class PivotedFrame(_AggShortcuts):
    """Result of ``GroupedFrame.pivot``: one output column per (pivot
    value, aggregate), named by the value for a single aggregate and
    ``value_aggname`` for several. One grouped call over the keys and the
    pivot column, then a scatter into a [groups x values] table on the
    device (``ops/segments.pivot_agg``)."""

    def __init__(self, frame, keys: list, pivot_col: str, values):
        self._frame = frame
        self._keys = keys
        self._pivot_col = pivot_col
        self._values = list(values) if values is not None else None

    def agg(self, *aggs: Union[AggExpr, str]):
        from ..ops.segments import pivot_agg

        agg_list = [AggExpr(a, None) if isinstance(a, str) else a
                    for a in aggs]
        if not agg_list:
            raise ValueError("agg() needs at least one aggregate")
        frame, agg_list = materialize_agg_exprs(self._frame, agg_list)
        return pivot_agg(frame, self._keys, self._pivot_col, self._values,
                         agg_list)


class MultiGroupedFrame(_AggShortcuts):
    """``Frame.rollup``/``Frame.cube``: aggregate at several grouping
    levels and union the results (Spark's subtotals). Key columns come
    back as host object columns with ``None`` in subtotal rows, so integer
    keys stay exact. One grouped call per level, then one concatenation
    per column."""

    def __init__(self, frame, keys: list, levels: list):
        if not keys:
            raise ValueError("rollup/cube require at least one key column")
        self._frame = frame
        self._keys = keys
        self._levels = levels
        for k in keys:
            frame._column_values(k)  # validate early

    def agg(self, *aggs: Union[AggExpr, str]):
        from .frame import Frame

        agg_list = [AggExpr(a, None) if isinstance(a, str) else a
                    for a in aggs]
        if not agg_list:
            raise ValueError("agg() needs at least one aggregate")
        frame, agg_list = materialize_agg_exprs(self._frame, agg_list)
        key_parts: dict = {k: [] for k in self._keys}
        agg_parts: dict = {a.name: [] for a in agg_list}
        for kept in self._levels:
            out = (grouped_agg(frame, list(kept), agg_list) if kept
                   else global_agg(frame, agg_list))
            d = out.to_pydict()
            n = len(next(iter(d.values()))) if d else 0
            for k in self._keys:
                key_parts[k].append(np.asarray(d[k], object) if k in d
                                    else np.full(n, None, dtype=object))
            for a in agg_list:
                agg_parts[a.name].append(np.asarray(d[a.name]))
        data: dict = {k: np.concatenate(key_parts[k]) for k in self._keys}
        for a in agg_list:
            parts = agg_parts[a.name]
            if any(p.dtype == object for p in parts):
                parts = [np.asarray(p, object) for p in parts]
            data[a.name] = np.concatenate(parts)
        return Frame(data, device=self._frame.device)


def rollup_levels(keys: list) -> list:
    """Prefixes, longest first, down to the grand total: Spark ROLLUP."""
    return [tuple(keys[:i]) for i in range(len(keys), -1, -1)]


def cube_levels(keys: list) -> list:
    """Every key subset (kept in key order), by descending size: CUBE."""
    out = []
    for r in range(len(keys), -1, -1):
        out.extend(itertools.combinations(keys, r))
    return out


__all__ = ["AggExpr", "AggOfExpr", "GroupedFrame", "PivotedFrame",
           "MultiGroupedFrame", "rollup_levels", "cube_levels", "global_agg",
           "materialize_agg_exprs", "count", "sum", "avg", "mean", "min",
           "max", "stddev", "variance", "stddev_pop", "var_pop", "median",
           "mode", "percentile_approx", "count_distinct", "countDistinct",
           "approx_count_distinct", "approxCountDistinct", "sum_distinct",
           "sumDistinct", "collect_list", "collect_set", "first", "last",
           "skewness", "kurtosis", "corr", "covar_samp", "covar_pop"]
