"""Columnar frame with a validity mask (subset of
``sparkdq4ml_tpu/frame/frame.py``).

A frame is a dict of equal-length columns plus a boolean mask. Numeric
columns are tensors on the frame's device (a vector column is 2-D);
string and array columns are numpy object arrays on the host, with
``None`` as their null, and gathers take their rows by a host index where
the device gathers by ``index_select``. ``filter``, ``limit`` and
``dropna`` never compact rows: they AND into the mask, and every consumer
reads the mask. Grouped, sorted, distinct, joined and exploded results
are compact frames with an all-true mask.

The relational verbs run on the frame's device: ``group_by().agg()``,
``sort``, ``distinct`` and ``drop_duplicates`` through the grouped engine
(``ops/segments.py``); ``join`` plans its row pairs on the host with numpy
from one pull of the key columns and gathers every payload column on the
device; window functions plan on the host the same way
(``frame/window.py``). A string key enters each of them as int32 codes
(``ops/strings.py``).
"""

from __future__ import annotations

import io
from typing import Iterable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..config import (config, float_dtype, int_dtype, resolve_device,
                      wide_types)
from ..ops import strings
from ..ops.expressions import (Alias, Col, Explode, Expr, SortOrder,
                               is_host_column, predicate_keep_mask,
                               spark_type_name)

_JOIN_TYPES = ("inner", "left", "right", "outer", "left_semi", "left_anti",
               "cross")


def _join_plan(lcols, rcols, li, ri, how):
    """Hash-join plan for numeric keys, the JAX package's
    ``_vector_join_plan``: ``(lpairs, rpairs)`` row-index arrays, -1 where
    an outer join has no partner. Left rows come out in order, each with
    its right matches in right order; unmatched right rows follow in
    order (right/outer). A NaN key never matches (NaN != NaN), as in the
    JAX package's dict plan for such keys. Integer key pairs compare as
    int64, others as float64."""
    def ids(a, b):
        if not (np.issubdtype(a.dtype, np.floating)
                or np.issubdtype(b.dtype, np.floating)):
            return a.astype(np.int64), b.astype(np.int64)
        return a.astype(np.float64), b.astype(np.float64)

    conv = [ids(a, b) for a, b in zip(lcols, rcols)]
    nl = li.size
    if len(conv) == 1:
        lid, rid = conv[0]
    else:
        # multi-key: group ids from one lexsort over the concatenated rows
        cols = [np.concatenate([a, b]) for a, b in conv]
        perm = np.lexsort(cols[::-1])
        newg = np.zeros(perm.size, bool)
        if perm.size:
            newg[0] = True
            for c in cols:
                cs = c[perm]
                newg[1:] |= cs[1:] != cs[:-1]
        inv = np.empty(perm.size, np.int64)
        inv[perm] = np.cumsum(newg) - 1
        lid, rid = inv[:nl], inv[nl:]
    order = np.argsort(rid, kind="stable")      # groups keep right order
    rid_sorted = rid[order]
    if rid_sorted.size:
        bound = np.empty(rid_sorted.size, bool)
        bound[0] = True
        bound[1:] = rid_sorted[1:] != rid_sorted[:-1]
        gstart = np.nonzero(bound)[0]
        gvals = rid_sorted[gstart]
        gcnt = np.diff(np.append(gstart, rid_sorted.size))
        pos = np.minimum(np.searchsorted(gvals, lid), gvals.size - 1)
        hit = gvals[pos] == lid
        start = np.where(hit, gstart[pos], 0)
        counts = np.where(hit, gcnt[pos], 0)
    else:
        start = np.zeros(lid.size, np.int64)
        counts = np.zeros(lid.size, np.int64)

    if how == "left_semi":
        hit = counts > 0
        return li[hit], ri[order[start[hit]]]
    if how == "left_anti":
        miss = counts == 0
        return li[miss], np.full(int(miss.sum()), -1, np.int64)

    ecounts = np.maximum(counts, 1) if how in ("left", "outer") else counts
    total = int(ecounts.sum())
    lp = np.repeat(li, ecounts)
    group_first = np.cumsum(ecounts) - ecounts
    within = np.arange(total) - np.repeat(group_first, ecounts)
    flat = np.repeat(start, ecounts) + within
    if order.size:
        rp = ri[order[np.minimum(flat, order.size - 1)]]
    else:
        rp = np.full(total, -1, np.int64)
    if how in ("left", "outer"):
        rp = np.where(np.repeat(counts == 0, ecounts), -1, rp)
    if how in ("right", "outer"):               # unmatched right rows last
        lid_sorted = np.sort(lid)
        if lid_sorted.size:
            pos = np.searchsorted(lid_sorted, rid)
            matched = (pos < lid_sorted.size) & \
                (lid_sorted[np.minimum(pos, lid_sorted.size - 1)] == rid)
        else:
            matched = np.zeros(rid.size, bool)
        extra = ri[~matched]
        lp = np.concatenate([lp, np.full(extra.size, -1, np.int64)])
        rp = np.concatenate([rp, extra])
    return lp.astype(np.int64), rp.astype(np.int64)


def _as_column(values, device: torch.device):
    """Coerce raw values into a column: a tensor on ``device``, or a host
    object array for strings. As in the JAX package, Python lists take the
    default dtypes, and a 64-bit numpy array keeps its width only under the
    float64 policy (JAX keeps it only in x64 mode)."""
    if isinstance(values, torch.Tensor):
        return values.to(device)
    if isinstance(values, np.ndarray) and values.dtype.kind in ("U", "S"):
        return values.astype(object)
    if is_host_column(values):
        return values
    wide = wide_types() and isinstance(values, np.ndarray)
    if not isinstance(values, np.ndarray):
        values = list(values)
        if values and any(isinstance(v, str) for v in values):
            return np.asarray(values, dtype=object)
        values = np.asarray(values)
        if values.dtype == object:
            return values
    dt = None
    if values.dtype == np.float64 and not wide:
        dt = float_dtype()
    elif values.dtype == np.int64 and not wide:
        dt = int_dtype()
    return torch.as_tensor(values, dtype=dt, device=device)


def _frame_device(columns: Mapping, mask) -> torch.device:
    for v in (*columns.values(), mask):
        if isinstance(v, torch.Tensor):
            return v.device
    return resolve_device()


class Frame:
    """Immutable columnar frame with a validity mask."""

    def __init__(self, columns: Mapping[str, object], mask=None,
                 device=None):
        self.device = (resolve_device(device) if device is not None
                       else _frame_device(columns, mask))
        self._data: dict[str, object] = {}
        n = None
        for name, values in columns.items():
            arr = _as_column(values, self.device)
            if n is not None and arr.shape[0] != n:
                raise ValueError(
                    f"column length {arr.shape[0]} != frame length {n}")
            n = arr.shape[0]
            self._data[name] = arr
        self._n = 0 if n is None else int(n)
        if mask is None:
            self._mask = torch.ones(self._n, dtype=torch.bool,
                                    device=self.device)
        else:
            self._mask = torch.as_tensor(mask, dtype=torch.bool).to(
                self.device)
            if tuple(self._mask.shape) != (self._n,):
                raise ValueError("mask shape mismatch")

    @classmethod
    def from_rows(cls, rows: Iterable[Sequence], names: Sequence[str],
                  device=None) -> "Frame":
        rows = list(rows)
        cols = list(zip(*rows)) if rows else [[] for _ in names]
        return cls({name: list(vals) for name, vals in zip(names, cols)},
                   device=device)

    def _with(self, data=None, mask=None) -> "Frame":
        f = Frame.__new__(Frame)
        f.device = self.device
        f._data = dict(self._data if data is None else data)
        f._mask = self._mask if mask is None else mask
        f._n = self._n
        return f

    # -- introspection -----------------------------------------------------
    @property
    def columns(self) -> list[str]:
        return list(self._data)

    @property
    def num_slots(self) -> int:
        """Physical row slots, masked-out rows included."""
        return self._n

    @property
    def mask(self) -> torch.Tensor:
        return self._mask

    def dtypes(self) -> list[tuple[str, str]]:
        return [(name, "string" if is_host_column(arr)
                 else spark_type_name(arr.dtype))
                for name, arr in self._data.items()]

    def schema_string(self) -> str:
        """``printSchema`` text, matching Spark's output shape."""
        out = io.StringIO()
        out.write("root\n")
        for name, arr in self._data.items():
            if is_host_column(arr):
                tname = "string"
            elif arr.ndim == 2:
                tname = "vector"
            else:
                tname = spark_type_name(arr.dtype)
            out.write(f" |-- {name}: {tname} (nullable = true)\n")
        return out.getvalue()

    def print_schema(self) -> None:
        print(self.schema_string(), end="")

    printSchema = print_schema

    # -- column access -----------------------------------------------------
    def _column_values(self, name: str):
        try:
            return self._data[name]
        except KeyError:
            raise KeyError(
                f"no column {name!r}; columns: {self.columns}") from None

    def col(self, name: str) -> Col:
        if name not in self._data:
            raise KeyError(f"no column {name!r}; columns: {self.columns}")
        return Col(name)

    def _eval(self, expr_or_values):
        if isinstance(expr_or_values, Expr):
            arr = expr_or_values.eval(self)
        else:
            arr = _as_column(expr_or_values, self.device)
        if arr.shape[0] != self._n:
            raise ValueError(
                f"column length {arr.shape[0]} != frame length {self._n}")
        return arr

    # -- transformations ---------------------------------------------------
    def with_column(self, name: str, values) -> "Frame":
        """``withColumn``: add or replace a column."""
        data = dict(self._data)
        data[name] = self._eval(values)
        return self._with(data=data)

    withColumn = with_column

    def with_column_renamed(self, old: str, new: str) -> "Frame":
        """``withColumnRenamed``; a no-op if ``old`` is absent (Spark)."""
        if old not in self._data:
            return self
        return self._with(data={(new if k == old else k): v
                                for k, v in self._data.items()})

    withColumnRenamed = with_column_renamed

    def with_columns(self, cols_map: Mapping[str, object]) -> "Frame":
        """``withColumns``: every expression resolves against the input
        frame (Spark semantics)."""
        evaluated = {name: self._eval(v) for name, v in cols_map.items()}
        data = dict(self._data)
        data.update(evaluated)
        return self._with(data=data)

    withColumns = with_columns

    def select(self, *exprs: Union[str, Expr]) -> "Frame":
        """Project columns and expressions. One ``explode`` generator (a
        bare ``Explode`` or an alias of one) may stand among them: the
        other items are computed first, then each row repeats once for
        every element of its array cell (Spark's rule)."""
        flat = []
        for e in exprs:
            flat.extend(e if isinstance(e, (list, tuple)) else [e])
        gens = [e for e in flat if isinstance(e, Explode) or (
            isinstance(e, Alias) and isinstance(e.child, Explode))]
        if len(gens) > 1:
            raise ValueError("only one explode() per select (Spark rule)")
        data: dict[str, object] = {}
        for e in flat:
            if isinstance(e, str):
                if e == "*":
                    data.update(self._data)
                    continue
                e = Col(e)
            if any(e is g for g in gens):
                continue
            data[e.name] = self._eval(e)
        if not gens:
            return self._with(data=data)
        g = gens[0]
        inner = g if isinstance(g, Explode) else g.child
        # a temporary slot keeps the source column, when it is selected
        # too, in the output
        tmp = "__explode_source__"
        while tmp in data:
            tmp += "_"
        data[tmp] = inner.source_values(self)
        return self._with(data=data).explode(tmp, g.name,
                                             keep_nulls=inner.outer)

    def explode(self, column: str, output_col: Optional[str] = None,
                keep_nulls: bool = False) -> "Frame":
        """Spark's ``explode``: one row for each element of each valid
        row's array cell (a compact frame), the other columns repeated;
        a null or empty cell drops its row, or with ``keep_nulls``
        (``explode_outer``) gives one row with a null element. Numeric
        elements make a float column on the device, strings a host
        column. The row plan is built on the host from the cell lengths;
        device columns gather by ``index_select``."""
        arr = self._data.get(column)
        if arr is None:
            raise ValueError(f"no column {column!r}")
        first = next((c for c in arr if c is not None), None) \
            if is_host_column(arr) else None
        if not is_host_column(arr) or (
                first is not None
                and not isinstance(first, (list, tuple, np.ndarray))):
            raise ValueError("explode() expects an array column (e.g. "
                             "split() output)")
        idx = np.flatnonzero(self._host_mask())
        cells = arr[idx]
        lens = np.asarray([len(c) if c is not None else 0 for c in cells],
                          np.int64)
        src = np.repeat(idx, np.maximum(lens, 1) if keep_nulls else lens)
        values: list = []
        for c, ln in zip(cells, lens):
            if ln:
                values.extend(c)
            elif keep_nulls:
                values.append(None)
        src_dev = torch.as_tensor(src, device=self.device)
        data: dict[str, object] = {}
        for name, col in self._data.items():
            if name != column:
                data[name] = (col[src] if is_host_column(col)
                              else col.index_select(0, src_dev))
        non_null = [v for v in values if v is not None]
        if non_null and all(isinstance(v, (int, float, np.integer,
                                           np.floating)) for v in non_null):
            data[output_col or column] = torch.as_tensor(
                [np.nan if v is None else float(v) for v in values],
                dtype=float_dtype(), device=self.device)
        else:
            out = np.empty(len(values), dtype=object)
            for i, v in enumerate(values):      # a list element stays one
                out[i] = v                      # cell, never a 2-D array
            data[output_col or column] = out
        return Frame(data, device=self.device)

    def select_expr(self, *exprs: str) -> "Frame":
        """``selectExpr``: SQL select-list strings over this frame, through
        a scratch catalog so no temp view leaks."""
        from ..sql.catalog import Catalog
        from ..sql.parser import execute

        cat = Catalog()
        cat.register("__this__", self)
        return execute(f"SELECT {', '.join(exprs)} FROM __this__",
                       catalog=cat)

    selectExpr = select_expr

    def drop(self, *names: str) -> "Frame":
        return self._with(data={k: v for k, v in self._data.items()
                                if k not in names})

    def limit(self, n: int) -> "Frame":
        keep = torch.cumsum(self._mask.to(torch.int64), 0) <= n
        return self._with(mask=self._mask & keep)

    def offset(self, n: int) -> "Frame":
        """Skip the first ``n`` valid rows (SQL OFFSET)."""
        keep = torch.cumsum(self._mask.to(torch.int64), 0) > n
        return self._with(mask=self._mask & keep)

    def union(self, other: "Frame") -> "Frame":
        """``union``/``unionAll``: rows of both frames, by position."""
        if self.columns != other.columns:
            raise ValueError("union requires identical column lists")
        data = {}
        for name in self.columns:
            a, b = self._data[name], other._data[name]
            if is_host_column(a) or is_host_column(b):
                data[name] = np.concatenate([np.asarray(a, object),
                                             np.asarray(b, object)])
            else:
                data[name] = torch.cat([a, b.to(a.device)])
        f = Frame(data, device=self.device)
        f._mask = torch.cat([self._mask, other._mask.to(self.device)])
        return f

    unionAll = union

    def dropna(self, how="any", thresh=None, subset=None) -> "Frame":
        """Mask out null rows (``na.drop``): ``how`` "any"|"all", ``thresh``
        the least non-null count (overrides ``how``), ``subset`` the
        columns considered. NaN and None are null."""
        if isinstance(how, (list, tuple)):
            subset, how = list(how), "any"
        if how not in ("any", "all"):
            raise ValueError(f"how={how!r}; expected 'any' or 'all'")
        cols = subset if subset is not None else self.columns
        nonnull = torch.zeros(self._n, dtype=torch.int32, device=self.device)
        for name in cols:
            arr = self._column_values(name)
            if is_host_column(arr):
                ok = torch.as_tensor([x is not None for x in arr],
                                     dtype=torch.bool, device=self.device)
            elif arr.is_floating_point():
                nan = torch.isnan(arr)
                ok = ~(nan.flatten(1).any(1) if nan.ndim > 1 else nan)
            else:
                ok = torch.ones(self._n, dtype=torch.bool, device=self.device)
            nonnull = nonnull + ok.to(torch.int32)
        if thresh is not None:
            keep = nonnull >= int(thresh)
        elif how == "all":
            keep = nonnull > 0
        else:
            keep = nonnull == len(cols)
        return self._with(mask=self._mask & keep)

    def fillna(self, value, subset=None) -> "Frame":
        """Replace NaN (None) with ``value`` in the [subset] float (string)
        columns; a dict maps column -> value."""
        if isinstance(value, dict):
            out = self
            for name, v in value.items():
                out = out.fillna(v, subset=[name])
            return out
        cols = subset if subset is not None else self.columns
        data = dict(self._data)
        for name in cols:
            arr = self._data[name]
            if is_host_column(arr):
                if isinstance(value, str):
                    data[name] = np.asarray([value if x is None else x
                                             for x in arr], dtype=object)
            elif arr.is_floating_point() and isinstance(value, (int, float)):
                data[name] = torch.where(torch.isnan(arr), torch.full(
                    (), float(value), dtype=arr.dtype, device=arr.device),
                    arr)
        return self._with(data=data)

    @property
    def na(self) -> "_NAFunctions":
        """``df.na``: ``fill`` -> ``fillna``, ``drop`` -> ``dropna``."""
        return _NAFunctions(self)

    # -- relational verbs ----------------------------------------------------
    def group_by(self, *keys: str):
        """``groupBy``: a GroupedFrame with agg/count/avg/..."""
        from .aggregates import GroupedFrame

        return GroupedFrame(self, list(keys))

    groupBy = group_by

    def agg(self, *aggs):
        """Global aggregates (no grouping): masked device reductions."""
        from .aggregates import (AggExpr, _dict_aggs, global_agg,
                                 materialize_agg_exprs)

        if len(aggs) == 1 and isinstance(aggs[0], dict):
            aggs = tuple(_dict_aggs(aggs[0]))
        agg_list = [a if isinstance(a, AggExpr) else AggExpr(a, None)
                    for a in aggs]
        frame, agg_list = materialize_agg_exprs(self, agg_list)
        return global_agg(frame, agg_list)

    def sort(self, *cols, ascending=True) -> "Frame":
        """``orderBy``: the valid rows in key order (a compact frame).
        Columns are names, ``Col``s or ``col.asc()``/``col.desc()`` markers
        (a marker's direction and null placement override ``ascending``).
        Nulls sort first ascending and last descending (Spark); ties keep
        row order."""
        from ..ops.segments import device_sort

        if not cols:
            raise ValueError("sort requires at least one column")
        asc = ([ascending] * len(cols) if isinstance(ascending, bool)
               else list(ascending))
        if len(asc) != len(cols):
            raise ValueError("ascending list must match columns")
        nulls_first: list = [None] * len(cols)
        names = []
        for i, c in enumerate(cols):
            if isinstance(c, SortOrder):
                name = c.name
                asc[i] = c.ascending
                nulls_first[i] = c.nulls_first
            else:
                name = c if isinstance(c, str) else c.name
            if name not in self._data:
                raise ValueError(
                    f"sort key {name!r} is not a column of this frame "
                    "(sorting by a computed expression is not supported — "
                    "add it with with_column first)")
            names.append(name)
        return device_sort(self, names, asc, nulls_first)

    orderBy = order_by = sort

    def distinct(self) -> "Frame":
        """Unique valid rows in first-occurrence order (a compact frame);
        NaN cells equal each other, as in Spark's null-safe dedup."""
        from ..ops.segments import _empty_frame, device_unique

        if self._n == 0 or (any(map(is_host_column, self._data.values()))
                            and not bool(self._mask.any())):
            # the JAX package's host path (an empty frame, or any string
            # column) rebuilds the empty result from row lists: every
            # column takes the float dtype
            return _empty_frame(self.columns, self.device)
        return device_unique(self, self.columns)

    def drop_duplicates(self, subset=None) -> "Frame":
        """``dropDuplicates``: the first valid row per distinct ``subset``
        key combination (all columns kept); without a subset, ``distinct``."""
        from ..ops.segments import device_unique

        if subset is None:
            return self.distinct()
        if isinstance(subset, str):
            subset = [subset]
        for c in subset:
            if c not in self._data:
                raise ValueError(f"dropDuplicates column {c!r} not found")
        return device_unique(self, list(subset))

    dropDuplicates = drop_duplicates

    def join(self, other: "Frame", on=None, how: str = "inner") -> "Frame":
        """Join on key column(s) present in both frames (Spark's USING
        semantics: each key appears once). ``how``: inner, left, right,
        outer/full, left_semi, left_anti, cross. A non-key name on both
        sides keeps the left column and names the right one
        ``<name>_right``. The row-pair plan is built on the host from one
        pull of the masks and key columns; every payload column is gathered
        on the device (``index_select``). Unmatched sides of outer joins
        fill with NaN, and an int column becomes float for it."""
        how = how.lower().replace("fullouter", "outer").replace(
            "full", "outer")
        if how not in _JOIN_TYPES:
            raise ValueError(f"unknown join type {how!r}; expected one of "
                             f"{_JOIN_TYPES}")
        keys = [on] if isinstance(on, str) else list(on or [])
        if how != "cross":
            if not keys:
                raise ValueError("join requires `on` key column(s)")
            for k in keys:
                if k not in self._data or k not in other._data:
                    raise ValueError(f"join key {k!r} must exist in both "
                                     "frames")
                a, b = self._data[k], other._data[k]
                if is_host_column(a) != is_host_column(b) or (
                        not is_host_column(a) and (a.ndim != 1
                                                   or b.ndim != 1)):
                    raise NotImplementedError(
                        f"join key {k!r}: the torch port joins 1-D numeric "
                        "keys with numeric keys and string keys with "
                        "string keys")

        # a string key as its codes in one dictionary of both sides: None
        # codes as NULL_CODE on both, so a null key meets a null key, as
        # in the JAX package's dict plan
        shared = {k: strings.shared_codes(self._data[k], other._data[k])[0]
                  for k in keys if how != "cross"
                  and is_host_column(self._data[k])}

        def pull(frame, side: int):
            """The valid rows and the key columns on the host."""
            host = [frame._mask.cpu().numpy()]
            for k in (keys if how != "cross" else []):
                host.append(shared[k][side] if k in shared
                            else frame._data[k].cpu().numpy())
            return np.nonzero(host[0])[0], host[1:]

        li, lk = pull(self, 0)
        ri, rk = pull(other, 1)
        if how == "cross":
            lpairs = np.repeat(li, len(ri))
            rpairs = np.tile(ri, len(li))
        elif ri.size == 0:
            if how in ("inner", "right", "left_semi"):
                lpairs = rpairs = np.empty(0, np.int64)
            else:                                # left / outer / left_anti
                lpairs = li.astype(np.int64)
                rpairs = np.full(li.size, -1, np.int64)
        else:
            lpairs, rpairs = _join_plan([k[li] for k in lk],
                                        [k[ri] for k in rk], li, ri, how)

        left_cols = self._gather_rows(lpairs, how in ("right", "outer"))
        if how in ("left_semi", "left_anti"):
            return Frame(left_cols, device=self.device)
        right_cols = other._gather_rows(
            rpairs, how in ("left", "outer", "left_anti"))
        data = dict(left_cols)
        if how in ("right", "outer") and lpairs.size and (lpairs < 0).any():
            # USING: one key column, taken from the side that has the row
            miss = lpairs < 0
            miss_dev = torch.as_tensor(miss, device=self.device)
            for k in keys:
                lkc = data[k]
                data[k] = (np.where(miss, right_cols[k], lkc)
                           if is_host_column(lkc) else
                           torch.where(miss_dev, right_cols[k].to(lkc.dtype),
                                       lkc))
        for name, col in right_cols.items():
            if name in keys:
                continue
            data[name + "_right" if name in data else name] = col
        return Frame(data, device=self.device)

    def cross_join(self, other: "Frame") -> "Frame":
        return self.join(other, on=None, how="cross")

    crossJoin = cross_join

    def _gather_rows(self, idx: np.ndarray, fill_missing: bool) -> dict:
        """Every column at the host row indices ``idx`` (-1 = a missing
        partner, filled with NaN/None when ``fill_missing``): one
        host->device copy of the indices, then ``index_select`` per
        column."""
        missing = idx < 0
        safe = np.where(missing, 0, idx)
        safe_dev = torch.as_tensor(safe, dtype=torch.int64,
                                   device=self.device)
        miss_dev = (torch.as_tensor(missing, device=self.device)
                    if fill_missing and missing.any() else None)
        out = {}
        for name, arr in self._data.items():
            if is_host_column(arr):
                col = np.asarray(arr, dtype=object)[safe] if self._n \
                    else np.full(len(idx), None, dtype=object)
                if fill_missing and missing.any():
                    col = col.copy()
                    col[missing] = None
                out[name] = col
                continue
            if self._n == 0 and len(idx):
                # gathering from an empty side: every index is missing
                out[name] = torch.full((len(idx),) + tuple(arr.shape[1:]),
                                       float("nan"), dtype=float_dtype(),
                                       device=self.device)
                continue
            col = arr.index_select(0, safe_dev)
            if miss_dev is not None:
                if not col.is_floating_point():
                    col = col.to(float_dtype())
                m = miss_dev.view((-1,) + (1,) * (col.ndim - 1))
                col = torch.where(m, torch.full((), float("nan"),
                                                dtype=col.dtype,
                                                device=col.device), col)
            out[name] = col
        return out

    def filter(self, condition: Union[Expr, torch.Tensor]) -> "Frame":
        """AND a predicate into the validity mask; a NULL (NaN) predicate
        drops the row, as Spark's WHERE does."""
        cond = self._eval(condition)
        return self._with(mask=self._mask & predicate_keep_mask(cond))

    def random_split(self, weights: Sequence[float],
                     seed: int = 0) -> list["Frame"]:
        """Split the rows into disjoint frames with the given relative
        weights (``df.randomSplit([0.8, 0.2], seed)``). The draw is the JAX
        package's (one numpy uniform per row slot), so both packages split
        alike. The splits share the columns; only the masks differ."""
        w = np.asarray(weights, np.float64)
        if w.ndim != 1 or len(w) < 1 or np.any(w < 0) or w.sum() == 0:
            raise ValueError(f"invalid split weights {weights!r}")
        edges = np.cumsum(w / w.sum())
        u = np.random.default_rng(seed).random(self._n)
        out = []
        lo = 0.0
        for hi in edges:
            pick = torch.as_tensor((u >= lo) & (u < hi), device=self.device)
            out.append(self._with(mask=self._mask & pick))
            lo = hi
        return out

    randomSplit = random_split

    # -- actions -------------------------------------------------------------
    def count(self) -> int:
        """Number of valid (unmasked) rows."""
        return int(self._mask.sum())

    def _host_mask(self) -> np.ndarray:
        return self._mask.cpu().numpy()

    def collect(self, limit: Optional[int] = None) -> list:
        d = self.to_pydict(limit)
        cols = [d[name] for name in self.columns]
        return [tuple(row) for row in zip(*cols)] if cols else []

    def take(self, n: int) -> list:
        return self.collect(limit=n)

    def head(self, n: int = 1):
        rows = self.take(n)
        return rows if n != 1 else (rows[0] if rows else None)

    def first(self):
        return self.head(1)

    def to_pydict(self, limit: Optional[int] = None) -> dict:
        """The valid rows on the host, as numpy arrays; ``limit`` gathers
        only the first ``limit`` valid rows."""
        m = self._host_mask()
        if limit is not None:
            keep = np.cumsum(m) <= limit
            m = m & keep
            m = m[:(int(np.argmax(~keep)) if not keep.all() else len(m))]
        out = {}
        for name, arr in self._data.items():
            host = arr[:len(m)]
            if isinstance(host, torch.Tensor):
                host = host.cpu().numpy()
            out[name] = np.asarray(host)[m]
        return out

    # -- display -------------------------------------------------------------
    @staticmethod
    def _format_cell(v, truncate: int) -> str:
        if isinstance(v, (np.floating, float)):
            if np.isnan(v):
                s = "NaN"
            elif isinstance(v, np.floating):
                # shortest round-trip repr at the column's own precision
                s = np.format_float_positional(v, unique=True, trim="0")
            else:
                s = repr(float(v))
        elif isinstance(v, (np.bool_, bool)):
            s = "true" if v else "false"
        elif isinstance(v, (np.integer, int)):
            s = str(int(v))
        elif isinstance(v, np.ndarray):  # vector cell, Spark-style: [40.0]
            s = "[" + ",".join(
                np.format_float_positional(x, unique=True, trim="0")
                if isinstance(x, np.floating) else str(x) for x in v) + "]"
        elif v is None:
            s = "null"
        else:
            s = str(v)
        if truncate > 0 and len(s) > truncate:
            s = s[: truncate - 3] + "..." if truncate > 3 else s[:truncate]
        return s

    def show_string(self, n: int = None,
                    truncate: Union[bool, int] = True) -> str:
        """Spark-format ASCII table (right-aligned cells, +---+ borders,
        ``only showing top N rows`` footer)."""
        if n is None:
            n = config.default_show_rows
        tr = 20 if truncate is True else (0 if truncate is False
                                          else int(truncate))
        total = int(self._host_mask().sum())
        d = self.to_pydict(limit=n)
        names = self.columns
        shown = len(next(iter(d.values()))) if d else 0
        rows = [[self._format_cell(d[name][i], tr) for name in names]
                for i in range(shown)]
        headers = [name if tr <= 0 or len(name) <= tr
                   else name[: tr - 3] + "..." for name in names]
        widths = [max([len(h)] + [len(r[j]) for r in rows])
                  for j, h in enumerate(headers)]
        sep = "+" + "+".join("-" * w for w in widths) + "+"
        out = [sep, "|" + "|".join(h.rjust(w) for h, w in
                                   zip(headers, widths)) + "|", sep]
        for r in rows:
            out.append("|" + "|".join(c.rjust(w) for c, w in
                                      zip(r, widths)) + "|")
        out.append(sep)
        text = "\n".join(out) + "\n"
        if total > n:
            text += f"only showing top {n} rows\n"
        return text

    def show(self, n: int = None, truncate: Union[bool, int] = True) -> None:
        print(self.show_string(n, truncate))

    def __repr__(self):
        fields = ", ".join(f"{name}: {t}" for name, t in self.dtypes())
        return f"Frame[{fields}]"

    # -- temp views ----------------------------------------------------------
    def create_or_replace_temp_view(self, name: str) -> None:
        """Register this frame in the catalog for SQL access."""
        from ..sql.catalog import default_catalog

        default_catalog().register(name, self)

    createOrReplaceTempView = create_or_replace_temp_view


class _NAFunctions:
    """``df.na`` (Spark's ``DataFrameNaFunctions``): ``fill`` and ``drop``."""

    def __init__(self, frame: Frame):
        self._frame = frame

    def fill(self, value, subset=None) -> Frame:
        return self._frame.fillna(value, subset=subset)

    def drop(self, how="any", thresh=None, subset=None) -> Frame:
        return self._frame.dropna(how=how, thresh=thresh, subset=subset)
