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

Pipeline compiler (``ops/compiler.py``): consecutive *compilable*
``with_column``/``with_columns``/``filter`` calls do not run one at a
time; they accumulate as pending steps (``_pending``) and run as ONE
cached plan (the eager path's kernels, through one trace frame) at the
first read of ``_data``/``_mask``. ``select`` fuses its projection
expressions into the same flush. Frames stay immutable and eager-equivalent: the flush is a
cache fill, semantics are bit-identical, and ``config.pipeline = False``
(``spark.pipeline.enabled``) restores the exact per-op eager path.
"""

from __future__ import annotations

import io
import logging
import threading
from typing import Iterable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..config import (config, float_dtype, int_dtype, resolve_device,
                      wide_types)
from ..ops import strings
from ..ops.cells import list_column  # noqa: F401 - the package exports it
from ..ops.expressions import (Alias, Col, Explode, Expr, JsonTuple,
                               SortOrder, is_host_column,
                               predicate_keep_mask, spark_type_name)
from ..utils.observability import op_span
from ..utils.profiling import counters

logger = logging.getLogger("sparkdq4ml_tpu_torch.frame")

# Guards the lazy creation of a frame's flush lock (Frame._lock).
_LOCK_FILL = threading.Lock()

def _step_names(pending) -> list[str]:
    """The columns pending pipeline steps produce, in order."""
    names: list[str] = []
    for s in pending:
        if s[0] == "with_column":
            names.append(s[1])
        elif s[0] == "with_columns":
            names.extend(n for n, _ in s[1])
    return names


def _lower_all(exprs, data: dict, pending) -> Optional[tuple]:
    """The lowerings (``ops/compiler.lower``) of ``exprs`` against the
    stored columns ``data`` and the ``pending`` steps, or None when one is
    not a compilable expression."""
    from ..ops.compiler import LazySchema, lower

    schema = LazySchema(data, _step_names(pending))
    lows = []
    for e in exprs:
        low = lower(e, schema)
        if low is None:
            return None
        lows.append(low)
    return tuple(lows)


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
    """Immutable columnar frame with a validity mask (see the module
    docstring for the pipeline's deferral)."""

    _pending: tuple = ()          # deferred pipeline steps (see _defer)
    _flush_lock = None            # per-frame flush serializer (see _lock)

    # _data/_mask are flush-on-read properties, so every consumer (frame
    # methods, aggregates, models, tests reading internals) sees the
    # materialized state without knowing the pipeline exists.
    @property
    def _data(self) -> dict:
        if self._pending:
            self._flush()
        return self._data_store

    @_data.setter
    def _data(self, value: dict) -> None:
        self._data_store = value

    @property
    def _mask(self):
        if self._pending:
            self._flush()
        return self._mask_store

    @_mask.setter
    def _mask(self, value) -> None:
        self._mask_store = value

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

    # -- pipeline compiler plumbing (ops/compiler.py) ----------------------
    def _lock(self):
        """This frame's flush serializer, created on first need; reentrant,
        as an eager replay re-enters on the same frame."""
        lk = self._flush_lock
        if lk is None:
            with _LOCK_FILL:
                lk = self._flush_lock
                if lk is None:
                    lk = self._flush_lock = threading.RLock()
        return lk

    def _snapshot(self) -> tuple:
        """A consistent (data store, mask store, pending) triple against a
        concurrent flush of this frame."""
        with self._lock():
            return self._data_store, self._mask_store, self._pending

    def _defer(self, step, *exprs) -> Optional["Frame"]:
        """A new frame sharing this one's stored columns and mask, with
        ``step`` appended to the pending pipeline together with the
        lowerings (``ops/compiler.lower``) of its expressions ``exprs``
        (one for a filter or with_column, a tuple for with_columns), made
        here, once, for its flush to reuse. None when the pipeline is off,
        the frame has no rows, or an expression is not compilable: the
        caller runs the step eagerly. A flush never mutates a shared
        store, and compilable steps are pure, so sibling frames replaying a
        shared prefix stay correct."""
        if not config.pipeline or self._n == 0:
            return None
        data, mask, pending = self._snapshot()
        lows = _lower_all(exprs, data, pending)
        if lows is None:
            return None
        f = Frame.__new__(Frame)
        f._data_store = data
        f._mask_store = mask
        f._pending = pending + (
            step + ((lows if step[0] == "with_columns" else lows[0]),),)
        f.device = self.device
        f._n = self._n
        return f

    def _pending_names(self) -> list[str]:
        return _step_names(self._pending)

    def _flush(self) -> None:
        """Materialize the pending steps as one cached plan, or, when the
        compiler fails (a lowering failure, counted
        ``pipeline.fallback``), by eager per-op replay. A device error
        escapes as it is.

        ``_pending`` is cleared only after the new stores are published: if
        even the eager replay raises, every later read raises the same
        error instead of serving the pre-op state."""
        from ..ops.compiler import PipelineError, run_pipeline

        with self._lock():
            steps = self._pending
            if not steps:
                return
            try:
                new_data, new_mask, _ = run_pipeline(
                    self._data_store, self._mask_store, self._n, steps)
            except PipelineError as e:
                logger.debug("pipeline flush fell back to eager replay: %s",
                             e)
                new_data, new_mask = self._eager_replay(steps)
            self._data_store = new_data
            self._mask_store = new_mask
            self._pending = ()

    def _eager_replay(self, steps):
        """Apply pipeline steps through the eager code paths."""
        f = self._with(data=self._data_store, mask=self._mask_store)
        for s in steps:
            if s[0] == "with_column":
                f = f._with_column_eager(s[1], s[2])
            elif s[0] == "with_columns":
                f = f._with_columns_eager(dict(s[1]))
            else:
                f = f._filter_eager(s[1])
        return f._data_store, f._mask_store

    # -- introspection -----------------------------------------------------
    @property
    def columns(self) -> list[str]:
        if not self._pending:
            return list(self._data_store)
        # pending with_column targets are columns too, without a flush
        out = list(self._data_store)
        seen = set(out)
        for n in self._pending_names():
            if n not in seen:
                seen.add(n)
                out.append(n)
        return out

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
        # a name check, not a value read: a pending pipeline stays pending
        if name not in self.columns:
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
    @op_span("frame.with_column")
    def with_column(self, name: str, values) -> "Frame":
        """``withColumn``: add or replace a column. A compilable expression
        defers into the fused pipeline."""
        f = self._defer(("with_column", name, values), values)
        return f if f is not None else self._with_column_eager(name, values)

    def _with_column_eager(self, name: str, values) -> "Frame":
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

    def with_columns_renamed(self, mapping: Mapping[str, str]) -> "Frame":
        """Spark 3.4's ``withColumnsRenamed``: a batch rename; absent keys
        are no-ops. A target that collides with a column keeping its name
        raises (the frame cannot hold two columns of one name); swaps are
        legal."""
        renamed_away = {k for k, new in mapping.items()
                        if k in self._data and new != k}
        data: dict = {}
        for k, v in self._data.items():
            nk = mapping.get(k, k)
            if nk in data or (nk != k and nk in self._data
                              and nk not in renamed_away):
                raise ValueError(
                    f"withColumnsRenamed: rename target {nk!r} collides "
                    "with an existing column; the engine cannot hold "
                    "duplicate column names (rename or drop the other "
                    f"{nk!r} first)")
            data[nk] = v
        return self._with(data=data)

    withColumnsRenamed = with_columns_renamed

    def to_df(self, *names: str) -> "Frame":
        """``toDF``: rename every column by position; names must be
        unique."""
        if len(names) != len(self.columns):
            raise ValueError(f"toDF expects {len(self.columns)} names, "
                             f"got {len(names)}")
        if len(set(names)) != len(names):
            raise ValueError(f"toDF names must be unique, got {list(names)}")
        return self._with(data={new: self._data[old]
                                for new, old in zip(names, self.columns)})

    toDF = to_df

    def transform(self, func, *args, **kwargs) -> "Frame":
        """Spark's ``df.transform(fn)``: chainable function application."""
        out = func(self, *args, **kwargs)
        if not isinstance(out, Frame):
            raise TypeError("transform function must return a Frame, got "
                            f"{type(out).__name__}")
        return out

    def replace(self, to_replace, value=None, subset=None) -> "Frame":
        """``df.replace``: substitute exact values in the ``subset``
        columns; a scalar pair, a list and a scalar, two lists, or a
        ``{old: new}`` dict. String keys apply to string columns, numeric
        keys to numeric ones; a None or float replacement widens an int
        column to the policy's float dtype (the JAX package's rule)."""
        if isinstance(to_replace, dict):
            mapping = to_replace
        elif isinstance(to_replace, (list, tuple)):
            if isinstance(value, (list, tuple)):
                if len(value) != len(to_replace):
                    raise ValueError(
                        f"replace: value list length {len(value)} != "
                        f"to_replace length {len(to_replace)}")
                mapping = dict(zip(to_replace, value))
            else:
                mapping = {v: value for v in to_replace}
        else:
            mapping = {to_replace: value}
        data = dict(self._data)
        for name in (subset if subset is not None else self.columns):
            arr = self._data[name]
            if is_host_column(arr):
                str_map = {k: v for k, v in mapping.items()
                           if isinstance(k, str)}
                if str_map:
                    data[name] = np.asarray(
                        [str_map.get(x, x) for x in arr], dtype=object)
                continue
            num_map = {k: v for k, v in mapping.items()
                       if isinstance(k, (int, float))
                       and not isinstance(k, bool)}
            if not num_map:
                continue
            col = arr            # every key is matched against the source
            if any(v is None or isinstance(v, float)
                   for v in num_map.values()) and not arr.is_floating_point():
                col = col.to(float_dtype())
            for old, new in num_map.items():
                new = float("nan") if new is None else new
                col = torch.where(arr == old, torch.tensor(
                    new, device=col.device).to(col.dtype), col)
            data[name] = col
        return self._with(data=data)

    def col_regex(self, pattern: str) -> list:
        """Spark's ``colRegex``: the columns whose names match the regex
        (backticks allowed), for ``select``."""
        import re

        pat = pattern.strip()
        if pat.startswith("`") and pat.endswith("`"):
            pat = pat[1:-1]
        rx = re.compile(pat)
        return [Col(c) for c in self.columns if rx.fullmatch(c)]

    colRegex = col_regex

    @property
    def schema(self) -> list[tuple[str, str]]:
        """``[(name, spark type name)]``, the pairs of ``dtypes()``."""
        return self.dtypes()

    def alias(self, name: str) -> "Frame":
        """Record a frame alias on this frame (Spark ``alias``); derived
        frames do not inherit it."""
        out = self._with()
        out._alias = name
        return out

    # -- no-ops for API parity: one device, no partitions, no lineage -------
    @op_span("frame.cache")
    def cache(self) -> "Frame":
        """Materialize and pin: flush any pending pipeline, then wait for
        the frame's device work, so that ``cache()`` bounds a timing as in
        the JAX package (which blocks until ready); counts
        ``frame.cache``."""
        self._data              # the flush
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        counters.increment("frame.cache")
        return self

    persist = cache

    def unpersist(self, blocking: bool = False) -> "Frame":
        return self

    def repartition(self, num_partitions: int, *cols) -> "Frame":
        return self

    def coalesce(self, num_partitions: int) -> "Frame":
        return self

    def hint(self, name: str, *parameters) -> "Frame":
        return self

    def checkpoint(self, eager: bool = True) -> "Frame":
        return self

    localCheckpoint = local_checkpoint = checkpoint

    def with_columns(self, cols_map: Mapping[str, object]) -> "Frame":
        """``withColumns``: every expression resolves against the input
        frame (Spark semantics). When every expression is compilable the
        batch defers as ONE pipeline step."""
        items = tuple(cols_map.items())
        f = (self._defer(("with_columns", items), *[v for _, v in items])
             if items else None)
        return f if f is not None else self._with_columns_eager(cols_map)

    def _with_columns_eager(self, cols_map: Mapping[str, object]) \
            -> "Frame":
        evaluated = {name: self._eval(v) for name, v in cols_map.items()}
        data = dict(self._data)
        data.update(evaluated)
        return self._with(data=data)

    withColumns = with_columns

    @op_span("frame.select")
    def select(self, *exprs: Union[str, Expr]) -> "Frame":
        """Project columns and expressions. One row generator (a bare
        ``Explode`` or an alias of one: ``explode``, ``explode_outer``,
        ``posexplode``) may stand among them: the other items are computed
        first, then each row repeats once for every element of its array
        cell (Spark's rule). A ``json_tuple`` item expands in place into
        its c0...cN columns, with no row multiplication."""
        flat = []
        for e in exprs:
            flat.extend(e if isinstance(e, (list, tuple)) else [e])
        gens = [e for e in flat if isinstance(e, Explode) or (
            isinstance(e, Alias) and isinstance(e.child, Explode))]
        if len(gens) > 1:
            raise ValueError("only one explode() per select (Spark rule)")
        # compilable projection expressions run in ONE flush together with
        # any pending steps (the SQL SELECT-list + WHERE path)
        pre = self._precompute_select(flat, gens)
        data: dict[str, object] = {}
        for e in flat:
            if isinstance(e, str):
                if e == "*":
                    data.update(self._data)
                    continue
                e = Col(e)
            if any(e is g for g in gens):
                continue
            if isinstance(e, JsonTuple):
                data.update(e.columns(self))
                continue
            if id(e) in pre:
                data[e.name] = pre[id(e)]
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
        return self._with(data=data).explode(
            tmp, g.name, keep_nulls=inner.outer,
            position_col="pos" if inner.with_position else None)

    def _precompute_select(self, exprs, gens) -> dict:
        """Run the compilable select expressions (and any pending steps) in
        one flush; returns ``{id(expr): column}`` for :meth:`select`. An
        empty dict means nothing fused."""
        if not config.pipeline or self._n == 0:
            return {}
        from ..ops.compiler import (LazySchema, PipelineError, lower,
                                    run_pipeline)

        with self._lock():
            steps = self._pending
            schema = LazySchema(self._data_store, _step_names(steps))
            cand = []
            for e in exprs:
                if (isinstance(e, Expr) and not isinstance(e, JsonTuple)
                        and not any(e is g for g in gens)
                        and not isinstance(e, Col)):    # plain refs: free
                    low = lower(e, schema)
                    if low is not None:
                        cand.append((e, low))
            # fusing pays when a pending chain flushes anyway or when two
            # or more expressions share one plan
            if not cand or (not steps and len(cand) < 2):
                return {}
            extra = [(f"__sel_{i}", e, low)
                     for i, (e, low) in enumerate(cand)]
            try:
                new_data, new_mask, extras = run_pipeline(
                    self._data_store, self._mask_store, self._n, steps,
                    extra)
            except PipelineError as e:
                logger.debug("fused select fell back to eager: %s", e)
                return {}
            self._data_store = new_data
            self._mask_store = new_mask
            self._pending = ()
        return {id(e): extras[f"__sel_{i}"]
                for i, (e, _) in enumerate(cand)}

    @op_span("frame.explode")
    def explode(self, column: str, output_col: Optional[str] = None,
                keep_nulls: bool = False,
                position_col: Optional[str] = None) -> "Frame":
        """Spark's ``explode``: one row for each element of each valid
        row's array cell (a compact frame), the other columns repeated;
        a null or empty cell drops its row, or with ``keep_nulls``
        (``explode_outer``) gives one row with a null element. Numeric
        elements make a float column on the device, strings a host
        column. With ``position_col`` (``posexplode``), each element's
        0-based position goes into that column, placed just before the
        value column (Spark's (pos, col) order): int32, or the policy's
        float with NaN where ``keep_nulls`` gave a null row. The row plan
        is built on the host from the cell lengths; device columns gather
        by ``index_select``."""
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
        positions: list = []
        for c, ln in zip(cells, lens):
            if ln:
                values.extend(c)
                positions.extend(range(ln))
            elif keep_nulls:
                values.append(None)
                positions.append(None)
        src_dev = torch.as_tensor(src, device=self.device)
        data: dict[str, object] = {}
        for name, col in self._data.items():
            if name != column:
                data[name] = (col[src] if is_host_column(col)
                              else col.index_select(0, src_dev))
        out_name = output_col or column
        non_null = [v for v in values if v is not None]
        if non_null and all(isinstance(v, (int, float, np.integer,
                                           np.floating)) for v in non_null):
            data[out_name] = torch.as_tensor(
                [np.nan if v is None else float(v) for v in values],
                dtype=float_dtype(), device=self.device)
        else:
            out = np.empty(len(values), dtype=object)
            for i, v in enumerate(values):      # a list element stays one
                out[i] = v                      # cell, never a 2-D array
            data[out_name] = out
        if position_col is not None:
            if position_col in data:
                raise ValueError(
                    f"position column {position_col!r} collides with an "
                    "existing output column")
            if any(p is None for p in positions):
                pos = torch.as_tensor(
                    [np.nan if p is None else float(p) for p in positions],
                    dtype=float_dtype(), device=self.device)
            else:
                pos = torch.as_tensor(np.asarray(positions, np.int32),
                                      device=self.device)
            ordered: dict[str, object] = {}
            for k, v in data.items():
                if k == out_name:
                    ordered[position_col] = pos
                ordered[k] = v
            data = ordered
        return Frame(data, device=self.device)

    def unpivot(self, ids, values=None, variable_column_name: str = "variable",
                value_column_name: str = "value") -> "Frame":
        """Spark 3.4's ``unpivot``/``melt``: wide to long. ``ids`` stay as
        identifier columns; each of ``values`` (default: every other
        column) gives one output row per valid input row, tagged with its
        name, row-major as Spark orders it (row 0's values first). A
        compact frame: the numeric columns are built on the device
        (``repeat_interleave`` and a stack, the values as float64 first,
        as the JAX package's numpy reshape does), the variable column is
        a host string column."""
        ids = [ids] if isinstance(ids, str) else list(ids)
        if values is None:
            values = [c for c in self.columns if c not in ids]
        values = [values] if isinstance(values, str) else list(values)
        if not values:
            raise ValueError("unpivot requires at least one value column")
        for c in ids + values:
            if c not in self.columns:
                raise ValueError(f"unpivot column {c!r} is not a column")
        for c in values:
            if is_host_column(self._data[c]):
                raise ValueError(f"unpivot value column {c!r} is not "
                                 "numeric")
        host = np.flatnonzero(self._host_mask())
        idx = torch.as_tensor(host, device=self.device)
        n, k = len(host), len(values)
        data: dict[str, object] = {}
        for c in ids:
            col = self._data[c]
            data[c] = (np.repeat(col[host], k) if is_host_column(col)
                       else col.index_select(0, idx).repeat_interleave(k,
                                                                      dim=0))
        data[variable_column_name] = np.asarray(values * n, dtype=object)
        stacked = torch.stack([self._data[c].index_select(0, idx).to(
            torch.float64) for c in values], dim=1).reshape(-1)
        data[value_column_name] = stacked.to(
            torch.float64 if wide_types() else float_dtype())
        return Frame(data, device=self.device)

    melt = unpivot

    def map_in_pandas(self, func, schema):
        """Spark 3's ``mapInPandas(fn, schema)``: ``func`` takes an
        iterator of pandas DataFrame batches (one batch: the whole frame)
        and yields output batches, concatenated on the host and cast to
        the DDL ``schema`` on the frame's device."""
        import pandas as pd

        from .csv import parse_ddl_schema

        fields = parse_ddl_schema(schema) if isinstance(schema, str) \
            else list(schema)
        outs = list(func(iter([self.to_pandas()])))
        for b in outs:
            if not isinstance(b, pd.DataFrame):
                raise TypeError("mapInPandas function must yield pandas "
                                f"DataFrames, got {type(b).__name__}")
        return pandas_result(outs, fields, self.device, "mapInPandas")

    mapInPandas = map_in_pandas

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

    def union_by_name(self, other: "Frame",
                      allow_missing_columns: bool = False) -> "Frame":
        """``unionByName``: union resolving columns by name. With
        ``allow_missing_columns`` a column only one side has fills with
        NaN (``None`` for a string column) on the other."""
        if allow_missing_columns:
            both = list(dict.fromkeys(self.columns + other.columns))

            def widen(frame):
                data = {}
                for name in both:
                    if name in frame._data:
                        data[name] = frame._data[name]
                        continue
                    ref = (other if name in other._data else self)._data[name]
                    data[name] = (np.full(frame.num_slots, None, dtype=object)
                                  if is_host_column(ref) else torch.full(
                                      (frame.num_slots,), float("nan"),
                                      dtype=float_dtype(),
                                      device=frame.device))
                return frame._with(data=data)

            return widen(self).union(widen(other))
        if set(self.columns) != set(other.columns):
            raise ValueError(
                f"unionByName: column sets differ {self.columns} vs "
                f"{other.columns}; pass allow_missing_columns=True")
        return self.union(other.select(*self.columns))

    unionByName = union_by_name

    def _set_op(self, other: "Frame", what: str, keep) -> "Frame":
        """The rows of this frame that ``keep(in_other, occurrence,
        budget)`` selects, in order, where the rows are keyed on the
        device (``segments.row_keys``: null-safe, ``-0.0 == 0.0``,
        ``1 == 1.0``; masked rows take no part): ``occurrence`` is the
        number of earlier left rows with the same key, ``budget`` the
        number of right rows with it. The result is rebuilt with the
        types the JAX package's ``Frame.from_rows`` gives its rows."""
        from ..ops.segments import (_empty_frame, gather_rows, narrow_dtype,
                                    occurrence_ranks, row_keys)

        if self.columns != other.columns:
            raise ValueError(f"{what} requires identical column lists")
        li, lk, _, _, rk, _ = row_keys(self, other)
        size = int(torch.cat([lk, rk]).max()) + 1 if lk.numel() else 0
        budget = torch.bincount(rk, minlength=size).index_select(0, lk)
        take = li[keep(budget > 0, occurrence_ranks(lk), budget)]
        if take.numel() == 0:
            return _empty_frame(self.columns, self.device)
        out = gather_rows(self, take)
        # Frame.from_rows' types: int64 to the int dtype, float64 to the
        # float dtype
        return out._with(data={
            name: arr if is_host_column(arr) else arr.to(narrow_dtype(
                arr.dtype)) for name, arr in out._data.items()})

    def intersect(self, other: "Frame") -> "Frame":
        """Distinct rows present in both frames (SQL INTERSECT,
        null-safe), in first-appearance order."""
        return self._set_op(other, "intersect",
                            lambda hit, occ, _: hit & (occ == 0))

    def except_all(self, other: "Frame") -> "Frame":
        """Rows of this frame not in ``other``, keeping duplicates (EXCEPT
        ALL): each of other's rows cancels the earliest equal row here."""
        return self._set_op(other, "exceptAll",
                            lambda _, occ, budget: occ >= budget)

    exceptAll = except_all

    def intersect_all(self, other: "Frame") -> "Frame":
        """Rows in both frames, each min(count here, count there) times
        (INTERSECT ALL), the earliest ones kept."""
        return self._set_op(other, "intersectAll",
                            lambda _, occ, budget: occ < budget)

    intersectAll = intersect_all

    def subtract(self, other: "Frame") -> "Frame":
        """Distinct rows of this frame not in ``other`` (SQL EXCEPT)."""
        return self._set_op(other, "subtract",
                            lambda hit, occ, _: ~hit & (occ == 0))

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

    def rollup(self, *keys: str):
        """``rollup``: subtotals over every key prefix plus the grand
        total, absent keys null (Spark ROLLUP)."""
        from .aggregates import MultiGroupedFrame, rollup_levels

        return MultiGroupedFrame(self, list(keys), rollup_levels(list(keys)))

    def cube(self, *keys: str):
        """``cube``: subtotals for every key subset (Spark CUBE)."""
        from .aggregates import MultiGroupedFrame, cube_levels

        return MultiGroupedFrame(self, list(keys), cube_levels(list(keys)))

    @property
    def stat(self):
        """``df.stat``: corr, cov, approxQuantile, crosstab, sampleBy and
        freqItems (Spark's DataFrameStatFunctions)."""
        from .stat import FrameStatFunctions

        return FrameStatFunctions(self)

    def corr(self, col1: str, col2: str, method: str = "pearson") -> float:
        return self.stat.corr(col1, col2, method)

    def cov(self, col1: str, col2: str) -> float:
        return self.stat.cov(col1, col2)

    def describe(self, *cols: str) -> "Frame":
        """Spark's ``describe``: count, mean, stddev, min and max rows of
        string cells (``str`` of each value in its column's type). A
        string column shows its non-null count and its least and greatest
        string, with null mean and stddev."""
        from .aggregates import AggExpr, global_agg

        if not cols:
            cols = tuple(name for name, arr in self._data.items()
                         if arr.ndim == 1)
        stats = ["count", "mean", "stddev", "min", "max"]
        fns = [{"mean": "avg"}.get(s, s) for s in stats]
        data: dict = {"summary": np.asarray(stats, dtype=object)}
        for c in cols:
            arr = self._data[c]
            if is_host_column(arr):
                codes, words = strings.codes(arr)
                present = np.unique(codes[self._host_mask()])
                present = present[present != strings.NULL_CODE]
                lo, hi = ((words[present[0]], words[present[-1]])
                          if present.size else (None, None))
                nn = int((codes[self._host_mask()]
                          != strings.NULL_CODE).sum())
                data[c] = np.asarray([str(nn), None, None, lo, hi],
                                     dtype=object)
                continue
            row = global_agg(self, [AggExpr(fn, c).alias(fn)
                                    for fn in fns]).to_pydict()
            data[c] = np.asarray([str(row[fn][0]) for fn in fns],
                                 dtype=object)
        return Frame(data, device=self.device)

    def summary(self, *stats: str) -> "Frame":
        """Spark's ``summary``: ``describe``'s rows plus percentiles
        (default: count, mean, stddev, min, 25%, 50%, 75%, max) of each
        numeric 1-D column. A percentile is numpy's linear quantile over
        the valid non-null values in float64, from one sort on the
        device."""
        from .aggregates import AggExpr, global_agg

        if not stats:
            stats = ("count", "mean", "stddev", "min", "25%", "50%", "75%",
                     "max")
        cols = [name for name, arr in self._data.items()
                if not is_host_column(arr) and arr.ndim == 1]
        data: dict = {"summary": np.asarray(list(stats), dtype=object)}
        plain = [s for s in stats if not s.endswith("%")]
        qs = [float(s[:-1]) / 100.0 for s in stats if s.endswith("%")]
        for c in cols:
            agg_row = {}
            if plain:
                d = global_agg(self, [AggExpr({"mean": "avg"}.get(s, s), c)
                                      .alias(s) for s in plain]).to_pydict()
                agg_row = {s: d[s][0] for s in plain}
            quant = iter(_linear_quantiles(self._data[c], self._mask, qs))
            data[c] = np.asarray([next(quant) if s.endswith("%")
                                  else str(agg_row[s]) for s in stats],
                                 dtype=object)
        return Frame(data, device=self.device)

    def sample(self, fraction: float, seed: int = 0,
               with_replacement: bool = False) -> "Frame":
        """Row sample, drawn with numpy as the JAX package draws it, so
        both packages keep the same rows. Without replacement: a Bernoulli
        mask (``default_rng(seed).random(num_slots) < fraction``, the
        columns shared). With replacement: Poisson copy counts per valid
        row (``fraction`` may exceed 1), gathered into a compact frame."""
        from ..ops.segments import gather_rows

        rng = np.random.default_rng(seed)
        if with_replacement:
            if fraction < 0.0:
                raise ValueError(f"fraction must be >= 0, got {fraction}")
            counts = rng.poisson(fraction, self._n)
            counts = np.where(self._host_mask(), counts, 0)
            idx = np.repeat(np.arange(self._n), counts)
            return gather_rows(self, torch.as_tensor(idx, device=self.device),
                               host_idx=idx)
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        keep = torch.as_tensor(rng.random(self._n) < fraction,
                               device=self.device)
        return self._with(mask=self._mask & keep)

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
        fill with NaN, and an int column becomes float for it. LEFT SEMI
        and LEFT ANTI run on the device (``_semi_join``)."""
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

        if how in ("left_semi", "left_anti"):
            return self._semi_join(other, keys, how == "left_semi")

        # a string key as its codes in one dictionary of both sides: None
        # codes as NULL_CODE on both, so a null key meets a null key, as
        # in the JAX package's dict plan
        shared = {k: strings.shared_codes(self._data[k], other._data[k])[0]
                  for k in keys if how != "cross"
                  and is_host_column(self._data[k])}

        def pull(frame, side: int):
            """The valid rows and the key columns on the host (one counted
            read a side)."""
            counters.increment("frame.host_sync")
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
            if how in ("inner", "right"):
                lpairs = rpairs = np.empty(0, np.int64)
            else:                                # left / outer
                lpairs = li.astype(np.int64)
                rpairs = np.full(li.size, -1, np.int64)
        else:
            lpairs, rpairs = _join_plan([k[li] for k in lk],
                                        [k[ri] for k in rk], li, ri, how)

        left_cols = self._gather_rows(lpairs, how in ("right", "outer"))
        right_cols = other._gather_rows(rpairs, how in ("left", "outer"))
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

    def _semi_join(self, other: "Frame", keys: list, semi: bool) -> "Frame":
        """LEFT SEMI (LEFT ANTI) JOIN on the device: the valid left rows,
        in order, whose key tuple is (is not) among the right side's.
        Both sides' keys are coded jointly (``segments.row_keys``): a NaN
        key never matches, a ``None`` string key meets a ``None`` one (the
        JAX package's dict plan), ``1 == 1.0``."""
        from ..ops.segments import gather_rows, row_keys

        li, lk, lnull, _, rk, rnull = row_keys(self.select(*keys),
                                                other.select(*keys))
        size = int(torch.cat([lk, rk]).max()) + 1 if lk.numel() else 0
        present = torch.bincount(rk[~rnull], minlength=size) > 0
        hit = present.index_select(0, lk) & ~lnull
        return gather_rows(self, li[hit if semi else ~hit])

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

    @op_span("frame.filter")
    def filter(self, condition: Union[Expr, torch.Tensor]) -> "Frame":
        """AND a predicate into the validity mask; a NULL (NaN) predicate
        drops the row, as Spark's WHERE does. A compilable predicate
        defers into the fused pipeline."""
        f = self._defer(("filter", condition), condition)
        return f if f is not None else self._filter_eager(condition)

    def _filter_eager(self, condition) -> "Frame":
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

    def is_empty(self) -> bool:
        return self.count() == 0

    isEmpty = is_empty

    def _host_mask(self) -> np.ndarray:
        counters.increment("frame.host_sync")
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

    def tail(self, n: int) -> list:
        """The last ``n`` valid rows (Spark ``tail``)."""
        rows = self.collect()
        return rows[-n:] if n > 0 else []

    def to_json(self) -> list[str]:
        """One JSON object string per valid row (Spark ``toJSON``, as a
        list); NaN and None become null, numpy scalars Python ones."""
        import json
        import math

        def coerce(v):
            if v is None:
                return None
            if isinstance(v, (np.floating, float)):
                f = float(v)
                return None if math.isnan(f) else f
            if isinstance(v, (np.integer, int)):
                return int(v)
            if isinstance(v, (np.bool_, bool)):
                return bool(v)
            if isinstance(v, np.ndarray):
                return [coerce(x) for x in v.tolist()]
            return v

        cols = self.columns
        return [json.dumps({c: coerce(v) for c, v in zip(cols, row)})
                for row in self.collect()]

    toJSON = to_json

    def foreach(self, f) -> None:
        """Apply ``f`` to every valid row on the host (Spark
        ``foreach``)."""
        for row in self.collect():
            f(row)

    def foreach_partition(self, f) -> None:
        """Apply ``f`` to an iterator over all valid rows (one
        partition)."""
        f(iter(self.collect()))

    foreachPartition = foreach_partition

    @op_span("frame.to_pydict", cat="action")
    def to_pydict(self, limit: Optional[int] = None) -> dict:
        """The valid rows on the host, as numpy arrays; ``limit`` gathers
        only the first ``limit`` valid rows. Counted as the JAX package
        counts its reads: with a limit, the mask (one ``frame.host_sync``)
        and then the device columns' prefixes (one more); without, the
        mask and the columns as one batch (one)."""
        data = self._data
        if limit is not None:
            m = self._host_mask()
            keep = np.cumsum(m) <= limit
            m = m & keep
            m = m[:(int(np.argmax(~keep)) if not keep.all() else len(m))]
        else:
            counters.increment("frame.host_sync")
            m = self._mask.cpu().numpy()
        pulled = False
        out = {}
        for name, arr in data.items():
            host = arr[:len(m)]
            if isinstance(host, torch.Tensor):
                host = host.cpu().numpy()
                pulled = True
            out[name] = np.asarray(host)[m]
        if pulled and limit is not None:
            counters.increment("frame.host_sync")
        return out

    def to_pandas(self):
        """The valid rows as a pandas DataFrame (Spark ``toPandas``):
        string columns stay object dtype, numeric columns keep their
        dtypes, and a vector column (2-D) becomes an object column of
        per-row arrays."""
        import pandas as pd

        out = {}
        for k, v in self.to_pydict().items():
            if v.ndim > 1:
                col = np.empty(len(v), dtype=object)
                for i in range(len(v)):
                    col[i] = np.asarray(v[i])
                v = col
            out[k] = v
        return pd.DataFrame(out, columns=self.columns)

    toPandas = to_pandas

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

    def create_temp_view(self, name: str) -> None:
        """``createTempView``: as the or-replace form, but a taken name
        raises."""
        from ..sql.catalog import default_catalog

        cat = default_catalog()
        if cat.table_exists(name):
            raise ValueError(f"temp view {name!r} already exists "
                             "(use createOrReplaceTempView)")
        cat.register(name, self)

    createTempView = create_temp_view

    def to_csv(self, path: str, header: bool = False,
               delimiter: str = ",") -> None:
        from .writer import write_csv

        write_csv(self, path, header=header, delimiter=delimiter)

    # -- writer --------------------------------------------------------------
    @property
    def write(self):
        """``df.write.format("csv").option("header", True).save(path)``."""
        from .writer import DataFrameWriter

        return DataFrameWriter(self)


def _linear_quantiles(col, mask, qs) -> list:
    """``str(np.quantile(v, q))`` for each q, ``v`` the valid non-null
    values of ``col`` in float64: one sort on the device, then numpy's
    linear rule (virtual index (n - 1) q, and its lerp, which switches
    form at t >= 0.5); "NaN" for no value."""
    if not qs:
        return []
    v = col.to(torch.float64)[mask]
    v = torch.sort(v[~torch.isnan(v)]).values
    n = v.shape[0]
    if n == 0:
        return ["NaN"] * len(qs)
    out = []
    for q in qs:
        vi = (n - 1) * np.float64(q)
        if vi >= n - 1:
            lo = hi = n - 1
            t = vi - np.float64(-1)
        else:
            lo = int(np.floor(vi))
            hi = lo + 1
            t = vi - np.float64(lo)
        pair = v[[lo, hi]].tolist()
        a, b = np.float64(pair[0]), np.float64(pair[1])
        diff = b - a
        out.append(str(b - diff * (1 - t) if t >= 0.5 else a + diff * t))
    return out


def pandas_result(outs: list, fields: list, device, what: str) -> Frame:
    """The pandas DataFrames a pandas UDF returned, concatenated into a
    frame on ``device`` and cast to the DDL ``fields``."""
    import pandas as pd

    names = [n for n, _ in fields]
    if outs:
        cat = pd.concat(outs, ignore_index=True)
        missing = [n for n in names if n not in cat.columns]
        if missing:
            raise ValueError(f"{what} output is missing schema columns "
                             f"{missing}")
        data = {}
        for n in names:
            # pandas may hand out read-only views: a column owns its memory
            a = cat[n].to_numpy()
            data[n] = a if a.flags.writeable else a.copy()
    else:
        data = {n: np.asarray([], np.float64) for n in names}
    out = Frame(data, device=device)
    for name, tname in fields:
        out = out.with_column(name, out.col(name).cast(tname))
    return out


class _NAFunctions:
    """``df.na`` (Spark's ``DataFrameNaFunctions``): ``fill``, ``drop`` and
    ``replace``."""

    def __init__(self, frame: Frame):
        self._frame = frame

    def fill(self, value, subset=None) -> Frame:
        return self._frame.fillna(value, subset=subset)

    def drop(self, how="any", thresh=None, subset=None) -> Frame:
        return self._frame.dropna(how=how, thresh=thresh, subset=subset)

    def replace(self, to_replace, value=None, subset=None) -> Frame:
        return self._frame.replace(to_replace, value=value, subset=subset)
