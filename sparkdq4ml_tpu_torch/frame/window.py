"""Window functions over numeric columns (port of
``sparkdq4ml_tpu/frame/window.py``): ``Window.partitionBy(...).orderBy(...)``
with the ranking, offset, value and windowed-aggregate functions.

The window *plan* (partitions and the order inside them) is built on the
host with numpy, as in the JAX package: one pull of the mask and the
key columns, a lexsort, partition and peer boundaries; window expressions
over one frame and one spec reuse the last plan. Each function
is evaluated vectorised per partition and the result is scattered back to
the frame's row slots as a tensor on the frame's device, so masked rows stay
masked. A string partition or ascending order key enters the plan as
its int32 codes (``ops/strings.py``: nulls first, as the JAX package's
host lexsort puts them); a string value column, a descending string key
and vector columns raise.

Frames follow Spark: ordered windows default to ``RANGE BETWEEN UNBOUNDED
PRECEDING AND CURRENT ROW`` (running aggregates include peer rows);
unordered windows aggregate the whole partition.
"""

from __future__ import annotations

import weakref
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..config import float_dtype, int_dtype, numpy_dtype
from ..ops import strings
from ..ops.expressions import Col, Expr, is_host_column

_RANKING_FNS = ("row_number", "rank", "dense_rank", "percent_rank",
                "cume_dist", "ntile")
_OFFSET_FNS = ("lag", "lead")
_AGG_FNS = ("count", "sum", "avg", "mean", "min", "max")
# value-picking fns: the value at the frame's first/last/n-th row
_VALUE_FNS = ("first_value", "last_value", "nth_value")


# Spark's frame-boundary sentinels (pyspark.sql.Window uses extreme ints)
_UNBOUNDED = (1 << 62)


class WindowSpec:
    """Immutable partition/order/frame specification."""

    def __init__(self, partition_cols: Sequence[str] = (),
                 order_cols: Sequence[tuple[str, bool]] = (),
                 frame: tuple = None):
        self.partition_cols = tuple(partition_cols)
        self.order_cols = tuple(order_cols)
        self.frame = frame            # None | ("rows"|"range", start, end)

    def partition_by(self, *cols: str) -> "WindowSpec":
        return WindowSpec(
            self.partition_cols + tuple(_colname(c) for c in cols),
            self.order_cols, self.frame)

    partitionBy = partition_by

    def order_by(self, *cols) -> "WindowSpec":
        return WindowSpec(
            self.partition_cols,
            self.order_cols + tuple(_order_item(c) for c in cols),
            self.frame)

    orderBy = order_by

    def rows_between(self, start: int, end: int) -> "WindowSpec":
        """ROWS frame: physical row offsets relative to the current row
        (``Window.unboundedPreceding`` / ``currentRow`` /
        ``unboundedFollowing`` sentinels, or plain ints — Spark API)."""
        start, end = int(start), int(end)
        if start > end:
            raise ValueError(f"frame start {start} > end {end}")
        return WindowSpec(self.partition_cols, self.order_cols,
                          ("rows", start, end))

    rowsBetween = rows_between

    def range_between(self, start: int, end: int) -> "WindowSpec":
        """RANGE frame. Supported bounds: the unbounded/current-row
        sentinel combinations (value offsets would need per-row order-key
        arithmetic — not implemented; Spark's common uses are the
        sentinel forms)."""
        start, end = int(start), int(end)
        if start > end:
            raise ValueError(f"frame start {start} > end {end}")
        for v in (start, end):
            if v not in (-_UNBOUNDED, 0, _UNBOUNDED) and abs(v) >= _UNBOUNDED:
                raise ValueError("bad frame bound")
        if start not in (-_UNBOUNDED, 0) or end not in (0, _UNBOUNDED):
            if not (start == -_UNBOUNDED and end == _UNBOUNDED):
                raise NotImplementedError(
                    "range_between supports only unboundedPreceding/"
                    "currentRow/unboundedFollowing bounds")
        return WindowSpec(self.partition_cols, self.order_cols,
                          ("range", start, end))

    rangeBetween = range_between

    def describe(self) -> str:
        parts = []
        if self.partition_cols:
            parts.append("PARTITION BY " + ", ".join(self.partition_cols))
        if self.order_cols:
            parts.append("ORDER BY " + ", ".join(
                f"{c}{'' if asc else ' DESC'}" for c, asc in self.order_cols))
        if self.frame is not None:
            kind, s, e = self.frame

            def b(v):
                if v <= -_UNBOUNDED:
                    return "UNBOUNDED PRECEDING"
                if v >= _UNBOUNDED:
                    return "UNBOUNDED FOLLOWING"
                if v == 0:
                    return "CURRENT ROW"
                return f"{-v} PRECEDING" if v < 0 else f"{v} FOLLOWING"
            parts.append(f"{kind.upper()} BETWEEN {b(s)} AND {b(e)}")
        return " ".join(parts)

    def __repr__(self):
        return f"WindowSpec({self.describe()})"


def _key_parts(k: np.ndarray) -> list[np.ndarray]:
    """Decompose one sort/group key into lexsort component arrays, highest
    priority first; bool keys cast to int8 (numpy forbids unary minus on
    bool, needed for DESC)."""
    if k.dtype == np.bool_:
        return [k.astype(np.int8)]
    if np.issubdtype(k.dtype, np.floating):
        # NaN = SQL NULL: the not-null flag makes NaN keys sort first
        # ascending (NULLS FIRST) and, negated for DESC, last (NULLS LAST)
        return [(~np.isnan(k)).astype(np.int8), k]
    return [k]


def _neq(ks: np.ndarray) -> np.ndarray:
    """Adjacent-row "value changed" flags for a sorted key component, with
    SQL NULL grouping: NaN equals NaN (nulls form one group, as Spark's
    windows treat them)."""
    neq = ks[1:] != ks[:-1]
    if np.issubdtype(ks.dtype, np.floating):
        neq &= ~(np.isnan(ks[1:]) & np.isnan(ks[:-1]))
    return neq


def _host_column(frame, name: str) -> np.ndarray:
    arr = frame._column_values(name)
    if is_host_column(arr):
        raise NotImplementedError(
            f"window over the string column {name!r} is not in the torch "
            "port's subset")
    if arr.ndim != 1:
        raise NotImplementedError(
            f"window over the vector column {name!r} is not in the torch "
            "port's subset")
    return arr.cpu().numpy()


def _host_key(frame, name: str, spec) -> np.ndarray:
    """A partition or order key on the host; a string key as its codes."""
    arr = frame._column_values(name)
    if not is_host_column(arr):
        return _host_column(frame, name)
    if any(c == name and not asc for c, asc in spec.order_cols):
        raise ValueError(f"descending window order on the string column "
                         f"{name!r} is not supported")
    return strings.codes(arr)[0]


# The last window plan built, with weak references to the mask and key
# tensors it was built from: window expressions over one spec and one frame
# (a select with several OVER items, chained with_column calls) share one
# host lexsort. Frame columns are never written in place, so the same
# tensor objects mean the same data. The entry is an immutable tuple
# replaced whole, so concurrent callers at worst build a plan twice.
_LAST_PLAN: dict = {}


def _window_plan(frame, spec):
    """``(idx, order, starts, ends, peer)``: the valid row slots, their
    lexsort by (partition keys, order keys), the partition bounds and the
    peer-group starts in the sorted domain, from one pull of the mask and
    the key columns."""
    names = list(spec.partition_cols) + [c for c, _ in spec.order_cols]
    tensors = [frame.mask] + [frame._column_values(c) for c in names]
    key = (spec.partition_cols, spec.order_cols)
    last = _LAST_PLAN.get("entry")
    if last is not None and last[0] == key and len(last[1]) == len(
            tensors) and all(r() is t for r, t in zip(last[1], tensors)):
        return last[2]
    idx = np.flatnonzero(frame.mask.cpu().numpy())     # valid slots only
    nv = len(idx)
    host = {c: _host_key(frame, c, spec)[idx] for c in dict.fromkeys(names)}

    # -- plan: lexsort by (partition keys, then order keys) ----------------
    pkeys = [_key_parts(host[c]) for c in spec.partition_cols]
    okeys = []
    for cname, asc in spec.order_cols:
        parts = _key_parts(host[cname])
        if not asc:
            parts = [-p for p in parts]
        okeys.append(parts)
    # np.lexsort: primary key LAST -> flatten in reverse priority order
    # (order keys before partitions, secondary components before primary)
    lex = [comp for parts in reversed(pkeys + okeys)
           for comp in reversed(parts)]
    order = np.lexsort(lex) if lex else np.arange(nv)

    # partition boundaries in the sorted domain (null grouping: _key_parts
    # separates nulls via the flag component, _neq folds NaN with NaN)
    boundary = np.zeros(nv, bool)
    if nv:
        boundary[0] = True
    for parts in pkeys:
        for comp in parts:
            boundary[1:] |= _neq(comp[order])
    # peer boundaries: partition boundary OR any order-key change
    peer = boundary.copy()
    for parts in okeys:
        for comp in parts:
            peer[1:] |= _neq(comp[order])
    starts = np.flatnonzero(boundary)
    plan = (idx, order, starts, np.r_[starts[1:], nv], peer)
    _LAST_PLAN["entry"] = (key, [weakref.ref(t) for t in tensors], plan)
    return plan


def _peer_upto(peer: np.ndarray, s: int, e: int) -> np.ndarray:
    """For each sorted row in partition [s, e), the count of partition rows
    up to and including its last peer (ties in the order key) — the row set
    of the default RANGE ...CURRENT ROW frame."""
    pk = peer[s:e].copy()
    pk[0] = True
    block_id = np.cumsum(pk) - 1
    block_end = np.r_[np.flatnonzero(pk)[1:], e - s]
    return block_end[block_id]


def _colname(c) -> str:
    if isinstance(c, str):
        return c
    if isinstance(c, Col):
        return c.name
    raise TypeError(f"window partition key must be a column name, got {c!r}")


def _order_item(c) -> tuple[str, bool]:
    """Accept "name", ("name", ascending), a Col, or a
    ``col.asc()``/``col.desc()`` SortOrder marker (the Spark idiom
    ``Window.orderBy(col("x").desc())``)."""
    from ..ops.expressions import SortOrder

    if isinstance(c, SortOrder):
        return (_colname(c.child), c.ascending)
    if isinstance(c, tuple) and len(c) == 2:
        return (_colname(c[0]), bool(c[1]))
    return (_colname(c), True)


class Window:
    """Entry points, Spark-style: ``Window.partitionBy("k").orderBy("v")``."""

    unboundedPreceding = unbounded_preceding = -_UNBOUNDED
    unboundedFollowing = unbounded_following = _UNBOUNDED
    currentRow = current_row = 0

    @staticmethod
    def partition_by(*cols: str) -> WindowSpec:
        return WindowSpec().partition_by(*cols)

    partitionBy = partition_by

    @staticmethod
    def order_by(*cols) -> WindowSpec:
        return WindowSpec().order_by(*cols)

    orderBy = order_by


class WindowFunction:
    """An unbound window function (``row_number()``); ``.over(spec)`` binds it.

    Spark raises at analysis time when a ranking function is used without an
    OVER clause; evaluating an unbound WindowFunction raises equivalently.
    """

    def __init__(self, fn: str, column: Optional[str] = None,
                 offset: int = 1, default=None, n: Optional[int] = None):
        self.fn = fn
        self.column = column
        self.offset = offset
        self.default = default
        self.n = n

    def over(self, spec: WindowSpec) -> "WindowExpr":
        return WindowExpr(self, spec)

    def __repr__(self):
        return f"{self.fn}({self.column or ''})"


class WindowExpr(Expr):
    """A window function bound to a WindowSpec — a regular column Expr, usable
    in ``withColumn``/``select`` and produced by SQL ``fn(...) OVER (...)``."""

    def __init__(self, func: WindowFunction, spec: WindowSpec):
        if func.fn in _RANKING_FNS + _OFFSET_FNS and not spec.order_cols:
            raise ValueError(f"{func.fn}() requires an ORDER BY in its window")
        self.func = func
        self.spec = spec

    @property
    def name(self) -> str:
        # Descriptive like Spark's generated names, so two different window
        # expressions in one select never collide in the output columns.
        return f"{self.func!r} OVER ({self.spec.describe()})"

    def __str__(self):
        return self.name

    # -- evaluation --------------------------------------------------------
    def eval(self, frame):
        func, spec = self.func, self.spec
        idx, order, starts, ends, peer = _window_plan(frame, spec)
        nv = len(idx)
        pulled: dict = {}

        def host(name):
            if name not in pulled:
                pulled[name] = _host_column(frame, name)[idx]
            return pulled[name]

        # -- evaluate per partition (vectorized inside each slice) ---------
        vals_sorted, fill = self._compute(
            frame, func, host, order, starts, ends, peer, nv)

        # -- scatter back to the original slots, on the frame's device -----
        tmp = np.empty(nv, dtype=vals_sorted.dtype)
        tmp[order] = vals_sorted
        out = np.full(frame.num_slots, fill, dtype=vals_sorted.dtype)
        out[idx] = tmp
        return torch.as_tensor(out, device=frame.device)

    def _compute(self, frame, func, host, order, starts, ends, peer, nv):
        """Returns (values in sorted domain, masked-slot fill)."""
        fn = func.fn
        fdt = numpy_dtype(float_dtype())
        idt = numpy_dtype(int_dtype())

        if fn in _RANKING_FNS:
            pos = np.arange(nv)
            gstart = np.zeros(nv, idt)
            for s, e in zip(starts, ends):
                gstart[s:e] = s
            if fn == "row_number":
                return (pos - gstart + 1).astype(idt), 0
            # index of first row of the current peer group
            peer_start = np.maximum.accumulate(np.where(peer, pos, 0))
            if fn == "rank":
                return (peer_start - gstart + 1).astype(idt), 0
            if fn == "dense_rank":
                cp = np.cumsum(peer)
                return (cp - cp[gstart] + 1).astype(idt), 0
            npart = np.zeros(nv, idt)
            for s, e in zip(starts, ends):
                npart[s:e] = e - s
            if fn == "percent_rank":
                r = (peer_start - gstart).astype(fdt)
                denom = np.maximum(npart - 1, 1).astype(fdt)
                return np.where(npart > 1, r / denom, 0.0).astype(fdt), \
                    np.nan
            if fn == "cume_dist":
                # rows ≤ current peer group = index just past the last peer
                out = np.empty(nv, fdt)
                for s, e in zip(starts, ends):
                    out[s:e] = _peer_upto(peer, s, e) / (e - s)
                return out, np.nan
            if fn == "ntile":
                k = int(func.n)
                if k < 1:
                    raise ValueError("ntile requires a positive bucket count")
                out = np.empty(nv, idt)
                for s, e in zip(starts, ends):
                    n = e - s
                    base, rem = divmod(n, min(k, n) if n else 1)
                    # Spark: first `rem` buckets get base+1 rows
                    sizes = np.full(min(k, n), base, np.int64)
                    sizes[:rem] += 1
                    out[s:e] = np.repeat(np.arange(1, len(sizes) + 1), sizes)
                return out, 0

        if fn in _OFFSET_FNS:
            v = host(func.column)[order]
            off = func.offset if fn == "lag" else -func.offset
            if not np.issubdtype(v.dtype, np.floating):
                v = v.astype(fdt)      # int lag needs a null (NaN) slot
            out = np.full(nv, np.nan, dtype=v.dtype)
            default = np.nan if func.default is None else func.default
            for s, e in zip(starts, ends):
                seg = v[s:e]
                if off == 0:           # lag/lead 0 = the current row (Spark)
                    out[s:e] = seg
                    continue
                shifted = np.full(e - s, default, dtype=seg.dtype)
                if off > 0 and e - s > off:
                    shifted[off:] = seg[:-(off)]
                elif off < 0 and e - s > -off:
                    shifted[:off] = seg[-off:]
                out[s:e] = shifted
            return out, np.nan

        if fn in _VALUE_FNS:
            v = host(func.column)[order].astype(np.float64)
            ordered = bool(self.spec.order_cols)
            frame_spec = self.spec.frame
            _require_order_for_frame(frame_spec, ordered)
            if fn == "nth_value" and int(func.n) < 1:
                raise ValueError("nth_value requires a positive offset")
            out = np.full(nv, np.nan, np.float64)
            for s, e in zip(starts, ends):
                n = e - s
                if n == 0:
                    continue
                if frame_spec is not None:
                    lo, hi, empty = _frame_bounds(frame_spec, peer, s, e, n)
                elif ordered:
                    # default frame: RANGE UNBOUNDED PRECEDING..CURRENT ROW
                    # (incl. peers) — last_value famously tracks the
                    # current peer group, not the partition end
                    upto = _peer_upto(peer, s, e)
                    lo = np.zeros(n, np.int64)
                    hi = upto - 1
                    empty = lo > hi
                else:                    # whole partition
                    lo = np.zeros(n, np.int64)
                    hi = np.full(n, n - 1, np.int64)
                    empty = lo > hi
                if fn == "first_value":
                    pick = lo
                elif fn == "last_value":
                    pick = hi
                else:
                    pick = lo + int(func.n) - 1
                    empty = empty | (pick > hi)
                seg = v[s:e]
                vals = seg[np.clip(pick, 0, n - 1)]
                out[s:e] = np.where(empty, np.nan, vals)
            return out.astype(fdt), np.nan

        if fn in _AGG_FNS:
            agg = {"mean": "avg"}.get(fn, fn)
            counting_all = agg == "count" and func.column is None
            if counting_all:
                v = np.ones(nv, fdt)
                null = np.zeros(nv, bool)
            else:
                v = host(func.column)[order].astype(np.float64)
                null = np.isnan(v)
            ordered = bool(self.spec.order_cols)
            frame_spec = self.spec.frame
            _require_order_for_frame(frame_spec, ordered)
            out = np.empty(nv, np.float64)
            for s, e in zip(starts, ends):
                seg = np.where(null[s:e], 0.0, v[s:e])
                cnt = (~null[s:e]).astype(np.float64)
                if frame_spec is not None:
                    out[s:e] = _framed_agg(agg, frame_spec, seg, cnt,
                                           v[s:e], null[s:e],
                                           peer, s, e)
                    continue
                if not ordered:          # whole-partition aggregate
                    out[s:e] = _segment_agg(agg, seg, cnt, v[s:e], null[s:e])
                    continue
                # running aggregate incl. peers (RANGE ... CURRENT ROW)
                upto = _peer_upto(peer, s, e)       # rows included per row
                cs, cc = np.cumsum(seg), np.cumsum(cnt)
                if agg == "count":
                    out[s:e] = cc[upto - 1]
                elif agg == "sum":
                    # zero non-null rows in the frame so far → NULL, not
                    # 0 (Spark; caught by the pandas differential sweep)
                    out[s:e] = np.where(cc[upto - 1] > 0, cs[upto - 1],
                                        np.nan)
                elif agg == "avg":
                    c = cc[upto - 1]
                    out[s:e] = np.where(c > 0, cs[upto - 1] / np.maximum(c, 1),
                                        np.nan)
                else:  # min / max: accumulate with nulls neutralized
                    neutral = np.inf if agg == "min" else -np.inf
                    acc = np.where(null[s:e], neutral, v[s:e])
                    run = (np.minimum if agg == "min" else np.maximum) \
                        .accumulate(acc)
                    # all-null-so-far → NaN; decided by the non-null count,
                    # so legitimate ±inf values pass through untouched
                    out[s:e] = np.where(cc[upto - 1] > 0, run[upto - 1],
                                        np.nan)
            if agg == "count":
                return out.astype(idt), 0
            return out.astype(fdt), np.nan

        raise ValueError(f"unknown window function {fn!r}")


def _require_order_for_frame(frame_spec, ordered: bool) -> None:
    """Spark: ROWS frames always need ordering; RANGE frames need it
    whenever a CURRENT ROW bound makes the frame row-dependent
    (unbounded-both is the only orderless form)."""
    if frame_spec is not None and not ordered:
        kind_, fs_, fe_ = frame_spec
        if kind_ == "rows" or not (fs_ <= -_UNBOUNDED
                                   and fe_ >= _UNBOUNDED):
            raise ValueError(f"a {kind_.upper()} frame requires an "
                             "ORDER BY in its window")


def _frame_bounds(frame_spec, peer, s, e, n):
    """Per-row inclusive frame bounds for one partition (sorted domain):
    returns ``(lo, hi, empty)``. ROWS offsets clip to the partition;
    RANGE bounds resolve through peer groups (CURRENT ROW includes all
    peers, Spark semantics)."""
    kind, fs, fe = frame_spec
    r = np.arange(n)
    if kind == "range":
        upto = _peer_upto(peer, s, e)              # rows ≤ last peer
        pk = peer[s:e].copy()
        pk[0] = True                               # callers ensure n > 0
        peer_start = np.maximum.accumulate(np.where(pk, r, 0))
        lo = np.zeros(n, np.int64) if fs <= -_UNBOUNDED else peer_start
        hi = np.full(n, n - 1, np.int64) if fe >= _UNBOUNDED else upto - 1
    else:                                          # rows
        lo = np.zeros(n, np.int64) if fs <= -_UNBOUNDED else \
            np.clip(r + fs, 0, n)                  # n ⇒ empty below
        hi = np.full(n, n - 1, np.int64) if fe >= _UNBOUNDED else \
            np.clip(r + fe, -1, n - 1)             # −1 ⇒ empty below
    return lo, hi, lo > hi


def _framed_agg(agg, frame_spec, seg, cnt, raw, null, peer, s, e):
    """Aggregate over an explicit ROWS/RANGE frame for one partition
    (host-side, vectorized): per sorted row r, the inclusive window
    [r+start, r+end] clipped to the partition (ROWS), or the sentinel
    RANGE forms resolved through peer groups. Spark semantics for empty /
    all-null windows: count = 0, sum/avg/min/max = null."""
    n = len(seg)
    if n == 0:
        return np.empty(0, np.float64)
    lo, hi, empty = _frame_bounds(frame_spec, peer, s, e, n)
    lo_c = np.clip(lo, 0, n - 1)
    hi_c = np.clip(hi, 0, n - 1)
    S = np.concatenate([[0.0], np.cumsum(seg)])
    C = np.concatenate([[0.0], np.cumsum(cnt)])
    wcnt = np.where(empty, 0.0, C[hi_c + 1] - C[lo_c])
    if agg == "count":
        return wcnt
    wsum = np.where(empty, 0.0, S[hi_c + 1] - S[lo_c])
    if agg == "sum":
        return np.where(wcnt > 0, wsum, np.nan)
    if agg == "avg":
        return np.where(wcnt > 0, wsum / np.maximum(wcnt, 1.0), np.nan)

    # min / max with nulls neutralized
    neutral = np.inf if agg == "min" else -np.inf
    acc = np.where(null, neutral, raw.astype(np.float64))
    reduce_ = np.minimum if agg == "min" else np.maximum
    if np.all(lo_c == 0):                  # frame starts at partition top
        val = reduce_.accumulate(acc)[hi_c]
    elif np.all(hi_c == n - 1):            # frame runs to partition end
        val = reduce_.accumulate(acc[::-1])[::-1][lo_c]
    else:
        val = _window_reduce(reduce_, acc, lo_c, hi_c, neutral)
    return np.where(wcnt > 0, val, np.nan)


def _window_reduce(reduce_, acc, lo, hi, neutral):
    """Per-row reduce of acc[lo[r]..hi[r]] for bounded fixed-span windows
    (lo/hi come from a common offset pair, so hi−lo is constant except at
    the clipped partition edges — pad with the neutral and slide)."""
    n = len(acc)
    w = int(np.max(hi - lo)) + 1 if n else 1
    w = max(w, 1)
    padded = np.concatenate([np.full(w - 1, neutral), acc,
                             np.full(w - 1, neutral)])
    sw = np.lib.stride_tricks.sliding_window_view(padded, w)
    # window covering [lo, hi] of width hi-lo+1 ≤ w sits at padded index
    # hi + (w-1) - (w-1) = ... anchor on hi: take the window ENDING at hi
    # (padded end index hi + w - 1), then mask off entries before lo via
    # the left neutral padding — entries [hi-w+1, hi]; those below lo are
    # within the neutral pad only when lo == hi-w+1, which holds except at
    # clipped edges where extra (smaller) entries are real rows BELOW lo.
    vals = sw[hi]  # window [hi-w+1, hi] in padded coords
    # rows below lo inside the span must be neutralized
    offs = np.arange(w)
    starts = hi - w + 1
    mask_bad = (starts[:, None] + offs[None, :]) < lo[:, None]
    vals = np.where(mask_bad, neutral, vals)
    return reduce_.reduce(vals, axis=1)


def _segment_agg(agg, seg, cnt, raw, null):
    n = cnt.sum()
    if agg == "count":
        return n
    if n == 0:
        return np.nan
    if agg == "sum":
        return seg.sum()
    if agg == "avg":
        return seg.sum() / n
    vals = raw[~null]
    return vals.min() if agg == "min" else vals.max()


# -- function constructors (exported via sparkdq4ml_tpu.functions) ----------

def row_number() -> WindowFunction:
    """Sequential number within the partition, by window order (1-based)."""
    return WindowFunction("row_number")


def rank() -> WindowFunction:
    """Rank with gaps after ties (SQL RANK)."""
    return WindowFunction("rank")


def dense_rank() -> WindowFunction:
    """Rank without gaps (SQL DENSE_RANK)."""
    return WindowFunction("dense_rank")


def percent_rank() -> WindowFunction:
    """(rank - 1) / (partition size - 1); 0 for single-row partitions."""
    return WindowFunction("percent_rank")


def cume_dist() -> WindowFunction:
    """Fraction of partition rows ≤ the current row's order key."""
    return WindowFunction("cume_dist")


def ntile(n: int) -> WindowFunction:
    """Partition rows into ``n`` ordered buckets (1-based), sizes differing
    by at most one (Spark/SQL NTILE)."""
    return WindowFunction("ntile", n=n)


def lag(col: Union[str, Col], offset: int = 1, default=None) -> WindowFunction:
    """Value of ``col`` ``offset`` rows before the current row in the window
    order; ``default`` (null if omitted) beyond the partition edge."""
    return WindowFunction("lag", column=_colname(col), offset=offset,
                          default=default)


def lead(col: Union[str, Col], offset: int = 1,
         default=None) -> WindowFunction:
    """Value of ``col`` ``offset`` rows after the current row."""
    return WindowFunction("lead", column=_colname(col), offset=offset,
                          default=default)


def first_value(col: Union[str, Col]) -> WindowFunction:
    """Value at the frame's first row (default frame: the partition
    start). Spark's ``first(col).over(w)`` maps here."""
    return WindowFunction("first_value", column=_colname(col))


def last_value(col: Union[str, Col]) -> WindowFunction:
    """Value at the frame's last row. Under the default frame (RANGE
    UNBOUNDED PRECEDING..CURRENT ROW) this tracks the current peer
    group — Spark's famously surprising semantics — not the partition
    end; add ROWS/RANGE ... UNBOUNDED FOLLOWING for that."""
    return WindowFunction("last_value", column=_colname(col))


def nth_value(col: Union[str, Col], n: int) -> WindowFunction:
    """Value at the frame's n-th row (1-based); null when the frame has
    fewer than ``n`` rows."""
    return WindowFunction("nth_value", column=_colname(col), n=n)


def window_agg(fn: str, column: Optional[str]) -> WindowFunction:
    """Windowed aggregate builder — ``sum("x").over(w)`` routes here."""
    return WindowFunction(fn, column=column)
