"""Grouped execution on the frame's device: ``group_by().agg()``, pivots,
``sort``, ``distinct`` and the set operations' row keys (single-device
subset of ``sparkdq4ml_tpu/ops/segments.py``).

The JAX package lowers each plan to one jitted XLA program; here the same
programs run as eager torch ops on the frame's device (``torch.sort(stable=
True)``, ``cumsum``, ``searchsorted``, ``index_add_``, ``scatter_reduce_``,
``index_select``), so a CUDA frame runs on the card and a CPU frame on the
CPU. Float segment sums go through the port's own kernels
(``kernels.dense_segment_sum``, ``kernels.sorted_segment_sum``), which add
in an order fixed by the plan, so a result is bit-identical from run to
run on the card; integer sums stay on ``index_add_`` (exact in any order).
Two lowerings of ``grouped_agg`` share one output contract:

* the **dense** program (integer-valued keys whose packed range fits
  ``S = min(2^17, max(2 n, 16))`` slots): each row's key tuple maps to a
  lexicographic slot id with no row sort, every aggregate reduces into
  stacked slot tables, and the present slots compact by a ``searchsorted``
  over their prefix sum;
* the **sorted** program (other keys; the distinct, order-valued, moment,
  two-column and collection aggregates; string value columns): a stable
  lexicographic sort over (invalid flag, per key: not-null flag, value),
  segment ids from the boundaries, reductions per segment. The order
  statistics (median, percentile_approx, mode) and collect_set read a
  second sort of each value column by (segment, value) (``_Ranked``);
  skewness, kurtosis and the corr family are float64 moment sums; the
  collections and the answers over strings are built on the host from
  the device's group order in one gather.

String keys and string value columns run as int32 codes
(``ops/strings.py``): the host encodes them in the strings' order,
``NULL_CODE`` first, and decodes the results.

Host reads: two per dense ``grouped_agg`` (the fit verdict with the table
size and the valid rows, then the group count), one on a dense miss and
one per sorted program (the group count with the valid rows); one per
``device_sort`` (the valid-row count) and per ``device_unique`` (the
group count); string keys add their dictionary pass, host answers their
gather. The float sums of both programs read the valid rows alone (the
dense program's gathered in row order, the sorted program's valid
prefix), so their order of adds, and their bits, do not depend on the
masked slots around them: a frame compacted by adaptive execution's
re-bucket groups to the same bits as its source.

Semantics are the JAX package's: masked rows carry no weight; NaN keys form
one null group that sorts first; aggregates skip NaN values, with the
empty -> NULL and n < 2 -> NULL variance rules; row order and output
dtypes match, and ``-0.0`` groups with ``0.0``. Where the JAX package
answers on its host path (a string key or value column, an aggregate
outside ``SEGMENT_FNS``), the result columns take that path's types
(``host_path_columns``). Ineligible input (a 2-D key for grouping, a
numeric-only aggregate over strings) raises ``NotImplementedError``: there
is no host path to fall back to. An empty frame (no row slots), and a
host-path grouping with no valid row, are answered directly with the JAX
package's empty-result dtypes.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..config import (config, float_dtype, int_dtype, numpy_dtype,
                      wide_types)
from . import kernels, strings
from .expressions import is_host_column
from ..utils import costprof as _costprof
from ..utils import faults as _faults
from ..utils import observability as _obs
from ..utils.profiling import counters

logger = logging.getLogger("sparkdq4ml_tpu_torch.ops.segments")

def _fault_fallback(op: str, e: BaseException) -> None:
    """One rung of the ``grouped_flush`` ladder taken: a recovery event
    (rung ``host``) and ``grouped.fault_fallback``."""
    from ..utils.recovery import RECOVERY_LOG

    RECOVERY_LOG.record(
        "grouped_flush", "fallback", rung="host",
        cause=f"{type(e).__name__}: {e}",
        detail=f"device {op} degraded to the host lowering")
    counters.increment("grouped.fault_fallback")


def _entry_faulted(op: str) -> bool:
    """The ``grouped_flush`` fault site at a grouped op's entry, where the
    JAX package's ``try_device`` injects it: True when a due injected
    device fault degraded the op (recorded). A real device fault or
    out-of-memory of the grouped program escapes: it never moves the
    work to the host."""
    try:
        _faults.inject("grouped_flush")
    except _faults.InjectedDeviceError as e:
        _fault_fallback(op, e)
        return True
    return False

__all__ = ["DEVICE_AGG_FNS", "SEGMENT_FNS", "grouped_agg", "global_values",
           "host_path_columns", "narrow_dtype", "pivot_agg", "pivot_values",
           "row_keys", "occurrence_ranks", "device_sort",
           "device_unique", "gather_rows", "agg_lowerable",
           "cardinality_history_key", "cache_stats", "clear_cache"]

# The aggregates the JAX package's segment program lowers; it answers any
# other aggregate on its host path, whose result types the port keeps
# (``host_path_columns``).
SEGMENT_FNS = frozenset({
    "count", "sum", "avg", "min", "max", "stddev", "variance",
    "stddev_pop", "var_pop", "first", "last", "count_distinct",
    "sum_distinct",
})
# Aggregates this engine computes (the names of frame.aggregates, after
# the mean -> avg normalisation): all of them.
DEVICE_AGG_FNS = SEGMENT_FNS | frozenset({
    "median", "mode", "percentile_approx", "collect_list", "collect_set",
    "skewness", "kurtosis", "corr", "covar_samp", "covar_pop", "max_by",
    "min_by",
})
# Aggregates of the dense program; the others run on the sorted one.
_DENSE_FNS = SEGMENT_FNS - {"count_distinct", "sum_distinct"}
_VAR_FNS = ("stddev", "variance", "stddev_pop", "var_pop")

# Dense-table ceiling: the packed key range must fit min(this, 2 n) slots
# or the plan reroutes to the sorted program.
_DENSE_MAX = 1 << 17


def agg_lowerable(agg) -> bool:
    """Whether the JAX package's segment program lowers ``agg`` (its
    ``agg_lowerable``): the structural test behind EXPLAIN's
    ``SegmentedAggregate`` marker."""
    return (agg.fn in SEGMENT_FNS and agg.column2 is None
            and agg.param is None)


# ---------------------------------------------------------------------------
# Plan cache: one entry per structural plan key (the JAX package's
# jit cache). An entry is the plan's lowering, whose eager torch ops run
# at the true row count; its first run at a (bucket, device) counts
# ``grouped.compile``, every later one ``grouped.hit``, as the JAX
# package's jit traces once a bucket. ``_PLAN_STATS`` counts the lookups
# that found an entry (``hits``) and the entries built (``builds``).
# ---------------------------------------------------------------------------

_CACHE: "OrderedDict[str, dict]" = OrderedDict()
_PLAN_STATS: dict = {}
_CACHE_LOCK = threading.Lock()


def clear_cache() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()
        _PLAN_STATS.clear()


def _cached_plan(key: str) -> dict:
    """The entry at ``key`` (the (bucket, device)s it ran at, its first
    run's dimensions and statistics key), built on a miss; the LRU holds
    ``spark.pipeline.cacheSize`` entries (``grouped.evict``)."""
    with _CACHE_LOCK:
        entry = _CACHE.get(key)
        stats = _PLAN_STATS.setdefault(key, {"hits": 0, "builds": 0})
        if entry is not None:
            _CACHE.move_to_end(key)
            stats["hits"] += 1
            return entry
        entry = _CACHE[key] = {"seen": set(), "dims": None,
                               "stats_key": key}
        stats["builds"] += 1
        while len(_CACHE) > max(int(config.pipeline_cache_size), 1):
            evicted, _ = _CACHE.popitem(last=False)
            _PLAN_STATS.pop(evicted, None)
            counters.increment("grouped.evict")
        return entry


def _run_plan(key: str, n: int, device, sp, dims: dict,
              stats_key: Optional[str] = None) -> bool:
    """One run of the plan at ``key`` over ``n`` rows: counts
    ``grouped.compile`` on its first run at (bucket, device), else
    ``grouped.hit``, and sets the span's verdict and plan key. ``dims``
    (rows, value columns, element size, table slots) size its work for
    ``utils/costprof.py``. Returns whether it was the first."""
    from .compiler import bucket_size

    entry = _cached_plan(key)
    where = (bucket_size(n), str(device))
    with _CACHE_LOCK:
        first = where not in entry["seen"]
        entry["seen"].add(where)
        if entry["dims"] is None:
            entry["dims"] = dict(dims)
        if stats_key is not None:
            entry["stats_key"] = stats_key
    counters.increment("grouped.compile" if first else "grouped.hit")
    sp.set(cache="compile" if first else "hit", plan_key=key)
    return first


def program_handles() -> list:
    """Registry callback: one handle per cached plan that has run,
    counted by the segment sums' work formula at its first run's
    dimensions (``utils/costprof.kernel_profile``)."""
    with _CACHE_LOCK:
        items = [(k, dict(e["dims"]), e["stats_key"])
                 for k, e in _CACHE.items() if e["dims"] is not None]
    return [_obs.ProgramHandle("grouped", k, None,
                               meta={"work": "segment_sums", "dims": d,
                                     "stats_key": sk})
            for k, d, sk in items]


def cache_stats() -> dict:
    """Registry callback (``observability.CACHES``): size, capacity, the
    ``grouped.*`` counters and one entry per cached plan."""
    with _CACHE_LOCK:
        entries = [{"key": k[:160], "program_key": k, **dict(v)}
                   for k, v in _PLAN_STATS.items()]
        size = len(_CACHE)
    return {
        "kind": "plan-keyed cache (segment-reduction grouped exec)",
        "size": size,
        "capacity": int(config.pipeline_cache_size),
        "hits": counters.get("grouped.hit"),
        "misses": counters.get("grouped.compile"),
        "evictions": counters.get("grouped.evict"),
        "fallbacks": counters.get("grouped.fallback"),
        "dense_misses": counters.get("grouped.dense_miss"),
        "entries": entries,
    }


_obs.CACHES.register("grouped", cache_stats)
_obs.CACHES.register_programs("grouped", program_handles)


def _col_kind_spec(arr) -> str:
    """A column's dtype in a plan key: numpy's name (``float32``)."""
    return numpy_dtype(arr.dtype).name


def cardinality_history_key(op: str, names, arrs) -> Optional[str]:
    """The statstore's output-cardinality key of a grouping (``op`` ``g``)
    or distinct (``d``) over ``names``: the sorted key names with their
    dtypes and the engine dtype tag, the JAX package's string. Name
    addressed, so EXPLAIN rebuilds it from a parsed query against the
    catalog with no execution. None when a column is missing or on the
    host."""
    from .compiler import dtype_tag

    parts = []
    for name, arr in sorted(zip(names, arrs), key=lambda p: p[0]):
        if arr is None or is_host_column(arr):
            return None
        parts.append(f"{name}:{_col_kind_spec(arr)}")
    if not parts:
        return None
    return f"card|{dtype_tag()}|{op}|" + ",".join(parts)


def _record_grouped_stats(key: str, rows_in: int, rows_out: int,
                          wall_ms: float, compiles: int, host_syncs: int,
                          card_key: Optional[str] = None) -> None:
    """Statstore hand-off of one grouped run: its wall time and host
    reads, its rows in and groups out, and the groups out under the
    cardinality key. Called only when ``spark.stats.enabled``; a failure
    is logged, never raised."""
    from ..utils import statstore as _stats

    try:
        _stats.STORE.record_flush(key, "grouped", wall_ms=wall_ms,
                                  compiled=compiles > 0,
                                  host_syncs=host_syncs)
        if rows_out >= 0:
            _stats.STORE.record_rows(key, "grouped", rows_in, rows_out)
            if card_key is not None:
                _stats.STORE.record_rows(card_key, "cardinality",
                                         rows_in, rows_out)
    except Exception:
        logger.debug("stats hand-off failed", exc_info=True)


# ---------------------------------------------------------------------------
# Column classification
# ---------------------------------------------------------------------------

def _key_kind(arr) -> Optional[str]:
    """Component kind of a 1-D device column: ``f`` float (NaN = NULL),
    ``b`` bool, ``i`` other integer; None = ineligible."""
    if arr is None or is_host_column(arr) or not isinstance(
            arr, torch.Tensor) or arr.ndim != 1:
        return None
    if arr.is_floating_point():
        return "f"
    if arr.dtype == torch.bool:
        return "b"
    return "i"


def _acc_dtype() -> torch.dtype:
    """Float accumulator: float64 under the float64 policy (the JAX
    package's x64 mode), else float32, as on the TPU."""
    return torch.float64 if wide_types() else torch.float32


def _wide_int() -> torch.dtype:
    """Integer accumulator: int64 under the float64 policy, else int32
    (the JAX package's canonical int64 without x64)."""
    return torch.int64 if wide_types() else torch.int32


def _require_kind(arr, name: str, what: str) -> str:
    kind = _key_kind(arr)
    if kind is None:
        shape = ("a string column" if is_host_column(arr)
                 else f"a {tuple(arr.shape)} column")
        raise NotImplementedError(
            f"{what} {name!r} is {shape}; the torch port groups, sorts and "
            "aggregates 1-D numeric and boolean columns, and groups, sorts "
            "and joins on string keys")
    return kind


def _key_columns(frame, names, what: str):
    """``(arrays, kinds, words)`` of the key columns ``names``: a string
    column becomes its int32 codes on the frame's device (kind ``i``,
    nulls first) with its dictionary in ``words``; another column must be
    a 1-D numeric or boolean one."""
    arrs, kinds, words = [], [], {}
    for k in names:
        arr = frame._column_values(k)
        if is_host_column(arr):
            (arr,), words[len(arrs)] = strings.device_codes([arr],
                                                            frame.device)
        kinds.append(_require_kind(arr, k, what))
        arrs.append(arr)
    return arrs, kinds, words


def _key_components(arr, kind: str):
    """Sort components of one group key, highest priority first: a
    not-null flag (False first, so NULL leads) and the value with NaN
    neutralised, so the flag alone places the nulls. ``-0.0`` and ``0.0``
    compare equal and keep row order, as under ``lax.sort``."""
    if kind == "b":
        return [arr.to(torch.int8)]
    if kind == "f":
        null = torch.isnan(arr)
        return [(~null).to(torch.uint8),
                torch.where(null, torch.zeros_like(arr), arr)]
    return [arr]


def _lex_perm(sort_keys, n: int, device, descending=None) -> torch.Tensor:
    """Stable lexicographic permutation over ``sort_keys`` (highest
    priority first; ``descending[i]`` flips key i): one stable sort pass
    per key, least significant first, so ties keep row order like
    ``np.lexsort``."""
    perm = torch.arange(n, device=device)
    for i in reversed(range(len(sort_keys))):
        _, order = torch.sort(sort_keys[i].index_select(0, perm),
                              stable=True,
                              descending=bool(descending and descending[i]))
        perm = perm.index_select(0, order)
    return perm


def _group_scaffold(keys, kinds, mask):
    """Sorted group discovery: ``(perm, valid, seg, boundary)`` with the
    invalid rows last and ``seg`` the sorted rows' group ids (clamped at
    0, so an all-invalid frame reduces nothing)."""
    n = mask.shape[0]
    comps = [c for k, kind in zip(keys, kinds)
             for c in _key_components(k, kind)]
    perm = _lex_perm([(~mask).to(torch.uint8)] + comps, n, mask.device)
    valid = mask.index_select(0, perm)
    boundary = valid.clone()
    if n > 1:
        neq = torch.zeros(n - 1, dtype=torch.bool, device=mask.device)
        for c in comps:
            cs = c.index_select(0, perm)
            neq |= cs[1:] != cs[:-1]
        boundary[1:] &= neq
    seg = (torch.cumsum(boundary.to(torch.int64), 0) - 1).clamp_(min=0)
    return perm, valid, seg, boundary


# ---------------------------------------------------------------------------
# Segment reductions (the torch counterparts of jax.ops.segment_*)
# ---------------------------------------------------------------------------

def _seg_sum(x, seg, size: int, contiguous: bool = False):
    """``out[s] = Σ x[seg == s]`` over ids in ``[0, size)``. Integer sums
    run on ``index_add_`` (exact in any order); float sums in a fixed
    order through the segment-sum kernels: the sorted kernel for the
    nondecreasing ids of the sorted program (``contiguous``), the dense
    kernel for a table that fits its shared memory, else the sorted kernel
    after a stable sort of the ids. ``seg=None`` (``size`` 1, float
    ``x``): every row into one slot, through the dense kernel's form that
    reads no ids."""
    if seg is None:
        return kernels.dense_segment_sum(x, None, 1)
    if not x.is_floating_point():
        out = torch.zeros((size,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, seg, x)
    if contiguous:
        return kernels.sorted_segment_sum(x, seg, size)
    cols = x.shape[1] if x.ndim == 2 else 1
    if kernels.dense_segment_fits(size, cols, x.element_size()):
        return kernels.dense_segment_sum(x, seg, size)
    order = torch.sort(seg, stable=True).indices
    return kernels.sorted_segment_sum(x.index_select(0, order),
                                      seg.index_select(0, order), size)


def _seg_extreme(x, seg, size: int, fill, reduce: str):
    out = torch.full((size,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    idx = seg if x.ndim == 1 else seg[:, None].expand(-1, x.shape[1])
    return out.scatter_reduce_(0, idx, x, reduce=reduce, include_self=True)


def _nan(dtype, device):
    return torch.full((), float("nan"), dtype=dtype, device=device)


def _to_int8_if_bool(v):
    return v.to(torch.int8) if v.dtype == torch.bool else v


# ---------------------------------------------------------------------------
# Dense lowering: integer-valued keys packed into one lexicographic slot id
# ---------------------------------------------------------------------------

def _dense_slots(keys, kinds, valid, S: int):
    """Per-row slot ids, the fit verdict (a device bool), the table size
    (the product of the digit ranges, in the float accumulator) and the
    key decoders. Each key contributes a digit 0 for NULL else ``k - lo + 1``,
    so ascending slot order is the lexicographic group order with nulls
    first. The digits are built in the float accumulator and cast to
    int32 only after the verdict has zeroed them on a miss: a key range
    past the accumulator's exact-integer window (2^53, or 2^24 in float32)
    or the table size reroutes, never aliases two groups."""
    acc = _acc_dtype()
    dev = valid.device
    big = torch.tensor(float("inf"), dtype=acc, device=dev)
    exact = 2.0 ** (53 if acc == torch.float64 else 24)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    sizes, infos, floats = [], [], []
    for k, kind in zip(keys, kinds):
        af = _to_int8_if_bool(k).to(acc)
        floats.append(af)
        if kind == "f":
            nonnull = valid & ~torch.isnan(af)
            ok = ok & torch.where(nonnull, af == torch.round(af),
                                  True).all()
        else:
            nonnull = valid
        any_nn = nonnull.any()
        lo = torch.where(nonnull, af, big).min()
        hi = torch.where(nonnull, af, -big).max()
        lo = torch.where(any_nn, lo, torch.zeros_like(lo))
        hi = torch.where(any_nn, hi, torch.full_like(hi, -1.0))
        sizes.append(hi - lo + 2)               # +1 digit offset, +1 null
        infos.append((kind, lo, k.dtype))
        ok = ok & (lo.abs() < exact) & (hi.abs() < exact)
    total = sizes[0]
    for s in sizes[1:]:
        total = total * s
    ok = ok & torch.isfinite(total) & (total <= S)

    strides = [None] * len(keys)                # last key = fastest digit
    stride = torch.ones((), dtype=acc, device=dev)
    for i in range(len(keys) - 1, -1, -1):
        strides[i] = stride
        stride = stride * sizes[i]
    safe = ok.to(acc)
    slot = torch.zeros(valid.shape, dtype=torch.int32, device=dev)
    for (kind, lo, _dt), st, af in zip(infos, strides, floats):
        digit = af - lo + 1
        if kind == "f":
            digit = torch.where(torch.isnan(af), torch.zeros_like(af), digit)
        contrib = torch.nan_to_num(digit * st * safe, nan=0.0, posinf=0.0,
                                   neginf=0.0)
        slot = slot + contrib.to(torch.int32)

    def make_decoder(kind, lo, dt, st, size):
        def decode(t_idx):
            tf = t_idx.to(acc)
            digit = torch.floor(tf / st) % size
            val = lo + digit - 1
            if kind == "f":
                return torch.where(digit == 0, _nan(acc, dev), val).to(dt)
            if kind == "b":
                return val.to(torch.int8).to(dt)
            return val.to(dt)
        return decode

    decoders = [make_decoder(kind, lo, dt, st, size)
                for (kind, lo, dt), st, size in zip(infos, strides, sizes)]
    return slot, ok, total, decoders


def _dense_verdict(ok, total, valid) -> torch.Tensor:
    """(fit verdict, table size, valid rows) as one float64 vector: the
    dense program's first host read."""
    f64 = torch.float64
    return torch.stack([ok.to(f64),
                        torch.where(ok, total, torch.zeros_like(total))
                        .to(f64), valid.sum().to(f64)])


def _dense_agg(keys, kinds, vals, val_kinds, agg_ops, mask, S: int,
               pre=None):
    """The dense program. Returns ``(key_outs, agg_outs)`` or None when
    the key range does not fit (the caller reroutes). ``pre``: the
    caller's ``(slot, T, nv, decoders)`` of a fit it has read already
    (``_run_grouping``), so this program makes no read of its own for
    it."""
    acc, wide = _acc_dtype(), _wide_int()
    n = mask.shape[0]
    dev = mask.device
    valid = mask
    idx = torch.arange(n, device=dev)
    if pre is None:
        slot, ok, total, decoders = _dense_slots(keys, kinds, valid, S)
        # host read 1: the fit verdict, the table size T (slot T
        # collects the masked rows), so the tables hold T + 1 slots, not
        # S + 1, and the valid rows
        counters.increment("frame.host_sync")
        ok_h, T, nv = _dense_verdict(ok, total, valid).tolist()
        if not ok_h:
            return None
    else:
        slot, T, nv, decoders = pre
    T, nv = int(T), int(nv)
    seg = torch.where(valid, slot, torch.full_like(slot, T)).to(torch.int64)
    # the float sums read the valid rows alone, in row order, so their
    # order of adds does not depend on how many masked slots surround
    # them (a re-bucketed frame sums as its unbucketed source)
    vidx = _valid_rows(valid, nv) if nv < n else None

    def fseg_sum(x):
        if vidx is None:
            return _seg_sum(x, seg, T + 1)
        return _seg_sum(x.index_select(0, vidx), seg.index_select(0, vidx),
                        T + 1)

    nonnull = [valid & ~torch.isnan(v) if vk == "f" else valid
               for v, vk in zip(vals, val_kinds)]

    def vwide(i):
        return _to_int8_if_bool(vals[i]).to(wide)

    def wfill(v):
        return torch.full((), v, dtype=wide, device=dev)

    # Stacked reductions: every sum-like member in one (n, C) index_add_
    # per domain, min/max members in one scatter_reduce_ each. Counts and
    # row indices are bounded by n, so they ride the float stacks whenever
    # n is inside the accumulator's exact-integer window.
    stacks = {"ai": [], "af": [], "mf": [], "mi": [], "xi": []}
    index: dict = {}

    def want(stack, name, arr):
        if name not in index:
            index[name] = (stack, len(stacks[stack]))
            stacks[stack].append(arr)

    small_n = n < (1 << (53 if acc == torch.float64 else 24))
    cstk, cdt = ("af", acc) if small_n else ("ai", wide)
    big_f = torch.tensor(float("inf"), dtype=acc, device=dev)
    big_i = torch.iinfo(wide).max
    small_i = torch.iinfo(wide).min
    want(cstk, "present", valid.to(cdt))
    for fn, s_i, ig in agg_ops:
        if s_i < 0:
            continue
        nn = nonnull[s_i]
        want(cstk, f"cnt{s_i}", nn.to(cdt))
        if fn in ("sum", "avg") + _VAR_FNS:
            if val_kinds[s_i] != "f":
                want("ai", f"sum{s_i}",
                     torch.where(valid, vwide(s_i), wfill(0)))
            else:
                vf = vals[s_i].to(acc)
                want("af", f"sum{s_i}",
                     torch.where(nn, vf, torch.zeros_like(vf)))
        elif fn in ("min", "max"):
            if val_kinds[s_i] == "f":
                vf = vals[s_i].to(acc)
                want("mf", f"{fn}{s_i}",
                     torch.where(nn, vf if fn == "min" else -vf, big_f))
            elif fn == "min":
                want("mi", f"min{s_i}",
                     torch.where(valid, vwide(s_i), wfill(big_i)))
            else:
                want("xi", f"max{s_i}",
                     torch.where(valid, vwide(s_i), wfill(small_i)))
        elif fn in ("first", "last"):
            gate = nn if ig else valid
            tag = "fst" if fn == "first" else "lst"
            if small_n:
                # last rides the min stack negated (indices are exact)
                pos = idx.to(acc) if fn == "first" else -idx.to(acc)
                want("mf", f"{tag}{s_i}{ig}", torch.where(gate, pos, big_f))
            elif fn == "first":
                want("mi", f"fst{s_i}{ig}",
                     torch.where(gate, idx.to(wide), wfill(big_i)))
            else:
                want("xi", f"lst{s_i}{ig}",
                     torch.where(gate, idx.to(wide), wfill(-1)))

    reduced = {}
    for stack, arrs in stacks.items():
        if not arrs:
            continue
        x = torch.stack(arrs, dim=1)
        if stack == "af":
            r = fseg_sum(x)
        elif stack == "ai":
            r = _seg_sum(x, seg, T + 1)
        elif stack in ("mf", "mi"):
            fill = float("inf") if stack == "mf" else big_i
            r = _seg_extreme(x, seg, T + 1, fill, "amin")
        else:
            r = _seg_extreme(x, seg, T + 1, small_i, "amax")
        reduced[stack] = r[:T]

    def table(name):
        stack, j = index[name]
        return reduced[stack][:, j]

    present = table("present") > 0
    counters.increment("frame.host_sync")
    g = int(present.sum())                      # host read 2: the groups

    cs = torch.cumsum(present.to(torch.int32), 0)
    comp = torch.searchsorted(
        cs, torch.arange(1, g + 1, dtype=torch.int32, device=dev))

    def at(name):
        return table(name).index_select(0, comp)

    def fsum(s_i):
        s = table(f"sum{s_i}")
        return s if val_kinds[s_i] == "f" else s.to(acc)

    # variance family second pass: the two-pass sum of (v - mean)^2
    need_var = list(dict.fromkeys(s_i for fn, s_i, _ in agg_ops
                                  if fn in _VAR_FNS))
    ssd = {}
    if need_var:
        seg_c = seg.clamp(max=T - 1)
        cols = []
        for s_i in need_var:
            vf = vals[s_i].to(acc)
            mu = fsum(s_i) / table(f"cnt{s_i}").to(acc)
            d = torch.where(nonnull[s_i], vf - mu.index_select(0, seg_c),
                            torch.zeros_like(vf))
            cols.append(d * d)
        tab = fseg_sum(torch.stack(cols, dim=1))[:T]
        for j, s_i in enumerate(need_var):
            ssd[s_i] = tab[:, j].index_select(0, comp)

    nan = _nan(acc, dev)
    key_outs = [dec(comp) for dec in decoders]
    agg_outs = []
    for fn, s_i, ig in agg_ops:
        if fn == "count" and s_i < 0:
            agg_outs.append(at("present").to(int_dtype()))
            continue
        vs = vals[s_i]
        cnt = at(f"cnt{s_i}")
        if fn == "count":
            agg_outs.append(cnt.to(int_dtype()))
        elif fn == "sum":
            s = at(f"sum{s_i}")
            if val_kinds[s_i] != "f":
                agg_outs.append(s.to(int_dtype()))
            else:
                agg_outs.append(torch.where(cnt > 0, s, nan).to(vs.dtype))
        elif fn == "avg":
            agg_outs.append((fsum(s_i).index_select(0, comp)
                             / cnt.to(acc)).to(float_dtype()))
        elif fn in _VAR_FNS:
            cf = cnt.to(acc)
            if fn in ("stddev", "variance"):
                var = torch.where(cnt > 1, ssd[s_i] / torch.clamp(cf - 1,
                                                                  min=1), nan)
            else:
                var = torch.where(cnt > 0, ssd[s_i] / torch.clamp(cf, min=1),
                                  nan)
            out = var if fn in ("variance", "var_pop") else torch.sqrt(var)
            agg_outs.append(out.to(float_dtype()))
        elif fn in ("min", "max"):
            m = at(f"{fn}{s_i}")
            if val_kinds[s_i] == "f":
                if fn == "max":
                    m = -m
                agg_outs.append(torch.where(cnt > 0, m, nan).to(vs.dtype))
            else:
                agg_outs.append(m.to(vs.dtype))
        else:                                   # first / last
            tag = "fst" if fn == "first" else "lst"
            pos = at(f"{tag}{s_i}{ig}")
            if fn == "last" and index[f"{tag}{s_i}{ig}"][0] == "mf":
                pos = -pos
            pi = pos.clamp(0, n - 1).to(torch.int64)
            picked = vs.index_select(0, pi)
            if ig and val_kinds[s_i] == "f":
                picked = torch.where(cnt > 0, picked,
                                     _nan(vs.dtype, dev))
            agg_outs.append(picked)
    return key_outs, agg_outs


# ---------------------------------------------------------------------------
# Sorted lowering (arbitrary keys; the distinct, order-valued, moment and
# two-column aggregates; string value columns)
# ---------------------------------------------------------------------------

def _valid_rows(valid, nv: int) -> torch.Tensor:
    """The indices of the ``nv`` true slots of ``valid``, in order, with
    no host read (``nv`` is known): each valid row's rank scattered to
    its place, the masked rows into one spare slot."""
    n = valid.shape[0]
    rank = torch.cumsum(valid.to(torch.int64), 0) - 1
    dst = torch.where(valid, rank, torch.full_like(rank, nv))
    out = torch.empty(nv + 1, dtype=torch.int64, device=valid.device)
    out.scatter_(0, dst, torch.arange(n, device=valid.device))
    return out[:nv]


def _distinct_runs(seg, v, eligible, n: int):
    """Re-sort (segment, value) among eligible rows (ineligible rows get
    segment n and sort last), then flag the first row of every
    (segment, value) run. The sorted segments are nondecreasing and each
    segment's values ascend, ties in row order. Returns ``(s2, v2, first,
    perm)``; ``perm`` maps the re-sorted rows to the input rows."""
    seg_k = torch.where(eligible, seg, torch.full_like(seg, n))
    val_k = torch.where(eligible, v, torch.zeros_like(v))
    perm = _lex_perm([seg_k, val_k], n, seg.device)
    s2, v2 = seg_k.index_select(0, perm), val_k.index_select(0, perm)
    live = s2 < n
    first = live.clone()
    if n > 1:
        first[1:] &= (s2[1:] != s2[:-1]) | (v2[1:] != v2[:-1])
    return s2, v2, first, perm


class _Ranked:
    """One value column's non-null rows sorted by (segment, value): the
    order median, percentile_approx, mode and collect_set read. ``cnt``
    and ``start`` are each segment's row count and first position."""

    def __init__(self, seg, v, eligible, G: int, n: int):
        self.n = n
        self.s2, self.v2, self.first, self.perm = _distinct_runs(
            seg, v, eligible, n)
        self.cnt = _seg_sum(eligible.to(torch.int64), seg, G)
        self.start = torch.cumsum(self.cnt, 0) - self.cnt

    def at(self, rank: torch.Tensor) -> torch.Tensor:
        """Each segment's value of the given 0-based rank (clamped)."""
        pos = (self.start + rank).clamp(0, self.n - 1)
        return self.v2.index_select(0, pos)

    def mode_pos(self, G: int) -> torch.Tensor:
        """Each segment's position (in the sorted order) of its most
        frequent value, ties to the smallest: run lengths, their segment
        maximum, then the first run at that maximum (``n`` when empty)."""
        n, dev = self.n, self.v2.device
        idx = torch.arange(n, device=dev)
        live = self.s2 < n
        run = (torch.cumsum(self.first.to(torch.int64), 0) - 1).clamp_(min=0)
        run_len = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, run, live.to(torch.int64))
        run_start = _seg_extreme(torch.where(live, idx, n), run, n, n,
                                 "amin")
        exists = run_len > 0
        run_seg = torch.where(exists, self.s2.index_select(
            0, run_start.clamp(max=n - 1)), G)
        best = _seg_extreme(run_len, run_seg, G + 1, 0, "amax")
        cand = exists & (run_len == best.index_select(0, run_seg))
        return _seg_extreme(torch.where(cand, run_start, n), run_seg, G + 1,
                            n, "amin")[:G]

    def set_runs(self):
        """The first row of each distinct (segment, value) run, ordered by
        segment and then by first appearance: ``(segments, values)``."""
        firsts = torch.nonzero(self.first).squeeze(1)
        fs = self.s2.index_select(0, firsts)
        order = torch.argsort(fs * max(self.n, 1)
                              + self.perm.index_select(0, firsts))
        return (fs.index_select(0, order),
                self.v2.index_select(0, firsts).index_select(0, order))


def _split_lists(values: list, segs: np.ndarray, G: int) -> np.ndarray:
    """A list column of G lists: ``values`` (in segment order) cut by
    their segment ids."""
    from ..frame.frame import list_column

    ends = np.cumsum(np.bincount(segs, minlength=G))
    return list_column([values[lo:hi]
                        for lo, hi in zip(np.r_[0, ends[:-1]], ends)])


def _host_values(t: torch.Tensor, dtype, words) -> list:
    """Python values of a gathered value column, as the JAX package's
    ``tolist()`` of its numpy column gives them: strings (``None`` for
    null) from codes, bools from int8."""
    if words is not None:
        return strings.decode(t, words).tolist()
    if dtype == torch.bool:
        t = t.to(torch.bool)
    return t.cpu().tolist()


# Aggregates whose value column must be numeric (a string column holds
# only count, min, max, first, last, mode, the distinct count and the
# collections, and the value of max_by/min_by).
_NUMERIC_ONLY = frozenset({
    "sum", "avg", "stddev", "variance", "stddev_pop", "var_pop",
    "sum_distinct", "median", "percentile_approx", "skewness", "kurtosis",
    "corr", "covar_samp", "covar_pop"})


def _sorted_agg(keys, kinds, vals, val_kinds, val_words, agg_ops, mask,
                keep_empty: bool = False, pre=None):
    """The sorted program. ``agg_ops`` holds ``(fn, slot, ignore_nulls,
    slot2, param)``; a string value slot (kind ``s``) holds int32 codes
    with its dictionary in ``val_words``. Returns ``(key_outs, agg_outs)``
    with one row per group (one row for no group when ``keep_empty``); an
    aggregate over strings, or a collection, comes back as a host object
    array (NaN where a group has no non-null value, as the JAX package's
    per-group numpy answers it). ``pre``: the caller's ``(perm, valid,
    seg, boundary, g, nv)``, read already (``_run_grouping``)."""
    acc = _acc_dtype()
    n = mask.shape[0]
    dev = mask.device
    idx = torch.arange(n, device=dev)
    if pre is None:
        perm, valid, seg, boundary = _group_scaffold(keys, kinds, mask)
        counters.increment("frame.host_sync")
        g, nv = torch.stack([boundary.sum(), valid.sum()]).tolist()
    else:
        perm, valid, seg, boundary, g, nv = pre
    g, nv = int(g), int(nv)
    G = max(g, 1)
    f64 = torch.float64

    def seg_sum(x):
        # the sorted rows' valid prefix alone: the order of adds does not
        # depend on how many masked slots trail it
        return _seg_sum(x[:nv], seg[:nv], G, contiguous=True)

    first_pos = _seg_extreme(torch.where(valid, idx, n), seg, G, n, "amin")
    fp = first_pos.clamp(0, n - 1)
    orig_first = perm.index_select(0, fp)
    key_outs = [k.index_select(0, orig_first) for k in keys]
    last_pos = _seg_extreme(torch.where(valid, idx, -1), seg, G, -1, "amax")
    lp = last_pos.clamp(0, n - 1)

    sorted_vals = [v.index_select(0, perm) for v in vals]
    nonnull = [valid & ~torch.isnan(vs) if vk == "f" else
               valid & (vs != strings.NULL_CODE) if vk == "s" else valid
               for vs, vk in zip(sorted_vals, val_kinds)]
    nan = _nan(acc, dev)
    wide = _wide_int()
    ranked: dict = {}

    def ranks(s_i):
        if s_i not in ranked:
            ranked[s_i] = _Ranked(seg, _to_int8_if_bool(sorted_vals[s_i]),
                                  nonnull[s_i], G, n)
        return ranked[s_i]

    def moments(x_list, ok):
        """Σ ok, then per segment Σ of each x and of the products of the
        centred columns (float64, fixed order)."""
        okf = ok.to(f64)
        xs = [torch.where(ok, x.to(f64), torch.zeros((), dtype=f64,
                                                      device=dev))
              for x in x_list]
        first = seg_sum(torch.stack([okf] + xs, dim=1))
        c = first[:, 0]
        mus = [first[:, j + 1] / c for j in range(len(xs))]
        ds = [torch.where(ok, x - mu.index_select(0, seg),
                          torch.zeros((), dtype=f64, device=dev))
              for x, mu in zip(xs, mus)]
        return c, ds

    agg_outs = []
    for fn, s_i, ig, s2, param in agg_ops:
        if fn == "count" and s_i < 0:
            agg_outs.append(seg_sum(valid.to(torch.int32)).to(int_dtype()))
            continue
        nn = nonnull[s_i]
        vs = sorted_vals[s_i]
        kind = val_kinds[s_i]
        if fn == "count":
            agg_outs.append(seg_sum(nn.to(torch.int32)).to(int_dtype()))
        elif fn in ("sum", "avg") + _VAR_FNS:
            vf = vs.to(acc)
            cnt = seg_sum(nn.to(acc))
            s = seg_sum(torch.where(nn, vf, torch.zeros_like(vf)))
            if fn == "sum":
                if kind != "f":
                    agg_outs.append(seg_sum(torch.where(
                        valid, _to_int8_if_bool(vs).to(wide),
                        torch.zeros((), dtype=wide, device=dev)))
                        .to(int_dtype()))
                else:
                    agg_outs.append(torch.where(cnt > 0, s, nan)
                                    .to(vs.dtype))
            elif fn == "avg":
                agg_outs.append((s / cnt).to(float_dtype()))
            else:
                mu = s / cnt
                d = torch.where(nn, vf - mu.index_select(0, seg),
                                torch.zeros_like(vf))
                ss = seg_sum(d * d)
                if fn in ("stddev", "variance"):
                    var = torch.where(cnt > 1,
                                      ss / torch.clamp(cnt - 1, min=1), nan)
                else:
                    var = torch.where(cnt > 0, ss / torch.clamp(cnt, min=1),
                                      nan)
                out = var if fn in ("variance", "var_pop") \
                    else torch.sqrt(var)
                agg_outs.append(out.to(float_dtype()))
        elif fn in ("min", "max"):
            red = "amin" if fn == "min" else "amax"
            if kind == "f":
                fill = float("inf") if fn == "min" else float("-inf")
                m = _seg_extreme(
                    torch.where(nn, vs, torch.full_like(vs, fill)), seg, G,
                    fill, red)
                cnt = seg_sum(nn.to(torch.int32))
                agg_outs.append(torch.where(cnt > 0, m,
                                            _nan(vs.dtype, dev)))
            else:
                vi = vs.to(torch.int32) if vs.dtype == torch.bool else vs
                info = torch.iinfo(vi.dtype)
                fill = info.max if fn == "min" else info.min
                m = _seg_extreme(torch.where(nn, vi,
                                             torch.full_like(vi, fill)),
                                 seg, G, fill, red)
                if kind == "s":
                    agg_outs.append(("codes", m, s_i,
                                     seg_sum(nn.to(torch.int32)) > 0))
                else:
                    agg_outs.append(m.to(vs.dtype))
        elif fn in ("first", "last"):
            if ig:
                pos = (_seg_extreme(torch.where(nn, idx, n), seg, G, n,
                                    "amin") if fn == "first" else
                       _seg_extreme(torch.where(nn, idx, -1), seg, G, -1,
                                    "amax"))
                has = seg_sum(nn.to(torch.int32)) > 0
                picked = vs.index_select(0, pos.clamp(0, n - 1))
                if kind == "s":
                    agg_outs.append(("codes", picked, s_i, has))
                    continue
                if kind == "f":
                    picked = torch.where(has, picked, _nan(vs.dtype, dev))
                agg_outs.append(picked)
            else:
                picked = vs.index_select(0, fp if fn == "first" else lp)
                agg_outs.append(("codes", picked, s_i, None) if kind == "s"
                                else picked)
        elif fn in ("count_distinct", "sum_distinct"):
            vn = _to_int8_if_bool(vs)
            segs, v2, firstrun, _ = _distinct_runs(seg, vn, nn, n)
            # the ineligible rows sort last: the last segment takes them
            # (their values are zero) and the ids stay nondecreasing
            sid = torch.where(segs < n, segs, torch.full_like(segs, G - 1))
            if fn == "count_distinct":
                agg_outs.append(_seg_sum(firstrun.to(torch.int32), sid, G)
                                .to(int_dtype()))
            elif kind != "f":
                agg_outs.append(_seg_sum(torch.where(
                    firstrun, v2, torch.zeros_like(v2)).to(wide), sid, G)
                    .to(int_dtype()))
            else:
                sd = _seg_sum(torch.where(firstrun, v2.to(acc),
                                          torch.zeros((), dtype=acc,
                                                      device=dev))[:nv],
                              sid[:nv], G, contiguous=True)
                cd = _seg_sum(firstrun.to(torch.int32), sid, G)
                agg_outs.append(torch.where(cd > 0, sd, nan)
                                .to(float_dtype()))
        elif fn in ("median", "percentile_approx"):
            r = ranks(s_i)
            c = r.cnt
            if fn == "median":
                # the two middle values in float64, averaged: np.median
                a = r.at((c - 1) // 2).to(f64)
                b = r.at(c // 2).to(f64)
                out = (a + b) / 2
            else:
                # nearest rank: max(ceil(p n) - 1, 0), at most n - 1
                rank = (torch.ceil(float(param) * c.to(f64)) - 1).to(
                    torch.int64).clamp(min=0)
                out = r.at(torch.minimum(rank, (c - 1).clamp(min=0))).to(f64)
            agg_outs.append(torch.where(c > 0, out, _nan(f64, dev)))
        elif fn == "mode":
            r = ranks(s_i)
            pick = r.v2.index_select(0, r.mode_pos(G).clamp(max=n - 1))
            if kind == "s":
                agg_outs.append(("codes", pick, s_i, r.cnt > 0))
            elif kind == "f":
                agg_outs.append(torch.where(r.cnt > 0, pick,
                                            _nan(vs.dtype, dev)))
            else:                               # int8 back to bool
                agg_outs.append(pick.to(vs.dtype))
        elif fn in ("skewness", "kurtosis"):
            c, (d,) = moments([vs], nn)
            d2 = d * d
            m = seg_sum(torch.stack([d2, d2 * d, d2 * d2], dim=1)) \
                / c[:, None]
            m2 = m[:, 0]
            out = (m[:, 1] / m2 ** 1.5 if fn == "skewness"
                   else m[:, 2] / m2 ** 2 - 3.0)
            agg_outs.append(torch.where((c > 0) & (m2 != 0), out,
                                        _nan(f64, dev)))
        elif fn in ("corr", "covar_samp", "covar_pop"):
            ok = nonnull[s_i] & nonnull[s2]
            c, (da, db) = moments([vs, sorted_vals[s2]], ok)
            m = seg_sum(torch.stack([da * db, da * da, db * db], dim=1))
            nanf = _nan(f64, dev)
            if fn == "covar_pop":
                out = torch.where(c > 0, m[:, 0] / c, nanf)
            elif fn == "covar_samp":
                out = torch.where(c > 1, m[:, 0] / (c - 1), nanf)
            else:
                sa, sb = torch.sqrt(m[:, 1] / c), torch.sqrt(m[:, 2] / c)
                out = torch.where((c > 1) & (sa != 0) & (sb != 0),
                                  (m[:, 0] / c) / (sa * sb), nanf)
            agg_outs.append(out)
        elif fn in ("max_by", "min_by"):
            # the value at the first row holding the extreme ordering;
            # only rows with a null ordering are skipped
            ok = nonnull[s2]
            bb = sorted_vals[s2].to(f64)
            fill = float("-inf") if fn == "max_by" else float("inf")
            ext = _seg_extreme(torch.where(ok, bb, torch.full_like(bb, fill)),
                               seg, G, fill,
                               "amax" if fn == "max_by" else "amin")
            cand = ok & (bb == ext.index_select(0, seg))
            pos = _seg_extreme(torch.where(cand, idx, n), seg, G, n, "amin")
            has = seg_sum(ok.to(torch.int32)) > 0
            picked = vs.index_select(0, pos.clamp(0, n - 1))
            if kind == "s":
                agg_outs.append(("by", picked, s_i, has))
            else:
                agg_outs.append(torch.where(has, picked.to(f64),
                                            _nan(f64, dev)))
        elif fn == "collect_list":
            sel = torch.nonzero(nn).squeeze(1)
            agg_outs.append(("lists", vs.index_select(0, sel),
                             seg.index_select(0, sel), s_i))
        elif fn == "collect_set":
            segs, values = ranks(s_i).set_runs()
            agg_outs.append(("lists", values, segs, s_i))
        else:
            raise ValueError(fn)
    keep = G if keep_empty else g
    return ([k[:keep] for k in key_outs],
            [_finish(o, vals, val_words, G)[:keep] if isinstance(o, tuple)
             else o[:keep] for o in agg_outs])


def _finish(out, vals, val_words, G: int) -> np.ndarray:
    """A deferred host result of ``_sorted_agg`` as an object array of G
    cells: ``("codes", codes, slot, has)`` decodes strings (NaN where
    ``has`` is false), ``("by", codes, slot, has)`` likewise with
    ``None``, ``("lists", values, segments, slot)`` cuts the values into
    one list per group."""
    tag, t, third, fourth = out
    if tag == "lists":
        values = _host_values(t, vals[fourth].dtype, val_words.get(fourth))
        return _split_lists(values, third.cpu().numpy(), G)
    if fourth is not None:
        t = torch.where(fourth, t, strings.NULL_CODE)
    cells = strings.decode(t, val_words[third])
    if fourth is not None and tag == "codes":
        cells[~fourth.cpu().numpy()] = float("nan")
    return cells


# ---------------------------------------------------------------------------
# The JAX package's host-path result types
# ---------------------------------------------------------------------------

# Results the JAX package's per-group numpy answers as Python floats.
_FLOAT_RESULT = frozenset({
    "avg", "stddev", "variance", "stddev_pop", "var_pop", "median",
    "percentile_approx", "skewness", "kurtosis", "corr", "covar_samp",
    "covar_pop", "max_by", "min_by"})


def _host_base_dtype(fn: str, col: torch.dtype) -> torch.dtype:
    """The numpy type of one group's answer on the JAX package's host
    path (``_np_agg``), before a NaN for an empty group can widen it."""
    if fn in ("count", "count_distinct"):
        return torch.int64
    if fn in _FLOAT_RESULT:
        return torch.float64
    if fn in ("sum", "sum_distinct"):
        if col.is_floating_point:
            return col if fn == "sum" else torch.float64
        return torch.int64
    return col                       # min, max, mode, first, last


def narrow_dtype(dt: torch.dtype) -> torch.dtype:
    """The JAX frame constructor's rule for a list-built column: int64 to
    the int dtype, float64 to the float dtype."""
    if dt == torch.int64:
        return int_dtype()
    if dt == torch.float64:
        return float_dtype()
    return dt


def host_path_columns(agg_ops, vals, outs) -> list:
    """``outs`` typed as the JAX package's host path types them, which
    builds each column from a Python list of per-group answers: each
    answer's own type, widened to float where a group answered NaN for
    no value, then int64 and float64 narrowed to the policy's dtypes
    (one host read for all the NaN checks). Host object answers come
    back as lists, for the frame constructor's list rule."""
    widen, checks = [], []
    for (fn, s_i, ig, _, _), out in zip(agg_ops, outs):
        if isinstance(out, np.ndarray):
            widen.append(None)
            continue
        col = vals[s_i].dtype if s_i >= 0 else torch.int64
        base = _host_base_dtype(fn, col)
        fills = (fn not in ("count", "count_distinct", "first", "last")
                 or ig)
        if fills and base != torch.float64 and out.is_floating_point():
            widen.append(len(checks))
            checks.append(torch.isnan(out).any())
        else:
            widen.append(-1)
    if checks:
        counters.increment("frame.host_sync")
    flags = torch.stack(checks).tolist() if checks else []
    typed = []
    for (fn, s_i, _, _, _), out, w in zip(agg_ops, outs, widen):
        if w is None:
            typed.append(out if fn in ("collect_list", "collect_set")
                         else list(out))
            continue
        col = vals[s_i].dtype if s_i >= 0 else torch.int64
        dt = torch.float64 if w >= 0 and flags[w] else _host_base_dtype(
            fn, col)
        typed.append(out.to(narrow_dtype(dt)))
    return typed


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _empty_frame(names, device):
    """The JAX package's answer for a frame with no row slots: its host
    path builds every column from an empty list (the float dtype)."""
    from ..frame.frame import Frame

    return Frame({name: torch.empty(0, dtype=float_dtype(), device=device)
                  for name in names}, device=device)


def _value_slots(frame, agg_list):
    """``(vals, kinds, words, ops)`` of an aggregate list: each value
    column once (a string column as int32 codes of its own dictionary,
    kind ``s``) and one ``(fn, slot, ignore_nulls, slot2, param)`` per
    aggregate (slot -1 for ``count(*)``)."""
    data = frame._data
    slots: dict = {}
    vals, kinds, words, ops = [], [], {}, []

    def slot(name):
        if name not in slots:
            arr = data.get(name)
            if arr is None:
                frame._column_values(name)          # raises KeyError
            if is_host_column(arr):
                (arr,), words[len(vals)] = strings.device_codes(
                    [arr], frame.device)
                kinds.append("s")
            else:
                kinds.append(_require_kind(arr, name, "aggregated column"))
            slots[name] = len(vals)
            vals.append(arr)
        return slots[name]

    for a in agg_list:
        if a.fn not in DEVICE_AGG_FNS:
            raise ValueError(f"unknown aggregate {a.fn!r}")
        if a.column is None:
            ops.append(("count", -1, False, -1, None))
            continue
        s_i = slot(a.column)
        s2 = -1 if a.column2 is None else slot(a.column2)
        for si, role in ((s_i, "value"), (s2, "second")):
            if si >= 0 and kinds[si] == "s" and (
                    a.fn in _NUMERIC_ONLY or role == "second"):
                raise NotImplementedError(
                    f"aggregate {a.fn}() over the string column "
                    f"{(a.column if role == 'value' else a.column2)!r}: "
                    "the torch port aggregates strings with count, min, "
                    "max, first, last, mode, count_distinct, collect_list, "
                    "collect_set and as the value of max_by/min_by")
        ops.append((a.fn, s_i, bool(a.ignore_nulls), s2, a.param))
    return vals, kinds, words, ops


def on_host_path(agg_list, val_kinds, key_words) -> bool:
    """True when the JAX package answers this grouping on its host path:
    a string key or value column, or an aggregate its segment program
    does not lower (outside ``SEGMENT_FNS``, two columns, a parameter)."""
    return bool(key_words) or "s" in val_kinds or any(
        a.fn not in SEGMENT_FNS or a.column2 is not None
        or a.param is not None for a in agg_list)


def _group_programs(frame, key_arrs, key_kinds, vals, kinds, words, ops):
    """The dense program where it applies, else the sorted one, with no
    plan, span or statistics: ``(key_outs, agg_outs)``."""
    mask = frame.mask
    out = None
    if "s" not in kinds and all(fn in _DENSE_FNS for fn, *_ in ops):
        out = _dense_agg(key_arrs, key_kinds, vals, kinds,
                         [op[:3] for op in ops], mask,
                         min(_DENSE_MAX, max(2 * frame.num_slots, 16)))
    if out is None:
        out = _sorted_agg(key_arrs, key_kinds, vals, kinds, words, ops,
                          mask)
    return out


def _run_grouping(frame, keys, key_arrs, key_kinds, vals, kinds, words,
                  ops, host: bool):
    """``grouped_agg``'s programs: ``(key_outs, agg_outs)`` with string
    keys still as codes. A grouping the JAX package answers on its host
    path (``host``) counts ``grouped.fallback`` and runs
    :func:`_group_programs`.

    A grouping the JAX package lowers runs as a cached
    plan in a ``frame.grouped.flush`` span and records its statistics.
    Its dense program is skipped, for the sorted one, when the statstore
    holds two dense misses of its plan (``optimizer.dense_skip``) or,
    under adaptive execution, when the recorded cardinality of its keys
    estimates more groups than the dense table holds (the
    ``grouped-lowering`` re-plan). A skip saves the dense program's own
    host read: its fit verdict rides the sorted program's read, and a
    verdict that fits (the history was wrong) runs the dense program
    after all. So the answer is always the static plan's, bit for bit:
    on the card the two programs add float sums in different orders."""
    from .compiler import dtype_tag

    mask = frame.mask
    n = frame.num_slots
    dense_ok = "s" not in kinds and all(fn in _DENSE_FNS for fn, *_ in ops)
    S = min(_DENSE_MAX, max(2 * n, 16))
    if host:
        counters.increment("grouped.fallback")
        return _group_programs(frame, key_arrs, key_kinds, vals, kinds,
                               words, ops)
    struct = "|".join([
        dtype_tag(),
        ",".join(f"{k}:{_col_kind_spec(a)}"
                 for k, a in zip(key_kinds, key_arrs)),
        ",".join(f"{fn}@{si}{'!' if ig else ''}" for fn, si, ig, *_ in ops),
        ",".join(f"{k}:{_col_kind_spec(a)}" for k, a in zip(kinds, vals)),
    ])
    stats_on = config.stats_enabled
    t_stats = time.perf_counter() if stats_on else 0.0
    c_stats = counters.get("grouped.compile")
    sync0 = counters.get("frame.host_sync")
    skip_dense = False
    if dense_ok and stats_on and config.optimizer_enabled:
        from ..utils import statstore as _stats_store

        if _stats_store.STORE.miss_count(f"GD{S}|{struct}") >= 2:
            skip_dense = True
            counters.increment("optimizer.dense_skip")
    card_key = (cardinality_history_key("g", keys, key_arrs)
                if stats_on else None)
    if dense_ok and not skip_dense and stats_on and config.aqe_enabled:
        from ..sql import adaptive as _aqe
        from ..utils import statstore as _stats_store

        est_g = (_stats_store.STORE.est_rows(card_key, n)
                 if card_key is not None else None)
        if est_g is not None and est_g > S \
                and _aqe.guard("grouped-lowering"):
            skip_dense = True
            _aqe.record(
                "grouped-lowering",
                f"est {est_g} groups > dense range {S}; sorted "
                "program directly",
                est_before=S, est_after=est_g)
    from .compiler import bucket_size

    out = None
    with _obs.TRACER.span(
            "frame.grouped.flush", cat="frame", op="group_by",
            keys=len(keys), aggs=len(ops), rows=n,
            bucket=bucket_size(n)) as sp:
        dims = {"n": n, "cols": max(len(vals), 1),
                "itemsize": torch.empty(0, dtype=_acc_dtype()).element_size(),
                "id_bytes": 8}
        dense_pre = sorted_pre = None
        if dense_ok and skip_dense:
            slot, ok, total, decoders = _dense_slots(key_arrs, key_kinds,
                                                     mask, S)
            scaffold = _group_scaffold(key_arrs, key_kinds, mask)
            counters.increment("frame.host_sync")
            ok_h, T, nv, g = torch.cat([
                _dense_verdict(ok, total, mask),
                scaffold[3].sum().to(torch.float64)[None]]).tolist()
            if ok_h:
                dense_pre = (slot, T, nv, decoders)
            else:
                sorted_pre = (*scaffold, g, nv)
        if dense_ok and (not skip_dense or dense_pre is not None):
            timer = _costprof.start_run(f"GD{S}|{struct}", n, frame.device)
            _run_plan(f"GD{S}|{struct}", n, frame.device, sp,
                      {**dims, "size": S}, f"G|{struct}")
            out = _dense_agg(key_arrs, key_kinds, vals, kinds,
                             [op[:3] for op in ops], mask, S, dense_pre)
            if out is not None:
                _costprof.end_run(f"GD{S}|{struct}", n, timer, frame.device)
                sp.set(groups=_rows(out), lowering="dense")
            else:
                counters.increment("grouped.dense_miss")
                if stats_on:
                    from ..utils import statstore as _stats_store

                    _stats_store.STORE.record_miss(f"GD{S}|{struct}")
        if out is None:
            timer = _costprof.start_run(f"GS|{struct}", n, frame.device)
            _run_plan(f"GS|{struct}", n, frame.device, sp, dims,
                      f"G|{struct}")
            out = _sorted_agg(key_arrs, key_kinds, vals, kinds, words, ops,
                              mask, pre=sorted_pre)
            _costprof.end_run(f"GS|{struct}", n, timer, frame.device)
            sp.set(groups=_rows(out), lowering="sorted")
    if stats_on:
        _record_grouped_stats(
            f"G|{struct}", n, _rows(out),
            (time.perf_counter() - t_stats) * 1e3,
            counters.get("grouped.compile") - c_stats,
            counters.get("frame.host_sync") - sync0, card_key=card_key)
    return out


def _rows(out) -> int:
    """The group count of a grouping's ``(key_outs, agg_outs)``."""
    key_outs, agg_outs = out
    first = (key_outs or agg_outs)[0]
    return len(first)


def grouped_agg(frame, keys, agg_list):
    """``group_by(keys).agg(agg_list)`` on the frame's device. Rows come
    out in lexicographic key order with the null group first; the result
    is a compact frame. ``agg_list`` holds plain column aggregates
    (``frame.aggregates.AggExpr``). Where the JAX package answers on its
    host path (``on_host_path``), the columns take that path's types
    (``host_path_columns``)."""
    from ..frame.frame import Frame

    n = frame.num_slots
    names = list(keys) + [a.name for a in agg_list]
    key_arrs, key_kinds, words = _key_columns(frame, keys, "group key")
    val_arrs, val_kinds, val_words, agg_ops = _value_slots(frame, agg_list)
    host = on_host_path(agg_list, val_kinds, words)
    faulted = _entry_faulted("grouped_agg")
    host = host or faulted
    # the JAX package's host path answers a frame with no valid row with
    # float columns
    if n == 0 or (host and not bool(frame.mask.any())):
        return _empty_frame(names, frame.device)

    key_outs, agg_outs = _run_grouping(frame, keys, key_arrs, key_kinds,
                                       val_arrs, val_kinds, val_words,
                                       agg_ops, host)
    for i, w in words.items():
        key_outs[i] = strings.decode(key_outs[i], w)
    if host:
        key_outs = [k if is_host_column(k) else k.to(narrow_dtype(k.dtype))
                    for k in key_outs]
        agg_outs = host_path_columns(agg_ops, val_arrs, agg_outs)
    cols = dict(zip(keys, key_outs))
    for a, arr in zip(agg_list, agg_outs):
        cols[a.name] = arr
    return Frame(cols, device=frame.device)


def _pivot_codes(cells: np.ndarray):
    """``(codes, lut)`` of a host pivot column: int32 codes (``NULL_CODE``
    for ``None``) and the dictionary value -> code. Strings take the
    cached dictionary of ``ops/strings.py``; a column that mixes types
    (``1``, ``"z"``) one in first-appearance order, where values Python
    finds equal (``1 == 1.0``) share a code."""
    try:
        codes, words = strings.codes(cells)
        return codes, {w: i for i, w in enumerate(words)}
    except NotImplementedError:
        lut = dict.fromkeys(cells)
        lut.pop(None, None)
        lut = {v: i for i, v in enumerate(lut)}
        index = dict(lut)
        index[None] = strings.NULL_CODE
        return np.fromiter(map(index.__getitem__, cells), np.int32,
                           count=len(cells)), lut


def _sorted_values(uniq) -> list:
    try:
        return sorted(uniq)
    except TypeError:
        # mixed types: grouped by type, natural order within each
        return sorted(uniq, key=lambda x: (str(type(x)), x))


def pivot_values(frame, column: str) -> list:
    """The distinct non-null values of ``column`` over the valid rows, as
    Python values, sorted (by type first when types mix)."""
    arr = frame._column_values(column)
    m = frame.mask
    if is_host_column(arr):
        codes, lut = _pivot_codes(arr)
        present = set(np.unique(codes[m.cpu().numpy()]).tolist())
        return _sorted_values([v for v, c in lut.items() if c in present])
    v = arr[m]
    if v.is_floating_point():
        v = v[~torch.isnan(v)]
    return _sorted_values(torch.unique(v).tolist())


def _pivot_match(pc: torch.Tensor, value, lut) -> torch.Tensor:
    """Rows of the inner grouping whose pivot key equals ``value`` as
    Python's ``==`` decides: through the dictionary of a host column, or
    as a number against a numeric one (``1 == 1.0``; NULL never
    matches)."""
    if lut is not None:
        if value is None:
            return pc == strings.NULL_CODE
        code = lut.get(value)
        if code is not None:
            return pc == code
    elif isinstance(value, (bool, int, float)):
        return (pc.to(torch.float64) if pc.is_floating_point() else pc) \
            == value
    return torch.zeros_like(pc, dtype=torch.bool)


def pivot_agg(frame, keys, pivot_col: str, values, agg_list):
    """``group_by(keys).pivot(pivot_col, values).agg(agg_list)``: one
    grouped call over ``keys + [pivot_col]``, the key
    groups found from its sorted rows, then each (value, aggregate)
    column scattered into a [groups] table on the device; an empty cell
    is null, except ``count(*)``, which is 0. Column types follow the JAX
    package's per-cell host answers (``_host_base_dtype``), widened to
    float where a cell is null."""
    from ..frame.frame import Frame

    if values is None:
        values = pivot_values(frame, pivot_col)
    taken = set(keys)
    names = []
    for v in values:
        for a in agg_list:
            base = str(v) if len(agg_list) == 1 else f"{v}_{a.name}"
            while base in taken:
                base += "_pivot"
            taken.add(base)
            names.append(base)
    if frame.num_slots == 0 or not bool(frame.mask.any()):
        return _empty_frame(list(keys) + names, frame.device)

    key_arrs, key_kinds, words = _key_columns(frame, keys, "group key")
    pcol = frame._column_values(pivot_col)
    lut = None
    if is_host_column(pcol):
        codes, lut = _pivot_codes(pcol)
        pcol = torch.as_tensor(codes, device=frame.device)
    key_arrs.append(pcol)
    key_kinds.append(_require_kind(pcol, pivot_col, "pivot column"))
    vals, kinds, vwords, ops = _value_slots(frame, agg_list)
    key_outs, agg_outs = _group_programs(frame, key_arrs, key_kinds, vals,
                                         kinds, vwords, ops)
    pc = key_outs[-1]
    dev = pc.device
    G2 = pc.shape[0]
    boundary = torch.zeros(G2, dtype=torch.bool, device=dev)
    boundary[:1] = True
    for k in key_outs[:-1]:
        neq = k[1:] != k[:-1]
        if k.is_floating_point():
            neq &= ~(torch.isnan(k[1:]) & torch.isnan(k[:-1]))
        boundary[1:] |= neq
    counters.increment("frame.host_sync")
    starts = torch.nonzero(boundary).squeeze(1)
    ng = starts.numel()                         # host read: the groups
    gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
    cols: dict = {}
    for i, k in enumerate(keys):
        kv = key_outs[i].index_select(0, starts)
        cols[k] = (strings.decode(kv, words[i]) if i in words
                   else kv.to(narrow_dtype(kv.dtype)))

    targets = [torch.where(_pivot_match(pc, v, lut), gid, ng)
               for v in values]
    full = torch.stack([torch.zeros(ng + 1, dtype=torch.bool, device=dev)
                        .scatter_(0, t, True)[:ng].all() for t in targets]
                       ).tolist() if targets else []
    cells, checks = [], []
    for vi, t in enumerate(targets):
        for (fn, s_i, ig, _, _), out in zip(ops, agg_outs):
            star = fn == "count" and s_i < 0
            if isinstance(out, np.ndarray):            # host objects
                th = t.cpu().numpy()
                table = np.full(ng + 1, float("nan"), dtype=object)
                table[th] = out
                cells.append(("host", fn, table[:ng]))
                continue
            col = vals[s_i].dtype if s_i >= 0 else torch.int64
            base = _host_base_dtype(fn, col)
            if not (full[vi] or star):
                dt = torch.float64
                fill = float("nan")
            else:
                dt, fill = out.dtype, 0
            table = torch.full((ng + 1,), fill, dtype=dt, device=dev)
            table = table.scatter_(0, t, out.to(dt))[:ng]
            fills = fn not in ("count", "count_distinct", "first",
                               "last") or ig
            if dt != torch.float64 and fills and base != torch.float64 \
                    and table.is_floating_point():
                cells.append(("check", len(checks), table, base))
                checks.append(torch.isnan(table).any())
            else:
                cells.append(("dev", base if dt != torch.float64 else dt,
                              table))
    if checks:
        counters.increment("frame.host_sync")
    flags = torch.stack(checks).tolist() if checks else []
    for name, cell in zip(names, cells):
        if cell[0] == "host":
            _, fn, table = cell
            cols[name] = (table if fn in ("collect_list", "collect_set")
                          else list(table))
        elif cell[0] == "check":
            _, j, table, base = cell
            cols[name] = table.to(narrow_dtype(torch.float64 if flags[j]
                                          else base))
        else:
            _, dt, table = cell
            cols[name] = table.to(narrow_dtype(dt))
    return Frame(cols, device=frame.device)


def global_values(frame, agg_list) -> list:
    """Each aggregate of ``agg_list`` over the frame's valid rows as one
    group of the sorted program: a 1-element tensor, or a 1-element host
    object array for strings and collections. A frame with no row slots
    answers as a group with no row."""
    vals, kinds, words, ops = _value_slots(frame, agg_list)
    if frame.num_slots == 0:
        # one masked-out slot stands in for the missing rows
        vals = [torch.zeros(1, dtype=v.dtype, device=frame.device)
                for v in vals]
        mask = torch.zeros(1, dtype=torch.bool, device=frame.device)
    else:
        mask = frame.mask
    return _sorted_agg([], [], vals, kinds, words, ops, mask,
                       keep_empty=True)[1]


def gather_rows(frame, take: torch.Tensor, host_idx=None):
    """Every column of ``frame`` at the row indices ``take`` (a device
    int64 tensor): device columns by ``index_select``, string columns on
    the host (one extra read of the indices unless ``host_idx`` is
    given)."""
    from ..frame.frame import Frame

    out = {}
    for name, arr in frame._data.items():
        if is_host_column(arr):
            if host_idx is None:
                counters.increment("frame.host_sync")
                host_idx = take.cpu().numpy()
            out[name] = np.asarray(arr, dtype=object)[host_idx]
        else:
            out[name] = arr.index_select(0, take)
    return Frame(out, device=frame.device)


def _dense_rank(x: torch.Tensor) -> torch.Tensor:
    """Each element's rank among the distinct values of ``x`` (int64)."""
    return torch.unique(x, return_inverse=True)[1]


def _cell_codes(a, b, ai, bi) -> list:
    """Joint codes of one column of two frames over their valid rows
    ``ai``/``bi``: a list of (left codes, right codes, left NaN, right
    NaN) tuples, one per component (a vector column gives one per
    element). The codes are equal exactly where Python's tuple equality
    finds the cells equal with NaN as one null: ``-0.0 == 0.0``, and
    ``1 == 1.0 == True`` across an int, a float and a bool column; the
    NaN flags mark the numeric nulls (None for a string column)."""
    ha, hb = is_host_column(a), is_host_column(b)
    if ha and hb:
        (ca, cb), _ = strings.shared_codes(a[ai.cpu().numpy()],
                                           b[bi.cpu().numpy()])
        # NULL_CODE (-1) shifted to 0: codes stay nonnegative
        return [(torch.as_tensor(ca, device=ai.device).to(torch.int64) + 1,
                 torch.as_tensor(cb, device=ai.device).to(torch.int64) + 1,
                 None, None)]
    if ha or hb:
        # a string never equals a number: disjoint codes
        host, dev_col, hi, di = (a, b, ai, bi) if ha else (b, a, bi, ai)
        (hc,), _ = strings.device_codes([host[hi.cpu().numpy()]],
                                        ai.device)
        dc, _, null, _ = _cell_codes(dev_col, dev_col, di, di)[0]
        hc = (hc.to(torch.int64) + 1) * 2
        dc = dc[:di.shape[0]] * 2 + 1
        null = null[:di.shape[0]]
        return [(hc, dc, None, null) if ha else (dc, hc, null, None)]
    xa, xb = a.index_select(0, ai), b.index_select(0, bi)
    if xa.ndim == 1:
        xa, xb = xa[:, None], xb[:, None]
    na = xa.shape[0]
    out = []
    for j in range(xa.shape[1]):
        x = torch.cat([xa[:, j].to(torch.float64), xb[:, j].to(torch.float64)])
        null = torch.isnan(x)
        x = torch.where(null, torch.zeros_like(x), x) + 0.0   # -0.0 -> 0.0
        code = _dense_rank(x) * 2 + null.to(torch.int64)
        out.append((code[:na], code[na:], null[:na], null[na:]))
    return out


def row_keys(left, right):
    """``(li, lk, lnull, ri, rk, rnull)``: the valid row indices of two
    frames with the same columns, in order, dense int64 keys of their
    rows, equal exactly where the rows are equal as the JAX package's set
    operations compare them (``_cell_codes``), and whether a row holds a
    numeric NaN. The columns' codes combine two at a time, re-ranked after
    each step so the keys stay below the row count."""
    li = torch.nonzero(left.mask).squeeze(1)
    ri = torch.nonzero(right.mask).squeeze(1).to(left.device)
    nl, nr = li.shape[0], ri.shape[0]
    key = None
    lnull = torch.zeros(nl, dtype=torch.bool, device=left.device)
    rnull = torch.zeros(nr, dtype=torch.bool, device=left.device)
    for name in left.columns:
        for ca, cb, na_, nb_ in _cell_codes(left._data[name],
                                            right._data[name], li, ri):
            if na_ is not None:
                lnull |= na_
            if nb_ is not None:
                rnull |= nb_
            code = torch.cat([ca, cb])
            if key is None:
                key = _dense_rank(code)
            else:
                span = int(code.max()) + 1 if code.numel() else 1
                key = _dense_rank(key * span + code)
    if key is None:                             # no column: one empty row
        key = torch.zeros(nl + nr, dtype=torch.int64, device=left.device)
    return li, key[:nl], lnull, ri, key[nl:], rnull


def occurrence_ranks(keys: torch.Tensor) -> torch.Tensor:
    """For each element, how many earlier elements hold the same key."""
    n = keys.shape[0]
    if n == 0:
        return keys.clone()
    order = torch.sort(keys, stable=True).indices
    sk = keys.index_select(0, order)
    pos = torch.arange(n, device=keys.device)
    start = torch.zeros(n, dtype=torch.bool, device=keys.device)
    start[0] = True
    start[1:] = sk[1:] != sk[:-1]
    run = torch.cumsum(start.to(torch.int64), 0) - 1
    run_start = torch.nonzero(start).squeeze(1).index_select(0, run)
    return torch.empty_like(pos).scatter_(0, order, pos - run_start)


def device_sort(frame, names, ascending, nulls_first):
    """``Frame.sort``: a stable sort over (invalid flag, per key: null
    flag, value), so ties keep row order as the JAX package's host lexsort
    does; nulls first ascending and last descending unless pinned. A
    string key sorts by its codes, ascending only (as in the JAX
    package). One host read (the valid-row count); payload gathered on
    the device.

    On the card the sort runs as a cached plan in a ``frame.grouped.flush``
    span (op ``sort``), as the JAX package's sort program runs on an
    accelerator; on the CPU, where the JAX package plans the sort on the
    host, and with a string key, where it takes its host path
    (``grouped.fallback``), it runs with no plan."""
    from .compiler import bucket_size, dtype_tag

    mask = frame.mask
    keys, desc = [(~mask).to(torch.uint8)], [False]
    specs, host_key = [], False
    for name, asc, nf in zip(names, ascending, nulls_first):
        arr = frame._column_values(name)
        if is_host_column(arr):
            if not asc:
                raise ValueError("descending sort on string columns is "
                                 "not supported")
            host_key = True
            (arr,), _ = strings.device_codes([arr], frame.device)
            null = arr == strings.NULL_CODE
            keys.append((~null if (asc if nf is None else nf) else null)
                        .to(torch.uint8))
            desc.append(False)
            keys.append(arr)
            desc.append(False)
            continue
        kind = _require_kind(arr, name, "sort key")
        nf = asc if nf is None else bool(nf)
        specs.append(f"{kind}{'^' if asc else 'v'}{'n' if nf else '_'}:"
                     f"{_col_kind_spec(arr)}")
        if kind == "f":
            # flag False sorts first: nulls-first wants nulls = False
            null = torch.isnan(arr)
            keys.append((~null if nf else null).to(torch.uint8))
            desc.append(False)
            arr = torch.where(null, torch.zeros_like(arr), arr)
        keys.append(_to_int8_if_bool(arr))
        desc.append(not asc)
    faulted = _entry_faulted("sort")
    if host_key or faulted:
        counters.increment("grouped.fallback")
    n = frame.num_slots
    planned = not (host_key or faulted) and frame.device.type != "cpu"
    with (_obs.TRACER.span("frame.grouped.flush", cat="frame", op="sort",
                           keys=len(names), rows=n, bucket=bucket_size(n))
          if planned else contextlib.nullcontext()) as sp:
        if planned:
            plan_key = "|".join([dtype_tag(), "S", ",".join(specs)])
            timer = _costprof.start_run(plan_key, n, frame.device)
            _run_plan(plan_key, n, frame.device, sp,
                      {"n": n, "cols": len(keys), "id_bytes": 8,
                       "itemsize": max(k.element_size() for k in keys)})
        perm = _lex_perm(keys, n, frame.device, desc)
        counters.increment("frame.host_sync")
        nv = int(mask.sum())                    # THE host read
        if planned:
            _costprof.end_run(plan_key, n, timer, frame.device)
    return gather_rows(frame, perm[:nv])


def device_unique(frame, key_names):
    """``Frame.distinct`` (``key_names`` = every column) and
    ``drop_duplicates`` (a subset): the first valid row of each distinct
    key combination, in first-occurrence order. NaN keys fold into one
    null group; a 2-D column groups per component.

    Numeric keys run as a cached plan in a ``frame.grouped.flush`` span
    (op ``distinct``) and record their group count, under the
    cardinality key too; a string key takes what is the JAX package's
    host path (``grouped.fallback``), with no plan."""
    from .compiler import bucket_size, dtype_tag

    n = frame.num_slots
    key_arrs, key_kinds = [], []
    host_key = False
    for k in key_names:
        arr = frame._column_values(k)
        if is_host_column(arr):
            host_key = True
            comps = strings.device_codes([arr], frame.device)[0]
        elif arr.ndim == 2:
            comps = [arr[:, j] for j in range(arr.shape[1])]
        else:
            comps = [arr]
        for c in comps:
            key_kinds.append(_require_kind(c, k, "distinct key"))
            key_arrs.append(c)
    host_key = _entry_faulted("distinct") or host_key
    if n == 0:
        return frame._with()
    if host_key:
        counters.increment("grouped.fallback")
    stats_on = config.stats_enabled and not host_key
    t_stats = time.perf_counter() if stats_on else 0.0
    c_stats = counters.get("grouped.compile")
    key = "|".join([dtype_tag(), "U", ",".join(
        f"{k}:{_col_kind_spec(a)}" for k, a in zip(key_kinds, key_arrs))])
    with (_obs.TRACER.span("frame.grouped.flush", cat="frame",
                           op="distinct", keys=len(key_arrs), rows=n,
                           bucket=bucket_size(n))
          if not host_key else contextlib.nullcontext()) as sp:
        if not host_key:
            timer = _costprof.start_run(key, n, frame.device)
            _run_plan(key, n, frame.device, sp,
                      {"n": n, "cols": len(key_arrs), "id_bytes": 8,
                       "itemsize": max(a.element_size()
                                       for a in key_arrs)})
        perm, valid, seg, boundary = _group_scaffold(key_arrs, key_kinds,
                                                     frame.mask)
        counters.increment("frame.host_sync")
        g = int(boundary.sum())                 # THE host read
        if not host_key:
            _costprof.end_run(key, n, timer, frame.device)
            sp.set(groups=g)
    if stats_on:
        _record_grouped_stats(
            key, n, g, (time.perf_counter() - t_stats) * 1e3,
            counters.get("grouped.compile") - c_stats, 1,
            card_key=cardinality_history_key(
                "d", key_names, [frame._column_values(k)
                                 for k in key_names]))
    # a stable sort gives each group its smallest row index first; the
    # sorted first indices restore first-occurrence order
    orig_first = _seg_extreme(torch.where(valid, perm, n), seg, max(g, 1),
                              n, "amin")
    keep, _ = torch.sort(orig_first[:g])
    return gather_rows(frame, keep)
