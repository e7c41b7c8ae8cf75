"""Fused expression pipeline: a plan-keyed cache with shape buckets (the
port of ``sparkdq4ml_tpu/ops/compiler.py``, single device).

Eager, every ``with_column`` / ``filter`` node launches its own kernels
from Python, one op at a time, through its own frame. Here chains of
compilable frame ops defer (``Frame._defer``) and materialize at the
first read as ONE cached plan per *plan shape*, run through one
:class:`_TraceFrame`.

* **Structural plan key**: an ``Expr`` tree linearizes to a string of op
  kinds, referenced-column dtypes and vector widths, the JAX package's
  strings letter for letter (numpy's dtype strings, ``<f4/<i4``). Python
  literals in comparison and arithmetic positions are *hoisted out of the
  key* and passed at run time, so ``price < 3`` and ``price < 4`` share
  one plan (``_lower`` rewrites the hoisted ``Lit`` into an
  :class:`_ArgLit`).

* **Plan-keyed cache**: one :class:`_Plan` per key (bounded LRU of
  ``spark.pipeline.cacheSize``, ``pipeline.evict``). A plan's first flush at a row
  bucket (:func:`bucket_size`: the next power of two, floored at
  ``spark.pipeline.minBucket``; ``n`` itself above :data:`EXACT_THRESHOLD`) counts
  ``pipeline.compile``, every later one ``pipeline.hit``, as the JAX
  package's jit traces once a bucket. The plan runs its lowered steps at
  the true row count on the frame's device, the card or the CPU: there
  is no padding and no captured graph (a CUDA graph replay of the
  app's one-step flushes measured no gain over these launches).

Semantics are bit-identical to eager evaluation: the plan runs the *same*
``Expr.eval`` methods against a :class:`_TraceFrame` shim, so it launches
the very kernels of the eager path. Anything outside the compilable
subset (strings, UDFs, row generators, array cells) never defers.

Two planned decisions of the cost-based optimizer live here, where a
flush's shape is known: at ``spark.optimizer.level >= 2`` a cold plan of
at least :data:`_SPLIT_MIN_STEPS` steps whose first half is cached with a
recorded first-run cost of at least :data:`_SPLIT_MIN_COMPILE_MS` splits
into that prefix and its tail (``optimizer.split``); and under a flush
byte budget (``spark.audit.deviceBudget`` x ``memoryFraction``) a plan
whose estimate, or whose remembered statstore bound
(``optimizer.mem_chunk``), exceeds the budget runs in row chunks
(``pipeline.oom_chunked``). Both are bit-identical to one flush: the
compilable steps are elementwise and the filters row-local. The port's
recorded first-run cost is its flush time (a plan's steps were lowered
when they deferred), which sits far below the split's threshold; the
rule and its constants are the JAX package's, so one snapshot gives one
decision in both packages.

Observability: ``pipeline.flush`` / ``pipeline.compile`` /
``pipeline.hit`` / ``pipeline.fallback`` / ``pipeline.evict`` counters in
:data:`utils.profiling.counters`, a ``frame.pipeline.flush`` span (steps,
bucket, rows, cache verdict, plan key) when tracing is on, one statstore
record a flush, and the ``pipeline`` entry of ``session.cache_report()``.
``spark.pipeline.enabled=false`` restores the exact per-op eager path.

Faults and the observatory: the ``pipeline_flush`` fault site fires at a
flush's dispatch (its ladder is ``Frame._flush``'s), an ``oom`` fault
shrinks the flush budget (:func:`flush_budget`), and a flush hands its
produced columns to the data-quality observatory
(``utils/dqprof.observe_flush``: one ``dq_sketch`` launch, no host read).
"""

from __future__ import annotations

import logging
import math
import re
import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import config, float_dtype, int_dtype, numpy_dtype
from ..utils import costprof as _costprof
from ..utils import faults as _faults
from ..utils import observability as _obs
from ..utils.profiling import counters
from . import expressions as E
from .cells import is_host_column

__all__ = [
    "bucket_size", "dtype_tag", "is_compilable", "lower",
    "run_pipeline", "clear_cache", "cache_len", "PipelineError",
    "flush_budget", "selectivity_key_for",
]


logger = logging.getLogger("sparkdq4ml_tpu_torch.ops.compiler")


class PipelineError(RuntimeError):
    """Internal lowering failure: callers fall back to eager replay."""


# ---------------------------------------------------------------------------
# Shape buckets
# ---------------------------------------------------------------------------

#: The row count above which the bucket is ``n`` itself (the JAX
#: package's ``pipeline_exact_threshold`` default).
EXACT_THRESHOLD = 1 << 17


def bucket_size(n: int) -> int:
    """Row-slot bucket for ``n`` rows, the JAX package's rule: the next
    power of two, floored at ``spark.pipeline.minBucket``; above
    :data:`EXACT_THRESHOLD` the bucket IS ``n``."""
    lo = max(int(config.pipeline_min_bucket), 1)
    if n <= lo:
        return lo
    if n > int(EXACT_THRESHOLD):
        return n
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# Compilability: the subset of Expr that a plan runs
# ---------------------------------------------------------------------------

# Numeric builtins (device columns in, device column out). Everything else
# in the builtin library is host-side (strings/arrays) or needs a
# host-extracted literal in a non-trailing position.
_NUMERIC_FUNCS = frozenset({
    "abs", "sqrt", "exp", "log", "log10", "pow", "power", "floor", "ceil",
    "sign", "signum", "greatest", "least", "isnan", "coalesce", "sin",
    "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh",
    "degrees", "radians", "cbrt", "expm1", "log1p", "log2", "mod", "pmod",
    "hypot", "rint", "nanvl",
})
# round(col, d) stays out, as in the JAX package (whose jit would turn its
# constant divisor into a reciprocal product); the sets stay one.
_LIT_TAIL_FUNCS: frozenset = frozenset()

# (min, max) argument counts; None = unbounded. A wrong-arity call must
# not defer: the eager path raises its error at the call site.
_FUNC_ARITY = {
    "pow": (2, 2), "power": (2, 2), "atan2": (2, 2), "hypot": (2, 2),
    "mod": (2, 2), "pmod": (2, 2), "nanvl": (2, 2),
    "greatest": (1, None), "least": (1, None), "coalesce": (1, None),
    "round": (1, 2),
}


def _arity_ok(fn_name: str, n_args: int) -> bool:
    lo, hi = _FUNC_ARITY.get(fn_name, (1, 1))
    return n_args >= lo and (hi is None or n_args <= hi)


def _lit_compilable(v) -> bool:
    """Mirrors ``Lit.eval``'s type dispatch: a Python bool, int or float
    (np.float64 subclasses float) is a device column there; anything else
    must not defer."""
    return isinstance(v, (bool, int, float))


_DTYPE_STRS: dict = {}


def _dtype_str(dtype: torch.dtype) -> str:
    """numpy's dtype string of a torch dtype (``<f4``, ``<i4``, ``|b1``),
    memoized: every flush asks for it once a referenced column."""
    s = _DTYPE_STRS.get(dtype)
    if s is None:
        try:
            s = numpy_dtype(dtype).str
        except KeyError:
            s = torch.empty(0, dtype=dtype).numpy().dtype.str
        _DTYPE_STRS[dtype] = s
    return s


def _col_spec(arr) -> str:
    """Plan-key spec of a referenced base column: dtype + vector width
    (``<f8``, ``<f4x4``, ...). Host object columns report ``h`` and are
    rejected by :func:`is_compilable`."""
    if is_host_column(arr) or not isinstance(arr, torch.Tensor):
        return "h"
    w = f"x{arr.shape[1]}" if arr.dim() == 2 else ""
    return f"{_dtype_str(arr.dtype)}{w}"


def schema_of(data: dict, pending_names: Sequence[str] = ()) -> dict:
    """name -> key spec: base device columns map to their dtype spec, host
    columns to ``h``, and columns produced by earlier pending steps to
    ``p`` (their dtype follows from the plan's structure)."""
    spec = {name: _col_spec(arr) for name, arr in data.items()}
    for name in pending_names:
        spec[name] = "p"
    return spec


class LazySchema:
    """``get``-only schema that resolves column specs on demand: a
    deferral check needs only the columns its expression references."""

    def __init__(self, data: dict, pending_names: Sequence[str]):
        self._data = data
        self._pending = frozenset(pending_names)
        self._cache: dict = {}

    def get(self, name, default=None):
        if name in self._pending:
            return "p"
        try:
            return self._cache[name]
        except KeyError:
            pass
        arr = self._data.get(name)
        if arr is None:
            return default
        spec = self._cache[name] = _col_spec(arr)
        return spec


def _dtype_tag() -> str:
    """Engine dtype fingerprint prefixed to every plan key: evaluation
    bakes ``float_dtype()``/``int_dtype()`` into a plan, so a policy flip
    must miss the cache."""
    return _dtype_str(float_dtype()) + "/" + _dtype_str(int_dtype())


dtype_tag = _dtype_tag


def _unary_op(expr) -> Optional[str]:
    """The JAX package's ``UnaryOp`` op of the port's unary nodes."""
    if isinstance(expr, E.Neg):
        return "-"
    if isinstance(expr, E.Not):
        return "!"
    if isinstance(expr, E.IsNull):
        return "isnotnull" if expr.negated else "isnull"
    return None


def _unary(expr, child):
    if isinstance(expr, E.Neg):
        return E.Neg(child)
    if isinstance(expr, E.Not):
        return E.Not(child)
    return E.IsNull(child, expr.negated)


def is_compilable(expr, schema) -> bool:
    """True when ``expr`` evaluates entirely on the device: numeric column
    refs, numeric literals, arithmetic/comparison/boolean ops, numeric
    casts, CASE WHEN, IN over literal values, and the numeric builtins
    (the walk of :func:`lower`)."""
    return lower(expr, schema) is not None


# ---------------------------------------------------------------------------
# Plan lowering: key fragment + literal hoisting + inputs (one traversal)
# ---------------------------------------------------------------------------

def _kind_dtype(kind: str) -> torch.dtype:
    return (torch.bool if kind == "b"
            else int_dtype() if kind == "i" else float_dtype())


class _ArgLit(E.Expr):
    """A hoisted literal: the ``index``-th run-time literal of its
    expression (which the plan runs with ``_RUNTIME_LITS.base`` at the
    expression's first) as a ``torch.full`` column of the eager ``Lit``'s
    dtype, as ``Lit.eval`` makes it."""

    def __init__(self, index: int, kind: str):
        self.index = index
        self.kind = kind            # "b" | "i" | "f"

    def eval(self, frame):
        val = _RUNTIME_LITS.lits[_RUNTIME_LITS.base + self.index]
        return torch.full((frame.num_slots,), val,
                          dtype=_kind_dtype(self.kind), device=frame.device)

    def __str__(self):
        return f"?lit{self.index}"


class _HostConstLit(E.Expr):
    """A literal evaluated as a host numpy array: the trailing literal
    arguments of :data:`_LIT_TAIL_FUNCS`, which the builtins read on the
    host."""

    def __init__(self, value):
        self.value = value

    def eval(self, frame):
        return np.full((frame.num_slots,), self.value)

    def __str__(self):
        return repr(self.value)


class _Lits(threading.local):
    lits: tuple = ()
    base: int = 0


_RUNTIME_LITS = _Lits()


def _lit_kind(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "b"
    if isinstance(v, (int, np.integer)):
        return "i"
    return "f"


def _hoistable_lit(expr) -> Optional[E.Lit]:
    """A numeric (non-bool, non-NaN) Lit in a BinOp/UnaryOp('-') operand
    position hoists to a run-time literal; bools and NaN stay in the
    key."""
    if isinstance(expr, E.Lit) and isinstance(expr.value, (int, float)) \
            and not isinstance(expr.value, bool) \
            and not (isinstance(expr.value, float)
                     and math.isnan(expr.value)):
        return expr
    return None


class _NotCompilable(Exception):
    """Raised inside :func:`_lower` at a node outside the compilable
    subset."""


def _lower(expr, schema, lits: list, refs: list):
    """One traversal returning ``(key_fragment, rewritten_expr)``, or
    raising :class:`_NotCompilable` at a node outside the compilable
    subset.

    ``lits`` collects the hoisted ``Lit`` nodes in traversal order; the
    rewritten tree holds :class:`_ArgLit` placeholders at the same
    positions. Key equality means identical traversal, so later frames
    extract their literal values in the cached plan's order. ``refs``
    collects, in first-seen order, the column names the expression reads
    from the frame's STORED columns (names ``schema`` does not map to
    ``p``): the plan's inputs."""
    if isinstance(expr, E.Col):
        spec = schema.get(expr.name)
        if spec is None or spec == "h":
            raise _NotCompilable
        if spec != "p" and expr.name not in refs:
            refs.append(expr.name)
        return f"C({expr.name!r}:{spec})", expr
    if isinstance(expr, E.Lit):
        if not _lit_compilable(expr.value):
            raise _NotCompilable
        return f"V({expr.value!r})", expr
    if isinstance(expr, E.Alias):
        k, ch = _lower(expr.child, schema, lits, refs)
        return k, (expr if ch is expr.child else E.Alias(ch, expr.name))
    if isinstance(expr, E.BinOp):

        def operand(side):
            h = _hoistable_lit(side)
            if h is not None:
                idx = len(lits)
                lits.append(h)
                kind = _lit_kind(h.value)
                return f"L{kind}", _ArgLit(idx, kind)
            return _lower(side, schema, lits, refs)

        lk, le = operand(expr.left)
        rk, re_ = operand(expr.right)
        return (f"B({expr.op},{lk},{rk})",
                expr if le is expr.left and re_ is expr.right
                else E.BinOp(expr.op, le, re_))
    op = _unary_op(expr)
    if op is not None:
        h = _hoistable_lit(expr.child) if op == "-" else None
        if h is not None:
            idx = len(lits)
            lits.append(h)
            kind = _lit_kind(h.value)
            return f"U(-,L{kind})", E.Neg(_ArgLit(idx, kind))
        k, ch = _lower(expr.child, schema, lits, refs)
        return (f"U({op},{k})",
                expr if ch is expr.child else _unary(expr, ch))
    if isinstance(expr, E.Cast):
        try:
            dt = E.resolve_type_name(expr.type_name)
        except (ValueError, NotImplementedError):
            raise _NotCompilable from None
        if isinstance(dt, np.dtype):
            raise _NotCompilable            # to string: host path
        k, ch = _lower(expr.child, schema, lits, refs)
        return (f"T({expr.type_name.lower()},{k})",
                expr if ch is expr.child else E.Cast(ch, expr.type_name))
    if isinstance(expr, E.InList):
        k, ch = _lower(expr.child, schema, lits, refs)
        if not all(isinstance(v, E.Lit)
                   and (_lit_compilable(v.value) or E.InList._is_null_lit(v))
                   for v in expr.values):
            raise _NotCompilable
        vals = ",".join("NULL" if E.InList._is_null_lit(v)
                        else repr(v.value) for v in expr.values)
        return (f"I({int(expr.negated)},{k},[{vals}])",
                expr if ch is expr.child
                else E.InList(ch, expr.values, expr.negated))
    if isinstance(expr, E.CaseWhen):
        parts = []
        branches = []
        changed = False
        for c, v in expr.branches:
            ck, ce = _lower(c, schema, lits, refs)
            vk, ve = _lower(v, schema, lits, refs)
            parts.append(f"{ck}:{vk}")
            changed = changed or ce is not c or ve is not v
            branches.append((ce, ve))
        if expr.otherwise_expr is not None:
            ok, oe = _lower(expr.otherwise_expr, schema, lits, refs)
            changed = changed or oe is not expr.otherwise_expr
        else:
            ok, oe = "_", None
        return (f"W([{';'.join(parts)}],{ok})",
                expr if not changed else E.CaseWhen(branches, oe))
    if isinstance(expr, E.Func):
        if not _arity_ok(expr.fn_name, len(expr.args)):
            raise _NotCompilable
        lit_tail = expr.fn_name in _LIT_TAIL_FUNCS
        if lit_tail:
            if not all(isinstance(a, E.Lit) and _lit_compilable(a.value)
                       for a in expr.args[1:]):
                raise _NotCompilable
        elif expr.fn_name not in _NUMERIC_FUNCS:
            raise _NotCompilable
        parts = []
        args = []
        changed = False
        for i, a in enumerate(expr.args):
            if lit_tail and i > 0:
                parts.append(f"V({a.value!r})")
                args.append(_HostConstLit(a.value))
                changed = True
                continue
            # numeric-builtin literal arguments hoist like BinOp operands:
            # pow(x, 2) and pow(x, 3) share one plan
            h = _hoistable_lit(a)
            if h is not None:
                idx = len(lits)
                lits.append(h)
                kind = _lit_kind(h.value)
                parts.append(f"L{kind}")
                args.append(_ArgLit(idx, kind))
                changed = True
                continue
            ak, ae = _lower(a, schema, lits, refs)
            parts.append(ak)
            changed = changed or ae is not a
            args.append(ae)
        return (f"F({expr.fn_name},{','.join(parts)})",
                expr if not changed else E.Func(expr.fn_name, args))
    raise _NotCompilable


def lower(expr, schema) -> Optional[tuple]:
    """The lowering of ``expr`` against ``schema``: ``(key_fragment,
    rewritten_expr, hoisted Lit nodes, input column names)``, or None
    when ``expr`` is outside the compilable subset. The frame lowers
    each step once, when it defers it, and the flush reuses the result
    (:func:`_linearize`)."""
    if not isinstance(expr, E.Expr):
        return None
    lits: list = []
    refs: list = []
    try:
        k, ex = _lower(expr, schema, lits, refs)
    except _NotCompilable:
        return None
    return k, ex, tuple(lits), tuple(refs)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

class _TraceFrame:
    """Frame shim a plan evaluates expressions against: its columns are the
    plan's inputs and ``num_slots`` the slots it runs at, so ``Expr.eval``
    runs unmodified: same nulls, dtype promotion and division corners as
    the eager path."""

    def __init__(self, env: dict, n: int, device: torch.device):
        self._env = env
        self._n = n
        self.device = device

    @property
    def num_slots(self) -> int:
        return self._n

    def _column_values(self, name: str):
        try:
            return self._env[name]
        except KeyError:
            raise KeyError(f"pipeline plan has no column {name!r}; "
                           f"inputs: {sorted(self._env)}") from None


def _linearize(steps, extra):
    """The plan of pending ``steps`` and projection ``extra``, from the
    lowerings (:func:`lower`) the frame made when it deferred each one (a
    step's last element, an extra's third): ``(key, lit_nodes,
    lowered_steps, lowered_extra, refs)``. Each lowered expression carries
    the offset of its literals in ``lit_nodes``. A step that reads a
    column before a later step replaces it receives the BASE column as
    an input."""
    lits: list = []
    key_parts: list = []
    lowered_steps: list = []
    lowered_extra: list = []
    refs: list = []

    def take(low):
        k, ex, ls, rs = low
        off = len(lits)
        lits.extend(ls)
        refs.extend(r for r in rs if r not in refs)
        return k, ex, off

    for step in steps:
        if step[0] == "with_column":
            k, ex, off = take(step[3])
            key_parts.append(f"W({step[1]!r})={k}")
            lowered_steps.append(("with_column", step[1], ex, off))
        elif step[0] == "with_columns":
            pairs = []
            ks = []
            for (name, _), low in zip(step[1], step[2]):
                k, ex, off = take(low)
                ks.append(f"{name!r}={k}")
                pairs.append((name, ex, off))
            key_parts.append(f"WS({';'.join(ks)})")
            lowered_steps.append(("with_columns", tuple(pairs)))
        elif step[0] == "filter":
            k, ex, off = take(step[2])
            key_parts.append(f"F:{k}")
            lowered_steps.append(("filter", ex, off))
        else:
            raise PipelineError(f"unknown pipeline step {step[0]!r}")
    for name, _, low in extra:
        k, ex, off = take(low)
        key_parts.append(f"O({name!r})={k}")
        lowered_extra.append((name, ex, off))
    key = _dtype_tag() + "|" + "|".join(key_parts)
    return key, lits, lowered_steps, lowered_extra, refs


class _Plan:
    """One cache entry: the lowered steps and their calling convention,
    built from the :func:`_linearize` walk that keyed it. ``buckets``
    counts the flushes a row bucket; a plan's first flush at a bucket is
    its ``pipeline.compile``, as a jit traces once a bucket in the JAX
    package."""

    def __init__(self, lowered):
        key, lits, lowered_steps, lowered_extra, refs = lowered
        replaced = {s[1] for s in lowered_steps if s[0] == "with_column"}
        for s in lowered_steps:
            if s[0] == "with_columns":
                replaced |= {name for name, _, _ in s[1]}
        # inputs the plan reads and replaces (``donated`` in the JAX
        # package's calling convention), and the ones it only reads
        self.donated = tuple(r for r in refs if r in replaced)
        self.kept = tuple(r for r in refs if r not in replaced)
        self.extra_names = tuple(name for name, _, _ in lowered_extra)
        # produced columns + projection outputs: the term the byte
        # estimate (_est_flush_bytes) charges per row
        self.n_outputs = (
            sum(1 for s in lowered_steps if s[0] == "with_column")
            + sum(len(s[1]) for s in lowered_steps
                  if s[0] == "with_columns")
            + len(lowered_extra))
        self.key = key
        self.n_lits = len(lits)
        # the statstore key of the plan's filters (None without one): the
        # flushes whose output mask carries a selectivity observation
        self.sel_key = None
        if any(s[0] == "filter" for s in lowered_steps):
            from ..utils import statstore as _stats

            self.sel_key = _stats.selectivity_key(key)
        self.est_bytes: dict[int, int] = {}     # bucket -> estimate
        # introspection (cache_report), updated under _CACHE_LOCK
        self.hits = 0
        self.compiles = 0
        self.buckets: dict[int, int] = {}
        self.traces = 0
        self.seen: set = set()          # the (bucket, device)s run at
        self.example: Optional[tuple] = None
        self.example_rows = 0           # the rows of the example's run
        self._steps = tuple(lowered_steps)
        self._extra = tuple(lowered_extra)

    def trace_body(self, kept, donated, mask, lit_args, n_slots: int,
                   device: torch.device):
        """The plan's steps over its inputs: returns ``(changed, new_mask,
        extras)``; ``lit_args`` are the hoisted literals' Python
        numbers."""
        rt = _RUNTIME_LITS
        rt.lits = tuple(lit_args)
        try:
            env = dict(kept)
            env.update(zip(self.donated, donated))
            fr = _TraceFrame(env, n_slots, device)

            def ev(ex, off):
                rt.base = off
                return ex.eval(fr)

            new_mask = mask
            changed = {}
            for st in self._steps:
                if st[0] == "with_column":
                    v = ev(st[2], st[3])
                    env[st[1]] = v
                    changed[st[1]] = v
                elif st[0] == "with_columns":
                    # Spark withColumns: every expression resolves against
                    # the pre-step state
                    vals = {name: ev(ex, off) for name, ex, off in st[1]}
                    env.update(vals)
                    changed.update(vals)
                else:
                    # SQL three-valued logic, the eager filter's helper
                    new_mask = new_mask & E.predicate_keep_mask(
                        ev(st[1], st[2]))
            extras = {name: ev(ex, off) for name, ex, off in self._extra}
            return changed, new_mask, extras
        finally:
            rt.lits, rt.base = (), 0

    def run(self, data: dict, mask, n: int, b: int, lit_values,
            device: torch.device):
        """One flush of ``n`` rows: returns ``((changed, new_mask,
        extras), compiled)``, ``compiled`` on the plan's first flush at
        (bucket, device)."""
        out = self.trace_body({name: data[name] for name in self.kept},
                              tuple(data[name] for name in self.donated),
                              mask, lit_values, n, device)
        where = (b, str(device))
        with _CACHE_LOCK:
            first = where not in self.seen
            if first:
                self.seen.add(where)
                self.traces += 1
                if self.example is None:
                    self.example = (
                        {k: (tuple(data[k].shape[1:]), data[k].dtype)
                         for k in self.kept},
                        tuple((tuple(data[k].shape[1:]), data[k].dtype)
                              for k in self.donated),
                        b, tuple(lit_values))
                    self.example_rows = n
        if first:
            counters.increment("pipeline.compile")
        return out, first


_CACHE: "OrderedDict[str, _Plan]" = OrderedDict()
_CACHE_LOCK = threading.RLock()


def clear_cache() -> None:
    """Drop every cached plan (tests; conf flips)."""
    with _CACHE_LOCK:
        _CACHE.clear()


def cache_len() -> int:
    with _CACHE_LOCK:
        return len(_CACHE)


def _lookup_plan(steps, extra):
    # key equality guarantees the literal order matches the cached plan's;
    # a miss builds its plan from this same linearization
    lowered = _linearize(steps, extra)
    key, lits = lowered[0], lowered[1]
    lit_values = tuple(v.value.item() if hasattr(v.value, "item")
                       else v.value for v in lits)
    with _CACHE_LOCK:
        plan = _CACHE.get(key)
        if plan is not None:
            _CACHE.move_to_end(key)
            return plan, lit_values
    plan = _Plan(lowered)
    with _CACHE_LOCK:
        # insert-if-absent: a racing thread may have built it first
        existing = _CACHE.get(key)
        if existing is not None:
            _CACHE.move_to_end(key)
            return existing, lit_values
        _CACHE[key] = plan
        while len(_CACHE) > max(int(config.pipeline_cache_size), 1):
            _CACHE.popitem(last=False)
            counters.increment("pipeline.evict")
    return plan, lit_values


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------

def _est_flush_bytes(plan, data: dict, b: int) -> int:
    """Cheap over-approximation of a flush's resident bytes at bucket
    ``b`` (the statstore's ``est_bytes``): inputs + mask + twice one
    engine-float column per produced output (value + one temporary)."""
    total = b   # bool mask
    out_itemsize = torch.empty(0, dtype=float_dtype()).element_size()
    for name in plan.kept + plan.donated:
        a = data[name]
        width = a.shape[1] if a.dim() == 2 else 1
        total += b * width * a.element_size()
    total += 2 * b * out_itemsize * max(plan.n_outputs, 1)
    return total


def _record_flush_stats(plan, data, b: int, n: int, wall_ms: float,
                        compiled: bool, new_mask, est=None) -> None:
    """Statstore hand-off (``utils/statstore.py``): one ``record_flush``
    a flush (wall/first-run digest, byte estimate) and, when the flush
    carried a filter, a DEFERRED selectivity observation: the kept rows'
    count stays a device scalar (one tiny reduction) until a batched,
    counted drain on the cold paths. Called only when
    ``spark.stats.enabled``; a failure is logged, never raised."""
    from ..utils import statstore as _stats

    try:
        if est is None:
            est = plan.est_bytes.get(b)
        if est is None:
            # the inputs' dtypes and widths are in the plan's key
            est = plan.est_bytes[b] = _est_flush_bytes(plan, data, b)
        _stats.STORE.record_flush(
            plan.key, "pipeline", wall_ms=wall_ms, compiled=compiled,
            est_bytes=est)
        if plan.sel_key is not None:
            _stats.STORE.defer_rows(plan.sel_key, "filter", n,
                                    torch.sum(new_mask))
    except Exception:
        logger.debug("stats hand-off failed", exc_info=True)


def _record_dq_profile(steps, changed, new_mask, mask_in, n: int,
                       b: int) -> None:
    """The observatory's hand-off (``utils/dqprof.observe_flush``): the
    flush's produced columns, and each ``with_column`` step whose
    expression is a registered DQ rule tallied against the flush's INPUT
    mask (the flush's own filter has dropped the violations from its
    output mask). A device fault leaves the flush unprofiled (the
    ``dq_profile`` rung); any other failure raises."""
    from ..utils import dqprof as _dqprof
    from .udf import default_registry

    registry = default_registry()
    rules = []
    for step in steps:
        if step[0] == "with_column":
            pairs = [(step[1], step[2])]
        elif step[0] == "with_columns":
            pairs = list(step[1])
        else:
            continue
        for name, ex in pairs:
            if (isinstance(ex, E.UdfCall) and name in changed
                    and ex.udf_name in registry):
                rules.append((ex.udf_name, name))
    _dqprof.observe_flush(changed, new_mask, n, b, rules=rules,
                          mask_in=mask_in)


def flush_budget() -> Optional[int]:
    """The device-byte budget of ONE flush, or None (the default): an
    injected ``oom`` fault's shrunk budget (``utils/faults.py``), else an
    explicit ``spark.audit.deviceBudget`` scaled by
    ``spark.audit.memoryFraction``. The allocator's limit is not read on
    this path. The adaptive re-bucket (``sql/adaptive.py``) checks a
    shrunk stage against the same budget."""
    shrunk = _faults.shrunk_budget("oom")
    if shrunk is not None:
        return shrunk
    budget = int(config.audit_device_budget)
    if budget > 0:
        return int(budget * float(config.audit_memory_fraction))
    return None


def _run_chunked(plan, lit_values, data: dict, mask, n: int,
                 budget: int, est: int):
    """Row-chunked run of an over-budget flush: the same plan over row
    slices of a power-of-two size (scaled from the estimate down to the
    budget, floored at the bucket floor), concatenated. Bit-identical to
    one flush, since the compilable steps are elementwise and a filter's
    mask AND is row-local. Counted ``pipeline.oom_chunked``, with a
    ``recovery.fallback`` event at site ``oom`` (rung ``chunked``)."""
    counters.increment("pipeline.oom_chunked")
    per_row = max(1.0, est / float(max(n, 1)))
    m = max(1, int(budget / per_row))
    m = 1 << max(m.bit_length() - 1, 0)
    m = max(m, max(int(config.pipeline_min_bucket), 1))
    m = min(m, n)
    nchunks = -(-n // m)
    from ..utils.recovery import RECOVERY_LOG

    RECOVERY_LOG.record(
        "oom", "fallback", rung="chunked",
        detail=f"est {est} B > budget {budget} B; "
               f"{nchunks} chunk(s) of {m} rows")
    device = mask.device
    stats_on = config.stats_enabled
    t_stats = time.perf_counter() if stats_on else 0.0
    pieces_changed: dict = {}
    pieces_mask: list = []
    pieces_extras: dict = {}
    compiled = 0
    with _obs.span("frame.pipeline.flush", cat="frame", rows=n, bucket=m,
                   chunks=nchunks, oom_budget=budget, est_bytes=est,
                   plan_key=plan.key):
        for start in range(0, n, m):
            rows = min(start + m, n) - start
            cb = bucket_size(rows)
            part = {name: data[name][start:start + rows]
                    for name in plan.kept + plan.donated}
            (changed, new_mask, extras), first = plan.run(
                part, mask[start:start + rows], rows, cb, lit_values,
                device)
            compiled += int(first)
            with _CACHE_LOCK:
                plan.buckets[cb] = plan.buckets.get(cb, 0) + 1
            for k, v in changed.items():
                pieces_changed.setdefault(k, []).append(v)
            pieces_mask.append(new_mask)
            for k, v in extras.items():
                pieces_extras.setdefault(k, []).append(v)
    if nchunks > compiled:
        counters.increment("pipeline.hit", nchunks - compiled)
    with _CACHE_LOCK:
        plan.compiles += compiled
        plan.hits += nchunks - compiled

    def cat(vs):
        return vs[0] if len(vs) == 1 else torch.cat(vs)

    new_data = dict(data)
    new_data.update({k: cat(vs) for k, vs in pieces_changed.items()})
    new_mask = cat(pieces_mask)
    if stats_on:
        _record_flush_stats(plan, data, m, n,
                            (time.perf_counter() - t_stats) * 1e3,
                            compiled > 0, new_mask, est=est)
    return (new_data, new_mask,
            {k: cat(vs) for k, vs in pieces_extras.items()})


#: The stage split (``spark.optimizer.level >= 2``): the fewest pending
#: steps of a plan worth probing, and the least recorded first-run cost
#: (statstore p50, ms) of the warm prefix for a split to pay (the JAX
#: package's constants).
_SPLIT_MIN_STEPS = 6
_SPLIT_MIN_COMPILE_MS = 5.0


def _split_point(steps, extra) -> Optional[int]:
    """Where to split a flush, or None: when the whole plan is cold (not
    cached) but its first half is cached with a recorded first-run cost
    of at least :data:`_SPLIT_MIN_COMPILE_MS`, the prefix replays as a
    hit and only the tail is new. Host-side planning only: one
    ``_linearize`` walk and two cache probes."""
    try:
        key = _linearize(steps, tuple(extra))[0]
    except Exception:
        return None
    parts = key.split("|")
    if len(parts) != 1 + len(steps) + len(extra):
        return None          # a key fragment embeds '|': stay unsplit
    with _CACHE_LOCK:
        if key in _CACHE:
            return None      # warm whole plan: replay beats any split
        k = len(steps) // 2
        prefix_key = "|".join(parts[:1 + k])
        if prefix_key not in _CACHE:
            return None
    from ..utils import statstore as _stats

    cost = _stats.STORE.compile_ms_p50(prefix_key)
    if cost is None or cost < _SPLIT_MIN_COMPILE_MS:
        return None
    return k


def _relower(steps, data: dict) -> Optional[tuple]:
    """``steps`` with their lowerings made again against ``data``: the
    columns a split's prefix produced are stored columns for its tail.
    None when one no longer lowers."""
    from ..frame.frame import _lower_all

    out: list = []
    for step in steps:
        exprs = ([e for _, e in step[1]] if step[0] == "with_columns"
                 else [step[2] if step[0] == "with_column" else step[1]])
        lows = _lower_all(exprs, data, tuple(out))
        if lows is None:
            return None
        out.append(step[:-1] + ((lows if step[0] == "with_columns"
                                 else lows[0]),))
    return tuple(out)


def _history_bytes(key: str) -> Optional[int]:
    """The statstore's remembered byte bound of a plan key (the larger of
    its estimates and measured peaks), or None."""
    from ..utils import statstore as _stats

    try:
        return _stats.STORE.bytes_bound(key)
    except Exception:
        return None


def selectivity_key_for(where_steps, schema) -> Optional[str]:
    """The statstore selectivity key a flush of ``where_steps``
    (``("filter", expr)`` pairs) over ``schema`` would record under,
    computed with no execution (the plan-key walk, then the statstore's
    filter extraction); EXPLAIN addresses history with it. None when a
    step does not lower (such a flush runs eagerly and records
    nothing)."""
    from ..utils import statstore as _stats

    steps = []
    for kind, expr in where_steps:
        low = lower(expr, schema)
        if low is None:
            return None
        steps.append((kind, expr, low))
    return _stats.selectivity_key(_linearize(tuple(steps), ())[0])


def run_pipeline(data: dict, mask, n: int, steps, extra=()):
    """Run pending ``steps`` (+ ``extra`` projection expressions, each
    ``(name, expr, lowering)``) over the base column dict as one cached
    plan; each step carries its lowering (:func:`lower`) last.

    Returns ``(new_data, new_mask, extras)``: a fresh column dict
    (replaced columns in place, new columns appended), the post-filter
    mask, and the projection outputs by name, all at ``n`` rows. Raises
    :class:`PipelineError` on a lowering failure (counted
    ``pipeline.fallback``); callers replay eagerly. A device error
    (``torch.cuda`` out of memory, an illegal access) escapes unwrapped.
    The stage split and the chunked flush are in the module docstring.
    """
    counters.increment("pipeline.flush")
    device = mask.device
    try:
        b = bucket_size(n)
        if (n > 0 and config.optimizer_enabled
                and int(config.optimizer_level) >= 2
                and len(steps) >= _SPLIT_MIN_STEPS):
            k = _split_point(steps, extra)
            if k:
                mid_data, mid_mask, _ = run_pipeline(data, mask, n,
                                                     steps[:k], ())
                tail = _relower(steps[k:], mid_data)
                if tail is None:
                    raise PipelineError("a split's tail did not lower")
                counters.increment("optimizer.split")
                return run_pipeline(mid_data, mid_mask, n, tail, extra)
        plan, lit_values = _lookup_plan(steps, tuple(extra))
        if n > 0:
            budget = flush_budget()
            if budget is not None:
                est = _est_flush_bytes(plan, data, b)
                if (est <= budget and config.optimizer_enabled
                        and config.stats_enabled):
                    # the remembered bound (measured peaks included)
                    # chunks a plan whose static estimate under-counts
                    hist = _history_bytes(plan.key)
                    if hist is not None and hist > budget:
                        counters.increment("optimizer.mem_chunk")
                        est = hist
                if est > budget:
                    return _run_chunked(plan, lit_values, data, mask, n,
                                        budget, est)
        stats_on = config.stats_enabled
        t_stats = time.perf_counter() if stats_on else 0.0
        timer = _costprof.start_run(plan.key, n, device)
        if _obs.TRACER.enabled:
            with _obs.TRACER.span(
                    "frame.pipeline.flush", cat="frame", steps=len(steps),
                    outputs=len(extra), rows=n, bucket=b,
                    plan_key=plan.key) as sp:
                # the fault site at the dispatch: a due device_error
                # raises inside the flush span and escapes to the
                # Frame._flush ladder
                _faults.inject("pipeline_flush")
                (changed, new_mask, extras), compiled = plan.run(
                    data, mask, n, b, lit_values, device)
                sp.set(cache="compile" if compiled else "hit")
        else:
            _faults.inject("pipeline_flush")
            (changed, new_mask, extras), compiled = plan.run(
                data, mask, n, b, lit_values, device)
        _costprof.end_run(plan.key, n, timer, device)
        if not compiled:
            counters.increment("pipeline.hit")
        with _CACHE_LOCK:
            if compiled:
                plan.compiles += 1
            else:
                plan.hits += 1
            plan.buckets[b] = plan.buckets.get(b, 0) + 1
        if stats_on:
            _record_flush_stats(plan, data, b, n,
                                (time.perf_counter() - t_stats) * 1e3,
                                compiled, new_mask)
        new_data = dict(data)
        new_data.update(changed)
    except PipelineError:
        counters.increment("pipeline.fallback")
        raise
    except (torch.cuda.OutOfMemoryError, torch.AcceleratorError):
        # a fault of the device itself, which no eager replay would mend
        raise
    except Exception as e:
        counters.increment("pipeline.fallback")
        raise PipelineError(str(e)) from e
    # the data-quality observatory (utils/dqprof.py), outside the try: a
    # failure of its kernel is never a PipelineError, so never an eager
    # replay. One flag read when it is off.
    if config.dq_profile_enabled:
        _record_dq_profile(steps, changed, new_mask, mask, n, b)
    return new_data, new_mask, extras


# ---------------------------------------------------------------------------
# Cache introspection (observability.CACHES; session.cache_report())
# ---------------------------------------------------------------------------

def cache_stats() -> dict:
    """Registry callback: size and capacity, hit/miss/eviction counters,
    and one entry per cached plan (stable ``program_key``, hit count,
    bucket histogram)."""
    with _CACHE_LOCK:
        plans = list(_CACHE.values())
        entries = [{"key": p.key[:160], "program_key": p.key,
                    "hits": p.hits,
                    "compiles": p.compiles, "buckets": dict(p.buckets),
                    "runtime_literals": p.n_lits}
                   for p in plans]
    return {
        "kind": "plan-keyed cache (fused expression pipeline)",
        "size": len(entries),
        "capacity": int(config.pipeline_cache_size),
        "hits": counters.get("pipeline.hit"),
        "misses": counters.get("pipeline.compile"),
        "evictions": counters.get("pipeline.evict"),
        "fallbacks": counters.get("pipeline.fallback"),
        "entries": entries,
    }


#: Numeric literal tokens of the plan-key grammar (``V(3)``, ``V(3.5)``):
#: the positions literal hoisting should have emptied.
_NUM_LIT_RE = re.compile(r"V\((-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\)")


def program_handles() -> list:
    """Registry callback: one :class:`~..utils.observability.ProgramHandle`
    per cached plan that has run: ``fn`` is the plan's body, ``args`` the
    input specs (``{name: (trailing shape, dtype)}``, the donated specs,
    the bucket, the literals) of its first run, the variants the same at
    twice and four times the bucket."""
    with _CACHE_LOCK:
        plans = list(_CACHE.values())
    out = []
    for p in plans:
        if p.example is None:
            continue
        kept, donated, b, lits = p.example
        out.append(_obs.ProgramHandle(
            "pipeline", p.key, p.trace_body,
            args=(kept, donated, b, lits),
            variants={"bucket": [((kept, donated, 2 * b, lits), {}),
                                 ((kept, donated, 4 * b, lits), {})]},
            meta={"expected_traces": max(len(p.buckets), 1),
                  "observed_traces": p.traces,
                  "dedup_key": _NUM_LIT_RE.sub("V(#)", p.key),
                  "runtime_literals": p.n_lits,
                  "rows": p.example_rows}))
    return out


_obs.CACHES.register("pipeline", cache_stats)
_obs.CACHES.register_programs("pipeline", program_handles)
