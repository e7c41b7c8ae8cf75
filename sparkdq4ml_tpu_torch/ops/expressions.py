"""Column expressions, evaluated eagerly on tensors
(``sparkdq4ml_tpu/ops/expressions.py``): column references, literals
(numbers, booleans, strings, NULL), aliases, casts to int, double, float
and string, arithmetic (``+ - * / %``, unary minus), the comparison and
boolean operators, ``IN`` lists, ``IS [NOT] NULL``, ``LIKE``, ``CASE
WHEN``, sort markers (``asc``/``desc``), UDF calls, the builtin function
library (``Func`` over ``_BUILTIN_FNS``, 140 names), the row functions
(``RowFunc``, ``_ROW_FNS``: ``rand``, ``randn``,
``monotonically_increasing_id``, ``spark_partition_id``,
``uuid``, ``typeof``), the generators (``explode``, ``explode_outer``,
``posexplode``, ``json_tuple``), the higher-order functions
(``transform``, ``filter``, ``exists``, ``aggregate`` over a
``Lambda``) and ``expr``. CAST to a type outside int, double, float and
string raises ``NotImplementedError`` that names it.

The function bodies live in topic modules beside this one:
``fn_numeric`` (numbers), ``fn_strings`` (text), ``fn_arrays`` (arrays),
``fn_dates`` (dates and timestamps) and ``fn_hashes`` (hashes and JSON);
``cells`` holds the helpers they share. Each name computes where the JAX
package computes it: a jnp op becomes the torch op on the column's
device; numpy or Python on the host stays on the host, and a numeric
result goes to the frame's device.

String and array columns are numpy object arrays on the host, as in the
JAX package, with ``None`` as their null. Numeric predicates stay torch
ops on the frame's device; string predicates compute on the host and hand
the device a bool mask.
"""

from __future__ import annotations

import builtins
import re
from typing import Sequence

import numpy as np
import torch

from ..config import float_dtype, int_dtype, numpy_dtype, wide_types
# the JAX package's helper names, kept here where its readers look for them
from .cells import (_cell_is_null, _int_or_null, _is_null_cell,  # noqa: F401
                    _null_cells, _null_mask, _require_array_cells,
                    _scalar_int, _scalar_str, _scalar_value, _str_map,
                    bool_or_null, evaluating_on, host_array, host_mask,
                    host_objects, is_host_column, list_column,
                    tensor_strings)
from .fn_arrays import ARRAY_FNS
from .fn_dates import DATE_FNS
from .fn_hashes import HASH_JSON_FNS, json_tuple_columns
from .fn_numeric import NUMERIC_FNS, _sql_divide, _sql_mod
from .fn_strings import STRING_FNS

# CAST's string target: the columns it makes are host object arrays.
STRING = np.dtype(object)

_TYPE_NAMES = {
    "int": int_dtype,
    "integer": int_dtype,
    # int64 only under the float64 policy, as JAX gives int64 only in x64
    "long": lambda: torch.int64 if wide_types() else torch.int32,
    "float": lambda: torch.float32,
    "double": float_dtype,
    "boolean": lambda: torch.bool,
    "string": lambda: STRING,
}

# the word literals a string -> boolean CAST reads (the JAX package's)
_BOOL_TRUE = frozenset(("true", "t", "yes", "y", "1"))
_BOOL_FALSE = frozenset(("false", "f", "no", "n", "0"))

_SPARK_TYPE = {torch.int32: "integer", torch.int16: "integer",
               torch.int8: "integer", torch.int64: "long",
               torch.float32: "float", torch.float64: "double",
               torch.bool: "boolean"}


def spark_type_name(dtype) -> str:
    """dtype -> Spark printSchema type name; anything else is a string."""
    return _SPARK_TYPE.get(dtype, "string")


def resolve_type_name(name: str) -> torch.dtype:
    try:
        return _TYPE_NAMES[name.lower()]()
    except KeyError:
        raise NotImplementedError(
            f"SQL type {name!r} is not in the torch port's subset "
            f"(supported: {sorted(_TYPE_NAMES)})") from None


class Expr:
    """Base column expression; Python operators build comparison and
    boolean expressions, like Spark's Column."""

    def eval(self, frame):  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def name(self) -> str:
        return str(self)

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def cast(self, type_name: str) -> "Cast":
        return Cast(self, type_name)

    astype = cast   # PySpark alias

    def isin(self, *values) -> "InList":
        """Membership test, ``col.isin(1, 2, 3)`` or SQL ``IN (...)``."""
        if len(values) == 1 and isinstance(values[0], (list, tuple, set)):
            values = tuple(values[0])
        return InList(self, [_as_expr(v) for v in values])

    def between(self, lower, upper) -> "Expr":
        """``lower <= col <= upper`` (inclusive), SQL ``BETWEEN``."""
        return (self >= lower) & (self <= upper)

    def like(self, pattern: str) -> "StringMatch":
        """SQL LIKE: ``%`` any run, ``_`` one character."""
        return StringMatch(self, pattern)

    def rlike(self, pattern: str) -> "StringMatch":
        """Regex search (Spark ``rlike``)."""
        return StringMatch(self, pattern, kind="rlike")

    def contains(self, sub: str) -> "StringMatch":
        return StringMatch(self, sub, kind="contains")

    def startswith(self, prefix: str) -> "StringMatch":
        return StringMatch(self, prefix, kind="startswith")

    def endswith(self, suffix: str) -> "StringMatch":
        return StringMatch(self, suffix, kind="endswith")

    def ilike(self, pattern: str) -> "StringMatch":
        """Case-insensitive LIKE (Spark ``ilike``): both sides lowered."""
        return StringMatch(fn("lower", self), pattern.lower())

    def eq_null_safe(self, other) -> "Expr":
        """Null-safe equality (Spark ``eqNullSafe``): true when both sides
        are null, false when one is."""
        other = _as_expr(other)
        return (self == other) | (self.is_null() & other.is_null())

    eqNullSafe = eq_null_safe

    def substr(self, startPos, length) -> "Func":
        """Spark ``col.substr(pos, len)`` (1-based), ``substring``'s
        method form; ``pos`` and ``len`` may be ints or columns."""
        return fn("substring", self, _as_expr(startPos), _as_expr(length))

    def get_item(self, key: int) -> "Func":
        """Spark ``getItem``: the 0-based array element; a negative or
        out-of-range ordinal is null."""
        return fn("get_item", self, Lit(int(key)))

    getItem = get_item

    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "IsNull":
        return IsNull(self, negated=True)

    isNull = is_null
    isNotNull = is_not_null

    def asc(self) -> "SortOrder":
        """Ascending sort marker for ``sort`` and window specs; nulls
        first unless pinned by the ``_nulls_first/_last`` variants."""
        return SortOrder(self, True)

    def desc(self) -> "SortOrder":
        """Descending sort marker; nulls last by default (Spark)."""
        return SortOrder(self, False)

    def asc_nulls_first(self) -> "SortOrder":
        return SortOrder(self, True, nulls_first=True)

    def asc_nulls_last(self) -> "SortOrder":
        return SortOrder(self, True, nulls_first=False)

    def desc_nulls_first(self) -> "SortOrder":
        return SortOrder(self, False, nulls_first=True)

    def desc_nulls_last(self) -> "SortOrder":
        return SortOrder(self, False, nulls_first=False)

    def _bin(self, op, other, reverse=False):
        other = other if isinstance(other, Expr) else Lit(other)
        return BinOp(op, other, self) if reverse else BinOp(op, self, other)

    def __add__(self, o):  return self._bin("+", o)
    def __radd__(self, o): return self._bin("+", o, True)
    def __sub__(self, o):  return self._bin("-", o)
    def __rsub__(self, o): return self._bin("-", o, True)
    def __mul__(self, o):  return self._bin("*", o)
    def __rmul__(self, o): return self._bin("*", o, True)
    def __truediv__(self, o):  return self._bin("/", o)
    def __rtruediv__(self, o): return self._bin("/", o, True)
    def __mod__(self, o):      return self._bin("%", o)
    def __rmod__(self, o):     return self._bin("%", o, True)
    def __neg__(self):     return Neg(self)
    def __lt__(self, o):   return self._bin("<", o)
    def __le__(self, o):   return self._bin("<=", o)
    def __gt__(self, o):   return self._bin(">", o)
    def __ge__(self, o):   return self._bin(">=", o)
    def __eq__(self, o):   return self._bin("==", o)  # type: ignore[override]
    def __ne__(self, o):   return self._bin("!=", o)  # type: ignore[override]
    def __and__(self, o):  return self._bin("&", o)
    def __rand__(self, o): return self._bin("&", o, True)
    def __or__(self, o):   return self._bin("|", o)
    def __ror__(self, o):  return self._bin("|", o, True)
    def __invert__(self):  return Not(self)

    __hash__ = object.__hash__  # __eq__ is overloaded; keep Exprs hashable


class SortOrder:
    """Sort-direction marker from ``col.asc()``/``col.desc()`` and the
    ``*_nulls_first/last`` variants, read by ``Frame.sort`` and window
    specs; not evaluable. ``nulls_first=None`` is Spark's default for the
    direction: first ascending, last descending."""

    def __init__(self, child: Expr, ascending: bool, nulls_first=None):
        self.child = child
        self.ascending = ascending
        self.nulls_first = nulls_first

    @property
    def name(self) -> str:
        return self.child.name


class Col(Expr):
    def __init__(self, name: str):
        self._name = name

    def eval(self, frame):
        return frame._column_values(self._name)

    @property
    def name(self) -> str:
        return self._name

    def __str__(self):
        return self._name


class Lit(Expr):
    """A literal, evaluated as a full column like the reference's: a
    tensor for a bool, int or float (NULL is a float NaN), a host object
    array for a string or ``None``."""

    def __init__(self, value):
        if not isinstance(value, (bool, int, float, str, type(None))):
            raise NotImplementedError(
                f"literal {value!r}: only bool, int, float, string and None "
                "literals are in the torch port's expression subset")
        self.value = value

    def eval(self, frame):
        if isinstance(self.value, bool):
            dt = torch.bool
        elif isinstance(self.value, int):
            dt = int_dtype()
        elif isinstance(self.value, float):
            dt = float_dtype()
        else:
            return np.full((frame.num_slots,), self.value, dtype=object)
        return torch.full((frame.num_slots,), self.value, dtype=dt,
                          device=frame.device)

    def __str__(self):
        return repr(self.value)


class Alias(Expr):
    def __init__(self, child: Expr, name: str):
        self.child = child
        self._name = name

    def eval(self, frame):
        return self.child.eval(frame)

    @property
    def name(self) -> str:
        return self._name

    def __str__(self):
        return f"{self.child} AS {self._name}"


def predicate_keep_mask(cond: torch.Tensor) -> torch.Tensor:
    """SQL WHERE truthiness: a NULL (NaN) predicate drops the row and
    nonzero numerics are true."""
    if cond.is_floating_point():
        return ~torch.isnan(cond) & (cond != 0)
    return cond.to(torch.bool)


_BIN_FNS = {
    "+": torch.add, "-": torch.sub, "*": torch.mul,
    "/": _sql_divide, "%": _sql_mod,
    "<": torch.lt, "<=": torch.le, ">": torch.gt, ">=": torch.ge,
    "==": torch.eq, "!=": torch.ne,
    "&": torch.logical_and, "|": torch.logical_or,
}


class BinOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        if op not in _BIN_FNS:
            raise NotImplementedError(
                f"operator {op!r} is not in the torch port's expression "
                "subset")
        self.op, self.left, self.right = op, left, right

    def eval(self, frame):
        a, b = self.left.eval(frame), self.right.eval(frame)
        if is_host_column(a) or is_host_column(b):
            # string columns live on the host: == and != compare there
            if self.op not in ("==", "!="):
                raise NotImplementedError(
                    f"operator {self.op} on a string column is not in the "
                    "torch port's expression subset")
            fn = np.equal if self.op == "==" else np.not_equal
            return host_mask(fn(host_objects(a), host_objects(b)), frame)
        if self.op in ("/", "%"):
            # Spark's / always yields a double; % needs a float for the
            # NULL of a zero divisor
            a, b = a.to(float_dtype()), b.to(float_dtype())
        return _BIN_FNS[self.op](a, b)

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


class Neg(Expr):
    """Unary minus."""

    def __init__(self, child: Expr):
        self.child = child

    def eval(self, frame):
        return torch.neg(self.child.eval(frame))

    def __str__(self):
        return f"(-{self.child})"


class Not(Expr):
    def __init__(self, child: Expr):
        self.child = child

    def eval(self, frame):
        return torch.logical_not(self.child.eval(frame))

    def __str__(self):
        return f"(!{self.child})"


def _cast_strings(v, dt, device):
    """Spark's string -> number CAST (the JAX package's ``_cast_strings``):
    trim and parse; an unparseable or null cell is NULL. An int target
    parses integral text exactly and, when every cell is such text, stays
    an int column; otherwise it truncates toward zero into a float column
    with NaN for NULL. Underscores (Python syntax, not SQL) do not
    parse."""
    if dt == torch.bool:
        vals = []
        for x in v:
            t = None if x is None else str(x).strip().lower()
            vals.append(True if t in _BOOL_TRUE else
                        False if t in _BOOL_FALSE else None)
        if any(b is None for b in vals):
            return torch.as_tensor([np.nan if b is None else float(b)
                                    for b in vals], dtype=float_dtype(),
                                   device=device)
        return torch.as_tensor(np.asarray(vals, np.bool_), device=device)
    int_target = not dt.is_floating_point
    parsed = np.empty(len(v), np.float64)
    exact = np.zeros(len(v), np.int64)
    all_exact_int = True
    for i, x in enumerate(v):
        if x is None:
            parsed[i] = np.nan
            all_exact_int = False
            continue
        t = str(x).strip()
        if "_" in t:
            parsed[i] = np.nan
            all_exact_int = False
            continue
        try:
            exact[i] = int(t)
            parsed[i] = float(exact[i])
            continue
        except (ValueError, OverflowError):
            all_exact_int = False
        try:
            parsed[i] = float(t)
        except ValueError:
            parsed[i] = np.nan
    if int_target:
        if all_exact_int:
            return torch.as_tensor(exact.astype(numpy_dtype(dt)),
                                   device=device)
        whole = np.where(np.isfinite(parsed), np.trunc(parsed), np.nan)
        return torch.as_tensor(whole, dtype=float_dtype(), device=device)
    return torch.as_tensor(parsed, dtype=dt, device=device)


def _float_to_int(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """XLA's float -> int32/int64 conversion: truncate toward zero,
    NaN -> 0, saturate out of range. The lower bound -2^(bits-1) is exact
    in float64; the upper one need not be (2^63 - 1 is not), so a value
    at or past 2^(bits-1) is set to it apart."""
    info = torch.iinfo(dt)
    v = torch.nan_to_num(v.to(torch.float64), nan=0.0)
    top = v >= 2.0 ** (info.bits - 1)
    out = torch.where(top, torch.zeros_like(v), v).clamp(min=info.min)
    out = out.trunc().to(dt)
    return torch.where(top, torch.full_like(out, info.max), out)


class Cast(Expr):
    """CAST(expr AS int|long|double|float|boolean|string): double -> int
    truncates toward zero (NaN 0, out of range saturated, as XLA); a
    number becomes its text (NULL stays NULL); a string is trimmed and
    parsed, and what does not parse is NULL (an int or boolean target
    then yields a float column with NaN, as the JAX package does)."""

    def __init__(self, child: Expr, type_name: str):
        resolve_type_name(type_name)          # raises outside the subset
        self.child = child
        self.type_name = type_name

    def eval(self, frame):
        v = self.child.eval(frame)
        dt = resolve_type_name(self.type_name)
        if dt is STRING:
            # the JAX package iterates a numpy array: numpy scalars print
            # at their own precision ('23.24' for a float32 23.24); a 1-D
            # tensor renders once per distinct value
            if isinstance(v, torch.Tensor) and v.dim() == 1:
                return tensor_strings(v)
            a = v if is_host_column(v) else v.cpu().numpy()
            return np.asarray(
                [None if x is None
                 or (isinstance(x, (float, np.floating)) and np.isnan(x))
                 else str(x) for x in a], dtype=object)
        if is_host_column(v):
            return _cast_strings(v, dt, frame.device)
        if v.is_floating_point() and not dt.is_floating_point \
                and dt != torch.bool:
            return _float_to_int(v, dt)
        return v.to(dt)          # to boolean: nonzero (NaN too) is true

    @property
    def name(self) -> str:
        return f"CAST({self.child} AS {self.type_name.upper()})"

    def __str__(self):
        return self.name


class UdfCall(Expr):
    """Invocation of a registered UDF by name (``callUDF``), resolved at
    evaluation time against the registry; a name the registry lacks
    falls back to the row functions, then to the builtins."""

    def __init__(self, udf_name: str, args: Sequence[Expr], registry=None):
        self.udf_name = udf_name
        self.args = list(args)
        self._registry = registry

    def eval(self, frame):
        from .udf import default_registry

        reg = self._registry if self._registry is not None \
            else default_registry()
        try:
            fn_, return_dtype = reg.lookup(self.udf_name)
        except KeyError:
            # the builtins by name (SQL ``abs(x)``, ``upper(s)``): a
            # registered UDF wins, then the row functions, then the rest
            key = self.udf_name.lower()
            if key in _ROW_FNS:
                return _ROW_FNS[key](frame, self.args)
            if key in _BUILTIN_FNS:
                return Func(key, self.args).eval(frame)
            raise
        out = fn_(*[a.eval(frame) for a in self.args])
        if return_dtype is not None:
            out = out.to(return_dtype)
        # the data-quality observatory (utils/dqprof.py): one flag read
        # when it is off
        from ..config import config as _cfg

        if _cfg.dq_profile_enabled:
            from ..utils import dqprof as _dqprof

            _dqprof.record_eval(self.udf_name, out)
        return out

    @property
    def name(self) -> str:
        return f"{self.udf_name}({', '.join(str(a) for a in self.args)})"

    def __str__(self):
        return self.name


def _as_expr(v) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


class IsNull(Expr):
    """``IS [NOT] NULL``: ``None`` in a string column, NaN in a float one;
    an int or bool column has no null."""

    def __init__(self, child: Expr, negated: bool = False):
        self.child = child
        self.negated = negated

    def eval(self, frame):
        v = self.child.eval(frame)
        if is_host_column(v):
            nulls = host_mask([x is None for x in v], frame)
        elif v.is_floating_point():
            nulls = torch.isnan(v)
        else:
            nulls = torch.zeros(v.shape[:1], dtype=torch.bool,
                                device=v.device)
        return ~nulls if self.negated else nulls

    def __str__(self):
        return f"({'isnotnull' if self.negated else 'isnull'}{self.child})"


class InList(Expr):
    """``expr [NOT] IN (v1, v2, ...)``: numeric columns compare on the
    device, string columns on the host. A null row is never a member, so
    it fails both IN and NOT IN. A NULL in the list follows SQL's
    three-valued logic: ``NOT IN (..., NULL)`` holds for no row, and ``IN``
    drops the NULL."""

    def __init__(self, child: Expr, values: Sequence[Expr],
                 negated: bool = False):
        self.child = child
        self.values = list(values)
        self.negated = negated

    @staticmethod
    def _is_null_lit(x) -> bool:
        return isinstance(x, Lit) and _is_null_cell(x.value)

    def eval(self, frame):
        values = self.values
        if any(self._is_null_lit(x) for x in values):
            if self.negated:
                return torch.zeros(frame.num_slots, dtype=torch.bool,
                                   device=frame.device)
            values = [x for x in values if not self._is_null_lit(x)]
        v = self.child.eval(frame)
        vals = [x.eval(frame) for x in values]
        if is_host_column(v) or any(is_host_column(x) for x in vals):
            va = host_objects(v)
            hit = np.zeros(va.shape[0], bool)
            for x in vals:
                hit |= np.equal(va, host_objects(x)).astype(bool)
            hit = host_mask(hit, frame)
            notnull = host_mask([x is not None for x in va], frame)
        else:
            hit = torch.zeros(v.shape[:1], dtype=torch.bool, device=v.device)
            for x in vals:
                hit |= torch.eq(v, x)
            notnull = (~torch.isnan(v) if v.is_floating_point()
                       else torch.ones_like(hit))
        return ((~hit) if self.negated else hit) & notnull

    def __str__(self):
        op = "NOT IN" if self.negated else "IN"
        return f"({self.child} {op} ({', '.join(map(str, self.values))}))"


class InColumn(Expr):
    """``expr [NOT] IN (SELECT col ...)``: a semi join of the rows against
    the valid values of a subquery's column, with ``InList``'s SQL null
    rules. Numbers join on the device (the distinct values sorted once,
    then a binary search a row); strings on the host (a hash set). The
    values compare at the types their literals would have."""

    def __init__(self, child: Expr, values, negated: bool = False):
        self.child = child
        self.values = values           # a tensor or a host object array
        self.negated = negated

    def eval(self, frame):
        vals = self.values
        v = self.child.eval(frame)
        if is_host_column(vals) or is_host_column(v):
            vals = host_objects(vals)
            nulls = _null_cells(vals)
        else:
            nulls = torch.isnan(vals) if vals.is_floating_point() else None
        if nulls is not None and bool(nulls.any()):
            if self.negated:
                return torch.zeros(frame.num_slots, dtype=torch.bool,
                                   device=frame.device)
            vals = vals[~nulls]
        if isinstance(vals, np.ndarray):
            va = host_objects(v)
            table = set(vals.tolist())
            hit = host_mask([x in table for x in va], frame)
            notnull = host_mask([x is not None for x in va], frame)
        else:
            vals = vals.to(vals.dtype if vals.dtype == torch.bool
                           else float_dtype() if vals.is_floating_point()
                           else int_dtype()).to(v.device)
            common = torch.promote_types(v.dtype, vals.dtype)
            if common == torch.bool:
                common = torch.int8            # searchsorted takes numbers
            table = torch.unique(vals.to(common))         # sorted
            vc = v.to(common)
            if table.numel():
                pos = torch.searchsorted(table, vc).clamp_(
                    max=table.numel() - 1)
                hit = table.index_select(0, pos) == vc
            else:
                hit = torch.zeros(v.shape[:1], dtype=torch.bool,
                                  device=v.device)
            notnull = (~torch.isnan(v) if v.is_floating_point()
                       else torch.ones_like(hit))
        return ((~hit) if self.negated else hit) & notnull

    def __str__(self):
        op = "NOT IN" if self.negated else "IN"
        return f"({self.child} {op} (subquery))"


class StringMatch(Expr):
    """``expr [NOT] LIKE pattern`` (``%`` matches any run, ``_`` one
    character) and the Column methods ``rlike`` (a regex search),
    ``contains``, ``startswith`` and ``endswith``; matched on the host once
    per distinct string, a null row fails both forms."""

    def __init__(self, child: Expr, pattern: str, negated: bool = False,
                 kind: str = "like"):
        self.child = child
        self.pattern = pattern
        self.negated = negated
        self.kind = kind

    def _matcher(self):
        pat = self.pattern
        if self.kind == "like":
            rx = re.compile(re.escape(pat).replace("%", ".*")
                            .replace("_", "."), re.DOTALL)
            return lambda s: rx.fullmatch(s) is not None
        if self.kind == "rlike":
            rx = re.compile(pat)
            return lambda s: rx.search(s) is not None
        if self.kind == "contains":
            return lambda s: pat in s
        if self.kind == "startswith":
            return lambda s: s.startswith(pat)
        if self.kind == "endswith":
            return lambda s: s.endswith(pat)
        raise ValueError(self.kind)

    def eval(self, frame):
        from . import strings

        match = self._matcher()
        v = self.child.eval(frame)
        if is_host_column(v):
            # one match a distinct string, then a lookup a row by code
            codes, words = strings.codes(v)
            keep = np.asarray([match(w) != self.negated for w in words]
                              + [False], bool)
            return host_mask(keep[codes], frame)   # NULL_CODE: no row
        hit = np.asarray([match(str(x)) for x in host_objects(v)], bool)
        return host_mask(~hit if self.negated else hit, frame)

    def __str__(self):
        neg = "NOT " if self.negated else ""
        return f"({self.child} {neg}{self.kind.upper()} {self.pattern!r})"


class CaseWhen(Expr):
    """``when(cond, value).when(...).otherwise(value)`` and SQL ``CASE
    WHEN``: the first branch whose condition holds. Numeric values select
    on the device; a string value anywhere makes the result a host string
    column. A missing ELSE is NULL (NaN, or None for strings)."""

    def __init__(self, branches, otherwise=None):
        self.branches = list(branches)      # [(condition, value), ...]
        self.otherwise_expr = otherwise

    def when(self, condition: Expr, value) -> "CaseWhen":
        return CaseWhen(self.branches + [(condition, _as_expr(value))],
                        self.otherwise_expr)

    def otherwise(self, value) -> "CaseWhen":
        return CaseWhen(self.branches, _as_expr(value))

    def eval(self, frame):
        literals = [v for _, v in self.branches] + (
            [self.otherwise_expr] if self.otherwise_expr is not None else [])
        if all(isinstance(v, Lit) and isinstance(v.value, (str, type(None)))
               for v in literals):
            return self._eval_string_literals(frame)
        conds = [c.eval(frame) for c, _ in self.branches]
        vals = [v.eval(frame) for _, v in self.branches]
        stringy = any(is_host_column(v) for v in vals)
        if self.otherwise_expr is not None:
            out = self.otherwise_expr.eval(frame)
            stringy = stringy or is_host_column(out)
        elif stringy:
            out = np.full((frame.num_slots,), None, dtype=object)
        else:
            out = torch.full((frame.num_slots,), float("nan"),
                             dtype=float_dtype(), device=frame.device)
        if stringy:
            out = host_objects(out)
            for c, v in zip(reversed(conds), reversed(vals)):
                c = c if isinstance(c, np.ndarray) else c.cpu().numpy()
                out = np.where(c.astype(bool), host_objects(v), out)
            return out
        for c, v in zip(reversed(conds), reversed(vals)):
            if out.is_floating_point() or v.is_floating_point():
                v, out = v.to(float_dtype()), out.to(float_dtype())
            out = torch.where(c.to(torch.bool), v, out)
        return out

    def _eval_string_literals(self, frame):
        """Every value a string literal (or NULL): the index of the first
        branch that holds is found on the device, and the strings are
        picked on the host by that index in one gather."""
        pick = torch.full((frame.num_slots,), len(self.branches),
                          dtype=torch.int16, device=frame.device)
        for i in range(len(self.branches) - 1, -1, -1):
            cond = self.branches[i][0].eval(frame)
            if not isinstance(cond, torch.Tensor):
                cond = host_mask(cond, frame)
            pick = torch.where(cond.to(torch.bool), i, pick)
        lut = np.empty(len(self.branches) + 1, dtype=object)
        lut[:-1] = [v.value for _, v in self.branches]
        lut[-1] = (None if self.otherwise_expr is None
                   else self.otherwise_expr.value)
        return lut[pick.cpu().numpy()]

    @property
    def name(self) -> str:
        parts = " ".join(f"WHEN {c} THEN {v}" for c, v in self.branches)
        tail = (f" ELSE {self.otherwise_expr}"
                if self.otherwise_expr is not None else "")
        return f"CASE {parts}{tail} END"

    def __str__(self):
        return self.name




# ---------------------------------------------------------------------------
# The builtin function library
# ---------------------------------------------------------------------------

# name -> fn(*evaluated args), the JAX package's 140 builtins
_BUILTIN_FNS = {**NUMERIC_FNS, **STRING_FNS, **ARRAY_FNS, **DATE_FNS,
                **HASH_JSON_FNS}


def _argument(expr, frame):
    """A builtin's argument as a column. A string literal is one cell
    broadcast over the frame's slots (a read-only view, no copy per
    slot), which ``_scalar_value`` reads in O(1)."""
    if isinstance(expr, Lit) and isinstance(expr.value, str):
        return np.broadcast_to(np.asarray([expr.value], object),
                               (frame.num_slots,))
    return expr.eval(frame)


class Func(Expr):
    """A call of a builtin scalar function by name (the scalar set of
    ``org.apache.spark.sql.functions``); an unknown name raises
    ``ValueError``. The arguments evaluate as columns; a numeric function
    runs torch ops on the frame's device, a string, array, hash or JSON
    one runs on the host, and a numeric result it builds there lands on
    the frame's device."""

    def __init__(self, fn_name: str, args: Sequence[Expr]):
        key = fn_name.lower()
        if key not in _BUILTIN_FNS:
            raise ValueError(f"unknown function {fn_name!r}")
        self.fn_name = key
        self.args = list(args)

    def eval(self, frame):
        with evaluating_on(frame.device):
            return _BUILTIN_FNS[self.fn_name](*[_argument(a, frame)
                                                for a in self.args])

    @property
    def name(self) -> str:
        return f"{self.fn_name}({', '.join(str(a) for a in self.args)})"

    def __str__(self):
        return self.name


class RowFunc(Expr):
    """A column that knows only the frame's row count: ``rand``/``randn``
    (numpy's ``default_rng(seed)`` drawn on the host over every row slot,
    then copied to the frame's device, so a seed gives the JAX package's
    stream bit for bit; a negative seed folds to 63 bits), the row ids
    0..n-1 and the partition id 0 (one logical partition)."""

    _KINDS = ("rand", "randn", "id", "partition_id")

    def __init__(self, kind: str, seed=None):
        if kind not in self._KINDS:
            raise ValueError(f"unknown row generator {kind!r}")
        self.kind = kind
        self.seed = seed

    def eval(self, frame):
        n = frame.num_slots
        if self.kind == "id":
            return torch.arange(n, dtype=int_dtype(), device=frame.device)
        if self.kind == "partition_id":
            return torch.zeros(n, dtype=int_dtype(), device=frame.device)
        seed = self.seed
        if seed is not None and int(seed) < 0:
            seed = int(seed) & 0x7FFFFFFFFFFFFFFF
        rng = np.random.default_rng(seed)
        host = (rng.uniform(size=n) if self.kind == "rand"
                else rng.standard_normal(size=n))
        return torch.as_tensor(host.astype(numpy_dtype(float_dtype())),
                               device=frame.device)

    @property
    def name(self) -> str:
        if self.kind == "id":
            return "monotonically_increasing_id()"
        if self.kind == "partition_id":
            return "spark_partition_id()"
        seed = "" if self.seed is None else str(self.seed)
        return f"{self.kind}({seed})"

    def __str__(self):
        return self.name


def _lit_arg(expr, what):
    """A literal argument's value, a negated literal included."""
    if isinstance(expr, Lit):
        return expr.value
    if isinstance(expr, Neg) and isinstance(expr.child, Lit):
        return -expr.child.value
    raise ValueError(f"{what} must be a literal")


def _row_generator(sql_name, kind, takes_seed=False):
    def f(frame, args):
        if not takes_seed and args:
            raise ValueError(f"{sql_name}() takes no arguments")
        if args and len(args) > 1:
            raise ValueError(f"{sql_name}([seed]) takes at most one "
                             "argument")
        seed = int(_lit_arg(args[0], f"{sql_name} seed")) if args else None
        return RowFunc(kind, seed).eval(frame)
    return f


def _row_uuid(frame, args):
    if args:
        raise ValueError("uuid() takes no arguments")
    import uuid as _uuid

    return np.asarray([str(_uuid.uuid4()) for _ in range(frame.num_slots)],
                      dtype=object)


def _row_typeof(frame, args):
    if len(args) != 1:
        raise ValueError("typeof(expr) takes one argument")
    v = args[0].eval(frame)
    if is_host_column(v):
        name = "string"
    else:
        dt = v.dtype
        name = ("boolean" if dt == torch.bool
                else "double" if dt.is_floating_point else "int")
    return np.asarray([name] * frame.num_slots, dtype=object)


# Row functions reached by name from SQL: they need the frame (its row
# count, an argument's dtype), so they take (frame, arg exprs).
_ROW_FNS = {
    "monotonically_increasing_id":
        _row_generator("monotonically_increasing_id", "id"),
    "spark_partition_id": _row_generator("spark_partition_id",
                                         "partition_id"),
    "rand": _row_generator("rand", "rand", takes_seed=True),
    "randn": _row_generator("randn", "randn", takes_seed=True),
    "uuid": _row_uuid,
    "typeof": _row_typeof,
}


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

class Explode(Expr):
    """``explode``, ``explode_outer`` and ``posexplode``: a generator, not
    a column. ``Frame.select`` (one a select) turns each element of an
    array cell into a row (``posexplode`` adds its 0-based position as
    ``pos``); evaluating it as a column raises. ``source`` is a column
    name or an array-valued expression (``split(...)``)."""

    def __init__(self, source, outer: bool = False,
                 with_position: bool = False):
        self.source = source
        self.outer = outer
        self.with_position = with_position

    def eval(self, frame):
        raise ValueError("explode() is a generator: use it inside select() "
                         "(one a select) or call Frame.explode(column)")

    def source_values(self, frame):
        if isinstance(self.source, str):
            return frame._column_values(self.source)
        return self.source.eval(frame)

    @property
    def name(self) -> str:
        return "col"                        # Spark's generator column name

    def __str__(self):
        fn_ = ("posexplode" if self.with_position
               else "explode_outer" if self.outer else "explode")
        return f"{fn_}({self.source})"


class JsonTuple(Expr):
    """``json_tuple(col, 'f1', 'f2', ...)``: a generator of one string
    column a field (c0...cN), no row multiplication; ``Frame.select``
    expands it, and evaluating it as a column raises."""

    def __init__(self, source, fields):
        self.source = _coerce(source)
        self.fields = [str(f) for f in fields]
        if not self.fields:
            raise ValueError("json_tuple needs at least one field name")

    def eval(self, frame):
        raise ValueError(
            "json_tuple() is a generator producing multiple columns — "
            "use it as a top-level select item")

    def columns(self, frame):
        """``[(name, object column), ...]`` for ``Frame.select``."""
        return json_tuple_columns(self.source.eval(frame), self.fields)


# ---------------------------------------------------------------------------
# Higher-order functions: transform, filter, exists, aggregate
# ---------------------------------------------------------------------------
#
# transform/filter/exists evaluate the lambda body once over a scope frame
# of every element of every cell (the outer columns the body reads
# repeated per element, numeric ones on the device); the results regroup
# by cell length. aggregate folds by element position: one body
# evaluation per position j over the rows whose cells reach j.


class Lambda:
    """``x -> body`` / ``(acc, x) -> body``: parameter names and a body in
    which they appear as column references (the scope frame binds them,
    shadowing outer columns as Spark does)."""

    def __init__(self, params, body: Expr):
        self.params = [str(p) for p in params]
        self.body = body


_LAM_COUNTER = [0]


def _fresh_lambda(fn_, n_params):
    """A PySpark-3 lambda: the callable gets column references to freshly
    named parameters and returns the body."""
    names = []
    for _ in range(n_params):
        names.append(f"_lam_x{_LAM_COUNTER[0]}")
        _LAM_COUNTER[0] += 1
    body = fn_(*[Col(n) for n in names])
    return Lambda(names, body if isinstance(body, Expr) else Lit(body))


def _column_from_elems(elems):
    """An element list (``None`` allowed) as a column: strings stay host
    objects, anything else becomes the policy's float with NaN, on the
    evaluation device."""
    from .cells import device_array

    if any(isinstance(v, str) for v in elems):
        return np.asarray(elems, object)
    return device_array(np.fromiter(
        (np.nan if v is None else float(v) for v in elems), np.float64,
        len(elems)), float_dtype())


def _referenced_cols(e, out: set):
    """Column names reachable from an expression tree, by a walk over its
    attributes (new expression kinds need no registration)."""
    if isinstance(e, Col):
        out.add(e.name)
        return
    if not isinstance(e, Expr):
        return
    for v in vars(e).values():
        if isinstance(v, Expr):
            _referenced_cols(v, out)
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, (list, tuple)):
                    for y in x:
                        _referenced_cols(y, out)
                else:
                    _referenced_cols(x, out)


_NULL_ABSORBERS = {"isnull", "isnan", "coalesce", "ifnull", "nvl", "nvl2",
                   "nullif"}


def _null_defined_on(body: Expr, param: str) -> bool:
    """True when the body is non-null on a null ``param``: every reference
    to it sits under a null-absorbing function (so ``exists`` reports its
    computed values, where ``x > 4`` on a null element is unknown)."""
    def ok(e) -> bool:
        if isinstance(e, Col):
            return e.name != param
        if isinstance(e, Func) and e.fn_name in _NULL_ABSORBERS:
            return True
        if isinstance(e, IsNull):
            return True
        if isinstance(e, UdfCall) and e.udf_name.lower() in _NULL_ABSORBERS:
            return True
        if not isinstance(e, Expr):
            return True
        for v in vars(e).values():
            kids = v if isinstance(v, (list, tuple)) else [v]
            for k in kids:
                inner = k if isinstance(k, (list, tuple)) else [k]
                for x in inner:
                    if isinstance(x, Expr) and not ok(x):
                        return False
        return True

    return ok(body)


def _scope_frame(parent, lens, bindings, needed=None):
    """The per-element scope: the outer columns repeated by cell length
    (device columns by ``repeat_interleave``, host ones by ``np.repeat``),
    only those in ``needed`` when given, and the lambda's parameters
    last, so they shadow outer names."""
    from ..frame.frame import Frame

    reps = np.asarray(lens, np.int64)
    reps_dev = torch.as_tensor(reps, device=parent.device)
    data = {}
    for name, vals in parent._data.items():
        if needed is not None and name not in needed:
            continue
        data[name] = (np.repeat(vals, reps, axis=0) if is_host_column(vals)
                      else vals.repeat_interleave(reps_dev, dim=0))
    data.update(bindings)
    return Frame(data, device=parent.device)


def _row_frame(parent, bindings, needed=None):
    """The per-row scope of ``aggregate``: the outer columns as they are
    (those in ``needed``), the parameters last."""
    from ..frame.frame import Frame

    data = {name: vals for name, vals in parent._data.items()
            if needed is None or name in needed}
    data.update(bindings)
    return Frame(data, device=parent.device)


def _elem_of(out_host, k):
    v = out_host[k]
    return None if _cell_is_null(v) else v


class HigherOrder(Expr):
    """transform / filter (an element predicate) / exists / aggregate."""

    _KINDS = ("transform", "filter", "exists", "aggregate")

    def __init__(self, kind, source, lam: Lambda, init: Expr = None,
                 finish: Lambda = None):
        if kind not in self._KINDS:
            raise ValueError(f"unknown higher-order function {kind!r}")
        want = 2 if kind == "aggregate" else 1
        if len(lam.params) != want:
            raise ValueError(
                f"{kind}() lambda takes {want} parameter(s), "
                f"got {len(lam.params)}")
        self.kind = kind
        self.source = _coerce(source)
        self.lam = lam
        self.init = init
        self.finish = finish

    def eval(self, frame):
        with evaluating_on(frame.device):
            return self._eval(frame)

    def __str__(self):
        """``transform(arr, x -> (x * 2))``: a readable default column
        name (the JAX package's is the object's repr)."""
        def lam(f):
            params = ", ".join(f.params)
            return (f"({params})" if len(f.params) > 1 else params) + \
                f" -> {f.body}"
        parts = [str(self.source)]
        if self.init is not None:
            parts.append(str(self.init))
        parts.append(lam(self.lam))
        if self.finish is not None:
            parts.append(lam(self.finish))
        return f"{self.kind}({', '.join(parts)})"

    def _eval(self, frame):
        cells = _require_array_cells(self.source.eval(frame), self.kind)
        if self.kind == "aggregate":
            return self._eval_aggregate(frame, cells)
        lens = [0 if c is None else len(c) for c in cells]
        flat = [e for c in cells if c is not None for e in c]
        bindings = {self.lam.params[0]: _column_from_elems(flat)}
        needed: set = set()
        _referenced_cols(self.lam.body, needed)
        try:
            out = self.lam.body.eval(
                _scope_frame(frame, lens, bindings, needed=needed))
        except KeyError:
            # a reference the attribute walk missed: the full scope
            out = self.lam.body.eval(_scope_frame(frame, lens, bindings))
        null_defined = (self.kind == "exists"
                        and _null_defined_on(self.lam.body,
                                             self.lam.params[0]))
        return self._regroup(cells, lens, flat, host_array(out),
                             null_defined)

    def _regroup(self, cells, lens, flat, out_host, null_defined):
        """The body's per-element values back into cells, by segment
        arithmetic over the flat elements: transform's values (None where
        null), filter's kept elements, exists' three-valued ANY."""
        n = len(flat)
        if out_host.dtype == object:
            nulls = np.fromiter(map(_cell_is_null, out_host), bool, n)
            truthy = np.fromiter((not z and bool(v) for v, z in
                                  zip(out_host, nulls)), bool, n)
        else:
            nulls = (np.isnan(out_host) if out_host.dtype.kind == "f"
                     else np.zeros(n, bool))
            truthy = ~nulls & (out_host != 0)
        ends = np.cumsum(np.asarray(lens, np.int64))
        starts = ends - np.asarray(lens, np.int64)

        def per_cell(mask):
            acc = np.concatenate([[0], np.cumsum(mask)])
            return acc[ends] - acc[starts]

        if self.kind == "exists":
            hits, null_vals = per_cell(truthy) > 0, per_cell(nulls) > 0
            null_in = per_cell(np.fromiter(map(_cell_is_null, flat), bool,
                                           n)) > 0
            return bool_or_null([
                None if c is None else True if hit
                else None if (nv or (ni and not null_defined)) else False
                for c, hit, nv, ni in zip(cells, hits, null_vals, null_in)])
        if self.kind == "transform":
            vals = list_column(list(out_host))
            vals[nulls] = None
            parts = np.split(vals, ends[:-1])
        else:   # filter: the elements whose predicate holds
            kept = list_column(flat)[truthy]
            parts = np.split(kept, np.cumsum(per_cell(truthy))[:-1])
        return list_column([None if c is None else p
                            for c, p in zip(cells, parts)])

    def _eval_aggregate(self, frame, cells):
        acc_name, x_name = self.lam.params
        acc = (self.init.eval(frame) if self.init is not None
               else Lit(0.0).eval(frame))
        max_len = builtins.max((0 if c is None else len(c) for c in cells),
                               default=0)
        needed: set = set()
        _referenced_cols(self.lam.body, needed)
        if self.finish is not None:
            _referenced_cols(self.finish.body, needed)
        needed |= {acc_name, x_name}
        for j in range(max_len):
            xj = [None if c is None or j >= len(c) else c[j] for c in cells]
            bindings = {acc_name: acc, x_name: _column_from_elems(xj)}
            try:
                new_acc = self.lam.body.eval(
                    _row_frame(frame, bindings, needed=needed))
            except KeyError:   # a reference the attribute walk missed
                needed = None
                new_acc = self.lam.body.eval(_row_frame(frame, bindings))
            active = [c is not None and j < len(c) for c in cells]
            if is_host_column(acc) or is_host_column(new_acc):
                acc = np.asarray(
                    [n if a else o for o, n, a in
                     zip(host_array(acc), host_array(new_acc), active)],
                    object)
            else:
                acc = torch.where(torch.as_tensor(active,
                                                  device=frame.device),
                                  new_acc, acc)
                if acc.is_floating_point():
                    # numpy's where widens to float64, which the JAX
                    # frame takes back at the policy's float
                    acc = acc.to(float_dtype())
        if self.finish is not None:
            acc = self.finish.body.eval(
                _row_frame(frame, {self.finish.params[0]: acc}))
        null_rows = [c is None for c in cells]
        if is_host_column(acc):
            return np.asarray([None if nr else v
                               for v, nr in zip(acc, null_rows)], object)
        acc = acc.to(float_dtype())
        return torch.where(torch.as_tensor(null_rows, device=acc.device),
                           torch.full((), float("nan"), dtype=acc.dtype,
                                      device=acc.device), acc)


# ---------------------------------------------------------------------------
# Constructors (``org.apache.spark.sql.functions``)
# ---------------------------------------------------------------------------

def _coerce(a) -> Expr:
    if isinstance(a, Expr):
        return a
    return Col(a) if isinstance(a, str) else Lit(a)


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


def call_udf(name: str, *args) -> UdfCall:
    """``functions.callUDF``: arguments are expressions or column names."""
    return UdfCall(name, [_coerce(a) for a in args])


callUDF = call_udf


def fn(name: str, *args) -> Func:
    """A builtin scalar function by name; a bare string argument is a
    column."""
    return Func(name, [_coerce(a) for a in args])


def when(condition: Expr, value) -> CaseWhen:
    """``functions.when``: start a CASE chain (``.when``, ``.otherwise``;
    no ``otherwise`` is NULL)."""
    return CaseWhen([]).when(condition, value)


def isnull(c) -> IsNull:
    return _coerce(c).is_null()


def _make_fn(fname: str):
    def f(*args):
        return fn(fname, *args)

    f.__name__ = fname
    f.__qualname__ = fname
    f.__doc__ = f"``functions.{fname}``: the builtin of that name."
    return f


for _name in ("sqrt", "exp", "log", "log10", "pow", "floor", "ceil",
              "signum", "greatest", "least", "isnan", "coalesce", "md5",
              "sha1", "sha2", "base64", "unbase64", "upper", "lower", "trim",
              "ltrim", "rtrim", "length", "concat", "substring", "array",
              "array_distinct", "flatten", "nanvl", "format_number",
              "levenshtein", "sin", "cos", "tan", "asin", "acos", "atan",
              "atan2", "sinh", "cosh", "tanh", "degrees", "radians", "cbrt",
              "expm1", "log1p", "log2", "hypot", "rint", "repeat", "reverse",
              "initcap", "array_union", "array_intersect", "array_except",
              "arrays_overlap", "array_min", "array_max", "arrays_zip",
              "datediff", "year", "month", "dayofmonth", "dayofweek",
              "dayofyear", "quarter", "hour", "minute", "second",
              "weekofyear", "last_day", "factorial", "hex", "unhex", "bin",
              "ascii", "crc32", "soundex", "bit_length", "octet_length",
              "hash", "xxhash64", "nullif", "nvl2", "ifnull"):
    globals()[_name] = _make_fn(_name)
del _name

sql_abs = _make_fn("abs")
sql_round = _make_fn("round")
nvl = _make_fn("coalesce")          # Spark: nvl(a, b) is coalesce(a, b)


def _lit_or_expr(v) -> Expr:
    """A value argument: an expression, else a literal (never a column
    name)."""
    return v if isinstance(v, Expr) else Lit(v)


def concat_ws(sep: str, *cols) -> Func:
    """The separator is a literal, the rest columns or expressions."""
    return Func("concat_ws", [Lit(sep)] + [_coerce(c) for c in cols])


def split(col_, pattern: str) -> Func:
    """The pattern is a literal regular expression."""
    return Func("split", [_coerce(col_), Lit(pattern)])


def regexp_replace(col_, pattern: str, replacement: str) -> Func:
    return Func("regexp_replace",
                [_coerce(col_), Lit(pattern), Lit(replacement)])


def regexp_extract(col_, pattern: str, idx: int) -> Func:
    return Func("regexp_extract", [_coerce(col_), Lit(pattern), Lit(idx)])


def instr(col_, substr: str) -> Func:
    return Func("instr", [_coerce(col_), Lit(substr)])


def locate(substr: str, col_, pos: int = 1) -> Func:
    return Func("locate", [Lit(substr), _coerce(col_), Lit(pos)])


def lpad(col_, length: int, pad: str) -> Func:
    return Func("lpad", [_coerce(col_), Lit(length), Lit(pad)])


def rpad(col_, length: int, pad: str) -> Func:
    return Func("rpad", [_coerce(col_), Lit(length), Lit(pad)])


def translate(col_, matching: str, replace: str) -> Func:
    return Func("translate", [_coerce(col_), Lit(matching), Lit(replace)])


def format_string(fmt: str, *cols) -> Func:
    """printf formatting; the format is a literal."""
    return fn("format_string", Lit(fmt), *cols)


def array_contains(col_, value) -> Func:
    """The value is a literal (or an expression), never a column name."""
    return Func("array_contains", [_coerce(col_), _lit_or_expr(value)])


def element_at(col_, index: int) -> Func:
    return Func("element_at", [_coerce(col_), Lit(int(index))])


def size(col_) -> Func:
    return Func("size", [_coerce(col_)])


def sort_array(col_, asc: bool = True) -> Func:
    """Nulls first ascending, last descending."""
    return fn("sort_array", col_, Lit(bool(asc)))


def array_join(col_, delimiter: str, null_replacement=None) -> Func:
    """Nulls dropped unless a replacement is given."""
    if null_replacement is None:
        return fn("array_join", col_, Lit(delimiter))
    return fn("array_join", col_, Lit(delimiter), Lit(null_replacement))


def slice(col_, start: int, length: int) -> Func:  # noqa: A001 - Spark name
    return fn("slice", col_, Lit(int(start)), Lit(int(length)))


def array_position(col_, value) -> Func:
    return Func("array_position", [_coerce(col_), _lit_or_expr(value)])


def array_remove(col_, element) -> Func:
    return Func("array_remove", [_coerce(col_), _lit_or_expr(element)])


def array_repeat(col_, count: int) -> Func:
    return Func("array_repeat", [_coerce(col_), Lit(int(count))])


def sequence(start, stop, step=None) -> Func:
    """The inclusive range of each row."""
    args = [_coerce(start), _coerce(stop)]
    if step is not None:
        args.append(_coerce(step))
    return Func("sequence", args)


def shuffle(col_, seed: int = None) -> Func:
    """A random permutation of each cell; the seed is an extension."""
    return Func("shuffle",
                [_coerce(col_), Lit(-1 if seed is None else int(seed))])


def _with_format(name):
    def f(col_, fmt: str = None) -> Func:
        return Func(name, [_coerce(col_)] + ([Lit(fmt)] if fmt is not None
                                             else []))
    f.__name__ = name
    return f


to_date = _with_format("to_date")
unix_timestamp = _with_format("unix_timestamp")
from_unixtime = _with_format("from_unixtime")
to_timestamp = _with_format("to_timestamp")


def date_format(col_, fmt: str) -> Func:
    return Func("date_format", [_coerce(col_), Lit(fmt)])


def date_add(col_, n: int) -> Func:
    return Func("date_add", [_coerce(col_), Lit(n)])


def date_sub(col_, n: int) -> Func:
    return Func("date_sub", [_coerce(col_), Lit(n)])


def add_months(col_, n: int) -> Func:
    return Func("add_months", [_coerce(col_), Lit(int(n))])


def months_between(end, start, roundOff: bool = True) -> Func:  # noqa: N803
    return Func("months_between",
                [_coerce(end), _coerce(start), Lit(bool(roundOff))])


def next_day(col_, day_of_week: str) -> Func:
    return Func("next_day", [_coerce(col_), Lit(str(day_of_week))])


def trunc(col_, fmt: str) -> Func:
    return Func("trunc", [_coerce(col_), Lit(str(fmt))])


def date_trunc(fmt: str, col_) -> Func:
    return Func("date_trunc", [Lit(str(fmt)), _coerce(col_)])


def current_date() -> Expr:
    """Today as epoch days (the host clock, read at call time)."""
    import datetime as _dt

    return Lit(float((_dt.date.today() - _dt.date(1970, 1, 1)).days))


def current_timestamp() -> Expr:
    """Now as whole epoch seconds (the host clock, read at call time);
    exact under the float64 policy only."""
    import time as _time

    return Lit(float(int(_time.time())))


def bround(col_, scale: int = 0) -> Func:
    return Func("bround", [_coerce(col_), Lit(int(scale))])


def conv(col_, from_base: int, to_base: int) -> Func:
    return Func("conv", [_coerce(col_), Lit(int(from_base)),
                         Lit(int(to_base))])


def shiftleft(col_, n: int) -> Func:
    return Func("shiftleft", [_coerce(col_), Lit(int(n))])


def shiftright(col_, n: int) -> Func:
    return Func("shiftright", [_coerce(col_), Lit(int(n))])


def shiftrightunsigned(col_, n: int) -> Func:
    return Func("shiftrightunsigned", [_coerce(col_), Lit(int(n))])


def bitwiseNOT(col_) -> Func:  # noqa: N802 - Spark name
    return Func("bitwise_not", [_coerce(col_)])


def substring_index(col_, delim: str, count: int) -> Func:
    return Func("substring_index",
                [_coerce(col_), Lit(str(delim)), Lit(int(count))])


def encode(col_, charset: str) -> Func:
    return Func("encode", [_coerce(col_), Lit(str(charset))])


def decode(col_, charset: str) -> Func:
    return Func("decode", [_coerce(col_), Lit(str(charset))])


def get_json_object(col_, path: str) -> Func:
    return Func("get_json_object", [_coerce(col_), Lit(str(path))])


def json_tuple(col_, *fields) -> JsonTuple:
    return JsonTuple(col_, fields)


def rand(seed=None) -> RowFunc:
    """Uniform [0, 1); reproducible for a seed."""
    return RowFunc("rand", seed)


def randn(seed=None) -> RowFunc:
    """Standard normal; reproducible for a seed."""
    return RowFunc("randn", seed)


def monotonically_increasing_id() -> RowFunc:
    """Row ids 0..n-1 (one logical partition makes them consecutive)."""
    return RowFunc("id")


def spark_partition_id() -> RowFunc:
    """Always 0: one logical partition."""
    return RowFunc("partition_id")


def explode(col_) -> Explode:
    return Explode(col_)


def explode_outer(col_) -> Explode:
    """``explode``, but a null or empty cell gives one null row."""
    return Explode(col_, outer=True)


def posexplode(col_) -> Explode:
    """``explode`` plus the element's 0-based position, ``pos``."""
    return Explode(col_, with_position=True)


def transform(col_, f) -> HigherOrder:
    """``transform(col, x -> ...)``: ``f`` a Python callable over a
    column reference, or a ``Lambda``."""
    lam = f if isinstance(f, Lambda) else _fresh_lambda(f, 1)
    return HigherOrder("transform", col_, lam)


def filter(col_, f) -> HigherOrder:  # noqa: A001 - Spark name
    """Keep the elements whose predicate holds (a null one drops)."""
    lam = f if isinstance(f, Lambda) else _fresh_lambda(f, 1)
    return HigherOrder("filter", col_, lam)


def exists(col_, f) -> HigherOrder:
    """Three-valued ANY over the elements."""
    lam = f if isinstance(f, Lambda) else _fresh_lambda(f, 1)
    return HigherOrder("exists", col_, lam)


def aggregate(col_, initial_value, merge, finish=None) -> HigherOrder:
    """``aggregate(col, init, (acc, x) -> ...[, acc -> ...])``: a fold per
    cell, vectorized across rows by element position."""
    lam = merge if isinstance(merge, Lambda) else _fresh_lambda(merge, 2)
    fin = None
    if finish is not None:
        fin = finish if isinstance(finish, Lambda) \
            else _fresh_lambda(finish, 1)
    return HigherOrder("aggregate", col_, lam, init=_lit_or_expr(
        initial_value), finish=fin)


def expr(sql_text: str) -> Expr:
    """Spark's ``F.expr``: one SQL expression (a ``selectExpr`` item:
    CAST, arithmetic, functions, lambdas, AS alias); aggregates and window
    items are not scalar expressions."""
    from ..sql.parser import _Parser, tokenize

    p = _Parser(tokenize(sql_text))
    item = p.select_item()
    p.expect("eof")
    if not isinstance(item, Expr):
        raise ValueError(
            f"expr({sql_text!r}) is not a scalar expression; use "
            "selectExpr()/session.sql() for aggregates and window items")
    return item
