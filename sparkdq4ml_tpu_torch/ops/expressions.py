"""Column expressions, evaluated eagerly on tensors (subset of
``sparkdq4ml_tpu/ops/expressions.py``): column references, literals
(numbers, booleans, strings, NULL), aliases, casts to int, double, float
and string, arithmetic (``+ - * / %``, unary minus), the comparison and
boolean operators, ``IN`` lists, ``IS [NOT] NULL``, ``LIKE``, ``CASE
WHEN``, the string functions ``concat``, ``concat_ws`` and ``split``, the
``explode`` generators, sort markers (``asc``/``desc``) and UDF calls. Any
other construct raises ``NotImplementedError`` that names it.

String and array columns are numpy object arrays on the host, as in the
JAX package, with ``None`` as their null. Numeric predicates stay torch
ops on the frame's device; string predicates compute on the host and hand
the device a bool mask.
"""

from __future__ import annotations

import re
from typing import Sequence

import numpy as np
import torch

from ..config import float_dtype, int_dtype

# CAST's string target: the columns it makes are host object arrays.
STRING = np.dtype(object)

_TYPE_NAMES = {
    "int": int_dtype,
    "integer": int_dtype,
    "float": lambda: torch.float32,
    "double": float_dtype,
    "string": lambda: STRING,
}

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


def _sql_divide(a, b):
    """Spark's non-ANSI division: x / 0 is NULL (0 / 0 included)."""
    return torch.where(b == 0, torch.full((), float("nan"), dtype=a.dtype,
                                          device=a.device), a / b)


def _sql_mod(a, b):
    """Spark's %: the sign follows the dividend; x % 0 is NULL."""
    return torch.where(b == 0, torch.full((), float("nan"), dtype=a.dtype,
                                          device=a.device), torch.fmod(a, b))


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
            return torch.as_tensor(exact.astype(np.int32), device=device)
        whole = np.where(np.isfinite(parsed), np.trunc(parsed), np.nan)
        return torch.as_tensor(whole, dtype=float_dtype(), device=device)
    return torch.as_tensor(parsed, dtype=dt, device=device)


def _float_to_int32(v: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 conversion: truncate toward zero, NaN -> 0,
    saturate out of range (every int32 bound is exact in float64)."""
    v = torch.nan_to_num(v.to(torch.float64), nan=0.0)
    info = torch.iinfo(torch.int32)
    return v.clamp(info.min, info.max).trunc().to(torch.int32)


class Cast(Expr):
    """CAST(expr AS int|double|float|string): double -> int truncates
    toward zero; a number becomes its text (NULL stays NULL); a string is
    trimmed and parsed, and what does not parse is NULL (an int target
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
            # at their own precision ('23.24' for a float32 23.24)
            a = v if is_host_column(v) else v.cpu().numpy()
            return np.asarray(
                [None if x is None
                 or (isinstance(x, (float, np.floating)) and np.isnan(x))
                 else str(x) for x in a], dtype=object)
        if is_host_column(v):
            return _cast_strings(v, dt, frame.device)
        if v.is_floating_point() and not dt.is_floating_point:
            if dt != torch.int32:
                raise NotImplementedError(f"CAST of a float to {dt}")
            return _float_to_int32(v)
        return v.to(dt)

    @property
    def name(self) -> str:
        return f"CAST({self.child} AS {self.type_name.upper()})"

    def __str__(self):
        return self.name


class UdfCall(Expr):
    """Invocation of a registered UDF by name (``callUDF``), resolved at
    evaluation time against the registry."""

    def __init__(self, udf_name: str, args: Sequence[Expr], registry=None):
        self.udf_name = udf_name
        self.args = list(args)
        self._registry = registry

    def eval(self, frame):
        from .udf import default_registry

        reg = self._registry if self._registry is not None \
            else default_registry()
        fn, return_dtype = reg.lookup(self.udf_name)
        out = fn(*[a.eval(frame) for a in self.args])
        if return_dtype is not None:
            out = out.to(return_dtype)
        return out

    @property
    def name(self) -> str:
        return f"{self.udf_name}({', '.join(str(a) for a in self.args)})"

    def __str__(self):
        return self.name


# ---------------------------------------------------------------------------
# Host columns: strings and arrays
# ---------------------------------------------------------------------------

def is_host_column(values) -> bool:
    """A string or array column: a numpy object array kept on the host."""
    return isinstance(values, np.ndarray) and values.dtype == object


def host_objects(values) -> np.ndarray:
    """A column as a host object array; a tensor's cells become Python
    numbers, as ``np.asarray(jax_array, object)`` gives in the JAX
    package."""
    if is_host_column(values):
        return values
    return values.cpu().numpy().astype(object)


def host_mask(mask, frame) -> torch.Tensor:
    """A host bool array computed from string cells, on the frame's
    device."""
    return torch.as_tensor(np.asarray(mask, bool), device=frame.device)


def _is_null_cell(x) -> bool:
    """``None`` (the string null) or a float NaN (the numeric null)."""
    return x is None or (isinstance(x, float) and x != x)


def _null_cells(values) -> np.ndarray:
    return np.fromiter(map(_is_null_cell, values), bool, count=len(values))


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
    """``expr [NOT] LIKE pattern``: ``%`` matches any run, ``_`` one
    character; matched on the host, a null row fails both forms."""

    def __init__(self, child: Expr, pattern: str, negated: bool = False):
        self.child = child
        self.pattern = pattern
        self.negated = negated

    def eval(self, frame):
        from . import strings

        rx = re.compile(re.escape(self.pattern).replace("%", ".*")
                        .replace("_", "."), re.DOTALL)
        v = self.child.eval(frame)
        if is_host_column(v):
            # one match a distinct string, then a lookup a row by code
            codes, words = strings.codes(v)
            keep = np.asarray([(rx.fullmatch(w) is not None) != self.negated
                               for w in words] + [False], bool)
            return host_mask(keep[codes], frame)   # NULL_CODE: no row
        hit = np.asarray([rx.fullmatch(str(x)) is not None
                          for x in host_objects(v)], bool)
        return host_mask(~hit if self.negated else hit, frame)

    def __str__(self):
        neg = "NOT " if self.negated else ""
        return f"({self.child} {neg}LIKE {self.pattern!r})"


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


def _scalar_value(v):
    """The value of a literal argument, which evaluates as a full column;
    a column whose cells differ is refused rather than read at row 0."""
    arr = host_objects(v).ravel()
    if len(arr) > 1 and (arr[1:] != arr[0]).any():
        raise ValueError("this function argument must be a literal, not a "
                         "column (per-row values are not supported)")
    x = arr[0]
    return x.item() if hasattr(x, "item") else x


def _str_map(fn, *arrays):
    """``fn`` over the rows of host columns; a row with a null cell
    (``None``, or NaN from a NULL literal) gives ``None``. The result is
    one object cell a row, so list results (``split``) stay ragged cells
    where the JAX package's ``np.asarray`` would make a 2-D array of
    equal-length lists."""
    out = np.empty(len(arrays[0]), dtype=object)
    for i, row in enumerate(zip(*[host_objects(a) for a in arrays])):
        out[i] = None if any(_is_null_cell(x) for x in row) else fn(*row)
    return out


def _fn_concat(*ss):
    """Spark's concat: NULL if any argument is null."""
    return _str_map(lambda *row: "".join(str(x) for x in row), *ss)


def _fn_concat_ws(sep, *ss):
    """Spark's concat_ws: the separator between the non-null arguments
    (it skips nulls, where concat would be NULL)."""
    s = _scalar_value(sep)
    return np.asarray([s.join(str(x) for x in row if not _is_null_cell(x))
                       for row in zip(*[host_objects(a) for a in ss])],
                      dtype=object)


def _fn_split(s, pattern):
    """Spark's split: an array cell of the pieces around each match of
    the regular expression ``pattern``."""
    pat = re.compile(_scalar_value(pattern))
    return _str_map(pat.split, s)


FUNCTIONS = {"concat": _fn_concat, "concat_ws": _fn_concat_ws,
             "split": _fn_split}


class Func(Expr):
    """A call of a built-in scalar function by name (the string
    functions ``concat``, ``concat_ws`` and ``split``), computed on the
    host over object columns."""

    def __init__(self, fn_name: str, args: Sequence[Expr]):
        key = fn_name.lower()
        if key not in FUNCTIONS:
            raise NotImplementedError(
                f"the function {fn_name}() is not in the torch port's "
                f"subset (supported: {sorted(FUNCTIONS)})")
        self.fn_name = key
        self.args = list(args)

    def eval(self, frame):
        return FUNCTIONS[self.fn_name](*[a.eval(frame) for a in self.args])

    @property
    def name(self) -> str:
        return f"{self.fn_name}({', '.join(str(a) for a in self.args)})"

    def __str__(self):
        return self.name


class Explode(Expr):
    """``explode(source)`` and ``explode_outer(source)``: a generator, not
    a column. ``Frame.select`` (one a select) turns each element of an
    array cell into a row; evaluating it as a column raises. ``source`` is
    a column name or an array-valued expression (``split(...)``)."""

    def __init__(self, source, outer: bool = False):
        self.source = source
        self.outer = outer

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
        fn = "explode_outer" if self.outer else "explode"
        return f"{fn}({self.source})"


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


def when(condition: Expr, value) -> CaseWhen:
    """``functions.when``: start a CASE chain (``.when``, ``.otherwise``;
    no ``otherwise`` is NULL)."""
    return CaseWhen([]).when(condition, value)


def isnull(c) -> IsNull:
    return _coerce(c).is_null()


def concat(*cols) -> Func:
    return Func("concat", [_coerce(c) for c in cols])


def concat_ws(sep: str, *cols) -> Func:
    """The separator is a literal, the rest columns or expressions."""
    return Func("concat_ws", [Lit(sep)] + [_coerce(c) for c in cols])


def split(col_, pattern: str) -> Func:
    """The pattern is a literal regular expression."""
    return Func("split", [_coerce(col_), Lit(pattern)])


def explode(col_) -> Explode:
    return Explode(col_)


def explode_outer(col_) -> Explode:
    """``explode``, but a null or empty cell gives one null row."""
    return Explode(col_, outer=True)
