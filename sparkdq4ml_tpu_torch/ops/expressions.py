"""Column expressions, evaluated eagerly on tensors (subset of
``sparkdq4ml_tpu/ops/expressions.py``): column references, literals,
aliases, casts to int or double, arithmetic (``+ - * / %``, unary minus),
the comparison and boolean operators, sort markers (``asc``/``desc``) and
UDF calls. Any other construct raises ``NotImplementedError`` that names
it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import float_dtype, int_dtype

_TYPE_NAMES = {
    "int": int_dtype,
    "integer": int_dtype,
    "float": lambda: torch.float32,
    "double": float_dtype,
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
    """A literal, evaluated as a full column like the reference's."""

    def __init__(self, value):
        if not isinstance(value, (bool, int, float)):
            raise NotImplementedError(
                f"literal {value!r}: only bool, int and float literals are "
                "in the torch port's expression subset")
        self.value = value

    def eval(self, frame):
        if isinstance(self.value, bool):
            dt = torch.bool
        elif isinstance(self.value, int):
            dt = int_dtype()
        else:
            dt = float_dtype()
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
            raise NotImplementedError(
                f"operator {self.op} on a string column is not in the "
                "torch port's expression subset")
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


def _float_to_int32(v: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 conversion: truncate toward zero, NaN -> 0,
    saturate out of range (every int32 bound is exact in float64)."""
    v = torch.nan_to_num(v.to(torch.float64), nan=0.0)
    info = torch.iinfo(torch.int32)
    return v.clamp(info.min, info.max).trunc().to(torch.int32)


class Cast(Expr):
    """CAST(expr AS int|double|float): double -> int truncates toward zero."""

    def __init__(self, child: Expr, type_name: str):
        resolve_type_name(type_name)          # raises outside the subset
        self.child = child
        self.type_name = type_name

    def eval(self, frame):
        v = self.child.eval(frame)
        if not isinstance(v, torch.Tensor):
            raise NotImplementedError(
                "CAST of a string column is not in the torch port's subset")
        dt = resolve_type_name(self.type_name)
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



def is_host_column(values) -> bool:
    """A string column: a numpy object array kept on the host."""
    return isinstance(values, np.ndarray) and values.dtype == object
