"""The SQL subset of the torch port (the relational core of
``sparkdq4ml_tpu/sql/parser.py``)::

    statement := [WITH name AS '(' query ')', ...] query
                 | CREATE [OR REPLACE] [TEMP[ORARY]] VIEW name AS statement
                 | DROP [TEMP[ORARY]] VIEW [IF EXISTS] name
    query    := SELECT [DISTINCT] item, ... FROM relation join*
                [WHERE pred] [GROUP BY key, ...] [HAVING pred]
                [ORDER BY key [ASC|DESC] [NULLS FIRST|LAST], ...]
                [LIMIT n] [OFFSET m]
    relation := view [[AS] alias] | '(' query ')' [[AS] alias]
    join     := [INNER | LEFT [OUTER|SEMI|ANTI] | RIGHT [OUTER]
                 | FULL [OUTER] | CROSS] JOIN relation
                (USING '(' col, ... ')' | ON a = b)
    item     := '*' | expr [OVER window] [[AS] alias]
    window   := '(' [PARTITION BY col, ...] [ORDER BY col [ASC|DESC], ...]
                [(ROWS|RANGE) BETWEEN bound AND bound] ')'

Expressions: columns, numeric, boolean and string literals, NULL,
``cast(x AS int|integer|double|float|string)``, ``+ - * / %``, unary
minus, comparisons, AND/OR/NOT and parentheses; ``[NOT] IN (list)``,
``[NOT] BETWEEN a AND b``, ``[NOT] LIKE 'pattern'``, ``IS [NOT] NULL``,
``CASE [operand] WHEN ... THEN ... [ELSE ...] END``; the string functions
``concat``, ``concat_ws`` and ``split``; uncorrelated subqueries: a scalar
``(SELECT ...)`` (read once to the host as a literal), ``[NOT] IN (SELECT
...)`` (a semi join against the subquery's values, planned on the
device) and ``EXISTS (SELECT ...)``; the aggregates ``COUNT(*)``,
``COUNT(DISTINCT x)``, ``SUM(DISTINCT x)`` and the device family
(``frame/aggregates.py``), expressions over aggregates in the select
list, HAVING and ORDER BY; the window functions of ``frame/window.py``
with OVER. GROUP BY and ORDER BY keys are names, 1-based select-item
positions or expressions. ``WITH`` names shadow temp views for one
statement (``_OverlayCatalog``).

Correlated subqueries (a qualified reference to an outer relation), set
operations, ``EXPLAIN``, ``ROLLUP``/``CUBE`` and other function calls
raise ``NotImplementedError`` naming what was met. The executor follows
the JAX package's ``_execute_single`` without its cost-based optimizer
(whose rewrites are bit-identical by design).
"""

from __future__ import annotations

import math
import re
from typing import Optional

from ..frame import window as W
from ..frame.aggregates import AggExpr, AggOfExpr
from ..ops import expressions as E

_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?"
    r"|\d+(?:[eE][+-]?\d+)?)"
    r"|(?P<string>'(?:[^']|'')*')"
    r"|(?P<ident>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>->|\|\||<=>|<=|>=|<>|!=|==|=|<|>|\+|-|\*|/|%|\(|\)|,|\.)"
    r")")

_KEYWORDS = {"select", "from", "where", "as", "and", "or", "not", "cast",
             "true", "false", "null", "group", "by", "order", "limit",
             "asc", "desc", "join", "inner", "left", "right", "full",
             "outer", "cross", "on", "using", "case", "when", "then",
             "else", "end", "is", "in", "between", "like", "having",
             "distinct", "union", "all"}

# The JAX grammar's aggregate names: the device family parses, the others
# raise NotImplementedError from AggExpr.
_AGG_FNS = {"count", "sum", "avg", "mean", "min", "max", "stddev",
            "variance", "stddev_pop", "var_pop", "median", "mode",
            "collect_list", "collect_set", "first", "last", "skewness",
            "kurtosis", "corr", "covar_samp", "covar_pop", "max_by",
            "min_by", "percentile_approx", "approx_percentile",
            "approx_count_distinct", "count_if", "any", "some", "every",
            "bool_or", "bool_and"}
_WINDOW_FNS = {"row_number", "rank", "dense_rank", "percent_rank",
               "cume_dist", "ntile", "lag", "lead", "first_value",
               "last_value", "nth_value"}
_SUBSET = ("the torch port's SQL subset ([WITH ...] SELECT ... FROM ... "
           "[JOIN] [WHERE] [GROUP BY] [HAVING] [ORDER BY] [LIMIT], with "
           "uncorrelated subqueries; CREATE/DROP TEMP VIEW)")
_CAST_TYPES = ("int", "integer", "double", "float", "string")
_DDL_RE = re.compile(
    r"^\s*create\s+(?:or\s+replace\s+)?(?:temp(?:orary)?\s+)?view\s+"
    r"([A-Za-z_][A-Za-z_0-9]*)\s+as\s+(.*)$", re.IGNORECASE | re.DOTALL)
_DROP_RE = re.compile(
    r"^\s*drop\s+(?:temp(?:orary)?\s+)?view\s+(if\s+exists\s+)?"
    r"([A-Za-z_][A-Za-z_0-9]*)\s*$", re.IGNORECASE)


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not in {_SUBSET}")


class _Token:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: str):
        self.kind = kind
        self.value = value


def tokenize(sql: str) -> list:
    tokens, pos = [], 0
    while pos < len(sql):
        if sql[pos:].strip() == "":
            break
        m = _TOKEN_RE.match(sql, pos)
        if m is None or m.end() == pos:
            raise _unsupported(f"the text {sql[pos:pos + 20]!r}")
        pos = m.end()
        if m.group("number") is not None:
            tokens.append(_Token("number", m.group("number")))
        elif m.group("string") is not None:
            tokens.append(_Token("string", m.group("string")[1:-1]
                                 .replace("''", "'")))
        elif m.group("ident") is not None:
            ident = m.group("ident")
            tokens.append(_Token("kw" if ident.lower() in _KEYWORDS
                                 else "ident", ident))
        else:
            tokens.append(_Token("op", m.group("op")))
    tokens.append(_Token("eof", ""))
    return tokens


class _AggCall(E.Expr):
    """An aggregate call met inside an expression (``HAVING COUNT(*) >
    2``, ``ORDER BY max(p) - min(p)``); rewritten to a column of the
    aggregated frame before any evaluation."""

    def __init__(self, fn: str, arg, distinct: bool = False):
        self.fn = fn.lower()
        self.arg = arg            # None = *, else an Expr
        self.distinct = distinct

    def to_agg(self) -> AggExpr:
        fn = f"{self.fn}_distinct" if self.distinct else self.fn
        if self.arg is None or isinstance(self.arg, E.Col):
            return AggExpr(fn, None if self.arg is None else self.arg.name)
        return AggOfExpr(fn, self.arg)

    def eval(self, frame):
        raise ValueError("an aggregate is only valid in a select list, "
                         "HAVING or ORDER BY of an aggregate query")

    def __str__(self):
        return self.to_agg().name


class _AggRef(E.Expr):
    """A parsed select-list aggregate used as an operand (``max(p) -
    min(p)``)."""

    def __init__(self, agg):
        self.agg = agg

    def eval(self, frame):
        raise ValueError("unresolved aggregate reference")

    def __str__(self):
        return self.agg.name


class PostAggItem:
    """A select item over aggregate results (``max(p) - min(p) AS
    spread``): ``expr`` reads the aggregated columns of ``aggs``."""

    __slots__ = ("expr", "aggs", "_name")

    def __init__(self, expr, aggs, name=None):
        self.expr = expr
        self.aggs = list(aggs)
        self._name = name

    @property
    def name(self) -> str:
        return self._name if self._name is not None else str(self.expr)

    def alias(self, name: str) -> "PostAggItem":
        return PostAggItem(self.expr, self.aggs, name)


class DerivedTable:
    """``FROM (SELECT ...) [AS] alias``: executed into a frame first (the
    alias is parsed; qualified references are not in the subset)."""

    __slots__ = ("query",)

    def __init__(self, query):
        self.query = query


class _Subquery(E.Expr):
    """An uncorrelated subquery in an expression; the executor replaces
    it before anything evaluates (``_resolve_subqueries``)."""

    def eval(self, frame):
        raise ValueError("an unresolved subquery: subqueries run only "
                         "inside session.sql()")


class ScalarSubquery(_Subquery):
    """``(SELECT one_value FROM ...)``: read once to the host as a literal
    (NULL when it returns no row)."""

    def __init__(self, query):
        self.query = query


class SubqueryIn(_Subquery):
    """``expr [NOT] IN (SELECT col FROM ...)``."""

    def __init__(self, child, query, negated: bool = False):
        self.child = child
        self.query = query
        self.negated = negated


class SubqueryExists(_Subquery):
    """``EXISTS (SELECT ...)``: a boolean literal (any row?)."""

    def __init__(self, query):
        self.query = query


class Query:
    """A parsed SELECT, with the WITH clause that precedes it."""

    def __init__(self, items, view, where=None, group_by=(), order_by=(),
                 limit=None, joins=(), distinct=False, having=None,
                 offset=0):
        self.items = list(items)
        self.view = view
        self.where = where
        self.group_by = list(group_by)
        self.order_by = list(order_by)
        self.limit = limit
        self.joins = list(joins)
        self.distinct = distinct
        self.having = having
        self.offset = offset
        self.drop_after_sort: list = []
        self.ctes: list = []                  # [(name, Query), ...]


def _map_expr(expr, fn):
    """A copy of ``expr`` with ``fn`` applied to each child expression;
    leaves (columns, literals, aggregates, window expressions) come back
    as they are."""
    if isinstance(expr, E.BinOp):
        return E.BinOp(expr.op, fn(expr.left), fn(expr.right))
    if isinstance(expr, (E.Not, E.Neg)):
        return type(expr)(fn(expr.child))
    if isinstance(expr, E.Cast):
        return E.Cast(fn(expr.child), expr.type_name)
    if isinstance(expr, E.IsNull):
        return E.IsNull(fn(expr.child), expr.negated)
    if isinstance(expr, E.InList):
        return E.InList(fn(expr.child), [fn(v) for v in expr.values],
                        expr.negated)
    if isinstance(expr, E.StringMatch):
        return E.StringMatch(fn(expr.child), expr.pattern, expr.negated)
    if isinstance(expr, E.CaseWhen):
        return E.CaseWhen([(fn(c), fn(v)) for c, v in expr.branches],
                          None if expr.otherwise_expr is None
                          else fn(expr.otherwise_expr))
    if isinstance(expr, E.Func):
        return E.Func(expr.fn_name, [fn(a) for a in expr.args])
    if isinstance(expr, E.Alias):
        return E.Alias(fn(expr.child), expr.name)
    if isinstance(expr, E.SortOrder):
        return E.SortOrder(fn(expr.child), expr.ascending, expr.nulls_first)
    if isinstance(expr, SubqueryIn):
        return SubqueryIn(fn(expr.child), expr.query, expr.negated)
    return expr


def _rewrite_aggs(expr, extra: list):
    """Aggregate calls inside an expression -> references to the
    aggregated output columns, collecting the aggregates to compute."""
    if isinstance(expr, _AggRef):
        extra.append(expr.agg)
        return E.Col(expr.agg.name)
    if isinstance(expr, _AggCall):
        agg = expr.to_agg()
        extra.append(agg)
        return E.Col(agg.name)
    return _map_expr(expr, lambda e: _rewrite_aggs(e, extra))


def _referenced_cols(expr, out: set) -> None:
    if isinstance(expr, E.Col):
        out.add(expr.name)

    def visit(e):
        _referenced_cols(e, out)
        return e

    _map_expr(expr, visit)


def _lit_value(expr, what: str):
    if isinstance(expr, E.Lit):
        return expr.value
    if isinstance(expr, E.Neg) and isinstance(expr.child, E.Lit):
        return -expr.child.value
    raise ValueError(f"{what} must be a literal")


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k: int = 0) -> _Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> _Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None):
        t = self.peek()
        if t.kind == kind and (value is None or t.value.lower() == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> _Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek().value or "the end of the query"
            raise _unsupported(f"{got!r} where {value or kind} was expected")
        return t

    def at_call(self) -> bool:
        return self.peek(1).kind == "op" and self.peek(1).value == "("

    # -- statement -----------------------------------------------------------
    def statement(self) -> Query:
        first = self.peek()
        if first.kind == "ident" and first.value.lower() in (
                "explain", "create", "drop", "insert", "update",
                "delete", "describe", "show"):
            raise _unsupported(f"{first.value.upper()} statements")
        ctes = []
        if self.accept("ident", "with"):
            while True:
                name = self.expect("ident").value
                self.expect("kw", "as")
                self.expect("op", "(")
                ctes.append((name, self.query()))
                self.expect("op", ")")
                if not self.accept("op", ","):
                    break
        q = self.query()
        q.ctes = ctes
        t = self.peek()
        if t.kind == "kw" and t.value.lower() == "union" or (
                t.kind == "ident" and t.value.lower() in ("intersect",
                                                          "except")):
            raise _unsupported(f"the set operation {t.value.upper()}")
        self.expect("eof")
        return q

    def query(self) -> Query:
        self.expect("kw", "select")
        distinct = bool(self.accept("kw", "distinct"))
        items = [self.select_item()]
        while self.accept("op", ","):
            items.append(self.select_item())
        if not self.accept("kw", "from"):
            raise _unsupported("a SELECT without FROM")
        view = self.relation()
        joins = []
        while True:
            j = self.join()
            if j is None:
                break
            joins.append(j)
        where = self.parse_or() if self.accept("kw", "where") else None
        group_by = []
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            if self.peek().kind == "ident" and self.peek().value.lower() in (
                    "rollup", "cube", "grouping") and self.at_call():
                raise _unsupported(f"GROUP BY {self.peek().value.upper()}")
            group_by.append(self.group_item())
            while self.accept("op", ","):
                group_by.append(self.group_item())
        having = self.parse_or() if self.accept("kw", "having") else None
        order_by = []
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            order_by.append(self.sort_item())
            while self.accept("op", ","):
                order_by.append(self.sort_item())
        limit = None
        if self.accept("kw", "limit"):
            limit = int(self.expect("number").value)
        offset = 0
        if self.accept("ident", "offset"):
            offset = int(self.expect("number").value)
        return Query(items, view, where, group_by, order_by, limit, joins,
                     distinct, having, offset)

    def relation(self):
        """A view name or a derived table, with an optional alias."""
        if self.peek().kind == "op" and self.peek().value == "(":
            self.next()
            sub = self.query()
            self.expect("op", ")")
            self.accept("kw", "as")
            if self.peek().kind == "ident" and not self._clause_word():
                self.next()
            return DerivedTable(sub)
        view = self.expect("ident").value
        if self.accept("kw", "as"):
            self.expect("ident")
        elif self.peek().kind == "ident" and not self._clause_word():
            self.next()
        return view

    def _clause_word(self) -> bool:
        return self.peek().value.lower() in ("semi", "anti", "intersect",
                                             "except", "offset")

    def join(self):
        how = None
        for kw in ("inner", "left", "right", "full", "cross"):
            if self.accept("kw", kw):
                how = {"full": "outer"}.get(kw, kw)
                if kw == "left":
                    if self.accept("ident", "semi"):
                        how = "left_semi"
                    elif self.accept("ident", "anti"):
                        how = "left_anti"
                self.accept("kw", "outer")
                break
        if how is None:
            if not self.accept("kw", "join"):
                return None
            how = "inner"
        else:
            self.expect("kw", "join")
        view = self.relation()
        keys = []
        if how != "cross":
            if self.accept("kw", "using"):
                self.expect("op", "(")
                keys.append(self.expect("ident").value)
                while self.accept("op", ","):
                    keys.append(self.expect("ident").value)
                self.expect("op", ")")
            else:
                self.expect("kw", "on")
                a = self._dotted()
                self.expect("op", "=")
                b = self._dotted()
                a_col, b_col = a.rpartition(".")[2], b.rpartition(".")[2]
                if a_col != b_col:
                    raise ValueError(
                        "JOIN ON supports an equi-join on a shared column "
                        f"name; got {a!r} = {b!r} (use USING or rename "
                        "first)")
                keys.append(a_col)
        return view, how, keys

    def _dotted(self) -> str:
        name = self.expect("ident").value
        while self.accept("op", "."):
            name += "." + self.expect("ident").value
        return name

    # -- clause items ------------------------------------------------------
    def group_item(self):
        expr = self.parse_or()
        if isinstance(expr, E.Col):
            return expr.name
        if isinstance(expr, E.Lit) and type(expr.value) is int:
            return expr.value
        return expr

    def sort_item(self):
        expr = self.parse_or()
        ascending = True
        if self.accept("kw", "desc"):
            ascending = False
        else:
            self.accept("kw", "asc")
        nulls_first = None
        if self.accept("ident", "nulls"):
            if self.accept("ident", "first"):
                nulls_first = True
            else:
                self.expect("ident", "last")
                nulls_first = False
        if isinstance(expr, E.Lit) and type(expr.value) is int:
            if nulls_first is not None:
                raise ValueError("NULLS FIRST/LAST with a positional "
                                 "ORDER BY key is not supported")
            return (expr.value, ascending)
        if nulls_first is not None:
            return (E.SortOrder(expr, ascending, nulls_first), ascending)
        if isinstance(expr, E.Col):
            return (expr.name, ascending)
        return (expr, ascending)

    def select_item(self):
        if self.accept("op", "*"):
            return "*"
        t = self.peek()
        if t.kind == "ident" and t.value.lower() in _AGG_FNS | _WINDOW_FNS \
                and self.at_call():
            expr = self.call()
            if isinstance(expr, _AggCall):
                expr = expr.to_agg()
                if self.peek().kind == "op" and self.peek().value in (
                        "+", "-", "*", "/", "%"):
                    expr = self.parse_add(_AggRef(expr))
                else:
                    return self._alias(expr)
        else:
            expr = self.parse_or()
        if isinstance(expr, E.Lit):
            raise _unsupported("a literal in the select list")
        collected: list = []
        rewritten = _rewrite_aggs(expr, collected)
        return self._alias(PostAggItem(rewritten, collected) if collected
                           else expr)

    def _alias(self, item):
        if self.accept("kw", "as"):
            return item.alias(self.expect("ident").value)
        alias = self.accept("ident")
        return item.alias(alias.value) if alias is not None else item

    # -- expressions (precedence climbing) ---------------------------------
    def parse_or(self):
        left = self.parse_and()
        while self.accept("kw", "or"):
            left = E.BinOp("|", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.accept("kw", "and"):
            left = E.BinOp("&", left, self.parse_not())
        return left

    def parse_not(self):
        if self.accept("kw", "not"):
            return E.Not(self.parse_not())
        return self.parse_cmp()

    _CMP = {"=": "==", "==": "==", "!=": "!=", "<>": "!=", "<": "<",
            "<=": "<=", ">": ">", ">=": ">="}

    def parse_cmp(self):
        left = self.parse_add()
        t = self.peek()
        if t.kind == "op" and t.value in self._CMP:
            self.next()
            return E.BinOp(self._CMP[t.value], left, self.parse_add())
        if self.accept("kw", "is"):
            negated = bool(self.accept("kw", "not"))
            self.expect("kw", "null")
            return E.IsNull(left, negated)
        negated = False
        if t.kind == "kw" and t.value.lower() == "not" and \
                self.peek(1).kind == "kw" and self.peek(1).value.lower() in (
                    "in", "between", "like"):
            self.next()
            negated = True
        if self.accept("kw", "in"):
            self.expect("op", "(")
            if self.peek().kind == "kw" and \
                    self.peek().value.lower() == "select":
                sub = self.query()
                self.expect("op", ")")
                return SubqueryIn(left, sub, negated)
            values = [self.parse_or()]
            while self.accept("op", ","):
                values.append(self.parse_or())
            self.expect("op", ")")
            return E.InList(left, values, negated)
        if self.accept("kw", "between"):
            lo = self.parse_add()
            self.expect("kw", "and")
            expr = left.between(lo, self.parse_add())
            return E.Not(expr) if negated else expr
        if self.accept("kw", "like"):
            return E.StringMatch(left, self.expect("string").value, negated)
        if t.kind == "op" and t.value in ("<=>", "||", "->"):
            raise _unsupported(f"the operator {t.value}")
        return left

    def parse_add(self, left=None):
        left = self.parse_mul(left)
        while True:
            if self.accept("op", "+"):
                left = E.BinOp("+", left, self.parse_mul())
            elif self.accept("op", "-"):
                left = E.BinOp("-", left, self.parse_mul())
            else:
                return left

    def parse_mul(self, left=None):
        left = self.parse_unary() if left is None else left
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = E.BinOp(t.value, left, self.parse_unary())
            else:
                return left

    def parse_unary(self):
        if self.accept("op", "-"):
            return E.Neg(self.parse_unary())
        return self.parse_atom()

    def parse_atom(self):
        t = self.peek()
        if t.kind == "number":
            self.next()
            if re.fullmatch(r"\d+", t.value):
                return E.Lit(int(t.value))
            return E.Lit(float(t.value))
        if t.kind == "string":
            self.next()
            return E.Lit(t.value)
        if self.accept("kw", "true"):
            return E.Lit(True)
        if self.accept("kw", "false"):
            return E.Lit(False)
        if self.accept("kw", "null"):
            return E.Lit(math.nan)
        if self.accept("kw", "cast"):
            self.expect("op", "(")
            inner = self.parse_or()
            self.expect("kw", "as")
            tname = self.expect("ident").value
            if tname.lower() not in _CAST_TYPES:
                raise _unsupported(f"CAST to {tname!r}")
            self.expect("op", ")")
            return E.Cast(inner, tname)
        if self.accept("kw", "case"):
            return self.case()
        if t.kind == "ident":
            if t.value.lower() == "exists" and self.at_call() and \
                    self.peek(2).kind == "kw" and \
                    self.peek(2).value.lower() == "select":
                self.next()
                self.next()
                sub = self.query()
                self.expect("op", ")")
                return SubqueryExists(sub)
            if self.at_call():
                return self.call()
            self.next()
            name = t.value
            if self.peek().kind == "op" and self.peek().value == ".":
                raise _unsupported(
                    f"the qualified column reference {name}."
                    f"{self.peek(1).value} (qualified names, and so "
                    "correlated subqueries, are outside the subset)")
            return E.Col(name)
        if self.accept("op", "("):
            if self.peek().kind == "kw" and \
                    self.peek().value.lower() == "select":
                sub = self.query()
                self.expect("op", ")")
                return ScalarSubquery(sub)
            inner = self.parse_or()
            self.expect("op", ")")
            return inner
        raise _unsupported(f"{t.value or 'the end of the query'!r}")

    def case(self):
        """``CASE [operand] WHEN ... THEN ... [ELSE ...] END`` (CASE is
        consumed); the simple form compares the operand with each WHEN
        value."""
        operand = None
        if not (self.peek().kind == "kw"
                and self.peek().value.lower() == "when"):
            operand = self.parse_or()
        branches = []
        while self.accept("kw", "when"):
            cond = self.parse_or()
            if operand is not None:
                cond = E.BinOp("==", operand, cond)
            self.expect("kw", "then")
            branches.append((cond, self.parse_or()))
        if not branches:
            raise ValueError("CASE requires at least one WHEN branch")
        otherwise = self.parse_or() if self.accept("kw", "else") else None
        self.expect("kw", "end")
        return E.CaseWhen(branches, otherwise)

    def call(self):
        """``fn(args)``: an aggregate (an ``_AggCall``), a window
        function followed by OVER (a ``WindowExpr``) or a string function
        (an ``E.Func``)."""
        fn = self.next().value
        fl = fn.lower()
        if fl in E.FUNCTIONS:
            self.expect("op", "(")
            args = []
            if not self.accept("op", ")"):
                args.append(self.parse_or())
                while self.accept("op", ","):
                    args.append(self.parse_or())
                self.expect("op", ")")
            return E.Func(fl, args)
        if fl not in _AGG_FNS | _WINDOW_FNS:
            raise _unsupported(f"the function {fn}()")
        self.expect("op", "(")
        args, distinct = [], False
        if not self.accept("op", ")"):
            if not self.accept("op", "*"):
                distinct = bool(self.accept("kw", "distinct"))
                args.append(self.parse_or())
                while self.accept("op", ","):
                    args.append(self.parse_or())
            self.expect("op", ")")
        if self.accept("ident", "over"):
            return self._window_fn(fl, args)(self.window_spec())
        if fl in _WINDOW_FNS:
            raise ValueError(f"window function {fn}() requires an OVER "
                             "clause")
        if distinct and (fl not in ("count", "sum") or len(args) != 1
                         or not isinstance(args[0], E.Col)):
            raise ValueError("DISTINCT is supported in COUNT(DISTINCT col) "
                             "and SUM(DISTINCT col)")
        if len(args) > 1:
            AggExpr(fl, None)            # an unported two-column aggregate
            raise ValueError(f"{fn}() takes one argument")
        if not args and fl != "count":
            raise ValueError(f"{fn} argument must be * or a column name")
        call = _AggCall(fl, args[0] if args else None, distinct)
        call.to_agg()                    # unported aggregates raise here
        return call

    def _window_fn(self, fl: str, args: list):
        col = args[0].name if len(args) == 1 and isinstance(
            args[0], E.Col) else None
        if fl in _AGG_FNS:
            if col is None and not (fl == "count" and not args):
                raise ValueError(f"{fl} argument must be * or a column name")
            return AggExpr(fl, col).over
        if fl == "ntile":
            if len(args) != 1 or not isinstance(args[0], E.Lit):
                raise ValueError("ntile(n) requires an integer literal")
            return W.ntile(int(args[0].value)).over
        if fl in ("first_value", "last_value"):
            if len(args) != 1 or col is None:
                raise ValueError(f"{fl}(col) requires a column argument")
            return getattr(W, fl)(col).over
        if fl == "nth_value":
            if len(args) != 2 or not isinstance(args[0], E.Col):
                raise ValueError("nth_value(col, n) requires a column and "
                                 "an integer literal")
            return W.nth_value(args[0].name,
                               int(_lit_value(args[1], "nth_value n"))).over
        if fl in ("lag", "lead"):
            if not args or not isinstance(args[0], E.Col):
                raise ValueError(f"{fl}(col[, offset[, default]]) requires "
                                 "a column first argument")
            offset = int(_lit_value(args[1], f"{fl} offset")) \
                if len(args) > 1 else 1
            default = _lit_value(args[2], f"{fl} default") \
                if len(args) > 2 else None
            return getattr(W, fl)(args[0].name, offset, default).over
        if args:
            raise ValueError(f"{fl}() takes no arguments")
        return getattr(W, fl)().over

    def window_spec(self):
        self.expect("op", "(")
        partition, order = [], []
        if self.accept("ident", "partition"):
            self.expect("kw", "by")
            partition.append(self.expect("ident").value)
            while self.accept("op", ","):
                partition.append(self.expect("ident").value)
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            order.append(self._window_order_item())
            while self.accept("op", ","):
                order.append(self._window_order_item())
        spec = W.WindowSpec(partition, order)
        kind = "rows" if self.accept("ident", "rows") else (
            "range" if self.accept("ident", "range") else None)
        if kind is not None:
            self.expect("kw", "between")
            lo = self._frame_bound()
            self.expect("kw", "and")
            hi = self._frame_bound()
            spec = (spec.rows_between(lo, hi) if kind == "rows"
                    else spec.range_between(lo, hi))
        self.expect("op", ")")
        return spec

    def _window_order_item(self):
        name = self.expect("ident").value
        if self.accept("kw", "desc"):
            return (name, False)
        self.accept("kw", "asc")
        return (name, True)

    def _frame_bound(self) -> int:
        if self.accept("ident", "unbounded"):
            if self.accept("ident", "preceding"):
                return W.Window.unbounded_preceding
            self.expect("ident", "following")
            return W.Window.unbounded_following
        if self.accept("ident", "current"):
            self.expect("ident", "row")
            return 0
        n = self.expect("number").value
        if float(n) != int(float(n)):
            raise ValueError(f"frame bound must be an integer, got {n!r}")
        off = int(float(n))
        if self.accept("ident", "preceding"):
            return -off
        self.expect("ident", "following")
        return off


def parse(sql: str) -> Query:
    return _Parser(tokenize(sql)).statement()


def execute(sql: str, catalog=None):
    """Run one statement of the subset against the catalog's temp views.
    ``CREATE [OR REPLACE] [TEMP] VIEW name AS ...`` runs its query and
    registers the result; ``DROP [TEMP] VIEW [IF EXISTS] name`` removes
    one (a missing view raises ``KeyError`` unless ``IF EXISTS``). Both
    return an empty frame with no column, as the JAX package does."""
    from ..frame.frame import Frame
    from .catalog import default_catalog

    cat = catalog if catalog is not None else default_catalog()
    m = _DDL_RE.match(sql)
    if m:
        cat.register(m.group(1), execute(m.group(2), cat))
        return Frame({"__one_row__": [0.0]}).drop("__one_row__").limit(0)
    m = _DROP_RE.match(sql)
    if m:
        if not cat.drop(m.group(2)) and not m.group(1):
            raise KeyError(f"temp view {m.group(2)!r} not found")
        return Frame({"__one_row__": [0.0]}).drop("__one_row__").limit(0)
    return _execute(parse(sql), cat)


class _OverlayCatalog:
    """A WITH clause's scope: its names shadow the catalog's views for
    one statement, and the catalog itself is left as it was."""

    def __init__(self, base):
        self._base = base
        self._views: dict = {}

    def register(self, name: str, frame) -> None:
        self._views[name.lower()] = frame

    def lookup(self, name: str):
        try:
            return self._views[name.lower()]
        except KeyError:
            return self._base.lookup(name)


def _pyval(v):
    return v.item() if hasattr(v, "item") else v


def _subquery_column(q, cat, what: str):
    frame = _execute(q, cat)
    if len(frame.columns) != 1:
        raise ValueError(f"{what} must select exactly one column, got "
                         f"{len(frame.columns)}: {frame.columns}")
    return frame


def _resolve_subqueries(expr, cat):
    """Each uncorrelated subquery in ``expr`` run against the catalog: a
    scalar one becomes a literal (one host read; NULL for no row, an
    error for two), ``IN`` a semi join against the subquery's valid
    values (``E.InColumn``), ``EXISTS`` a boolean literal."""
    if isinstance(expr, ScalarSubquery):
        frame = _subquery_column(expr.query, cat, "a scalar subquery")
        values = frame.to_pydict()[frame.columns[0]]
        if len(values) > 1:
            raise ValueError("scalar subquery returned more than one row")
        return E.Lit(_pyval(values[0]) if len(values) else math.nan)
    if isinstance(expr, SubqueryIn):
        frame = _subquery_column(expr.query, cat, "IN (subquery)")
        col = frame._column_values(frame.columns[0])
        valid = (frame.mask.cpu().numpy() if E.is_host_column(col)
                 else frame.mask)
        return E.InColumn(_resolve_subqueries(expr.child, cat), col[valid],
                          expr.negated)
    if isinstance(expr, SubqueryExists):
        return E.Lit(_execute(expr.query, cat).count() > 0)
    if isinstance(expr, PostAggItem):
        return PostAggItem(_resolve_subqueries(expr.expr, cat), expr.aggs,
                           expr._name)
    return _map_expr(expr, lambda e: _resolve_subqueries(e, cat))


def _relation(source, cat):
    return (_execute(source.query, cat) if isinstance(source, DerivedTable)
            else cat.lookup(source))


def _sort_with_exprs(frame, order_by, extra_drops=()):
    """Sort by names, SortOrder markers and expressions (materialised as
    temp columns), then drop the temps and ``extra_drops``."""
    cols, asc, temps = [], [], []
    for i, (key, a) in enumerate(order_by):
        if isinstance(key, E.SortOrder) and not isinstance(key.child, E.Col):
            tmp = f"__ord_{i}"
            frame = frame.with_column(tmp, key.child)
            temps.append(tmp)
            key = E.SortOrder(E.Col(tmp), key.ascending, key.nulls_first)
        elif not isinstance(key, (str, E.SortOrder)):
            tmp = f"__ord_{i}"
            frame = frame.with_column(tmp, key)
            temps.append(tmp)
            key = tmp
        cols.append(key)
        asc.append(a)
    frame = frame.sort(*cols, ascending=asc)
    drops = temps + [c for c in extra_drops if c in frame.columns]
    return frame.drop(*drops) if drops else frame


def _resolve_positions(q: Query) -> None:
    """ORDER BY <position>: the 1-based select item's name."""
    resolved = []
    for key, asc in q.order_by:
        if isinstance(key, int):
            if not 1 <= key <= len(q.items):
                raise ValueError(f"ORDER BY position {key} is not in the "
                                 f"select list (1..{len(q.items)})")
            item = q.items[key - 1]
            if isinstance(item, str):
                raise ValueError("ORDER BY position cannot reference *")
            key = item.name
        resolved.append((key, asc))
    q.order_by = resolved


def _group_keys(q: Query, frame):
    """GROUP BY positions and expressions -> column names; expression
    keys become columns (under the matching select item's name, else a
    temp name the projection drops)."""
    keys = []
    for j, key in enumerate(q.group_by):
        if isinstance(key, str):
            keys.append(key)
            continue
        if isinstance(key, int):
            if not 1 <= key <= len(q.items):
                raise ValueError(f"GROUP BY position {key} is not in the "
                                 f"select list (1..{len(q.items)})")
            item = q.items[key - 1]
            if isinstance(item, str):
                raise ValueError("GROUP BY position cannot reference *")
            if isinstance(item, (AggExpr, PostAggItem)):
                raise ValueError(
                    "GROUP BY position cannot reference an aggregate")
            if not isinstance(item, E.Col):
                frame = frame.with_column(item.name, item)
                q.items[key - 1] = E.Col(item.name)
            keys.append(item.name)
            continue
        matched = next(
            (i for i, it in enumerate(q.items)
             if not isinstance(it, (str, AggExpr, PostAggItem))
             and (str(it) == str(key)
                  or (isinstance(it, E.Alias)
                      and str(it.child) == str(key)))), None)
        if matched is not None:
            name = q.items[matched].name
            frame = frame.with_column(name, q.items[matched])
            q.items[matched] = E.Col(name)
        else:
            name = f"__grp_{j}"
            frame = frame.with_column(name, key)
        keys.append(name)
    q.group_by = keys
    return frame


def _execute(q: Query, cat):
    if q.ctes:
        cat = _OverlayCatalog(cat)
        for name, sub in q.ctes:                # later ones see earlier
            cat.register(name, _execute(sub, cat))
    frame = _relation(q.view, cat)
    for view, how, keys in q.joins:
        frame = frame.join(_relation(view, cat), on=keys or None, how=how)
    if q.where is not None:
        q.where = _resolve_subqueries(q.where, cat)
    if q.having is not None:
        q.having = _resolve_subqueries(q.having, cat)
    q.items = [it if isinstance(it, (str, AggExpr))
               else _resolve_subqueries(it, cat) for it in q.items]
    if q.where is not None:
        frame = frame.filter(q.where)
    if any(isinstance(k, int) for k, _ in q.order_by):
        _resolve_positions(q)
    if q.group_by and any(not isinstance(k, str) for k in q.group_by):
        frame = _group_keys(q, frame)

    aggs = [it for it in q.items if isinstance(it, AggExpr)]
    post_items = [it for it in q.items if isinstance(it, PostAggItem)]
    known = {a.name for a in aggs}
    component_aggs = []
    for it in post_items:
        for a in it.aggs:
            if a.name not in known:
                known.add(a.name)
                component_aggs.append(a)
    having = q.having
    if having is not None and not q.group_by and not (aggs or post_items):
        raise ValueError("HAVING requires GROUP BY or an aggregate select "
                         "list")
    if aggs or post_items or q.group_by:
        if any(isinstance(it, str) for it in q.items):
            raise ValueError("SELECT * cannot be combined with aggregates/"
                             "GROUP BY; list the grouped columns explicitly")
        non_aggs = [it for it in q.items
                    if not isinstance(it, (AggExpr, PostAggItem))]
        for it in non_aggs:
            if not isinstance(it, E.Col) or (q.group_by
                                             and it.name not in q.group_by):
                raise ValueError(f"non-aggregate select item {it} must be "
                                 "a GROUP BY key")
        extra: list = []
        if having is not None:
            having = _rewrite_aggs(having, extra)
        if q.group_by:
            order_by = []
            for key, asc in q.order_by:
                if not isinstance(key, str):
                    key = _rewrite_aggs(key, extra)
                    if isinstance(key, E.Col):
                        key = key.name
                order_by.append((key, asc))
            q.order_by = order_by
        seen: set = set()
        extra = [a for a in extra if a.name not in known
                 and a.name not in seen and not seen.add(a.name)]
        if q.group_by:
            frame = frame.group_by(*q.group_by).agg(*aggs, *component_aggs,
                                                    *extra)
        else:
            if non_aggs:
                raise ValueError("plain columns in an aggregate query "
                                 "require GROUP BY")
            frame = frame.agg(*aggs, *component_aggs, *extra)
        if having is not None:
            frame = frame.filter(having)
        for it in post_items:
            frame = frame.with_column(it.name, it.expr)
        keep = [it.name for it in q.items]
        needs: set = set()
        for key, _ in q.order_by:
            if isinstance(key, str):
                needs.add(key)
            else:
                _referenced_cols(key, needs)
        q.drop_after_sort = [c for c in frame.columns
                             if c in needs and c not in keep]
        frame = frame.select(*keep, *q.drop_after_sort)
    else:
        if len(q.items) > 1 and any(isinstance(it, str) for it in q.items):
            expanded = []
            for it in q.items:
                expanded.extend(E.Col(c) for c in frame.columns) \
                    if isinstance(it, str) else expanded.append(it)
            q.items = expanded
        star = len(q.items) == 1 and isinstance(q.items[0], str)
        if q.order_by and not star:
            # SQL sorts before it projects, so ORDER BY may name columns
            # the select list drops: sort first when the source has them
            keys = []
            for i, (key, asc) in enumerate(q.order_by):
                if isinstance(key, E.SortOrder):
                    if not isinstance(key.child, E.Col):
                        tmp = f"__ord_{i}"
                        frame = frame.with_column(tmp, key.child)
                        key = E.SortOrder(E.Col(tmp), key.ascending,
                                          key.nulls_first)
                elif not isinstance(key, str):
                    tmp = f"__ord_{i}"
                    frame = frame.with_column(tmp, key)
                    key = tmp
                keys.append((key, asc))
            q.order_by = keys
            if all((c if isinstance(c, str) else c.name) in frame.columns
                   for c, _ in q.order_by):
                frame = frame.sort(*[c for c, _ in q.order_by],
                                   ascending=[a for _, a in q.order_by])
                q.order_by = []
        if not star:
            keep_for_sort: list = []
            if q.order_by:
                produced = {it.name for it in q.items}
                needed: set = set()
                for key, _ in q.order_by:
                    if isinstance(key, str):
                        needed.add(key)
                    else:
                        _referenced_cols(key, needed)
                keep_for_sort = [c for c in frame.columns
                                 if c in needed and c not in produced]
                if keep_for_sort and q.distinct:
                    raise ValueError(
                        "SELECT DISTINCT: ORDER BY keys must appear in the "
                        "select list")
            frame = frame.select(*q.items, *keep_for_sort)
            q.drop_after_sort = keep_for_sort
    if q.distinct:
        frame = frame.distinct()
    if q.order_by:
        frame = _sort_with_exprs(frame, q.order_by, q.drop_after_sort)
    elif q.drop_after_sort:
        frame = frame.drop(*q.drop_after_sort)
    if q.offset:
        frame = frame.offset(q.offset)
    if q.limit is not None:
        frame = frame.limit(q.limit)
    return frame
