"""The SQL of the torch port (``sparkdq4ml_tpu/sql/parser.py``)::

    statement := EXPLAIN [ANALYZE] statement
                 | [WITH name AS '(' set ')', ...] set
                 | CREATE [OR REPLACE] [TEMP[ORARY]] VIEW name AS statement
                 | DROP [TEMP[ORARY]] VIEW [IF EXISTS] name
    set      := query ((UNION [ALL] | INTERSECT | EXCEPT) query)*
    query    := SELECT [DISTINCT] item, ... [FROM relation join*]
                [WHERE pred] [GROUP BY key, ... | GROUP BY ROLLUP|CUBE
                '(' col, ... ')'] [HAVING pred]
                [ORDER BY key [ASC|DESC] [NULLS FIRST|LAST], ...]
                [LIMIT n] [OFFSET m]
    relation := view [[AS] alias] | '(' set ')' [[AS] alias]
    join     := [INNER | LEFT [OUTER|SEMI|ANTI] | RIGHT [OUTER]
                 | FULL [OUTER] | CROSS] JOIN relation
                (USING '(' col, ... ')' | ON a = b)
    item     := '*' | expr [OVER window] [[AS] alias]
    window   := '(' [PARTITION BY col, ...] [ORDER BY col [ASC|DESC], ...]
                [(ROWS|RANGE) BETWEEN bound AND bound] ')'

A SELECT without FROM projects over one anonymous row (``SELECT 1 + 1,
upper('a')``). Set operations are left-associative (no higher INTERSECT
precedence, as in the JAX package). Expressions: columns, qualified
``alias.col`` (resolved against the FROM/JOIN scope: the alias, else the
view name; the right side's duplicate column as ``<name>_right``; a
column literally named so first), numeric, boolean and string literals,
NULL, ``cast(x AS int|integer|double|float|string)``, ``+ - * / %``,
``||`` (concat), unary minus, comparisons, AND/OR/NOT and parentheses;
``[NOT] IN (list)``, ``[NOT] BETWEEN a AND b``, ``[NOT] LIKE 'pattern'``,
``IS [NOT] NULL``, ``CASE [operand] WHEN ... THEN ... [ELSE ...] END``,
``if(c, a, b)``; every builtin function and row function by name
(``upper(s)``, ``round(x, 2)``, ``rand(42)``; a registered UDF of the
same name wins), ``extract(FIELD FROM x)`` over the date and time
fields, ``LEFT(s, n)``/``RIGHT(s, n)`` in call position; the higher-order
functions ``transform``/``filter``/``exists(arr, x -> ...)`` and
``aggregate(arr, init, (acc, x) -> ...[, acc -> ...])`` with SQL lambdas;
subqueries: a scalar ``(SELECT ...)`` (read once to the host as a
literal), ``[NOT] IN (SELECT ...)`` (a semi join against the subquery's
values, planned on the device) and ``EXISTS (SELECT ...)`` (kept apart
from the array ``EXISTS(arr, x -> ...)``), and a correlated ``[NOT]
EXISTS`` / ``[NOT] IN`` whose correlation is a conjunction of
equalities, rewritten to a LEFT SEMI or LEFT ANTI join (a correlated NOT
IN keeps the anti join's null rule); any other correlation raises the JAX
package's ValueError. Aggregates: every one of ``frame/aggregates.py``
(``COUNT(*)``, ``COUNT(DISTINCT x)``, ``SUM(DISTINCT x)``,
``PERCENTILE_APPROX(col, p)``, ``CORR(a, b)``, ``MAX_BY(v, ord)``,
``APPROX_COUNT_DISTINCT(col[, rsd])``, ...) and the boolean ones
(``count_if``, ``any``/``some``/``bool_or``, ``every``/``bool_and``)
desugared over a 0/1 flag; expressions over aggregates in the select
list, HAVING and ORDER BY; the window functions of ``frame/window.py``
with OVER. GROUP BY and ORDER BY keys are names, 1-based select-item
positions or expressions. ``WITH`` names shadow temp views for one
statement (``_OverlayCatalog``).

Out of scope, raising ``NotImplementedError`` naming what was met:
``GROUP BY GROUPING SETS``, the ``<=>`` operator, CAST to a type outside
the four above, and statements other than SELECT, EXPLAIN and the
temp-view DDL. A function name that is neither a UDF, a row function
nor a builtin raises the registry's KeyError when the query runs, as in
the JAX package.

The executor follows the JAX package's: every query (each CTE body
first) passes through the cost-based optimizer (``sql/optimizer.py``:
pushdown, pruning, build-side hints, join reordering at level 2) and runs
under adaptive execution (``sql/adaptive.py``: the join's build flip,
the re-bucket after WHERE, the grouped engine's lowering choice), whose
rewrites and re-plans never change a result.
``spark.optimizer.enabled=false`` and ``spark.aqe.enabled=false`` run
the literal plan.

``EXPLAIN`` renders the structural plan tree with no execution
(``est_rows`` from statstore history, the optimizer's ``== Rewrites ==``
and ``== Before Optimization ==``); ``EXPLAIN ANALYZE`` runs the
statement and annotates each operator with its measured rows, wall
time, compile/hit verdict, host reads, peak memory and counted cost,
then ``== Query Stats ==``, ``== Caches ==`` and ``== Adaptive ==``.
The output is the JAX package's under ``spark.audit.enabled=false`` and
``spark.dq.profile.enabled=false``; it still lacks that package's
``est peak`` column and its ``!! est peak`` budget line (its
``analysis/program/static_mem.py``), its DQ-rule lines (its
``utils/dqprof.py``) and its sharded annotations (``ShardedStage``,
``Exchange``, per-shard rows).
"""

from __future__ import annotations

import math
import re
from typing import Optional

from ..config import config
from ..frame import window as W
from ..frame.aggregates import (AggExpr, AggOfExpr, approx_count_distinct,
                                percentile_approx)
from ..ops import expressions as E
from ..utils import observability as _obs

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

# The JAX grammar's aggregate names: one-column aggregates, the
# percentile with its literal percentage, the two-column family, and the
# boolean aggregates (desugared into an aggregate of a 0/1 flag).
_AGG_FNS_1 = {"count", "sum", "avg", "mean", "min", "max", "stddev",
              "variance", "stddev_pop", "var_pop", "median", "mode",
              "collect_list", "collect_set", "first", "last", "skewness",
              "kurtosis", "approx_count_distinct"}
_AGG_FNS_PCT = {"percentile_approx", "approx_percentile"}
_AGG_FNS_2 = {"corr", "covar_samp", "covar_pop", "max_by", "min_by"}
_BOOL_AGGS = {"count_if", "any", "some", "every", "bool_or", "bool_and"}
_AGG_FNS = _AGG_FNS_1 | _AGG_FNS_PCT | _AGG_FNS_2 | _BOOL_AGGS
_WINDOW_FNS = {"row_number", "rank", "dense_rank", "percent_rank",
               "cume_dist", "ntile", "lag", "lead", "first_value",
               "last_value", "nth_value"}
_SUBSET = ("the torch port's SQL subset ([WITH ...] SELECT ... [FROM ...] "
           "[JOIN] [WHERE] [GROUP BY [ROLLUP|CUBE]] [HAVING] [ORDER BY] "
           "[LIMIT] [UNION|INTERSECT|EXCEPT ...], with subqueries; "
           "CREATE/DROP TEMP VIEW)")
_CAST_TYPES = ("int", "integer", "long", "double", "float", "boolean",
               "string")
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
    aggregated frame before any evaluation. ``args`` are the call's
    arguments (none for ``*``); ``build`` makes the aggregate from them
    (a percentage or an rsd rides along in ``extra``)."""

    def __init__(self, fn: str, args, distinct: bool = False, extra=None):
        self.fn = fn.lower()
        self.args = list(args)
        self.distinct = distinct
        self.extra = extra

    def with_args(self, args) -> "_AggCall":
        return _AggCall(self.fn, args, self.distinct, self.extra)

    def to_agg(self) -> AggExpr:
        fn, args = self.fn, self.args
        if self.distinct:
            return AggExpr(f"{fn}_distinct", args[0].name)
        if fn in _AGG_FNS_2:
            return AggExpr(fn, args[0].name, column2=args[1].name)
        if fn == "approx_count_distinct":
            return approx_count_distinct(args[0].name, self.extra)
        if fn in _AGG_FNS_PCT:
            return percentile_approx(args[0].name, self.extra)
        if not args or isinstance(args[0], E.Col):
            return AggExpr(fn, args[0].name if args else None)
        return AggOfExpr(fn, args[0])

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


def _bool_agg(fn: str, pred):
    """``count_if``/``any``/``some``/``every``/``bool_or``/``bool_and`` of
    a predicate, desugared as the JAX package does: an aggregate of the
    0/1 flag ``CASE WHEN pred THEN 1 ELSE 0 END`` (``count_if`` its sum;
    the others its max or min, compared with 0)."""
    flag = E.CaseWhen([(pred, E.Lit(1))], E.Lit(0))
    if fn == "count_if":
        return _AggRef(AggOfExpr("sum", flag, alias=f"count_if({pred})"))
    red = "max" if fn in ("any", "some", "bool_or") else "min"
    return E.BinOp(">", _AggRef(AggOfExpr(red, flag)), E.Lit(0))


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
    """``FROM (SELECT ...) [AS] alias``: executed into a frame first; the
    alias scopes qualified references to its columns."""

    __slots__ = ("query", "alias")

    def __init__(self, query, alias=None):
        self.query = query
        self.alias = alias


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
    """A parsed SELECT: its clauses, the set-operation branches that
    follow it (``unions``: ``(op, Query)``, op one of union, union_all,
    intersect, except; left-associative), the WITH clause before it, the
    FROM relation's alias and the grouping mode (group, rollup or
    cube)."""

    def __init__(self, items, view, where=None, group_by=(), order_by=(),
                 limit=None, joins=(), distinct=False, having=None,
                 offset=0):
        self.items = list(items)
        self.view = view
        self.where = where
        self.group_by = list(group_by)
        self.order_by = list(order_by)
        self.limit = limit
        self.joins = list(joins)              # [(source, how, keys, alias)]
        self.distinct = distinct
        self.having = having
        self.offset = offset
        self.drop_after_sort: list = []
        self.ctes: list = []                  # [(name, Query), ...]
        self.unions: list = []
        self.view_alias = None
        self.group_mode = "group"


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
        return E.StringMatch(fn(expr.child), expr.pattern, expr.negated,
                             expr.kind)
    if isinstance(expr, E.CaseWhen):
        return E.CaseWhen([(fn(c), fn(v)) for c, v in expr.branches],
                          None if expr.otherwise_expr is None
                          else fn(expr.otherwise_expr))
    if isinstance(expr, E.Func):
        return E.Func(expr.fn_name, [fn(a) for a in expr.args])
    if isinstance(expr, E.UdfCall):
        return E.UdfCall(expr.udf_name, [fn(a) for a in expr.args],
                         expr._registry)
    if isinstance(expr, E.HigherOrder):
        def lam(x):
            return None if x is None else E.Lambda(x.params, fn(x.body))
        return E.HigherOrder(expr.kind, fn(expr.source), lam(expr.lam),
                             None if expr.init is None else fn(expr.init),
                             lam(expr.finish))
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


def _map_cols(expr, fn):
    """A copy of ``expr`` with ``fn`` applied to every column name (inside
    aggregate calls too; a subquery's own query is left to its scope)."""
    if isinstance(expr, E.Col):
        new = fn(expr.name)
        return expr if new == expr.name else E.Col(new)
    if isinstance(expr, _AggCall):
        return expr.with_args([_map_cols(a, fn) for a in expr.args])
    return _map_expr(expr, lambda e: _map_cols(e, fn))


def _resolve_name(name: str, scope: dict, columns) -> str:
    """A possibly qualified name against the relation scope (alias ->
    {source column: output column}). A column literally named so wins
    first; a name with a parenthesis is an aggregate's output column."""
    if "." not in name or "(" in name or name in columns:
        return name
    alias, _, col = name.partition(".")
    m = scope.get(alias.lower())
    if m is None:
        raise ValueError(
            f"unknown relation alias {alias!r} in {name!r} "
            f"(aliases in scope: {sorted(scope)})")
    if col not in m:
        raise ValueError(f"column {col!r} not found in relation "
                         f"{alias!r} (has: {sorted(m)})")
    return m[col]


def _resolve_agg_cols(agg, scope: dict, columns):
    """The qualified column names of an aggregate resolved in place (a
    parsed query executes once)."""
    if agg.column is not None:
        agg.column = _resolve_name(agg.column, scope, columns)
    if agg.column2 is not None:
        agg.column2 = _resolve_name(agg.column2, scope, columns)
    return agg


def _resolve_qualified(expr, scope: dict, columns):
    """Qualified references (``t.price``) rewritten to output columns; in
    an item over aggregates, the references to the aggregates' outputs
    follow their new names (``max(t.p)`` -> ``max(p)``)."""
    if not scope:
        return expr
    if isinstance(expr, PostAggItem):
        renames, aggs = {}, []
        for a in expr.aggs:
            old = a.name
            a = _resolve_agg_cols(a, scope, columns)
            if a.name != old:
                renames[old] = a.name
            aggs.append(a)
        inner = expr.expr
        if renames:
            inner = _map_cols(inner, lambda n: renames.get(n, n))
        inner = _map_cols(inner, lambda n: _resolve_name(n, scope, columns))
        return PostAggItem(inner, aggs, expr._name)
    return _map_cols(expr, lambda n: _resolve_name(n, scope, columns))


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
                ctes.append((name, self.set_expr()))
                self.expect("op", ")")
                if not self.accept("op", ","):
                    break
        q = self.set_expr()
        q.ctes = ctes
        self.expect("eof")
        return q

    def set_expr(self) -> Query:
        """``query ((UNION [ALL] | INTERSECT | EXCEPT) query)*``,
        left-associative (no higher INTERSECT precedence, as in the JAX
        package: parenthesise a derived table to group)."""
        q = self.query()
        while True:
            if self.accept("kw", "union"):
                op = "union_all" if self.accept("kw", "all") else "union"
            elif self.peek().kind == "ident" and self.peek().value.lower() \
                    in ("intersect", "except"):
                op = self.next().value.lower()
            else:
                return q
            q.unions.append((op, self.query()))

    def query(self) -> Query:
        self.expect("kw", "select")
        distinct = bool(self.accept("kw", "distinct"))
        items = [self.select_item()]
        while self.accept("op", ","):
            items.append(self.select_item())
        # a SELECT without FROM projects over one anonymous row
        view, view_alias, joins = None, None, []
        if self.accept("kw", "from"):
            view, view_alias = self.relation()
            while True:
                j = self.join()
                if j is None:
                    break
                joins.append(j)
        where = self.parse_or() if self.accept("kw", "where") else None
        group_by, group_mode = [], "group"
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            word = self.peek().value.lower()
            if self.peek().kind == "ident" and word in ("rollup", "cube") \
                    and self.at_call():
                # GROUP BY ROLLUP(a, b) / CUBE(a, b): Spark's subtotals
                group_mode = self.next().value.lower()
                self.expect("op", "(")
                group_by.append(self.expect("ident").value)
                while self.accept("op", ","):
                    group_by.append(self.expect("ident").value)
                self.expect("op", ")")
            else:
                if self.peek().kind == "ident" and word == "grouping" \
                        and self.at_call():
                    raise _unsupported("GROUP BY GROUPING SETS")
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
        q = Query(items, view, where, group_by, order_by, limit, joins,
                  distinct, having, offset)
        q.group_mode = group_mode
        q.view_alias = view_alias
        return q

    def relation(self):
        """A view name or a derived table, with an optional alias:
        ``(source, alias)``."""
        if self.peek().kind == "op" and self.peek().value == "(":
            self.next()
            sub = self.set_expr()
            self.expect("op", ")")
            self.accept("kw", "as")
            alias = None
            if self.peek().kind == "ident" and not self._clause_word():
                alias = self.next().value
            return DerivedTable(sub, alias), alias
        view = self.expect("ident").value
        alias = None
        if self.accept("kw", "as"):
            alias = self.expect("ident").value
        elif self.peek().kind == "ident" and not self._clause_word():
            alias = self.next().value
        return view, alias

    def _clause_word(self) -> bool:
        return self.peek().value.lower() in ("semi", "anti", "intersect",
                                             "except", "offset")

    def join(self):
        """``[INNER|LEFT [OUTER|SEMI|ANTI]|RIGHT [OUTER]|FULL [OUTER]|
        CROSS] JOIN relation (USING (k, ...) | ON a = b)`` -> ``(source,
        how, keys, alias)``; a qualified ON (``ON t.k = g.k``) reduces to
        the shared column name (the joins are USING-shaped)."""
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
        view, alias = self.relation()
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
        return view, how, keys, alias

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
                expr = _AggRef(expr.to_agg())
            if self.peek().kind == "op" and self.peek().value in (
                    "+", "-", "*", "/", "%"):
                expr = self.parse_add(expr)
            elif isinstance(expr, _AggRef):
                return self._alias(expr.agg)
        else:
            expr = self.parse_or()
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
                sub = self.set_expr()
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
        if t.kind == "op" and t.value in ("<=>", "->"):
            raise _unsupported(f"the operator {t.value}")
        return left

    def parse_add(self, left=None):
        left = self.parse_mul(left)
        while True:
            if self.accept("op", "+"):
                left = E.BinOp("+", left, self.parse_mul())
            elif self.accept("op", "-"):
                left = E.BinOp("-", left, self.parse_mul())
            elif self.accept("op", "||"):
                # SQL || is concat (null-propagating)
                left = E.UdfCall("concat", [left, self.parse_mul()])
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
        if t.kind == "ident" and t.value.lower() == "extract" \
                and self.at_call():
            # extract(FIELD FROM x): the field functions' sugar
            self.next()
            self.expect("op", "(")
            field = self.expect("ident").value.lower()
            field = {"day": "dayofmonth", "dow": "dayofweek",
                     "doy": "dayofyear", "week": "weekofyear"}.get(field,
                                                                   field)
            self.expect("kw", "from")
            inner = self.parse_or()
            self.expect("op", ")")
            return E.UdfCall(field, [inner])
        if t.kind == "kw" and t.value.lower() in ("left", "right") \
                and self.at_call():
            # LEFT(s, n) / RIGHT(s, n): the string functions named by join
            # keywords, in call position only
            self.next()
            return E.UdfCall(t.value.lower(), self._call_args())
        if t.kind == "ident":
            if t.value.lower() == "exists" and self.at_call() and \
                    self.peek(2).kind == "kw" and \
                    self.peek(2).value.lower() == "select":
                self.next()
                self.next()
                sub = self.set_expr()
                self.expect("op", ")")
                return SubqueryExists(sub)
            if self.at_call():
                return self.call()
            # a qualified reference ``alias.col`` resolves at execution
            # against the relation scope (a literal dotted column wins)
            return E.Col(self._dotted())
        if self.accept("op", "("):
            if self.peek().kind == "kw" and \
                    self.peek().value.lower() == "select":
                sub = self.set_expr()
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

    def _call_args(self) -> list:
        """``'(' [expr, ...] ')'``."""
        self.expect("op", "(")
        args = []
        if not self.accept("op", ")"):
            args.append(self.parse_or())
            while self.accept("op", ","):
                args.append(self.parse_or())
            self.expect("op", ")")
        return args

    def call(self):
        """``fn(args)``: an aggregate (an ``_AggCall``, or for a boolean
        aggregate an expression over one), a window function followed by
        OVER (a ``WindowExpr``), ``if(c, a, b)`` (a CASE), a higher-order
        function (an ``E.HigherOrder``), or any other name as an
        ``E.UdfCall``, which resolves at evaluation to a registered UDF, a
        row function or a builtin."""
        fn = self.next().value
        fl = fn.lower()
        if fl == "if":
            args = self._call_args()
            if len(args) != 3:
                raise ValueError(f"if(cond, a, b) takes 3 arguments, got "
                                 f"{len(args)}")
            return E.CaseWhen([(args[0], args[1])], args[2])
        if fl in ("transform", "filter", "exists", "aggregate"):
            self.expect("op", "(")
            return self.higher_order(fl)
        if fl not in _AGG_FNS | _WINDOW_FNS:
            return E.UdfCall(fn, self._call_args())
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
        cols = all(isinstance(a, E.Col) for a in args)
        if distinct:
            if fl not in ("count", "sum") or len(args) != 1 or not cols:
                raise ValueError("DISTINCT is supported in COUNT(DISTINCT "
                                 "col) and SUM(DISTINCT col)")
            return _AggCall(fl, args, distinct=True)
        if fl in _AGG_FNS_2:
            if len(args) != 2 or not cols:
                raise ValueError(f"{fn}(col1, col2) takes two columns")
            return _AggCall(fl, args)
        if fl in _BOOL_AGGS:
            if len(args) != 1:
                raise ValueError(f"{fn}(predicate) takes one argument")
            return _bool_agg(fl, args[0])
        if fl == "approx_count_distinct":
            if not args or not isinstance(args[0], E.Col):
                raise ValueError(
                    "approx_count_distinct(col[, rsd]) takes a column")
            extra = (float(_lit_value(args[1], "rsd")) if len(args) > 1
                     else 0.05)
            call = _AggCall(fl, args[:1], extra=extra)
        elif fl in _AGG_FNS_PCT:
            if len(args) not in (2, 3) or not isinstance(args[0], E.Col) \
                    or not isinstance(args[1], E.Lit):
                raise ValueError(f"{fn}(col, percentage[, accuracy]) "
                                 "requires a column and a literal "
                                 "percentage")
            call = _AggCall(fl, args[:1], extra=float(args[1].value))
        else:
            if len(args) > 1:
                raise ValueError(f"{fn}() takes one argument")
            if not args and fl != "count":
                raise ValueError(f"{fn} argument must be * or a column "
                                 "name")
            call = _AggCall(fl, args)
        call.to_agg()                    # validates the arguments
        return call

    def lambda_(self) -> E.Lambda:
        """``x -> expr`` or ``(acc, x) -> expr``: the parameters appear as
        column references in the body, bound by the higher-order
        function's scope frame."""
        params = []
        if self.accept("op", "("):
            params.append(self.expect("ident").value)
            while self.accept("op", ","):
                params.append(self.expect("ident").value)
            self.expect("op", ")")
        else:
            params.append(self.expect("ident").value)
        self.expect("op", "->")
        return E.Lambda(params, self.parse_or())

    def higher_order(self, fn: str):
        """``transform``/``filter``/``exists`` ``(arr, lambda)`` and
        ``aggregate(arr, init, merge[, finish])``; '(' is consumed."""
        source = self.parse_or()
        self.expect("op", ",")
        if fn == "aggregate":
            init = self.parse_or()
            self.expect("op", ",")
            merge = self.lambda_()
            finish = self.lambda_() if self.accept("op", ",") else None
            self.expect("op", ")")
            return E.HigherOrder("aggregate", source, merge, init=init,
                                 finish=finish)
        lam = self.lambda_()
        self.expect("op", ")")
        return E.HigherOrder(fn, source, lam)

    def _window_fn(self, fl: str, args: list):
        col = args[0].name if len(args) == 1 and isinstance(
            args[0], E.Col) else None
        if fl in _AGG_FNS_1 - {"approx_count_distinct"}:
            if col is None and not (fl == "count" and not args):
                raise ValueError(f"{fl} argument must be * or a column name")
            return AggExpr(fl, col).over
        if fl in _AGG_FNS:
            raise ValueError(f"windowed {fl}() is not supported (the "
                             "running aggregates window; Spark <= 2.x)")
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
    return an empty frame with no column, as the JAX package does.

    When tracing is on, each statement runs inside an ``sql.query`` span
    with the query text, the plan summary (:func:`plan_summary`) and the
    output's row slots."""
    if not _obs.TRACER.enabled:
        return _execute_statement(sql, catalog)
    with _obs.TRACER.span("sql.query", cat="sql",
                          query=" ".join(sql.split())[:300]) as s:
        out = _execute_statement(sql, catalog)
        n = getattr(out, "_n", None)
        if n is not None:
            s.set(rows_out=n)
        return out


_EXPLAIN_RE = re.compile(r"^\s*explain(\s+analyze)?\b(.*)$",
                         re.IGNORECASE | re.DOTALL)


def _execute_statement(sql: str, catalog=None):
    from ..frame.frame import Frame
    from .catalog import default_catalog

    cat = catalog if catalog is not None else default_catalog()
    m = _EXPLAIN_RE.match(sql)
    if m and m.group(2).strip():
        return _execute_explain(m.group(2), cat, analyze=bool(m.group(1)))
    m = _DDL_RE.match(sql)
    if m:
        if _obs.TRACER.enabled:
            _obs.current_span().set(plan=f"CreateView[{m.group(1)}]")
        cat.register(m.group(1), execute(m.group(2), cat))
        return Frame({"__one_row__": [0.0]}).drop("__one_row__").limit(0)
    m = _DROP_RE.match(sql)
    if m:
        if _obs.TRACER.enabled:
            _obs.current_span().set(plan=f"DropView[{m.group(2)}]")
        if not cat.drop(m.group(2)) and not m.group(1):
            raise KeyError(f"temp view {m.group(2)!r} not found")
        return Frame({"__one_row__": [0.0]}).drop("__one_row__").limit(0)
    q = parse(sql)
    if _obs.TRACER.enabled:
        _obs.current_span().set(plan=plan_summary(q))
    return _run_parsed(q, cat)


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


def _execute_subquery(q, cat):
    """A subquery run in its own scope; a reference to an outer relation
    that no rewrite took (``_decorrelate_where``) is the JAX package's
    "correlated subqueries are not supported" error."""
    try:
        return _execute_set(q, cat)
    except ValueError as e:
        if "unknown relation alias" in str(e):
            raise ValueError(
                "correlated subqueries are not supported (the subquery "
                f"references an outer relation: {e}); rewrite as a join "
                "- LEFT SEMI for EXISTS/IN, LEFT ANTI for NOT EXISTS/NOT "
                "IN") from e
        raise


def _subquery_column(q, cat, what: str):
    frame = _execute_subquery(q, cat)
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
        return E.Lit(_execute_subquery(expr.query, cat).count() > 0)
    if isinstance(expr, PostAggItem):
        return PostAggItem(_resolve_subqueries(expr.expr, cat), expr.aggs,
                           expr._name)
    return _map_expr(expr, lambda e: _resolve_subqueries(e, cat))


def _relation(source, cat):
    return (_execute_set(source.query, cat)
            if isinstance(source, DerivedTable) else cat.lookup(source))


# ---------------------------------------------------------------------------
# Correlated EXISTS / IN: the semi/anti-join rewrite
# ---------------------------------------------------------------------------

def _conjuncts(e) -> list:
    if isinstance(e, E.BinOp) and e.op == "&":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _conjoin(parts):
    out = None
    for p in parts:
        out = p if out is None else E.BinOp("&", out, p)
    return out


def _relation_aliases(q: Query) -> set:
    """The relation aliases a query's own FROM/JOIN clause binds."""
    names = set()
    if isinstance(q.view, str):
        names.add((q.view_alias or q.view).lower())
    elif isinstance(q.view, DerivedTable) and q.view.alias:
        names.add(q.view.alias.lower())
    for view, _how, _keys, jalias in q.joins:
        nm = jalias or (view if isinstance(view, str) else None)
        if nm:
            names.add(nm.lower())
    return names


def _outer_refs(expr, outer_scope: dict, inner_aliases: set) -> set:
    """Qualified names in ``expr`` whose alias binds in the outer scope
    and not in the subquery's own relations: the correlation points."""
    cols: set = set()
    _referenced_cols(expr, cols)
    return {name for name in cols
            if "." in name and "(" not in name
            and name.partition(".")[0].lower() in outer_scope
            and name.partition(".")[0].lower() not in inner_aliases}


def _unsupported_correlation(why: str) -> ValueError:
    return ValueError(
        f"unsupported correlated subquery ({why}); only conjunctive "
        "equality correlation decorrelates (the Spark semi/anti-join "
        "rewrite) - rewrite the query as an explicit JOIN")


def _decorrelate_one(sub: Query, extra_outer_cols, outer_scope, cat):
    """One correlated predicate subquery as the right side of a semi (or
    anti) join: ``(right_frame, keys)``, the right frame's columns named
    after the outer columns they equal. ``extra_outer_cols`` pairs the IN
    form's outer column with the subquery's select item. Only conjunctive
    equality correlation rewrites; anything else raises."""
    inner_aliases = _relation_aliases(sub)
    if sub.unions or sub.group_by or sub.having or sub.limit is not None \
            or sub.offset or sub.ctes:
        raise _unsupported_correlation(
            "the subquery uses set ops, grouping, or limits")
    eq_pairs, rest = [], []           # (outer flat column, inner expr)
    for c in _conjuncts(sub.where) if sub.where is not None else []:
        refs = _outer_refs(c, outer_scope, inner_aliases)
        if not refs:
            rest.append(c)
            continue
        if isinstance(c, E.BinOp) and c.op == "==" and isinstance(
                c.left, E.Col) and isinstance(c.right, E.Col):
            l_out, r_out = c.left.name in refs, c.right.name in refs
            if l_out != r_out:
                outer = c.left.name if l_out else c.right.name
                eq_pairs.append((_resolve_name(outer, outer_scope, ()),
                                 c.right if l_out else c.left))
                continue
        raise _unsupported_correlation(f"non-equi correlated predicate {c}")
    for outer_expr, item in extra_outer_cols:
        if not isinstance(outer_expr, E.Col):
            raise _unsupported_correlation(
                "the IN operand must be a plain column")
        eq_pairs.append((outer_expr.name, item))
    if not eq_pairs:
        raise _unsupported_correlation("no equality correlation found")

    def inner_key(ie):
        # the subquery's own qualifier stripped: g.guest == guest
        if isinstance(ie, E.Col):
            alias, _, col = ie.name.partition(".")
            return col if alias.lower() in inner_aliases else ie.name
        return str(ie)

    deduped: dict = {}
    for o, ie in eq_pairs:
        k = inner_key(ie)
        if o in deduped and deduped[o][1] != k:
            raise _unsupported_correlation(
                "two different correlation keys target one outer column")
        deduped.setdefault(o, (ie, k))
    inner = Query([E.Alias(ie, o) for o, (ie, _) in deduped.items()],
                  sub.view, _conjoin(rest), joins=sub.joins, distinct=True)
    inner.view_alias = sub.view_alias
    return _execute_set(_maybe_optimize(inner, cat), cat), list(deduped)


def _decorrelate_where(where, scope: dict, cat):
    """WHERE split into its plain conjuncts and its correlated predicate
    subqueries, each of those a ``(right_frame, keys, how)`` semi or anti
    join. Uncorrelated subqueries stay for ``_resolve_subqueries``, which
    keeps their null semantics; a correlated NOT IN takes the anti join's
    (a null key never matches, so its row stays)."""
    keep, joins = [], []
    for c in _conjuncts(where):
        neg, target = False, c
        if isinstance(c, E.Not) and isinstance(c.child, (SubqueryExists,
                                                          SubqueryIn)):
            neg, target = True, c.child
        if isinstance(target, SubqueryExists):
            sub, extra = target.query, []
        elif isinstance(target, SubqueryIn):
            sub = target.query
            neg = neg != target.negated
            if len(sub.items) != 1 or isinstance(sub.items[0],
                                                 (str, AggExpr)):
                keep.append(c)
                continue
            extra = [(target.child, sub.items[0])]
        else:
            keep.append(c)
            continue
        if sub.where is None or not _outer_refs(sub.where, scope,
                                                _relation_aliases(sub)):
            keep.append(c)
            continue
        right, keys = _decorrelate_one(sub, extra, scope, cat)
        joins.append((right, keys, "left_anti" if neg else "left_semi"))
    return _conjoin(keep), joins


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


def _execute_set(q: Query, cat):
    """A set expression: its first SELECT, then each UNION [ALL] /
    INTERSECT / EXCEPT branch, left to right."""
    frame = _execute_single(q, cat)
    for op, sub in q.unions:
        rhs = _execute_single(sub, cat)
        if op == "union_all":
            frame = frame.union(rhs)
        elif op == "union":
            frame = frame.union(rhs).distinct()
        elif op == "intersect":
            frame = frame.intersect(rhs)
        else:
            frame = frame.subtract(rhs)
    return frame


def _scoped_source(q: Query, cat):
    """The FROM relation joined with each JOIN, and the relation scope:
    alias (or view name) -> {source column: output column}; a semi or
    anti join's right side is reachable through its keys only."""
    from ..frame.frame import Frame

    scope: dict = {}
    if q.view is None:
        # OneRowRelation: one anonymous row for the projection
        return Frame({"__one_row__": [0.0]}).drop("__one_row__"), scope
    frame = _relation(q.view, cat)
    if isinstance(q.view, DerivedTable):
        if q.view.alias:
            scope[q.view.alias.lower()] = {c: c for c in frame.columns}
    else:
        scope[(q.view_alias or q.view).lower()] = {c: c for c in
                                                   frame.columns}
    # the optimizer's build hints and (left, right) row estimates per
    # join: the estimates are the drift baseline of adaptive execution
    hints = list(getattr(q, "join_build", ()) or ())
    ests = list(getattr(q, "join_est", ()) or ())
    for j, (view, how, keys, jalias) in enumerate(q.joins):
        right = _relation(view, cat)
        pre = set(frame.columns)
        frame = frame.join(right, on=keys or None, how=how,
                           build=hints[j] if j < len(hints) else None,
                           est=ests[j] if j < len(ests) else None)
        name = jalias or (view if isinstance(view, str) else None)
        if name:
            post = set(frame.columns)
            scope[name.lower()] = (
                {k: k for k in keys} if how in ("left_semi", "left_anti")
                else {c: (f"{c}_right" if c not in keys and c in pre
                          and f"{c}_right" in post else c)
                      for c in right.columns})
    return frame, scope


def _execute_single(q: Query, cat):
    frame, scope = _scoped_source(q, cat)
    cols = frame.columns
    if q.where is not None:
        q.where = _resolve_qualified(q.where, scope, cols)
    if q.having is not None:
        q.having = _resolve_qualified(q.having, scope, cols)
    q.items = [_resolve_agg_cols(it, scope, cols) if isinstance(it, AggExpr)
               else it if isinstance(it, str)
               else _resolve_qualified(it, scope, cols) for it in q.items]
    q.group_by = [_resolve_name(k, scope, cols) if isinstance(k, str) else k
                  for k in q.group_by]
    q.order_by = [(_resolve_name(k, scope, cols) if isinstance(k, str)
                   else _resolve_qualified(k, scope, cols), a)
                  for k, a in q.order_by]
    if q.where is not None:
        # correlated EXISTS / IN as semi and anti joins
        q.where, corr_joins = _decorrelate_where(q.where, scope, cat)
        for right, keys, how in corr_joins:
            frame = frame.join(right, on=keys, how=how)
    if q.where is not None:
        q.where = _resolve_subqueries(q.where, cat)
    if q.having is not None:
        q.having = _resolve_subqueries(q.having, cat)
    q.items = [it if isinstance(it, (str, AggExpr))
               else _resolve_subqueries(it, cat) for it in q.items]
    if q.where is not None:
        frame = frame.filter(q.where)
        # stage boundary (sql/adaptive.py): when history says far fewer
        # rows survive than the slot count and a grouping, sort or
        # distinct follows, the survivors compact into a smaller bucket
        if config.aqe_enabled and isinstance(q.view, str) \
                and not q.joins \
                and (q.group_by or q.order_by or q.distinct
                     or any(isinstance(it, AggExpr) for it in q.items)):
            from ..utils import statstore as _statstore
            from . import adaptive as _adaptive

            skey = _filter_history_key(q, cat)
            if skey is not None:
                frame = _adaptive.maybe_rebucket(
                    frame, _statstore.STORE.est_rows(skey, frame.num_slots))
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
            grouped = (frame.rollup(*q.group_by) if q.group_mode == "rollup"
                       else frame.cube(*q.group_by)
                       if q.group_mode == "cube"
                       else frame.group_by(*q.group_by))
            frame = grouped.agg(*aggs, *component_aggs, *extra)
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


# ---------------------------------------------------------------------------
# The structural plan: plan_summary, PlanNode, plan_tree (EXPLAIN)
# ---------------------------------------------------------------------------

class _AnyColSchema(dict):
    """Optimistic column schema for the structural fused-stage check:
    every column resolves as a device column of unknown dtype (``p``), so
    the check keys on the expression's form only."""

    def get(self, key, default=None):  # noqa: ARG002 - dict signature
        return "p"


_OPTIMISTIC_SCHEMA = _AnyColSchema()


def _segment_lowerable_aggs(items) -> bool:
    """The ``SegmentedAggregate`` marker's test: every aggregate of the
    select list (post-aggregate items' components included) is one the
    grouped engine lowers (``segments.agg_lowerable``)."""
    from ..ops.segments import agg_lowerable

    found = False
    for it in items:
        aggs = (it.aggs if isinstance(it, PostAggItem)
                else [it] if isinstance(it, AggExpr) else [])
        for a in aggs:
            found = True
            if not agg_lowerable(a):
                return False
    return found


def plan_summary(q: Query) -> str:
    """``explain()``-style one-line plan for a parsed query — the operator
    chain root-first (the shape Spark's ``explain`` prints), attached to
    every ``sql.query`` span so traces show WHAT a query did, not just its
    text.

    When the pipeline is on (``spark.pipeline.enabled``, the default) and
    the WHERE predicate and every projection are *structurally*
    compilable, the Project+Filter pair of a non-aggregating query prints
    as ``FusedStage(Project[n] <- Filter)``: one cached plan. Structural
    means column dtypes are assumed numeric (the plan is summarized
    before execution binds the frame). ``ORDER BY`` prints as
    ``DeviceSort[n]`` and a plain ``GROUP BY`` whose aggregates the
    grouped engine lowers as ``SegmentedAggregate[groupBy:n]``, as in
    the JAX package with its grouped execution on (the port's only
    mode)."""
    chain = plan_tree(q).main_chain()
    s = " <- ".join(n.label for n in chain)
    if q.unions:
        s += f" (+{len(q.unions)} set-op)"
    if q.ctes:
        s = f"With[{len(q.ctes)}] " + s
    return s


def _structurally_fusable(q: Query) -> bool:
    """The FusedStage predicate — one definition for the plan-summary
    marker, the plan tree, and EXPLAIN (the pipeline compiler re-checks
    against real dtypes at flush time; see :func:`plan_summary`)."""
    from ..config import config as _cfg
    from ..ops.compiler import is_compilable

    aggregating = bool(q.group_by) or any(
        isinstance(it, (AggExpr, PostAggItem)) for it in q.items)
    return (_cfg.pipeline and q.where is not None and not aggregating
            and is_compilable(q.where, _OPTIMISTIC_SCHEMA)
            and all(isinstance(it, str)
                    or is_compilable(it, _OPTIMISTIC_SCHEMA)
                    or isinstance(it, E.Col)
                    for it in q.items))


def _structurally_segmented(q: Query) -> bool:
    return q.group_mode == "group" and _segment_lowerable_aggs(q.items)


class PlanNode:
    """One operator of the structural query plan — the per-operator node
    tree ``plan_summary``'s flat chain is derived from, and the carrier
    of EXPLAIN ANALYZE's measured stats (``stats`` stays empty on the
    un-executed ``plan_tree`` output; EXPLAIN adds ``est_rows``, ANALYZE
    the measured schema). ``children[0]`` is the operator's input; a
    Join's ``children[1]`` is the probe-side Scan. ``meta`` carries
    structural facts (the Scan's view name, the parsed query behind a
    filter or aggregate) and is never rendered."""

    __slots__ = ("op", "detail", "children", "stats", "meta")

    def __init__(self, op: str, detail: str = "", children=()):
        self.op = op
        self.detail = detail
        self.children = list(children)
        self.stats: dict = {}
        self.meta: dict = {}

    @property
    def label(self) -> str:
        return f"{self.op}{self.detail}"

    def walk(self):
        """Preorder traversal over every node."""
        yield self
        for c in self.children:
            yield from c.walk()

    def execution_order(self):
        """Nodes in the order the engine RUNS them (inputs before
        consumers) — the order their spans arrive in, which is what FIFO
        span attribution must follow (a root-first walk would hand the
        WHERE filter's span to the Having node). Postorder — which is
        already execution order for chains, Join probe sides, and SetOps
        union branches — except ``With``, whose CTEs (children[1:]) run
        BEFORE the main query (children[0])."""
        if self.op == "With":
            for c in self.children[1:]:
                yield from c.execution_order()
            if self.children:
                yield from self.children[0].execution_order()
            yield self
            return
        for c in self.children:
            yield from c.execution_order()
        yield self

    def main_chain(self) -> list:
        """Root-first operator chain down ``children[0]``, ending at the
        Scan — exactly the shape :func:`plan_summary` prints. (A Scan
        may carry a derived-table subquery plan as its child; the chain
        does not descend into it.)"""
        out, node = [], self
        while node is not None:
            out.append(node)
            node = (node.children[0]
                    if node.children and node.op != "Scan" else None)
        return out

    def render(self, analyze: bool = False) -> str:
        """Indented operator tree; any annotated stats (``est_rows`` on
        EXPLAIN, the full measured schema on ANALYZE) print as a logfmt
        suffix."""
        from ..utils.logging import format_kv

        lines: list[str] = []

        def emit(node, depth):
            pad = "" if depth == 0 else "   " * (depth - 1) + "+- "
            line = pad + node.label
            if node.stats:
                # unknowns render as "-" so every node shows the full
                # stat schema (format_kv would elide None)
                stats = {k: ("-" if node.stats[k] is None
                             else node.stats[k]) for k in node.stats}
                kv = format_kv(**stats)
                if kv:
                    line += f"  ({kv})"
            lines.append(line)
            for c in node.children:
                emit(c, depth + 1)

        emit(self, 0)
        return "\n".join(lines)


def plan_tree(q: Query) -> PlanNode:
    """Build the per-operator plan-node tree for a parsed query (the
    structural plan: built before execution binds the frame, so markers
    follow the same optimistic-dtype convention as ``plan_summary``)."""
    def scan_node(view):
        """Scan leaf; a derived table carries its subquery's plan as a
        child (outside the main chain) so EXPLAIN shows it and span
        attribution consumes the subquery's spans at the right point
        instead of handing them to outer same-named operators."""
        if isinstance(view, DerivedTable):
            return PlanNode("Scan", "[(subquery)]",
                            [plan_tree(view.query)])
        if isinstance(view, str):
            n = PlanNode("Scan", f"[{view}]")
            n.meta["view"] = view      # est-rows catalog lookup
            return n
        return PlanNode("Scan", "[(subquery)]")  # OneRowRelation et al.

    node = scan_node(q.view)
    hints = list(getattr(q, "join_build", ()) or ())
    hints += [None] * (len(q.joins) - len(hints))
    for (view, how, _keys, _alias), hint in zip(reversed(q.joins),
                                                reversed(hints)):
        how = how if isinstance(how, str) else "inner"
        detail = f"[{how},build={hint}]" if hint else f"[{how}]"
        node = PlanNode("Join", detail, [node, scan_node(view)])
    if _structurally_fusable(q):
        node = PlanNode("FusedStage",
                        f"(Project[{len(q.items)}] <- Filter)", [node])
        node.meta["query"] = q         # est-rows history lookup
    else:
        if q.where is not None:
            node = PlanNode("Filter", "", [node])
            node.meta["query"] = q     # est-rows history lookup
        node = PlanNode("Project", f"[{len(q.items)}]", [node])
    if q.group_by:
        mode = q.group_mode if q.group_mode != "group" else "groupBy"
        op = ("SegmentedAggregate" if _structurally_segmented(q)
              else "Aggregate")
        node = PlanNode(op, f"[{mode}:{len(q.group_by)}]", [node])
        node.meta["query"] = q         # cardinality-history lookup
    if q.having is not None:
        node = PlanNode("Having", "", [node])
    if q.distinct:
        node = PlanNode("Distinct", "", [node])
        node.meta["query"] = q         # cardinality-history lookup
    if q.order_by:
        node = PlanNode("DeviceSort", f"[{len(q.order_by)}]", [node])
    if q.offset:
        node = PlanNode("Offset", f"[{q.offset}]", [node])
        node.meta["offset"] = q.offset
    if q.limit is not None:
        node = PlanNode("Limit", f"[{q.limit}]", [node])
        node.meta["limit"] = q.limit
    return node


_EXPLAIN_RE = re.compile(r"^\s*explain(\s+analyze)?\b(.*)$",
                         re.IGNORECASE | re.DOTALL)

#: Plan-node op → the span names that measure it, most specific first.
#: ``frame.grouped.flush:<op>`` keys the grouped-engine flush spans by
#: their ``op`` attribute. Spans are consumed FIFO, so a query with two
#: joins attributes the first ``frame.join`` span to the first Join node.
_NODE_SPAN_CANDIDATES = {
    "FusedStage": ("frame.pipeline.flush", "frame.filter", "frame.select"),
    "ShardedStage": ("frame.pipeline.flush", "frame.filter",
                     "frame.select"),
    "Filter": ("frame.filter",),
    "Project": ("frame.select",),
    "Aggregate": ("frame.agg",),
    "SegmentedAggregate": ("frame.grouped.flush:group_by", "frame.agg"),
    "Having": ("frame.filter",),
    "Sort": ("frame.sort",),
    "DeviceSort": ("frame.sort", "frame.grouped.flush:sort"),
    "Distinct": ("frame.distinct", "frame.drop_duplicates",
                 "frame.grouped.flush:distinct"),
    "Join": ("frame.join",),
}

#: Nodes whose program (if any) is the pipeline compiler's — a deferred
#: filter/projection flushes OUTSIDE its own op span (at the next
#: materialization point), so the verdict may ride an unconsumed
#: ``frame.pipeline.flush`` span at query level. The predicate keys on
#: the flush span's shape: ``steps`` are with_column/filter steps (the
#: Filter node's program), ``outputs`` are fused select projections (the
#: Project node's program); FusedStage owns both.
_PIPELINE_NODE_PRED = {
    "FusedStage": lambda a: True,
    "ShardedStage": lambda a: True,
    "Filter": lambda a: a.get("steps", 0) > 0,
    "Project": lambda a: a.get("outputs", 0) > 0,
}

#: The acceptance contract: EVERY operator node carries these keys after
#: an ANALYZE pass (measured where a span matched, defaults otherwise).
_ANALYZE_DEFAULTS = (("rows_in", None), ("rows_out", None),
                     ("wall_ms", 0.0), ("compile", "none"),
                     ("host_syncs", 0), ("peak_mem", None))


def _annotate_plan(tree: PlanNode, qs) -> None:
    """Attribute one query's collected spans to plan-tree operators.

    ``qs`` is an ``observability.QueryStatsCollector`` whose window was
    exactly this query's execution. Attribution is name-based and FIFO
    (frame ops execute in plan order within one query); the compile-vs-
    cache-hit verdict comes from the operator's own flush span or the
    flush span nested directly under it. After the walk every node holds
    the full stat schema (:data:`_ANALYZE_DEFAULTS`)."""
    by_name: dict[str, list] = {}
    children_of: dict = {}
    for s in qs.spans:
        by_name.setdefault(s.name, []).append(s)
        children_of.setdefault(s.parent_id, []).append(s)
        if s.name == "frame.grouped.flush":
            by_name.setdefault(
                f"frame.grouped.flush:{s.attrs.get('op')}", []).append(s)

    def pop(name, pred=None):
        lst = by_name.get(name)
        for s in list(lst or ()):
            if pred is not None and not pred(s.attrs):
                continue
            for other in by_name.values():   # one span feeds ONE node
                if s in other:
                    other.remove(s)
            return s
        return None

    peak_attr = max((s.attrs.get("peak_mem", 0) for s in qs.spans),
                    default=0) or None
    # EXECUTION order, not render order: spans arrive input-side-first,
    # and FIFO queues must be consumed the same way (a root-first walk
    # would hand the WHERE filter's span to the Having node).
    for node in tree.execution_order():
        primary = None
        for name in _NODE_SPAN_CANDIDATES.get(node.op, ()):
            primary = pop(name)
            if primary is not None:
                break
        stats = node.stats
        if primary is not None:
            a = primary.attrs
            # cost-observatory join handles: the plan key (when the
            # span's program has one) addresses the CostProfile cache;
            # "measured" marks operators that actually ran (the roofline
            # `host` verdict's evidence). meta, never rendered.
            node.meta["measured"] = True
            if a.get("plan_key"):
                node.meta["plan_key"] = a["plan_key"]
            if "rows_in" in a:
                stats["rows_in"] = a.get("rows_in")
                stats["rows_out"] = a.get("rows_out")
            else:                 # a flush span: rows/groups vocabulary
                stats["rows_in"] = a.get("rows")
                stats["rows_out"] = a.get("groups", a.get("rows"))
            stats["wall_ms"] = round((primary.dur_us or 0) / 1e3, 3)
            stats["host_syncs"] = a.get("host_syncs", 0)
            if a.get("peak_mem") is not None:
                stats["peak_mem"] = a["peak_mem"]
            if a.get("lowering"):
                stats["lowering"] = a["lowering"]
            verdict = a.get("cache")
            if verdict is None:
                # the flush program ran nested under this op's span
                # (grouped sort/distinct on accelerators)
                for c in children_of.get(primary.sid, ()):
                    if c.name in ("frame.pipeline.flush",
                                  "frame.grouped.flush") \
                            and c.attrs.get("cache"):
                        verdict = c.attrs["cache"]
                        break
            pred = _PIPELINE_NODE_PRED.get(node.op)
            if verdict is None and pred is not None:
                # deferred pipeline steps flush at the next
                # materialization point, outside the op's own span
                flush = pop("frame.pipeline.flush", pred)
                if flush is not None:
                    verdict = flush.attrs.get("cache")
                    stats["flush_ms"] = round((flush.dur_us or 0) / 1e3, 3)
                    if flush.attrs.get("plan_key"):
                        node.meta["plan_key"] = flush.attrs["plan_key"]
            if verdict is not None:
                stats["compile"] = verdict
            for k, v in a.items():
                if k.startswith("recovery_"):
                    stats[k] = v
        for key, default in _ANALYZE_DEFAULTS:
            stats.setdefault(key, default)
        if stats["peak_mem"] is None:
            stats["peak_mem"] = peak_attr
    # Row counts flow along edges: an operator with no span of its own
    # (Scan, Limit, Offset) inherits its input's output count and its
    # consumer's input count — static shape info, never a device read.
    chain = tree.main_chain()
    for parent, child in zip(chain, chain[1:]):
        if child.stats.get("rows_out") is None \
                and parent.stats.get("rows_in") is not None:
            child.stats["rows_out"] = parent.stats["rows_in"]
        if parent.stats.get("rows_in") is None \
                and child.stats.get("rows_out") is not None:
            parent.stats["rows_in"] = child.stats["rows_out"]


def _filter_history_key(q, cat) -> Optional[str]:
    """The statstore selectivity key a flush of this query's WHERE would
    record under — computed from the parsed predicate plus the scanned
    view's REAL column dtypes (catalog lookup; zero execution, zero
    device reads). None when the view is unregistered, the predicate is
    not structurally compilable (those flushes run eager and record no
    history), or the query joins (the flush-time schema then carries
    joined columns this static walk cannot see)."""
    view = q.view if isinstance(q.view, str) else None
    if view is None or q.where is None or q.joins:
        return None
    try:
        frame = cat.lookup(view)
    except Exception:
        return None
    # Mirror the executor's name resolution (qualified ``t.x`` refs
    # rewrite to flat columns BEFORE the filter defers — the flush-time
    # history key is recorded against the RESOLVED predicate). Subquery
    # markers are deliberately NOT resolved here (that would execute
    # them); they fail the compilability walk below and yield None,
    # exactly like their flushes record nothing.
    where = q.where
    try:
        scope = {(q.view_alias or view).lower():
                 {c: c for c in frame.columns}}
        where = _resolve_qualified(where, scope, frame.columns)
    except Exception:
        return None
    from ..ops import compiler as C

    schema = C.LazySchema(frame._data_store, frame._pending_names())
    return C.selectivity_key_for((("filter", where),), schema)


def _annotate_est_rows(tree: PlanNode, cat) -> None:
    """History-informed cardinality column (``est_rows``): Scan rows are static slot counts, Filter/FusedStage apply the
    HISTORICAL selectivity recorded for the structurally-same filter
    stack (``utils.statstore``; persisted across sessions), and
    row-preserving operators propagate. Unknowns stay None and render as
    ``-``. Zero execution: catalog lookups + one ``_linearize`` walk per
    filter, never a device program (the deferred-observation drain is a
    host read of already-dispatched scalars). Never raises: estimation
    is advisory."""
    from ..utils import statstore as _stats

    try:
        _stats.STORE.drain_pending()
    except Exception:
        pass
    #: CTE-name -> estimated rows (filled from the With wrapper's CTE
    #: bodies BEFORE the main query annotates, so a Scan of a CTE name
    #: resolves history-informed cardinality instead of going "-")
    cte_est: dict[str, int] = {}

    def est(node) -> Optional[int]:
        try:
            child = est(node.children[0]) if node.children else None
        except RecursionError:   # pathological depth: stop annotating
            return None
        out: Optional[int] = None
        op = node.op
        if op == "Scan":
            view = node.meta.get("view")
            if isinstance(view, str):
                if view.lower() in cte_est:
                    out = cte_est[view.lower()]
                else:
                    try:
                        out = int(cat.lookup(view).num_slots)
                    except Exception:
                        out = None
            else:
                out = child      # derived table: its subquery's estimate
        elif op in ("FusedStage", "ShardedStage", "Filter"):
            q = node.meta.get("query")
            if child is not None and q is not None:
                skey = _filter_history_key(q, cat)
                if skey is not None:
                    sel = _stats.STORE.selectivity(skey)
                    if sel is not None:
                        out = int(round(sel * child))
        elif op in ("Project", "Sort", "DeviceSort", "Exchange"):
            out = child
        elif op == "Limit":
            lim = node.meta.get("limit")
            out = (min(child, int(lim)) if child is not None
                   and lim is not None else None)
        elif op == "Offset":
            off = node.meta.get("offset")
            out = (max(child - int(off), 0) if child is not None
                   and off is not None else None)
        elif op in ("Aggregate", "SegmentedAggregate", "Distinct"):
            # output-cardinality history: the grouped engine records
            # rows in -> groups out under a name+dtype key
            # (ops/segments.cardinality_history_key), whose ratio scales
            # the input estimate; unknown stays "-".
            q = node.meta.get("query")
            if child is not None and q is not None:
                ckey = _cardinality_history_key(q, cat,
                                                op == "Distinct")
                if ckey is not None:
                    sel = _stats.STORE.selectivity(ckey)
                    if sel is not None:
                        out = int(round(sel * child))
        # Join/SetOps output cardinality has no history key yet —
        # stays unknown rather than a guess. DDL and wrapper nodes
        # have no cardinality at all and stay unannotated.
        if op not in ("CreateView", "DropView", "With", "SetOps"):
            node.stats["est_rows"] = out
        # cardinality propagates along children[0], but side arms (a
        # Join's probe-side Scan) still deserve their own annotation —
        # the column must not silently disappear on the right arm
        for side in node.children[1:]:
            est(side)
        return out

    def annotate(node) -> Optional[int]:
        """Wrapper-aware walk: With annotates its CTE bodies first (in
        registration order — later CTEs may scan earlier ones) and
        propagates the main query's estimate onto the wrapper; SetOps
        annotates every branch and folds branch estimates through the
        operator chain (UNION sums — an upper bound under dedup —,
        INTERSECT takes the min, EXCEPT keeps the left bound)."""
        if node.op == "With":
            for name, sub in zip(node.meta.get("cte_names") or (),
                                 node.children[1:]):
                v = annotate(sub)
                if v is not None:
                    cte_est[str(name).lower()] = v
            out = annotate(node.children[0]) if node.children else None
            node.stats["est_rows"] = out
            return out
        if node.op == "SetOps":
            vals = [annotate(c) for c in node.children]
            out = vals[0] if vals else None
            for op, v in zip(node.meta.get("set_ops") or (), vals[1:]):
                if op in ("union", "union_all"):
                    out = out + v if out is not None and v is not None \
                        else None
                elif op == "intersect":
                    out = min(out, v) if out is not None and v is not None \
                        else None
                # except: the left branch bound stands
            node.stats["est_rows"] = out
            return out
        if node.op == "CreateView":
            for c in node.children:
                annotate(c)
            return None
        return est(node)

    try:
        annotate(tree)
    except Exception:
        pass


def _cardinality_history_key(q, cat, distinct: bool):
    """The statstore output-cardinality key a grouped/distinct flush of
    this query would record under (``ops/segments.
    cardinality_history_key`` — name+dtype addressed, zero execution).
    None when the view is unregistered, the query joins (the flush-time
    frame carries joined columns this static walk cannot see), or any
    key is not a plain resolvable column."""
    view = q.view if isinstance(q.view, str) else None
    if view is None or q.joins:
        return None
    try:
        frame = cat.lookup(view)
    except Exception:
        return None
    if distinct:
        names = []
        for it in q.items:
            # plain column projections only (str or a bare Col ref) —
            # computed items change the distinct key surface in ways
            # this static probe cannot mirror
            if isinstance(it, str) and it != "*":
                names.append(it)
            elif isinstance(it, E.Col):
                names.append(it.name)
            else:
                return None
        if not names:
            return None
    else:
        names = [k for k in q.group_by if isinstance(k, str)]
        if len(names) != len(q.group_by) or not names:
            return None
    arrs = [frame._data_store.get(n) for n in names]
    if any(a is None for a in arrs):
        return None
    from ..ops import segments as _segments

    return _segments.cardinality_history_key(
        "d" if distinct else "g", names, arrs)


def _annotate_costs(tree: PlanNode) -> None:
    """Cost columns (``utils/costprof.py``) for EXPLAIN ANALYZE: per
    operator node, the counted profile of the plan its flush span named
    (``est_flops``/``est_bytes``), the achieved rates at the node's
    measured wall (``gflops``/``gbps``; host-clock time on the CPU) and
    the roofline ``bound`` verdict (compute|memory|sync|host). Counting
    runs the plan's steps on small CPU tensors: no device work, no counted
    host read. A plan that cannot be counted leaves every column "-".
    Never raises: cost annotation is advisory."""
    from ..utils import costprof as _costprof

    try:
        # ONE batched resolution (one registry enumeration) for every
        # keyed node, then a second walk annotates
        profiles = _costprof.profiles_for(
            n.meta.get("plan_key") for n in tree.execution_order())
        for node in tree.execution_order():
            stats = node.stats
            if "wall_ms" not in stats:
                continue              # un-analyzed node (no stat schema)
            key = node.meta.get("plan_key")
            prof = profiles.get(key) if key else None
            wall = stats.get("flush_ms") or stats.get("wall_ms")
            gflops, gbps = _costprof.achieved(prof, wall)
            if prof is not None:
                bound = _costprof.roofline(
                    prof, int(stats.get("host_syncs") or 0))
            elif key:
                bound = None          # extraction degraded: render "-"
            elif node.meta.get("measured"):
                bound = "host"        # ran, but with no device program
            else:
                bound = None
            stats["est_flops"] = (None if prof is None
                                  else int(prof.flops))
            stats["est_bytes"] = (None if prof is None
                                  else int(prof.bytes_accessed))
            stats["gflops"] = gflops
            stats["gbps"] = gbps
            stats["bound"] = bound
    except Exception:
        pass


def _parse_explain_tree(body: str):
    """Parse an EXPLAIN'd statement into ``(plan_tree, kind, payload)``:
    ``("query", Query)`` for a SELECT statement, ``("create"|"drop",
    body)`` for the DDL forms (their child tree is the materializing
    query's plan)."""
    m = _DDL_RE.match(body)
    if m:
        name, inner = m.group(1), m.group(2)
        sub = _EXPLAIN_RE.match(inner)
        if sub:       # EXPLAIN CREATE VIEW v AS EXPLAIN ... is nonsense
            raise ValueError("nested EXPLAIN is not supported")
        tree = PlanNode("CreateView", f"[{name}]",
                        [plan_tree(parse(inner))])
        return tree, "create", body
    m = _DROP_RE.match(body)
    if m:
        return PlanNode("DropView", f"[{m.group(2)}]"), "drop", body
    q = parse(body)
    return _wrap_plan_tree(q), "query", q


def _wrap_plan_tree(q: Query) -> PlanNode:
    """Plan tree for a full statement: the main query's tree plus the
    With/SetOps wrapper nodes. ``meta`` carries the CTE names and the
    set-operator list so ``_annotate_est_rows`` can propagate
    cardinality through the wrappers (a Scan of a CTE name resolves
    against the CTE body's estimate, not the catalog)."""
    tree = plan_tree(q)
    if q.ctes:
        # children[0] = main query; children[1:] = the CTE bodies in
        # registration order (execution_order runs them first)
        tree = PlanNode("With", f"[{len(q.ctes)}]",
                        [tree] + [plan_tree(sub) for _name, sub in q.ctes])
        tree.meta["cte_names"] = [name for name, _sub in q.ctes]
    if q.unions:
        tree = PlanNode("SetOps", f"[+{len(q.unions)}]",
                        [tree] + [plan_tree(sub) for _op, sub in q.unions])
        tree.meta["set_ops"] = [op for op, _sub in q.unions]
    return tree


def _cache_lines(before: dict, after: dict) -> list[str]:
    """One line per cache (and per cached program) the query touched —
    the diff of two ``observability.cache_report()`` snapshots."""
    lines: list[str] = []
    for name, post in sorted(after.items()):
        pre = before.get(name, {})
        if not isinstance(post, dict) or not isinstance(pre, dict):
            continue
        deltas = {}
        for k in ("hits", "misses", "evictions", "fallbacks",
                  "dense_misses"):
            d = (post.get(k) or 0) - (pre.get(k) or 0)
            if d:
                deltas[k] = d
        if not deltas and post.get("entries") == pre.get("entries"):
            continue
        summary = " ".join(f"{k}+{v}" for k, v in deltas.items())
        lines.append(f"{name}: size={post.get('size', '?')}"
                     + (f" {summary}" if summary else ""))
        pre_entries = {e.get("key"): e for e in pre.get("entries") or ()}
        for e in post.get("entries") or ():
            p = pre_entries.get(e.get("key"), {})
            touched = any((e.get(k) or 0) > (p.get(k) or 0)
                          for k in ("hits", "compiles", "builds"))
            if not touched:
                continue
            # program_key duplicates key= (its un-truncated form): one
            # rendering is enough
            detail = {k: v for k, v in e.items()
                      if k not in ("key", "program_key")}
            from ..utils.logging import format_kv

            lines.append(f"  program {format_kv(**detail)} key="
                         f"{e.get('key', '')!r}")
    return lines


def _execute_explain(body: str, cat, analyze: bool):
    """Run an ``EXPLAIN [ANALYZE]`` statement. EXPLAIN renders the
    structural plan tree WITHOUT executing (no flush, no device work:
    parsing, catalog metadata and statstore history only); EXPLAIN
    ANALYZE executes the statement under a per-query stats collector
    (``observability.query_stats``) and annotates every operator with
    measured rows, wall ms, compile/hit verdicts, host reads and peak
    device bytes, plus the ``== Query Stats ==``, ``== Caches ==`` and
    ``== Adaptive ==`` sections. Returns a one-row frame with the plan
    text in a ``plan`` column (Spark's ``EXPLAIN`` result shape).

    ANALYZE of a query that evaluates a registered DQ rule adds the
    ``== Data Quality ==`` section (``utils/dqprof.py``); a query without
    one renders as it did. The output is the JAX package's under
    ``spark.audit.enabled=false``: its ``est peak`` column and budget line
    (``analysis/program/static_mem.py``) are not ported yet."""
    import time as _time

    import torch

    from ..config import config as _cfg
    from ..frame.frame import Frame
    from ..utils.logging import format_kv
    from . import adaptive as _adaptive

    tree, kind, payload = _parse_explain_tree(body)
    # the optimizer's rewrite of the parsed query, exactly as execution
    # would make it (no execution), and the before/after diff; ANALYZE
    # runs the rewritten query, so the annotated tree is the plan that ran
    opt_rewrites: list[str] = []
    before_text: Optional[str] = None
    if kind == "query" and _cfg.optimizer_enabled:
        from . import optimizer as _optimizer

        q_opt, rewrites = _optimizer.optimize_or_fallback(payload, cat)
        if rewrites:
            before_text = tree.render()
            tree = _wrap_plan_tree(q_opt)
            payload = q_opt
            opt_rewrites.extend(str(r) for r in rewrites)
    _obs.current_span().set(
        plan=("ExplainAnalyze" if analyze else "Explain"))
    # history-informed est_rows, annotated BEFORE any execution
    if _cfg.stats_enabled:
        _annotate_est_rows(tree, cat)

    def _opt_sections() -> list[str]:
        out: list[str] = []
        if opt_rewrites:
            out.append("== Rewrites ==")
            out.extend(opt_rewrites)
        if before_text is not None:
            out.append("== Before Optimization ==")
            out.append(before_text)
        return out

    if not analyze:
        text = "== Physical Plan ==\n" + tree.render()
        for ln in _opt_sections():
            text += "\n" + ln
        return Frame({"plan": [text]})

    caches_before = _obs.cache_report() if _cfg.explain_caches else {}
    # the observatory's rule marks (one flag read when it is off): the
    # drain before execution is this cold surface's own counted read,
    # outside the query's stats window
    dq_marks = None
    if _cfg.dq_profile_enabled:
        from ..utils import dqprof as _dqprof

        dq_marks = _dqprof.rule_marks()
    # any mid-query re-plan (sql/adaptive.py) records an event here and
    # renders as the == Adaptive == section
    with _adaptive.capture() as aqe_events, \
            _obs.query_stats(sample_memory=_cfg.explain_memory) as qs:
        t0 = _time.perf_counter()
        if kind == "query":
            out = _run_parsed(payload, cat)
        else:
            out = _execute_statement(payload, cat)
        # honest wall clock: flush what is pending and wait for the card
        mask = out._mask
        if mask.is_cuda:
            torch.cuda.synchronize(mask.device)
        wall_ms = (_time.perf_counter() - t0) * 1e3
    _annotate_plan(tree, qs)
    if _cfg.costprof_enabled:
        _annotate_costs(tree)
    top = tree.main_chain()[0]
    if top.stats.get("rows_out") is None:
        top.stats["rows_out"] = out.num_slots
    if _cfg.stats_enabled:
        # the query's valid rows (one mask reduction, outside the stats
        # window) against the pre-query est_rows
        rows_valid = int(out.count())
        top.stats["rows_valid"] = rows_valid
        est = top.stats.get("est_rows")
        if est is not None:
            top.stats["est_drift"] = (
                f"x{est / rows_valid:.2f}" if rows_valid
                else f"+{est}")
        from ..utils import statstore as _statstore

        _statstore.STORE.absorb_query_stats(qs)
    delta = qs.counter_delta()
    lines = ["== Analyzed Plan ==", tree.render(analyze=True),
             "== Query Stats =="]
    totals = {
        "wall_ms": round(wall_ms, 3),
        "rows_out": out.num_slots,
        "host_syncs": delta.get("frame.host_sync", 0),
        "compiles": (delta.get("pipeline.compile", 0)
                     + delta.get("grouped.compile", 0)),
        "cache_hits": (delta.get("pipeline.hit", 0)
                       + delta.get("grouped.hit", 0)),
        "fallbacks": (delta.get("pipeline.fallback", 0)
                      + delta.get("grouped.fallback", 0)),
        "recovery_events": sum(v for k, v in delta.items()
                               if k.startswith("recovery.")
                               and "." not in k[len("recovery."):]),
    }
    if _cfg.explain_memory:
        from ..utils import meminfo as _meminfo

        totals["live_bytes"] = _meminfo.sample()
        totals["peak_bytes"] = _meminfo.peak_bytes()
    lines.append(format_kv(**totals))
    if _cfg.explain_caches:
        cl = _cache_lines(caches_before, _obs.cache_report())
        if cl:
            lines.append("== Caches ==")
            lines.extend(cl)
    lines.extend(_opt_sections())
    if aqe_events:
        lines.append("== Adaptive ==")
        lines.extend(_adaptive.render(aqe_events))
    if dq_marks is not None:
        from ..utils import dqprof as _dqprof

        lines.extend(_dqprof.explain_lines(dq_marks))
    return Frame({"plan": ["\n".join(lines)]})


def _maybe_optimize(q: Query, cat):
    """Cost-based rewrite hook (``sql/optimizer.py``), gated on
    ``spark.optimizer.enabled``: one flag read when disabled. Any
    optimizer failure degrades to the unrewritten plan inside
    ``optimize_or_fallback``."""
    from ..config import config as _cfg

    if not _cfg.optimizer_enabled or getattr(q, "_optimized", False):
        return q
    from . import optimizer as _optimizer

    q2, _rewrites = _optimizer.optimize_or_fallback(q, cat)
    return q2


def _run_parsed(q: Query, cat):
    """Execute an already-parsed query: CTE overlay + set expression.
    Each CTE body and the main set expression pass through the
    cost-based optimizer first (CTE frames are registered in the overlay
    before the main query optimizes, so its relation metadata resolves
    CTE names like any view)."""
    if q.ctes:
        cat = _OverlayCatalog(cat)
        for name, sub in q.ctes:
            # Later CTEs may reference earlier ones (executed in order).
            cat.register(name, _execute_set(_maybe_optimize(sub, cat),
                                            cat))
    return _execute_set(_maybe_optimize(q, cat), cat)
