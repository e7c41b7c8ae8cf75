"""The SQL subset of the torch port (a small part of
``sparkdq4ml_tpu/sql/parser.py``)::

    SELECT item [, item ...] FROM view [WHERE predicate]

An item is a column or ``cast(x AS int|double)``, optionally aliased (with
or without ``AS``). A predicate combines comparisons
(``< <= > >= = == != <>``) of columns, casts and numeric literals with
AND, OR, NOT and parentheses. Any other grammar raises
``NotImplementedError`` naming what it met.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional

from ..ops import expressions as E

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|<>|!=|==|[<>=(),])
  | (?P<other>.)
""", re.VERBOSE)

_KEYWORDS = {"select", "from", "where", "as", "cast", "and", "or", "not",
             "true", "false"}
# Reserved words of the full grammar: never read as a column or an alias.
_RESERVED = {"all", "any", "between", "by", "case", "cross", "delete",
             "distinct", "else", "end", "except", "exists", "full", "group",
             "having", "in", "inner", "insert", "intersect", "is", "join",
             "left", "like", "limit", "null", "offset", "on", "order",
             "outer", "right", "set", "then", "union", "update", "values",
             "when", "with"}
_CMP = {"<": "<", "<=": "<=", ">": ">", ">=": ">=", "=": "==", "==": "==",
        "!=": "!=", "<>": "!="}


class _Token(NamedTuple):
    kind: str  # "num", "ident", "kw", "reserved", "op", "other", "eof"
    value: str


def tokenize(sql: str) -> list[_Token]:
    out = []
    for m in _TOKEN.finditer(sql):
        kind, value = m.lastgroup, m.group()
        if kind == "ws":
            continue
        if kind == "ident" and value.lower() in _KEYWORDS:
            kind, value = "kw", value.lower()
        elif kind == "ident" and value.lower() in _RESERVED:
            kind = "reserved"
        out.append(_Token(kind, value))
    out.append(_Token("eof", ""))
    return out


def _unsupported(tok: _Token, where: str):
    text = tok.value if tok.kind != "eof" else "end of query"
    return NotImplementedError(
        f"{text!r} {where} is not in the torch port's SQL subset "
        "(SELECT item[, item...] FROM view [WHERE predicate])")


class Query(NamedTuple):
    items: list
    view: str
    where: Optional[E.Expr]


class _Parser:
    def __init__(self, tokens: list[_Token]):
        self.toks = tokens
        self.pos = 0

    def peek(self) -> _Token:
        return self.toks[self.pos]

    def next(self) -> _Token:
        tok = self.toks[self.pos]
        self.pos += 1
        return tok

    def accept(self, kind: str, value: Optional[str] = None) -> bool:
        tok = self.peek()
        if tok.kind == kind and (value is None or tok.value == value):
            self.pos += 1
            return True
        return False

    def expect(self, kind: str, value: str, where: str) -> None:
        if not self.accept(kind, value):
            raise _unsupported(self.peek(), where)

    def ident(self, where: str) -> str:
        tok = self.next()
        if tok.kind != "ident":
            raise _unsupported(tok, where)
        return tok.value

    def query(self) -> Query:
        self.expect("kw", "select", "at the start")
        items = [self.item()]
        while self.accept("op", ","):
            items.append(self.item())
        self.expect("kw", "from", "after the select list")
        view = self.ident("as the FROM relation")
        where = self.predicate() if self.accept("kw", "where") else None
        if self.peek().kind != "eof":
            raise _unsupported(self.peek(), "after the query")
        return Query(items, view, where)

    def item(self) -> E.Expr:
        expr = self.operand("in the select list")
        if isinstance(expr, E.Lit):
            raise NotImplementedError(
                "a literal in the select list is not in the torch port's "
                "SQL subset")
        if self.accept("kw", "as") or self.peek().kind == "ident":
            expr = E.Alias(expr, self.ident("as an alias"))
        return expr

    def predicate(self) -> E.Expr:
        left = self.conjunction()
        while self.accept("kw", "or"):
            left = E.BinOp("|", left, self.conjunction())
        return left

    def conjunction(self) -> E.Expr:
        left = self.negation()
        while self.accept("kw", "and"):
            left = E.BinOp("&", left, self.negation())
        return left

    def negation(self) -> E.Expr:
        if self.accept("kw", "not"):
            return E.Not(self.negation())
        return self.comparison()

    def comparison(self) -> E.Expr:
        if self.accept("op", "("):
            inner = self.predicate()
            self.expect("op", ")", "to close a parenthesis")
            left = inner
        else:
            left = self.operand("in the WHERE clause")
        tok = self.peek()
        if tok.kind == "op" and tok.value in _CMP:
            self.pos += 1
            return E.BinOp(_CMP[tok.value], left,
                           self.operand("in a comparison"))
        return left

    def operand(self, where: str) -> E.Expr:
        tok = self.next()
        if tok.kind == "num":
            return E.Lit(float(tok.value) if "." in tok.value
                         else int(tok.value))
        if tok.kind == "kw" and tok.value in ("true", "false"):
            return E.Lit(tok.value == "true")
        if tok.kind == "kw" and tok.value == "cast":
            self.expect("op", "(", "after CAST")
            child = self.operand("inside CAST")
            self.expect("kw", "as", "inside CAST")
            type_name = self.ident("as a CAST type")
            if type_name.lower() not in ("int", "integer", "double"):
                raise NotImplementedError(
                    f"CAST to {type_name!r} is not in the torch port's SQL "
                    "subset (int, double)")
            self.expect("op", ")", "to close CAST")
            return E.Cast(child, type_name)
        if tok.kind == "ident":
            if self.peek() == _Token("op", "("):
                raise NotImplementedError(
                    f"function call {tok.value}(...) is not in the torch "
                    "port's SQL subset")
            return E.Col(tok.value)
        raise _unsupported(tok, where)


def parse(sql: str) -> Query:
    return _Parser(tokenize(sql)).query()


def execute(sql: str, catalog=None):
    """Run one query of the subset against the catalog's temp views."""
    from .catalog import default_catalog

    q = parse(sql)
    frame = (catalog if catalog is not None
             else default_catalog()).lookup(q.view)
    if q.where is not None:
        frame = frame.filter(q.where)
    return frame.select(*q.items)
