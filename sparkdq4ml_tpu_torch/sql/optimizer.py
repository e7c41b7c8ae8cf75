"""Cost-based plan optimizer: statstore-driven rewrites over the parsed
``Query`` (the port of ``sparkdq4ml_tpu/sql/optimizer.py``, single
device).

``optimize`` rewrites a parsed :class:`~.parser.Query` before it runs,
from static catalog metadata (column lists, slot counts: never a device
read) and the statstore's persisted history, so the same walk serves
plain ``EXPLAIN``'s zero-execution before/after diff. Every rewrite shows
as a line of EXPLAIN's ``== Rewrites ==`` section:

* **predicate pushdown** (level >= 1): a WHERE conjunct that references
  exactly one relation of a join moves into a derived table around that
  relation, so the join's host plan sees only the surviving rows. The
  join-type gates keep null extension exact: a push into the base side
  needs every join to keep the right side's row identity (inner, left,
  semi, anti, cross); a joined relation takes pushes only under an inner
  or cross join with no later right or outer join. Emission order is
  untouched.
* **column pruning** (level >= 1): the relations of a join keep only the
  columns the query references plus every join key, so the join gathers
  (one ``index_select`` a column) only what the query can observe. A name
  on two sides keeps its column everywhere (the ``_right`` renames stay
  as they were); an expression outside the analyzable subset (subqueries,
  window functions) turns pruning off for the query.
* **join reordering** (level >= 2): consecutive INNER joins run smallest
  estimated first (statstore selectivity of the pushed filters x slot
  count; cold history falls back to slot counts). Gated to plans whose
  row multiset is provably kept and in which nothing observes input order
  (no LIMIT/OFFSET, non-key names unique); the physical row order may
  change, so it is opt-in.
* **build-side selection** (level >= 1): an inner join whose accumulated
  left side is estimated at most half the right side carries a
  ``build=left`` hint; ``Frame.join`` then sorts the small side and
  re-canonicalizes the pairs, bit-identical to the default plan.

Two cost decisions live at the lowering layer, where the plan's shape is
known: the stage split and the planned memory chunking of
``ops/compiler.run_pipeline``, and the grouped engine's dense skip in
``ops/segments.grouped_agg``; they share this module's conf gates.

Degradation: any failure inside :func:`optimize_or_fallback` runs the
unrewritten plan and counts ``optimizer.fallback``; the optimizer can
slow a query, never change or lose it. The JAX package's ``optimizer``
fault site and its ``recovery.fallback`` event come with the port's
``utils/faults.py`` and ``utils/recovery.py``.

Conf: ``spark.optimizer.enabled`` (default true) and
``spark.optimizer.level`` (default 1; 2 adds join reordering and the
stage split). Disabled, a query pays one flag read.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..config import config
from ..ops import expressions as E
from ..utils.profiling import counters

logger = logging.getLogger("sparkdq4ml_tpu_torch.sql.optimizer")

#: Join types under which filtering the ACCUMULATED LEFT side before the
#: join equals filtering after it: the join must never null-extend left
#: columns (right/outer joins append unmatched right rows whose left
#: columns are NaN — a pushed predicate would keep them, the post-join
#: filter would drop them).
_SAFE_LEFT = ("inner", "left", "left_semi", "left_anti", "cross")

#: Build-side hysteresis: hint ``build=left`` only when the accumulated
#: left estimate is under half the right side — the canonicalizing pair
#: sort costs O(P log P), so a marginal size gap must not flip the plan.
_BUILD_RATIO = 2


class Rewrite:
    """One applied rewrite — the EXPLAIN ``== Rewrites ==`` line."""

    __slots__ = ("rule", "detail")

    def __init__(self, rule: str, detail: str):
        self.rule = rule
        self.detail = detail

    def __str__(self):
        return f"{self.rule}: {self.detail}"


def enabled() -> bool:
    return bool(config.optimizer_enabled)


# ---------------------------------------------------------------------------
# Static expression analysis (whitelist walk — anything outside the
# known subset disables the rewrite that needed it, never guesses)
# ---------------------------------------------------------------------------

def _walk(expr, refs: set, shadow: frozenset = frozenset()) -> bool:
    """Collect every column name ``expr`` references into ``refs``;
    returns False when the tree contains any node outside the
    statically-analyzable subset (subquery placeholders, window
    expressions, generators) — callers must then skip the rewrite."""
    if isinstance(expr, E.Col):
        if expr.name not in shadow:
            refs.add(expr.name)
        return True
    if isinstance(expr, E.Lit):
        return True
    if isinstance(expr, E.Alias):
        return _walk(expr.child, refs, shadow)
    if isinstance(expr, E.BinOp):
        return (_walk(expr.left, refs, shadow)
                and _walk(expr.right, refs, shadow))
    if isinstance(expr, (E.Neg, E.Not, E.IsNull)):
        return _walk(expr.child, refs, shadow)
    if isinstance(expr, E.Cast):
        return _walk(expr.child, refs, shadow)
    if isinstance(expr, E.InList):
        return (_walk(expr.child, refs, shadow)
                and all(_walk(v, refs, shadow) for v in expr.values))
    if isinstance(expr, E.CaseWhen):
        return (all(_walk(c, refs, shadow) and _walk(v, refs, shadow)
                    for c, v in expr.branches)
                and (expr.otherwise_expr is None
                     or _walk(expr.otherwise_expr, refs, shadow)))
    if isinstance(expr, E.StringMatch):
        return _walk(expr.child, refs, shadow)
    if isinstance(expr, (E.UdfCall, E.Func)):
        return all(_walk(a, refs, shadow) for a in expr.args)
    if isinstance(expr, E.SortOrder):
        return _walk(expr.child, refs, shadow)
    if isinstance(expr, E.HigherOrder):
        # lambda params shadow outer columns inside the body
        inner = shadow | frozenset(expr.lam.params)
        ok = _walk(expr.source, refs, shadow) and _walk(
            expr.lam.body, refs, inner)
        if expr.init is not None:
            ok = ok and _walk(expr.init, refs, shadow)
        if expr.finish is not None:
            ok = ok and _walk(expr.finish.body, refs,
                              shadow | frozenset(expr.finish.params))
        return ok
    # ScalarSubquery / SubqueryIn / SubqueryExists / _AggRef / window
    # expressions / anything future: not statically analyzable here
    return False


def _agg_refs(agg, refs: set) -> bool:
    from ..frame.aggregates import AggExpr, AggOfExpr

    if isinstance(agg, AggOfExpr):
        return _walk(agg.expr, refs)
    if isinstance(agg, AggExpr):
        if agg.column is not None:
            refs.add(agg.column)
        if agg.column2 is not None:
            refs.add(agg.column2)
        return True
    return False


def _item_refs(item, refs: set) -> bool:
    """Column references of one select item; False = not analyzable."""
    from ..frame.aggregates import AggExpr
    from .parser import PostAggItem

    if isinstance(item, str):
        return item != "*"
    if isinstance(item, PostAggItem):
        return (_walk(item.expr, refs)
                and all(_agg_refs(a, refs) for a in item.aggs))
    if isinstance(item, AggExpr):
        return _agg_refs(item, refs)
    if isinstance(item, E.Expr):
        return _walk(item, refs)
    return False


# ---------------------------------------------------------------------------
# Relation model
# ---------------------------------------------------------------------------

class _Rel:
    """One FROM/JOIN relation: ``idx`` -1 = the base relation, >= 0 =
    ``q.joins[idx]``. ``bind`` is the scope name qualified refs resolve
    against (the alias, else the view name)."""

    __slots__ = ("idx", "view", "bind", "cols", "how", "keys", "pushed",
                 "keep")

    def __init__(self, idx, view, bind, cols, how=None, keys=()):
        self.idx = idx
        self.view = view
        self.bind = bind
        self.cols = cols              # list[str] | None (unknown)
        self.how = how
        self.keys = list(keys)
        self.pushed: list = []        # conjuncts moved into this scan
        self.keep: Optional[list] = None   # pruned column list


def _view_columns(view, cat) -> Optional[list]:
    """Static column list of a plain-view relation (None for derived
    tables and unregistered names). Uses ``Frame.columns`` — pending
    names included, NO flush, no device read."""
    if not isinstance(view, str):
        return None
    try:
        return list(cat.lookup(view).columns)
    except Exception:
        return None


def _relations(q, cat) -> Optional[list]:
    """The query's relation table, base first; None when the shape is
    outside the rewriter's reach (FROM-less, duplicate binding names)."""
    from .parser import DerivedTable

    if q.view is None:
        return None
    rels: list[_Rel] = []
    if isinstance(q.view, str):
        bind = (q.view_alias or q.view).lower()
        rels.append(_Rel(-1, q.view, bind, _view_columns(q.view, cat)))
    elif isinstance(q.view, DerivedTable):
        bind = (q.view.alias or "").lower()
        rels.append(_Rel(-1, q.view, bind, None))
    else:
        return None
    for i, (view, how, keys, alias) in enumerate(q.joins):
        bind = (alias or (view if isinstance(view, str) else "")).lower()
        rels.append(_Rel(i, view, bind,
                         _view_columns(view, cat), how, keys))
    binds = [r.bind for r in rels if r.bind]
    if len(binds) != len(set(binds)):
        return None                   # ambiguous scope: stay literal
    return rels


def _resolve_ref(name: str, rels: list) -> Optional[_Rel]:
    """The relation a column reference binds to, mirroring the
    executor's resolution: a literal column of that (dotted) name wins
    first, then ``alias.col`` against the relation scope, then the
    first relation carrying the plain name. None = unresolvable (an
    aggregate-output or select-alias reference, or an unknown alias)."""
    if "(" in name:
        return None
    for r in rels:
        if r.cols is not None and name in r.cols:
            return r
    if "." in name:
        alias = name.partition(".")[0].lower()
        for r in rels:
            if r.bind == alias:
                return r
    return None


def _strip_qualifier(expr, rel: _Rel):
    """Rewrite ``alias.col`` references bound to ``rel`` into plain
    ``col`` names valid inside the relation's own scan scope."""
    from .parser import _map_cols

    cols = rel.cols or ()

    def fn(name: str) -> str:
        if "." not in name or "(" in name or name in cols:
            return name
        alias, _, col = name.partition(".")
        return col if alias.lower() == rel.bind else name

    return _map_cols(expr, fn)


def _pushable(rel: _Rel, rels: list) -> bool:
    """Whether a single-relation conjunct may move into ``rel``'s scan
    (see module docstring for the join-type gates)."""
    if rel.cols is None or not isinstance(rel.view, str):
        return False
    joins = [r for r in rels if r.idx >= 0]
    if rel.idx < 0:
        return all(r.how in _SAFE_LEFT for r in joins)
    if rel.how not in ("inner", "cross"):
        return False
    return all(r.how in _SAFE_LEFT for r in joins if r.idx > rel.idx)


# ---------------------------------------------------------------------------
# Cost model (statstore-informed, static fallback)
# ---------------------------------------------------------------------------

def _rel_sel_key(rel: _Rel, cat) -> Optional[str]:
    """The filter-structural statstore key for a relation's pushed
    filter stack — the address both the selectivity estimate and the
    flop-cost term read. None when nothing was pushed."""
    if not rel.pushed:
        return None
    from .parser import Query, _conjoin, _filter_history_key

    probe = Query(["*"], rel.view,
                  _conjoin([_strip_qualifier(c, rel) for c in rel.pushed]))
    return _filter_history_key(probe, cat)


def _est_rel_rows(rel: _Rel, cat) -> Optional[int]:
    """History-informed output-row estimate for one relation AFTER its
    pushed filters: the statstore selectivity recorded for the same
    filter structure (the key EXPLAIN's ``est_rows`` uses) x the view's
    static slot count; cold history falls back to static slots. Zero
    execution: a catalog lookup + one ``_linearize`` walk."""
    if rel.cols is None or not isinstance(rel.view, str):
        return None
    try:
        slots = int(cat.lookup(rel.view).num_slots)
    except Exception:
        return None
    if not rel.pushed:
        return slots
    from ..utils import statstore as _stats

    skey = _rel_sel_key(rel, cat)
    sel = _stats.STORE.selectivity(skey) if skey is not None else None
    if sel is None:
        return slots
    return int(round(sel * slots))


def _est_rel_flops(rel: _Rel, cat) -> Optional[float]:
    """The recorded cost profile's flop count for the relation's pushed
    filter program (the largest recorded at the same filter-structural
    key the selectivity estimate uses). None when cold or nothing was
    pushed: the reorder's flop term is then zero and the ranking is by
    rows alone."""
    if rel.cols is None or not isinstance(rel.view, str):
        return None
    from ..utils import statstore as _stats

    return _stats.STORE.flops_for_selectivity(_rel_sel_key(rel, cat))


# ---------------------------------------------------------------------------
# The rewrite passes
# ---------------------------------------------------------------------------

def _split_where(q, rels: list, rewrites: list) -> Optional[object]:
    """Predicate pushdown: assign single-relation conjuncts to their
    relation's ``pushed`` list; returns the residual WHERE."""
    from .parser import _conjoin, _conjuncts

    if q.where is None or not q.joins:
        return q.where
    keep = []
    pushed_any = False
    for c in _conjuncts(q.where):
        refs: set = set()
        if not _walk(c, refs) or not refs:
            keep.append(c)
            continue
        targets = [_resolve_ref(name, rels) for name in refs]
        if any(t is None for t in targets) \
                or len({id(t) for t in targets}) != 1:
            keep.append(c)
            continue
        rel = targets[0]
        if not _pushable(rel, rels):
            keep.append(c)
            continue
        rel.pushed.append(c)
        pushed_any = True
        rewrites.append(Rewrite(
            "pushdown", f"{c} -> Scan[{rel.view}]"))
    return _conjoin(keep) if pushed_any else q.where


def _needed_columns(q, rels: list, residual_where) -> bool:
    """Column pruning analysis: fill each relation's ``keep`` list with
    the columns the query can observe (+ every join key). Returns False
    — and leaves every ``keep`` None — when any referenced expression
    is outside the analyzable subset or any reference is ambiguous."""
    refs: set = set()
    for it in q.items:
        if isinstance(it, str) and it == "*":
            return False
        if not _item_refs(it, refs):
            return False
    for part in (residual_where, q.having):
        if part is not None and not _walk(part, refs):
            return False
    for key in q.group_by:
        if isinstance(key, str):
            refs.add(key)
        elif not isinstance(key, int) and not _walk(key, refs):
            return False
    for key, _asc in q.order_by:
        if isinstance(key, str):
            refs.add(key)
        elif not isinstance(key, int) and not _walk(key, refs):
            return False
    # pushed conjuncts filter INSIDE the wrapped scan, before its
    # projection — their references need no keep slot; join keys do.
    all_keys = {k for r in rels for k in r.keys}
    needed = {r.idx: set() for r in rels}
    for name in refs:
        if "(" in name:
            continue                  # aggregate-output reference
        literal_hit = any(r.cols is not None and name in r.cols
                          for r in rels)
        if "." in name and not literal_hit:
            alias, _, col = name.partition(".")
            rel = next((r for r in rels if r.bind == alias.lower()), None)
            if rel is None:
                return False          # unknown alias: stay literal
            # keep the column on EVERY relation carrying it, not just
            # the bound one: pruning a collision twin would un-fire the
            # ``_right`` rename and change the output column NAME
            for r in rels:
                if r.cols is not None and col in r.cols:
                    needed[r.idx].add(col)
            needed[rel.idx].add(col)
            continue
        base = name
        if name.endswith("_right") and not literal_hit:
            base = name[: -len("_right")]
        for r in rels:
            if r.cols is not None and base in r.cols:
                needed[r.idx].add(base)
        # an unmatched plain name is a select-alias or pending-column
        # reference — not a scan column, nothing to keep
    for r in rels:
        if r.cols is None or not isinstance(r.view, str):
            continue
        keep = [c for c in r.cols if c in needed[r.idx] or c in all_keys]
        if keep and len(keep) < len(r.cols):
            r.keep = keep
    return True


#: Relative weight of the flop-cost term in the join-reorder ranking:
#: with profiles present, a relation's rank is its row estimate scaled
#: by up to 1 + _FLOP_WEIGHT depending on how its filter-program flops
#: compare to the heaviest candidate's. Row estimates stay dominant —
#: the flop term only breaks near-ties toward the cheaper scan.
_FLOP_WEIGHT = 0.5


def _maybe_reorder(q, rels: list, ests: dict, flops: dict,
                   rewrites: list) -> Optional[list]:
    """Join reordering (level >= 2): greedy smallest-cost-first over
    INNER joins, honoring key availability — cost is the row estimate
    scaled by the relation's recorded filter-program flops (the recorded
    cost profiles) when any candidate has one, rows alone otherwise.
    Returns the new join order (indices into ``q.joins``) or None. Gated
    to shapes where the output row multiset is provably preserved and
    nothing downstream observes physical order (no LIMIT/OFFSET) and the
    ``_right``-suffix structure cannot change (non-key column names
    unique across relations)."""
    joins = [r for r in rels if r.idx >= 0]
    if len(joins) < 2 or q.limit is not None or getattr(q, "offset", 0):
        return None
    if any(r.how != "inner" or not r.keys or r.cols is None
           or not isinstance(r.view, str) for r in joins):
        return None
    base = rels[0]
    if base.cols is None:
        return None
    all_keys = {k for r in joins for k in r.keys}
    seen: dict[str, int] = {}
    for r in rels:
        for c in r.cols:
            if c in all_keys:
                continue
            if c in seen:
                return None           # cross-relation collision
            seen[c] = r.idx
    if any(ests.get(r.idx) is None for r in joins):
        return None
    fmax = max((flops.get(r.idx) or 0.0) for r in joins)

    def _rank(r: _Rel) -> float:
        rows = float(ests[r.idx])
        if fmax <= 0.0:
            return rows
        return rows * (1.0 + _FLOP_WEIGHT * (flops.get(r.idx) or 0.0)
                       / fmax)

    available = set(base.cols)
    order: list[int] = []
    remaining = list(joins)
    while remaining:
        cands = [r for r in remaining if set(r.keys) <= available]
        if not cands:
            return None
        pick = min(cands, key=_rank)
        order.append(pick.idx)
        available |= set(pick.cols)
        remaining.remove(pick)
    if order == [r.idx for r in joins]:
        return None
    rewrites.append(Rewrite(
        "join-reorder",
        ", ".join(f"{rels[i + 1].view}~{ests[i]}r" for i in order)
        + (" (smallest rows x flop cost first)" if fmax > 0.0
           else " (smallest estimate first)")))
    return order


def _wrap(rel: _Rel):
    """Materialize a relation's pushed filters / pruned projection as a
    derived-table wrapper (an existing, fully-tested executor path)."""
    from .parser import DerivedTable, Query, _conjoin

    if not rel.pushed and rel.keep is None:
        return None
    items = ([E.Col(c) for c in rel.keep]
             if rel.keep is not None else ["*"])
    where = (_conjoin([_strip_qualifier(c, rel) for c in rel.pushed])
             if rel.pushed else None)
    return DerivedTable(Query(items, rel.view, where), rel.bind)


def _clone(q):
    """Shallow Query copy — the rewritten plan must never mutate the
    parse result (EXPLAIN renders the original as the 'before' tree)."""
    from .parser import Query

    q2 = Query(list(q.items), q.view, q.where, list(q.group_by),
               list(q.order_by), q.limit, list(q.joins),
               distinct=q.distinct, having=q.having, offset=q.offset)
    q2.unions = list(q.unions)
    q2.group_mode = q.group_mode
    q2.view_alias = q.view_alias
    q2.ctes = list(q.ctes)
    return q2


def _optimize_single(q, cat, rewrites: list):
    """Optimize ONE SELECT (no set-op handling); returns a rewritten
    shallow copy, or ``q`` itself when nothing applies."""
    from .parser import DerivedTable

    rels = _relations(q, cat)
    # recurse into derived tables first (their inner queries are full
    # SELECTs); CTE bodies are optimized by the executor at registration
    new_view = q.view
    if isinstance(q.view, DerivedTable):
        inner = _optimize_single(q.view.query, cat, rewrites)
        if inner is not q.view.query:
            new_view = DerivedTable(inner, q.view.alias)
    new_joins = list(q.joins)
    for i, (view, how, keys, alias) in enumerate(new_joins):
        if isinstance(view, DerivedTable):
            inner = _optimize_single(view.query, cat, rewrites)
            if inner is not view.query:
                new_joins[i] = (DerivedTable(inner, view.alias), how,
                                keys, alias)
    changed = new_view is not q.view or new_joins != list(q.joins)

    where = q.where
    order = None
    hints: list = []
    join_ests: list = []
    if rels is not None:
        n_rw = len(rewrites)
        where = _split_where(q, rels, rewrites)
        if q.joins:
            # pruning pays at the join boundary (one device gather per
            # materialized column); a single-relation query's unused
            # columns are never touched by the flush anyway
            _needed_columns(q, rels, where)
        ests = {r.idx: _est_rel_rows(r, cat) for r in rels}
        if int(config.optimizer_level) >= 2:
            flops = {r.idx: _est_rel_flops(r, cat) for r in rels}
            order = _maybe_reorder(q, rels, ests, flops, rewrites)
        # build-side hints over the FINAL join order; the per-join
        # (left, right) estimate pairs ride along as ``join_est`` — the
        # drift baseline the adaptive hooks (sql/adaptive.py) compare
        # observed counts against at run time
        joined = ([next(r for r in rels if r.idx == i) for i in order]
                  if order is not None
                  else [r for r in rels if r.idx >= 0])
        left_est = ests.get(-1)
        for r in joined:
            hint = None
            right_est = ests.get(r.idx)
            join_ests.append((left_est, right_est))
            if (r.how == "inner" and r.keys and left_est is not None
                    and right_est is not None
                    and left_est * _BUILD_RATIO <= right_est):
                hint = "left"
                rewrites.append(Rewrite(
                    "build-side",
                    f"Join[{r.view}] build=left "
                    f"(est {left_est} vs {right_est} rows)"))
            hints.append(hint)
            if left_est is not None and right_est is not None:
                left_est = max(left_est, right_est)
            else:
                left_est = None
        for r in rels:
            if r.keep is not None:
                rewrites.append(Rewrite(
                    "prune",
                    f"Scan[{r.view}] keeps {len(r.keep)}/"
                    f"{len(r.cols)} cols ({', '.join(r.keep)})"))
        # apply wrappers in the final order
        base_wrap = _wrap(rels[0])
        if base_wrap is not None:
            new_view = base_wrap
        joins_out = []
        for r in joined:
            # new_joins, not q.joins: a joined derived table's entry may
            # already hold its recursively optimized inner query
            view, how, keys, alias = new_joins[r.idx]
            w = _wrap(r)
            if w is not None:
                joins_out.append((w, how, keys, r.bind or alias))
            else:
                joins_out.append((view, how, keys, alias))
        if joins_out:
            new_joins = joins_out
        changed = (changed or len(rewrites) > n_rw
                   or where is not q.where)
    has_ests = any(e is not None
                   for pair in join_ests for e in pair)
    if not changed:
        if has_ests:
            # advisory only — never affects planning or EXPLAIN, just
            # gives the runtime hooks a drift baseline
            q.join_est = join_ests
        return q
    q2 = _clone(q)
    q2.view = new_view
    q2.where = where
    q2.joins = new_joins
    if isinstance(new_view, DerivedTable) and new_view is not q.view:
        q2.view_alias = None
    if any(hints):
        q2.join_build = hints
    if has_ests:
        q2.join_est = join_ests
    return q2


def optimize(q, cat):
    """Rewrite a parsed query (and its set-operation branches) for
    execution; returns ``(query, rewrites)``. Pure planning: static
    catalog metadata + statstore history, zero execution — callers
    wanting the degradation ladder use :func:`optimize_or_fallback`."""
    rewrites: list[Rewrite] = []
    q2 = _optimize_single(q, cat, rewrites)
    if q.unions:
        new_unions = []
        changed = False
        for op, sub in q.unions:
            sub2 = _optimize_single(sub, cat, rewrites)
            changed = changed or sub2 is not sub
            new_unions.append((op, sub2))
        if changed:
            if q2 is q:
                q2 = _clone(q)
            q2.unions = new_unions
    q2._optimized = True
    if rewrites:
        counters.increment("optimizer.rewrite", len(rewrites))
    return q2, rewrites


def optimize_or_fallback(q, cat):
    """The production entry: :func:`optimize` behind the ``optimizer``
    fault site and the unrewritten-plan degradation. Returns ``(query,
    rewrites)``; on any failure the original query and no rewrite,
    counted ``optimizer.fallback`` with a recovery event: the optimizer
    can slow a query, never change or lose it."""
    if not config.optimizer_enabled or getattr(q, "_optimized", False):
        return q, []
    from ..utils import faults as _faults

    try:
        _faults.inject("optimizer")
        return optimize(q, cat)
    except Exception as e:
        from ..utils.recovery import RECOVERY_LOG

        counters.increment("optimizer.fallback")
        RECOVERY_LOG.record(
            "optimizer", "fallback", rung="unrewritten",
            cause=f"{type(e).__name__}: {e}",
            detail="query runs its literal parse shape")
        logger.debug("optimizer degraded to the unrewritten plan",
                     exc_info=True)
        return q, []
