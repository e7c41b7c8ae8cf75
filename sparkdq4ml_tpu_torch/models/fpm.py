"""Frequent pattern mining of the port (port of
``sparkdq4ml_tpu/models/fpm.py``): ``FPGrowth`` with its model (frequent
itemsets, single-consequent association rules, ``transform``,
persistence) and ``PrefixSpan``.

Both are host algorithms, as in the JAX package: transactions and
sequences are lists of strings in host object columns, and the FP-tree
recursion and PrefixSpan's pseudo-projection run in Python on the host.
The output order, counts, confidence, lift and support are the JAX
package's: the code is the same but for the FP-growth recursion, which
reads each item's conditional base through an index of the transactions
that hold it instead of scanning them all, orders each transaction's
items once a level instead of once a base, and keeps equal transactions
once with their counts summed (integer sums, so the supports are the
same). The only device value they read is the frame's validity mask (one
copy). The model's itemset and rule frames are host results, on the CPU;
PrefixSpan's patterns come back on the device of the frame it was given.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..frame.frame import Frame
from .base import Estimator, Model, persistable
from .text import _obj_array


def _mine(transactions, counts, min_count, suffix, out):
    """Recursive FP-growth over conditional pattern bases. Each item's base
    is read from the transactions that hold it (an index built in the
    counting pass), each transaction ordered once, and equal transactions
    of a base are kept once with their counts summed: the JAX package's
    bases, with the same integer counts, so the same itemsets and
    supports."""
    freq = defaultdict(int)
    holders = defaultdict(list)
    for k, (t, c) in enumerate(zip(transactions, counts)):
        for item in t:
            freq[item] += c
            holders[item].append(k)
    items = {i: f for i, f in freq.items() if f >= min_count}
    rank = {i: r for r, i in enumerate(sorted(items,
                                              key=lambda i: (-items[i], i)))}
    # each transaction's frequent items in (-frequency, item) order, once:
    # an item's base is then a filter of these
    ranked = [tuple(sorted((i for i in t if i in rank),
                           key=rank.__getitem__)) for t in transactions]
    # least-frequent-first mining order (ties alphabetical for determinism)
    for item in sorted(items, key=lambda i: (items[i], i)):
        new_suffix = suffix + (item,)
        out[frozenset(new_suffix)] = items[item]
        # conditional pattern base for `item`
        base: dict = {}
        for k in holders[item]:
            kept = tuple(i for i in ranked[k] if i != item)
            if kept:
                base[kept] = base.get(kept, 0) + counts[k]
        if base:
            _mine(list(base), list(base.values()), min_count, new_suffix,
                  out)


@persistable
class FPGrowth(Estimator):
    """MLlib ``FPGrowth`` setter surface: setItemsCol/setMinSupport/
    setMinConfidence/setPredictionCol + ``fit(frame)``."""

    _persist_attrs = ('min_support', 'min_confidence', 'items_col',
                      'prediction_col')

    def __init__(self, min_support: float = 0.3,
                 min_confidence: float = 0.8, items_col: str = "items",
                 prediction_col: str = "prediction"):
        if not 0.0 < min_support <= 1.0:
            raise ValueError("min_support must be in (0, 1]")
        if not 0.0 <= min_confidence <= 1.0:
            raise ValueError("min_confidence must be in [0, 1]")
        self.min_support = float(min_support)
        self.min_confidence = float(min_confidence)
        self.items_col = items_col
        self.prediction_col = prediction_col

    def set_min_support(self, v):
        if not 0.0 < v <= 1.0:
            raise ValueError("min_support must be in (0, 1]")
        self.min_support = float(v)
        return self

    def set_min_confidence(self, v):
        if not 0.0 <= v <= 1.0:
            raise ValueError("min_confidence must be in [0, 1]")
        self.min_confidence = float(v)
        return self

    def set_items_col(self, v):
        self.items_col = v
        return self

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    setMinSupport = set_min_support
    setMinConfidence = set_min_confidence
    setItemsCol = set_items_col
    setPredictionCol = set_prediction_col

    def fit(self, frame) -> "FPGrowthModel":
        col = frame._column_values(self.items_col)
        if not (isinstance(col, np.ndarray) and col.dtype == object):
            raise ValueError(f"column {self.items_col!r} must hold item "
                             "lists")
        mask = frame.mask.cpu().numpy()
        # MLlib: duplicate items within one transaction are an error;
        # we dedupe like most FPM implementations and document it
        txns = [tuple(dict.fromkeys(t)) for t, m in zip(col, mask)
                if m and t is not None and len(t)]
        n = len(txns)
        if n == 0:
            raise ValueError("FPGrowth: no valid transactions")
        min_count = max(1, int(np.ceil(self.min_support * n)))

        # first pass: global frequencies; filter + order transactions
        freq = defaultdict(int)
        for t in txns:
            for item in t:
                freq[item] += 1
        kept = {i: f for i, f in freq.items() if f >= min_count}
        ordered: dict = {}             # equal transactions kept once
        for t in txns:
            kt = tuple(sorted((i for i in t if i in kept),
                              key=lambda i: (-kept[i], i)))
            if kt:
                ordered[kt] = ordered.get(kt, 0) + 1

        itemsets: dict = {}
        _mine(list(ordered), list(ordered.values()), min_count, (),
              itemsets)
        return FPGrowthModel(
            [(sorted(s), int(c)) for s, c in sorted(
                itemsets.items(), key=lambda kv: (len(kv[0]),
                                                  sorted(kv[0])))],
            n, self.min_confidence,
            {"items_col": self.items_col,
             "prediction_col": self.prediction_col})


@persistable
class FPGrowthModel(Model):
    """Frequent itemsets + single-consequent association rules (MLlib's
    rule shape); ``transform`` predicts the union of fired consequents."""

    _persist_attrs = ('itemsets', 'num_transactions', 'min_confidence',
                      '_params')

    def __init__(self, itemsets, num_transactions, min_confidence,
                 params=None):
        # itemsets: list of (sorted item list, count)
        self.itemsets = [(list(s), int(c)) for s, c in itemsets]
        self.num_transactions = int(num_transactions)
        self.min_confidence = float(min_confidence)
        self._params = dict(params or {})
        self._build_rules()

    def _post_load(self):
        self.itemsets = [(list(s), int(c)) for s, c in self.itemsets]
        self._build_rules()

    def _build_rules(self):
        lookup = {frozenset(s): c for s, c in self.itemsets}
        self._rules = []
        n = max(self.num_transactions, 1)
        for s, c in self.itemsets:
            if len(s) < 2:
                continue
            fs = frozenset(s)
            for consequent in s:
                ante = fs - {consequent}
                ante_count = lookup.get(ante)
                if not ante_count:
                    continue
                conf = c / ante_count
                if conf >= self.min_confidence:
                    cons_count = lookup.get(frozenset([consequent]), 0)
                    lift = conf / (cons_count / n) if cons_count else np.nan
                    self._rules.append(
                        (sorted(ante), consequent, conf, lift, c / n))

    @property
    def freq_itemsets(self):
        return Frame({
            "items": _obj_array([s for s, _ in self.itemsets]),
            "freq": np.asarray([c for _, c in self.itemsets], np.int64)},
            device="cpu")

    freqItemsets = freq_itemsets

    @property
    def association_rules(self):
        return Frame({
            "antecedent": _obj_array([a for a, *_ in self._rules]),
            "consequent": _obj_array([[c] for _, c, *_ in self._rules]),
            "confidence": np.asarray([r[2] for r in self._rules]),
            "lift": np.asarray([r[3] for r in self._rules]),
            "support": np.asarray([r[4] for r in self._rules])},
            device="cpu")

    associationRules = association_rules

    def transform(self, frame):
        col = frame._column_values(self._p("items_col", "items"))
        out = []
        for t in col:
            if t is None:
                out.append(None)
                continue
            have = set(t)
            fired = []
            for ante, consequent, *_ in self._rules:
                if consequent not in have and set(ante) <= have \
                        and consequent not in fired:
                    fired.append(consequent)
            out.append(sorted(fired))
        return frame.with_column(self._p("prediction_col", "prediction"),
                                 _obj_array(out))

    def _p(self, k, default=None):
        return self._params.get(k, default)


# --- PrefixSpan ---------------------------------------------------------------
#
# MLlib ``PrefixSpan`` (mllib.fpm.PrefixSpan in the Spark 2.4 dependency,
# pom.xml:29-32; the ml-level findFrequentSequentialPatterns API landed in
# 3.0 — this class exposes that surface over the 2.4 algorithm). Sequential
# patterns over itemset sequences are host-resident string/object data by
# the framework's boundary rule (same as FPGrowth above); the classic
# pseudo-projection recursion runs on the host.


def _first_occurrence(seq, start_i, last_itemset, item, itemset_ext):
    """Earliest projection point for extending a pattern at itemset
    ``start_i`` (the current match position) with ``item``.

    ``itemset_ext``: the item joins the pattern's last itemset, so the
    matching itemset (searched from ``start_i`` on) must contain
    ``last_itemset + (item,)``. Sequence extension: ``item`` opens a new
    itemset strictly after ``start_i``. Returns (i, j) with j = offset
    just past ``item``, or None.
    """
    if itemset_ext:
        for i in range(start_i, len(seq)):
            s = seq[i]
            if item in s and all(x in s for x in last_itemset):
                return i, s.index(item) + 1
        return None
    for i in range(start_i + 1, len(seq)):
        s = seq[i]
        if item in s:
            return i, s.index(item) + 1
    return None


class PrefixSpan:
    """Sequential pattern mining (PrefixSpan, Pei et al. — the algorithm
    MLlib implements). ``find_frequent_sequential_patterns(frame)`` returns
    a Frame with ``sequence`` (list of itemsets) and ``freq`` columns,
    MLlib's output schema.

    A sequence is a list of itemsets; itemsets are unordered (stored
    sorted). Pattern growth uses canonical extensions — a new item either
    starts a new itemset ("sequence extension") or joins the last itemset
    with items greater than its current maximum ("itemset extension") —
    with pseudo-projection (first minimal occurrence) per sequence, which
    keeps support counting exact.
    """

    def __init__(self, min_support: float = 0.1,
                 max_pattern_length: int = 10,
                 max_local_proj_db_size: int = 32000000,
                 sequence_col: str = "sequence"):
        if not (0.0 <= min_support <= 1.0):
            raise ValueError("min_support must be in [0, 1]")
        if max_pattern_length < 1:
            raise ValueError("max_pattern_length must be >= 1")
        self.min_support = float(min_support)
        self.max_pattern_length = int(max_pattern_length)
        # accepted for API parity; a single host mines the whole projected
        # DB, so the mllib local/distributed split point is meaningless here
        self.max_local_proj_db_size = int(max_local_proj_db_size)
        self.sequence_col = sequence_col

    def set_min_support(self, v):
        if not (0.0 <= v <= 1.0):
            raise ValueError("min_support must be in [0, 1]")
        self.min_support = float(v)
        return self

    setMinSupport = set_min_support

    def set_max_pattern_length(self, v):
        if v < 1:
            raise ValueError("max_pattern_length must be >= 1")
        self.max_pattern_length = int(v)
        return self

    setMaxPatternLength = set_max_pattern_length

    def set_max_local_proj_db_size(self, v):
        self.max_local_proj_db_size = int(v)
        return self

    setMaxLocalProjDBSize = set_max_local_proj_db_size

    def set_sequence_col(self, v):
        self.sequence_col = v
        return self

    setSequenceCol = set_sequence_col

    def find_frequent_sequential_patterns(self, frame):
        import math

        raw = frame._column_values(self.sequence_col)
        valid = frame.mask.cpu().numpy()
        seqs = []
        for s, ok in zip(raw, valid):
            if not ok or s is None:           # masked slots never vote
                continue
            seqs.append(tuple(tuple(sorted(set(itemset))) for itemset in s))
        n = len(seqs)
        if n == 0:
            return _ps_result([], [], frame.device)
        min_count = max(1, int(math.ceil(self.min_support * n)))
        max_len = self.max_pattern_length

        results = []

        def mine(pattern, pattern_items, projections):
            """``projections``: list of (seq_idx, i, j) — pattern's last
            itemset matched inside itemset ``i`` ending at offset ``j``."""
            if pattern_items >= max_len:
                return
            last = pattern[-1] if pattern else ()
            last_max = last[-1] if last else None
            # candidate support: each sequence votes once per (kind, item)
            counts = defaultdict(int)
            for (si, i, j) in projections:
                seq = seqs[si]
                seen = set()
                if last:
                    # itemset extensions: suffix of the matched itemset,
                    # or any later itemset containing last ∪ {x}
                    for x in seq[i][j:]:
                        seen.add((True, x))
                    for i2 in range(i + 1, len(seq)):
                        s2 = seq[i2]
                        if all(y in s2 for y in last):
                            for x in s2:
                                if x > last_max:
                                    seen.add((True, x))
                for i2 in range(i + 1, len(seq)):
                    for x in seq[i2]:
                        seen.add((False, x))
                for c in seen:
                    counts[c] += 1

            for (is_ext, item), c in sorted(
                    counts.items(), key=lambda kv: (kv[0][0], kv[0][1])):
                if c < min_count:
                    continue
                new_pattern = (pattern[:-1] + [last + (item,)] if is_ext
                               else pattern + [(item,)])
                proj = []
                for (si, i, j) in projections:
                    seq = seqs[si]
                    if is_ext:
                        # at the matched itemset the pattern's last itemset
                        # already holds; item must appear at/after offset j
                        if item in seq[i][j:]:
                            proj.append((si, i, seq[i].index(item) + 1))
                            continue
                        hit = _first_occurrence(seq, i + 1, last, item, True)
                    else:
                        hit = _first_occurrence(seq, i, (), item, False)
                    if hit is not None:
                        proj.append((si, hit[0], hit[1]))
                results.append(([list(p) for p in new_pattern], c))
                mine(new_pattern, pattern_items + 1, proj)

        # Root projections seed at a virtual itemset −1 so the sequence-
        # extension scans (which start at i+1) see itemset 0.
        mine([], 0, [(si, -1, 0) for si in range(n)])
        patterns = [r[0] for r in results]
        freqs = [r[1] for r in results]
        return _ps_result(patterns, freqs, frame.device)

    findFrequentSequentialPatterns = find_frequent_sequential_patterns


def _ps_result(patterns, freqs, device):
    return Frame({
        "sequence": _obj_array(patterns),
        "freq": np.asarray(freqs, np.int64),
    }, device=device)
