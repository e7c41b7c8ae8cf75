"""Data-quality observatory: column profiles, rule violation rates and
drift (the port of ``sparkdq4ml_tpu/utils/dqprof.py``).

* **Column profiles** (:class:`ColumnProfile`): count, nulls (NaN under
  the mask), min/max, mean and M2, and a fixed-bucket histogram over a
  log-compressed domain. A flush's columns are sketched by ONE call of the
  ``dq_sketch`` kernel (``ops/kernels.py``), whose raw vector a column is
  ``[count, nulls, sum, sumsq, min, max] + hist``; host profiles merge by
  Chan's formula, so per-flush increments and persisted snapshots are one
  algebra.
* **Rule accounting**: each registered DQ rule a flush produces, and each
  eager evaluation of one (``ops/expressions.UdfCall``), tallies
  ``[rows, passed]`` (a rule output > 0 passes; NaN fails) through the same
  kernel.
* **Drift**: PSI of the cumulative histogram against a pinned baseline
  (``spark.dq.baselineMode``); past ``spark.dq.driftThreshold`` the breach
  sets the ``dq.drift.<column>`` gauge (always set) and tags the current
  span. (The JAX package also captures an incident bundle there when its
  incident recorder is on; the recorder is not ported, which is the JAX
  package's behavior with ``spark.incident.*`` unset.)

The hot path only enqueues the kernel's device output; the one batched,
counted host read (``dq.drain_sync``) happens on the cold surfaces:
:func:`report`, EXPLAIN ANALYZE. ``spark.dq.profile.enabled=false`` makes
every hook one flag read. The ``dq_profile`` fault site fires at the
sketch's dispatch; a device fault there, injected or real, degrades
that flush to unprofiled (``dq.profile_failed`` and a recovery event),
never the flush, while a kernel that fails to build or launch raises.
Profiles persist in the statstore under ``dqprof|<column>`` keys.

The histogram samples rows 0, step, 2 step, ... with ``step = ceil(bucket
/ HIST_SAMPLE)`` of the flush's row bucket (``compiler.bucket_size``), the
rows the JAX package samples from its padded arrays. Sums are kept in
float64 on the card (the JAX package sums in float32).
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Optional

import torch

from ..config import config
from .profiling import counters

logger = logging.getLogger("sparkdq4ml_tpu_torch.dqprof")

#: Profile-document version; a snapshot of another version is ignored.
PROFILE_VERSION = 1

#: Columns profiled a flush (a name-sorted prefix).
MAX_COLS = 16

#: Bound on not-yet-drained observations: past it the oldest drops
#: (``dq.pending_dropped``).
MAX_PENDING = 4096

#: Histogram domain clip in transform space, t = sign(x)·log10(1+|x|).
TMAX = 12.0

#: Leading moment slots of a sketch vector: count, nulls, sum, sumsq,
#: min, max.
MOMENTS = 6

#: Rows of a bucket the histogram takes whole; past it a stride sample,
#: scaled back up by the stride.
HIST_SAMPLE = 4096

#: PSI pseudo-count a bucket.
EPS = 1e-4

#: A drain whose failure rate for a rule reaches this, over at least
#: SPIKE_MIN_ROWS rows, is a violation spike.
VIOLATION_SPIKE_RATE = 0.5
SPIKE_MIN_ROWS = 8


class ColumnProfile:
    """One column's running profile: raw moments from the device, kept on
    the host as Welford mean and M2 so :meth:`merge` is exact and
    associative."""

    __slots__ = ("count", "nulls", "mean", "m2", "min", "max", "hist")

    def __init__(self, count=0, nulls=0, mean=0.0, m2=0.0,
                 min=None, max=None, hist=None):
        self.count = int(count)
        self.nulls = int(nulls)
        self.mean = float(mean)
        self.m2 = float(m2)
        self.min = None if min is None else float(min)
        self.max = None if max is None else float(max)
        self.hist = [int(c) for c in (hist or [])]

    @classmethod
    def from_raw(cls, raw) -> Optional["ColumnProfile"]:
        """A profile from one sketch vector (``[count, nulls, sum, sumsq,
        min, max, hist...]``); None for a malformed one."""
        arr = [float(v) for v in raw]
        if len(arr) < MOMENTS:
            return None
        count = int(round(arr[0]))
        nulls = int(round(arr[1]))
        if count > 0:
            mean = arr[2] / count
            m2 = max(arr[3] - arr[2] ** 2 / count, 0.0)
            mn, mx = arr[4], arr[5]
        else:
            mean, m2, mn, mx = 0.0, 0.0, None, None
        hist = [int(round(c)) for c in arr[MOMENTS:]]
        return cls(count=count, nulls=nulls, mean=mean, m2=m2,
                   min=mn, max=mx, hist=hist)

    @property
    def variance(self) -> Optional[float]:
        """Sample variance (None below two observations)."""
        return self.m2 / (self.count - 1) if self.count > 1 else None

    def merge(self, other: "ColumnProfile") -> None:
        """Chan's parallel mean/M2 merge."""
        n1, n2 = self.count, other.count
        if n2 > 0:
            if n1 == 0:
                self.mean, self.m2 = other.mean, other.m2
            else:
                n = n1 + n2
                delta = other.mean - self.mean
                self.mean += delta * n2 / n
                self.m2 += other.m2 + delta * delta * n1 * n2 / n
            self.count = n1 + n2
        self.nulls += other.nulls
        for mine, theirs, pick in (("min", other.min, min),
                                   ("max", other.max, max)):
            cur = getattr(self, mine)
            if theirs is not None:
                setattr(self, mine,
                        theirs if cur is None else pick(cur, theirs))
        if len(self.hist) == len(other.hist):
            self.hist = [a + b for a, b in zip(self.hist, other.hist)]
        elif n2 > n1:
            # a histogramBins change mid-history: the heavier side wins
            self.hist = list(other.hist)

    def copy(self) -> "ColumnProfile":
        return ColumnProfile(count=self.count, nulls=self.nulls,
                             mean=self.mean, m2=self.m2, min=self.min,
                             max=self.max, hist=self.hist)

    def to_doc(self) -> dict:
        return {"version": PROFILE_VERSION, "count": self.count,
                "nulls": self.nulls, "mean": self.mean, "m2": self.m2,
                "min": self.min, "max": self.max,
                "hist": list(self.hist)}

    @classmethod
    def from_doc(cls, doc) -> Optional["ColumnProfile"]:
        """None for a document of another version or a malformed one."""
        if not isinstance(doc, dict) \
                or int(doc.get("version", 0)) != PROFILE_VERSION:
            return None
        try:
            return cls(count=doc.get("count", 0),
                       nulls=doc.get("nulls", 0),
                       mean=doc.get("mean", 0.0), m2=doc.get("m2", 0.0),
                       min=doc.get("min"), max=doc.get("max"),
                       hist=doc.get("hist"))
        except (TypeError, ValueError):
            return None


def histogram_edges(bins: int) -> list:
    """The ``bins + 1`` bucket edges in data space."""
    out = []
    for i in range(int(bins) + 1):
        t = -TMAX + (2.0 * TMAX) * i / int(bins)
        out.append(math.copysign(10.0 ** abs(t) - 1.0, t))
    return out


def drift_score(baseline: Optional[ColumnProfile],
                current: Optional[ColumnProfile]) -> Optional[float]:
    """Population-stability index of two histograms; None when either is
    empty or their buckets differ."""
    if baseline is None or current is None:
        return None
    if baseline.count <= 0 or current.count <= 0:
        return None
    if not baseline.hist or len(baseline.hist) != len(current.hist):
        return None
    te = float(sum(baseline.hist)) + EPS * len(baseline.hist)
    ta = float(sum(current.hist)) + EPS * len(current.hist)
    score = 0.0
    for e, a in zip(baseline.hist, current.hist):
        pe = (e + EPS) / te
        pa = (a + EPS) / ta
        score += (pa - pe) * math.log(pa / pe)
    return round(score, 6)


# ---------------------------------------------------------------------------
# Deferred observations and the host state
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
#: ("col" | "rule", name, host rows, device vector) awaiting one batched
#: host read.
_PENDING: list = []
_PROFILES: dict = {}     # column -> ColumnProfile (cumulative)
_BASELINES: dict = {}    # column -> pinned ColumnProfile
_NO_BASELINE = object()  # a pin was tried and its mode gave none
_RULES: dict = {}        # rule -> {"evals", "rows", "violations"}
_DRIFT: dict = {}        # column -> latest PSI


def enabled() -> bool:
    return bool(config.dq_profile_enabled)


def clear() -> None:
    """Drop every profile, baseline, tally and pending observation."""
    with _LOCK:
        _PENDING.clear()
        _PROFILES.clear()
        _BASELINES.clear()
        _RULES.clear()
        _DRIFT.clear()


def _profilable(v, n: Optional[int]) -> bool:
    """A numeric 1-D tensor of ``n`` rows (any length when None); string
    columns and vectors are skipped."""
    if not isinstance(v, torch.Tensor) or v.ndim != 1:
        return False
    if n is not None and v.shape[0] != n:
        return False
    return not v.is_complex()


def _enqueue(entries) -> None:
    dropped = 0
    with _LOCK:
        _PENDING.extend(entries)
        while len(_PENDING) > MAX_PENDING:
            _PENDING.pop(0)
            dropped += 1
    if dropped:
        counters.increment("dq.pending_dropped", dropped)


#: The device faults that leave a flush unprofiled (the ``dq_profile``
#: rung): an injected fault is a ``torch.AcceleratorError``. A sticky CUDA
#: error (an illegal address) leaves the context unusable, and the next
#: read of the card raises it again.
_DEVICE_ERRORS = (torch.AcceleratorError, torch.OutOfMemoryError)


def _unprofiled(e: BaseException, detail: str) -> None:
    """The ``dq_profile`` rung taken: a recovery event (rung
    ``unprofiled``) and ``dq.profile_failed``."""
    from .recovery import RECOVERY_LOG

    counters.increment("dq.profile_failed")
    RECOVERY_LOG.record("dq_profile", "fallback", rung="unprofiled",
                        cause=f"{type(e).__name__}: {e}", detail=detail)


def hist_step(bucket: int) -> int:
    """The histogram's stride at a flush's row bucket."""
    return max(1, -(-int(bucket) // HIST_SAMPLE))


def observe_flush(changed, new_mask, n: int, bucket: int, rules=(),
                  mask_in=None) -> None:
    """The flush hook (``ops/compiler.run_pipeline``, behind one
    ``spark.dq.profile.enabled`` read): one ``dq_sketch`` call over the
    flush's profiled output columns (under its output mask) and its rule
    columns (under its input mask, since the flush's own filter has
    dropped the violations from the output mask), its output enqueued for
    a later drain. No host read here.

    The ``dq_profile`` fault site: a device fault, injected or real
    (``torch.AcceleratorError``, ``torch.OutOfMemoryError``), leaves this
    flush unprofiled with a counted recovery event. A kernel that fails to
    build or to launch, and a bad argument, raise."""
    if not enabled():
        return
    from ..ops import kernels
    from . import faults as _faults

    try:
        _faults.inject("dq_profile")
        if int(bucket) <= 0:
            return
        names = []
        for name in sorted(changed):
            if len(names) >= MAX_COLS:
                break
            if _profilable(changed[name], n):
                names.append(name)
        rule_cols = []
        if mask_in is not None:
            for rule_name, col_name in rules:
                v = changed.get(col_name)
                if v is not None and _profilable(v, n) \
                        and len(rule_cols) < kernels.SKETCH_MAX_COLS:
                    rule_cols.append((rule_name, v))
        if not names and not rule_cols:
            return
        bins = max(int(config.dq_histogram_bins), 1)
        out = kernels.dq_sketch([changed[k] for k in names], new_mask,
                                [v for _, v in rule_cols], mask_in,
                                bins=bins, step=hist_step(bucket))
        stride = MOMENTS + bins
        entries = [("col", str(name), 0, out[i * stride:(i + 1) * stride])
                   for i, name in enumerate(names)]
        base = len(names) * stride
        entries += [("rule", str(rule_name), 0,
                     out[base + 2 * j:base + 2 * j + 2])
                    for j, (rule_name, _) in enumerate(rule_cols)]
        counters.increment("dq.sketches", len(entries))
        _enqueue(entries)
    except _DEVICE_ERRORS as e:
        _unprofiled(e, "dq sketch dispatch degraded; this flush reports "
                       "no profile")


def record_eval(rule: str, out) -> None:
    """The tally of one eager evaluation of a registered rule
    (``ops/expressions.UdfCall``, behind one flag read): ``[rows,
    passed]`` over every row of its output, from the ``dq_sketch``
    kernel. A device fault leaves the evaluation untallied with a counted
    recovery event, as in :func:`observe_flush`."""
    if not enabled():
        return
    if not _profilable(out, None):
        return
    rows = int(out.shape[0])
    if rows <= 0:
        return
    from ..ops import kernels

    try:
        tally = kernels.dq_sketch([], None, [out], None)
    except _DEVICE_ERRORS as e:
        _unprofiled(e, f"rule {rule} evaluation reports no tally")
        return
    counters.increment("dq.rule_evals")
    _enqueue([("rule", str(rule), rows, tally)])


# ---------------------------------------------------------------------------
# Cold path: the drain, baselines, drift and the violation telemetry
# ---------------------------------------------------------------------------

def _record_statstore(col: str, prof: ColumnProfile) -> None:
    if not config.stats_enabled:
        return
    try:
        from . import statstore as _stats

        _stats.STORE.record_profile(f"dqprof|{col}", "dqprof",
                                    prof.to_doc())
    except Exception:
        logger.debug("dq-profile statstore hand-off failed",
                     exc_info=True)


def _adopted_baseline(col: str) -> Optional[ColumnProfile]:
    """A persisted snapshot's profile of this column, if one was loaded:
    the cross-session drift reference."""
    if not config.stats_enabled:
        return None
    from . import statstore as _stats

    doc = _stats.STORE.profile(f"dqprof|{col}")
    return ColumnProfile.from_doc(doc) if doc else None


def _pin_baseline(col: str, prof: ColumnProfile):
    """The drift reference by ``spark.dq.baselineMode``: ``first`` adopts
    a persisted snapshot, else pins the first drained profile;
    ``persisted`` only adopts; ``off`` scores no drift."""
    mode = str(config.dq_baseline_mode)
    if mode == "off":
        return _NO_BASELINE
    adopted = _adopted_baseline(col)
    if adopted is not None:
        baseline = adopted
    elif mode == "persisted":
        return _NO_BASELINE
    else:
        baseline = prof.copy()
    counters.increment("dq.baseline_pinned")
    return baseline


def _check_drift(col: str, prof: ColumnProfile) -> None:
    baseline = _BASELINES.get(col)
    if baseline is None:
        baseline = _BASELINES[col] = _pin_baseline(col, prof)
    if baseline is _NO_BASELINE:
        return
    score = drift_score(baseline, prof)
    if score is None:
        return
    from . import observability as _obs

    with _LOCK:
        _DRIFT[col] = score
    _obs.METRICS.set_gauge(f"dq.drift.{col}", score)
    if score <= float(config.dq_drift_threshold):
        return
    counters.increment("dq.drift_breach")
    _obs.current_span().set(dq_drift=col)


def _apply_rule(name: str, rows: int, passed: int, window: dict) -> None:
    with _LOCK:
        r = _RULES.setdefault(
            name, {"evals": 0, "rows": 0, "violations": 0})
        r["evals"] += 1
        r["rows"] += rows
        violations = max(rows - passed, 0)
        r["violations"] += violations
        total_rows, total_viol = r["rows"], r["violations"]
    w = window.setdefault(name, [0, 0])
    w[0] += rows
    w[1] += violations
    if violations:
        counters.increment(f"dq.violations.{name}", violations)
    from . import observability as _obs

    rate = (total_viol / total_rows) if total_rows else 0.0
    _obs.METRICS.set_gauge(f"dq.violation_rate.{name}", round(rate, 6))


def _check_spikes(window: dict) -> None:
    """Violation-rate spikes over this drain's rows alone."""
    for name, (rows, violations) in window.items():
        if rows >= SPIKE_MIN_ROWS and \
                violations / rows >= VIOLATION_SPIKE_RATE:
            counters.increment("dq.violation_spike")


def _pull(pending) -> list:
    """Every pending vector on the host, one batched read a device."""
    by_dev: dict = {}
    for i, p in enumerate(pending):
        by_dev.setdefault(p[3].device, []).append(i)
    values: list = [None] * len(pending)
    for dev, idx in by_dev.items():
        parts = [pending[i][3].reshape(-1).to(torch.float64) for i in idx]
        flat = torch.cat(parts).cpu().tolist()
        off = 0
        for i, part in zip(idx, parts):
            values[i] = flat[off:off + part.numel()]
            off += part.numel()
    return values


def drain() -> None:
    """Read every pending observation in one batched host read (counted
    ``dq.drain_sync``), then fold them into the profiles, baselines, drift
    gauges and rule tallies."""
    with _LOCK:
        pending, _PENDING[:] = list(_PENDING), []
    if not pending:
        return
    values = _pull(pending)
    counters.increment("dq.drain_sync")
    touched: dict = {}
    window: dict = {}
    for (kind, name, rows, _), arr in zip(pending, values):
        if kind == "col":
            prof = ColumnProfile.from_raw(arr)
            if prof is None:
                continue
            with _LOCK:
                cur = _PROFILES.get(name)
                if cur is None:
                    cur = _PROFILES[name] = prof
                else:
                    cur.merge(prof)
            touched[name] = cur
        elif len(arr) >= 2:
            _apply_rule(name, int(round(arr[0])), int(round(arr[1])),
                        window)
    for col, prof in touched.items():
        _check_drift(col, prof)
        _record_statstore(col, prof)
    _check_spikes(window)


# ---------------------------------------------------------------------------
# Cold surfaces: the report and the EXPLAIN section
# ---------------------------------------------------------------------------

def report(top: Optional[int] = None, drain_first: bool = True) -> dict:
    """``session.dq_report()``: one row per profiled column (its sketch
    fields, drift and baseline evidence) and per rule (its tallies). Pays
    the drain."""
    if not enabled():
        return {"enabled": False, "columns": [], "rules": [],
                "size": 0, "pending": 0}
    if drain_first:
        drain()
    with _LOCK:
        profiles = {k: v.copy() for k, v in _PROFILES.items()}
        baselines = dict(_BASELINES)
        rules = {k: dict(v) for k, v in _RULES.items()}
        drift = dict(_DRIFT)
        pending = len(_PENDING)
    columns = []
    for col in sorted(profiles):
        p = profiles[col]
        doc = p.to_doc()
        doc["column"] = col
        doc["variance"] = p.variance
        doc["drift"] = drift.get(col)
        base = baselines.get(col)
        doc["baseline_count"] = (base.count if isinstance(
            base, ColumnProfile) else None)
        columns.append(doc)
    if top is not None:
        columns = columns[:max(int(top), 0)]
    rule_rows = []
    for name in sorted(rules):
        r = rules[name]
        rate = (r["violations"] / r["rows"]) if r["rows"] else 0.0
        rule_rows.append({"rule": name, "evals": r["evals"],
                          "rows": r["rows"],
                          "violations": r["violations"],
                          "rate": round(rate, 6)})
    return {"enabled": True, "columns": columns, "rules": rule_rows,
            "size": len(profiles), "pending": pending,
            "bins": int(config.dq_histogram_bins),
            "drift_threshold": float(config.dq_drift_threshold),
            "baseline_mode": str(config.dq_baseline_mode)}


def rule_marks() -> Optional[dict]:
    """EXPLAIN ANALYZE's mark before execution: each rule's evaluations
    after a drain. None when disabled."""
    if not enabled():
        return None
    drain()
    with _LOCK:
        return {name: r["evals"] for name, r in _RULES.items()}


def explain_lines(marks) -> list:
    """The ``== Data Quality ==`` section of EXPLAIN ANALYZE, rendered only
    when the query evaluated a registered rule since ``marks``: the rule
    tallies and the profiled columns so far."""
    if marks is None or not enabled():
        return []
    drain()
    with _LOCK:
        rules = {k: dict(v) for k, v in _RULES.items()}
        profiles = {k: v.copy() for k, v in _PROFILES.items()}
        drift = dict(_DRIFT)
    evaluated = [name for name in sorted(rules)
                 if rules[name]["evals"] > marks.get(name, 0)]
    if not evaluated:
        return []
    lines = ["== Data Quality =="]
    for name in sorted(rules):
        r = rules[name]
        rate = (r["violations"] / r["rows"]) if r["rows"] else 0.0
        lines.append(f"rule {name}: evals={r['evals']} "
                     f"rows={r['rows']} violations={r['violations']} "
                     f"rate={rate:.4f}")
    for col in sorted(profiles)[:8]:
        p = profiles[col]
        span = ("-" if p.min is None
                else f"[{p.min:g}, {p.max:g}]")
        d = drift.get(col)
        lines.append(f"column {col}: count={p.count} nulls={p.nulls} "
                     f"mean={p.mean:.4f} range={span} "
                     f"drift={'-' if d is None else format(d, 'g')}")
    return lines
