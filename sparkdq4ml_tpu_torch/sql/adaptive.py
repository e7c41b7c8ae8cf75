"""Adaptive query execution: mid-query re-planning from observed counts
(the port of ``sparkdq4ml_tpu/sql/adaptive.py``, single device).

``sql/optimizer.py`` picks a plan from persisted history; this module is
the decision layer the stage-boundary hooks call where a running query
already holds fresh counts on the host:

* **build-side flip** (``Frame.join``): the join's host plan knows both
  sides' valid-row counts before it builds anything. When either side
  drifted past ``spark.aqe.driftFactor`` from the optimizer's estimate,
  the build side is re-decided from the observed counts. Bit-identical:
  both build directions emit the same pair order.
* **downstream re-bucket** (``sql/parser._execute_single`` after WHERE):
  when history says the surviving rows land a power-of-two bucket
  (``ops/compiler.bucket_size``) below the slot count, past the drift
  factor, the survivors compact into the smaller bucket so grouping,
  sorting and distinct run over fewer slots; the flush budget is
  re-checked there. Sound by the masked-slot invariant.
* **grouped lowering choice** (``ops/segments.grouped_agg``): when the
  recorded output-cardinality history says the group count exceeds the
  dense table's range, the dense program's own host read is skipped for
  this query: its fit verdict rides the sorted program's read, and the
  dense program runs only if the verdict fits after all (the history was
  wrong), so the answer is the static plan's bit for bit (on the card
  the two programs add float sums in different orders).

Every decision point runs behind :func:`guard`, which degrades a failed
decision to the static plan with an ``aqe.fallback`` count. (The JAX
package's ``aqe`` fault site and ``recovery.fallback`` event come with
the port's fault and recovery layers; its broadcast shuffle-skip and
skew split need the sharded store and come with the mesh.)

EXPLAIN ANALYZE renders applied events as an ``== Adaptive ==`` section
(the :func:`capture` scope); ``aqe.replans``/``aqe.replans.<trigger>``
count them. ``spark.aqe.enabled=false`` reduces every hook to one conf
read.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
from typing import Optional

import numpy as np
import torch

from ..config import config
from ..utils.profiling import counters

logger = logging.getLogger("sparkdq4ml_tpu_torch.sql.adaptive")

__all__ = [
    "enabled", "guard", "drift", "record", "capture", "render",
    "rebucket_candidate", "maybe_rebucket", "row_nbytes",
    "BUILD_RATIO",
]

#: Build-side hysteresis, mirroring the static optimizer's
#: ``_BUILD_RATIO``: the observed-count re-decision must clear the same
#: bar the estimate-based hint did, or drift would flip marginal joins
#: back and forth between runs.
BUILD_RATIO = 2


class ReplanEvent:
    """One applied mid-query re-plan — the ``== Adaptive ==`` line."""

    __slots__ = ("trigger", "detail", "est_before", "est_after")

    def __init__(self, trigger: str, detail: str,
                 est_before: Optional[int], est_after: Optional[int]):
        self.trigger = trigger
        self.detail = detail
        self.est_before = est_before
        self.est_after = est_after

    def __str__(self):
        def fmt(v):
            return "-" if v is None else str(v)

        return (f"{self.trigger}: {self.detail} "
                f"(est_rows {fmt(self.est_before)} -> "
                f"{fmt(self.est_after)})")


#: EXPLAIN ANALYZE's capture scope: a list the execution under
#: :func:`capture` appends applied events into. Context-local so
#: concurrent serving queries never interleave sections.
_CAPTURE: contextvars.ContextVar = contextvars.ContextVar(
    "aqe_capture", default=None)


def enabled() -> bool:
    return bool(config.aqe_enabled)


def guard(decision: str) -> bool:
    """Admission of ONE re-plan decision point: True when the adaptive
    decision may proceed. The ``aqe`` fault site injects here (a
    ``device_error`` raises, a ``stall`` fires its due-test); either, or
    any other failure, degrades this decision to the static plan (rung
    ``static``: the query finishes on the plan it had) with an
    ``aqe.fallback`` count and a recovery event. Never raises."""
    from ..utils import faults as _faults

    try:
        _faults.inject("aqe")
        if _faults.fired("aqe", "stall"):
            raise TimeoutError("injected stall at 'aqe'")
        return bool(config.aqe_enabled)
    except Exception as e:
        from ..utils.recovery import RECOVERY_LOG

        counters.increment("aqe.fallback")
        RECOVERY_LOG.record(
            "aqe", "fallback", rung="static",
            cause=f"{type(e).__name__}: {e}",
            detail=f"{decision} re-plan skipped; the static plan "
                   "finishes the query")
        logger.debug("aqe %s decision degraded to the static plan",
                     decision, exc_info=True)
        return False


def drift(est: Optional[int], observed: int) -> bool:
    """Whether ``observed`` crossed ``spark.aqe.driftFactor`` away from
    ``est`` in EITHER direction (an estimate can be wrong both ways; a
    too-small estimate flips build sides, a too-large one shrinks
    buckets). A cold estimate (None) never triggers — adaptivity needs
    an expectation to drift FROM."""
    if est is None:
        return False
    f = max(float(config.aqe_drift_factor), 1.0)
    a = max(int(observed), 1)
    b = max(int(est), 1)
    return a >= b * f or b >= a * f


def record(trigger: str, detail: str, est_before: Optional[int],
           est_after: Optional[int]) -> None:
    """Count one APPLIED re-plan and surface it: ``aqe.replans`` (+ the
    per-trigger mirror), the active span's ``aqe`` annotation, and the
    EXPLAIN ANALYZE capture scope when one is open."""
    counters.increment("aqe.replans")
    counters.increment(f"aqe.replans.{trigger}")
    from ..utils import observability as _obs

    _obs.current_span().set(aqe=trigger)
    events = _CAPTURE.get()
    if events is not None:
        events.append(ReplanEvent(trigger, detail, est_before, est_after))


@contextlib.contextmanager
def capture():
    """Scope under which applied re-plan events collect into the yielded
    list — EXPLAIN ANALYZE's ``== Adaptive ==`` source."""
    events: list = []
    token = _CAPTURE.set(events)
    try:
        yield events
    finally:
        _CAPTURE.reset(token)


def render(events) -> list[str]:
    """The ``== Adaptive ==`` body lines (header is the caller's)."""
    return [str(e) for e in events]


# ---------------------------------------------------------------------------
# Byte model (host metadata only — never a device read)
# ---------------------------------------------------------------------------

def row_nbytes(frame) -> int:
    """Resident bytes a row of ``frame``: each column's element size
    (a 2-D column counts its row width) plus the mask byte; a host column
    counts one pointer. Shape metadata only: never a device read."""
    total = 1    # bool mask
    for name in frame.columns:
        arr = frame._data[name]
        if not isinstance(arr, torch.Tensor):
            total += 8
        else:
            width = arr.shape[1] if arr.dim() == 2 else 1
            total += width * arr.element_size()
    return total


# ---------------------------------------------------------------------------
# Downstream re-bucketing (the stage-boundary memory re-plan)
# ---------------------------------------------------------------------------

def rebucket_candidate(est: Optional[int], slots: int) -> bool:
    """Cheap pre-check (no sync): history estimates enough shrink that
    observing the true count could pay — the estimate drifted below the
    slot count AND lands a strictly smaller power-of-two bucket."""
    if est is None or slots <= 0:
        return False
    from ..ops.compiler import bucket_size

    if not drift(est, slots):
        return False
    return bucket_size(max(int(est), 1)) < bucket_size(slots)


def maybe_rebucket(frame, est: Optional[int]):
    """Re-bucket a just-filtered frame to its OBSERVED valid-row count
    when the slot count drifted past ``spark.aqe.driftFactor`` above it
    and a strictly smaller power-of-two bucket results: the surviving
    rows compact (``index_select`` in mask order, so row order is kept)
    into an all-valid frame of the observed rows, as in the JAX package,
    so every downstream stage runs in the smaller bucket.
    The budget check of the compiler's flush (``flush_budget``) is made
    again here: a stage that still exceeds it is left to the chunked
    flush.

    Sound by the masked-slot invariant: masked rows are invisible to
    every consumer, so dropping their slots changes no result. Costs one
    counted host read, paid only after :func:`rebucket_candidate` said the
    shrink is plausible. Returns the (possibly new) frame."""
    from ..frame.frame import Frame
    from ..ops.compiler import bucket_size, flush_budget

    slots = frame.num_slots
    if slots <= 0 or not rebucket_candidate(est, slots):
        return frame
    if not guard("re-bucket"):
        return frame
    host_mask = frame._host_mask()        # counted device->host read
    keep = np.nonzero(host_mask)[0]
    observed = int(keep.size)
    new_bucket = bucket_size(max(observed, 1))
    if new_bucket >= bucket_size(slots) or not drift(observed, slots):
        return frame                      # history lied small: keep plan
    per_row = row_nbytes(frame)
    budget = flush_budget()
    if budget is not None and new_bucket * per_row > budget:
        return frame
    take_dev = torch.as_tensor(keep, dtype=torch.int64,
                               device=frame.device)
    data = {}
    for name in frame.columns:
        arr = frame._data[name]
        if not isinstance(arr, torch.Tensor):
            data[name] = np.asarray(arr, dtype=object)[keep]
        else:
            data[name] = arr.index_select(0, take_dev)
    record("re-bucket",
           f"{slots} -> {new_bucket} padded slots "
           f"(observed {observed} rows; est {est})",
           est_before=slots, est_after=observed)
    return Frame(data, device=frame.device)
