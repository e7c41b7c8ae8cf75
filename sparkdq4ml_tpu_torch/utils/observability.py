"""Structured tracing and metrics (the port of
``sparkdq4ml_tpu/utils/observability.py``, the part the pipeline compiler,
the statstore and the session's reports use).

A span-based tracer with hierarchical, contextvar-propagated spans
(``sql.query`` -> frame op -> ``frame.pipeline.flush``) and a metrics
registry that extends :data:`utils.profiling.counters` with gauges and
fixed-bucket latency histograms.

Exporters (host-side, on demand, never on the hot path):

* :func:`chrome_trace` / :func:`dump_chrome_trace`: Chrome trace-event
  JSON, loadable in Perfetto or ``chrome://tracing``;
* logfmt event lines through :func:`utils.logging.format_kv` (one DEBUG
  line per finished span when ``log_spans`` is on);
* :func:`prometheus_text`: a Prometheus text-format snapshot;
* :func:`trace_report`: a human-readable span tree.

Disabled mode costs one ``TRACER.enabled`` read per instrumented site and
allocates nothing (the shared :data:`_NOOP` is returned), so a traced
site adds no device work and no host read.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import json
import logging
import os
import threading
import time
from typing import Callable, Optional

from . import profiling
from .logging import format_kv

logger = logging.getLogger("sparkdq4ml_tpu_torch.observability")

ENV_VAR = "SPARKDQ4ML_OBS"

# ---------------------------------------------------------------------------
# Metrics: gauges + fixed-bucket histograms (counters live in
# utils.profiling.counters)
# ---------------------------------------------------------------------------

#: Default latency buckets (milliseconds) — fixed at creation so scrapes see
#: a stable schema; spans record their duration into ``span_ms.<category>``.
DEFAULT_BUCKETS_MS = (0.1, 0.5, 1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)

#: THE metric-name registry, the JAX package's names kept as they are so
#: one dashboard reads both: every literal name passed to
#: ``counters.increment`` / ``METRICS.set_gauge`` / ``METRICS.observe``
#: is declared here, name -> (type, help); the Prometheus exporter renders
#: the declared help text. Families this port does not produce yet keep
#: their entries, so the two registries stay one. A pure literal.
METRIC_NAMES = {
    # frame engine
    "frame.host_sync": ("counter", "counted device->host boundary pulls"),
    "frame.cache": ("counter", "Frame.cache()/persist() materializations"),
    # fused expression pipeline (ops/compiler.py)
    "pipeline.flush": ("counter", "pending-pipeline materializations"),
    "pipeline.compile": ("counter", "fused programs traced+compiled"),
    "pipeline.hit": ("counter", "fused-program plan-cache replays"),
    "pipeline.fallback": ("counter", "flushes degraded to eager replay"),
    "pipeline.fault_fallback": ("counter",
                                "flushes eager-replayed by the fault "
                                "ladder"),
    "pipeline.evict": ("counter", "plan-cache LRU evictions"),
    "pipeline.oom_chunked": ("counter",
                             "over-budget flushes run row-chunked"),
    "pipeline.shard_gather": ("counter",
                              "sharded flushes gathered to single-device "
                              "by the shard_flush ladder"),
    # grouped execution (ops/segments.py)
    "grouped.compile": ("counter", "grouped programs traced+compiled"),
    "grouped.hit": ("counter", "grouped-program plan-cache replays"),
    "grouped.fallback": ("counter", "grouped ops on the host path"),
    "grouped.fault_fallback": ("counter",
                               "grouped ops host-degraded by the fault "
                               "ladder"),
    "grouped.dense_miss": ("counter", "dense lowering misfits rerouted"),
    "grouped.evict": ("counter", "grouped plan-cache LRU evictions"),
    "grouped.shard_gather": ("counter",
                             "sharded grouped/distinct programs gathered "
                             "to single-device by the shard_merge "
                             "ladder"),
    # row-sharded frames (parallel/shard.py)
    "shard.place": ("counter", "frames laid out row-sharded"),
    "shard.gather": ("counter", "sharded frames degraded to "
                                "single-device placement"),
    "shard.join_partitioned": ("counter",
                               "joins planned via the hash-partition "
                               "shuffle lowering"),
    "shard.fit_passthrough": ("counter",
                              "fit placements consuming shard partials "
                              "directly (no re-shard)"),
    # streaming ingest (frame/native_csv.py)
    "ingest.files": ("counter", "native CSV files read"),
    "ingest.bytes": ("counter", "native CSV bytes parsed"),
    "ingest.rows": ("counter", "native CSV rows parsed"),
    "ingest.chunks": ("counter", "streamed parse chunks"),
    "ingest.streamed": ("counter", "files read via the streaming path"),
    "ingest.python_fallback": ("counter",
                               "files degraded to the python engine"),
    "ingest.fault_fallback": ("counter",
                              "native reads degraded by the fault "
                              "ladder"),
    # solver / jit layers
    "solver.fits": ("counter", "model fits dispatched"),
    "solver.iterations": ("counter", "solver iterations run"),
    "jit.trace_miss": ("counter", "jit-factory cache misses (new trace)"),
    "jit.trace_hit": ("counter", "jit-factory cache hits"),
    # parallel / mesh
    "parallel.psum_dispatches": ("counter", "collective dispatches"),
    "parallel.shard_map_builds": ("counter", "shard_map programs built"),
    "mesh.devices": ("gauge", "devices in the session mesh"),
    # device memory (utils/meminfo.py)
    "mem.live_bytes": ("gauge", "live-array census bytes"),
    "mem.peak_bytes": ("gauge", "process-lifetime census peak bytes"),
    # tracer internals
    "trace.dropped_spans": ("counter", "spans evicted by the bounded "
                                       "buffer"),
    # tail-based request-tree retention (TailSampler)
    "trace.kept": ("counter", "request trees promoted to the retained "
                              "store by the tail keep-policy"),
    "trace.dropped": ("counter", "request trees aged out of the tail "
                                 "ring without being kept"),
    # incident flight recorder (utils/incidents.py)
    "incident.written": ("counter", "incident bundles persisted to the "
                                    "incident dir"),
    "incident.failed": ("counter", "incident bundle writes degraded to "
                                   "in-memory retention"),
    # fault injection (utils/faults.py)
    "faults.injected": ("counter", "chaos faults fired"),
    # serving layer (serve/)
    "serve.admit": ("counter", "queries admitted"),
    "serve.reject": ("counter", "queries rejected (all reasons)"),
    "serve.shed": ("counter", "queries shed by an open breaker"),
    "serve.complete": ("counter", "queries completed ok"),
    "serve.error": ("counter", "queries failed in execution"),
    "serve.deadline_exceeded": ("counter", "queries past their deadline"),
    "serve.late_result": ("counter", "executed values discarded late"),
    "serve.requeue": ("counter", "retryable failures requeued"),
    "serve.tenants_reaped": ("counter", "idle stateless tenants reaped"),
    "serve.queue_depth": ("gauge", "queued jobs across tenants"),
    "serve.in_flight": ("gauge", "jobs executing right now"),
    "serve.tenants": ("gauge", "known tenant states"),
    "serve.workers": ("gauge", "live worker threads"),
    "serve.slo_burn": ("gauge", "SLO error-budget burn rate, all "
                                "tenants (1.0 = burning the 1% budget "
                                "exactly)"),
    "serve.queue_ms": ("histogram", "queue wait per executed job"),
    "serve.exec_ms": ("histogram", "execution wall per job"),
    "serve.e2e_ms": ("histogram", "client-experienced end-to-end "
                                  "latency"),
    # cross-request plan coalescing (serve/coalesce.py)
    "serve.coalesce.batched": ("counter", "queries served by a "
                                          "cross-request batched "
                                          "dispatch"),
    "serve.coalesce.dispatches": ("counter", "cross-request batched "
                                             "device dispatches"),
    "serve.coalesce.degraded": ("counter", "batches degraded to "
                                           "per-request replay"),
    "serve.coalesce.batch_size": ("histogram", "members per batched "
                                               "dispatch"),
    "serve.coalesce.window_ms": ("histogram", "hold-window wait per "
                                              "batched dispatch"),
    # network serving front end (serve/net.py + serve/client.py)
    "net.accept": ("counter", "socket connections accepted"),
    "net.requests": ("counter", "wire requests parsed (both framings)"),
    "net.pages": ("counter", "result pages streamed"),
    "net.page_deadline": ("counter", "result streams truncated by the "
                                     "wire deadline between pages"),
    "net.bytes_in": ("counter", "request bytes read off the wire"),
    "net.bytes_out": ("counter", "response bytes written to the wire"),
    "net.conn_reset": ("counter", "connections dropped by a reset "
                                  "(injected or real)"),
    "net.conn_timeout": ("counter", "connections closed by the "
                                    "read/write timeout (slow-loris "
                                    "guard)"),
    "net.partial_write": ("counter", "responses truncated mid-write"),
    "net.frame_overflow": ("counter", "requests refused over "
                                      "maxFrameBytes"),
    "net.client_gone": ("counter", "mid-stream client disconnects "
                                   "(result discarded via "
                                   "serve.late_result)"),
    "net.idem_hit": ("counter", "idempotency-key dedup hits (no "
                                "re-execution)"),
    "net.error_frames": ("counter", "structured error frames/responses "
                                    "sent"),
    "net.active": ("gauge", "open socket connections"),
    "net.client_retry": ("counter", "resilient-client attempt retries"),
    "net.client_hedge": ("counter", "resilient-client hedged attempts"),
    # cost-based plan optimizer (sql/optimizer.py + lowering hooks)
    "optimizer.rewrite": ("counter", "plan rewrites applied"),
    "optimizer.fallback": ("counter",
                           "queries degraded to the unrewritten plan"),
    "optimizer.split": ("counter",
                        "mega-stage flushes split at a warm prefix"),
    "optimizer.mem_chunk": ("counter",
                            "flushes chunked by remembered byte bounds"),
    "optimizer.dense_skip": ("counter",
                             "grouped dense attempts skipped by miss "
                             "history"),
    # adaptive query execution (sql/adaptive.py + boundary hooks)
    "aqe.replans": ("counter", "mid-query re-plan events applied, all "
                               "triggers"),
    "aqe.fallback": ("counter", "re-plan decision points degraded to "
                                "the static plan by the aqe fault "
                                "ladder"),
    # plan-stats observatory (utils/statstore.py)
    "stats.record": ("counter", "flush observations recorded"),
    "stats.evict": ("counter", "stats entries evicted (maxEntries)"),
    "stats.drain_sync": ("counter",
                         "batched deferred-observation device pulls"),
    "stats.pending_dropped": ("counter",
                              "deferred observations dropped at the "
                              "pending bound"),
    "stats.loaded": ("counter", "stats entries adopted from a snapshot"),
    "stats.persisted": ("counter", "stats snapshots written"),
    "stats.persist_failed": ("counter",
                             "snapshot writes degraded to in-memory "
                             "only"),
    "stats.load_failed": ("counter",
                          "corrupt/stale snapshots degraded to empty"),
    # device-cost observatory (utils/costprof.py)
    "costprof.extracted": ("counter",
                           "AOT cost profiles extracted (lower+compile, "
                           "zero device execution)"),
    "costprof.failed": ("counter",
                        "cost extractions degraded to unprofiled "
                        "(surfaces render '-')"),
    "shard.skew": ("gauge", "worst/mean shard row-balance ratio of the "
                            "most recent sharded placement"),
    "shard.exchange_bytes": ("counter",
                             "statically-sized cross-shard exchange "
                             "volume, all kinds"),
    "profiling.captures": ("counter",
                           "managed profiler captures armed"),
    # data-quality observatory (utils/dqprof.py)
    "dq.sketches": ("counter",
                    "column/rule sketch reductions dispatched from "
                    "flush hooks"),
    "dq.drain_sync": ("counter",
                      "batched cold-path drains of deferred dq "
                      "sketches (the only dq host syncs)"),
    "dq.pending_dropped": ("counter",
                           "deferred dq observations dropped at the "
                           "pending bound"),
    "dq.profile_failed": ("counter",
                          "flushes degraded to unprofiled by the "
                          "dq_profile fault ladder"),
    "dq.rule_evals": ("counter",
                      "eager DQ-rule evaluations accounted"),
    "dq.baseline_pinned": ("counter",
                           "drift baselines pinned (first drain or "
                           "persisted snapshot adoption)"),
    "dq.drift_breach": ("counter",
                        "column drift scores past "
                        "spark.dq.driftThreshold"),
    "dq.violation_spike": ("counter",
                           "per-drain rule violation-rate spikes"),
    "dq.program_evict": ("counter",
                         "dq sketch programs evicted at the cache "
                         "bound"),
}

#: Dynamic metric-name families (formatted per site/tenant/category at
#: runtime): any name starting with one of these prefixes is declared by
#: the family. prefix → (type, help). Same pure-literal contract as
#: :data:`METRIC_NAMES`.
METRIC_NAME_PREFIXES = {
    "recovery.": ("counter", "resilience-layer event mirror (action and "
                             "per-site action.site keys)"),
    "faults.injected.": ("counter", "per-site injected-fault mirror"),
    "jit.backend.": ("counter", "backend compile events"),
    "solver.": ("counter", "per-solver dispatch counters"),
    "serve.reject.": ("counter", "per-reason admission rejections"),
    "serve.e2e_ms.": ("histogram", "per-tenant end-to-end latency "
                                   "(series-capped)"),
    "serve.slo_burn.": ("gauge", "per-tenant SLO error-budget burn rate "
                                 "(series-capped)"),
    "span_ms.": ("histogram", "span wall-clock latency by category"),
    "costprof.": ("counter", "device-cost observatory activity"),
    "aqe.replans.": ("counter", "per-trigger mid-query re-plan events "
                                "(build-flip/broadcast/skew-split/"
                                "re-bucket/grouped-lowering)"),
    "shard.exchange_bytes.": ("counter",
                              "per-kind cross-shard exchange volume "
                              "(psum/all_to_all/gather)"),
    "dq.violations.": ("counter", "per-rule DQ violation rows"),
    "dq.violation_rate.": ("gauge", "per-rule cumulative violation "
                                    "fraction"),
    "dq.drift.": ("gauge", "per-column PSI drift vs the pinned "
                           "baseline"),
}


class Histogram:
    """Fixed-bucket histogram (Prometheus convention: cumulative bucket
    counts keyed by upper bound ``le``, plus ``sum`` and ``count``).
    Thread-safe; buckets are fixed at construction."""

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS_MS):
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = 0
        for i, b in enumerate(self.buckets):  # ≤ ~14 buckets: linear is fine
            if v <= b:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cumulative, acc = {}, 0
        for b, c in zip(self.buckets, counts):
            acc += c
            cumulative[b] = acc
        cumulative[float("inf")] = total
        return {"buckets": cumulative, "sum": s, "count": total}


class MetricsRegistry:
    """Gauges + histograms, by name. Counters intentionally stay in
    :data:`utils.profiling.counters` (one monotonic registry, one recovery
    mirror); :func:`metrics_snapshot` merges all three views."""

    def __init__(self):
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def get_gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def histogram(self, name: str, buckets=None) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = Histogram(name, buckets or DEFAULT_BUCKETS_MS)
                self._histograms[name] = h
            return h

    def observe(self, name: str, value: float, buckets=None) -> None:
        self.histogram(name, buckets).observe(value)

    def snapshot(self) -> dict:
        with self._lock:
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        out: dict = dict(gauges)
        for name, h in hists.items():
            out[name] = h.snapshot()
        return out

    def clear(self) -> None:
        with self._lock:
            self._gauges.clear()
            self._histograms.clear()


#: Process-global metrics registry (gauges + histograms).
METRICS = MetricsRegistry()


def metrics_snapshot() -> dict:
    """One merged registry view: every monotonic counter (including the
    ``recovery.*`` mirror), every gauge, and every histogram
    summary, flat by name."""
    out: dict = dict(profiling.counters.snapshot())
    out.update(METRICS.snapshot())
    return out


# ---------------------------------------------------------------------------
# Tracer: hierarchical spans, contextvar-propagated
# ---------------------------------------------------------------------------


class _NoopSpan:
    """Shared disabled-mode stand-in: reentrant, stateless, allocation-free.
    Every method is a no-op returning self."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NOOP = _NoopSpan()

_CURRENT: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "sparkdq4ml_torch_obs_current_span", default=None)


def _live_bytes() -> int:
    """Bytes the CUDA caching allocator holds for live tensors (0 without
    a card): the ``mem.live_bytes`` counter track."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0
    return int(torch.cuda.memory_allocated())


class Span:
    """One traced operation. Use as a context manager, or through
    ``Tracer.begin``/``Tracer.end`` for long-lived spans (a session root).
    ``set(**attrs)`` attaches structured attributes at any point.

    ``trace_id`` is the span id of the trace's root span; both exporters
    emit it, so a logfmt line can be found in the Perfetto view."""

    __slots__ = ("name", "cat", "attrs", "sid", "parent_id", "trace_id",
                 "tid", "ts_us", "dur_us", "_t0", "_token", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.sid = tracer._next_id()
        parent = _CURRENT.get()
        if parent is None:
            # a long-lived root opened with ``begin`` parents spans whose
            # context lost the link (worker threads, sibling contexts)
            try:
                parent = tracer._ambient[-1]
            except IndexError:
                parent = None
        self.parent_id = parent.sid if parent is not None else None
        self.trace_id = parent.trace_id if parent is not None else self.sid
        self.tid = threading.get_ident()
        self.ts_us = 0
        self.dur_us: Optional[int] = None
        self._t0 = 0.0
        self._token: Optional[contextvars.Token] = None

    def set(self, **attrs) -> "Span":
        # copy-on-write: exporters read ``attrs`` from other threads
        self.attrs = {**self.attrs, **attrs}
        return self

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        self.ts_us = self._tracer._now_us()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.dur_us = int((time.perf_counter() - self._t0) * 1e6)
        if et is not None:
            self.attrs = {**self.attrs, "error": et.__name__}
        if self._token is not None:
            try:
                _CURRENT.reset(self._token)
            except ValueError:   # crossed contexts (begin/end misuse)
                _CURRENT.set(None)
            self._token = None
        self._tracer._finish(self)
        return False


class Tracer:
    """Span recorder. ``enabled`` is the hot-path gate. Finished spans land
    in a bounded buffer (oldest dropped, counted) and their durations feed
    the ``span_ms.<category>`` histograms."""

    #: Minimum spacing of the counter samples rendered as ``"ph": "C"``
    #: tracks (microseconds); sampled at span completion, so an idle
    #: process records nothing.
    counter_sample_us = 20_000
    #: Bounded counter-sample history (oldest dropped).
    max_counter_samples = 4096

    def __init__(self, max_spans: int = 10_000):
        self.enabled = False
        self.log_spans = False
        self.max_spans = max_spans
        self.dropped = 0              # spans evicted by the bounded buffer
        self._spans: list[Span] = []
        self._open: dict[int, Span] = {}
        self._ambient: list[Span] = []   # begun roots (see Span.__init__)
        self._sinks: list = []        # per-query collectors (query_stats)
        self._csamples: list = []     # (ts_us, {metric: value}) track
        self._last_csample_us = 0
        self._lock = threading.Lock()
        self._id = 0
        self._epoch_s = time.time()
        self._pc0 = time.perf_counter()

    # -- internals --------------------------------------------------------
    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def _now_us(self) -> int:
        return int((self._epoch_s
                    + (time.perf_counter() - self._pc0)) * 1e6)

    def _finish(self, s: Span) -> None:
        with self._lock:
            self._open.pop(s.sid, None)
            self._spans.append(s)
            excess = len(self._spans) - self.max_spans
            if excess > 0:
                del self._spans[:excess]
                self.dropped += excess
            sinks = list(self._sinks)
        if excess > 0:
            profiling.counters.increment("trace.dropped_spans", excess)
        for sink in sinks:
            try:
                sink(s)
            except Exception:   # a broken collector must not break the op
                logger.debug("span sink failed", exc_info=True)
        self._maybe_sample_counters()
        METRICS.observe(f"span_ms.{s.cat or 'other'}",
                        (s.dur_us or 0) / 1e3)
        if self.log_spans:
            logger.debug(
                "span %s",
                format_kv(name=s.name, cat=s.cat,
                          dur_ms=round((s.dur_us or 0) / 1e3, 3),
                          trace_id=s.trace_id, span_id=s.sid,
                          parent_id=s.parent_id, **s.attrs))

    def _maybe_sample_counters(self) -> None:
        """The counter tracks of the Chrome trace: the allocator's live
        bytes and the pipeline hit/compile counters, taken at span
        completion at most every :data:`counter_sample_us`."""
        now = self._now_us()
        with self._lock:
            if now - self._last_csample_us < self.counter_sample_us:
                return
            self._last_csample_us = now
        sample = {
            "mem.live_bytes": _live_bytes(),
            "serve.queue_depth": METRICS.get_gauge("serve.queue_depth"),
            "pipeline.hit": profiling.counters.get("pipeline.hit"),
            "pipeline.compile": profiling.counters.get("pipeline.compile"),
        }
        with self._lock:
            self._csamples.append((now, sample))
            if len(self._csamples) > self.max_counter_samples:
                del self._csamples[: len(self._csamples)
                                   - self.max_counter_samples]

    def counter_samples(self) -> list:
        with self._lock:
            return list(self._csamples)

    # -- recording --------------------------------------------------------
    def span(self, name: str, cat: str = "", **attrs):
        """Context manager for one traced operation; the shared no-op when
        disabled."""
        if not self.enabled:
            return _NOOP
        return Span(self, name, cat, attrs)

    def begin(self, name: str, cat: str = "", **attrs):
        """Open a long-lived span (e.g. a session root) that outlives the
        calling frame; pair with :meth:`end`."""
        if not self.enabled:
            return _NOOP
        s = Span(self, name, cat, attrs)
        s.ts_us = self._now_us()
        s._t0 = time.perf_counter()
        _CURRENT.set(s)
        with self._lock:
            self._open[s.sid] = s
            self._ambient.append(s)
        return s

    def end(self, s) -> None:
        if s is None or s is _NOOP:
            return
        s.dur_us = int((time.perf_counter() - s._t0) * 1e6)
        if _CURRENT.get() is s:
            _CURRENT.set(None)
        with self._lock:
            if s in self._ambient:
                self._ambient.remove(s)
        self._finish(s)

    # -- views ------------------------------------------------------------
    def spans(self) -> list:
        """Finished and still-open spans."""
        with self._lock:
            done = list(self._spans)
            open_ = list(self._open.values())
        return done + open_

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._open.clear()
            self._ambient.clear()
            self._csamples.clear()
            self._last_csample_us = 0
            self.dropped = 0


#: Process-global tracer, disabled by default (the session's
#: ``spark.observability.enabled`` conf or :func:`enable` turn it on).
TRACER = Tracer()


def enabled() -> bool:
    return TRACER.enabled


def enable(max_spans: int = 10_000, log_spans: bool = False) -> None:
    """Turn recording on (idempotent); recorded spans are kept."""
    TRACER.max_spans = int(max_spans)
    TRACER.log_spans = bool(log_spans)
    TRACER.enabled = True


def disable() -> None:
    """Stop recording; recorded spans stay exportable."""
    TRACER.enabled = False


def reset() -> None:
    """Clear spans, gauges and histograms (counters have their own
    ``profiling.counters.clear``)."""
    TRACER.clear()
    METRICS.clear()


def span(name: str, cat: str = "", **attrs):
    """``with observability.span("x"): ...``."""
    if not TRACER.enabled:
        return _NOOP
    return TRACER.span(name, cat, **attrs)


def current_span():
    """The innermost active span in this context (:data:`_NOOP` when
    disabled or outside any span)."""
    if not TRACER.enabled:
        return _NOOP
    s = _CURRENT.get()
    return s if s is not None else _NOOP


def current_ids() -> tuple:
    """``(trace_id, span_id)`` of the innermost active span, ``(None,
    None)`` when tracing is off or no span is open."""
    if not TRACER.enabled:
        return (None, None)
    s = _CURRENT.get()
    if s is None:
        try:
            s = TRACER._ambient[-1]
        except IndexError:
            return (None, None)
    return (s.trace_id, s.sid)


def emit_span(name: str, cat: str = "", dur_ms: float = 0.0,
              ctx=None, **attrs) -> None:
    """Record an already-elapsed interval as a finished span, back-dated
    by ``dur_ms``; ``ctx`` (an object with ``root_sid`` and
    ``root_trace``) parents it under a request root."""
    t = TRACER
    if not t.enabled:
        return
    s = Span(t, name, cat, attrs)
    if ctx is not None and getattr(ctx, "root_sid", None) is not None:
        s.parent_id = ctx.root_sid
        s.trace_id = ctx.root_trace
    s.dur_us = int(max(float(dur_ms), 0.0) * 1000)
    s.ts_us = t._now_us() - s.dur_us
    t._finish(s)


def op_span(name: str, cat: str = "frame"):
    """Decorator for frame-op methods: when tracing is on, the call runs
    in a span with rows in and out (``_n``, never a device read) and the
    ``frame.host_sync`` events the op performed. Disabled cost: one
    attribute read and a branch."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            t = TRACER
            if not t.enabled:
                return fn(self, *args, **kwargs)
            sync0 = profiling.counters.get("frame.host_sync")
            with Span(t, name, cat, {"rows_in": getattr(self, "_n", None)}) \
                    as s:
                out = fn(self, *args, **kwargs)
                n = getattr(out, "_n", None)
                if n is not None:
                    s.set(rows_out=n)
                s.set(host_syncs=profiling.counters.get("frame.host_sync")
                      - sync0)
                return out
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# Per-query stats collection
# ---------------------------------------------------------------------------


class QueryStatsCollector:
    """Scopes the span and counter streams to one query: every span that
    the installing thread finishes while the collector is installed lands
    in ``spans`` (in completion order), and ``counter_delta()`` reports
    how every counter moved (counters are process-global)."""

    def __init__(self):
        self.spans: list = []
        self._tid = threading.get_ident()
        self._counters0 = profiling.counters.snapshot()

    def _on_span(self, s) -> None:
        if s.tid == self._tid:
            self.spans.append(s)

    def counter_delta(self) -> dict:
        now = profiling.counters.snapshot()
        out = {}
        for k, v in now.items():
            d = v - self._counters0.get(k, 0)
            if d:
                out[k] = d
        return out

    def spans_named(self, *names) -> list:
        return [s for s in self.spans if s.name in names]


# the enabled flag's restore is refcounted: the first collector in saves
# it, the last one out restores it
_QS_LOCK = threading.Lock()
_QS_ACTIVE = 0
_QS_WAS_ENABLED = False


@contextlib.contextmanager
def query_stats(sample_memory: bool = True):
    """Install a :class:`QueryStatsCollector` for one query. Turns tracing
    on for the window if it is off, and restores the previous state when
    the last active collector exits. ``sample_memory`` is accepted for the
    JAX package's signature; per-span memory sampling comes with
    ``utils/meminfo.py``."""
    global _QS_ACTIVE, _QS_WAS_ENABLED
    t = TRACER
    with _QS_LOCK:
        if _QS_ACTIVE == 0:
            _QS_WAS_ENABLED = t.enabled
        _QS_ACTIVE += 1
        if not t.enabled:
            enable(max_spans=t.max_spans, log_spans=t.log_spans)
    qs = QueryStatsCollector()
    with t._lock:
        t._sinks.append(qs._on_span)
    try:
        yield qs
    finally:
        with t._lock:
            try:
                t._sinks.remove(qs._on_span)
            except ValueError:
                pass
        with _QS_LOCK:
            _QS_ACTIVE -= 1
            if _QS_ACTIVE == 0:
                t.enabled = _QS_WAS_ENABLED


# ---------------------------------------------------------------------------
# Compiled-program cache introspection
# ---------------------------------------------------------------------------


class ProgramHandle:
    """One enumerable cached program: a stable ``program_key`` and the
    callable that runs it (``fn`` over ``args``/``kwargs``).

    * ``cache``: the producer's registry name (``pipeline``, ...);
    * ``program_key``: equal to the ``program_key`` of the producer's
      ``report()`` entry;
    * ``variants``: name -> ``(args, kwargs)`` or a list of them, inputs
      the producer declares equivalent (the bucket doubled and
      quadrupled);
    * ``mesh`` / ``guarded``: None on one device;
    * ``meta``: producer facts (``expected_traces``, ``observed_traces``,
      ``dedup_key``, ``runtime_literals``).
    """

    __slots__ = ("cache", "program_key", "fn", "args", "kwargs",
                 "variants", "mesh", "guarded", "meta")

    def __init__(self, cache: str, program_key: str, fn,
                 args: tuple = (), kwargs: Optional[dict] = None,
                 variants: Optional[dict] = None, mesh=None,
                 guarded: Optional[bool] = None,
                 meta: Optional[dict] = None):
        self.cache = cache
        self.program_key = str(program_key)
        self.fn = fn
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        self.variants = dict(variants or {})
        self.mesh = mesh
        self.guarded = guarded
        self.meta = dict(meta or {})

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ProgramHandle({self.cache!r}, "
                f"{self.program_key[:60]!r}, variants="
                f"{sorted(self.variants)})")


class CacheRegistry:
    """One registry every compiled-program cache reports into: each
    producer registers a zero-argument stats callable under a stable name,
    and optionally a program enumerator yielding :class:`ProgramHandle`
    records. ``report()`` (``session.cache_report()``) is the merged
    view."""

    def __init__(self):
        self._providers: dict[str, Callable[[], dict]] = {}
        self._program_providers: dict[str, Callable[[], list]] = {}
        self._lock = threading.Lock()

    def register(self, name: str, stats_fn: Callable[[], dict]) -> None:
        """Idempotent: registering a name again replaces its callable."""
        with self._lock:
            self._providers[name] = stats_fn

    def register_programs(self, name: str,
                          programs_fn: Callable[[], list]) -> None:
        with self._lock:
            self._program_providers[name] = programs_fn

    def unregister(self, name: str) -> None:
        with self._lock:
            self._providers.pop(name, None)
            self._program_providers.pop(name, None)

    def programs(self) -> tuple[list, dict]:
        """Every enumerable cached program, and ``{producer: error}`` for
        enumerators that raised (reported, never swallowed)."""
        with self._lock:
            items = list(self._program_providers.items())
        handles: list = []
        errors: dict[str, str] = {}
        for name, fn in sorted(items):
            try:
                handles.extend(fn())
            except Exception as e:
                errors[name] = f"{type(e).__name__}: {e}"
        return handles, errors

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._providers)

    def report(self) -> dict:
        with self._lock:
            items = list(self._providers.items())
        out: dict = {}
        for name, fn in sorted(items):
            try:
                out[name] = fn()
            except Exception as e:   # introspection never takes a query down
                out[name] = {"error": str(e)}
        return out


#: Process-global cache registry (see :class:`CacheRegistry`).
CACHES = CacheRegistry()


def cache_report() -> dict:
    """Merged per-cache introspection: size and capacity, hits, misses,
    evictions, and per-entry detail where the producer tracks it."""
    return CACHES.report()


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------


def _tid_map(spans) -> dict:
    """A small integer per OS thread id (Chrome tids read better)."""
    out: dict[int, int] = {}
    for s in spans:
        if s.tid not in out:
            out[s.tid] = len(out)
    return out


def chrome_trace() -> dict:
    """Chrome trace-event JSON object (``{"traceEvents": [...]}``):
    complete ("X") events in microseconds, span and parent ids in
    ``args``; open spans export with their duration so far and
    ``"open": true``; the counter samples as ``"ph": "C"`` events."""
    tracer = TRACER
    spans = tracer.spans()
    tids = _tid_map(spans)
    pid = os.getpid()
    events = []
    for s in spans:
        open_ = s.dur_us is None
        dur = (tracer._now_us() - s.ts_us) if open_ else s.dur_us
        args = dict(s.attrs)
        args["trace_id"] = s.trace_id
        args["span_id"] = s.sid
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        if open_:
            args["open"] = True
        events.append({
            "ph": "X", "name": s.name, "cat": s.cat or "other",
            "ts": s.ts_us, "dur": max(int(dur), 1),
            "pid": pid, "tid": tids[s.tid], "args": args,
        })
    for ts, sample in tracer.counter_samples():
        for metric, value in sample.items():
            events.append({
                "ph": "C", "name": metric, "cat": "resource",
                "ts": ts, "pid": pid,
                "args": {"value": value},
            })
    return {"traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"framework": "sparkdq4ml_tpu_torch",
                          "dropped_spans": tracer.dropped}}


def dump_chrome_trace(path: str) -> str:
    """Write :func:`chrome_trace` to ``path`` (atomic rename); returns the
    path."""
    doc = chrome_trace()
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def trace_report() -> str:
    """Human-readable span tree (indentation = parentage), oldest
    first."""
    spans = sorted(TRACER.spans(), key=lambda s: (s.ts_us, s.sid))
    children: dict[Optional[int], list] = {}
    for s in spans:
        children.setdefault(s.parent_id, []).append(s)
    by_id = {s.sid: s for s in spans}
    lines: list[str] = []

    def emit(s, depth):
        dur = ("open" if s.dur_us is None
               else f"{s.dur_us / 1e3:.3f} ms")
        attrs = format_kv(**s.attrs)
        lines.append("  " * depth + f"{s.name} [{s.cat or 'other'}] {dur}"
                     + (f"  {attrs}" if attrs else ""))
        for c in children.get(s.sid, []):
            emit(c, depth + 1)

    # roots: no parent, or a parent already evicted from the buffer
    for s in spans:
        if s.parent_id is None or s.parent_id not in by_id:
            emit(s, 0)
    if TRACER.dropped:
        lines.append(f"dropped={TRACER.dropped} spans (bounded buffer "
                     "wrapped; raise spark.observability.maxSpans)")
    return "\n".join(lines)


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch in "_:") else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return "sparkdq4ml_" + s


def _prom_num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _prom_help(name: str) -> str:
    declared = METRIC_NAMES.get(name)
    if declared is None:
        for prefix in METRIC_NAME_PREFIXES:
            if name.startswith(prefix) and name != prefix:
                declared = METRIC_NAME_PREFIXES[prefix]
                break
    if declared is not None:
        return f"{name} - {declared[1]}"
    return f"{name} - sparkdq4ml_tpu_torch metric"


def prometheus_text() -> str:
    """Prometheus text-format snapshot: every counter, gauge and histogram
    (cumulative ``_bucket{le=...}`` series with ``_sum``/``_count``), each
    with ``# HELP`` and ``# TYPE`` headers; dots and other illegal
    characters in names become underscores."""
    lines: list[str] = []
    for name, v in sorted(profiling.counters.snapshot().items()):
        pn = _prom_name(name)
        lines.append(f"# HELP {pn} {_prom_help(name)}")
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {_prom_num(v)}")
    snap = METRICS.snapshot()
    for name in sorted(snap):
        v = snap[name]
        pn = _prom_name(name)
        lines.append(f"# HELP {pn} {_prom_help(name)}")
        if isinstance(v, dict):      # histogram summary
            lines.append(f"# TYPE {pn} histogram")
            for le, c in v["buckets"].items():
                lines.append(f'{pn}_bucket{{le="{_prom_num(le)}"}} {c}')
            lines.append(f"{pn}_sum {_prom_num(v['sum'])}")
            lines.append(f"{pn}_count {v['count']}")
        else:
            lines.append(f"# TYPE {pn} gauge")
            lines.append(f"{pn} {_prom_num(v)}")
    return "\n".join(lines) + "\n"
