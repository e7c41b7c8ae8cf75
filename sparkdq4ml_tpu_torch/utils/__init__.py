"""Utilities of the torch port: JAX's threefry streams (``prng``), the
counters, ``PhaseTimer`` and profiler traces (``profiling``), logging
(``logging``), spans, metrics and the cache registry (``observability``)
and the plan-statistics store (``statstore``)."""

from . import observability
from .logging import configure_logging, format_kv
from .observability import METRICS, TRACER, metrics_snapshot, prometheus_text
from .profiling import PhaseTimer, block_until_ready, counters, timed, trace
