"""Process-wide defaults of the PyTorch port (subset of
``sparkdq4ml_tpu/config.py``): the float and int dtype policy, the
``show()`` row default, the device a session runs on, the native CSV
ingest settings (``spark.ingest.*`` in a session's conf), the fused
pipeline's and the plan-statistics store's switches and bounds
(``spark.pipeline.*``, ``spark.stats.*``), and the planner's
(``spark.optimizer.*``, ``spark.aqe.*``, ``spark.costprof.*``,
``spark.explain.*``, ``spark.audit.deviceBudget``/``memoryFraction``),
and the data-quality observatory's (``spark.dq.*``).

There is no kernel on/off switch: a wrapper in ``ops/kernels.py`` launches
its CUDA kernel on a CUDA tensor and runs its plain PyTorch version on a
CPU tensor, and on nothing else.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class _Config:
    # Default floating dtype for frame columns and solvers: float32 on the
    # card; the CPU parity tests select float64, as the JAX suite does.
    default_float_dtype: torch.dtype = torch.float32
    # Spark CSV inference yields IntegerType -> int32.
    default_int_dtype: torch.dtype = torch.int32
    # Rows shown by Frame.show() when no argument is given (Spark: 20).
    default_show_rows: int = 20
    # Device of a session whose conf does not set spark.torch.device.
    default_device: str = "cuda"
    # Native CSV ingest (frame/native_csv.py). Files larger than one chunk
    # parse through the native stream in chunks cut on record boundaries,
    # a producer thread running the parse up to ``ingest_prefetch`` chunks
    # ahead of the copies to the device (spark.ingest.streaming; False
    # parses every file in one call).
    ingest_streaming: bool = True
    # Parse threads a chunk: 0 lets the native layer choose
    # (spark.ingest.threads).
    ingest_threads: int = 0
    # Chunk size in bytes, and the size above which a file streams
    # (spark.ingest.chunkBytes).
    ingest_chunk_bytes: int = 8 << 20
    # Parsed chunks the producer may run ahead; 0 parses inline
    # (spark.ingest.prefetch).
    ingest_prefetch: int = 2
    # SIMD tier of the parse: "auto", "off", "avx2" or "avx512", clamped to
    # what the CPU has (spark.ingest.simd).
    ingest_simd: str = "auto"
    # Fused expression pipeline (ops/compiler.py): consecutive compilable
    # Frame.with_column/filter ops defer and run as one cached plan per
    # structural plan key (spark.pipeline.enabled; False restores the exact
    # per-op eager path).
    pipeline: bool = True
    # Plan-statistics store (utils/statstore.py): per-plan-key observed
    # selectivity, wall-time digests, estimated bytes (spark.stats.enabled;
    # false reduces every hook to one flag read).
    stats_enabled: bool = True
    # Snapshot path for cross-session persistence (spark.stats.path);
    # empty = in memory only. Loaded at session start, written by stop()
    # when stats_flush_on_stop (spark.stats.flushOnStop).
    stats_path: str = ""
    stats_flush_on_stop: bool = True
    # Bounded entry table of the statstore (spark.stats.maxEntries): past
    # it the least recently updated entry goes.
    stats_max_entries: int = 512
    # Row-bucket floor of the pipeline (spark.pipeline.minBucket) and the
    # bound of its plan LRU, shared by the grouped engine's plan cache
    # (spark.pipeline.cacheSize).
    pipeline_min_bucket: int = 8
    pipeline_cache_size: int = 256
    # Cost-based optimizer (sql/optimizer.py, spark.optimizer.enabled):
    # pushdown, pruning and build-side hints before execution; level 2
    # (spark.optimizer.level) adds join reordering and the compiler's
    # stage split.
    optimizer_enabled: bool = True
    optimizer_level: int = 1
    # Adaptive execution (sql/adaptive.py, spark.aqe.enabled): re-plans
    # from counts a running query observed once they drift past
    # aqe_drift_factor (spark.aqe.driftFactor) from the estimates.
    aqe_enabled: bool = True
    aqe_drift_factor: float = 4.0
    # Cost profiles (utils/costprof.py, spark.costprof.enabled) and the
    # roofline ridge in flops per byte (spark.costprof.ridge).
    costprof_enabled: bool = True
    costprof_ridge: float = 8.0
    # EXPLAIN ANALYZE: memory sampling at span boundaries
    # (spark.explain.memory) and its == Caches == section
    # (spark.explain.caches).
    explain_memory: bool = True
    explain_caches: bool = True
    # A flush's device-byte budget: audit_device_budget x
    # audit_memory_fraction when the budget is set (spark.audit.deviceBudget
    # in bytes, 0 = none; spark.audit.memoryFraction).
    audit_device_budget: int = 0
    audit_memory_fraction: float = 0.9
    # Data-quality observatory (utils/dqprof.py): each flush's columns
    # sketched and each DQ rule's evaluations tallied, deferred to a drain
    # on the cold surfaces (spark.dq.profile.enabled; false reduces every
    # hook to one flag read). The histogram's buckets
    # (spark.dq.histogramBins), the PSI past which a column drifts
    # (spark.dq.driftThreshold) and the drift reference
    # (spark.dq.baselineMode: "first", "persisted" or "off").
    dq_profile_enabled: bool = True
    dq_histogram_bins: int = 32
    dq_drift_threshold: float = 0.25
    dq_baseline_mode: str = "first"


config = _Config()

CONF_FALSE = ("false", "off", "0", "no")
CONF_TRUE = ("true", "on", "1", "yes")


def _flag(value: str):
    v = value.strip().lower()
    return True if v in CONF_TRUE else False if v in CONF_FALSE else None


# Session conf keys of the ingest settings: key -> (attribute, parser); a
# parser's None leaves the setting as it is.
INGEST_KEYS = {
    "spark.ingest.streaming": ("ingest_streaming", _flag),
    "spark.ingest.threads": ("ingest_threads", int),
    "spark.ingest.chunkBytes": ("ingest_chunk_bytes", int),
    "spark.ingest.prefetch": ("ingest_prefetch", int),
    "spark.ingest.simd": ("ingest_simd", lambda v: v.strip().lower()),
}

# The fused pipeline's and the statstore's keys, in the same form.
PIPELINE_KEYS = {
    "spark.pipeline.enabled": ("pipeline", _flag),
    "spark.pipeline.minBucket": ("pipeline_min_bucket", int),
    "spark.pipeline.cacheSize": ("pipeline_cache_size", int),
    "spark.stats.enabled": ("stats_enabled", _flag),
    "spark.stats.path": ("stats_path", str),
    "spark.stats.maxEntries": ("stats_max_entries", int),
    "spark.stats.flushOnStop": ("stats_flush_on_stop", _flag),
}

# The planner's keys (optimizer, adaptive execution, cost profiles,
# EXPLAIN and the flush budget), in the same form.
PLANNER_KEYS = {
    "spark.optimizer.enabled": ("optimizer_enabled", _flag),
    "spark.optimizer.level": ("optimizer_level", int),
    "spark.aqe.enabled": ("aqe_enabled", _flag),
    "spark.aqe.driftFactor": ("aqe_drift_factor", float),
    "spark.costprof.enabled": ("costprof_enabled", _flag),
    "spark.costprof.ridge": ("costprof_ridge", float),
    "spark.explain.memory": ("explain_memory", _flag),
    "spark.explain.caches": ("explain_caches", _flag),
    "spark.audit.deviceBudget": ("audit_device_budget", int),
    "spark.audit.memoryFraction": ("audit_memory_fraction", float),
}

# The data-quality observatory's keys, in the same form.
DQ_KEYS = {
    "spark.dq.profile.enabled": ("dq_profile_enabled", _flag),
    "spark.dq.histogramBins": ("dq_histogram_bins", int),
    "spark.dq.driftThreshold": ("dq_drift_threshold", float),
    "spark.dq.baselineMode": ("dq_baseline_mode", str),
}


def apply_conf(conf: dict, saved: dict) -> None:
    """Set the settings that ``conf`` names, recording each setting's value
    before its first change into ``saved`` (for :func:`restore_conf`)."""
    for key, (attr, parse) in {**INGEST_KEYS, **PIPELINE_KEYS,
                               **PLANNER_KEYS, **DQ_KEYS}.items():
        if key in conf:
            value = parse(str(conf[key]))
            if value is not None:
                saved.setdefault(attr, getattr(config, attr))
                setattr(config, attr, value)


def restore_conf(saved: dict) -> None:
    for attr, value in saved.items():
        setattr(config, attr, value)
    saved.clear()


def float_dtype() -> torch.dtype:
    return config.default_float_dtype


def int_dtype() -> torch.dtype:
    return config.default_int_dtype


def wide_types() -> bool:
    """True under the float64 policy: the counterpart of JAX's x64 mode,
    where 64-bit numpy inputs keep their width instead of narrowing."""
    return config.default_float_dtype == torch.float64


@contextlib.contextmanager
def float_policy(dtype: torch.dtype):
    """Run a block under another float dtype, restoring the old one."""
    old = config.default_float_dtype
    config.default_float_dtype = dtype
    try:
        yield
    finally:
        config.default_float_dtype = old


_NUMPY_OF = {torch.float32: np.float32, torch.float64: np.float64,
             torch.int32: np.int32, torch.int64: np.int64,
             torch.bool: np.bool_}


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(_NUMPY_OF[dtype])


def check_device(device) -> torch.device:
    """The device a caller asked for, refusing a CUDA device that is absent:
    the port never continues on the CPU when the card was asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was requested but no CUDA device is "
            "present; set spark.torch.device=cpu to run on the CPU")
    return dev


def resolve_device(device=None) -> torch.device:
    """``device`` if given, else the active session's, else the default."""
    if device is not None:
        return check_device(device)
    from .session import TorchSession

    active = TorchSession.active()
    if active is not None:
        return active.device
    return check_device(config.default_device)


def as_tensor(values, dtype: torch.dtype = None) -> torch.Tensor:
    """Tensor of ``values``: a tensor keeps its device, anything else goes
    to the resolved device (see :func:`resolve_device`)."""
    if isinstance(values, torch.Tensor):
        return values if dtype is None else values.to(dtype)
    return torch.as_tensor(np.asarray(values), dtype=dtype,
                           device=resolve_device())
