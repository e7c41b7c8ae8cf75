"""Cost profiles: per-plan counted work and roofline verdicts (the port of
``sparkdq4ml_tpu/utils/costprof.py`` and of the extractor in its
``analysis/program/costs.py``).

Every ``observability.CACHES``-enumerable program gets a
:class:`CostProfile`: its floating-point operations, its transcendental
operations and the bytes it reads and writes. The JAX package takes them
from XLA's ``cost_analysis`` after an ahead-of-time compile; the port
counts them itself, without running anything on a device:

* a **pipeline plan** (``ops/compiler.py``) runs its lowered steps on
  small CPU tensors of ones at two row counts under a
  ``TorchFunctionMode`` that counts, for each torch operation, the bytes
  of its tensor inputs and result and one operation a result element (a
  transcendental one for ``exp``, ``log``, ``sqrt``, the trigonometric
  family, ``pow``, ...; two a multiply-add of a matrix product); a view
  moves nothing. A plan's steps are elementwise, so its cost is affine in
  the rows, and the two counts extend to the rows of its first run
  (counting on ``meta`` tensors would cost a second's import on first
  use);
* a **grouped plan** (``ops/segments.py``) and a **hand kernel**
  (``ops/kernels.py``) are counted by the work formula of the kernel
  bounds in PERF.md: 17 B a row for ``dq_rules`` (two float32 columns
  read, two written, one mask byte), n·D·(D+1) operations and the design
  read once for the Gramians, an id and C floats a row read and the
  table written for the segment sums.

The port's figures are its own count and differ from XLA's. A profile is
cached per plan key and persisted into the statstore (``record_cost``),
where the optimizer's join reorder reads its flops.

Achieved rates join a profile with the median time of the plan's runs at
the profile's size: on the card its device time (two CUDA events around
each run, read lazily on the cold surfaces), on the CPU its host time; a
hand kernel's time is its own launches', two CUDA events its wrapper
(``ops/kernels.py``) records around each of the first runs of a size.
EXPLAIN ANALYZE's columns use the node's
measured wall instead, as in the JAX package.
Roofline: arithmetic intensity (flops per byte) at or above
``spark.costprof.ridge`` is ``compute``-bound, below it ``memory``-bound;
a program that paid a host read while moving almost nothing is
``sync``-bound; an operator with no device program is ``host``.
``spark.costprof.enabled=false`` reduces every hook to one flag read.
"""

from __future__ import annotations

import logging
import statistics
import threading
import time
from typing import Optional

import torch

from ..config import config
from .profiling import counters

logger = logging.getLogger("sparkdq4ml_tpu_torch.costprof")

#: A profile below BOTH floors that still paid a host read is verdicted
#: ``sync``-bound (the JAX package's floors).
SYNC_FLOOR_BYTES = 1 << 16
SYNC_FLOOR_FLOPS = 1e5

#: At most this many NEW extractions a cold-surface call (the JAX
#: package's budget); the rest report as pending.
EXTRACT_BUDGET = 8


class CostProfile:
    """One program's counted cost: flops, transcendentals, bytes read and
    written, bytes written, and the JAX package's other fields (empty on
    one device)."""

    __slots__ = ("flops", "transcendentals", "bytes_accessed",
                 "output_bytes", "collectives", "peak_bytes",
                 "argument_bytes", "devices", "extract_ms")

    def __init__(self, flops=0.0, transcendentals=0.0, bytes_accessed=0.0,
                 output_bytes=0.0, collectives=None, peak_bytes=None,
                 argument_bytes=None, devices=1, extract_ms=None):
        self.flops = float(flops)
        self.transcendentals = float(transcendentals)
        self.bytes_accessed = float(bytes_accessed)
        self.output_bytes = float(output_bytes)
        self.collectives = dict(collectives or {})
        self.peak_bytes = None if peak_bytes is None else int(peak_bytes)
        self.argument_bytes = (None if argument_bytes is None
                               else int(argument_bytes))
        self.devices = int(devices)
        self.extract_ms = extract_ms

    @property
    def collective_bytes(self) -> int:
        return int(sum(self.collectives.values()))

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, flops per byte accessed."""
        return self.flops / max(self.bytes_accessed, 1.0)

    def to_doc(self) -> dict:
        doc = {"flops": self.flops, "transcendentals": self.transcendentals,
               "bytes_accessed": self.bytes_accessed,
               "output_bytes": self.output_bytes, "devices": self.devices}
        if self.collectives:
            doc["collectives"] = dict(self.collectives)
        if self.peak_bytes is not None:
            doc["peak_bytes"] = self.peak_bytes
        if self.argument_bytes is not None:
            doc["argument_bytes"] = self.argument_bytes
        if self.extract_ms is not None:
            doc["extract_ms"] = self.extract_ms
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "CostProfile":
        return cls(flops=doc.get("flops", 0.0),
                   transcendentals=doc.get("transcendentals", 0.0),
                   bytes_accessed=doc.get("bytes_accessed", 0.0),
                   output_bytes=doc.get("output_bytes", 0.0),
                   collectives=doc.get("collectives"),
                   peak_bytes=doc.get("peak_bytes"),
                   argument_bytes=doc.get("argument_bytes"),
                   devices=doc.get("devices", 1),
                   extract_ms=doc.get("extract_ms"))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"CostProfile(flops={self.flops:g}, "
                f"bytes={self.bytes_accessed:g})")


# ---------------------------------------------------------------------------
# Roofline arithmetic (the JAX package's, unchanged)
# ---------------------------------------------------------------------------

def enabled() -> bool:
    return bool(config.costprof_enabled)


def achieved(profile: Optional[CostProfile],
             wall_ms: Optional[float]) -> tuple:
    """``(gflops, gbps)`` achieved at a measured time, None/None when
    either side is unknown."""
    if profile is None or not wall_ms or wall_ms <= 0:
        return (None, None)
    secs = wall_ms / 1e3
    return (round(profile.flops / secs / 1e9, 3),
            round(profile.bytes_accessed / secs / 1e9, 3))


def roofline(profile: Optional[CostProfile],
             host_syncs: int = 0) -> Optional[str]:
    """The ``bound`` verdict: ``host`` without a device program, ``sync``
    when it paid a host read over near-zero work, else ``compute`` or
    ``memory`` by intensity against ``spark.costprof.ridge``."""
    if profile is None:
        return "host"
    if host_syncs and profile.bytes_accessed < SYNC_FLOOR_BYTES \
            and profile.flops < SYNC_FLOOR_FLOPS:
        return "sync"
    if profile.intensity >= float(config.costprof_ridge):
        return "compute"
    return "memory"


# ---------------------------------------------------------------------------
# Counting: torch operations over small CPU tensors, extended to the rows
# ---------------------------------------------------------------------------

#: Operations counted as transcendental (one a result element).
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh",
    "cosh", "tanh", "asinh", "acosh", "atanh", "pow", "erf", "erfc",
    "erfinv", "sigmoid", "hypot",
})

#: Operations that move or make data and do no arithmetic.
_MOVES = frozenset({
    "to", "type", "float", "double", "int", "long", "bool", "copy_",
    "clone", "contiguous", "full", "full_like", "fill_", "empty",
    "empty_like", "zeros", "zeros_like", "ones", "ones_like", "tensor",
    "as_tensor", "index_select", "cat", "stack", "gather", "getitem",
    "arange", "new_full", "new_zeros", "new_empty", "where",
})

#: The row counts a plan is counted at; its cost is affine in the rows
#: (elementwise steps, fills and the mask's AND), so two sizes fix it.
_COUNT_ROWS = (2, 4)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(out: torch.Tensor, ins: list) -> bool:
    ptr = out.untyped_storage().data_ptr()
    return any(t.untyped_storage().data_ptr() == ptr for t in ins)


def _op_counter():
    """A ``TorchFunctionMode`` that counts each torch operation with a
    tensor result: the bytes of its tensor inputs (read once) and of its
    result (written once), nothing for a view of an input, and one
    operation a result element (a transcendental one for ``exp``, ...;
    two a multiply-add of a matrix product; one an input element for a
    reduction). A nested call inside an operation is not seen."""
    from torch.overrides import TorchFunctionMode

    class _OpCounter(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.flops = 0.0
            self.transcendentals = 0.0
            self.bytes = 0.0
            self.out_bytes = 0.0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            outs = _tensors(out)
            if not outs:
                return out
            ins = _tensors(args) + _tensors(kwargs)
            outs = [t for t in outs if not _is_view(t, ins)]
            if not outs:
                return out
            name = getattr(func, "__name__", "").strip("_")
            if name[:1] in ("r", "i") and name[1:] in (
                    "add", "sub", "mul", "truediv", "floordiv", "mod",
                    "pow", "and", "or", "xor"):
                name = name[1:]
            written = sum(_nbytes(t) for t in outs)
            self.bytes += sum(_nbytes(t) for t in ins) + written
            self.out_bytes += written
            n_out = sum(t.numel() for t in outs)
            if name in ("mm", "matmul", "bmm", "addmm"):
                a = [t for t in ins if t.dim() >= 2]
                k = a[0].shape[-1] if a else 1
                self.flops += 2.0 * n_out * k
            elif name in _TRANSCENDENTAL:
                self.transcendentals += n_out
            elif name.startswith(("sum", "mean", "amax", "amin", "prod",
                                  "cumsum", "any", "all")):
                self.flops += sum(t.numel() for t in ins)
            elif name not in _MOVES:
                self.flops += n_out
            return out

    return _OpCounter()


def count(fn, *args, **kwargs) -> CostProfile:
    """The counted cost of ``fn(*args, **kwargs)``, run on the tensors
    given (small CPU ones: the count runs them)."""
    counter = _op_counter()
    with counter:
        fn(*args, **kwargs)
    return CostProfile(flops=counter.flops,
                       transcendentals=counter.transcendentals,
                       bytes_accessed=counter.bytes,
                       output_bytes=counter.out_bytes)


def _ones(spec, rows: int):
    shape, dtype = spec
    return torch.ones((rows,) + tuple(shape), dtype=dtype)


def _pipeline_profile(handle) -> CostProfile:
    """A pipeline plan's steps counted on the CPU over inputs of ones at
    two row counts and extended to the rows of its first run (which it
    ran at, unpadded; the JAX package's profile is of its padded
    example bucket): nothing runs on a device, and no work grows with
    the rows."""
    kept, donated, _bucket, lits = handle.args
    b = _size(handle)

    def at(rows):
        return count(handle.fn, {k: _ones(s, rows) for k, s in kept.items()},
                     tuple(_ones(s, rows) for s in donated),
                     torch.ones(rows, dtype=torch.bool), lits, rows,
                     torch.device("cpu"))

    r1, r2 = _COUNT_ROWS
    p1, p2 = at(r1), at(r2)

    def ext(a, c):
        return a + (c - a) * (b - r1) / (r2 - r1)

    return CostProfile(
        flops=ext(p1.flops, p2.flops),
        transcendentals=ext(p1.transcendentals, p2.transcendentals),
        bytes_accessed=ext(p1.bytes_accessed, p2.bytes_accessed),
        output_bytes=ext(p1.output_bytes, p2.output_bytes))


def kernel_profile(name: str, dims: dict) -> CostProfile:
    """A hand kernel's work from its call's dimensions, the formulas of
    the kernel bounds (PERF.md): ``dq_rules`` n rows of ``itemsize``
    floats (two read, two written, a mask byte); the Gramians n·D·(D+1)
    operations (one triangle) over the design read once and the D×D
    result written; the segment sums an id (``id_bytes``, 0 without ids)
    and ``cols`` floats a row read, one operation a value, and the
    ``size``-slot table written; ``dq_sketch`` each column, rule and mask
    read once (``bytes_a_row``), four operations a column value and one a
    rule value, the float64 sketch written."""
    n = int(dims.get("n", 0))
    s = int(dims.get("itemsize", 4))
    if name == "dq_rules":
        return CostProfile(bytes_accessed=n * (4 * s + 1),
                           output_bytes=n * (2 * s + 1))
    if name in ("packed_gram", "masked_gram"):
        D = int(dims["D"])
        read = (n * D * s if name == "packed_gram"
                else n * ((D - 1) * s + int(dims.get("w_itemsize", s))))
        return CostProfile(flops=float(n) * D * (D + 1),
                           bytes_accessed=read + D * D * s,
                           output_bytes=D * D * s)
    if name in ("dense_segment_sum", "sorted_segment_sum",
                "segment_sums"):
        c = int(dims.get("cols", 1))
        table = int(dims.get("size", 1)) * c * s
        return CostProfile(flops=float(n) * c,
                           bytes_accessed=n * (int(dims.get("id_bytes", 8))
                                               + c * s) + table,
                           output_bytes=table)
    if name == "dq_sketch":
        c, r = int(dims["cols"]), int(dims["rules"])
        out = 8 * (c * (6 + int(dims["bins"])) + 2 * r)
        return CostProfile(flops=float(n) * (4 * c + r),
                           bytes_accessed=n * int(dims["bytes_a_row"]) + out,
                           output_bytes=out)
    raise KeyError(f"no work formula for the kernel {name!r}")


# ---------------------------------------------------------------------------
# Run times by (plan key, size), read lazily
# ---------------------------------------------------------------------------

_EV_LOCK = threading.Lock()
_PENDING_EVENTS: list = []
_TIMES: dict = {}
_SOURCE: dict = {}                   # (key, size) -> "device" | "wall"
_STARTED: dict = {}                  # (key, size) -> runs timed
#: Runs timed a (plan key, size), the first ones; pending event pairs
#: past the bound are dropped unread (``costprof.events_dropped``).
_TIMES_KEEP = 16
_PENDING_MAX = 4096


def start_run(key: str, size: int, device):
    """A token that times one run of the plan at ``key`` over ``size``
    rows on ``device``: a started CUDA event on the card (its device
    time), the host clock on the CPU (synchronous there); None with
    profiles off, inside a graph capture, or once :data:`_TIMES_KEEP`
    runs of (key, size) were timed, so a steady path pays one lookup.
    Hand it to :func:`end_run`."""
    if not config.costprof_enabled:
        return None
    with _EV_LOCK:
        started = _STARTED.get((key, size), 0)
        if started >= _TIMES_KEEP:
            return None
        _STARTED[(key, size)] = started + 1
    if device.type == "cuda":
        if torch.cuda.is_current_stream_capturing():
            return None                 # a graph capture records no time
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return time.perf_counter()


def end_run(key: str, size: int, token, device) -> None:
    """End the run of the plan at ``key`` over ``size`` rows begun by
    :func:`start_run`: on the card an end event, the pair read on a cold
    surface (never here); on the CPU the host time."""
    if token is None:
        return
    if device.type != "cuda":
        record_time(key, size, 1e3 * (time.perf_counter() - token))
        return
    end = torch.cuda.Event(enable_timing=True)
    end.record(torch.cuda.current_stream(device))
    with _EV_LOCK:
        _PENDING_EVENTS.append((key, size, token, end))
        if len(_PENDING_EVENTS) > _PENDING_MAX:
            del _PENDING_EVENTS[0]
            counters.increment("costprof.events_dropped")


def record_time(key: str, size: int, ms: float,
                source: str = "wall") -> None:
    """One run's time of the plan at ``key`` over ``size`` rows: a
    device time from CUDA events, or a host wall time taken where the run
    had finished (after a host read, or on the CPU)."""
    if not config.costprof_enabled:
        return
    with _EV_LOCK:
        times = _TIMES.setdefault((key, int(size)), [])
        times.append(float(ms))
        del times[:-_TIMES_KEEP]
        _SOURCE[(key, int(size))] = source


def _drain_events() -> None:
    with _EV_LOCK:
        pending = list(_PENDING_EVENTS)
        _PENDING_EVENTS.clear()
    for key, size, start, end in pending:
        end.synchronize()
        record_time(key, size, start.elapsed_time(end), "device")


def time_ms(key: str, size: int) -> Optional[float]:
    """The median recorded time (ms) of the plan at ``key`` over ``size``
    rows, or None. Reads the pending CUDA events: a cold surface."""
    _drain_events()
    with _EV_LOCK:
        times = list(_TIMES.get((key, int(size))) or ())
    return statistics.median(times) if times else None


# ---------------------------------------------------------------------------
# Profile cache, extraction, report
# ---------------------------------------------------------------------------

_FAILED = object()
_PROFILES: dict = {}
_LOCK = threading.Lock()


def clear() -> None:
    """Drop every cached profile and recorded device time."""
    with _LOCK:
        _PROFILES.clear()
    with _EV_LOCK:
        _PENDING_EVENTS.clear()
        _TIMES.clear()
        _SOURCE.clear()
        _STARTED.clear()


def _stats_key(handle) -> str:
    return handle.meta.get("stats_key") or handle.program_key


def _extract(handle) -> Optional[CostProfile]:
    """One count through the ``cost_profile`` fault site: any failure,
    injected or real, leaves the plan unprofiled (``-`` on the surfaces,
    ``costprof.failed``, a recovery event) and never takes a surface
    down."""
    from . import faults as _faults

    try:
        _faults.inject("cost_profile")
        if handle.cache == "pipeline":
            prof = _pipeline_profile(handle)
        else:
            prof = kernel_profile(handle.meta["work"], handle.meta["dims"])
    except Exception as e:
        counters.increment("costprof.failed")
        from .recovery import RECOVERY_LOG

        RECOVERY_LOG.record(
            "cost_profile", "fallback", rung="unprofiled",
            cause=f"{type(e).__name__}: {e}",
            detail=f"cost extraction degraded; plan "
                   f"{handle.program_key[:80]!r} reports no profile")
        logger.debug("cost count failed for %r", handle.program_key[:80],
                     exc_info=True)
        return None
    counters.increment("costprof.extracted")
    if config.stats_enabled:
        from . import statstore as _stats

        _stats.STORE.record_cost(_stats_key(handle), f"cost:{handle.cache}",
                                 prof.to_doc())
    return prof


def _cache_get(key: str):
    with _LOCK:
        if key in _PROFILES:
            p = _PROFILES[key]
            return True, (None if p is _FAILED else p)
    return False, None


def _cache_put(key: str, profile: Optional[CostProfile]) -> None:
    with _LOCK:
        _PROFILES[key] = _FAILED if profile is None else profile


def _from_statstore(key: str) -> Optional[CostProfile]:
    if not config.stats_enabled:
        return None
    from . import statstore as _stats

    doc = _stats.STORE.cost(key)
    return CostProfile.from_doc(doc) if doc else None


def profiles_for(keys) -> dict:
    """``{key: CostProfile|None}`` for a batch of plan keys: cached, else
    adopted from the statstore, else counted (one registry enumeration a
    call). A key with no live program resolves None uncached."""
    if not enabled():
        return {k: None for k in keys if k}
    out: dict = {}
    missing: list = []
    for key in dict.fromkeys(k for k in keys if k):
        hit, prof = _cache_get(key)
        if hit:
            out[key] = prof
            continue
        prof = _from_statstore(key)
        if prof is not None:
            _cache_put(key, prof)
            out[key] = prof
        else:
            missing.append(key)
    if missing:
        from . import observability as _obs

        handles, _errors = _obs.CACHES.programs()
        by_key = {h.program_key: h for h in handles}
        for key in missing:
            h = by_key.get(key)
            if h is None:
                out[key] = None
                continue
            prof = _extract(h)
            _cache_put(key, prof)
            out[key] = prof
    return out


def profile_for(key: Optional[str]) -> Optional[CostProfile]:
    if not key:
        return None
    return profiles_for((key,)).get(key)


def extract_all(budget: Optional[int] = None) -> dict:
    """Every enumerable program's profile (at most ``budget`` new counts
    of pipeline plans; the rest pending): ``{key: {"cache", "profile",
    "pending", "stats_key", "size"}}``."""
    out: dict = {}
    if not enabled():
        return out
    budget = EXTRACT_BUDGET if budget is None else max(int(budget), 0)
    from . import observability as _obs

    handles, _errors = _obs.CACHES.programs()
    fresh = 0
    for h in handles:
        key = h.program_key
        if key in out:
            continue
        hit, prof = _cache_get(key)
        pending = False
        if not hit:
            prof = _from_statstore(key) or _from_statstore(_stats_key(h))
            if prof is not None:
                _cache_put(key, prof)
            elif h.cache != "pipeline" or fresh < budget:
                # a work formula costs nothing; a count runs the plan
                prof = _extract(h)
                _cache_put(key, prof)
                fresh += h.cache == "pipeline"
            else:
                pending = True
        out[key] = {"cache": h.cache, "profile": prof,
                    "pending": pending, "stats_key": _stats_key(h),
                    "size": _size(h)}
    return out


def _size(handle) -> Optional[int]:
    """The rows a handle's profile counts: the first run's of a pipeline
    plan (its example), of a grouped plan or of a kernel."""
    if handle.cache == "pipeline":
        return int(handle.meta.get("rows") or handle.args[2])
    return handle.meta.get("dims", {}).get("n")


def report(top: Optional[int] = None, budget: Optional[int] = None) -> dict:
    """The roofline table (``session.profile_report()``): one row per
    enumerable program (pipeline plans, grouped plans, the hand kernels
    launched so far), its counted cost, its achieved rates at its time
    (see the module docstring) and its verdict, ranked by wall-time
    share."""
    if not enabled():
        return {"enabled": False, "entries": [], "size": 0, "pending": 0}
    entries = extract_all(budget=budget)
    stats_entry = None
    if config.stats_enabled:
        from . import statstore as _stats

        _stats.STORE.drain_pending()
        stats_entry = _stats.STORE.entry
    rows = []
    total_wall = 0.0
    for key, info in entries.items():
        prof = info["profile"]
        st = (stats_entry(info["stats_key"])
              if stats_entry is not None else None) or {}
        wall = st.get("wall_ms") or {}
        wall_sum = float(wall.get("sum") or 0.0)
        t = (time_ms(key, info["size"]) if info["size"] is not None
             else None)
        time_of = None if t is None else _SOURCE.get((key, info["size"]))
        total_wall += wall_sum
        gflops, gbps = achieved(prof, t)
        rows.append({
            "key": key[:160], "cache": info["cache"],
            "pending": info["pending"],
            "flops": None if prof is None else prof.flops,
            "transcendentals": (None if prof is None
                                else prof.transcendentals),
            "bytes": None if prof is None else prof.bytes_accessed,
            "output_bytes": None if prof is None else prof.output_bytes,
            "flushes": int(st.get("flushes") or 0),
            "wall_ms_sum": round(wall_sum, 3),
            "time_ms": t, "time_of": time_of, "rows": info["size"],
            "gflops": gflops, "gbps": gbps,
            "bound": (roofline(prof, int(st.get("host_syncs") or 0))
                      if prof is not None else None),
            "_wall": wall_sum,
        })
    for r in rows:
        w = r.pop("_wall")
        r["device_time_share"] = (round(w / total_wall, 4)
                                  if total_wall > 0 else None)
    rows.sort(key=lambda r: -(r["device_time_share"] or 0.0))
    pending = sum(1 for r in rows if r["pending"])
    if top is not None:
        rows = rows[:max(int(top), 0)]
    return {"enabled": True, "entries": rows, "size": len(entries),
            "pending": pending, "total_wall_ms": round(total_wall, 3),
            "ridge_flops_per_byte": float(config.costprof_ridge)}


def kernel_handles() -> list:
    """Registry callback: one handle per hand kernel launched in this
    process, keyed ``kernel:<name>|<dims>`` by its last call
    (``ops/kernels.last_call``), counted by :func:`kernel_profile`."""
    from ..ops import kernels
    from . import observability as _obs

    return [_obs.ProgramHandle("kernels", kernel_key(name, dims), None,
                               meta={"work": name, "dims": dict(dims)})
            for name, dims in sorted(kernels.last_call.items())]


def kernel_key(name: str, dims: dict) -> str:
    """A hand kernel's profile key, ``kernel:<name>|<dims>``: the key its
    wrapper's launch times are recorded under."""
    spec = ",".join(f"{k}={v}" for k, v in sorted(dims.items()))
    return f"kernel:{name}|{spec}"


def _register() -> None:
    from . import observability as _obs

    _obs.CACHES.register_programs("kernels", kernel_handles)


_register()
