"""Device-memory accounting: live and peak bytes (the port of
``sparkdq4ml_tpu/utils/meminfo.py``).

Two sources, as in the JAX package:

* **Allocator statistics** (``torch.cuda.memory_stats``,
  ``max_memory_allocated``, ``mem_get_info``) on every initialized card:
  the bytes the caching allocator holds for live tensors, its peak, and
  the card's byte limit. They cost no device synchronization and are
  what :func:`sample` and the per-span sampler read. On the CPU there
  are none (``device_stats()`` is empty, as on XLA:CPU).
* **A census of live tensors** (every ``torch.Tensor`` the process still
  references, found through the garbage collector and summed by
  ``nbytes``): attributable by dtype and by buffer, on any device, at
  the cost of a walk over the interpreter's objects; only
  :func:`memory_report` takes it.

Sampling feeds the ``mem.live_bytes``/``mem.peak_bytes`` gauges and,
while ``TRACER.mem_sample`` is on (EXPLAIN ANALYZE turns it on for one
query under ``spark.explain.memory``), a ``peak_mem`` attribute on every
finished span: the larger of the allocator's bytes in use at span entry
and exit, raised to its peak when the peak moved inside the span.
Nothing here runs on the default path.
"""

from __future__ import annotations

import gc
import threading
import warnings

import torch

#: Process peak of the sampled live bytes (monotone; :func:`reset_peak`).
_PEAK_LOCK = threading.Lock()
_PEAK_BYTES = 0


def _cards() -> list:
    """The CUDA devices this process has initialized (none on the CPU)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def live_bytes() -> int:
    """Bytes the caching allocator holds for live tensors on every
    initialized card (0 on the CPU). No synchronization."""
    return sum(int(torch.cuda.memory_allocated(d)) for d in _cards())


def estimated_bytes(tree) -> int:
    """Shape-and-dtype byte estimate of a nest of dicts, lists and tuples
    whose leaves are tensors or numpy arrays (``numel`` x element size);
    never a device read."""
    if isinstance(tree, dict):
        return sum(estimated_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(estimated_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    nbytes = getattr(tree, "nbytes", None)
    return int(nbytes) if isinstance(nbytes, int) else 0


def device_stats() -> list:
    """Allocator statistics of every initialized card (``[]`` on the
    CPU), under the JAX package's names: ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit`` (the card's total memory) and
    ``num_allocs``."""
    out = []
    for d in _cards():
        st = torch.cuda.memory_stats(d)
        _free, total = torch.cuda.mem_get_info(d)
        out.append({
            "device": str(d), "platform": "gpu",
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "num_allocs": int(st.get("allocation.all.current", 0)),
        })
    return out


def _allocator_peak() -> int:
    return sum(int(torch.cuda.max_memory_allocated(d)) for d in _cards())


def peak_bytes() -> int:
    """The process peak of the sampled live bytes, raised to the
    allocator's peak where there is one."""
    with _PEAK_LOCK:
        peak = _PEAK_BYTES
    return max(peak, _allocator_peak())


def reset_peak() -> None:
    """Forget the peak: the sampled one and the allocator's."""
    global _PEAK_BYTES
    with _PEAK_LOCK:
        _PEAK_BYTES = 0
    for d in _cards():
        torch.cuda.reset_peak_memory_stats(d)


def sample(update_gauges: bool = True) -> int:
    """One sample of the live bytes, folded into the peak and (by
    default) the ``mem.live_bytes``/``mem.peak_bytes`` gauges. Returns
    the live bytes."""
    global _PEAK_BYTES
    b = live_bytes()
    with _PEAK_LOCK:
        if b > _PEAK_BYTES:
            _PEAK_BYTES = b
        peak = _PEAK_BYTES
    if update_gauges:
        from . import observability as _obs

        _obs.METRICS.set_gauge("mem.live_bytes", b)
        _obs.METRICS.set_gauge("mem.peak_bytes", max(peak, _allocator_peak()))
    return b


def _live_tensors() -> list:
    """Every tensor the process references, each storage once (views of
    one storage count its bytes once), meta tensors left out."""
    seen, out = set(), []
    with warnings.catch_warnings():
        # a deprecated module attribute warns when isinstance probes it
        warnings.simplefilter("ignore")
        objs = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
    for obj in objs:
        if obj.is_meta:
            continue
        try:
            ptr = (obj.device, obj.untyped_storage().data_ptr())
        except RuntimeError:
            continue
        if ptr in seen:
            continue
        seen.add(ptr)
        out.append(obj)
    return out


def memory_report(top: int = 5) -> dict:
    """One merged view (``session.memory_report()``):

    * ``live_bytes``/``peak_bytes``/``live_arrays``: the census of live
      tensors (each storage once) and the peak,
    * ``by_dtype``: live bytes per dtype, descending,
    * ``largest``: the ``top`` biggest live tensors (shape, dtype, bytes),
    * ``devices``: the cards' allocator statistics,
    * ``backend``: ``cuda`` when a card is initialized, else ``cpu``.
    """
    global _PEAK_BYTES
    tensors = _live_tensors()
    by_dtype: dict = {}
    buffers = []
    total = 0
    for t in tensors:
        nb = t.untyped_storage().nbytes()
        total += nb
        dt = str(t.dtype).replace("torch.", "")
        by_dtype[dt] = by_dtype.get(dt, 0) + nb
        buffers.append((nb, list(t.shape), dt, str(t.device)))
    buffers.sort(key=lambda b: b[0], reverse=True)
    with _PEAK_LOCK:
        if total > _PEAK_BYTES:
            _PEAK_BYTES = total
        peak = _PEAK_BYTES
    return {
        "backend": "cuda" if _cards() else "cpu",
        "live_bytes": total,
        "peak_bytes": max(peak, _allocator_peak()),
        "live_arrays": len(tensors),
        "by_dtype": dict(sorted(by_dtype.items(), key=lambda kv: -kv[1])),
        "largest": [{"bytes": nb, "shape": shape, "dtype": dt,
                     "device": dev}
                    for nb, shape, dt, dev in buffers[:max(int(top), 0)]],
        "devices": device_stats(),
    }


class SpanSampler:
    """Entry/exit sampling of one span (made only when
    ``TRACER.mem_sample`` is on): ``peak_mem`` is the larger of the live
    bytes at the two boundaries, raised to the allocator's peak when that
    peak moved inside the span."""

    __slots__ = ("entry_bytes", "entry_alloc_peak")

    def __init__(self):
        self.entry_bytes = sample(update_gauges=False)
        self.entry_alloc_peak = _allocator_peak()

    def finish(self) -> dict:
        exit_bytes = sample()
        peak = max(self.entry_bytes, exit_bytes)
        alloc_peak = _allocator_peak()
        if alloc_peak > self.entry_alloc_peak:
            peak = max(peak, alloc_peak)
        return {"peak_mem": peak, "mem_live_bytes": exit_bytes}
