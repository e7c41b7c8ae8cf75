"""Tracing and profiling utilities (the port of
``sparkdq4ml_tpu/utils/profiling.py``).

* :class:`PhaseTimer`: per-phase wall clock for the pipeline runner, with
  a cold first run and a steady median beside it;
* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace of the block;
* :func:`block_until_ready`: honest timing (CUDA launches are
  asynchronous; a timing without a sync measures the enqueue only);
* :data:`counters`: process-global named counters (``pipeline.*``,
  ``frame.host_sync``, ``stats.*``, ...).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Optional

import torch

logger = logging.getLogger("sparkdq4ml_tpu_torch.profiling")


def _devices(tree, out: set) -> None:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)


def block_until_ready(tree):
    """Wait for the device work behind every CUDA tensor in ``tree`` (a
    tensor, or dicts, lists and tuples of them); returns ``tree``. A
    no-op for CPU tensors and anything else."""
    devices: set = set()
    _devices(tree, devices)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


class Counters:
    """Thread-safe named monotonic counters. ``snapshot()`` returns a plain
    dict for reports and assertions."""

    def __init__(self):
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def increment(self, name: str, by: int = 1) -> int:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + by
            return self._counts[name]

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self, prefix: str = "") -> dict:
        with self._lock:
            return {k: v for k, v in self._counts.items()
                    if k.startswith(prefix)}

    def clear(self, prefix: str = "") -> None:
        with self._lock:
            if not prefix:
                self._counts.clear()
            else:
                for k in [k for k in self._counts if k.startswith(prefix)]:
                    del self._counts[k]


#: Process-global counter registry (see :class:`Counters`).
counters = Counters()


class PhaseTimer:
    """Collects named phase durations; ``report()`` returns a dict.

    A first (cold) run through a phase pays the kernels' builds, the
    pipeline's first flushes and the allocator's growth; :meth:`steady`
    re-runs the phase so :meth:`report_pairs` shows (cold, steady) side
    by side."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.steadies: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                block_until_ready(sync)
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            logger.debug("phase %-20s %8.3f ms", name, dt * 1e3)

    def steady(self, name: str, fn, reps: int = 3, sync=None):
        """Median steady-state wall clock of ``fn()`` over ``reps`` calls
        (run it after the cold :meth:`phase`); returns the last result.

        :func:`block_until_ready` waits only for tensors: an opaque result
        (a Frame, a fitted model) passes through without waiting for its
        device work. Pass ``sync`` to extract a tensor from the result
        (``lambda f: f.mask``) so the timing includes that work."""
        times = []
        out = None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            block_until_ready(sync(out) if sync is not None else out)
            times.append(time.perf_counter() - t0)
        times.sort()
        self.steadies[name] = times[len(times) // 2]
        logger.debug("steady %-19s %8.3f ms", name,
                     self.steadies[name] * 1e3)
        return out

    def report(self) -> dict[str, float]:
        return dict(self.phases)

    def report_pairs(self) -> dict[str, dict[str, Optional[float]]]:
        """{phase: {"cold": s|None, "steady": s|None}}; steady-only names
        are reported, not dropped."""
        names = list(self.phases) + [n for n in self.steadies
                                     if n not in self.phases]
        return {name: {"cold": self.phases.get(name),
                       "steady": self.steadies.get(name)}
                for name in names}


def _profiler_activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace of the block, written as a Chrome trace
    (``trace.json``) into ``log_dir``; a no-op when ``log_dir`` is
    None."""
    if log_dir is None:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_profiler_activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# Managed profiler captures
# ---------------------------------------------------------------------------
#
# Captures land under one base directory, named
# ``cap-<timestamp>-<pid>-<label>``; retention is bounded (the oldest are
# pruned) and one capture runs at a time per process.

#: Hard ceiling on an armed capture's duration (seconds).
MAX_CAPTURE_S = 60.0

#: Captures kept by :func:`prune_captures` when no bound is given.
MAX_CAPTURES = 8

_CAPTURE_LOCK = threading.Lock()
_CAPTURE_ACTIVE: Optional[str] = None     # path of the running capture
_CAPTURE_PROFILER = None


def capture_base_dir() -> str:
    """Home of managed captures: ``SPARKDQ4ML_CAPTURE_DIR`` if set, else
    ``~/.cache/sparkdq4ml_tpu_torch/captures``."""
    env = os.environ.get("SPARKDQ4ML_CAPTURE_DIR")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "sparkdq4ml_tpu_torch", "captures")


def captures() -> list:
    """Managed capture directories, oldest first (the names carry the
    time, so their order is their age)."""
    base = capture_base_dir()
    try:
        return sorted(
            os.path.join(base, d) for d in os.listdir(base)
            if d.startswith("cap-")
            and os.path.isdir(os.path.join(base, d)))
    except OSError:
        return []


def latest_capture() -> Optional[str]:
    caps = captures()
    return caps[-1] if caps else None


def prune_captures(keep: Optional[int] = None) -> int:
    """Drop the oldest managed captures past ``keep`` (default
    :data:`MAX_CAPTURES`); returns how many went. Never raises."""
    import shutil

    keep = max(int(MAX_CAPTURES if keep is None else keep), 1)
    pruned = 0
    for path in captures()[:-keep]:
        shutil.rmtree(path, ignore_errors=True)
        pruned += 1
    return pruned


def capture_active() -> Optional[str]:
    with _CAPTURE_LOCK:
        return _CAPTURE_ACTIVE


def start_capture(seconds: float, label: str = "manual") -> str:
    """Arm one managed ``torch.profiler`` capture for ``seconds`` (clamped
    to :data:`MAX_CAPTURE_S`); a background timer stops it. Returns the
    capture path; raises ``RuntimeError`` while another capture runs."""
    import re

    global _CAPTURE_ACTIVE, _CAPTURE_PROFILER
    seconds = min(max(float(seconds), 0.05), MAX_CAPTURE_S)
    safe = re.sub(r"[^A-Za-z0-9_.-]+", "_", str(label))[:48] or "manual"
    name = f"cap-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}-{safe}"
    path = os.path.join(capture_base_dir(), name)
    with _CAPTURE_LOCK:
        if _CAPTURE_ACTIVE is not None:
            raise RuntimeError(
                f"a profiler capture is already running "
                f"({_CAPTURE_ACTIVE}); one capture at a time")
        os.makedirs(path, exist_ok=True)
        prof = torch.profiler.profile(activities=_profiler_activities())
        prof.start()
        _CAPTURE_ACTIVE, _CAPTURE_PROFILER = path, prof
    counters.increment("profiling.captures")

    def _stop(armed=path):
        time.sleep(seconds)
        stop_capture(expected=armed)

    threading.Thread(target=_stop, daemon=True,
                     name="sparkdq4ml-capture-timer").start()
    return path


def stop_capture(expected: Optional[str] = None) -> Optional[str]:
    """Stop the running capture and write its Chrome trace (idempotent);
    returns its path, or None when nothing ran. ``expected`` stops only
    that capture (the timer's contract)."""
    global _CAPTURE_ACTIVE, _CAPTURE_PROFILER
    with _CAPTURE_LOCK:
        if expected is not None and _CAPTURE_ACTIVE != expected:
            return None
        path, _CAPTURE_ACTIVE = _CAPTURE_ACTIVE, None
        prof, _CAPTURE_PROFILER = _CAPTURE_PROFILER, None
        if path is None:
            return None
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(path, "trace.json"))
        except Exception:
            logger.debug("profiler stop failed", exc_info=True)
    prune_captures()
    return path


@contextlib.contextmanager
def timed(label: str = "block", sync=None):
    """Log the wall clock of a block. Pass ``sync`` (tensors, or a
    zero-argument callable returning them at exit) to wait for their
    device work before the clock stops."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        block_until_ready(sync() if callable(sync) else sync)
    logger.info("%s took %.3f ms", label, (time.perf_counter() - t0) * 1e3)
