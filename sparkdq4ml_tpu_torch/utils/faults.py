"""Deterministic fault injection (the port of
``sparkdq4ml_tpu/utils/faults.py``).

A :class:`FaultPlan` schedules failures at named **sites** of the
execution path, keyed by a per-site attempt counter and a seed, so every
injected failure is reproducible run to run, and a schedule fires on the
same attempts in the port as in the JAX package (:func:`_det_uniform` is
the same crc32 draw).

Failure classes (``kind``):

* ``device_error``: raises :class:`InjectedDeviceError`, a subclass of
  ``torch.AcceleratorError``, the class a real CUDA fault surfaces as, so
  the catch paths cannot tell the two apart.
* ``nan``: poisons one element of one float leaf of a result (a diverged
  solver, a flaky transfer) at a seeded position, the leaves taken in the
  JAX package's order (dict keys sorted).
* ``preempt``: raises :class:`Preemption` (not a device error), which
  ``recovery.fit_or_resume`` turns into a checkpoint resume.
* ``io_error``, ``torn_chunk``, ``thread_death``, ``pool_exhaust``: the
  native CSV reader's faults; ``oom``: a shrunk flush budget
  (:func:`shrunk_budget`); ``stall``: a due-test of the adaptive planner.

:data:`FAULT_SITES` is the JAX package's registry, whole. The sites of
modules the port does not have yet (``gram_sharded``, ``shard_*``,
``mesh``, ``serve_*``, ``coalesce``, ``net_*``, ``incident``) fire
nowhere in it.

Activation: :func:`install_plan`, the :func:`inject_faults` context
manager, the ``SPARKDQ4ML_FAULTS`` environment variable or the session
conf ``spark.faults`` (with ``spark.faults.seed``), e.g.::

    SPARKDQ4ML_FAULTS="pipeline_flush:device_error:1;solver:nan:1"

Spec grammar: ``site:kind[:a1,a2,...][:p=prob][:n=count][:seed=s]``. An
attempt list fires on those 1-based attempts; ``p=`` fires as a seeded
Bernoulli draw per attempt; with neither, on attempt 1 only. With no plan
installed every hook is one ``is None`` check.
"""

from __future__ import annotations

import logging
import os
import threading
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

logger = logging.getLogger("sparkdq4ml_tpu_torch.faults")

ENV_VAR = "SPARKDQ4ML_FAULTS"

KINDS = ("device_error", "nan", "preempt", "device_drop",
         "io_error", "torn_chunk", "thread_death", "pool_exhaust",
         "breaker_trip", "oom", "conn_reset", "partial_write",
         "stall", "slow_client")

#: The fault-site registry (the JAX package's, letter for letter): site ->
#: the kinds its hooks honor. A hook must name a key of this dict: the
#: plan matches sites by string equality, so a misspelt site never fires.
FAULT_SITES = {
    "gram_sharded": ("device_error", "preempt", "nan"),
    "fit_packed": ("device_error", "preempt", "nan"),
    "solver": ("device_error", "preempt", "nan"),
    "fit": ("device_error", "preempt"),
    "mesh": ("device_drop",),
    "pipeline_flush": ("device_error", "nan"),
    "grouped_flush": ("device_error",),
    "shard_flush": ("device_error",),
    "shard_merge": ("device_error",),
    "ingest_native": ("io_error", "torn_chunk", "thread_death",
                      "pool_exhaust"),
    "serve_exec": ("device_error",),
    "serve_admit": ("breaker_trip", "oom"),
    "coalesce": ("device_error", "stall", "oom"),
    "oom": ("oom",),
    "stats_persist": ("io_error", "torn_chunk"),
    "incident": ("io_error",),
    "optimizer": ("device_error",),
    "aqe": ("device_error", "stall"),
    "cost_profile": ("device_error",),
    "dq_profile": ("device_error",),
    "net_accept": ("conn_reset",),
    "net_read": ("conn_reset", "stall", "slow_client"),
    "net_write": ("conn_reset", "partial_write", "stall"),
}


class InjectedDeviceError(torch.AcceleratorError):
    """Simulated device fault raised by the fault plan: caught wherever a
    real ``torch.AcceleratorError`` is."""


class Preemption(RuntimeError):
    """Simulated mid-fit preemption. Not a device error: retry loops must
    not swallow it; ``recovery.fit_or_resume`` owns it."""


class InjectedIOError(OSError):
    """Simulated I/O failure in the native ingest layer or the statstore's
    snapshot. An ``OSError``, but not a ``FileNotFoundError``: a missing
    file is permanent and must raise, never degrade."""


@dataclass
class FaultSpec:
    """One scheduled failure: ``kind`` at ``site``, firing on the listed
    1-based attempts, or per attempt with probability ``p`` (seeded)."""

    site: str
    kind: str
    attempts: Optional[frozenset] = None   # None and p None -> {1}
    p: Optional[float] = None
    n: int = 1                             # oom budget bytes
    seed: Optional[int] = None             # overrides the plan seed

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(supported: {KINDS})")
        if self.attempts is None and self.p is None:
            self.attempts = frozenset({1})

    def fires(self, attempt: int, plan_seed: int) -> bool:
        if self.attempts is not None:
            return attempt in self.attempts
        return _det_uniform(self._seed(plan_seed), self.site,
                            attempt) < float(self.p)

    def _seed(self, plan_seed: int) -> int:
        return plan_seed if self.seed is None else self.seed


def _det_uniform(seed: int, site: str, attempt: int) -> float:
    """Deterministic uniform in [0, 1), crc32-keyed (``hash(str)`` is
    salted per process)."""
    key = zlib.crc32(f"{seed}:{site}:{attempt}".encode()) & 0xFFFFFFFF
    return key / 2.0 ** 32


def parse_spec(text: str) -> FaultSpec:
    parts = [p.strip() for p in text.strip().split(":") if p.strip()]
    if len(parts) < 2:
        raise ValueError(
            f"fault spec {text!r} must be site:kind[:attempts][:p=..]"
            "[:n=..][:seed=..]")
    site, kind = parts[0], parts[1].lower()
    attempts, p, n, seed = None, None, 1, None
    for part in parts[2:]:
        if part.startswith("p="):
            p = float(part[2:])
        elif part.startswith("n="):
            n = int(part[2:])
        elif part.startswith("seed="):
            seed = int(part[5:])
        else:
            attempts = frozenset(int(a) for a in part.split(",") if a)
    return FaultSpec(site, kind, attempts, p, n, seed)


def parse_plan(text: str, seed: int = 0) -> "FaultPlan":
    """Specs separated by ``;`` (or newlines: commas belong to attempt
    lists)."""
    sep = ";" if ";" in text else "\n"
    specs = [parse_spec(s) for s in text.split(sep) if s.strip()]
    return FaultPlan(specs, seed=seed)


@dataclass
class FaultPlan:
    """The active schedule, per-(site, class) attempt counters and the
    record of what fired. Counters are keyed by failure class (``raise``
    for the raising kinds, else the kind), so an ``inject`` and a
    ``corrupt`` guarding one dispatch never count one attempt twice."""

    specs: List[FaultSpec]
    seed: int = 0
    _counts: dict = field(default_factory=dict)
    _fired: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def _has(self, site: str, kinds: Sequence[str]) -> bool:
        return any(s.site == site and s.kind in kinds for s in self.specs)

    def _tick(self, site: str, cls: str) -> int:
        key = f"{site}#{cls}"
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + 1
            return self._counts[key]

    def _due(self, site: str, attempt: int, kinds: Sequence[str]):
        for spec in self.specs:
            if spec.site == site and spec.kind in kinds \
                    and spec.fires(attempt, self.seed):
                return spec
        return None

    def _record(self, spec: FaultSpec, attempt: int):
        with self._lock:
            self._fired.append((spec.site, spec.kind, attempt))
        from . import observability as _obs
        from . import profiling

        profiling.counters.increment("faults.injected")
        profiling.counters.increment(f"faults.injected.{spec.site}")
        if _obs.TRACER.enabled:
            # EXPLAIN ANALYZE copies recovery_* span attributes onto the
            # operator that absorbed the fault
            _obs.current_span().set(
                recovery_fault=f"{spec.site}:{spec.kind}")
        logger.warning("fault injected: site=%s kind=%s attempt=%d",
                       spec.site, spec.kind, attempt)

    @property
    def fired(self) -> list:
        with self._lock:
            return list(self._fired)

    def attempts_at(self, site: str, cls: str = "raise") -> int:
        with self._lock:
            return self._counts.get(f"{site}#{cls}", 0)


_PLAN: Optional[FaultPlan] = None
_ENV_CHECKED = False


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    global _PLAN, _ENV_CHECKED
    _PLAN = plan
    _ENV_CHECKED = True  # an explicit install wins over the environment
    return plan


def install_from_env(env: Optional[str] = None,
                     seed: int = 0) -> Optional[FaultPlan]:
    """(Re-)read the environment's spec; installs None when unset."""
    text = os.environ.get(ENV_VAR) if env is None else env
    return install_plan(parse_plan(text, seed=seed) if text else None)


def clear() -> None:
    install_plan(None)


def active() -> Optional[FaultPlan]:
    """The active plan; reads ``SPARKDQ4ML_FAULTS`` once when no plan was
    installed, so a schedule works without a session."""
    global _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        if os.environ.get(ENV_VAR):
            install_from_env()
    return _PLAN


class inject_faults:
    """Context manager installing a plan for a scope::

        with inject_faults("pipeline_flush:device_error:1", seed=42):
            frame.count()
    """

    def __init__(self, *specs, seed: int = 0):
        parsed = [s if isinstance(s, FaultSpec) else parse_spec(s)
                  for s in specs]
        self.plan = FaultPlan(parsed, seed=seed)
        self._prev = None

    def __enter__(self) -> FaultPlan:
        self._prev = _PLAN
        install_plan(self.plan)
        return self.plan

    def __exit__(self, *exc):
        install_plan(self._prev)
        return False


_RAISE_KINDS = ("device_error", "preempt", "io_error")


def inject(site: str) -> None:
    """Raise the failure due at ``site``, if any: ``device_error`` ->
    :class:`InjectedDeviceError`, ``preempt`` -> :class:`Preemption`,
    ``io_error`` -> :class:`InjectedIOError`. The attempt counter ticks on
    every call while a raising spec names the site, so a retry walks past
    an attempt-1 fault on its second try."""
    plan = active()
    if plan is None or not plan._has(site, _RAISE_KINDS):
        return
    attempt = plan._tick(site, "raise")
    spec = plan._due(site, attempt, _RAISE_KINDS)
    if spec is None:
        return
    plan._record(spec, attempt)
    if spec.kind == "preempt":
        raise Preemption(
            f"injected preemption at {site!r} (attempt {attempt})")
    if spec.kind == "io_error":
        raise InjectedIOError(
            f"injected I/O error at {site!r} (attempt {attempt})")
    raise InjectedDeviceError(
        f"injected device error at {site!r} (attempt {attempt})")


def fired(site: str, kind: str) -> bool:
    """Due-test of a non-raising kind (a torn chunk, a dying producer
    thread, an exhausted pool, an adaptive stall); each kind keeps its own
    attempt counter."""
    plan = active()
    if plan is None or not plan._has(site, (kind,)):
        return False
    attempt = plan._tick(site, kind)
    spec = plan._due(site, attempt, (kind,))
    if spec is None:
        return False
    plan._record(spec, attempt)
    return True


def shrunk_budget(site: str) -> Optional[int]:
    """The device-byte budget an ``oom`` fault due at ``site`` imposes
    (the spec's ``n``, at least 1), or None: the flush treats it as a
    ``spark.audit.deviceBudget`` and runs row-chunked."""
    plan = active()
    if plan is None or not plan._has(site, ("oom",)):
        return None
    attempt = plan._tick(site, "oom")
    spec = plan._due(site, attempt, ("oom",))
    if spec is None:
        return None
    plan._record(spec, attempt)
    return max(1, int(spec.n))


def corrupt(site: str, tree):
    """``tree`` with one float element set to NaN when a ``nan`` fault is
    due at ``site`` (a seeded leaf and element); else ``tree`` itself."""
    plan = active()
    if plan is None or not plan._has(site, ("nan",)):
        return tree
    attempt = plan._tick(site, "nan")
    spec = plan._due(site, attempt, ("nan",))
    if spec is None:
        return tree
    plan._record(spec, attempt)
    return _poison(tree, spec._seed(plan.seed), site, attempt)


def _flatten(tree, leaves: list):
    """The leaves of ``tree`` in ``jax.tree_util``'s order (dict keys
    sorted, sequences in order, None empty) and a rebuild function; a
    namedtuple keeps its type."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_flatten(tree[k], leaves) for k in keys]
        return lambda it: type(tree)(
            (k, s(it)) for k, s in zip(keys, subs))
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(v, leaves) for v in tree]
        if hasattr(tree, "_fields"):
            return lambda it: type(tree)(*(s(it) for s in subs))
        return lambda it: type(tree)(s(it) for s in subs)
    leaves.append(tree)
    return lambda it: next(it)


def _inexact(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point() and leaf.numel() > 0
    import numpy as np

    if not (hasattr(leaf, "dtype") and hasattr(leaf, "size")):
        return False
    a = np.asarray(leaf)
    return np.issubdtype(a.dtype, np.inexact) and a.size > 0


def _poison(tree, seed: int, site: str, attempt: int):
    """NaN one element of one float leaf, chosen as the JAX package
    chooses it."""
    import numpy as np

    leaves: list = []
    rebuild = _flatten(tree, leaves)
    targets = [i for i, leaf in enumerate(leaves) if _inexact(leaf)]
    if not targets:
        return tree
    u = _det_uniform(seed, site + "#leaf", attempt)
    li = targets[int(u * len(targets)) % len(targets)]
    leaf = leaves[li]
    size = leaf.numel() if isinstance(leaf, torch.Tensor) \
        else int(np.asarray(leaf).size)
    ei = int(_det_uniform(seed, site + "#elem", attempt) * size) % size
    if isinstance(leaf, torch.Tensor):
        flat = leaf.clone()
        flat.view(-1)[ei] = float("nan")
    else:
        flat = np.array(leaf, copy=True)
        flat.reshape(-1)[ei] = np.nan
    leaves[li] = flat
    return rebuild(iter(leaves))
