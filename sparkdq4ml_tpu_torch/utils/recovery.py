"""Failure detection and recovery (the port of
``sparkdq4ml_tpu/utils/recovery.py``).

* **Detection**: :func:`check_finite` finds NaN/Inf in a result; a device
  fault surfaces as ``torch.AcceleratorError`` (``torch.OutOfMemoryError``
  for memory) and is caught by the retry loop.
* **Re-execution**: :func:`resilient_call` is the task-retry loop, with
  exponential backoff and deterministic jitter (:class:`RetryPolicy`),
  per-attempt deadlines (:class:`DeadlineExceeded`) and a
  :class:`CircuitBreaker`; it walks a ladder of fallback rungs when the
  primary one exhausts its attempts.
* **Checkpointing**: :func:`fit_or_resume` saves a fitted stage and
  resumes from it; with ``checkpoint_every`` it checkpoints every N
  solver iterations, so a preemption loses at most one segment.
* **Telemetry**: every retry, fallback, breaker trip and resume lands in
  :data:`RECOVERY_LOG` as a :class:`RecoveryEvent`, mirrored into the
  ``recovery.<action>`` and ``recovery.<action>.<site>`` counters. A
  clean run records nothing.

What is retried: injected faults and recoverable device errors (a
refused allocation). A sticky CUDA error (an illegal address) leaves the
context unusable for the rest of the process: a retry fails the same way
and the ladder ends in :class:`FitFailure`. A kernel that fails to build
or launch raises ``RuntimeError``, which no rung catches.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger("sparkdq4ml_tpu_torch.recovery")


class FitFailure(RuntimeError):
    """A computation failed (a non-finite result or a device error) and
    did not recover within the retries and fallbacks."""


class DeadlineExceeded(RuntimeError):
    """An attempt ran past its deadline. Its work cannot be cancelled; the
    retry loop stops waiting on it and moves on."""


class CircuitOpenError(FitFailure):
    """Every rung was skipped because its breaker is open."""


@dataclasses.dataclass
class RecoveryEvent:
    """One recovery decision."""

    site: str            # the fault site ("pipeline_flush", "fit", ...)
    action: str          # retry | fallback | recovered | exhausted |
    #                      circuit_open | circuit_skip | deadline |
    #                      preempted | resumed | checkpoint
    attempt: int = 0     # 1-based attempt within the current rung
    rung: str = ""       # ladder rung ("primary", "eager", ...)
    cause: str = ""      # exception repr / "non-finite result" / ""
    backoff_s: float = 0.0
    detail: str = ""
    time_s: float = 0.0  # wall clock (time.time)
    trace_id: Optional[int] = None   # the active span, when tracing is on
    span_id: Optional[int] = None

    def as_kv(self) -> str:
        from .logging import format_kv

        return format_kv(
            site=self.site, action=self.action, attempt=self.attempt,
            rung=self.rung, cause=self.cause,
            backoff_s=round(self.backoff_s, 4), detail=self.detail,
            trace_id=self.trace_id, span_id=self.span_id)


class RecoveryLog:
    """Append-only event log with a counter mirror; thread-safe, bounded
    (the oldest events go past ``maxlen``)."""

    def __init__(self, maxlen: int = 10_000):
        self._events: List[RecoveryEvent] = []
        self._maxlen = maxlen
        self._lock = threading.Lock()

    def record(self, site: str, action: str, **kw) -> RecoveryEvent:
        if "trace_id" not in kw:
            from . import observability as _obs

            kw["trace_id"], kw["span_id"] = _obs.current_ids()
        ev = RecoveryEvent(site=site, action=action, time_s=time.time(), **kw)
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self._maxlen:
                del self._events[: len(self._events) - self._maxlen]
        from . import profiling

        profiling.counters.increment(f"recovery.{action}")
        if site:
            profiling.counters.increment(f"recovery.{action}.{site}")
        level = (logging.INFO if action in ("resumed", "checkpoint",
                                            "recovered")
                 else logging.WARNING)
        logger.log(level, "recovery %s", ev.as_kv())
        return ev

    def events(self, site: Optional[str] = None,
               action: Optional[str] = None) -> List[RecoveryEvent]:
        with self._lock:
            evs = list(self._events)
        if site is not None:
            evs = [e for e in evs if e.site == site]
        if action is not None:
            evs = [e for e in evs if e.action == action]
        return evs

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


RECOVERY_LOG = RecoveryLog()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Attempts, exponential backoff with deterministic jitter, a
    per-attempt deadline and a total one. The jitter is a pure function of
    (seed, site, attempt), the draw of ``faults._det_uniform``, so a run
    replays with the same sleeps as the JAX package's."""

    max_attempts: int = 3
    backoff_base: float = 0.05     # s before the 2nd attempt
    backoff_factor: float = 2.0
    backoff_max: float = 5.0
    jitter: float = 0.1            # +[0, jitter) fraction of the backoff
    seed: int = 0
    attempt_deadline: Optional[float] = None   # s an attempt
    total_deadline: Optional[float] = None     # s over every attempt
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def backoff(self, attempt: int, site: str = "") -> float:
        """Seconds to wait after failed ``attempt`` (1-based)."""
        if attempt >= self.max_attempts:
            return 0.0  # no sleep before a fallback or a raise
        base = min(self.backoff_base * self.backoff_factor ** (attempt - 1),
                   self.backoff_max)
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        from .faults import _det_uniform

        return base * (1.0 + self.jitter
                       * _det_uniform(self.seed, site, attempt))

    _CONF_KEYS = {
        "maxAttempts": ("max_attempts", int),
        "backoffBase": ("backoff_base", float),
        "backoffFactor": ("backoff_factor", float),
        "backoffMax": ("backoff_max", float),
        "jitter": ("jitter", float),
        "seed": ("seed", int),
        "attemptDeadline": ("attempt_deadline", float),
        "totalDeadline": ("total_deadline", float),
    }

    @classmethod
    def _conf_kwargs(cls, conf: Mapping, prefix: str) -> dict:
        kw = {}
        for conf_key, (attr, cast) in cls._CONF_KEYS.items():
            v = conf.get(prefix + conf_key)
            if v is not None:
                kw[attr] = cast(v)
        return kw

    @classmethod
    def from_conf(cls, conf: Optional[Mapping] = None,
                  prefix: str = "spark.recovery.",
                  **overrides) -> "RetryPolicy":
        """From a conf mapping: ``spark.recovery.maxAttempts``,
        ``.backoffBase``, ``.backoffFactor``, ``.backoffMax``, ``.jitter``,
        ``.seed``, ``.attemptDeadline``, ``.totalDeadline``; unset keys
        keep the defaults."""
        kw = cls._conf_kwargs(conf or {}, prefix)
        kw.update(overrides)
        return cls(**kw)


def _session_conf() -> Mapping:
    from ..session import TorchSession

    active = TorchSession.active()
    return active.conf if active is not None else {}


def active_policy(site: str = "", **overrides) -> RetryPolicy:
    """The active session's policy: the ``spark.recovery.*`` keys, with
    the per-site ``spark.recovery.<site>.*`` keys over them; the defaults
    without a session."""
    conf = _session_conf()
    kw = RetryPolicy._conf_kwargs(conf, "spark.recovery.")
    if site:
        kw.update(RetryPolicy._conf_kwargs(conf, f"spark.recovery.{site}."))
    kw.update(overrides)
    return RetryPolicy(**kw)


class CircuitBreaker:
    """Per-key consecutive-failure breaker: after ``failure_threshold``
    straight failures the key opens and its rung is skipped until
    ``cooldown`` seconds pass, when one trial is allowed; a success
    closes it."""

    def __init__(self, failure_threshold: int = 3, cooldown: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        self.cooldown = float(cooldown)
        self._clock = clock
        self._state: dict = {}     # key -> (consecutive failures, opened)
        self._lock = threading.Lock()

    def allow(self, key: str) -> bool:
        with self._lock:
            _, opened = self._state.get(key, (0, None))
            if opened is None:
                return True
            return self._clock() - opened >= self.cooldown

    def record_success(self, key: str) -> None:
        with self._lock:
            self._state.pop(key, None)

    def record_failure(self, key: str) -> bool:
        """True when this failure opened the breaker."""
        with self._lock:
            fails, opened = self._state.get(key, (0, None))
            fails += 1
            just_opened = fails >= self.failure_threshold and opened is None
            if fails >= self.failure_threshold:
                opened = self._clock()
            self._state[key] = (fails, opened)
            return just_opened

    def reset(self, key: Optional[str] = None) -> None:
        with self._lock:
            if key is None:
                self._state.clear()
            else:
                self._state.pop(key, None)

    def snapshot(self) -> dict:
        """Per-key consecutive failures and whether the key refuses
        calls."""
        with self._lock:
            now = self._clock()
            return {key: {"consecutive_failures": fails,
                          "open": (opened is not None
                                   and now - opened < self.cooldown)}
                    for key, (fails, opened) in self._state.items()}


#: The breaker of the device paths (the packed fit); keys are site/rung.
DEVICE_BREAKER = CircuitBreaker()


def _run_with_deadline(fn: Callable, seconds: Optional[float]):
    """``fn()`` bounded by ``seconds``: it runs in a daemon thread and
    :class:`DeadlineExceeded` is raised when it overruns. The thread is
    not cancelled and may still launch work on the card: the caller
    synchronizes the device before its next attempt."""
    if seconds is None:
        return fn()
    box: dict = {}

    def runner():
        try:
            box["value"] = fn()
        except BaseException as e:        # re-raised on the caller thread
            box["error"] = e

    t = threading.Thread(target=runner, daemon=True,
                         name="sparkdq4ml-deadline")
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise DeadlineExceeded(
            f"attempt exceeded its {seconds:.3g} s deadline; the in-flight "
            "call may still be running")
    if "error" in box:
        raise box["error"]
    return box["value"]


def _leaves(tree, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)


def _finite(leaf) -> Optional[bool]:
    """Whether a numeric leaf is all finite; None for other leaves."""
    if isinstance(leaf, torch.Tensor):
        if not leaf.is_floating_point():
            return True
        return bool(torch.isfinite(leaf).all())
    if isinstance(leaf, (np.ndarray, float, np.floating)):
        arr = np.asarray(leaf)
        return (not np.issubdtype(arr.dtype, np.inexact)
                or bool(np.all(np.isfinite(arr))))
    return None


def check_finite(tree, _seen=None) -> bool:
    """True when every float tensor or array in ``tree`` is finite: dicts,
    lists and tuples of them, and fitted models (their ``_persist_attrs``
    when declared, else their public attributes). Cycles are guarded."""
    if _seen is None:
        _seen = set()
    if id(tree) in _seen:
        return True
    _seen.add(id(tree))
    attrs = getattr(tree, "_persist_attrs", None)
    if attrs is not None:
        return all(check_finite(getattr(tree, a, None), _seen)
                   for a in attrs)
    leaves: list = []
    _leaves(tree, leaves)
    if len(leaves) == 1 and leaves[0] is tree and _finite(tree) is None \
            and hasattr(tree, "__dict__"):
        return check_finite({k: v for k, v in vars(tree).items()
                             if not k.startswith("_")}, _seen)
    for leaf in leaves:
        ok = _finite(leaf)
        if ok is False:
            return False
        if ok is None and hasattr(leaf, "__dict__") \
                and id(leaf) not in _seen:
            # an opaque object: its public attributes (a model's private
            # summary frame may hold NaN in masked slots)
            _seen.add(id(leaf))
            if not check_finite({k: v for k, v in vars(leaf).items()
                                 if not k.startswith("_")}, _seen):
                return False
    return True


def result_validator() -> Optional[Callable]:
    """:func:`check_finite` when a fault plan is installed or the session
    sets ``spark.recovery.validate=on``, else None (a fit that diverges on
    its data keeps its NaN rather than refitting down the ladder)."""
    from ..config import CONF_TRUE
    from . import faults as _faults

    if _faults.active() is not None:
        return check_finite
    if str(_session_conf().get("spark.recovery.validate",
                               "off")).lower() in CONF_TRUE:
        return check_finite
    return None


def _retryable_errors() -> tuple:
    return (torch.AcceleratorError, torch.OutOfMemoryError,
            DeadlineExceeded)


def _settle_device() -> None:
    """Wait for the card after a timed-out attempt, whose thread may still
    be launching work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def resilient_call(fn: Callable, *, site: str = "call",
                   policy: Optional[RetryPolicy] = None,
                   validate: Optional[Callable] = None,
                   fallbacks: Sequence[Tuple[str, Callable]] = (),
                   breaker: Optional[CircuitBreaker] = None,
                   on_failure: Optional[Callable] = None,
                   log: RecoveryLog = None):
    """Run ``fn()`` under the retry policy, as a ladder ``[("primary",
    fn)] + fallbacks``: each rung gets up to ``policy.max_attempts``
    attempts with backoff between them; a rung whose breaker key
    (``site/rung``) is open is skipped (``circuit_skip``); when every rung
    fails, :class:`FitFailure`. An attempt fails on a device error, a
    :class:`DeadlineExceeded` or a result ``validate`` rejects. An attempt
    waits for the card's work behind its result, so a device fault shows
    inside the ladder.

    ``on_failure(attempt, error_or_none)`` runs after each failed attempt;
    a callable it returns replaces the rung's function. Every decision is
    recorded in ``log`` (default :data:`RECOVERY_LOG`); a clean first
    attempt records nothing."""
    from . import faults as _faults
    from .profiling import block_until_ready

    policy = policy or active_policy(site)
    log = log or RECOVERY_LOG
    started = time.monotonic()
    ladder = [("primary", fn)] + list(fallbacks)
    last_err: Optional[BaseException] = None
    last_cause = ""
    ran_any = False

    for rung_idx, (rung, call) in enumerate(ladder):
        key = f"{site}/{rung}"
        if breaker is not None and not breaker.allow(key):
            log.record(site, "circuit_skip", rung=rung,
                       detail="breaker open; skipping rung")
            continue
        ran_any = True
        if rung_idx > 0:
            log.record(site, "fallback", rung=rung, cause=last_cause,
                       detail=f"degrading to {rung!r}")
        for attempt in range(1, policy.max_attempts + 1):
            if policy.total_deadline is not None and \
                    time.monotonic() - started > policy.total_deadline:
                log.record(site, "deadline", rung=rung, attempt=attempt,
                           detail="total deadline exhausted")
                raise FitFailure(
                    f"{site}: total deadline of {policy.total_deadline:.3g}"
                    f" s exhausted after {attempt - 1} attempt(s) on rung "
                    f"{rung!r}") from last_err
            if isinstance(last_err, DeadlineExceeded):
                _settle_device()
            err: Optional[BaseException] = None
            try:
                out = _run_with_deadline(
                    lambda: block_until_ready(call()),
                    policy.attempt_deadline)
            except _faults.Preemption:
                raise    # fit_or_resume's to handle
            except _retryable_errors() as e:
                err = e
            else:
                if validate is None or validate(out):
                    if breaker is not None:
                        breaker.record_success(key)
                    if attempt > 1 or rung_idx > 0:
                        log.record(site, "recovered", rung=rung,
                                   attempt=attempt)
                    return out
            last_err = err
            last_cause = (f"{type(err).__name__}: {err}" if err is not None
                          else "non-finite result")
            if breaker is not None and breaker.record_failure(key):
                log.record(site, "circuit_open", rung=rung, attempt=attempt,
                           cause=last_cause,
                           detail=f"breaker opened for {key!r}")
            wait = policy.backoff(attempt, site)
            log.record(site, "retry" if attempt < policy.max_attempts
                       else "exhausted", rung=rung, attempt=attempt,
                       cause=last_cause, backoff_s=wait)
            if on_failure is not None:
                downgraded = on_failure(attempt, err)
                if callable(downgraded):
                    call = downgraded
            if wait > 0.0:
                policy.sleep(wait)
    if not ran_any:
        raise CircuitOpenError(
            f"{site}: every rung's circuit breaker is open") from last_err
    raise FitFailure(
        f"{site}: failed after {len(ladder)} rung(s) x "
        f"{policy.max_attempts} attempt(s): {last_cause}") from last_err


def retry(fn: Callable, retries: int = 3,
          validate: Callable = check_finite,
          on_failure: Optional[Callable] = None):
    """:func:`resilient_call` with ``retries`` attempts, no backoff and no
    fallback; ``on_failure(attempt, err)`` runs between attempts."""
    if retries < 1:
        raise ValueError("retries must be >= 1")
    policy = RetryPolicy(max_attempts=retries, backoff_base=0.0, jitter=0.0)
    try:
        return resilient_call(fn, site="retry", policy=policy,
                              validate=validate, on_failure=on_failure)
    except FitFailure as e:
        raise FitFailure(
            f"computation failed after {retries} attempts: "
            f"{e.__cause__ if e.__cause__ is not None else 'non-finite'}"
        ) from e.__cause__


def _has_stage(checkpoint_dir: str) -> bool:
    return os.path.exists(os.path.join(checkpoint_dir, "stage.json")) or \
        os.path.exists(os.path.join(checkpoint_dir, "metadata.json"))


def _atomic_save(model, checkpoint_dir: str,
                 progress: Optional[dict] = None) -> None:
    """Save into a sibling directory, then one rename: a crash mid-save
    never leaves a half-written checkpoint. ``progress`` (the mid-fit
    cursor) rides in the same rename."""
    import json
    import shutil

    from ..models.base import save_stage

    tmp = checkpoint_dir.rstrip("/\\") + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    save_stage(model, tmp)
    if progress is not None:
        with open(os.path.join(tmp, "progress.json"), "w") as f:
            json.dump(progress, f)
    shutil.rmtree(checkpoint_dir, ignore_errors=True)
    os.rename(tmp, checkpoint_dir)


def _read_progress(checkpoint_dir: str) -> Optional[dict]:
    import json

    try:
        with open(os.path.join(checkpoint_dir, "progress.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _fit_converged(model) -> Optional[bool]:
    """The convergence flag of the model's fit, when it has one."""
    src = getattr(model, "_summary_source", None)
    if src is None or len(src) < 2 or src[1] is None:
        return None
    converged = getattr(src[1], "converged", None)
    if converged is None:
        return None
    return bool(np.asarray(converged))


def fit_or_resume(estimator, frame, checkpoint_dir: str, retries: int = 1,
                  checkpoint_every: Optional[int] = None,
                  max_preemptions: int = 8):
    """Fit with a persistent checkpoint: a finished stage in
    ``checkpoint_dir`` loads without a refit; otherwise fit (retried when
    ``retries > 1``), save atomically and return the model.

    ``checkpoint_every=N`` fits an estimator with ``max_iter`` in segments
    of N iterations, each checkpointing its model and a ``progress.json``
    cursor; a preemption between segments resumes from the cursor. A
    segment refits from the start with the larger budget (a fit is a pure
    function of its inputs), so the last model is the one an
    uninterrupted fit gives. A :class:`~.faults.Preemption` is caught up
    to ``max_preemptions`` times, recorded, and resumed."""
    from ..models.base import load_stage
    from . import faults as _faults

    iterative = (checkpoint_every is not None
                 and getattr(estimator, "max_iter", None) is not None)
    if _has_stage(checkpoint_dir):
        progress = _read_progress(checkpoint_dir)
        if progress is None or progress.get("finished", True):
            logger.info("resuming fitted stage from %s", checkpoint_dir)
            RECOVERY_LOG.record("fit", "resumed",
                                detail=f"loaded stage from {checkpoint_dir}")
            return load_stage(checkpoint_dir)
        # an unfinished cursor is never the final model
        if iterative:
            RECOVERY_LOG.record(
                "fit", "resumed", detail=(
                    f"mid-fit cursor at {progress.get('budget')}"
                    f"/{progress.get('total')} iterations"))
        else:
            logger.info("checkpoint %s holds an unfinished segment; "
                        "refitting in full", checkpoint_dir)

    def do_fit(est):
        _faults.inject("fit")
        return est.fit(frame)

    preemptions = 0
    while True:
        try:
            if iterative:
                return _fit_segments(estimator, checkpoint_dir, do_fit,
                                     retries, int(checkpoint_every))
            model = retry(lambda: do_fit(estimator), retries=retries)
            _atomic_save(model, checkpoint_dir)
            return model
        except _faults.Preemption as e:
            preemptions += 1
            RECOVERY_LOG.record("fit", "preempted", attempt=preemptions,
                                cause=str(e))
            if preemptions >= max_preemptions:
                raise FitFailure(
                    f"fit preempted {preemptions} times; giving up") from e
            if _has_stage(checkpoint_dir):
                progress = _read_progress(checkpoint_dir)
                if progress is None or progress.get("finished", True):
                    return load_stage(checkpoint_dir)


def _fit_segments(estimator, checkpoint_dir: str, do_fit, retries: int,
                  every: int):
    """Grow the iteration budget ``every`` at a time, checkpointing after
    each segment, until the fit converges or the budget is spent."""
    import copy

    if every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    total = int(estimator.max_iter)
    progress = _read_progress(checkpoint_dir) or {}
    done = int(progress.get("budget", 0)) if not progress.get(
        "finished", False) else 0
    while True:
        budget = min(done + every, total)
        est = copy.copy(estimator)
        est.max_iter = budget
        model = retry(lambda: do_fit(est), retries=retries)
        finished = bool(_fit_converged(model)) or budget >= total
        _atomic_save(model, checkpoint_dir, progress={
            "budget": budget, "total": total, "finished": finished})
        RECOVERY_LOG.record(
            "fit", "checkpoint",
            detail=f"segment at {budget}/{total} iterations"
                   + (" (finished)" if finished else ""))
        if finished:
            return model
        done = budget
