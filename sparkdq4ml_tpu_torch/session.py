"""``TorchSession``: the entry point of the port, the counterpart of the
JAX package's ``TpuSession`` with the same builder API.

The session's device comes from the conf key ``spark.torch.device``, which
defaults to ``"cuda"``. Without a CUDA device, ``get_or_create`` raises
unless the caller asked for ``"cpu"``: the port never continues on the CPU
when the card was asked for. The ``spark.ingest.*`` keys set the native
CSV ingest (``config.INGEST_KEYS``), the ``spark.pipeline.*`` and
``spark.stats.*`` keys the fused pipeline and its statistics
(``config.PIPELINE_KEYS``), and the ``spark.optimizer.*``, ``spark.aqe.*``,
``spark.costprof.*``, ``spark.explain.*`` and
``spark.audit.deviceBudget``/``memoryFraction`` keys the planner
(``config.PLANNER_KEYS``), while the session runs; ``stop`` restores them. ``spark.observability.enabled``
(or ``SPARKDQ4ML_OBS=1``) turns the span tracer on. A session loads the
statstore snapshot at ``spark.stats.path`` when it starts and saves it
when it stops (unless ``spark.stats.flushOnStop=false``). The
``spark.dq.*`` keys set the data-quality observatory
(``config.DQ_KEYS``; ``session.dq_report()``). ``spark.faults`` (or
``SPARKDQ4ML_FAULTS``) installs a fault schedule for the session's life,
seeded by ``spark.faults.seed``; the ``spark.recovery.*`` keys set the
retry policy its faults meet (``utils/recovery.py``), and
``session.recovery_log`` holds what recovered.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from .config import (CONF_FALSE, CONF_TRUE, apply_conf, check_device,
                     config, restore_conf, wide_types)
from .frame.csv import DataFrameReader
from .frame.frame import Frame
from .ops.udf import UDFRegistry, default_registry
from .sql.catalog import Catalog, default_catalog

DEVICE_KEY = "spark.torch.device"

_ACTIVE: Optional["TorchSession"] = None
_ACTIVE_LOCK = threading.Lock()


class TorchSession:
    """Device + catalog + UDF registry + reader."""

    def __init__(self, app_name: str = "sparkdq4ml-torch",
                 master: Optional[str] = None,
                 conf: Optional[dict] = None):
        self.app_name = app_name
        self.master = master
        self.conf: dict[str, str] = dict(conf or {})
        self.device: torch.device = check_device(
            self.conf.get(DEVICE_KEY, config.default_device))
        self.catalog: Catalog = default_catalog()
        self.udf: UDFRegistry = default_registry()
        self._saved_conf: dict = {}
        self._session_span = None
        self._fault_plan = None
        self._init_faults()
        self._apply_conf(self.conf)
        self._init_observability()
        if config.stats_enabled and config.stats_path:
            from .utils import statstore as _statstore

            _statstore.STORE.load(config.stats_path)

    def _apply_conf(self, conf: dict) -> None:
        """Set the settings ``conf`` names (restored by :meth:`stop`).
        Turning the pipeline off drops the plan cache."""
        apply_conf(conf, self._saved_conf)
        if (str(conf.get("spark.pipeline.enabled", "")).strip().lower()
                in CONF_FALSE):
            from .ops import compiler as _compiler

            _compiler.clear_cache()

    def _init_faults(self) -> None:
        """Install the fault schedule (``utils/faults.py``) of the conf or
        the environment::

            .config("spark.faults", "pipeline_flush:device_error:1")
            .config("spark.faults.seed", 7)

        With neither, a plan installed by the caller stays as it is. The
        session uninstalls its own plan when it stops."""
        from .utils import faults as _faults

        seed = int(self.conf.get("spark.faults.seed", 0))
        spec = self.conf.get("spark.faults")
        if spec:
            self._fault_plan = _faults.install_plan(
                _faults.parse_plan(spec, seed=seed))
        elif os.environ.get(_faults.ENV_VAR):
            self._fault_plan = _faults.install_from_env(seed=seed)

    def _init_observability(self) -> None:
        """The span tracer, from the conf or ``SPARKDQ4ML_OBS``:

            .config("spark.observability.enabled", "true")
            .config("spark.observability.maxSpans", 50000)
            .config("spark.observability.logSpans", "true")

        Off by default. When on, a root ``session`` span opens (ended by
        :meth:`stop`) and everything the session runs nests under it."""
        from .utils import observability as _obs

        val = str(self.conf.get("spark.observability.enabled",
                                "")).strip().lower()
        env_on = os.environ.get(_obs.ENV_VAR, "").strip().lower() not in (
            ("",) + CONF_FALSE)
        if val in CONF_TRUE or (val == "" and env_on):
            _obs.enable(
                max_spans=int(self.conf.get("spark.observability.maxSpans",
                                            10_000)),
                log_spans=str(self.conf.get("spark.observability.logSpans",
                                            "")).lower() in CONF_TRUE)
            if self._session_span is None:
                self._session_span = _obs.TRACER.begin(
                    "session", cat="session", app=self.app_name,
                    device=str(self.device))
        elif val in CONF_FALSE:
            _obs.disable()

    class Builder:
        def __init__(self):
            self._app_name = "sparkdq4ml-torch"
            self._master: Optional[str] = None
            self._conf: dict[str, str] = {}

        def app_name(self, name: str) -> "TorchSession.Builder":
            self._app_name = name
            return self

        appName = app_name

        def master(self, master: str) -> "TorchSession.Builder":
            self._master = master
            return self

        def config(self, key: str, value) -> "TorchSession.Builder":
            self._conf[key] = str(value)
            return self

        def get_or_create(self) -> "TorchSession":
            """The active session, or a new one. Asking the active session
            for another device raises: stop it first."""
            global _ACTIVE
            with _ACTIVE_LOCK:
                if _ACTIVE is None:
                    _ACTIVE = TorchSession(self._app_name, self._master,
                                           self._conf)
                    return _ACTIVE
                if DEVICE_KEY in self._conf and torch.device(
                        self._conf[DEVICE_KEY]) != _ACTIVE.device:
                    raise ValueError(
                        f"the active session runs on {_ACTIVE.device}; stop "
                        f"it before asking for {self._conf[DEVICE_KEY]}")
                _ACTIVE.conf.update(self._conf)
                if any(k.startswith("spark.faults") for k in self._conf):
                    _ACTIVE._init_faults()
                _ACTIVE._apply_conf(self._conf)
                return _ACTIVE

        getOrCreate = get_or_create

    @classmethod
    def builder(cls) -> "TorchSession.Builder":
        return cls.Builder()

    @classmethod
    def active(cls) -> Optional["TorchSession"]:
        return _ACTIVE

    @property
    def read(self) -> DataFrameReader:
        return DataFrameReader(self)

    def sql(self, query: str) -> Frame:
        """Run the SQL subset against this session's temp views."""
        from .sql.parser import execute

        return execute(query, self.catalog)

    def create_data_frame(self, data, names=None) -> Frame:
        """A frame on the session's device from a dict of columns or from
        rows and their names."""
        if isinstance(data, dict):
            return Frame(data, device=self.device)
        return Frame.from_rows(data, names, device=self.device)

    createDataFrame = create_data_frame

    def table(self, name: str) -> Frame:
        """Spark's ``spark.table(name)``: the registered temp view."""
        return self.catalog.lookup(name)

    def range(self, start: int, end: Optional[int] = None, step: int = 1,
              num_partitions: Optional[int] = None) -> Frame:
        """Spark's ``spark.range``: a frame with one integer ``id`` column,
        ``range(n)`` counting 0..n-1 and ``range(start, end, step)`` as
        Python's; ``num_partitions`` is accepted and ignored. The ids are
        int64 under the float64 policy and int32 under the float32 one,
        where ids outside int32 raise (as the JAX package does without
        x64)."""
        if step == 0:
            raise ValueError("range step must not be zero")
        if end is None:
            start, end = 0, start
        ids = np.arange(start, end, step, dtype=np.int64)
        if not wide_types() and ids.size > 0:
            # arange is monotone: the extremes are its endpoints
            lo, hi = sorted((int(ids[0]), int(ids[-1])))
            if lo < -(2 ** 31) or hi >= 2 ** 31:
                raise ValueError(
                    f"range ids [{lo}, {hi}] exceed int32 under the float32 "
                    "policy; use the float64 policy for 64-bit ids")
        return Frame({"id": ids}, device=self.device)

    @property
    def recovery_log(self):
        """The structured recovery log (``utils.recovery.RECOVERY_LOG``):
        every retry, fallback, breaker trip, preemption and resume. Empty
        on a clean run."""
        from .utils.recovery import RECOVERY_LOG

        return RECOVERY_LOG

    @property
    def version(self) -> str:
        """The port's version string (Spark's ``spark.version``)."""
        from . import __version__

        return __version__

    # -- observability surface ---------------------------------------------
    def metrics(self) -> dict:
        """One merged metrics snapshot: every counter (``pipeline.*``,
        ``frame.host_sync``, ``stats.*``, ...), every gauge and every
        latency histogram (``span_ms.<category>``), flat by name."""
        from .utils import observability as _obs

        return _obs.metrics_snapshot()

    def metrics_text(self) -> str:
        """Prometheus text-format rendering of :meth:`metrics`."""
        from .utils import observability as _obs

        return _obs.prometheus_text()

    def trace_report(self) -> str:
        """Human-readable span tree of everything traced so far (empty
        when tracing was never on)."""
        from .utils import observability as _obs

        return _obs.trace_report()

    def dump_trace(self, path: str) -> str:
        """Write the Chrome trace-event JSON to ``path``; returns it."""
        from .utils import observability as _obs

        return _obs.dump_chrome_trace(path)

    def cache_report(self) -> dict:
        """The cached-program registry (``observability.CACHES``): for the
        fused pipeline its size, hits, misses, evictions, fallbacks and
        one entry per cached plan."""
        from .ops import compiler  # noqa: F401 - registers "pipeline"
        from .utils import observability as _obs

        return _obs.cache_report()

    def stats_report(self) -> dict:
        """The plan-statistics store (``utils.statstore``): one row per
        structural plan key (observed selectivity, wall and first-run
        digests, host syncs, byte bounds), this process's flushes plus
        the history loaded from ``spark.stats.path``. Draining the
        deferred selectivity scalars costs one counted batched read.
        ``spark.stats.enabled=false`` makes it refuse."""
        if not config.stats_enabled:
            return {"enabled": False, "entries": [], "size": 0}
        from .utils import statstore as _statstore

        doc = _statstore.STORE.report()
        doc["enabled"] = True
        doc["path"] = config.stats_path or None
        return doc

    def memory_report(self, top: int = 5) -> dict:
        """Device-memory accounting (``utils.meminfo``): the live tensors'
        bytes by dtype and the largest of them, the process peak, and the
        allocator's statistics on the card."""
        from .utils import meminfo as _meminfo

        return _meminfo.memory_report(top=top)

    def profile_report(self, top: Optional[int] = None,
                       budget: Optional[int] = None) -> dict:
        """The cost profiles (``utils.costprof``): one row per cached
        program and hand kernel launched, with its counted flops and
        bytes, its achieved rates at the median time of its runs at the
        counted size (a hand kernel's from its own launches) and its
        roofline verdict, ranked by wall-time share; at most ``budget``
        new plan counts a call (``costprof.EXTRACT_BUDGET``), the rest
        pending. ``spark.costprof.enabled=false`` makes it refuse."""
        from .utils import costprof as _costprof

        return _costprof.report(top=top, budget=budget)

    def dq_report(self, top: Optional[int] = None) -> dict:
        """The data-quality observatory (``utils.dqprof``): one row per
        profiled column (count, nulls, min, max, mean, variance, the
        histogram, PSI drift against the pinned baseline) and per rule
        (evaluations, rows, violations, rate). Pays the observatory's one
        counted batched read (``dq.drain_sync``).
        ``spark.dq.profile.enabled=false`` makes it refuse."""
        if not config.dq_profile_enabled:
            return {"enabled": False, "columns": [], "rules": [],
                    "size": 0, "pending": 0}
        from .utils import dqprof as _dqprof

        return _dqprof.report(top=top)

    def stop(self) -> None:
        """Save the statstore (``spark.stats.path``, unless
        ``spark.stats.flushOnStop=false``), end the session span, restore
        the settings this session changed."""
        global _ACTIVE
        if config.stats_enabled and config.stats_path \
                and config.stats_flush_on_stop:
            from .utils import statstore as _statstore

            _statstore.STORE.save(config.stats_path, merge=True)
        if self._session_span is not None:
            from .utils import observability as _obs

            _obs.TRACER.end(self._session_span)
            self._session_span = None
        if self._fault_plan is not None:
            # a schedule is the session's: a later session does not
            # inherit it
            from .utils import faults as _faults

            if _faults.active() is self._fault_plan:
                _faults.clear()
            self._fault_plan = None
        with _ACTIVE_LOCK:
            restore_conf(self._saved_conf)
            if _ACTIVE is self:
                _ACTIVE = None
