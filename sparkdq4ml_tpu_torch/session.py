"""``TorchSession``: the entry point of the port, the counterpart of the
JAX package's ``TpuSession`` with the same builder API.

The session's device comes from the conf key ``spark.torch.device``, which
defaults to ``"cuda"``. Without a CUDA device, ``get_or_create`` raises
unless the caller asked for ``"cpu"``: the port never continues on the CPU
when the card was asked for. The ``spark.ingest.*`` keys set the native
CSV ingest (``config.INGEST_KEYS``) while the session runs; ``stop``
restores them.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from .config import (apply_conf, check_device, config, restore_conf,
                     wide_types)
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
        apply_conf(self.conf, self._saved_conf)

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
                apply_conf(self._conf, _ACTIVE._saved_conf)
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
    def version(self) -> str:
        """The port's version string (Spark's ``spark.version``)."""
        from . import __version__

        return __version__

    def stop(self) -> None:
        global _ACTIVE
        with _ACTIVE_LOCK:
            restore_conf(self._saved_conf)
            if _ACTIVE is self:
                _ACTIVE = None
