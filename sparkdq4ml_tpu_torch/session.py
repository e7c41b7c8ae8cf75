"""``TorchSession``: the entry point of the port, the counterpart of
``sparkdq4ml_tpu.TpuSession`` with the same builder API.

The session's device comes from the conf key ``spark.torch.device``, which
defaults to ``"cuda"``. Without a CUDA device, ``get_or_create`` raises
unless the caller asked for ``"cpu"``: the port never continues on the CPU
when the card was asked for.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .config import check_device, config
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

    def stop(self) -> None:
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None
