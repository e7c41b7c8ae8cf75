"""UDF registry: the engine capability behind ``spark.udf().register``.

Registered functions are vectorized tensor -> tensor functions, callable
from column expressions through ``call_udf``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .expressions import resolve_type_name


class UDFRegistry:
    """Name -> (vectorized fn, return dtype)."""

    def __init__(self):
        self._fns: dict[str, tuple[Callable, Optional[torch.dtype]]] = {}

    def register(self, name: str, fn: Callable, return_type=None) -> Callable:
        """Register ``fn`` under ``name``. ``return_type`` is a Spark SQL
        type name ("double", "int", ...), a torch dtype, or None to keep
        the function's own dtype."""
        if isinstance(return_type, str):
            return_type = resolve_type_name(return_type)
        self._fns[name] = (fn, return_type)
        return fn

    def lookup(self, name: str):
        try:
            return self._fns[name]
        except KeyError:
            raise KeyError(
                f"UDF {name!r} is not registered "
                f"(registered: {sorted(self._fns)})") from None

    def names(self):
        return sorted(self._fns)

    def __contains__(self, name: str) -> bool:
        return name in self._fns


_DEFAULT = UDFRegistry()


def default_registry() -> UDFRegistry:
    return _DEFAULT
