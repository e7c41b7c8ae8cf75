"""Temp-view catalog backing ``createOrReplaceTempView`` and ``sql``."""

from __future__ import annotations


class Catalog:
    def __init__(self):
        self._views: dict[str, object] = {}

    def register(self, name: str, frame) -> None:
        self._views[name.lower()] = frame

    def lookup(self, name: str):
        try:
            return self._views[name.lower()]
        except KeyError:
            raise KeyError(f"temp view {name!r} not found "
                           f"(views: {sorted(self._views)})") from None

    def clear(self) -> None:
        self._views.clear()


_DEFAULT = Catalog()


def default_catalog() -> Catalog:
    return _DEFAULT
