"""Temp-view catalog backing ``createOrReplaceTempView``, ``sql`` and its
``CREATE``/``DROP VIEW`` statements (``sparkdq4ml_tpu/sql/catalog.py``)."""

from __future__ import annotations

from typing import NamedTuple


class Table(NamedTuple):
    """Spark ``catalog.listTables()`` row shape (temp views only here)."""

    name: str
    isTemporary: bool = True


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

    def table_exists(self, name: str) -> bool:
        return name.lower() in self._views

    tableExists = table_exists

    def drop(self, name: str) -> bool:
        """Remove a view; False when there was none."""
        return self._views.pop(name.lower(), None) is not None

    dropTempView = drop_temp_view = drop

    def list_views(self) -> list:
        return sorted(self._views)

    def list_tables(self) -> list:
        """Spark's ``catalog.listTables()`` shape: ``Table`` rows with
        ``.name`` and ``.isTemporary`` (always True: this catalog holds
        only temp views)."""
        return [Table(name=n, isTemporary=True) for n in sorted(self._views)]

    listTables = list_tables

    def clear(self) -> None:
        self._views.clear()


_DEFAULT = Catalog()


def default_catalog() -> Catalog:
    return _DEFAULT
