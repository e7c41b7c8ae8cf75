"""CSV reader with schema inference, in pure Python and numpy (subset of
``sparkdq4ml_tpu/frame/csv.py``).

* Records end in ``\\r\\n``, ``\\r`` or ``\\n``: the reference datasets are
  terminated by a bare CR.
* Without a header the columns are named ``_c0, _c1, ...``.
* Inference prefers integer, then long, double, boolean, string. Empty
  fields are nulls: NaN in float columns, and an int column with nulls
  becomes a double column.

Quoted fields are not in this subset and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..config import float_dtype, int_dtype, numpy_dtype
from .frame import Frame

_NULL_STRINGS = {""}
_TRUE = {"true", "TRUE", "True"}
_FALSE = {"false", "FALSE", "False"}


def split_records(text: str) -> list[str]:
    r"""Split on \r\n, \r or \n; drop blank records (Spark skips them)."""
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    return [line for line in text.split("\n") if line.strip() != ""]


def _try_int(s: str) -> Optional[int]:
    try:
        return int(s)
    except ValueError:
        return None


def _try_float(s: str) -> Optional[float]:
    try:
        return float(s)
    except ValueError:
        return None


def _is_null_field(v: str) -> bool:
    """Whitespace-only (and empty) fields are nulls for numeric typing."""
    return v in _NULL_STRINGS or not v.strip()


def infer_column(values: Sequence[str]) -> np.ndarray:
    """Infer one column's type and parse it (object dtype for strings)."""
    non_null = [v for v in values if not _is_null_field(v)]
    has_null = len(non_null) != len(values)
    floats = numpy_dtype(float_dtype())
    if non_null and all(_try_int(v) is not None for v in non_null):
        if not has_null:
            ints = [int(v) for v in values]
            lo, hi = min(ints), max(ints)
            dt = (numpy_dtype(int_dtype()) if -(2**31) <= lo and hi < 2**31
                  else np.int64)
            return np.asarray(ints, dtype=dt)
        return np.asarray([np.nan if _is_null_field(v) else float(v)
                           for v in values], dtype=floats)
    if non_null and all(_try_float(v) is not None for v in non_null):
        return np.asarray([np.nan if _is_null_field(v) else float(v)
                           for v in values], dtype=floats)
    if non_null and not has_null and \
            all(v in _TRUE or v in _FALSE for v in non_null):
        return np.asarray([v in _TRUE for v in values], dtype=np.bool_)
    return np.asarray([v if v not in _NULL_STRINGS else None
                       for v in values], dtype=object)


def read_csv(path: str, header: bool = False, infer_schema: bool = True,
             delimiter: str = ",", quote: str = '"', device=None) -> Frame:
    """Load a CSV file into a Frame on ``device`` (default: the active
    session's device)."""
    with open(path, "rb") as f:
        text = f.read().decode("utf-8")
    if quote and quote in text:
        raise NotImplementedError(
            "quoted CSV fields are not in the torch port's reader yet")
    rows = [r.split(delimiter) for r in split_records(text)]
    if not rows:
        return Frame({}, device=device)
    if header:
        names, rows = rows[0], rows[1:]
    else:
        names = [f"_c{i}" for i in range(len(rows[0]))]
    cols: list[list[str]] = [[] for _ in names]
    for r in rows:
        for i in range(len(names)):
            cols[i].append(r[i] if i < len(r) else "")
    data = {}
    for name, values in zip(names, cols):
        if infer_schema:
            data[name] = infer_column(values)
        else:
            data[name] = np.asarray([v if v not in _NULL_STRINGS else None
                                     for v in values], dtype=object)
    return Frame(data, device=device)


class DataFrameReader:
    """``spark.read().format("csv").option(...).load(path)``."""

    def __init__(self, session=None):
        self._session = session
        self._format = "csv"
        self._options: dict[str, str] = {}

    def format(self, fmt: str) -> "DataFrameReader":
        self._format = fmt.lower()
        return self

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key.lower()] = str(value)
        return self

    def _bool_opt(self, key: str, default: bool) -> bool:
        v = self._options.get(key.lower())
        return default if v is None else \
            v.strip().lower() in ("true", "1", "yes")

    def load(self, path: str) -> Frame:
        if self._format != "csv":
            raise NotImplementedError(
                f"format {self._format!r}: the torch port reads csv only")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return read_csv(
            path,
            header=self._bool_opt("header", False),
            infer_schema=self._bool_opt("inferschema", False),
            delimiter=self._options.get(
                "sep", self._options.get("delimiter", ",")),
            quote=self._options.get("quote", '"'),
            device=(self._session.device if self._session is not None
                    else None))
