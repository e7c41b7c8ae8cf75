"""CSV writer and ``df.write`` (``sparkdq4ml_tpu/frame/writer.py``): the
valid rows of a frame back to storage as CSV, JSON lines or Parquet. The
CSV bytes equal the JAX writer's for the same frame."""

from __future__ import annotations

import os

import numpy as np


def _format_value(v) -> str:
    if v is None:
        return ""
    if isinstance(v, (np.floating, float)):
        if np.isnan(v):
            return ""
        return np.format_float_positional(np.float64(v), unique=True,
                                          trim="0")
    if isinstance(v, (np.bool_, bool)):
        return "true" if v else "false"
    if isinstance(v, (np.integer, int)):
        return str(int(v))
    return str(v)


def _escape(s: str, delimiter: str, quote: str = '"') -> str:
    if delimiter in s or quote in s or "\n" in s or "\r" in s:
        return quote + s.replace(quote, quote * 2) + quote
    return s


def write_csv(frame, path: str, header: bool = False,
              delimiter: str = ",") -> None:
    d = frame.to_pydict()  # valid rows only
    names = frame.columns
    lines = []
    if header:
        lines.append(delimiter.join(_escape(n, delimiter) for n in names))
    n = len(next(iter(d.values()))) if d else 0
    for i in range(n):
        lines.append(delimiter.join(
            _escape(_format_value(d[name][i]), delimiter) for name in names))
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", newline="") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


class DataFrameWriter:
    """``df.write.format("csv").option(...).mode(...).save(path)``."""

    def __init__(self, frame):
        self._frame = frame
        self._format = "csv"
        self._options: dict[str, str] = {}
        self._mode = "errorifexists"

    def format(self, fmt: str) -> "DataFrameWriter":
        self._format = fmt.lower()
        return self

    def option(self, key: str, value) -> "DataFrameWriter":
        self._options[key.lower()] = str(value)
        return self

    def mode(self, mode: str) -> "DataFrameWriter":
        if mode.lower() not in ("overwrite", "errorifexists", "error"):
            raise ValueError(f"unsupported write mode {mode!r}")
        self._mode = mode.lower()
        return self

    def save(self, path: str) -> None:
        if self._format not in ("csv", "json", "parquet"):
            raise ValueError(
                f"unsupported format {self._format!r} (csv, json, "
                "or parquet)")
        if os.path.exists(path) and self._mode == "errorifexists":
            raise FileExistsError(
                f"{path} exists (use .mode('overwrite') to replace)")
        if self._format == "parquet":
            from .parquet import write_parquet

            write_parquet(
                self._frame, path,
                compression=self._options.get("compression", "snappy"))
            return
        if self._format == "json":
            from .jsonl import write_json

            write_json(self._frame, path)
            return
        header = self._options.get("header", "false").lower() in ("true", "1")
        delimiter = self._options.get("sep",
                                      self._options.get("delimiter", ","))
        write_csv(self._frame, path, header=header, delimiter=delimiter)

    def csv(self, path: str) -> None:
        self.save(path)

    def json(self, path: str) -> None:
        self.format("json").save(path)

    def parquet(self, path: str) -> None:
        self.format("parquet").save(path)
