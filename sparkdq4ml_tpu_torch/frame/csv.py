"""CSV reader with schema inference (``sparkdq4ml_tpu/frame/csv.py``).

* Records end in ``\\r\\n``, ``\\r`` or ``\\n``: the reference datasets are
  terminated by a bare CR.
* Quoted fields (RFC 4180): delimiters and record separators inside quotes
  are content, and ``""`` inside quotes is a quote.
* Without a header the columns are named ``_c0, _c1, ...``.
* Inference prefers integer, then long, double, boolean, string. Empty
  fields are nulls: NaN in float columns, and an int column with nulls
  becomes a double column.
* ``mode``: PERMISSIVE (short rows null-fill, long rows truncate),
  DROPMALFORMED (rows of another width are dropped) or FAILFAST (they
  raise). An explicit DDL ``schema`` names and casts the columns.

Two engines: the native tokenizer (``frame/native_csv.py``) for the
all-numeric case, and the Python one here. ``engine="auto"`` takes the
Python engine where the reference does: non-numeric content, a ragged
header, a delimiter or quote of more than one byte, a mode other than
PERMISSIVE, or an explicit schema. A failure of the native engine raises;
it never re-reads the file with the Python engine.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np

from ..config import float_dtype, int_dtype, numpy_dtype
from .frame import Frame

_NULL_STRINGS = {""}
_TRUE = {"true", "TRUE", "True"}
_FALSE = {"false", "FALSE", "False"}


def split_records(text: str) -> list[str]:
    r"""Split on \r\n, \r or \n; drop blank records (Spark skips them).
    Quote-unaware: :func:`parse_csv_text` sends quoted text through the
    stateful scanner."""
    text = text.replace("\r\n", "\n").replace("\r", "\n")
    return [line for line in text.split("\n") if line.strip() != ""]


def _parse_quoted_text(text: str, delimiter: str,
                       quote: str) -> list[list[str]]:
    r"""One-pass stateful tokenizer for text with quotes: record
    separators (\r\n, \r, \n) and delimiters inside quoted fields are
    content; ``""`` inside quotes is an escaped quote (RFC 4180)."""
    rows: list[list[str]] = []
    row: list[str] = []
    buf: list[str] = []
    quoted_field = False   # the record had quotes (never blank-skipped)
    in_q = False
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if in_q:
            if c == quote:
                if i + 1 < n and text[i + 1] == quote:
                    buf.append(quote)
                    i += 1
                else:
                    in_q = False
            else:
                buf.append(c)
        elif c == quote:
            in_q = True
            quoted_field = True
        elif c == delimiter:
            row.append("".join(buf))
            buf = []
        elif c in ("\r", "\n"):
            if c == "\r" and i + 1 < n and text[i + 1] == "\n":
                i += 1
            row.append("".join(buf))
            buf = []
            if len(row) > 1 or row[0].strip() != "" or quoted_field:
                rows.append(row)      # blank lines are skipped (Spark)
            row = []
            quoted_field = False
        else:
            buf.append(c)
        i += 1
    if buf or row or quoted_field:   # a lone quoted "" is still a record
        row.append("".join(buf))
        if len(row) > 1 or row[0].strip() != "" or quoted_field:
            rows.append(row)
    return rows


def parse_csv_text(text: str, delimiter: str = ",",
                   quote: str = '"') -> list[list[str]]:
    """A whole CSV text as rows of fields: quote-free text takes the plain
    split, any quote the stateful scanner."""
    if quote and quote in text:
        return _parse_quoted_text(text, delimiter, quote)
    return [r.split(delimiter) for r in split_records(text)]


def split_fields(record: str, delimiter: str = ",",
                 quote: str = '"') -> list[str]:
    """One record's fields, with RFC 4180 quoting (the scanner of
    :func:`parse_csv_text`)."""
    if quote not in record:
        return record.split(delimiter)
    rows = _parse_quoted_text(record, delimiter, quote)
    return rows[0] if rows else [""]


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
    """Whitespace-only (and empty) fields are nulls for numeric and
    boolean typing, as the native tokenizer reads them; string columns
    keep the exact-"" rule."""
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


_MODES = ("PERMISSIVE", "DROPMALFORMED", "FAILFAST")
# The types a DDL schema may declare (_cast_column casts to each).
_DDL_TYPES = ("int", "integer", "long", "float", "double", "boolean",
              "string")


def parse_ddl_schema(ddl: str) -> list:
    """A Spark DDL schema string (``"a INT, b DOUBLE, s STRING"``) as
    [(name, type name)]."""
    fields = []
    for part in ddl.split(","):
        toks = part.split()
        if len(toks) != 2:
            raise ValueError(
                f"bad DDL field {part.strip()!r} (expected 'name TYPE')")
        name, type_name = toks
        if type_name.lower() not in _DDL_TYPES:
            raise ValueError(f"unknown SQL type name: {type_name!r}")
        fields.append((name, type_name.lower()))
    return fields


def _cast_column(values: list, type_name: str) -> np.ndarray:
    """Raw CSV strings cast to a declared type; an unparseable or null
    cell is null (Spark's PERMISSIVE), which makes an integral column a
    float column."""
    if type_name == "string":
        return np.asarray([v if v not in _NULL_STRINGS else None
                           for v in values], dtype=object)
    if type_name == "boolean":
        out = [None if _is_null_field(v)
               else v.strip().lower() == "true" for v in values]
        if any(v is None for v in out):
            return np.asarray([np.nan if v is None else float(v)
                               for v in out])
        return np.asarray(out, bool)
    floats = np.empty(len(values), np.float64)
    any_null = False
    for i, v in enumerate(values):
        try:
            floats[i] = float(v)
        except (TypeError, ValueError):
            floats[i] = np.nan
            any_null = True
    if type_name in ("int", "integer", "long"):
        if not any_null and np.all(floats == np.floor(floats)):
            return floats.astype(np.int64 if type_name == "long"
                                 else np.int32)
        return floats          # a nullable integral column is float
    return floats.astype(np.float32 if type_name == "float"
                         else numpy_dtype(float_dtype()))


def read_csv(path: str, header: bool = False, infer_schema: bool = True,
             delimiter: str = ",", engine: str = "auto", quote: str = '"',
             mode: str = "PERMISSIVE", schema=None, device=None) -> Frame:
    """Load a CSV file into a Frame on ``device`` (default: the active
    session's device).

    ``engine``: "python", "native" (the C++ tokenizer; raises where it
    cannot take the read's options) or "auto" (native where the file and
    options allow, else python). ``mode``: PERMISSIVE, DROPMALFORMED or
    FAILFAST. ``schema``: explicit [(name, type)] (from a DDL string),
    which names the columns and casts each to its type.
    """
    from . import native_csv

    mode = mode.upper()
    if mode not in _MODES:
        raise ValueError(f"mode={mode!r}; expected one of {_MODES}")
    if schema is not None:
        engine = "python"      # the cast of a declared schema is host-side
    declined = False
    if engine in ("auto", "native"):
        if mode != "PERMISSIVE":
            # the native engine pads short rows (permissive); dropping and
            # failing on a field count are the Python engine's
            if engine == "native":
                raise RuntimeError("native CSV engine supports "
                                   "mode=PERMISSIVE only")
        else:
            frame = native_csv.try_read_csv(
                path, header=header, infer_schema=infer_schema,
                delimiter=delimiter, quote=quote,
                required=(engine == "native"), device=device)
            if frame is not None:
                return frame
            declined = True

    t0 = time.perf_counter()
    with open(path, "rb") as f:
        raw = f.read()
    frame = _python_read(raw.decode("utf-8"), header, infer_schema,
                         delimiter, quote, mode, schema, device)
    native_csv.reads.add({
        "engine": "python", "mode": "python", "declined": declined,
        "path": os.path.basename(path), "bytes": len(raw),
        "rows": frame.num_slots, "chunks": 0,
        "seconds": time.perf_counter() - t0, "device": str(frame.device)})
    return frame


def _python_read(text, header, infer_schema, delimiter, quote, mode, schema,
                 device) -> Frame:
    rows = parse_csv_text(text, delimiter, quote)
    if not rows:
        return Frame({}, device=device)
    if header:
        names, rows = rows[0], rows[1:]
    else:
        names = [f"_c{i}" for i in range(len(rows[0]))]
    if schema is not None:
        if len(schema) != len(names):
            raise ValueError(
                f"schema has {len(schema)} fields but the file has "
                f"{len(names)} columns")
        names = [n for n, _ in schema]
    ncols = len(names)
    if mode != "PERMISSIVE":
        bad = [r for r in rows if len(r) != ncols]
        if bad and mode == "FAILFAST":
            raise ValueError(
                f"FAILFAST: malformed CSV record (expected {ncols} fields, "
                f"got {len(bad[0])}): {bad[0]!r}")
        if bad:  # DROPMALFORMED
            rows = [r for r in rows if len(r) == ncols]
    cols: list[list[str]] = [[] for _ in range(ncols)]
    for r in rows:
        for i in range(ncols):
            cols[i].append(r[i] if i < len(r) else "")
    if schema is not None:
        return Frame({name: _cast_column(values, type_name)
                      for (name, type_name), values in zip(schema, cols)},
                     device=device)
    data = {}
    for name, values in zip(names, cols):
        if infer_schema:
            data[name] = infer_column(values)
        else:
            data[name] = np.asarray([v if v not in _NULL_STRINGS else None
                                     for v in values], dtype=object)
    return Frame(data, device=device)


class DataFrameReader:
    """``spark.read.format("csv").option(...).load(path)``, and the json
    and parquet formats."""

    def __init__(self, session=None):
        self._session = session
        self._format = "csv"
        self._options: dict[str, str] = {}
        self._schema = None

    def schema(self, ddl: str) -> "DataFrameReader":
        """Explicit schema as a Spark DDL string (``"a INT, b DOUBLE"``):
        no inference, each column cast to its declared type."""
        self._schema = parse_ddl_schema(ddl)
        return self

    def format(self, fmt: str) -> "DataFrameReader":
        self._format = fmt.lower()
        return self

    def option(self, key: str, value) -> "DataFrameReader":
        self._options[key.lower()] = str(value)
        return self

    def options(self, **kwargs) -> "DataFrameReader":
        for k, v in kwargs.items():
            self.option(k, v)
        return self

    def _bool_opt(self, key: str, default: bool) -> bool:
        v = self._options.get(key.lower())
        return default if v is None else \
            v.strip().lower() in ("true", "1", "yes")

    def load(self, path: str) -> Frame:
        if self._format not in ("csv", "json", "parquet"):
            raise ValueError(
                f"unsupported format {self._format!r} (csv, json, "
                "or parquet)")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        device = self._session.device if self._session is not None else None
        if self._format == "parquet":
            from .parquet import read_parquet

            return read_parquet(path, device=device)
        if self._format == "json":
            from .jsonl import read_json

            return read_json(path,
                             multi_line=self._bool_opt("multiline", False),
                             device=device)
        return read_csv(
            path,
            header=self._bool_opt("header", False),
            infer_schema=self._bool_opt("inferschema", False),
            delimiter=self._options.get(
                "sep", self._options.get("delimiter", ",")),
            engine=self._options.get("engine", "auto"),
            quote=self._options.get("quote", '"'),
            mode=self._options.get("mode", "PERMISSIVE"),
            schema=self._schema, device=device)

    def csv(self, path: str, header: bool = False,
            inferSchema: bool = False) -> Frame:
        return self.option("header", header).option(
            "inferSchema", inferSchema).load(path)

    def json(self, path: str, multiLine: bool = False) -> Frame:
        return self.format("json").option("multiLine", multiLine).load(path)

    def parquet(self, path: str) -> Frame:
        return self.format("parquet").load(path)
