"""Columnar frame with a validity mask (subset of
``sparkdq4ml_tpu/frame/frame.py``).

A frame is a dict of equal-length columns plus a boolean mask. Numeric
columns are tensors on the frame's device (a vector column is 2-D); string
columns are numpy object arrays on the host. ``filter`` never compacts
rows: it ANDs into the mask, and every consumer reads the mask.
"""

from __future__ import annotations

import io
from typing import Iterable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..config import (config, float_dtype, int_dtype, resolve_device,
                      wide_types)
from ..ops.expressions import (Col, Expr, is_host_column,
                               predicate_keep_mask, spark_type_name)


def _as_column(values, device: torch.device):
    """Coerce raw values into a column: a tensor on ``device``, or a host
    object array for strings. As in the JAX package, Python lists take the
    default dtypes, and a 64-bit numpy array keeps its width only under the
    float64 policy (JAX keeps it only in x64 mode)."""
    if isinstance(values, torch.Tensor):
        return values.to(device)
    if isinstance(values, np.ndarray) and values.dtype.kind in ("U", "S"):
        return values.astype(object)
    if is_host_column(values):
        return values
    wide = wide_types() and isinstance(values, np.ndarray)
    if not isinstance(values, np.ndarray):
        values = list(values)
        if values and any(isinstance(v, str) for v in values):
            return np.asarray(values, dtype=object)
        values = np.asarray(values)
        if values.dtype == object:
            return values
    dt = None
    if values.dtype == np.float64 and not wide:
        dt = float_dtype()
    elif values.dtype == np.int64 and not wide:
        dt = int_dtype()
    return torch.as_tensor(values, dtype=dt, device=device)


def _frame_device(columns: Mapping, mask) -> torch.device:
    for v in (*columns.values(), mask):
        if isinstance(v, torch.Tensor):
            return v.device
    return resolve_device()


class Frame:
    """Immutable columnar frame with a validity mask."""

    def __init__(self, columns: Mapping[str, object], mask=None,
                 device=None):
        self.device = (resolve_device(device) if device is not None
                       else _frame_device(columns, mask))
        self._data: dict[str, object] = {}
        n = None
        for name, values in columns.items():
            arr = _as_column(values, self.device)
            if n is not None and arr.shape[0] != n:
                raise ValueError(
                    f"column length {arr.shape[0]} != frame length {n}")
            n = arr.shape[0]
            self._data[name] = arr
        self._n = 0 if n is None else int(n)
        if mask is None:
            self._mask = torch.ones(self._n, dtype=torch.bool,
                                    device=self.device)
        else:
            self._mask = torch.as_tensor(mask, dtype=torch.bool).to(
                self.device)
            if tuple(self._mask.shape) != (self._n,):
                raise ValueError("mask shape mismatch")

    @classmethod
    def from_rows(cls, rows: Iterable[Sequence], names: Sequence[str],
                  device=None) -> "Frame":
        rows = list(rows)
        cols = list(zip(*rows)) if rows else [[] for _ in names]
        return cls({name: list(vals) for name, vals in zip(names, cols)},
                   device=device)

    def _with(self, data=None, mask=None) -> "Frame":
        f = Frame.__new__(Frame)
        f.device = self.device
        f._data = dict(self._data if data is None else data)
        f._mask = self._mask if mask is None else mask
        f._n = self._n
        return f

    # -- introspection -----------------------------------------------------
    @property
    def columns(self) -> list[str]:
        return list(self._data)

    @property
    def num_slots(self) -> int:
        """Physical row slots, masked-out rows included."""
        return self._n

    @property
    def mask(self) -> torch.Tensor:
        return self._mask

    def dtypes(self) -> list[tuple[str, str]]:
        return [(name, "string" if is_host_column(arr)
                 else spark_type_name(arr.dtype))
                for name, arr in self._data.items()]

    def schema_string(self) -> str:
        """``printSchema`` text, matching Spark's output shape."""
        out = io.StringIO()
        out.write("root\n")
        for name, arr in self._data.items():
            if is_host_column(arr):
                tname = "string"
            elif arr.ndim == 2:
                tname = "vector"
            else:
                tname = spark_type_name(arr.dtype)
            out.write(f" |-- {name}: {tname} (nullable = true)\n")
        return out.getvalue()

    def print_schema(self) -> None:
        print(self.schema_string(), end="")

    printSchema = print_schema

    # -- column access -----------------------------------------------------
    def _column_values(self, name: str):
        try:
            return self._data[name]
        except KeyError:
            raise KeyError(
                f"no column {name!r}; columns: {self.columns}") from None

    def col(self, name: str) -> Col:
        if name not in self._data:
            raise KeyError(f"no column {name!r}; columns: {self.columns}")
        return Col(name)

    def _eval(self, expr_or_values):
        if isinstance(expr_or_values, Expr):
            arr = expr_or_values.eval(self)
        else:
            arr = _as_column(expr_or_values, self.device)
        if arr.shape[0] != self._n:
            raise ValueError(
                f"column length {arr.shape[0]} != frame length {self._n}")
        return arr

    # -- transformations ---------------------------------------------------
    def with_column(self, name: str, values) -> "Frame":
        """``withColumn``: add or replace a column."""
        data = dict(self._data)
        data[name] = self._eval(values)
        return self._with(data=data)

    withColumn = with_column

    def with_column_renamed(self, old: str, new: str) -> "Frame":
        """``withColumnRenamed``; a no-op if ``old`` is absent (Spark)."""
        if old not in self._data:
            return self
        return self._with(data={(new if k == old else k): v
                                for k, v in self._data.items()})

    withColumnRenamed = with_column_renamed

    def select(self, *exprs: Union[str, Expr]) -> "Frame":
        data: dict[str, object] = {}
        for e in exprs:
            if isinstance(e, str):
                e = Col(e)
            data[e.name] = self._eval(e)
        return self._with(data=data)

    def filter(self, condition: Union[Expr, torch.Tensor]) -> "Frame":
        """AND a predicate into the validity mask; a NULL (NaN) predicate
        drops the row, as Spark's WHERE does."""
        cond = self._eval(condition)
        return self._with(mask=self._mask & predicate_keep_mask(cond))

    def random_split(self, weights: Sequence[float],
                     seed: int = 0) -> list["Frame"]:
        """Split the rows into disjoint frames with the given relative
        weights (``df.randomSplit([0.8, 0.2], seed)``). The draw is the JAX
        package's (one numpy uniform per row slot), so both packages split
        alike. The splits share the columns; only the masks differ."""
        w = np.asarray(weights, np.float64)
        if w.ndim != 1 or len(w) < 1 or np.any(w < 0) or w.sum() == 0:
            raise ValueError(f"invalid split weights {weights!r}")
        edges = np.cumsum(w / w.sum())
        u = np.random.default_rng(seed).random(self._n)
        out = []
        lo = 0.0
        for hi in edges:
            pick = torch.as_tensor((u >= lo) & (u < hi), device=self.device)
            out.append(self._with(mask=self._mask & pick))
            lo = hi
        return out

    randomSplit = random_split

    # -- actions -------------------------------------------------------------
    def count(self) -> int:
        """Number of valid (unmasked) rows."""
        return int(self._mask.sum())

    def _host_mask(self) -> np.ndarray:
        return self._mask.cpu().numpy()

    def to_pydict(self, limit: Optional[int] = None) -> dict:
        """The valid rows on the host, as numpy arrays; ``limit`` gathers
        only the first ``limit`` valid rows."""
        m = self._host_mask()
        if limit is not None:
            keep = np.cumsum(m) <= limit
            m = m & keep
            m = m[:(int(np.argmax(~keep)) if not keep.all() else len(m))]
        out = {}
        for name, arr in self._data.items():
            host = arr[:len(m)]
            if isinstance(host, torch.Tensor):
                host = host.cpu().numpy()
            out[name] = np.asarray(host)[m]
        return out

    # -- display -------------------------------------------------------------
    @staticmethod
    def _format_cell(v, truncate: int) -> str:
        if isinstance(v, (np.floating, float)):
            if np.isnan(v):
                s = "NaN"
            elif isinstance(v, np.floating):
                # shortest round-trip repr at the column's own precision
                s = np.format_float_positional(v, unique=True, trim="0")
            else:
                s = repr(float(v))
        elif isinstance(v, (np.bool_, bool)):
            s = "true" if v else "false"
        elif isinstance(v, (np.integer, int)):
            s = str(int(v))
        elif isinstance(v, np.ndarray):  # vector cell, Spark-style: [40.0]
            s = "[" + ",".join(
                np.format_float_positional(x, unique=True, trim="0")
                if isinstance(x, np.floating) else str(x) for x in v) + "]"
        elif v is None:
            s = "null"
        else:
            s = str(v)
        if truncate > 0 and len(s) > truncate:
            s = s[: truncate - 3] + "..." if truncate > 3 else s[:truncate]
        return s

    def show_string(self, n: int = None,
                    truncate: Union[bool, int] = True) -> str:
        """Spark-format ASCII table (right-aligned cells, +---+ borders,
        ``only showing top N rows`` footer)."""
        if n is None:
            n = config.default_show_rows
        tr = 20 if truncate is True else (0 if truncate is False
                                          else int(truncate))
        total = int(self._host_mask().sum())
        d = self.to_pydict(limit=n)
        names = self.columns
        shown = len(next(iter(d.values()))) if d else 0
        rows = [[self._format_cell(d[name][i], tr) for name in names]
                for i in range(shown)]
        headers = [name if tr <= 0 or len(name) <= tr
                   else name[: tr - 3] + "..." for name in names]
        widths = [max([len(h)] + [len(r[j]) for r in rows])
                  for j, h in enumerate(headers)]
        sep = "+" + "+".join("-" * w for w in widths) + "+"
        out = [sep, "|" + "|".join(h.rjust(w) for h, w in
                                   zip(headers, widths)) + "|", sep]
        for r in rows:
            out.append("|" + "|".join(c.rjust(w) for c, w in
                                      zip(r, widths)) + "|")
        out.append(sep)
        text = "\n".join(out) + "\n"
        if total > n:
            text += f"only showing top {n} rows\n"
        return text

    def show(self, n: int = None, truncate: Union[bool, int] = True) -> None:
        print(self.show_string(n, truncate))

    def __repr__(self):
        fields = ", ".join(f"{name}: {t}" for name, t in self.dtypes())
        return f"Frame[{fields}]"

    # -- temp views ----------------------------------------------------------
    def create_or_replace_temp_view(self, name: str) -> None:
        """Register this frame in the catalog for SQL access."""
        from ..sql.catalog import default_catalog

        default_catalog().register(name, self)

    createOrReplaceTempView = create_or_replace_temp_view
