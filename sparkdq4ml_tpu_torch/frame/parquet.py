"""Parquet read and write (``sparkdq4ml_tpu/frame/parquet.py``): one Arrow
column per frame column. ``pyarrow`` is imported only here, and is
required here."""

from __future__ import annotations

import numpy as np

from .frame import Frame


def _require_pyarrow():
    try:
        import pyarrow
        import pyarrow.parquet  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "parquet support requires pyarrow, which is not installed "
            "(use csv/json formats instead)") from e
    return pyarrow


def write_parquet(frame, path: str, compression: str = "snappy") -> None:
    """The valid rows; a vector or array column as an Arrow list of
    float64, a string column as strings (None is null)."""
    pa = _require_pyarrow()
    import pyarrow.parquet as pq

    d = frame.to_pydict()
    cols = {}
    for name in frame.columns:
        v = d[name]
        arr = np.asarray(v)
        if arr.dtype != object and arr.ndim == 2:
            cols[name] = pa.array([[float(e) for e in row] for row in arr],
                                  type=pa.list_(pa.float64()))
        elif arr.dtype == object:
            vals = list(v)
            if any(isinstance(x, (list, tuple, np.ndarray))
                   for x in vals if x is not None):
                cols[name] = pa.array(
                    [None if x is None else
                     [float(e) for e in np.asarray(x).ravel()]
                     for x in vals], type=pa.list_(pa.float64()))
            else:
                cols[name] = pa.array(
                    [None if x is None else str(x) for x in vals],
                    type=pa.string())
        else:
            cols[name] = pa.array(arr)
    pq.write_table(pa.table(cols), path, compression=compression)


def read_parquet(path: str, device=None) -> Frame:
    pa = _require_pyarrow()
    import pyarrow.parquet as pq

    table = pq.read_table(path)
    data = {}
    for name in table.column_names:
        col = table.column(name)
        t = col.type
        if pa.types.is_list(t) or pa.types.is_large_list(t):
            data[name] = np.asarray(
                [None if x is None else np.asarray(x, np.float64)
                 for x in col.to_pylist()], dtype=object)
        elif (pa.types.is_string(t) or pa.types.is_large_string(t)
              or pa.types.is_binary(t)):
            data[name] = np.asarray(col.to_pylist(), dtype=object)
        elif pa.types.is_boolean(t):
            data[name] = np.asarray(col.to_pylist(), dtype=bool)
        else:
            # Arrow nulls of a number column become NaN
            arr = col.to_numpy(zero_copy_only=False)
            if not arr.flags.writeable:  # Arrow's own memory: copy it
                arr = arr.copy()
            if col.null_count:
                arr = np.asarray(arr, np.float64)
                mask = np.asarray(col.is_null().to_pylist(), bool)
                arr = np.where(mask, np.nan, arr)
            data[name] = arr
    return Frame(data, device=device)
