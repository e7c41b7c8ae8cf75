"""JSON-lines reader and writer (``sparkdq4ml_tpu/frame/jsonl.py``): one
object a line, or with ``multi_line`` one top-level array of objects.

The columns are the union of the records' keys. A column whose values are
all integral reads as int, any float makes it double, and a string, bool
or nested value makes it a host object column; a missing key is null (NaN
in a number column, None in an object column).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from ..config import float_dtype, numpy_dtype
from .frame import Frame, list_column


def _records_from_file(path: str, multi_line: bool) -> list[dict]:
    with open(path, "r", encoding="utf-8") as f:
        if multi_line:
            records = json.load(f)
            if not isinstance(records, list):
                raise ValueError(
                    "multiLine json must be a top-level array of objects")
        else:
            records = [json.loads(line) for line in f if line.strip()]
    for r in records:
        if not isinstance(r, dict):
            raise ValueError(f"json record is not an object: {r!r}")
    return records


def read_json(path: str, multi_line: bool = False, device=None) -> Frame:
    records = _records_from_file(path, multi_line)
    names: list[str] = []
    for r in records:
        for k in r:
            if k not in names:
                names.append(k)
    floats = numpy_dtype(float_dtype())
    data = {}
    for name in names:
        vals = [r.get(name) for r in records]
        kinds = set()
        for v in vals:
            if v is None:
                continue
            if isinstance(v, bool):
                kinds.add("bool")
            elif isinstance(v, int):
                kinds.add("int")
            elif isinstance(v, float):
                kinds.add("float")
            elif isinstance(v, str):
                kinds.add("str")
            else:
                kinds.add("object")
        if kinds <= {"int"} and all(v is not None for v in vals):
            try:
                data[name] = np.asarray(vals, np.int64)
            except OverflowError:
                # integers past int64 read as a float column
                data[name] = np.asarray([float(v) for v in vals], floats)
        elif kinds <= {"int", "float"}:
            data[name] = np.asarray(
                [math.nan if v is None else float(v) for v in vals], floats)
        elif kinds <= {"bool"} and all(v is not None for v in vals):
            data[name] = np.asarray(vals, bool)
        else:
            data[name] = list_column(vals)
    return Frame(data, device=device)


def _json_value(v):
    if v is None:
        return None
    if isinstance(v, (np.floating, float)):
        # NaN and infinities have no JSON form: null, at every depth
        return float(v) if math.isfinite(v) else None
    if isinstance(v, (np.bool_, bool)):
        return bool(v)
    if isinstance(v, (np.integer, int)):
        return int(v)
    if isinstance(v, np.ndarray):
        return [_json_value(x) for x in v.tolist()]
    if isinstance(v, (list, tuple)):
        return [_json_value(x) for x in v]
    if isinstance(v, dict):
        return {k: _json_value(x) for k, x in v.items()}
    return v


def write_json(frame, path: str) -> None:
    """One JSON object a line, valid rows only; NaN is null."""
    d = frame.to_pydict()
    names = frame.columns
    n = len(next(iter(d.values()))) if d else 0
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n):
            f.write(json.dumps({name: _json_value(d[name][i])
                                for name in names}) + "\n")
