"""Shared helpers of the expression layer and the builtin function library
(the JAX package's ``_null_mask``, ``_str_map``, ``_scalar_value``,
``_scalar_str``, ``_scalar_int``, ``_int_or_null``, ``_cell_is_null``,
``_nullable_int32_col``, ``_exact_int64_col`` and
``_require_array_cells``, ``sparkdq4ml_tpu/ops/expressions.py:618-760``,
``:777-791``, ``:968``, ``:1300``, ``:2540-2551``, ``:2657-2662``).

String and array columns are numpy object arrays on the host, with
``None`` as their null; numeric columns are tensors on the frame's
device, with NaN as the float null. A function that computes on the host
builds its numeric result as a tensor on the evaluation device:
``Func.eval`` names it (:func:`evaluating_on`), so a string parsed on the
host lands on the frame's card, never on the CPU by default.

The JAX package's x64 switch is the port's float64 policy
(``config.wide_types``): ``jnp.asarray`` of a 64-bit numpy array keeps
its width only under it (:func:`device_array`).
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

from ..config import float_dtype, numpy_dtype, resolve_device, wide_types
from . import strings

_DEVICE: contextvars.ContextVar = contextvars.ContextVar(
    "sparkdq4ml_eval_device", default=None)


@contextlib.contextmanager
def evaluating_on(device):
    """The device that host-computed columns of a builtin go to."""
    token = _DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _DEVICE.reset(token)


def eval_device() -> torch.device:
    """The device of the frame being evaluated, else the session's."""
    dev = _DEVICE.get()
    return dev if dev is not None else resolve_device()


def wide_float() -> torch.dtype:
    """``jnp.float64`` as the JAX package gets it: float64 under x64 (the
    float64 policy), float32 without."""
    return torch.float64 if wide_types() else torch.float32


def wide_int() -> torch.dtype:
    """``jnp.int64`` likewise: int64 under the float64 policy, else
    int32."""
    return torch.int64 if wide_types() else torch.int32


def device_array(values, dtype=None) -> torch.Tensor:
    """``jnp.asarray(values[, dtype])`` on the evaluation device: without
    a dtype a 64-bit numpy array narrows to 32 bits unless the float64
    policy holds, as JAX narrows without x64."""
    if isinstance(values, torch.Tensor):
        t = values.to(eval_device()) if values.device != eval_device() \
            else values
        return t if dtype is None else t.to(dtype)
    arr = np.asarray(values)
    if dtype is None:
        if arr.dtype == np.float64:
            dtype = wide_float()
        elif arr.dtype == np.int64:
            dtype = wide_int()
    if dtype is not None:
        arr = arr.astype(numpy_dtype(dtype), copy=False)
    return torch.as_tensor(arr, device=eval_device())


def const(like: torch.Tensor, value) -> torch.Tensor:
    """``value`` as a 0-dim tensor of ``like``'s dtype on its device. A
    divisor must be one: CUDA divides a tensor by a Python number as a
    product with its reciprocal (one more rounding), where the CPU and
    XLA divide."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def as_float(v) -> torch.Tensor:
    """``jnp.asarray(v, float_dtype())``: a numeric column as the
    policy's float on its device (a host column on the evaluation
    device)."""
    if isinstance(v, torch.Tensor):
        return v.to(float_dtype())
    return device_array(np.asarray(v, np.float64), float_dtype())


def as_tensor(v) -> torch.Tensor:
    """``jnp.asarray(v)``: a numeric column as it is."""
    return v if isinstance(v, torch.Tensor) else device_array(v)


# ---------------------------------------------------------------------------
# Host columns: strings and arrays
# ---------------------------------------------------------------------------

def is_host_column(values) -> bool:
    """A string or array column: a numpy object array kept on the host."""
    return isinstance(values, np.ndarray) and values.dtype == object


def host_objects(values) -> np.ndarray:
    """A column as a host object array; a tensor's cells become Python
    numbers, as ``np.asarray(jax_array, object)`` gives in the JAX
    package."""
    if is_host_column(values):
        return values
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy().astype(object)
    return np.asarray(values).astype(object)


def host_array(values) -> np.ndarray:
    """``np.asarray(column)``: a tensor's values as a numpy array of its
    dtype (numpy scalar cells), a host column as it is."""
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    return np.asarray(values)


def host_mask(mask, frame) -> torch.Tensor:
    """A host bool array computed from string cells, on the frame's
    device."""
    return torch.as_tensor(np.asarray(mask, bool), device=frame.device)


def _is_null_cell(x) -> bool:
    """``None`` (the string null) or a float NaN (the numeric null)."""
    return x is None or (isinstance(x, float) and x != x)


def _cell_is_null(v) -> bool:
    """``None`` or a NaN of any float type, numpy scalars included."""
    return v is None or (isinstance(v, (float, np.floating)) and np.isnan(v))


def _null_cells(values) -> np.ndarray:
    return np.fromiter(map(_is_null_cell, values), bool, count=len(values))


def _null_mask(v):
    """Per-row null indicator: ``None`` in a host column (a host bool
    array), NaN in a float column (a tensor); an int or bool column has
    none."""
    if is_host_column(v):
        return np.fromiter((x is None for x in v), bool, count=len(v))
    v = as_tensor(v)
    if v.is_floating_point():
        return torch.isnan(v)
    return torch.zeros(v.shape[:1], dtype=torch.bool, device=v.device)


def _distinct_rows(hosts):
    """The distinct rows of host string columns (cells str or ``None``),
    through their dictionary codes: one column's ``(codes, words)``, or
    for several ``(inverse, a representative row of each)``; None when a
    column holds another kind of cell."""
    try:
        coded = [strings.codes(h) for h in hosts]
    except NotImplementedError:
        return None
    if len(coded) == 1:
        return coded[0]
    key = np.zeros(len(hosts[0]), np.int64)
    stride = 1
    for codes, words in coded:
        if stride * (len(words) + 1) >= 1 << 62:
            stacked = np.stack([c for c, _ in coded], axis=1)
            _, first, inv = np.unique(stacked, axis=0, return_index=True,
                                      return_inverse=True)
            return inv.reshape(-1), first
        key += (codes.astype(np.int64) + 1) * stride
        stride *= len(words) + 1
    _, first, inv = np.unique(key, return_index=True, return_inverse=True)
    return inv, first


def map_rows(fn, *arrays) -> np.ndarray:
    """``fn(*row)`` over the rows of host columns, as an object column
    (one cell a row, list results kept whole). Where every column holds
    strings and ``None``, ``fn`` runs once per distinct row and the
    results gather by the rows' dictionary codes: the same cells as a row
    loop, in the time of one encoding pass and a gather."""
    hosts = [host_objects(a) for a in arrays]
    n = len(hosts[0])
    keyed = _distinct_rows(hosts) if n > 1 else None
    if keyed is None:
        return list_column([fn(*row) for row in zip(*hosts)])
    if len(hosts) == 1:
        codes, words = keyed
        # the last entry, which NULL_CODE picks, is fn(None)
        has_null = bool((codes == strings.NULL_CODE).any())
        lut = list_column([fn(w) for w in words]
                          + [fn(None) if has_null else None])
        return lut[codes]
    inv, first = keyed
    lut = list_column([fn(*[h[i] for h in hosts]) for i in first])
    return lut[inv]


def map_cells(fn, *arrays) -> list:
    """``fn(*cells)`` of each row of host columns, once per distinct
    combination of cell objects: a column never has a cell written in
    place, so one object holds one value (a ``sequence`` result shares
    its cells between equal rows, a literal's column is one object)."""
    seen: dict = {}
    out = []
    for row in zip(*[host_objects(a) for a in arrays]):
        key = tuple(map(id, row))
        if key not in seen:
            seen[key] = fn(*row)
        out.append(seen[key])
    return out


def _str_map(fn, *arrays):
    """``fn`` over the rows of host columns; a row with a null cell
    (``None``, or NaN from a NULL literal) gives ``None``. The result is
    one object cell a row, so list results (``split``) stay ragged cells
    where the JAX package's ``np.asarray`` would make a 2-D array of
    equal-length lists."""
    return map_rows(lambda *row: None if any(_is_null_cell(x) for x in row)
                    else fn(*row), *arrays)


def tensor_strings(v: torch.Tensor) -> np.ndarray:
    """A numeric column's cells as text, each as its numpy scalar prints
    (``str(np.float32(x))``, '0.1'), NaN as ``None``: rendered once per
    distinct bit pattern (``torch.unique`` on the column's device, so -0.0
    stays apart from 0.0), then gathered on the host."""
    bits = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.float16: torch.int16}.get(v.dtype)
    keys = v.view(bits) if bits is not None else v
    uniq, inv = torch.unique(keys, return_inverse=True)
    vals = (uniq.view(v.dtype) if bits is not None else uniq).cpu().numpy()
    lut = list_column([None if (isinstance(x, np.floating) and np.isnan(x))
                       else str(x) for x in vals])
    return lut[inv.cpu().numpy()]


def _scalar_value(v):
    """The value of a literal argument, which evaluates as a full column;
    a column whose cells differ is refused rather than read at row 0 (a
    tensor is checked on its device). As in the JAX package, NaN differs
    from itself, so a NULL literal of more than one row is refused too."""
    if isinstance(v, torch.Tensor):
        flat = v.reshape(-1)
        if flat.numel() > 1:
            if not bool((flat == flat[:1]).all()):
                raise ValueError("this function argument must be a literal, "
                                 "not a column (per-row values are not "
                                 "supported)")
        return flat[0].item()
    if isinstance(v, np.ndarray) and v.ndim == 1 and len(v) \
            and v.strides[0] == 0:          # a broadcast literal: one cell
        x = v[0]
        return x.item() if hasattr(x, "item") else x
    arr = host_objects(v).ravel()
    x = arr[0]
    if len(arr) > 1 and (
            any(y != x for y in arr[1:])
            if isinstance(x, (list, tuple, np.ndarray))
            else bool(np.any(arr[1:] != x))):   # one C loop, not a Python one
        raise ValueError("this function argument must be a literal, not a "
                         "column (per-row values are not supported)")
    return x.item() if hasattr(x, "item") else x


def _scalar_str(v) -> str:
    return _scalar_value(v)


def _scalar_int(v) -> int:
    return int(_scalar_value(v))


def float_or_null(vals) -> torch.Tensor:
    """Python numbers with ``None`` as a float column with NaN, in the
    policy's float on the evaluation device."""
    return device_array(np.asarray(
        [np.nan if v is None else float(v) for v in vals], np.float64),
        float_dtype())


def _int_or_null(vals) -> torch.Tensor:
    """An int32 column, widened to the policy's float with NaN when a
    value is null (the JAX package's numeric-null convention)."""
    if None in vals:
        return float_or_null(vals)
    return device_array(np.asarray(vals, np.int32))


def bool_or_null(vals) -> torch.Tensor:
    """A bool column, or the policy's float with NaN for a null."""
    if None in vals:
        return float_or_null(vals)
    return device_array(np.asarray(vals, np.bool_))


def _nullable_int32_col(vals):
    """Small ints with ``None``s: a host object column when any is null,
    else an int32 tensor (the 32-bit sibling of ``_exact_int64_col``)."""
    if None in vals:
        return np.asarray(vals, object)
    return device_array(np.asarray(vals, np.int32))


def _exact_int64_col(vals):
    """64-bit ints (``None``s allowed): an int64 tensor under the float64
    policy, else exact host objects, as the JAX package keeps them where
    x64 is off rather than wrap them to int32."""
    if None in vals or not wide_types():
        return np.asarray(vals, object)
    return device_array(np.asarray(vals, np.int64))


def _require_array_cells(arr, fn_name):
    """Array functions refuse a column whose first non-null cell is not a
    list (a plain string column would otherwise give character-level
    results), as Spark's analyzer does."""
    a = host_objects(arr)
    for cell in a:
        if cell is None:
            continue
        if not isinstance(cell, (list, tuple, np.ndarray)):
            raise ValueError(
                f"{fn_name}() expects an array column (e.g. split() or "
                f"collect_list() output), got a {type(cell).__name__} cell")
        break
    return a


def list_column(items) -> np.ndarray:
    """A ragged list column (a collect_list result, token lists, array
    cells): a 1-D object array with one item a row, where ``np.asarray``
    would make equal-length lists one 2-D array."""
    arr = np.empty(len(items), dtype=object)
    for i, it in enumerate(items):
        arr[i] = it
    return arr


def _distinct_values(values: torch.Tensor):
    """(valid mask, distinct valid values on the host as float64, each
    valid row's index into them) of a float column: ``torch.unique`` on
    the column's device."""
    v = values.to(torch.float64)
    valid = ~torch.isnan(v)
    uniq, inv = torch.unique(v[valid], return_inverse=True)
    return valid, uniq.cpu().numpy(), inv


def per_distinct(values: torch.Tensor, fn) -> np.ndarray:
    """``fn(x)`` of each valid (non-NaN) value of a float column, as a
    host object column with ``None`` for NaN. ``fn`` runs once per
    distinct value, and the results gather back on the host: a date
    column of 10^7 rows has a few hundred distinct days."""
    out = np.full(values.shape[0], None, dtype=object)
    if values.numel() == 0:
        return out
    valid, uniq, inv = _distinct_values(values)
    lut = list_column([fn(float(x)) for x in uniq])
    out[valid.cpu().numpy()] = lut[inv.cpu().numpy()]
    return out


def per_distinct_numbers(values: torch.Tensor, fn, dtype) -> torch.Tensor:
    """``fn(x)`` (a number) of each valid value of a float column, once
    per distinct value, gathered on the column's device into ``dtype``
    with NaN where the value is NaN."""
    out = torch.full(values.shape, float("nan"), dtype=dtype,
                     device=values.device)
    if values.numel() == 0:
        return out
    valid, uniq, inv = _distinct_values(values)
    lut = torch.as_tensor(np.asarray([fn(float(x)) for x in uniq],
                                     np.float64), device=values.device)
    out[valid] = lut[inv].to(dtype)
    return out
