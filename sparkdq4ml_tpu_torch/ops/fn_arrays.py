"""The array builtins (``sparkdq4ml_tpu/ops/expressions.py:777-1230``):
``array``, ``array_contains``, ``element_at``, ``getItem``, ``size``,
``sort_array``, ``array_distinct``, ``array_join``, ``slice``,
``flatten``, ``array_position``, ``array_remove``, the null-safe
``array_union``/``array_intersect``/``array_except`` (``_array_set_op``
``:1065``), ``arrays_overlap``, ``array_min``/``array_max``,
``array_repeat``, ``sequence``, ``arrays_zip``, ``shuffle`` and
``reverse``.

Array cells are host objects (numpy object arrays of elements), as in the
JAX package, so these run on the host; boolean and integer results go to
the evaluation device. Set operations treat null as equal to null. The
functions of cells run once per distinct combination of cell objects
(``cells.map_cells``): ``sequence`` builds one cell per distinct bounds,
which its equal rows share.
"""

from __future__ import annotations

import builtins

import numpy as np

from .cells import (_cell_is_null, _require_array_cells, _scalar_int,
                    _scalar_value, _str_map, bool_or_null, device_array,
                    float_or_null, host_array, host_objects, map_cells,
                    list_column, wide_int)


def _fn_array_contains(arr, value):
    """NULL for a null cell; the value is a literal."""
    v = _scalar_value(value)
    return bool_or_null(map_cells(
        lambda cell: None if cell is None else bool(v in cell),
        _require_array_cells(arr, "array_contains")))


def _fn_element_at(arr, index):
    """1-based, negative counts from the end; out of range or a null cell
    gives NULL."""
    i = _scalar_int(index)
    if i == 0:
        raise ValueError("element_at index is 1-based; 0 is invalid")
    def one(cell):
        if cell is None:
            return None
        pos = i - 1 if i > 0 else len(cell) + i
        return cell[pos] if 0 <= pos < len(cell) else None

    return list_column(map_cells(one, _require_array_cells(arr,
                                                           "element_at")))


def _fn_get_item(arr, index):
    """0-based; a negative or out-of-range ordinal or a null cell gives
    NULL (GetArrayItem)."""
    i = _scalar_int(index)
    return list_column(map_cells(
        lambda cell: None if cell is None or i < 0 or i >= len(cell)
        else cell[i], _require_array_cells(arr, "getItem")))


def _fn_array(*cols):
    """One array cell a row from scalar columns; a null (NaN included)
    becomes ``None`` inside the cell. Numeric cells keep their numpy
    scalars, as ``np.asarray`` of the JAX package's columns does."""
    if not cols:
        raise ValueError("array() needs at least one column")
    host = [host_array(c) for c in cols]
    out = np.empty(len(host[0]), object)
    for i in range(len(out)):
        out[i] = np.asarray(
            [None if _cell_is_null(h[i]) else h[i] for h in host], object)
    return out


def _fn_sort_array(arr, *asc):
    """Nulls first ascending, last descending; ascending by default."""
    up = bool(host_array(asc[0]).ravel()[0]) if asc else True

    def one(cell):
        if cell is None:
            return None
        vals = [v for v in cell if v is not None]
        nulls = [None] * (len(cell) - len(vals))
        vals.sort(reverse=not up)
        return np.asarray(nulls + vals if up else vals + nulls, object)

    return list_column(map_cells(one, _require_array_cells(arr,
                                                           "sort_array")))


def _elem_key(v):
    """Set identity of an element: null equals null, NaN equals NaN."""
    if v is None:
        return ("\0null",)
    if isinstance(v, (float, np.floating)) and np.isnan(v):
        return ("\0nan",)
    return v


def _fn_array_distinct(arr):
    def one(cell):
        if cell is None:
            return None
        seen, vals = set(), []
        for v in cell:
            k = _elem_key(v)
            if k not in seen:
                seen.add(k)
                vals.append(v)
        return np.asarray(vals, object)

    return list_column(map_cells(one, _require_array_cells(
        arr, "array_distinct")))


def _fn_array_join(arr, delim, *null_replacement):
    """Nulls are dropped unless a replacement is given."""
    d = str(host_objects(delim).ravel()[0])
    rep = (str(host_objects(null_replacement[0]).ravel()[0])
           if null_replacement else None)
    return list_column(map_cells(
        lambda cell: None if cell is None
        else d.join((rep if v is None else str(v)) for v in cell
                    if v is not None or rep is not None),
        _require_array_cells(arr, "array_join")))


def _fn_slice(arr, start, length):
    """1-based; a negative start counts from the end; start 0 is an
    error."""
    s = _scalar_int(start)
    ln = _scalar_int(length)
    if s == 0:
        raise ValueError("slice start index is 1-based; 0 is invalid")
    if ln < 0:
        raise ValueError("slice length must be >= 0")
    out = []
    for cell in _require_array_cells(arr, "slice"):
        if cell is None:
            out.append(None)
            continue
        pos = s - 1 if s > 0 else len(cell) + s
        out.append(np.asarray([], object) if pos < 0
                   else np.asarray(list(cell[pos:pos + ln]), object))
    return list_column(out)


def _fn_flatten(arr):
    """One level of nesting removed; a null inner array nulls the cell;
    a flat array column is refused."""
    out = []
    for cell in _require_array_cells(arr, "flatten"):
        if cell is None:
            out.append(None)
            continue
        vals: list = []
        for inner in cell:
            if inner is None:
                vals = None
                break
            if not isinstance(inner, (list, tuple, np.ndarray)):
                raise ValueError(
                    "flatten() expects an array-of-arrays column; inner "
                    f"cells here are {type(inner).__name__}")
            vals.extend(inner)
        out.append(None if vals is None else np.asarray(vals, object))
    return list_column(out)


def _fn_array_size(arr):
    """The length of a cell; a null cell gives -1 (Spark 2.4's
    sizeOfNull)."""
    return device_array(np.asarray(
        [-1 if cell is None else len(cell)
         for cell in _require_array_cells(arr, "size")], np.int32))


def _fn_array_position(arr, value):
    """1-based index of the first element equal to the literal, 0 when
    absent; a null cell gives NULL; null elements never match. A 64-bit
    column as ``jnp.asarray`` of int64 gives it (int32 without the float64
    policy)."""
    v = _scalar_value(value)
    out = []
    for cell in _require_array_cells(arr, "array_position"):
        if cell is None or v is None:
            out.append(None)
            continue
        pos = 0
        for i, x in enumerate(cell):
            if x is not None and x == v:
                pos = i + 1
                break
        out.append(pos)
    if any(x is None for x in out):
        return np.asarray(out, object)
    return device_array(np.asarray(out, np.int64), wide_int())


def _fn_array_remove(arr, element):
    """Drop every element equal to the literal; null elements stay."""
    v = _scalar_value(element)
    return list_column([
        None if cell is None or v is None
        else np.asarray([x for x in cell if x is None or x != v], object)
        for cell in _require_array_cells(arr, "array_remove")])


def _array_set_op(name, candidates, keep):
    """One dedup pass over ``candidates(la, lb)`` keeping the elements
    whose key passes ``keep(key, right_keys)``; null equals null; a null
    cell on either side gives NULL."""

    def one(la, lb):
        if la is None or lb is None:
            return None
        right = {_elem_key(x) for x in lb}
        seen, vals = set(), []
        for x in candidates(la, lb):
            k = _elem_key(x)
            if k not in seen and keep(k, right):
                seen.add(k)
                vals.append(x)
        return np.asarray(vals, object)

    def f(a, b):
        return list_column(map_cells(one, _require_array_cells(a, name),
                                     _require_array_cells(b, name)))

    return f


# array_union: a's first occurrences in order, then b's unseen ones;
# array_intersect / array_except: a's distinct elements present / absent
# in b, in a's order.
_fn_array_union = _array_set_op(
    "array_union", lambda la, lb: list(la) + list(lb), lambda k, r: True)
_fn_array_intersect = _array_set_op(
    "array_intersect", lambda la, lb: la, lambda k, r: k in r)
_fn_array_except = _array_set_op(
    "array_except", lambda la, lb: la, lambda k, r: k not in r)


def _fn_arrays_overlap(a, b):
    """True on a shared non-null element; else NULL when both sides are
    non-empty and either holds a null; else false."""
    out = []
    for la, lb in zip(_require_array_cells(a, "arrays_overlap"),
                      _require_array_cells(b, "arrays_overlap")):
        if la is None or lb is None:
            out.append(None)
            continue
        sa = {_elem_key(x) for x in la if x is not None}
        has_null = any(x is None for x in la) or any(x is None for x in lb)
        if any(x is not None and _elem_key(x) in sa for x in lb):
            out.append(True)
        elif len(la) and len(lb) and has_null:
            out.append(None)
        else:
            out.append(False)
    return bool_or_null(out)


def _array_extreme(which):
    """array_min / array_max: null elements skipped; an empty, all-null
    or null cell gives NULL; strings stay host, numbers become the
    policy's float."""
    pick = builtins.min if which == "min" else builtins.max

    def f(arr):
        out = []
        for cell in _require_array_cells(arr, f"array_{which}"):
            vals = (None if cell is None
                    else [x for x in cell if x is not None])
            out.append(pick(vals) if vals else None)
        if all(isinstance(x, str) for x in out if x is not None):
            return np.asarray(out, object)
        return float_or_null(out)

    return f


def _fn_array_repeat(elem, count):
    """The row's value ``count`` times; a negative count gives []."""
    n = builtins.max(0, _scalar_int(count))
    host = host_array(elem)
    out = np.empty(len(host), object)
    for i, x in enumerate(host):
        out[i] = np.asarray([None if _cell_is_null(x) else x] * n, object)
    return out


def _fn_sequence(start, stop, *step):
    """The inclusive integer range of each row; the default step is ±1
    toward stop; a step of 0 or one pointing away from stop is an error.
    Each distinct (start, stop, step) builds its cell once."""
    bounds = [host_array(start).astype(np.float64),
              host_array(stop).astype(np.float64)]
    if step:
        bounds.append(host_array(step[0]).astype(np.float64))
    bounds = np.stack(bounds, axis=1)
    valid = ~np.isnan(bounds).any(axis=1)
    out = np.full(len(bounds), None, dtype=object)
    # int() of each bound truncates toward zero, as astype does
    keys, inv = np.unique(bounds[valid].astype(np.int64), axis=0,
                          return_inverse=True)
    lut = []
    for row in keys:
        lo, hi = int(row[0]), int(row[1])
        s = int(row[2]) if step else (1 if hi >= lo else -1)
        if s == 0 or (hi > lo and s < 0) or (hi < lo and s > 0):
            raise ValueError(
                f"sequence boundaries: {lo} to {hi} by {s} — the step "
                "must move toward stop (Spark's requirement)")
        lut.append(np.asarray(list(range(lo, hi + (1 if s > 0 else -1), s)),
                              object))
    out[valid] = list_column(lut)[inv.reshape(-1)]
    return out


def _fn_arrays_zip(*arrs):
    """Element-wise rows padded with null to the longest input; each
    zipped element is a fixed-width list (no struct columns)."""
    cells = [_require_array_cells(a, "arrays_zip") for a in arrs]
    out = []
    for row in zip(*cells):
        if any(c is None for c in row):
            out.append(None)
            continue
        width = builtins.max((len(c) for c in row), default=0)
        out.append(list_column(
            [np.asarray([c[j] if j < len(c) else None for c in row], object)
             for j in range(width)]))
    return list_column(out)


def _fn_shuffle(arr, *seed):
    """A random permutation of each cell; a seed of -1 (the one-argument
    form) draws from the OS, any other makes the column reproducible."""
    s = _scalar_int(seed[0]) if seed else -1
    rng = np.random.default_rng(None if s == -1 else s)
    return list_column([
        None if cell is None
        else np.asarray([cell[j] for j in rng.permutation(len(cell))],
                        object)
        for cell in _require_array_cells(arr, "shuffle")])


def _fn_reverse(v):
    """Strings reverse by character, arrays by element, dispatched on the
    first non-null cell."""
    a = host_objects(v)
    first = next((c for c in a if c is not None), None)
    if isinstance(first, (list, tuple, np.ndarray)):
        return list_column([None if c is None
                            else np.asarray(list(c)[::-1], object)
                            for c in a])
    return _str_map(lambda x: x[::-1], v)


ARRAY_FNS = {
    "array_contains": _fn_array_contains,
    "element_at": _fn_element_at,
    "get_item": _fn_get_item,
    "array": _fn_array,
    "sort_array": _fn_sort_array,
    "array_distinct": _fn_array_distinct,
    "array_join": _fn_array_join,
    "slice": _fn_slice,
    "flatten": _fn_flatten,
    "size": _fn_array_size,
    "reverse": _fn_reverse,
    "array_position": _fn_array_position,
    "array_remove": _fn_array_remove,
    "array_union": _fn_array_union,
    "array_intersect": _fn_array_intersect,
    "array_except": _fn_array_except,
    "arrays_overlap": _fn_arrays_overlap,
    "array_min": _array_extreme("min"),
    "array_max": _array_extreme("max"),
    "array_repeat": _fn_array_repeat,
    "sequence": _fn_sequence,
    "arrays_zip": _fn_arrays_zip,
    "shuffle": _fn_shuffle,
}
