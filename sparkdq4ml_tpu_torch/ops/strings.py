"""String keys as integer codes (the port's counterpart of the JAX
package's host paths for string keys in ``frame/aggregates.py``,
``frame/frame.py`` and ``frame/window.py``).

String columns stay numpy object arrays on the host, as in the JAX
package, and ``None`` is their null. To group, sort, deduplicate, join,
partition or match one, the host builds a dictionary of its distinct
strings (one hash pass over the cells, then ``sorted`` over the few
uniques, so code order is Python's code-point order, the order of the
reference's host lexsort), encodes every cell as an int32 code
(``NULL_CODE`` for ``None``, below every string, so nulls lead), and the
device programs run on the codes. The keys of a result decode on the
host.

A column's codes are kept for the last few object arrays encoded (by
identity, through a weak reference), so the verbs that key on one column
in turn (a GROUP BY, an ORDER BY and a window over one string column)
encode it once. Frames never write their columns in place, so the same
array object holds the same cells.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

NULL_CODE = -1
_RECENT_MAX = 8


class _Recent:
    """The codes of the last ``_RECENT_MAX`` arrays encoded; an entry
    leaves with its array."""

    def __init__(self):
        self._entries: dict = {}        # id -> (weakref, codes, words)
        # reentrant: a collection inside a locked step may run _drop
        self._lock = threading.RLock()

    def get(self, values):
        with self._lock:
            hit = self._entries.get(id(values))
        if hit is not None and hit[0]() is values:
            return hit[1], hit[2]
        return None

    def put(self, values, codes, words) -> None:
        key = id(values)
        ref = weakref.ref(values, lambda r: self._drop(key, r))
        with self._lock:
            self._entries[key] = (ref, codes, words)
            while len(self._entries) > _RECENT_MAX:
                self._entries.pop(next(iter(self._entries)))

    def _drop(self, key, ref) -> None:
        with self._lock:
            if key in self._entries and self._entries[key][0] is ref:
                del self._entries[key]


_recent = _Recent()


def _check_words(uniq) -> list:
    for v in uniq:
        if not isinstance(v, str):
            raise NotImplementedError(
                f"the key cell {v!r} is not a string; the torch port keys "
                "host columns of strings and None only")
    return sorted(uniq)


def codes(values) -> tuple[np.ndarray, list]:
    """``(codes, words)`` of one object array: ``words`` its distinct
    non-null cells in sorted order, ``codes`` each cell's int32 index in
    them (``NULL_CODE`` for ``None``). Raises ``NotImplementedError`` for
    a cell that is neither a string nor ``None`` (an array cell, say)."""
    known = _recent.get(values)
    if known is not None:
        return known
    try:
        index = dict.fromkeys(values)
    except TypeError:
        raise NotImplementedError(
            "a key column of array cells is not in the torch port's "
            "subset") from None
    index.pop(None, None)
    words = _check_words(index)
    index = {w: i for i, w in enumerate(words)}
    index[None] = NULL_CODE
    out = np.fromiter(map(index.__getitem__, values), np.int32,
                      count=len(values))
    _recent.put(values, out, words)
    return out, words


def shared_codes(*arrays) -> tuple[list, list]:
    """The codes of each object array in one dictionary of all their
    distinct strings: each array's own codes, remapped."""
    each = [codes(a) for a in arrays]
    if len(each) == 1:                  # one array: its own dictionary
        return [each[0][0]], each[0][1]
    words = sorted(set().union(*(w for _, w in each)))
    at = {w: i for i, w in enumerate(words)}
    out = []
    for c, w in each:
        remap = np.asarray([at[x] for x in w] + [NULL_CODE], np.int32)
        out.append(remap[c])            # NULL_CODE picks the last entry
    return out, words


def device_codes(columns, device) -> tuple[list, list]:
    """``(codes, words)``: the int32 code tensors on ``device`` of each
    object array in ``columns``, all from one shared dictionary."""
    host, words = shared_codes(*columns)
    return [torch.as_tensor(c, device=device) for c in host], words


def decode(codes_, words: list) -> np.ndarray:
    """The object array of strings (``None`` for ``NULL_CODE``) that
    ``codes_`` (a tensor or an int array) stand for."""
    if isinstance(codes_, torch.Tensor):
        codes_ = codes_.cpu().numpy()
    lut = np.empty(len(words) + 1, dtype=object)
    lut[:len(words)] = words
    return lut[np.asarray(codes_, np.int64)]    # NULL_CODE picks lut[-1]
