"""The helpers of ``sparkdq4ml_tpu/models/text.py`` that the pattern
miners, Word2Vec and FeatureHasher take (the rest of the text module is
not ported): ``_obj_array`` (a ragged object column,
``ops/cells.py:list_column``), ``_token_col`` and ``_stable_hash``."""

from __future__ import annotations

import hashlib

import numpy as np

from ..ops.cells import list_column as _obj_array  # noqa: F401


def _token_col(frame, name):
    """The host object column ``name`` of token lists; raises for any
    other column."""
    col = frame._column_values(name)
    if not (isinstance(col, np.ndarray) and col.dtype == object):
        raise ValueError(f"column {name!r} must be a string/token column")
    return col


def _stable_hash(token: str, mod: int) -> int:
    """A process-stable bucket of ``token`` in ``[0, mod)``: the first 8
    bytes of its md5, little-endian (the JAX package's hash)."""
    return int.from_bytes(hashlib.md5(token.encode()).digest()[:8],
                          "little") % mod
