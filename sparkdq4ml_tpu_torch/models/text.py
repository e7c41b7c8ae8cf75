"""The two helpers of ``sparkdq4ml_tpu/models/text.py`` that the pattern
miners and Word2Vec take (the rest of the text module is not ported):
``_obj_array`` (a ragged object column, ``ops/cells.py:list_column``) and
``_token_col``."""

from __future__ import annotations

import numpy as np

from ..ops.cells import list_column as _obj_array  # noqa: F401


def _token_col(frame, name):
    """The host object column ``name`` of token lists; raises for any
    other column."""
    col = frame._column_values(name)
    if not (isinstance(col, np.ndarray) and col.dtype == object):
        raise ValueError(f"column {name!r} must be a string/token column")
    return col
