"""``org.apache.spark.ml.linalg.Vectors``: host-side helpers for
single-point inference."""

from __future__ import annotations

import numpy as np

from ..config import float_dtype, numpy_dtype


class Vectors:
    @staticmethod
    def dense(*values) -> np.ndarray:
        if len(values) == 1 and isinstance(values[0],
                                           (list, tuple, np.ndarray)):
            values = values[0]
        return np.asarray(values, dtype=numpy_dtype(float_dtype()))
