"""``org.apache.spark.ml.linalg.Vectors`` and ``Matrices``: host-side
helpers for single-point inference."""

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


class Matrices:
    """``org.apache.spark.ml.linalg.Matrices`` (dense only: the engine's
    matrices are dense arrays)."""

    @staticmethod
    def dense(num_rows: int, num_cols: int, values) -> np.ndarray:
        arr = np.asarray(values, dtype=numpy_dtype(float_dtype()))
        if arr.size != num_rows * num_cols:
            raise ValueError(
                f"{arr.size} values for a {num_rows}x{num_cols} matrix")
        # Spark's Matrices.dense is column-major
        return arr.reshape(num_cols, num_rows).T
