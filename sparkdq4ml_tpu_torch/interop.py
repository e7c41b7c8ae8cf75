"""Carrying state between the JAX package and the port, through numpy: the
same seeded data feeds both, and a model fitted in one predicts in the
other."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from .frame.frame import Frame
from .models.regression import LinearRegressionModel


def frame_from_numpy(columns: Mapping[str, np.ndarray], mask=None,
                     device=None) -> Frame:
    """A frame of numpy columns (and an optional boolean mask) on
    ``device``, by default the active session's."""
    return Frame({k: np.asarray(v) for k, v in columns.items()},
                 mask=None if mask is None else np.asarray(mask, bool),
                 device=device)


def linear_model_from_numpy(coefficients, intercept: float,
                            params: Optional[dict] = None
                            ) -> LinearRegressionModel:
    """A ``LinearRegressionModel`` from host coefficients, such as
    ``np.asarray`` of a JAX model's. ``params`` uses the estimator's
    snake_case names (``reg_param``, ``features_col``, ...)."""
    return LinearRegressionModel(np.asarray(coefficients),
                                 float(intercept), params)
