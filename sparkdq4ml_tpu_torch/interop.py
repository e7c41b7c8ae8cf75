"""Carrying state between the JAX package and the port through numpy: the
same seeded data feeds both, and a model fitted in one predicts in the
other. Saved stages need nothing here: both packages write one on-disk
format, so ``models.load_stage`` (or ``PipelineModel.load``,
``LinearRegressionModel.load``) reads a directory the JAX package saved."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from .frame.frame import Frame
from .models.regression import LinearRegressionModel
from .models.tuning import CrossValidatorModel


def frame_from_numpy(columns: Mapping[str, np.ndarray], mask=None,
                     device=None) -> Frame:
    """A frame of numpy columns (and an optional boolean mask) on
    ``device``, by default the active session's."""
    return Frame({k: np.asarray(v) for k, v in columns.items()},
                 mask=None if mask is None else np.asarray(mask, bool),
                 device=device)


WORDS = ("amber", "Beta", "cobalt", "delta", "ember", "fir", "", "b_a",
         "b%a", "éclair")


def string_columns(n: int, seed: int = 0, null_share: float = 0.1) -> dict:
    """A seeded table with string and array columns, as numpy arrays that
    both packages' frames take: ``name`` (object strings from ``WORDS``,
    about ``null_share`` of them None), ``tags`` (object array cells:
    lists of 0 to 3 words, some None), ``k`` (int32 in [0, 5)) and ``v``
    (float64, some NaN)."""
    rng = np.random.default_rng(seed)
    name = np.asarray(rng.choice(np.asarray(WORDS, dtype=object), n),
                      dtype=object)
    name[rng.random(n) < null_share] = None
    tags = np.empty(n, dtype=object)
    for i in range(n):
        tags[i] = (None if rng.random() < null_share else
                   [str(w) for w in rng.choice(WORDS,
                                               int(rng.integers(0, 4)))])
    v = rng.normal(10.0, 5.0, n)
    v[rng.random(n) < null_share] = np.nan
    return {"name": name, "tags": tags,
            "k": rng.integers(0, 5, n).astype(np.int32), "v": v}


def linear_model_from_numpy(coefficients, intercept: float,
                            params: Optional[dict] = None,
                            scale: float = 1.0) -> LinearRegressionModel:
    """A ``LinearRegressionModel`` from host coefficients, such as
    ``np.asarray`` of a JAX model's. ``params`` uses the estimator's
    snake_case names (``reg_param``, ``features_col``, ...); ``scale`` is a
    Huber model's fitted sigma."""
    return LinearRegressionModel(np.asarray(coefficients),
                                 float(intercept), params, scale=scale)


def cv_model_from_numpy(best_model, avg_metrics, best_index: int
                        ) -> CrossValidatorModel:
    """A ``CrossValidatorModel`` from a best model (a port model) and the
    reference's ``avg_metrics``/``best_index`` as numpy."""
    return CrossValidatorModel(best_model, np.asarray(avg_metrics, np.float64),
                               int(best_index))
