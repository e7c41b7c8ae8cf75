"""Estimator / Transformer / Model bases: the MLlib ``ml`` pipeline
contracts that ``VectorAssembler`` and ``LinearRegression`` implement."""

from __future__ import annotations


class Transformer:
    """Frame -> Frame."""

    def transform(self, frame):  # pragma: no cover - abstract
        raise NotImplementedError


class Estimator:
    """Frame -> Model."""

    def fit(self, frame):  # pragma: no cover - abstract
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer."""
