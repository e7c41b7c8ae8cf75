"""``VectorAssembler``: numeric columns -> one dense vector column."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import float_dtype
from .base import Transformer, persistable


@persistable
class VectorAssembler(Transformer):
    _persist_attrs = ("input_cols", "output_col")

    def __init__(self, input_cols: Optional[Sequence[str]] = None,
                 output_col: str = "features"):
        self.input_cols = list(input_cols) if input_cols else []
        self.output_col = output_col

    def set_input_cols(self, cols: Sequence[str]) -> "VectorAssembler":
        self.input_cols = list(cols)
        return self

    setInputCols = set_input_cols

    def set_output_col(self, name: str) -> "VectorAssembler":
        self.output_col = name
        return self

    setOutputCol = set_output_col

    def transform(self, frame):
        if not self.input_cols:
            raise ValueError("VectorAssembler: input_cols not set")
        parts = []
        for name in self.input_cols:
            arr = frame._column_values(name).to(float_dtype())
            parts.append(arr[:, None] if arr.ndim == 1 else arr)
        return frame.with_column(self.output_col, torch.cat(parts, dim=1))
