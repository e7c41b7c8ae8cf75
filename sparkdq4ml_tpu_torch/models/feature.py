"""The feature layer of the port (port of
``sparkdq4ml_tpu/models/feature.py``, single device).

``VectorAssembler`` packs numeric columns into one ``(n, d)`` vector
column; the other stages are MLlib's ``spark.ml.feature`` transformers and
estimators. MLlib's conventions hold: StandardScaler takes the *sample*
(n−1) std, defaults to ``with_mean=False, with_std=True`` and maps a
zero-variance feature to 0; MinMaxScaler maps a constant feature to
``(min+max)/2``.

Every statistic a fit learns is a pass over the frame's valid rows on the
frame's device, and every float sum of it adds in a fixed order, so a
fitted model is bit-identical from run to run on the card: per-column sums
through the dense segment sum's whole form (``stat._col_sums``), per-class
sums through ``ops/segments.py:_seg_sum``, the covariance through the
masked Gramian (``stat._moment_stats``). Counts are integer segment sums.
Order statistics (medians, quantiles, modes, category sets) come from
device sorts; for the quantiles of ``np.quantile``'s linear method the host
computes numpy's virtual indices and interpolation on the few order
statistics it reads (``_order_quantiles``), so the splits and centers
equal numpy's. Transforms are device tensor ops.

Host steps, as in the JAX package: the order of a StringIndexer's distinct
labels by (count, label) and the mapping of a string column's distinct
words to label indices (the words are host strings; every row goes
through the device codes); FeatureHasher's hash of each distinct string;
scipy's tail probabilities of the selectors. String columns are the
port's host object columns, encoded once into dictionary codes
(``ops/strings.py``).
"""

from __future__ import annotations

import functools
from itertools import combinations_with_replacement
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import float_dtype, int_dtype, numpy_dtype
from ..ops import strings
from ..ops.cells import is_host_column
from ..ops.segments import _seg_sum
from .base import Estimator, Model, Transformer, feature_matrix, persistable
from .stat import _col_sums, _count_and_sums
from .stat import _extremes as _masked_min_max
from .stat import _host, _moment_stats, _weighted_col_sums


def _squeezed(frame, name: str):
    """``(X, squeeze)``: a column as (n, d) in the policy's float dtype, and
    whether it was one feature (1-D)."""
    X = frame._column_values(name).to(float_dtype())
    return (X[:, None], True) if X.ndim == 1 else (X, False)


def _dev(values, like: torch.Tensor) -> torch.Tensor:
    """Host numbers as a tensor of ``like``'s dtype on its device."""
    return torch.as_tensor(np.asarray(values), device=like.device).to(
        like.dtype)


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

    def get_input_cols(self):
        return list(self.input_cols)

    getInputCols = get_input_cols

    def get_output_col(self):
        return self.output_col

    getOutputCol = get_output_col

    def transform(self, frame):
        if not self.input_cols:
            raise ValueError("VectorAssembler: input_cols not set")
        parts = []
        for name in self.input_cols:
            arr = frame._column_values(name).to(float_dtype())
            parts.append(arr[:, None] if arr.ndim == 1 else arr)
        return frame.with_column(self.output_col, torch.cat(parts, dim=1))


@persistable
class VectorSizeHint(Transformer):
    """MLlib ``VectorSizeHint``: declare (and check) the size of a vector
    column. Vector columns are dense (n, d) tensors, so the size is
    checked once: ``error`` raises on a mismatch, ``skip`` masks every row
    of a mismatching column, ``optimistic`` passes through."""

    _persist_attrs = ("input_col", "size", "handle_invalid")

    def __init__(self, input_col: str = None, size: int = None,
                 handle_invalid: str = "error"):
        if handle_invalid not in ("error", "skip", "optimistic"):
            raise ValueError(
                f"handle_invalid must be error/skip/optimistic, "
                f"got {handle_invalid!r}")
        self.input_col = input_col
        self.size = None if size is None else int(size)
        self.handle_invalid = handle_invalid

    def set_input_col(self, v):
        self.input_col = v
        return self

    setInputCol = set_input_col

    def set_size(self, v):
        self.size = int(v)
        return self

    setSize = set_size

    def set_handle_invalid(self, v):
        if v not in ("error", "skip", "optimistic"):
            raise ValueError(
                f"handle_invalid must be error/skip/optimistic, got {v!r}")
        self.handle_invalid = v
        return self

    setHandleInvalid = set_handle_invalid

    def transform(self, frame):
        if self.input_col is None or self.size is None:
            raise ValueError("VectorSizeHint: input_col and size must be set")
        if self.size < 1:
            raise ValueError(f"VectorSizeHint: invalid size {self.size}")
        arr = frame._column_values(self.input_col)
        width = 1 if arr.ndim == 1 else arr.shape[1]
        if width != self.size:
            if self.handle_invalid == "error":
                raise ValueError(
                    f"VectorSizeHint: column {self.input_col!r} has size "
                    f"{width}, expected {self.size}")
            if self.handle_invalid == "skip":
                return frame.filter(torch.zeros(
                    (frame.num_slots,), dtype=torch.bool,
                    device=frame.device))
        return frame


# ---------------------------------------------------------------------------
# Labels of a column: the distinct cells of a string (host) or numeric
# column, formatted as the JAX package's ``str(v)`` of each cell
# ---------------------------------------------------------------------------

def _cell_codes(frame, col: str):
    """``(codes, words)``: every row's code on the frame's device (int64,
    -1 for a null cell) and the distinct cells' labels, ``str(v)`` of each
    as the JAX package formats a cell (a numeric column's values as Python
    numbers). Several codes may carry one label (each NaN of a float
    column, say)."""
    values = frame._column_values(col)
    if is_host_column(values):
        try:
            host_codes, words = strings.codes(values)
        except NotImplementedError:      # cells other than strings
            cells = [None if v is None else str(v) for v in values]
            host_codes, words = strings.codes(np.asarray(cells, object))
        return (torch.as_tensor(host_codes, device=frame.device).to(
            torch.int64), list(words))
    uniq, inv = torch.unique(values, return_inverse=True)
    return inv.to(torch.int64), [str(v) for v in uniq.tolist()]


def _label_counts(frame, col: str):
    """``{label: count}`` over the valid non-null rows: one integer
    segment sum over the codes, the labels merged on the host."""
    codes, words = _cell_codes(frame, col)
    keep = frame.mask & (codes >= 0)
    counts = _seg_sum(keep.to(torch.int64), torch.where(keep, codes, 0),
                      max(len(words), 1))
    out: dict = {}
    for word, c in zip(words, counts.tolist()):
        if c:
            out[word] = out.get(word, 0) + c
    return out


def _label_index(frame, col: str, index: dict, missing: int):
    """Each row's index in ``index`` (label -> position) on the frame's
    device, ``missing`` for a null cell or a label not in it: the words
    are looked up once on the host, the rows through their codes."""
    codes, words = _cell_codes(frame, col)
    lut = torch.as_tensor([index.get(w, missing) for w in words] + [missing],
                          dtype=torch.int64, device=frame.device)
    return lut[torch.where(codes >= 0, codes, len(words))]


@persistable
class StringIndexer(Estimator):
    """MLlib ``StringIndexer``: map string categories to double indices,
    most frequent first (``frequencyDesc``; ties alphabetical, as Spark).
    ``handle_invalid``: ``"error"`` (default) | ``"keep"`` (unseen →
    numLabels) | ``"skip"`` (unseen rows masked on transform).

    The counts are one integer segment sum over the column's dictionary
    codes on the frame's device; ordering the distinct labels by
    (−count, label) is a host step, as in the JAX package."""

    _persist_attrs = ("input_col", "output_col", "handle_invalid")

    def __init__(self, input_col: str = None, output_col: str = None,
                 handle_invalid: str = "error"):
        self.input_col = input_col
        self.output_col = output_col
        if handle_invalid not in ("error", "keep", "skip"):
            raise ValueError(f"handle_invalid={handle_invalid!r}")
        self.handle_invalid = handle_invalid

    def set_input_col(self, v):
        self.input_col = v
        return self

    setInputCol = set_input_col

    def set_output_col(self, v):
        self.output_col = v
        return self

    setOutputCol = set_output_col

    def set_handle_invalid(self, v):
        self.handle_invalid = v
        return self

    setHandleInvalid = set_handle_invalid

    def fit(self, frame) -> "StringIndexerModel":
        counts = _label_counts(frame, self.input_col)
        labels = sorted(counts, key=lambda k: (-counts[k], k))
        return StringIndexerModel(labels, self.input_col, self.output_col,
                                  self.handle_invalid)


@persistable
class StringIndexerModel(Model):
    _persist_attrs = ("labels", "input_col", "output_col", "handle_invalid")

    def __init__(self, labels, input_col, output_col, handle_invalid="error"):
        self.labels = list(labels)
        self.input_col = input_col
        self.output_col = output_col
        self.handle_invalid = handle_invalid
        self._index = {l: i for i, l in enumerate(self.labels)}

    def _post_load(self):
        self.labels = list(self.labels)
        self._index = {l: i for i, l in enumerate(self.labels)}

    labelsArray = property(lambda self: [list(self.labels)])

    def transform(self, frame):
        n_labels = len(self.labels)
        idx = _label_index(frame, self.input_col, self._index, n_labels)
        invalid = idx == n_labels
        if self.handle_invalid == "error" and bool(
                (invalid & frame.mask).any()):
            col = frame._column_values(self.input_col)
            cells = (col if is_host_column(col)
                     else np.asarray(col.tolist(), object))
            rows = np.flatnonzero(_host(invalid & frame.mask))
            bad = sorted({str(cells[i]) for i in rows})
            raise ValueError(f"StringIndexer: unseen labels {bad}; set "
                             f"handle_invalid='keep' or 'skip'")
        out = frame.with_column(self.output_col, idx.to(float_dtype()))
        if self.handle_invalid == "skip":
            out = out.filter(~invalid)
        return out


@persistable
class IndexToString(Transformer):
    """Inverse of StringIndexer: indices → label strings (a host column;
    an index outside the labels gives None)."""

    _persist_attrs = ("input_col", "output_col", "labels")

    def __init__(self, input_col: str = None, output_col: str = None,
                 labels=None):
        self.input_col = input_col
        self.output_col = output_col
        self.labels = list(labels) if labels is not None else None

    def transform(self, frame):
        idx = frame._column_values(self.input_col)
        k = len(self.labels)
        pos = idx.to(torch.float64).trunc()
        pos = torch.where((pos >= 0) & (pos < k), pos, float(k))
        lut = np.empty(k + 1, dtype=object)
        lut[:k] = self.labels
        return frame.with_column(self.output_col,
                                 lut[_host(pos.to(torch.int64))])


@persistable
class OneHotEncoder(Estimator):
    """MLlib ``OneHotEncoder``: index column → one-hot vector column.
    ``drop_last=True`` (Spark's default) omits the last category. The
    sizes are the valid rows' largest index + 1, read once for all
    columns; the encoding is a comparison against an iota."""

    _persist_attrs = ("input_col", "output_col", "drop_last",
                      "input_cols", "output_cols")
    input_cols = None
    output_cols = None

    def __init__(self, input_col: str = None, output_col: str = None,
                 drop_last: bool = True, input_cols=None, output_cols=None):
        if input_col is not None and input_cols is not None:
            raise ValueError("set input_col OR input_cols, not both")
        self.input_col = input_col
        self.output_col = output_col
        self.input_cols = list(input_cols) if input_cols is not None else None
        self.output_cols = (list(output_cols) if output_cols is not None
                            else None)
        self.drop_last = drop_last

    def set_drop_last(self, v: bool):
        self.drop_last = v
        return self

    setDropLast = set_drop_last

    def _col_pairs(self):
        """[(in, out)] across the single- and plural-column forms."""
        if self.input_cols is not None:
            if not self.input_cols:
                raise ValueError("input_cols must not be empty")
            outs = self.output_cols
            if outs is None or len(outs) != len(self.input_cols):
                raise ValueError("output_cols must match input_cols")
            return list(zip(self.input_cols, outs))
        if self.input_col is None:
            raise ValueError("OneHotEncoder needs input_col or input_cols")
        return [(self.input_col, self.output_col)]

    def fit(self, frame) -> "OneHotEncoderModel":
        w = frame.mask
        maxes = torch.stack([
            torch.where(w, frame._column_values(cin).to(float_dtype()),
                        -1.0).max()
            for cin, _ in self._col_pairs()])
        sizes = (_host(maxes).astype(np.int64) + 1).tolist()
        if self.input_cols is not None:
            return OneHotEncoderModel(sizes[0], None, None, self.drop_last,
                                      category_sizes=sizes,
                                      input_cols=self.input_cols,
                                      output_cols=self.output_cols)
        return OneHotEncoderModel(sizes[0], self.input_col, self.output_col,
                                  self.drop_last)


OneHotEncoderEstimator = OneHotEncoder


@persistable
class OneHotEncoderModel(Model):
    _persist_attrs = ("category_size", "input_col", "output_col",
                      "drop_last", "category_sizes", "input_cols",
                      "output_cols")
    category_sizes = None
    input_cols = None
    output_cols = None

    def __init__(self, category_size, input_col, output_col, drop_last=True,
                 category_sizes=None, input_cols=None, output_cols=None):
        self.category_size = int(category_size)
        self.input_col = input_col
        self.output_col = output_col
        self.drop_last = drop_last
        self.category_sizes = (list(map(int, category_sizes))
                               if category_sizes is not None else None)
        self.input_cols = list(input_cols) if input_cols is not None else None
        self.output_cols = (list(output_cols) if output_cols is not None
                            else None)
        self._check_plural_invariant()

    def _check_plural_invariant(self):
        if self.input_cols is not None:
            if (self.output_cols is None or self.category_sizes is None
                    or len(self.output_cols) != len(self.input_cols)
                    or len(self.category_sizes) != len(self.input_cols)):
                raise ValueError(
                    "input_cols / output_cols / category_sizes lengths "
                    "must match")

    def _post_load(self):
        self._check_plural_invariant()

    @property
    def categorySizes(self):
        if self.category_sizes is not None:
            return list(self.category_sizes)
        return [self.category_size]

    def _triples(self):
        if self.input_cols is not None:
            return list(zip(self.input_cols, self.output_cols,
                            self.category_sizes))
        return [(self.input_col, self.output_col, self.category_size)]

    def transform(self, frame):
        out = frame
        for cin, cout, size in self._triples():
            # indices from the ORIGINAL frame (an earlier output may share
            # a later input's name)
            idx = frame._column_values(cin).to(int_dtype())
            width = size - (1 if self.drop_last else 0)
            eye = torch.arange(width, dtype=int_dtype(), device=idx.device)
            out = out.with_column(
                cout, (idx[:, None] == eye[None, :]).to(float_dtype()))
        return out


@persistable
class Bucketizer(Transformer):
    """MLlib ``Bucketizer``: continuous column → bucket index by split
    points (``splits`` of length b+1, increasing; ±inf for open ends).
    Values outside the splits, and NaN, raise unless ``handle_invalid`` is
    ``'keep'`` (→ index b) or ``'skip'`` (→ masked)."""

    _persist_attrs = ("splits", "input_col", "output_col", "handle_invalid")

    def __init__(self, splits=None, input_col: str = None,
                 output_col: str = None, handle_invalid: str = "error"):
        self.splits = list(splits) if splits is not None else None
        self.input_col = input_col
        self.output_col = output_col
        self.handle_invalid = handle_invalid

    def set_splits(self, v):
        self.splits = list(v)
        return self

    setSplits = set_splits

    def transform(self, frame):
        s = np.asarray(self.splits, numpy_dtype(float_dtype()))
        if s.ndim != 1 or len(s) < 3 or not np.all(np.diff(s) > 0):
            raise ValueError("splits must be >=3 strictly increasing values")
        x = frame._column_values(self.input_col).to(float_dtype())
        st = torch.as_tensor(s, device=x.device)
        # right-closed last bucket (Spark): x == splits[-1] is in it; NaN
        # counts no split below it, as the JAX package's searchsorted
        pos = torch.searchsorted(st, x, right=True)
        nan = torch.isnan(x)
        pos = torch.where(nan, 0, pos)
        idx = torch.clamp(pos - 1, 0, len(s) - 2).to(float_dtype())
        invalid = (x < st[0]) | (x > st[-1]) | nan
        if self.handle_invalid == "error":
            if bool((invalid & frame.mask).any()):
                raise ValueError("Bucketizer: values outside splits; set "
                                 "handle_invalid='keep' or 'skip'")
        elif self.handle_invalid == "keep":
            idx = torch.where(invalid, float(len(s) - 1), idx)
        out = frame.with_column(self.output_col, idx)
        if self.handle_invalid == "skip":
            out = out.filter(~invalid)
        return out


# ---------------------------------------------------------------------------
# Order statistics, as numpy computes them
# ---------------------------------------------------------------------------

def _np_lerp(a, b, t):
    """numpy's ``_lerp``, the linear interpolation of ``np.quantile``
    (with its ``t >= 0.5`` branch), on host arrays."""
    diff_b_a = np.subtract(b, a)
    out = np.asanyarray(np.add(a, diff_b_a * t))
    np.subtract(b, diff_b_a * (1 - t), out=out, where=t >= 0.5,
                casting="unsafe", dtype=out.dtype)
    return out[()] if out.ndim == 0 else out


def _order_quantiles(svals: torch.Tensor, counts, q):
    """``np.quantile(x_j, q)`` (linear method) of each column j of the
    sorted values ``svals`` (m, d), whose first ``counts[j]`` entries of
    column j are its values (≥ 1 of them). ``q`` is what numpy takes as
    its quantiles (a float array, or a 0-d array of the data's dtype).
    numpy's virtual indices, gammas and interpolation run on the host in
    numpy's dtypes; the order statistics they name are read from the
    device in one gather: the result equals numpy's bit for bit."""
    prev_all, next_all, gammas = [], [], []
    for n in counts:
        virtual = np.asanyarray((n - 1) * q)
        prev = np.asanyarray(np.floor(virtual))
        nxt = np.asanyarray(prev + 1)
        above = virtual >= n - 1
        if above.any():
            prev[above] = -1
            nxt[above] = -1
        below = virtual < 0
        if below.any():
            prev[below] = 0
            nxt[below] = 0
        prev, nxt = prev.astype(np.intp), nxt.astype(np.intp)
        gammas.append(np.asanyarray(virtual - prev, dtype=virtual.dtype))
        prev_all.append(np.where(prev < 0, prev + n, prev))
        next_all.append(np.where(nxt < 0, nxt + n, nxt))
    d = len(counts)
    rows = np.stack([np.ravel(p) for p in prev_all]
                    + [np.ravel(x) for x in next_all])          # (2d, k)
    cols = np.repeat(np.concatenate([np.arange(d)] * 2)[:, None],
                     rows.shape[1], axis=1)
    picked = _host(svals[torch.as_tensor(rows, device=svals.device),
                         torch.as_tensor(cols, device=svals.device)])
    out = []
    for j in range(d):
        shape = np.shape(gammas[j])
        a = picked[j].reshape(shape)
        b = picked[d + j].reshape(shape)
        if shape == ():
            a, b = a[()], b[()]
        out.append(_np_lerp(a, b, gammas[j]))
    return out


def _sorted_valid(X: torch.Tensor, keep: torch.Tensor):
    """``(svals, counts)``: each column of ``X``'s kept rows sorted, NaN
    last, and its count of non-NaN values (host ints)."""
    Xv = X[keep]
    svals = torch.sort(Xv, dim=0).values
    counts = (~torch.isnan(Xv)).sum(0) if Xv.is_floating_point() else \
        torch.full((X.shape[1],), Xv.shape[0], device=X.device)
    return svals, [int(c) for c in counts.tolist()]


def _np_median(svals: torch.Tensor, counts, dtype):
    """``np.median`` of each column's first ``counts[j]`` sorted values
    (NaN for none), from the one or two middle values read in one gather
    and averaged by numpy in ``dtype``."""
    d = len(counts)
    lo = [max((n - 1) // 2, 0) for n in counts]
    hi = [max(n // 2, 0) for n in counts]
    cols = torch.arange(d, device=svals.device)
    picked = _host(svals[torch.as_tensor(lo + hi, device=svals.device),
                         torch.cat([cols, cols])]).astype(dtype)
    out = []
    for j, n in enumerate(counts):
        if n == 0:
            out.append(dtype.type(np.nan))
        elif n % 2:
            out.append(np.mean(picked[j:j + 1]))
        else:
            out.append(np.mean(np.asarray([picked[j], picked[d + j]])))
    return np.asarray(out, dtype)


# ---------------------------------------------------------------------------
# Scalers
# ---------------------------------------------------------------------------

class _ScalerBase(Estimator):
    """The input/output-column setters shared by the scalers."""

    def __init__(self, input_col: str = "features",
                 output_col: str = "scaled_features"):
        self.input_col = input_col
        self.output_col = output_col

    def set_input_col(self, name: str):
        self.input_col = name
        return self

    setInputCol = set_input_col

    def set_output_col(self, name: str):
        self.output_col = name
        return self

    setOutputCol = set_output_col

    def _masked_feature_matrix(self, frame):
        """(n, d) feature matrix and (n,) mask weights on the device."""
        X = feature_matrix(frame, self.input_col)
        return X, frame.mask.to(X.dtype)


def _masked_moments(X, w):
    """Mask-weighted count, mean and sample variance, every sum in a
    fixed order (``stat._col_sums``)."""
    n, s1 = _count_and_sums(X, w)
    mean = s1 / n
    centered = X - mean
    var = _weighted_col_sums(lambda M: M * M, centered, w * w) / \
        torch.clamp(n - 1.0, min=1.0)
    return n, mean, var


@persistable
class StandardScaler(_ScalerBase):
    """MLlib ``StandardScaler``: defaults ``with_mean=False,
    with_std=True``; sample (n−1) std; zero-variance features scale to
    0.0."""

    _persist_attrs = ("input_col", "output_col", "with_mean", "with_std")

    def __init__(self, input_col: str = "features",
                 output_col: str = "scaled_features",
                 with_mean: bool = False, with_std: bool = True):
        super().__init__(input_col, output_col)
        self.with_mean = with_mean
        self.with_std = with_std

    def set_with_mean(self, v: bool):
        self.with_mean = v
        return self

    setWithMean = set_with_mean

    def set_with_std(self, v: bool):
        self.with_std = v
        return self

    setWithStd = set_with_std

    def fit(self, frame) -> "StandardScalerModel":
        X, w = self._masked_feature_matrix(frame)
        _, mean, var = _masked_moments(X, w)
        both = _host(torch.stack([mean, torch.sqrt(var)]))
        return StandardScalerModel(both[0], both[1], self.with_mean,
                                   self.with_std, self.input_col,
                                   self.output_col)


@persistable
class StandardScalerModel(Model):
    _persist_attrs = ("mean", "std", "with_mean", "with_std", "input_col",
                      "output_col")

    def __init__(self, mean, std, with_mean, with_std, input_col, output_col):
        self.mean = np.asarray(mean)
        self.std = np.asarray(std)
        self.with_mean = with_mean
        self.with_std = with_std
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, frame):
        X, squeeze = _squeezed(frame, self.input_col)
        if self.with_mean:
            X = X - _dev(self.mean, X)
        if self.with_std:
            # MLlib: features with std == 0 map to 0.0 (scale factor 0)
            inv = np.where(self.std > 0, 1.0 / np.where(self.std > 0,
                                                        self.std, 1.0), 0.0)
            X = X * _dev(inv, X)
        return frame.with_column(self.output_col,
                                 X[:, 0] if squeeze else X)


@persistable
class MinMaxScaler(_ScalerBase):
    """MLlib ``MinMaxScaler``: rescale to [min, max] per feature; constant
    features map to ``(min+max)/2``."""

    _persist_attrs = ("input_col", "output_col", "min", "max")

    def __init__(self, input_col: str = "features",
                 output_col: str = "scaled_features",
                 min: float = 0.0, max: float = 1.0):
        super().__init__(input_col, output_col)
        self.min = float(min)
        self.max = float(max)

    def set_min(self, v: float):
        self.min = float(v)
        return self

    setMin = set_min

    def set_max(self, v: float):
        self.max = float(v)
        return self

    setMax = set_max

    def fit(self, frame) -> "MinMaxScalerModel":
        X, w = self._masked_feature_matrix(frame)
        both = _host(torch.stack(_masked_min_max(X, w)))
        return MinMaxScalerModel(both[0], both[1], self.min, self.max,
                                 self.input_col, self.output_col)


@persistable
class MinMaxScalerModel(Model):
    _persist_attrs = ("original_min", "original_max", "min", "max",
                      "input_col", "output_col")

    def __init__(self, original_min, original_max, min, max,
                 input_col, output_col):
        self.original_min = np.asarray(original_min)
        self.original_max = np.asarray(original_max)
        self.min = min
        self.max = max
        self.input_col = input_col
        self.output_col = output_col

    originalMin = property(lambda self: self.original_min)
    originalMax = property(lambda self: self.original_max)

    def transform(self, frame):
        X, squeeze = _squeezed(frame, self.input_col)
        rng = self.original_max - self.original_min
        constant = rng == 0
        inv = np.where(constant, 0.0, 1.0 / np.where(constant, 1.0, rng))
        scaled = (X - _dev(self.original_min, X)) * _dev(inv, X) \
            * (self.max - self.min) + self.min
        half = 0.5 * (self.max + self.min)
        scaled = torch.where(torch.as_tensor(constant, device=X.device),
                             torch.as_tensor(half, dtype=X.dtype,
                                             device=X.device), scaled)
        return frame.with_column(self.output_col,
                                 scaled[:, 0] if squeeze else scaled)


@persistable
class MaxAbsScaler(_ScalerBase):
    """MLlib ``MaxAbsScaler``: divide by per-feature max |x|; all-zero
    features stay 0."""

    _persist_attrs = ("input_col", "output_col")

    def fit(self, frame) -> "MaxAbsScalerModel":
        X, w = self._masked_feature_matrix(frame)
        lo, hi = _host(torch.stack(_masked_min_max(X, w)))
        return MaxAbsScalerModel(np.maximum(np.abs(lo), np.abs(hi)),
                                 self.input_col, self.output_col)


@persistable
class MaxAbsScalerModel(Model):
    _persist_attrs = ("max_abs", "input_col", "output_col")

    def __init__(self, max_abs, input_col, output_col):
        self.max_abs = np.asarray(max_abs)
        self.input_col = input_col
        self.output_col = output_col

    maxAbs = property(lambda self: self.max_abs)

    def transform(self, frame):
        X, squeeze = _squeezed(frame, self.input_col)
        inv = np.where(self.max_abs > 0,
                       1.0 / np.where(self.max_abs > 0, self.max_abs, 1.0),
                       0.0)
        X = X * _dev(inv, X)
        return frame.with_column(self.output_col, X[:, 0] if squeeze else X)


# ---------------------------------------------------------------------------
# Imputer
# ---------------------------------------------------------------------------

@persistable
class Imputer(Estimator):
    """MLlib ``Imputer``: replace missing values (NaN, or a configured
    ``missing_value``) in numeric columns with the column's mean, median or
    mode over its valid rows, in float64.

    On the device: the mean is a fixed-order sum (``stat._col_sums``), so
    it may differ from numpy's pairwise sum in the last bits; the median
    and the mode (the smallest value of the largest count) are exact
    selections from one sort."""

    _persist_attrs = ("input_cols", "output_cols", "strategy",
                      "missing_value")

    def __init__(self, input_cols: Optional[Sequence[str]] = None,
                 output_cols: Optional[Sequence[str]] = None,
                 strategy: str = "mean", missing_value: float = float("nan")):
        self.input_cols = list(input_cols) if input_cols else []
        self.output_cols = list(output_cols) if output_cols else []
        if strategy not in ("mean", "median", "mode"):
            raise ValueError(f"strategy={strategy!r} (mean|median|mode)")
        self.strategy = strategy
        self.missing_value = float(missing_value)

    def set_input_cols(self, v):
        self.input_cols = list(v)
        return self

    setInputCols = set_input_cols

    def set_output_cols(self, v):
        self.output_cols = list(v)
        return self

    setOutputCols = set_output_cols

    def set_strategy(self, v):
        if v not in ("mean", "median", "mode"):
            raise ValueError(f"strategy={v!r}")
        self.strategy = v
        return self

    setStrategy = set_strategy

    def set_missing_value(self, v):
        self.missing_value = float(v)
        return self

    setMissingValue = set_missing_value

    def _out_cols(self):
        return self.output_cols or self.input_cols

    def _surrogate(self, vals: torch.Tensor) -> float:
        if self.strategy == "mean":
            n, s = _col_sums(torch.stack([torch.ones_like(vals), vals],
                                         dim=1)).tolist()
            return s / n
        svals = torch.sort(vals).values
        if self.strategy == "median":
            return float(_np_median(svals[:, None], [svals.shape[0]],
                                    np.dtype(np.float64))[0])
        # mode: most frequent, smallest on ties (Spark): the first
        # maximum over the sorted runs
        uniq, cnt = torch.unique_consecutive(svals, return_counts=True)
        return float(uniq[torch.argmax(cnt)])

    def fit(self, frame) -> "ImputerModel":
        if not self.input_cols:
            raise ValueError("Imputer: input_cols not set")
        if self.output_cols and len(self.output_cols) != len(self.input_cols):
            raise ValueError("output_cols length must match input_cols")
        surrogates = []
        for name in self.input_cols:
            x = frame._column_values(name).to(torch.float64)[frame.mask]
            miss = torch.isnan(x) if np.isnan(self.missing_value) \
                else (x == self.missing_value)
            vals = x[~miss & ~torch.isnan(x)]
            if vals.shape[0] == 0:
                raise ValueError(f"Imputer: column {name!r} has no valid "
                                 "values to learn a surrogate from")
            surrogates.append(self._surrogate(vals))
        model = ImputerModel(self.input_cols, self._out_cols(),
                             surrogates, self.missing_value)
        model._device = frame.device
        return model


@persistable
class ImputerModel(Model):
    _persist_attrs = ("input_cols", "output_cols", "surrogates",
                      "missing_value")

    def __init__(self, input_cols, output_cols, surrogates, missing_value):
        self.input_cols = list(input_cols)
        self.output_cols = list(output_cols)
        self.surrogates = [float(s) for s in surrogates]
        self.missing_value = float(missing_value)

    _device = None      # the fitted frame's device (not persisted)

    @property
    def surrogate_df(self):
        """The learned surrogates as a 1-row Frame (MLlib surrogateDF), on
        the device of the frame the model was fitted on, else the
        session's."""
        from ..frame.frame import Frame

        return Frame({c: [s] for c, s in zip(self.input_cols,
                                             self.surrogates)},
                     device=self._device)

    surrogateDF = surrogate_df

    def transform(self, frame):
        for name, out, s in zip(self.input_cols, self.output_cols,
                                self.surrogates):
            x = frame._column_values(name).to(float_dtype())
            # NaN (the engine's null) is always missing
            miss = torch.isnan(x)
            if not np.isnan(self.missing_value):
                miss = miss | (x == self.missing_value)
            frame = frame.with_column(out, torch.where(
                miss, torch.as_tensor(s, dtype=x.dtype, device=x.device), x))
        return frame


# ---------------------------------------------------------------------------
# Elementwise and vector stages
# ---------------------------------------------------------------------------

@persistable
class Normalizer(Transformer):
    """MLlib ``Normalizer``: scale each row of a vector column to unit
    p-norm (default p=2). Zero rows stay zero."""

    _persist_attrs = ("input_col", "output_col", "p")

    def __init__(self, input_col: str = "features",
                 output_col: str = "normalized_features", p: float = 2.0):
        self.input_col = input_col
        self.output_col = output_col
        if not p >= 1.0:
            raise ValueError("p must be >= 1")
        self.p = float(p)

    def set_input_col(self, v):
        self.input_col = v
        return self

    setInputCol = set_input_col

    def set_output_col(self, v):
        self.output_col = v
        return self

    setOutputCol = set_output_col

    def set_p(self, v):
        if not v >= 1.0:
            raise ValueError("p must be >= 1")
        self.p = float(v)
        return self

    setP = set_p

    def transform(self, frame):
        X, squeeze = _squeezed(frame, self.input_col)
        if self.p == float("inf"):
            norm = X.abs().amax(dim=1, keepdim=True)
        elif self.p == 2.0:
            norm = torch.sqrt((X * X).sum(dim=1, keepdim=True))
        elif self.p == 1.0:
            norm = X.abs().sum(dim=1, keepdim=True)
        else:
            norm = (X.abs() ** self.p).sum(dim=1, keepdim=True) \
                ** (1.0 / self.p)
        pos = norm > 0
        out = torch.where(pos, X / torch.where(pos, norm, 1.0), X)
        return frame.with_column(self.output_col,
                                 out[:, 0] if squeeze else out)


@persistable
class Binarizer(Transformer):
    """MLlib ``Binarizer``: 1.0 where x > threshold else 0.0, on a scalar
    or vector column (NaN → 0.0)."""

    _persist_attrs = ("threshold", "input_col", "output_col")

    def __init__(self, threshold: float = 0.0, input_col: str = None,
                 output_col: str = None):
        self.threshold = float(threshold)
        self.input_col = input_col
        self.output_col = output_col

    def set_threshold(self, v):
        self.threshold = float(v)
        return self

    setThreshold = set_threshold

    def set_input_col(self, v):
        self.input_col = v
        return self

    setInputCol = set_input_col

    def set_output_col(self, v):
        self.output_col = v
        return self

    setOutputCol = set_output_col

    def transform(self, frame):
        x = frame._column_values(self.input_col).to(float_dtype())
        return frame.with_column(self.output_col,
                                 (x > self.threshold).to(x.dtype))


def _monomials(d: int, degree: int) -> list:
    """The index tuples of every monomial of degree 1..``degree`` over d
    features: grouped by degree, lexicographic within one (the JAX
    package's order)."""
    return [combo for deg in range(1, degree + 1)
            for combo in combinations_with_replacement(range(d), deg)]


@persistable
class PolynomialExpansion(Transformer):
    """MLlib ``PolynomialExpansion``: every monomial of total degree
    1..``degree`` of an (n, d) vector column, in the JAX package's order
    (grouped by degree, lexicographic within one; MLlib interleaves the
    same set of monomials). Each term is a product of columns taken left
    to right, as the JAX package multiplies them."""

    _persist_attrs = ("degree", "input_col", "output_col")

    def __init__(self, degree: int = 2, input_col: str = "features",
                 output_col: str = "poly_features"):
        if degree < 1:
            raise ValueError("degree must be >= 1")
        self.degree = int(degree)
        self.input_col = input_col
        self.output_col = output_col

    def set_degree(self, v):
        if v < 1:
            raise ValueError("degree must be >= 1")
        self.degree = int(v)
        return self

    setDegree = set_degree

    def set_input_col(self, v):
        self.input_col = v
        return self

    setInputCol = set_input_col

    def set_output_col(self, v):
        self.output_col = v
        return self

    setOutputCol = set_output_col

    def transform(self, frame):
        X = feature_matrix(frame, self.input_col)
        cols = []
        for combo in _monomials(X.shape[1], self.degree):
            term = X[:, combo[0]]
            for j in combo[1:]:
                term = term * X[:, j]
            cols.append(term)
        return frame.with_column(self.output_col, torch.stack(cols, dim=1))


@persistable
class QuantileDiscretizer(Estimator):
    """MLlib ``QuantileDiscretizer``: learn ``num_buckets`` exact quantile
    split points over the valid non-NaN rows and return a
    :class:`Bucketizer` with open (±inf) outer splits; duplicate quantiles
    collapse, so the bucketizer may have fewer buckets (Spark).

    The values are sorted on the device in float64; the splits are
    ``np.quantile``'s, bit for bit (``_order_quantiles``)."""

    _persist_attrs = ("num_buckets", "input_col", "output_col",
                      "handle_invalid")

    def __init__(self, num_buckets: int = 2, input_col: str = None,
                 output_col: str = None, handle_invalid: str = "error"):
        if num_buckets < 2:
            raise ValueError("num_buckets must be >= 2")
        self.num_buckets = int(num_buckets)
        self.input_col = input_col
        self.output_col = output_col
        self.handle_invalid = handle_invalid

    def set_num_buckets(self, v):
        if v < 2:
            raise ValueError("num_buckets must be >= 2")
        self.num_buckets = int(v)
        return self

    setNumBuckets = set_num_buckets

    def set_input_col(self, v):
        self.input_col = v
        return self

    setInputCol = set_input_col

    def set_output_col(self, v):
        self.output_col = v
        return self

    setOutputCol = set_output_col

    def set_handle_invalid(self, v):
        self.handle_invalid = v
        return self

    setHandleInvalid = set_handle_invalid

    def fit(self, frame) -> "Bucketizer":
        x = frame._column_values(self.input_col).to(torch.float64)
        svals, counts = _sorted_valid(x[:, None], frame.mask)
        if counts[0] == 0:
            raise ValueError("QuantileDiscretizer: no valid rows to fit on")
        qs = _order_quantiles(svals, counts, np.linspace(
            0, 1, self.num_buckets + 1)[1:-1])[0]
        inner = np.unique(qs)  # duplicate quantiles collapse (Spark)
        splits = [-float("inf"), *inner.tolist(), float("inf")]
        return Bucketizer(splits, self.input_col, self.output_col,
                          self.handle_invalid)


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------

@persistable
class PCA(Estimator):
    """MLlib ``PCA``: the top-k principal components of a vector column.
    The fit is one masked moment pass (the centered scatter through the
    masked Gramian, ``stat._moment_stats``) and ``torch.linalg.eigh`` of
    the tiny (d, d) sample covariance; each component's largest-|·| entry
    is made positive. ``transform`` projects raw rows, without centering
    (Spark's documented behavior)."""

    _persist_attrs = ("k", "input_col", "output_col")

    def __init__(self, k: int = None, input_col: str = "features",
                 output_col: str = "pca_features"):
        self.k = k
        self.input_col = input_col
        self.output_col = output_col

    def set_k(self, v):
        self.k = int(v)
        return self

    setK = set_k

    def set_input_col(self, v):
        self.input_col = v
        return self

    setInputCol = set_input_col

    def set_output_col(self, v):
        self.output_col = v
        return self

    setOutputCol = set_output_col

    def fit(self, frame) -> "PCAModel":
        if not self.k or self.k < 1:
            raise ValueError("PCA: k must be a positive integer")
        X = feature_matrix(frame, self.input_col)
        d = X.shape[1]
        if self.k > d:
            raise ValueError(f"k={self.k} exceeds the {d} input features")
        w = frame.mask.to(X.dtype)
        n, _, C, *_ = _moment_stats(X, w, norms=False)
        if float(n) == 0:
            raise ValueError("PCA: no valid rows to fit on")
        cov = C / torch.clamp(n - 1.0, min=1.0)          # sample covariance
        vals, vecs = torch.linalg.eigh(cov)              # ascending order
        vals = vals.flip(0)[: self.k]
        vecs_np = _host(vecs.flip(1)[:, : self.k])       # (d, k) columns
        # deterministic sign: largest-|.| entry of each component positive
        signs = np.sign(vecs_np[np.argmax(np.abs(vecs_np), axis=0),
                                np.arange(self.k)])
        signs[signs == 0] = 1.0
        total = float(torch.clamp(torch.diagonal(cov), min=0.0).sum())
        ev = np.clip(_host(vals), 0.0, None)
        ratios = ev / total if total > 0 else np.zeros_like(ev)
        return PCAModel(vecs_np * signs, ratios, self.k,
                        self.input_col, self.output_col)


@persistable
class PCAModel(Model):
    _persist_attrs = ("pc", "explained_variance", "k", "input_col",
                      "output_col")

    def __init__(self, pc, explained_variance, k, input_col, output_col):
        self.pc = np.asarray(pc)                         # (d, k)
        self.explained_variance = np.asarray(explained_variance)
        self.k = int(k)
        self.input_col = input_col
        self.output_col = output_col

    explainedVariance = property(lambda self: self.explained_variance)

    def transform(self, frame):
        X = feature_matrix(frame, self.input_col)
        return frame.with_column(self.output_col, X @ _dev(self.pc, X))


@persistable
class Interaction(Transformer):
    """MLlib ``Interaction``: the per-row tensor (Kronecker) product of
    the input columns, scalars or vectors, as one vector of ∏ dᵢ
    entries."""

    _persist_attrs = ("input_cols", "output_col")

    def __init__(self, input_cols: Optional[Sequence[str]] = None,
                 output_col: str = "interacted"):
        self.input_cols = list(input_cols) if input_cols else []
        self.output_col = output_col

    def set_input_cols(self, v):
        self.input_cols = list(v)
        return self

    setInputCols = set_input_cols

    def set_output_col(self, v):
        self.output_col = v
        return self

    setOutputCol = set_output_col

    def transform(self, frame):
        if len(self.input_cols) < 2:
            raise ValueError("Interaction needs at least two input columns")
        out = None
        for name in self.input_cols:
            arr = feature_matrix(frame, name)
            out = arr if out is None else \
                (out[:, :, None] * arr[:, None, :]).reshape(out.shape[0], -1)
        return frame.with_column(self.output_col, out)


@persistable
class SQLTransformer(Transformer):
    """MLlib ``SQLTransformer``: a SQL statement over the placeholder view
    ``__THIS__``, run by the port's SQL engine (``sql/parser.py``) against
    the session catalog, so joins with registered temp views work."""

    _persist_attrs = ("statement",)

    def __init__(self, statement: Optional[str] = None):
        self.statement = statement

    def set_statement(self, v):
        self.statement = v
        return self

    setStatement = set_statement

    def get_statement(self):
        return self.statement

    getStatement = get_statement

    def transform(self, frame):
        if not self.statement:
            raise ValueError("SQLTransformer: statement not set")
        import uuid

        from ..sql.catalog import default_catalog
        from ..sql.parser import execute

        view = f"sql_transformer_{uuid.uuid4().hex[:12]}"
        cat = default_catalog()
        cat.register(view, frame)
        try:
            return execute(self.statement.replace("__THIS__", view), cat)
        finally:
            cat.drop(view)


@persistable
class VectorIndexer(Estimator):
    """MLlib ``VectorIndexer``: every feature of a vector column with at
    most ``max_categories`` distinct valid values becomes categorical and
    is re-encoded to 0..k−1 by value order; the rest pass through. The
    distinct values come from one device ``torch.unique`` a feature, in
    float64; only the small category sets are read."""

    _persist_attrs = ("input_col", "output_col", "max_categories",
                      "handle_invalid")

    def __init__(self, max_categories: int = 20,
                 input_col: str = "features",
                 output_col: str = "indexed",
                 handle_invalid: str = "error"):
        if max_categories < 2:
            raise ValueError("max_categories must be >= 2")
        if handle_invalid not in ("error", "keep"):
            raise ValueError(f"handle_invalid={handle_invalid!r}")
        self.max_categories = int(max_categories)
        self.input_col = input_col
        self.output_col = output_col
        self.handle_invalid = handle_invalid

    def set_max_categories(self, v):
        if v < 2:
            raise ValueError("max_categories must be >= 2")
        self.max_categories = int(v)
        return self

    setMaxCategories = set_max_categories

    def set_input_col(self, v):
        self.input_col = v
        return self

    setInputCol = set_input_col

    def set_output_col(self, v):
        self.output_col = v
        return self

    setOutputCol = set_output_col

    def fit(self, frame) -> "VectorIndexerModel":
        X = frame._column_values(self.input_col).to(torch.float64)
        if X.ndim == 1:
            X = X[:, None]
        Xv = X[frame.mask]
        uniqs = []
        for j in range(X.shape[1]):
            col = Xv[:, j]
            uniqs.append(torch.unique(col[~torch.isnan(col)]))
        sizes = [u.shape[0] for u in uniqs]
        # 0 observed values (all NaN or all masked): a continuous feature
        pick = [j for j, s in enumerate(sizes)
                if 0 < s <= self.max_categories]
        values = _host(torch.cat([uniqs[j] for j in pick])).tolist() \
            if pick else []
        category_maps, at = {}, 0
        for j in pick:
            category_maps[j] = values[at:at + sizes[j]]
            at += sizes[j]
        return VectorIndexerModel(X.shape[1], category_maps,
                                  self.input_col, self.output_col,
                                  self.handle_invalid)


@persistable
class VectorIndexerModel(Model):
    _persist_attrs = ("num_features", "_category_maps_json", "input_col",
                      "output_col", "handle_invalid")

    def __init__(self, num_features, category_maps, input_col="features",
                 output_col="indexed", handle_invalid="error"):
        self.num_features = int(num_features)
        self.category_maps = {int(k): list(v)
                              for k, v in category_maps.items()}
        # JSON keys are strings; persist through a string-keyed mirror
        self._category_maps_json = {str(k): list(v)
                                    for k, v in self.category_maps.items()}
        self.input_col = input_col
        self.output_col = output_col
        self.handle_invalid = handle_invalid

    def _post_load(self):
        self.category_maps = {int(k): list(v)
                              for k, v in self._category_maps_json.items()}

    @property
    def category_maps_(self):
        return dict(self.category_maps)

    categoryMaps = category_maps_

    def transform(self, frame):
        X = frame._column_values(self.input_col).to(torch.float64)
        if X.ndim == 1:
            X = X[:, None]
        out = X.clone()
        bad_cols = []
        for j, cats in self.category_maps.items():
            cats_t = torch.as_tensor(cats, dtype=torch.float64,
                                     device=X.device)
            x = X[:, j].contiguous()
            idx_c = torch.clamp(torch.searchsorted(cats_t, x), 0,
                                len(cats) - 1)
            known = cats_t[idx_c] == x
            is_nan = torch.isnan(x)
            if self.handle_invalid == "error":
                bad_cols.append(frame.mask & ~known & ~is_nan)
                # NaN stays NaN (it is not a category)
                out[:, j] = torch.where(is_nan, x, idx_c.to(torch.float64))
            else:   # keep: unseen (NaN included) gets index k
                out[:, j] = torch.where(known & ~is_nan,
                                        idx_c.to(torch.float64),
                                        float(len(cats)))
        if bad_cols:
            bad = torch.stack(bad_cols, dim=1)
            if bool(bad.any()):
                js = list(self.category_maps)
                col = int(torch.nonzero(bad.any(0))[0])
                row = int(torch.nonzero(bad[:, col])[0])
                raise ValueError(
                    f"VectorIndexer: unseen category "
                    f"{float(X[row, js[col]])!r} in feature {js[col]}")
        return frame.with_column(self.output_col, out.to(float_dtype()))


# ---------------------------------------------------------------------------
# Selectors
# ---------------------------------------------------------------------------

@persistable
class ChiSqSelector(Estimator):
    """MLlib ``ChiSqSelector``: pick features by the χ² independence test
    against a categorical label (``stat.ChiSquareTest``).
    ``selector_type``: ``numTopFeatures`` (default, smallest p-values
    first), ``percentile`` or ``fpr``."""

    _persist_attrs = ("num_top_features", "selector_type", "percentile",
                      "fpr", "features_col", "label_col", "output_col")

    def __init__(self, num_top_features: int = 50,
                 selector_type: str = "numTopFeatures",
                 percentile: float = 0.1, fpr: float = 0.05,
                 features_col: str = "features", label_col: str = "label",
                 output_col: str = "selected"):
        if selector_type not in ("numTopFeatures", "percentile", "fpr"):
            raise ValueError(f"selector_type={selector_type!r}")
        self.num_top_features = int(num_top_features)
        self.selector_type = selector_type
        self.percentile = float(percentile)
        self.fpr = float(fpr)
        self.features_col = features_col
        self.label_col = label_col
        self.output_col = output_col

    def set_num_top_features(self, v):
        self.num_top_features = int(v)
        return self

    setNumTopFeatures = set_num_top_features

    def set_selector_type(self, v):
        if v not in ("numTopFeatures", "percentile", "fpr"):
            raise ValueError(f"selector_type={v!r}")
        self.selector_type = v
        return self

    setSelectorType = set_selector_type

    def set_percentile(self, v):
        self.percentile = float(v)
        return self

    setPercentile = set_percentile

    def set_fpr(self, v):
        self.fpr = float(v)
        return self

    setFpr = set_fpr

    def set_features_col(self, v):
        self.features_col = v
        return self

    setFeaturesCol = set_features_col

    def set_label_col(self, v):
        self.label_col = v
        return self

    setLabelCol = set_label_col

    def set_output_col(self, v):
        self.output_col = v
        return self

    setOutputCol = set_output_col

    def fit(self, frame) -> "ChiSqSelectorModel":
        p_values = _chi2_p_values(frame, self.features_col, self.label_col)
        d = len(p_values)
        order = np.argsort(p_values, kind="stable")
        if self.selector_type == "numTopFeatures":
            chosen = order[: self.num_top_features]
        elif self.selector_type == "percentile":
            chosen = order[: max(1, int(d * self.percentile))]
        else:   # fpr
            chosen = np.flatnonzero(p_values < self.fpr)
        return ChiSqSelectorModel(sorted(int(i) for i in chosen),
                                  self.features_col, self.output_col)


def _chi2_p_values(frame, features_col: str, label_col: str) -> np.ndarray:
    from .stat import ChiSquareTest

    res = ChiSquareTest.test(frame, features_col, label_col).to_pydict()
    return np.asarray(res["pValues"][0], np.float64)


class _SelectorModelBase(Model):
    """Shared surface of the feature selectors: the selected indices and a
    gather (an empty selection gives an (n, 0) column, as MLlib)."""

    _persist_attrs = ("selected_features", "features_col", "output_col")

    def __init__(self, selected_features, features_col="features",
                 output_col="selected"):
        self.selected_features = [int(i) for i in selected_features]
        self.features_col = features_col
        self.output_col = output_col

    selectedFeatures = property(lambda self: list(self.selected_features))

    def transform(self, frame):
        X = feature_matrix(frame, self.features_col)
        sel = torch.as_tensor(self.selected_features, dtype=torch.int64,
                              device=X.device)
        return frame.with_column(self.output_col, X.index_select(1, sel))


@persistable
class ChiSqSelectorModel(_SelectorModelBase):
    pass


def _is_string_col(arr) -> bool:
    """A string column: the port's host object column (numpy 'U'/'S'
    arrays and lists of strings count too)."""
    if isinstance(arr, torch.Tensor):
        return False
    a = arr if isinstance(arr, np.ndarray) else np.asarray(arr)
    return a.dtype.kind in ("U", "S") or is_host_column(a)


def _parse_r_formula(formula: str):
    """``label ~ term + term - term`` → (label, include_terms,
    exclude_terms); a term is a tuple of column names (more than one for
    a ``:`` interaction). ``.`` means every other column."""
    if "~" not in formula:
        raise ValueError(f"RFormula: missing '~' in {formula!r}")
    lhs, rhs = formula.split("~", 1)
    label = lhs.strip()
    include, exclude = [], []
    sign, token = 1, ""
    tokens = []
    for ch in rhs + "+":
        if ch in "+-":
            if token.strip():
                tokens.append((sign, token.strip()))
            sign = 1 if ch == "+" else -1
            token = ""
        else:
            token += ch
    for sg, tok in tokens:
        term = tuple(t.strip() for t in tok.split(":"))
        if any(not t for t in term):
            raise ValueError(f"RFormula: empty term in {formula!r}")
        (include if sg > 0 else exclude).append(term)
    return label, include, exclude


@persistable
class RFormula(Estimator):
    """MLlib ``RFormula``: R model formulas (``label ~ col1 + col2``, ``.``
    for every other column, ``-`` to exclude, ``:`` to interact). Numeric
    terms pass through; string terms are StringIndexed (frequencyDesc) and
    dummy-coded with the last category dropped, Spark's encoding. Produces
    ``features`` and ``label`` columns."""

    _persist_attrs = ("formula", "features_col", "label_col",
                      "force_index_label")

    def __init__(self, formula: Optional[str] = None,
                 features_col: str = "features", label_col: str = "label",
                 force_index_label: bool = False):
        self.formula = formula
        self.features_col = features_col
        self.label_col = label_col
        self.force_index_label = bool(force_index_label)

    def set_formula(self, v):
        self.formula = v
        return self

    setFormula = set_formula

    def set_features_col(self, v):
        self.features_col = v
        return self

    setFeaturesCol = set_features_col

    def set_label_col(self, v):
        self.label_col = v
        return self

    setLabelCol = set_label_col

    def set_force_index_label(self, v):
        self.force_index_label = bool(v)
        return self

    setForceIndexLabel = set_force_index_label

    def _encode_col(self, frame, col):
        """One column → encoder spec: ("num", col) or ("cat", col, labels)."""
        if not _is_string_col(frame._column_values(col)):
            return ("num", col)
        model = StringIndexer(input_col=col, output_col="_idx").fit(frame)
        return ("cat", col, model.labels)

    def fit(self, frame) -> "RFormulaModel":
        if not self.formula:
            raise ValueError("RFormula: formula not set")
        label, include, exclude = _parse_r_formula(self.formula)
        excluded = {t[0] for t in exclude if len(t) == 1}
        terms = []
        for term in include:
            if term == (".",):
                for c in frame.columns:
                    if c != label and c not in excluded and \
                            (c,) not in terms:
                        terms.append((c,))
            elif term not in terms:
                terms.append(term)
        terms = [t for t in terms if t not in exclude]

        encoders = [[self._encode_col(frame, c) for c in t] for t in terms]
        label_labels = None
        if label:
            lv = frame._column_values(label)
            if _is_string_col(lv) or self.force_index_label:
                label_labels = StringIndexer(
                    input_col=label, output_col="_l").fit(frame).labels
        return RFormulaModel(encoders, label, label_labels,
                             self.features_col, self.label_col)


@persistable
class RFormulaModel(Model):
    """The resolved formula: per term, the encoder of each of its columns.
    Its design is built on the device in float64 (a string term's dummy
    columns from the column's codes) and cast to the policy's dtype."""

    _persist_attrs = ("_encoders_json", "label_source", "label_labels",
                      "features_col", "label_col")

    def __init__(self, encoders=None, label_source="", label_labels=None,
                 features_col="features", label_col="label"):
        self.encoders = encoders or []
        self._encoders_json = [[list(e) for e in term]
                               for term in self.encoders]
        self.label_source = label_source
        self.label_labels = (None if label_labels is None
                             else list(label_labels))
        self.features_col = features_col
        self.label_col = label_col

    def _post_load(self):
        self.encoders = [[tuple(e) for e in term]
                         for term in self._encoders_json]

    def _encode_one(self, frame, enc):
        """Encoder spec → (n, k) float64 matrix on the frame's device."""
        if enc[0] == "num":
            arr = frame._column_values(enc[1]).to(torch.float64)
            return arr[:, None] if arr.ndim == 1 else arr
        _, col, labels = enc
        k = len(labels)
        idx = _label_index(frame, col, {l: i for i, l in enumerate(labels)},
                           k)
        unseen = frame.mask & (idx == k)
        if bool(unseen.any()):
            # an unseen category would dummy-code as the dropped level
            values = frame._column_values(col)
            rows = np.flatnonzero(_host(unseen))
            bad = sorted({str(values[i]) for i in rows})[:5]
            raise ValueError(f"RFormula: unseen categories {bad} in "
                             f"column {col!r}")
        # the last category is the all-zero row (dropLast); one category
        # leaves zero columns
        eye = torch.arange(k - 1, device=idx.device)
        return (idx[:, None] == eye[None, :]).to(torch.float64)

    def transform(self, frame):
        mats = []
        for term in self.encoders:
            mat = None
            for enc in term:
                m = self._encode_one(frame, enc)
                mat = m if mat is None else \
                    (mat[:, :, None] * m[:, None, :]).reshape(mat.shape[0],
                                                              -1)
            if mat is not None and mat.shape[1] > 0:
                mats.append(mat)
        if not mats:
            raise ValueError("RFormula produced no feature columns")
        out = frame.with_column(self.features_col,
                                torch.cat(mats, dim=1).to(float_dtype()))
        if self.label_source:
            if self.label_labels is not None:
                y = _label_index(frame, self.label_source,
                                 {l: i for i, l in
                                  enumerate(self.label_labels)}, -1)
                y = torch.where(y < 0, float("nan"), y.to(torch.float64))
            else:
                y = frame._column_values(self.label_source).to(
                    torch.float64)
            out = out.with_column(self.label_col, y.to(float_dtype()))
        return out


@persistable
class ElementwiseProduct(Transformer):
    """MLlib ``ElementwiseProduct``: the Hadamard product of each row with
    a fixed ``scaling_vec``."""

    _persist_attrs = ("scaling_vec", "input_col", "output_col")

    def __init__(self, scaling_vec=None, input_col: str = "features",
                 output_col: str = "scaled_features"):
        self.scaling_vec = None if scaling_vec is None \
            else np.asarray(scaling_vec, np.float64)
        self.input_col = input_col
        self.output_col = output_col

    def set_scaling_vec(self, v):
        self.scaling_vec = np.asarray(v, np.float64)
        return self

    def set_input_col(self, v):
        self.input_col = v
        return self

    def set_output_col(self, v):
        self.output_col = v
        return self

    setScalingVec = set_scaling_vec
    setInputCol = set_input_col
    setOutputCol = set_output_col

    def transform(self, frame):
        if self.scaling_vec is None:
            raise ValueError("ElementwiseProduct: scaling_vec not set")
        X = feature_matrix(frame, self.input_col)
        v = _dev(self.scaling_vec, X)
        if v.shape[0] != X.shape[1]:
            raise ValueError(f"scaling_vec length {v.shape[0]} != "
                             f"vector size {X.shape[1]}")
        return frame.with_column(self.output_col, X * v[None, :])


@persistable
class VectorSlicer(Transformer):
    """MLlib ``VectorSlicer``: a subset of vector indices, one gather."""

    _persist_attrs = ("indices", "input_col", "output_col")

    def __init__(self, indices=(), input_col: str = "features",
                 output_col: str = "sliced_features"):
        self.indices = [int(i) for i in indices]
        self.input_col = input_col
        self.output_col = output_col

    def set_indices(self, v):
        self.indices = [int(i) for i in v]
        return self

    def set_input_col(self, v):
        self.input_col = v
        return self

    def set_output_col(self, v):
        self.output_col = v
        return self

    setIndices = set_indices
    setInputCol = set_input_col
    setOutputCol = set_output_col

    def transform(self, frame):
        if not self.indices:
            raise ValueError("VectorSlicer: indices not set")
        X = feature_matrix(frame, self.input_col)
        d = X.shape[1]
        if any(i < 0 or i >= d for i in self.indices):
            raise ValueError(f"indices out of range for vector size {d}")
        return frame.with_column(self.output_col, X.index_select(
            1, torch.as_tensor(self.indices, device=X.device)))


@functools.lru_cache(maxsize=None)
def _dct_basis(d: int) -> np.ndarray:
    """Orthonormal DCT-II matrix B (d, d) in float64: y = B @ x."""
    k = np.arange(d)[:, None]
    i = np.arange(d)[None, :]
    B = np.cos(np.pi * k * (2 * i + 1) / (2 * d))
    B *= np.sqrt(2.0 / d)
    B[0] *= 1.0 / np.sqrt(2.0)
    return B


@persistable
class DCT(Transformer):
    """MLlib ``DCT``: orthonormal 1-D DCT-II (or its inverse, DCT-III) of
    each row, one (n, d)×(d, d) product against the cosine basis, built in
    float64 and cast to the column's dtype (jTransforms' scaled
    ``forward(..., true)``)."""

    _persist_attrs = ("inverse", "input_col", "output_col")

    def __init__(self, inverse: bool = False, input_col: str = "features",
                 output_col: str = "dct_features"):
        self.inverse = bool(inverse)
        self.input_col = input_col
        self.output_col = output_col

    def set_inverse(self, v):
        self.inverse = bool(v)
        return self

    def set_input_col(self, v):
        self.input_col = v
        return self

    def set_output_col(self, v):
        self.output_col = v
        return self

    setInverse = set_inverse
    setInputCol = set_input_col
    setOutputCol = set_output_col

    def transform(self, frame):
        X, squeeze = _squeezed(frame, self.input_col)
        B = _dev(_dct_basis(X.shape[1]), X)
        out = X @ (B if self.inverse else B.T)  # inverse: Bᵀ orthonormality
        return frame.with_column(self.output_col,
                                 out[:, 0] if squeeze else out)


@persistable
class FeatureHasher(Transformer):
    """MLlib ``FeatureHasher``: hash numeric and string columns into one
    vector of ``num_features`` entries. A numeric column adds its finite
    values at bucket(hash(name)); a string column adds 1 at
    bucket(hash(name=value)). Each distinct string is hashed once on the
    host (md5, ``text._stable_hash``); the adds run on the device, column
    by column in ``input_cols`` order, as the JAX package adds them."""

    _persist_attrs = ("num_features", "input_cols", "output_col")

    def __init__(self, num_features: int = 1024, input_cols=(),
                 output_col: str = "features"):
        if num_features < 1:
            raise ValueError("num_features must be >= 1")
        self.num_features = int(num_features)
        self.input_cols = list(input_cols)
        self.output_col = output_col

    def set_num_features(self, v):
        if v < 1:
            raise ValueError("num_features must be >= 1")
        self.num_features = int(v)
        return self

    def set_input_cols(self, v):
        self.input_cols = list(v)
        return self

    def set_output_col(self, v):
        self.output_col = v
        return self

    setNumFeatures = set_num_features
    setInputCols = set_input_cols
    setOutputCol = set_output_col

    def transform(self, frame):
        from .text import _stable_hash

        if not self.input_cols:
            raise ValueError("FeatureHasher: input_cols not set")
        n = frame.num_slots
        M = torch.zeros((n, self.num_features), dtype=float_dtype(),
                        device=frame.device)
        rows = torch.arange(n, device=frame.device)
        for name in self.input_cols:
            arr = frame._column_values(name)
            if _is_string_col(arr):
                codes, words = _cell_codes(frame, name)
                buckets = torch.as_tensor(
                    [_stable_hash(f"{name}={u}", self.num_features)
                     for u in words] + [0], dtype=torch.int64,
                    device=frame.device)
                present = codes >= 0
                M.index_put_((rows[present], buckets[codes[present]]),
                             torch.ones((), dtype=M.dtype,
                                        device=M.device), accumulate=True)
            else:
                j = _stable_hash(name, self.num_features)
                col = arr.to(torch.float64)
                M[:, j] = (M[:, j].to(torch.float64) + torch.where(
                    torch.isfinite(col), col, 0.0)).to(M.dtype)
        return frame.with_column(self.output_col, M)


@persistable
class RobustScaler(_ScalerBase):
    """MLlib ``RobustScaler``: center by the median, scale by the quantile
    range (IQR by default), NaN values ignored. The quantiles are
    ``np.nanmedian``'s and ``np.nanquantile``'s of the valid rows in the
    column's dtype, from one device sort (``_order_quantiles``)."""

    _persist_attrs = ("with_centering", "with_scaling", "lower", "upper",
                      "input_col", "output_col")

    def __init__(self, with_centering: bool = False,
                 with_scaling: bool = True, lower: float = 0.25,
                 upper: float = 0.75, input_col: str = "features",
                 output_col: str = "scaled_features"):
        super().__init__(input_col, output_col)
        self.with_centering = bool(with_centering)
        self.with_scaling = bool(with_scaling)
        self.lower = float(lower)
        self.upper = float(upper)
        self._check_bounds()

    def set_with_centering(self, v):
        self.with_centering = bool(v)
        return self

    def set_with_scaling(self, v):
        self.with_scaling = bool(v)
        return self

    def set_lower(self, v):
        self.lower = float(v)
        self._check_bounds()
        return self

    def set_upper(self, v):
        self.upper = float(v)
        self._check_bounds()
        return self

    def _check_bounds(self):
        if not 0.0 <= self.lower < self.upper <= 1.0:
            raise ValueError("need 0 <= lower < upper <= 1")

    setWithCentering = set_with_centering
    setWithScaling = set_with_scaling
    setLower = set_lower
    setUpper = set_upper

    def fit(self, frame) -> "RobustScalerModel":
        self._check_bounds()
        X = feature_matrix(frame, self.input_col)
        if not bool(frame.mask.any()):
            raise ValueError("RobustScaler: no valid rows")
        dtype = numpy_dtype(X.dtype)
        d = X.shape[1]
        svals, counts = _sorted_valid(X, frame.mask)
        seen = [j for j, c in enumerate(counts) if c > 0]

        def per_column(fn, fill):
            out = np.full(d, fill, dtype)
            if seen:
                out[seen] = fn(svals[:, seen], [counts[j] for j in seen])
            return out

        with np.errstate(all="ignore"):
            med = per_column(lambda s, c: _np_median(s, c, dtype),
                             np.nan) if self.with_centering \
                else np.zeros(d)
            if self.with_scaling:
                def quantile(q):
                    return per_column(lambda s, c: np.stack(
                        _order_quantiles(s, c, np.asanyarray(q, dtype))),
                        np.nan)
                rng = quantile(self.upper) - quantile(self.lower)
                # MLlib: zero-range (constant) features map to 0.0
                scale = np.where(np.nan_to_num(rng) > 0, 1.0 / rng, 0.0)
            else:
                scale = np.ones(d)
        med = np.nan_to_num(med)     # all-NaN column: center 0, scale 0
        return RobustScalerModel(med, scale, self.input_col,
                                 self.output_col)


@persistable
class RobustScalerModel(Model):
    """``scale`` is the multiplicative factor (0 for zero-range
    features)."""

    _persist_attrs = ("median", "scale", "input_col", "output_col")

    def __init__(self, median, scale, input_col="features",
                 output_col="scaled_features"):
        self.median = np.asarray(median, np.float64)
        self.scale = np.asarray(scale, np.float64)
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, frame):
        X, squeeze = _squeezed(frame, self.input_col)
        out = (X - _dev(self.median, X)) * _dev(self.scale, X)
        return frame.with_column(self.output_col,
                                 out[:, 0] if squeeze else out)


@persistable
class VarianceThresholdSelector(Estimator):
    """MLlib ``VarianceThresholdSelector``: keep the features whose
    sample variance exceeds ``variance_threshold``, from one masked moment
    pass (the Summarizer's scatter)."""

    _persist_attrs = ("variance_threshold", "features_col", "output_col")

    def __init__(self, variance_threshold: float = 0.0,
                 features_col: str = "features",
                 output_col: str = "selected_features"):
        self.variance_threshold = float(variance_threshold)
        self.features_col = features_col
        self.output_col = output_col

    def set_variance_threshold(self, v):
        self.variance_threshold = float(v)
        return self

    def set_features_col(self, v):
        self.features_col = v
        return self

    def set_output_col(self, v):
        self.output_col = v
        return self

    setVarianceThreshold = set_variance_threshold
    setFeaturesCol = set_features_col
    setOutputCol = set_output_col

    def fit(self, frame) -> "VarianceThresholdSelectorModel":
        from .stat import _extract

        X, w = _extract(frame, self.features_col)
        n, _, C, *_ = _moment_stats(X, w, norms=False)
        if float(n) == 0:
            raise ValueError("VarianceThresholdSelector: no valid rows")
        var = _host(torch.diagonal(C)) / max(float(n) - 1.0, 1.0)
        keep = np.nonzero(var > self.variance_threshold)[0]
        # an empty selection is a valid model (MLlib)
        return VarianceThresholdSelectorModel(
            keep.astype(np.int64).tolist(), self.features_col,
            self.output_col)


@persistable
class VarianceThresholdSelectorModel(_SelectorModelBase):
    def __init__(self, selected_features, features_col="features",
                 output_col="selected_features"):
        super().__init__(selected_features, features_col, output_col)


@persistable
class UnivariateFeatureSelector(Estimator):
    """MLlib ``UnivariateFeatureSelector``: score every feature against
    the label with the test that (featureType, labelType) implies: χ² for
    categorical/categorical, ANOVA F for continuous features and a
    categorical label, F-regression for continuous/continuous; then select
    by mode (numTopFeatures | percentile | fpr | fdr | fwe).

    The statistics are float64 sums on the device over the valid rows
    (per class through ``_seg_sum``, per feature through
    ``stat._col_sums``); only scipy's tail probabilities of the tiny (d,)
    statistics run on the host, as in the JAX package."""

    _persist_attrs = ("feature_type", "label_type", "selection_mode",
                      "selection_threshold", "features_col", "label_col",
                      "output_col")

    _MODES = ("numTopFeatures", "percentile", "fpr", "fdr", "fwe")

    def __init__(self, feature_type: str = "continuous",
                 label_type: str = "categorical",
                 selection_mode: str = "numTopFeatures",
                 selection_threshold: Optional[float] = None,
                 features_col: str = "features", label_col: str = "label",
                 output_col: str = "selected_features"):
        if feature_type not in ("categorical", "continuous"):
            raise ValueError(f"feature_type={feature_type!r}")
        if label_type not in ("categorical", "continuous"):
            raise ValueError(f"label_type={label_type!r}")
        if selection_mode not in self._MODES:
            raise ValueError(f"selection_mode={selection_mode!r}; "
                             f"expected one of {self._MODES}")
        self.feature_type = feature_type
        self.label_type = label_type
        self.selection_mode = selection_mode
        self.selection_threshold = selection_threshold
        self.features_col = features_col
        self.label_col = label_col
        self.output_col = output_col

    def set_feature_type(self, v):
        if v not in ("categorical", "continuous"):
            raise ValueError(f"feature_type={v!r}")
        self.feature_type = v
        return self

    def set_label_type(self, v):
        if v not in ("categorical", "continuous"):
            raise ValueError(f"label_type={v!r}")
        self.label_type = v
        return self

    def set_selection_mode(self, v):
        if v not in self._MODES:
            raise ValueError(f"selection_mode={v!r}")
        self.selection_mode = v
        return self

    def set_selection_threshold(self, v):
        self.selection_threshold = float(v)
        return self

    def set_features_col(self, v):
        self.features_col = v
        return self

    def set_label_col(self, v):
        self.label_col = v
        return self

    def set_output_col(self, v):
        self.output_col = v
        return self

    setFeatureType = set_feature_type
    setLabelType = set_label_type
    setSelectionMode = set_selection_mode
    setSelectionThreshold = set_selection_threshold
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col
    setOutputCol = set_output_col

    def _p_values(self, X, y):
        """(d,) p-values of the continuous-feature tests; X (n, d) and y
        (n,) float64 valid rows on the device."""
        from scipy import stats as sstats

        n, d = X.shape
        ones = torch.ones_like(y)
        if self.label_type == "categorical":   # ANOVA F (f_classif)
            classes, ids = torch.unique(y, return_inverse=True)
            k = classes.shape[0]
            counts = _seg_sum(torch.ones_like(ids), ids, k)
            sums = _seg_sum(X, ids, k)
            means = sums / counts.to(X.dtype)[:, None]
            grand = _col_sums(X) / n
            within = _seg_sum((X - means.index_select(0, ids)) ** 2, ids, k)
            counts, means, grand, within = (
                _host(t) for t in (counts, means, grand, within))
            ss_between = np.zeros(d)
            for c in range(k):
                ss_between += counts[c] * (means[c] - grand) ** 2
            ss_within = within.sum(axis=0)
            df_b = k - 1
            df_w = n - k
            with np.errstate(divide="ignore", invalid="ignore"):
                F = (ss_between / df_b) / (ss_within / df_w)
            F = np.nan_to_num(F)
            return sstats.f.sf(F, df_b, df_w)
        # continuous/continuous: F-regression on the Pearson correlation
        Xc = X - _col_sums(X) / n
        yc = y - _col_sums(y[:, None]) / n
        sxx = _weighted_col_sums(lambda M: M * M, Xc, ones)
        sxy = _weighted_col_sums(lambda M: M, Xc, yc)
        syy = _col_sums((yc * yc)[:, None])
        sxx, sxy, syy = (_host(t) for t in (sxx, sxy, syy))
        denom = np.sqrt(sxx * syy[0])
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(denom > 0, sxy / denom, 0.0)
            F = r * r / np.maximum(1.0 - r * r, 1e-300) * (n - 2)
        return sstats.f.sf(F, 1, n - 2)

    def fit(self, frame) -> "UnivariateFeatureSelectorModel":
        X = feature_matrix(frame, self.features_col)
        mask = frame.mask
        if not bool(mask.any()):
            raise ValueError("UnivariateFeatureSelector: no valid rows")
        d = X.shape[1]
        if self.feature_type == "categorical":
            if self.label_type != "categorical":
                raise ValueError("categorical features require a "
                                 "categorical label (chi2)")
            pvals = _chi2_p_values(frame, self.features_col, self.label_col)
        else:
            y = frame._column_values(self.label_col).to(torch.float64)
            pvals = self._p_values(X[mask].to(torch.float64), y[mask])

        mode = self.selection_mode
        thr = self.selection_threshold
        if thr is None:         # Spark's defaults per mode
            thr = {"numTopFeatures": 50, "percentile": 0.1,
                   "fpr": 0.05, "fdr": 0.05, "fwe": 0.05}[mode]
        order = np.argsort(pvals, kind="stable")
        if mode == "numTopFeatures":
            keep = np.sort(order[: int(thr)])
        elif mode == "percentile":
            keep = np.sort(order[: max(1, int(thr * d))])
        elif mode == "fpr":
            keep = np.nonzero(pvals < thr)[0]
        elif mode == "fwe":
            keep = np.nonzero(pvals < thr / d)[0]
        else:  # fdr: Benjamini–Hochberg
            ranked = pvals[order]
            below = ranked <= thr * (np.arange(1, d + 1) / d)
            k = int(np.nonzero(below)[0].max()) + 1 if below.any() else 0
            keep = np.sort(order[:k])
        return UnivariateFeatureSelectorModel(
            keep.astype(np.int64).tolist(), self.features_col,
            self.output_col)


@persistable
class UnivariateFeatureSelectorModel(_SelectorModelBase):
    def __init__(self, selected_features, features_col="features",
                 output_col="selected_features"):
        super().__init__(selected_features, features_col, output_col)
