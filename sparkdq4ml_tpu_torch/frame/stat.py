"""``Frame.stat``: Spark's ``DataFrameStatFunctions`` (the counterpart of
``sparkdq4ml_tpu/frame/stat.py``).

The reference application's second DQ rule is a price-correlation check,
and ``df.stat.corr("guest", "price")`` is how its rules are designed. Every
statistic reads the frame's valid rows only. Correlation and covariance
are the JAX package's one-pass mask-weighted reduction in the policy's
float dtype, with every sum in the fixed order of the segment-sum kernels;
Spearman ranks, quantiles and the counts behind ``crosstab``, ``sampleBy``
and ``freqItems`` are computed on the frame's device, and only the
distinct values are formatted on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import float_dtype
from ..ops import strings
from ..ops.expressions import is_host_column
from ..ops.segments import _seg_sum
from ..utils.profiling import counters


def _sums(cols: list) -> torch.Tensor:
    """Σ of each 1-D column, in one fixed-order segment-sum launch that
    reads no id column."""
    return _seg_sum(torch.stack(cols, dim=1), None, 1)[0]


def _corr_cov(a, b, w):
    """Mask-weighted Pearson correlation and sample covariance, one pass
    (the JAX package's ``_corr_cov``, in the dtype of ``a``)."""
    n, sa, sb = _sums([w, a * w, b * w])
    ma, mb = sa / n, sb / n
    da = (a - ma) * w
    db = (b - mb) * w
    sab, saa, sbb = _sums([da * db, da * da, db * db])
    div = torch.clamp(n - 1.0, min=1.0)
    cov = sab / div
    denom = torch.sqrt((saa / div) * (sbb / div))
    corr = torch.where(denom > 0, cov / denom,
                       torch.full_like(cov, float("nan")))
    return corr, cov


def _rank(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Average ranks (1-based, ties averaged, as ``scipy.stats.rankdata``)
    of the valid entries; invalid entries rank 0, and a NaN among the
    valid ones makes every valid rank NaN (rankdata's ``propagate``).
    One stable sort by (invalid, value); each tie run's first and last
    positions give its average rank."""
    keep = w > 0
    n = x.shape[0]
    dev = x.device
    v = torch.where(keep, x, torch.zeros_like(x))
    order = torch.sort(v, stable=True).indices
    order = order.index_select(0, torch.sort(
        (~keep).index_select(0, order).to(torch.uint8), stable=True).indices)
    sv, sk = v.index_select(0, order), keep.index_select(0, order)
    start = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        start[1:] = (sv[1:] != sv[:-1]) | (sk[1:] != sk[:-1])
    run = torch.cumsum(start.to(torch.int64), 0) - 1
    starts = torch.nonzero(start).squeeze(1)
    ends = torch.cat([starts[1:], torch.full((1,), n, device=dev)]) - 1
    first, last = starts.index_select(0, run), ends.index_select(0, run)
    avg = (first + last + 2).to(torch.float64) / 2.0
    ranks = torch.zeros(n, dtype=torch.float64, device=dev).scatter_(
        0, order, torch.where(sk, avg, torch.zeros_like(avg)))
    if bool((keep & torch.isnan(x)).any()):
        ranks = torch.where(keep, torch.full_like(ranks, float("nan")),
                            ranks)
    return ranks.to(x.dtype)


def _labels(values: torch.Tensor):
    """``(codes, labels)`` of a numeric column's rows: ``labels[c]`` is
    ``str`` of the numpy scalar of each distinct value, as the JAX package
    formats every cell: values keyed by their bits, so ``-0.0`` and
    ``0.0`` stay apart, with every NaN one "nan"."""
    if values.is_floating_point():
        canon = torch.where(torch.isnan(values),
                            torch.full_like(values, float("nan")), values)
        key = canon.view(torch.int64 if values.dtype == torch.float64
                         else torch.int32)
    else:
        key = values.to(torch.int64)
    uniq, codes = torch.unique(key, return_inverse=True)
    n = values.shape[0]
    first = torch.full((uniq.shape[0],), n, dtype=torch.int64,
                       device=values.device).scatter_reduce_(
        0, codes, torch.arange(n, device=values.device), "amin")
    return codes, [str(x) for x in values.index_select(0, first).cpu()
                   .numpy()]


def _count_labels(frame, col: str):
    """``(codes, labels)`` of ``col`` over the frame's valid rows, codes
    on the frame's device, where equal labels may have several codes. A
    string column takes its dictionary codes (``str(None)`` is "None")."""
    arr = frame._column_values(col)
    if is_host_column(arr):
        codes, words = strings.codes(arr)          # kept for the column
        valid = codes[frame._host_mask()].astype(np.int64) + 1
        return (torch.as_tensor(valid, device=frame.device),
                ["None"] + list(words))
    return _labels(arr[frame.mask])


def _merged(codes: torch.Tensor, labels: list):
    """Codes remapped onto the sorted distinct labels of the codes
    present: ``(codes, sorted labels)``."""
    names = sorted({labels[c] for c in torch.unique(codes).tolist()})
    at = {s: i for i, s in enumerate(names)}
    remap = torch.as_tensor([at.get(s, 0) for s in labels],
                            dtype=torch.int64, device=codes.device)
    return remap.index_select(0, codes), names


class FrameStatFunctions:
    def __init__(self, frame):
        self._frame = frame

    def _pair(self, col1: str, col2: str):
        dt = float_dtype()
        f = self._frame
        return (f._column_values(col1).to(dt), f._column_values(col2).to(dt),
                f.mask.to(dt))

    def corr(self, col1: str, col2: str, method: str = "pearson") -> float:
        """Pearson (or Spearman rank) correlation of two numeric
        columns."""
        a, b, w = self._pair(col1, col2)
        if method == "spearman":
            a, b = _rank(a, w), _rank(b, w)
        elif method != "pearson":
            raise ValueError(f"unknown correlation method {method!r}")
        counters.increment("frame.host_sync")  # device scalar -> float
        return float(_corr_cov(a, b, w)[0])

    def cov(self, col1: str, col2: str) -> float:
        """Sample covariance (n - 1 denominator, as Spark)."""
        a, b, w = self._pair(col1, col2)
        counters.increment("frame.host_sync")  # device scalar -> float
        return float(_corr_cov(a, b, w)[1])

    def approx_quantile(self, col: str, probabilities, relative_error=0.0):
        """Exact quantiles of a numeric column: the sorted valid values at
        ``min(int(p n), n - 1)`` (``relative_error`` is accepted for API
        compatibility). One sort on the device, one host read."""
        f = self._frame
        counters.increment("frame.host_sync")  # the one host read
        v = torch.sort(f._column_values(col).to(float_dtype())[f.mask]).values
        n = v.shape[0]
        ps = np.atleast_1d(probabilities)
        if n == 0:
            return [float("nan") for _ in ps]
        idx = torch.as_tensor([min(int(p * n), n - 1) for p in ps],
                              device=v.device)
        return v.index_select(0, idx).tolist()

    approxQuantile = approx_quantile

    def crosstab(self, col1: str, col2: str):
        """Contingency table of two columns (Spark's ``stat.crosstab``),
        keyed on ``str`` of each value: the pair counts on the device, the
        distinct values formatted and sorted on the host."""
        from .frame import Frame

        ca, la = _merged(*_count_labels(self._frame, col1))
        cb, lb = _merged(*_count_labels(self._frame, col2))
        counts = torch.bincount(ca * len(lb) + cb,
                                minlength=len(la) * len(lb))
        table = counts.reshape(len(la), len(lb)).to(torch.int64)
        data = {f"{col1}_{col2}": np.asarray(la, dtype=object)}
        host = table.cpu().numpy()
        for j, y in enumerate(lb):
            data[y] = host[:, j]
        return Frame(data, device=self._frame.device)

    def sample_by(self, col: str, fractions: dict, seed: int = 0):
        """Stratified Bernoulli sample without replacement (Spark's
        ``stat.sampleBy``): a row whose ``col`` value is a key of
        ``fractions`` stays with that probability, any other row never.
        The draw is numpy's (``default_rng(seed).random(num_slots)``), as
        in the JAX package; the strata match on the device."""
        for k, fr in fractions.items():
            if not 0.0 <= fr <= 1.0:
                raise ValueError(
                    f"fraction for stratum {k!r} must be in [0, 1], got {fr}")
        f = self._frame
        vals = f._column_values(col)
        u = torch.as_tensor(np.random.default_rng(seed).random(f.num_slots),
                            device=f.device)
        frac = torch.zeros(f.num_slots, dtype=torch.float64, device=f.device)
        if is_host_column(vals):
            codes, words = strings.codes(vals)
            table = np.zeros(len(words) + 1)
            for k, fr in fractions.items():
                if isinstance(k, str) and k in words:
                    table[words.index(k)] = fr
                elif k is None:
                    table[-1] = fr             # NULL_CODE picks the last
            frac = torch.as_tensor(table[codes], device=f.device)
        else:
            x = vals.to(torch.float64) if vals.is_floating_point() else vals
            for k, fr in fractions.items():
                if isinstance(k, (bool, int, float)):
                    frac = torch.where(x == k, torch.full_like(frac, fr),
                                       frac)
        return f._with(mask=f.mask & (u < frac))

    sampleBy = sample_by

    def freq_items(self, cols, support: float = 0.01):
        """Each column's items with frequency >= ``support`` (Spark's
        ``freqItems``), keyed and sorted on ``str`` of each value."""
        from .frame import Frame

        out = {}
        n = max(self._frame.count(), 1)
        for c in cols:
            codes, labels = _merged(*_count_labels(self._frame, c))
            counts = torch.bincount(codes, minlength=len(labels)).tolist()
            # the JAX package's np.asarray([items], dtype=object): one row
            # holding the items, one per cell
            out[c + "_freqItems"] = np.asarray(
                [[v for v, k in zip(labels, counts) if k / n >= support]],
                dtype=object)
        return Frame(out, device=self._frame.device)

    freqItems = freq_items
