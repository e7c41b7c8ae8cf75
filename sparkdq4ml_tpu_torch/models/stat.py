"""``spark.ml.stat`` of the port (port of ``sparkdq4ml_tpu/models/stat.py``,
single device): ``Correlation``, ``Summarizer``, ``ChiSquareTest`` and
``KolmogorovSmirnovTest``.

Every statistic is one masked pass on the frame's device. The sums add in
a fixed order, so a statistic is bit-identical from run to run on the
card: the per-column sums go through the dense segment sum's whole form
(``_col_sums``: no id column, at most ``kernels.SEGSUM_REG_COLS`` columns a
launch), and the centered scatter ``C = Σ w·(x−μ)(x−μ)ᵀ`` is the top-left
block of the masked Gramian ``Σ s²·z zᵀ`` of ``z = [x − μ, 0, 1]`` with
``s = √w`` (kernel ``masked_gram``), the JAX package's √w scaling.
Contingency counts are integer segment sums. Only the small results come
back to the host: the d×d scatter, the per-feature statistics and the
contingency tables, which the host turns into correlations, χ² statistics
and scipy's tail probabilities, as the JAX package does. The KS test runs
on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..frame.stat import _rank
from ..ops import kernels
from ..ops.segments import _seg_sum
from .base import feature_matrix, no_mesh


def _col_sums(M: torch.Tensor) -> torch.Tensor:
    """Σ over the rows of each column of ``M`` (n, k), in a fixed order:
    the dense segment sum's whole form, at most ``SEGSUM_REG_COLS``
    columns a launch."""
    step = kernels.SEGSUM_REG_COLS
    return torch.cat([_seg_sum(M[:, j:j + step].contiguous(), None, 1)[0]
                      for j in range(0, M.shape[1], step)])


def _weighted_col_sums(fn, X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``Σᵢ fn(X)ᵢⱼ·wᵢ`` for each column j, built ``SEGSUM_REG_COLS``
    columns at a time (no (n, d) temporary)."""
    step = kernels.SEGSUM_REG_COLS
    wc = w[:, None]
    return torch.cat([_seg_sum((fn(X[:, j:j + step]) * wc).contiguous(),
                               None, 1)[0]
                      for j in range(0, X.shape[1], step)])


def _count_and_sums(X: torch.Tensor, w: torch.Tensor):
    """``(Σw, Σ X·w)``."""
    return _col_sums(w[:, None])[0], _weighted_col_sums(lambda M: M, X, w)


def _scatter(X: torch.Tensor, mean: torch.Tensor, w: torch.Tensor):
    """The centered scatter ``Σ w·(x−μ)(x−μ)ᵀ``: the top-left d×d block of
    ``masked_gram(X − μ, 0, √w)``."""
    d = X.shape[1]
    Xc = X - mean
    return kernels.masked_gram(Xc, torch.zeros_like(w), torch.sqrt(w))[:d, :d]


def _extremes(X: torch.Tensor, w: torch.Tensor):
    """Per-feature min and max over the rows of positive weight (the
    float type's largest and smallest value for none), NaN propagating:
    one ``aminmax`` pass over the kept rows."""
    Xk = X[w > 0]
    if Xk.shape[0] == 0:
        big = torch.finfo(X.dtype).max
        return X.new_full((X.shape[1],), big), X.new_full((X.shape[1],), -big)
    return torch.aminmax(Xk, dim=0)


def _moment_stats(X: torch.Tensor, w: torch.Tensor, norms: bool = True):
    """One masked moment pass over (n, d) ``X`` with row weights ``w``:
    count, per-feature mean, the CENTERED scatter (no raw-moment
    cancellation), min/max and, with ``norms``, the L1 and L2 norms and
    the nonzero counts (else None for those three)."""
    n, s1 = _count_and_sums(X, w)
    mean = s1 / n
    C = _scatter(X, mean, w)
    mn, mx = _extremes(X, w)
    if not norms:
        return n, mean, C, mn, mx, None, None, None
    l1 = _weighted_col_sums(torch.abs, X, w)
    sq = _weighted_col_sums(lambda M: M * M, X, w)
    nnz = _weighted_col_sums(lambda M: (M != 0).to(M.dtype), X, w)
    return n, mean, C, mn, mx, l1, torch.sqrt(sq), nnz


def _extract(frame, col: str, mesh=None):
    """(n, d) features in the policy's float dtype and the frame's mask
    as weights of that dtype, on the frame's device."""
    no_mesh(mesh, "spark.ml.stat")
    X = feature_matrix(frame, col)
    return X, frame.mask.to(X.dtype)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class Correlation:
    """``org.apache.spark.ml.stat.Correlation``."""

    @staticmethod
    def corr(frame, column: str = "features", method: str = "pearson",
             mesh=None):
        """(d×d) correlation matrix of a vector column as a numpy array:
        ``pearson`` from one scatter pass; ``spearman`` from the same pass
        over each column's average ranks among the valid rows
        (``frame/stat.py:_rank``, ``scipy.stats.rankdata``'s ranks; the
        masked rows rank 0 and weigh 0)."""
        X, w = _extract(frame, column, mesh)
        if method == "spearman":
            X = torch.stack([_rank(X[:, j], w) for j in range(X.shape[1])],
                            dim=1)
        elif method != "pearson":
            raise ValueError(f"unknown correlation method {method!r}")
        n, s1 = _count_and_sums(X, w)
        C = _host(_scatter(X, s1 / n, w))
        d = np.sqrt(np.diag(C))
        denom = np.outer(d, d)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = C / denom
        out[denom == 0] = np.nan
        np.fill_diagonal(out, 1.0)
        return out


class Summarizer:
    """``org.apache.spark.ml.stat.Summarizer``: one-pass per-feature
    metrics of a vector column. ``metrics(...)`` selects named metrics;
    ``summary(frame, col)`` returns them all as a dict."""

    METRICS = ("mean", "variance", "std", "count", "numNonZeros", "min",
               "max", "normL1", "normL2")

    def __init__(self, metrics=("mean", "variance")):
        unknown = set(metrics) - set(self.METRICS)
        if unknown:
            raise ValueError(f"unknown metrics {sorted(unknown)}")
        self._metrics = tuple(metrics)

    @classmethod
    def metrics(cls, *names) -> "Summarizer":
        return cls(names)

    def summary(self, frame, column: str = "features", mesh=None,
                weight_col: str = None) -> dict:
        """One-pass metrics; ``weight_col`` (MLlib's optional weight)
        weights mean, variance, norms and numNonZeros, while ``count``
        stays the number of rows of positive weight and min/max ignore
        the weights (MLlib's MultivariateOnlineSummarizer; rows of weight
        0 are skipped). A negative or NaN weight raises."""
        X, w = _extract(frame, column, mesh)
        count = None
        if weight_col is not None:
            uw = frame._column_values(weight_col).to(torch.float64)
            valid = frame.mask
            bad, positive = torch.stack([
                (valid & ~(uw >= 0)).sum(), (valid & (uw > 0)).sum()]).tolist()
            if bad:                             # NaN fails >= too
                raise ValueError("weights must be nonnegative")
            count = int(positive)
            w = torch.where(valid, uw, torch.zeros_like(uw)).to(X.dtype)
        norms = bool({"normL1", "normL2", "numNonZeros"} & set(self._metrics))
        stats = _moment_stats(X, w, norms)
        n, mean, C, mn, mx, l1, l2, nnz = [None if s is None else _host(s)
                                          for s in stats]
        var = np.diag(C) / max(float(n) - 1.0, 1.0)
        all_metrics = {
            "mean": mean, "variance": var, "std": np.sqrt(var),
            "count": int(n) if count is None else count,
            "numNonZeros": nnz, "min": mn, "max": mx,
            "normL1": l1, "normL2": l2,
        }
        return {k: all_metrics[k] for k in self._metrics}


def summary(frame, column: str = "features", mesh=None,
            weight_col: str = None) -> dict:
    """All Summarizer metrics of a vector column in one pass."""
    return Summarizer(Summarizer.METRICS).summary(frame, column, mesh,
                                                  weight_col)


def _chi2_row(table: np.ndarray):
    """(statistic, degrees of freedom, p-value) of one contingency table,
    its empty rows and columns dropped (Spark's degrees of freedom count
    observed categories only)."""
    from scipy import stats as sstats

    table = table[table.sum(axis=1) > 0][:, table.sum(axis=0) > 0]
    if table.shape[0] < 2 or table.shape[1] < 2:
        return 0.0, 0, 1.0
    row = table.sum(axis=1, keepdims=True)
    col = table.sum(axis=0, keepdims=True)
    expected = row @ col / table.sum()
    stat = float(((table - expected) ** 2 / expected).sum())
    dof = (table.shape[0] - 1) * (table.shape[1] - 1)
    return stat, dof, float(sstats.chi2.sf(stat, dof))


class ChiSquareTest:
    """``org.apache.spark.ml.stat.ChiSquareTest``: Pearson's χ²
    independence test of every (categorical) feature against the label.

    The contingency tables of all features are one integer segment sum
    over the valid rows, keyed by (feature, value, label); the tables
    (in the policy's float dtype, as the JAX package's one-hot products
    give them) come back to the host for the χ² statistic and scipy's
    tail probability."""

    @staticmethod
    def test(frame, features_col: str = "features",
             label_col: str = "label", mesh=None):
        from ..frame.frame import Frame

        X, w = _extract(frame, features_col, mesh)
        keep = w > 0
        Xk = X[keep]
        yk = frame._column_values(label_col).to(X.dtype)[keep]
        d = X.shape[1]
        if Xk.shape[0] == 0:
            raise ValueError("ChiSquareTest: no valid rows")
        bad_x = ((Xk != torch.floor(Xk)) | (Xk < 0)).any()
        bad_y = ((yk != torch.floor(yk)) | (yk < 0)).any()
        checks = torch.stack([bad_x.to(X.dtype), bad_y.to(X.dtype),
                              yk.max(), *Xk.amax(0)]).tolist()
        if checks[0]:
            raise ValueError("ChiSquareTest requires nonnegative integer "
                             "(categorical) features")
        if checks[1]:
            raise ValueError("ChiSquareTest requires nonnegative integer "
                             "labels")
        n_label = int(checks[2]) + 1
        n_feat = [int(m) + 1 for m in checks[3:]]
        offsets = np.concatenate([[0], np.cumsum(n_feat)]) * n_label
        base = torch.as_tensor(offsets[:-1], device=X.device)
        ids = (Xk.to(torch.int64) * n_label + yk.to(torch.int64)[:, None]
               + base).reshape(-1)
        counts = _seg_sum(torch.ones_like(ids), ids, int(offsets[-1]))
        counts = _host(counts.to(X.dtype))
        p_values, dofs, statistics = [], [], []
        for j in range(d):
            table = counts[offsets[j]:offsets[j + 1]].reshape(n_feat[j],
                                                              n_label)
            stat, dof, p = _chi2_row(table)
            statistics.append(stat)
            dofs.append(dof)
            p_values.append(p)
        return Frame({
            "pValues": np.asarray([np.asarray(p_values)], object),
            "degreesOfFreedom": np.asarray([np.asarray(dofs)], object),
            "statistics": np.asarray([np.asarray(statistics)], object),
        }, device=frame.device)


class KolmogorovSmirnovTest:
    """``org.apache.spark.ml.stat.KolmogorovSmirnovTest``: one-sample,
    two-sided KS test of a sample column against a theoretical
    distribution (``"norm"`` with optional mean/std, as MLlib, or any
    ``scipy.stats`` distribution name). A host step, as in the JAX
    package: the valid values are read to the host, sorted there, and the
    p-value is the asymptotic Kolmogorov tail (scipy)."""

    @staticmethod
    def test(frame, sample_col: str, dist: str = "norm", *params):
        from scipy import stats as sstats

        from ..frame.frame import Frame
        from ..config import float_dtype

        x = frame._column_values(sample_col).to(float_dtype())
        xh = _host(x[frame.mask])
        n = xh.size
        if n == 0:
            raise ValueError("KolmogorovSmirnovTest: no valid rows")
        dist_obj = getattr(sstats, dist, None)
        if dist_obj is None:
            raise ValueError(f"unknown distribution {dist!r}")
        if dist == "norm" and not params:
            params = (0.0, 1.0)    # MLlib default: standard normal
        xs = np.sort(xh)
        cdf = dist_obj.cdf(xs, *params)
        i = np.arange(1, n + 1, dtype=np.float64)
        d_plus = np.max(i / n - cdf)
        d_minus = np.max(cdf - (i - 1) / n)
        statistic = float(max(d_plus, d_minus))
        p_value = float(
            sstats.distributions.kstwobign.sf(np.sqrt(n) * statistic))
        return Frame({"pValue": np.asarray([p_value]),
                      "statistic": np.asarray([statistic])},
                     device=frame.device)
