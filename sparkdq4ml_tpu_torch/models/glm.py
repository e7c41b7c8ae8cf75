"""GeneralizedLinearRegression: MLlib's IRLS GLM (port of
``sparkdq4ml_tpu/models/glm.py``, single device).

Families x links as in the JAX package: gaussian (identity, log,
inverse), binomial (logit, probit, cloglog), poisson (log, identity,
sqrt), gamma (inverse, identity, log) and tweedie (the power link
``link_power``, by default ``1 - variance_power``). Optional L2
``reg_param``, ``weight_col`` and ``offset_col``.

Each IRLS iteration is one weighted least-squares solve. Its normal matrix
``X1ᵀWX1`` and moment ``X1ᵀWz`` come from one ``masked_gram`` launch
(``ops/kernels.py``) with weight ``√ww`` and response ``z``: the kernel's
``A = Σ ww·[x, z, 1][x, z, 1]ᵀ`` holds ``X1ᵀWX1`` in its rows and
columns ``0..d-1, d+1`` (the intercept last, as in the JAX package) and
``X1ᵀWz`` in column ``d`` of those rows; without an intercept they are
``A[:d, :d]`` and ``A[:d, d]``. The reference's ``lax.while_loop`` is a
Python loop over device steps that reads its convergence latch once an
iteration; the final pass at the converged β is one more launch.

The training summary works on the host in float64 over the valid rows, as
the JAX package's does, with the link and variance functions evaluated in
the policy's float dtype where the reference evaluates them through JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import float_dtype
from ..frame.frame import Frame
from ..ops import kernels
from .base import Estimator, Model, feature_matrix, no_mesh, persistable

_FAMILY_LINKS = {
    "gaussian": ("identity", "log", "inverse"),
    "binomial": ("logit", "probit", "cloglog"),
    "poisson": ("log", "identity", "sqrt"),
    "gamma": ("inverse", "identity", "log"),
    # tweedie accepts any power link; validated separately
    "tweedie": (),
}
_DEFAULT_LINK = {"gaussian": "identity", "binomial": "logit",
                 "poisson": "log", "gamma": "inverse"}
_EPS = 1e-12
_SQRT_2PI = math.sqrt(2.0 * math.pi)


def _clamp_min(x, lo):
    return torch.clamp(x, min=lo)


def _power_link(lp: float):
    """Tweedie power link g(μ) = μ^lp (lp = 0 is the log link)."""
    if lp == 0.0:
        return (lambda mu: torch.log(_clamp_min(mu, _EPS)), torch.exp,
                torch.exp)
    if lp == 1.0:
        return (lambda mu: mu, lambda eta: eta, torch.ones_like)
    if lp == -1.0:
        return (lambda mu: 1.0 / mu, lambda eta: 1.0 / eta,
                lambda eta: -1.0 / (eta * eta))
    inv_p = 1.0 / lp
    # the floor keeps every derived quantity finite in float32 (the JAX
    # package's choice, glm.py:64-69)
    floor = 1e-3
    return (lambda mu: _clamp_min(mu, _EPS) ** lp,
            lambda eta: _clamp_min(eta, floor) ** inv_p,
            lambda eta: inv_p * _clamp_min(eta, floor) ** (inv_p - 1.0))


def _link_fns(link: str):
    """(g, g⁻¹, dμ/dη) of a link, on tensors."""
    if link == "identity":
        return (lambda mu: mu, lambda eta: eta, torch.ones_like)
    if link == "log":
        return (lambda mu: torch.log(_clamp_min(mu, _EPS)), torch.exp,
                torch.exp)
    if link == "logit":
        inv = torch.sigmoid
        return (lambda mu: torch.log(mu / (1.0 - mu)), inv,
                lambda eta: inv(eta) * (1.0 - inv(eta)))
    if link == "inverse":
        return (lambda mu: 1.0 / mu, lambda eta: 1.0 / eta,
                lambda eta: -1.0 / (eta * eta))
    if link == "sqrt":
        return (torch.sqrt, lambda eta: eta * eta, lambda eta: 2.0 * eta)
    if link == "probit":
        return (torch.special.ndtri, torch.special.ndtr,
                lambda eta: torch.exp(-0.5 * eta * eta) / _SQRT_2PI)
    if link == "cloglog":
        return (lambda mu: torch.log(-torch.log1p(-mu)),
                lambda eta: -torch.expm1(-torch.exp(eta)),
                lambda eta: torch.exp(eta - torch.exp(eta)))
    if link.startswith("power(") and link.endswith(")"):
        return _power_link(float(link[6:-1]))
    raise ValueError(f"unknown link {link!r}")


def _tweedie_power(family: str):
    """``"tweedie:<p>"`` -> p, else None."""
    if family.startswith("tweedie:"):
        return float(family.split(":", 1)[1])
    return None


def _variance_fn(family: str):
    p = _tweedie_power(family)
    if p is not None:
        if p == 0.0:
            return torch.ones_like
        return lambda mu: _clamp_min(mu, _EPS) ** p
    return {"gaussian": torch.ones_like,
            "binomial": lambda mu: mu * (1.0 - mu),
            "poisson": lambda mu: mu,
            "gamma": lambda mu: mu * mu}[family]


def _clip_mu(family: str, mu):
    if family == "binomial":
        return torch.clamp(mu, _EPS, 1.0 - _EPS)
    if family in ("poisson", "gamma"):
        return _clamp_min(mu, _EPS)
    p = _tweedie_power(family)
    if p is not None and p != 0.0:
        return torch.clamp(mu, _EPS, 1e8)
    return mu


def _unit_deviance(family: str, y, mu):
    """Per-row deviance contribution (before weighting)."""
    zero = torch.zeros((), dtype=mu.dtype, device=mu.device)
    p = _tweedie_power(family)
    if p is not None:
        if p == 0.0:
            family = "gaussian"
        elif p == 1.0:
            family = "poisson"
        elif p == 2.0:
            family = "gamma"
        else:
            yp = _clamp_min(y, 0.0)
            t1 = torch.where(yp > 0,
                             yp ** (2.0 - p) / ((1.0 - p) * (2.0 - p)), zero)
            t2 = y * mu ** (1.0 - p) / (1.0 - p)
            t3 = mu ** (2.0 - p) / (2.0 - p)
            return 2.0 * (t1 - t2 + t3)
    if family == "gaussian":
        return (y - mu) ** 2
    if family == "binomial":
        yl = torch.where(y > 0, y * torch.log(_clamp_min(y, _EPS) / mu), zero)
        ol = torch.where(y < 1, (1 - y) * torch.log(
            _clamp_min(1 - y, _EPS) / (1 - mu)), zero)
        return 2.0 * (yl + ol)
    if family == "poisson":
        t = torch.where(y > 0, y * torch.log(_clamp_min(y, _EPS) / mu), zero)
        return 2.0 * (t - (y - mu))
    r = _clamp_min(y, _EPS) / mu
    return 2.0 * (-torch.log(r) + (y - mu) / mu)


def _deviance(family: str, y, mu, w):
    """Per-family deviance, weight-summed (Spark/R convention)."""
    return torch.sum(w * _unit_deviance(family, y, mu))


class GlmFit(NamedTuple):
    beta: torch.Tensor         # (p,): [coefficients..., intercept slot]
    iterations: int
    converged: bool
    deviance: torch.Tensor
    xtwx: torch.Tensor         # final weighted normal matrix


def _wls_stats(family: str, link: str, fit_intercept: bool):
    """``(X, y, w, off, β) -> (X1ᵀWX1, X1ᵀWz, deviance)`` through one
    ``masked_gram`` launch. ``w == 0`` marks masked rows: their y may be
    NaN and their η may push the inverse link to ±inf, so every statistic
    is sanitized through ``torch.where`` as in the reference."""
    _, link_inv, dmu_deta = _link_fns(link)
    var_f = _variance_fn(family)

    def stats(X, y, w, off, beta):
        d = X.shape[1]
        one = torch.ones((), dtype=X.dtype, device=X.device)
        zero = torch.zeros((), dtype=X.dtype, device=X.device)
        valid = w > 0
        eta = X @ beta[:d] + off
        if fit_intercept:
            eta = eta + beta[d]
        mu = torch.where(valid, _clip_mu(family, link_inv(eta)), one)
        yv = torch.where(valid, y, one)   # yv == mu == 1: zero deviance
        dm = torch.where(valid, dmu_deta(eta), one)
        dm = torch.where(torch.abs(dm) < _EPS,
                         torch.sign(dm) * _EPS + (dm == 0) * _EPS, dm)
        z = torch.where(valid, eta - off + (yv - mu) / dm, zero)
        ww = torch.where(valid, w * dm * dm / _clamp_min(var_f(mu), _EPS),
                         zero)
        A = kernels.masked_gram(X, z, torch.sqrt(ww))
        if fit_intercept:
            idx = torch.cat([torch.arange(d, device=X.device),
                             torch.full((1,), d + 1, device=X.device)])
            xtwx, xtwz = A[idx][:, idx], A[idx, d]
        else:
            xtwx, xtwz = A[:d, :d], A[:d, d]
        return xtwx, xtwz, _deviance(family, yv, mu, w)

    return stats


def irls(X, y, w, off, beta0, *, family: str, link: str, max_iter: int,
         tol: float, reg_param: float, fit_intercept: bool) -> GlmFit:
    """The IRLS fit of ``_build_fit`` on ``X``'s device: ``X`` (n, d)
    without the intercept column, which ``fit_intercept`` carries as the
    last slot of β. One ``masked_gram`` launch and one host read of the
    convergence latch an iteration, one more launch at the end."""
    stats = _wls_stats(family, link, fit_intercept)
    p = beta0.shape[0]
    ridge = torch.eye(p, dtype=X.dtype, device=X.device) * reg_param
    if fit_intercept:
        ridge[p - 1, p - 1] = 0.0       # never penalize the intercept
    beta = beta0
    it, delta = 0, math.inf
    while it < max_iter and delta > tol:
        xtwx, xtwz, _ = stats(X, y, w, off, beta)
        new = torch.linalg.solve(xtwx + ridge, xtwz)
        step = torch.max(torch.abs(new - beta)) / \
            torch.clamp(torch.max(torch.abs(new)), min=1.0)
        beta, it = new, it + 1
        delta = float(step)
    xtwx, _, dev = stats(X, y, w, off, beta)
    return GlmFit(beta, it, delta <= tol, dev, xtwx)


def _validate_y(family: str, variance_power: float, y: torch.Tensor):
    """The reference's label checks over the valid labels (NaN skipped),
    one host read."""
    y = y[~torch.isnan(y)]
    if family == "binomial":
        if not bool(((y >= 0) & (y <= 1)).all()):
            raise ValueError("binomial family requires labels in [0, 1]")
    elif family == "poisson":
        if not bool((y >= 0).all()):
            raise ValueError("poisson family requires nonnegative labels")
    elif family == "gamma":
        if not bool((y > 0).all()):
            raise ValueError("gamma family requires positive labels")
    elif family == "tweedie":
        if 1.0 <= variance_power < 2.0:
            if not bool((y >= 0).all()):
                raise ValueError("tweedie with 1 <= variance_power < 2 "
                                 "requires nonnegative labels")
        elif variance_power >= 2.0:
            if not bool((y > 0).all()):
                raise ValueError("tweedie with variance_power >= 2 "
                                 "requires positive labels")


@persistable
class GeneralizedLinearRegression(Estimator):
    """MLlib ``GeneralizedLinearRegression`` builder surface:
    setFamily/setLink/setMaxIter/setTol/setRegParam/setFitIntercept/
    setWeightCol/setFeaturesCol/setLabelCol/setPredictionCol/
    setLinkPredictionCol + ``fit(frame)``."""

    _persist_attrs = ('family', 'link', 'max_iter', 'tol', 'reg_param',
                      'fit_intercept', 'features_col', 'label_col',
                      'prediction_col', 'link_prediction_col', 'weight_col',
                      'offset_col', 'variance_power', 'link_power')

    def __init__(self, family: str = "gaussian", link: Optional[str] = None,
                 max_iter: int = 25, tol: float = 1e-6,
                 reg_param: float = 0.0, fit_intercept: bool = True,
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction",
                 link_prediction_col: Optional[str] = None,
                 weight_col: Optional[str] = None,
                 offset_col: Optional[str] = None,
                 variance_power: float = 0.0,
                 link_power: Optional[float] = None):
        family = family.lower()
        if family not in _FAMILY_LINKS:
            raise ValueError(f"unknown family {family!r} "
                             f"(supported: {sorted(_FAMILY_LINKS)})")
        if family == "tweedie":
            if link is not None:
                raise ValueError("tweedie uses link_power, not link")
            if 0.0 < variance_power < 1.0:
                raise ValueError("variance_power must be 0 or >= 1 "
                                 "(no Tweedie distribution exists in (0,1))")
            if link_power is None:
                link_power = 1.0 - variance_power
            link = f"power({float(link_power)})"
        else:
            if link_power is not None:
                raise ValueError("link_power is only valid for the tweedie "
                                 "family")
            link = link.lower() if link else _DEFAULT_LINK[family]
            if link not in _FAMILY_LINKS[family]:
                raise ValueError(
                    f"link {link!r} not supported by family "
                    f"{family!r} (supported: {_FAMILY_LINKS[family]})")
        if reg_param < 0:
            raise ValueError("reg_param must be >= 0")
        self.family = family
        self.link = link
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.reg_param = float(reg_param)
        self.fit_intercept = bool(fit_intercept)
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.link_prediction_col = link_prediction_col
        self.weight_col = weight_col
        self.offset_col = offset_col
        self.variance_power = float(variance_power)
        self.link_power = (None if link_power is None else float(link_power))

    def _family_key(self) -> str:
        """The family string the model's helpers read (tweedie carries its
        variance power)."""
        if self.family == "tweedie":
            return f"tweedie:{self.variance_power}"
        return self.family

    def _set(self, name, v):
        setattr(self, name, v)
        return self

    def _reinit(self, family, link, variance_power=None, link_power=None):
        if variance_power is None:
            variance_power = self.variance_power
        return GeneralizedLinearRegression.__init__(
            self, family, link, self.max_iter, self.tol, self.reg_param,
            self.fit_intercept, self.features_col, self.label_col,
            self.prediction_col, self.link_prediction_col, self.weight_col,
            self.offset_col, variance_power, link_power) or self

    def set_family(self, v):
        v = v.lower()
        if v == "tweedie":
            return self._reinit(v, None, link_power=self.link_power)
        return self._reinit(v, self.link if v == self.family else None)

    setFamily = set_family

    def set_link(self, v):
        return self._reinit(self.family, v)

    setLink = set_link

    def set_variance_power(self, v):
        return self._reinit("tweedie", None, variance_power=float(v),
                            link_power=self.link_power)

    setVariancePower = set_variance_power

    def set_link_power(self, v):
        return self._reinit("tweedie", None, link_power=float(v))

    setLinkPower = set_link_power

    def set_offset_col(self, v):
        return self._set("offset_col", v)

    setOffsetCol = set_offset_col

    def set_max_iter(self, v):
        return self._set("max_iter", int(v))

    setMaxIter = set_max_iter

    def set_tol(self, v):
        return self._set("tol", float(v))

    setTol = set_tol

    def set_reg_param(self, v):
        if v < 0:
            raise ValueError("reg_param must be >= 0")
        return self._set("reg_param", float(v))

    setRegParam = set_reg_param

    def set_fit_intercept(self, v):
        return self._set("fit_intercept", bool(v))

    setFitIntercept = set_fit_intercept

    def set_weight_col(self, v):
        return self._set("weight_col", v)

    setWeightCol = set_weight_col

    def set_features_col(self, v):
        return self._set("features_col", v)

    setFeaturesCol = set_features_col

    def set_label_col(self, v):
        return self._set("label_col", v)

    setLabelCol = set_label_col

    def set_link_prediction_col(self, v):
        return self._set("link_prediction_col", v)

    setLinkPredictionCol = set_link_prediction_col

    def fit(self, frame: Frame,
            mesh=None) -> "GeneralizedLinearRegressionModel":
        no_mesh(mesh, "GeneralizedLinearRegression")
        dt = float_dtype()
        X = feature_matrix(frame, self.features_col)
        y = frame._column_values(self.label_col).to(dt)
        mask = frame.mask
        if not bool(mask.any()):
            raise ValueError("GeneralizedLinearRegression: no valid rows")
        _validate_y(self.family, self.variance_power, y[mask])
        zero = torch.zeros((), dtype=dt, device=X.device)
        prior_w = (frame._column_values(self.weight_col).to(dt)
                   if self.weight_col is not None else torch.ones_like(y))
        w = torch.where(mask, prior_w, zero)
        off = (torch.where(mask, frame._column_values(self.offset_col)
                           .to(dt), zero)
               if self.offset_col is not None else torch.zeros_like(y))
        d = X.shape[1]
        p = d + 1 if self.fit_intercept else d

        # the family-standard start: one IRLS step from mu0
        beta0 = torch.zeros(p, dtype=dt, device=X.device)
        if self.fit_intercept:
            ym = torch.where(mask, y, zero)
            mu_bar = float(torch.sum(ym * w)
                           / torch.clamp(torch.sum(w), min=1e-12))
            link_f, _, _ = _link_fns(self.link)
            positive = self.family in ("poisson", "gamma") or (
                self.family == "tweedie" and self.variance_power != 0.0)
            mu0 = {"binomial": min(max(mu_bar, 0.01), 0.99)}.get(
                self.family, max(mu_bar, 0.1) if positive else mu_bar)
            beta0[p - 1] = link_f(torch.tensor(mu0, dtype=dt))
        res = irls(X, y, w, off, beta0, family=self._family_key(),
                   link=self.link, max_iter=self.max_iter, tol=self.tol,
                   reg_param=self.reg_param,
                   fit_intercept=self.fit_intercept)
        beta = res.beta.to(torch.float64).cpu().numpy()
        coef = beta[:d] if self.fit_intercept else beta
        intercept = float(beta[d]) if self.fit_intercept else 0.0
        model = GeneralizedLinearRegressionModel(
            coefficients=coef.copy(), intercept=intercept,
            params=self._params_dict())
        model._fit_info = {
            "deviance": float(res.deviance),
            "iterations": int(res.iterations),
            "converged": bool(res.converged),
            "xtwx": res.xtwx.to(torch.float64).cpu().numpy(),
            "frame": frame,
        }
        return model

    def _params_dict(self):
        d = {k: getattr(self, k) for k in self._persist_attrs}
        d["family"] = self._family_key()
        return d


@persistable
class GeneralizedLinearRegressionModel(Model):
    _persist_attrs = ('coefficients', 'intercept', '_params')
    _fit_info = None  # load_stage bypasses __init__; summary absent then

    def __init__(self, coefficients, intercept, params=None):
        self.coefficients = np.asarray(coefficients)
        self.intercept = float(intercept)
        self._params = dict(params or {})
        self._fit_info = None

    @property
    def num_features(self):
        return int(self.coefficients.shape[0])

    numFeatures = num_features

    def _p(self, key, default=None):
        return self._params.get(key, default)

    def _eta(self, X):
        coef = torch.as_tensor(self.coefficients, dtype=X.dtype,
                               device=X.device)
        return X @ coef + self.intercept

    def transform(self, frame: Frame) -> Frame:
        X = feature_matrix(frame, self._p("features_col", "features"))
        eta = self._eta(X)
        oc = self._p("offset_col")
        if oc:
            eta = eta + frame._column_values(oc).to(eta.dtype)
        _, link_inv, _ = _link_fns(self._p("link", "identity"))
        out = frame.with_column(self._p("prediction_col", "prediction"),
                                link_inv(eta))
        lp = self._p("link_prediction_col")
        if lp:
            out = out.with_column(lp, eta)
        return out

    def predict(self, features) -> float:
        x = torch.as_tensor(np.asarray(features, np.float64).reshape(1, -1),
                            dtype=float_dtype())
        _, link_inv, _ = _link_fns(self._p("link", "identity"))
        return float(link_inv(self._eta(x))[0])

    @property
    def summary(self) -> "GlmTrainingSummary":
        if self._fit_info is None:
            raise ValueError("summary is only available on the model "
                             "returned by fit() (not after load())")
        return GlmTrainingSummary(self, self._fit_info)

    @property
    def has_summary(self):
        return self._fit_info is not None

    hasSummary = has_summary


def _on_policy(fn, *arrays) -> np.ndarray:
    """``fn`` of host arrays evaluated in the policy's float dtype on the
    CPU, back as numpy: where the reference passes float64 numpy through
    ``jnp.asarray`` (float32 unless x64 is on)."""
    dt = float_dtype()
    out = fn(*(torch.as_tensor(np.asarray(a), dtype=dt) for a in arrays))
    return out.numpy()


class GlmTrainingSummary:
    """MLlib ``GeneralizedLinearRegressionTrainingSummary``: deviance, null
    deviance, dispersion, AIC, residuals, coefficient standard errors /
    t-values / p-values (Wald; normal for binomial and poisson, t for the
    others)."""

    def __init__(self, model, info):
        self._m = model
        self._info = info
        self._frame = info["frame"]
        self._cache: dict = {}

    @property
    def deviance(self) -> float:
        return self._info["deviance"]

    @property
    def num_iterations(self) -> int:
        return self._info["iterations"]

    numIterations = num_iterations

    @property
    def converged(self) -> bool:
        return self._info["converged"]

    def _host(self, name: str) -> np.ndarray:
        v = self._frame._column_values(name).to(torch.float64).cpu().numpy()
        return v[self._frame._host_mask()]

    def _xyw(self):
        if "xyw" not in self._cache:
            m = self._m
            X = self._host(m._p("features_col", "features"))
            if X.ndim == 1:
                X = X[:, None]
            y = self._host(m._p("label_col", "label"))
            w = (self._host(m._p("weight_col")) if m._p("weight_col")
                 else np.ones_like(y))
            self._cache["xyw"] = (X, y, w)
        return self._cache["xyw"]

    def _offset(self):
        if "offset" not in self._cache:
            oc = self._m._p("offset_col")
            self._cache["offset"] = (
                self._host(oc) if oc else
                np.zeros(len(self._xyw()[1]), np.float64))
        return self._cache["offset"]

    def _mu(self):
        if "mu" not in self._cache:
            X, _, _ = self._xyw()
            _, link_inv, _ = _link_fns(self._m._p("link"))
            eta = X @ self._m.coefficients + self._m.intercept + \
                self._offset()
            family = self._m._p("family")
            self._cache["mu"] = _on_policy(
                lambda e: _clip_mu(family, link_inv(e)), eta)
        return self._cache["mu"]

    @property
    def degrees_of_freedom(self) -> int:
        X, _, _ = self._xyw()
        p = self._m.num_features + (1 if self._m._p("fit_intercept", True)
                                    else 0)
        return int(len(X) - p)

    degreesOfFreedom = degrees_of_freedom

    @property
    def residual_degree_of_freedom_null(self) -> int:
        X, _, _ = self._xyw()
        return int(len(X) - (1 if self._m._p("fit_intercept", True) else 0))

    residualDegreeOfFreedomNull = residual_degree_of_freedom_null

    @property
    def dispersion(self) -> float:
        family = self._m._p("family")
        if family in ("binomial", "poisson"):
            return 1.0
        if "dispersion" not in self._cache:
            _, y, w = self._xyw()
            mu = self._mu()
            var = _on_policy(_variance_fn(family), mu)
            pearson = np.sum(w * (y - mu) ** 2 / np.maximum(var, _EPS))
            self._cache["dispersion"] = float(
                pearson / max(self.degrees_of_freedom, 1))
        return self._cache["dispersion"]

    @property
    def null_deviance(self) -> float:
        _, y, w = self._xyw()
        family = self._m._p("family")
        link = self._m._p("link")
        off = self._offset()
        link_f, link_inv, _ = _link_fns(link)
        dt = float_dtype()
        if np.any(off != 0.0):
            # with an offset the null model's linear predictor is
            # β₀ + offset_i: an intercept-only IRLS fit
            if self._m._p("fit_intercept", True):
                mu_bar = float(np.sum(y * w) / max(w.sum(), _EPS))
                b0 = _on_policy(lambda m: link_f(_clip_mu(family, m)),
                                mu_bar)
                t = lambda a: torch.as_tensor(a, dtype=dt)
                res = irls(torch.ones((len(y), 1), dtype=dt), t(y), t(w),
                           t(off), t(np.reshape(b0, 1)), family=family,
                           link=link, max_iter=50, tol=1e-10, reg_param=0.0,
                           fit_intercept=False)
                return float(res.deviance)
            mu0 = _on_policy(lambda o: _clip_mu(family, link_inv(o)), off)
        elif self._m._p("fit_intercept", True):
            mu0 = np.full_like(y, np.sum(y * w) / w.sum())
        else:
            mu0 = np.full_like(y, float(_on_policy(link_inv, 0.0)))
        return float(_on_policy(
            lambda yy, m, ww: _deviance(family, yy, _clip_mu(family, m), ww),
            y, mu0, w))

    nullDeviance = null_deviance

    def residuals(self, residuals_type: str = "deviance") -> Frame:
        """deviance | pearson | working | response residual column."""
        _, y, w = self._xyw()
        family = self._m._p("family")
        mu = self._mu()
        if residuals_type == "response":
            r = y - mu
        elif residuals_type == "pearson":
            var = _on_policy(_variance_fn(family), mu)
            r = (y - mu) * np.sqrt(w) / np.sqrt(np.maximum(var, _EPS))
        elif residuals_type == "working":
            link_f, _, dmu = _link_fns(self._m._p("link"))
            d = _on_policy(dmu, _on_policy(link_f, mu))
            r = (y - mu) / np.where(np.abs(d) < _EPS, _EPS, d)
        elif residuals_type == "deviance":
            unit = _on_policy(lambda yy, m: _unit_deviance(family, yy, m),
                              y, mu) * w
            r = np.sign(y - mu) * np.sqrt(np.maximum(unit, 0.0))
        else:
            raise ValueError(f"unknown residuals type {residuals_type!r}")
        return Frame({f"{residuals_type}Residuals": r},
                     device=self._frame.device)

    @property
    def aic(self) -> float:
        _, y, w = self._xyw()
        family = self._m._p("family")
        if _tweedie_power(family) is not None:
            raise ValueError("AIC is not supported for the tweedie family")
        from scipy.special import gammaln

        mu = self._mu()
        n = len(y)
        p = self._m.num_features + (1 if self._m._p("fit_intercept", True)
                                    else 0)
        if family == "gaussian":
            rss = np.sum(w * (y - mu) ** 2)
            ll = -0.5 * n * (np.log(2 * np.pi * rss / n) + 1)
            return float(-2 * ll + 2 * (p + 1))
        if family == "binomial":
            ll = np.sum(w * (y * np.log(mu) + (1 - y) * np.log(1 - mu)))
            return float(-2 * ll + 2 * p)
        if family == "poisson":
            ll = np.sum(w * (y * np.log(np.maximum(mu, _EPS)) - mu
                             - gammaln(y + 1)))
            return float(-2 * ll + 2 * p)
        disp = max(self.dispersion, _EPS)
        a = 1.0 / disp
        ll = np.sum(w * (a * np.log(a * y / np.maximum(mu, _EPS))
                         - a * y / np.maximum(mu, _EPS)
                         - np.log(np.maximum(y, _EPS)) - gammaln(a)))
        return float(-2 * ll + 2 * (p + 1))

    @property
    def coefficient_standard_errors(self):
        if self._m._p("reg_param", 0.0) > 0:
            raise ValueError(
                "standard errors are not available for regularized fits "
                "(reg_param > 0); refit with reg_param=0 for Wald inference")
        cov = np.linalg.pinv(self._info["xtwx"]) * self.dispersion
        return np.sqrt(np.clip(np.diag(cov), 0.0, None))

    coefficientStandardErrors = coefficient_standard_errors

    @property
    def t_values(self):
        se = self.coefficient_standard_errors
        beta = np.r_[self._m.coefficients, self._m.intercept] \
            if self._m._p("fit_intercept", True) else self._m.coefficients
        return beta / np.where(se == 0, np.inf, se)

    tValues = t_values

    @property
    def p_values(self):
        from scipy import stats as sstats

        t = np.abs(self.t_values)
        if self._m._p("family") in ("binomial", "poisson"):
            return 2.0 * (1.0 - sstats.norm.cdf(t))
        return 2.0 * sstats.t.sf(t, max(self.degrees_of_freedom, 1))

    pValues = p_values
