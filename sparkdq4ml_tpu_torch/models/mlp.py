"""MultilayerPerceptronClassifier of the port (port of
``sparkdq4ml_tpu/models/mlp.py``, single device): sigmoid hidden layers, a
linear output of class logits, the mean softmax cross-entropy over the
valid rows, trained by the shared full-batch Adam (``solvers.adam_scan``,
a Python loop of autograd steps with no host read inside), with the
model's logits, softmax probability, argmax prediction and persistence in
the JAX package's format.

The initial weights are the JAX package's Glorot-uniform draws, bit for
bit: a layer's key is the second half of ``split`` of the running key
(``utils/prng.py``), its limit ``sqrt(6 / (fan_in + fan_out))`` rounded to
the float policy before the root and taken in it (as JAX computes it under
either x64 mode), the biases zero.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config import float_dtype, numpy_dtype, resolve_device
from ..frame.frame import Frame
from ..utils import prng
from .base import Estimator, Model, feature_matrix, no_mesh, persistable
from .solvers import adam_scan, psum_value_and_grad


def _mlp_forward(params, X):
    """Sigmoid hidden layers + linear output logits (softmax at the loss);
    ``params`` a sequence of (W, b) pairs."""
    h = X
    for i, (W, b) in enumerate(params):
        z = h @ W + b
        h = z if i == len(params) - 1 else torch.sigmoid(z)
    return h


def glorot_params(layers: Sequence[int], seed: int, dtype, device) -> list:
    """The JAX package's initial [(W, b), ...]: W ~ U(−limit, limit) from
    the layer's key, b zero."""
    ndt = numpy_dtype(dtype)
    key = prng.PRNGKey(seed, device)
    params = []
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        key, k1 = prng.split(key)
        limit = float(np.sqrt(ndt.type(6.0 / (fan_in + fan_out))))
        W = prng.uniform(k1, (fan_in, fan_out), dtype, -limit, limit)
        params.append((W, torch.zeros((fan_out,), dtype=dtype,
                                      device=device)))
    return params


def mlp_fit(X, y, mask, layers: Sequence[int], max_iter: int, lr: float,
            seed: int, params0=None):
    """(params, loss history) on the device of ``X``: ``max_iter`` Adam
    steps from the Glorot draws of ``seed`` (or from ``params0``, a list
    of (W, b) pairs). ``X`` and ``y`` hold zeros in the rows ``mask``
    drops."""
    dt, dev = X.dtype, X.device
    num_classes = layers[-1]
    wm = mask.to(dt)
    n = torch.sum(wm)
    Y1 = torch.nn.functional.one_hot(y.to(torch.int64), num_classes).to(
        dt) * wm[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)

    def objective(flat):
        logits = _mlp_forward(list(zip(flat[0::2], flat[1::2])), X)
        lse = torch.logsumexp(logits, dim=1)
        ll = torch.where(mask, lse - torch.sum(logits * Y1, dim=1), zero)
        return torch.sum(ll) / n

    if params0 is None:
        params0 = glorot_params(layers, seed, dt, dev)
    flat0 = tuple(t for pair in params0 for t in pair)
    flat, history = adam_scan(psum_value_and_grad(objective), flat0,
                              max_iter, lr)
    return list(zip(flat[0::2], flat[1::2])), history


@persistable
class MultilayerPerceptronClassifier(Estimator):
    """MLlib ``MultilayerPerceptronClassifier`` and its setters:
    setLayers/setMaxIter/setStepSize/setSeed(+cols). ``layers`` gives
    [input, hidden..., output] sizes; the output size is the class count."""

    _persist_attrs = ('layers', 'max_iter', 'step_size', 'seed',
                      'features_col', 'label_col', 'prediction_col',
                      'probability_col', 'raw_prediction_col')

    def __init__(self, layers: Sequence[int] = (), max_iter: int = 100,
                 step_size: float = 0.03, seed: int = 0,
                 features_col: str = "features", label_col: str = "label",
                 prediction_col: str = "prediction",
                 probability_col: str = "probability",
                 raw_prediction_col: str = "rawPrediction"):
        self.layers = [int(v) for v in layers]
        self.max_iter = int(max_iter)
        self.step_size = float(step_size)
        self.seed = int(seed)
        self.features_col = features_col
        self.label_col = label_col
        self.prediction_col = prediction_col
        self.probability_col = probability_col
        self.raw_prediction_col = raw_prediction_col

    def set_layers(self, v):
        self.layers = [int(x) for x in v]
        return self

    def set_max_iter(self, v):
        self.max_iter = int(v)
        return self

    def set_step_size(self, v):
        self.step_size = float(v)
        return self

    def set_seed(self, v):
        self.seed = int(v)
        return self

    def set_features_col(self, v):
        self.features_col = v
        return self

    def set_label_col(self, v):
        self.label_col = v
        return self

    def set_prediction_col(self, v):
        self.prediction_col = v
        return self

    setLayers = set_layers
    setMaxIter = set_max_iter
    setStepSize = set_step_size
    setSeed = set_seed
    setFeaturesCol = set_features_col
    setLabelCol = set_label_col
    setPredictionCol = set_prediction_col

    def _checked(self, frame: Frame):
        """(X, y, mask, layers) of a fit: the rows the mask drops zeroed;
        raises for the JAX package's invalid inputs (one host read)."""
        X = feature_matrix(frame, self.features_col)
        y = frame._column_values(self.label_col).to(torch.float64)
        mask = frame.mask
        finite = torch.isfinite(y)
        ym = torch.where(mask & finite, y, torch.zeros_like(y))
        valid, bad_y, bad_x, top = torch.stack([
            mask.sum().to(torch.float64),
            ((~finite | (ym < 0) | (ym != torch.floor(ym))) & mask).sum().to(
                torch.float64),
            (~torch.isfinite(X) & mask[:, None]).sum().to(torch.float64),
            ym.max() if ym.numel() else torch.zeros((), dtype=torch.float64,
                                                    device=y.device)
        ]).tolist()
        if valid == 0:
            raise ValueError("MultilayerPerceptronClassifier: no valid rows")
        if bad_y:
            raise ValueError("labels must be nonnegative integers 0..k-1")
        if bad_x:
            raise ValueError("feature matrix has NaN/inf in valid rows")
        num_classes = int(top) + 1
        layers = list(self.layers) or [X.shape[1], num_classes]
        if len(layers) < 2:
            raise ValueError("layers needs at least [input, output] sizes")
        if layers[0] != X.shape[1]:
            raise ValueError(f"layers[0]={layers[0]} != feature size "
                             f"{X.shape[1]}")
        if layers[-1] < num_classes:
            raise ValueError(f"layers[-1]={layers[-1]} < {num_classes} "
                             "observed classes")
        zero = torch.zeros((), dtype=X.dtype, device=X.device)
        return (torch.where(mask[:, None], X, zero),
                torch.where(mask, y, 0.0).to(X.dtype), mask, layers)

    def fit(self, frame: Frame, mesh=None) \
            -> "MultilayerPerceptronClassificationModel":
        no_mesh(mesh, "MultilayerPerceptronClassifier")
        X, y, mask, layers = self._checked(frame)
        params, history = mlp_fit(X, y, mask, layers, self.max_iter,
                                  self.step_size, self.seed)
        flat = torch.cat([t.reshape(-1) for pair in params for t in pair]
                         + [history]).to(torch.float64).cpu().numpy()
        weights, at = [], 0
        for W, b in params:
            w_host = flat[at:at + W.numel()].reshape(W.shape)
            at += W.numel()
            weights.append((w_host, flat[at:at + b.numel()]))
            at += b.numel()
        return MultilayerPerceptronClassificationModel(
            layers, weights, self._params_dict(), flat[at:].tolist())

    def _params_dict(self):
        return {k: getattr(self, k) for k in self._persist_attrs}


@persistable
class MultilayerPerceptronClassificationModel(Model):
    """Fitted MLP: ``weights`` is the [(W, b), ...] stack; transform adds
    rawPrediction (logits), probability (softmax), prediction (argmax)."""

    _persist_attrs = ('layers', 'flat_weights', '_params', 'loss_history')

    def __init__(self, layers, weights=None, params=None,
                 loss_history=None, flat_weights=None):
        self.layers = [int(v) for v in layers]
        if weights is not None:
            self.flat_weights = {f"W{i}": np.asarray(W)
                                 for i, (W, _) in enumerate(weights)}
            self.flat_weights.update(
                {f"b{i}": np.asarray(b)
                 for i, (_, b) in enumerate(weights)})
        else:
            self.flat_weights = {k: np.asarray(v)
                                 for k, v in (flat_weights or {}).items()}
        self._params = dict(params or {})
        self.loss_history = list(loss_history or [])

    def _post_load(self):
        self.layers = [int(v) for v in self.layers]
        self.flat_weights = {k: np.asarray(v)
                             for k, v in self.flat_weights.items()}

    def _p(self, k, default=None):
        return self._params.get(k, default)

    @property
    def weights(self):
        n = len(self.layers) - 1
        return [(self.flat_weights[f"W{i}"], self.flat_weights[f"b{i}"])
                for i in range(n)]

    @property
    def num_features(self):
        return int(self.layers[0])

    numFeatures = num_features

    def _logits(self, X: torch.Tensor) -> torch.Tensor:
        X = X.to(float_dtype())
        if X.ndim == 1:
            X = X[:, None]
        params = [(torch.tensor(W, device=X.device).to(X.dtype),
                   torch.tensor(b, device=X.device).to(X.dtype))
                  for W, b in self.weights]
        return _mlp_forward(params, X)

    def transform(self, frame: Frame) -> Frame:
        p = self._params
        logits = self._logits(frame._column_values(
            p.get("features_col", "features")))
        prob = torch.softmax(logits, dim=1)
        pred = torch.argmax(logits, dim=1).to(float_dtype())
        out = frame.with_column(p.get("raw_prediction_col", "rawPrediction"),
                                logits)
        out = out.with_column(p.get("probability_col", "probability"), prob)
        return out.with_column(p.get("prediction_col", "prediction"), pred)

    def predict(self, features) -> float:
        """The class of one feature vector, on the device
        ``config.resolve_device`` gives (the active session's)."""
        x = torch.as_tensor(np.asarray(features, np.float64).reshape(1, -1),
                            device=resolve_device())
        return float(torch.argmax(self._logits(x)[0]))
