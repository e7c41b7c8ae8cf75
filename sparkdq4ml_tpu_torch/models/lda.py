"""Latent Dirichlet Allocation of the port (port of
``sparkdq4ml_tpu/models/lda.py``, single device): batch variational EM
(``optimizer="em"``) and online variational Bayes (Hoffman, Blei and
Bach), with ``describe_topics``, ``transform``, ``log_likelihood``,
``log_perplexity``, ``topics_matrix``, ``estimated_doc_concentration`` and
persistence in the JAX package's format.

Documents are a dense ``(n, V)`` count matrix on the frame's device. The
E-step is three matrix products an inner iteration (``_e_step``) with
``torch.special.digamma``; the M-step ``λ ← (1−ρ)·λ + ρ·(η + (D/B)·sstats)``
runs as a Python loop of device steps with no host read inside. λ starts
from JAX's gamma draw (``utils/prng.py``: Gamma(100, 1/100)); the online
optimizer's minibatch rows are JAX's ``randint`` draws (int32 under the
float32 policy, int64 under float64, as JAX draws them with x64 off or on).
Rows the mask drops carry no tokens: their counts are replaced (not
multiplied) by zeros, so a NaN there cannot poison the statistics. The
variational bound is the JAX package's, its token term over chunks of
rows with ``torch.lgamma`` and a log-sum-exp over the topics.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import float_dtype
from ..frame.frame import Frame
from ..utils import prng
from .base import Estimator, Model, no_mesh, persistable

_EPS = 1e-30
# The bound's token term takes its (rows, k, V) log-sum-exp over chunks of
# rows holding at most this many values.
BOUND_CHUNK_VALUES = 1 << 24


def _dirichlet_expectation(a):
    """E[log x] for x ~ Dir(a), rows of ``a`` (…, m)."""
    return torch.special.digamma(a) - torch.special.digamma(
        torch.sum(a, dim=-1, keepdim=True))


def _e_step(cnts, expElogbeta, alpha: float, inner_iter: int):
    """Batch variational E-step: (gamma, sstats before the product with
    ``expElogbeta``, which the caller takes once)."""
    n = cnts.shape[0]
    k = expElogbeta.shape[0]
    gamma = torch.ones((n, k), dtype=cnts.dtype, device=cnts.device)
    for _ in range(inner_iter):
        expElogtheta = torch.exp(_dirichlet_expectation(gamma))   # (n, k)
        phinorm = expElogtheta @ expElogbeta + _EPS               # (n, V)
        gamma = alpha + expElogtheta * ((cnts / phinorm) @ expElogbeta.T)
    expElogtheta = torch.exp(_dirichlet_expectation(gamma))
    sstats = expElogtheta.T @ (cnts / (expElogtheta @ expElogbeta + _EPS))
    return gamma, sstats


def lda_fit(cnts, k: int, max_iter: int, inner_iter: int, alpha: float,
            eta: float, offset: float, decay: float, em: bool, batch: int,
            seed: int):
    """λ (k, V) on the device of ``cnts``: full-batch EM (ρ = 1) or online
    VB over minibatches of ``batch`` rows drawn with replacement."""
    dt, dev = cnts.dtype, cnts.device
    n, vocab = cnts.shape
    wide = dt == torch.float64
    keys = prng.split(prng.PRNGKey(seed, dev))
    key, init = keys[0], keys[1]
    # Hoffman's init: lambda ~ Gamma(100, 1/100), breaks topic symmetry
    lam = prng.gamma(init, 100.0, (k, vocab), dt) / torch.as_tensor(
        100.0, dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    t = torch.arange(max_iter, dtype=dt, device=dev)
    rhos = torch.pow(offset + t + 1.0, torch.as_tensor(-decay, dtype=dt,
                                                       device=dev))
    for i in range(max_iter):
        expElogbeta = torch.exp(_dirichlet_expectation(lam))      # (k, V)
        if em:
            cnts_b, scale, rho = cnts, 1.0, one
        else:
            pair = prng.split(key)
            key = pair[0]
            idx = prng.randint(pair[1], (batch,), 0, n,
                               torch.int64 if wide else torch.int32)
            cnts_b, scale, rho = cnts.index_select(0, idx), n / batch, rhos[i]
        sstats = _e_step(cnts_b, expElogbeta, alpha, inner_iter)[1] \
            * expElogbeta
        lam_hat = eta + scale * sstats
        lam = (one - rho) * lam + rho * lam_hat
    return lam


def lda_bound(cnts, lam, mask, alpha: float, eta: float, inner_iter: int):
    """The variational lower bound (Hoffman's ``approx_bound``), a 0-dim
    tensor on the device of ``cnts``."""
    dt, dev = cnts.dtype, cnts.device
    k, vocab = lam.shape
    Elogbeta = _dirichlet_expectation(lam)                        # (k, V)
    gamma, _ = _e_step(cnts, torch.exp(Elogbeta), alpha, inner_iter)
    Elogtheta = _dirichlet_expectation(gamma)                     # (n, k)
    # token term: Σ_dw n_dw · log Σ_k exp(Elogtheta_dk + Elogbeta_kw), over
    # chunks of rows so that the (rows, k, V) values stay bounded
    n = cnts.shape[0]
    chunk = max(1, min(n, BOUND_CHUNK_VALUES // max(1, k * vocab)))
    token = torch.zeros((), dtype=dt, device=dev)
    for s in range(0, n, chunk):
        c, th = cnts[s:s + chunk], Elogtheta[s:s + chunk]
        m = th[:, :, None] + Elogbeta[None, :, :]                 # (c, k, V)
        mmax = torch.amax(m, dim=1)
        token = token + torch.sum(c * (mmax + torch.log(
            torch.sum(torch.exp(m - mmax[:, None, :]), dim=1) + _EPS)))

    def lg(v):
        return torch.lgamma(torch.as_tensor(v, dtype=dt, device=dev))

    th = (torch.sum((alpha - gamma) * Elogtheta, dim=1)
          + torch.sum(torch.lgamma(gamma), dim=1)
          - torch.lgamma(torch.sum(gamma, dim=1))
          + lg(alpha * k) - k * lg(alpha))
    theta_term = torch.sum(torch.where(mask, th, torch.zeros_like(th)))
    beta_term = (torch.sum((eta - lam) * Elogbeta)
                 + torch.sum(torch.lgamma(lam))
                 - torch.sum(torch.lgamma(torch.sum(lam, dim=1)))
                 + k * (lg(eta * vocab) - vocab * lg(eta)))
    return token + theta_term + beta_term


def _counts(frame: Frame, name: str):
    """The frame's count matrix in the policy's float dtype, the rows the
    mask drops replaced by zeros."""
    cnts = frame._column_values(name).to(float_dtype())
    if cnts.ndim != 2:
        raise ValueError("LDA features must be a vector column of "
                         "term counts (CountVectorizer/HashingTF)")
    return torch.where(frame.mask[:, None], cnts, torch.zeros_like(cnts))


@persistable
class LDA(Estimator):
    """MLlib ``LDA`` surface: ``setK/setMaxIter/setOptimizer/
    setDocConcentration/setTopicConcentration/setSubsamplingRate/
    setLearningOffset/setLearningDecay/setSeed/setFeaturesCol/
    setTopicDistributionCol`` + ``fit(frame)``.

    ``doc_concentration``/``topic_concentration`` accept MLlib's ``auto``
    default (−1 → 1/k). The online optimizer samples fixed-size
    minibatches WITH replacement. ``optimize_doc_concentration`` is not
    supported (alpha stays fixed) and raises if enabled.
    """

    _persist_attrs = ('k', 'max_iter', 'optimizer', 'doc_concentration',
                      'topic_concentration', 'subsampling_rate',
                      'learning_offset', 'learning_decay', 'seed',
                      'inner_iter', 'features_col', 'topic_distribution_col')

    def __init__(self, k: int = 10, max_iter: int = 20,
                 optimizer: str = "online",
                 doc_concentration: float = -1.0,
                 topic_concentration: float = -1.0,
                 subsampling_rate: float = 0.05,
                 learning_offset: float = 1024.0,
                 learning_decay: float = 0.51,
                 optimize_doc_concentration: bool = False,
                 seed: int = 0, inner_iter: int = 50,
                 features_col: str = "features",
                 topic_distribution_col: str = "topicDistribution"):
        if k < 2:
            raise ValueError("k must be >= 2")
        if optimizer not in ("online", "em"):
            raise ValueError(f"optimizer must be online or em, "
                             f"got {optimizer!r}")
        if optimize_doc_concentration:
            raise ValueError(
                "optimize_doc_concentration is not supported: alpha stays "
                "fixed (set doc_concentration explicitly instead)")
        if not (0.0 < subsampling_rate <= 1.0):
            raise ValueError("subsampling_rate must be in (0, 1]")
        self.k = int(k)
        self.max_iter = int(max_iter)
        self.optimizer = optimizer
        self.doc_concentration = float(doc_concentration)
        self.topic_concentration = float(topic_concentration)
        self.subsampling_rate = float(subsampling_rate)
        self.learning_offset = float(learning_offset)
        self.learning_decay = float(learning_decay)
        self.seed = int(seed)
        self.inner_iter = int(inner_iter)
        self.features_col = features_col
        self.topic_distribution_col = topic_distribution_col

    def set_k(self, v):
        if v < 2:
            raise ValueError("k must be >= 2")
        self.k = int(v)
        return self

    setK = set_k

    def set_max_iter(self, v):
        self.max_iter = int(v)
        return self

    setMaxIter = set_max_iter

    def set_optimizer(self, v):
        if v not in ("online", "em"):
            raise ValueError(f"optimizer must be online or em, got {v!r}")
        self.optimizer = v
        return self

    setOptimizer = set_optimizer

    def set_doc_concentration(self, v):
        self.doc_concentration = float(v)
        return self

    setDocConcentration = set_doc_concentration

    def set_topic_concentration(self, v):
        self.topic_concentration = float(v)
        return self

    setTopicConcentration = set_topic_concentration

    def set_subsampling_rate(self, v):
        if not (0.0 < v <= 1.0):
            raise ValueError("subsampling_rate must be in (0, 1]")
        self.subsampling_rate = float(v)
        return self

    setSubsamplingRate = set_subsampling_rate

    def set_learning_offset(self, v):
        self.learning_offset = float(v)
        return self

    setLearningOffset = set_learning_offset

    def set_learning_decay(self, v):
        self.learning_decay = float(v)
        return self

    setLearningDecay = set_learning_decay

    def set_seed(self, v):
        self.seed = int(v)
        return self

    setSeed = set_seed

    def set_features_col(self, v):
        self.features_col = v
        return self

    setFeaturesCol = set_features_col

    def set_topic_distribution_col(self, v):
        self.topic_distribution_col = v
        return self

    setTopicDistributionCol = set_topic_distribution_col

    def _alpha_eta(self):
        alpha = (1.0 / self.k if self.doc_concentration <= 0
                 else self.doc_concentration)
        eta = (1.0 / self.k if self.topic_concentration <= 0
               else self.topic_concentration)
        return float(alpha), float(eta)

    def fit(self, frame: Frame, mesh=None) -> "LDAModel":
        no_mesh(mesh, "LDA")
        cnts = _counts(frame, self.features_col)
        n, vocab = int(cnts.shape[0]), int(cnts.shape[1])
        alpha, eta = self._alpha_eta()
        em = self.optimizer == "em"
        batch = n if em else max(1, int(round(self.subsampling_rate * n)))
        lam = lda_fit(cnts, self.k, self.max_iter, self.inner_iter, alpha,
                      eta, self.learning_offset, self.learning_decay, em,
                      batch, self.seed)
        return LDAModel(topics=lam.cpu().numpy(), params=dict(
            k=self.k, vocab_size=vocab, alpha=alpha, eta=eta,
            optimizer=self.optimizer, inner_iter=self.inner_iter,
            features_col=self.features_col,
            topic_distribution_col=self.topic_distribution_col,
            training_docs=n))


@persistable
class LDAModel(Model):
    """Fitted LDA: ``topicsMatrix`` (V × k, column-normalized topic-word
    expectation, Spark's layout), ``describeTopics``, ``transform`` (adds
    the topic-distribution vector column), ``logLikelihood`` (variational
    lower bound) and ``logPerplexity`` (−bound per token). The topic
    summaries are host numpy on λ, as in the JAX package; the inference
    runs on the frame's device."""

    _persist_attrs = ('topics', '_params')

    def __init__(self, topics: np.ndarray = None, params: dict = None):
        self.topics = np.asarray(topics)       # (k, V) variational lambda
        self._params = dict(params or {})

    @property
    def vocab_size(self):
        return int(self._params["vocab_size"])

    vocabSize = vocab_size

    @property
    def is_distributed(self):
        return False                            # local model semantics

    isDistributed = is_distributed

    @property
    def estimated_doc_concentration(self):
        return np.full(int(self._params["k"]), self._params["alpha"])

    estimatedDocConcentration = estimated_doc_concentration

    def topics_matrix(self) -> np.ndarray:
        """(V, k): topic-word expectation E[beta], column per topic
        (Spark's ``topicsMatrix`` orientation), columns sum to 1."""
        beta = self.topics / self.topics.sum(axis=1, keepdims=True)
        return beta.T

    topicsMatrix = topics_matrix

    def describe_topics(self, max_terms_per_topic: int = 10) -> Frame:
        beta = self.topics / self.topics.sum(axis=1, keepdims=True)
        k = beta.shape[0]
        top = np.argsort(-beta, axis=1)[:, :max_terms_per_topic]
        weights = np.take_along_axis(beta, top, axis=1)
        return Frame({
            "topic": np.arange(k, dtype=np.int64),
            "termIndices": top.astype(np.int64),
            "termWeights": weights,
        }, device="cpu")

    describeTopics = describe_topics

    def _lam(self, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.topics, device=like.device).to(
            like.dtype)

    def transform(self, frame: Frame) -> Frame:
        p = self._params
        cnts = frame._column_values(p["features_col"]).to(float_dtype())
        gamma, _ = _e_step(cnts, torch.exp(_dirichlet_expectation(
            self._lam(cnts))), float(p["alpha"]), int(p["inner_iter"]))
        theta = gamma / torch.sum(gamma, dim=1, keepdim=True)
        return frame.with_column(p["topic_distribution_col"], theta)

    def log_likelihood(self, frame: Frame) -> float:
        p = self._params
        cnts = _counts(frame, p["features_col"])
        return float(lda_bound(cnts, self._lam(cnts), frame.mask,
                               float(p["alpha"]), float(p["eta"]),
                               int(p["inner_iter"])))

    logLikelihood = log_likelihood

    def log_perplexity(self, frame: Frame) -> float:
        p = self._params
        d = frame._column_values(p["features_col"]).to(torch.float64)
        tokens = float(torch.where(frame.mask[:, None], d,
                                   torch.zeros_like(d)).sum())
        if tokens == 0:
            raise ValueError("log_perplexity: no tokens in the dataset")
        return -self.log_likelihood(frame) / tokens

    logPerplexity = log_perplexity
