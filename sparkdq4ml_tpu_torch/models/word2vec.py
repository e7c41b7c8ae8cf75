"""Word2Vec of the port (port of ``sparkdq4ml_tpu/models/word2vec.py``,
single device): skip-gram with negative sampling (SGNS), the JAX
package's objective and schedule.

* The vocabulary (count descending, ties by the token), the skip-gram
  pairs (a per-center window drawn from numpy's generator, documents cut
  at ``max_sentence_length`` in-vocabulary tokens) and the shuffle of the
  pairs into ``(steps, batch)`` minibatches are host steps, as in the JAX
  package, and draw the same numbers from the same generators; the pairs
  are built with numpy from the per-document windows.
* The SGD steps run on the device of the frame, a Python loop with no
  host read inside. Each step's negatives are ``searchsorted`` of JAX's
  uniforms (``fold_in`` of the seed's key with the step, from
  ``utils/prng.py``, drawn for many steps at once on the device) into the
  unigram^0.75 CDF, in the policy's float dtype as JAX draws them (float32
  with x64 off, float64 with it on). The updates of both tables are two
  fixed-order segment sums onto ``vocab_size`` slots (``_seg_sum``), the
  full step size a pair, as in the JAX package.
* ``transform`` averages each document's word vectors: one sorted segment
  sum over the token rows, already in document order. ``find_synonyms``
  is one cosine matrix-vector product and a stable descending sort, so
  ties go to the lower index, as ``jax.lax.top_k`` breaks them.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from ..config import float_dtype, numpy_dtype
from ..frame.frame import Frame
from ..ops.segments import _seg_sum
from ..utils import prng
from .base import Estimator, Model, no_mesh, persistable
from .text import _token_col

# Negative draws made at once on the device: this many uniforms at most.
NEGATIVE_CHUNK = 1 << 24


def _build_vocab(col, mask, min_count: int, max_vocab: int):
    """Host pass: vocabulary (count-desc, ties by the token) + counts."""
    docs = [t for t, m in zip(col, mask) if m and t is not None and len(t)]
    counts = Counter(str(t) for toks in docs for t in toks)
    kept = sorted(((-c, t) for t, c in counts.items() if c >= min_count))
    kept = kept[:max_vocab]
    return ([t for _, t in kept],
            np.asarray([-c for c, _ in kept], np.int64), docs)


def _build_pairs(docs, index: dict, window: int, seed: int,
                 max_sentence_length: int = 1000):
    """Host pass: all (center, context) skip-gram pairs, centers in order
    and each center's contexts left to right, with word2vec's window size
    drawn uniformly from 1..window per center (one draw a chunk, in the
    JAX package's order). Documents longer than ``max_sentence_length``
    in-vocabulary tokens are cut first (MLlib's maxSentenceLength), so no
    window spans a cut."""
    rng = np.random.default_rng(seed)
    ids, wins, offs, lens = [], [], [], []
    total = 0
    for toks in docs:
        all_ids = [index[t] for t in toks if t in index]
        for s in range(0, len(all_ids), max_sentence_length):
            chunk = all_ids[s: s + max_sentence_length]
            L = len(chunk)
            if L < 2:
                continue
            wins.append(rng.integers(1, window + 1, size=L))
            ids.append(chunk)
            offs.append(total)
            lens.append(L)
            total += L
    if not ids:
        return np.zeros((0,), np.int32), np.zeros((0,), np.int32)
    flat = np.fromiter((i for chunk in ids for i in chunk), np.int64, total)
    win = np.concatenate(wins)
    L = np.repeat(np.asarray(lens, np.int64), lens)
    start = np.repeat(np.asarray(offs, np.int64), lens)
    pos = np.arange(total, dtype=np.int64) - start          # index in chunk
    lo = np.maximum(0, pos - win)
    hi = np.minimum(L, pos + win + 1)
    count = hi - lo - 1
    first = np.cumsum(count) - count
    within = np.arange(int(count.sum()), dtype=np.int64) - np.repeat(first,
                                                                     count)
    j = np.repeat(lo, count) + within
    j += j >= np.repeat(pos, count)                         # skip the center
    centers = np.repeat(flat, count)
    contexts = flat[np.repeat(start, count) + j]
    return centers.astype(np.int32), contexts.astype(np.int32)


def step_negatives(noise_cdf, seed: int, s0: int, s1: int, batch: int,
                   negatives: int, uniform_dtype) -> torch.Tensor:
    """The negatives of steps ``s0 .. s1 - 1``, (steps, batch, negatives)
    on the device of ``noise_cdf``: ``searchsorted`` of the uniforms of
    ``fold_in(PRNGKey(seed), step)`` into the CDF (an id of ``vocab_size``
    where a uniform passes the CDF's last value)."""
    dev = noise_cdf.device
    keys = prng.fold_in(prng.PRNGKey(seed, dev),
                        torch.arange(s0, s1, device=dev))
    u = prng.uniform(keys, (batch, negatives), uniform_dtype)
    return torch.searchsorted(noise_cdf, u.reshape(s1 - s0, -1)).reshape(
        u.shape)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def sgns_train(c_mat, o_mat, noise_cdf, seed: int, U0, V0, lr0: float,
               negatives: int, uniform_dtype):
    """The SGD steps on the device of ``U0``: ``c_mat``/``o_mat`` the
    (steps, batch) center and context ids; returns (U, V, loss history).
    The step's negatives come from ``fold_in(PRNGKey(seed), step)``."""
    dev, dt = U0.device, U0.dtype
    steps, B = c_mat.shape
    vocab, dim = U0.shape
    idt = numpy_dtype(dt).type
    i = np.arange(steps, dtype=idt)
    lrs = torch.as_tensor(idt(lr0) * np.maximum(
        idt(1.0) - i / idt(steps), idt(1e-2)), device=dev)
    chunk = max(1, NEGATIVE_CHUNK // (B * negatives))
    U, V = U0, V0
    losses = []
    for s0 in range(0, steps, chunk):
        s1 = min(steps, s0 + chunk)
        neg_all = step_negatives(noise_cdf, seed, s0, s1, B, negatives,
                                 uniform_dtype)
        for s in range(s0, s1):
            c_ids, o_ids = c_mat[s], o_mat[s]
            neg = neg_all[s - s0]
            u_c = U.index_select(0, c_ids)                  # (B, dim)
            v_pos = V.index_select(0, o_ids)
            # a gather clamps an id past the table, as XLA's does; the
            # segment sum drops it, as XLA's scatter does
            v_neg = V.index_select(0, torch.clamp(neg, max=vocab - 1)
                                   .reshape(-1)).reshape(B, negatives, dim)
            pos_logit = torch.sum(u_c * v_pos, dim=1)
            neg_logit = torch.einsum("bd,bkd->bk", u_c, v_neg)
            loss = (torch.mean(_softplus(-pos_logit))
                    + torch.mean(torch.sum(_softplus(neg_logit), dim=1)))
            g_pos = torch.sigmoid(pos_logit) - 1.0
            g_neg = torch.sigmoid(neg_logit)
            gu = g_pos[:, None] * v_pos + torch.einsum("bk,bkd->bd", g_neg,
                                                       v_neg)
            gv_pos = g_pos[:, None] * u_c
            gv_neg = g_neg[:, :, None] * u_c[:, None, :]
            dU = _seg_sum(gu, c_ids, vocab)
            dV = _seg_sum(torch.cat([gv_pos, gv_neg.reshape(-1, dim)]),
                          torch.cat([o_ids, neg.reshape(-1)]), vocab)
            lr = lrs[s]
            U = U - lr * dU
            V = V - lr * dV
            losses.append(loss)
    return U, V, torch.stack(losses)


@persistable
class Word2Vec(Estimator):
    """MLlib ``Word2Vec`` setter surface: setVectorSize/setWindowSize/
    setMinCount/setMaxIter/setStepSize/setSeed/setMaxSentenceLength(+cols);
    plus ``num_negatives`` for the SGNS objective (see module docstring)."""

    _persist_attrs = ('vector_size', 'window_size', 'min_count', 'max_iter',
                      'step_size', 'num_negatives', 'batch_size',
                      'max_vocab_size', 'max_sentence_length', 'seed',
                      'input_col', 'output_col')

    def __init__(self, vector_size: int = 100, window_size: int = 5,
                 min_count: int = 5, max_iter: int = 1,
                 step_size: float = 0.025, num_negatives: int = 5,
                 batch_size: int = 1024, max_vocab_size: int = 262144,
                 max_sentence_length: int = 1000, seed: int = 0,
                 input_col: str = None, output_col: str = None):
        if vector_size < 1:
            raise ValueError("vector_size must be >= 1")
        if window_size < 1:
            raise ValueError("window_size must be >= 1")
        if max_sentence_length < 2:
            raise ValueError("max_sentence_length must be >= 2")
        self.vector_size = int(vector_size)
        self.window_size = int(window_size)
        self.min_count = int(min_count)
        self.max_iter = int(max_iter)
        self.step_size = float(step_size)
        self.num_negatives = int(num_negatives)
        self.batch_size = int(batch_size)
        self.max_vocab_size = int(max_vocab_size)
        self.max_sentence_length = int(max_sentence_length)
        self.seed = int(seed)
        self.input_col = input_col
        self.output_col = output_col

    def set_max_sentence_length(self, v):
        if v < 2:
            raise ValueError("max_sentence_length must be >= 2")
        self.max_sentence_length = int(v)
        return self

    setMaxSentenceLength = set_max_sentence_length

    def set_vector_size(self, v):
        if v < 1:
            raise ValueError("vector_size must be >= 1")
        self.vector_size = int(v)
        return self

    def set_window_size(self, v):
        if v < 1:
            raise ValueError("window_size must be >= 1")
        self.window_size = int(v)
        return self

    def set_min_count(self, v):
        self.min_count = int(v)
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

    def set_input_col(self, v):
        self.input_col = v
        return self

    def set_output_col(self, v):
        self.output_col = v
        return self

    setVectorSize = set_vector_size
    setWindowSize = set_window_size
    setMinCount = set_min_count
    setMaxIter = set_max_iter
    setStepSize = set_step_size
    setSeed = set_seed
    setInputCol = set_input_col
    setOutputCol = set_output_col

    def fit(self, frame: Frame, mesh=None) -> "Word2VecModel":
        no_mesh(mesh, "Word2Vec")
        dt = float_dtype()
        ndt = numpy_dtype(dt)
        dev = frame.device
        col = _token_col(frame, self.input_col)
        mask = frame.mask.cpu().numpy()
        vocab, counts, docs = _build_vocab(col, mask, self.min_count,
                                           self.max_vocab_size)
        if not vocab:
            raise ValueError("Word2Vec: no tokens meet min_count in valid "
                             "rows")
        index = {t: i for i, t in enumerate(vocab)}
        centers, contexts = _build_pairs(docs, index, self.window_size,
                                         self.seed,
                                         self.max_sentence_length)
        V = len(vocab)
        dim = self.vector_size
        rng = np.random.default_rng(self.seed)

        if centers.size == 0:   # single-token docs only: random init model
            U = (rng.random((V, dim)) - 0.5) / dim
            return Word2VecModel(vocab, U.astype(ndt), self._params_dict(),
                                 device=dev)

        # unigram^0.75 negative-sampling table as a CDF (word2vec standard)
        p = counts.astype(np.float64) ** 0.75
        noise_cdf = np.cumsum(p / p.sum()).astype(ndt)

        B = max(1, self.batch_size)
        n_pairs = centers.size
        steps = max(1, -(-n_pairs // B)) * max(1, self.max_iter)
        # shuffle + tile pairs into (steps, B) minibatch matrices
        perm = rng.permutation(n_pairs)
        idx = np.resize(perm, steps * B)
        c_mat = torch.as_tensor(centers[idx].reshape(steps, B).astype(
            np.int64), device=dev)
        o_mat = torch.as_tensor(contexts[idx].reshape(steps, B).astype(
            np.int64), device=dev)
        U0 = torch.as_tensor(((rng.random((V, dim)) - 0.5) / dim).astype(
            ndt), device=dev)
        V0 = torch.zeros((V, dim), dtype=dt, device=dev)
        U, _, losses = sgns_train(c_mat, o_mat,
                                  torch.as_tensor(noise_cdf, device=dev),
                                  self.seed, U0, V0, self.step_size,
                                  self.num_negatives, dt)
        flat = torch.cat([U.reshape(-1), losses.to(dt)]).cpu().numpy()
        return Word2VecModel(vocab, flat[:V * dim].reshape(V, dim),
                             self._params_dict(),
                             flat[V * dim:].astype(np.float64).tolist(),
                             device=dev)

    def _params_dict(self):
        return {k: getattr(self, k) for k in self._persist_attrs}


@persistable
class Word2VecModel(Model):
    """Word vectors + the MLlib surface: ``transform`` (per-document mean
    vector), ``getVectors`` (word → vector frame), ``findSynonyms``
    (cosine top-k). The model computes on the device its fit ran on (the
    CPU once loaded, or for a transform, the frame's)."""

    _persist_attrs = ('vocabulary', 'vectors', '_params', 'loss_history')

    def __init__(self, vocabulary, vectors, params=None, loss_history=None,
                 device=None):
        self.vocabulary = list(vocabulary)
        self.vectors = np.asarray(vectors)
        self._params = dict(params or {})
        self.loss_history = list(loss_history or [])
        self._device = torch.device(device or "cpu")
        self._build_index()

    def _post_load(self):
        self.vocabulary = list(self.vocabulary)
        self._device = torch.device("cpu")
        self._build_index()

    def _build_index(self):
        self._index = {t: i for i, t in enumerate(self.vocabulary)}

    def _p(self, k, default=None):
        return self._params.get(k, default)

    def _table(self, device) -> torch.Tensor:
        return torch.as_tensor(self.vectors, device=device).to(float_dtype())

    @property
    def vector_size(self):
        return int(self.vectors.shape[1])

    def getVectorSize(self):     # PySpark surface: a METHOD, not an attr
        return self.vector_size

    def get_vectors(self):
        return Frame({"word": np.asarray(self.vocabulary, object),
                      "vector": self._table(self._device)})

    getVectors = get_vectors

    def transform(self, frame):
        """Per-document mean of the word vectors (MLlib semantics); docs
        with no in-vocabulary token map to the zero vector. The token rows
        (document ids ascending) are gathered and summed on the frame's
        device by one sorted segment sum."""
        col = _token_col(frame, self._p("input_col"))
        n = len(col)
        dev = frame.device
        get = self._index.get
        hits = [[j for j in map(get, toks) if j is not None]
                if toks is not None else [] for toks in col]
        lens = np.fromiter(map(len, hits), np.int64, n)
        word_ids = np.fromiter((j for h in hits for j in h), np.int64,
                               int(lens.sum()))
        W = self._table(dev)
        if word_ids.size == 0:
            M = torch.zeros((n, self.vector_size), dtype=W.dtype, device=dev)
        else:
            doc_ids = torch.as_tensor(np.repeat(np.arange(n), lens),
                                      device=dev)
            sums = _seg_sum(W.index_select(0, torch.as_tensor(
                word_ids, device=dev)), doc_ids, n, contiguous=True)
            cnt = torch.as_tensor(lens, device=dev).to(W.dtype)
            M = sums / torch.clamp(cnt, min=1.0)[:, None]
        return frame.with_column(self._p("output_col"), M)

    def find_synonyms(self, word: str, num: int):
        """Top ``num`` nearest words by cosine similarity, as a Frame
        (word, similarity) — excludes the query word itself."""
        j = self._index.get(word)
        if j is None:
            raise ValueError(f"word {word!r} not in vocabulary")
        W = self._table(self._device)
        norms = torch.clamp(torch.linalg.vector_norm(W, dim=1), min=1e-12)
        sims = (W @ W[j]) / (norms * norms[j])
        sims[j] = float("-inf")
        k = min(num, len(self.vocabulary) - 1)
        top = torch.sort(sims, descending=True, stable=True)
        host = torch.stack([top.values[:k].to(torch.float64),
                            top.indices[:k].to(torch.float64)]).cpu().numpy()
        return Frame({
            "word": np.asarray([self.vocabulary[int(i)] for i in host[1]],
                               object),
            "similarity": host[0]}, device=self._device)

    findSynonyms = find_synonyms
