"""Locality-sensitive hashing of the port (port of
``sparkdq4ml_tpu/models/lsh.py``): ``BucketedRandomProjectionLSH``
(Euclidean) and ``MinHashLSH`` (Jaccard) with their models.

* Hashes are computed on the device of the frame: one matrix product and
  a floor (the divisor a tensor), or one masked minimum over the
  per-index hash values.
* ``approx_nearest_neighbors`` picks the candidates (rows sharing a bucket
  with the key in any table, or every valid row when fewer than k do),
  computes their distances and takes a stable top-k on the device, and
  reads the k chosen rows once.
* ``approx_similarity_join`` plans each table's candidate pairs on the
  host with the port's numeric join plan (``frame/frame.py:_join_plan``,
  the JAX package's ``_vector_join_plan``), dedupes them across tables
  with one sort, and computes the exact distances on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import float_dtype
from ..frame.frame import Frame, _join_plan
from .base import Estimator, Model, feature_matrix, host_fetch, persistable

_MINHASH_PRIME = 2038074743  # MLlib's MinHashLSH prime


class _LSHParams:
    @staticmethod
    def _check_tables(v):
        if v < 1:
            raise ValueError("num_hash_tables must be >= 1")
        return int(v)

    def set_input_col(self, v):
        self.input_col = v
        return self

    def set_output_col(self, v):
        self.output_col = v
        return self

    def set_num_hash_tables(self, v):
        self.num_hash_tables = self._check_tables(v)
        return self

    def set_seed(self, v):
        self.seed = int(v)
        return self

    setInputCol = set_input_col
    setOutputCol = set_output_col
    setNumHashTables = set_num_hash_tables
    setSeed = set_seed


class _LSHModelBase(Model):
    """Shared approxNearestNeighbors / approxSimilarityJoin on top of a
    subclass-provided ``_hashes(X) -> (n, L) int32`` and
    ``_distance_rows(A, B) -> (n,)``."""

    def _validate(self, X, mask=None):
        """Subclass hook: reject inputs the hash family is undefined on."""

    def transform(self, frame):
        # hash ids stay int32: a float32 column would quantize MinHash's
        # ids of up to 2^31 (resolution 128 above 2^24)
        X = feature_matrix(frame, self.input_col)
        self._validate(X, frame.mask)
        return frame.with_column(self.output_col, self._hashes(X))

    def approx_nearest_neighbors(self, frame, key, num_neighbors: int,
                                 dist_col: str = "distCol"):
        """Top-k rows of ``frame`` nearest to vector ``key`` among
        candidates sharing ≥1 hash bucket (all valid rows when fewer than
        k share one: deterministic beats partial); ties by row order."""
        X = feature_matrix(frame, self.input_col)
        keyv = torch.as_tensor(np.atleast_1d(np.asarray(key, np.float64)),
                               device=X.device).to(X.dtype)
        valid = frame.mask
        self._validate(X, valid)
        self._validate(keyv[None, :])
        hit = (self._hashes(X) == self._hashes(keyv[None, :])).any(dim=1)
        cand = hit & valid
        counts = host_fetch(torch.stack([cand.sum(), valid.sum()])).tolist()
        if counts[0] < num_neighbors:
            cand, counts[0] = valid, counts[1]
        d = self._distance_rows(X, keyv[None, :])
        inf = torch.full((), float("inf"), dtype=d.dtype, device=d.device)
        order = torch.sort(torch.where(cand, d, inf), stable=True).indices
        k = min(num_neighbors, counts[0])
        keep = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
        keep[order[:k]] = True
        dist = torch.where(cand, d, torch.full_like(d, float("nan")))
        return frame.filter(keep).with_column(dist_col,
                                              dist.to(float_dtype()))

    approxNearestNeighbors = approx_nearest_neighbors

    def approx_similarity_join(self, frame_a, frame_b, threshold: float,
                               dist_col: str = "distCol"):
        """All (a, b) pairs with distance ≤ threshold among candidates
        sharing a hash bucket in ANY table: ``idA``/``idB`` (positions
        among each frame's valid rows) + the distance column. One host
        read of the hashes a frame; the distances on the device."""
        Xa = feature_matrix(frame_a, self.input_col)
        Xb = feature_matrix(frame_b, self.input_col)
        self._validate(Xa, frame_a.mask)
        self._validate(Xb, frame_b.mask)
        ha = self._hashes(Xa)[frame_a.mask].to(torch.int64).cpu().numpy()
        hb = self._hashes(Xb)[frame_b.mask].to(torch.int64).cpu().numpy()
        dev = Xa.device
        # plan over COMPACT positions (0..n_valid-1): idA/idB then index
        # the frames' valid rows directly (the to_pydict() order)
        pos_a = np.arange(ha.shape[0])
        pos_b = np.arange(hb.shape[0])
        lps, rps = [], []
        for t in range(ha.shape[1]):
            lp, rp = _join_plan([ha[:, t]], [hb[:, t]], pos_a, pos_b,
                                "inner")
            lps.append(lp)
            rps.append(rp)
        lp = np.concatenate(lps) if lps else np.zeros((0,), np.int64)
        rp = np.concatenate(rps) if rps else np.zeros((0,), np.int64)
        if lp.size == 0:
            return Frame({"idA": np.zeros((0,), np.int64),
                          "idB": np.zeros((0,), np.int64),
                          dist_col: np.zeros((0,), np.float64)}, device=dev)
        # dedupe across tables in one sorted pass (np.unique would be the
        # same set; some numpy versions take a hash path many times slower)
        nb = int(rp.max()) + 1
        uniq = np.sort(lp * np.int64(nb) + rp)
        uniq = uniq[np.concatenate([[True], uniq[1:] != uniq[:-1]])]
        pa, pb = uniq // nb, uniq % nb
        A = Xa[frame_a.mask].index_select(0, torch.as_tensor(pa, device=dev))
        B = Xb[frame_b.mask].index_select(0, torch.as_tensor(pb, device=dev))
        d = self._distance_rows(A, B)
        keep = d <= threshold
        host = host_fetch(torch.stack([d.to(torch.float64),
                                       keep.to(torch.float64)]))
        sel = host[1] > 0
        return Frame({"idA": pa[sel].astype(np.int64),
                      "idB": pb[sel].astype(np.int64),
                      dist_col: host[0][sel]}, device=dev)

    approxSimilarityJoin = approx_similarity_join


# ---------------------------------------------------------------------------
# BucketedRandomProjectionLSH (Euclidean)
# ---------------------------------------------------------------------------

@persistable
class BucketedRandomProjectionLSH(Estimator, _LSHParams):
    """Euclidean-distance LSH: ``h_l(x) = floor(x·w_l / bucketLength)`` for
    ``num_hash_tables`` Gaussian unit directions ``w_l`` (numpy's draw)."""

    _persist_attrs = ('bucket_length', 'num_hash_tables', 'seed',
                      'input_col', 'output_col')

    def __init__(self, bucket_length: float = None,
                 num_hash_tables: int = 1, seed: int = 0,
                 input_col: str = "features", output_col: str = "hashes"):
        if bucket_length is not None and bucket_length <= 0:
            raise ValueError("bucket_length must be > 0")
        self.bucket_length = bucket_length
        self.num_hash_tables = self._check_tables(num_hash_tables)
        self.seed = int(seed)
        self.input_col = input_col
        self.output_col = output_col

    def set_bucket_length(self, v):
        if v <= 0:
            raise ValueError("bucket_length must be > 0")
        self.bucket_length = float(v)
        return self

    setBucketLength = set_bucket_length

    def fit(self, frame) -> "BucketedRandomProjectionLSHModel":
        if self.bucket_length is None:
            raise ValueError("bucket_length must be set")
        d = feature_matrix(frame, self.input_col).shape[1]
        rng = np.random.default_rng(self.seed)
        W = rng.normal(size=(d, self.num_hash_tables))
        W /= np.linalg.norm(W, axis=0, keepdims=True)   # unit directions
        return BucketedRandomProjectionLSHModel(
            W.astype(np.float64), float(self.bucket_length),
            self.input_col, self.output_col)


@persistable
class BucketedRandomProjectionLSHModel(_LSHModelBase):
    _persist_attrs = ('projections', 'bucket_length', 'input_col',
                      'output_col')

    def __init__(self, projections, bucket_length, input_col="features",
                 output_col="hashes"):
        self.projections = np.asarray(projections)
        self.bucket_length = float(bucket_length)
        self.input_col = input_col
        self.output_col = output_col

    def _hashes(self, X):
        W = torch.as_tensor(self.projections, device=X.device).to(X.dtype)
        length = torch.as_tensor(self.bucket_length, dtype=X.dtype,
                                 device=X.device)
        return torch.floor((X @ W) / length).to(torch.int32)

    def _distance_rows(self, A, B):
        return torch.sqrt(torch.sum((A - B) ** 2, dim=1))


# ---------------------------------------------------------------------------
# MinHashLSH (Jaccard, binary vectors)
# ---------------------------------------------------------------------------

@persistable
class MinHashLSH(Estimator, _LSHParams):
    """Jaccard-distance LSH over binary vectors:
    ``h_l(x) = min over nonzero j of ((a_l·(j+1) + b_l) mod prime)``
    (MLlib's 1-indexed perfect-hash family)."""

    _persist_attrs = ('num_hash_tables', 'seed', 'input_col', 'output_col')

    def __init__(self, num_hash_tables: int = 1, seed: int = 0,
                 input_col: str = "features", output_col: str = "hashes"):
        self.num_hash_tables = self._check_tables(num_hash_tables)
        self.seed = int(seed)
        self.input_col = input_col
        self.output_col = output_col

    def fit(self, frame) -> "MinHashLSHModel":
        X = feature_matrix(frame, self.input_col)
        valid = frame.mask[:, None]
        bad = torch.stack([(((X != 0) & (X != 1)) & valid).sum(),
                           ((X.sum(dim=1) == 0) & frame.mask).sum()])
        bad = bad.cpu().tolist()
        if bad[0]:
            raise ValueError("MinHashLSH requires binary 0/1 vectors")
        if bad[1]:
            raise ValueError("MinHashLSH: every valid vector needs at "
                             "least one nonzero entry")
        rng = np.random.default_rng(self.seed)
        a = rng.integers(1, _MINHASH_PRIME, size=self.num_hash_tables)
        b = rng.integers(0, _MINHASH_PRIME, size=self.num_hash_tables)
        return MinHashLSHModel(a.astype(np.int64), b.astype(np.int64),
                               self.input_col, self.output_col)


@persistable
class MinHashLSHModel(_LSHModelBase):
    _persist_attrs = ('coeff_a', 'coeff_b', 'input_col', 'output_col')

    def __init__(self, coeff_a, coeff_b, input_col="features",
                 output_col="hashes"):
        self.coeff_a = np.asarray(coeff_a, np.int64)
        self.coeff_b = np.asarray(coeff_b, np.int64)
        self.input_col = input_col
        self.output_col = output_col

    def _validate(self, X, mask=None):
        """MinHash of the empty set is undefined (MLlib raises too): an
        all-zero vector would hash to the sentinel in every table and
        collide with every other empty vector."""
        empty = ~(X.sum(dim=1) > 0)
        if mask is not None:
            empty = empty & mask
        if bool(empty.any()):
            raise ValueError("MinHashLSH: vectors must have at least one "
                             "nonzero entry")

    def _hashes(self, X):
        d = X.shape[1]
        j = np.arange(1, d + 1, dtype=np.int64)            # 1-indexed
        hv = (self.coeff_a[:, None] * j[None, :]
              + self.coeff_b[:, None]) % _MINHASH_PRIME     # (L, d)
        # int32 masked min: float32 would collapse ids above 2^24
        hvd = torch.as_tensor(hv.astype(np.int32), device=X.device)
        big = torch.tensor(_MINHASH_PRIME, dtype=torch.int32,
                           device=X.device)
        masked = torch.where(X[:, None, :] > 0, hvd[None, :, :], big)
        return torch.amin(masked, dim=2)                   # (n, L) int32

    def _distance_rows(self, A, B):
        inter = torch.sum((A > 0) & (B > 0), dim=1)
        union = torch.sum((A > 0) | (B > 0), dim=1)
        one = torch.ones((), dtype=float_dtype(), device=A.device)
        return one - inter.to(one.dtype) / torch.clamp(union, min=1).to(
            one.dtype)
