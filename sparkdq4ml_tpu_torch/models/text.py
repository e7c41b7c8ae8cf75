"""The text feature pipeline of the port (port of
``sparkdq4ml_tpu/models/text.py``): Tokenizer, RegexTokenizer,
StopWordsRemover and NGram on host token columns, HashingTF,
CountVectorizer/CountVectorizerModel and IDF/IDFModel, with persistence in
the JAX package's format; and the helpers the pattern miners, Word2Vec and
FeatureHasher take (``_obj_array``, ``_token_col``, ``_stable_hash``).

Token columns are host object arrays of string lists, as in the JAX
package. Where text becomes counts, the host maps each token to an integer
in one dictionary pass over the flattened corpus (in place of the JAX
package's ``np.unique``, which sorts every token; HashingTF hashes each
distinct token once), and the device counts: one integer ``bincount`` over (document, column) pairs for
HashingTF and CountVectorizerModel, one ``torch.unique`` of those pairs for
CountVectorizer's document frequencies. Counts stay integers until the
last step, which casts them to the float policy; IDF's document
frequencies and its ``n`` are integer sums over the valid rows.

HashingTF's bucket is the first 8 bytes of the token's md5, little-endian,
modulo ``num_features`` (the JAX package's hash, not Spark's murmur3: the
same semantics, other buckets). CountVectorizer's vocabulary is ordered by
(−document frequency, token), the tokens compared by code point as numpy
compares them.
"""

from __future__ import annotations

import hashlib
import re
from itertools import chain
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import float_dtype
from ..ops.cells import list_column as _obj_array
from .base import Estimator, Model, Transformer, persistable

# Spark's english default list (abridged to the common core, as in the JAX
# package; users can pass their own)
_ENGLISH_STOP_WORDS = [
    "a", "about", "above", "after", "again", "against", "all", "am", "an",
    "and", "any", "are", "as", "at", "be", "because", "been", "before",
    "being", "below", "between", "both", "but", "by", "could", "did", "do",
    "does", "doing", "down", "during", "each", "few", "for", "from",
    "further", "had", "has", "have", "having", "he", "her", "here", "hers",
    "herself", "him", "himself", "his", "how", "i", "if", "in", "into",
    "is", "it", "its", "itself", "me", "more", "most", "my", "myself",
    "no", "nor", "not", "of", "off", "on", "once", "only", "or", "other",
    "ought", "our", "ours", "ourselves", "out", "over", "own", "same",
    "she", "should", "so", "some", "such", "than", "that", "the", "their",
    "theirs", "them", "themselves", "then", "there", "these", "they",
    "this", "those", "through", "to", "too", "under", "until", "up",
    "very", "was", "we", "were", "what", "when", "where", "which", "while",
    "who", "whom", "why", "with", "would", "you", "your", "yours",
    "yourself", "yourselves"]


def _token_col(frame, name):
    """The host object column ``name`` of token lists; raises for any
    other column."""
    col = frame._column_values(name)
    if not (isinstance(col, np.ndarray) and col.dtype == object):
        raise ValueError(f"column {name!r} must be a string/token column")
    return col


def _stable_hash(token: str, mod: int) -> int:
    """A process-stable bucket of ``token`` in ``[0, mod)``: the first 8
    bytes of its md5, little-endian (the JAX package's hash)."""
    return int.from_bytes(hashlib.md5(token.encode()).digest()[:8],
                          "little") % mod


def _flatten(docs) -> tuple[np.ndarray, list]:
    """(tokens a document, the tokens of every document in order); a
    ``None`` document holds no token."""
    lens = np.fromiter((0 if t is None else len(t) for t in docs),
                       np.int64, count=len(docs))
    return lens, list(chain.from_iterable(t for t in docs if t is not None))


def _count_matrix(lens: np.ndarray, cols: np.ndarray, width: int,
                  device, hit: Optional[np.ndarray] = None) -> torch.Tensor:
    """The (documents, ``width``) int64 matrix of how often each column
    occurs in each document: ``cols`` one column a token, documents of
    ``lens`` tokens in order, and ``hit`` the tokens that count (all by
    default). One ``bincount`` on ``device``."""
    n = len(lens)
    doc = torch.repeat_interleave(
        torch.arange(n, device=device), torch.as_tensor(lens, device=device))
    col = torch.as_tensor(cols, device=device)
    if hit is not None:
        keep = torch.as_tensor(hit, device=device)
        doc, col = doc[keep], col[keep]
    return torch.bincount(doc * width + col, minlength=n * width).reshape(
        n, width)


@persistable
class Tokenizer(Transformer):
    """MLlib ``Tokenizer``: lowercase + split on whitespace."""

    _persist_attrs = ('input_col', 'output_col')

    def __init__(self, input_col: str = None, output_col: str = None):
        self.input_col = input_col
        self.output_col = output_col

    def set_input_col(self, v):
        self.input_col = v
        return self

    setInputCol = set_input_col

    def set_output_col(self, v):
        self.output_col = v
        return self

    setOutputCol = set_output_col

    def transform(self, frame):
        col = _token_col(frame, self.input_col)
        out = _obj_array(
            [None if s is None else str(s).lower().split() for s in col])
        return frame.with_column(self.output_col, out)


@persistable
class RegexTokenizer(Tokenizer):
    """MLlib ``RegexTokenizer``: split by ``pattern`` (gaps=True, default
    ``\\s+``) or match tokens (gaps=False); optional lowercase,
    ``min_token_length`` filter."""

    _persist_attrs = ('input_col', 'output_col', 'pattern', 'gaps',
                      'to_lowercase', 'min_token_length')

    def __init__(self, input_col: str = None, output_col: str = None,
                 pattern: str = r"\s+", gaps: bool = True,
                 to_lowercase: bool = True, min_token_length: int = 1):
        super().__init__(input_col, output_col)
        self.pattern = pattern
        self.gaps = gaps
        self.to_lowercase = to_lowercase
        self.min_token_length = int(min_token_length)

    def set_pattern(self, v):
        self.pattern = v
        return self

    setPattern = set_pattern

    def transform(self, frame):
        col = _token_col(frame, self.input_col)
        rx = re.compile(self.pattern)
        cut = rx.split if self.gaps else rx.findall
        low, least = self.to_lowercase, self.min_token_length

        def tok(s):
            if s is None:
                return None
            return [t for t in cut(s.lower() if low else s)
                    if len(t) >= least]

        return frame.with_column(self.output_col,
                                 _obj_array([tok(s) for s in col]))


@persistable
class StopWordsRemover(Transformer):
    """MLlib ``StopWordsRemover``: drop stop words from a token column
    (case-insensitive by default: a token matches when its lowercase is a
    lowercased stop word)."""

    _persist_attrs = ('input_col', 'output_col', 'stop_words',
                      'case_sensitive')

    def __init__(self, input_col: str = None, output_col: str = None,
                 stop_words: Optional[Sequence[str]] = None,
                 case_sensitive: bool = False):
        self.input_col = input_col
        self.output_col = output_col
        self.stop_words = list(stop_words) if stop_words is not None \
            else list(_ENGLISH_STOP_WORDS)
        self.case_sensitive = case_sensitive

    @staticmethod
    def load_default_stop_words(language: str = "english"):
        if language != "english":
            raise ValueError("only the english default list ships here")
        return list(_ENGLISH_STOP_WORDS)

    loadDefaultStopWords = load_default_stop_words

    def set_stop_words(self, v):
        self.stop_words = list(v)
        return self

    setStopWords = set_stop_words

    def transform(self, frame):
        col = _token_col(frame, self.input_col)
        if self.case_sensitive:
            stop = set(self.stop_words)

            def keep(toks):
                return [t for t in toks if t not in stop]
        else:
            stop = {w.lower() for w in self.stop_words}

            def keep(toks):
                return [t for t in toks if t.lower() not in stop]

        out = _obj_array([None if toks is None else keep(toks)
                          for toks in col])
        return frame.with_column(self.output_col, out)


@persistable
class NGram(Transformer):
    """MLlib ``NGram``: sliding n-grams (space-joined) over a token column."""

    _persist_attrs = ('input_col', 'output_col', 'n')

    def __init__(self, n: int = 2, input_col: str = None,
                 output_col: str = None):
        if n < 1:
            raise ValueError("n must be >= 1")
        self.n = int(n)
        self.input_col = input_col
        self.output_col = output_col

    def set_n(self, v):
        if v < 1:
            raise ValueError("n must be >= 1")
        self.n = int(v)
        return self

    setN = set_n

    def transform(self, frame):
        col = _token_col(frame, self.input_col)
        n = self.n
        out = _obj_array(
            [None if toks is None else
             [" ".join(toks[i:i + n]) for i in range(len(toks) - n + 1)]
             for toks in col])
        return frame.with_column(self.output_col, out)


@persistable
class HashingTF(Transformer):
    """MLlib ``HashingTF``: hashed term-frequency vectors of a fixed
    dimension, as a dense (documents, ``num_features``) matrix on the
    frame's device (hence the default 1024, not Spark's sparse 2^18). Each
    distinct token is hashed once on the host; the counts are one integer
    ``bincount`` on the device, cast to the float policy last."""

    _persist_attrs = ('num_features', 'input_col', 'output_col', 'binary')

    def __init__(self, num_features: int = 1024, input_col: str = None,
                 output_col: str = None, binary: bool = False):
        if num_features < 1:
            raise ValueError("num_features must be >= 1")
        self.num_features = int(num_features)
        self.input_col = input_col
        self.output_col = output_col
        self.binary = binary

    def set_num_features(self, v):
        if v < 1:
            raise ValueError("num_features must be >= 1")
        self.num_features = int(v)
        return self

    setNumFeatures = set_num_features

    def set_binary(self, v):
        self.binary = bool(v)
        return self

    setBinary = set_binary

    def transform(self, frame):
        col = _token_col(frame, self.input_col)
        F = self.num_features
        lens, flat = _flatten(col)
        bucket = {t: _stable_hash(str(t), F) for t in dict.fromkeys(flat)}
        cols = np.fromiter(map(bucket.__getitem__, flat), np.int64,
                           count=len(flat))
        M = _count_matrix(lens, cols, F, frame.device)
        if self.binary:
            M = M > 0
        return frame.with_column(self.output_col, M.to(float_dtype()))


@persistable
class CountVectorizer(Estimator):
    """MLlib ``CountVectorizer``: learn a vocabulary (top ``vocab_size`` by
    document frequency, ties by the token) with ``min_df`` (a count, or a
    share of the valid documents below 1) and ``min_tf`` in-document
    filters; transform to dense count vectors. The document frequencies
    count distinct (document, token) pairs on the frame's device."""

    _persist_attrs = ('vocab_size', 'min_df', 'min_tf', 'binary',
                      'input_col', 'output_col')

    def __init__(self, vocab_size: int = 262144, min_df: float = 1.0,
                 min_tf: float = 1.0, binary: bool = False,
                 input_col: str = None, output_col: str = None):
        self.vocab_size = int(vocab_size)
        self.min_df = float(min_df)
        self.min_tf = float(min_tf)
        self.binary = binary
        self.input_col = input_col
        self.output_col = output_col

    def set_vocab_size(self, v):
        self.vocab_size = int(v)
        return self

    setVocabSize = set_vocab_size

    def set_min_df(self, v):
        self.min_df = float(v)
        return self

    setMinDF = set_min_df

    def fit(self, frame) -> "CountVectorizerModel":
        col = _token_col(frame, self.input_col)
        mask = frame.mask.cpu().numpy()
        docs = [toks for toks, m in zip(col, mask)
                if m and toks is not None]
        n_docs = len(docs)
        lens, flat = _flatten(docs)
        index: dict = {}        # token text -> code, in order of appearance
        codes = np.fromiter((index.setdefault(str(t), len(index))
                             for t in flat), np.int64, count=len(flat))
        U = len(index)
        if U:
            dev = frame.device
            doc = torch.repeat_interleave(
                torch.arange(n_docs, device=dev),
                torch.as_tensor(lens, device=dev))
            pairs = torch.unique(doc * U + torch.as_tensor(codes,
                                                           device=dev))
            df_counts = torch.bincount(pairs % U, minlength=U).cpu().numpy()
        else:
            df_counts = np.zeros(0, np.int64)
        # min_df: absolute count if >= 1, else fraction of documents
        thresh = self.min_df if self.min_df >= 1.0 \
            else self.min_df * max(n_docs, 1)
        words = list(index)
        kept = sorted((-int(df_counts[j]), words[j])
                      for j in np.flatnonzero(df_counts >= thresh))
        vocab = [w for _, w in kept[: self.vocab_size]]
        return CountVectorizerModel(vocab, self.min_tf, self.binary,
                                    self.input_col, self.output_col)


@persistable
class CountVectorizerModel(Model):
    _persist_attrs = ('vocabulary', 'min_tf', 'binary', 'input_col',
                      'output_col')

    def __init__(self, vocabulary, min_tf=1.0, binary=False,
                 input_col=None, output_col=None):
        self.vocabulary = list(vocabulary)
        self.min_tf = float(min_tf)
        self.binary = binary
        self.input_col = input_col
        self.output_col = output_col
        self._build_index()

    def _post_load(self):
        self.vocabulary = list(self.vocabulary)
        self._build_index()

    def _build_index(self):
        """Token → column, built once per model."""
        self._index = {}
        for j, w in enumerate(self.vocabulary):
            self._index.setdefault(str(w), j)

    def transform(self, frame):
        col = _token_col(frame, self.input_col)
        V = len(self.vocabulary)
        lens, flat = _flatten(col)
        index = self._index
        cols = np.fromiter((index.get(str(t), -1) for t in flat), np.int64,
                           count=len(flat))
        hit = cols >= 0
        M = _count_matrix(lens, np.where(hit, cols, 0), V, frame.device,
                          hit)
        if self.min_tf >= 1.0:
            M = torch.where(M < self.min_tf, 0, M)
        else:   # fraction-of-document threshold; empty docs are all-zero
            share = M.to(torch.float64) / torch.as_tensor(
                np.maximum(lens, 1), dtype=torch.float64,
                device=M.device)[:, None]
            M = torch.where(share < self.min_tf, 0, M)
        if self.binary:
            M = M > 0
        return frame.with_column(self.output_col, M.to(float_dtype()))


@persistable
class IDF(Estimator):
    """MLlib ``IDF``: log((n+1)/(df+1)) weights over a TF vector column,
    ``n`` the valid documents and ``df`` the valid documents where a
    column is positive (integer sums on the frame's device), weights of
    columns under ``min_doc_freq`` zero."""

    _persist_attrs = ('min_doc_freq', 'input_col', 'output_col')

    def __init__(self, min_doc_freq: int = 0, input_col: str = None,
                 output_col: str = None):
        self.min_doc_freq = int(min_doc_freq)
        self.input_col = input_col
        self.output_col = output_col

    def set_min_doc_freq(self, v):
        self.min_doc_freq = int(v)
        return self

    setMinDocFreq = set_min_doc_freq

    def fit(self, frame) -> "IDFModel":
        dt = float_dtype()
        tf = frame._column_values(self.input_col).to(dt)
        mask = frame.mask
        df = ((tf > 0) & mask[:, None]).sum(0)
        n = mask.sum()
        idf = torch.log((n + 1).to(dt) / (df + 1).to(dt))
        if self.min_doc_freq > 0:
            idf = torch.where(df >= self.min_doc_freq, idf,
                              torch.zeros((), dtype=dt, device=idf.device))
        return IDFModel(idf.cpu().numpy(), self.input_col, self.output_col)


@persistable
class IDFModel(Model):
    _persist_attrs = ('idf', 'input_col', 'output_col')

    def __init__(self, idf, input_col=None, output_col=None):
        self.idf = np.asarray(idf)
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, frame):
        tf = frame._column_values(self.input_col).to(float_dtype())
        return frame.with_column(
            self.output_col,
            tf * torch.tensor(self.idf, device=tf.device).to(tf.dtype))
