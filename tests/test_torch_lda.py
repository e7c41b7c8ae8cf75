"""``LDA`` of the port (``models/lda.py``) held against the JAX package on
the CPU in both float policies, on the cases of ``tests/test_lda.py``
(single device): batch EM and online VB on planted-vocabulary corpora
(λ, its start from JAX's gamma draw, the online minibatches from JAX's
randint), ``describe_topics``, ``topics_matrix``, ``transform``,
``log_likelihood``, ``log_perplexity``, ``estimated_doc_concentration``,
explicit concentrations, masked rows holding junk counts or NaN, every
``ValueError`` and save/load both ways.

Tolerances: λ within 1e-9 of its topic's largest entry under the float64
policy and 1e-4 under float32 (λ starts from gamma draws that match JAX's
within a few ulps, ``tests/test_torch_prng.py``); the bound and the
perplexity within rtol 1e-9 and 1e-5; topic distributions and term
weights within 1e-9 and 1e-4 (as λ); the top terms equal.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.models import base as jbase
from sparkdq4ml_tpu.models import lda as jlda
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import lda as tlda

POLICIES = {"float64": SimpleNamespace(name="float64", lam=1e-9, rtol=1e-9),
            "float32": SimpleNamespace(name="float32", lam=1e-4, rtol=1e-5)}
K, VOCAB_PER = 3, 8
VOCAB = K * VOCAB_PER


def _clear():
    for fn in (jlda._online_fit_fn, jlda._bound_fn, jlda._transform_fn):
        fn.cache_clear()


@pytest.fixture(params=sorted(POLICIES))
def policy(request):
    pol = POLICIES[request.param]
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, pol.name)
    _clear()            # the JAX package caches its programs per shape only
    try:
        with jax.enable_x64(pol.name == "float64"), \
                float_policy(getattr(torch, pol.name)):
            yield pol
    finally:
        jax_config.default_float_dtype = old
        _clear()


def planted(seed=0, docs_per=40):
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(K):
        for _ in range(docs_per):
            cnt = np.zeros(VOCAB)
            np.add.at(cnt, rng.integers(t * VOCAB_PER, (t + 1) * VOCAB_PER,
                                        size=60), 1.0)
            np.add.at(cnt, rng.integers(0, VOCAB, size=4), 1.0)
            rows.append(cnt)
    return np.stack(rows)[rng.permutation(len(rows))]


def frames(X, mask=None):
    return (JFrame({"features": X}, mask=mask),
            TFrame({"features": X}, mask=mask, device="cpu"))


def same_lda(a, b, j, t, pol):
    err = np.max(np.abs(b.topics.astype(np.float64) - a.topics)
                 / np.max(a.topics, axis=1, keepdims=True))
    assert err <= pol.lam, f"lambda off by {err}"
    da, db = a.describe_topics(5).to_pydict(), b.describeTopics(5).to_pydict()
    np.testing.assert_array_equal(np.stack(db["termIndices"]),
                                  np.stack(da["termIndices"]))
    np.testing.assert_allclose(np.stack(db["termWeights"]),
                               np.stack(da["termWeights"]), rtol=pol.lam,
                               atol=pol.lam)
    np.testing.assert_allclose(b.topicsMatrix(), a.topics_matrix(),
                               rtol=pol.lam, atol=pol.lam)
    assert b.log_likelihood(t) == pytest.approx(a.log_likelihood(j),
                                                rel=pol.rtol)
    assert b.logPerplexity(t) == pytest.approx(a.log_perplexity(j),
                                               rel=pol.rtol)
    np.testing.assert_allclose(
        np.asarray(b.transform(t).to_pydict()["topicDistribution"],
                   np.float64),
        np.asarray(a.transform(j).to_pydict()["topicDistribution"],
                   np.float64), rtol=pol.lam, atol=pol.lam)
    np.testing.assert_array_equal(b.estimatedDocConcentration,
                                  a.estimated_doc_concentration)
    assert b.vocab_size == a.vocab_size and not b.isDistributed


@pytest.mark.parametrize("kw", [
    dict(k=K, max_iter=30, optimizer="em", seed=3),
    dict(k=K, max_iter=60, optimizer="online", seed=1,
         subsampling_rate=0.25),
    dict(k=4, max_iter=10, optimizer="em", seed=2, doc_concentration=0.5,
         topic_concentration=0.2, inner_iter=20),
    dict(k=2, max_iter=12, optimizer="online", seed=5, subsampling_rate=0.1,
         learning_offset=16.0, learning_decay=0.7),
])
def test_fit_matches_the_reference(policy, kw):
    j, t = frames(planted())
    a = jlda.LDA(**kw).fit(j)
    b = tlda.LDA(**kw).fit(t)
    assert b.topics.dtype == a.topics.dtype
    same_lda(a, b, j, t, policy)


def test_masked_rows_with_junk_or_nan_carry_no_tokens(policy):
    X = planted(seed=8, docs_per=12)
    keep = np.arange(len(X)) % 2 == 1
    for junk in (1000.0, np.nan):
        Xbad = X.copy()
        Xbad[~keep] = junk
        j, t = frames(Xbad, keep)
        kw = dict(k=K, max_iter=10, optimizer="em", seed=4)
        a = jlda.LDA(**kw).fit(j)
        b = tlda.LDA(**kw).fit(t)
        assert np.all(np.isfinite(b.topics))
        same_lda(a, b, j, t, policy)
        clean = tlda.LDA(**kw).fit(TFrame({"features": X[keep]},
                                          device="cpu"))
        np.testing.assert_allclose(b.topics, clean.topics,
                                   rtol=10 * policy.lam, atol=1e-6)


def test_checks_raise_as_in_the_reference():
    for M, F in ((jlda, JFrame), (tlda, TFrame)):
        kw = {} if F is JFrame else {"device": "cpu"}
        with pytest.raises(ValueError, match="k must be >= 2"):
            M.LDA(k=1)
        with pytest.raises(ValueError, match="optimizer"):
            M.LDA(optimizer="gibbs")
        with pytest.raises(ValueError, match="subsampling_rate"):
            M.LDA(subsampling_rate=0.0)
        with pytest.raises(ValueError, match="not supported"):
            M.LDA(optimize_doc_concentration=True)
        with pytest.raises(ValueError, match="vector column"):
            M.LDA(k=2).fit(F({"features": np.asarray([1.0, 2.0])}, **kw))
        model = M.LDA(k=2, max_iter=2, optimizer="em").fit(
            F({"features": planted(docs_per=3)}, **kw))
        with pytest.raises(ValueError, match="no tokens"):
            model.log_perplexity(F({"features": np.zeros((2, VOCAB))},
                                   **kw))
    est = (tlda.LDA().setK(3).setMaxIter(4).setOptimizer("em")
           .setDocConcentration(0.3).setTopicConcentration(0.2)
           .setSubsamplingRate(0.5).setLearningOffset(8.0)
           .setLearningDecay(0.6).setSeed(2).setFeaturesCol("f")
           .setTopicDistributionCol("td"))
    assert (est.k, est.optimizer, est.features_col) == (3, "em", "f")
    with pytest.raises(NotImplementedError):
        tlda.LDA(k=2).fit(frames(planted(docs_per=2))[1], mesh=object())


def test_model_round_trips_both_ways(tmp_path):
    with float_policy(torch.float64):
        _clear()
        j, t = frames(planted(docs_per=10))
        a = jlda.LDA(k=K, max_iter=5, optimizer="em", seed=1).fit(j)
        a.save(str(tmp_path / "jax"))
        b = tbase.load_stage(str(tmp_path / "jax"))
        assert isinstance(b, tlda.LDAModel)
        np.testing.assert_array_equal(b.topics, a.topics)
        assert b.log_perplexity(t) == pytest.approx(a.log_perplexity(j),
                                                    rel=1e-9)
        est = tlda.LDA(k=K, max_iter=5, optimizer="em", seed=1)
        b.save(str(tmp_path / "torch"))
        est.save(str(tmp_path / "est"))
        c = jbase.load_stage(str(tmp_path / "torch"))
        np.testing.assert_array_equal(c.topics, a.topics)
        assert jbase.load_stage(str(tmp_path / "est")).k == K
        _clear()
