"""``Word2Vec`` of the port (``models/word2vec.py``) held against the JAX
package on the CPU in both float policies, on the cases of
``tests/test_word2vec.py`` (single device): the vocabulary and its counts,
the skip-gram pairs (built with numpy here, with Python loops there) and
the shuffled minibatches, each step's negatives against JAX's own draw
(float32 uniforms with x64 off, float64 with it on), the vectors and the
loss history after SGD, ``transform``'s document means (a None row and a
row of unknown tokens included), ``find_synonyms`` with ties broken
toward the lower index, ``get_vectors``, min_count, long documents cut at
``max_sentence_length``, a corpus of one-token documents, masked rows,
every ``ValueError`` and save/load both ways; the updates are two
fixed-order segment sums a step and the means one sorted segment sum.

Tolerances: vocabulary, pairs, minibatches and negatives exact. Under the
float64 policy vectors, losses, means and similarities within 1e-9 of
their scale; under the float32 policy within 1e-4 of their scale (the
segment sums add in another order than XLA's scatter), the top synonyms
equal.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.frame.frame import list_column as jlist
from sparkdq4ml_tpu.models import base as jbase
from sparkdq4ml_tpu.models import word2vec as jw
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import word2vec as tw
from sparkdq4ml_tpu_torch.ops import kernels
from sparkdq4ml_tpu_torch.ops.cells import list_column as tlist

POLICIES = {"float64": SimpleNamespace(name="float64", scale=1e-9),
            "float32": SimpleNamespace(name="float32", scale=1e-4)}


@pytest.fixture(params=sorted(POLICIES))
def policy(request):
    pol = POLICIES[request.param]
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, pol.name)
    jw._sgns_fit_fn.cache_clear()
    try:
        with jax.enable_x64(pol.name == "float64"), \
                float_policy(getattr(torch, pol.name)):
            yield pol
    finally:
        jax_config.default_float_dtype = old
        jw._sgns_fit_fn.cache_clear()


def near(got, want, pol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= pol.scale * max(float(np.max(np.abs(want))), 1.0), \
        f"{what}: off by {err}"


def planted_docs(n_docs=400, seed=0):
    rng = np.random.default_rng(seed)
    animals = ["cat", "dog", "pet", "fur", "paw"]
    vehicles = ["car", "road", "drive", "wheel", "fuel"]
    return [list(rng.choice(animals if rng.random() < 0.5 else vehicles,
                            size=8)) for _ in range(n_docs)]


def frames(docs, mask=None):
    return (JFrame({"toks": jlist(docs)}, mask=mask),
            TFrame({"toks": tlist(docs)}, mask=mask, device="cpu"))


KW = dict(vector_size=16, window_size=3, min_count=1, max_iter=3,
          num_negatives=4, batch_size=256, seed=1, input_col="toks",
          output_col="vec")


def same_model(a, b, pol):
    assert b.vocabulary == a.vocabulary
    assert b.vectors.dtype == a.vectors.dtype
    near(b.vectors, a.vectors, pol, "vectors")
    near(b.loss_history, a.loss_history, pol, "loss history")


@pytest.mark.parametrize("kw", [KW, dict(KW, max_iter=1, batch_size=100,
                                         window_size=5, seed=9),
                                dict(KW, num_negatives=1, step_size=0.05)])
def test_fit_matches_the_reference(policy, kw):
    docs = planted_docs()
    j, t = frames(docs)
    a = jw.Word2Vec(**kw).fit(j)
    b = tw.Word2Vec(**kw).fit(t)
    same_model(a, b, policy)
    queries = docs[:5] + [None, ["zebra", "unknown"], ["cat", "zebra"]]
    ja, tb = frames(queries)
    near(b.transform(tb).to_pydict()["vec"],
         a.transform(ja).to_pydict()["vec"], policy, "document means")
    for word in ("cat", "car", "fuel"):
        sa = a.find_synonyms(word, 4).to_pydict()
        sb = b.findSynonyms(word, 4).to_pydict()
        assert list(sb["word"]) == list(sa["word"])
        near(sb["similarity"], sa["similarity"], policy, "similarity")
    assert set(sb["word"]) <= {"road", "drive", "wheel", "car"}


def test_vocabulary_pairs_and_negatives_are_the_reference():
    """The host passes equal the JAX package's, and each step's
    negatives equal its ``searchsorted`` of JAX's uniforms."""
    docs = planted_docs(60, seed=3) + [["x"] * 3, ["y"]]
    mask = np.ones(len(docs), bool)
    col = jlist(docs)
    va, ca, da = jw._build_vocab(col, mask, 2, 6)
    vb, cb, db = tw._build_vocab(tlist(docs), mask, 2, 6)
    assert vb == va and cb.tolist() == ca.tolist() and db == da
    index = {t: i for i, t in enumerate(va)}
    for window, cut in ((3, 1000), (2, 3), (5, 2)):
        pa = jw._build_pairs(da, index, window, 7, cut)
        pb = tw._build_pairs(db, index, window, 7, cut)
        for x, y in zip(pa, pb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    p = cb.astype(np.float64) ** 0.75
    for dt, jdt, x64 in ((torch.float32, jnp.float32, False),
                         (torch.float64, jnp.float64, True)):
        cdf = np.cumsum(p / p.sum()).astype(str(dt)[6:])
        got = tw.step_negatives(torch.as_tensor(cdf), 3, 0, 4, 50, 5, dt)
        with jax.enable_x64(x64):
            for s in range(4):
                u = jax.random.uniform(jax.random.fold_in(
                    jax.random.PRNGKey(3), s), (50, 5), jdt)
                np.testing.assert_array_equal(
                    got[s].numpy(), np.asarray(jnp.searchsorted(
                        jnp.asarray(cdf), u)))


def test_updates_and_means_are_fixed_order_segment_sums(monkeypatch):
    calls = []
    real = kernels.dense_segment_sum

    def spy(x, seg, size):
        calls.append(("dense", tuple(x.shape), size))
        return real(x, seg, size)

    real_sorted = kernels.sorted_segment_sum

    def spy_sorted(x, seg, size):
        calls.append(("sorted", tuple(x.shape), size))
        return real_sorted(x, seg, size)

    monkeypatch.setattr(kernels, "dense_segment_sum", spy)
    monkeypatch.setattr(kernels, "sorted_segment_sum", spy_sorted)
    docs = planted_docs(40)
    m = tw.Word2Vec(**dict(KW, max_iter=1)).fit(frames(docs)[1])
    steps = len(m.loss_history)
    assert calls[:2] == [("dense", (256, 16), 10),
                         ("dense", (256 * 5, 16), 10)]
    assert len(calls) == 2 * steps
    calls.clear()
    m.transform(frames(docs[:7] + [None])[1])
    assert calls == [("sorted", (56, 16), 8)]


def test_ties_go_to_the_lower_index():
    vocab = ["a", "b", "c", "d", "e"]
    vectors = np.asarray([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.0, 1.0],
                          [1.0, 1.0]], np.float32)
    m = tw.Word2VecModel(vocab, vectors, {"input_col": "t"})
    d = m.find_synonyms("a", 4).to_pydict()
    assert list(d["word"]) == ["c", "e", "b", "d"]
    j = jw.Word2VecModel(vocab, vectors, {"input_col": "t"})
    assert list(j.find_synonyms("a", 4).to_pydict()["word"]) == \
        list(d["word"])


def test_min_count_masked_rows_and_one_token_docs(policy):
    docs = [["a", "b"], ["a", "c"], ["a", "b"], ["q", "q", "q"]]
    mask = np.asarray([True, True, True, False])
    j, t = frames(docs, mask)
    kw = dict(vector_size=4, min_count=2, window_size=2, max_iter=1,
              input_col="toks", output_col="v", seed=0)
    a = jw.Word2Vec(**kw).fit(j)
    b = tw.Word2Vec(**kw).fit(t)
    assert set(b.vocabulary) == {"a", "b"}
    same_model(a, b, policy)
    j1, t1 = frames([["solo"], ["one"], ["solo"]])
    a1 = jw.Word2Vec(**kw).fit(j1)
    b1 = tw.Word2Vec(**kw).fit(t1)
    assert b1.loss_history == [] and b1.vocabulary == a1.vocabulary
    np.testing.assert_array_equal(b1.vectors, a1.vectors)


def test_surface_and_checks():
    m = tw.Word2Vec(**KW).fit(frames(planted_docs(80))[1])
    d = m.get_vectors().to_pydict()
    assert list(d["word"]) == m.vocabulary
    assert np.asarray(d["vector"]).shape == (len(m.vocabulary), 16)
    assert m.getVectorSize() == m.vector_size == 16
    with pytest.raises(ValueError, match="not in vocabulary"):
        m.find_synonyms("zebra", 3)
    for M in (jw, tw):
        for bad in (dict(vector_size=0), dict(window_size=0),
                    dict(max_sentence_length=1)):
            with pytest.raises(ValueError, match=list(bad)[0]):
                M.Word2Vec(**bad)
    with pytest.raises(ValueError, match="min_count"):
        tw.Word2Vec(min_count=9, input_col="toks").fit(
            frames([["a", "b"]])[1])
    with pytest.raises(ValueError, match="token column"):
        tw.Word2Vec(input_col="x").fit(TFrame({"x": np.arange(3.0)},
                                              device="cpu"))
    with pytest.raises(NotImplementedError):
        tw.Word2Vec(input_col="toks").fit(frames([["a", "b"]])[1],
                                          mesh=object())


def test_model_round_trips_both_ways(tmp_path):
    docs = planted_docs(80)
    with float_policy(torch.float64):
        a = jw.Word2Vec(**KW).fit(frames(docs)[0])
        a.save(str(tmp_path / "jax"))
        b = tbase.load_stage(str(tmp_path / "jax"))
        assert isinstance(b, tw.Word2VecModel)
        np.testing.assert_array_equal(b.vectors, a.vectors)
        assert list(b.find_synonyms("cat", 2).to_pydict()["word"]) == \
            list(a.find_synonyms("cat", 2).to_pydict()["word"])
        b.save(str(tmp_path / "torch"))
        c = jbase.load_stage(str(tmp_path / "torch"))
        np.testing.assert_array_equal(c.vectors, a.vectors)
        assert c.vocabulary == a.vocabulary
