"""The text feature pipeline of the port (``models/text.py``) held against
the JAX package on the CPU in both float policies: every case of
``tests/test_text_ovr.py``'s text part (tokenizers, stop words, n-grams,
HashingTF, CountVectorizer, IDF, the pipeline, persistence), the filters
and flags that file leaves out (``min_df`` as a share, ``min_tf`` as a
count and a share, ``binary``, ``min_doc_freq``, case and pattern
options, every ``ValueError``), a seeded corpus of 300 documents through
every stage, save/load in both directions and the ``interop``
functions that build the port's models from numpy.

Tolerances: tokens, n-grams, buckets, counts, vocabularies and their order
are exact; IDF weights and TF-IDF values within rtol 1e-12 under the
float64 policy and 1e-6 under float32 (a float32 ``log`` may round one ulp
apart from XLA's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.models import base as jbase
from sparkdq4ml_tpu.models import text as jtext
from sparkdq4ml_tpu_torch import interop
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.models import Pipeline as TPipeline
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import text as ttext

RTOL = {"float64": 1e-12, "float32": 1e-6}

DOCS = np.asarray(["the TPU runs Fast", "the cpu runs slow", None,
                   "fast tpu fast"], dtype=object)


@pytest.fixture(params=sorted(RTOL))
def policy(request):
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, request.param)
    try:
        with jax.enable_x64(request.param == "float64"), \
                float_policy(getattr(torch, request.param)):
            yield request.param
    finally:
        jax_config.default_float_dtype = old


def frames(cols, mask=None):
    return (JFrame(dict(cols), mask=mask),
            TFrame(dict(cols), mask=mask, device="cpu"))


def tokens(values):
    """A ragged token column from a list of lists (or None)."""
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr


def same_tokens(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (None if x is None else list(x)) == \
            (None if y is None else list(y))


def matrix(frame, name):
    return np.stack([np.asarray(r) for r in frame.to_pydict()[name]])


def same_matrix(a, b, policy=None):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    if policy is None:
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL[policy], atol=0)


def corpus(n=300, seed=0):
    """Seeded raw documents: capitals, punctuation, stop words, a None."""
    rng = np.random.default_rng(seed)
    words = np.asarray([f"w{j}" for j in range(60)] + ["The", "and", "OF",
                                                       "to", "a"], object)
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    docs = []
    for i in range(n):
        k = int(rng.integers(0, 12))
        toks = list(rng.choice(words, k, p=p))
        if toks and rng.random() < 0.3:
            toks[0] = toks[0].capitalize() + ","
        docs.append(" ".join(toks) + ("." if rng.random() < 0.5 else ""))
    docs[7] = None
    return np.asarray(docs, dtype=object)


class TestTokenizers:
    def test_tokenizer_lowercases_and_splits(self):
        j, t = frames({"text": DOCS})
        a = jtext.Tokenizer("text", "words").transform(j).to_pydict()
        b = ttext.Tokenizer("text", "words").transform(t).to_pydict()
        same_tokens(b["words"], a["words"])
        assert b["words"][0] == ["the", "tpu", "runs", "fast"]
        assert b["words"][2] is None

    @pytest.mark.parametrize("kw", [
        dict(pattern=r"[a-z]+", gaps=False),
        dict(min_token_length=2),
        dict(pattern=r"\W+", min_token_length=2),
        dict(pattern=r"\W+", to_lowercase=False),
        dict(min_token_length=0),
    ])
    def test_regex_tokenizer(self, kw):
        text = np.asarray(["a1 b2 c3", "a bb ccc", " Lead, trail. ", None,
                           "MiXeD-case_words"], dtype=object)
        j, t = frames({"text": text})
        a = jtext.RegexTokenizer("text", "t", **kw).transform(j).to_pydict()
        b = ttext.RegexTokenizer("text", "t", **kw).transform(t).to_pydict()
        same_tokens(b["t"], a["t"])

    def test_regex_reference_cases(self):
        f = TFrame({"text": np.asarray(["a1 b2 c3"], dtype=object)},
                   device="cpu")
        out = ttext.RegexTokenizer("text", "t", pattern=r"[a-z]+",
                                   gaps=False).transform(f).to_pydict()
        assert out["t"][0] == ["a", "b", "c"]
        f = TFrame({"text": np.asarray(["a bb ccc"], dtype=object)},
                   device="cpu")
        out = ttext.RegexTokenizer("text", "t", min_token_length=2
                                   ).transform(f).to_pydict()
        assert out["t"][0] == ["bb", "ccc"]

    def test_non_token_column_raises(self):
        t = TFrame({"x": np.arange(3.0)}, device="cpu")
        with pytest.raises(ValueError, match="string/token column"):
            ttext.Tokenizer("x", "y").transform(t)


class TestStopWordsAndNGram:
    def test_default_stop_words(self):
        j, t = frames({"text": DOCS})
        a = jtext.StopWordsRemover("words", "clean").transform(
            jtext.Tokenizer("text", "words").transform(j)).to_pydict()
        b = ttext.StopWordsRemover("words", "clean").transform(
            ttext.Tokenizer("text", "words").transform(t)).to_pydict()
        same_tokens(b["clean"], a["clean"])
        assert b["clean"][0] == ["tpu", "runs", "fast"]

    def test_default_list_is_the_references(self):
        assert ttext.StopWordsRemover.loadDefaultStopWords() == \
            jtext.StopWordsRemover.load_default_stop_words()
        with pytest.raises(ValueError, match="english"):
            ttext.StopWordsRemover.load_default_stop_words("french")

    @pytest.mark.parametrize("case_sensitive", [True, False])
    def test_custom_stop_words(self, case_sensitive):
        w = tokens([["Foo", "foo", "bar", "FOO"], None, []])
        j, t = frames({"w": w})
        kw = dict(stop_words=["foo"], case_sensitive=case_sensitive)
        a = jtext.StopWordsRemover("w", "c", **kw).transform(j).to_pydict()
        b = ttext.StopWordsRemover("w", "c", **kw).transform(t).to_pydict()
        same_tokens(b["c"], a["c"])
        if case_sensitive:
            assert b["c"][0] == ["Foo", "bar", "FOO"]

    @pytest.mark.parametrize("n", [1, 2, 3, 4])
    def test_ngram(self, n):
        w = tokens([["a", "b", "c"], None, [], ["x"]])
        j, t = frames({"w": w})
        a = jtext.NGram(n, "w", "g").transform(j).to_pydict()
        b = ttext.NGram(n, "w", "g").transform(t).to_pydict()
        same_tokens(b["g"], a["g"])
        if n == 2:
            assert b["g"][0] == ["a b", "b c"]
        if n == 4:
            assert b["g"][0] == []

    def test_ngram_validation(self):
        with pytest.raises(ValueError, match="n must be"):
            ttext.NGram(0)
        with pytest.raises(ValueError, match="n must be"):
            ttext.NGram(2).set_n(0)


class TestVectorizers:
    @pytest.mark.parametrize("binary", [False, True])
    @pytest.mark.parametrize("num_features", [1, 32, 64])
    def test_hashing_tf(self, policy, binary, num_features):
        j, t = frames({"text": DOCS})
        a = jtext.HashingTF(num_features, "words", "tf", binary=binary
                            ).transform(jtext.Tokenizer("text", "words")
                                        .transform(j))
        b = ttext.HashingTF(num_features, "words", "tf", binary=binary
                            ).transform(ttext.Tokenizer("text", "words")
                                        .transform(t))
        M = matrix(b, "tf")
        same_matrix(matrix(a, "tf"), M)
        assert b._column_values("tf").dtype == getattr(torch, policy)
        if num_features == 64:
            assert M.shape == (4, 64)
            assert M[2].sum() == 0.0
            assert M[3].max() == (1.0 if binary else 2.0)
            if not binary:
                assert M[3].sum() == 3.0

    def test_hashing_tf_validation(self):
        with pytest.raises(ValueError, match="num_features"):
            ttext.HashingTF(0)
        with pytest.raises(ValueError, match="num_features"):
            ttext.HashingTF(8).set_num_features(0)

    @pytest.mark.parametrize("kw", [
        dict(),
        dict(vocab_size=3, min_df=2.0),
        dict(min_df=0.5),
        dict(min_df=0.3, vocab_size=2),
        dict(min_tf=2.0),
        dict(min_tf=0.5),
        dict(binary=True),
    ])
    def test_count_vectorizer(self, policy, kw):
        j, t = frames({"text": DOCS})
        fj = jtext.Tokenizer("text", "words").transform(j)
        ft = ttext.Tokenizer("text", "words").transform(t)
        a = jtext.CountVectorizer(input_col="words", output_col="cv",
                                  **kw).fit(fj)
        b = ttext.CountVectorizer(input_col="words", output_col="cv",
                                  **kw).fit(ft)
        assert b.vocabulary == a.vocabulary
        same_matrix(matrix(a.transform(fj), "cv"),
                    matrix(b.transform(ft), "cv"))

    def test_count_vectorizer_reference_cases(self):
        t = ttext.Tokenizer("text", "words").transform(
            TFrame({"text": DOCS}, device="cpu"))
        model = ttext.CountVectorizer(input_col="words",
                                      output_col="cv").fit(t)
        assert set(model.vocabulary[:4]) == {"the", "runs", "fast", "tpu"}
        M = matrix(model.transform(t), "cv")
        assert M[3, model.vocabulary.index("fast")] == 2.0
        small = ttext.CountVectorizer(vocab_size=3, min_df=2.0,
                                      input_col="words",
                                      output_col="cv").fit(t)
        assert len(small.vocabulary) == 3 and "cpu" not in small.vocabulary

    def test_count_vectorizer_respects_mask(self):
        keep = np.asarray([True, False, True, True])
        j, t = frames({"text": DOCS}, mask=keep)
        a = jtext.CountVectorizer(input_col="words", output_col="cv").fit(
            jtext.Tokenizer("text", "words").transform(j))
        b = ttext.CountVectorizer(input_col="words", output_col="cv").fit(
            ttext.Tokenizer("text", "words").transform(t))
        assert b.vocabulary == a.vocabulary
        assert "cpu" not in b.vocabulary

    def test_count_vectorizer_empty_corpus(self):
        w = tokens([[], None])
        j, t = frames({"w": w})
        a = jtext.CountVectorizer(input_col="w", output_col="cv").fit(j)
        b = ttext.CountVectorizer(input_col="w", output_col="cv").fit(t)
        assert b.vocabulary == a.vocabulary == []
        assert matrix(b.transform(t), "cv").shape == (2, 0)

    @pytest.mark.parametrize("min_doc_freq", [0, 2])
    def test_idf(self, policy, min_doc_freq):
        keep = np.asarray([True, True, True, False])
        j, t = frames({"text": DOCS}, mask=keep)
        fj = jtext.HashingTF(32, "words", "tf").transform(
            jtext.Tokenizer("text", "words").transform(j))
        ft = ttext.HashingTF(32, "words", "tf").transform(
            ttext.Tokenizer("text", "words").transform(t))
        a = jtext.IDF(min_doc_freq, "tf", "tfidf").fit(fj)
        b = ttext.IDF(min_doc_freq, "tf", "tfidf").fit(ft)
        assert b.idf.dtype == np.dtype(policy)
        same_matrix(a.idf, b.idf, policy)
        same_matrix(matrix(a.transform(fj), "tfidf"),
                    matrix(b.transform(ft), "tfidf"), policy)
        assert b.idf.min() >= 0.0


def _pipeline(pkg, corpus_frame):
    stages = [pkg.Tokenizer("text", "words"),
              pkg.RegexTokenizer("text", "rx", pattern=r"\W+",
                                 min_token_length=2),
              pkg.StopWordsRemover("rx", "clean"),
              pkg.NGram(2, "clean", "bigrams"),
              pkg.HashingTF(64, "clean", "tf"),
              pkg.CountVectorizer(vocab_size=20, min_df=2.0,
                                  input_col="bigrams", output_col="cv"),
              pkg.IDF(input_col="tf", output_col="features")]
    frame = corpus_frame
    fitted = []
    for st in stages:
        if hasattr(st, "fit"):
            st = st.fit(frame)
        fitted.append(st)
        frame = st.transform(frame)
    return fitted, frame


def test_corpus_through_every_stage(policy):
    text = corpus()
    mask = np.ones(len(text), bool)
    mask[::11] = False
    j, t = frames({"text": text}, mask=mask)
    fa, a = _pipeline(jtext, j)
    fb, b = _pipeline(ttext, t)
    da, db = a.to_pydict(), b.to_pydict()
    for name in ("words", "rx", "clean", "bigrams"):
        same_tokens(db[name], da[name])
    assert fb[5].vocabulary == fa[5].vocabulary and len(fb[5].vocabulary)
    same_matrix(np.stack(da["tf"]), db["tf"])
    same_matrix(np.stack(da["cv"]), db["cv"])
    same_matrix(fa[6].idf, fb[6].idf, policy)
    same_matrix(np.stack(da["features"]), db["features"], policy)


def test_text_pipeline_end_to_end(policy):
    t = TFrame({"text": DOCS}, device="cpu")
    model = TPipeline([ttext.Tokenizer("text", "words"),
                       ttext.StopWordsRemover("words", "clean"),
                       ttext.HashingTF(128, "clean", "tf"),
                       ttext.IDF(input_col="tf", output_col="features")]
                      ).fit(t)
    assert matrix(model.transform(t), "features").shape == (4, 128)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_persistence_both_ways(tmp_path, direction):
    w = tokens([["x", "y"], ["x"], ["z", "x", "y"]])
    j, t = frames({"w": w})
    if direction == "port_to_jax":
        cv = ttext.CountVectorizer(input_col="w", output_col="cv").fit(t)
        tbase.save_stage(cv, str(tmp_path / "cv"))
        back = jbase.load_stage(str(tmp_path / "cv"))
        assert back.vocabulary == cv.vocabulary
        same_matrix(matrix(back.transform(j), "cv"),
                    matrix(cv.transform(t), "cv"))
    else:
        cv = jtext.CountVectorizer(input_col="w", output_col="cv").fit(j)
        jbase.save_stage(cv, str(tmp_path / "cv"))
        back = tbase.load_stage(str(tmp_path / "cv"))
        assert isinstance(back, ttext.CountVectorizerModel)
        assert back.vocabulary == cv.vocabulary
        same_matrix(matrix(cv.transform(j), "cv"),
                    matrix(back.transform(t), "cv"))
    tf_j = jtext.HashingTF(16, "w", "tf").transform(j)
    tf_t = ttext.HashingTF(16, "w", "tf").transform(t)
    src = (ttext.IDF(input_col="tf", output_col="o").fit(tf_t)
           if direction == "port_to_jax"
           else jtext.IDF(input_col="tf", output_col="o").fit(tf_j))
    (tbase if direction == "port_to_jax" else jbase).save_stage(
        src, str(tmp_path / "idf"))
    back = (jbase if direction == "port_to_jax" else tbase).load_stage(
        str(tmp_path / "idf"))
    np.testing.assert_array_equal(np.asarray(back.idf), np.asarray(src.idf))
    for st in (ttext.Tokenizer("a", "b"),
               ttext.RegexTokenizer("a", "b", pattern=r"\d+", gaps=False),
               ttext.StopWordsRemover("a", "b", stop_words=["q"]),
               ttext.NGram(3, "a", "b"), ttext.HashingTF(7, "a", "b", True)):
        path = str(tmp_path / type(st).__name__)
        tbase.save_stage(st, path)
        other = jbase.load_stage(path)
        assert {k: getattr(other, k) for k in st._persist_attrs} == \
            {k: getattr(st, k) for k in st._persist_attrs}


def test_interop_models_from_numpy(policy):
    text = corpus(seed=3)
    j, t = frames({"text": text})
    fj = jtext.HashingTF(32, "words", "tf").transform(
        jtext.Tokenizer("text", "words").transform(j))
    ft = ttext.HashingTF(32, "words", "tf").transform(
        ttext.Tokenizer("text", "words").transform(t))
    cv = jtext.CountVectorizer(min_tf=2.0, binary=True, input_col="words",
                               output_col="cv").fit(fj)
    mine = interop.count_vectorizer_model_from_numpy(
        cv.vocabulary, cv.min_tf, cv.binary, "words", "cv")
    same_matrix(matrix(cv.transform(fj), "cv"), matrix(mine.transform(ft),
                                                       "cv"))
    idf = jtext.IDF(input_col="tf", output_col="o").fit(fj)
    mine = interop.idf_model_from_numpy(np.asarray(idf.idf), "tf", "o")
    same_matrix(matrix(idf.transform(fj), "o"), matrix(mine.transform(ft),
                                                       "o"), policy)


def _load_smoke():
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def jax_text_rec_small() -> dict:
    """``chip_smoke.text_rec_small``'s cases through the JAX package."""
    from sparkdq4ml_tpu.models import ALS, MultilayerPerceptronClassifier
    from sparkdq4ml_tpu.models import VectorAssembler as JVA
    from sparkdq4ml_tpu.models import mlp as jmlp
    from sparkdq4ml_tpu.models import recommendation as jrec

    for fn in (jrec._als_fit_fn, jrec._implicit_fit_fn, jmlp._mlp_fit_fn):
        fn.cache_clear()

    def host(v) -> list:
        return np.asarray(v, np.float64).tolist()

    out = {}
    rng = np.random.default_rng(0)
    U = rng.normal(size=(30, 3))
    V = rng.normal(size=(20, 3))
    R = U @ V.T
    u, i = np.nonzero(rng.random((30, 20)) < 0.6)
    f = JFrame({"user": u.astype(np.int32), "item": i.astype(np.int32),
                "rating": R[u, i].astype(np.float32)})
    als = ALS(rank=3, max_iter=15, reg_param=0.01, seed=1).fit(f)
    out["als_loss"] = host(als.loss_history)
    out["als_predictions"] = host(np.asarray(als.transform(f).to_pydict()[
        "prediction"])[:8])
    out["als_top"] = [[int(j) for j, _ in rec] for rec in
                      als.recommend_for_all_users(3).to_pydict()[
                          "recommendations"][:5]]
    rng = np.random.default_rng(0)
    U = rng.normal(size=(40, 3))
    V = rng.normal(size=(30, 3))
    prob = 1 / (1 + np.exp(-2.0 * (U @ V.T)))
    observed = rng.random((40, 30)) < prob * 0.4
    counts = rng.poisson(3.0, size=(40, 30)) + 1
    u, i = np.nonzero(observed)
    f = JFrame({"user": u.astype(float), "item": i.astype(float),
                "rating": counts[u, i].astype(float)})
    ials = ALS(rank=8, max_iter=15, reg_param=0.05, implicit_prefs=True,
               alpha=10.0, seed=0).fit(f)
    out["ials_loss"] = host(ials.loss_history)
    out["ials_predictions"] = host(np.asarray(ials.transform(f).to_pydict()[
        "prediction"])[:8])
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(400, 2))
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float64)
    f = JVA(["a", "b"], "features").transform(
        JFrame({"a": X[:, 0], "b": X[:, 1], "label": y}))
    mlp = MultilayerPerceptronClassifier(layers=[2, 8, 2], max_iter=800,
                                         step_size=0.05, seed=1).fit(f)
    d = mlp.transform(f).to_pydict()
    out["mlp_loss"] = host(mlp.loss_history[::100] + mlp.loss_history[-1:])
    out["mlp_accuracy"] = float(np.mean(np.asarray(d["prediction"]) == y))
    out["mlp_probability"] = host(np.asarray(d["probability"])[:4, 1])
    f = jtext.Tokenizer("text", "words").transform(JFrame({"text": DOCS}))
    out["words"] = [None if w is None else list(w)
                    for w in f.to_pydict()["words"]]
    f = jtext.HashingTF(64, "words", "tf").transform(f)
    tf = np.asarray(f.to_pydict()["tf"], np.float64)
    out["tf"] = [[int(j), float(tf.flat[j])]
                 for j in np.flatnonzero(tf.reshape(-1))]
    cv = jtext.CountVectorizer(input_col="words", output_col="cv").fit(f)
    out["vocabulary"] = list(cv.vocabulary)
    cm = np.asarray(cv.transform(f).to_pydict()["cv"], np.float64)
    out["cv"] = [[int(j), float(cm.flat[j])]
                 for j in np.flatnonzero(cm.reshape(-1))]
    out["idf"] = host(jtext.IDF(input_col="tf", output_col="t").fit(f).idf)
    return out


@pytest.fixture
def float32_policy():
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = jnp.float32
    try:
        with jax.enable_x64(False), float_policy(torch.float32):
            yield
    finally:
        jax_config.default_float_dtype = old


def test_text_rec_golden_is_the_references(float32_policy):
    """``chip_smoke.TEXT_REC_GOLDEN`` is the JAX package's float32 output
    of ``text_rec_small``'s cases, and the port's CPU run of them meets it
    as the card must (ids, vocabularies, counts and the accuracy exact,
    floats within ``TEXT_REC_TOL``)."""
    smoke = _load_smoke()
    want = jax_text_rec_small()
    golden = smoke.TEXT_REC_GOLDEN
    assert set(golden) == set(want)
    for k in smoke.TEXT_REC_EXACT:
        assert golden[k] == want[k], k
    assert max(smoke.text_rec_errors(golden, want).values()) <= 1e-12
    got = smoke.text_rec_small("cpu")
    for k in smoke.TEXT_REC_EXACT:
        assert got[k] == golden[k], k
    errs = smoke.text_rec_errors(got, golden)
    assert max(errs.values()) <= smoke.TEXT_REC_TOL, errs
