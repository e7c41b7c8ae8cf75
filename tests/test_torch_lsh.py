"""``BucketedRandomProjectionLSH`` and ``MinHashLSH`` of the port
(``models/lsh.py``) held against the JAX package on the CPU in both float
policies, on the cases of ``tests/test_lsh.py``: the hash columns,
``approx_nearest_neighbors`` (candidates sharing a bucket, the fallback to
every valid row when fewer than k share one, ties by row order, the
distance column of the rows it keeps), ``approx_similarity_join``
(positions among each frame's valid rows, pairs found in several tables
once, no candidate at all), masked rows holding NaN, MinHash's binary and
empty-vector checks at fit, transform and query time, every ``ValueError``
and save/load both ways.

Tolerances: hashes, chosen rows and join pairs exact; distances within
rtol 1e-10 under the float64 policy (XLA fuses the squared differences'
sum into a multiply-add, and torch's CPU ``sqrt`` has been seen to return
one thread's chunk of float64 results 4e-11 off) and 1e-6 under float32.
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
from sparkdq4ml_tpu.models import lsh as jl
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import lsh as tl

POLICIES = {"float64": SimpleNamespace(name="float64", rtol=1e-10),
            "float32": SimpleNamespace(name="float32", rtol=1e-6)}


@pytest.fixture(params=sorted(POLICIES))
def policy(request):
    pol = POLICIES[request.param]
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, pol.name)
    try:
        with jax.enable_x64(pol.name == "float64"), \
                float_policy(getattr(torch, pol.name)):
            yield pol
    finally:
        jax_config.default_float_dtype = old


def frames(X, mask=None):
    return (JFrame({"features": X}, mask=mask),
            TFrame({"features": X}, mask=mask, device="cpu"))


def same_frames(a, b, pol, dist="distCol"):
    da, db = a.to_pydict(), b.to_pydict()
    assert list(da) == list(db)
    for k in da:
        x, y = np.asarray(da[k]), np.asarray(db[k])
        assert x.shape == y.shape, k
        if k == dist:
            np.testing.assert_allclose(y.astype(np.float64),
                                       x.astype(np.float64), rtol=pol.rtol,
                                       atol=pol.rtol)
        else:
            np.testing.assert_array_equal(y, x, err_msg=k)


def points(n=400, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 2))


@pytest.mark.parametrize("length,tables,k", [(2.0, 4, 3), (0.5, 1, 5),
                                             (1.0, 3, 400), (0.05, 2, 2)])
def test_brp_matches_the_reference(policy, length, tables, k):
    X = points()
    mask = np.random.default_rng(1).random(400) > 0.1
    X[~mask] = np.nan
    j, t = frames(X, mask)
    kw = dict(bucket_length=length, num_hash_tables=tables, seed=3)
    a = jl.BucketedRandomProjectionLSH(**kw).fit(j)
    b = tl.BucketedRandomProjectionLSH(**kw).fit(t)
    np.testing.assert_array_equal(b.projections, a.projections)
    same_frames(a.transform(j), b.transform(t), policy)
    key = np.asarray(X[np.flatnonzero(mask)[0]])
    same_frames(a.approx_nearest_neighbors(j, key, k),
                b.approxNearestNeighbors(t, key, k), policy)
    ja, ta = frames(points(150, 2))
    same_frames(a.approx_similarity_join(j, ja, 0.4),
                b.approxSimilarityJoin(t, ta, 0.4), policy)


def test_nearest_neighbor_ties_and_fallback(policy):
    X = np.asarray([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [-1.0, 0.0],
                    [5.0, 5.0], [0.0, 1.0]])
    j, t = frames(X)
    kw = dict(bucket_length=0.1, num_hash_tables=1, seed=0)
    a = jl.BucketedRandomProjectionLSH(**kw).fit(j)
    b = tl.BucketedRandomProjectionLSH(**kw).fit(t)
    for k in (1, 3, 6, 10):
        same_frames(a.approx_nearest_neighbors(j, [0.0, 0.0], k),
                    b.approx_nearest_neighbors(t, [0.0, 0.0], k), policy)


def test_join_without_candidates(policy):
    j, t = frames(np.asarray([[0.0, 0.0], [0.1, 0.0]]))
    far = frames(np.asarray([[100.0, 100.0]]))
    kw = dict(bucket_length=0.5, num_hash_tables=2, seed=4)
    a = jl.BucketedRandomProjectionLSH(**kw).fit(j)
    b = tl.BucketedRandomProjectionLSH(**kw).fit(t)
    out = b.approx_similarity_join(t, far[1], 1.0, dist_col="d")
    assert out.columns == ["idA", "idB", "d"] and out.count() == 0
    same_frames(a.approx_similarity_join(j, far[0], 1.0, dist_col="d"), out,
                policy, dist="d")


def binary_rows(n=300, d=16, seed=0):
    B = (np.random.default_rng(seed).random((n, d)) < 0.3).astype(float)
    B[:, 0] = 1.0
    return B


@pytest.mark.parametrize("tables,k,threshold", [(4, 5, 0.6), (1, 2, 0.3),
                                                (2, 300, 0.9)])
def test_minhash_matches_the_reference(policy, tables, k, threshold):
    B = binary_rows()
    mask = np.random.default_rng(2).random(300) > 0.1
    B[~mask] = np.nan
    j, t = frames(B, mask)
    a = jl.MinHashLSH(num_hash_tables=tables, seed=3).fit(j)
    b = tl.MinHashLSH(num_hash_tables=tables, seed=3).fit(t)
    np.testing.assert_array_equal(b.coeff_a, a.coeff_a)
    np.testing.assert_array_equal(b.coeff_b, a.coeff_b)
    ha, hb = a.transform(j), b.transform(t)
    assert str(np.asarray(hb.to_pydict()["hashes"]).dtype) == "int32"
    same_frames(ha, hb, policy)
    key = binary_rows(1, seed=5)[0]
    same_frames(a.approx_nearest_neighbors(j, key, k),
                b.approx_nearest_neighbors(t, key, k), policy)
    ja, ta = frames(binary_rows(80, seed=6))
    same_frames(a.approx_similarity_join(j, ja, threshold),
                b.approx_similarity_join(t, ta, threshold), policy)


def test_checks_raise_as_in_the_reference():
    B = binary_rows(20)
    for M, F in ((jl, JFrame), (tl, TFrame)):
        kw = {} if F is JFrame else {"device": "cpu"}
        with pytest.raises(ValueError, match="num_hash_tables"):
            M.MinHashLSH(num_hash_tables=0)
        with pytest.raises(ValueError, match="bucket_length"):
            M.BucketedRandomProjectionLSH(bucket_length=-1.0)
        with pytest.raises(ValueError, match="bucket_length must be set"):
            M.BucketedRandomProjectionLSH().fit(F({"features": B}, **kw))
        bad = B.copy()
        bad[3, 2] = 0.5
        with pytest.raises(ValueError, match="binary"):
            M.MinHashLSH().fit(F({"features": bad}, **kw))
        empty = B.copy()
        empty[4] = 0.0
        with pytest.raises(ValueError, match="nonzero"):
            M.MinHashLSH().fit(F({"features": empty}, **kw))
        model = M.MinHashLSH(num_hash_tables=2).fit(F({"features": B},
                                                      **kw))
        with pytest.raises(ValueError, match="nonzero"):
            model.transform(F({"features": empty}, **kw))
        with pytest.raises(ValueError, match="nonzero"):
            model.approx_nearest_neighbors(F({"features": B}, **kw),
                                           np.zeros(16), 2)
        masked = model.transform(F({"features": empty},
                                   mask=np.arange(20) != 4, **kw))
        assert masked.count() == 19
    assert tl.BucketedRandomProjectionLSH().setBucketLength(
        2.0).setNumHashTables(3).setSeed(1).setInputCol("x").setOutputCol(
        "h").bucket_length == 2.0


@pytest.mark.parametrize("which", ["brp", "minhash"])
def test_models_round_trip_both_ways(tmp_path, which):
    with float_policy(torch.float64):
        B = binary_rows(50) if which == "minhash" else points(50)
        est = (jl.MinHashLSH(num_hash_tables=3, seed=2)
               if which == "minhash" else
               jl.BucketedRandomProjectionLSH(bucket_length=1.0,
                                              num_hash_tables=3, seed=2))
        j, t = frames(B)
        a = est.fit(j)
        a.save(str(tmp_path / "jax"))
        b = tbase.load_stage(str(tmp_path / "jax"))
        assert type(b).__name__ == type(a).__name__
        np.testing.assert_array_equal(
            np.asarray(b.transform(t).to_pydict()["hashes"]),
            np.asarray(a.transform(j).to_pydict()["hashes"]))
        b.save(str(tmp_path / "torch"))
        c = jbase.load_stage(str(tmp_path / "torch"))
        np.testing.assert_array_equal(
            np.asarray(c.transform(j).to_pydict()["hashes"]),
            np.asarray(a.transform(j).to_pydict()["hashes"]))
