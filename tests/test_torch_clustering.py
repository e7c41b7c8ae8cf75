"""The clustering family of the torch port (``models/clustering.py``) and
``ClusteringEvaluator`` held against the JAX package on the CPU: KMeans in
its three init modes (with its summary, transform, predict and cost),
GaussianMixture, BisectingKMeans, PowerIterationClustering in both init
modes (its random start JAX's threefry draw, reproduced in numpy), the
silhouette, persistence and ``kmeans_model_from_numpy`` /
``gmm_model_from_numpy``; the Lloyd sums go through one segment sum of
k slots an iteration.

Tolerances: under the float64 policy cluster sizes, assignments and iterations
exact, centers, costs, log-likelihoods and silhouettes within rtol 1e-9 (a GMM
covariance, E[xxᵀ] − μμᵀ, within rtol of the largest squared mean, the moment
it is taken from). Under the float32 policy (the JAX side with x64 off) sizes,
assignments and iterations exact and the numbers within rtol 1e-5, but for two:
the training cost, a float32 sum of expanded squared distances (‖x‖² − 2x·c +
‖c‖², whose rounding either package's sum order moves by more), within 2e-5;
and PIC on an unstructured random graph, whose float32 embedding decides
nothing (the JAX package's own float32 and float64 assignments differ there),
is held on a graph of three planted communities.
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
from sparkdq4ml_tpu.models import clustering as jc
from sparkdq4ml_tpu.models import evaluation as je
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.interop import (gmm_model_from_numpy,
                                          kmeans_model_from_numpy)
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import clustering as tc
from sparkdq4ml_tpu_torch.models import evaluation as te
from sparkdq4ml_tpu_torch.ops import kernels

POLICIES = {"float64": SimpleNamespace(name="float64", rtol=1e-9,
                                       cost=1e-9),
            "float32": SimpleNamespace(name="float32", rtol=1e-5,
                                       cost=2e-5)}


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


def blobs(n=240, d=3, seed=0):
    """Four seeded Gaussian blobs, about 10% of the rows masked out (some
    of those NaN)."""
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.normal(c, 1.0, size=(n // 4, d))
                        for c in (0.0, 4.0, 8.0, 12.0)])
    mask = rng.random(n) > 0.1
    X[np.flatnonzero(~mask)[:3]] = np.nan
    return {"features": X}, mask


def frames(cols, mask):
    return (JFrame(dict(cols), mask=mask),
            TFrame(dict(cols), mask=mask, device="cpu"))


def close(got, want, rtol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0, err_msg=what)


def predictions(model, frame, col="prediction"):
    return np.asarray(model.transform(frame).to_pydict()[col])


@pytest.mark.parametrize("mode", ["k-means||", "k-means++", "random"])
def test_kmeans_init_modes(policy, mode):
    cols, mask = blobs()
    j, t = frames(cols, mask)
    a = jc.KMeans(k=4, seed=3, init_mode=mode).fit(j)
    b = tc.KMeans(k=4, seed=3, init_mode=mode).fit(t)
    close(b.centers, a.centers, policy.rtol, "centers")
    assert b.cluster_sizes == a.cluster_sizes
    assert b.summary.num_iter == a.summary.numIter
    assert b.summary.clusterSizes == a.summary.cluster_sizes
    close(b.training_cost, a.training_cost, policy.cost, "cost")
    close(b.compute_cost(t), a.compute_cost(j), policy.cost, "compute")
    np.testing.assert_array_equal(predictions(b, t), predictions(a, j))
    x = [4.1, 3.9, 4.2]
    assert b.predict(x) == a.predict(x)


def test_kmeans_stops_at_max_iter_and_keeps_empty_centers(policy):
    cols, mask = blobs()
    j, t = frames(cols, mask)
    a = jc.KMeans(k=6, max_iter=2, seed=1, init_mode="random").fit(j)
    b = tc.KMeans(k=6, max_iter=2, seed=1, init_mode="random").fit(t)
    assert a.num_iters == b.num_iters == 2
    close(b.centers, a.centers, policy.rtol, "centers")
    assert b.cluster_sizes == a.cluster_sizes


def test_lloyd_sums_are_one_segment_sum_of_k_slots(monkeypatch):
    calls = []
    real = kernels.dense_segment_sum

    def spy(x, seg, size):
        calls.append((tuple(x.shape), size))
        return real(x, seg, size)

    monkeypatch.setattr(kernels, "dense_segment_sum", spy)
    cols, mask = blobs()
    _, t = frames(cols, mask)
    with float_policy(torch.float64):
        m = tc.KMeans(k=4, seed=3).fit(t)
    # the coordinate sums, the weight and the cost: d + 2 columns
    assert calls == [((240, 5), 4)] * (m.num_iters + 1)


def test_gaussian_mixture(policy):
    cols, mask = blobs(d=2)
    j, t = frames(cols, mask)
    a = jc.GaussianMixture(k=3, seed=1, tol=1e-3).fit(j)
    b = tc.GaussianMixture(k=3, seed=1, tol=1e-3).fit(t)
    assert b.summary.num_iter == a.summary.numIter
    for f in ("weights", "means"):
        close(getattr(b, f), getattr(a, f), policy.rtol, f)
    # a covariance is E[xxᵀ] − μμᵀ: held within rtol of the second
    # moment it is taken from
    np.testing.assert_allclose(b.covs, a.covs, rtol=policy.rtol,
                               atol=policy.rtol * np.max(a.means ** 2))
    close(b.summary.log_likelihood, a.summary.logLikelihood, policy.rtol,
          "ll")
    got, want = b.transform(t).to_pydict(), a.transform(j).to_pydict()
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    # the posteriors of one set of parameters (the port's fit) agree; the
    # two fits' parameters agree as held above
    same = jc.GaussianMixtureModel(b.weights, b.means, b.covs, b._params)
    np.testing.assert_allclose(got["probability"], same.transform(j)
                               .to_pydict()["probability"],
                               rtol=policy.rtol, atol=policy.rtol)
    x = [4.0, 4.5]
    assert b.predict(x) == a.predict(x)
    np.testing.assert_allclose(b.predictProbability(x),
                               same.predict_probability(x),
                               rtol=policy.rtol, atol=policy.rtol)
    assert len(b.gaussians) == 3 and b.gaussians_df.count() == 3


@pytest.mark.parametrize("k,min_size", [(4, 1.0), (3, 0.3), (6, 1.0)])
def test_bisecting_kmeans(policy, k, min_size):
    cols, mask = blobs()
    j, t = frames(cols, mask)
    kw = dict(k=k, seed=2, min_divisible_cluster_size=min_size)
    a = jc.BisectingKMeans(**kw).fit(j)
    b = tc.BisectingKMeans(**kw).fit(t)
    assert b.cluster_sizes == a.cluster_sizes
    np.testing.assert_array_equal(b.left, a.left)
    np.testing.assert_array_equal(b.right, a.right)
    close(b.node_centers, a.node_centers, policy.rtol, "centers")
    close(b.training_cost, a.training_cost, policy.cost, "cost")
    close(b.compute_cost(t), a.compute_cost(j), policy.cost, "compute")
    np.testing.assert_array_equal(predictions(b, t), predictions(a, j))
    assert b.k == a.k and b.predict([8.0, 8.0, 8.0]) == a.predict(
        [8.0, 8.0, 8.0])


def random_graph(nodes=60, edges=300, seed=0):
    rng = np.random.default_rng(seed)
    return {"src": rng.integers(0, nodes, edges) * 3 + 7,
            "dst": rng.integers(0, nodes, edges) * 3 + 7,
            "weight": rng.random(edges)}


def community_graph(per=30, seed=0):
    """Three planted communities: dense strong edges inside, a few weak
    ones across, duplicates and self-loops included."""
    rng = np.random.default_rng(seed)
    src, dst, w = [], [], []
    for c in range(3):
        a = rng.integers(0, per, 6 * per) + c * per
        b = rng.integers(0, per, 6 * per) + c * per
        src += list(a)
        dst += list(b)
        w += list(rng.uniform(0.5, 1.0, len(a)))
    a, b = rng.integers(0, 3 * per, 12), rng.integers(0, 3 * per, 12)
    src += list(a)
    dst += list(b)
    w += list(rng.uniform(0.0, 0.05, 12))
    return {"src": np.asarray(src), "dst": np.asarray(dst),
            "weight": np.asarray(w)}


@pytest.mark.parametrize("mode", ["random", "degree"])
def test_power_iteration_clustering(policy, mode):
    graph = random_graph() if policy.name == "float64" else \
        community_graph()
    kw = dict(k=3, init_mode=mode, seed=5, max_iter=15)
    a = jc.PowerIterationClustering(**kw).assign_clusters(
        JFrame(dict(graph))).to_pydict()
    b = tc.PowerIterationClustering(**kw).assign_clusters(
        TFrame(dict(graph), device="cpu")).to_pydict()
    np.testing.assert_array_equal(b["id"], a["id"])
    np.testing.assert_array_equal(b["cluster"], a["cluster"])


def test_pic_affinity_adds_duplicates_and_self_loops_once(policy):
    graph = {"src": np.array([0, 1, 1, 2, 2]),
             "dst": np.array([1, 0, 2, 2, 0]),
             "weight": np.array([0.5, 0.25, 1.0, 3.0, 2.0])}
    pic = tc.PowerIterationClustering(k=2)
    ids, W = pic.affinity(TFrame(graph, device="cpu"))
    assert ids.tolist() == [0, 1, 2]
    np.testing.assert_allclose(W.numpy(), [[0.0, 0.75, 2.0],
                                           [0.75, 0.0, 1.0],
                                           [2.0, 1.0, 3.0]])
    # the entries the one segment sum adds: each edge both ways, a
    # self-loop's second entry zero
    ids2, vals, slots = pic.affinity_entries(TFrame(graph, device="cpu"))
    assert ids2.tolist() == ids.tolist()
    assert slots.tolist() == [1, 3, 5, 8, 6, 3, 1, 7, 8, 2]
    assert vals.tolist() == [0.5, 0.25, 1.0, 3.0, 2.0,
                             0.5, 0.25, 1.0, 0.0, 2.0]
    assert torch.equal(
        kernels.segment_sum_reference(vals, slots, 9).reshape(3, 3), W)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_uniform_draw_is_jax_threefry(dtype, seed):
    with jax.enable_x64(True):
        want = jax.random.uniform(jax.random.PRNGKey(seed), (129,),
                                  getattr(jnp, dtype))
    got = tc.uniform_like_jax(seed, 129, np.dtype(dtype))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_pic_checks_raise_as_in_jax():
    for M in (jc, tc):
        with pytest.raises(ValueError, match="k must be"):
            M.PowerIterationClustering(k=1)
        with pytest.raises(ValueError, match="init_mode"):
            M.PowerIterationClustering(init_mode="x")
    graph = {"src": np.array([0, 1]), "dst": np.array([1, 2]),
             "weight": np.array([1.0, -1.0])}
    for M, F in ((jc, JFrame(dict(graph))),
                 (tc, TFrame(dict(graph), device="cpu"))):
        with pytest.raises(ValueError, match="nonnegative"):
            M.PowerIterationClustering(k=2).assign_clusters(F)


@pytest.mark.parametrize("k", [2, 4, 5])
def test_silhouette(policy, k):
    cols, mask = blobs()
    j, t = frames(cols, mask)
    a = jc.KMeans(k=k, seed=4).fit(j)
    b = tc.KMeans(k=k, seed=4).fit(t)
    got = te.ClusteringEvaluator().evaluate(b.transform(t))
    want = je.ClusteringEvaluator().evaluate(a.transform(j))
    assert got == pytest.approx(want, rel=policy.rtol)


def test_silhouette_edges():
    f = TFrame({"features": np.array([[0.0], [1.0], [5.0], [5.5]]),
                "prediction": np.array([0.0, 0.0, 2.0, 2.9])},
               device="cpu")
    jf = JFrame({"features": np.array([[0.0], [1.0], [5.0], [5.5]]),
                 "prediction": np.array([0.0, 0.0, 2.0, 2.9])})
    got = te.ClusteringEvaluator().evaluate(f)
    assert got == pytest.approx(je.ClusteringEvaluator().evaluate(jf),
                                rel=1e-12)
    one = f.with_column("prediction", np.zeros(4))
    assert np.isnan(te.ClusteringEvaluator().evaluate(one))
    with pytest.raises(ValueError, match="unknown metric"):
        te.ClusteringEvaluator(metric_name="davies")


def test_persistence_and_models_from_numpy(policy, tmp_path):
    cols, mask = blobs(d=2)
    j, t = frames(cols, mask)
    km = jc.KMeans(k=3, seed=2).fit(j)
    jbase.save_stage(km, str(tmp_path / "km"))
    back = tbase.load_stage(str(tmp_path / "km"))
    np.testing.assert_array_equal(predictions(back, t), predictions(km, j))
    np.testing.assert_array_equal(
        predictions(kmeans_model_from_numpy(np.asarray(km.centers)), t),
        predictions(km, j))
    bk = tc.BisectingKMeans(k=3, seed=2).fit(t)
    tbase.save_stage(bk, str(tmp_path / "bk"))
    np.testing.assert_array_equal(
        predictions(tbase.load_stage(str(tmp_path / "bk")), t),
        predictions(jbase.load_stage(str(tmp_path / "bk")), j))
    gm = jc.GaussianMixture(k=2, seed=0).fit(j)
    port = gmm_model_from_numpy(gm.weights, gm.means, gm.covs, gm._params)
    np.testing.assert_allclose(
        port.transform(t).to_pydict()["probability"],
        gm.transform(j).to_pydict()["probability"], rtol=policy.rtol,
        atol=policy.rtol)
    with pytest.raises(NotImplementedError, match="mesh"):
        tc.KMeans().fit(t, mesh=object())
