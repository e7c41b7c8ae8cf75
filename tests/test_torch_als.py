"""ALS of the port (``models/recommendation.py``) held against the JAX
package on the CPU in both float policies: the two half-steps on seeded
factors (with weights that drop ratings, entities without ratings, float
and integer ids), every single-device case of ``tests/test_als.py``
(planted low rank, loss history, predict, masked poisoned rows, cold-start
``nan`` and ``drop``, recommendations for users and items, factor frames,
implicit feedback with α = 0, 5 and 10, negative ratings), the id maps and
initial factors (``max_iter=0``), a top-k with tied scores, every
``ValueError``, save/load in both directions and
``interop.als_model_from_numpy``.

Tolerances: id maps, initial factors and top-k indices are exact; factors
and predictions within 1e-8 of their scale (the largest magnitude of the
JAX side's) under the float64 policy and 1e-4 under float32, loss
histories within the same relative tolerance or that tolerance of the
history's largest loss (of the loss at pred = 0 where a fit's loss
cancels to 4e-7 at once); a recommendation's items equal wherever the JAX side's scores
around it are more than the tolerance apart. The float64 cases run at one
intra-op thread (``tests/torch_repro.py``).
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
from sparkdq4ml_tpu.models import recommendation as jrec
from sparkdq4ml_tpu_torch import interop
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.models import base as tbase
from sparkdq4ml_tpu_torch.models import recommendation as trec
from sparkdq4ml_tpu_torch.session import TorchSession
from torch_repro import one_intra_op_thread

POLICIES = {"float64": SimpleNamespace(name="float64", tol=1e-8),
            "float32": SimpleNamespace(name="float32", tol=1e-4)}


@pytest.fixture(autouse=True)
def cpu_session():
    """A model that was not fitted here computes on the session's device:
    every case runs in a session on the CPU."""
    s = (TorchSession.builder().config("spark.torch.device", "cpu")
         .get_or_create())
    yield s
    s.stop()


@pytest.fixture(params=sorted(POLICIES))
def policy(request):
    pol = POLICIES[request.param]
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, pol.name)
    jrec._als_fit_fn.cache_clear()
    jrec._implicit_fit_fn.cache_clear()
    try:
        with jax.enable_x64(pol.name == "float64"), \
                float_policy(getattr(torch, pol.name)), \
                one_intra_op_thread():
            yield pol
    finally:
        jax_config.default_float_dtype = old
        jrec._als_fit_fn.cache_clear()
        jrec._implicit_fit_fn.cache_clear()


def close_norm(got, want, pol, what=""):
    """Within ``pol.tol`` of the largest magnitude in ``want`` (or 1)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    err = float(np.max(np.abs(got[ok] - want[ok]))) if ok.any() else 0.0
    scale = max(float(np.max(np.abs(want[ok]))) if ok.any() else 0.0, 1.0)
    assert err <= pol.tol * scale, f"{what}: off by {err}"


def frames(cols, mask=None):
    return (JFrame(dict(cols), mask=mask),
            TFrame(dict(cols), mask=mask, device="cpu"))


def planted_ratings(n_users=30, n_items=20, rank=3, frac=0.6, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, rank))
    V = rng.normal(size=(n_items, rank))
    R = U @ V.T
    obs = rng.random((n_users, n_items)) < frac
    u, i = np.nonzero(obs)
    return {"user": u.astype(np.int32), "item": i.astype(np.int32),
            "rating": R[u, i].astype(np.float32)}, R


def implicit_data(n_users=40, n_items=30, rank=3, seed=0):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, rank))
    V = rng.normal(size=(n_items, rank))
    prob = 1 / (1 + np.exp(-2.0 * (U @ V.T)))
    observed = rng.random((n_users, n_items)) < prob * 0.4
    counts = rng.poisson(3.0, size=(n_users, n_items)) + 1
    u, i = np.nonzero(observed)
    return {"user": u.astype(float), "item": i.astype(float),
            "rating": counts[u, i].astype(float)}


def same_model(a, b, pol, loss_scale=None):
    assert b.user_ids == a.user_ids and b.item_ids == a.item_ids
    close_norm(b.user_factors_arr, a.user_factors_arr, pol, "user factors")
    close_norm(b.item_factors_arr, a.item_factors_arr, pol, "item factors")
    # a loss that cancels (p − pred near 0) is held against the scale of
    # what cancels, ``loss_scale``, else against the history's largest
    h = np.asarray(a.loss_history, np.float64)
    scale = loss_scale or float(np.max(np.abs(h), initial=0.0))
    np.testing.assert_allclose(b.loss_history, h, rtol=pol.tol,
                               atol=pol.tol * scale)
    assert b.user_factors_arr.dtype == np.dtype(pol.name)


def half_step_inputs(seed, dtype, n_self=9, n_other=7, nnz=60, k=3):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n_other, k))
    idx_self = rng.integers(0, n_self - 1, nnz)        # the last has none
    idx_other = rng.integers(0, n_other, nnz)
    r = rng.normal(size=nnz) * 2.0
    w = (rng.random(nnz) > 0.2).astype(np.float64)
    return [np.asarray(v, dtype) if v.dtype.kind == "f" else v
            for v in (F, idx_self, idx_other, r, w)], n_self, k


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("implicit", [False, True])
def test_half_steps_match_the_reference(policy, weighted, implicit):
    (F, s, o, r, w), n_self, k = half_step_inputs(
        3 + weighted + 2 * implicit, np.dtype(policy.name))
    jw = jnp.asarray(w) if weighted else None
    tw = torch.as_tensor(w) if weighted else None
    if implicit:
        a = jrec._implicit_half_step(jnp.asarray(F), jnp.asarray(s),
                                     jnp.asarray(o), jnp.asarray(r), n_self,
                                     k, 0.1, 2.0, jw)
        b = trec._implicit_half_step(torch.as_tensor(F), torch.as_tensor(s),
                                     torch.as_tensor(o), torch.as_tensor(r),
                                     n_self, k, 0.1, 2.0, tw)
    else:
        a = jrec._als_half_step(jnp.asarray(F), jnp.asarray(s),
                                jnp.asarray(o), jnp.asarray(r), n_self, k,
                                0.1, jw)
        b = trec._als_half_step(torch.as_tensor(F), torch.as_tensor(s),
                                torch.as_tensor(o), torch.as_tensor(r),
                                n_self, k, 0.1, tw)
    assert b.dtype == getattr(torch, policy.name)
    close_norm(b.numpy(), np.asarray(a), policy, "half-step")
    assert np.all(b.numpy()[n_self - 1] == 0.0)
    with pytest.raises(NotImplementedError, match="mesh"):
        trec._als_half_step(torch.as_tensor(F), torch.as_tensor(s),
                            torch.as_tensor(o), torch.as_tensor(r), n_self,
                            k, 0.1, psum_axis="data")


@pytest.mark.parametrize("kw", [
    dict(rank=3, max_iter=15, reg_param=0.01, seed=1),
    dict(rank=3, max_iter=10, reg_param=0.01, seed=1, data_seed=2),
    dict(rank=2, max_iter=5, seed=1),
    dict(rank=4, max_iter=5, seed=1),
])
def test_explicit_fit_matches_the_reference(policy, kw):
    kw = dict(kw)
    cols, _ = planted_ratings(seed=kw.pop("data_seed", 0))
    j, t = frames(cols)
    a = jrec.ALS(**kw).fit(j)
    b = trec.ALS(**kw).fit(t)
    same_model(a, b, policy)
    close_norm(b.transform(t).to_pydict()["prediction"],
               a.transform(j).to_pydict()["prediction"], policy,
               "predictions")
    assert b.predict(int(cols["user"][0]), int(cols["item"][0])) == \
        pytest.approx(a.predict(int(cols["user"][0]),
                                int(cols["item"][0])),
                      rel=policy.tol, abs=policy.tol)
    assert b.rank == a.rank == kw["rank"]


def test_reconstructs_planted_low_rank(policy):
    cols, _ = planted_ratings()
    t = TFrame(cols, device="cpu")
    model = trec.ALS(rank=3, max_iter=15, reg_param=0.01, seed=1).fit(t)
    out = model.transform(t).to_pydict()
    err = np.asarray(out["prediction"], np.float64) - out["rating"]
    assert float(np.sqrt(np.mean(err ** 2))) < 0.1
    h = model.loss_history
    assert len(h) == 15 and h[-1] < h[0]


def test_id_maps_and_initial_factors_are_exact(policy):
    rng = np.random.default_rng(11)
    cols = {"user": rng.choice([7, 3, 99, 42, 5], 40).astype(np.int64),
            "item": rng.choice([1000, 2, 17], 40).astype(np.int32),
            "rating": rng.normal(size=40)}
    j, t = frames(cols)
    a = jrec.ALS(rank=3, max_iter=0, seed=5).fit(j)
    b = trec.ALS(rank=3, max_iter=0, seed=5).fit(t)
    assert b.user_ids == a.user_ids == [3, 5, 7, 42, 99]
    assert b.item_ids == a.item_ids
    np.testing.assert_array_equal(b.user_factors_arr, a.user_factors_arr)
    np.testing.assert_array_equal(b.item_factors_arr, a.item_factors_arr)
    assert b.loss_history == a.loss_history == []


def test_masked_rows_excluded(policy):
    cols, _ = planted_ratings(n_users=8, n_items=6, frac=1.0)
    cols["rating"] = np.where(np.arange(48) == 0, 1e6,
                              cols["rating"]).astype(np.float32)
    keep = cols["rating"] < 1e5
    cols_nan = dict(cols, rating=np.where(keep, cols["rating"], np.nan))
    for c in (cols, cols_nan):
        j, t = frames(c, mask=keep)
        a = jrec.ALS(rank=3, max_iter=10, reg_param=0.01, seed=1).fit(j)
        b = trec.ALS(rank=3, max_iter=10, reg_param=0.01, seed=1).fit(t)
        same_model(a, b, policy)
        assert np.abs(b.user_factors_arr).max() < 100


@pytest.mark.parametrize("strategy", ["nan", "drop"])
def test_cold_start(policy, strategy):
    cols, _ = planted_ratings(n_users=5, n_items=4, frac=1.0)
    j, t = frames(cols)
    a = jrec.ALS(rank=2, max_iter=5, seed=1,
                 cold_start_strategy=strategy).fit(j)
    b = trec.ALS(rank=2, max_iter=5, seed=1,
                 cold_start_strategy=strategy).fit(t)
    unseen = {"user": np.asarray([0, 999, 3, 2], np.int32),
              "item": np.asarray([0, 1, 77, 3], np.int32),
              "rating": [0.0, 0.0, 0.0, 0.0]}
    ju, tu = frames(unseen)
    pa = a.transform(ju).to_pydict()["prediction"]
    pb = b.transform(tu).to_pydict()["prediction"]
    close_norm(pb, pa, policy, "cold-start predictions")
    if strategy == "nan":
        assert np.isfinite(pb[0]) and np.isnan(pb[1]) and np.isnan(pb[2])
    else:
        assert b.transform(tu).count() == 2
    assert np.isnan(b.predict(999, 0))


def _same_recs(a, b, id_col, pol):
    da, db = a.to_pydict(), b.to_pydict()
    np.testing.assert_array_equal(db[id_col], da[id_col])
    for ra, rb in zip(da["recommendations"], db["recommendations"]):
        assert len(ra) == len(rb)
        sa = np.asarray([s for _, s in ra], np.float64)
        sb = np.asarray([s for _, s in rb], np.float64)
        close_norm(sb, sa, pol, "scores")
        # scores within tol·scale of each other may swap places
        near = 2 * pol.tol * max(float(np.max(np.abs(sa), initial=0.0)),
                                 1.0)
        gap = np.abs(np.diff(sa))
        for pos, ((ia, _), (ib, _)) in enumerate(zip(ra, rb)):
            if ((pos == 0 or gap[pos - 1] > near)
                    and (pos == len(ra) - 1 or gap[pos] > near)):
                assert ia == ib


def test_recommendations_match_the_reference(policy):
    cols, R = planted_ratings(n_users=10, n_items=8, frac=1.0)
    j, t = frames(cols)
    a = jrec.ALS(rank=3, max_iter=15, reg_param=0.01, seed=1).fit(j)
    b = trec.ALS(rank=3, max_iter=15, reg_param=0.01, seed=1).fit(t)
    _same_recs(a.recommend_for_all_users(3), b.recommendForAllUsers(3),
               "user", policy)
    _same_recs(a.recommend_for_all_items(2), b.recommendForAllItems(2),
               "item", policy)
    d = b.recommend_for_all_users(3).to_pydict()
    for u, rec in zip(d["user"], d["recommendations"]):
        best = int(np.argmax(R[int(u)]))
        assert rec[0][0] == best or rec[1][0] == best
        assert rec[0][1] >= rec[1][1] >= rec[2][1]
    # more than the items: every item, as jax.lax.top_k would cap it
    assert len(b.recommend_for_all_items(50).to_pydict()[
        "recommendations"][0]) == 10


@pytest.mark.parametrize("num", [1, 2, 3, 5, 6])
def test_top_k_ties_keep_the_lower_index_first(policy, num):
    """Equal item factors give equal scores: jax.lax.top_k puts the lower
    index first, and so must the port."""
    U = np.asarray([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [0.0, 0.0]])
    V = np.asarray([[1.0, 1.0], [2.0, 0.0], [1.0, 1.0], [2.0, 0.0],
                    [0.0, 2.0], [1.0, 1.0]])
    users, items = [10, 11, 12, 13], [100, 101, 102, 103, 104, 105]
    a = jrec.ALSModel(U, V, users, items)
    b = interop.als_model_from_numpy(U, V, users, items)
    ra = a.recommend_for_all_users(num).to_pydict()["recommendations"]
    rb = b.recommend_for_all_users(num).to_pydict()["recommendations"]
    for x, y in zip(ra, rb):
        assert [i for i, _ in y] == [i for i, _ in x]
        assert [s for _, s in y] == [s for _, s in x]
    ra = a.recommend_for_all_items(num).to_pydict()["recommendations"]
    rb = b.recommend_for_all_items(num).to_pydict()["recommendations"]
    for x, y in zip(ra, rb):
        assert [i for i, _ in y] == [i for i, _ in x]


def test_top_k_rows_against_a_stable_sort():
    rng = np.random.default_rng(2)
    scores = torch.as_tensor(rng.integers(0, 4, (50, 37)).astype(
        np.float32))
    scores[3] = -0.0
    scores[4, ::2] = 0.0
    for k in (1, 5, 37):
        vals, idx = trec.top_k_rows(scores, k)
        want = torch.sort(scores + 0.0, dim=1, descending=True, stable=True)
        assert torch.equal(idx, want.indices[:, :k])
        assert torch.equal(vals, want.values[:, :k])


def test_factor_frames(policy):
    cols, _ = planted_ratings(n_users=6, n_items=5, frac=1.0)
    j, t = frames(cols)
    a = jrec.ALS(rank=4, max_iter=5, seed=1).fit(j)
    b = trec.ALS(rank=4, max_iter=5, seed=1).fit(t)
    for fa, fb in ((a.user_factors, b.userFactors),
                   (a.item_factors, b.itemFactors)):
        da, db = fa.to_pydict(), fb.to_pydict()
        np.testing.assert_array_equal(db["id"], da["id"])
        close_norm(np.stack(db["features"]), np.stack(da["features"]),
                   policy, "factor frame")
    assert b.user_factors.to_pydict()["features"][0].shape == (4,)


@pytest.mark.parametrize("kw", [
    dict(rank=8, max_iter=15, reg_param=0.05, alpha=10.0, seed=0),
    dict(rank=6, max_iter=10, alpha=5.0, seed=0, data_seed=1),
    dict(rank=5, max_iter=12, alpha=5.0, seed=0, data_seed=2),
    dict(rank=4, max_iter=8, alpha=0.0, seed=0, data_seed=3),
])
def test_implicit_fit_matches_the_reference(policy, kw):
    kw = dict(kw)
    cols = implicit_data(seed=kw.pop("data_seed", 0))
    j, t = frames(cols)
    a = jrec.ALS(implicit_prefs=True, **kw).fit(j)
    b = trec.ALS(implicit_prefs=True, **kw).fit(t)
    same_model(a, b, policy)
    close_norm(b.transform(t).to_pydict()["prediction"],
               a.transform(j).to_pydict()["prediction"], policy,
               "predictions")
    assert np.all(np.isfinite(b.user_factors_arr))
    assert b.loss_history[-1] < b.loss_history[0]


def test_implicit_negative_ratings_zero_preference(policy):
    cols = {"user": np.asarray([0.0, 0.0, 1.0, 1.0]),
            "item": np.asarray([0.0, 1.0, 0.0, 1.0]),
            "rating": np.asarray([5.0, -5.0, -5.0, 5.0])}
    j, t = frames(cols)
    kw = dict(rank=2, max_iter=20, implicit_prefs=True, alpha=20.0,
              reg_param=0.01, seed=0)
    a = jrec.ALS(**kw).fit(j)
    b = trec.ALS(**kw).fit(t)
    # the fit reaches 4e-7 at once: the loss is p − pred cancelling, held
    # against mean(c·p²), the loss at pred = 0
    r = cols["rating"]
    same_model(a, b, policy,
               loss_scale=float(np.mean((1 + 20.0 * np.abs(r)) * (r > 0))))
    assert b.predict(0, 0) > b.predict(0, 1)
    assert b.predict(1, 1) > b.predict(1, 0)


def test_implicit_ranking_quality():
    cols = implicit_data()
    observed = np.zeros((40, 30), bool)
    observed[cols["user"].astype(int), cols["item"].astype(int)] = True
    model = trec.ALS(rank=8, max_iter=15, reg_param=0.05,
                     implicit_prefs=True, alpha=10.0, seed=0).fit(
        TFrame(cols, device="cpu"))
    scores = model.user_factors_arr @ model.item_factors_arr.T
    aucs = [np.mean(scores[u][observed[u]][:, None]
                    > scores[u][~observed[u]][None, :])
            for u in range(40) if observed[u].any() and (~observed[u]).any()]
    assert np.mean(aucs) > 0.75


def test_validations():
    with pytest.raises(ValueError, match="alpha"):
        trec.ALS(implicit_prefs=True, alpha=-1.0)
    with pytest.raises(ValueError, match="alpha"):
        trec.ALS().set_alpha(-0.5)
    with pytest.raises(ValueError, match="rank"):
        trec.ALS(rank=0)
    with pytest.raises(ValueError, match="rank"):
        trec.ALS().setRank(0)
    with pytest.raises(ValueError, match="cold_start_strategy"):
        trec.ALS(cold_start_strategy="keep")
    with pytest.raises(ValueError, match="cold_start_strategy"):
        trec.ALS().setColdStartStrategy("keep")
    assert trec.ALS(implicit_prefs=True).implicit_prefs is True
    cols, _ = planted_ratings(n_users=4, n_items=3, frac=1.0)
    t = TFrame(cols, mask=np.zeros(12, bool), device="cpu")
    with pytest.raises(ValueError, match="no valid rows"):
        trec.ALS().fit(t)
    bad = dict(cols, rating=np.where(np.arange(12) == 2, np.inf,
                                     cols["rating"]))
    with pytest.raises(ValueError, match="NaN/inf"):
        trec.ALS().fit(TFrame(bad, device="cpu"))
    with pytest.raises(NotImplementedError, match="mesh"):
        trec.ALS().fit(TFrame(cols, device="cpu"), mesh=object())
    est = (trec.ALS().setRank(3).setMaxIter(2).setRegParam(0.2)
           .setUserCol("u").setItemCol("i").setRatingCol("r")
           .setImplicitPrefs(True).setAlpha(2.0).setSeed(4))
    assert (est.rank, est.max_iter, est.reg_param, est.user_col,
            est.item_col, est.rating_col, est.implicit_prefs, est.alpha,
            est.seed) == (3, 2, 0.2, "u", "i", "r", True, 2.0, 4)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("implicit", [False, True])
def test_persistence_both_ways(tmp_path, direction, implicit):
    cols = implicit_data(seed=4) if implicit else \
        planted_ratings(n_users=6, n_items=5, frac=1.0)[0]
    j, t = frames(cols)
    kw = dict(rank=4 if implicit else 2, max_iter=6 if implicit else 5,
              implicit_prefs=implicit, seed=0 if implicit else 1)
    path = str(tmp_path / "als")
    if direction == "port_to_jax":
        src = trec.ALS(**kw).fit(t)
        src.save(path)
        back = jbase.load_stage(path)
        out, src_out = back.transform(j), src.transform(t)
    else:
        src = jrec.ALS(**kw).fit(j)
        src.save(path)
        back = tbase.load_stage(path)
        assert isinstance(back, trec.ALSModel)
        out, src_out = back.transform(t), src.transform(j)
    np.testing.assert_allclose(back.user_factors_arr, src.user_factors_arr)
    assert back._params["implicit_prefs"] is implicit
    assert back.predict(0, 0) == pytest.approx(src.predict(0, 0), rel=1e-6)
    np.testing.assert_allclose(out.to_pydict()["prediction"],
                               src_out.to_pydict()["prediction"],
                               rtol=1e-6)
    assert out.count() == src_out.count()
    est = trec.ALS(rank=5, implicit_prefs=True, alpha=3.0)
    est.save(str(tmp_path / "est"))
    other = jbase.load_stage(str(tmp_path / "est"))
    assert {k: getattr(other, k) for k in est._persist_attrs} == \
        {k: getattr(est, k) for k in est._persist_attrs}


def test_interop_model_predicts_as_the_reference(policy):
    cols, _ = planted_ratings(seed=5)
    j, t = frames(cols)
    a = jrec.ALS(rank=3, max_iter=8, reg_param=0.05, seed=2,
                 cold_start_strategy="drop").fit(j)
    b = interop.als_model_from_numpy(
        np.asarray(a.user_factors_arr), np.asarray(a.item_factors_arr),
        a.user_ids, a.item_ids, a._params, a.loss_history)
    close_norm(b.transform(t).to_pydict()["prediction"],
               a.transform(j).to_pydict()["prediction"], policy,
               "predictions")
    assert b.predict(3, 4) == a.predict(3, 4)
    _same_recs(a.recommend_for_all_users(4), b.recommend_for_all_users(4),
               "user", policy)


def test_loaded_model_computes_on_the_sessions_device(tmp_path,
                                                      cpu_session):
    """A loaded model, and one built by ``interop`` without a device,
    recommends on the session's device; with no session it asks for the
    card, and refuses where there is none."""
    cols, _ = planted_ratings(n_users=6, n_items=5, frac=1.0)
    src = trec.ALS(rank=2, max_iter=3, seed=1).fit(TFrame(cols,
                                                          device="cpu"))
    src.save(str(tmp_path / "als"))
    loaded = tbase.load_stage(str(tmp_path / "als"))
    built = interop.als_model_from_numpy(
        src.user_factors_arr, src.item_factors_arr, src.user_ids,
        src.item_ids, src._params)
    for m in (loaded, built):
        assert m.device == cpu_session.device
        assert m.recommend_for_all_users(2).device == cpu_session.device
        assert m.item_factors.device == cpu_session.device
    def recs(model, user_side):
        out = (model.recommend_for_all_users(2) if user_side
               else model.recommend_for_all_items(3))
        return list(out.to_pydict()["recommendations"])

    assert recs(loaded, False) == recs(src, False)
    cpu_session.stop()
    if torch.cuda.is_available():
        assert loaded.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loaded.recommend_for_all_users(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            built.user_factors
    # a model given its device keeps it without a session
    pinned = interop.als_model_from_numpy(
        src.user_factors_arr, src.item_factors_arr, src.user_ids,
        src.item_ids, src._params, device="cpu")
    assert recs(pinned, True) == recs(src, True)
