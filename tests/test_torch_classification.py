"""The classification family of the torch port (``models/classification.py``)
held against the JAX package on the CPU: the packed fits with their cores
and the two drivers (binomial Newton and FISTA, softmax Newton and FISTA,
the squared-hinge SVC), NaiveBayes' statistics, each estimator with and
without ``weight_col``, ``fit_intercept=False`` and
``standardization=False``, the summaries with their curves and
by-threshold frames, OneVsRest, a CrossValidator over LogisticRegression,
the label checks, and the tour's classifier section on dataset-full
(``examples/ml_pipeline_tour.py``) with ``chip_smoke.py``'s golden
constants.

Tolerances: under the float64 policy, iterations, ``converged`` and
predictions are exact, coefficients and objectives agree within rtol 1e-9
and curves within 1e-12. Under the float32 policy, with the JAX side under
``jax.enable_x64(False)``: within 1e-4 and iterations within 1, each
widened by twice what the reference's own float32 result moves when every
nonzero feature is nudged by one ulp (``nudged``) and, for the packed fits,
when its rows come in another order, so that every sum adds them in
another order. Some of these fits are that sensitive in float32: a one-ulp
nudge moves the reference's coefficients by up to 1.6e-4, or stops its
FISTA six steps sooner, and a reordering moves a softmax coefficient of
4e-3 by 1e-6, a quarter of a thousandth.
"""

import importlib.util
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import dataset_path, prepare_features, run_dq_pipeline
from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JaxFrame
from sparkdq4ml_tpu.models import classification as jc
from sparkdq4ml_tpu.models import evaluation as jax_eval
from sparkdq4ml_tpu.models import tuning as jax_tuning
from sparkdq4ml_tpu.parallel import distributed as jax_dist
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame
from sparkdq4ml_tpu_torch.models import classification as tc
from sparkdq4ml_tpu_torch.models import evaluation, tuning
from sparkdq4ml_tpu_torch.ops import kernels
from sparkdq4ml_tpu_torch.parallel import distributed
from sparkdq4ml_tpu_torch.sql import default_catalog

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-9
CURVE_TOL = 1e-12
POLICIES = {"float64": SimpleNamespace(name="float64", rtol=RTOL,
                                       curve=CURVE_TOL, iters=0,
                                       np=np.float64),
            "float32": SimpleNamespace(name="float32", rtol=1e-4,
                                       curve=1e-4, iters=1,
                                       np=np.float32)}


@pytest.fixture(params=sorted(POLICIES))
def policy(request):
    """Both packages under one float policy; yields its tolerances."""
    pol = POLICIES[request.param]
    old = jax_config.default_float_dtype
    jax_config.default_float_dtype = getattr(jnp, pol.name)
    try:
        with jax.enable_x64(pol.name == "float64"), \
                float_policy(getattr(torch, pol.name)):
            yield pol
    finally:
        jax_config.default_float_dtype = old


@pytest.fixture
def float64():
    with float_policy(torch.float64):
        yield POLICIES["float64"]


def table(n=300, d=3, seed=0, classes=2):
    """Seeded numpy columns (features, label, w) and a 20% mask: labels
    from a noisy linear score, cut at its quantiles into ``classes``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)) * rng.uniform(0.5, 2.0, d) + rng.normal(
        size=d)
    score = X @ rng.normal(size=d) + rng.normal(size=n)
    cuts = np.quantile(score, np.linspace(0, 1, classes + 1)[1:-1])
    y = np.digitize(score, cuts).astype(np.float64)
    mask = rng.random(n) > 0.2
    return {"features": X, "label": y,
            "w": rng.uniform(0.5, 2.0, n)}, mask


def frames(cols, mask):
    return (Frame(cols, mask=mask, device="cpu"),
            JaxFrame(cols, mask=mask))


def nudged(X, seed=0):
    """``X`` in float32 with each nonzero entry one ulp up or down."""
    X = np.asarray(X, np.float32)
    to = np.where(np.random.default_rng(seed).random(X.shape) < 0.5,
                  np.inf, -np.inf).astype(np.float32)
    return np.where(X != 0, np.nextafter(X, to), X)


def reference(pol, fn, X):
    """The reference's result ``fn(X)``, and the list of its results on
    perturbed inputs: under the float32 policy ``[fn(nudged(X))]``, else
    empty."""
    return fn(X), ([fn(nudged(X))] if pol.iters else [])


def close(got, want, pol, what="", moved=()):
    """``got`` against the reference's ``want``; under the float32 policy
    the tolerance widens by twice the farthest that one of ``moved`` (the
    reference on perturbed inputs) lies from ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    spread = np.zeros_like(want)
    for m in moved:
        spread = np.maximum(spread, np.abs(want - np.asarray(m, np.float64)))
    slack = pol.rtol * np.abs(want) + pol.rtol * 1e-3 + 2 * spread
    bad = ~(np.abs(got - want) <= slack)
    assert not bad.any(), (f"{what}: {got[bad]} vs {want[bad]} (spread "
                           f"{spread[bad]})")


def same_iterations(got, want, pol, moved=()):
    spread = max((abs(int(want) - int(m)) for m in moved), default=0)
    assert abs(int(got) - int(want)) <= pol.iters + spread


# ---------------------------------------------------------------------------
# packing, feature statistics, the packed fits (cores and drivers)
# ---------------------------------------------------------------------------

def test_pack_design_weighted_matches_the_reference(float64):
    cols, mask = table()
    w = np.where(mask, cols["w"], 0.0)
    got = distributed.pack_design_weighted(
        torch.as_tensor(cols["features"]), torch.as_tensor(cols["label"]),
        torch.as_tensor(mask), torch.as_tensor(w))
    want = jax_dist.pack_design_weighted(cols["features"], cols["label"],
                                         mask, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unpack_fit_result_decodes_the_logistic_layout(float64):
    """[coef | intercept | iterations | converged | history], the layout of
    the reference's _pack_logistic_result."""
    r = jc.LogisticFitResult(jnp.asarray([1.5, -2.0]), jnp.asarray(0.25),
                             jnp.asarray(7), jnp.arange(5.0),
                             jnp.asarray(True))
    got = distributed.unpack_fit_result(
        np.asarray(jc._pack_logistic_result(r)), 2)
    np.testing.assert_array_equal(got.coefficients, [1.5, -2.0])
    assert (got.intercept, got.iterations, got.converged) == (0.25, 7, True)
    np.testing.assert_array_equal(got.objective_history, np.arange(5.0))


@pytest.mark.parametrize("weighted", [False, True])
def test_feature_stats_match_the_reference(policy, weighted):
    cols, mask = table(seed=3)
    w = np.where(mask, cols["w"], 0.0) if weighted else mask
    X = cols["features"].astype(policy.np)
    n, std = tc._feature_stats(torch.as_tensor(X), None,
                               torch.as_tensor(w))
    jn, jstd = jc._feature_stats(jnp.asarray(X), None, jnp.asarray(w))
    close(n, jn, policy)
    close(std, jstd, policy)


def packed_inputs(cols, mask, weighted, dtype):
    if weighted:
        Z = jax_dist.pack_design_weighted(
            cols["features"], cols["label"], mask,
            np.where(mask, cols["w"], 0.0))
    else:
        Z = jax_dist.pack_design(cols["features"], cols["label"], mask)
    return np.asarray(Z, dtype)


LOGISTIC_CONFIGS = [(True, True), (False, True), (True, False)]


def same_fit(got, want, pol, d, moved=()):
    """Two flat binomial results (the logistic layout)."""
    def unpack(flat):
        return distributed.unpack_fit_result(np.asarray(flat, np.float64), d)
    g, w, ms = unpack(got), unpack(want), [unpack(m) for m in moved]
    same_iterations(g.iterations, w.iterations, pol,
                    [m.iterations for m in ms])
    if pol.iters == 0:
        assert g.converged == w.converged
        close(g.objective_history, w.objective_history, pol)
    close(g.coefficients, w.coefficients, pol, "coefficients",
          [m.coefficients for m in ms])
    close(g.intercept, w.intercept, pol, "intercept",
          [m.intercept for m in ms])


def packed_reference(pol, fn, Z, d):
    """The reference's packed fit of ``Z`` and, under the float32 policy,
    its fits of ``Z`` with its d feature columns nudged and of ``Z`` with
    its rows in another order."""
    def run(X, rows=slice(None)):
        return fn(jnp.asarray(np.concatenate(
            [np.asarray(X, pol.np), Z[:, d:]], axis=1)[rows]))
    want, moved = reference(pol, run, Z[:, :d])
    if moved:
        moved.append(run(Z[:, :d],
                         np.random.default_rng(0).permutation(len(Z))))
    return want, moved


@pytest.mark.parametrize("solver,reg,alpha", [("newton", 0.05, 0.0),
                                              ("newton", 0.0, 0.0),
                                              ("fista", 0.05, 0.5),
                                              ("fista", 0.02, 1.0)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("fit_intercept,standardization", LOGISTIC_CONFIGS)
def test_logistic_packed_fit_matches_the_reference(
        policy, solver, reg, alpha, weighted, fit_intercept,
        standardization):
    cols, mask = table(seed=1)
    Z = packed_inputs(cols, mask, weighted, policy.np)
    args = (60, 1e-6, fit_intercept, standardization)
    fit = jc.fused_logistic_fit_packed(None, *args, weighted=weighted,
                                       solver=solver)
    want, moved = packed_reference(
        policy, lambda Zj: fit(Zj, jnp.asarray([reg, alpha], policy.np)),
        Z, 3)
    got = tc.fused_logistic_fit_packed(*args, weighted=weighted,
                                       solver=solver)(
        torch.as_tensor(Z), reg, alpha)
    same_fit(got, want, policy, 3, moved)


def same_softmax(got, want, pol, K, d, moved=()):
    """Two flat softmax results. The loss does not change when every
    intercept moves by one constant, and an unpenalized direction is
    solved only up to the jitter, so the intercepts are compared centered,
    as the estimator's identifiability pivot leaves them."""
    def unpack(flat):
        r = jc.unpack_softmax_result(np.asarray(flat, np.float64), K, d)
        b = r.intercept_vector
        return r._replace(intercept_vector=b - b.mean())
    g, w, ms = unpack(got), unpack(want), [unpack(m) for m in moved]
    same_iterations(g.iterations, w.iterations, pol,
                    [m.iterations for m in ms])
    if pol.iters == 0:
        assert g.converged == w.converged
        close(g.objective_history, w.objective_history, pol)
    close(g.coefficient_matrix, w.coefficient_matrix, pol, "coefficients",
          [m.coefficient_matrix for m in ms])
    close(g.intercept_vector, w.intercept_vector, pol, "intercepts",
          [m.intercept_vector for m in ms])


@pytest.mark.parametrize("solver,reg,alpha", [("newton", 0.05, 0.0),
                                              ("fista", 0.05, 0.5)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("fit_intercept,standardization", LOGISTIC_CONFIGS)
def test_softmax_packed_fit_matches_the_reference(
        policy, solver, reg, alpha, weighted, fit_intercept,
        standardization):
    cols, mask = table(seed=2, classes=3)
    Z = packed_inputs(cols, mask, weighted, policy.np)
    args = (60, 1e-6, fit_intercept, standardization)
    fit = jc.fused_softmax_fit_packed(None, 3, *args, weighted=weighted,
                                      solver=solver)
    want, moved = packed_reference(
        policy, lambda Zj: fit(Zj, jnp.asarray([reg, alpha], policy.np)),
        Z, 3)
    got = tc.fused_softmax_fit_packed(3, *args, weighted=weighted,
                                      solver=solver)(
        torch.as_tensor(Z), reg, alpha)
    same_softmax(got, want, policy, 3, 3, moved)


@pytest.mark.parametrize("reg", [0.0, 0.1])
@pytest.mark.parametrize("fit_intercept,standardization", LOGISTIC_CONFIGS)
def test_svc_packed_fit_matches_the_reference(policy, reg, fit_intercept,
                                              standardization):
    cols, mask = table(seed=4)
    Z = packed_inputs(cols, mask, False, policy.np)
    args = (80, 1e-6, fit_intercept, standardization)
    fit = jc.fused_svc_fit_packed(None, *args)
    want, moved = packed_reference(
        policy, lambda Zj: fit(Zj, jnp.asarray([reg, 0.0], policy.np)), Z, 3)
    got = tc.fused_svc_fit_packed(*args)(torch.as_tensor(Z), reg)
    same_fit(got, want, policy, 3, moved)


@pytest.mark.parametrize("every", [1, 3, 7, 1000])
@pytest.mark.parametrize("which", ["logistic", "softmax", "svc"])
def test_fista_latch_reads_leave_the_result_unchanged(float64, monkeypatch,
                                                      every, which):
    """Reading the latch every step, every few steps or never gives the
    same bits: the steps after convergence are frozen."""
    cols, mask = table(seed=5, classes=3 if which == "softmax" else 2)
    Z = torch.as_tensor(packed_inputs(cols, mask, False, np.float64))
    fits = {"logistic": lambda: tc.fused_logistic_fit_packed(
                200, 1e-5, True, True)(Z, 0.02, 0.5),
            "softmax": lambda: tc.fused_softmax_fit_packed(
                3, 200, 1e-5, True, True)(Z, 0.02, 0.5),
            "svc": lambda: tc.fused_svc_fit_packed(200, 1e-5, True,
                                                   True)(Z, 0.05)}
    want = fits[which]()
    monkeypatch.setattr(tc, "FISTA_CHECK_EVERY", every)
    assert torch.equal(fits[which](), want)


def test_fista_reads_its_latch_every_few_steps(float64, monkeypatch):
    """Host reads of the FISTA driver: one latch read every
    FISTA_CHECK_EVERY steps after the first, until it has closed."""
    cols, mask = table(seed=5)
    Z = torch.as_tensor(packed_inputs(cols, mask, False, np.float64))
    reads = []
    real = tc._fista_drive

    def counted(*args, **kwargs):
        done = torch.Tensor.__bool__

        def read(t):
            reads.append(1)
            return done(t)
        monkeypatch.setattr(torch.Tensor, "__bool__", read)
        try:
            return real(*args, **kwargs)
        finally:
            monkeypatch.setattr(torch.Tensor, "__bool__", done)
    monkeypatch.setattr(tc, "_fista_drive", counted)
    flat = tc.fused_logistic_fit_packed(200, 1e-5, True, True)(Z, 0.02, 0.5)
    iters = int(distributed.unpack_fit_result(flat, 3).iterations)
    assert 0 < iters < 200
    assert len(reads) == -(-iters // tc.FISTA_CHECK_EVERY)


def test_newton_hessian_is_the_masked_gramian(float64):
    """The binomial Newton Hessian (Za·s)ᵀZa, Za = [Xs, mask], is the
    masked Gramian of Xs with weight √s at rows and columns [0..d-1, d+1]."""
    cols, mask = table(seed=6)
    X = torch.as_tensor(cols["features"])
    wm = torch.as_tensor(mask).to(X.dtype)
    Xs = X * wm[:, None]
    s = torch.rand(X.shape[0], dtype=X.dtype) * wm
    Za = torch.cat([Xs, wm[:, None]], dim=1)
    A = kernels.masked_gram(Xs, torch.as_tensor(cols["label"]),
                            torch.sqrt(s))
    idx = torch.tensor([0, 1, 2, 4])
    np.testing.assert_allclose(A[idx][:, idx].numpy(),
                               ((Za * s[:, None]).T @ Za).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("k,d", [(2, 3), (3, 3), (5, 3000)])
def test_naive_bayes_statistics_match_the_reference(policy, k, d):
    """Up to a text width: five classes over three thousand features."""
    cols, mask = table(seed=7, classes=k, d=d)
    X = np.abs(cols["features"]).astype(policy.np)
    y = np.where(mask, cols["label"], 0.0).astype(policy.np)
    w = np.where(mask, cols["w"], 0.0).astype(policy.np)
    got = tc._nb_sufficient_stats(torch.as_tensor(X), torch.as_tensor(y),
                                  torch.as_tensor(w), k)
    want = jc._nb_sufficient_stats(jnp.asarray(X), jnp.asarray(y),
                                   jnp.asarray(w), k)
    for g, w_ in zip(got, want):
        close(g, w_, policy)


# K·(d+1) = 243 stays under the Newton cap; 4·101 = 404 goes to FISTA
WIDE_CASES = [("newton", 3, 80, 0.05, 0.0), ("fista", 4, 100, 0.05, 0.5)]


@pytest.mark.parametrize("solver,k,d,reg,alpha", WIDE_CASES)
def test_wide_softmax_packed_fit_matches_the_reference(float64, solver, k, d,
                                                       reg, alpha):
    """K > 2 classes at about a hundred features: the softmax gradient and
    Hessian contractions at the widths the router sends to each solver."""
    cols, mask = table(n=400, d=d, seed=18, classes=k)
    Z = packed_inputs(cols, mask, True, np.float64)
    args = (40, 1e-6, True, True)
    want = jc.fused_softmax_fit_packed(None, k, *args, weighted=True,
                                       solver=solver)(
        jnp.asarray(Z), jnp.asarray([reg, alpha]))
    got = tc.fused_softmax_fit_packed(k, *args, weighted=True,
                                      solver=solver)(
        torch.as_tensor(Z), reg, alpha)
    same_softmax(got, want, float64, k, d)


def test_softmax_hessian_chunks_leave_the_fit_unchanged(float64,
                                                        monkeypatch):
    """The softmax Newton Hessian summed over chunks of 37 rows, against
    one chunk: the same fit up to the order of the sums."""
    cols, mask = table(n=400, d=20, seed=19, classes=3)
    Z = torch.as_tensor(packed_inputs(cols, mask, False, np.float64))

    def fit():
        return tc.fused_softmax_fit_packed(3, 40, 1e-6, True, True,
                                           solver="newton")(Z, 0.05, 0.0)
    whole = fit()
    monkeypatch.setattr(tc, "HESSIAN_CHUNK_ELEMENTS", 37 * (9 + 21 * 21))
    same_softmax(fit(), whole, float64, 3, 20)


# ---------------------------------------------------------------------------
# the estimators
# ---------------------------------------------------------------------------

BINOMIAL = [{}, {"reg_param": 0.05}, {"reg_param": 0.05,
                                       "elastic_net_param": 0.5},
            {"weight_col": "w"},
            {"weight_col": "w", "reg_param": 0.05, "elastic_net_param": 1.0},
            {"fit_intercept": False}, {"standardization": False,
                                       "reg_param": 0.1},
            {"standardization": False, "reg_param": 0.1,
             "elastic_net_param": 0.5},
            {"family": "multinomial", "reg_param": 0.05}]
MULTINOMIAL = [{}, {"reg_param": 0.05}, {"reg_param": 0.05,
                                          "elastic_net_param": 0.5},
               {"weight_col": "w", "reg_param": 0.05},
               {"fit_intercept": False, "reg_param": 0.05},
               {"standardization": False, "reg_param": 0.1}]
LR_CASES = [(2, kw) for kw in BINOMIAL] + [(3, kw) for kw in MULTINOMIAL]


def lr_id(case):
    k, kw = case
    return f"k{k}-" + ("-".join(f"{a}={b}" for a, b in kw.items())
                       or "defaults")


def same_predictions(out, jout, pol, cols=("prediction",)):
    got, want = out.to_pydict(), jout.to_pydict()
    for c in cols:
        if pol.iters == 0:
            np.testing.assert_array_equal(got[c], np.asarray(want[c]))
        else:
            assert np.mean(got[c] == np.asarray(want[c])) > 0.99


def fit_both(pol, make, cols, mask, numbers, nudge=True):
    """``numbers(model, frame)`` of the port's fit (``make(tc)``) and of the
    reference's (``make(jc)``), the latter also on nudged features under
    the float32 policy (``nudge``): (got, want, moved)."""
    df = Frame(cols, mask=mask, device="cpu")
    got = numbers(make(tc).fit(df), df)

    def ref(X):
        jdf = JaxFrame(dict(cols, features=X), mask=mask)
        return numbers(make(jc).fit(jdf), jdf)
    if not nudge:
        return got, ref(cols["features"]), []
    return (got, *reference(pol, ref, cols["features"]))


def same_numbers(got, want, moved, pol):
    """Dicts of ``numbers``: predictions and iterations by their rules,
    the rest by ``close``; the objective history under float64 only."""
    for k, w in want.items():
        m = [mv[k] for mv in moved]
        if k == "prediction":
            if pol.iters == 0:
                np.testing.assert_array_equal(got[k], w)
            else:
                assert np.mean(got[k] == w) > 0.99
        elif k == "iterations":
            same_iterations(got[k], w, pol, m)
        elif k != "history" or pol.iters == 0:
            close(got[k], w, pol, k, m)


def lr_numbers(model, frame):
    s, out = model.summary, model.transform(frame).to_pydict()
    return {"coef": model.coefficient_matrix,
            "intercept": model.intercept_vector,
            "iterations": s.total_iterations,
            "history": s.objective_history,
            "prediction": np.asarray(out["prediction"]),
            "probability": np.asarray(out["probability"])}


@pytest.mark.parametrize("case", LR_CASES, ids=lr_id)
def test_logistic_regression_matches_the_reference(policy, case):
    k, kw = case
    cols, mask = table(seed=8, classes=k)
    got, want, moved = fit_both(
        policy, lambda m: m.LogisticRegression(max_iter=60, **kw), cols,
        mask, lr_numbers)
    same_numbers(got, want, moved, policy)


@pytest.mark.parametrize("k", [2, 3])
def test_logistic_summary_matches_the_reference(policy, k):
    cols, mask = table(seed=9, classes=k)
    df, jdf = frames(cols, mask)
    s = tc.LogisticRegression(max_iter=60, reg_param=0.02).fit(df).summary
    js = jc.LogisticRegression(max_iter=60, reg_param=0.02).fit(jdf).summary
    assert s.accuracy == pytest.approx(js.accuracy, abs=policy.rtol)
    if k == 2:
        assert s.area_under_roc == pytest.approx(js.area_under_roc,
                                                 abs=policy.curve)
        frames_ = ("roc", "pr", "precision_by_threshold",
                   "recall_by_threshold", "f_measure_by_threshold")
        for name in frames_:
            got = getattr(s, name).to_pydict()
            want = getattr(js, name).to_pydict()
            assert list(got) == list(want)
            for c in got:
                np.testing.assert_allclose(got[c], np.asarray(want[c]),
                                           rtol=policy.curve,
                                           atol=policy.curve, err_msg=name)
    else:
        np.testing.assert_array_equal(s.labels, js.labels)
        for name in ("precision_by_label", "recall_by_label",
                     "f_measure_by_label", "weighted_precision",
                     "weighted_recall", "weighted_f_measure"):
            close(getattr(s, name), getattr(js, name), policy, name)


@pytest.mark.parametrize("k", [2, 3])
def test_evaluate_on_another_frame_matches(float64, k):
    cols, mask = table(seed=10, classes=k)
    other, omask = table(seed=11, classes=k)
    df, jdf = frames(cols, mask)
    odf, ojdf = frames(other, omask)
    s = tc.LogisticRegression(reg_param=0.01).fit(df).evaluate(odf)
    js = jc.LogisticRegression(reg_param=0.01).fit(jdf).evaluate(ojdf)
    assert s.accuracy == js.accuracy
    assert type(s).__name__ == type(js).__name__
    same_predictions(s.predictions, js.predictions, float64)


@pytest.mark.parametrize("k", [2, 3])
def test_single_point_predictions_match(float64, k):
    cols, mask = table(seed=12, classes=k)
    df, jdf = frames(cols, mask)
    model = tc.LogisticRegression(reg_param=0.01).fit(df)
    ref = jc.LogisticRegression(reg_param=0.01).fit(jdf)
    for x in cols["features"][:5]:
        close(model.predict_raw(x), ref.predict_raw(x), float64)
        close(model.predict_probability(x), ref.predict_probability(x),
              float64)
        assert model.predict(x) == ref.predict(x)
    assert (model.num_classes, model.num_features) == \
        (ref.num_classes, ref.num_features)


def test_multinomial_vector_accessors_raise_in_both(float64):
    cols, mask = table(seed=13, classes=3)
    df, jdf = frames(cols, mask)
    for model in (tc.LogisticRegression().fit(df),
                  jc.LogisticRegression().fit(jdf)):
        for attr in ("coefficients", "intercept"):
            with pytest.raises(RuntimeError, match="multinomial"):
                getattr(model, attr)


SVC_CASES = [{}, {"reg_param": 0.1}, {"fit_intercept": False},
             {"standardization": False, "reg_param": 0.1},
             {"threshold": 0.5}]


def svc_numbers(model, frame):
    out = model.transform(frame).to_pydict()
    return {"coef": model.coefficients, "intercept": model.intercept,
            "iterations": model.iterations,
            "history": model.objective_history,
            "prediction": np.asarray(out["prediction"]),
            "raw": np.asarray(out["rawPrediction"])}


@pytest.mark.parametrize("kw", SVC_CASES, ids=str)
def test_linear_svc_matches_the_reference(policy, kw):
    cols, mask = table(seed=14)
    got, want, moved = fit_both(
        policy, lambda m: m.LinearSVC(max_iter=80, **kw), cols, mask,
        svc_numbers)
    same_numbers(got, want, moved, policy)


def test_linear_svc_single_point_predictions_match(float64):
    cols, mask = table(seed=14)
    df, jdf = frames(cols, mask)
    model = tc.LinearSVC(reg_param=0.05).fit(df)
    ref = jc.LinearSVC(reg_param=0.05).fit(jdf)
    for x in cols["features"][:8]:
        assert model.predict(x) == ref.predict(x)


NB_CASES = [("multinomial", None, 1.0), ("multinomial", "w", 0.5),
            ("bernoulli", None, 1.0), ("bernoulli", "w", 2.0)]


@pytest.mark.parametrize("model_type,weight_col,smoothing", NB_CASES)
def test_naive_bayes_matches_the_reference(policy, model_type, weight_col,
                                           smoothing):
    cols, mask = table(seed=15, classes=3)
    X = cols["features"]
    cols["features"] = (np.abs(X) if model_type == "multinomial"
                        else (X > 0).astype(np.float64))
    kw = {"model_type": model_type, "weight_col": weight_col,
          "smoothing": smoothing}

    def numbers(model, frame):
        out = model.transform(frame).to_pydict()
        return {"pi": model.pi, "theta": model.theta,
                "prediction": np.asarray(out["prediction"]),
                "probability": np.asarray(out["probability"]),
                "predict": [model.predict(x) for x in cols["features"][:5]]}
    # a nudged 0/1 feature is no bernoulli input
    got, want, moved = fit_both(policy, lambda m: m.NaiveBayes(**kw), cols,
                                mask, numbers,
                                nudge=model_type == "multinomial")
    same_numbers(got, want, moved, policy)


def classifier_pair(which):
    if which == "logistic":
        return (tc.LogisticRegression(max_iter=60, reg_param=0.01),
                jc.LogisticRegression(max_iter=60, reg_param=0.01))
    if which == "svc":
        return tc.LinearSVC(max_iter=60), jc.LinearSVC(max_iter=60)
    return (tc.NaiveBayes(model_type="bernoulli"),
            jc.NaiveBayes(model_type="bernoulli"))


@pytest.mark.parametrize("which", ["logistic", "svc", "naive_bayes"])
def test_one_vs_rest_matches_the_reference(policy, which):
    cols, mask = table(seed=16, classes=3)
    if which == "naive_bayes":
        cols["features"] = (cols["features"] > 0).astype(np.float64)
    df, jdf = frames(cols, mask)
    clf, jclf = classifier_pair(which)
    model = tc.OneVsRest(clf).fit(df)
    ref = jc.OneVsRest(jclf).fit(jdf)
    assert model.num_classes == ref.num_classes == 3
    same_predictions(model.transform(df), ref.transform(jdf), policy)


@pytest.mark.parametrize("band", [0, 2])
def test_newton_on_nearly_separable_labels_as_in_the_reference(policy,
                                                               band):
    """An unregularized binomial Newton fit whose two classes overlap on a
    few guests only, as OneVsRest's outer price bands do: its Hessian's
    smallest eigenvalue is about the float32 jitter, so float32 Newton
    takes 18 and 25 iterations where float64 takes 13 and 12, in the
    reference as in the port. Iterations within the policy's slack, the
    final objective within 1e-5 and, in float64, the coefficients."""
    rng = np.random.default_rng(0)
    guest = rng.integers(1, 40, 20_000).astype(np.float64)
    price = 5.0 * guest + 20.0 + rng.normal(0.0, 3.0, guest.size)
    cols = {"features": guest[:, None],
            "label": (((price >= 60.0) + (price >= 140.0)) == band).astype(
                np.float64)}
    model = tc.LogisticRegression(max_iter=50).fit(Frame(cols, device="cpu"))
    ref = jc.LogisticRegression(max_iter=50).fit(JaxFrame(cols))
    s, rs = model.summary, ref.summary
    same_iterations(s.total_iterations, rs.total_iterations, policy)
    assert s.objective_history[-1] == pytest.approx(
        rs.objective_history[-1], rel=1e-5)
    if policy.iters == 0:
        close(model.coefficients, ref.coefficients, policy)
        close(model.intercept, ref.intercept, policy)


def test_cross_validator_over_logistic_regression(float64):
    """The generic fit-per-cell path with BinaryClassificationEvaluator."""
    cols, mask = table(n=240, seed=17)
    df, jdf = frames(cols, mask)
    grid = [{"reg_param": r, "elastic_net_param": a}
            for r in (0.01, 0.2) for a in (0.0, 0.5)]
    got = tuning.CrossValidator(tc.LogisticRegression(max_iter=50), grid,
                                evaluation.BinaryClassificationEvaluator(),
                                num_folds=3).fit(df)
    ref = jax_tuning.CrossValidator(
        jc.LogisticRegression(max_iter=50), grid,
        jax_eval.BinaryClassificationEvaluator(), num_folds=3).fit(jdf)
    assert got.best_index == ref.best_index
    close(got.avg_metrics, ref.avg_metrics, float64)
    close(got.best_model.coefficients, ref.best_model.coefficients, float64)
    same_predictions(got.transform(df), ref.transform(jdf), float64)


# ---------------------------------------------------------------------------
# checks of the input, and what the port does not take
# ---------------------------------------------------------------------------

def bad_cases():
    cols, mask = table(n=40, seed=18)
    three = dict(cols, label=np.arange(40) % 3.0)
    return {
        "negative label": (lambda m: m.LogisticRegression(),
                           dict(cols, label=cols["label"] - 1.0), mask),
        "fractional label": (lambda m: m.LogisticRegression(),
                             dict(cols, label=cols["label"] * 0.5), mask),
        "binomial on three": (lambda m: m.LogisticRegression(
            family="binomial"), three, mask),
        "negative weight": (lambda m: m.LogisticRegression(weight_col="w"),
                            dict(cols, w=cols["w"] - 1.0), mask),
        "no valid rows": (lambda m: m.LogisticRegression(), cols,
                          np.zeros(40, bool)),
        "svc on three": (lambda m: m.LinearSVC(), three, mask),
        "nb negative feature": (lambda m: m.NaiveBayes(), cols, mask),
        "nb bernoulli non 0/1": (lambda m: m.NaiveBayes(
            model_type="bernoulli"), dict(cols, features=np.abs(
                cols["features"])), mask),
        "nb negative weight": (lambda m: m.NaiveBayes(weight_col="w"),
                               dict(cols, features=np.abs(cols["features"]),
                                    w=cols["w"] - 1.0), mask),
        "ovr without classifier": (lambda m: m.OneVsRest(), cols, mask),
    }


@pytest.mark.parametrize("name", sorted(bad_cases()))
def test_bad_input_raises_as_in_the_reference(float64, name):
    make, cols, mask = bad_cases()[name]
    df, jdf = frames(cols, mask)
    with pytest.raises(ValueError) as want:
        make(jc).fit(jdf)
    with pytest.raises(ValueError) as got:
        make(tc).fit(df)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("make", [
    lambda: tc.LogisticRegression(), lambda: tc.LinearSVC(),
    lambda: tc.NaiveBayes(), lambda: tc.OneVsRest(tc.LogisticRegression())],
    ids=["logistic", "svc", "naive_bayes", "one_vs_rest"])
def test_mesh_fits_are_not_ported(float64, make):
    cols, mask = table(n=40, seed=19)
    cols["features"] = np.abs(cols["features"])
    df, _ = frames(cols, mask)
    with pytest.raises(NotImplementedError, match="mesh"):
        make().fit(df, mesh=object())


# ---------------------------------------------------------------------------
# the tour's classifier section on dataset-full
# ---------------------------------------------------------------------------

def port_tour(s):
    """The tour's classifier section through the port."""
    import sparkdq4ml_tpu_torch as dq
    from sparkdq4ml_tpu_torch.models import VectorAssembler

    dq.register_builtin_rules()
    df = (s.read.format("csv").option("inferSchema", "true")
          .option("header", "false").load(dataset_path("full")))
    df = df.with_column_renamed("_c0", "guest").with_column_renamed(
        "_c1", "price")
    df = df.with_column("price_no_min",
                        dq.call_udf("minimumPriceRule", dq.col("price")))
    df.create_or_replace_temp_view("price")
    df = s.sql("SELECT cast(guest as int) guest, price_no_min AS price "
               "FROM price WHERE price_no_min > 0")
    df = df.with_column("price_correct_correl",
                        dq.call_udf("priceCorrelationRule", dq.col("price"),
                                    dq.col("guest")))
    df.create_or_replace_temp_view("price")
    df = s.sql("SELECT guest, price_correct_correl AS price "
               "FROM price WHERE price_correct_correl > 0")
    fdf = VectorAssembler(["guest"], "features").transform(df)
    return fdf.with_column("label", (fdf.col("guest") > 25).cast("double"))


def tour_numbers(ldf, lr_cls, svc_cls, evaluator_cls):
    lr = lr_cls(max_iter=50, reg_param=0.01).fit(ldf)
    auc = evaluator_cls().evaluate(lr.transform(ldf))
    svc = svc_cls(max_iter=100, reg_param=0.01).fit(ldf)
    out = svc.transform(ldf).to_pydict()
    return {"coef": float(lr.coefficients[0]), "intercept": lr.intercept,
            "iterations": lr.summary.total_iterations, "auc": auc,
            "svc_coef": float(svc.coefficients[0]),
            "svc_intercept": svc.intercept,
            "accuracy": float(np.mean(out["prediction"] == out["label"]))}


def jax_tour(session):
    fdf = prepare_features(run_dq_pipeline(session, dataset_path("full")))
    ldf = fdf.with_column("label", (fdf.col("guest") > 25).cast("double"))
    return tour_numbers(ldf, jc.LogisticRegression, jc.LinearSVC,
                        jax_eval.BinaryClassificationEvaluator)


def test_tour_classifier_section_matches_the_reference(policy, session):
    want = jax_tour(session)
    s = (TorchSession.builder().config("spark.torch.device", "cpu")
         .get_or_create())
    try:
        got = tour_numbers(port_tour(s), tc.LogisticRegression,
                           tc.LinearSVC,
                           evaluation.BinaryClassificationEvaluator)
    finally:
        s.stop()
        default_catalog().clear()
    assert got["auc"] == want["auc"]
    assert got["accuracy"] == want["accuracy"]
    same_iterations(got["iterations"], want["iterations"], policy)
    for k in ("coef", "intercept", "svc_coef", "svc_intercept"):
        assert got[k] == pytest.approx(want[k], rel=policy.rtol), k


def test_chip_smoke_tour_goldens_are_the_reference_output(session):
    """The constants ``chip_smoke.py`` holds the card to are the JAX
    package's float64 output of the tour's classifier section."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = jax_tour(session)
    golden = smoke.ML_TOUR_GOLDEN
    assert golden["logistic"]["iterations"] == want["iterations"]
    assert golden["logistic"]["auc"] == want["auc"]
    assert golden["svc"]["accuracy"] == want["accuracy"]
    for got, key in ((golden["logistic"]["coef"], "coef"),
                     (golden["logistic"]["intercept"], "intercept"),
                     (golden["svc"]["coef"], "svc_coef"),
                     (golden["svc"]["intercept"], "svc_intercept")):
        assert got == pytest.approx(want[key], rel=1e-12), key
