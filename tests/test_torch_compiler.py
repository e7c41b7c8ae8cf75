"""The port's fused pipeline (``sparkdq4ml_tpu_torch/ops/compiler.py`` and
the deferring frame) against the JAX package's (``sparkdq4ml_tpu/ops/
compiler.py``), on the CPU, in both float policies.

The same frames, built from seeded numpy data, go through the same calls
in both packages; then:

* the plan keys of the two caches are equal as strings;
* the ``pipeline.flush``/``compile``/``hit``/``evict``/``fallback``
  counter deltas are equal;
* the port's columns and masks with the pipeline on equal those with it
  off, bit for bit, and equal the JAX package's (exactly, or within
  1e-6 / 1e-12 relative for the transcendental builtins);
* a hit flush makes no counted host sync.

The JAX side runs with its data-quality profile off
(``spark.dq.profile.enabled=false``), whose flush hook would otherwise add
counters of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import compiler as jax_compiler
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu.utils import statstore as jax_statstore
from sparkdq4ml_tpu.utils.profiling import counters as jax_counters
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import config, float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import compiler
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.sql import default_catalog
from sparkdq4ml_tpu_torch.utils import statstore
from sparkdq4ml_tpu_torch.utils.profiling import counters

POLICIES = ("float64", "float32")
# builtins whose torch and XLA results may differ in the last bits
TRANSCENDENTAL = {"float64": 1e-12, "float32": 1e-6}
COUNTED = ("pipeline.flush", "pipeline.compile", "pipeline.hit",
           "pipeline.evict", "pipeline.fallback")


def _reset():
    for c, cnt in ((compiler, counters), (jax_compiler, jax_counters)):
        c.clear_cache()
        cnt.clear("pipeline.")
        cnt.clear("frame.")
        cnt.clear("optimizer.")
    statstore.STORE.clear()
    jax_statstore.STORE.clear()


@pytest.fixture(params=POLICIES)
def policy(request):
    """Both packages under one float policy, pipeline on, fresh caches and
    counters; yields the policy's name."""
    name = request.param
    saved = (jax_config.default_float_dtype, jax_config.pipeline,
             jax_config.dq_profile_enabled, config.pipeline)
    jax_config.default_float_dtype = getattr(jnp, name)
    jax_config.pipeline = True
    jax_config.dq_profile_enabled = False
    config.pipeline = True
    _reset()
    try:
        with jax.enable_x64(name == "float64"), \
                float_policy(getattr(torch, name)):
            yield name
    finally:
        (jax_config.default_float_dtype, jax_config.pipeline,
         jax_config.dq_profile_enabled, config.pipeline) = saved
        _reset()


def _columns(seed=0, n=6):
    rng = np.random.default_rng(seed)
    price = np.round(rng.uniform(0.0, 120.0, n), 2)
    price[rng.random(n) < 0.2] = np.nan
    return {"price": price,
            "guest": rng.integers(1, 30, n).astype(np.int32),
            "flag": rng.random(n) < 0.5,
            "city": np.asarray([["ny", "sf", None, "la"][i % 4]
                                for i in range(n)], dtype=object)}


def _frames(seed=0, n=6):
    cols = _columns(seed, n)
    return (JFrame({k: v.copy() for k, v in cols.items()}),
            TFrame({k: v.copy() for k, v in cols.items()}, device="cpu"))


def _eager(fn):
    old = config.pipeline
    config.pipeline = False
    try:
        return fn()
    finally:
        config.pipeline = old


def _keys(c) -> set:
    return {e["program_key"] for e in c.cache_stats()["entries"]}


def _deltas(cnt) -> dict:
    return {k: cnt.get(k) for k in COUNTED}


def _same(a: TFrame, b: TFrame) -> None:
    """Columns and masks bit for bit (dtypes included)."""
    assert a.columns == b.columns
    da, db = a._data, b._data
    for name in a.columns:
        x, y = da[name], db[name]
        if isinstance(x, np.ndarray):
            assert list(x) == list(y), name
            continue
        assert x.dtype == y.dtype, name
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.isnan(x), torch.isnan(y)) and torch.equal(
            x[~torch.isnan(x)], y[~torch.isnan(y)])), name
    assert torch.equal(a.mask, b.mask)


def _like_jax(t: TFrame, j: JFrame, policy: str, rtol: float = 0.0):
    # the JAX package's flush returns its new columns in name order (a
    # jit output dict is a pytree, flattened by sorted key), where its
    # eager path and the port keep them in the order they were added
    assert sorted(t.columns) == sorted(j.columns)
    dt, dj = t.to_pydict(), j.to_pydict()
    for name in j.columns:
        x, y = np.asarray(dt[name]), np.asarray(dj[name])
        assert x.shape == y.shape, name
        if y.dtype == object:
            assert list(x) == list(y), name
        elif rtol and x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=rtol, equal_nan=True,
                                       err_msg=name)
        else:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def _surface(E):
    c = E.col
    return [
        ("arith", lambda: (c("price") * 2.0 + c("guest") - 1.5)),
        ("div_null", lambda: c("price") / (c("guest") - 2)),
        ("mod", lambda: c("price") % 4),
        ("neg", lambda: -c("price")),
        ("neg_lit", lambda: c("price") + -E.Lit(3)),
        ("cmp_chain", lambda: (c("price") > 5.0) & (c("guest") <= 8)),
        ("or_not", lambda: (c("price") < 4) | ~(c("guest") == 5)),
        ("isnull", lambda: c("price").is_null()),
        ("isnotnull", lambda: c("price").is_not_null()),
        ("cast_int", lambda: c("price").cast("int")),
        ("cast_double", lambda: c("guest").cast("double")),
        ("cast_bool_int", lambda: c("flag").cast("int")),
        ("between", lambda: c("price").between(5, 30)),
        ("isin", lambda: c("guest").isin(1, 5, 20)),
        ("not_isin_null", lambda: E.InList(
            c("guest"), [E.Lit(1), E.Lit(None)], negated=True)),
        ("case_when", lambda: E.when(c("price") < 5.0, -1.0)
         .when(c("price") > 90.0, 99.0).otherwise(c("price"))),
        ("case_no_else", lambda: E.when(c("price") < 5.0, 1.0)),
        ("func_sqrt", lambda: E.fn("sqrt", c("price"))),
        ("func_pow", lambda: E.fn("pow", c("guest"), E.Lit(2))),
        ("func_greatest", lambda: E.fn("greatest", c("price"),
                                       c("guest"))),
        ("func_coalesce", lambda: E.fn("coalesce", c("price"),
                                       c("guest"))),
        ("func_isnan", lambda: E.fn("isnan", c("price"))),
        ("func_pmod", lambda: E.fn("pmod", -c("price"), c("guest"))),
        ("alias", lambda: (c("price") + 1).alias("bumped")),
        ("bool_lit", lambda: (c("price") > 3.0) & E.Lit(True)),
    ]


SURFACE = [n for n, _ in _surface(TE)]
TRANSCENDENTAL_CASES = {"func_sqrt", "func_pow"}


def _build(E, name):
    return dict(_surface(E))[name]()


@pytest.mark.parametrize("name", SURFACE)
def test_with_column_keys_counters_and_bits(policy, name):
    j, t = _frames()
    jf = j.with_column("out", _build(JE, name))
    tf = t.with_column("out", _build(TE, name))
    assert tf._pending, f"{name} did not defer"
    jf.count()
    eager = _eager(lambda: t.with_column("out", _build(TE, name)))
    assert not eager._pending
    _same(tf, eager)
    _like_jax(tf, jf, policy, TRANSCENDENTAL[policy]
              if name in TRANSCENDENTAL_CASES else 0.0)
    assert _keys(compiler) == _keys(jax_compiler)
    assert _deltas(counters) == _deltas(jax_counters)
    assert counters.get("pipeline.fallback") == 0


@pytest.mark.parametrize("name", SURFACE)
def test_filter_keys_counters_and_bits(policy, name):
    j, t = _frames(seed=1)
    jf = j.filter(_build(JE, name))
    tf = t.filter(_build(TE, name))
    assert tf.count() == jf.count()
    eager = _eager(lambda: t.filter(_build(TE, name)))
    _same(tf, eager)
    _like_jax(tf, jf, policy)
    assert _keys(compiler) == _keys(jax_compiler)
    assert _deltas(counters) == _deltas(jax_counters)


def _chain(f, E):
    f = f.with_column("p2", E.col("price") * 2.0)
    f = f.with_column("tier", E.when(E.col("p2") > 50.0, 2.0)
                      .otherwise(1.0))
    f = f.filter(E.col("price") > 1.0)
    f = f.with_column("adj", E.col("p2") + E.col("tier"))
    f = f.filter(E.col("adj") < 200.0)
    return f.with_column("g2", E.col("guest").cast("double") / 2)


def test_chained_pipeline_is_one_plan(policy):
    j, t = _frames(seed=2, n=40)
    jf, tf = _chain(j, JE), _chain(t, TE)
    assert len(tf._pending) == 6
    jf.count()
    _same(tf, _eager(lambda: _chain(t, TE)))
    _like_jax(tf, jf, policy)
    assert counters.get("pipeline.compile") == 1
    assert _keys(compiler) == _keys(jax_compiler)
    assert _deltas(counters) == _deltas(jax_counters)


def _batch(f, E):
    return f.with_columns({"price": E.col("price") * 0.0,
                           "orig": E.col("price") + 1.0})


def test_with_columns_batch_semantics(policy):
    j, t = _frames(seed=3)
    jf, tf = _batch(j, JE), _batch(t, TE)
    assert tf._pending
    _same(tf, _eager(lambda: _batch(t, TE)))
    _like_jax(tf, jf, policy)
    assert _keys(compiler) == _keys(jax_compiler)


def _read_then_replace(f, E):
    return f.with_column("p2", E.col("price") * 2.0).with_column(
        "price", E.col("price") + 1.0).filter(E.col("price") > 5.0)


def test_read_then_replace_column_is_one_plan(policy):
    j, t = _frames(seed=4, n=20)
    jf, tf = _read_then_replace(j, JE), _read_then_replace(t, TE)
    _like_jax(tf, jf, policy)
    assert counters.get("pipeline.compile") == 1
    assert counters.get("pipeline.fallback") == 0
    assert _keys(compiler) == _keys(jax_compiler)
    # the source frame still holds the original prices
    np.testing.assert_array_equal(t.to_pydict()["price"],
                                  j.to_pydict()["price"])


def test_literal_hoisting_shares_one_plan(policy):
    for threshold in (3.0, 4.0, 7.5, 90.0):
        j, t = _frames(seed=5, n=12)
        jf = j.filter(JE.col("price") < threshold)
        tf = t.filter(TE.col("price") < threshold)
        assert tf.count() == jf.count()
    assert counters.get("pipeline.compile") == 1
    assert counters.get("pipeline.hit") == 3
    assert _deltas(counters) == _deltas(jax_counters)
    assert _keys(compiler) == _keys(jax_compiler)


def test_func_literal_arguments_hoist(policy):
    for exponent in (2, 3, 5):
        j, t = _frames(seed=6)
        jf = j.with_column("p", JE.fn("pow", JE.col("guest"),
                                      JE.Lit(exponent)))
        tf = t.with_column("p", TE.fn("pow", TE.col("guest"),
                                      TE.Lit(exponent)))
        _like_jax(tf, jf, policy, TRANSCENDENTAL[policy])
    assert _deltas(counters) == _deltas(jax_counters)
    assert counters.get("pipeline.compile") == 1


def test_lengths_in_one_bucket_share_one_plan(policy):
    for n in (600, 700, 1500):
        cols = {"v": np.arange(n, dtype=np.float64)}
        jf = JFrame(dict(cols)).with_column("w", JE.col("v") * 3.0)
        tf = TFrame(dict(cols), device="cpu").with_column(
            "w", TE.col("v") * 3.0)
        _like_jax(tf, jf, policy)
    # 600 and 700 share the 1024 bucket, 1500 takes 2048
    assert counters.get("pipeline.compile") == 2
    assert _deltas(counters) == _deltas(jax_counters)
    entry = compiler.cache_stats()["entries"][0]
    assert entry["buckets"] == {1024: 2, 2048: 1}
    assert entry["buckets"] == \
        jax_compiler.cache_stats()["entries"][0]["buckets"]


def test_dtype_policy_flip_misses_the_cache(policy):
    other = "float32" if policy == "float64" else "float64"
    col = {"a": np.asarray([1.0, 2.0, 3.0])}
    TFrame(dict(col), device="cpu").with_column(
        "h", TE.col("a") / 2)._data
    with float_policy(getattr(torch, other)):
        out = TFrame(dict(col), device="cpu").with_column(
            "h", TE.col("a") / 2)
        assert out._data["h"].dtype == getattr(torch, other)
    assert counters.get("pipeline.compile") == 2
    tags = {k.split("|")[0] for k in _keys(compiler)}
    assert tags == {"<f8/<i4", "<f4/<i4"}


def test_adversarial_column_names_cannot_collide(policy):
    evil = "a)=C('b':<f8)|W(c"
    for F, E in ((JFrame, JE), (TFrame, TE)):
        kw = {} if F is JFrame else {"device": "cpu"}
        base = F({"b": np.asarray([1.0, 2.0])}, **kw)
        first = base.with_column("a", E.col("b")).with_column(
            "c", E.Lit(1.0))
        first.count()
        bad = base.with_column(evil, E.Lit(1.0))
        bad.count()
        assert bad.columns == ["b", evil]
    assert counters.get("pipeline.compile") == 2
    assert _keys(compiler) == _keys(jax_compiler)


def test_structural_mismatch_recompiles(policy):
    for op in ("<", "<="):
        j, t = _frames(seed=7)
        (j.filter(JE.col("price") < 3.0) if op == "<"
         else j.filter(JE.col("price") <= 3.0)).count()
        (t.filter(TE.col("price") < 3.0) if op == "<"
         else t.filter(TE.col("price") <= 3.0)).count()
    assert counters.get("pipeline.compile") == 2
    assert _deltas(counters) == _deltas(jax_counters)


def test_numpy_scalar_literals_stay_eager(policy):
    """np.int64 and np.bool_ are no Python int or bool: the port's Lit
    refuses them, and the compilable subset does too; np.float64 is a
    float and defers, as in the JAX package."""
    _, t = _frames()
    schema = compiler.schema_of(t._data_store)
    for value in (np.int64(5), np.bool_(True)):
        lit = TE.Lit.__new__(TE.Lit)
        lit.value = value
        assert not compiler.is_compilable(lit, schema)
        assert not jax_compiler.is_compilable(JE.Lit(value), schema)
    assert compiler.is_compilable(TE.Lit(np.float64(5.0)), schema)
    assert t.with_column("x", TE.col("price") + TE.Lit(
        np.float64(5.0)))._pending


def test_non_compilable_stays_eager(policy):
    _, t = _frames()
    assert not t.with_column("up", TE.fn("upper", TE.col("city")))._pending
    assert not t.filter(TE.col("city").like("n%"))._pending
    assert not t.with_column("rd", TE.fn("round", TE.col("price"),
                                         TE.Lit(1)))._pending
    from sparkdq4ml_tpu_torch import register_builtin_rules

    register_builtin_rules()
    assert not t.with_column("u", TE.call_udf(
        "minimumPriceRule", TE.col("price")))._pending
    with pytest.raises(TypeError):
        t.with_column("bad", TE.Func("hypot", [TE.col("price")]))


def test_bucket_size_rule_matches(policy, monkeypatch):
    for settings in ((8, 1 << 17), (16, 1 << 10)):
        monkeypatch.setattr(config, "pipeline_min_bucket", settings[0])
        monkeypatch.setattr(compiler, "EXACT_THRESHOLD", settings[1])
        monkeypatch.setattr(jax_config, "pipeline_min_bucket", settings[0])
        monkeypatch.setattr(jax_config, "pipeline_exact_threshold",
                            settings[1])
        for n in (0, 1, 7, 8, 9, 16, 17, 600, 1024, 1025, 1 << 17,
                  (1 << 17) + 1, 10_000_000):
            assert compiler.bucket_size(n) == \
                jax_compiler.bucket_size(n), (settings, n)


def test_fixed_bounds_are_the_jax_defaults(policy):
    """The port's bucket rule, plan-cache and statstore bounds default to
    the JAX package's default settings."""
    assert (config.pipeline_min_bucket, compiler.EXACT_THRESHOLD,
            config.pipeline_cache_size, config.stats_max_entries) == (
        jax_config.pipeline_min_bucket, jax_config.pipeline_exact_threshold,
        jax_config.pipeline_cache_size, jax_config.stats_max_entries)
    assert compiler.cache_stats()["capacity"] == \
        jax_compiler.cache_stats()["capacity"]


def test_lru_eviction_counts(policy, monkeypatch):
    monkeypatch.setattr(config, "pipeline_cache_size", 2)
    monkeypatch.setattr(jax_config, "pipeline_cache_size", 2)
    for k in range(4):
        j, t = _frames(seed=8)
        j.with_column(f"c{k}", JE.col("price") + 1.0).count()
        t.with_column(f"c{k}", TE.col("price") + 1.0).count()
    assert counters.get("pipeline.evict") == 2
    assert compiler.cache_len() == 2
    assert _deltas(counters) == _deltas(jax_counters)
    assert _keys(compiler) == _keys(jax_compiler)


def test_fallback_counts_and_replays(policy, monkeypatch):
    def broken(self, *a, **k):
        raise RuntimeError("plan construction failed")

    monkeypatch.setattr(compiler._Plan, "__init__", broken)
    monkeypatch.setattr(jax_compiler._Plan, "__init__", broken)
    j, t = _frames(seed=9)
    jf = j.with_column("x", JE.col("price") + 1.0)
    tf = t.with_column("x", TE.col("price") + 1.0)
    _like_jax(tf, jf, policy)
    assert counters.get("pipeline.fallback") == 1
    assert _deltas(counters) == _deltas(jax_counters)


def test_failed_flush_keeps_pending_and_keeps_raising(monkeypatch):
    import sparkdq4ml_tpu_torch.frame.frame as frame_mod

    _, t = _frames()
    f = t.with_column("x", TE.col("price") + 1.0)
    real = frame_mod.Frame._eager_replay

    def boom(*a, **k):
        raise compiler.PipelineError("forced")

    def bad_replay(self, steps):
        raise RuntimeError("replay exploded")

    monkeypatch.setattr(compiler, "run_pipeline", boom)
    monkeypatch.setattr(frame_mod.Frame, "_eager_replay", bad_replay)
    with pytest.raises(RuntimeError, match="replay exploded"):
        f.to_pydict()
    assert f._pending and "x" in f.columns
    with pytest.raises(RuntimeError, match="replay exploded"):
        f.count()
    monkeypatch.setattr(frame_mod.Frame, "_eager_replay", real)
    x = f.to_pydict()["x"]
    assert np.array_equal(x, t.to_pydict()["price"] + 1, equal_nan=True)


def test_siblings_share_a_prefix_safely(policy):
    _, t = _frames(seed=10, n=30)
    f = t.with_column("p2", TE.col("price") * 2.0)
    a = f.filter(TE.col("price") > 5.0)
    b = f.filter(TE.col("price") > 90.0)
    na, nb = a.count(), b.count()
    _same(a, _eager(lambda: t.with_column("p2", TE.col("price") * 2.0)
                    .filter(TE.col("price") > 5.0)))
    assert nb <= na and f.count() == t.count()


def test_hit_flush_makes_no_host_sync(policy):
    for threshold, fresh in ((3.0, True), (4.0, False)):
        j, t = _frames(seed=11)
        jf = j.filter(JE.col("price") > threshold)
        tf = t.filter(TE.col("price") > threshold)
        before = (counters.get("frame.host_sync"),
                  jax_counters.get("frame.host_sync"))
        tf._flush()
        jf._flush()
        assert counters.get("pipeline.hit") == (0 if fresh else 1)
        assert (counters.get("frame.host_sync"),
                jax_counters.get("frame.host_sync")) == before


def test_cache_materializes_and_counts(policy):
    _, t = _frames()
    f = t.with_column("p2", TE.col("price") * 2.0)
    assert f.cache() is f
    assert not f._pending
    assert counters.get("frame.cache") == 1
    assert counters.get("pipeline.flush") == 1


def test_to_pydict_counts_like_jax(policy):
    j, t = _frames()
    j.count(), t.count()
    for fn in (lambda f: f.to_pydict(), lambda f: f.to_pydict(2),
               lambda f: f.show_string(2)):
        before = (counters.get("frame.host_sync"),
                  jax_counters.get("frame.host_sync"))
        fn(t)
        fn(j)
        assert (counters.get("frame.host_sync") - before[0]
                == jax_counters.get("frame.host_sync") - before[1])


# ---------------------------------------------------------------------------
# Two-step plans, literals per flush, outputs that are inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SURFACE)
def test_chain_with_filter_bits(policy, name):
    j, t = _frames(seed=13, n=7)
    jf = j.with_column("out", _build(JE, name)).filter(
        JE.col("guest") > 3)
    tf = t.with_column("out", _build(TE, name)).filter(
        TE.col("guest") > 3)
    _same(tf, _eager(lambda: t.with_column("out", _build(TE, name))
                     .filter(TE.col("guest") > 3)))
    _like_jax(tf, jf, policy, TRANSCENDENTAL[policy]
              if name in TRANSCENDENTAL_CASES else 0.0)
    (entry,) = compiler.cache_stats()["entries"]
    assert entry["compiles"] == 1
    assert _deltas(counters) == _deltas(jax_counters)


def test_literals_and_lengths_per_flush(policy):
    """Flushes of one plan at new literal values and new lengths within
    one bucket compute with those values, interleaved, and every result
    stays as it was when the next flush runs."""
    results = []
    for n, threshold, scale in ((7, 3.0, 2.0), (5, 90.0, 3.0),
                                (8, 40.0, -1.5), (6, 3.0, 2.0)):
        j, t = _frames(seed=14, n=n)
        tf = t.with_column("s", TE.col("price") * scale).filter(
            TE.col("price") > threshold)
        jf = j.with_column("s", JE.col("price") * scale).filter(
            JE.col("price") > threshold)
        tf._data
        eager = _eager(lambda: t.with_column(
            "s", TE.col("price") * scale).filter(
            TE.col("price") > threshold))
        results.append((tf, jf, eager))
    for tf, jf, eager in results:
        _same(tf, eager)
        _like_jax(tf, jf, policy)
    assert counters.get("pipeline.compile") == 1
    assert counters.get("pipeline.hit") == 3
    (entry,) = compiler.cache_stats()["entries"]
    assert entry["buckets"] == {8: 4}


def test_outputs_passing_inputs_through(policy):
    """A plan whose outputs are its inputs (a renamed column, an int cast
    of an int column) hands back the stored tensors, as the eager path
    does."""
    _, t = _frames(seed=15)
    f = t.with_column("label", TE.col("price")).with_column(
        "g", TE.col("guest").cast("int"))
    d = f._data
    assert d["label"] is t._data["price"]
    assert d["g"] is t._data["guest"]
    assert f.mask is t.mask


# ---------------------------------------------------------------------------
# SQL and the session
# ---------------------------------------------------------------------------

APP_SQL = ("SELECT cast(guest as int) guest, price_no_min AS price "
           "FROM price WHERE price_no_min > 0",
           "SELECT guest, price_correct_correl AS price "
           "FROM price WHERE price_correct_correl > 0")


@pytest.fixture
def sessions(policy, session):
    port = (TorchSession.builder().app_name("test")
            .config("spark.torch.device", "cpu").get_or_create())
    yield session, port
    port.stop()
    default_catalog().clear()


def _sql_frame(F, E, n=600, seed=3, **kw):
    rng = np.random.default_rng(seed)
    guest = rng.integers(1, 40, n).astype(np.int32)
    price = rng.uniform(-10.0, 120.0, n)
    f = F({"guest": guest, "price": price}, **kw)
    return f.with_column("price_no_min", E.col("price") * 1.0).with_column(
        "price_correct_correl", E.col("price") - 20.0)


def test_app_queries_keys_and_counters(sessions, policy):
    js, ts = sessions
    for q in APP_SQL * 2:
        _sql_frame(JFrame, JE).create_or_replace_temp_view("price")
        _sql_frame(TFrame, TE, device="cpu").create_or_replace_temp_view(
            "price")
        jout, tout = js.sql(q), ts.sql(q)
        _like_jax(tout, jout, policy)
    assert _keys(compiler) == _keys(jax_compiler)
    assert _deltas(counters) == _deltas(jax_counters)
    assert counters.get("pipeline.hit") >= 2


def test_sql_on_against_off_bit_identical(sessions, policy):
    _, ts = sessions
    q = ("SELECT guest, price / 2 AS half, price * guest AS tot "
         "FROM t WHERE price > 30 AND guest < 35")
    _sql_frame(TFrame, TE, device="cpu").create_or_replace_temp_view("t")
    on = ts.sql(q)
    off = _eager(lambda: ts.sql(q))
    _same(on, off)


def test_pipeline_conf_is_session_scoped():
    assert config.pipeline is True
    s = (TorchSession.builder().app_name("scoped")
         .config("spark.torch.device", "cpu")
         .config("spark.pipeline.enabled", "false")
         .config("spark.stats.enabled", "false").get_or_create())
    try:
        assert config.pipeline is False
        assert config.stats_enabled is False
        _, t = _frames()
        assert not t.with_column("x", TE.col("price") + 1)._pending
    finally:
        s.stop()
    assert config.pipeline is True
    assert config.stats_enabled is True
