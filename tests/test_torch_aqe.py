"""The port's adaptive execution (``sparkdq4ml_tpu_torch/sql/
adaptive.py`` and its hooks in ``Frame.join``, the executor's WHERE
boundary and the grouped engine) against the JAX package's, on the CPU:
the cases of ``tests/test_aqe.py`` without its sharded ones (the skew
split, the broadcast skip) and its fault site.

Each re-plan gives the port's result with adaptive execution off, bit
for bit (or as sorted rows where the JAX suite compares so), the JAX
package's result, and the JAX package's ``== Adaptive ==`` lines.
"""

import numpy as np
import pytest

from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.sql import adaptive as jax_adaptive
from sparkdq4ml_tpu.utils import statstore as jax_statstore
from sparkdq4ml_tpu.utils.profiling import counters as jax_counters
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import config
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import compiler
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.ops.compiler import bucket_size
from sparkdq4ml_tpu_torch.sql import adaptive
from sparkdq4ml_tpu_torch.sql import optimizer as opt
from sparkdq4ml_tpu_torch.utils import statstore
from sparkdq4ml_tpu_torch.utils.profiling import counters
from torch_planner import (assert_exact, assert_sorted, both,  # noqa: F401
                           both64, jax_run, plan, port_run, register,
                           section, setting)


def _replans(trigger=None, cnt=counters):
    return cnt.get("aqe.replans" + (f".{trigger}" if trigger else ""))


# ---------------------------------------------------------------------------
# Build-side flip (the est= hook of Frame.join)
# ---------------------------------------------------------------------------

def _join_frames(F):
    rng = np.random.default_rng(11)
    kw = {"device": "cpu"} if F is TFrame else {}
    return (F({"k": np.arange(30, dtype=np.float64),
               "v": rng.normal(size=30)}, **kw),
            F({"k": (np.arange(4096) % 64).astype(np.float64),
               "w": rng.normal(size=4096)}, **kw))


def test_drift_flips_build_side_bit_identical(both):
    left, right = _join_frames(TFrame)
    setting(aqe_enabled=False)
    ref = left.join(right, on="k").to_pydict()
    setting(aqe_enabled=True)
    with adaptive.capture() as events:
        got = left.join(right, on="k", est=(30 * 4096, 4096)).to_pydict()
    jl, jr = _join_frames(JFrame)
    with jax_adaptive.capture() as jax_events:
        jgot = jl.join(jr, on="k", est=(30 * 4096, 4096)).to_pydict()
    assert _replans("build-flip") == 1
    assert adaptive.render(events) == jax_adaptive.render(jax_events)
    assert_exact(ref, got)
    assert_exact(jgot, got)


def test_no_drift_keeps_static_plan(both64):
    left, right = _join_frames(TFrame)
    left.join(right, on="k", est=(30, 4096))
    assert _replans() == 0


def test_cold_estimate_never_triggers(both64):
    left, right = _join_frames(TFrame)
    left.join(right, on="k", est=(None, None))
    left.join(right, on="k")
    assert _replans() == 0


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer",
                                 "left_semi", "left_anti"])
def test_build_left_hint_is_bit_identical(both64, how):
    """``build="left"`` is honoured on inner joins and ignored on the
    others; the pairs and their order never change."""
    rng = np.random.default_rng(5)
    left = TFrame({"k": rng.integers(0, 20, 50).astype(np.float64),
                   "v": rng.normal(size=50)}, device="cpu")
    right = TFrame({"k": rng.integers(0, 25, 300).astype(np.float64),
                    "w": rng.normal(size=300)}, device="cpu")
    assert_exact(left.join(right, on="k", how=how).to_pydict(),
                 left.join(right, on="k", how=how,
                           build="left").to_pydict())


# ---------------------------------------------------------------------------
# Re-bucket after the WHERE boundary
# ---------------------------------------------------------------------------

REBUCKET_SQL = "SELECT k, sum(v) AS s FROM aqe_t WHERE v > 2.0 GROUP BY k"


def _rebucket_view(n=4096, seed=17):
    rng = np.random.default_rng(seed)
    register("aqe_t", {"k": rng.integers(0, 32, n).astype(np.float64),
                       "v": rng.normal(size=n)})


def _seed_filter_history(sql=REBUCKET_SQL):
    """One run with adaptive execution off in each package records the
    WHERE's selectivity; returns the port's result."""
    setting(aqe_enabled=False)
    ref = port_run(sql)
    jax_run(sql)
    statstore.STORE.drain_pending()
    jax_statstore.STORE.drain_pending()
    return ref


def test_unit_shrink_preserves_rows_and_slots(both):
    rng = np.random.default_rng(3)
    f = TFrame({"k": rng.integers(0, 8, 4096).astype(np.float64),
                "v": rng.normal(size=4096)},
               device="cpu").filter(TE.col("v") > 2.0)
    ref = f.to_pydict()
    observed = len(ref["v"])
    assert 0 < observed < 200
    out = adaptive.maybe_rebucket(f, est=observed)
    assert out.num_slots == observed
    assert bucket_size(out.num_slots) < 4096
    assert _replans("re-bucket") == 1
    assert_exact(ref, out.to_pydict())


def test_unit_respects_device_budget(both64, monkeypatch):
    rng = np.random.default_rng(4)
    f = TFrame({"v": rng.normal(size=4096)},
               device="cpu").filter(TE.col("v") > 2.0)
    f._host_mask()
    monkeypatch.setattr(compiler, "flush_budget", lambda: 8)
    assert adaptive.maybe_rebucket(f, est=64) is f
    assert _replans() == 0


def test_no_history_means_static_plan(both64):
    rng = np.random.default_rng(5)
    f = TFrame({"v": rng.normal(size=4096)},
               device="cpu").filter(TE.col("v") > 2.0)
    assert adaptive.maybe_rebucket(f, est=None) is f
    assert _replans() == 0


def test_sql_rebucket_bit_parity(both):
    _rebucket_view()
    ref = _seed_filter_history()
    setting(aqe_enabled=True)
    got = port_run(REBUCKET_SQL)
    jgot = jax_run(REBUCKET_SQL)
    assert _replans("re-bucket") == 1
    assert _replans("re-bucket", jax_counters) == 1
    assert_exact(ref, got)
    assert_exact(jgot, got)


GLOBAL_SQL = ("SELECT sum(v) AS s, avg(v) AS a, stddev(v) AS d "
              "FROM aqe_t WHERE v > 1.0")


@pytest.mark.parametrize("n", (4096, 40_000))
def test_global_float_sums_keep_their_bits_through_a_rebucket(both, n):
    """A global SUM, AVG and STDDEV whose WHERE takes the re-bucket give
    the bits of the same query with adaptive execution off: both add the
    valid rows compacted in row order, whatever the slots around them
    (frame/aggregates.py:_valid_slots)."""
    _rebucket_view(n=n, seed=23)
    ref = _seed_filter_history(GLOBAL_SQL)
    setting(aqe_enabled=True)
    got = port_run(GLOBAL_SQL)
    assert _replans("re-bucket") == 1
    assert list(got) == list(ref) == ["s", "a", "d"]
    for c in got:
        x, y = np.asarray(got[c]), np.asarray(ref[c])
        assert x.dtype == y.dtype and x.shape == y.shape == (1,)
        assert x.tobytes() == y.tobytes(), (c, x, y)
    jgot = jax_run(GLOBAL_SQL)
    for c in got:
        assert float(got[c][0]) == pytest.approx(float(jgot[c][0]),
                                                 rel=1e-5), c


@pytest.mark.parametrize("sql", [
    REBUCKET_SQL,
    "SELECT k, v FROM aqe_t WHERE v > 2.0 ORDER BY v",
    "SELECT DISTINCT k FROM aqe_t WHERE v > 2.0",
    "SELECT count(*) c, max(v) m FROM aqe_t WHERE v > 2.0",
])
def test_analyze_adaptive_section_equals_jax(both64, sql):
    _rebucket_view()
    _seed_filter_history(sql)
    setting(aqe_enabled=True)
    jax_text, text = plan("EXPLAIN ANALYZE " + sql)
    assert "== Adaptive ==" in text
    assert section(text, "Adaptive") == section(jax_text, "Adaptive")
    assert section(text, "Adaptive")[0].startswith("re-bucket: 4096 -> ")


def test_no_replan_renders_no_section(both64):
    _rebucket_view()
    text = port_run("EXPLAIN ANALYZE " + REBUCKET_SQL)["plan"][0]
    assert "== Adaptive ==" not in text


def test_disabled_mode_explain_byte_identical(both64):
    _rebucket_view()
    _seed_filter_history()
    setting(aqe_enabled=False)
    off = port_run("EXPLAIN " + REBUCKET_SQL)["plan"][0]
    setting(aqe_enabled=True)
    on = port_run("EXPLAIN " + REBUCKET_SQL)["plan"][0]
    assert off == on == jax_run("EXPLAIN " + REBUCKET_SQL)["plan"][0]


def test_hooks_reduce_to_one_conf_read(both64, monkeypatch):
    """With adaptive execution off no decision function is entered."""
    def boom(*a, **kw):
        raise AssertionError("adaptive hook entered with AQE off")

    _rebucket_view()
    _seed_filter_history()              # leaves aqe_enabled False
    for fn in ("guard", "drift", "record", "maybe_rebucket"):
        monkeypatch.setattr(adaptive, fn, boom)
    left, right = _join_frames(TFrame)
    left.join(right, on="k", est=(30 * 4096, 4096))
    text = port_run("EXPLAIN ANALYZE " + REBUCKET_SQL)["plan"][0]
    assert "== Adaptive ==" not in text
    assert _replans() == 0


# ---------------------------------------------------------------------------
# The grouped lowering choice from cardinality history
# ---------------------------------------------------------------------------

def test_history_above_dense_range_skips_dense(both):
    rng = np.random.default_rng(31)
    register("aqe_g", {"k": rng.integers(0, 64, 1024).astype(np.float64),
                       "v": rng.normal(size=1024)})
    sql = "SELECT k, sum(v) AS s FROM aqe_g GROUP BY k"
    setting(aqe_enabled=False)
    ref = port_run(sql)
    jax_run(sql)
    for store in (statstore.STORE, jax_statstore.STORE):
        cards = [k for k in list(store._entries) if k.startswith("card|")]
        assert cards, "the grouped run should record cardinality"
        store.record_rows(cards[0], "cardinality", 1, 1_000_000)
    assert sorted(k for k in statstore.STORE._entries
                  if k.startswith("card|")) == \
        sorted(k for k in jax_statstore.STORE._entries
               if k.startswith("card|"))
    setting(aqe_enabled=True)
    syncs = counters.get("frame.host_sync")
    got = port_run(sql)
    jax_run(sql)
    assert _replans("grouped-lowering") == 1
    assert_sorted(ref, got)
    assert counters.get("frame.host_sync") - syncs >= 1
    jax_text, text = plan("EXPLAIN ANALYZE " + sql)
    assert section(text, "Adaptive") == section(jax_text, "Adaptive")


# ---------------------------------------------------------------------------
# The flop-cost term of the reorder, and pushdown into a decorrelated
# subquery's branch
# ---------------------------------------------------------------------------

def test_flops_for_selectivity_bridges_plan_keys(both64):
    store = statstore.STORE
    store.record_cost("ns:t|f32|F:gt|P:proj", "pipeline", {"flops": 123.0})
    store.record_cost("f32|F:gt|P:other", "pipeline", {"flops": 60.0})
    store.record_cost("f32|F:lt|P:proj", "pipeline", {"flops": 999.0})
    assert store.flops_for_selectivity("f32|F:gt") == 123.0
    assert store.flops_for_selectivity("f32|F:nope") is None
    assert store.flops_for_selectivity(None) is None


def _reorder_views():
    rng = np.random.default_rng(61)
    register("big2", {"k": rng.integers(0, 64, 2000).astype(np.float64),
                      "v": rng.normal(size=2000)})
    register("d1", {"k": np.arange(64, dtype=np.float64),
                    "a": rng.normal(size=64)})
    register("d2", {"k": np.arange(64, dtype=np.float64),
                    "b": rng.normal(size=64)})


REORDER_SQL = "SELECT v, a, b FROM big2 JOIN d1 USING (k) JOIN d2 USING (k)"


def test_equal_rows_cold_flops_keeps_order(both64):
    _reorder_views()
    setting(optimizer_level=2)
    jax_text, text = plan("EXPLAIN " + REORDER_SQL)
    assert text == jax_text and "join-reorder" not in text


def test_flop_term_breaks_row_tie(both64, monkeypatch):
    from sparkdq4ml_tpu.sql import optimizer as jax_opt

    _reorder_views()
    setting(optimizer_enabled=False, optimizer_level=2)
    off = port_run(REORDER_SQL)
    for mod in (opt, jax_opt):
        monkeypatch.setattr(
            mod, "_est_rel_flops",
            lambda rel, cat: 1e6 if rel.view == "d1" else None)
    setting(optimizer_enabled=True)
    on = port_run(REORDER_SQL)
    assert_sorted(off, on)
    assert_sorted(jax_run(REORDER_SQL), on)
    jax_text, text = plan("EXPLAIN " + REORDER_SQL)
    assert text == jax_text
    assert "join-reorder" in text
    assert "smallest rows x flop cost first" in text


DECORRELATED_SQL = ("SELECT k, v FROM o WHERE EXISTS "
                    "(SELECT j FROM i JOIN d USING (j) "
                    "WHERE i.k = o.k AND w > 0)")


def _decorrelated_views():
    rng = np.random.default_rng(71)
    register("o", {"k": rng.integers(0, 40, 200).astype(np.float64),
                   "v": rng.normal(size=200)})
    register("i", {"k": rng.integers(0, 40, 300).astype(np.float64),
                   "j": rng.integers(0, 16, 300).astype(np.float64)})
    register("d", {"j": np.arange(16, dtype=np.float64),
                   "w": rng.normal(size=16)})


def test_branch_pushdown_parity_and_counter(both):
    _decorrelated_views()
    setting(optimizer_enabled=False)
    before = counters.get("optimizer.rewrite")
    off = port_run(DECORRELATED_SQL)
    assert counters.get("optimizer.rewrite") == before
    setting(optimizer_enabled=True)
    on = port_run(DECORRELATED_SQL)
    assert counters.get("optimizer.rewrite") > before
    assert_exact(off, on)
    assert_exact(jax_run(DECORRELATED_SQL), on)


def test_outer_explain_pinned_branch_diff_renders(both64):
    _decorrelated_views()
    setting(optimizer_enabled=False)
    off = port_run("EXPLAIN " + DECORRELATED_SQL)["plan"][0]
    setting(optimizer_enabled=True)
    on = port_run("EXPLAIN " + DECORRELATED_SQL)["plan"][0]
    assert off == on
    jax_text, branch = plan("EXPLAIN SELECT j FROM i JOIN d USING (j) "
                            "WHERE w > 0")
    assert branch == jax_text
    assert "pushdown: (w > 0) -> Scan[d]" in branch


def test_session_conf_scoping():
    saved = (config.aqe_enabled, config.aqe_drift_factor)
    s = TorchSession.builder().config("spark.torch.device", "cpu").config(
        "spark.aqe.enabled", "false").config(
        "spark.aqe.driftFactor", "8").get_or_create()
    try:
        assert config.aqe_enabled is False
        assert config.aqe_drift_factor == 8.0
    finally:
        s.stop()
    assert (config.aqe_enabled, config.aqe_drift_factor) == saved


def test_drift_and_candidate_match_jax(both64):
    for est, observed in ((None, 5), (100, 24), (100, 26), (1, 4), (4, 1),
                          (0, 0), (4096, 128), (10_000_000, 100_000)):
        assert adaptive.drift(est, observed) == \
            jax_adaptive.drift(est, observed)
        assert adaptive.rebucket_candidate(est, max(observed, 1)) == \
            jax_adaptive.rebucket_candidate(est, max(observed, 1))
        assert adaptive.rebucket_candidate(observed, est or 1) == \
            jax_adaptive.rebucket_candidate(observed, est or 1)


@pytest.mark.parametrize("keys", ["dimension", "duplicates", "nan",
                                  "negative", "wide", "fractional", "int"])
@pytest.mark.parametrize("how", ["inner", "left", "right", "outer"])
def test_join_plan_fast_paths_equal_the_general_plan(keys, how,
                                                     monkeypatch):
    """The join plan's radix-and-table path (ids in [0, 2^16)) and its
    unique-right-key path give the pairs of the general sort-and-search
    plan, in order, in both build directions."""
    from sparkdq4ml_tpu_torch.frame import frame as F

    rng = np.random.default_rng(len(keys) * 31 + len(how))
    left = rng.integers(0, 40, 300).astype(np.float64)
    right = {"dimension": np.arange(32.0),
             "duplicates": rng.integers(0, 30, 90).astype(np.float64),
             "nan": np.where(rng.random(60) < 0.2, np.nan,
                             rng.integers(0, 30, 60)),
             "negative": rng.integers(-5, 30, 60).astype(np.float64),
             "wide": rng.integers(0, 1 << 17, 60).astype(np.float64),
             "fractional": rng.integers(0, 30, 60) + 0.5,
             "int": rng.integers(0, 30, 60)}[keys]
    if keys == "int":
        left = left.astype(np.int64)
    li, ri = np.arange(left.size) * 2, np.arange(right.size) * 3
    fast = [F._join_plan([left], [right], li, ri, how, b)
            for b in (False, True)]
    monkeypatch.setattr(F, "_small_ids", lambda a, b: None)
    general = F._join_plan([left], [right], li, ri, how)
    for lp, rp in fast[:1] + (fast[1:] if how == "inner" else []):
        np.testing.assert_array_equal(lp, general[0])
        np.testing.assert_array_equal(rp, general[1])
