"""The port's cost-based optimizer (``sparkdq4ml_tpu_torch/sql/
optimizer.py``, its executor hook and the compiler's and grouped engine's
lowering hooks) against the JAX package's, on the CPU: the cases of
``tests/test_optimizer.py`` without its sharded ones and its fault site
(the port has no fault layer yet).

For each statement: the port's result with the optimizer on equals its
result with it off (column for column, or as sorted rows for the level-2
reorder) and the JAX package's result; the plain ``EXPLAIN`` texts of the
two packages are equal (the rewrite lines, the rewritten tree, the tree
before optimization). Statstore snapshots built in one package steer the
other's plan the same way.
"""

import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import compiler as jax_compiler
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu.utils import statstore as jax_statstore
from sparkdq4ml_tpu.utils.profiling import counters as jax_counters
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import config
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import compiler
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.sql import optimizer as opt
from sparkdq4ml_tpu_torch.sql import parser
from sparkdq4ml_tpu_torch.utils import statstore
from sparkdq4ml_tpu_torch.utils.profiling import counters
from torch_planner import (assert_exact, assert_sorted, both,  # noqa: F401
                           both64, jax_run, plan, port_run, register,
                           setting, suite_views)


def _pair(sql: str, level: int = 1):
    """The port's (off, on) results and the JAX package's on result (each
    package runs both arms, so their statstores hold the same history)."""
    setting(optimizer_level=level, optimizer_enabled=False)
    off = port_run(sql)
    jax_run(sql)
    setting(optimizer_enabled=True)
    return off, port_run(sql), jax_run(sql)


def _check(sql: str, level: int = 1) -> str:
    """Parity of ``sql`` (see the module docstring); returns the port's
    EXPLAIN text."""
    off, on, jax_on = _pair(sql, level)
    if level >= 2:
        assert_sorted(off, on)
        assert_sorted(jax_on, on)
    else:
        assert_exact(off, on)
        assert_exact(jax_on, on)
    jax_text, port_text = plan("EXPLAIN " + sql)
    assert port_text == jax_text
    return port_text


PARITY = {
    "plain_filter": "SELECT v, x1 FROM big WHERE v < 0 AND k > 5",
    "join_pushdown_both_sides": (
        "SELECT k, v, u FROM big JOIN mid USING (k) "
        "WHERE v < -0.5 AND u > 0"),
    "join_build_side_small_left": "SELECT k, w, v FROM small JOIN big "
                                  "USING (k)",
    "left_join_pushes_left_only": (
        "SELECT k, v, w FROM big LEFT JOIN small USING (k) "
        "WHERE v < -0.5 AND x1 > 0"),
    "group_by_over_join": (
        "SELECT k, count(*) c, sum(v) s FROM big JOIN small "
        "USING (k) WHERE v < 0.5 GROUP BY k ORDER BY k"),
    "cte": ("WITH f AS (SELECT k, v FROM big WHERE v < 0) "
            "SELECT k, v, u FROM f JOIN mid USING (k) WHERE u > 0"),
    "set_ops": ("SELECT k FROM big WHERE v < -1 UNION "
                "SELECT k FROM small WHERE w > 0"),
    "limit_offset": ("SELECT k, v, u FROM big JOIN mid USING (k) "
                     "WHERE v < 0 ORDER BY v LIMIT 7 OFFSET 2"),
    "joined_derived_table": (
        "SELECT big.k, v, sw FROM big JOIN "
        "(SELECT s.k, w AS sw FROM small s JOIN mid USING (k) "
        "WHERE u > 0) sub USING (k) WHERE v < 0"),
    "three_way_level1": ("SELECT v, u, w FROM big JOIN mid USING (k) "
                         "JOIN small USING (k) WHERE v < 0"),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_parity(both, case):
    suite_views()
    text = _check(PARITY[case])
    if case == "join_build_side_small_left":
        assert "build=left" in text
    if case == "left_join_pushes_left_only":
        assert "pushdown" in text and "Scan[small]\n" in text + "\n"
    if case == "joined_derived_table":
        assert "pushdown: (u > 0) -> Scan[mid]" in text
        after = text.split("== Before Optimization ==")[0]
        assert after.count("Scan[(subquery)]") >= 2


@pytest.mark.parametrize("case", sorted(PARITY))
def test_parity_level2(both64, case):
    suite_views()
    text = _check(PARITY[case], level=2)
    if case == "three_way_level1":
        assert "join-reorder" in text


def test_collision_column_referenced_only_via_alias(both):
    register("ca", {"k": np.arange(8).astype(np.float64),
                    "x": np.arange(8) * 1.0, "junk": np.arange(8) * 3.0})
    register("cb", {"k": np.arange(8).astype(np.float64),
                    "x": np.arange(8) * 2.0})
    sql = "SELECT b.x, a.k FROM ca a JOIN cb b USING (k)"
    off, on, jax_on = _pair(sql)
    assert list(off) == list(on) == ["x_right", "k"]
    assert_exact(off, on)
    assert_exact(jax_on, on)
    assert plan("EXPLAIN " + sql)[0] == plan("EXPLAIN " + sql)[1]


def test_string_key_join(both):
    register("ls", {"s": np.asarray(["a", "b", "c", "b"], object),
                    "v": [1.0, 2.0, 3.0, 4.0]})
    register("rs", {"s": np.asarray(["b", "c", "d"], object),
                    "w": [10.0, 20.0, 30.0]})
    _check("SELECT s, v, w FROM ls JOIN rs USING (s)")


def test_explain_diff_renders_with_zero_execution(both64):
    suite_views()
    sql = "SELECT k, v, u FROM big JOIN mid USING (k) WHERE v < -0.5 AND u > 0"
    before = counters.snapshot()
    frame = parser.execute("EXPLAIN " + sql)
    after = counters.snapshot()
    text = frame.to_pydict()["plan"][0]
    for key in ("pipeline.flush", "pipeline.compile", "grouped.compile",
                "frame.host_sync"):
        assert after.get(key, 0) == before.get(key, 0), key
    for part in ("== Rewrites ==", "== Before Optimization ==",
                 "pushdown", "prune", "Scan[(subquery)]"):
        assert part in text


def test_disabled_mode_renders_literal_plan(both64):
    suite_views()
    setting(optimizer_enabled=False)
    jax_text, text = plan("EXPLAIN SELECT k, v, u FROM big JOIN mid "
                          "USING (k) WHERE v < -0.5 AND u > 0")
    assert text == jax_text
    assert "== Rewrites ==" not in text and "Scan[big]" in text


def test_explain_analyze_executes_optimized_plan(both64):
    suite_views()
    text = port_run("EXPLAIN ANALYZE SELECT k, v, u FROM big JOIN mid "
                    "USING (k) WHERE v < -0.5 AND u > 0")["plan"][0]
    assert "== Rewrites ==" in text and "== Query Stats ==" in text


def test_failure_degrades_to_unrewritten_plan(both64, monkeypatch):
    suite_views()
    sql = "SELECT k, v, u FROM big JOIN mid USING (k) WHERE v < 0"
    setting(optimizer_enabled=False)
    ref = port_run(sql)
    setting(optimizer_enabled=True)

    def broken(q, cat):
        raise RuntimeError("planner fault")

    monkeypatch.setattr(opt, "optimize", broken)
    before = counters.get("optimizer.fallback")
    assert_exact(ref, port_run(sql))
    assert counters.get("optimizer.fallback") == before + 1


def test_disabled_applies_no_rewrites(both64):
    suite_views()
    setting(optimizer_enabled=False)
    before = counters.get("optimizer.rewrite")
    port_run("SELECT k, v, u FROM big JOIN mid USING (k) WHERE v < 0")
    assert counters.get("optimizer.rewrite") == before


def test_rewrite_counts_match(both64):
    suite_views()
    sql = PARITY["join_pushdown_both_sides"]
    a0, b0 = jax_counters.get("optimizer.rewrite"), counters.get(
        "optimizer.rewrite")
    jax_run(sql)
    port_run(sql)
    assert counters.get("optimizer.rewrite") - b0 == \
        jax_counters.get("optimizer.rewrite") - a0 > 0


def test_session_conf_scoping():
    saved = (config.optimizer_enabled, config.optimizer_level)
    s = TorchSession.builder().config("spark.torch.device", "cpu").config(
        "spark.optimizer.enabled", "false").config(
        "spark.optimizer.level", "2").get_or_create()
    try:
        assert config.optimizer_enabled is False
        assert config.optimizer_level == 2
    finally:
        s.stop()
    assert (config.optimizer_enabled, config.optimizer_level) == saved


# ---------------------------------------------------------------------------
# Lowering hooks: the stage split, the planned chunking, the dense skip
# ---------------------------------------------------------------------------

def _chain(f, E, steps, tail_col=None):
    for i in range(steps):
        src = tail_col if tail_col and i >= steps // 2 else "v"
        f = f.with_column(f"c{i}", E.col(src) * float(i + 1) + 0.5)
    return f


def _frames(cols):
    return (JFrame({k: np.array(v) for k, v in cols.items()}),
            TFrame({k: np.array(v) for k, v in cols.items()}, device="cpu"))


def test_stage_split_at_warm_prefix(both, monkeypatch):
    monkeypatch.setattr(compiler, "_SPLIT_MIN_COMPILE_MS", 0.0)
    monkeypatch.setattr(jax_compiler, "_SPLIT_MIN_COMPILE_MS", 0.0)
    rng = np.random.default_rng(0)
    cols = {"v": rng.normal(size=256), "y": rng.normal(size=256)}
    jf, tf = _frames(cols)
    setting(optimizer_level=1)
    ref = _chain(tf, TE, 12, "y")._data["c11"].clone()
    for c in (compiler, jax_compiler):
        c.clear_cache()
    statstore.STORE.clear()
    jax_statstore.STORE.clear()
    setting(optimizer_level=2)
    _chain(tf, TE, 6).count()
    _chain(jf, JE, 6).count()
    before = (counters.get("optimizer.split"),
              jax_counters.get("optimizer.split"))
    out = _chain(tf, TE, 12, "y")
    jout = _chain(jf, JE, 12, "y")
    out.count()
    jout.count()
    assert counters.get("optimizer.split") == before[0] + 1
    assert jax_counters.get("optimizer.split") == before[1] + 1
    assert torch.equal(out._data["c11"], ref)
    # XLA fuses the multiply-add of each step; torch rounds twice
    np.testing.assert_allclose(np.asarray(jout._data["c11"]), ref.numpy(),
                               rtol=1e-6)
    # the prefix and the tail are cached in both packages
    assert {e["program_key"] for e in compiler.cache_stats()["entries"]} \
        == {e["program_key"] for e in jax_compiler.cache_stats()["entries"]}


def test_split_decision_from_a_shared_snapshot(both64, tmp_path):
    """A snapshot recording the prefix's first-run cost at 5 ms (the
    threshold) makes both packages split; the port's own recorded cost
    (its flush time, far below it) does not."""
    rng = np.random.default_rng(9)
    cols = {"v": rng.normal(size=64), "y": rng.normal(size=64)}
    jf, tf = _frames(cols)
    setting(optimizer_level=2)
    _chain(tf, TE, 6).count()
    _chain(jf, JE, 6).count()
    before = counters.get("optimizer.split")
    _chain(tf, TE, 12, "y").count()
    assert counters.get("optimizer.split") == before
    compiler.clear_cache()
    statstore.STORE.clear()
    _chain(tf, TE, 6).count()
    prefix = next(e["program_key"]
                  for e in compiler.cache_stats()["entries"])
    store = jax_statstore.StatStore()
    store.record_flush(prefix, "pipeline", wall_ms=5.0, compiled=True)
    path = str(tmp_path / "snap.jsonl")
    assert store.save(path, merge=False)
    statstore.STORE.clear()
    statstore.STORE.load(path)
    jax_statstore.STORE.clear()
    jax_statstore.STORE.load(path)
    _chain(tf, TE, 12, "y").count()
    jax_before = jax_counters.get("optimizer.split")
    _chain(jf, JE, 12, "y").count()
    assert counters.get("optimizer.split") == before + 1
    assert jax_counters.get("optimizer.split") == jax_before + 1


def test_planned_memory_chunking_from_history(both):
    rng = np.random.default_rng(1)
    jf, tf = _frames({"v": rng.normal(size=64)})
    out = tf.with_column("d", TE.col("v") * 2.0)
    ref = out._data["d"].clone()
    key = compiler.cache_stats()["entries"][0]["program_key"]
    jout = jf.with_column("d", JE.col("v") * 2.0)
    jout.count()
    jkey = jax_compiler.cache_stats()["entries"][0]["program_key"]
    assert key == jkey
    statstore.STORE.record_flush(key, "pipeline", est_bytes=1 << 40)
    jax_statstore.STORE.record_flush(jkey, "pipeline", est_bytes=1 << 40)
    setting(audit_device_budget=1 << 20)
    c0 = (counters.get("optimizer.mem_chunk"),
          counters.get("pipeline.oom_chunked"),
          jax_counters.get("optimizer.mem_chunk"),
          jax_counters.get("pipeline.oom_chunked"))
    out2 = tf.with_column("d", TE.col("v") * 2.0)
    got = out2._data["d"]
    jf.with_column("d", JE.col("v") * 2.0).count()
    assert (counters.get("optimizer.mem_chunk") - c0[0],
            counters.get("pipeline.oom_chunked") - c0[1]) == \
        (jax_counters.get("optimizer.mem_chunk") - c0[2],
         jax_counters.get("pipeline.oom_chunked") - c0[3]) == (1, 1)
    assert torch.equal(got, ref)


def test_over_budget_flush_runs_chunked_bit_identical(both):
    rng = np.random.default_rng(4)
    v = rng.normal(size=1000)
    tf = TFrame({"v": v, "w": rng.normal(size=1000)}, device="cpu")

    def run():
        return (tf.with_column("d", TE.col("v") * 3.0 - TE.col("w"))
                .filter(TE.col("d") > 0.25))

    ref = run()
    ref_d, ref_m = ref._data["d"].clone(), ref._mask.clone()
    setting(audit_device_budget=4096)
    before = counters.get("pipeline.oom_chunked")
    got = run()
    assert torch.equal(got._data["d"], ref_d)
    assert torch.equal(got._mask, ref_m)
    assert counters.get("pipeline.oom_chunked") == before + 1


def test_grouped_dense_skip_from_miss_history(both):
    rng = np.random.default_rng(2)
    vals = rng.normal(size=32)

    def grouped(F):
        f = F({"k": np.asarray([0.0, 1e9] * 16), "v": vals.copy()},
              **({"device": "cpu"} if F is TFrame else {}))
        return f.group_by("k").agg({"v": "sum"}).to_pydict()

    ref = grouped(TFrame)
    grouped(TFrame)
    jref = grouped(JFrame)
    grouped(JFrame)
    before = (counters.get("optimizer.dense_skip"),
              counters.get("grouped.dense_miss"),
              jax_counters.get("optimizer.dense_skip"),
              jax_counters.get("grouped.dense_miss"))
    got = grouped(TFrame)
    jgot = grouped(JFrame)
    assert counters.get("optimizer.dense_skip") == before[0] + 1
    assert counters.get("grouped.dense_miss") == before[1]
    assert jax_counters.get("optimizer.dense_skip") == before[2] + 1
    assert jax_counters.get("grouped.dense_miss") == before[3]
    assert_exact(ref, got)
    assert_exact(jref, jgot)
    assert_exact(jgot, got)


# ---------------------------------------------------------------------------
# Shared statstore snapshots steer both packages' plans alike
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("built_in", ["jax", "port"])
def test_snapshot_est_rows_and_reorder(both64, tmp_path, built_in):
    """A snapshot of a selective filter's history, built in one package,
    gives both packages the same ``est_rows`` and the same level-2 join
    order (the filtered relation first)."""
    suite_views()
    run = jax_run if built_in == "jax" else port_run
    run("SELECT k, u FROM mid WHERE u > 1.5")
    store = jax_statstore.STORE if built_in == "jax" else statstore.STORE
    store.drain_pending()
    path = str(tmp_path / "snap.jsonl")
    assert store.save(path, merge=False)
    statstore.STORE.clear()
    jax_statstore.STORE.clear()
    statstore.STORE.load(path)
    jax_statstore.STORE.load(path)
    setting(optimizer_level=2)
    sql = ("SELECT v, u, w FROM big JOIN small USING (k) JOIN mid USING (k) "
           "WHERE u > 1.5")
    jax_text, text = plan("EXPLAIN " + sql)
    assert text == jax_text
    assert "join-reorder: mid~" in text
    assert "est_rows=" in text
    jax_text, text = plan("EXPLAIN SELECT k, u FROM mid WHERE u > 1.5")
    assert text == jax_text
    assert "est_rows=128" not in text.splitlines()[1]


# ---------------------------------------------------------------------------
# est_rows through the With/SetOps wrappers
# ---------------------------------------------------------------------------

def test_cte_scan_resolves_body_estimate(both64):
    suite_views()
    jax_run("SELECT v FROM big WHERE v < -1.0")
    port_run("SELECT v FROM big WHERE v < -1.0")
    jax_statstore.STORE.drain_pending()
    statstore.STORE.drain_pending()
    jax_text, text = plan("EXPLAIN WITH c AS (SELECT v FROM big WHERE "
                          "v < -1.0) SELECT v FROM c LIMIT 5")
    assert text == jax_text
    scan_line = next(ln for ln in text.splitlines() if "Scan[c]" in ln)
    assert "est_rows=-" not in scan_line and "est_rows=" in scan_line
    with_line = next(ln for ln in text.splitlines()
                     if ln.startswith("With["))
    assert "est_rows=5" in with_line


def test_setops_branches_annotated(both64):
    suite_views()
    jax_text, text = plan("EXPLAIN SELECT v FROM big UNION ALL "
                          "SELECT w FROM small")
    assert text == jax_text
    setops_line = next(ln for ln in text.splitlines()
                       if ln.startswith("SetOps["))
    assert "est_rows=4064" in setops_line


def test_headline_app_unchanged_with_level2(both64):
    """The reference app's DQ queries give the same rows with the
    optimizer at level 2 and off."""
    import sparkdq4ml_tpu_torch as tdq

    out = {}
    for arm in (False, True):
        setting(optimizer_enabled=arm, optimizer_level=2)
        df = both64.read.format("csv").option("inferSchema", "true").load(
            "data/dataset-abstract.csv")
        df = df.with_column_renamed("_c0", "guest").with_column_renamed(
            "_c1", "price")
        tdq.register_builtin_rules()
        df = df.with_column("price_no_min", tdq.call_udf(
            "minimumPriceRule", tdq.col("price")))
        df.create_or_replace_temp_view("price")
        d = both64.sql("SELECT cast(guest as int) guest, price_no_min AS "
                       "price FROM price WHERE price_no_min > 0")
        d = d.with_column("price_correct_correl", tdq.call_udf(
            "priceCorrelationRule", tdq.col("price"), tdq.col("guest")))
        d.create_or_replace_temp_view("price")
        d = both64.sql("SELECT guest, price_correct_correl AS price FROM "
                       "price WHERE price_correct_correl > 0")
        out[arm] = d.to_pydict()
    assert len(out[True]["guest"]) == 24
    assert_exact(out[False], out[True])
