"""The port's ``EXPLAIN [ANALYZE]`` (``sparkdq4ml_tpu_torch/sql/
parser.py``) and ``Frame.explain`` against the JAX package's, on the CPU:
the plan-tree and EXPLAIN cases of ``tests/test_explain.py``.

Plain ``EXPLAIN`` returns the JAX package's text (under
``spark.audit.enabled=false`` and ``spark.dq.profile.enabled=false``);
``EXPLAIN ANALYZE`` gives the same tree, row counts, compile/hit
verdicts, sections and section order (``torch_planner.
assert_same_analysis``). Wall times, host reads, memory and cost columns
are the port's own and are not compared.
"""

import re

import numpy as np
import pytest

from sparkdq4ml_tpu.sql import parser as jax_parser
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.sql import parser
from sparkdq4ml_tpu_torch.utils import observability as obs
from sparkdq4ml_tpu_torch.utils.profiling import counters
from torch_planner import (assert_same_analysis, both, both64,  # noqa: F401
                           jax_run, plan, port_run, register, section,
                           setting)

HEADLINE_DQ = ("SELECT cast(guest as int) guest, price_no_min AS price "
               "FROM price WHERE price_no_min > 0")
NODE_FIELDS = ("rows_in=", "rows_out=", "wall_ms=", "compile=",
               "host_syncs=", "peak_mem=")


def _views():
    register("t", {"a": [1.0, 2.0, 3.0, 4.0], "k": [1, 1, 2, 2]})
    register("u", {"k": [1, 2], "b": [10.0, 20.0]})


def _nodes(text: str) -> list:
    return section(text, "Analyzed Plan")


# ---------------------------------------------------------------------------
# The plan tree
# ---------------------------------------------------------------------------

TREE_QUERIES = [
    "SELECT a FROM t WHERE a > 1 ORDER BY a LIMIT 5",
    "SELECT t.a FROM t JOIN u USING (k)",
    "SELECT a FROM t WHERE a > 1 LIMIT 2",
    "SELECT a FROM t",
    "SELECT k, count(*) c FROM t GROUP BY k ORDER BY k",
    "SELECT k, median(a) m FROM t GROUP BY k",
    "SELECT k, sum(a) s FROM t WHERE a > 0 GROUP BY k HAVING sum(a) > 1",
    "SELECT DISTINCT k FROM t",
    "SELECT a FROM t ORDER BY a LIMIT 2 OFFSET 1",
    "SELECT upper(cast(a AS string)) s FROM t WHERE a > 1",
    "SELECT a FROM (SELECT a FROM t WHERE a > 0) sub WHERE a < 4",
    "WITH big AS (SELECT a FROM t WHERE a > 1) SELECT a FROM big",
    "SELECT a FROM t UNION ALL SELECT b FROM u",
    "SELECT k FROM t GROUP BY ROLLUP(k)",
    "SELECT a, row_number() OVER (ORDER BY a) r FROM t",
]


@pytest.mark.parametrize("sql", TREE_QUERIES)
def test_plan_tree_and_summary_match(both64, sql):
    q, jq = parser.parse(sql), jax_parser.parse(sql)
    assert parser.plan_summary(q) == jax_parser.plan_summary(jq)
    tree = parser.plan_tree(q)
    assert tree.render() == jax_parser.plan_tree(jq).render()
    assert [n.label for n in tree.main_chain()] == \
        [n.label for n in jax_parser.plan_tree(jq).main_chain()]
    assert all(not n.stats for n in tree.walk())


def test_join_nodes_carry_right_scan_child(both64):
    tree = parser.plan_tree(parser.parse("SELECT t.a FROM t JOIN u USING (k)"))
    join = next(n for n in tree.walk() if n.op == "Join")
    assert [c.label for c in join.children] == ["Scan[t]", "Scan[u]"]


def test_pipeline_off_renders_unfused(both64):
    setting(pipeline=False)
    sql = "SELECT a FROM t WHERE a > 1"
    assert parser.plan_tree(parser.parse(sql)).render() == \
        jax_parser.plan_tree(jax_parser.parse(sql)).render()
    assert "FusedStage" not in parser.plan_summary(parser.parse(sql))


# ---------------------------------------------------------------------------
# Plain EXPLAIN
# ---------------------------------------------------------------------------

EXPLAIN_QUERIES = TREE_QUERIES + [
    "CREATE OR REPLACE TEMP VIEW v AS SELECT a FROM t",
    "DROP VIEW IF EXISTS v",
]


@pytest.mark.parametrize("sql", EXPLAIN_QUERIES)
def test_explain_text_equals_jax(both, sql):
    _views()
    jax_text, text = plan("EXPLAIN " + sql)
    assert text == jax_text
    assert text.startswith("== Physical Plan ==")


def test_returns_one_row_plan_frame(both64):
    _views()
    out = parser.execute("EXPLAIN SELECT a FROM t WHERE a > 1")
    assert out.columns == ["plan"] and out.count() == 1


def test_explain_is_case_insensitive(both64):
    _views()
    assert port_run("explain SELECT a FROM t")["plan"][0] == \
        port_run("EXPLAIN SELECT a FROM t")["plan"][0]


def test_no_execution_no_flush(both64):
    _views()
    before = counters.snapshot()
    parser.execute("EXPLAIN SELECT a, a * 2 AS b FROM t WHERE a > 1 "
                   "ORDER BY a")
    after = counters.snapshot()
    for key in ("pipeline.flush", "pipeline.compile", "grouped.compile",
                "frame.host_sync"):
        assert after.get(key, 0) == before.get(key, 0), key


def test_explain_leaves_tracer_disabled(both64):
    _views()
    port_run("EXPLAIN SELECT a FROM t")
    assert not obs.TRACER.enabled


def test_nested_explain_refused(both64):
    _views()
    with pytest.raises(ValueError, match="nested EXPLAIN"):
        parser.execute("EXPLAIN CREATE VIEW v AS EXPLAIN SELECT a FROM t")


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

ANALYZE_QUERIES = [
    "SELECT a FROM t WHERE a > 1",
    "SELECT k, count(*) c, avg(a) m FROM t WHERE a > 0 GROUP BY k "
    "ORDER BY k",
    "SELECT k, count(*) c FROM t GROUP BY k",
    "SELECT t.a, u.b FROM t JOIN u USING (k) WHERE a > 1",
    "SELECT k, sum(a) s FROM t WHERE a > 0 GROUP BY k HAVING sum(a) > 1",
    "SELECT a FROM (SELECT a FROM t WHERE a > 0) sub WHERE a < 4",
    "WITH big AS (SELECT a FROM t WHERE a > 1) SELECT a FROM big WHERE a < 4",
    "SELECT DISTINCT k FROM t",
    "SELECT a FROM t WHERE a > 2 UNION ALL SELECT a FROM t WHERE a < 2",
    "SELECT a FROM t ORDER BY a LIMIT 2 OFFSET 1",
]


@pytest.mark.parametrize("sql", ANALYZE_QUERIES)
def test_analyze_structure_equals_jax(both, sql):
    _views()
    first = plan("EXPLAIN ANALYZE " + sql)
    assert_same_analysis(*first)
    again = plan("EXPLAIN ANALYZE " + sql)        # compile -> hit
    assert_same_analysis(*again)
    for line in _nodes(first[1]):
        for field in NODE_FIELDS:
            assert field in line, (field, line)


def test_repeat_flips_compile_to_hit(both64):
    _views()
    q = ("EXPLAIN ANALYZE SELECT k, count(*) c, avg(a) m FROM t "
         "WHERE a > 0 GROUP BY k ORDER BY k")
    agg = next(ln for ln in _nodes(port_run(q)["plan"][0])
               if "SegmentedAggregate" in ln)
    assert "compile=compile" in agg
    agg = next(ln for ln in _nodes(port_run(q)["plan"][0])
               if "SegmentedAggregate" in ln)
    assert "compile=hit" in agg and "lowering=" in agg


def test_where_and_having_filters_not_swapped(both64):
    _views()
    nodes = _nodes(port_run(
        "EXPLAIN ANALYZE SELECT k, sum(a) s FROM t WHERE a > 0 "
        "GROUP BY k HAVING sum(a) > 1")["plan"][0])
    filt = next(ln for ln in nodes if re.search(r"\bFilter\b", ln)
                and "FusedStage" not in ln)
    having = next(ln for ln in nodes if "Having" in ln)
    assert "rows_in=4" in filt and "rows_in=2" in having


def test_cache_section_lists_touched_programs(both64):
    _views()
    text = port_run("EXPLAIN ANALYZE SELECT a FROM t WHERE a > 1")["plan"][0]
    assert "== Caches ==" in text and "pipeline:" in text
    assert "program " in text


def test_caches_and_memory_gated_by_conf(both64):
    _views()
    setting(explain_caches=False, explain_memory=False)
    text = port_run("EXPLAIN ANALYZE SELECT a FROM t WHERE a > 1")["plan"][0]
    assert "== Caches ==" not in text and "live_bytes=" not in text
    assert all("peak_mem=-" in ln for ln in _nodes(text))
    setting(explain_caches=True, explain_memory=True)
    text = port_run("EXPLAIN ANALYZE SELECT a FROM t WHERE a > 1")["plan"][0]
    assert "live_bytes=" in text
    assert any(re.search(r"peak_mem=\d", ln) for ln in _nodes(text))


def test_costprof_off_drops_cost_columns(both64):
    _views()
    setting(costprof_enabled=False)
    text = port_run("EXPLAIN ANALYZE SELECT a FROM t WHERE a > 1")["plan"][0]
    assert "est_flops" not in text and "bound=" not in text
    setting(costprof_enabled=True)
    text = port_run("EXPLAIN ANALYZE SELECT a FROM t WHERE a > 1")["plan"][0]
    stage = next(ln for ln in _nodes(text) if "FusedStage" in ln)
    assert re.search(r"est_flops=\d", stage) and "bound=memory" in stage


def test_analyze_leaves_tracer_state(both64):
    _views()
    port_run("EXPLAIN ANALYZE SELECT a FROM t WHERE a > 1")
    assert not obs.TRACER.enabled and not obs.TRACER.mem_sample


@pytest.mark.parametrize("dataset,rows", [("abstract", (40, 34, 24)),
                                          ("small", (27, 24, 20)),
                                          ("full", (1040, 1034, 1024))])
def test_headline_dq_queries_analyzed(both64, dataset, rows):
    """The reference app's two DQ queries under EXPLAIN ANALYZE: every
    node annotated, the golden row counts, the JAX package's structure."""
    import sparkdq4ml_tpu as jdq
    import sparkdq4ml_tpu_torch as tdq
    from sparkdq4ml_tpu.session import TpuSession

    jspark = TpuSession.builder().app_name("explain").get_or_create()
    try:
        path = f"data/dataset-{dataset}.csv"
        for mod, spark in ((jdq, jspark), (tdq, both64)):
            mod.register_builtin_rules()
            df = (spark.read.format("csv").option("inferSchema", "true")
                  .load(path))
            df = df.with_column_renamed("_c0", "guest").with_column_renamed(
                "_c1", "price")
            df.with_column("price_no_min", mod.call_udf(
                "minimumPriceRule", mod.col("price"))
            ).create_or_replace_temp_view("price")
        first = plan("EXPLAIN ANALYZE " + HEADLINE_DQ)
        assert_same_analysis(*first)
        nodes = _nodes(first[1])
        for line in nodes:
            for field in NODE_FIELDS:
                assert field in line, (field, line)
        assert f"rows_in={rows[0]}" in nodes[0]
        assert f"rows_valid={rows[1]}" in nodes[0]
        for mod, spark in ((jdq, jspark), (tdq, both64)):
            d = spark.sql(HEADLINE_DQ)
            d.with_column("price_correct_correl", mod.call_udf(
                "priceCorrelationRule", mod.col("price"), mod.col("guest"))
            ).create_or_replace_temp_view("price")
        second = plan("EXPLAIN ANALYZE SELECT guest, price_correct_correl "
                      "AS price FROM price WHERE price_correct_correl > 0")
        assert_same_analysis(*second)
        assert f"rows_valid={rows[2]}" in _nodes(second[1])[0]
    finally:
        jspark.stop()


# ---------------------------------------------------------------------------
# Frame.explain
# ---------------------------------------------------------------------------

def test_frame_pending_pipeline_profile(both64):
    f = (TFrame({"x": [1.0, 2.0, 3.0]}, device="cpu")
         .with_column("y", TE.col("x") * 2).filter(TE.col("y") > 2))
    text = f.explain_string(analyze=True)
    for part in ("== Analyzed ==", "frame.pipeline.flush", "cache=",
                 "counters:", "pipeline.flush=1", "== Physical Frame =="):
        assert part in text
    assert "row slots: 3 (valid: 2, masked: 1)" in text


def test_frame_materialized_reports_nothing_pending(both64):
    f = TFrame({"x": [1.0, 2.0]}, device="cpu")
    f.count()
    assert "nothing pending" in f.explain_string(analyze=True)


def test_frame_plain_explain(both64, capsys):
    from sparkdq4ml_tpu.frame.frame import Frame as JFrame

    TFrame({"x": [1.0, 2.0], "s": np.asarray(["a", None], object)},
           device="cpu").explain()
    out = capsys.readouterr().out
    JFrame({"x": [1.0, 2.0], "s": np.asarray(["a", None], object)}).explain()
    assert out == capsys.readouterr().out
    assert out.startswith("== Physical Frame ==")
    assert "== Analyzed ==" not in out
