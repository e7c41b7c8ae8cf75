"""The port's spans, metrics and cache registry (``sparkdq4ml_tpu_torch/
utils/observability.py``) against the JAX package's, on the CPU.

* the spans of the reference app's two SQL queries (``sql.query`` >
  ``frame.filter``, ``frame.select`` > ``frame.pipeline.flush``) have the
  same names and nesting, and their flushes the same ``steps``, ``rows``,
  ``bucket`` and ``cache`` attributes, cold and warm;
* ``cache_report()``'s pipeline entry and ``metrics()``'s keys agree
  after the same calls;
* ``chrome_trace()`` is well formed; ``trace_report()``,
  ``prometheus_text()``, histograms, ``query_stats`` and the disabled
  mode behave as in the JAX package.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.frame.frame import Frame as JFrame
from sparkdq4ml_tpu.ops import compiler as jax_compiler
from sparkdq4ml_tpu.ops import expressions as JE
from sparkdq4ml_tpu.utils import observability as jax_obs
from sparkdq4ml_tpu.utils import statstore as jax_statstore
from sparkdq4ml_tpu.utils.profiling import counters as jax_counters
from sparkdq4ml_tpu_torch import TorchSession
from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import compiler
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.sql import default_catalog
from sparkdq4ml_tpu_torch.utils import observability as obs
from sparkdq4ml_tpu_torch.utils import statstore
from sparkdq4ml_tpu_torch.utils.profiling import counters

APP_SQL = ("SELECT cast(guest as int) guest, price_no_min AS price "
           "FROM price WHERE price_no_min > 0",
           "SELECT guest, price_correct_correl AS price "
           "FROM price WHERE price_correct_correl > 0")
FLUSH_ATTRS = ("steps", "outputs", "rows", "bucket", "cache", "plan_key")


def _reset():
    for c, cnt, st, o in ((compiler, counters, statstore, obs),
                          (jax_compiler, jax_counters, jax_statstore,
                           jax_obs)):
        c.clear_cache()
        cnt.clear()
        st.STORE.clear()
        o.reset()
        o.disable()


@pytest.fixture
def both(session):
    """Both packages in float32 (the app's policy), tracing on, fresh
    state; yields the (JAX, port) sessions."""
    saved = (jax_config.default_float_dtype, jax_config.dq_profile_enabled)
    jax_config.default_float_dtype = jnp.float32
    jax_config.dq_profile_enabled = False
    _reset()
    port = (TorchSession.builder().app_name("test")
            .config("spark.torch.device", "cpu").get_or_create())
    try:
        with jax.enable_x64(False), float_policy(torch.float32):
            jax_obs.enable()
            obs.enable()
            yield session, port
    finally:
        port.stop()
        default_catalog().clear()
        jax_config.default_float_dtype, jax_config.dq_profile_enabled = \
            saved
        _reset()


def _app_table(seed=0, n=40):
    rng = np.random.default_rng(seed)
    guest = rng.integers(1, 40, n).astype(np.int32)
    price = np.round(5.0 * guest + 20.0 + rng.normal(0.0, 3.0, n), 2)
    price[: n // 8] = rng.uniform(0.0, 20.0, n // 8)
    return {"guest": guest, "price": price}


def _run_app_queries(sess, F, E, kw, runs=2):
    """The app's DQ SQL as the app runs it, ``runs`` times (cold, then
    warm): the rule columns here are plain expressions of price."""
    for _ in range(runs):
        d = F(_app_table(), **kw).with_column(
            "price_no_min", E.col("price") * 1.0)
        d._data
        d.create_or_replace_temp_view("price")
        d = sess.sql(APP_SQL[0])
        d = d.with_column("price_correct_correl", E.col("price") - 30.0)
        d._data
        d.create_or_replace_temp_view("price")
        sess.sql(APP_SQL[1]).count()


def _sql_trees(o) -> list:
    spans = sorted(o.TRACER.spans(), key=lambda s: (s.ts_us, s.sid))
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent_id, []).append(s)

    def tree(s):
        node = {"name": s.name, "cat": s.cat,
                "children": [tree(c) for c in kids.get(s.sid, [])]}
        if s.name == "frame.pipeline.flush":
            node["attrs"] = {k: s.attrs.get(k) for k in FLUSH_ATTRS}
        if s.name == "sql.query":
            node["query"] = s.attrs.get("query")
            node["rows_out"] = s.attrs.get("rows_out")
        return node

    return [tree(s) for s in spans if s.name == "sql.query"]


def test_app_query_spans_match(both):
    js, ts = both
    _run_app_queries(js, JFrame, JE, {})
    _run_app_queries(ts, TFrame, TE, {"device": "cpu"})
    got, want = _sql_trees(obs), _sql_trees(jax_obs)
    assert len(got) == 4
    assert got == want
    flushes = [c["children"][0]["attrs"] for t in got
               for c in t["children"] if c["name"] == "frame.select"]
    assert [f["cache"] for f in flushes] == ["compile", "compile", "hit",
                                             "hit"]
    assert {f["bucket"] for f in flushes} == {64}


def test_cache_report_and_metrics_match(both):
    js, ts = both
    _run_app_queries(js, JFrame, JE, {}, runs=3)
    _run_app_queries(ts, TFrame, TE, {"device": "cpu"}, runs=3)
    got = ts.cache_report()["pipeline"]
    want = js.cache_report()["pipeline"]
    for doc in (got, want):
        doc.pop("kind")
    got["entries"].sort(key=lambda e: e["key"])
    want["entries"].sort(key=lambda e: e["key"])
    assert got == want
    # the families this slice ports; the JAX package's other layers (its
    # grouped engine, solvers, ingest) add their own counters
    families = ("pipeline.", "frame.", "stats.", "span_ms.", "trace.")
    mine = {k for k in ts.metrics() if k.startswith(families)}
    theirs = {k for k in js.metrics() if k.startswith(families)}
    assert mine == theirs
    assert {"pipeline.flush", "pipeline.compile", "pipeline.hit",
            "span_ms.sql", "span_ms.frame"} <= mine


def test_chrome_trace_is_well_formed(both, tmp_path):
    _, ts = both
    _run_app_queries(ts, TFrame, TE, {"device": "cpu"})
    path = ts.dump_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"]["dropped_spans"] == 0
    xs = [e for e in events if e["ph"] == "X"]
    ids = {e["args"]["span_id"] for e in xs}
    assert {"sql.query", "frame.filter", "frame.select",
            "frame.pipeline.flush"} <= {e["name"] for e in xs}
    for e in xs:
        assert e["dur"] >= 1 and isinstance(e["ts"], int)
        assert e["cat"] and isinstance(e["tid"], int)
        parent = e["args"].get("parent_id")
        assert parent is None or parent in ids
        json.dumps(e)
    for e in (e for e in events if e["ph"] == "C"):
        assert e["cat"] == "resource" and "value" in e["args"]


def test_trace_report_and_prometheus(both):
    _, ts = both
    _run_app_queries(ts, TFrame, TE, {"device": "cpu"}, runs=1)
    report = ts.trace_report()
    lines = report.splitlines()
    assert any(line.startswith("sql.query [sql]") for line in lines)
    assert any(line.startswith("    frame.pipeline.flush [frame]")
               for line in lines)
    text = ts.metrics_text()
    assert "# TYPE sparkdq4ml_pipeline_flush counter" in text
    assert "# HELP sparkdq4ml_pipeline_flush pipeline.flush - " \
           "pending-pipeline materializations" in text
    assert 'sparkdq4ml_span_ms_sql_bucket{le="+Inf"}' in text
    assert text.endswith("\n")


def test_prometheus_text_matches_jax_format():
    for o, cnt in ((obs, counters), (jax_obs, jax_counters)):
        cnt.clear()
        o.METRICS.clear()
        cnt.increment("pipeline.hit", 3)
        cnt.increment("recovery.retry.site", 1)
        o.METRICS.set_gauge("mesh.devices", 1)
        o.METRICS.observe("span_ms.frame", 0.7)
        o.METRICS.observe("span_ms.frame", 12.0)
    assert obs.prometheus_text() == jax_obs.prometheus_text()
    assert obs.metrics_snapshot() == jax_obs.metrics_snapshot()
    counters.clear()
    jax_counters.clear()
    obs.METRICS.clear()
    jax_obs.METRICS.clear()


def test_histogram_matches():
    got, want = obs.Histogram("h"), jax_obs.Histogram("h")
    for v in (0.05, 0.1, 3.0, 99.0, 1e9):
        got.observe(v)
        want.observe(v)
    assert got.snapshot() == want.snapshot()


def test_disabled_mode_is_a_no_op():
    obs.disable()
    assert obs.span("x") is obs._NOOP
    assert obs.current_span() is obs._NOOP
    assert obs.current_ids() == (None, None)
    obs.emit_span("y", dur_ms=1.0)
    with obs.span("x") as s:
        s.set(a=1)
    assert obs.TRACER.spans() == []


def test_nesting_begin_end_and_emit():
    obs.reset()
    obs.enable()
    try:
        root = obs.TRACER.begin("session", cat="session")
        with obs.span("a", cat="t") as a:
            assert obs.current_span() is a
            assert obs.current_ids() == (root.sid, a.sid)
            with obs.span("b") as b:
                b.set(k=1)
        obs.emit_span("late", dur_ms=2.0)
        obs.TRACER.end(root)
        by = {s.name: s for s in obs.TRACER.spans()}
        assert by["a"].parent_id == root.sid
        assert by["b"].parent_id == by["a"].sid
        assert by["b"].attrs == {"k": 1}
        assert by["late"].dur_us == 2000
        assert by["a"].trace_id == root.sid
    finally:
        obs.reset()
        obs.disable()


def test_bounded_buffer_counts_drops():
    obs.reset()
    counters.clear("trace.")
    obs.enable(max_spans=3)
    try:
        for i in range(5):
            with obs.span(f"s{i}"):
                pass
        assert len(obs.TRACER.spans()) == 3
        assert counters.get("trace.dropped_spans") == 2
        assert "dropped=2 spans" in obs.trace_report()
    finally:
        obs.enable(max_spans=10_000)
        obs.reset()
        obs.disable()


def test_query_stats_scopes_spans_and_counters():
    obs.reset()
    obs.disable()
    with obs.query_stats() as qs:
        assert obs.enabled()
        counters.increment("frame.host_sync")
        with obs.span("frame.filter", cat="frame"):
            pass
    assert not obs.enabled()
    assert [s.name for s in qs.spans] == ["frame.filter"]
    assert qs.spans_named("frame.filter")
    assert qs.counter_delta() == {"frame.host_sync": 1}
    obs.reset()


def test_op_span_counts_host_syncs():
    obs.reset()
    obs.enable()
    try:
        f = TFrame({"a": np.arange(5.0)}, device="cpu")
        f.to_pydict()
        (s,) = [s for s in obs.TRACER.spans() if s.name == "frame.to_pydict"]
        assert s.cat == "action"
        assert s.attrs == {"rows_in": 5, "host_syncs": 1}
    finally:
        obs.reset()
        obs.disable()


def test_cache_registry_reports_and_surfaces_errors():
    reg = obs.CacheRegistry()
    reg.register("ok", lambda: {"size": 1})
    reg.register("bad", lambda: 1 / 0)
    reg.register_programs("ok", lambda: [obs.ProgramHandle("ok", "k", None)])
    reg.register_programs("bad", lambda: 1 / 0)
    assert reg.names() == ["bad", "ok"]
    rep = reg.report()
    assert rep["ok"] == {"size": 1} and "error" in rep["bad"]
    handles, errors = reg.programs()
    assert [h.program_key for h in handles] == ["k"]
    assert "ZeroDivisionError" in errors["bad"]
    reg.unregister("bad")
    assert reg.names() == ["ok"]


def test_pipeline_program_handles():
    compiler.clear_cache()
    f = TFrame({"a": np.arange(20.0)}, device="cpu")
    f.filter(TE.col("a") > 3.0).count()
    handles, errors = obs.CACHES.programs()
    mine = [h for h in handles if h.cache == "pipeline"]
    assert not errors.get("pipeline")
    assert len(mine) == 1
    h = mine[0]
    assert h.meta["expected_traces"] == 1
    assert h.meta["runtime_literals"] == 1
    assert h.meta["dedup_key"] == h.program_key
    kept, donated, b, lits = h.args
    assert b == 32 and lits == (3.0,)
    assert [v[0][2] for v in h.variants["bucket"]] == [64, 128]
    compiler.clear_cache()


def test_session_observability_conf():
    s = (TorchSession.builder().config("spark.torch.device", "cpu")
         .config("spark.observability.enabled", "true").get_or_create())
    try:
        assert obs.enabled()
        TFrame({"a": np.arange(3.0)}, device="cpu").cache()
        names = {sp.name for sp in obs.TRACER.spans()}
        assert {"session", "frame.cache"} <= names
    finally:
        s.stop()
        obs.disable()
    by = {sp.name: sp for sp in obs.TRACER.spans()}
    assert by["session"].dur_us is not None          # ended by stop()
    assert by["frame.cache"].parent_id == by["session"].sid
    obs.reset()
