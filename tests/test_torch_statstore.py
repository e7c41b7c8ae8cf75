"""The port's plan-statistics store (``sparkdq4ml_tpu_torch/utils/
statstore.py``) against the JAX package's (``sparkdq4ml_tpu/utils/
statstore.py``), on the CPU.

* after the same frame and SQL calls in both packages, ``report()``'s
  entries agree: keys, kinds, flush and compile counts, rows in and out,
  selectivity observations and selectivities (the time digests are not
  compared);
* a snapshot saved by either package loads into the other, entry for
  entry;
* ``Digest``, ``selectivity_key``, merge, trim, eviction and the version
  gate behave alike, and the deferred kept-row counts drain in one
  counted batched read.
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

PACKAGES = {"jax": jax_statstore, "torch": statstore}
COMPARED = ("key", "kind", "flushes", "compiles", "selectivity", "rows_in",
            "rows_out", "sel_observations", "host_syncs")


def _reset():
    for c, cnt, st in ((compiler, counters, statstore),
                       (jax_compiler, jax_counters, jax_statstore)):
        c.clear_cache()
        cnt.clear("pipeline.")
        cnt.clear("stats.")
        st.STORE.clear()


@pytest.fixture(params=["float64", "float32"])
def policy(request):
    name = request.param
    saved = (jax_config.default_float_dtype, jax_config.dq_profile_enabled)
    jax_config.default_float_dtype = getattr(jnp, name)
    jax_config.dq_profile_enabled = False
    _reset()
    try:
        with jax.enable_x64(name == "float64"), \
                float_policy(getattr(torch, name)):
            yield name
    finally:
        jax_config.default_float_dtype, jax_config.dq_profile_enabled = \
            saved
        _reset()


def _rows(report) -> list:
    return sorted(({k: e[k] for k in COMPARED} for e in report["entries"]),
                  key=lambda e: e["key"])


def _table(seed, n):
    rng = np.random.default_rng(seed)
    price = np.round(rng.uniform(-20.0, 120.0, n), 2)
    price[rng.random(n) < 0.05] = np.nan
    return {"guest": rng.integers(1, 40, n).astype(np.int32),
            "price": price}


def _queries(F, E, **kw):
    """A DQ-style sequence: filters at several thresholds and lengths,
    fused projections, a replaced column."""
    for seed, n, lo in ((0, 40, 0.0), (1, 600, 10.0), (2, 700, 10.0),
                        (3, 40, 50.0)):
        f = F(_table(seed, n), **kw)
        g = f.with_column("p2", E.col("price") * 2.0).filter(
            E.col("price") > lo)
        g.count()
        h = f.filter(E.col("guest") < 30).filter(E.col("price") > lo)
        h.select(E.col("guest").cast("int").alias("guest"),
                 (E.col("price") / 2).alias("half")).count()
        f.with_column("price", E.col("price") + 1.0).count()


def test_report_entries_equal_after_the_same_queries(policy):
    _queries(JFrame, JE)
    _queries(TFrame, TE, device="cpu")
    got, want = statstore.STORE.report(), jax_statstore.STORE.report()
    assert got["version"] == want["version"] == 1
    assert _rows(got) == _rows(want)
    kinds = {e["kind"] for e in got["entries"]}
    assert kinds == {"pipeline", "filter"}
    assert counters.get("stats.record") == jax_counters.get("stats.record")


def test_app_query_selectivities(policy, session):
    """The reference app's two WHERE clauses through SQL in both packages:
    their selectivity entries hold the kept rows over the row slots."""
    port = (TorchSession.builder().app_name("test")
            .config("spark.torch.device", "cpu").get_or_create())
    try:
        for sess, F, E, kw in ((session, JFrame, JE, {}),
                               (port, TFrame, TE, {"device": "cpu"})):
            for seed in (4, 5):
                f = F(_table(seed, 40), **kw).with_column(
                    "price_no_min", E.col("price") - 5.0)
                f.create_or_replace_temp_view("price")
                sess.sql("SELECT cast(guest as int) guest, price_no_min AS "
                         "price FROM price WHERE price_no_min > 0").count()
        got, want = port.stats_report(), jax_statstore.STORE.report()
        assert got["enabled"] is True
        assert _rows(got) == _rows(want)
        (sel,) = [e for e in got["entries"] if e["kind"] == "filter"]
        kept = sum(int(np.nansum(_table(s, 40)["price"] - 5.0 > 0))
                   for s in (4, 5))
        assert (sel["rows_in"], sel["rows_out"]) == (80, kept)
    finally:
        port.stop()
        default_catalog().clear()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_snapshot_crosses_packages(policy, tmp_path, writer, reader):
    _queries(JFrame, JE)
    _queries(TFrame, TE, device="cpu")
    path = str(tmp_path / "stats.jsonl")
    src, dst = PACKAGES[writer].STORE, PACKAGES[reader].STORE
    docs = {e["key"]: e for e in map(src.entry, (
        e["key"] for e in src.report()["entries"]))}
    assert src.save(path, merge=False)
    dst.clear()
    assert dst.load(path) == len(docs)
    for key, doc in docs.items():
        assert dst.entry(key) == doc
    # the plan keys of the reading package's own cache address them
    own = (compiler if reader == "torch" else jax_compiler).cache_stats()
    for e in own["entries"]:
        assert dst.entry(e["program_key"]) is not None


def test_save_merges_and_load_is_idempotent(tmp_path):
    path = str(tmp_path / "s.jsonl")
    for pkg in (statstore, jax_statstore):
        a = pkg.StatStore()
        a.record_flush("k1", "pipeline", wall_ms=1.0)
        a.record_rows("k2", "filter", 10, 4)
        assert a.save(path, merge=True)
        b = pkg.StatStore()
        b.record_flush("k3", "pipeline", compiled=True, wall_ms=7.0)
        assert b.save(path, merge=True)
        c = pkg.StatStore()
        assert c.load(path) == 3
        assert c.load(path) == 3
        assert len(c) == 3 and c.selectivity("k2") == 0.4
    with open(path) as f:
        assert json.loads(f.readline())["version"] == 1


def test_digest_matches(policy):
    values = [0.05, 0.3, 0.3, 2.0, 7.5, 40.0, 400.0, 20000.0]
    docs = []
    for pkg in (statstore, jax_statstore):
        d = pkg.Digest()
        for v in values:
            d.observe(v)
        other = pkg.Digest.from_doc(d.to_doc())
        d.merge(other)
        docs.append((d.to_doc(), d.mean(), d.p50(), d.p90(),
                     d.quantile(0.99)))
        with pytest.raises(ValueError):
            pkg.Digest.from_doc({"counts": [1, 2]})
    assert docs[0] == docs[1]


def test_selectivity_key_matches():
    keys = ["<f4/<i4|F:B(>,C('a':<f4),Li)|O('__sel_0')=C('a':<f4)",
            "<f8/<i4|W('x')=C('a':<f8)",
            "ns:'t1'|<f8/<i4|F:B(<,C('a':<f8),Lf)|F:U(isnull,C('b':<f8))",
            "shard[2]|<f8/<i4|F:B(>,C('a':<f8),Li)", "", "ns:'x'|"]
    for k in keys:
        assert statstore.selectivity_key(k) == \
            jax_statstore.selectivity_key(k)


def test_deferred_rows_drain_in_one_counted_read():
    s = statstore.StatStore()
    counters.clear("stats.")
    for i in range(5):
        s.defer_rows("f", "filter", 10, torch.tensor(i + 1))
    s.defer_rows("f", "filter", 10, 3)
    assert s.selectivity("f") is None
    s.drain_pending()
    assert counters.get("stats.drain_sync") == 1
    e = s.entry("f")
    assert (e["rows_in"], e["rows_out"], e["sel_observations"]) == \
        (60, 18, 6)


def test_pending_bound_drops_oldest(monkeypatch):
    monkeypatch.setattr(statstore, "MAX_PENDING", 3)
    s = statstore.StatStore()
    counters.clear("stats.")
    for i in range(5):
        s.defer_rows("f", "filter", 1, torch.tensor(1))
    assert counters.get("stats.pending_dropped") == 2
    s.drain_pending()
    assert s.entry("f")["sel_observations"] == 3


def test_max_entries_evicts_and_trims(tmp_path, monkeypatch):
    monkeypatch.setattr(config, "stats_max_entries", 3)
    monkeypatch.setattr(jax_config, "stats_max_entries", 3)
    for pkg in (statstore, jax_statstore):
        s = pkg.StatStore()
        for i in range(5):
            s.record_flush(f"k{i}", "pipeline")
        assert len(s) == 3
        assert s.entry("k0") is None and s.entry("k4") is not None


@pytest.mark.parametrize("content", ['{"version": 99}\n', "not json\n",
                                     '{"version": 1}\n{"key": \n'])
def test_bad_snapshot_degrades_to_empty(tmp_path, content):
    path = tmp_path / "bad.jsonl"
    path.write_text(content)
    counters.clear("stats.")
    s = statstore.StatStore()
    assert s.load(str(path)) == 0
    assert len(s) == 0
    assert counters.get("stats.load_failed") == 1
    assert statstore.StatStore().load(str(tmp_path / "missing")) == 0


def test_unwritable_path_degrades_to_memory(tmp_path):
    counters.clear("stats.")
    s = statstore.StatStore()
    s.record_flush("k", "pipeline")
    assert not s.save(str(tmp_path / "no" / "such" / "dir" / "s.jsonl"))
    assert counters.get("stats.persist_failed") == 1
    assert len(s) == 1


def test_cost_and_profile_survive_merges(tmp_path):
    path = str(tmp_path / "c.jsonl")
    a = statstore.StatStore()
    a.record_cost("k", "pipeline", {"flops": 10.0, "peak_bytes": 4096})
    a.record_profile("dqprof|price", "dqprof", {"version": 1})
    a.save(path, merge=False)
    b = statstore.StatStore()
    for _ in range(3):
        b.record_flush("k", "pipeline")
    b.save(path, merge=True)
    c = statstore.StatStore()
    c.load(path)
    assert c.cost("k") == {"flops": 10.0, "peak_bytes": 4096}
    assert c.entry("k")["flushes"] == 3
    assert c.bytes_bound("k") == 4096
    assert c.profile("dqprof|price") == {"version": 1}
    assert c.flops_for_selectivity(None) is None


def test_est_rows_and_misses():
    s = statstore.StatStore()
    s.record_rows("f", "filter", 100, 25)
    assert s.est_rows("f", 40) == 10
    assert s.est_rows("g", 40) is None
    s.record_miss("plan")
    s.record_miss("plan")
    assert s.miss_count("plan") == 2


def test_absorb_query_stats():
    from sparkdq4ml_tpu_torch.utils import observability as obs

    s = statstore.StatStore()
    with obs.query_stats() as qs:
        with obs.span("frame.filter", cat="frame"):
            pass
        with obs.span("sql.query", cat="sql"):
            pass
    s.absorb_query_stats(qs)
    assert s.entry("span:frame")["flushes"] == 1
    assert s.entry("span:sql")["wall_ms"]["count"] == 1


def test_disabled_stats_record_nothing(policy):
    saved = config.stats_enabled
    config.stats_enabled = False
    try:
        TFrame(_table(0, 40), device="cpu").filter(
            TE.col("price") > 0.0).count()
        assert len(statstore.STORE) == 0
        s = (TorchSession.builder().config("spark.torch.device", "cpu")
             .get_or_create())
        assert s.stats_report() == {"enabled": False, "entries": [],
                                    "size": 0}
        s.stop()
    finally:
        config.stats_enabled = saved


def test_session_loads_and_saves_the_snapshot(policy, tmp_path):
    path = str(tmp_path / "session.jsonl")
    seed = statstore.StatStore()
    seed.record_rows("<f8/<i4|F:B(>,C('x':<f8),Li)", "filter", 10, 5)
    seed.save(path, merge=False)
    s = (TorchSession.builder().config("spark.torch.device", "cpu")
         .config("spark.stats.path", path).get_or_create())
    try:
        assert config.stats_path == path
        assert statstore.STORE.selectivity(
            "<f8/<i4|F:B(>,C('x':<f8),Li)") == 0.5
        TFrame(_table(1, 40), device="cpu").filter(
            TE.col("price") > 0.0).count()
        assert s.stats_report()["path"] == path
    finally:
        s.stop()
    assert config.stats_path == ""
    again = statstore.StatStore()
    # the seed and the plan (a lone filter's plan key is its own
    # selectivity key: one entry holds both)
    assert again.load(path) == 2
    (key,) = [k for k in _keys_of(again) if "price" in k]
    assert again.entry(key)["flushes"] == 1
    assert again.entry(key)["sel_observations"] == 1


def _keys_of(store) -> list:
    return [e["key"] for e in store.report(drain=False)["entries"]]
