"""The port's data-quality observatory (``sparkdq4ml_tpu_torch/utils/
dqprof.py`` and the ``dq_sketch`` kernel's plain version) against the JAX
package's (``sparkdq4ml_tpu/utils/dqprof.py``), on the CPU:

* sketches of the same seeded columns: count, nulls, min, max and the
  histogram exact, sum and sum of squares within 1e-6 relative (the JAX
  package sums in float32); rule tallies exact;
* the kernel's plan and order of adds, replayed in numpy
  (``chip_smoke.sketch_replay``), gives the plain version's sketch at
  every edge of its vector reads, for each dtype, for views off the
  16-byte grid, for 16 columns and 16 rules in one call;
* PSI within 1e-9, the profile algebra alike;
* the app's ``dq_report()`` documents and EXPLAIN ANALYZE's
  ``== Data Quality ==`` text equal, timings stripped;
* statstore snapshots with profiles load across packages both ways;
* a profiled flush makes no host read, and with the profile off no hook
  runs.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.utils import dqprof as jdq
from sparkdq4ml_tpu.utils import statstore as jstats
from sparkdq4ml_tpu_torch.config import config
from sparkdq4ml_tpu_torch.ops import compiler, kernels
from sparkdq4ml_tpu_torch.utils import dqprof as tdq
from sparkdq4ml_tpu_torch.utils import statstore as tstats
from sparkdq4ml_tpu_torch.utils.profiling import counters

EXACT = (0, 1, 4, 5)        # count, nulls, min, max
SUMS = (2, 3)               # sum, sumsq
DTYPES = ("float32", "float64", "int32", "int64", "bool")  # read as they are


def _column(n: int, dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        col = rng.random(n) < 0.3
    elif dtype in ("int32", "int64"):
        col = rng.integers(-50, 400, n).astype(dtype)
    else:
        col = rng.lognormal(4.0, 1.5, n) * np.where(rng.random(n) < 0.2,
                                                    -1.0, 1.0)
        col[rng.random(n) < 0.1] = np.nan
        col[rng.random(n) < 0.02] = 0.0
        col = col.astype(dtype)
    mask = rng.random(n) < 0.8
    return col, mask


def _jax_sketch(col, mask, bins: int):
    """The JAX body over the flush's padded bucket, as the JAX package
    runs it."""
    n = col.shape[0]
    b = compiler.bucket_size(n)
    pad = np.zeros(b - n, col.dtype)
    c = np.concatenate([col, pad])
    m = np.concatenate([mask, np.zeros(b - n, bool)])
    return np.asarray(jdq._sketch_body(bins)(jnp.asarray(c),
                                             jnp.asarray(m)), np.float64), b


def _check_sketch(got, want):
    assert got.shape == want.shape
    for i in EXACT:
        assert got[i] == want[i], i
    for i in SUMS:
        assert got[i] == pytest.approx(want[i], rel=1e-6, abs=1e-30)
    np.testing.assert_array_equal(got[tdq.MOMENTS:], want[tdq.MOMENTS:])


@pytest.mark.parametrize("n", (1, 7, 40, 1040, 5000, 20_000, 200_003))
@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_equals_the_jax_body(n, dtype):
    col, mask = _column(n, dtype, seed=n)
    bins = 32
    want, b = _jax_sketch(col, mask, bins)
    got = kernels.dq_sketch([torch.as_tensor(col)], torch.as_tensor(mask),
                            bins=bins, step=tdq.hist_step(b))
    _check_sketch(got.numpy(), want)


@pytest.mark.parametrize("bins", (1, 8, 32, 100))
def test_rule_tallies_and_bins_equal_the_jax_bodies(bins):
    col, mask = _column(3000, "float32", seed=bins)
    rule, _ = _column(3000, "float64", seed=bins + 1)
    mask_in = np.random.default_rng(bins).random(3000) < 0.9
    want, b = _jax_sketch(col, mask, bins)
    pad = compiler.bucket_size(3000) - 3000
    rj = np.asarray(jdq._rule_body()(
        jnp.asarray(np.concatenate([rule, np.zeros(pad)])),
        jnp.asarray(np.concatenate([mask_in, np.zeros(pad, bool)]))))
    got = kernels.dq_sketch([torch.as_tensor(col)], torch.as_tensor(mask),
                            [torch.as_tensor(rule)],
                            torch.as_tensor(mask_in), bins=bins,
                            step=tdq.hist_step(b)).numpy()
    _check_sketch(got[:-2], want)
    np.testing.assert_array_equal(got[-2:], rj)
    every = kernels.dq_sketch([], None, [torch.as_tensor(rule)], None,
                              bins=bins).numpy()
    assert every.tolist() == [3000, float((rule > 0).sum())]


def _replayed(cols, mask, bins: int, step: int, rules=(),
              mask_in=None) -> np.ndarray:
    """csrc/dq_sketch.cu's plan in numpy (``chip_smoke.sketch_replay``):
    ``sketch_plan``'s blocks over ranges of a multiple of 16 rows, each
    thread's chunks of four rows in order, the lanes and warps in a fixed
    order, the last block adding the block tallies in block order."""
    import chip_smoke as smoke

    return smoke.sketch_replay(cols, mask, rules, mask_in, bins, step)


def _check_replayed(got, want, ncols: int, bins: int) -> None:
    """The replay against the plain version: count, nulls, min, max, the
    histogram and the rule tallies exact, the sums within 1e-12 (another
    order of float64 adds)."""
    stride = tdq.MOMENTS + bins
    assert got.shape == want.shape
    for c in range(ncols):
        g, w = got[c * stride:(c + 1) * stride], want[c * stride:
                                                      (c + 1) * stride]
        for i in EXACT:
            assert g[i] == w[i], (c, i)
        for i in SUMS:
            assert g[i] == pytest.approx(w[i], rel=1e-12, abs=1e-300)
        np.testing.assert_array_equal(g[tdq.MOMENTS:], w[tdq.MOMENTS:])
    np.testing.assert_array_equal(got[ncols * stride:], want[ncols * stride:])


@pytest.mark.parametrize("n,step", ((1, 1), (16_383, 4), (16_384, 1),
                                    (16_385, 5), (300_001, 74),
                                    (1_000_003, 245), (2_097_152, 512)))
def test_the_kernels_partition_gives_the_plain_sketch(n, step):
    """At n around the vector width (a tail of 3 and 1 rows past whole
    chunks), one block, a few, and the 16-row grain's last block."""
    cols = [_column(n, dt, seed=3)[0] for dt in ("float32", "int32")]
    mask = _column(n, "bool", seed=4)[1]
    blocks, rows = kernels.sketch_plan(n)
    assert rows % kernels.SKETCH_GRAIN == 0
    assert (blocks - 1) * rows < max(n, 1) <= blocks * rows
    got = _replayed(cols, mask, 32, step)
    want = kernels.dq_sketch([torch.as_tensor(c) for c in cols],
                             torch.as_tensor(mask), bins=32,
                             step=step).numpy()
    _check_replayed(got, want, 2, 32)


@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("dtype", DTYPES)
def test_each_dtype_and_view_gives_the_replayed_sketch(dtype, offset):
    """A column and a rule of each dtype the kernel reads as it is, as
    contiguous tensors and as views at an offset of one element (a
    pointer off the 16-byte grid, where the kernel reads row by row in
    the same order), against the replay and the JAX bodies."""
    n, bins = 16_385, 32
    col, mask = _column(n + offset, dtype, seed=17)
    mask_in = np.random.default_rng(18).random(n + offset) < 0.9
    tc, tm, ti = (torch.as_tensor(a)[offset:]
                  for a in (col, mask, mask_in))
    assert tc.storage_offset() == offset
    col, mask, mask_in = col[offset:], mask[offset:], mask_in[offset:]
    want_j, b = _jax_sketch(col, mask, bins)
    step = tdq.hist_step(b)
    got = kernels.dq_sketch([tc], tm, [tc], ti, bins=bins, step=step).numpy()
    _check_replayed(_replayed([col], mask, bins, step, [col], mask_in),
                    got, 1, bins)
    _check_sketch(got[:-2], want_j)
    pad = b - n
    rule_j = np.asarray(jdq._rule_body()(
        jnp.asarray(np.concatenate([col.astype(np.float32),
                                    np.zeros(pad, np.float32)])),
        jnp.asarray(np.concatenate([mask_in, np.zeros(pad, bool)]))))
    np.testing.assert_array_equal(got[-2:], rule_j)


@pytest.mark.parametrize("masked", (True, False))
def test_sixteen_columns_and_sixteen_rules_in_one_call(masked):
    """The most groups a launch takes: each column's slice equals its own
    call, the rules' tallies count mask_in rows, or every row without
    one (record_eval's shape), and the whole equals the replay."""
    n, bins, step = 40_003, 16, 3
    cols = [_column(n, DTYPES[c % 5], seed=30 + c)[0]
            for c in range(kernels.SKETCH_MAX_COLS)]
    rules = [_column(n, DTYPES[(r + 2) % 5], seed=60 + r)[0]
             for r in range(kernels.SKETCH_MAX_COLS)]
    mask = _column(n, "bool", seed=90)[1]
    mask_in = (np.random.default_rng(91).random(n) < 0.7) if masked \
        else None
    got = kernels.dq_sketch(
        [torch.as_tensor(c) for c in cols], torch.as_tensor(mask),
        [torch.as_tensor(r) for r in rules],
        None if mask_in is None else torch.as_tensor(mask_in),
        bins=bins, step=step).numpy()
    assert got.shape == (kernels.sketch_size(16, 16, bins),)
    _check_replayed(_replayed(cols, mask, bins, step, rules, mask_in), got,
                    16, bins)
    stride = tdq.MOMENTS + bins
    for c, col in enumerate(cols):
        one = kernels.dq_sketch([torch.as_tensor(col)],
                                torch.as_tensor(mask), bins=bins,
                                step=step).numpy()
        np.testing.assert_array_equal(got[c * stride:(c + 1) * stride], one)
    tallies = got[16 * stride:].reshape(16, 2)
    for r, rule in enumerate(rules):
        pos = rule.astype(np.float32) > 0
        rows = n if mask_in is None else int(mask_in.sum())
        passed = pos.sum() if mask_in is None else (pos & mask_in).sum()
        assert tallies[r].tolist() == [rows, passed]


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.ones(4)
    m = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError):
        kernels.dq_sketch([x] * 17, m)
    with pytest.raises(ValueError):
        kernels.dq_sketch([x], m, bins=0)
    with pytest.raises(ValueError):
        kernels.dq_sketch([x, torch.ones(5)], m)
    with pytest.raises(ValueError):
        kernels.dq_sketch([x], torch.ones(4))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kernels.dq_sketch([x.to("meta")], m.to("meta"))


# ---------------------------------------------------------------------------
# The profile algebra
# ---------------------------------------------------------------------------

def _profiles(mod, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        raw = np.concatenate([[rng.integers(5, 90), rng.integers(0, 4),
                               rng.normal(500, 50), rng.normal(9e4, 1e3),
                               rng.normal(-3, 1), rng.normal(40, 1)],
                              rng.integers(0, 50, 16)])
        out.append(mod.ColumnProfile.from_raw(raw))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_profiles_merge_and_score_alike(seed):
    got, want = _profiles(tdq, seed), _profiles(jdq, seed)
    for g, w in zip(got, want):
        assert g.to_doc() == w.to_doc()
    for a, b in ((got, want),):
        a[0].merge(a[1])
        b[0].merge(b[1])
        assert a[0].to_doc() == b[0].to_doc()
    psi = tdq.drift_score(got[0], got[2])
    assert psi == pytest.approx(jdq.drift_score(want[0], want[2]),
                                abs=1e-9)
    assert tdq.histogram_edges(16) == jdq.histogram_edges(16)
    doc = got[0].to_doc()
    assert tdq.ColumnProfile.from_doc(doc).to_doc() == doc
    assert tdq.ColumnProfile.from_doc({**doc, "version": 0}) is None


# ---------------------------------------------------------------------------
# The app: reports, EXPLAIN, snapshots, drift
# ---------------------------------------------------------------------------

HEADLINE_RULE_SQL = (
    "SELECT guest, priceCorrelationRule(price, guest) AS pcc "
    "FROM price WHERE priceCorrelationRule(price, guest) > 0")


def _fresh():
    from sparkdq4ml_tpu.ops import compiler as jcompiler
    from sparkdq4ml_tpu.utils import observability as jobs
    from sparkdq4ml_tpu_torch.utils import observability as tobs

    for mod in (tdq, jdq):
        mod.clear()
    for c in (compiler, jcompiler):
        c.clear_cache()
    tstats.STORE.clear()
    jstats.STORE.clear()
    tobs.METRICS.clear()
    jobs.METRICS.clear()


@pytest.fixture
def sessions():
    """A port session on the CPU and a JAX one, both observatories on and
    fresh, both float32 (x64 off)."""
    import sparkdq4ml_tpu as jdq_pkg
    import sparkdq4ml_tpu_torch as tdq_pkg

    saved = (config.dq_profile_enabled, jax_config.dq_profile_enabled,
             jax_config.audit_enabled)
    config.dq_profile_enabled = jax_config.dq_profile_enabled = True
    jax_config.audit_enabled = False
    _fresh()
    t = tdq_pkg.TorchSession.builder().config("spark.torch.device",
                                              "cpu").get_or_create()
    j = jdq_pkg.TpuSession.builder().get_or_create()
    try:
        yield (tdq_pkg, t), (jdq_pkg, j)
    finally:
        t.stop()
        j.stop()
        (config.dq_profile_enabled, jax_config.dq_profile_enabled,
         jax_config.audit_enabled) = saved
        _fresh()


def _dq_phase(pkg, spark, guest, price):
    import chip_smoke as smoke

    spark.udf.register("minimumPriceRule", pkg.minimum_price_rule, "double")
    spark.udf.register("priceCorrelationRule", pkg.price_correlation_rule,
                       "double")
    df = spark.createDataFrame({"guest": guest, "price": price})
    d = df.with_column("price_no_min",
                       pkg.call_udf("minimumPriceRule", df.col("price")))
    d.create_or_replace_temp_view("price")
    d = spark.sql(smoke.RULE_1_SQL)
    d = d.with_column("price_correct_correl",
                      pkg.call_udf("priceCorrelationRule", d.col("price"),
                                   d.col("guest")))
    d.create_or_replace_temp_view("price")
    clean = spark.sql(smoke.RULE_2_SQL)
    clean = clean.with_column("label", clean.col("price"))
    clean = clean.with_column("price", clean.col("price") * 1.0)
    clean.count()
    return clean


def _same_docs(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and not isinstance(g, bool):
            assert g == pytest.approx(w, rel=1e-6), k
        elif isinstance(w, list) and w and isinstance(w[0], dict):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                _same_docs(a, b)
        else:
            assert g == w, k


_MEAN = re.compile(r"mean=(-?[0-9.]+)")


def assert_same_section(got: list, want: list) -> None:
    """Two ``== Data Quality ==`` sections line for line; a column's mean,
    printed to 4 decimals, within the printed digit (the JAX package's
    float32 sums round it either way)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _MEAN.sub("mean=#", g) == _MEAN.sub("mean=#", w)
        gm, wm = _MEAN.search(g), _MEAN.search(w)
        if wm:
            assert float(gm.group(1)) == pytest.approx(
                float(wm.group(1)), abs=1.01e-4)


def _table(n: int = 2000, seed: int = 2, scale: float = 1.0):
    import chip_smoke as smoke

    guest, price = smoke.full_table(n, seed=seed)
    return guest, np.round(price * scale, 2)


def test_dq_reports_are_equal(sessions):
    (tp, t), (jp, j) = sessions
    guest, price = _table()
    _dq_phase(tp, t, guest, price)
    _dq_phase(jp, j, guest, price)
    syncs = counters.get("dq.drain_sync")
    got, want = t.dq_report(), j.dq_report()
    assert counters.get("dq.drain_sync") == syncs + 1
    _same_docs(got, want)
    assert [c["column"] for c in got["columns"]] == ["label", "price"]
    rules = {r["rule"]: r for r in got["rules"]}
    assert rules["minimumPriceRule"]["rows"] == 2000
    assert t.dq_report(top=1)["columns"] == got["columns"][:1]


def test_explain_sections_are_equal(sessions):
    (tp, t), (jp, j) = sessions
    guest, price = _table()
    for pkg, spark in sessions:
        _dq_phase(pkg, spark, guest, price)
    plans = [spark.sql("EXPLAIN ANALYZE " + HEADLINE_RULE_SQL).to_pydict()[
        "plan"][0] for _, spark in sessions]
    sections = [p.splitlines()[p.splitlines().index("== Data Quality =="):]
                for p in plans]
    assert_same_section(sections[0], sections[1])
    assert sections[0][1].startswith("rule minimumPriceRule: evals=1")
    free = t.sql("EXPLAIN ANALYZE SELECT guest FROM price WHERE guest > 3") \
        .to_pydict()["plan"][0]
    assert "== Data Quality ==" not in free


def test_drift_scores_are_equal(sessions):
    """A baseline batch, then a batch with its price scaled by 3: PSI past
    the threshold and the gauge set in both; an unshifted batch stays
    under it."""
    from sparkdq4ml_tpu.utils import observability as jobs
    from sparkdq4ml_tpu_torch.utils import observability as tobs

    scores = {}
    for scale in (1.0, 3.0):
        for (pkg, spark), mod in zip(sessions, (tdq, jdq)):
            mod.clear()
            _dq_phase(pkg, spark, *_table(seed=2))
            mod.report()
            _dq_phase(pkg, spark, *_table(seed=5, scale=scale))
            scores[(mod.__name__, scale)] = mod.report()
    for scale in (1.0, 3.0):
        got = {c["column"]: c["drift"]
               for c in scores[(tdq.__name__, scale)]["columns"]}
        want = {c["column"]: c["drift"]
                for c in scores[(jdq.__name__, scale)]["columns"]}
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == pytest.approx(want[k], abs=1e-9)
        assert (got["price"] > 0.25) == (scale == 3.0)
    assert tobs.METRICS.get_gauge("dq.drift.price") == pytest.approx(
        jobs.METRICS.get_gauge("dq.drift.price"), abs=1e-9)


def test_snapshots_with_profiles_load_both_ways(sessions, tmp_path):
    (tp, t), (jp, j) = sessions
    guest, price = _table()
    for pkg, spark in sessions:
        _dq_phase(pkg, spark, guest, price)
    t.dq_report()
    j.dq_report()
    for src, dst, name in ((tstats, jstats, "t"), (jstats, tstats, "j")):
        path = str(tmp_path / f"{name}.jsonl")
        assert src.STORE.save(path, merge=False)
        want = src.STORE.profile("dqprof|price")
        assert want is not None and want["count"] > 0
        dst.STORE.clear()
        assert dst.STORE.load(path) > 0
        assert dst.STORE.profile("dqprof|price") == want


def test_a_profiled_flush_makes_no_host_read(sessions):
    (tp, t), _ = sessions
    guest, price = _table()
    clean = _dq_phase(tp, t, guest, price)
    syncs = counters.get("frame.host_sync")
    drains = counters.get("dq.drain_sync")
    sketches = counters.get("dq.sketches")
    f = clean.with_column("twice", clean.col("price") * 2.0)
    f._data
    assert counters.get("frame.host_sync") == syncs
    assert counters.get("dq.drain_sync") == drains
    assert counters.get("dq.sketches") == sketches + 1
    assert len(tdq._PENDING) > 0


def test_the_pending_queue_is_bounded(monkeypatch):
    tdq.clear()
    monkeypatch.setattr(tdq, "MAX_PENDING", 3)
    dropped = counters.get("dq.pending_dropped")
    for i in range(5):
        tdq._enqueue([("rule", "r", 1, torch.tensor([1.0, 1.0]))])
    assert len(tdq._PENDING) == 3
    assert counters.get("dq.pending_dropped") == dropped + 2
    tdq.clear()


def test_with_the_profile_off_no_hook_runs(sessions, monkeypatch):
    (tp, t), _ = sessions

    def boom(*a, **k):
        raise AssertionError("a dq hook ran with the profile off")

    for name in ("observe_flush", "record_eval", "rule_marks",
                 "explain_lines", "drain"):
        monkeypatch.setattr(tdq, name, boom)
    monkeypatch.setattr(kernels, "dq_sketch", boom)
    config.dq_profile_enabled = False
    guest, price = _table()
    _dq_phase(tp, t, guest, price)
    plan = t.sql("EXPLAIN ANALYZE " + HEADLINE_RULE_SQL).to_pydict()[
        "plan"][0]
    assert "== Data Quality ==" not in plan
    assert t.dq_report() == {"enabled": False, "columns": [], "rules": [],
                             "size": 0, "pending": 0}


def test_a_sketch_fault_leaves_the_flush_unprofiled(sessions):
    from sparkdq4ml_tpu_torch.utils import faults
    from sparkdq4ml_tpu_torch.utils.recovery import RECOVERY_LOG

    (tp, t), _ = sessions
    RECOVERY_LOG.clear()
    guest, price = _table()
    with faults.inject_faults("dq_profile:device_error:1"):
        clean = _dq_phase(tp, t, guest, price)
    assert [(e.site, e.action, e.rung) for e in RECOVERY_LOG.events()] == [
        ("dq_profile", "fallback", "unprofiled")]
    assert clean.count() > 0
    assert t.dq_report()["size"] >= 1
    RECOVERY_LOG.clear()


@pytest.mark.parametrize("name, value", [
    ("MAX_COLS", 8), ("MAX_BINS", 512), ("MOMENTS", 7), ("BIG", "1e+30f"),
    ("TMAX", "10.0f"), ("GRAIN", 8), ("TALLY_BYTES", 48), ("THREADS", 256),
    ("F32", 5), ("F64", 5), ("I32", 5), ("I64", 5), ("B8", 5),
])
def test_the_sketch_contract_reaches_the_kernel_through_the_flags(
        monkeypatch, name, value):
    """csrc/dq_sketch.cu takes each constant it shares with ops/kernels.py
    (the SketchPlan layout, the moment slots, the clip, the plan's grain,
    tally size and threads, the dtype codes)
    from the nvcc flags, refuses to build without it, and has no default
    of its own; a changed value changes the build key."""
    src = (kernels.CSRC / "dq_sketch.cu").read_text()
    macro = f"DQ_SKETCH_{name}"
    flags = [f for f in kernels.NVCC_FLAGS if f.startswith(f"-D{macro}=")]
    assert len(flags) == 1
    assert f'#ifndef {macro}\n#error "build with -D{macro} ' in src
    assert f"#define {macro}" not in src
    key = kernels.build_key("dq_sketch")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", tuple(
        f"-D{macro}={value}" if f == flags[0] else f
        for f in kernels.NVCC_FLAGS))
    assert kernels.build_key("dq_sketch") != key


def test_the_sketch_flags_carry_the_python_constants():
    """The flags hold the values the wrapper, the plan and the plain
    version use, and the ctypes SketchPlan is laid out for the same column
    count; the scratch's counters leave the segment sums' tickets alone
    and the tallies on the 16-byte grid."""
    flags = set(kernels.NVCC_FLAGS)
    assert {f"-DDQ_SKETCH_MAX_COLS={kernels.SKETCH_MAX_COLS}",
            f"-DDQ_SKETCH_MAX_BINS={kernels.SKETCH_MAX_BINS}",
            f"-DDQ_SKETCH_MOMENTS={kernels.SKETCH_MOMENTS}",
            f"-DDQ_SKETCH_BIG={kernels.SKETCH_BIG!r}f",
            f"-DDQ_SKETCH_TMAX={kernels.SKETCH_TMAX!r}f",
            f"-DDQ_SKETCH_GRAIN={kernels.SKETCH_GRAIN}",
            f"-DDQ_SKETCH_TALLY_BYTES={kernels.SKETCH_TALLY_BYTES}",
            f"-DDQ_SKETCH_THREADS={kernels.SKETCH_THREADS}"} <= flags
    for name, dtype in kernels._SKETCH_TYPES:
        assert f"-DDQ_SKETCH_{name}={kernels._SKETCH_DTYPES[dtype]}" in flags
    fields = dict(kernels._SketchPlan._fields_)
    assert fields["dtypes"]._length_ == 2 * kernels.SKETCH_MAX_COLS
    assert kernels._SKETCH_TICKET_OFFSET >= 4 * kernels.SEGSUM_TICKETS
    assert kernels._SKETCH_HIST_OFFSET >= kernels._SKETCH_TICKET_OFFSET + 4
    assert kernels._TICKET_BYTES >= kernels._SKETCH_HIST_OFFSET + 4 * (
        kernels.SKETCH_MAX_COLS * kernels.SKETCH_MAX_BINS)
    assert kernels._TICKET_BYTES % 16 == 0


@pytest.mark.parametrize("error, degrades", [
    (RuntimeError("kernel build failed"), False),
    (RuntimeError("dq_sketch kernel launch failed: CUDA error 700"), False),
    (ValueError("dq_sketch: bad arguments"), False),
    (torch.AcceleratorError("CUDA error: an illegal memory access"), True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
])
def test_only_a_device_fault_leaves_a_sketch_unprofiled(sessions,
                                                        monkeypatch, error,
                                                        degrades):
    """A kernel that fails to build or launch, or a bad argument, raises
    out of both hooks and out of the flush (never an eager replay); a
    device fault leaves the flush or the evaluation unprofiled with a
    recovery event and ``dq.profile_failed``."""
    from sparkdq4ml_tpu_torch.utils.recovery import RECOVERY_LOG

    (tp, t), _ = sessions

    def fail(*a, **k):
        raise error

    monkeypatch.setattr(kernels, "dq_sketch", fail)
    RECOVERY_LOG.clear()
    col = torch.arange(8, dtype=torch.float32)
    hooks = (lambda: tdq.observe_flush({"x": col},
                                       torch.ones(8, dtype=torch.bool), 8,
                                       8),
             lambda: tdq.record_eval("minimumPriceRule", col))
    guest, price = _table(200)
    fallbacks = counters.get("pipeline.fallback")
    failed = counters.get("dq.profile_failed")
    if degrades:
        for hook in hooks:
            hook()
        _dq_phase(tp, t, guest, price)
        events = RECOVERY_LOG.events()
        assert len(events) >= 3 and all(
            (e.site, e.action, e.rung) == ("dq_profile", "fallback",
                                           "unprofiled") for e in events)
        assert counters.get("dq.profile_failed") - failed == len(events)
        assert tdq.report()["size"] == 0
    else:
        for hook in hooks + (lambda: _dq_phase(tp, t, guest, price),):
            with pytest.raises(type(error)) as got:
                hook()
            assert got.value is error
        assert RECOVERY_LOG.events() == []
        assert counters.get("dq.profile_failed") == failed
    assert counters.get("pipeline.fallback") == fallbacks
    RECOVERY_LOG.clear()
