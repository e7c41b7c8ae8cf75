"""The port's recovery layer (``sparkdq4ml_tpu_torch/utils/recovery.py``)
and its ladders against the JAX package's, on the CPU:

* backoff seconds, breaker transitions, ``check_finite`` and the events of
  scripted ``resilient_call`` ladders are equal;
* the reference app under each of ``chip_smoke.CHAOS_SCHEDULES`` on
  dataset-abstract leaves the JAX package's recovery events (and
  ``chip_smoke.CHAOS_GOLDEN``'s) and the golden results; the 10^7-row
  schedules, at a small table, leave the JAX events and the clean run's
  bits;
* ``fit_or_resume`` under a mid-fit preemption resumes to the
  uninterrupted fit bit for bit;
* the ingest ladder reads the same columns under each native fault, the
  statstore's snapshot survives a torn write;
* with no fault plan a clean run never reaches the machinery.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from chaos_goldens import jax_chaos_run, jax_run
from test_torch_dqprof import assert_same_section
from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.utils import faults as jfaults
from sparkdq4ml_tpu.utils import recovery as jrec
from sparkdq4ml_tpu_torch.config import config
from sparkdq4ml_tpu_torch.utils import faults as tfaults
from sparkdq4ml_tpu_torch.utils import recovery as trec

ON_CPU = (("spark.torch.device", "cpu"),)
ABSTRACT = os.path.join(smoke.ROOT, "data", "dataset-abstract.csv")


@pytest.fixture(autouse=True)
def clean_logs():
    for rec, faults in ((jrec, jfaults), (trec, tfaults)):
        rec.RECOVERY_LOG.clear()
        rec.DEVICE_BREAKER.reset()
        faults.clear()
    yield
    for rec, faults in ((jrec, jfaults), (trec, tfaults)):
        rec.RECOVERY_LOG.clear()
        rec.DEVICE_BREAKER.reset()
        faults.clear()


def _events(rec) -> list:
    return [(e.site, e.action, e.rung, e.attempt, round(e.backoff_s, 12))
            for e in rec.RECOVERY_LOG.events()]


CONFS = (
    {},
    {"spark.recovery.maxAttempts": "5", "spark.recovery.seed": "9"},
    {"spark.recovery.backoffBase": "0.2", "spark.recovery.jitter": "0.5",
     "spark.recovery.backoffFactor": "3", "spark.recovery.backoffMax": "1"},
    {"spark.recovery.fit_packed.maxAttempts": "4",
     "spark.recovery.fit_packed.seed": "3", "spark.recovery.jitter": "0"},
)


@pytest.mark.parametrize("conf", CONFS)
def test_backoff_seconds_are_equal(conf):
    for site in ("", "fit_packed", "pipeline_flush"):
        prefix = f"spark.recovery.{site}." if site else "spark.recovery."
        a = trec.RetryPolicy.from_conf(conf, prefix=prefix)
        b = jrec.RetryPolicy.from_conf(conf, prefix=prefix)
        for attempt in range(1, 8):
            assert a.backoff(attempt, site) == b.backoff(attempt, site)


def _ladder(rec, fail_on, nan_on, rungs: int, err):
    """A scripted ladder: attempt k of the whole call fails with ``err``
    when k is in ``fail_on``, returns NaN when in ``nan_on``."""
    calls = [0]

    def step():
        calls[0] += 1
        if calls[0] in fail_on:
            raise err(f"scripted fault {calls[0]}")
        return np.array([np.nan if calls[0] in nan_on else 1.0])

    policy = rec.RetryPolicy(max_attempts=3, seed=4, sleep=lambda s: None)
    fallbacks = [(f"rung{i}", step) for i in range(1, rungs)]
    try:
        out = rec.resilient_call(step, site="fit_packed", policy=policy,
                                 validate=rec.check_finite,
                                 fallbacks=fallbacks,
                                 breaker=rec.CircuitBreaker())
        result = float(out[0])
    except rec.FitFailure as e:
        result = type(e.__cause__).__name__ if e.__cause__ else "nan"
    return result, _events(rec)


@pytest.mark.parametrize("fail_on,nan_on,rungs", [
    ((), (), 1), ((1,), (), 1), ((1, 2), (3,), 2), ((1, 2, 3), (), 2),
    ((1, 2, 3, 4, 5, 6), (), 2), ((), (1, 2, 3, 4), 3),
    ((2, 4, 6), (1, 3), 3)])
def test_scripted_ladders_leave_the_same_events(fail_on, nan_on, rungs):
    port = _ladder(trec, fail_on, nan_on, rungs,
                   tfaults.InjectedDeviceError)
    jaxs = _ladder(jrec, fail_on, nan_on, rungs,
                   jfaults.injected_device_error_class())
    assert port == jaxs


def test_a_real_card_error_is_retried_and_a_build_error_is_not():
    policy = trec.RetryPolicy(max_attempts=3, sleep=lambda s: None)

    def oom():
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(trec.FitFailure) as info:
        trec.resilient_call(oom, site="serve_exec", policy=policy)
    assert isinstance(info.value.__cause__, torch.OutOfMemoryError)
    assert [e.action for e in trec.RECOVERY_LOG.events()] == [
        "retry", "retry", "exhausted"]
    trec.RECOVERY_LOG.clear()

    def build():
        raise RuntimeError("kernel build failed")

    with pytest.raises(RuntimeError, match="kernel build failed"):
        trec.resilient_call(build, site="serve_exec", policy=policy)
    assert len(trec.RECOVERY_LOG) == 0


def test_a_deadline_is_retried():
    import time

    calls = []

    def slow():
        calls.append(1)
        if len(calls) == 1:
            time.sleep(0.5)
        return 3

    policy = trec.RetryPolicy(max_attempts=2, attempt_deadline=0.1,
                              sleep=lambda s: None)
    assert trec.resilient_call(slow, site="call", policy=policy) == 3
    assert [(e.action, e.cause.split(":")[0])
            for e in trec.RECOVERY_LOG.events()] == [
        ("retry", "DeadlineExceeded"), ("recovered", "")]


def test_breakers_open_and_close_alike():
    out = []
    for rec in (trec, jrec):
        now = [0.0]
        b = rec.CircuitBreaker(failure_threshold=2, cooldown=5.0,
                               clock=lambda: now[0])
        trace = []
        for t, op in ((0, "f"), (1, "a"), (1, "f"), (2, "a"), (6, "a"),
                      (6, "f"), (7, "a"), (12, "a"), (12, "s"), (13, "a")):
            now[0] = t
            if op == "f":
                trace.append(b.record_failure("k"))
            elif op == "s":
                b.record_success("k")
            else:
                trace.append(b.allow("k"))
        trace.append(b.snapshot())
        out.append(trace)
    assert out[0] == out[1]


TREES = (
    {"a": np.ones(3), "b": (np.float32(1.0), [np.arange(4.0)])},
    {"a": np.array([1.0, np.inf])},
    [np.array([np.nan]), 1],
    {"i": np.array([1, 2]), "s": "text", "n": None},
)


@pytest.mark.parametrize("tree", TREES)
def test_check_finite_alike(tree):
    assert trec.check_finite(tree) == jrec.check_finite(tree)


def test_check_finite_reads_tensors():
    assert trec.check_finite({"t": torch.ones(3)})
    assert not trec.check_finite({"t": torch.tensor([1.0, float("nan")])})
    assert trec.check_finite({"t": torch.arange(3)})


# ---------------------------------------------------------------------------
# The app under the schedules of chip_smoke.py's phase 19(b)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_clean(tmp_path_factory):
    return jax_run(None, str(tmp_path_factory.mktemp("jax_clean")))


@pytest.fixture(scope="module")
def port_clean(tmp_path_factory):
    return smoke.chaos_run(None, smoke.csv_frame(ABSTRACT),
                           str(tmp_path_factory.mktemp("port_clean")), ON_CPU)


def test_clean_run_is_golden(port_clean, jax_clean):
    out, events, fired = port_clean
    assert events == [] == fired and jax_clean[1] == []
    gold = smoke.CHAOS_GOLDEN["clean"]
    assert out["rows"] == gold["rows"] and out["group_sum"] == gold[
        "group_sum"]
    assert out["coef"] == pytest.approx(gold["coef"], rel=1e-6)
    assert out["rmse"] == pytest.approx(gold["rmse"], rel=1e-6)
    assert_same_section(out["dq_section"], jax_clean[0]["dq_section"])
    assert out["dq_section"][0] == "== Data Quality =="


@pytest.mark.parametrize("schedule", smoke.CHAOS_SCHEDULES)
def test_schedule_leaves_the_jax_events(schedule, port_clean, tmp_path):
    out, events, fired = smoke.chaos_run(
        schedule, smoke.csv_frame(ABSTRACT), str(tmp_path), ON_CPU)
    j_out, j_events, j_fired = jax_run(schedule, str(tmp_path))
    assert events == j_events == smoke.CHAOS_GOLDEN["events"][schedule]
    assert fired == j_fired and fired, "the schedule fired nowhere"
    clean = port_clean[0]
    for key in ("rows", "group_sum", "dear", "coef", "intercept", "rmse",
                "predict40"):
        assert out[key] == clean[key], key
    if schedule != "dq_profile:device_error:1":
        assert_same_section(out["dq_section"], j_out["dq_section"])


@pytest.mark.parametrize("schedule", smoke.CHAOS_FULL)
def test_full_size_schedules_at_a_small_table(schedule, tmp_path):
    """Phase 19(b)'s schedules of the 10^7-row table, here at 4,096 rows
    made by chip_smoke.full_table: the JAX events, the clean run's bits."""
    guest, price = smoke.full_table(4096, seed=3)
    if schedule.startswith("oom:"):
        schedule = "oom:oom:n=4096"

    def frame_of(spark):
        return spark.create_data_frame({"guest": guest, "price": price})

    def jframe_of(spark):
        return spark.createDataFrame({"guest": guest, "price": price})

    clean = smoke.chaos_run(None, frame_of, str(tmp_path), ON_CPU)[0]
    out, events, fired = smoke.chaos_run(schedule, frame_of,
                                         str(tmp_path), ON_CPU)
    _, j_events, j_fired = jax_chaos_run(schedule, jframe_of,
                                         str(tmp_path))
    assert events == j_events and fired == j_fired and fired
    for key in ("rows", "group_sum", "dear", "coef", "intercept", "rmse",
                "predict40", "dq_section"):
        assert out[key] == clean[key], key


def test_no_plan_never_reaches_the_machinery(monkeypatch, tmp_path,
                                             port_clean):
    def boom(*a, **k):
        raise AssertionError("recovery machinery ran on a clean run")

    monkeypatch.setattr(tfaults.FaultPlan, "_tick", boom)
    monkeypatch.setattr(trec.RecoveryLog, "record", boom)
    out, events, _ = smoke.chaos_run(None, smoke.csv_frame(ABSTRACT),
                                     str(tmp_path), ON_CPU)
    assert events == [] and out["coef"] == port_clean[0]["coef"]


def test_session_installs_and_removes_its_schedule():
    from sparkdq4ml_tpu_torch import TorchSession

    spark = TorchSession.builder().config("spark.torch.device", "cpu") \
        .config("spark.faults", "aqe:stall:2").config(
            "spark.faults.seed", 5).get_or_create()
    try:
        plan = tfaults.active()
        assert plan is not None and plan.seed == 5
        assert spark.recovery_log is trec.RECOVERY_LOG
    finally:
        spark.stop()
    assert tfaults.active() is None


# ---------------------------------------------------------------------------
# fit_or_resume
# ---------------------------------------------------------------------------

def _lasso_frames(n: int = 2000):
    guest, price = smoke.full_table(n, seed=4)
    keep = (price >= 20) & ~((guest < 14) & (price > 90))
    x = guest[keep].astype(np.float64)
    y = price[keep]
    feats = x[:, None]
    from sparkdq4ml_tpu.frame.frame import Frame as JFrame
    from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame

    cols = {"features": feats, "label": y}
    return TFrame(cols, device="cpu"), JFrame(cols)


def test_mid_fit_preemption_resumes_to_the_same_model(tmp_path):
    from sparkdq4ml_tpu.models import LinearRegression as JLR
    from sparkdq4ml_tpu_torch.models import LinearRegression as TLR

    tframe, jframe = _lasso_frames()
    params = dict(max_iter=40, reg_param=1.0, elastic_net_param=1.0)
    whole = TLR(**params).fit(tframe)
    runs = []
    for rec, faults, est, frame in ((trec, tfaults, TLR(**params), tframe),
                                    (jrec, jfaults, JLR(**params), jframe)):
        rec.RECOVERY_LOG.clear()
        # the fit converges in 2 iterations: segments of 1 put the
        # preemptions after a checkpoint, resumed from its cursor
        with faults.inject_faults("fit:preempt:2", seed=1):
            model = rec.fit_or_resume(est, frame,
                                      str(tmp_path / rec.__name__),
                                      checkpoint_every=1)
        runs.append((model, [(e.site, e.action, e.attempt)
                             for e in rec.RECOVERY_LOG.events()]))
    (model, events), (_, j_events) = runs
    assert events == j_events
    assert events == [("fit", "checkpoint", 0), ("fit", "preempted", 1),
                      ("fit", "checkpoint", 0)]
    assert np.array_equal(np.asarray(model.coefficients),
                          np.asarray(whole.coefficients))
    assert model.intercept == whole.intercept
    again = trec.fit_or_resume(TLR(**params), tframe,
                               str(tmp_path / trec.__name__))
    assert np.array_equal(np.asarray(again.coefficients),
                          np.asarray(whole.coefficients))
    assert trec.RECOVERY_LOG.events()[-1].action == "resumed"


# ---------------------------------------------------------------------------
# ingest_native and stats_persist
# ---------------------------------------------------------------------------

INGEST_SCHEDULES = ("ingest_native:io_error:1", "ingest_native:torn_chunk:2",
                    "ingest_native:thread_death:2",
                    "ingest_native:pool_exhaust:1")


@pytest.fixture
def streamed(tmp_path):
    """A 50,000-row CSV and both packages set to stream it in chunks of
    64 KiB."""
    guest, price = smoke.full_table(50_000, seed=6)
    path = str(tmp_path / "t.csv")
    smoke.write_table_csv(path, guest, price)
    saved = [(cfg, {k: getattr(cfg, k) for k in (
        "ingest_streaming", "ingest_chunk_bytes", "ingest_prefetch")})
        for cfg in (config, jax_config)]
    for cfg, _ in saved:
        cfg.ingest_streaming, cfg.ingest_chunk_bytes = True, 1 << 16
        cfg.ingest_prefetch = 2
    yield path
    for cfg, values in saved:
        for k, v in values.items():
            setattr(cfg, k, v)


def _read(path, engine="auto"):
    from sparkdq4ml_tpu_torch.frame.csv import read_csv

    f = read_csv(path, engine=engine, device="cpu")
    return {k: f._column_values(k).numpy() for k in f.columns}


@pytest.mark.parametrize("schedule", INGEST_SCHEDULES)
def test_ingest_faults_read_the_same_columns(schedule, streamed):
    from sparkdq4ml_tpu.frame.csv import read_csv as jread
    from sparkdq4ml_tpu_torch.frame import native_csv

    clean = _read(streamed)
    pool = len(native_csv._POOL)
    with tfaults.inject_faults(schedule, seed=2):
        got = _read(streamed)
    with jfaults.inject_faults(schedule, seed=2):
        jread(streamed)
    assert _events(trec) == _events(jrec) and _events(trec)
    assert clean.keys() == got.keys()
    for k in clean:
        assert clean[k].dtype == got[k].dtype
        assert np.array_equal(clean[k].view(np.uint8), got[k].view(np.uint8))
    assert len(native_csv._POOL) == pool


def test_ingest_faults_never_hide_a_missing_file_or_a_native_request(
        streamed, tmp_path):
    with tfaults.inject_faults("ingest_native:io_error:1"):
        with pytest.raises(FileNotFoundError):
            _read(str(tmp_path / "missing.csv"))
    with tfaults.inject_faults("ingest_native:torn_chunk:1"):
        with pytest.raises(RuntimeError, match="torn chunk"):
            _read(streamed, engine="native")


@pytest.mark.parametrize("schedule", ("stats_persist:io_error:2",
                                      "stats_persist:torn_chunk:1"))
def test_a_failed_snapshot_write_keeps_the_old_one(schedule, tmp_path):
    from sparkdq4ml_tpu.utils import statstore as jstats
    from sparkdq4ml_tpu_torch.utils import statstore as tstats

    for stats, faults in ((tstats, tfaults), (jstats, jfaults)):
        path = str(tmp_path / f"{stats.__name__}.jsonl")
        stats.STORE.clear()
        stats.STORE.record_rows("k", "filter", 10, 4)
        assert stats.STORE.save(path)
        before = open(path).read()
        stats.STORE.record_rows("k2", "filter", 8, 1)
        with faults.inject_faults(schedule):
            stats.STORE.load(path)
            assert not stats.STORE.save(path)
        assert open(path).read() == before
        stats.STORE.clear()
    assert _events(trec) == _events(jrec)
    assert [e[:3] for e in _events(trec)][-1] == (
        "stats_persist", "fallback", "memory")
