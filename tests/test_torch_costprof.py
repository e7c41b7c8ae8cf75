"""The port's cost profiles (``sparkdq4ml_tpu_torch/utils/costprof.py``)
on the CPU: counts of hand-checked plans against the numbers worked out
by hand, the hand kernels' work formulas, and the roofline arithmetic and
verdicts against the JAX package's functions given equal profiles (the
JAX package counts with XLA's ``cost_analysis``, so the counts
themselves are not compared).
"""

import numpy as np
import pytest

from sparkdq4ml_tpu.config import config as jax_config
from sparkdq4ml_tpu.utils import costprof as jax_costprof
from sparkdq4ml_tpu_torch.config import config
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import compiler, kernels
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.utils import costprof, statstore
from sparkdq4ml_tpu_torch.utils.profiling import counters
from torch_planner import both64, port_run, register, section  # noqa: F401


def _plan_profile(frame_fn):
    compiler.clear_cache()
    costprof.clear()
    statstore.STORE.clear()
    frame_fn().count()
    (entry,) = compiler.cache_stats()["entries"]
    return entry["program_key"], costprof.profile_for(entry["program_key"])


def test_hand_checked_arithmetic_plan(both64):
    """``d = v * 2 + 1`` then ``v > 3`` at bucket 16, float32: three
    literal columns (3 x 64 B written), the multiply and the add (64 B
    read twice, 64 B written, 16 operations each), the comparison (128 B
    read, 16 B written, 16 operations) and the mask AND (16 B read twice,
    16 B written, 16 operations): 64 operations, 768 bytes."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy

    with float_policy(torch.float32):
        key, prof = _plan_profile(lambda: TFrame(
            {"v": np.arange(16.0)}, device="cpu").with_column(
            "d", TE.col("v") * 2.0 + 1.0).filter(TE.col("v") > 3.0))
    assert (prof.flops, prof.transcendentals, prof.bytes_accessed,
            prof.output_bytes) == (64.0, 0.0, 768.0, 352.0)


def test_hand_checked_transcendental_plan(both64):
    """``e = exp(v)`` over 20 rows (bucket 32; the port runs the true
    rows), float64: one transcendental a row, 160 B read and 160 B
    written, no other operation."""
    key, prof = _plan_profile(lambda: TFrame(
        {"v": np.linspace(0.0, 1.0, 20)}, device="cpu").with_column(
        "e", TE.fn("exp", TE.col("v"))))
    assert (prof.flops, prof.transcendentals, prof.bytes_accessed) == \
        (0.0, 20.0, 320.0)


def test_counts_scale_with_the_rows(both64):
    def plan_at(n):
        return _plan_profile(lambda: TFrame(
            {"v": np.arange(float(n))}, device="cpu").with_column(
            "d", TE.col("v") * 3.0))[1]

    small, big = plan_at(100), plan_at(1000)
    assert big.flops == 10 * small.flops       # the first run's rows
    assert big.bytes_accessed == 10 * small.bytes_accessed


@pytest.mark.parametrize("name,dims,want", [
    ("dq_rules", {"n": 1000, "itemsize": 4}, (0.0, 17000.0)),
    ("dq_rules", {"n": 10, "itemsize": 8}, (0.0, 330.0)),
    ("packed_gram", {"n": 100, "D": 3, "itemsize": 4},
     (1200.0, 100 * 3 * 4 + 9 * 4)),
    ("masked_gram", {"n": 100, "D": 4, "itemsize": 4, "w_itemsize": 1},
     (2000.0, 100 * (3 * 4 + 1) + 16 * 4)),
    ("sorted_segment_sum", {"n": 1000, "cols": 2, "size": 10,
                            "itemsize": 4, "id_bytes": 8},
     (2000.0, 1000 * (8 + 8) + 80)),
    ("dense_segment_sum", {"n": 1000, "cols": 1, "size": 1,
                           "itemsize": 4, "id_bytes": 0},
     (1000.0, 4004.0)),
])
def test_kernel_work_formulas(name, dims, want):
    p = costprof.kernel_profile(name, dims)
    assert (p.flops, p.bytes_accessed) == want


PROFILES = [
    dict(flops=1e6, bytes_accessed=1e6),
    dict(flops=1e9, bytes_accessed=1e6),
    dict(flops=10.0, bytes_accessed=100.0),
    dict(flops=8e6, bytes_accessed=1e6),
    dict(flops=0.0, bytes_accessed=1.7e8),
]


@pytest.mark.parametrize("doc", PROFILES)
@pytest.mark.parametrize("ridge", [8.0, 12.0])
def test_roofline_and_achieved_match_jax(doc, ridge, monkeypatch):
    monkeypatch.setattr(config, "costprof_ridge", ridge)
    monkeypatch.setattr(jax_config, "costprof_ridge", ridge)
    mine = costprof.CostProfile(**doc)
    theirs = jax_costprof.CostProfile.from_doc(mine.to_doc())
    for syncs in (0, 1):
        assert costprof.roofline(mine, syncs) == \
            jax_costprof.roofline(theirs, syncs)
    for wall in (None, 0.0, 0.5, 12.0):
        assert costprof.achieved(mine, wall) == \
            jax_costprof.achieved(theirs, wall)
    assert costprof.roofline(None) == jax_costprof.roofline(None) == "host"


def test_profile_persists_and_is_adopted(both64, tmp_path):
    key, prof = _plan_profile(lambda: TFrame(
        {"v": np.arange(16.0)}, device="cpu").with_column(
        "d", TE.col("v") + 1.0))
    assert statstore.STORE.cost(key)["flops"] == prof.flops
    path = str(tmp_path / "s.jsonl")
    statstore.STORE.save(path, merge=False)
    statstore.STORE.clear()
    costprof.clear()
    statstore.STORE.load(path)
    before = counters.get("costprof.extracted")
    again = costprof.profile_for(key)
    assert again.to_doc() == prof.to_doc()
    assert counters.get("costprof.extracted") == before   # adopted


def test_profile_report_rows(both64):
    register("t", {"a": np.arange(64.0), "k": np.arange(64) % 4})
    for _ in range(2):      # a first run times into the compile digest
        port_run("SELECT k, count(*) c, sum(a) s FROM t WHERE a > 3 "
                 "GROUP BY k")
    rep = costprof.report()
    assert rep["enabled"] and rep["size"] >= 2
    caches = {r["cache"] for r in rep["entries"]}
    assert {"pipeline", "grouped"} <= caches
    for r in rep["entries"]:
        assert r["bound"] in ("memory", "compute", "sync"), r
        assert r["time_of"] == "wall" and r["gbps"] is not None, r


def test_kernel_rows_join_a_measured_time(both64, monkeypatch):
    """A hand kernel's row joins its work formula with the time its
    wrapper recorded under the kernel's key (here recorded by hand, as
    the wrapper's CUDA events would on the card); none recorded, no
    rate."""
    dims = {"n": 10_000_000, "itemsize": 4}
    monkeypatch.setattr(kernels, "last_call", {"dq_rules": dims})
    costprof.clear()
    rep = costprof.report()
    (row,) = [r for r in rep["entries"] if r["cache"] == "kernels"]
    assert row["bytes"] == 17 * 10_000_000
    assert row["gbps"] is None and row["time_of"] is None
    costprof.record_time(costprof.kernel_key("dq_rules", dims),
                         dims["n"], 0.1, "device")
    rep = costprof.report()
    (row,) = [r for r in rep["entries"] if r["cache"] == "kernels"]
    assert row["gbps"] == 1700.0 and row["time_of"] == "device"
    assert row["bound"] == "memory"


def test_report_refuses_when_disabled(both64, monkeypatch):
    monkeypatch.setattr(config, "costprof_enabled", False)
    assert costprof.report() == {"enabled": False, "entries": [],
                                 "size": 0, "pending": 0}
    assert both64.profile_report()["enabled"] is False


def test_explain_analyze_cost_columns_are_the_count(both64):
    register("t", {"a": np.arange(4.0)})
    text = port_run("EXPLAIN ANALYZE SELECT a FROM t WHERE a > 1")["plan"][0]
    stage = next(ln for ln in section(text, "Analyzed Plan")
                 if "FusedStage" in ln)
    (entry,) = [e for e in compiler.cache_stats()["entries"]]
    prof = costprof.profile_for(entry["program_key"])
    assert f"est_flops={int(prof.flops)}" in stage
    assert f"est_bytes={int(prof.bytes_accessed)}" in stage


def test_costprof_conf_keys_session_scoped():
    from sparkdq4ml_tpu_torch import TorchSession

    saved = (config.costprof_enabled, config.costprof_ridge)
    s = TorchSession.builder().config("spark.torch.device", "cpu").config(
        "spark.costprof.enabled", "false").config(
        "spark.costprof.ridge", "12").get_or_create()
    try:
        assert (config.costprof_enabled, config.costprof_ridge) == \
            (False, 12.0)
    finally:
        s.stop()
    assert (config.costprof_enabled, config.costprof_ridge) == saved
