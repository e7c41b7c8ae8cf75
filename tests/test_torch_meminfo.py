"""The port's device-memory accounting (``sparkdq4ml_tpu_torch/utils/
meminfo.py``) on the CPU: the JAX package's report keys, the census of
live tensors, the static estimate, the gauges and peak, the per-span
sampling under ``query_stats`` and ``session.memory_report()``. On the
CPU the allocator statistics are empty (as the JAX package's are on
XLA:CPU) and the sampled live bytes are 0; the census still counts every
tensor.
"""

import numpy as np
import torch

from sparkdq4ml_tpu.utils import meminfo as jax_meminfo
from sparkdq4ml_tpu_torch.frame.frame import Frame as TFrame
from sparkdq4ml_tpu_torch.ops import expressions as TE
from sparkdq4ml_tpu_torch.utils import meminfo
from sparkdq4ml_tpu_torch.utils import observability as obs
from torch_planner import both64  # noqa: F401


def test_report_keys_are_the_jax_packages(both64):
    keep = torch.arange(4096, dtype=torch.float64)      # noqa: F841
    mine, theirs = meminfo.memory_report(top=3), jax_meminfo.memory_report(
        top=3)
    assert set(mine) == set(theirs)
    assert mine["backend"] == "cpu" and mine["devices"] == []
    assert mine["live_bytes"] >= 4096 * 8
    assert mine["peak_bytes"] >= mine["live_bytes"]
    assert len(mine["largest"]) <= 3
    assert mine["largest"][0]["bytes"] >= 4096 * 8
    assert mine["by_dtype"]["float64"] >= 4096 * 8
    assert list(mine["by_dtype"].values()) == sorted(
        mine["by_dtype"].values(), reverse=True)


def test_census_counts_a_storage_once(both64):
    base = torch.zeros(1 << 16, dtype=torch.float32)
    views = [base[i::2] for i in range(2)]              # noqa: F841
    rep = meminfo.memory_report(top=50)
    same = [b for b in rep["largest"] if b["bytes"] == base.nbytes]
    assert len(same) == 1


def test_estimated_bytes_is_static():
    est = meminfo.estimated_bytes(
        {"a": torch.zeros((16, 4)), "b": np.zeros(8, np.int32),
         "c": [torch.zeros(3, dtype=torch.float64), None]})
    assert est == 16 * 4 * 4 + 8 * 4 + 3 * 8
    assert est == jax_meminfo.estimated_bytes(
        {"a": np.zeros((16, 4), np.float32), "b": np.zeros(8, np.int32),
         "c": [np.zeros(3, np.float64), None]})


def test_sample_gauges_peak_and_reset(both64):
    meminfo.reset_peak()
    b = meminfo.sample()
    assert b == meminfo.live_bytes() == 0               # no card
    assert obs.METRICS.get_gauge("mem.live_bytes") == b
    assert meminfo.peak_bytes() >= b
    keep = torch.ones(1024)                             # noqa: F841
    meminfo.memory_report()
    assert meminfo.peak_bytes() >= 4096                 # the census's
    meminfo.reset_peak()
    assert meminfo.peak_bytes() == 0


def test_span_sampling_under_query_stats(both64):
    f = (TFrame({"x": np.arange(64.0)}, device="cpu")
         .with_column("y", TE.col("x") * 2.0))
    with obs.query_stats(sample_memory=True) as qs:
        f.count()
    assert qs.spans and all("peak_mem" in s.attrs for s in qs.spans)
    assert not obs.TRACER.mem_sample
    g = (TFrame({"x": np.arange(64.0)}, device="cpu")
         .with_column("y", TE.col("x") * 3.0))
    with obs.query_stats(sample_memory=False) as qs:
        g.count()
    assert qs.spans and all("peak_mem" not in s.attrs for s in qs.spans)


def test_span_sampler_fields():
    s = meminfo.SpanSampler()
    out = s.finish()
    assert set(out) == {"peak_mem", "mem_live_bytes"}


def test_session_memory_report(both64):
    rep = both64.memory_report(top=2)
    assert rep["backend"] == "cpu" and len(rep["largest"]) <= 2
