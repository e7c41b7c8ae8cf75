"""The port's ``PhaseTimer``, ``counters``, traces and logging
(``sparkdq4ml_tpu_torch/utils/profiling.py``, ``utils/logging.py``)
against the JAX package's, on the CPU: the same calls give the same
report structure and the same medians under one clock, the same counter
snapshots, the same logfmt lines."""

import io
import json
import logging
import os
import threading

import pytest
import torch

from sparkdq4ml_tpu.utils import logging as jax_logging
from sparkdq4ml_tpu.utils import profiling as jax_profiling
from sparkdq4ml_tpu_torch.utils import logging as port_logging
from sparkdq4ml_tpu_torch.utils import profiling


class FakeClock:
    """perf_counter advancing by the given steps, one a call."""

    def __init__(self, steps):
        self.t = 0.0
        self.steps = list(steps)

    def __call__(self):
        self.t += self.steps.pop(0) if self.steps else 0.0
        return self.t


def _timed_run(mod, monkeypatch):
    # phase a: 0.5 s; steady a: 0.3, 0.1, 0.2 s; steady-only b: 0.4 s x3
    clock = FakeClock([0.0, 0.5, 0.0, 0.3, 0.0, 0.1, 0.0, 0.2,
                       0.0, 0.4, 0.0, 0.4, 0.0, 0.4])
    monkeypatch.setattr(mod.time, "perf_counter", clock)
    t = mod.PhaseTimer()
    with t.phase("a"):
        pass
    out = t.steady("a", lambda: 7)
    t.steady("b", lambda: 8, sync=lambda o: None)
    return t, out


def test_phase_timer_matches_jax(monkeypatch):
    mine, out = _timed_run(profiling, monkeypatch)
    theirs, jout = _timed_run(jax_profiling, monkeypatch)
    assert out == jout == 7
    assert mine.report_pairs() == theirs.report_pairs()
    assert mine.report() == theirs.report() == {"a": 0.5}
    pairs = mine.report_pairs()
    assert pairs["a"] == {"cold": 0.5, "steady": pytest.approx(0.2)}
    assert pairs["b"] == {"cold": None, "steady": pytest.approx(0.4)}


def test_phase_accumulates_and_syncs():
    t = profiling.PhaseTimer()
    x = torch.ones(8)
    with t.phase("w", sync=x):
        pass
    first = t.report()["w"]
    with t.phase("w"):
        pass
    assert t.report()["w"] >= first


def test_steady_sync_extractor_is_called():
    calls = []

    class Opaque:
        arr = torch.ones(4)

    t = profiling.PhaseTimer()
    t.steady("op", Opaque, sync=lambda o: calls.append(1) or o.arr, reps=2)
    assert len(calls) == 2
    assert t.report_pairs()["op"]["cold"] is None


def test_block_until_ready_passes_trees_through():
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), 3]}
    assert profiling.block_until_ready(tree) is tree
    assert profiling.block_until_ready(5) == 5


def _count(cnt):
    cnt.clear()
    cnt.increment("pipeline.flush")
    cnt.increment("pipeline.flush", 2)
    cnt.increment("pipeline.hit")
    cnt.increment("frame.host_sync", 4)
    snap = (cnt.snapshot(), cnt.snapshot("pipeline"), cnt.get("nope"))
    cnt.clear("pipeline")
    return snap, cnt.snapshot()


def test_counters_match_jax():
    assert _count(profiling.Counters()) == _count(jax_profiling.Counters())
    (full, pipe, missing), rest = _count(profiling.Counters())
    assert pipe == {"pipeline.flush": 3, "pipeline.hit": 1}
    assert missing == 0 and rest == {"frame.host_sync": 4}


def test_counters_lose_no_update_across_threads():
    c = profiling.Counters()

    def work():
        for _ in range(2000):
            c.increment("x")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert c.get("x") == 16000


def test_timed_logs_the_block(caplog):
    with caplog.at_level(logging.INFO, logger="sparkdq4ml_tpu_torch"):
        with profiling.timed("work", sync=lambda: torch.ones(1)):
            pass
    assert any("work took" in r.getMessage() for r in caplog.records)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(16).sum()
    with open(tmp_path / "t" / "trace.json") as f:
        doc = json.load(f)
    assert "traceEvents" in doc
    with profiling.trace(None):
        pass


def test_managed_capture(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARKDQ4ML_CAPTURE_DIR", str(tmp_path))
    profiling.counters.clear("profiling.")
    path = profiling.start_capture(30.0, label="a b/c")
    try:
        assert os.path.basename(path).endswith("-a_b_c")
        assert profiling.capture_active() == path
        with pytest.raises(RuntimeError):
            profiling.start_capture(1.0)
        torch.ones(4).sum()
    finally:
        done = profiling.stop_capture()
    assert done == path and profiling.capture_active() is None
    assert os.path.exists(os.path.join(path, "trace.json"))
    assert profiling.latest_capture() == path
    assert profiling.stop_capture() is None
    assert profiling.counters.get("profiling.captures") == 1
    for i in range(3):
        os.makedirs(tmp_path / f"cap-0000{i}")
    assert profiling.prune_captures(keep=2) == 2
    assert len(profiling.captures()) == 2


def test_format_kv_matches_jax():
    fields = dict(a=1, b=None, c="", d="x y", e="k=v", f=0, g=0.0,
                  h='q"t')
    assert port_logging.format_kv(**fields) == \
        jax_logging.format_kv(**fields)


def test_configure_logging_tiers_and_is_idempotent():
    root = logging.getLogger()
    noisy = ("torch", "torch._dynamo", "torch._inductor")
    saved = (list(root.handlers), root.level,
             [logging.getLogger(n).level for n in noisy])
    try:
        stream = io.StringIO()
        port_logging.configure_logging(stream=stream)
        port_logging.configure_logging(stream=stream)
        ours = [h for h in root.handlers
                if getattr(h, "_sparkdq4ml_torch", False)]
        assert len(ours) == 1
        assert logging.getLogger("sparkdq4ml_tpu_torch").level == \
            logging.DEBUG
        assert logging.getLogger("torch").level == logging.WARNING
        logging.getLogger("sparkdq4ml_tpu_torch.x").debug("hello")
        assert "DEBUG sparkdq4ml_tpu_torch.x" in stream.getvalue()
    finally:
        root.handlers, root.level = saved[0], saved[1]
        for n, level in zip(noisy, saved[2]):
            logging.getLogger(n).setLevel(level)
        logging.getLogger("sparkdq4ml_tpu_torch").setLevel(logging.NOTSET)
