"""The callers of the dense segment sum's whole-table form
(``kernels.dense_segment_sum(x, None, 1)``, no id column) on the CPU: the
global float sums of ``frame/aggregates.py:global_agg`` (avg, sum,
stddev, variance; behind describe and summary) and ``frame/stat.py:_sums``
(corr and cov) pass no slot ids, and give the same bits as the id route
with all-zero ids that they used before. A recorder wraps
``kernels.dense_segment_sum``. Their results against the JAX package are
held by ``tests/test_torch_stat.py`` and ``tests/test_torch_aggregates_
extra.py``, unchanged. Last, both wrappers' launch paths on CPU tensors
with a fake launcher in place of the CUDA one: the plan's arguments, the
stream's scratch, a fresh output a call (the sorted wrapper's one
allocation), the launch counts."""

import numpy as np
import pytest
import torch

from sparkdq4ml_tpu_torch.config import float_policy
from sparkdq4ml_tpu_torch.frame import aggregates as A
from sparkdq4ml_tpu_torch.frame.frame import Frame
from sparkdq4ml_tpu_torch.ops import expressions as E
from sparkdq4ml_tpu_torch.ops import kernels
from sparkdq4ml_tpu_torch.ops.segments import _seg_sum


def table(seed: int = 0, n: int = 500) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * 100.0
    x[rng.random(n) < 0.05] = np.nan
    return {"g": rng.integers(0, 7, n).astype(np.int32), "x": x,
            "y": 3.0 * np.nan_to_num(x) + rng.normal(size=n)}


@pytest.fixture
def recorded(monkeypatch):
    """Every dense_segment_sum call's (seg, size); with ``zero_ids`` set,
    a call without ids runs the id route with all-zero ids instead."""
    calls, real = [], kernels.dense_segment_sum
    mode = {"zero_ids": False}

    def recorder(x, seg, size):
        calls.append((seg, size))
        if seg is None and mode["zero_ids"]:
            seg = torch.zeros(x.shape[0], dtype=torch.int64)
        return real(x, seg, size)

    monkeypatch.setattr(kernels, "dense_segment_sum", recorder)
    return calls, mode


def global_results(frame: Frame) -> dict:
    out = frame.agg(A.avg("x"), A.sum("x"), A.stddev("x"),
                    A.variance("y")).to_pydict()
    out["corr"] = frame.stat.corr("x", "y")
    out["cov"] = frame.stat.cov("x", "y")
    out["describe"] = frame.describe("x", "y").to_pydict()
    out["summary"] = frame.summary().to_pydict()
    return out


def same_bits(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        return a.shape == b.shape and a.tobytes() == b.tobytes()
    return a.tolist() == b.tolist()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
def test_global_sums_pass_no_id_column(recorded, dtype, masked):
    calls, mode = recorded
    with float_policy(dtype):
        frame = Frame(table(), device="cpu")
        if masked:
            frame = frame.filter(E.col("g") > 1)
        got = global_results(frame)
        assert calls and all(seg is None and size == 1
                             for seg, size in calls)
        n_calls = len(calls)
        mode["zero_ids"] = True
        before = global_results(frame)
    assert len(calls) == 2 * n_calls
    assert same_bits(got, before)


def test_grouped_sums_still_pass_slot_ids(recorded):
    calls, _ = recorded
    with float_policy(torch.float64):
        Frame(table(), device="cpu").group_by("g").agg(A.sum("x"))
    assert calls and all(seg is not None for seg, _ in calls)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cols", [None, 3, 4])
def test_seg_sum_without_ids(dtype, cols):
    """``_seg_sum(x, None, 1)`` gives the bits of the id route with
    all-zero ids; an integer column has no whole-table form."""
    rng = np.random.default_rng(4)
    shape = (300,) if cols is None else (300, cols)
    x = torch.as_tensor(rng.normal(size=shape) * 50).to(dtype)
    got = _seg_sum(x, None, 1)
    want = _seg_sum(x, torch.zeros(300, dtype=torch.int64), 1)
    assert got.dtype == dtype and got.shape == (1,) + shape[1:]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="float32 or float64"):
        _seg_sum(x.to(torch.int64), None, 1)


@pytest.fixture
def fake_launch(monkeypatch):
    """The dense wrapper's launch path on CPU tensors, with a launcher
    that records its arguments and writes the plain sum to ``out``."""
    import ctypes

    calls = []

    def launcher(xp, sp, scratch, outp, args, vec, stream):
        n, C, size = args.n, args.C, args.slots
        calls.append(dict(xp=xp, sp=sp, scratch=scratch, out=outp, n=n,
                          C=C, size=size, form=args.form,
                          blocks=args.blocks,
                          per_block=args.chunks_per_block,
                          ticket_bytes=args.ticket_bytes, vec=vec,
                          stream=stream))
        x = torch.empty((n, C), dtype=torch.float64)
        ctypes.memmove(x.data_ptr(), xp, x.numel() * 8)
        if sp:
            seg = torch.empty(n, dtype=torch.int64)
            ctypes.memmove(seg.data_ptr(), sp, n * 8)
            want = kernels.segment_sum_reference(x, seg, size)
        else:
            want = x.sum(0, keepdim=True)
        want = want.contiguous()
        ctypes.memmove(outp, want.data_ptr(), want.numel() * 8)
        return 0

    monkeypatch.setattr(kernels, "_route", lambda name, *t: True)
    monkeypatch.setattr(kernels, "_raw_stream", lambda dev: 7)
    real = kernels._launcher
    monkeypatch.setattr(kernels, "_launcher", lambda name, key: (
        launcher if key == ("dense", torch.float64) else real(name, key)))
    monkeypatch.setattr(kernels, "_streams", {})
    kernels.launches.reset()
    return calls


def test_dense_wrapper_launch_path(fake_launch):
    """One launch a call with the plan's arguments, the scratch of its
    stream (ticket counters first, the partial tables after them), a fresh
    output every call, the one-slot launches counted apart."""
    calls = fake_launch
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(50_000, 3)))
    seg = torch.as_tensor(rng.integers(0, 41, 50_000))
    a = kernels.dense_segment_sum(x, seg, 41)
    b = kernels.dense_segment_sum(x, seg, 41)
    c = kernels.dense_segment_sum(x, None, 1)
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    assert torch.equal(a, kernels.segment_sum_reference(x, seg, 41))
    assert torch.equal(c, x.sum(0, keepdim=True)) and c.shape == (1, 3)
    plan = kernels.dense_segment_plan(50_000, 41, 3, 8, True)
    first = calls[0]
    assert (first["n"], first["C"], first["size"], first["form"],
            first["blocks"], first["per_block"]) == (
        50_000, 3, 41, kernels.DENSE_FORMS.index("table"), plan.blocks,
        plan.chunks_per_block)
    assert first["xp"] == x.data_ptr() and first["sp"] == seg.data_ptr()
    assert first["vec"] and first["stream"] == 7
    assert first["ticket_bytes"] == kernels._TICKET_BYTES
    state = kernels._streams[(None, 7)]
    assert first["scratch"] == state.scratch.data_ptr()
    assert state.nbytes >= plan.scratch_bytes
    # only the one-slot output comes from the stream's batch
    assert list(state.outputs) == [((1, 3), torch.float64)]
    assert c.untyped_storage().nbytes() == kernels.SEGSUM_OUTPUTS * 3 * 8
    assert a.untyped_storage().nbytes() == 41 * 3 * 8
    assert calls[2]["sp"] == 0 and calls[2]["form"] == \
        kernels.DENSE_FORMS.index("whole")
    counts = kernels.launches.snapshot()
    assert counts["dense_segment_sum"] == 3
    assert counts["dense_segment_sum_one_slot"] == 1
    # an unaligned view reads as scalars; a non-contiguous x is copied
    kernels.dense_segment_sum(x[1:, :], seg[1:], 41)
    assert not calls[-1]["vec"]
    kernels.dense_segment_sum(x[:, :2].T.contiguous().T, seg, 41)
    assert calls[-1]["xp"] != x.data_ptr()


def test_dense_wrapper_times_its_launch(fake_launch, monkeypatch):
    """Each launch is timed under the kernel's profile key (the host
    clock for these CPU tensors, CUDA events on the card), so
    ``profile_report()`` gives the kernel's row a time of its own;
    with ``spark.costprof.enabled=false`` nothing is timed."""
    from sparkdq4ml_tpu_torch.config import config
    from sparkdq4ml_tpu_torch.utils import costprof

    costprof.clear()
    monkeypatch.setattr(kernels, "last_call", {})
    x = torch.ones((1000, 2), dtype=torch.float64)
    seg = torch.arange(1000) % 5
    dims = {"n": 1000, "cols": 2, "size": 5, "itemsize": 8, "id_bytes": 8}
    key = costprof.kernel_key("dense_segment_sum", dims)
    kernels.dense_segment_sum(x, seg, 5)
    kernels.dense_segment_sum(x, seg, 5)
    assert kernels.last_call["dense_segment_sum"] == dims
    assert len(costprof._TIMES[(key, 1000)]) == 2
    (row,) = [r for r in costprof.report()["entries"] if r["key"] == key]
    assert row["time_ms"] is not None and row["time_of"] == "wall"
    monkeypatch.setattr(config, "costprof_enabled", False)
    kernels.dense_segment_sum(x, seg, 5)
    assert len(costprof._TIMES[(key, 1000)]) == 2
    assert len(fake_launch) == 3
    costprof.clear()


@pytest.fixture
def fake_sorted_launch(monkeypatch):
    """The sorted wrapper's launch path on CPU tensors, with a launcher
    that records its arguments and writes the plain sum to ``out``."""
    import ctypes

    calls, log = [], []

    def launcher(xp, sp, scratch, outp, args, size, vec, stream):
        n, C = args.n, args.C
        log.append(("launch",))
        calls.append(dict(xp=xp, sp=sp, scratch=scratch, out=outp, n=n, C=C,
                          size=size, blocks=args.blocks,
                          rows_per_block=args.rows_per_block,
                          width=args.width, memset=args.memset,
                          stage_rows=args.stage_rows,
                          per_thread=args.per_thread, smem=args.smem,
                          ticket_bytes=args.ticket_bytes, vec=vec,
                          stream=stream))
        x = torch.empty((n, C), dtype=torch.float64)
        ctypes.memmove(x.data_ptr(), xp, x.numel() * 8)
        seg = torch.empty(n, dtype=torch.int64)
        ctypes.memmove(seg.data_ptr(), sp, n * 8)
        want = kernels.segment_sum_reference(x, seg, size).contiguous()
        ctypes.memmove(outp, want.data_ptr(), want.numel() * 8)
        return 0

    monkeypatch.setattr(kernels, "_route", lambda name, *t: True)
    monkeypatch.setattr(kernels, "_raw_stream", lambda dev: 7)
    real = kernels._launcher
    monkeypatch.setattr(kernels, "_launcher", lambda name, key: (
        launcher if key == ("sorted", torch.float64) else real(name, key)))
    monkeypatch.setattr(kernels, "_streams", {})
    kernels.launches.reset()
    return calls, log


def test_sorted_wrapper_launch_path(fake_sorted_launch, monkeypatch):
    """One launch a call with the plan's arguments and the slot count, the
    scratch of its stream (ticket counters first, two partials a block
    after them) reused from call to call with no scratch allocation, a
    fresh output every call (the only allocation), n = 0 and no columns
    launching nothing."""
    calls, log = fake_sorted_launch
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(50_000, 3)))
    seg = torch.as_tensor(np.sort(rng.integers(0, 900, 50_000)))
    a = kernels.sorted_segment_sum(x, seg, 900)
    state = kernels._streams[(None, 7)]
    scratch = state.scratch
    # the wrapper's allocations before its launch
    log.clear()
    real_zeros, real_empty = torch.zeros, torch.empty
    monkeypatch.setattr(torch, "zeros", lambda *s, **k: (
        log.append(("zeros", s)), real_zeros(*s, **k))[1])
    monkeypatch.setattr(torch, "empty", lambda *s, **k: (
        log.append(("empty", s)), real_empty(*s, **k))[1])
    b = kernels.sorted_segment_sum(x, seg, 900)
    monkeypatch.setattr(torch, "zeros", real_zeros)
    monkeypatch.setattr(torch, "empty", real_empty)
    assert log[:log.index(("launch",))] == [("empty", ((900, 3),))]
    assert kernels._streams[(None, 7)].scratch is scratch
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    assert torch.equal(a, kernels.segment_sum_reference(x, seg, 900))
    plan = kernels.sorted_segment_plan(50_000, 3, 8, 900)
    first = calls[0]
    assert (first["n"], first["C"], first["size"], first["blocks"],
            first["rows_per_block"], first["width"], first["stage_rows"],
            first["per_thread"], first["smem"], first["memset"]) == (
        50_000, 3, 900, plan.blocks, plan.rows_per_block, 3,
        plan.stage_rows, plan.rows_per_thread, plan.smem_bytes, 0)
    assert first["xp"] == x.data_ptr() and first["sp"] == seg.data_ptr()
    assert first["vec"] and first["stream"] == 7
    assert first["ticket_bytes"] == kernels._TICKET_BYTES
    assert first["scratch"] == scratch.data_ptr()
    assert state.nbytes >= plan.scratch_bytes
    assert kernels.launches.snapshot()["sorted_segment_sum"] == 2
    # (n,) values, an unaligned view (value-by-value copies), a copy of a
    # non-contiguous x, and no rows or no columns: zeros, no launch
    one = kernels.sorted_segment_sum(x[:, 0].contiguous(), seg, 900)
    assert one.shape == (900,) and calls[-1]["C"] == 1
    kernels.sorted_segment_sum(x[1:], seg[1:], 900)
    assert not calls[-1]["vec"]
    kernels.sorted_segment_sum(x[:, :2].T.contiguous().T, seg, 900)
    assert calls[-1]["xp"] != x.data_ptr()
    for empty in (x[:0], x[:, :0]):
        got = kernels.sorted_segment_sum(empty, seg[:empty.shape[0]], 900)
        assert got.shape == (900,) + empty.shape[1:] and not got.any()
    # an output large beside the rows: the plan's memset reaches the
    # launcher, and so do slabs of wide rows
    kernels.sorted_segment_sum(x[:10, 0].contiguous(), seg[:10], 900)
    assert calls[-1]["memset"] == 1 and calls[-1]["width"] == 1
    wide = torch.as_tensor(rng.normal(size=(2000, 50)))
    got = kernels.sorted_segment_sum(wide, seg[:2000], 900)
    assert calls[-1]["width"] == 12 and calls[-1]["C"] == 50
    assert torch.equal(got, kernels.segment_sum_reference(wide, seg[:2000],
                                                          900))
    assert len(calls) == 7
    assert kernels.launches.snapshot()["sorted_segment_sum"] == 7
