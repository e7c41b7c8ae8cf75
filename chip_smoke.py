#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sparkdq4ml_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: a CUDA device must be present; prints its name and power limit;
2. build: compiles both CUDA kernels from the sources in the checkout;
3. parity: each kernel against its plain PyTorch version on the card, in
   float32 and float64, at the listed sizes, including NaNs, an int32
   guest column, n = 0, and two runs of the Gramian that must agree bit
   for bit;
4. golden app: the reference application (CSV -> DQ rules -> SQL ->
   VectorAssembler -> Lasso fit -> predict(40)) on the three datasets
   through ``TorchSession``, in float32, against the row counts and fit
   numbers of SURVEY.md section 2.3;
5. full size: the same path on a seeded 10,000,000-row table, with the
   launch counts reset just before it and read just after, held against the
   port's plain path on the CPU in float64;
6. times: each kernel, its plain version and the library call with CUDA
   events (median of 25 runs after warm-up), the app phase (median of
   5 runs; the counts come from the first), and one more app-phase run
   under torch.profiler for the device's idle share (its kernel table goes
   to chiprun_out/app_profile.txt).

The last lines are the kernel table as one JSON object, the card's name and
power limit from nvidia-smi, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet; full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

GOLDEN = {  # SURVEY.md section 2.3: rows raw -> rule 1 -> rule 2, fit
    "abstract": ((40, 34, 24), 2.809940, 0.996515, 217.9436),
    "small": ((27, 24, 20), 2.731280, 0.996407, 217.5090),
    "full": ((1040, 1034, 1024), 1.805140, 0.998743, 219.0998),
}
FULL_ROWS = 10_000_000
DQ_SIZES = (0, 1, 127, 128, 65_537, 10_000_000)
GRAM_SHAPES = ((0, 3), (1, 3), (10_000_000, 3), (1_000_000, 18),
               (1_000_000, 130), (1_000_000, 514))
TIMED_RUNS = 25
APP_RUNS = 5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# The app path, through the entry points a user calls
# ---------------------------------------------------------------------------

def app_path(spark, df, counts=None, mark=lambda stage: None):
    """Rules, SQL, label, VectorAssembler, fit and predict(40) on a frame
    with ``guest`` and ``price`` columns. Appends the row counts after
    each stage to ``counts`` when given; calls ``mark(stage)`` as each
    stage ends."""
    import sparkdq4ml_tpu_torch as dq
    from sparkdq4ml_tpu_torch.models import (LinearRegression,
                                             VectorAssembler, Vectors)

    spark.udf.register("minimumPriceRule", dq.minimum_price_rule, "double")
    spark.udf.register("priceCorrelationRule", dq.price_correlation_rule,
                       "double")
    if counts is not None:
        counts.append(df.count())
    df = df.with_column("price_no_min",
                        dq.call_udf("minimumPriceRule", df.col("price")))
    df.create_or_replace_temp_view("price")
    df = spark.sql("SELECT cast(guest as int) guest, price_no_min AS price "
                   "FROM price WHERE price_no_min > 0")
    if counts is not None:
        counts.append(df.count())
    df = df.with_column("price_correct_correl",
                        dq.call_udf("priceCorrelationRule", df.col("price"),
                                    df.col("guest")))
    df.create_or_replace_temp_view("price")
    df = spark.sql("SELECT guest, price_correct_correl AS price "
                   "FROM price WHERE price_correct_correl > 0")
    if counts is not None:
        counts.append(df.count())
    mark("rules_and_sql")
    df = df.with_column("label", df.col("price"))
    df = VectorAssembler().setInputCols(["guest"]).setOutputCol(
        "features").transform(df)
    mark("vector_assembler")
    model = (LinearRegression().setMaxIter(40).setRegParam(1)
             .setElasticNetParam(1)).fit(df)
    mark("fit")
    return df, model, model.predict(Vectors.dense(40.0))


def session(device: str):
    from sparkdq4ml_tpu_torch import TorchSession

    return TorchSession.builder().app_name("chip_smoke").config(
        "spark.torch.device", device).get_or_create()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def dq_inputs(n: int, dtype, device, seed: int):
    import torch

    rng = np.random.default_rng(seed)
    price = rng.uniform(0.0, 130.0, n)
    guest = rng.integers(1, 40, n).astype(np.float64)
    price[rng.random(n) < 0.01] = np.nan
    guest[rng.random(n) < 0.01] = np.nan
    return (torch.as_tensor(price, dtype=dtype, device=device),
            torch.as_tensor(guest, dtype=dtype, device=device))


def same_bits(a, b) -> bool:
    import torch

    if a.dtype == torch.bool:
        return torch.equal(a, b)
    view = torch.int32 if a.element_size() == 4 else torch.int64
    return torch.equal(a.view(view), b.view(view))


def check_dq_rules(device: str, sizes=DQ_SIZES) -> float:
    """Returns max |kernel - plain| over the float32 rule columns (NaNs,
    which sit at the same places, excluded)."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy
    from sparkdq4ml_tpu_torch.ops import kernels
    from sparkdq4ml_tpu_torch.ops.rules import dq_rules_fused

    err = 0.0
    for dtype in (torch.float32, torch.float64):
        for n in sizes:
            price, guest = dq_inputs(n, dtype, device, seed=n)
            got = kernels.dq_rules(price, guest)
            want = kernels.dq_rules_reference(price, guest)
            for g, w, what in zip(got, want, ("pnm", "pcc", "keep")):
                if g.shape != (n,) or not same_bits(g, w):
                    raise AssertionError(f"dq_rules {what} differs from "
                                         f"its plain version: n={n} {dtype}")
            if dtype == torch.float32 and n:
                for g, w in zip(got[:2], want[:2]):
                    diff = torch.nan_to_num((g - w).abs(), nan=0.0)
                    err = max(err, float(diff.max()))
            # int32 guest column, cast by dq_rules_fused first
            guest_i = torch.nan_to_num(guest, nan=0.0).to(torch.int32)
            with float_policy(dtype):
                got = dq_rules_fused(price, guest_i)
            want = kernels.dq_rules_reference(price, guest_i.to(dtype))
            if not all(same_bits(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"dq_rules_fused, int32 guest, n={n}")
    log(f"dq_rules: bit-exact at n in {list(sizes)}, float32 and float64")
    return err


def packed_design(n: int, D: int, dtype, device, seed: int):
    """Z = [X, y, 1] * mask with about 10% of the rows masked out."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    Z = torch.randn((n, D), generator=g, device=device, dtype=dtype)
    Z[:, -1] = 1.0
    keep = torch.rand(n, generator=g, device=device) > 0.1
    return Z * keep[:, None].to(dtype)


def check_packed_gram(device: str, shapes=GRAM_SHAPES) -> dict:
    """Returns {(n, D): max |kernel - plain|} of the float32 runs."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for n, D in shapes:
            Z = packed_design(n, D, dtype, device, seed=n + D)
            got = kernels.packed_gram(Z)
            again = kernels.packed_gram(Z)
            plain = kernels.packed_gram_reference(Z)
            if got.shape != (D, D):
                raise AssertionError(f"packed_gram shape {got.shape}")
            if not same_bits(got, again):
                raise AssertionError(f"packed_gram not bit-stable: n={n} "
                                     f"D={D} {dtype}")
            absZ = Z.abs().double()
            bound = rel * (absZ.T @ absZ)
            del absZ
            if dtype == torch.float32:
                Z64 = Z.double()
                exact = Z64.T @ Z64
                del Z64
                for what, A in (("kernel", got), ("plain", plain)):
                    over = ((A.double() - exact).abs() - bound).max()
                    if n and over > 0:
                        raise AssertionError(
                            f"packed_gram {what} float32 n={n} D={D}: "
                            f"|A - A64| exceeds 1e-5 |Z|'|Z| by {over}")
                errs[(n, D)] = float((got - plain).abs().max()) if n else 0.0
            else:
                over = ((got - plain).abs() - bound).max()
                if n and over > 0:
                    raise AssertionError(
                        f"packed_gram float64 n={n} D={D}: |kernel - plain| "
                        f"exceeds 1e-12 |Z|'|Z| by {over}")
            del Z, got, again, plain, bound
    log(f"packed_gram: within bounds and bit-stable at {list(shapes)}")
    return errs


# ---------------------------------------------------------------------------
# Phase 4: golden app path
# ---------------------------------------------------------------------------

def check_goldens(device: str) -> None:
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    spark = session(device)
    for name, (rows, rmse, r2, p40) in GOLDEN.items():
        df = (spark.read.format("csv").option("inferSchema", "true")
              .option("header", "false")
              .load(os.path.join(ROOT, "data", f"dataset-{name}.csv")))
        df = df.with_column_renamed("_c0", "guest").with_column_renamed(
            "_c1", "price")
        before = kernels.launches.snapshot()["packed_gram"]
        counts = []
        out, model, pred = app_path(spark, df, counts)
        if tuple(counts) != rows:
            raise AssertionError(f"{name}: row counts {counts} != {rows}")
        for col in out.columns:
            if out._column_values(col).device.type != torch.device(
                    device).type:
                raise AssertionError(f"{name}: column {col} is not on "
                                     f"{device}")
        s = model.summary
        for what, got, want in (("RMSE", s.rootMeanSquaredError, rmse),
                                ("r2", s.r2, r2), ("predict(40)", pred, p40)):
            if abs(got - want) > 1e-3 * abs(want):
                raise AssertionError(f"{name}: {what} {got} vs {want}")
        if device == "cuda" and \
                kernels.launches.snapshot()["packed_gram"] <= before:
            raise AssertionError(f"{name}: the fit did not launch "
                                 "packed_gram")
        log(f"golden {name}: rows {counts}, RMSE {s.rootMeanSquaredError}, "
            f"r2 {s.r2}, predict(40) {pred}")
    spark.stop()


# ---------------------------------------------------------------------------
# Phase 5: full size
# ---------------------------------------------------------------------------

def full_table(rows: int, seed: int = 0):
    """guest in [1, 40); price = 5 guest + 20 + N(0, 3) in cents; 3% of the
    rows priced in [0, 20) (rule 1 drops them); 2% of the rows with
    guest < 14 priced in (90, 120] (rule 2 drops them)."""
    rng = np.random.default_rng(seed)
    guest = rng.integers(1, 40, rows).astype(np.int32)
    price = 5.0 * guest + 20.0 + rng.normal(0.0, 3.0, rows)
    cheap = rng.random(rows) < 0.03
    price[cheap] = rng.uniform(0.0, 20.0, int(cheap.sum()))
    dear = (guest < 14) & (rng.random(rows) < 0.02)
    price[dear] = 120.0 - rng.uniform(0.0, 30.0, int(dear.sum()))
    return guest, np.round(price, 2)


def run_full(device: str, guest, price, stages=None) -> dict:
    """The app path on the full table, then the fused DQ pass over the same
    columns. With ``stages`` (a dict), each stage's host-clock time in ms,
    ended by a device synchronisation, is recorded into it."""
    import torch

    from sparkdq4ml_tpu_torch.ops.rules import dq_rules_fused

    last = [time.perf_counter()]

    def mark(stage):
        if stages is None:
            return
        if device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        stages[stage] = 1e3 * (now - last[0])
        last[0] = now

    spark = session(device)
    df = spark.createDataFrame({"guest": guest, "price": price})
    mark("create_data_frame")
    out, model, pred = app_path(spark, df, mark=mark)
    rmse = model.summary.rootMeanSquaredError
    mark("summary")
    keep = dq_rules_fused(df.col("price").eval(df),
                          df.col("guest").eval(df))[2]
    res = {"kept": out.count(), "fused_kept": int(keep.sum()),
           "coef": float(model.coefficients[0]),
           "intercept": model.intercept, "rmse": rmse, "predict40": pred}
    mark("dq_rules_fused")
    spark.stop()
    return res


def check_full(rows: int = FULL_ROWS):
    """Returns the card's result, the launch counts of the main path's run,
    the app-phase wall times in s (that run first, then APP_RUNS - 1
    more), and one run's stage times in ms."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy
    from sparkdq4ml_tpu_torch.ops import kernels

    guest, price = full_table(rows)
    run_full("cuda", guest[:1000], price[:1000])     # warm-up
    torch.cuda.synchronize()

    def timed_run():
        t0 = time.perf_counter()
        res = run_full("cuda", guest, price)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    kernels.launches.reset()
    card, first_s = timed_run()
    counts = kernels.launches.snapshot()
    app_s = [first_s] + [timed_run()[1] for _ in range(APP_RUNS - 1)]
    stages = {}
    run_full("cuda", guest, price, stages)
    log(f"app stages at {rows} rows, ms: {stages}")
    with float_policy(torch.float64):
        plain = run_full("cpu", guest, price)
    log(f"full size, card float32: {card}")
    log(f"full size, cpu float64 plain path: {plain}")
    if card["kept"] != plain["kept"] or card["fused_kept"] != card["kept"]:
        raise AssertionError(f"kept rows: card {card}, cpu {plain}")
    for k in ("coef", "intercept", "rmse"):
        if abs(card[k] - plain[k]) > 1e-3 * abs(plain[k]):
            raise AssertionError(f"full size {k}: {card[k]} vs {plain[k]}")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"the main path never launched {name}")
    return card, counts, app_s, stages


# ---------------------------------------------------------------------------
# Phase 6: times
# ---------------------------------------------------------------------------

def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def dq_times(n: int) -> dict:
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    price, guest = dq_inputs(n, torch.float32, "cuda", seed=7)
    moved = n * (4 + 4 + 4 + 4 + 1)
    return {"n": n, "dtype": "float32",
            "ms": median_ms(lambda: kernels.dq_rules(price, guest)),
            "plain_ms": median_ms(
                lambda: kernels.dq_rules_reference(price, guest)),
            "library_ms": None,
            "bound_ms": 1e3 * moved / HBM_BYTES_PER_S, "bound_by": "bytes"}


def gram_times(n: int, D: int) -> dict:
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    Z = packed_design(n, D, torch.float32, "cuda", seed=11)
    t_bytes = (n * D + D * D) * 4 / HBM_BYTES_PER_S
    t_ops = n * D * (D + 1) / FP32_FLOPS    # one triangle of symmetric A
    return {"n": n, "D": D, "dtype": "float32",
            "ms": median_ms(lambda: kernels.packed_gram(Z)),
            "plain_ms": median_ms(lambda: kernels.packed_gram_reference(Z)),
            "library_ms": median_ms(lambda: torch.matmul(Z.T, Z)),
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# Each wrapper's CUDA kernels, by a part of their names.
KERNEL_NAMES = {"dq_rules": ("dq_rules_kernel",),
                "packed_gram": ("gram_small_kernel", "gram_tiled_kernel",
                                "reduce_chunks_kernel")}


def profile_app(rows: int = FULL_ROWS) -> dict:
    """One app-phase run under torch.profiler: device busy time over the
    run's wall time, the wrappers whose kernels the trace holds (the busy
    time counts only those), and the kernel table written to
    chiprun_out/app_profile.txt. The profiler's own cost is inside the wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    guest, price = full_table(rows)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_full("cuda", guest, price)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    on_device = [e for e in events
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
    listed = " ".join(e.key for e in on_device)
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in on_device)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "app_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=60))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_events": len(on_device),
            "port_kernels_in_trace": sorted(
                name for name, parts in KERNEL_NAMES.items()
                if any(p in listed for p in parts))}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on the card")
        return 1
    sys.path.insert(0, ROOT)
    from sparkdq4ml_tpu_torch.ops import kernels

    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({card})")

    t0 = time.perf_counter()
    kernels.build()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    dq_err = check_dq_rules("cuda")
    gram_errs = check_packed_gram("cuda")
    check_goldens("cuda")
    full, counts, app_s, stages = check_full()
    log(f"app phase at {FULL_ROWS} rows, card float32, s: {app_s}; "
        f"launches of the first run {counts}")

    dq_main, dq_app = dq_times(FULL_ROWS), dq_times(40)
    gram_main, gram_app, gram_big = (gram_times(FULL_ROWS, 3),
                                     gram_times(40, 3),
                                     gram_times(1_000_000, 514))
    prof = profile_app()
    log(f"profile of the app phase: {prof}")
    kernels_line = {"kernels": [
        {"name": "dq_rules", "route": "cuda",
         "source": "sparkdq4ml_tpu_torch/ops/csrc/dq_rules.cu",
         "replaces": "sparkdq4ml_tpu/ops/pallas_kernels.py:237",
         "launches": counts["dq_rules"], "max_abs_err": dq_err,
         "parity": True, **dq_main, "app_size": dq_app},
        {"name": "packed_gram", "route": "cuda",
         "source": "sparkdq4ml_tpu_torch/ops/csrc/packed_gram.cu",
         "replaces": "sparkdq4ml_tpu/ops/pallas_kernels.py:180",
         "launches": counts["packed_gram"],
         "max_abs_err": gram_errs[(FULL_ROWS, 3)],
         "parity": True, **gram_main, "app_size": gram_app,
         "largest": gram_big},
    ], "app_phase_s": float(np.median(app_s)), "app_phase_runs_s": app_s,
        "app_rows": FULL_ROWS, "app_stages_ms": stages,
        "app_profile": prof, "card": card}
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
