#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sparkdq4ml_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: a CUDA device must be present; prints its name and power limit;
2. build: compiles the three CUDA kernels from the sources in the checkout,
   one nvcc each, all started together; then one wrapper call of each
   Gramian under torch.profiler at the app's, the tour's and the full
   table's shapes, for the number of kernels it launches (first, while no
   other profiler session has run in the process);
3. parity: each kernel against its plain PyTorch version on the card, in
   float32 and float64, at the listed sizes, including NaNs, an int32
   guest column, n = 0, boolean and float weights for the masked Gramian,
   the Gramians' tile edges (D = 5, 128, 256 and a ragged n at D = 130),
   two runs of each Gramian that must agree bit for bit, and each Gramian
   equal to its transpose bit for bit;
4. golden app: the reference application (CSV -> DQ rules -> SQL ->
   VectorAssembler -> Lasso fit -> predict(40)) on the three datasets
   through ``TorchSession``, in float32, against the row counts and fit
   numbers of SURVEY.md section 2.3;
5. full size: the same path on a seeded 10,000,000-row table, with the
   launch counts reset just before it and read just after, held against the
   port's plain path on the CPU in float64; then, on the same table
   DQ-cleaned, the tour's CrossValidator (3 x 3 grid, 3 folds, rmse) and
   the Huber fit unweighted and with a seeded weight column, each run with
   the counts reset just before it and read just after, held against the
   CPU float64 run of the same code; then the tour's CV and the Huber fit
   on dataset-full against the JAX package's float64 output, and the app's
   fit with solver="l-bfgs" (OWL-QN) against FISTA on the three datasets;
6. times: each kernel, its plain version and the library call with CUDA
   events (median of 25 runs after warm-up), the app phase (median of
   5 runs; the counts come from the first), the model-selection paths
   (three runs each, the counted one first), and one more run of the app
   phase and of each model-selection path under torch.profiler for the
   device's idle share (the kernel tables go to
   chiprun_out/<path>_profile.txt).

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
# The tour's cross-validation (examples/ml_pipeline_tour.py) and the Huber
# fit on dataset-full: the JAX package's output on the CPU in float64
# (tests/test_torch_tuning.py and tests/test_torch_robust.py hold these
# constants to it). Grid points 0-2 agree to 6e-9 in float64, below what a
# float32 Gramian resolves, so the card's choice among them is held to be
# optimal within 1e-3, not to be index 0.
CV_GRID = [{"reg_param": r, "elastic_net_param": a}
           for r in (0.01, 0.1, 1.0) for a in (0.0, 0.5, 1.0)]
CV_GOLDEN = {"grid": CV_GRID, "best_index": 0,
             "avg_metrics": [1.51164574, 1.51164577, 1.51164580, 1.51505589,
                             1.51506402, 1.51507218, 1.80290124, 1.80823927,
                             1.81372020],
             "coef": 4.97525549, "intercept": 22.2354160}
HUBER_GOLDEN = {"coef": 4.97610721, "intercept": 22.2313856,
                "scale": 1.20692064, "iterations": 80}
FULL_ROWS = 10_000_000
DQ_SIZES = (0, 1, 127, 128, 65_537, 10_000_000)
# The Gramians' edges: one launch up to kernels.GRAM_ONE_CHUNK_ROWS rows
# (40, 1040, 16384), D = 5 (the first tiled D), D = 128 and 256 (tile
# multiples), a ragged n at D = 130 (several chunks, a partial last tile).
GRAM_SHAPES = ((0, 3), (1, 3), (40, 3), (16_384, 3), (10_000_000, 3),
               (65_537, 5), (1_000_000, 18), (65_537, 128), (65_537, 256),
               (100_003, 130), (1_000_000, 130), (1_000_000, 514))
MASKED_SHAPES = ((0, 1), (1, 1), (1040, 1), (16_384, 1), (10_000_000, 1),
                 (65_537, 3), (1_000_000, 16), (65_537, 126),
                 (65_537, 254), (100_003, 128), (1_000_000, 128),
                 (1_000_000, 512))
APP_KERNELS = ("dq_rules", "packed_gram")   # the app path's; CV and Huber
                                            # launch masked_gram
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

def dq_clean(spark, df, counts=None, mark=lambda stage: None):
    """Rules, SQL, label and VectorAssembler on a frame with ``guest`` and
    ``price`` columns: the DQ-clean, assembled frame every fit starts from.
    Appends the row counts after each stage to ``counts`` when given;
    calls ``mark(stage)`` as each stage ends."""
    import sparkdq4ml_tpu_torch as dq
    from sparkdq4ml_tpu_torch.models import VectorAssembler

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
    return df


def app_path(spark, df, counts=None, mark=lambda stage: None,
             solver="auto"):
    """``dq_clean``, then the reference app's Lasso fit and predict(40)."""
    from sparkdq4ml_tpu_torch.models import LinearRegression, Vectors

    df = dq_clean(spark, df, counts, mark)
    model = (LinearRegression().setMaxIter(40).setRegParam(1)
             .setElasticNetParam(1).setSolver(solver)).fit(df)
    mark("fit")
    return df, model, model.predict(Vectors.dense(40.0))


def read_dataset(spark, name: str):
    df = (spark.read.format("csv").option("inferSchema", "true")
          .option("header", "false")
          .load(os.path.join(ROOT, "data", f"dataset-{name}.csv")))
    return df.with_column_renamed("_c0", "guest").with_column_renamed(
        "_c1", "price")


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
            if not same_bits(got, got.T.contiguous()):
                raise AssertionError(f"packed_gram not symmetric: n={n} "
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
    log(f"packed_gram: within bounds, bit-stable and symmetric at "
        f"{list(shapes)}")
    return errs


# ---------------------------------------------------------------------------
# Phase 4: golden app path
# ---------------------------------------------------------------------------

def check_goldens(device: str) -> None:
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    spark = session(device)
    for name, (rows, rmse, r2, p40) in GOLDEN.items():
        df = read_dataset(spark, name)
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
    for name in APP_KERNELS:
        if counts[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    return card, counts, app_s, stages


# ---------------------------------------------------------------------------
# Phase 3b: masked_gram against its plain version
# ---------------------------------------------------------------------------

def masked_inputs(n: int, d: int, dtype, device, seed: int, weights: str):
    """X (n, d), y (n) and a weight: a boolean mask with about 10% of the
    rows out, or floats in [0, 2)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((n, d), generator=g, device=device, dtype=dtype)
    y = torch.randn(n, generator=g, device=device, dtype=dtype)
    u = torch.rand(n, generator=g, device=device, dtype=dtype)
    w = u > 0.1 if weights == "bool" else 2.0 * u
    return X, y, w


def check_masked_gram(device: str, shapes=MASKED_SHAPES) -> dict:
    """The kernel in float32 within 1e-5 |Zw|'|Zw| of the float64 Gramian
    of the same inputs, and in float64 within 1e-12 |Zw|'|Zw| of
    masked_gram_reference; boolean and float weights; two runs
    bit-identical. Returns {(n, d): max |kernel - plain|} of the float32
    boolean-mask runs."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    errs, plain_excess = {}, {}
    for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for weights in ("bool", "float"):
            for n, d in shapes:
                X, y, w = masked_inputs(n, d, dtype, device, n + d, weights)
                got = kernels.masked_gram(X, y, w)
                again = kernels.masked_gram(X, y, w)
                plain = kernels.masked_gram_reference(X, y, w)
                what = f"masked_gram n={n} d={d} {dtype} {weights} weights"
                if got.shape != (d + 2, d + 2):
                    raise AssertionError(f"{what}: shape {got.shape}")
                if not same_bits(got, again):
                    raise AssertionError(f"{what}: not bit-stable")
                if not same_bits(got, got.T.contiguous()):
                    raise AssertionError(f"{what}: not symmetric")
                Z = torch.cat([X.double(), y.double()[:, None],
                               torch.ones_like(y, dtype=torch.float64)[:, None]],
                              dim=1) * w.double()[:, None]
                bound = rel * (Z.abs().T @ Z.abs())
                want = (Z.T @ Z) if dtype == torch.float32 else plain
                del Z
                over = ((got.double() - want).abs() - bound).max()
                if n and over > 0:
                    raise AssertionError(f"{what}: exceeds {rel} |Zw|'|Zw| "
                                         f"by {float(over)}")
                if dtype == torch.float32 and n:
                    # The plain version (cuBLAS SGEMM) is held to nothing
                    # here: its own excess over the bound is only logged.
                    plain_over = float(((plain.double() - want).abs()
                                        - bound).max())
                    if plain_over > 0:
                        plain_excess[what] = plain_over
                if dtype == torch.float32 and weights == "bool":
                    errs[(n, d)] = (float((got - plain).abs().max())
                                    if n else 0.0)
                del X, y, w, got, again, plain, bound, want
    log(f"masked_gram: within bounds, bit-stable and symmetric at "
        f"{list(shapes)}, "
        "float32 and float64, boolean and float weights; the float32 plain "
        f"version's excess over 1e-5 |Zw|'|Zw|: {plain_excess or 'none'}")
    return errs


# ---------------------------------------------------------------------------
# Phase 5b: model selection and robust fits
# ---------------------------------------------------------------------------

def cross_validate(df):
    """The tour's CrossValidator fit on an assembled frame."""
    from sparkdq4ml_tpu_torch.models import (CrossValidator,
                                             LinearRegression,
                                             RegressionEvaluator)

    return CrossValidator(LinearRegression(max_iter=40), CV_GRID,
                          RegressionEvaluator(metric_name="rmse"),
                          num_folds=3).fit(df)


def huber(df, weight_col=None):
    """LinearRegression(loss="huber", max_iter=100) fit on ``df``."""
    from sparkdq4ml_tpu_torch.models import LinearRegression

    return LinearRegression(loss="huber", max_iter=100,
                            weight_col=weight_col).fit(df)


def described(model) -> dict:
    """A fitted CrossValidatorModel or Huber model's numbers on the host.
    Reading the iteration count builds the training summary, which gathers
    the frame to the host: it stays outside every timed run."""
    if hasattr(model, "best_index"):
        return {"best_index": model.best_index,
                "avg_metrics": [float(v) for v in model.avg_metrics],
                "coef": float(model.best_model.coefficients[0]),
                "intercept": model.best_model.intercept}
    return {"coef": float(model.coefficients[0]),
            "intercept": model.intercept, "scale": model.scale,
            "iterations": model.summary.totalIterations}


def check_cv(card: dict, want: dict, what: str) -> None:
    """Card against a float64 result: avg_metrics within 1e-3 relative, the
    card's choice optimal within 1e-3 by the float64 metrics, the refit
    model within 1e-3."""
    got_m, want_m = np.asarray(card["avg_metrics"]), np.asarray(
        want["avg_metrics"])
    if np.any(np.abs(got_m - want_m) > 1e-3 * np.abs(want_m)):
        raise AssertionError(f"{what}: avg_metrics {got_m} vs {want_m}")
    if want_m[card["best_index"]] > want_m.min() * (1 + 1e-3):
        raise AssertionError(f"{what}: the card chose grid point "
                             f"{card['best_index']}, not optimal within 1e-3")
    for k in ("coef", "intercept"):
        if abs(card[k] - want[k]) > 1e-3 * abs(want[k]):
            raise AssertionError(f"{what} refit {k}: {card[k]} vs {want[k]}")


def check_fit(card: dict, want: dict, keys, what: str) -> None:
    for k in keys:
        if abs(card[k] - want[k]) > 1e-3 * abs(want[k]):
            raise AssertionError(f"{what} {k}: {card[k]} vs {want[k]}")


def driven(fn, *args, **kwargs):
    """``fn`` run once with the launch counts set to 0 just before it and
    read just after; returns (result, counts, host-clock s to a device
    synchronisation)."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else lambda: None)
    sync()
    kernels.launches.reset()
    t0 = time.perf_counter()
    res = fn(*args, **kwargs)
    sync()
    return res, kernels.launches.snapshot(), time.perf_counter() - t0


def check_model_selection(rows: int = FULL_ROWS,
                          device: str = "cuda") -> dict:
    """The tour's CV and the Huber fits, unweighted and weighted, on the
    DQ-clean 10^7-row table, on the card in float32 against the CPU float64
    plain run of the same code. Returns each path's card result, launch
    counts and host-clock seconds (the counted run first)."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy

    guest, price = full_table(rows)
    weight = np.random.default_rng(1).uniform(0.5, 2.0, rows)

    def clean(dev):
        spark = session(dev)
        df = dq_clean(spark, spark.createDataFrame({"guest": guest,
                                                    "price": price}))
        return spark, df.with_column("w", weight)

    warm = session(device)
    small = dq_clean(warm, warm.createDataFrame({"guest": guest[:1000],
                                                 "price": price[:1000]}))
    cross_validate(small)                                # warm-up
    huber(small.with_column("w", weight[:1000]), "w")
    warm.stop()
    spark, df = clean(device)
    out = {}
    for path, fn, kw in (("cv", cross_validate, {}), ("huber", huber, {}),
                         ("huber_weighted", huber, {"weight_col": "w"})):
        model, counts, first = driven(fn, df, **kw)
        again = [driven(fn, df, **kw)[2] for _ in range(2)]
        res = described(model)
        out[path] = {"card": res, "launches": counts,
                     "runs_s": [first] + again}
        if device == "cuda":
            out[path]["profile"] = profile_run(
                path, lambda: fn(df, **kw))
        log(f"{path} at {rows} rows, {device} float32: {res}; launches "
            f"{counts}; s {out[path]['runs_s']}")
    spark.stop()
    with float_policy(torch.float64):
        spark, df = clean("cpu")
        plain = {"cv": described(cross_validate(df)),
                 "huber": described(huber(df)),
                 "huber_weighted": described(huber(df, "w"))}
        spark.stop()
    for path, want in plain.items():
        out[path]["cpu_float64"] = want
        log(f"{path} at {rows} rows, cpu float64 plain path: {want}")
    check_cv(out["cv"]["card"], plain["cv"], f"CV at {rows} rows")
    for path in ("huber", "huber_weighted"):
        check_fit(out[path]["card"], plain[path],
                  ("coef", "intercept", "scale"), f"{path} at {rows} rows")
    expect = {"cv": 3, "huber": 1, "huber_weighted": 1}
    for path, n in expect.items():
        if device == "cuda" and out[path]["launches"]["masked_gram"] != n:
            raise AssertionError(f"{path}: {out[path]['launches']} "
                                 f"masked_gram launches, expected {n}")
    return out


def check_dataset_full(device: str) -> dict:
    """The tour's CV and the Huber fit on dataset-full against the JAX
    package's float64 output (CV_GOLDEN, HUBER_GOLDEN)."""
    spark = session(device)
    df = dq_clean(spark, read_dataset(spark, "full"))
    cv, hub = described(cross_validate(df)), described(huber(df))
    spark.stop()
    check_cv(cv, CV_GOLDEN, "CV on dataset-full")
    check_fit(hub, HUBER_GOLDEN, ("coef", "intercept", "scale"),
              "huber on dataset-full")
    log(f"dataset-full on {device}: CV {cv} (reference float64 choice "
        f"{CV_GOLDEN['best_index']}); huber {hub}")
    return {"cv": cv, "huber": hub}


def check_owlqn(device: str) -> dict:
    """The reference app's fit with solver="l-bfgs" (OWL-QN) on the three
    datasets: coefficients within 1e-3 of the FISTA fit's."""
    spark = session(device)
    out = {}
    for name in GOLDEN:
        fits = {}
        for solver in ("l-bfgs", "auto"):
            (_, model, pred), counts, _ = driven(
                app_path, spark, read_dataset(spark, name), solver=solver)
            if device == "cuda" and counts["packed_gram"] != 1:
                raise AssertionError(f"{solver} fit on {name}: {counts}")
            fits[solver] = {"coef": float(model.coefficients[0]),
                            "intercept": model.intercept,
                            "iterations": model.summary.totalIterations,
                            "predict40": pred, "launches": counts}
        check_fit(fits["l-bfgs"], fits["auto"], ("coef", "intercept"),
                  f"OWL-QN vs FISTA on {name}")
        out[name] = fits
    spark.stop()
    log(f"OWL-QN (l-bfgs) against FISTA: {out}")
    return out


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


def masked_times(n: int, d: int) -> dict:
    """masked_gram with a boolean mask (the cross-validation's and the
    unweighted Huber fit's weight). library_ms is one torch.matmul on a
    pre-built Zw, the packing excluded."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    X, y, w = masked_inputs(n, d, torch.float32, "cuda", 13, "bool")
    D = d + 2
    Zw = torch.cat([X, y[:, None], torch.ones_like(y)[:, None]],
                   dim=1) * w.to(X.dtype)[:, None]
    # X, y in float32 and a one-byte mask read once; A written once
    t_bytes = (n * ((d + 1) * 4 + 1) + D * D * 4) / HBM_BYTES_PER_S
    t_ops = n * D * (D + 1) / FP32_FLOPS    # one triangle of symmetric A
    return {"n": n, "d": d, "dtype": "float32", "weights": "bool",
            "ms": median_ms(lambda: kernels.masked_gram(X, y, w)),
            "plain_ms": median_ms(
                lambda: kernels.masked_gram_reference(X, y, w)),
            "library_ms": median_ms(lambda: torch.matmul(Zw.T, Zw)),
            "library_call": "torch.matmul(Zw.T, Zw) on a pre-built Zw",
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# Each wrapper's CUDA kernels, by a part of their names (the two Gramian
# kernels share their templates and differ in the design type).
KERNEL_NAMES = {"dq_rules": ("dq_rules_kernel",),
                "packed_gram": ("PackedDesign",),
                "masked_gram": ("MaskedDesign",)}


def profile_run(name: str, fn) -> dict:
    """One run of ``fn`` under torch.profiler: device busy time over the
    run's wall time, the wrappers whose kernels the trace holds (the busy
    time counts only those), and the kernel table written to
    chiprun_out/<name>_profile.txt. The profiler's own cost is inside the
    wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    on_device = [e for e in events
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
    listed = " ".join(e.key for e in on_device)
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in on_device)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}_profile.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total",
                             row_limit=60))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_events": len(on_device),
            "port_kernels_in_trace": sorted(
                name for name, parts in KERNEL_NAMES.items()
                if any(p in listed for p in parts))}


def device_kernels_per_call(name: str, *args) -> dict:
    """The device kernels that one call of the wrapper ``name`` on ``args``
    runs, and the kernel launches its host side makes, from a
    torch.profiler trace of that call alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sparkdq4ml_tpu_torch.ops import kernels

    fn = getattr(kernels, name)
    fn(*args)                                           # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    events = prof.events()
    on_device = [e.name for e in events
                 if str(getattr(e, "device_type", "")).endswith("CUDA")]
    launched = sum(e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                              "cudaLaunchKernelExC") for e in events)
    return {"device_kernels": len(on_device), "host_launches": launched,
            "names": sorted(set(on_device))}


def gram_kernel_counts() -> dict:
    """Kernels per wrapper call at the app's (40, 3), the tour's (1040, 1)
    and the full table's (10^7, 3) and (10^7, 1) shapes: one at the first
    two (one chunk), two at 10^7 rows (the chunk pass and the reduce)."""
    import torch

    out = {}
    for n, D in ((40, 3), (FULL_ROWS, 3)):
        Z = packed_design(n, D, torch.float32, "cuda", seed=5)
        out[f"packed_gram ({n}, {D})"] = device_kernels_per_call(
            "packed_gram", Z)
    for n, d in ((1040, 1), (FULL_ROWS, 1)):
        args = masked_inputs(n, d, torch.float32, "cuda", 5, "bool")
        out[f"masked_gram ({n}, d={d})"] = device_kernels_per_call(
            "masked_gram", *args)
    log(f"device kernels per wrapper call: {out}")
    for key, got in out.items():
        want = 1 if key in ("packed_gram (40, 3)",
                            "masked_gram (1040, d=1)") else 2
        if got["host_launches"] != want or got["device_kernels"] != want:
            raise AssertionError(f"{key}: {got}, expected {want} kernel(s) "
                                 "a call")
    return out


def profile_app(rows: int = FULL_ROWS) -> dict:
    guest, price = full_table(rows)
    return profile_run("app", lambda: run_full("cuda", guest, price))


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
    # First, while no other profiler session has run in this process.
    per_call = gram_kernel_counts()

    dq_err = check_dq_rules("cuda")
    gram_errs = check_packed_gram("cuda")
    masked_errs = check_masked_gram("cuda")
    check_goldens("cuda")
    full, counts, app_s, stages = check_full()
    log(f"app phase at {FULL_ROWS} rows, card float32, s: {app_s}; "
        f"launches of the first run {counts}")
    t0 = time.perf_counter()
    selection = check_model_selection()
    selection_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = {"dataset_full": check_dataset_full("cuda"),
             "owlqn": check_owlqn("cuda")}
    small_s = time.perf_counter() - t0

    dq_main, dq_app = dq_times(FULL_ROWS), dq_times(40)
    gram_main, gram_app, gram_big = (gram_times(FULL_ROWS, 3),
                                     gram_times(40, 3),
                                     gram_times(1_000_000, 514))
    masked_main, masked_app, masked_big = (masked_times(FULL_ROWS, 1),
                                           masked_times(1040, 1),
                                           masked_times(1_000_000, 512))
    prof = profile_app()
    log(f"profile of the app phase: {prof}")
    by_path = {"app": counts,
               **{p: selection[p]["launches"] for p in selection},
               "owlqn_dataset_full": small["owlqn"]["full"]["l-bfgs"][
                   "launches"]}
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
        {"name": "masked_gram", "route": "cuda",
         "source": "sparkdq4ml_tpu_torch/ops/csrc/masked_gram.cu",
         "replaces": "sparkdq4ml_tpu/ops/pallas_kernels.py:113",
         "launches": selection["cv"]["launches"]["masked_gram"],
         "max_abs_err": masked_errs[(FULL_ROWS, 1)],
         "parity": True, **masked_main, "app_size": masked_app,
         "largest": masked_big},
    ], "launches_by_path": by_path,
        "device_kernels_per_call": per_call,
        "app_phase_s": float(np.median(app_s)), "app_phase_runs_s": app_s,
        "app_rows": FULL_ROWS, "app_stages_ms": stages,
        "app_profile": prof,
        "model_selection": {p: {k: v for k, v in r.items()
                                if k != "launches"}
                            for p, r in selection.items()},
        "model_selection_phase_s": selection_s,
        "small_phases": small, "small_phases_s": small_s, "card": card}
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
