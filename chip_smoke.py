#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sparkdq4ml_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. device: a CUDA device must be present; prints its name and power limit;
2. build: compiles the CUDA kernels from the sources in the checkout
   (the three ports of the TPU kernels and the port's own segment sums),
   one nvcc each, all started together; then one wrapper call of each
   Gramian under torch.profiler at the app's, the tour's and the full
   table's shapes, for the number of kernels it launches (first, while no
   other profiler session has run in the process);
3. parity: each kernel against its plain PyTorch version on the card, in
   float32 and float64, at the listed sizes, including NaNs, an int32
   guest column, n = 0, boolean and float weights for the masked Gramian,
   the Gramians' tile edges (D = 5, 128, 256 and a ragged n at D = 130),
   two runs of each Gramian that must agree bit for bit, and each Gramian
   equal to its transpose bit for bit; the two segment sums (dense slots,
   sorted segments) against index_add_ in float64 and bit-identical over
   two runs, at ragged edges and at the 10^7-row table's shapes (9,611,537
   clean rows onto 39 guest slots, onto 20,556 price groups, onto 39 long
   segments);
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
   chiprun_out/<path>_profile.txt);
7. SQL core: the whole of examples/sql_tour.py (GROUP BY with HAVING and
   ORDER BY, the sorted-program groupings, sort, distinct, joins, window
   functions, arithmetic, a derived table, explode, the CTE with a scalar
   subquery, IN (subquery) against LEFT SEMI, temp-view DDL) on
   dataset-full against SQL_TOUR_GOLDEN, then six steps on the 10^7-row
   table cleaned by the fused DQ kernel (the rows dq_clean keeps), in
   float32, with the launch counts reset just before and read just after
   (dq_rules must launch once, both segment sums at least once), each
   step's host-clock time, one run under torch.profiler (its kernel
   table written beside phase 6's), every result held against the CPU
   float64 run of the same code, steps 1 and 2 bit-identical over two
   runs and the price > avg_price count the same in all three;
8. the rest of the SQL tour on the same cleaned table (its own dq_rules
   launch and counts): the CTE with a scalar AVG subquery, IN (subquery)
   against LEFT SEMI JOIN, IN/BETWEEN and a CASE band (a string column of
   9.6 M rows), GROUP BY/ORDER BY/join/LIKE/distinct/window on the band,
   CREATE/DROP TEMP VIEW; held to the CPU float64 run (one clean table and
   session shared with phase 7's), steps 1-4 bit-identical over two runs,
   each step's median of 3 and the band's dictionary-encoding time.

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
# Phase 3c: the segment sums against their plain version
# ---------------------------------------------------------------------------

def clean_columns(rows: int = FULL_ROWS):
    """The DQ-clean full table on the card (the rows dq_clean keeps, from
    one fused DQ pass): guest as int64 and price as float32."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    guest, price = full_table(rows)
    g = torch.as_tensor(guest, device="cuda")
    p = torch.as_tensor(price, dtype=torch.float32, device="cuda")
    keep = kernels.dq_rules(p, g.to(torch.float32))[2]
    return g[keep].to(torch.int64), p[keep]


def segment_cases(guest, price):
    """(name, kernel, x, seg, size) at the grouped engine's shapes: the
    dense program's stacked (present, count, sum) onto the 39 guest slots
    (size 41: the null slot and the masked rows' slot stay empty), the
    sorted program's AVG(guest) over the 20,556 price groups, and 39
    segments of ~250 k rows each (the tile carries)."""
    import torch

    one = torch.ones_like(price)
    order = torch.sort(price, stable=True).indices
    ps = price.index_select(0, order)
    bound = torch.ones_like(ps, dtype=torch.bool)
    bound[1:] = ps[1:] != ps[:-1]
    groups = torch.cumsum(bound.to(torch.int64), 0) - 1
    by_guest = torch.sort(guest, stable=True)
    return [("dense 39 slots", "dense_segment_sum",
             torch.stack([one, one, price], dim=1), guest, 41),
            ("sorted price groups", "sorted_segment_sum",
             guest.index_select(0, order).to(torch.float32), groups,
             int(groups[-1]) + 1),
            ("sorted 39 long segments", "sorted_segment_sum",
             price.index_select(0, by_guest.indices), by_guest.values, 40)]


def edge_segment_cases(device: str, seed: int = 0):
    """Small and ragged shapes: no row, one row, tile and block edges,
    the largest float32 table that fits shared memory, runs of one row."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    biggest = kernels.SEGSUM_SMEM_BYTES // (kernels.SEGSUM_WARPS * 4) - 32
    out = []
    for n, size, cols in ((0, 3, 1), (1, 1, 1), (31, 4, 2), (32, 4, 1),
                          (33, 2, 3), (4097, 5, 1), (65_537, 300, 2),
                          (100_003, biggest, 1), (100_003, 90_000, 1)):
        x = torch.as_tensor(rng.normal(size=(n, cols)), device=device)
        seg = torch.as_tensor(rng.integers(0, size, n), device=device)
        out.append((f"dense n={n} size={size} C={cols}", "dense_segment_sum",
                    x, seg, size))
        out.append((f"sorted n={n} size={size} C={cols}",
                    "sorted_segment_sum", x, torch.sort(seg).values, size))
    return out


def check_segment_sum(cases) -> dict:
    """Each case in float32 and float64: two kernel runs bit-identical,
    the float32 kernel within 1e-5 Σ|x| of the float64 plain version
    (index_add_) per segment, the float64 kernel within 1e-12 Σ|x| of it.
    A dense case whose table does not fit takes the sorted kernel after a
    stable sort, as ops/segments.py does. Returns {name: max |float32
    kernel - float64 plain|}."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    errs = {}
    for name, kernel, x, seg, size in cases:
        want = kernels.segment_sum_reference(x.double().cpu(), seg.cpu(),
                                             size)
        bound = kernels.segment_sum_reference(x.double().abs().cpu(),
                                              seg.cpu(), size)
        for dtype, rel in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            xd, sd, fn = x.to(dtype), seg, getattr(kernels, kernel)
            if kernel == "dense_segment_sum" and \
                    not kernels.dense_segment_fits(
                        size, x.shape[1] if x.ndim == 2 else 1,
                        xd.element_size()):
                order = torch.sort(seg, stable=True).indices
                xd, sd = xd.index_select(0, order), seg.index_select(0, order)
                fn = kernels.sorted_segment_sum
            got, again = fn(xd, sd, size), fn(xd, sd, size)
            if got.shape != want.shape or not same_bits(got, again):
                raise AssertionError(f"{fn.__name__} {name} {dtype}: not "
                                     "bit-identical over two runs")
            diff = (got.double().cpu() - want).abs()
            if bool((diff > rel * bound).any()):
                raise AssertionError(
                    f"{fn.__name__} {name} {dtype}: exceeds {rel} sum|x| by "
                    f"{float((diff - rel * bound).max())}")
            if dtype == torch.float32:
                errs[name] = float(diff.max()) if diff.numel() else 0.0
    log(f"segment sums: bit-identical over two runs and within bounds: "
        f"{errs}")
    return errs


def segsum_times(name, kernel, x, seg, size) -> dict:
    """One segment-sum kernel, its plain version (index_add_ into zeros)
    and the library call (index_add_ for slot ids, torch.segment_reduce
    for contiguous segments) at one of segment_cases' shapes."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    fn = getattr(kernels, kernel)
    n = x.shape[0]
    cols = x.shape[1] if x.ndim == 2 else 1
    if kernel == "dense_segment_sum":
        library = lambda: torch.zeros((size, cols), dtype=x.dtype,
                                      device=x.device).index_add_(0, seg, x)
        call = "index_add_"
    else:
        lengths = torch.bincount(seg, minlength=size)
        library = lambda: torch.segment_reduce(x, "sum", lengths=lengths)
        call = "torch.segment_reduce(lengths=...)"
    moved = n * (8 + 4 * cols) + size * cols * 4
    return {"case": name, "n": n, "size": size, "columns": cols,
            "dtype": "float32",
            "ms": median_ms(lambda: fn(x, seg, size)),
            "plain_ms": median_ms(
                lambda: kernels.segment_sum_reference(x, seg, size)),
            "library_ms": median_ms(library), "library_call": call,
            "bound_ms": 1e3 * moved / HBM_BYTES_PER_S, "bound_by": "bytes"}


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
# Phase 7: the SQL core (examples/sql_tour.py sections 1-6)
# ---------------------------------------------------------------------------

# Every section of the tour on dataset-full: the JAX package's output on
# the CPU in float64 (tests/test_torch_sql_core.py holds this constant to
# it). Keys, counts, ranks and flags are held exactly, floats within 1e-5
# relative.
SQL_TOUR_GOLDEN = {
    "clean": 1040, "fluent_rows": 35, "joined": 1040, "over": 500,
    "semi": 1040, "rank_pairs": 1040, "rank_checksum": 280847,
    "fluent_equals_sql_rank": True,
    "busy": {"guest": list(range(1, 36)),
             "n": [37, 34, 31, 35, 28, 37, 29, 30, 26, 20, 25, 21, 23, 35,
                    28, 35, 25, 35, 27, 39, 31, 26, 30, 31, 37, 26, 31, 28,
                    30, 19, 34, 32, 29, 24, 32],
             "avg_price": [27.197027027027037, 32.243529411764705,
                            36.87354838709678, 42.07628571428572,
                            49.546428571428564, 53.83648648648649,
                            60.546551724137935, 68.29466666666667,
                            69.62115384615385, 75.11650000000002, 79.462,
                            82.0157142857143, 87.29608695652176,
                            91.49885714285713, 97.28714285714285, 101.996,
                            106.72199999999997, 111.99114285714282,
                            116.57222222222221, 121.4289743589744,
                            126.14774193548388, 131.85615384615383,
                            136.50566666666668, 141.91193548387093,
                            139.28135135135136, 140.18346153846156,
                            151.8532258064516, 156.10035714285712,
                            166.42633333333336, 171.61421052631573,
                            176.83735294117645, 181.15718750000002,
                            186.63206896551722, 191.15375000000003,
                            196.54531250000005]},
    "first_value": {"guest": list(range(1, 36)),
                    "cheapest": [23.24, 29.77, 29.91, 39.67, 44.81, 49.74,
                                 54.85, 59.69, 64.66, 70.0, 74.65, 80.0,
                                 84.97, 89.0, 94.66, 99.39, 100.0, 109.45,
                                 110.0, 119.24, 124.21, 129.41, 134.23,
                                 138.0, 3.0, 4.0, 5.0, 10.0, 164.06, 169.37,
                                 174.09, 178.97, 184.32, 188.92, 193.9]},
    "spreads": {"guest": [27, 28, 26], "spread": [154.06, 154.01, 149.46]},
    "top5": {"guest": [35, 35, 35, 35, 35],
             "price": [198.84, 198.73, 198.63, 198.56, 198.31]},
    # the later sections (tour_rest)
    "pair_rows": 3,
    "exploded": {"guest": [1, 1, 2, 2, 2, 2],
                 "v": [1.0, 23.24, 2.0, 30.89, 2.0, 33.74]},
    "premium": {"guest": [35, 35, 35, 35, 35],
                "price": [198.84, 198.73, 198.63, 198.56, 198.31]},
    "mean_price": 110.53928846153846,
    "semi_rows": 1040, "in_rows": 1040, "in_equals_semi": True,
    "ddl": {"exists_before": True, "premium_rows": 660,
            "exists_after": False},
}
SQL_ROWS_RTOL = 1e-4            # 10^7-row sums, averages, stddevs
TOUR_RTOL = 1e-5                # dataset-full floats against the golden


def tour_clean(spark, path: str):
    """The tour's load and SQL cleanup; registers and returns ``clean``."""
    df = (spark.read.format("csv").option("inferSchema", "true").load(path)
          .with_column_renamed("_c0", "guest")
          .with_column_renamed("_c1", "price"))
    df.create_or_replace_temp_view("inventory")
    clean = spark.sql(
        "SELECT CAST(guest AS INT) AS guest, CAST(price AS DOUBLE) AS price "
        "FROM inventory WHERE price > 0 AND guest > 0")
    clean.create_or_replace_temp_view("clean")
    return clean


def host(values) -> list:
    return np.asarray(values).tolist()


def sql_tour(spark, F, Window, Col, clean) -> dict:
    """examples/sql_tour.py sections 1-6 on a registered ``clean`` view,
    through the API both packages share, reduced to host numbers."""
    busy = spark.sql(
        "SELECT guest, COUNT(*) AS n, AVG(price) AS avg_price FROM clean "
        "GROUP BY guest HAVING COUNT(*) > 10 ORDER BY guest")
    fluent = (clean.group_by("guest")
              .agg(F.count().alias("n"), F.avg("price").alias("avg_price"))
              .filter(Col("n") > 10).sort("guest"))
    busy.create_or_replace_temp_view("busy")
    joined = spark.sql("SELECT guest, price, avg_price FROM clean "
                       "JOIN busy USING (guest)")
    over = joined.filter(Col("price") > Col("avg_price")).count()
    semi = spark.sql("SELECT price FROM clean LEFT SEMI JOIN busy "
                     "USING (guest)")
    w = Window.partition_by("guest").order_by("price")
    ranked = clean.with_column("rk", F.dense_rank().over(w))
    sql_ranked = spark.sql(
        "SELECT guest, price, DENSE_RANK() OVER (PARTITION BY guest ORDER BY "
        "price) AS rk FROM clean").to_pydict()
    pairs = sorted(zip(host(sql_ranked["guest"]), host(sql_ranked["rk"])))
    fluent_pairs = sorted(zip(host(ranked.to_pydict()["guest"]),
                              host(ranked.to_pydict()["rk"])))
    fv = spark.sql(
        "SELECT guest, price, first_value(price) OVER (PARTITION BY guest "
        "ORDER BY price) AS cheapest FROM clean").to_pydict()
    cheapest = dict(zip(host(fv["guest"]), host(fv["cheapest"])))
    spread = spark.sql(
        "SELECT guest, max(price) - min(price) AS spread "
        "FROM (SELECT guest, price FROM clean WHERE guest > 1) g "
        "GROUP BY guest ORDER BY max(price) - min(price) DESC LIMIT 3"
    ).to_pydict()
    top5 = spark.sql("SELECT guest, price FROM clean ORDER BY price DESC "
                     "LIMIT 5").to_pydict()
    b = busy.to_pydict()
    return {**tour_rest(spark, F, clean), "clean": clean.count(),
            "busy": {"guest": host(b["guest"]), "n": host(b["n"]),
                     "avg_price": host(b["avg_price"])},
            "fluent_rows": fluent.count(),
            "joined": joined.count(), "over": over, "semi": semi.count(),
            "rank_pairs": len(pairs),
            "rank_checksum": int(sum(g * r for g, r in pairs)),
            "fluent_equals_sql_rank": pairs == fluent_pairs,
            "first_value": {"guest": sorted(cheapest),
                            "cheapest": [cheapest[g]
                                         for g in sorted(cheapest)]},
            "spreads": {"guest": host(spread["guest"]),
                        "spread": host(spread["spread"])},
            "top5": {"guest": host(top5["guest"]),
                     "price": host(top5["price"])}}


def tour_ddl(spark) -> dict:
    """examples/sql_tour.py's DDL section on a registered ``clean`` view:
    a temp view made by SQL, its row count, ``table_exists`` around DROP."""
    spark.sql("CREATE OR REPLACE TEMP VIEW premium AS "
              "SELECT guest, price FROM clean WHERE price > 90")
    before = spark.catalog.table_exists("premium")
    n = spark.sql("SELECT count(*) AS n FROM premium").to_pydict()["n"][0]
    spark.sql("DROP VIEW premium")
    return {"exists_before": before, "premium_rows": int(n),
            "exists_after": spark.catalog.table_exists("premium")}


def tour_rest(spark, F, clean) -> dict:
    """examples/sql_tour.py's later sections on the registered ``clean``
    and ``busy`` views: explode of a split array, the CTE with a scalar
    subquery, LEFT SEMI against IN (subquery), the DDL round trip. The
    exploded pieces are strings of numbers: they are held as numbers, as
    a float32 price prints other digits than a float64 one."""
    pair = clean.limit(3).select_expr(
        "guest", "concat_ws(',', guest, price) AS s")
    exploded = pair.select(
        "guest", F.explode(F.split(F.col("s"), ",")).alias("v")).to_pydict()
    premium = spark.sql(
        "WITH stats AS (SELECT avg(price) AS ap FROM clean) "
        "SELECT guest, price FROM clean "
        "WHERE price > (SELECT ap FROM stats) ORDER BY price DESC LIMIT 5"
    ).to_pydict()
    semi = spark.sql("SELECT price FROM clean LEFT SEMI JOIN busy "
                     "USING (guest)").to_pydict()["price"]
    in_sub = spark.sql("SELECT price FROM clean WHERE guest IN "
                       "(SELECT guest FROM busy)").to_pydict()["price"]
    return {"pair_rows": pair.count(),
            "exploded": {"guest": host(exploded["guest"]),
                         "v": [float(v) for v in exploded["v"]]},
            "premium": {"guest": host(premium["guest"]),
                        "price": host(premium["price"])},
            "mean_price": float(np.mean(clean.to_pydict()["price"])),
            "semi_rows": len(semi), "in_rows": len(in_sub),
            "in_equals_semi": bool(np.array_equal(semi, in_sub)),
            "ddl": tour_ddl(spark)}


def check_tour(got: dict, want: dict, rtol: float, what: str) -> None:
    """Integers and lists of integers exactly, floats within ``rtol``."""
    def walk(g, w, path):
        if isinstance(w, dict):
            if set(g) != set(w):
                raise AssertionError(f"{what} {path}: keys {sorted(g)}")
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
        elif isinstance(w, list):
            if len(g) != len(w):
                raise AssertionError(f"{what} {path}: {len(g)} != {len(w)}")
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}[{i}]")
        elif isinstance(w, float):
            if not abs(g - w) <= rtol * abs(w):
                raise AssertionError(f"{what} {path}: {g} vs {w}")
        elif g != w:
            raise AssertionError(f"{what} {path}: {g} != {w}")
    walk(got, want, "")


def check_tour_golden(device: str) -> dict:
    """The tour's sections 1-6 on dataset-full through the port, in
    float32, against SQL_TOUR_GOLDEN."""
    from sparkdq4ml_tpu_torch import functions as F
    from sparkdq4ml_tpu_torch.frame.window import Window
    from sparkdq4ml_tpu_torch.ops.expressions import Col

    spark = session(device)
    clean = tour_clean(spark, os.path.join(ROOT, "data", "dataset-full.csv"))
    got = sql_tour(spark, F, Window, Col, clean)
    spark.stop()
    check_tour(got, SQL_TOUR_GOLDEN, TOUR_RTOL, "SQL tour on dataset-full")
    log(f"SQL tour on dataset-full, {device} float32: matches the golden")
    return got


KEY_GUESTS = np.arange(0, 40, 2)        # 20 keys: odd guests are missing


def sql_core_steps(spark, clean):
    """Steps 1-6 of the SQL core on the clean 10^7-row frame, as
    (name, fn) pairs; each fn returns the step's result frames (and
    counts the step itself reads)."""
    from sparkdq4ml_tpu_torch import functions as F
    from sparkdq4ml_tpu_torch.frame.window import Window
    from sparkdq4ml_tpu_torch.ops.expressions import Col

    def group_by():
        stats = spark.sql(
            "SELECT guest, COUNT(*) AS n, SUM(price) AS total, AVG(price) "
            "AS avg_price, MIN(price) AS lo, MAX(price) AS hi, STDDEV(price) "
            "AS sd FROM clean GROUP BY guest HAVING COUNT(*) > 10 "
            "ORDER BY guest")
        stats.select("guest", "avg_price").create_or_replace_temp_view(
            "busy")
        fluent = (clean.group_by("guest")
                  .agg(F.count().alias("n"), F.avg("price").alias("avg_price"),
                       F.stddev("price").alias("sd"))
                  .filter(Col("n") > 10).sort("guest"))
        return {"stats": stats, "fluent": fluent}

    def sorted_groups():
        nd = spark.sql("SELECT guest, COUNT(DISTINCT price) AS nd FROM clean "
                       "GROUP BY guest")
        by_price = spark.sql("SELECT price, COUNT(*) AS n FROM clean "
                             "GROUP BY price")
        # the sorted program's float sums (the sorted segment-sum kernel)
        by_price_avg = spark.sql("SELECT price, AVG(guest) AS avg_guest FROM "
                                 "clean GROUP BY price")
        return {"count_distinct": nd, "by_price": by_price,
                "by_price_avg": by_price_avg}

    def sort_distinct():
        return {"top5": spark.sql("SELECT guest, price FROM clean ORDER BY "
                                  "price DESC LIMIT 5"),
                "sorted": clean.sort("guest", Col("price").desc()),
                "distinct": clean.distinct(),
                "per_guest": clean.drop_duplicates(["guest"])}

    def join():
        joined = spark.sql("SELECT guest, price, avg_price FROM clean "
                           "JOIN busy USING (guest)")
        keys = spark.createDataFrame({"guest": KEY_GUESTS.astype(np.int32),
                                      "tag": KEY_GUESTS * 10.0})
        return {"joined": joined,
                "over": joined.filter(Col("price") > Col("avg_price")),
                "semi": spark.sql("SELECT price FROM clean LEFT SEMI JOIN "
                                  "busy USING (guest)"),
                "left": clean.join(keys, "guest", "left")}

    def window():
        w = Window.partition_by("guest").order_by("price")
        ranked = (clean.with_column("rk", F.dense_rank().over(w))
                  .with_column("prev", F.lag("price", 1).over(w)))
        sql = spark.sql(
            "SELECT guest, price, DENSE_RANK() OVER (PARTITION BY guest "
            "ORDER BY price) AS rk, first_value(price) OVER (PARTITION BY "
            "guest ORDER BY price) AS cheapest, SUM(price) OVER (PARTITION "
            "BY guest ORDER BY price ROWS BETWEEN 2 PRECEDING AND CURRENT "
            "ROW) AS run FROM clean")
        return {"ranked": ranked, "sql": sql}

    def expressions():
        feat = clean.select_expr("guest", "price",
                                 "price / guest AS price_per_guest")
        return {"feat": feat, "feat_nonnull": feat.na.drop(),
                "spread": spark.sql(
                    "SELECT guest, max(price) - min(price) AS spread "
                    "FROM (SELECT guest, price FROM clean WHERE guest > 1) g "
                    "GROUP BY guest ORDER BY max(price) - min(price) DESC "
                    "LIMIT 3")}

    return [("group_by", group_by), ("sorted_groups", sorted_groups),
            ("sort_distinct", sort_distinct), ("join", join),
            ("window", window), ("expressions", expressions)]


def summarize_sql_core(res: dict) -> dict:
    """Host arrays of every step's results (float64; a string column as
    an object array), for the comparison."""
    out = {}
    for step, frames in res.items():
        for name, frame in frames.items():
            d = frame.to_pydict()
            out[f"{step}.{name}"] = {
                c: v if v.dtype == object else np.asarray(v, np.float64)
                for c, v in d.items()}
    return out


def bit_identical(a: dict, b: dict) -> list:
    """The columns of two summaries that differ in any bit (a string
    column in any cell)."""
    bad = []
    for key, cols in a.items():
        for c, v in cols.items():
            w = b[key][c]
            same = (v.shape == w.shape and (
                np.array_equal(v, w) if v.dtype == object
                else np.array_equal(v.view(np.int64), w.view(np.int64))))
            if not same:
                bad.append(f"{key}.{c}")
    return bad


# What each result column is held to against the CPU float64 run: "exact"
# (keys, counts, ranks, min/max/first/last and lag picks, compared after
# rounding the float64 value to float32) or "rtol" (SQL_ROWS_RTOL).
SQL_CORE_RTOL_COLS = {"total", "avg_price", "sd", "run", "price_per_guest",
                      "spread", "avg_guest"}


def check_sql_core(card: dict, cpu: dict) -> dict:
    """The card's float32 results against the CPU float64 run of the same
    code. ``price > avg_price`` compares each row with its guest's float32
    average on the card, which may sit on the other side of a price than
    the float64 one: its rows are held exactly to that predicate evaluated
    on the host over the card's joined rows (which are held to the CPU
    run like every other result). Returns the largest relative error of
    each rtol column and the two row counts of that filter."""
    errs = {}
    for key, want in cpu.items():
        got = card[key]
        if list(got) != list(want):
            raise AssertionError(f"{key}: columns {list(got)}")
        if key == "join.over":
            continue                        # held to the card's averages
        for c, w in want.items():
            g = got[c]
            if g.shape != w.shape:
                raise AssertionError(f"{key}.{c}: {g.shape} vs {w.shape}")
            if g.dtype == object or w.dtype == object:
                if not (g.dtype == w.dtype and np.array_equal(g, w)):
                    raise AssertionError(f"{key}.{c}: strings differ")
            elif c in SQL_CORE_RTOL_COLS:
                ok = np.isnan(w) == np.isnan(g)
                rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
                rel = np.where(np.isnan(w), 0.0, rel)
                errs[f"{key}.{c}"] = float(rel.max()) if rel.size else 0.0
                if not ok.all() or errs[f"{key}.{c}"] > SQL_ROWS_RTOL:
                    raise AssertionError(
                        f"{key}.{c}: max relative error "
                        f"{errs[f'{key}.{c}']} > {SQL_ROWS_RTOL}")
            else:
                w32 = w.astype(np.float32).astype(np.float64)
                if not np.array_equal(g, w32, equal_nan=True):
                    bad = int((~((g == w32) | (np.isnan(g) & np.isnan(w32)))
                               ).sum())
                    raise AssertionError(f"{key}.{c}: {bad} values differ")
    if "join.over" not in cpu:
        return errs
    joined, over = card["join.joined"], card["join.over"]
    above = (joined["price"].astype(np.float32)
             > joined["avg_price"].astype(np.float32))
    for c in over:
        if not np.array_equal(over[c], joined[c][above], equal_nan=True):
            raise AssertionError(f"join.over.{c}: not the joined rows above "
                                 "their guest's average on the card")
    errs["join.over rows (card, cpu)"] = (int(above.sum()),
                                          cpu["join.over"]["price"].size)
    return errs


def clean_table(device: str, guest, price):
    """A session and the full table cleaned by the app's DQ rules through
    the fused kernel (one ``dq_rules`` launch; the rows ``dq_clean``
    keeps), registered as ``clean``."""
    from sparkdq4ml_tpu_torch.ops.rules import dq_rules_fused

    spark = session(device)
    df = spark.createDataFrame({"guest": guest, "price": price})
    keep = dq_rules_fused(df.col("price").eval(df),
                          df.col("guest").eval(df))[2]
    clean = df.filter(keep)
    clean.create_or_replace_temp_view("clean")
    return spark, clean


def run_steps(steps, device: str, times=None, runs: int = 1, once=()):
    """Each (name, fn) of ``steps`` run ``runs`` times (the names in
    ``once`` once); returns {name: [each run's result]}. With ``times``
    (a dict), each run's host-clock seconds to a device synchronisation
    are appended to ``times[name]``."""
    import torch

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    outs: dict = {}
    for name, fn in steps:
        for _ in range(1 if name in once else runs):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            if times is not None:
                times.setdefault(name, []).append(time.perf_counter() - t0)
            outs.setdefault(name, []).append(out)
    return outs


def run_sql_core(spark, clean, times=None, runs: int = 1):
    """The six steps on a ``clean_table``; the window step, whose plan is
    host numpy, runs once. Returns {step: [each run's result frames]}."""
    return run_steps(sql_core_steps(spark, clean), spark.device.type,
                     times, runs, once=("window",))


def first_runs(outs: dict) -> dict:
    return {name: runs[0] for name, runs in outs.items()}


def cpu_reference(guest, price) -> dict:
    """The CPU float64 run of phases 7 and 8 on one clean table and one
    session (each step once): {"clean_rows", "core", "rest"} summaries."""
    import torch

    from sparkdq4ml_tpu_torch.config import float_policy

    with float_policy(torch.float64):
        spark, clean = clean_table("cpu", guest, price)
        core = summarize_sql_core(first_runs(run_sql_core(spark, clean)))
        rest = summarize_sql_core(first_runs(run_sql_rest(spark, clean)))
        kept = clean.count()
        spark.stop()
    return {"clean_rows": kept, "core": core, "rest": rest}


def card_path(run, guest, price, counted, what: str):
    """``run(spark, clean, times, runs=3)`` on the card's clean table,
    the launch counts set to 0 just before the table is cleaned and read
    just after the path; each kernel in ``counted`` must have launched
    (dq_rules once). Returns (clean rows, outs, times, counts, path s)."""
    import torch

    from sparkdq4ml_tpu_torch.ops import kernels

    times: dict = {}
    torch.cuda.synchronize()
    kernels.launches.reset()
    t0 = time.perf_counter()
    spark, clean = clean_table("cuda", guest, price)
    outs = run(spark, clean, times, runs=3)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    counts = kernels.launches.snapshot()
    kept = clean.count()
    spark.stop()
    if counts["dq_rules"] != 1:
        raise AssertionError(f"the {what} path launched dq_rules "
                             f"{counts['dq_rules']} times, expected 1")
    for name in counted:
        if counts[name] == 0:
            raise AssertionError(f"the {what} path never launched {name}")
    for step, runs in outs.items():
        for name, frame in runs[0].items():
            for c in frame.columns:
                col = frame._column_values(c)
                if not isinstance(col, np.ndarray) and \
                        col.device.type != "cuda":
                    raise AssertionError(f"{step}.{name}.{c} is not on the "
                                         "card")
    return kept, outs, times, counts, path_s


def check_sql_core_full(cpu: dict, rows: int = FULL_ROWS) -> dict:
    """Steps 1-6 on the DQ-clean 10^7-row table (cleaned by one
    ``dq_rules`` launch): the card (float32) with the launch counts reset
    just before and read just after, held against the CPU float64 run of
    the same code (``cpu_reference``); steps 1 and 2 bit-identical over
    two card runs and the ``price > avg_price`` count the same in all
    three; each step's median of 3 host-clock times (the window step,
    whose plan is host numpy, once); one more run under torch.profiler
    for the device's idle share."""
    guest, price = full_table(rows)
    spark, clean = clean_table("cuda", guest[:1000], price[:1000])
    run_sql_core(spark, clean)                              # warm-up
    spark.stop()
    kept, outs, times, counts, path_s = card_path(
        run_sql_core, guest, price, ("dense_segment_sum",
                                     "sorted_segment_sum"), "SQL-core")
    card = summarize_sql_core(first_runs(outs))
    again = summarize_sql_core({k: outs[k][1] for k in ("group_by",
                                                        "sorted_groups")})
    unstable = bit_identical({k: card[k] for k in again}, again)
    if unstable:
        raise AssertionError(f"steps 1-2 differ between two card runs: "
                             f"{unstable}")
    over_counts = [r["over"].count() for r in outs["join"]]
    if len(set(over_counts)) != 1:
        raise AssertionError(f"price > avg_price kept {over_counts} rows in "
                             "the three runs")

    def profiled():
        sp, cl = clean_table("cuda", guest, price)
        run_sql_core(sp, cl)
        sp.stop()

    prof = profile_run("sql_core", profiled)
    if kept != cpu["clean_rows"]:
        raise AssertionError(f"clean rows: card {kept}, cpu "
                             f"{cpu['clean_rows']}")
    errs = check_sql_core(card, cpu["core"])
    steps_ms = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    log(f"SQL core at {rows} rows ({kept} clean), card float32: step ms "
        f"(median) {steps_ms}; runs s {times}; launches {counts}; "
        f"price > avg_price rows in the three runs {over_counts}; steps 1-2 "
        f"bit-identical over two runs; profile {prof}; errors against cpu "
        f"float64 {errs}")
    return {"rows": rows, "clean_rows": kept, "steps_ms": steps_ms,
            "runs_s": times, "path_s": path_s, "launches": counts,
            "over_rows_by_run": over_counts, "profile": prof,
            "max_rel_err": errs}


# ---------------------------------------------------------------------------
# Phase 8: the rest of the SQL tour at 10^7 rows
# ---------------------------------------------------------------------------

BANDS = ("small", "medium", "large")
# guests in [1, 40): the averages of guests 16 and 17 lie near 100 and
# 105, so 102.5 splits them far from any rounding
BUSY_REST_SQL = ("SELECT guest, COUNT(*) AS n, AVG(price) AS avg_price "
                 "FROM clean GROUP BY guest HAVING COUNT(*) > 10 AND "
                 "AVG(price) > 102.5")
BAND_SQL = ("SELECT guest, price, CASE WHEN guest < 10 THEN 'small' WHEN "
            "guest < 25 THEN 'medium' ELSE 'large' END AS band FROM clean")


def sql_rest_steps(spark, clean):
    """Phase 8's steps on the clean 10^7-row frame, as (name, fn) pairs
    returning result frames: (1) the CTE with a scalar AVG subquery;
    (2) IN (subquery) and LEFT SEMI JOIN; (3) IN, BETWEEN and the CASE
    band (a 9.6 M-row string column); (4) string keys on a band of its
    own, registered as ``banded``: GROUP BY band, ORDER BY band, a join on
    band, LIKE, distinct, a window partitioned by band; (5) the DDL round
    trip."""
    bands = spark.createDataFrame({
        "band": np.asarray(BANDS, dtype=object),
        "factor": np.asarray([1.0, 2.0, 3.0])})

    def cte():
        return {"premium": spark.sql(
            "WITH stats AS (SELECT avg(price) AS ap FROM clean) "
            "SELECT guest, price FROM clean WHERE price > (SELECT ap FROM "
            "stats) ORDER BY price DESC LIMIT 5")}

    def in_semi():
        spark.sql(BUSY_REST_SQL).create_or_replace_temp_view("busy")
        return {"in": spark.sql("SELECT guest, price FROM clean WHERE guest "
                                "IN (SELECT guest FROM busy)"),
                "semi": spark.sql("SELECT guest, price FROM clean LEFT SEMI "
                                  "JOIN busy USING (guest)")}

    def predicates():
        return {"in_between": spark.sql(
            "SELECT guest, price FROM clean WHERE guest IN (3, 7, 11, 30) "
            "AND price BETWEEN 40 AND 160"), "banded": spark.sql(BAND_SQL)}

    def string_keys():
        # a band column of its own (a new object array), so that each run
        # pays one dictionary encoding, which the six queries then share
        spark.sql(BAND_SQL).create_or_replace_temp_view("banded")
        return {"group": spark.sql(
                    "SELECT band, COUNT(*) AS n, AVG(price) AS avg_price, "
                    "STDDEV(price) AS sd FROM banded GROUP BY band"),
                "ordered": spark.sql("SELECT band, guest, price FROM banded "
                                     "ORDER BY band"),
                "joined": spark.sql("SELECT band, price FROM banded").join(
                    bands, "band"),
                "like": spark.sql("SELECT guest, price FROM banded WHERE "
                                  "band LIKE 's%'"),
                "distinct": spark.sql("SELECT band FROM banded").distinct(),
                "window": spark.sql(
                    "SELECT band, price, ROW_NUMBER() OVER (PARTITION BY "
                    "band ORDER BY price) AS rn FROM banded")}

    def ddl():
        spark.sql("CREATE OR REPLACE TEMP VIEW cheap AS SELECT guest, price "
                  "FROM clean WHERE price < 60")
        if not spark.catalog.table_exists("cheap"):
            raise AssertionError("CREATE TEMP VIEW did not register cheap")
        n = spark.sql("SELECT count(*) AS n FROM cheap")
        spark.sql("DROP VIEW cheap")
        if spark.catalog.table_exists("cheap"):
            raise AssertionError("DROP VIEW left cheap in the catalog")
        return {"count": n}

    return [("cte", cte), ("in_semi", in_semi), ("predicates", predicates),
            ("string_keys", string_keys), ("ddl", ddl)]


def run_sql_rest(spark, clean, times=None, runs: int = 1):
    """Phase 8's steps on a ``clean_table``: {step: [each run's
    result frames]}."""
    return run_steps(sql_rest_steps(spark, clean), spark.device.type,
                     times, runs)


def encode_ms(frame, column: str, runs: int = 3) -> float:
    """Median host-clock ms of the dictionary encoding of one string
    column (the hash pass, the int32 codes, their copy to the card), each
    run on a new copy of the column, which no earlier encoding holds."""
    import torch

    from sparkdq4ml_tpu_torch.ops import strings

    cells = frame._column_values(column)
    times = []
    for _ in range(runs):
        fresh = cells.copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        strings.device_codes([fresh], "cuda")
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def check_sql_rest_full(cpu: dict, rows: int = FULL_ROWS) -> dict:
    """Phase 8 on the DQ-clean 10^7-row table (cleaned by one
    ``dq_rules`` launch): the card (float32), launch counts reset just
    before and read just after, held against the CPU float64 run of the
    same code (keys, counts, codes, strings and order exact; sums and
    averages within 1e-4); steps 1-4 bit-identical over two card runs;
    IN (subquery) and LEFT SEMI give the same rows; each step's median of
    3 host-clock times and the band's encoding time."""
    guest, price = full_table(rows)
    spark, clean = clean_table("cuda", guest[:1000], price[:1000])
    run_sql_rest(spark, clean)                              # warm-up
    spark.stop()
    kept, outs, times, counts, path_s = card_path(
        run_sql_rest, guest, price, ("dense_segment_sum",), "SQL-rest")
    card = summarize_sql_core(first_runs(outs))
    steps = ("cte", "in_semi", "predicates", "string_keys")
    again = summarize_sql_core({k: outs[k][1] for k in steps})
    unstable = bit_identical({k: card[k] for k in again}, again)
    if unstable:
        raise AssertionError(f"phase 8 steps differ between two card runs: "
                             f"{unstable}")
    if bit_identical({"x": card["in_semi.in"]}, {"x": card["in_semi.semi"]}):
        raise AssertionError("IN (subquery) and LEFT SEMI JOIN gave other "
                             "rows")
    banded = outs["predicates"][0]["banded"]
    enc_ms = encode_ms(banded, "band")
    if kept != cpu["clean_rows"]:
        raise AssertionError(f"clean rows: card {kept}, cpu "
                             f"{cpu['clean_rows']}")
    errs = check_sql_core(card, cpu["rest"])
    steps_ms = {k: 1e3 * float(np.median(v)) for k, v in times.items()}
    info = {"in_rows": int(card["in_semi.in"]["guest"].size),
            "band_rows": int(card["predicates.banded"]["band"].size),
            "groups": card["string_keys.group"]["band"].tolist(),
            "group_counts": card["string_keys.group"]["n"].tolist(),
            "cheap_rows": int(card["ddl.count"]["n"][0])}
    log(f"SQL rest at {rows} rows ({kept} clean), card float32: step ms "
        f"(median) {steps_ms}; band encoding ms {enc_ms}; runs s {times}; "
        f"launches {counts}; {info}; steps 1-4 bit-identical over two runs; "
        f"errors against cpu float64 {errs}")
    return {"rows": rows, "clean_rows": kept, "steps_ms": steps_ms,
            "band_encoding_ms": enc_ms, "runs_s": times, "path_s": path_s,
            "launches": counts, "max_rel_err": errs, **info}


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
                "masked_gram": ("MaskedDesign",),
                "dense_segment_sum": ("dense_partials",),
                "sorted_segment_sum": ("sorted_tiles",)}


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
    script_t0 = time.perf_counter()
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
    check_segment_sum(edge_segment_cases("cuda"))
    seg_cases = segment_cases(*clean_columns())
    seg_errs = check_segment_sum(seg_cases)
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
    seg_dense, seg_sorted, seg_long = (segsum_times(*c) for c in seg_cases)
    del seg_cases
    prof = profile_app()
    log(f"profile of the app phase: {prof}")
    t0 = time.perf_counter()
    tour = check_tour_golden("cuda")
    cpu = cpu_reference(*full_table(FULL_ROWS))
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sql_core = check_sql_core_full(cpu)
    sql_core_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sql_rest = check_sql_rest_full(cpu)
    sql_rest_s = time.perf_counter() - t0
    del cpu
    by_path = {"app": counts,
               **{p: selection[p]["launches"] for p in selection},
               "owlqn_dataset_full": small["owlqn"]["full"]["l-bfgs"][
                   "launches"],
               "sql_core": sql_core["launches"],
               "sql_rest": sql_rest["launches"]}
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
        {"name": "dense_segment_sum", "route": "cuda", "port_only": True,
         "source": "sparkdq4ml_tpu_torch/ops/csrc/segment_sum.cu",
         "replaces": "sparkdq4ml_tpu/ops/segments.py:728 "
                     "(jax.ops.segment_sum, an XLA scatter, no pallas_call)",
         "launches": sql_core["launches"]["dense_segment_sum"],
         "max_abs_err": seg_errs["dense 39 slots"], "parity": True,
         "bit_identical_runs": True, **seg_dense},
        {"name": "sorted_segment_sum", "route": "cuda", "port_only": True,
         "source": "sparkdq4ml_tpu_torch/ops/csrc/segment_sum.cu",
         "replaces": "sparkdq4ml_tpu/ops/segments.py:1026 "
                     "(jax.ops.segment_sum, an XLA scatter, no pallas_call)",
         "launches": sql_core["launches"]["sorted_segment_sum"],
         "max_abs_err": seg_errs["sorted price groups"], "parity": True,
         "bit_identical_runs": True, **seg_sorted,
         "long_segments": seg_long},
    ], "launches_by_path": by_path,
        "device_kernels_per_call": per_call,
        "app_phase_s": float(np.median(app_s)), "app_phase_runs_s": app_s,
        "app_rows": FULL_ROWS, "app_stages_ms": stages,
        "app_profile": prof,
        "model_selection": {p: {k: v for k, v in r.items()
                                if k != "launches"}
                            for p, r in selection.items()},
        "model_selection_phase_s": selection_s,
        "small_phases": small, "small_phases_s": small_s,
        "sql_tour_dataset_full": {"rank_checksum": tour["rank_checksum"],
                                  "over": tour["over"]},
        "sql_core": sql_core, "sql_core_phase_s": sql_core_s,
        "sql_rest": sql_rest, "sql_rest_phase_s": sql_rest_s,
        "cpu_float64_reference_s": cpu_s,
        "script_s": time.perf_counter() - script_t0, "card": card}
    print(json.dumps(kernels_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
